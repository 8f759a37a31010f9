"""GBLUP on the eigenbasis of the genomic relationship matrix.

Counterpart of jwas_tpu/ops/markers.py::sweep_gblup (:496, GBLUP.jl:43-49),
of the GBLUP workspace of jwas_tpu/engine/setup.py (:521-535) and of the
chain data and EBVs of jwas_tpu/engine/mcmc.py (:778-786, :600-601).

With G_tt = V diag(lambda) V' over the training individuals, the
breeding values of the training rows are L alpha with L = V and
alpha_i ~ N(0, D_i var_a), D = |lambda|: one vectorised draw of every
pseudo-marker effect a step between three GEMVs with L or L', no
sequential chain. The EBVs of the output IDs are (G_ot V) / D times
alpha, the output map. jwas_tpu takes V of the whole G and L = Z_t V, which is the same when every
genotyped individual is phenotyped (G_tt is G with its rows and columns
permuted) and breaks its sweep otherwise (an (n_train,) + (n_geno,) sum,
ROADMAP.md fault R9); the port takes the training block, where G_ot V / D
is the conditional mean G_ot G_tt^-1 V alpha of the others.

The GEMVs are torch.mv calls: jwas_tpu computes them outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jwas_tpu_torch.ops.grouped import full_precision_matmul


class GBLUPMarkers(NamedTuple):
    """The chain data of GBLUP, in the chain's dtype on its device; serves
    the chain what the marker stores serve it outside the sweep (xpx for
    the dtype, valid, rinv, n_obs, matvec_store for the EBVs)."""

    L: torch.Tensor                   # (n_obs, n) eigenvectors over the
                                      # training rows, in observation order
    D: torch.Tensor                   # (n,) |eigenvalues|
    out_map: torch.Tensor             # (n_out, n): EBVs = out_map @ alpha
    valid: torch.Tensor               # (n,) ones: every pseudo-marker is real
    rinv: Optional[torch.Tensor]      # (n_obs,) inverse residual weights
    n_obs: int
    row_perm: None = None             # the EBVs are the output map's rows

    @property
    def xpx(self) -> torch.Tensor:
        return self.D

    @property
    def device(self) -> torch.device:
        return self.L.device

    def matvec_store(self, v):
        """The output map times v: (n_out,) for v (n,), (n_out, t) for the
        t traits' effects (n, t)."""
        with full_precision_matmul():
            return self.out_map @ v


def gblup_eigen(G, train_rows, out_rows, dtype):
    """GBLUP's workspace (jwas_tpu/engine/setup.py:524-535) from the
    relationship matrix G (n_geno, n_geno) on its device: G_tt, the block
    of the training rows (train_rows: G's row of each observation, in
    observation order), decomposed in float64 by torch.linalg.eigh;
    L = V, D = |lambda|, and the output map (G[out_rows, train_rows] V) / D
    in float64, each returned in dtype."""
    train = torch.as_tensor(train_rows, dtype=torch.int64, device=G.device)
    out = torch.as_tensor(out_rows, dtype=torch.int64, device=G.device)
    G_tt = G.index_select(0, train).index_select(1, train).double()
    lam, V = torch.linalg.eigh(G_tt)
    del G_tt
    D = lam.abs()
    with full_precision_matmul():
        out_map = (G.index_select(0, out).index_select(1, train).double() @ V) / D
    return V.to(dtype), D.to(dtype), out_map.to(dtype)


def build_gblup_markers(L, D, out_map=None, rinv=None) -> GBLUPMarkers:
    """GBLUPMarkers on L's device in its dtype; out_map None: L, the
    training rows' EBVs; rinv (n_obs,) inverse residual weights."""
    L = torch.as_tensor(L)
    f = dict(dtype=L.dtype, device=L.device)
    D = torch.as_tensor(D).to(**f)
    n_obs, n = L.shape
    if D.shape != (n,):
        raise ValueError(f"D must hold one eigenvalue for each of L's {n} columns")
    out_map = L if out_map is None else torch.as_tensor(out_map).to(**f)
    if rinv is not None:
        rinv = torch.as_tensor(rinv).to(**f)
        if rinv.shape != (n_obs,) or n_obs != n:
            raise ValueError(f"GBLUP weighs its {n} pseudo-markers by the {n_obs} "
                             f"observations' weights: both counts must agree")
    return GBLUPMarkers(L=L, D=D, out_map=out_map, valid=torch.ones(n, **f),
                        rinv=rinv, n_obs=int(n_obs))


def sweep_gblup(gm: GBLUPMarkers, alpha, ycorr, vare, var_a,
                gen: Optional[torch.Generator], z=None):
    """The GBLUP pseudo-marker update (jwas_tpu's sweep_gblup): ycorr
    += L alpha; lhs = R^-1 + vare / (var_a D), elementwise as jwas_tpu
    adds them; alpha = L' R^-1 ycorr / lhs + z sqrt(vare / lhs); ycorr
    -= L alpha. alpha (n,) and ycorr (n_obs,) are updated in place and
    returned; z (n,) standard normals (tests inject the JAX package's),
    else drawn from gen."""
    L = gm.L
    with full_precision_matmul():
        ycorr += torch.mv(L, alpha)
        rv = 1.0 if gm.rinv is None else gm.rinv
        lhs = rv + vare / (var_a * gm.D)
        w = ycorr if gm.rinv is None else gm.rinv * ycorr
        mean = torch.mv(L.T, w) / lhs
        if z is None:
            z = torch.randn(alpha.shape, generator=gen, dtype=alpha.dtype,
                            device=alpha.device)
        alpha.copy_(mean + z * torch.sqrt(vare / lhs))
        ycorr -= torch.mv(L, alpha)
    return alpha, ycorr
