"""The dense genotype store: marker-major centered genotypes on the device,
their Gram tiles, and the exact single-site sweeps.

Counterpart of jwas_tpu/ops/markers.py: MarkerBlocks and
build_marker_blocks (:55-115), the dense group-sequential schedule of
grouped_dense_sweep (:524-566, with jwas_tpu/engine/mcmc.py:233-320 and
:366-392) and sweep_exact_abc / sweep_exact_c0l / sweep_exact_bayesr
(:404-493).

The store is the centered matrix of every genotyped individual held
marker-major, (p, n_store) float32 or float64, as io/genotypes.py writes it:
a group of G = b * gb markers is one contiguous slab of rows, the dense
counterpart of the 2-bit store's rows. It is never padded or copied: the
padding markers of the p_pad = nblocks * b layout are virtual (valid 0,
zero Gram rows, xpx 1), and a short last group's GEMVs read its real rows
and give zeros for the rest. The phenotyped rows are found through
row_perm, as on the 2-bit store (ops/grouped.py: store_order, unpad), and
the residual weights R^-1 (rinv, one an observation) enter xpx, the Gram
tiles and every rhs.

DenseMarkers serves ops/grouped.py::walk_groups the same protocol as the
2-bit GroupedPackedMarkers (groups, rhs, matvec, matvec_store), so
sweep_blocks_abc_grouped, sweep_blocks_c0l_grouped (RR-BLUP, BayesL) and
sweep_blocks_bayesr_grouped run it unchanged through the inner-rounds
kernels K1/K2 and K3. Its two GEMVs a round,
X_g' R^-1 ycorr and X_g d_alpha, are full-precision torch.mv calls (the
JAX package leaves them to XLA outside any Pallas kernel; a multi-trait
round's are one torch.mm each over the t traits, jwas_tpu/ops/
multitrait.py:208, :218), and the Gram
tiles X_k' R^-1 X_k are one torch.bmm a chunk of blocks, never in TF32 or
bf16.

The exact sweep (runMCMC's fast_blocks=False) is the same grouped sweeps
with nreps = 1 over a store of one block a group (exact=True): a round is
rhs = X_c' R^-1 ycorr of a chunk of b markers, one K1 (or K3) launch on
the chunk's Gram tile, which updates its markers one after the other with
the rhs kept current through the Gram rows, then ycorr -= X_c d_alpha.
That is the sequential single-site sampler in exact algebra: within a
chunk the Gram updates give each marker the rhs the per-marker dot product
would, up to rounding. The ragged last chunk is the short group's
zero-padded rhs and Gram rows. sweep_draws serves the grouped sweeps a
whole sweep's panels; sweep_exact_abc_ref, sweep_exact_c0l_ref and
sweep_exact_bayesr_ref are the step-by-step plain versions (one dot
product a marker) the tests hold the exact sweep against.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops.grouped import full_precision_matmul, store_order, unpad, weighted

_GRAM_BYTES = 1 << 30     # bound on one weighted chunk of the Gram set-up


class DenseMarkers(NamedTuple):
    """A dense store in the grouped layout with its Gram tiles:
    nblocks, b, _ = grams.shape; G = b * gb; p_pad = nblocks * b."""

    X: torch.Tensor                   # (p, n_store) centered genotypes of
                                      # every genotyped individual
    G: int                            # markers a group
    row_perm: Optional[torch.Tensor]  # (n_obs,) int64 store column per
                                      # observation, or None (identity)
    rinv: Optional[torch.Tensor]      # (n_obs,) inverse residual weights,
                                      # or None (unit weights)
    xpx: torch.Tensor                 # (p_pad,) diag of X'R^-1X (1 for padding)
    grams: torch.Tensor               # (nblocks, b, b) block-major X'R^-1X tiles
    valid: torch.Tensor               # (p_pad,) 1 real marker, 0 padding
    n_obs: int
    exact: bool = False               # the exact sweep's store (gb = 1,
                                      # one sweep an outer iteration)

    @property
    def n_store(self) -> int:
        return self.X.shape[1]

    @property
    def ngroups(self) -> int:
        return self.valid.shape[0] // self.G

    @property
    def device(self) -> torch.device:
        return self.X.device

    def groups(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """(g, rows) in group order; a short last group's real rows only."""
        p = self.X.shape[0]
        for g in range(self.ngroups):
            yield g, self.X[g * self.G:min(p, (g + 1) * self.G)]

    def rhs(self, g: int, rows, w_pad):
        """X_g' w of group g, (G,) for w_pad (n_store,), (G, t) for
        (n_store, t) (one product for all the traits): zero for its padding
        markers."""
        out = rows @ w_pad
        if rows.shape[0] == self.G:
            return out
        full = torch.zeros((self.G,) + tuple(out.shape[1:]), dtype=out.dtype,
                           device=out.device)
        full[:rows.shape[0]] = out
        return full

    def matvec(self, g: int, rows, v):
        """X_g v of group g in store order: (n_store,) for v (G,),
        (n_store, t) for (G, t)."""
        return rows.T @ v[:rows.shape[0]]

    def matvec_store(self, v):
        """X v over the whole store: (n_store,) for v (p_pad,), (n_store, t)
        for (p_pad, t) (the multi-trait EBVs, X alpha' as one product)."""
        with full_precision_matmul():
            return self.X.T @ v[:self.X.shape[0]]


def dense_stats(X, b: int, nblocks: int, w_store=None):
    """Gram tiles (nblocks, b, b) of X_k' diag(w_store) X_k and xpx, their
    diagonal, (nblocks * b,), one torch.bmm a chunk of whole blocks (and
    one product for a ragged last block), in X's dtype at full precision.
    w_store (n_store,) weighs the store's columns (R^-1 of the observation
    in that column, 0 for an individual without a phenotype); None: every
    column weighs 1."""
    p, n = X.shape
    grams = torch.zeros((nblocks, b, b), dtype=X.dtype, device=X.device)
    step = max(1, _GRAM_BYTES // max(b * n * X.element_size(), 1))
    with full_precision_matmul():
        for k0 in range(0, nblocks, step):
            r0, r1 = k0 * b, min(p, (k0 + step) * b)
            if r0 >= r1:
                break
            full = (r1 - r0) // b
            xb = X[r0:r0 + full * b].view(full, b, n)
            if full:
                xw = xb if w_store is None else xb * w_store
                grams[k0:k0 + full] = torch.bmm(xw, xb.transpose(1, 2))
            if r0 + full * b < r1:
                xr = X[r0 + full * b:r1]
                xrw = xr if w_store is None else xr * w_store
                m = xr.shape[0]
                grams[k0 + full, :m, :m] = xrw @ xr.T
    return grams, torch.diagonal(grams, dim1=1, dim2=2).reshape(-1)


def build_dense_markers(X, n_obs: int, block_size: int, group_blocks: int,
                        row_perm=None, rinv=None, exact: bool = False) -> DenseMarkers:
    """A (p, n_store) dense store on its device in the grouped layout with
    its Gram tiles (GibbsMats, tools4genotypes.jl:237-275).

    row_perm: (n_obs,) store column of each observation, or None for the
    identity (then n_obs <= n_store). rinv: (n_obs,) inverse residual
    weights or None; it enters xpx, the Grams and, through the store, every
    rhs. Both become tensors of X's device (rinv in X's dtype). exact: the
    store of the exact sweep, whose chunks are its blocks (group_blocks
    must be 1)."""
    p, n_store = X.shape
    dev, dtype = X.device, X.dtype
    b, gb = int(block_size), int(group_blocks)
    if exact and gb != 1:
        raise ValueError("the exact sweep's store has one block a group")
    G = b * gb
    p_pad = -(-p // G) * G
    if row_perm is None and n_obs > n_store:
        raise ValueError(f"n_obs={n_obs} exceeds the store's {n_store} columns")
    perm = None
    if row_perm is not None:
        perm = torch.as_tensor(row_perm, dtype=torch.int64).to(dev)
        if perm.shape != (n_obs,) or bool((perm < 0).any()) or bool((perm >= n_store).any()):
            raise ValueError(f"row_perm must hold {n_obs} store columns in [0, {n_store})")
    rinv_t = None
    if rinv is not None:
        rinv_t = torch.as_tensor(rinv).to(device=dev, dtype=dtype)
        if rinv_t.shape != (n_obs,):
            raise ValueError(f"rinv must hold one weight for each of {n_obs} observations")
    w_store = None
    if perm is not None or rinv_t is not None or n_obs < n_store:
        ones = torch.ones(n_obs, dtype=dtype, device=dev)
        w_store = store_order(ones if rinv_t is None else rinv_t, n_store, perm)
    grams, xpx = dense_stats(X, b, p_pad // b, w_store)
    valid = torch.zeros(p_pad, dtype=dtype, device=dev)
    valid[:p] = 1.0
    xpx = torch.where(valid > 0, torch.clamp(xpx, min=1e-10), torch.ones_like(xpx))
    return DenseMarkers(X=X, G=G, row_perm=perm, rinv=rinv_t, xpx=xpx,
                        grams=grams, valid=valid, n_obs=int(n_obs), exact=exact)


# ---------------------------------------------------------------- exact sweeps


def sweep_draws(b: int, *panels):
    """draws(g, r, reps) of the grouped sweeps run as the exact sweep (a
    store of one block of b markers a group, nreps = 1) from panels drawn
    for a whole sweep in marker order, as the JAX package's sweep_exact_*
    draw them: (p,) uniforms and normals, or (p, 4) Gumbels and (p,)
    normals. Group g reads rows g*b to (g+1)*b as the (b, 1[, 4]) panels a
    round takes; the ragged last group's padding rows read 1, which keeps a
    padding marker out (pi 1, or class prior [1, 0, 0, 0])."""
    p = panels[0].shape[0]
    extra = -(-p // b) * b - p
    padded = [torch.cat([x, x.new_ones((extra,) + tuple(x.shape[1:]))]) for x in panels]

    def draws(g, r, reps):
        return tuple(x[g * b:(g + 1) * b].unsqueeze(1) for x in padded)

    return draws


def _obs_row(dm: DenseMarkers, j: int):
    """Marker j's genotypes in observation order, and weighted."""
    x = unpad(dm.X[j], dm.n_obs, dm.row_perm)
    return x, weighted(dm, x)


def sweep_exact_abc_ref(dm: DenseMarkers, alpha, beta, delta, ycorr, vare,
                        var_eff, pi, us, zs):
    """The exact BayesC / BayesB sweep step by step, as the JAX package's
    sweep_exact_abc: one dot product x_j' R^-1 ycorr a marker, then ycorr
    += (a_old - a_new) x_j. State and in-place contract as
    sweep_blocks_abc_grouped's; us, zs the sweep's (p,) panels."""
    p, p_pad = dm.X.shape[0], dm.valid.shape[0]
    inv_vare = (1.0 / vare).reshape(())
    var_eff = var_eff.reshape(-1).expand(p_pad)
    pi_c = torch.clamp(pi, 1e-10, 1.0)
    log_pi, log_pi_comp = torch.log(pi_c), torch.log1p(-pi_c + 1e-12)
    for j in range(p):
        x, xw = _obs_row(dm, j)
        sl = slice(j, j + 1)
        k = mk.abc_constants(dm.xpx[sl], var_eff[sl], inv_vare)
        a_old = alpha[sl].clone()
        a_new, b_new, inc = mk.abc_update(
            (xw @ ycorr).reshape(1), a_old, dm.xpx[sl], inv_vare, k, log_pi[sl],
            log_pi_comp[sl], us[sl], zs[sl])
        alpha[sl], beta[sl], delta[sl] = a_new, b_new, inc.to(delta.dtype)
        ycorr += (a_old - a_new) * x
    return alpha, beta, delta, ycorr


def sweep_exact_c0l_ref(dm: DenseMarkers, alpha, ycorr, vare, varg, gamma, zs):
    """The exact RR-BLUP / BayesL sweep step by step, as the JAX package's
    sweep_exact_c0l with its _c0l_update: lambda = (vare / varg) / gamma,
    mean = (x_j' R^-1 ycorr + xpx a_old) / (xpx + lambda), a_new = mean +
    z sqrt(vare / (xpx + lambda)), then ycorr += (a_old - a_new) x_j.
    gamma (p_pad,) or None (RR-BLUP); zs the sweep's (p,) normals."""
    p = dm.X.shape[0]
    lam = vare / varg
    lam = lam.expand(dm.valid.shape) if gamma is None else lam / gamma
    for j in range(p):
        x, xw = _obs_row(dm, j)
        a_old = alpha[j].clone()
        rhs = xw @ ycorr + dm.xpx[j] * a_old
        inv_lhs = 1.0 / (dm.xpx[j] + lam[j])
        a_new = inv_lhs * rhs + zs[j] * torch.sqrt(inv_lhs * vare)
        alpha[j] = a_new
        ycorr += (a_old - a_new) * x
    return alpha, ycorr


def sweep_exact_bayesr_ref(dm: DenseMarkers, alpha, delta, ycorr, vare,
                           sigma_sq, pi_mat, gumbel, zs):
    """The exact BayesR sweep, one dot product a marker as the JAX
    package's sweep_exact_bayesr; gumbel (p, 4), zs (p,)."""
    p = dm.X.shape[0]
    inv_vare = (1.0 / vare).reshape(())
    log_pi = torch.log(torch.clamp(pi_mat, 1e-12, 1.0))
    k_all = mk.bayesr_constants(dm.xpx[:p], inv_vare, sigma_sq)
    for j in range(p):
        x, xw = _obs_row(dm, j)
        sl = slice(j, j + 1)
        a_old = alpha[sl].clone()
        a_new, klass = mk.bayesr_update(
            (xw @ ycorr).reshape(1), a_old, dm.xpx[sl], inv_vare,
            mk.BayesRConstants(*(c[sl] for c in k_all)), log_pi[sl], gumbel[sl],
            zs[sl])
        alpha[sl], delta[sl] = a_new, klass
        ycorr += (a_old - a_new) * x
    return alpha, delta, ycorr
