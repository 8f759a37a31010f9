"""The sparse location MME: CSR operators, a Jacobi-preconditioned CG and
the joint perturbation-optimization (PO) draw of the location parameters.

Counterpart of jwas_tpu/ops/sparse_mme.py: SparseREGroup (:43), SparseLoc
(:55), w_matvec (:73), w_rhs (:79), _vinv_matvec (:85), prior_matvec
(:92), mme_matvec (:109), mme_diag (:121), cg_solve (:136),
sample_location_po (:149) and build_sparse_loc (:191).

A single-trait model above 20,000 location levels (a large pedigree,
single-step's imputation residual) keeps its (n, K) design W and each
random-effect structure Vinv as torch.sparse_csr_tensors on the chain's
device, with W' stored beside W (never transposed a call), and each
group's factor F (Vinv = F'F: Henderson's hAi for a pedigree, its column
slice for single-step's epsilon) stored as F'. The lambda-MME operator is

    A x = W' R^-1 W x + sum_g (G_g^-1 (x) Vinv_g) x vare

applied as CSR products (spmv: each row's products summed in order by
torch.segment_reduce, never a scatter-add), which give the same sums run
after run, so a chain repeats itself for a seed. The location draw is
the exact joint draw of jwas_tpu:

    e   = sqrt(vare) W' R^-1/2 z0 + vare sum_g (L_g (x) F_g') z_g,
    sol = A^-1 (rhs + e)  ~  N(A^-1 rhs, vare A^-1),

L_g the Cholesky factor of G_g^-1, solved by Jacobi-preconditioned CG
from the previous draw. sample_location_po_from_normals takes its normals
z0 (n_obs,) and z_g (k, m_g) as inputs (the tests feed jwas_tpu's);
sample_location_po draws them from the chain's generator.

The CG is jax.scipy.sparse.linalg.cg's iteration (stop when ||r||^2 <=
tol^2 ||b||^2 or after maxiter iterations) with the stopping test kept on
the device: an iteration of a converged system changes nothing (its step
is masked to 0), so the host reads the test only every few iterations
(CGStats.check_every, the first read after as many iterations as the last
solve took) and the solution is the one jwas_tpu's loop stops at. Fault
R3 (ROADMAP.md): jwas_tpu discards the residual (:144), so a draw that did
not converge passes silently; CGStats keeps, on the device, the number of
solves that stopped at maxiter unconverged and the worst relative
residual, which the chain reads with its saved samples and warns about
at the end of the run.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def csr(M, dtype, device) -> torch.Tensor:
    """A scipy sparse matrix as a torch.sparse_csr_tensor of dtype on
    device, canonical (duplicates summed, columns sorted): int64 indices on
    the card (torch's default; int32 ones met an illegal memory access in
    cuSPARSE at 100,001 levels on an H100), int32 on the CPU (torch's fast
    CSR product takes only those)."""
    import scipy.sparse as sp

    device = torch.device(device)
    M = sp.csr_matrix(M, copy=True)
    M.sum_duplicates()
    M.sort_indices()
    idx = np.int32 if device.type == "cpu" and max(M.shape + (M.nnz,)) < 2**31 else np.int64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)      # "beta state"
        return torch.sparse_csr_tensor(
            torch.as_tensor(M.indptr.astype(idx)), torch.as_tensor(M.indices.astype(idx)),
            torch.as_tensor(M.data, dtype=dtype), size=M.shape,
            check_invariants=False).to(device)


def spmv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M x for a CSR tensor M (r, c) and x (c,) or (c, k), the same sums
    run after run. On the card each entry's product is gathered and each
    row's products summed in order by torch.segment_reduce: cuSPARSE's CSR
    SpMV and SpMM, which torch's M @ x calls there, split a long row (W''s
    intercept row, 30,000 entries at phase 13a's shape) among threads
    differently from run to run, even under
    torch.use_deterministic_algorithms (H100, torch 2.11). On the CPU torch's
    CSR product sums a row in order."""
    if M.device.type == "cpu":
        return M @ x
    crow, col, val = M.crow_indices(), M.col_indices(), M.values()
    prod = val * x[col] if x.dim() == 1 else val[:, None] * x[col]
    return torch.segment_reduce(prod, "sum", offsets=crow, axis=0)


def csr_diagonal(A: torch.Tensor) -> torch.Tensor:
    """The diagonal of a square CSR tensor."""
    crow, col, val = A.crow_indices(), A.col_indices(), A.values()
    rows = torch.repeat_interleave(torch.arange(A.shape[0], device=val.device),
                                   crow[1:] - crow[:-1])
    D = torch.zeros(A.shape[0], dtype=val.dtype, device=val.device)
    on = rows == col
    D[rows[on]] = val[on]
    return D


def csr_bytes(T: Optional[torch.Tensor]) -> int:
    """Bytes of a CSR tensor's three arrays (0 for None)."""
    if T is None:
        return 0
    return sum(a.numel() * a.element_size()
               for a in (T.crow_indices(), T.col_indices(), T.values()))


class SparseREGroup(NamedTuple):
    """A random-effect group's sparse structure: Vinv (q, q) CSR and the
    transposed factor Ft = F' (q, m) CSR, F (m, q) with Vinv = F'F; both
    None for the identity; v_diag (q,) the diagonal of Vinv (ones for the
    identity)."""

    V: Optional[torch.Tensor]
    Ft: Optional[torch.Tensor]
    v_diag: torch.Tensor


class CGStats:
    """On-device counters of the PO draws' CG solves (fault R3): solves,
    iterations, solves that stopped at maxiter above the tolerance
    (not_converged) and the worst final relative residual sqrt(r'r / b'b)
    (worst). read() is one transfer; the chain reads it with a saved
    sample. last_iters (host) is the last solve's iteration count, read at
    its final check; check_every is the host's interval between reads of
    the stopping test."""

    check_every = 8

    def __init__(self, device):
        self.solves = torch.zeros((), dtype=torch.int64, device=device)
        self.iters = torch.zeros((), dtype=torch.int64, device=device)
        self.not_converged = torch.zeros((), dtype=torch.int64, device=device)
        self.worst = torch.zeros((), dtype=torch.float64, device=device)
        self.last_iters = 0
        self.host_reads = 0
        self.host = None          # the chain's last read of the counters

    def tensors(self):
        return (self.solves, self.iters, self.not_converged, self.worst)

    def read(self) -> dict:
        v = torch.stack([t.to(torch.float64) for t in self.tensors()]).cpu().tolist()
        return dict(solves=int(v[0]), iterations=int(v[1]), not_converged=int(v[2]),
                    worst_residual=float(v[3]), host_reads=self.host_reads)


class SparseLoc(NamedTuple):
    """The single-trait location design and random-effect structure on a
    device: W (n, K) and Wt = W' (K, n) CSR, diag_w (K,) diag(W'R^-1W),
    free (K,) 1.0 for an active equation (a level with data or a random
    effect's; an empty fixed-effect level is pinned at 0, as the
    reference's Gibbs skips zero diagonals, solver.jl:146), rinv (n,) or
    None, a SparseREGroup a group and the CG's counters."""

    W: torch.Tensor
    Wt: torch.Tensor
    diag_w: torch.Tensor
    free: torch.Tensor
    rinv: Optional[torch.Tensor]
    groups: Tuple[SparseREGroup, ...]
    stats: CGStats

    @property
    def n_obs(self) -> int:
        return self.W.shape[0]

    @property
    def n_loc(self) -> int:
        return self.W.shape[1]


def w_matvec(sl: SparseLoc, x):
    """W x -> (n_obs,)."""
    return spmv(sl.W, x)


def w_rhs(sl: SparseLoc, v):
    """W' v -> (K,)."""
    return spmv(sl.Wt, v)


def _vinv_matmul(grp: SparseREGroup, X):
    """Vinv X for X (q, k) (the identity when the group has none)."""
    return X if grp.V is None else spmv(grp.V, X)


def prior_matvec(re_cfgs, groups, x, gis, vare):
    """sum_g (G_g^-1 (x) Vinv_g) x vare over the location layout: for each
    group one CSR product of Vinv with its k terms' slices."""
    out = torch.zeros_like(x)
    for cfg, grp, Gi in zip(re_cfgs, groups, gis):
        q = cfg.n_levels
        X = torch.stack([x[s:s + q] for s in cfg.starts], 1)        # (q, k)
        V = _vinv_matmul(grp, X)
        acc = (V @ (Gi * vare).T).T                                   # (k, q)
        for i, s in enumerate(cfg.starts):
            out[s:s + q] += acc[i]
    return out


def mme_matvec(sl: SparseLoc, re_cfgs, x, gis, vare):
    """A x for the lambda-MME; a pinned (non-free) coordinate acts as an
    identity row, which keeps the operator SPD."""
    xm = sl.free * x
    wv = spmv(sl.W, xm)
    if sl.rinv is not None:
        wv = sl.rinv * wv
    out = spmv(sl.Wt, wv) + prior_matvec(re_cfgs, sl.groups, xm, gis, vare)
    return sl.free * out + (1.0 - sl.free) * x


def mme_diag(sl: SparseLoc, re_cfgs, gis, vare):
    """diag(A), the Jacobi preconditioner; 1 on pinned rows."""
    d = sl.diag_w.clone()
    for cfg, grp, Gi in zip(re_cfgs, sl.groups, gis):
        q = cfg.n_levels
        for i, s in enumerate(cfg.starts):
            d[s:s + q] += (Gi[i, i] * vare) * grp.v_diag
    return torch.where(sl.free > 0, torch.clamp(d, min=1e-30), torch.ones_like(d))


def cg_solve(sl: SparseLoc, re_cfgs, b, gis, vare, x0=None, tol: float = 1e-8,
             maxiter: int = 200, stats: Optional[CGStats] = None):
    """Jacobi-preconditioned CG on the lambda-MME (jax.scipy.sparse.linalg.
    cg's iteration, from x0, default 0): stops once ||r||^2 <= tol^2
    ||b||^2 or after maxiter iterations. The test lives on the device
    (a converged system's steps are 0) and the host reads it after as many
    iterations as the previous solve took, then every stats.check_every.
    stats (default sl.stats) counts the solve (fault R3). Returns free x."""
    stats = sl.stats if stats is None else stats
    d = mme_diag(sl, re_cfgs, gis, vare)
    b = sl.free * b
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mme_matvec(sl, re_cfgs, x, gis, vare)
    z = r / d
    p = z.clone()
    gamma = torch.dot(r, z)
    bs = torch.dot(b, b)
    atol2 = (tol * tol) * bs
    rs = torch.dot(r, r)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = 0
    chunk = max(stats.check_every, stats.last_iters)
    while done < maxiter:
        for _ in range(min(chunk, maxiter - done)):
            active = rs > atol2
            Ap = mme_matvec(sl, re_cfgs, p, gis, vare)
            pAp = torch.dot(p, Ap)
            alpha = torch.where(active & (pAp != 0), gamma / torch.where(pAp != 0, pAp, 1.0),
                                zero)
            x.add_(alpha * p)
            r.sub_(alpha * Ap)
            z = r / d
            gamma_new = torch.dot(r, z)
            beta = torch.where(active & (gamma != 0),
                               gamma_new / torch.where(gamma != 0, gamma, 1.0), zero)
            p = torch.where(active, z + beta * p, p)
            gamma = torch.where(active, gamma_new, gamma)
            rs = torch.where(active, torch.dot(r, r), rs)
            k += active.to(torch.int64)
        done += min(chunk, maxiter - done)
        chunk = stats.check_every
        stats.host_reads += 1
        going, stats.last_iters = torch.stack([(rs > atol2).to(torch.int64), k]).tolist()
        if not going:
            break
    rel = torch.sqrt(rs / torch.where(bs > 0, bs, 1.0)).to(torch.float64)
    stats.solves += 1
    stats.iters += k
    stats.not_converged += (~(rs <= atol2)).to(torch.int64)     # NaN counts
    torch.maximum(stats.worst, rel, out=stats.worst)
    return sl.free * x


def po_perturbation(sl: SparseLoc, re_cfgs, vare, chols, z0, zs):
    """The PO draw's perturbation e = sqrt(vare) W' R^-1/2 z0 + vare
    sum_g (L_g (x) F_g') z_g, z0 (n_obs,), z_g (k, m_g) (m_g the factor's
    rows, q for an identity group)."""
    if sl.rinv is not None:
        z0 = torch.sqrt(sl.rinv) * z0
    e = torch.sqrt(vare) * spmv(sl.Wt, z0)
    for cfg, grp, L, z in zip(re_cfgs, sl.groups, chols, zs):
        q, k = cfg.n_levels, len(cfg.starts)
        fz = z if grp.Ft is None else spmv(grp.Ft, z.T).T              # (k, q)
        contrib = vare * (L[:k, :k] @ fz)
        for i, s in enumerate(cfg.starts):
            e[s:s + q] += contrib[i]
    return e


def sample_location_po_from_normals(sl: SparseLoc, re_cfgs, rhs, gis, vare, chols,
                                    z0, zs, x0=None, tol: float = 1e-8,
                                    maxiter: int = 200):
    """One exact joint draw sol ~ N(A^-1 rhs, vare A^-1) from the normals
    z0 (n_obs,) and zs (a (k, m_g) a group). gis: each group's G^-1,
    chols: their lower Cholesky factors."""
    e = po_perturbation(sl, re_cfgs, vare, chols, z0, zs)
    return cg_solve(sl, re_cfgs, rhs + e, gis, vare, x0=x0, tol=tol, maxiter=maxiter)


def draw_normals(gen, sl: SparseLoc, re_cfgs, dtype):
    """The PO draw's normals from the chain's generator: z0 (n_obs,), then a
    (k, m_g) a group."""
    dev = sl.free.device
    z0 = torch.randn(sl.n_obs, generator=gen, dtype=dtype, device=dev)
    zs = [torch.randn((len(cfg.starts), cfg.factor_rows if cfg.has_vinv else cfg.n_levels),
                      generator=gen, dtype=dtype, device=dev) for cfg in re_cfgs]
    return z0, zs


def sample_location_po(gen, sl: SparseLoc, re_cfgs, rhs, gis, vare, chols, x0=None,
                       tol: float = 1e-8, maxiter: int = 200):
    """sample_location_po_from_normals with its normals drawn from gen."""
    z0, zs = draw_normals(gen, sl, re_cfgs, rhs.dtype)
    return sample_location_po_from_normals(sl, re_cfgs, rhs, gis, vare, chols, z0, zs,
                                           x0=x0, tol=tol, maxiter=maxiter)


def group_factor(grp):
    """A group's factor F with Vinv = F'F as scipy CSR: its Vinv_factor
    (set_random: hAi for a pedigree; ssbr_setup: hAi's column slice for
    epsilon), else the transposed Cholesky factor of Vinv (the reference's
    dense fallback, :234-239); None for the identity."""
    import scipy.sparse as sp

    if grp.Vinv is None:
        return None
    F = getattr(grp, "Vinv_factor", None)
    if F is not None:
        return sp.csr_matrix(F)
    V = grp.Vinv.toarray() if sp.issparse(grp.Vinv) else np.asarray(grp.Vinv)
    return sp.csr_matrix(np.linalg.cholesky(V).T)


def build_sparse_loc(W_csr, rinv_np, re_groups, re_cfgs, dtype=torch.float32,
                     device="cpu") -> SparseLoc:
    """A SparseLoc from a scipy CSR design (n, K), the residual weights
    rinv (n,) or None, the workspace's groups (REGroupData: Vinv scipy
    sparse or None, Vinv_factor) and their REGroupCfgs. free: a column
    with data (diag(W'R^-1W) > 0) or in a random effect."""
    import scipy.sparse as sp

    W = sp.csr_matrix(W_csr)
    K = W.shape[1]
    r = np.ones(W.shape[0]) if rinv_np is None else np.asarray(rinv_np, dtype=np.float64)
    Wc = W.tocoo()
    diag_w = np.zeros(K)
    np.add.at(diag_w, Wc.col, (Wc.data ** 2) * r[Wc.row])
    free = (diag_w > 0).astype(np.float64)
    groups = []
    for grp, cfg in zip(re_groups, re_cfgs):
        q = cfg.n_levels
        for s in cfg.starts:
            free[s:s + q] = 1.0
        if grp.Vinv is None:
            groups.append(SparseREGroup(V=None, Ft=None,
                                        v_diag=torch.ones(q, dtype=dtype, device=device)))
            continue
        V = sp.csr_matrix(grp.Vinv)
        groups.append(SparseREGroup(
            V=csr(V, dtype, device), Ft=csr(group_factor(grp).T, dtype, device),
            v_diag=torch.as_tensor(V.diagonal(), dtype=dtype).to(device)))
    return SparseLoc(
        W=csr(W, dtype, device), Wt=csr(W.T, dtype, device),
        diag_w=torch.as_tensor(diag_w, dtype=dtype).to(device),
        free=torch.as_tensor(free, dtype=dtype).to(device),
        rinv=None if rinv_np is None else torch.as_tensor(r, dtype=dtype).to(device),
        groups=tuple(groups), stats=CGStats(device))
