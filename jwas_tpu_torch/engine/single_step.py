"""Single-step Bayesian regression (SSBR): genotypes of the non-genotyped
pedigree animals imputed from their genotyped relatives.

Counterpart of jwas_tpu/engine/single_step.py: _partitioned_a_inverse
(:41), _blocked_cg_spd (:78), _make_nn_solver (:130), _impute_genotypes
(:140), _add_term (:165), get_Hi (:181), apy_partition (:251),
apy_g_inverse (:269) and ssbr_setup (:301) (SSBR.jl, forSSBR.jl):

- A^-1 reordered to [non-genotyped; genotyped] (pedigree order within
  each), its blocks A_nn and A_ng, and the factor of A_nn, the column
  slice F_nn = hAi[:, nn] of Henderson's hAi ((U'U)[nn] = U[:, nn]' U[:, nn]);
- M_n = A_nn^-1 (-A_ng M_g) over the markers, by scipy's splu on the host
  up to 10,000 non-genotyped animals, as the reference does, and above
  that by a Jacobi-preconditioned CG with a block of right-hand sides in
  float64 on the chain's device (one CSR product an iteration for the
  block, stopped when every column's relative residual is below 1e-10);
- the J covariate, J_n = A_nn^-1 (-A_ng J_g) with J_g = -1, and the
  imputation residual epsilon, a random term over the non-genotyped
  animals with Vinv = A_nn, its factor F_nn and the total genetic
  variance; the EBVs gain J sol_J + epsilon (SSBR.jl:41-53).

Fault R14 (ROADMAP.md): the reference fills the imputed matrix of every
pedigree animal, (nn + ng, p), on the host (:156) before keeping the rows
of the data frame's individuals: 100,000 x 50,000 values for a 100,000-
animal pedigree. Here the imputation runs a chunk of markers at a time,
its width from the device's free memory, and writes only those rows,
straight into the marker-major dense store on the device that the chain
reads; the genotyped animals' store columns are copied, not recentred, as
the reference's aligned rows are.
"""

from __future__ import annotations

import time
import warnings
from typing import List

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import splu

from jwas_tpu_torch.models.model import Model, ModelTerm, set_covariate, set_random
from jwas_tpu_torch.ops.sparse_mme import csr, csr_diagonal

EPS_NAME = "ϵ"
SPLU_MAX_NN = 10_000        # splu on the host up to this; blocked CG above
CG_TOL = 1e-10              # the blocked CG's relative residual a column
CG_MAXITER = 2000
_CPU_WORK_BYTES = 1 << 28   # the imputation's working blocks on the CPU
_WORK_ARRAYS = 8            # (nn, chunk) float64 arrays of a CG chunk


def _partitioned_a_inverse(model: Model):
    """A^-1 with rows and columns ordered [non-genotyped; genotyped].
    Returns (Ai_nn, Ai_ng, nongeno_ids, geno_ids, F_nn), each ID list in
    the pedigree's order, F_nn = hAi[:, nongenotyped] (F_nn' F_nn = A_nn)."""
    ped = model.ped
    geno_set = set(model.M[0].obs_ids)
    missing = [s for s in model.M[0].obs_ids if s not in ped.id_index]
    if missing:
        raise ValueError(
            "not all genotyped individuals are in the pedigree "
            f"(e.g. {missing[:5]}); single-step requires genotyped ⊆ pedigree")
    nongeno_ids = [s for s in ped.ids if s not in geno_set]
    geno_ids = [s for s in ped.ids if s in geno_set]
    hAi = ped.a_inverse_factor()
    Ai = (hAi.T @ hAi).tocsc()
    perm = np.array([ped.id_index[s] for s in nongeno_ids + geno_ids], dtype=np.int64)
    Ai_perm = Ai[perm][:, perm].tocsc()
    nn = len(nongeno_ids)
    return (Ai_perm[:nn, :nn].tocsc(), Ai_perm[:nn, nn:].tocsc(), nongeno_ids, geno_ids,
            hAi[:, perm[:nn]].tocsc())


class CGInfo:
    """The blocked CG's iterations and worst final relative residual over
    every call (the imputation's, then J's)."""

    def __init__(self):
        self.iterations = 0
        self.worst = 0.0


def _blocked_cg_spd(A, B, tol: float = CG_TOL, maxiter: int = CG_MAXITER, info=None):
    """Jacobi-preconditioned CG with a block of right-hand sides B (nn, c)
    for the SPD CSR tensor A (nn, nn), float64, on A's device: step sizes a
    column, one CSR product an iteration for the block; stops when every
    column's relative residual ||r|| / ||b|| is below tol or after maxiter
    iterations (one read of the test an iteration). Warns when the worst
    residual is above 1e-6, as the reference does. info (CGInfo): adds
    its iterations and worst residual. Returns X (nn, c)."""
    D = csr_diagonal(A)
    Minv = 1.0 / torch.clamp(D, min=1e-300)
    X = torch.zeros_like(B)
    R = B.clone()
    Z = Minv[:, None] * R
    P = Z.clone()
    rz = (R * Z).sum(0)
    b_norm = torch.clamp(torch.sqrt((B * B).sum(0)), min=1e-300)
    it = 0
    for it in range(1, maxiter + 1):
        AP = A @ P
        denom = (P * AP).sum(0)
        pos = denom > 0
        alpha = torch.where(pos, rz / torch.where(pos, denom, 1.0), 0.0)
        X.add_(P * alpha[None, :])
        R.sub_(AP * alpha[None, :])
        del AP
        if bool((torch.sqrt((R * R).sum(0)) / b_norm < tol).all()):
            break
        Z = Minv[:, None] * R
        rz_new = (R * Z).sum(0)
        beta = rz_new / torch.where(rz > 0, rz, 1.0)
        P = Z.add_(P * beta[None, :])
        rz = rz_new
    res = torch.sqrt((R * R).sum(0)) / b_norm
    worst = float(res.max()) if res.numel() else 0.0
    if info is not None:
        info.iterations += it
        info.worst = max(info.worst, worst)
    if worst > 1e-6:
        warnings.warn(
            f"imputation CG did not fully converge: max relative residual "
            f"{worst:.2e} after {maxiter} iterations (tol {tol:.0e}); imputed "
            f"genotypes may be slightly biased — check the pedigree for "
            f"extreme inbreeding loops")
    return X


def _make_nn_solver(Ai_nn, device="cpu", info=None):
    """A solver B -> A_nn^-1 B for (nn, c) float64 tensors on device: the
    exact splu on the host up to SPLU_MAX_NN non-genotyped animals (as the
    reference), the blocked CG on device above it."""
    if Ai_nn.shape[0] <= SPLU_MAX_NN:
        lu = splu(sp.csc_matrix(Ai_nn))

        def solve(B):
            X = lu.solve(np.asarray(B.cpu().numpy(), dtype=np.float64))
            return torch.as_tensor(X.reshape(B.shape)).to(B.device)
        return solve
    A = csr(Ai_nn, torch.float64, device)
    return lambda B: _blocked_cg_spd(A, B, info=info)


def _impute_chunk_width(nn: int, p: int, device, reserve: int = 0) -> int:
    """Markers a chunk of the imputation: _WORK_ARRAYS (nn, chunk) float64
    arrays in half the device's free memory less reserve bytes (on the CPU
    in _CPU_WORK_BYTES)."""
    device = torch.device(device)
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0] - reserve
        budget = max(free // 2, 0)
    else:
        budget = _CPU_WORK_BYTES
    return int(max(1, min(p, budget // max(1, _WORK_ARRAYS * 8 * max(nn, 1)))))


def _impute_genotypes(g, solve_nn, Ai_ng, geno_ids, nongeno_ids, ids, chunk: int):
    """The dense store of the individuals ids, (p, len(ids)) in g.dense's
    dtype on its device (SSBR.jl:83-142): a genotyped individual's column
    is its column of g.dense, a non-genotyped one's its row of M_n =
    A_nn^-1 (-A_ng M_g), solved chunk markers at a time in float64 (fault
    R14: the rows of other pedigree animals are never kept)."""
    store = g.dense
    dev, dtype = store.device, store.dtype
    p = store.shape[0]
    col_of = {s: i for i, s in enumerate(g.obs_ids)}
    g_cols = torch.as_tensor([col_of[s] for s in geno_ids], dtype=torch.int64, device=dev)
    n_index = {s: i for i, s in enumerate(nongeno_ids)}
    is_g = np.array([s in col_of for s in ids], dtype=bool)
    out = torch.empty((p, len(ids)), dtype=dtype, device=dev)
    dst_g = torch.as_tensor(np.flatnonzero(is_g), device=dev)
    src_g = torch.as_tensor([col_of[s] for s, k in zip(ids, is_g) if k],
                            dtype=torch.int64, device=dev)
    dst_n = torch.as_tensor(np.flatnonzero(~is_g), device=dev)
    src_n = torch.as_tensor([n_index[s] for s, k in zip(ids, is_g) if not k],
                            dtype=torch.int64, device=dev)
    A_ng = csr(Ai_ng, torch.float64, dev)
    for c0 in range(0, p, chunk):
        c1 = min(p, c0 + chunk)
        Mg = store[c0:c1].index_select(1, g_cols).to(torch.float64).T    # (ng, c)
        Mn = solve_nn(-(A_ng @ Mg.contiguous()))                          # (nn, c)
        del Mg
        if dst_g.numel():
            out[c0:c1, dst_g] = store[c0:c1].index_select(1, src_g)
        if dst_n.numel():
            out[c0:c1, dst_n] = Mn.index_select(0, src_n).T.to(dtype)
        del Mn
    return out


def _add_term(model: Model, name: str) -> List[str]:
    """One ModelTerm a trait (add_term, SSBR.jl:164-170), each after its
    trait's last term: a trait's location columns stay contiguous, as the
    multi-trait engine needs (jwas_tpu appends them after every trait's
    terms; the set of location parameters is the same)."""
    added = []
    for m, lhs in enumerate(model.lhs_vec):
        term = ModelTerm(trm_str=f"{lhs}:{name}", i_model=m, trait_name=lhs,
                         factors=[name])
        model.terms.append(term)
        model.term_dict[term.trm_str] = term
        added.append(term.trm_str)
    model.terms.sort(key=lambda trm: trm.i_model)      # stable: equation order kept
    return added


def _genotype_rows(geno, rows) -> np.ndarray:
    """The host float64 (len(rows), p) genotypes of the store columns rows
    (a dense store's), or the relationship matrix's (rows, rows) block."""
    idx = torch.as_tensor(rows, dtype=torch.int64)
    if geno.grm is not None:
        G = geno.grm.index_select(0, idx.to(geno.grm.device)).index_select(
            1, idx.to(geno.grm.device))
        return G.to(torch.float64).cpu().numpy()
    if geno.dense is None:
        raise ValueError("get_Hi needs a dense store (storage 'f32', 'f64' or 'int8') "
                         "or a relationship matrix")
    return geno.dense.index_select(1, idx.to(geno.dense.device)).T.to(
        torch.float64).cpu().numpy()


def get_Hi(ped, geno, weight_for_G: float = 1.0):
    """H^-1 for single-step GBLUP (get_Hi, SSGBLUP.jl:2-36): Hi = Ai +
    [0 0; 0 inv(G) - inv(A_gg)] over [non-genotyped; genotyped], G the
    relationship matrix (geno.grm for GBLUP, else VanRaden's (M M' + 1e-5
    I) / p with the columns over sqrt(2pq)) blended as w G + (1 - w) A_gg.
    A_gg by chunked splu solves A[:, g] = Ai^-1 E_g. Returns (Hi scipy
    CSC, the IDs in that order); use it as set_random(model, "ID", G0,
    Vinv=Hi, names=ids)."""
    geno_set = set(geno.obs_ids)
    missing = [s for s in geno.obs_ids if s not in ped.id_index]
    if missing:
        raise ValueError(f"genotyped individuals missing from the pedigree: {missing[:5]}")
    nongeno_ids = [s for s in ped.ids if s not in geno_set]
    geno_ids = [s for s in ped.ids if s in geno_set]
    order = nongeno_ids + geno_ids
    perm = np.array([ped.id_index[s] for s in order], dtype=np.int64)
    Ai = ped.a_inverse()[perm][:, perm].tocsc()
    nn, n = len(nongeno_ids), len(order)
    ng = n - nn
    lu = splu(Ai)
    A_gg = np.empty((ng, ng))
    chunk = max(1, min(512, ng))
    for c0 in range(0, ng, chunk):
        c1 = min(c0 + chunk, ng)
        E = np.zeros((n, c1 - c0))
        E[nn + c0:nn + c1] = np.eye(c1 - c0)
        A_gg[:, c0:c1] = lu.solve(E)[nn:]
    A_gg = 0.5 * (A_gg + A_gg.T)
    row_of = {s: i for i, s in enumerate(geno.obs_ids)}
    rows = np.array([row_of[s] for s in geno_ids], dtype=np.int64)
    if geno.grm is not None:
        G = _genotype_rows(geno, rows)
    else:
        M = _genotype_rows(geno, rows)
        f = np.asarray(geno.allele_freq, dtype=np.float64)
        M = M / np.sqrt(np.maximum(2.0 * f * (1.0 - f), 1e-12))[None, :]
        G = (M @ M.T + 1e-5 * np.eye(ng)) / M.shape[1]
    if not 0.0 <= weight_for_G <= 1.0:
        raise ValueError("weight_for_G must be in [0, 1]")
    G = weight_for_G * G + (1.0 - weight_for_G) * A_gg
    try:
        np.linalg.cholesky(G)
    except np.linalg.LinAlgError:
        raise ValueError("the blended relationship matrix G is not positive "
                         "definite; lower weight_for_G or check the GRM") from None
    corr = np.linalg.inv(G) - np.linalg.inv(A_gg)
    Hi = Ai.tolil()
    Hi[nn:, nn:] = Hi[nn:, nn:] + corr
    return Hi.tocsc(), order


def apy_partition(ped, geno_ids, core_ids):
    """[non-genotyped; core; non-core genotyped] ID lists in pedigree order
    (the APY genoSet!, forSSBR.jl:58-99); core_ids must be genotyped."""
    geno_set = set(str(s) for s in geno_ids)
    core_set = set(str(s) for s in core_ids)
    bad = core_set - geno_set
    if bad:
        raise ValueError(f"core IDs not genotyped: {sorted(bad)[:5]}")
    nongeno = [s for s in ped.ids if s not in geno_set]
    core = [s for s in ped.ids if s in core_set]
    noncore = [s for s in ped.ids if s in geno_set and s not in core_set]
    return nongeno, core, noncore


def apy_g_inverse(G: np.ndarray, core_idx: np.ndarray) -> np.ndarray:
    """The APY inverse of a relationship matrix (Misztal 2014): non-core
    individuals conditionally independent given the core; exact when the
    core is everyone. Returns the (n, n) approximation of inv(G) in G's
    order."""
    n = G.shape[0]
    core_idx = np.asarray(core_idx, dtype=np.int64)
    mask = np.zeros(n, dtype=bool)
    mask[core_idx] = True
    non_idx = np.flatnonzero(~mask)
    Gcc = G[np.ix_(core_idx, core_idx)]
    Gcn = G[np.ix_(core_idx, non_idx)]
    Gcc_inv = np.linalg.inv(Gcc)
    W = Gcc_inv @ Gcn
    m_inv = 1.0 / (np.diag(G)[non_idx] - np.einsum("cm,cm->m", Gcn, W))
    Ginv = np.zeros_like(G)
    Ginv[np.ix_(core_idx, core_idx)] = Gcc_inv + (W * m_inv[None, :]) @ W.T
    Ginv[np.ix_(core_idx, non_idx)] = -W * m_inv[None, :]
    Ginv[np.ix_(non_idx, core_idx)] = Ginv[np.ix_(core_idx, non_idx)].T
    Ginv[non_idx, non_idx] = m_inv
    return Ginv


def ssbr_setup(model: Model, df_whole, opts, check_memory=None) -> dict:
    """The single-step transformation in place (SSBRrun, SSBR.jl:8-54):
    the marker set's dense store becomes that of df_whole's individuals
    (imputed where not genotyped; g.obs_ids their IDs), df_whole gains the
    J covariate and the epsilon column, the model the J and epsilon terms
    (a trait each), the epsilon random effect (Vinv = A_nn, its factor
    F_nn, G the total genetic variance) and J + epsilon in its EBVs'
    terms. check_memory(nn, chunk, n_rows): the caller's memory guard,
    called before the new store is allocated. Returns the seconds by part
    (partition, imputation, J), the non-genotyped count, the chunk width
    and the blocked CG's iterations and worst residual (0 under splu)."""
    if model.ped is None:
        raise ValueError("single-step analysis requires a pedigree")
    if not model.M:
        raise ValueError("single-step analysis requires genotypes")
    for g in model.M:
        if g.method == "GBLUP":
            raise ValueError("SSGBLUP is not supported; use SSBR with marker methods")
        if g.genetic_variance.val is None:
            raise ValueError("single-step requires the genetic variance: "
                             "get_genotypes(..., G) with G_is_marker_variance=False")
        if g.dense is None:
            raise ValueError("storage='2bit' does not support single-step analysis.")
    id_col = df_whole.columns[0]
    ids = [str(x) for x in df_whole[id_col].tolist()]
    not_in_ped = [s for s in ids if s not in model.ped.id_index]
    if not_in_ped:
        raise ValueError(f"{len(not_in_ped)} phenotyped/output individuals are not in the "
                         f"pedigree (e.g. {not_in_ped[:5]})")
    t0 = time.perf_counter()
    Ai_nn, Ai_ng, nongeno_ids, geno_ids, F_nn = _partitioned_a_inverse(model)
    info = CGInfo()
    t1 = time.perf_counter()
    g = model.M[0]
    dev = g.dense.device
    solve_nn = _make_nn_solver(Ai_nn, dev, info)
    nn, p = len(nongeno_ids), g.dense.shape[0]
    reserve = p * len(ids) * g.dense.element_size()
    chunk = _impute_chunk_width(nn, p, dev, reserve)
    if check_memory is not None:
        check_memory(nn, chunk, len(ids))
    store = _impute_genotypes(g, solve_nn, Ai_ng, geno_ids, nongeno_ids, ids, chunk)
    g.dense = store
    g.obs_ids = list(ids)
    g.n_obs = len(ids)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    imp_iters, imp_worst = info.iterations, info.worst
    t2 = time.perf_counter()
    fit_j = getattr(opts, "fitting_J_vector", True)
    if fit_j:
        row_of = {s: i for i, s in enumerate(nongeno_ids + geno_ids)}
        rows = np.array([row_of[s] for s in ids], dtype=np.int64)
        Jg = -np.ones(len(geno_ids))
        rhs = torch.as_tensor(-(Ai_ng @ Jg)).reshape(-1, 1).to(dev)
        Jn = solve_nn(rhs).reshape(-1).cpu().numpy()
        df_whole["J"] = np.concatenate([Jn, Jg])[rows]
        j_terms = _add_term(model, "J")
        set_covariate(model, "J")
    t3 = time.perf_counter()
    nongeno_set = set(nongeno_ids)
    df_whole[EPS_NAME] = np.array([s if s in nongeno_set else "missing" for s in ids],
                                  dtype=object)
    eps_terms = _add_term(model, EPS_NAME)
    g_total = np.asarray(model.M[0].genetic_variance.val, dtype=np.float64)
    set_random(model, EPS_NAME, float(g_total) if g_total.ndim == 0 else g_total,
               Vinv=Ai_nn, names=nongeno_ids, Vinv_factor=F_nn)
    if fit_j:
        model.ped_term_vec = list(model.ped_term_vec) + j_terms
    model.ped_term_vec = list(model.ped_term_vec) + eps_terms
    return dict(partition_s=t1 - t0, imputation_s=t2 - t1, J_s=t3 - t2, nongenotyped=nn,
                genotyped=len(geno_ids), chunk=chunk, cg_iterations=imp_iters,
                cg_worst_residual=imp_worst, J_cg_iterations=info.iterations - imp_iters,
                solver="splu" if nn <= SPLU_MAX_NN else "blocked CG")
