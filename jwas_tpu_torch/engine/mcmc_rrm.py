"""The random-regression model (RRM) of a longitudinal trait: data,
step, window and entry point.

Counterpart of jwas_tpu/engine/mcmc_rrm.py: RRMData (:38), RRMCfg (:52),
RRMState (:68), make_rrm_step (:82-163), RRMAccum and make_rrm_run_window
(:168-226), run_mcmc_rrm (:229-468) and _rrm_results (:471-571), with
Tables in place of DataFrames. Long data (ID, time, y) is mapped onto a
(ntimes, nind) grid, its unobserved cells pinned at 0. An outer iteration:

1. the location parameters: the LHS W'W plus the random effects' blocks
   (ops/location.py::assemble_lhs_lambda) and one pass of K6; W and W'
   are CSR (ops/sparse_mme.py::spmv, the same sums run after run) where
   jwas_tpu keeps a dense (n_obs, K) W (85,000 x 10,002 at 10,000 animals
   x 10 test days); W'W is dense, as K6 reads it;
2. ycorr scattered to the grid, the marker chain (ops/rrm.py::
   sweep_rrm_abc: K10 on the card, a chunk of markers against their
   cross-Grams, built once a run in set-up), the grid gathered back to
   ycorr;
3. pi over the 2^c labels, a Dirichlet draw on the label counts + 1 (the
   counts by a scatter-add), with BayesC / BayesB;
4. each random-effect group's covariance (an inverse Wishart; a group set
   with estimate_variance=False keeps its G, as the port's other steps do:
   fault R10), the residual variance, and the c x c marker covariance, an
   inverse Wishart over beta (BayesC / BayesB) or alpha.

The step makes no host sync: inv(varg) and the factorisations are the
unchecked forms, and the chain reads the device back once a saved sample.
The EBVs are the trajectory u = phi (alpha X) of every individual at every
time point, averaged over the saved samples on the device.

jwas_tpu's semantics are kept where they depart from JWAS's: BayesB runs
as BayesC (no per-marker variance, :113, :153) and BayesL as RR-BLUP (no
lambda draw): fault R15 (ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from jwas_tpu_torch.engine.mcmc import to_host
from jwas_tpu_torch.engine.output import _sd, check_finite_posteriors
from jwas_tpu_torch.engine.progress import ProgressPrinter, maybe_profile
from jwas_tpu_torch.engine.samples_io import RRMSampleStream
from jwas_tpu_torch.engine.setup import (MCMCOptions, normalize_method, not_ported,
                                         resolve_device)
from jwas_tpu_torch.engine.state import REGroupCfg
from jwas_tpu_torch.io.table import Table, as_table, to_numeric
from jwas_tpu_torch.models.design import build_design
from jwas_tpu_torch.ops import location
from jwas_tpu_torch.ops.dists import (sample_dirichlet, sample_inv_wishart,
                                      sample_scaled_inv_chi2)
from jwas_tpu_torch.ops.location import (assemble_lhs_lambda, gibbs_pass_lambda,
                                         symmetric_upper)
from jwas_tpu_torch.ops.rrm import (_labels, build_m_phiphi, build_rrm_cross_grams,
                                    pack_cross_grams, sweep_chunk, sweep_limit_error,
                                    sweep_rrm_abc)
from jwas_tpu_torch.ops.sparse_mme import csr, spmv

RRM_METHODS = ("BayesC", "BayesB", "RR-BLUP", "BayesL")
LABEL_METHODS = ("BayesC", "BayesB")      # those that draw the labels


class RRMData(NamedTuple):
    W: torch.Tensor           # (n_obs, K) location design, CSR
    Wt: torch.Tensor          # (K, n_obs) its transpose, CSR
    WtW: torch.Tensor         # (K, K) dense, exactly symmetric
    X: torch.Tensor           # (p, nind) centered genotypes, marker-major
    phi: torch.Tensor         # (ntimes, c)
    mphiphi: torch.Tensor     # (p, c, c)
    obs_mask: torch.Tensor    # (ntimes, nind) 1/0
    cell: torch.Tensor        # (n_obs,) int64: time * nind + individual
    Vinv: Tuple[Optional[torch.Tensor], ...] = ()   # a group's (q, q), None: I
    vc_scale: Tuple[torch.Tensor, ...] = ()         # a group's (k, k) prior scale
    cross_grams: Optional[torch.Tensor] = None      # K10's, packed (pack_cross_grams);
                                                    # None on the CPU (plain sweep)


@dataclass(frozen=True)
class RRMCfg:
    method: str
    n_obs: int
    n_markers: int
    ncoeff: int
    estimate_pi: bool
    estimate_marker_variance: bool
    estimate_residual_variance: bool
    df_residual: float
    df_marker: float
    scale_R: float
    re_groups: Tuple[REGroupCfg, ...] = ()


class RRMState(NamedTuple):
    gen: torch.Generator
    sol: torch.Tensor         # (K,)
    alpha: torch.Tensor       # (c, p)
    beta: torch.Tensor        # (c, p)
    delta: torch.Tensor       # (c, p) 0/1 in the chain's dtype
    ycorr: torch.Tensor       # (n_obs,)
    vare: torch.Tensor        # 0-d
    varg: torch.Tensor        # (c, c)
    pi: torch.Tensor          # (2^c,)
    marker_scale: torch.Tensor  # (c, c) prior scale
    vc: Tuple[torch.Tensor, ...] = ()   # a group's (k, k) covariance


def to_grid(data: RRMData, ycorr: torch.Tensor) -> torch.Tensor:
    """ycorr scattered to the (ntimes, nind) grid, the other cells 0."""
    grid = torch.zeros(data.obs_mask.numel(), dtype=ycorr.dtype, device=ycorr.device)
    grid[data.cell] = ycorr
    return grid.view(data.obs_mask.shape)


def from_grid(data: RRMData, grid: torch.Tensor) -> torch.Tensor:
    """The observed cells of the grid, in the data's order."""
    return grid.reshape(-1)[data.cell]


def location_system(cfg: RRMCfg, state: RRMState, data: RRMData):
    """The location pass's LHS (W'W plus the groups' G^-1 (x) Vinv vare
    blocks), its right-hand side W'(ycorr + W sol) and ycorr + W sol."""
    LHS = assemble_lhs_lambda(cfg.re_groups, data.WtW, data.Vinv, state.vc, state.vare)
    ycorr = state.ycorr + spmv(data.W, state.sol)
    return LHS, spmv(data.Wt, ycorr), ycorr


def rrm_step(cfg: RRMCfg, state: RRMState, data: RRMData) -> RRMState:
    """One outer iteration (jwas_tpu's make_rrm_step, :86-163), on the
    state's device with no host sync."""
    gen, dtype = state.gen, state.ycorr.dtype
    c = cfg.ncoeff
    LHS, rhs, ycorr = location_system(cfg, state, data)
    sol = gibbs_pass_lambda(LHS, state.sol, rhs, state.vare, gen)
    ycorr = ycorr - spmv(data.W, sol)

    Ginv = torch.linalg.inv_ex(state.varg)[0].contiguous()   # column-major on a card
    log_pi = torch.log(torch.clamp(state.pi, 1e-30, 1.0))
    alpha, beta, delta, grid = sweep_rrm_abc(
        data.X, data.phi, data.mphiphi, data.obs_mask, state.alpha, to_grid(data, ycorr),
        state.vare, Ginv, log_pi, gen, estimate_delta=cfg.method in LABEL_METHODS,
        cross_grams=data.cross_grams)
    ycorr = from_grid(data, grid)

    pi = state.pi
    if cfg.estimate_pi:
        bits = 2 ** torch.arange(c, device=delta.device)
        idx = (delta.to(torch.int64) * bits[:, None]).sum(0)
        counts = torch.zeros(2**c, dtype=dtype, device=delta.device)
        counts.index_add_(0, idx, torch.ones_like(idx, dtype=dtype))
        pi = sample_dirichlet(gen, counts + 1.0)

    vc = list(state.vc)
    for g, grp in enumerate(cfg.re_groups):
        if not grp.estimate_variance:
            continue
        q = grp.n_levels
        sols = torch.stack([sol[s:s + q] for s in grp.starts])
        S = sols @ (data.Vinv[g] @ sols.T) if grp.has_vinv else sols @ sols.T
        vc[g] = sample_inv_wishart(gen, grp.df + q, data.vc_scale[g] + 0.5 * (S + S.T))

    vare = state.vare
    if cfg.estimate_residual_variance:
        vare = sample_scaled_inv_chi2(gen, torch.sum(ycorr * ycorr), cfg.n_obs,
                                      cfg.df_residual, cfg.scale_R)
    varg = state.varg
    if cfg.estimate_marker_variance:
        dat = beta if cfg.method in LABEL_METHODS else alpha
        varg = sample_inv_wishart(gen, cfg.df_marker + cfg.n_markers,
                                  state.marker_scale + dat @ dat.T)
    return state._replace(sol=sol, alpha=alpha, beta=beta, delta=delta, ycorr=ycorr,
                          vare=vare, varg=varg, pi=pi, vc=tuple(vc))


class RRMAccum(NamedTuple):
    n: int
    sol_m: torch.Tensor
    sol_m2: torch.Tensor
    alpha_m: torch.Tensor
    alpha_m2: torch.Tensor
    delta_m: torch.Tensor
    vare_m: torch.Tensor
    vare_m2: torch.Tensor
    varg_m: torch.Tensor
    varg_m2: torch.Tensor
    pi_m: torch.Tensor
    pi_m2: torch.Tensor
    u_m: torch.Tensor          # (ntimes, nind) the EBV trajectories
    u_m2: torch.Tensor
    vc_m: Tuple[torch.Tensor, ...] = ()
    vc_m2: Tuple[torch.Tensor, ...] = ()


def init_accum(state: RRMState, data: RRMData) -> RRMAccum:
    z = torch.zeros_like
    u0 = z(data.obs_mask, dtype=state.ycorr.dtype)
    return RRMAccum(
        n=0, sol_m=z(state.sol), sol_m2=z(state.sol), alpha_m=z(state.alpha),
        alpha_m2=z(state.alpha), delta_m=z(state.alpha), vare_m=z(state.vare),
        vare_m2=z(state.vare), varg_m=z(state.varg), varg_m2=z(state.varg),
        pi_m=z(state.pi), pi_m2=z(state.pi), u_m=u0, u_m2=z(u0),
        vc_m=tuple(z(v) for v in state.vc), vc_m2=tuple(z(v) for v in state.vc))


def _welford(m, x, n):
    return m + (x - m) / n


def accumulate(accum: RRMAccum, state: RRMState, data: RRMData) -> RRMAccum:
    """The running means of a saved sample (jwas_tpu's run_window,
    :200-224), on the device; u = phi (alpha X)."""
    n = accum.n + 1
    u = data.phi @ (state.alpha @ data.X)
    pairs = dict(sol=state.sol, alpha=state.alpha, vare=state.vare, varg=state.varg,
                 pi=state.pi, u=u)
    out = {"n": n, "delta_m": _welford(accum.delta_m, state.delta, n)}
    for k, v in pairs.items():
        out[f"{k}_m"] = _welford(getattr(accum, f"{k}_m"), v, n)
        out[f"{k}_m2"] = _welford(getattr(accum, f"{k}_m2"), v * v, n)
    out["vc_m"] = tuple(_welford(m, v, n) for m, v in zip(accum.vc_m, state.vc))
    out["vc_m2"] = tuple(_welford(m, v * v, n) for m, v in zip(accum.vc_m2, state.vc))
    return RRMAccum(**out)


def run_window(cfg: RRMCfg, state: RRMState, data: RRMData, accum: RRMAccum,
               n_iters: int, accumulate_sample: bool = True):
    """n_iters outer iterations, then (accumulate_sample) the running means
    of the last state (jwas_tpu's run_window, :191-226)."""
    for _ in range(n_iters):
        state = rrm_step(cfg, state, data)
    if accumulate_sample:
        accum = accumulate(accum, state, data)
    return state, accum


def read_back(state: RRMState, stream: RRMSampleStream) -> Dict[str, np.ndarray]:
    """A saved sample's values on the host, in one transfer: vare, varg and
    pi, and what the sample files need (sol, alpha, the groups' vc<g>)."""
    parts = {"vare": state.vare, "varg": state.varg, "pi": state.pi}
    if stream.enabled:
        if stream.loc_slices:
            parts["sol"] = state.sol
        if stream.write_markers:
            parts["alpha"] = state.alpha
        parts.update((f"vc{g}", v) for g, v in enumerate(state.vc))
    return to_host(parts, state.alpha.dtype)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_mcmc_rrm(model, df, opts: MCMCOptions, device) -> Dict:
    """runMCMC(model, df, RRM=Phi) (MCMC_BayesianAlphabet_RRM,
    MCMC_BayesianAlphabet_RRM.jl:5-261; jwas_tpu's run_mcmc_rrm :229-468):
    long data with an ID column first, a 'time' column and the trait;
    Phi the (ntimes, c) basis over the data's sorted unique times
    (generate_full_phi). Genotypes on a dense store, BayesC, BayesB,
    RR-BLUP or BayesL; i.i.d., pedigree and Vinv random effects; float32
    or float64 (double_precision). Returns jwas_tpu's result keys as
    Tables, plus "_rrm": seconds by part and a window's seconds."""
    t_start = time.perf_counter()
    device = resolve_device(device)
    dtype = torch.float64 if opts.double_precision else torch.float32
    phi_np = np.asarray(opts.RRM, dtype=np.float64)
    if phi_np.ndim != 2:
        raise ValueError("RRM must be the (ntimes, ncoeff) Phi matrix")
    ntimes, ncoeff = phi_np.shape
    if model.n_models != 1:
        raise ValueError("RRM supports a single trait (long format)")
    df = as_table(df)
    if "time" not in df.columns:
        raise ValueError("RRM requires a 'time' column in the phenotype data")

    id_col = df.columns[0]
    ids_all = np.array([str(x).strip() for x in df[id_col].tolist()], dtype=object)
    yv = to_numeric(df[model.lhs_vec[0]], errors="coerce").astype(np.float64)
    keep = np.isfinite(yv)
    df = Table({col: df[col][keep] for col in df.columns})
    df[id_col] = ids_all[keep]
    yv = yv[keep]
    n_obs = len(yv)

    tv = to_numeric(df["time"], errors="raise").astype(np.float64)
    times = np.unique(tv)
    if len(times) != ntimes:
        raise ValueError(f"Phi has {ntimes} rows but the data has {len(times)} unique times")
    time_idx = np.searchsorted(times, tv).astype(np.int64)
    ids = list(dict.fromkeys(df[id_col].tolist()))
    ind_of = {s: i for i, s in enumerate(ids)}
    ind_idx = np.array([ind_of[s] for s in df[id_col].tolist()], dtype=np.int64)
    nind = len(ids)
    cell = time_idx * nind + ind_idx
    if len(np.unique(cell)) != n_obs:
        raise ValueError("duplicate (ID, time) observations in the data")

    # the location design over the long observations
    W_host = build_design(model, df).tocsr()
    K = W_host.shape[1]
    limit = location.pass_limit(device, dtype)
    if limit and K > limit:
        raise not_ported(
            f"{K} location parameters on the dense location path: the location "
            f"pass (K6) takes at most {limit} on {device}, and a dense model above "
            f"that", "a location pass above K6's limit")

    # random effects (i.i.d., V, pedigree A), jwas_tpu's defaults (:268-296)
    re_cfgs, Vinvs, vc_scales, vc0 = [], [], [], []
    for re in model.random_effects:
        terms = [model.term_dict[t] for t in re.term_array]
        q, k = terms[0].n_levels, len(re.term_array)
        if re.G.val is None:
            base = float(np.var(yv, ddof=1)) / 2.0
            re.G.val = np.eye(k) * base
            re.G.scale = np.asarray(re.G.val) * (re.G.df - k - 1.0)
        re_cfgs.append(REGroupCfg(
            starts=tuple(t.start_pos for t in terms), n_levels=q, df=float(re.G.df),
            has_vinv=re.Vinv is not None, random_type=re.random_type,
            estimate_variance=bool(re.G.estimate_variance)))
        Vinvs.append(None if re.Vinv is None else symmetric_upper(torch.as_tensor(
            np.asarray(re.Vinv.todense()), dtype=dtype).to(device)))
        vc_scales.append(np.atleast_2d(np.asarray(re.G.scale, dtype=np.float64)))
        vc0.append(np.atleast_2d(np.asarray(re.G.val, dtype=np.float64)))

    # genotypes, one store column an individual in the data's order
    if not model.M:
        raise ValueError("RRM currently requires genotypes")
    g0 = model.M[0]
    normalize_method(g0, model)
    if g0.method not in RRM_METHODS:
        raise ValueError(f"method {g0.method!r} is not supported with RRM")
    why = sweep_limit_error(nind, ntimes, ncoeff, dtype, device)
    if why is not None:
        raise not_ported(f"RRM with {why}", "the RRM chain (K10) above its limits")
    geno = g0.aligned_to(ids)
    p = geno.n_markers

    # priors (:309-347)
    vare0 = model.R.val
    if vare0 is None:
        vare0 = float(np.var(yv, ddof=1)) / 2.0
        model.R.val = vare0
        model.R.scale = vare0 * (model.R.df - 2.0) / model.R.df
    scale_R = float(model.R.scale)
    L = 2**ncoeff
    pi0 = np.zeros(L)
    if isinstance(g0.pi, dict):
        for pat, prob in g0.pi.items():
            pat = tuple(float(x) for x in pat)
            if len(pat) != ncoeff:
                raise ValueError("RRM Pi patterns must have ncoeff entries")
            pi0[sum(int(pat[k]) * 2**k for k in range(ncoeff))] = float(prob)
    else:
        pi0[-1] = 1.0
    gval = g0.G.val
    if gval is None:
        gv = g0.genetic_variance.val
        if gv is None:
            gv = np.eye(ncoeff) * float(np.var(yv, ddof=1)) / 2.0
        gv = np.atleast_2d(np.asarray(gv, dtype=np.float64))
        if gv.shape == (1, 1):
            gv = np.eye(ncoeff) * float(gv[0, 0])
        denom = np.zeros((ncoeff, ncoeff))
        for li, lab in enumerate(_labels(ncoeff)):
            denom += pi0[li] * np.outer(lab, lab)
        denom = denom * geno.sum2pq
        denom[denom == 0] = 1.0
        gval = gv / denom
    gval = np.atleast_2d(np.asarray(gval, dtype=np.float64))
    if gval.shape == (1, 1):
        gval = np.eye(ncoeff) * float(gval[0, 0])
    df_marker = float(g0.G.df) + ncoeff
    marker_scale = gval * (df_marker - ncoeff - 1.0)
    seconds = {"design": time.perf_counter() - t_start}

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    t0 = time.perf_counter()
    obs_mask = np.zeros((ntimes, nind))
    obs_mask[time_idx, ind_idx] = 1.0
    X = geno.dense.to(device=device, dtype=dtype)
    phi = t(phi_np)
    mask_t = t(obs_mask)
    mphiphi = build_m_phiphi(X, phi, mask_t)
    cross_grams = None
    if device.type == "cuda":
        cross_grams = pack_cross_grams(build_rrm_cross_grams(
            X, phi, mask_t, sweep_chunk(nind, ntimes, ncoeff, dtype, device)))
    _sync(device)
    seconds["phi_mphiphi"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = RRMCfg(
        method=geno.method, n_obs=n_obs, n_markers=p, ncoeff=ncoeff,
        estimate_pi=bool(g0.estimate_pi) and geno.method in LABEL_METHODS,
        estimate_marker_variance=bool(g0.G.estimate_variance),
        estimate_residual_variance=bool(model.R.estimate_variance),
        df_residual=float(model.R.df), df_marker=df_marker, scale_R=scale_R,
        re_groups=tuple(re_cfgs))
    data = RRMData(
        W=csr(W_host, dtype, device), Wt=csr(W_host.T.tocsr(), dtype, device),
        WtW=symmetric_upper(t((W_host.T @ W_host).toarray())), X=X, phi=phi,
        mphiphi=mphiphi, obs_mask=mask_t,
        cell=torch.as_tensor(cell, dtype=torch.int64).to(device), Vinv=tuple(Vinvs),
        vc_scale=tuple(t(v) for v in vc_scales), cross_grams=cross_grams)
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if opts.seed is None else int(opts.seed))
    state = RRMState(
        gen=gen, sol=torch.zeros(K, dtype=dtype, device=device),
        alpha=torch.zeros((ncoeff, p), dtype=dtype, device=device),
        beta=torch.zeros((ncoeff, p), dtype=dtype, device=device),
        delta=torch.ones((ncoeff, p), dtype=dtype, device=device),
        ycorr=t(yv), vare=t(float(vare0)), varg=t(gval), pi=t(pi0),
        marker_scale=t(marker_scale), vc=tuple(t(v) for v in vc0))
    _sync(device)
    seconds["workspace"] = time.perf_counter() - t0

    n_outer = max(1, opts.chain_length)
    burnin = opts.burnin
    osf = opts.output_samples_frequency
    if osf <= 0:
        osf = max(1, opts.chain_length // 1000)
    n_saved = max(1, (n_outer - burnin) // osf)

    t0 = time.perf_counter()
    accum = init_accum(state, data)
    stream = RRMSampleStream(model, geno, cfg, opts)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length)
    windows = []
    try:
        with maybe_profile(opts):
            if burnin > 0:
                state, accum = run_window(cfg, state, data, accum, burnin, False)
            for w in range(n_saved):
                tw = time.perf_counter()
                state, accum = run_window(cfg, state, data, accum, osf, True)
                host = read_back(state, stream)
                windows.append(time.perf_counter() - tw)
                stream.write_sample(host)
                progress.update(burnin + (w + 1) * osf, vare=host["vare"],
                                varg=host["varg"], pi=host["pi"])
    finally:
        stream.close()
    seconds["chain"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    host = {k: (v.cpu().numpy() if torch.is_tensor(v) else
                tuple(x.cpu().numpy() for x in v) if isinstance(v, tuple) else v)
            for k, v in accum._asdict().items()}
    results = rrm_results(model, geno, cfg, RRMAccum(**host), ids, times, opts)
    seconds["results"] = time.perf_counter() - t0
    results["_rrm"] = {"seconds": seconds, "windows": windows}
    return results


def rrm_results(model, geno, cfg: RRMCfg, accum: RRMAccum, ids, times, opts) -> Dict:
    """The result tables (jwas_tpu's _rrm_results, :471-571) from the
    host accumulators, written to output_folder as <key>.txt."""
    check_finite_posteriors(accum.vare_m)
    results: Dict[str, Table] = {}
    rows = [name.split(":", 2) for name in model.term_names()]
    results["location parameters"] = Table({
        "Trait": [r[0] for r in rows], "Effect": [r[1] for r in rows],
        "Level": [r[2] for r in rows],
        "Estimate": np.asarray(accum.sol_m, dtype=np.float64),
        "SD": np.asarray(_sd(accum.sol_m, accum.sol_m2), dtype=np.float64)})
    trait = model.lhs_vec[0]
    results["residual variance"] = Table({
        "Covariance": [f"{trait}_{trait}"], "Estimate": [float(accum.vare_m)],
        "SD": [float(_sd(accum.vare_m, accum.vare_m2))]})
    c, p = cfg.ncoeff, cfg.n_markers
    names = [str(i + 1) for i in range(c)]
    results[f"marker effects {geno.name}"] = Table({
        "Trait": np.repeat(np.asarray(names, dtype=object), p),
        "Marker_ID": np.tile(np.asarray(geno.marker_ids, dtype=object), c),
        "Estimate": np.asarray(accum.alpha_m).reshape(-1),
        "SD": _sd(accum.alpha_m, accum.alpha_m2).reshape(-1),
        "Model_Frequency": np.asarray(accum.delta_m).reshape(-1)})
    results[f"marker effects variances {geno.name}"] = Table({
        "Covariance": [f"{a}_{b}" for a in names for b in names],
        "Estimate": np.asarray(accum.varg_m).reshape(-1),
        "SD": _sd(accum.varg_m, accum.varg_m2).reshape(-1)})
    if cfg.estimate_pi:
        labels = ["[" + ", ".join(str(float((s >> k) & 1)) for k in range(c)) + "]"
                  for s in range(2**c)]
        results[f"pi_{geno.name}"] = Table({
            "pi": labels, "Estimate": np.asarray(accum.pi_m),
            "SD": _sd(accum.pi_m, accum.pi_m2)})
    for re, vc_m, vc_m2 in zip(model.random_effects, accum.vc_m, accum.vc_m2):
        vc_m = np.atleast_2d(np.asarray(vc_m))
        k = vc_m.shape[0]
        table = Table({
            "Covariance": [f"{re.term_array[i]}_{re.term_array[j]}"
                           for i in range(k) for j in range(k)],
            "Estimate": vc_m.reshape(-1),
            "SD": np.atleast_2d(_sd(vc_m, np.asarray(vc_m2))).reshape(-1)})
        if re.random_type == "A":
            results["polygenic effects covariance matrix"] = table
        else:
            results[f"random effect variances {re.term_array[0]}"] = table
    u_m = np.asarray(accum.u_m)
    results["EBV_trajectory"] = Table({
        "ID": np.tile(np.asarray(ids, dtype=object), len(times)),
        "time": np.repeat(np.asarray(times, dtype=np.float64), len(ids)),
        "EBV": u_m.reshape(-1),
        "PEV": (_sd(accum.u_m, accum.u_m2) ** 2).reshape(-1)})
    if opts.output_folder:
        os.makedirs(opts.output_folder, exist_ok=True)
        for key, table in results.items():
            safe = key.replace(" ", "_").replace("*", ".")
            table.to_csv(os.path.join(opts.output_folder, safe + ".txt"))
    return results
