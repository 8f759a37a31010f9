"""Single-trait BayesC, BayesB and BayesR on the 2-bit packed store: Gibbs
step, chain loop, runMCMC.

Counterpart of jwas_tpu/engine/mcmc.py, trimmed to the path that runMCMC
takes for storage='2bit' genotypes on one device (:786-868):
STData (:50), make_st_step (:113-527: the location pass :180-185, the
packed grouped BayesC/B branch :191-210 and BayesR branch :321-347, pi
:438-443, the marker variance :446-472, its scale :476-484, the residual
variance :509-518), make_run_window (:580-668), _init_accum (:671),
_apply_update_priors (:691-715), _build_st_data_and_state (:762-868, the
state :1128-1224) and the single-chain loop of runMCMC (:1435-1569).

Two entry points share the chain loop (run_chain) and the initial state:
runMCMC(model, df, ...) takes a model from build_model and the phenotypes
and returns the result tables, as jwas_tpu's does; run_st takes a store set
up by setup_markers and the priors explicitly and returns numpy posterior
means. BayesB runs BayesC's sweep with one variance a marker. The EBVs of
the output IDs are the output IDs' rows of the X alpha pass over the store
(K5), in place of jwas_tpu's dense (n_out, p) decode (:600-601).
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from jwas_tpu_torch.engine.output import build_results
from jwas_tpu_torch.engine.progress import ProgressPrinter, maybe_profile
from jwas_tpu_torch.engine.samples_io import STSampleStream
from jwas_tpu_torch.engine.setup import (MCMCOptions, Workspace,
                                         prepare_workspace, reject_unported)
from jwas_tpu_torch.engine.state import ChainState, EngineCfg
from jwas_tpu_torch.engine.validation import validate_args
from jwas_tpu_torch.io.genotypes import DEFAULT_BAYESR_PI, bayesr_pi  # noqa: F401
from jwas_tpu_torch.io.packed import Packed2BitStore, store_has_missing
from jwas_tpu_torch.models.model import Model, describe
from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops.grouped import (
    GroupedPackedMarkers,
    build_grouped_markers,
    grouped_matvec,
    grouped_matvec_store,
    plan_store,
    sweep_blocks_abc_grouped,
    sweep_blocks_bayesr_grouped,
)
from jwas_tpu_torch.ops.location import gibbs_pass_lambda
from jwas_tpu_torch.ops.variance import (
    sample_marker_variance_bayesb,
    sample_marker_variance_bayesr,
    sample_marker_variance_common,
    sample_pi_abc,
    sample_pi_bayesr,
    sample_residual_variance_st,
    sample_scale_bayesb,
    sample_scale_st,
)

METHODS = ("BayesC", "BayesB", "BayesR")


class STData(NamedTuple):
    """Static device data of a single-trait chain."""

    W: torch.Tensor            # (n, K) location design
    WtW: torch.Tensor          # (K, K) location LHS (no random effects)
    y: torch.Tensor            # (n,)
    gm: GroupedPackedMarkers
    scale_r: torch.Tensor      # 0-d residual-variance prior scale
    ebv_rows: Optional[torch.Tensor]  # (n_out,) store columns of the EBVs'
                                      # IDs; None: the training rows
    out_W: Optional[torch.Tensor]     # (n_out, K) prediction-equation rows,
                                      # None when it has no terms


class SampleOut(NamedTuple):
    vare: torch.Tensor
    varg: torch.Tensor         # BayesB: the mean over the real markers
    pi: torch.Tensor           # BayesC 0-d P(excluded), BayesR (4,)
    ebv: torch.Tensor          # (n_out,) EBVs (run_st: the training rows)
    genvar: torch.Tensor
    h2: torch.Tensor


class Accum(NamedTuple):
    """Running posterior means (Welford, output.jl:556-604)."""

    n: float
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
    scale_m: torch.Tensor
    scale_m2: torch.Tensor
    ebv_m: torch.Tensor
    ebv_m2: torch.Tensor


class ChainPlan(NamedTuple):
    """Outer iterations of a chain (JWAS.jl:313, exact accounting)."""

    nreps: int                 # effective sweeps an outer iteration
    burnin_outer: int
    thin_outer: int            # outer iterations a saved sample
    n_saved: int


def chain_plan(chain_length: int, burnin: int, output_samples_frequency: int,
               nreps: int) -> ChainPlan:
    n_outer = max(1, chain_length // nreps)
    burnin_outer = burnin // nreps
    osf = output_samples_frequency
    if osf <= 0:
        osf = max(1, chain_length // 1000)
    thin_outer = max(1, osf // nreps)
    return ChainPlan(nreps, burnin_outer, thin_outer,
                     max(1, (n_outer - burnin_outer) // thin_outer))


def resolve_device(device) -> torch.device:
    """The chain's device: the GPU unless the caller asks for another; a
    missing GPU raises (the CPU is never taken silently)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false); pass "
            "device='cpu' to run the plain versions on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def setup_markers(store: Packed2BitStore, obs_ids, device="cuda",
                  fast_blocks=True, host_offload=False) -> GroupedPackedMarkers:
    """Block sizes, row order, residence and Gram tiles for a store, as
    runMCMC picks them for storage='2bit' (jwas_tpu/engine/mcmc.py:786-844).

    device: where the chain lives; the GPU unless the caller asks for
    another (see resolve_device). A store whose packed bytes are a tensor
    on that device is used in place. fast_blocks: True or False for the
    default block size (from the number of observations) or an int block
    size. host_offload: True, False or "auto" (runMCMC's
    host_offload_genotypes): whether the store streams from pinned host
    memory, as many of its leading groups on the device as fit
    (ops/grouped.py::plan_device_groups; JWAS_HBM_BYTES sets the budget,
    hybrid_budget makes one for a chosen split). A numpy or memmap
    store that streams is copied into pinned host memory in chunks. The
    exact bf16 Gram path is taken when the store has no missing codes and
    no row permutation is needed.
    """
    device = resolve_device(device)
    n = len(obs_ids)
    b, gb, host, _ = plan_store(n, store.packed, fast_blocks, host_offload,
                                device, warn=True)
    index = {s: i for i, s in enumerate(store.obs_ids)}
    try:
        perm = np.asarray([index[s] for s in obs_ids], dtype=np.int64)
    except KeyError as e:
        raise ValueError(f"individual {e} has no genotypes") from None
    if len(perm) == store.n_obs and (perm == np.arange(store.n_obs)).all():
        perm = None
    has_missing = (store.has_missing if store.has_missing is not None
                   else store_has_missing(store.packed))
    return build_grouped_markers(
        store.packed, store.means, n, b, gb, device, row_perm=perm,
        has_missing=has_missing, host=host,
    )


def make_st_step(cfg: EngineCfg):
    """One outer iteration: location pass, grouped marker sweep (nreps
    effective sweeps), pi, marker variance, its scale, residual variance.
    The marker state and ycorr of the returned state are the input's
    tensors, updated in place. BayesB is BayesC's sweep with one variance a
    marker."""
    bayesr = cfg.method == "BayesR"
    bayesb = cfg.method == "BayesB"

    def step(state: ChainState, data: STData) -> ChainState:
        gen, gm = state.gen, data.gm

        # 1. location parameters (MCMC_BayesianAlphabet.jl:196-220)
        ycorr = state.ycorr + data.W @ state.sol
        sol = gibbs_pass_lambda(data.WtW, state.sol, data.W.T @ ycorr,
                                state.vare, gen)
        ycorr -= data.W @ sol

        # 2. marker effects: group-sequential packed sweep (in place)
        real = gm.valid > 0
        beta = state.beta
        if bayesr:
            pad_row = torch.tensor([1.0, 0.0, 0.0, 0.0], device=real.device)
            pi_mat = torch.where(real[:, None], state.pi[None, :], pad_row)
            alpha, delta, ycorr = sweep_blocks_bayesr_grouped(
                gm, state.alpha, state.delta, ycorr, state.vare, state.varg,
                pi_mat, gen, nreps=cfg.nreps, sync_every=cfg.sync_every,
            )
        else:
            alpha, beta, delta, ycorr = sweep_blocks_abc_grouped(
                gm, state.alpha, state.beta, state.delta, ycorr, state.vare,
                state.varg, state.pi, gen, nreps=cfg.nreps,
                sync_every=cfg.sync_every,
            )

        # 2b. pi (Pi.jl:7-17)
        pi = state.pi
        if cfg.estimate_pi and bayesr:
            pi = sample_pi_bayesr(gen, delta, gm.valid)
        elif cfg.estimate_pi:
            pi_s = sample_pi_abc(gen, delta, cfg.n_markers, gm.valid)
            pi = torch.where(real, pi_s, torch.ones_like(pi))

        # 2c. marker-effect variance (variance_components.jl:151-189)
        varg = state.varg
        if cfg.estimate_marker_variance and bayesr:
            varg = sample_marker_variance_bayesr(gen, alpha, delta,
                                                 cfg.df_marker, state.scale_g)
        elif cfg.estimate_marker_variance and bayesb:
            varg = sample_marker_variance_bayesb(gen, beta, cfg.df_marker,
                                                 state.scale_g)
        elif cfg.estimate_marker_variance:
            nloci = torch.sum(torch.where(real, delta, torch.zeros_like(delta)))
            varg = sample_marker_variance_common(gen, alpha, nloci,
                                                 cfg.df_marker, state.scale_g)

        # 2d. prior scale of the marker-effect variance
        scale_g = state.scale_g
        if cfg.estimate_scale and bayesb:
            scale_g = sample_scale_bayesb(gen, varg, gm.valid, cfg.n_markers,
                                          cfg.df_marker)
        elif cfg.estimate_scale:
            scale_g = sample_scale_st(gen, varg, cfg.df_marker)

        # 3. residual variance
        vare = state.vare
        if cfg.estimate_residual_variance:
            vare = sample_residual_variance_st(gen, ycorr, cfg.n_obs,
                                               cfg.df_residual, data.scale_r)

        return ChainState(gen=gen, sol=sol, alpha=alpha, beta=beta,
                          delta=delta, ycorr=ycorr, vare=vare, varg=varg,
                          pi=pi, scale_g=scale_g)

    return step


def _welford(m, x, n):
    return m + (x - m) / n


def _pi_summary(cfg: EngineCfg, state: ChainState):
    """The pi a sample reports: BayesR's (4,) class prior, BayesC's and
    BayesB's P(excluded) of the first marker (their common value when pi
    is estimated)."""
    return state.pi if cfg.method == "BayesR" else state.pi[0]


def _varg_summary(cfg: EngineCfg, data: STData, state: ChainState):
    """The marker variance a sample reports: BayesB's mean over the real
    markers, the common variance otherwise."""
    if cfg.method != "BayesB":
        return state.varg
    return torch.sum(torch.where(data.gm.valid > 0, state.varg, 0.0)) / cfg.n_markers


def sample_ebv(data: STData, state: ChainState):
    """EBVs of a sample (getEBV, output.jl:281-306): prediction-equation
    terms plus X alpha, the latter one K5 pass over the store in store
    order with the wanted IDs' columns selected."""
    if data.ebv_rows is not None and data.ebv_rows.numel() == 0:
        return torch.zeros(0, dtype=state.alpha.dtype, device=state.alpha.device)
    xa = grouped_matvec_store(data.gm, state.alpha)
    rows = data.gm.row_perm if data.ebv_rows is None else data.ebv_rows
    ebv = xa[:data.gm.n_obs] if rows is None else xa[rows]
    return ebv if data.out_W is None else data.out_W @ state.sol + ebv


def make_run_window(cfg: EngineCfg):
    step = make_st_step(cfg)

    def run_window(state: ChainState, data: STData, accum: Accum,
                   n_iters: int, accumulate: bool = True):
        for _ in range(n_iters):
            state = step(state, data)
        ebv = sample_ebv(data, state)
        genvar = (torch.var(ebv, unbiased=False) if ebv.numel() > 1
                  else torch.zeros((), dtype=ebv.dtype, device=ebv.device))
        out = SampleOut(vare=state.vare, varg=_varg_summary(cfg, data, state),
                        pi=_pi_summary(cfg, state),
                        ebv=ebv, genvar=genvar,
                        h2=genvar / (genvar + state.vare))
        if accumulate:
            n = accum.n + 1.0
            accum = Accum(
                n=n,
                sol_m=_welford(accum.sol_m, state.sol, n),
                sol_m2=_welford(accum.sol_m2, state.sol ** 2, n),
                alpha_m=_welford(accum.alpha_m, state.alpha, n),
                alpha_m2=_welford(accum.alpha_m2, state.alpha ** 2, n),
                # model frequency: P(in a slab class) for BayesR
                delta_m=_welford(accum.delta_m,
                                 (state.delta > 0).to(state.alpha.dtype), n),
                vare_m=_welford(accum.vare_m, state.vare, n),
                vare_m2=_welford(accum.vare_m2, state.vare ** 2, n),
                varg_m=_welford(accum.varg_m, out.varg, n),
                varg_m2=_welford(accum.varg_m2, out.varg ** 2, n),
                pi_m=_welford(accum.pi_m, out.pi, n),
                pi_m2=_welford(accum.pi_m2, out.pi ** 2, n),
                scale_m=_welford(accum.scale_m, state.scale_g, n),
                scale_m2=_welford(accum.scale_m2, state.scale_g ** 2, n),
                ebv_m=_welford(accum.ebv_m, ebv, n),
                ebv_m2=_welford(accum.ebv_m2, ebv ** 2, n),
            )
        return state, accum, out

    return run_window


def _init_accum(cfg: EngineCfg, data: STData, state: ChainState) -> Accum:
    def z(t):
        return torch.zeros_like(t, dtype=state.alpha.dtype)

    s = z(state.vare)
    pi = z(_pi_summary(cfg, state))
    n_out = data.y.shape[0] if data.ebv_rows is None else data.ebv_rows.shape[0]
    ebv = torch.zeros(n_out, dtype=state.alpha.dtype, device=state.alpha.device)
    return Accum(n=0.0, sol_m=z(state.sol), sol_m2=z(state.sol),
                 alpha_m=z(state.alpha), alpha_m2=z(state.alpha),
                 delta_m=z(state.alpha), vare_m=s, vare_m2=s, varg_m=s,
                 varg_m2=s, pi_m=pi, pi_m2=pi, scale_m=s, scale_m2=s,
                 ebv_m=ebv, ebv_m2=ebv)


def _reject_unsupported(**unsupported) -> None:
    for name, value in unsupported.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported yet; the port runs single-trait "
                f"BayesC, BayesB and BayesR in float32 with one genotype category "
                f"and no weights, random effects, latent traits or "
                f"annotations"
            )


def make_cfg(gm: GroupedPackedMarkers, method: str, *, nreps, sync_every,
             chain_length: int, df_R, df_marker, estimate_pi: bool,
             estimate_marker_variance: bool, estimate_scale: bool,
             estimate_residual_variance: bool) -> EngineCfg:
    """The chain's static configuration; nreps defaults to the block size
    and is clamped to chain_length (never more sweeps than asked for)."""
    b = gm.grams.shape[1]
    nreps = max(1, min(nreps if nreps is not None else b, chain_length))
    return EngineCfg(
        method=method, n_obs=gm.n_obs, n_markers=int(gm.valid.sum().item()),
        estimate_pi=estimate_pi,
        estimate_marker_variance=estimate_marker_variance,
        estimate_scale=estimate_scale,
        estimate_residual_variance=estimate_residual_variance,
        nreps=nreps, sync_every=mk.resolve_sync_every(nreps, sync_every),
        df_residual=float(df_R), df_marker=float(df_marker),
    )


def make_data(gm: GroupedPackedMarkers, y, W, scale_R, ebv_rows=None,
              out_W=None) -> STData:
    """The chain's device data; y (n,) and W (n, K; None: an intercept)
    in observation order."""
    dev, f32, n = gm.device, torch.float32, gm.n_obs
    y = torch.as_tensor(np.asarray(y), dtype=f32).to(dev)
    W = (torch.ones((n, 1), dtype=f32, device=dev) if W is None
         else torch.as_tensor(np.asarray(W), dtype=f32).to(dev))
    if tuple(y.shape) != (n,) or W.ndim != 2 or W.shape[0] != n:
        raise ValueError(f"y must be ({n},) and W ({n}, K) for {n} genotyped "
                         f"observations; got {tuple(y.shape)}, {tuple(W.shape)}")
    if ebv_rows is not None:
        ebv_rows = torch.as_tensor(np.asarray(ebv_rows), dtype=torch.int64).to(dev)
    if out_W is not None:
        out_W = torch.as_tensor(np.asarray(out_W), dtype=f32).to(dev)
    return STData(W=W, WtW=W.T @ W, y=y, gm=gm, ebv_rows=ebv_rows, out_W=out_W,
                  scale_r=torch.tensor(float(np.mean(scale_R)), dtype=f32, device=dev))


def initial_state(cfg: EngineCfg, data: STData, *, vare0, marker_var0,
                  marker_scale0, pi0, seed: Optional[int], sol0=None,
                  alpha0=None) -> ChainState:
    """The location parameters at sol0 and the real markers' effects at
    alpha0 (each 0 when None), every BayesC/B marker included (BayesR: all
    in the null class), the priors' values, one generator seeded with seed
    (None: 0) (jwas_tpu/engine/mcmc.py:1128-1224). A per-marker pi0 (p,)
    is kept, padded with 1.0; BayesB starts every real marker's variance
    at marker_var0 and the padding's at 1.0. The starting residual is
    y - W sol0 - X alpha0, X alpha0 one K5 pass over the store."""
    gm = data.gm
    dev, f32 = gm.device, torch.float32

    def scalar(x):
        return torch.tensor(float(np.mean(x)), dtype=f32, device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if seed is None else int(seed))
    real = gm.valid > 0
    p_pad, p = gm.valid.shape[0], cfg.n_markers
    sol = torch.zeros(data.W.shape[1], dtype=f32, device=dev)
    if sol0 is not None:
        sol = torch.as_tensor(np.asarray(sol0, dtype=np.float64), dtype=f32).to(dev)
    alpha = torch.zeros(p_pad, dtype=f32, device=dev)
    if alpha0 is not None:
        alpha[:p] = torch.as_tensor(np.asarray(alpha0, dtype=np.float64), dtype=f32).to(dev)
    if cfg.method == "BayesR":
        delta = torch.zeros(p_pad, dtype=torch.int32, device=dev)
        pi = torch.as_tensor(bayesr_pi(pi0), dtype=f32).to(dev)
    else:
        delta = real.to(torch.int32)
        pi_np = np.ones(p_pad)
        pi_np[:p] = np.asarray(pi0, dtype=np.float64)
        pi = torch.as_tensor(pi_np, dtype=f32).to(dev)
    varg = scalar(marker_var0)
    if cfg.method == "BayesB":
        varg = torch.where(real, varg, torch.ones((), dtype=f32, device=dev))
    return ChainState(
        gen=gen, sol=sol, alpha=alpha, beta=alpha.clone(), delta=delta,
        ycorr=data.y - data.W @ sol - grouped_matvec(gm, alpha),
        vare=scalar(vare0), varg=varg, pi=pi, scale_g=scalar(marker_scale0),
    )


SAMPLE_KEYS = ("vare", "varg", "pi", "genvar", "h2")


def _read_back(state: ChainState, out: SampleOut, stream, p: int) -> Dict:
    """A saved sample's values on the host, in one transfer: the tracks of
    SAMPLE_KEYS and what the sample files need (sol, alpha, BayesB's
    per-marker variances, ebv)."""
    parts = {k: getattr(out, k) for k in SAMPLE_KEYS}
    if stream is not None and stream.enabled:
        if stream.loc_slices:
            parts["sol"] = state.sol
        if stream.write_markers:
            parts["alpha"] = state.alpha[:p]
            if state.varg.dim():
                parts["varg_markers"] = state.varg[:p]
        if stream.ebv:
            parts["ebv"] = out.ebv
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in parts.values()])
    flat = flat.cpu().numpy()
    host, i = {}, 0
    for k, t in parts.items():
        host[k] = flat[i:i + t.numel()].reshape(t.shape)
        i += t.numel()
    return host


def apply_update_priors(cfg: EngineCfg, data: STData, state: ChainState,
                        accum: Accum):
    """Empirical-Bayes prior refresh from the running posterior means
    (jwas_tpu/engine/mcmc.py:691-715, MCMC_BayesianAlphabet.jl:381-395):
    the marker-variance scale becomes mean(varg) (df - 2) / df, except
    BayesB's, and the residual-variance scale mean(vare) (df_R - 2) / df_R.
    Returns (data, state)."""
    if cfg.method != "BayesB":
        state = state._replace(
            scale_g=accum.varg_m * (cfg.df_marker - 2.0) / cfg.df_marker)
    data = data._replace(
        scale_r=accum.vare_m * (cfg.df_residual - 2.0) / cfg.df_residual)
    return data, state


def run_chain(cfg: EngineCfg, data: STData, state: ChainState, plan: ChainPlan,
              stream=None, progress=None, update_priors_frequency: int = 0):
    """The single-chain loop (jwas_tpu/engine/mcmc.py:1484-1560): burn-in,
    then n_saved windows of thin_outer outer iterations, each ending with
    its sample read back (and written to the sample files by stream). With
    update_priors_frequency K > 0 the priors are refreshed
    (apply_update_priors) at the end of each window in which the sweep
    count passes a multiple of K.
    Returns (state, accum, samples, burnin_seconds, window_seconds)."""
    run_window = make_run_window(cfg)
    accum = _init_accum(cfg, data, state)
    samples = {k: [] for k in SAMPLE_KEYS}
    window_seconds = []
    upf, prior_epoch = int(update_priors_frequency or 0), 0
    t0 = time.perf_counter()
    if plan.burnin_outer > 0:
        state, accum, out = run_window(state, data, accum, plan.burnin_outer,
                                       accumulate=False)
        out.vare.item()              # waits for the device
    t_burnin = time.perf_counter() - t0
    for w in range(plan.n_saved):
        t_w = time.perf_counter()
        state, accum, out = run_window(state, data, accum, plan.thin_outer)
        iters_done = (plan.burnin_outer + (w + 1) * plan.thin_outer) * plan.nreps
        if upf > 0 and iters_done // upf > prior_epoch:
            prior_epoch = iters_done // upf
            data, state = apply_update_priors(cfg, data, state, accum)
        host = _read_back(state, out, stream, cfg.n_markers)
        window_seconds.append(time.perf_counter() - t_w)
        for k in SAMPLE_KEYS:
            samples[k].append(host[k])
        if stream is not None:
            stream.write_sample(host)
        if progress is not None:
            progress.update(iters_done, vare=host["vare"], varg=host["varg"],
                            pi=host["pi"])
    return state, accum, samples, t_burnin, window_seconds


def _host(t):
    return t.detach().cpu().numpy()


def run_st(gm: GroupedPackedMarkers, y, *, vare0: float, scale_R: float,
           df_R: float, marker_var0: float, marker_scale0: float,
           df_marker: float, pi0=0.0, W=None, nreps: Optional[int] = None,
           sync_every: Optional[int] = None, chain_length: int = 100,
           burnin: int = 0, output_samples_frequency: int = 0,
           seed: Optional[int] = None, estimate_pi: bool = True,
           estimate_marker_variance: bool = True,
           estimate_scale: bool = False,
           estimate_residual_variance: bool = True,
           method: str = "BayesC", rinv=None, dtype=torch.float32,
           random_effects=(), trait_type: str = "continuous",
           annotations=None, n_genotype_categories: int = 1) -> dict:
    """Run one single-trait BayesC, BayesB or BayesR chain on the device
    that holds gm.

    gm comes from setup_markers (or build_grouped_markers); y (n,) and the
    location design W (n, K; default: an intercept) are in observation
    order. The priors are those of prepare_workspace. pi0 is BayesC's
    P(excluded), or BayesR's (4,) class prior (0: the default
    DEFAULT_BAYESR_PI); for BayesR, marker_var0 is sigma^2, the variance
    of class 3, for BayesB every marker's starting variance. nreps
    (default: the block size) effective sweeps make one outer iteration,
    clamped to chain_length; sync_every defaults to min(8, nreps).

    Returns numpy posterior means (vare, varg, pi, scale, sol, alpha,
    model_frequency, ebv) with posterior standard deviations (*_sd) and
    ebv_pev, the saved sample tracks under "samples", and host wall
    times: burnin_seconds and window_seconds (one per saved sample,
    thin_outer outer iterations each; each ends with the device finished,
    since its samples are read back). pi and pi_sd are floats for BayesC
    and (4,) arrays of class shares for BayesR, whose samples["pi"] is
    (n_saved, 4); model_frequency is each marker's posterior probability
    of a nonzero effect; ebv covers the training observations.
    """
    _reject_unsupported(
        method=method not in METHODS, rinv=rinv is not None,
        dtype=dtype != torch.float32, random_effects=len(random_effects) > 0,
        trait_type=trait_type != "continuous",
        annotations=annotations is not None,
        n_genotype_categories=n_genotype_categories != 1,
    )
    data = make_data(gm, y, W, scale_R)
    cfg = make_cfg(gm, method, nreps=nreps, sync_every=sync_every,
                   chain_length=chain_length, df_R=df_R, df_marker=df_marker,
                   estimate_pi=estimate_pi,
                   estimate_marker_variance=estimate_marker_variance,
                   estimate_scale=estimate_scale,
                   estimate_residual_variance=estimate_residual_variance)
    state = initial_state(cfg, data, vare0=vare0, marker_var0=marker_var0,
                          marker_scale0=marker_scale0, pi0=pi0, seed=seed)
    plan = chain_plan(chain_length, burnin, output_samples_frequency, cfg.nreps)
    _, accum, samples, t_burnin, window_seconds = run_chain(cfg, data, state, plan)

    def mean_sd(name):
        """Posterior mean and sd, sqrt|E x^2 - (E x)^2| (output.jl)."""
        m = _host(getattr(accum, name + "_m"))
        m2 = _host(getattr(accum, name + "_m2"))
        return m, np.sqrt(np.abs(m2 - m ** 2))

    p = cfg.n_markers
    res = {}
    for name in ("vare", "varg", "pi", "scale"):
        m, sd = mean_sd(name)
        res[name], res[name + "_sd"] = (m, sd) if m.ndim else (float(m), float(sd))
    res["sol"], res["sol_sd"] = mean_sd("sol")
    alpha, alpha_sd = mean_sd("alpha")
    res["alpha"], res["alpha_sd"] = alpha[:p], alpha_sd[:p]
    ebv, ebv_sd = mean_sd("ebv")
    return {
        **res, "model_frequency": _host(accum.delta_m)[:p],
        "ebv": ebv, "ebv_pev": ebv_sd ** 2,
        "samples": {k: np.asarray(v, dtype=np.float64) for k, v in samples.items()},
        "nreps": cfg.nreps, "burnin_outer": plan.burnin_outer,
        "thin_outer": plan.thin_outer,
        "burnin_seconds": t_burnin, "window_seconds": window_seconds,
    }


def _build_st_data_and_state(ws: Workspace, opts: MCMCOptions, device):
    """The 2-bit grouped branch of jwas_tpu's _build_st_data_and_state
    (:786-868, state :1128-1224): setup_markers' block choice and row order
    of the training rows, the workspace's priors, the output IDs' store
    columns and prediction-equation rows, the residence of the store
    (host_offload_genotypes) and the starting values (starting_value: the
    location parameters, :1131-1141; the genotypes' starting_alpha: the
    marker effects, :1142-1145). Returns (cfg, data, state)."""
    g = ws.geno
    K = ws.W.shape[1]
    sol0 = None
    if opts.starting_value is not None and opts.starting_value is not False:
        sol0 = np.asarray(opts.starting_value, dtype=np.float64).reshape(-1)
        if len(sol0) != K:
            raise ValueError(
                f"length of starting values for non-marker location "
                f"parameters is wrong (expected {K}, got {len(sol0)}); the "
                f"order is model.term_names()")
    gm = setup_markers(g.packed_store, ws.obs_ids, device, fast_blocks=opts.fast_blocks,
                       host_offload=opts.host_offload_genotypes)
    if opts.independent_blocks:
        sync_every = 0                   # one sync an outer iteration
    elif opts.sync_every is not None:
        sync_every = max(1, int(opts.sync_every))
    else:
        sync_every = None
    cfg = make_cfg(gm, g.method, nreps=opts.nreps, sync_every=sync_every,
                   chain_length=opts.chain_length, df_R=ws.df_R,
                   df_marker=ws.df_marker, estimate_pi=bool(g.estimate_pi),
                   estimate_marker_variance=bool(g.G.estimate_variance),
                   estimate_scale=bool(g.G.estimate_scale),
                   estimate_residual_variance=bool(ws.model.R.estimate_variance))
    out_W = None
    if ws.prediction_terms:
        out_W = np.zeros((len(ws.output_ids), ws.W.shape[1]))
        for name in ws.prediction_terms:
            term = ws.model.term_dict[name]
            out_W[:, term.start_pos:term.start_pos + term.n_levels] += ws.output_X[name]
    data = make_data(gm, ws.y, ws.W, ws.scale_R, ebv_rows=ws.output_store_rows,
                     out_W=out_W)
    state = initial_state(cfg, data, vare0=ws.vare0, marker_var0=ws.marker_var0,
                          marker_scale0=ws.marker_scale0, pi0=ws.pi0, seed=opts.seed,
                          sol0=sol0, alpha0=g.starting_alpha)
    return cfg, data, state


def runMCMC(model: Model, df, *, device="cuda", **kwargs) -> Dict:
    """Run MCMC for a model from build_model on phenotypes df (a Table, a
    {name: array} mapping or a DataFrame whose first column holds the IDs):
    the reference's runMCMC (JWAS.jl:161-511), single chain, single-trait
    BayesC, BayesB or BayesR on the 2-bit store. kwargs are MCMCOptions'
    fields.

    device: where the chain runs, the GPU unless the caller asks for the
    CPU (device="cpu" runs the kernels' plain versions); without a GPU the
    default raises. Returns a dict of Tables (the keys of jwas_tpu's
    result dict: "location parameters", "residual variance", "marker
    effects <name>", "marker effects variances <name>", "pi_<name>",
    "ScaleEffectVar<name>", "EBV_<trait>", "genetic_variance",
    "heritability"), written as <key>.txt to output_folder with the
    per-parameter MCMC sample files. Options the reference rejects raise
    its ValueError before an option the port does not run yet raises
    NotImplementedError.
    """
    opts = MCMCOptions(**kwargs)
    validate_args(model, opts)
    reject_unported(opts)
    device = resolve_device(device)
    model.mcmc_info = opts
    if opts.printout_model_info:
        describe(model)
    ws = prepare_workspace(model, df, opts, device=device)
    cfg, data, state = _build_st_data_and_state(ws, opts, device)
    plan = chain_plan(opts.chain_length, opts.burnin, opts.output_samples_frequency,
                      cfg.nreps)
    stream = STSampleStream(ws, cfg, opts)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length)
    try:
        with maybe_profile(opts):
            _, accum, samples, _, _ = run_chain(
                cfg, data, state, plan, stream, progress,
                update_priors_frequency=opts.update_priors_frequency)
    finally:
        stream.close()
    accum = accum._replace(**{k: _host(v) for k, v in accum._asdict().items()
                              if torch.is_tensor(v)})
    results = build_results(ws, cfg, accum, samples, opts)
    if stream.enabled and stream.write_markers:
        results["_marker_sample_file"] = stream.writer.path(
            f"marker_effects_{ws.geno.name}_{model.lhs_vec[0]}")
    return results
