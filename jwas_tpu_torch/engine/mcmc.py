"""Single-trait BayesC and BayesR on the 2-bit packed store: Gibbs step and
chain loop.

Counterpart of jwas_tpu/engine/mcmc.py, trimmed to the path that runMCMC
takes for storage='2bit' genotypes on one device (:786-868):
STData (:50), make_st_step (:113-527: the location pass :180-185, the
packed grouped BayesC branch :191-210 and BayesR branch :321-347, pi
:438-443, the marker variance :446-451 and :469-472, its scale :476-484,
the residual variance :509-518), make_run_window (:580-668), _init_accum
(:671), the initial state (:1128-1224) and the single-chain loop
(:1484-1560) as run_st.

run_st takes the priors that jwas_tpu's prepare_workspace computes
(engine/setup.py:146-152) explicitly; the pandas model layer, sample files
and result CSVs are not ported yet.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from jwas_tpu_torch.engine.state import ChainState, EngineCfg
from jwas_tpu_torch.io.packed import Packed2BitStore, store_has_missing
from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops.grouped import (
    GroupedPackedMarkers,
    build_grouped_markers,
    grouped_matvec,
    pick_stable_blocks,
    sweep_blocks_abc_grouped,
    sweep_blocks_bayesr_grouped,
)
from jwas_tpu_torch.ops.location import gibbs_pass_lambda
from jwas_tpu_torch.ops.variance import (
    sample_marker_variance_bayesr,
    sample_marker_variance_common,
    sample_pi_abc,
    sample_pi_bayesr,
    sample_residual_variance_st,
    sample_scale_st,
)

METHODS = ("BayesC", "BayesR")
# BayesR class prior when pi0 is 0 (jwas_tpu/io/genotypes.py:28)
DEFAULT_BAYESR_PI = (0.95, 0.03, 0.015, 0.005)


class STData(NamedTuple):
    """Static device data of a single-trait chain."""

    W: torch.Tensor            # (n, K) location design
    WtW: torch.Tensor          # (K, K) location LHS (no random effects)
    y: torch.Tensor            # (n,)
    gm: GroupedPackedMarkers
    scale_r: torch.Tensor      # 0-d residual-variance prior scale


class SampleOut(NamedTuple):
    vare: torch.Tensor
    varg: torch.Tensor
    pi: torch.Tensor           # BayesC 0-d P(excluded), BayesR (4,)
    ebv: torch.Tensor          # (n,) X alpha for the training observations
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


def setup_markers(store: Packed2BitStore, obs_ids, device="cuda",
                  fast_blocks=True) -> GroupedPackedMarkers:
    """Block sizes, row order and Gram tiles for a store, as runMCMC picks
    them for storage='2bit' (jwas_tpu/engine/mcmc.py:786-844).

    device: where the store and the chain live; the GPU unless the caller
    asks for another (a missing GPU raises, the CPU is never taken
    silently). fast_blocks: True for the default block size (from the
    number of observations) or an int block size. The exact bf16 Gram path
    is taken when the store has no missing codes and no row permutation is
    needed.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "setup_markers: no CUDA device (torch.cuda.is_available() is "
            "false); pass device='cpu' to run the plain versions on the CPU")
    n = len(obs_ids)
    if fast_blocks is True or not fast_blocks:
        bs = mk.default_block_size(n)
    else:
        bs = int(fast_blocks)
    bs = max(8, ((bs + 7) // 8) * 8)
    user_sized = fast_blocks is not True and bool(fast_blocks)
    b, gb = pick_stable_blocks(n, bs, store.n_markers, warn=user_sized)
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
        has_missing=has_missing,
    )


def make_st_step(cfg: EngineCfg):
    """One outer iteration: location pass, grouped marker sweep (nreps
    effective sweeps), pi, marker variance, its scale, residual variance.
    The marker state and ycorr of the returned state are the input's
    tensors, updated in place."""
    bayesr = cfg.method == "BayesR"

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
        elif cfg.estimate_marker_variance:
            nloci = torch.sum(torch.where(real, delta, torch.zeros_like(delta)))
            varg = sample_marker_variance_common(gen, alpha, nloci,
                                                 cfg.df_marker, state.scale_g)

        # 2d. prior scale of the marker-effect variance
        scale_g = state.scale_g
        if cfg.estimate_scale:
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
    """The pi a sample reports: BayesR's (4,) class prior, BayesC's common
    P(excluded) (the first marker's)."""
    return state.pi if cfg.method == "BayesR" else state.pi[0]


def make_run_window(cfg: EngineCfg):
    step = make_st_step(cfg)

    def run_window(state: ChainState, data: STData, accum: Accum,
                   n_iters: int, accumulate: bool = True):
        for _ in range(n_iters):
            state = step(state, data)
        # EBV of the training individuals: X alpha (getEBV, output.jl:281-306)
        ebv = grouped_matvec(data.gm, state.alpha)
        genvar = torch.var(ebv, unbiased=False)
        out = SampleOut(vare=state.vare, varg=state.varg,
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
    return Accum(n=0.0, sol_m=z(state.sol), sol_m2=z(state.sol),
                 alpha_m=z(state.alpha), alpha_m2=z(state.alpha),
                 delta_m=z(state.alpha), vare_m=s, vare_m2=s, varg_m=s,
                 varg_m2=s, pi_m=pi, pi_m2=pi, scale_m=s, scale_m2=s,
                 ebv_m=z(data.y), ebv_m2=z(data.y))


def _reject_unsupported(**unsupported) -> None:
    for name, value in unsupported.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported yet; the port runs single-trait "
                f"BayesC and BayesR in float32 with one genotype category "
                f"and no weights, random effects, latent traits or "
                f"annotations"
            )


def bayesr_pi0(pi0) -> np.ndarray:
    """BayesR's (4,) class prior: the default when pi0 is 0, else pi0,
    which must be 4 nonnegative shares summing to 1
    (jwas_tpu/io/genotypes.py:266-273)."""
    if np.ndim(pi0) == 0 and pi0 == 0.0:
        return np.asarray(DEFAULT_BAYESR_PI)
    pi = np.asarray(pi0, dtype=np.float64)
    if pi.shape != (4,):
        raise ValueError("BayesR Pi must be a length-4 vector")
    if not np.isclose(pi.sum(), 1.0, atol=1e-8) or (pi < 0).any():
        raise ValueError("BayesR Pi must be nonnegative and sum to 1")
    return pi


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
    """Run one single-trait BayesC or BayesR chain on the device that
    holds gm.

    gm comes from setup_markers (or build_grouped_markers); y (n,) and the
    location design W (n, K; default: an intercept) are in observation
    order. The priors are those of jwas_tpu's prepare_workspace. pi0 is
    BayesC's P(excluded), or BayesR's (4,) class prior (0: the default
    DEFAULT_BAYESR_PI); for BayesR, marker_var0 is sigma^2, the variance
    of class 3. nreps (default: the block size) effective sweeps make one
    outer iteration, clamped to chain_length; sync_every defaults to
    min(8, nreps).

    Returns numpy posterior means (vare, varg, pi, scale, sol, alpha,
    model_frequency, ebv) with posterior standard deviations (*_sd) and
    ebv_pev, the saved sample tracks under "samples", and host wall
    times: burnin_seconds and window_seconds (one per saved sample,
    thin_outer outer iterations each; each ends with the device finished,
    since its samples are read back). pi and pi_sd are floats for BayesC
    and (4,) arrays of class shares for BayesR, whose samples["pi"] is
    (n_saved, 4); model_frequency is each marker's posterior probability
    of a nonzero effect.
    """
    _reject_unsupported(
        method=method not in METHODS, rinv=rinv is not None,
        dtype=dtype != torch.float32, random_effects=len(random_effects) > 0,
        trait_type=trait_type != "continuous",
        annotations=annotations is not None,
        n_genotype_categories=n_genotype_categories != 1,
    )
    dev = gm.store.device
    f32 = torch.float32
    n = gm.n_obs
    nblocks, b, _ = gm.grams.shape
    p_pad = nblocks * b
    p = int(gm.valid.sum().item())
    y = torch.as_tensor(np.asarray(y), dtype=f32).to(dev)
    W = (torch.ones((n, 1), dtype=f32, device=dev) if W is None
         else torch.as_tensor(np.asarray(W), dtype=f32).to(dev))
    if tuple(y.shape) != (n,) or W.ndim != 2 or W.shape[0] != n:
        raise ValueError(f"y must be ({n},) and W ({n}, K) for {n} genotyped "
                         f"observations; got {tuple(y.shape)}, {tuple(W.shape)}")
    K = W.shape[1]

    bayesr = method == "BayesR"
    if bayesr:
        pi0 = bayesr_pi0(pi0)
    nreps = max(1, min(nreps if nreps is not None else b, chain_length))
    cfg = EngineCfg(
        method=method, n_obs=n, n_markers=p, estimate_pi=estimate_pi,
        estimate_marker_variance=estimate_marker_variance,
        estimate_scale=estimate_scale,
        estimate_residual_variance=estimate_residual_variance,
        nreps=nreps, sync_every=mk.resolve_sync_every(nreps, sync_every),
        df_residual=float(df_R), df_marker=float(df_marker),
    )

    def scalar(x):
        return torch.tensor(float(np.mean(x)), dtype=f32, device=dev)

    data = STData(W=W, WtW=W.T @ W, y=y, gm=gm, scale_r=scalar(scale_R))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if seed is None else int(seed))
    real = gm.valid > 0
    sol = torch.zeros(K, dtype=f32, device=dev)
    alpha = torch.zeros(p_pad, dtype=f32, device=dev)
    if bayesr:
        delta = torch.zeros(p_pad, dtype=torch.int32, device=dev)
        pi = torch.as_tensor(pi0, dtype=f32).to(dev)
    else:
        delta = real.to(torch.int32)
        pi = torch.where(real, scalar(pi0), torch.ones((), dtype=f32, device=dev))
    state = ChainState(
        gen=gen, sol=sol, alpha=alpha, beta=alpha.clone(), delta=delta,
        ycorr=y - W @ sol - grouped_matvec(gm, alpha),
        vare=scalar(vare0), varg=scalar(marker_var0), pi=pi,
        scale_g=scalar(marker_scale0),
    )

    n_outer = max(1, chain_length // nreps)
    burnin_outer = burnin // nreps
    osf = output_samples_frequency
    if osf <= 0:
        osf = max(1, chain_length // 1000)
    thin_outer = max(1, osf // nreps)
    n_saved = max(1, (n_outer - burnin_outer) // thin_outer)

    run_window = make_run_window(cfg)
    accum = _init_accum(cfg, data, state)
    samples = {k: [] for k in ("vare", "varg", "pi", "genvar", "h2")}
    window_seconds = []
    t0 = time.perf_counter()
    if burnin_outer > 0:
        state, accum, out = run_window(state, data, accum, burnin_outer,
                                       accumulate=False)
        out.vare.item()              # waits for the device
    t_burnin = time.perf_counter() - t0
    for _ in range(n_saved):
        t_w = time.perf_counter()
        state, accum, out = run_window(state, data, accum, thin_outer)
        for k in samples:
            samples[k].append(getattr(out, k).tolist())
        window_seconds.append(time.perf_counter() - t_w)

    def host(t):
        return t.detach().cpu().numpy()

    def mean_sd(name):
        """Posterior mean and sd, sqrt|E x^2 - (E x)^2| (output.jl)."""
        m = host(getattr(accum, name + "_m"))
        m2 = host(getattr(accum, name + "_m2"))
        return m, np.sqrt(np.abs(m2 - m ** 2))

    res = {}
    for name in ("vare", "varg", "pi", "scale"):
        m, sd = mean_sd(name)
        res[name], res[name + "_sd"] = (m, sd) if m.ndim else (float(m), float(sd))
    res["sol"], res["sol_sd"] = mean_sd("sol")
    alpha, alpha_sd = mean_sd("alpha")
    res["alpha"], res["alpha_sd"] = alpha[:p], alpha_sd[:p]
    ebv, ebv_sd = mean_sd("ebv")
    return {
        **res, "model_frequency": host(accum.delta_m)[:p],
        "ebv": ebv, "ebv_pev": ebv_sd ** 2,
        "samples": {k: np.asarray(v) for k, v in samples.items()},
        "nreps": nreps, "burnin_outer": burnin_outer, "thin_outer": thin_outer,
        "burnin_seconds": t_burnin, "window_seconds": window_seconds,
    }
