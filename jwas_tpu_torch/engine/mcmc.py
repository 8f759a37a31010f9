"""The single-trait methods on the 2-bit packed store, a dense store,
GBLUP's eigenbasis or no genotypes, with random effects: Gibbs step, chain
loop, runMCMC.

Counterpart of jwas_tpu/engine/mcmc.py, trimmed to the paths that runMCMC
takes on one device for storage='2bit' genotypes (:786-868), for dense
ones (:796-844), for GBLUP (:778-786) and without genotypes (method
"none", :771-772, :904-910): STData (:50), make_st_step
(:113-527: the location pass over the LHS W'R^-1W plus the random
effects' blocks and W'R^-1 ycorr :86-106, :180-185,
:766-768, the packed grouped BayesC/B branch :191-210 and BayesR branch
:321-347, the dense grouped and exact branches :233-267, :288-320,
:366-404, GBLUP :414-417, pi :438-443, the marker variance and BayesL's
local shrinkage :446-472, its scale :476-484, the random-effect
covariances :486-507, the weighted residual variance :509-518),
make_run_window (:580-668), _init_accum (:671), _apply_update_priors
(:691-715), _build_st_data_and_state (:762-868, the groups :916-944, the
state :1128-1224), the single-chain loop of runMCMC (:1435-1569) and
its several chains (_run_multichain and _apply_update_priors_mc,
:1227-1432): run_chains runs K states on one device, sharing the store,
its Gram tiles and the workspace, a window each in turn (jwas_tpu vmaps
them); the pooled means and a "PSRF" table come back with the results.

The location pass is one launch of K6 on the card (ops/location.py), on
every path; with random effects the LHS is assembled from the group
covariances and the residual variance each outer iteration. A group set
with estimate_variance=False keeps its G: jwas_tpu draws it all the same
(fault R10, ROADMAP.md).

The chain's dtype is its store's, float32 or float64
(double_precision), chosen per call: there is no global switch (fault
R8). A dense store runs the grouped sweeps through the same walker as the
2-bit store, on the inner-rounds kernels K1/K2 and K3; with
fast_blocks=False its groups are single blocks walked once an outer
iteration, the exact single-site sweep (ops/dense.py). RR-BLUP and BayesL
run K1 with every marker in the slab (ops/grouped.py::
sweep_blocks_c0l_grouped); BayesA is BayesB with pi 0 (engine/setup.py::
normalize_method); GBLUP draws every pseudo-marker at once between two
GEMVs with L (ops/gblup.py), fast_blocks ignored.

Latent traits (binary, ordered categorical, censored; jwas_tpu/engine/
mcmc.py:126-157, set-up :995-1072): each outer iteration first draws the
liabilities (ops/threshold.py, a tail-safe truncated normal where jwas_tpu's
collapses, fault R13) and a categorical trait's free thresholds; the chain
then runs on the liabilities, and a categorical trait's residual variance
stays 1. Annotations (annotated BayesC and BayesR on a dense store,
:421-437): the probit update of ops/annotations.py replaces the pi draw,
and its per-marker prior goes to K1 as its (nblocks, b) log pi and to K3
as its (nblocks, b, 4) one.

Two entry points share the chain loop (run_chains; run_chain runs one)
and the initial state: runMCMC(model, df, ...) takes a model from
build_model and the phenotypes and returns the result tables, as
jwas_tpu's does; run_st takes a store set up by setup_markers and the
priors explicitly and returns numpy posterior means. BayesB runs BayesC's sweep with one variance a marker. The EBVs of
the output IDs are the output IDs' rows of the X alpha pass over the store
(K5), in place of jwas_tpu's dense (n_out, p) decode (:600-601); GBLUP's
are its output map times alpha, as jwas_tpu's.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import replace
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from jwas_tpu_torch.engine.output import build_results
from jwas_tpu_torch.engine.progress import ProgressPrinter, maybe_profile
from jwas_tpu_torch.engine.samples_io import STSampleStream, multichain_streams
from jwas_tpu_torch.engine.setup import (MCMCOptions, Workspace, prepare_workspace,
                                         reject_unported, resolve_device)
from jwas_tpu_torch.engine.state import ChainState, EngineCfg, REGroupCfg
from jwas_tpu_torch.engine.validation import validate_args
from jwas_tpu_torch.io.genotypes import DEFAULT_BAYESR_PI, bayesr_pi  # noqa: F401
from jwas_tpu_torch.io.packed import Packed2BitStore, store_has_missing
from jwas_tpu_torch.io.table import Table
from jwas_tpu_torch.models.model import Model, describe
from jwas_tpu_torch.ops import annotations as an
from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops import sparse_mme as sm
from jwas_tpu_torch.ops import threshold as th
from jwas_tpu_torch.ops.dense import DenseMarkers, build_dense_markers
from jwas_tpu_torch.ops.dists import sample_gamma_like
from jwas_tpu_torch.ops.gblup import GBLUPMarkers, build_gblup_markers, sweep_gblup
from jwas_tpu_torch.ops.grouped import (
    GroupedPackedMarkers,
    build_grouped_markers,
    grouped_matvec,
    plan_store,
    sweep_blocks_abc_grouped,
    sweep_blocks_bayesr_grouped,
    sweep_blocks_c0l_grouped,
)
from jwas_tpu_torch.ops.location import (assemble_lhs_lambda, gibbs_pass_lambda,
                                         symmetric_upper)
from jwas_tpu_torch.ops.variance import (
    sample_bayesl_gamma,
    sample_marker_variance_bayesb,
    sample_marker_variance_bayesr,
    sample_marker_variance_common,
    sample_pi_abc,
    sample_pi_bayesr,
    sample_random_effect_vc,
    sample_residual_variance_st,
    sample_scale_bayesb,
    sample_scale_st,
)

# the chain's methods; BayesA runs as BayesB (engine/setup.py::normalize_method)
METHODS = ("BayesC", "BayesB", "BayesR", "RR-BLUP", "BayesL", "GBLUP")
PI_METHODS = ("BayesC", "BayesB", "BayesR")    # those with a pi to estimate
LATENT = ("categorical", "categorical(binary)", "censored")
CATEGORICAL = ("categorical", "categorical(binary)")


class NoMarkers(NamedTuple):
    """The marker side of a model without genotypes (method "none"): no
    markers; the chain's dtype, device and residual weights."""

    xpx: torch.Tensor          # (0,) in the chain's dtype on its device
    valid: torch.Tensor        # (0,)
    rinv: Optional[torch.Tensor]
    n_obs: int

    @property
    def device(self):
        return self.xpx.device


class STData(NamedTuple):
    """Static device data of a single-trait chain, in the chain's dtype."""

    W: torch.Tensor            # (n, K) location design
    WtW: torch.Tensor          # (K, K) W'R^-1W, exactly symmetric
                               # (ops/location.py::symmetric_upper)
    y: torch.Tensor            # (n,)
    gm: object                 # GroupedPackedMarkers, DenseMarkers,
                               # GBLUPMarkers or NoMarkers
    scale_r: torch.Tensor      # 0-d residual-variance prior scale
    ebv_rows: Optional[torch.Tensor]  # (n_out,) store columns of the EBVs'
                                      # IDs; None: the training rows
    out_W: Optional[torch.Tensor]     # (n_out, K) prediction-equation rows,
                                      # None when it has no terms (never
                                      # None without markers)
    Vinv: tuple = ()           # a random-effect group's (q, q) Vinv,
                               # exactly symmetric; None for "I"
    vc_scale: tuple = ()       # a group's (k, k) prior scale
    category_obs: Optional[torch.Tensor] = None  # (n,) int64 categories of a
                                                 # categorical trait, 0 missing
    cens_lower: Optional[torch.Tensor] = None    # (n,) a censored trait's
    cens_upper: Optional[torch.Tensor] = None    # liability bounds (+-BIG)
    anno_A: Optional[torch.Tensor] = None        # (p_pad, k) annotation design
                                                 # [1, annotations], padding 0
    sl: object = None          # the sparse location path's SparseLoc
                               # (ops/sparse_mme.py); W is then its CSR
                               # design, WtW None, each Vinv a CSR tensor


class SampleOut(NamedTuple):
    vare: torch.Tensor
    varg: torch.Tensor         # BayesB: the mean over the real markers
    pi: torch.Tensor           # BayesC 0-d P(excluded), BayesR (4,),
                               # RR-BLUP / BayesL / GBLUP (0,)
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
    vc_m: tuple = ()           # a (k, k) mean a random-effect group
    vc_m2: tuple = ()
    ann_m: Optional[torch.Tensor] = None    # the annotation coefficients'
    ann_m2: Optional[torch.Tensor] = None


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


def setup_dense_markers(X, store_ids, obs_ids, device="cuda", fast_blocks=True,
                        rinv=None, dtype=None) -> DenseMarkers:
    """Blocks, row order and Gram tiles of a dense (p, n_store) store of
    the individuals store_ids, as jwas_tpu's runMCMC picks them for dense
    genotypes (mk.dense_blocks; fast_blocks=False: the exact sweep's chunks
    of default_block_size(n)). rinv: (n,) inverse residual weights of the
    observations obs_ids. The store is used in place when it already lies
    on the device in dtype (default: its own); otherwise it is copied once.
    """
    device = resolve_device(device)
    X = torch.as_tensor(X)
    dtype = X.dtype if dtype is None else dtype
    if X.device != device or X.dtype != dtype:
        X = X.to(device=device, dtype=dtype)
    n = len(obs_ids)
    b, gb, exact = mk.dense_blocks(n, fast_blocks, X.shape[0])
    index = {s: i for i, s in enumerate(store_ids)}
    try:
        perm = np.asarray([index[s] for s in obs_ids], dtype=np.int64)
    except KeyError as e:
        raise ValueError(f"individual {e} has no genotypes") from None
    if len(perm) <= X.shape[1] and (perm == np.arange(len(perm))).all():
        perm = None
    return build_dense_markers(X, n, b, gb, row_perm=perm, rinv=rinv, exact=exact)


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


def latent_step(cfg: EngineCfg, state: ChainState, data: STData,
                z_of=None, u_thr=None) -> ChainState:
    """A latent trait's liabilities, then a categorical trait's free
    thresholds when it has more than 2 categories (jwas_tpu/engine/
    mcmc.py:126-157): the bounds from the thresholds (or the censoring
    bounds), the liabilities (sample_liabilities with R = vare, one pass;
    z_of its truncated normals, default from the chain's generator:
    ops/threshold.py::truncated_normals), the
    thresholds from 2 on (u_thr: their uniforms, default drawn)."""
    trait_type = cfg.trait_types[0]
    if trait_type == "censored":
        lb, ub = data.cens_lower, data.cens_upper
    else:
        lb, ub = th.bounds_from_thresholds(state.thresholds, data.category_obs)
    liab, ycorr = th.sample_liabilities(
        state.liab.view(1, -1), state.ycorr.view(1, -1), state.vare.view(1, 1),
        lb.view(1, -1), ub.view(1, -1), (0,), 1,
        th.truncated_normals(state.gen) if z_of is None else z_of)
    liab, ycorr = liab[0], ycorr[0]
    thresholds = state.thresholds
    n_cat = cfg.cat_counts[0] if cfg.cat_counts else 0
    if trait_type == "categorical" and n_cat > 2:
        if u_thr is None:
            thresholds = th.draw_thresholds(state.gen, thresholds, liab,
                                            data.category_obs, n_cat, 2)
        else:
            thresholds = th.sample_thresholds_t(thresholds, liab, data.category_obs,
                                                n_cat, 2, u_thr)
    return state._replace(liab=liab, ycorr=ycorr, thresholds=thresholds)


def sparse_location_step(cfg: EngineCfg, state: ChainState, data: STData) -> ChainState:
    """The location parameters on the sparse path (jwas_tpu/engine/
    mcmc.py:160-178): rhs = W' R^-1 (ycorr + W sol), then one PO-CG joint
    draw from the previous sol (ops/sparse_mme.py) at cfg.cg_tol and
    cfg.cg_maxiter, with each group's G^-1 and its Cholesky factor, its
    normals from the chain's generator; no host sync outside the CG's
    stopping test."""
    sl = data.sl
    ycorr = state.ycorr + sm.spmv(sl.W, state.sol)
    w = ycorr if sl.rinv is None else sl.rinv * ycorr
    rhs = sm.spmv(sl.Wt, w)
    gis = [torch.linalg.inv_ex(v)[0] for v in state.vc]
    chols = [torch.linalg.cholesky_ex(0.5 * (g + g.T))[0] for g in gis]
    sol = sm.sample_location_po(state.gen, sl, cfg.re_groups, rhs, gis, state.vare, chols,
                                x0=state.sol, tol=cfg.cg_tol, maxiter=cfg.cg_maxiter)
    ycorr -= sm.spmv(sl.W, sol)
    return state._replace(sol=sol, ycorr=ycorr)


def make_st_step(cfg: EngineCfg):
    """One outer iteration: a latent trait's liabilities and thresholds
    (latent_step), location pass (over W'R^-1W plus the random effects'
    blocks), marker sweep (nreps effective sweeps of the grouped schedule;
    one for the exact sweep's store and GBLUP; none without markers), pi
    (or the annotation probits), marker variance (then BayesL's local
    shrinkage), its scale, the random-effect covariances, the residual
    variance. The marker state of the returned state is the input's
    tensors, updated in place. BayesB is BayesC's sweep with one variance a
    marker."""
    method = cfg.method
    bayesr, bayesb = method == "BayesR", method == "BayesB"
    bayesl, gblup = method == "BayesL", method == "GBLUP"
    latent = cfg.trait_types[0] in LATENT

    def markers(state: ChainState, data: STData) -> ChainState:
        gen, gm, ycorr = state.gen, data.gm, state.ycorr

        # 2. marker effects (in place)
        real = gm.valid > 0
        beta = state.beta
        delta = state.delta
        if bayesr:
            pi_mat = state.pi                       # annotated: (p_pad, 4) already
            if pi_mat.dim() == 1:
                pad_row = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=state.pi.dtype,
                                       device=real.device)
                pi_mat = torch.where(real[:, None], state.pi[None, :], pad_row)
            alpha, delta, ycorr = sweep_blocks_bayesr_grouped(
                gm, state.alpha, state.delta, ycorr, state.vare, state.varg,
                pi_mat, gen, nreps=cfg.nreps, sync_every=cfg.sync_every,
            )
        elif gblup:
            alpha, ycorr = sweep_gblup(gm, state.alpha, ycorr, state.vare,
                                       state.varg, gen)
        elif method in ("RR-BLUP", "BayesL"):
            alpha, ycorr = sweep_blocks_c0l_grouped(
                gm, state.alpha, ycorr, state.vare, state.varg,
                state.gamma_l if bayesl else None, gen, nreps=cfg.nreps,
                sync_every=cfg.sync_every,
            )
        else:
            alpha, beta, delta, ycorr = sweep_blocks_abc_grouped(
                gm, state.alpha, state.beta, state.delta, ycorr, state.vare,
                state.varg, state.pi, gen, nreps=cfg.nreps,
                sync_every=cfg.sync_every,
            )

        # 2b. pi (Pi.jl:7-17), or the annotation probits in its place
        # (jwas_tpu/engine/mcmc.py:421-437)
        pi = state.pi
        ann_coeffs, ann_var = state.ann_coeffs, state.ann_var
        if cfg.anno_steps:
            update = an.anno_bayesc_update if cfg.anno_steps == 1 else an.anno_bayesr_update
            ann_coeffs, ann_var, pi = update(data.anno_A, delta, ann_coeffs, ann_var,
                                             gm.valid, an.ProbitDraws(gen))
        elif cfg.estimate_pi and bayesr:
            pi = sample_pi_bayesr(gen, delta, gm.valid)
        elif cfg.estimate_pi:
            pi_s = sample_pi_abc(gen, delta, cfg.n_markers, gm.valid)
            pi = torch.where(real, pi_s, torch.ones_like(pi))

        # 2c. marker-effect variance (variance_components.jl:151-189), then
        # BayesL's local shrinkage (:191-218)
        varg, gamma_l = state.varg, state.gamma_l
        if cfg.estimate_marker_variance and bayesr:
            varg = sample_marker_variance_bayesr(gen, alpha, delta,
                                                 cfg.df_marker, state.scale_g)
        elif cfg.estimate_marker_variance and bayesb:
            varg = sample_marker_variance_bayesb(gen, beta, cfg.df_marker,
                                                 state.scale_g)
        elif cfg.estimate_marker_variance and method == "BayesC":
            nloci = torch.sum(torch.where(real, delta, torch.zeros_like(delta)))
            varg = sample_marker_variance_common(gen, alpha, nloci,
                                                 cfg.df_marker, state.scale_g)
        elif cfg.estimate_marker_variance:
            weights = 1.0 / gamma_l if bayesl else 1.0 / gm.D if gblup else None
            varg = sample_marker_variance_common(gen, alpha, cfg.n_markers,
                                                 cfg.df_marker, state.scale_g,
                                                 invweights=weights)
            if bayesl:
                gamma_l = sample_bayesl_gamma(gen, gamma_l, alpha, varg, gm.valid)

        # 2d. prior scale of the marker-effect variance
        scale_g = state.scale_g
        if cfg.estimate_scale and bayesb:
            scale_g = sample_scale_bayesb(gen, varg, gm.valid, cfg.n_markers,
                                          cfg.df_marker)
        elif cfg.estimate_scale:
            scale_g = sample_scale_st(gen, varg, cfg.df_marker)
        return state._replace(alpha=alpha, beta=beta, delta=delta, ycorr=ycorr,
                              varg=varg, pi=pi, scale_g=scale_g, gamma_l=gamma_l,
                              ann_coeffs=ann_coeffs, ann_var=ann_var)

    def step(state: ChainState, data: STData) -> ChainState:
        gen, gm = state.gen, data.gm

        # 0. a latent trait's liabilities and thresholds
        if latent:
            state = latent_step(cfg, state, data)

        # 1. location parameters (MCMC_BayesianAlphabet.jl:196-220), K6; on
        # the sparse path the PO-CG joint draw (jwas_tpu/engine/mcmc.py:160-178)
        if cfg.sparse_loc:
            state = sparse_location_step(cfg, state, data)
        else:
            lhs = (assemble_lhs_lambda(cfg.re_groups, data.WtW, data.Vinv, state.vc,
                                       state.vare) if cfg.re_groups else data.WtW)
            ycorr = state.ycorr + data.W @ state.sol
            w = ycorr if gm.rinv is None else gm.rinv * ycorr
            sol = gibbs_pass_lambda(lhs, state.sol, data.W.T @ w, state.vare, gen)
            ycorr -= data.W @ sol
            state = state._replace(sol=sol, ycorr=ycorr)
        sol = state.sol

        # 2. markers, pi, their variance and its scale
        if method != "none":
            state = markers(state, data)

        # 3.1 random-effect covariances (sampleVCs, variance_components.jl:
        # 115-147); a group with estimate_variance=False keeps its G (R10)
        vc = list(state.vc)
        for g, grp in enumerate(cfg.re_groups):
            if grp.estimate_variance:
                q = grp.n_levels
                sols = torch.stack([sol[s:s + q] for s in grp.starts])
                vc[g] = sample_random_effect_vc(gen, sols, data.Vinv[g], grp.df,
                                                data.vc_scale[g])

        # 3.2 residual variance
        vare = state.vare
        if cfg.estimate_residual_variance:
            vare = sample_residual_variance_st(gen, state.ycorr, cfg.n_obs,
                                               cfg.df_residual, data.scale_r,
                                               invweights=gm.rinv)
        return state._replace(vare=vare, vc=tuple(vc))

    return step


def _welford(m, x, n):
    return m + (x - m) / n


def _pi_summary(cfg: EngineCfg, data: STData, state: ChainState):
    """The pi a sample reports: BayesR's (4,) class prior, BayesC's and
    BayesB's P(excluded) of the first marker (their common value when pi
    is estimated), none (0,) for the methods without a pi, whose sample
    file rows jwas_tpu writes empty; under annotations the mean of the
    per-marker prior over the real markers (jwas_tpu/engine/mcmc.py:
    621-633)."""
    if cfg.anno_steps:
        real = data.gm.valid > 0
        pi = state.pi if state.pi.dim() == 2 else state.pi[:, None]
        mean = torch.where(real[:, None], pi, 0.0).sum(0) / cfg.n_markers
        return mean if state.pi.dim() == 2 else mean[0]
    if cfg.method in ("BayesC", "BayesB"):
        return state.pi[0]
    return state.pi


def _varg_summary(cfg: EngineCfg, data: STData, state: ChainState):
    """The marker variance a sample reports: BayesB's mean over the real
    markers, the common variance otherwise."""
    if cfg.method != "BayesB":
        return state.varg
    return torch.sum(torch.where(data.gm.valid > 0, state.varg, 0.0)) / cfg.n_markers


def loc_part(W, sol):
    """W sol for a dense or, on the sparse path, a CSR W (ops/sparse_mme.py::
    spmv, the same sums run after run)."""
    return sm.spmv(W, sol) if W.layout == torch.sparse_csr else W @ sol


def sample_ebv(data: STData, state: ChainState):
    """EBVs of a sample (getEBV, output.jl:281-306): prediction-equation
    terms plus X alpha, the latter one pass over the store in store order
    (K5 on the 2-bit store, one GEMV on a dense one) with the wanted IDs'
    columns selected; without markers the prediction-equation terms
    alone."""
    if isinstance(data.gm, NoMarkers):
        return loc_part(data.out_W, state.sol)
    if data.ebv_rows is not None and data.ebv_rows.numel() == 0:
        return torch.zeros(0, dtype=state.alpha.dtype, device=state.alpha.device)
    xa = data.gm.matvec_store(state.alpha)
    rows = data.gm.row_perm if data.ebv_rows is None else data.ebv_rows
    ebv = xa[:data.gm.n_obs] if rows is None else xa[rows]
    return ebv if data.out_W is None else loc_part(data.out_W, state.sol) + ebv


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
                        pi=_pi_summary(cfg, data, state),
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
                vc_m=tuple(_welford(m, v, n) for m, v in zip(accum.vc_m, state.vc)),
                vc_m2=tuple(_welford(m, v ** 2, n) for m, v in zip(accum.vc_m2, state.vc)),
                ann_m=(None if accum.ann_m is None
                       else _welford(accum.ann_m, state.ann_coeffs, n)),
                ann_m2=(None if accum.ann_m2 is None
                        else _welford(accum.ann_m2, state.ann_coeffs ** 2, n)),
            )
        return state, accum, out

    return run_window


def _init_accum(cfg: EngineCfg, data: STData, state: ChainState) -> Accum:
    def z(t):
        return torch.zeros_like(t, dtype=state.alpha.dtype)

    s = z(state.vare)
    pi = z(_pi_summary(cfg, data, state))
    if isinstance(data.gm, NoMarkers):
        n_out = data.out_W.shape[0]
    else:
        n_out = data.y.shape[0] if data.ebv_rows is None else data.ebv_rows.shape[0]
    ebv = torch.zeros(n_out, dtype=state.alpha.dtype, device=state.alpha.device)
    vc = tuple(z(v) for v in state.vc)
    ann = None if state.ann_coeffs is None else z(state.ann_coeffs)
    return Accum(n=0.0, sol_m=z(state.sol), sol_m2=z(state.sol),
                 alpha_m=z(state.alpha), alpha_m2=z(state.alpha),
                 delta_m=z(state.alpha), vare_m=s, vare_m2=s, varg_m=s,
                 varg_m2=s, pi_m=pi, pi_m2=pi, scale_m=s, scale_m2=s,
                 ebv_m=ebv, ebv_m2=ebv, vc_m=vc, vc_m2=vc, ann_m=ann, ann_m2=ann)


def _reject_unsupported(**unsupported) -> None:
    for name, value in unsupported.items():
        if value:
            raise NotImplementedError(
                f"{name} is not supported by run_st: it runs single-trait "
                f"{', '.join(METHODS)} (BayesA is BayesB with pi0 0 and "
                f"estimate_pi False) with one genotype category and no "
                f"random effects, latent traits or annotations, in the "
                f"store's dtype with the store's residual weights (a dense "
                f"store's, ops/dense.py::build_dense_markers; the 2-bit store "
                f"has none)"
            )


def _check_store(gm, method: str) -> None:
    """GBLUP runs on its eigenbasis and nothing else does, method "none"
    on no markers; the 2-bit store runs BayesC, BayesB and BayesR only,
    as in jwas_tpu."""
    if (method == "none") != isinstance(gm, NoMarkers):
        raise ValueError('method "none" runs on NoMarkers and the other methods '
                         'on markers')
    if (method == "GBLUP") != isinstance(gm, GBLUPMarkers):
        raise ValueError("GBLUP runs on a GBLUPMarkers (ops/gblup.py) and the "
                         "other methods on a marker store")
    if isinstance(gm, GroupedPackedMarkers) and method not in PI_METHODS:
        raise ValueError("storage='2bit' supports BayesC/BayesB/BayesR only")


def make_cfg(gm, method: str, *, nreps, sync_every, chain_length: int, df_R,
             df_marker, estimate_pi: bool, estimate_marker_variance: bool,
             estimate_scale: bool, estimate_residual_variance: bool,
             re_groups=()) -> EngineCfg:
    """The chain's static configuration; nreps defaults to the block size
    and is clamped to chain_length (never more sweeps than asked for); the
    exact sweep's store (a dense store built with exact=True), GBLUP and
    a model without markers run one sweep an outer iteration. Only BayesC,
    BayesB and BayesR estimate pi (RR-BLUP, BayesL and GBLUP have none,
    normalize_method). re_groups: a REGroupCfg a random-effect group."""
    _check_store(gm, method)
    if isinstance(gm, (GBLUPMarkers, NoMarkers)) or (
            isinstance(gm, DenseMarkers) and gm.exact):
        nreps = 1
    else:
        nreps = max(1, min(nreps if nreps is not None else gm.grams.shape[1],
                           chain_length))
    return EngineCfg(
        method=method, n_obs=gm.n_obs, n_markers=int(gm.valid.sum().item()),
        estimate_pi=estimate_pi and method in PI_METHODS,
        estimate_marker_variance=estimate_marker_variance,
        estimate_scale=estimate_scale,
        estimate_residual_variance=estimate_residual_variance,
        nreps=nreps, sync_every=mk.resolve_sync_every(nreps, sync_every),
        df_residual=float(df_R), df_marker=float(df_marker),
        re_groups=tuple(re_groups),
    )


def make_data(gm, y, W, scale_R, ebv_rows=None, out_W=None, Vinv=(),
              vc_scale=(), sl=None) -> STData:
    """The chain's device data in the store's dtype; y (n,) and W (n, K;
    None: an intercept) in observation order; the residual weights are the
    store's (gm.rinv). Vinv, vc_scale: a random-effect group's dense (q, q)
    structure (None: the identity) and (k, k) prior scale. W'R^-1W and
    each Vinv are made exactly symmetric (symmetric_upper), so that the
    location pass may read rows for columns. sl: the sparse location
    path's SparseLoc, whose CSR design and Vinvs take the place of W's and
    Vinv's (no W'R^-1W); out_W may then be a CSR tensor."""
    dev, f32, n = gm.device, gm.xpx.dtype, gm.n_obs
    y = torch.as_tensor(np.asarray(y), dtype=f32).to(dev)
    if sl is not None:
        if tuple(y.shape) != (n,) or sl.n_obs != n:
            raise ValueError(f"y and the sparse design must have {n} rows")
        return STData(
            W=sl.W, WtW=None, y=y, gm=gm, sl=sl,
            ebv_rows=None if ebv_rows is None else torch.as_tensor(
                np.asarray(ebv_rows), dtype=torch.int64).to(dev),
            out_W=out_W, scale_r=torch.tensor(float(np.mean(scale_R)), dtype=f32, device=dev),
            Vinv=tuple(grp.V for grp in sl.groups),
            vc_scale=tuple(torch.as_tensor(np.asarray(v), dtype=f32).to(dev)
                           for v in vc_scale))
    W = (torch.ones((n, 1), dtype=f32, device=dev) if W is None
         else torch.as_tensor(np.asarray(W), dtype=f32).to(dev))
    if tuple(y.shape) != (n,) or W.ndim != 2 or W.shape[0] != n:
        raise ValueError(f"y must be ({n},) and W ({n}, K) for {n} genotyped "
                         f"observations; got {tuple(y.shape)}, {tuple(W.shape)}")
    if ebv_rows is not None:
        ebv_rows = torch.as_tensor(np.asarray(ebv_rows), dtype=torch.int64).to(dev)
    if out_W is not None:
        out_W = torch.as_tensor(np.asarray(out_W), dtype=f32).to(dev)
    WtW = symmetric_upper(W.T @ (W if gm.rinv is None else gm.rinv[:, None] * W))

    def on_dev(x):
        return None if x is None else torch.as_tensor(np.asarray(x), dtype=f32).to(dev)

    return STData(W=W, WtW=WtW, y=y, gm=gm, ebv_rows=ebv_rows, out_W=out_W,
                  scale_r=torch.tensor(float(np.mean(scale_R)), dtype=f32, device=dev),
                  Vinv=tuple(None if v is None else symmetric_upper(on_dev(v)) for v in Vinv),
                  vc_scale=tuple(on_dev(v) for v in vc_scale))


def initial_state(cfg: EngineCfg, data: STData, *, vare0, marker_var0,
                  marker_scale0, pi0, seed: Optional[int], sol0=None,
                  alpha0=None, vc0=()) -> ChainState:
    """The location parameters at sol0 and the real markers' effects at
    alpha0 (each 0 when None; GBLUP ignores alpha0, as jwas_tpu does),
    every BayesC/B marker included (BayesR: all in the null class), the
    priors' values, one generator seeded with seed (None: 0)
    (jwas_tpu/engine/mcmc.py:1128-1224). A per-marker pi0 (p,) is kept,
    padded with 1.0; BayesB starts every real marker's variance at
    marker_var0 and the padding's at 1.0. BayesL draws its local shrinkage
    first, Gamma(1) * 8 a real marker (1 for padding), and starts from
    marker_var0 / 8 and marker_scale0 / 8 (:1151-1157). The starting
    residual is y - W sol0 - X alpha0, X alpha0 one K5 pass over the store
    (GBLUP: L alpha0; none without markers). vc0: a (k, k) starting
    covariance a random-effect group (:944)."""
    gm, method = data.gm, cfg.method
    dev, f32 = gm.device, gm.xpx.dtype

    def scalar(x):
        return torch.tensor(float(np.mean(x)), dtype=f32, device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if seed is None else int(seed))
    real = gm.valid > 0
    p_pad, p = gm.valid.shape[0], cfg.n_markers
    one = torch.ones((), dtype=f32, device=dev)
    gamma_l = torch.ones(p_pad, dtype=f32, device=dev)
    varg, scale_g = scalar(marker_var0), scalar(marker_scale0)
    if method == "BayesL":
        gamma_l = torch.where(real, sample_gamma_like(gen, 1.0, gamma_l) * 8.0, one)
        varg = scalar(float(np.mean(marker_var0)) / 8.0)
        scale_g = scalar(float(np.mean(marker_scale0)) / 8.0)
    sol = torch.zeros(data.W.shape[1], dtype=f32, device=dev)
    if sol0 is not None:
        sol = torch.as_tensor(np.asarray(sol0, dtype=np.float64), dtype=f32).to(dev)
    alpha = torch.zeros(p_pad, dtype=f32, device=dev)
    if alpha0 is not None and method != "GBLUP":
        alpha[:p] = torch.as_tensor(np.asarray(alpha0, dtype=np.float64), dtype=f32).to(dev)
    if method == "BayesR":
        delta = torch.zeros(p_pad, dtype=torch.int32, device=dev)
        pi = torch.as_tensor(bayesr_pi(pi0), dtype=f32).to(dev)
    else:
        delta = real.to(torch.int32)
        pi = torch.zeros(0, dtype=f32, device=dev)
    if method in ("BayesC", "BayesB"):
        pi_np = np.ones(p_pad)
        pi_np[:p] = np.asarray(pi0, dtype=np.float64)
        pi = torch.as_tensor(pi_np, dtype=f32).to(dev)
    if method == "BayesB":
        varg = torch.where(real, varg, one)
    ycorr = data.y - loc_part(data.W, sol)
    if method == "GBLUP":
        ycorr -= torch.mv(gm.L, alpha)
    elif method != "none":
        ycorr -= grouped_matvec(gm, alpha)
    vc = tuple(torch.as_tensor(np.atleast_2d(np.asarray(v, dtype=np.float64)),
                               dtype=f32).to(dev) for v in vc0)
    return ChainState(
        gen=gen, sol=sol, alpha=alpha, beta=alpha.clone(), delta=delta,
        ycorr=ycorr, vare=scalar(vare0), varg=varg,
        pi=pi, scale_g=scale_g, gamma_l=gamma_l, vc=vc,
    )


SAMPLE_KEYS = ("vare", "varg", "pi", "genvar", "h2")


CG_KEYS = ("solves", "iterations", "not_converged", "worst_residual")


def _read_back(state: ChainState, out: SampleOut, stream, p: int, cg=None) -> Dict:
    """A saved sample's values on the host, in one transfer: the tracks of
    SAMPLE_KEYS and what the sample files need (sol, alpha, BayesB's
    per-marker variances, ebv, the random-effect covariances vc<g>), and
    the sparse path's CG counters (cg, ops/sparse_mme.py::CGStats: fault
    R3) under CG_KEYS."""
    parts = {k: getattr(out, k) for k in SAMPLE_KEYS}
    dtype = state.alpha.dtype
    if stream is not None and stream.enabled:
        if stream.loc_slices:
            parts["sol"] = state.sol
        if stream.write_markers:
            parts["alpha"] = state.alpha[:p]
            if state.varg.dim():
                parts["varg_markers"] = state.varg[:p]
        if stream.ebv:
            parts["ebv"] = out.ebv
        if stream.re_vars:
            parts.update((f"vc{g}", v) for g, v in enumerate(state.vc))
        if stream.latent:
            parts["liab"] = state.liab
            if state.thresholds is not None:
                parts["thresholds"] = state.thresholds
    if cg is not None:
        parts.update(zip(CG_KEYS, cg.tensors()))
    return to_host(parts, dtype)


def to_host(parts: Dict[str, torch.Tensor], dtype) -> Dict[str, np.ndarray]:
    """The tensors of parts on the host in one transfer, as dtype, each in
    its own shape."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in parts.values()]).cpu().numpy()
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
    BayesB's (and none without markers), a pedigree group's scale mean(G)
    (df - k - 1), and the residual-variance scale mean(vare) (df_R - 2) /
    df_R. Returns (data, state)."""
    if cfg.method not in ("BayesB", "none"):
        state = state._replace(
            scale_g=accum.varg_m * (cfg.df_marker - 2.0) / cfg.df_marker)
    vc_scale = tuple(
        accum.vc_m[g] * (grp.df - len(grp.starts) - 1.0) if grp.random_type == "A"
        else data.vc_scale[g] for g, grp in enumerate(cfg.re_groups))
    data = data._replace(
        vc_scale=vc_scale,
        scale_r=accum.vare_m * (cfg.df_residual - 2.0) / cfg.df_residual)
    return data, state


def pool_accums(accums):
    """The pooled posterior means of equal-length chains: the mean over the
    chains of each running mean (exact: every chain saw n samples;
    jwas_tpu/engine/mcmc.py:1398-1399). Works on Accum and MTAccum."""
    if len(accums) == 1:
        return accums[0]

    def mean(xs):
        return torch.stack(list(xs)).mean(dim=0)

    fields = {}
    for name in accums[0]._fields:
        vals = [getattr(a, name) for a in accums]
        if name == "n" or vals[0] is None:
            fields[name] = vals[0]
        elif isinstance(vals[0], tuple):
            fields[name] = tuple(mean(v) for v in zip(*vals))
        else:
            fields[name] = mean(vals)
    return type(accums[0])(**fields)


def apply_update_priors_mc(cfg: EngineCfg, data: STData, states, accums):
    """The prior refresh of several chains (_apply_update_priors_mc,
    jwas_tpu/engine/mcmc.py:1227-1250): each chain's marker-variance scale
    from its own running mean, the shared residual and pedigree-group
    scales from the chains' pooled means. Returns (data, states)."""
    data, _ = apply_update_priors(cfg, data, states[0], pool_accums(accums))
    return data, [apply_update_priors(cfg, data, s, a)[1] for s, a in zip(states, accums)]


def run_chains(cfg: EngineCfg, data: STData, states, plan: ChainPlan, stream=None,
               chain_streams=(), progress=None, update_priors_frequency: int = 0):
    """K chains on one device (jwas_tpu/engine/mcmc.py:1253-1432, where
    they are vmapped): they share data (the store, its Gram tiles, the
    workspace) and each has its own state and generator. Each chain burns
    in, then every window each chain in turn runs its thin_outer outer
    iterations, so that the prior refresh (apply_update_priors_mc) sees
    every chain at the same window; each chain's sample is read back, chain
    0's written by stream (the top-level files) and chain k's by
    chain_streams[k] (chain_<k+1>/). samples holds every chain's draws,
    window by window, chain by chain, so that posterior SDs pool over
    (sample, chain); tracks holds each window's (K,) vare, h2, genvar,
    varg and (K, m) pi for the PSRF table. Returns (states, accums,
    samples, tracks, burnin_seconds, window_seconds)."""
    K = len(states)
    states = list(states)
    run_window = make_run_window(cfg)
    accums = [_init_accum(cfg, data, s) for s in states]
    samples = {k: [] for k in SAMPLE_KEYS}
    tracks = {k: [] for k in SAMPLE_KEYS}
    window_seconds = []
    upf, prior_epoch = int(update_priors_frequency or 0), 0
    t0 = time.perf_counter()
    if plan.burnin_outer > 0:
        for k in range(K):
            states[k], accums[k], out = run_window(states[k], data, accums[k],
                                                   plan.burnin_outer, accumulate=False)
        out.vare.item()              # waits for the device
    t_burnin = time.perf_counter() - t0
    for w in range(plan.n_saved):
        t_w = time.perf_counter()
        outs = []
        for k in range(K):
            states[k], accums[k], out = run_window(states[k], data, accums[k],
                                                   plan.thin_outer)
            outs.append(out)
        iters_done = (plan.burnin_outer + (w + 1) * plan.thin_outer) * plan.nreps
        if upf > 0 and iters_done // upf > prior_epoch:
            prior_epoch = iters_done // upf
            data, states = apply_update_priors_mc(cfg, data, states, accums)
        cg = None if data.sl is None else data.sl.stats
        hosts = [_read_back(states[k], outs[k], stream, cfg.n_markers,
                            cg if k == K - 1 else None) for k in range(K)]
        if cg is not None:
            cg.host = {k: float(hosts[-1][k]) for k in CG_KEYS}
        window_seconds.append(time.perf_counter() - t_w)
        for key in SAMPLE_KEYS:
            samples[key].extend(h[key] for h in hosts)
            tracks[key].append(np.stack([np.asarray(h[key]) for h in hosts]))
        if stream is not None:
            stream.write_sample(hosts[0])
        for cs, h in zip(chain_streams, hosts):
            cs.write_sample(h)
        if progress is not None:
            progress.update(iters_done, vare=hosts[0]["vare"], varg=hosts[0]["varg"],
                            pi=hosts[0]["pi"])
    return states, accums, samples, tracks, t_burnin, window_seconds


def run_chain(cfg: EngineCfg, data: STData, state: ChainState, plan: ChainPlan,
              stream=None, progress=None, update_priors_frequency: int = 0):
    """One chain through run_chains (jwas_tpu/engine/mcmc.py:1484-1560):
    burn-in, then n_saved windows of thin_outer outer iterations, each
    ending with its sample read back (and written by stream), the priors
    refreshed every update_priors_frequency sweeps. Returns (state, accum,
    samples, burnin_seconds, window_seconds)."""
    states, accums, samples, _, t_burnin, window_seconds = run_chains(
        cfg, data, [state], plan, stream, progress=progress,
        update_priors_frequency=update_priors_frequency)
    return states[0], accums[0], samples, t_burnin, window_seconds


def psrf_table(series) -> Table:
    """A Table of parameter and PSRF from (name, (n_saved, K) draws) pairs
    (jwas_tpu/engine/mcmc.py:1413-1431): a series whose chains are all
    constant is left out, and one PSRF cannot take (fewer than two
    samples) is skipped."""
    from jwas_tpu_torch.analysis.diagnostics import PSRF

    names, values = [], []
    for name, arr, skip_constant in series:
        if skip_constant and np.allclose(arr.std(axis=0), 0.0):
            continue
        try:
            with np.errstate(all="ignore"):
                values.append(float(PSRF(*[arr[:, c] for c in range(arr.shape[1])])))
        except ValueError:
            continue
        names.append(name)
    return Table({"parameter": np.asarray(names, dtype=object),
                  "PSRF": np.asarray(values, dtype=np.float64)})


def st_psrf(tracks) -> Table:
    """The single-trait PSRF table: vare, h2, genvar, varg, then each pi
    component that moves (pi[c]: BayesC's P(excluded) is pi[0], BayesR's
    four class shares pi[0]..pi[3])."""
    series = [(name, np.stack(tracks[name]), False) for name in ("vare", "h2", "genvar",
                                                                  "varg")]
    pi = np.stack(tracks["pi"])
    if pi.ndim == 2:                                    # BayesC: (n_saved, K)
        pi = pi[:, :, None]
    series += [(f"pi[{c}]", pi[:, :, c], True) for c in range(pi.shape[2])]
    return psrf_table(series)


def _host(t):
    return t.detach().cpu().numpy()


def run_st(gm, y, *, vare0: float, scale_R: float,
           df_R: float, marker_var0: float, marker_scale0: float,
           df_marker: float, pi0=0.0, W=None, nreps: Optional[int] = None,
           sync_every: Optional[int] = None, chain_length: int = 100,
           burnin: int = 0, output_samples_frequency: int = 0,
           seed: Optional[int] = None, estimate_pi: bool = True,
           estimate_marker_variance: bool = True,
           estimate_scale: bool = False,
           estimate_residual_variance: bool = True,
           method: str = "BayesC", rinv=None, dtype=None,
           random_effects=(), trait_type: str = "continuous",
           annotations=None, n_genotype_categories: int = 1) -> dict:
    """Run one single-trait chain of a method of METHODS on the device
    that holds gm, in gm's dtype with gm's residual weights.

    gm comes from setup_markers (or build_grouped_markers; BayesC, BayesB
    and BayesR only), or for a dense store from setup_dense_markers (or
    ops/dense.py::build_dense_markers; a store built with exact=True, as
    fast_blocks=False builds it, runs the exact sweep), or for GBLUP from
    ops/gblup.py::build_gblup_markers; y (n,) and the location design W
    (n, K; default: an intercept) are in observation order. The priors are
    those of prepare_workspace. pi0 is BayesC's
    P(excluded), or BayesR's (4,) class prior (0: the default
    DEFAULT_BAYESR_PI); for BayesR, marker_var0 is sigma^2, the variance
    of class 3, for BayesB every marker's starting variance; BayesA is
    BayesB with pi0 0 and estimate_pi False. nreps
    (default: the block size) effective sweeps make one outer iteration,
    clamped to chain_length; sync_every defaults to min(8, nreps).

    Returns numpy posterior means (vare, varg, pi, scale, sol, alpha,
    model_frequency, ebv) with posterior standard deviations (*_sd) and
    ebv_pev, the saved sample tracks under "samples", and host wall
    times: burnin_seconds and window_seconds (one per saved sample,
    thin_outer outer iterations each; each ends with the device finished,
    since its samples are read back). pi and pi_sd are floats for BayesC
    and (4,) arrays of class shares for BayesR, whose samples["pi"] is
    (n_saved, 4), and empty for the methods without a pi; model_frequency
    is each marker's posterior probability of a nonzero effect; ebv covers
    the training observations.
    """
    _reject_unsupported(
        method=method not in METHODS, rinv=rinv is not None,
        dtype=dtype is not None and dtype != gm.xpx.dtype,
        random_effects=len(random_effects) > 0,
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


def latent_setup_st(ws: Workspace, seed: Optional[int]):
    """A single-trait latent trait's data and starting values
    (jwas_tpu/engine/mcmc.py:995-1043): a categorical trait's categories
    (n,) and thresholds [-BIG, linspace(0, 1, K)[:-1].., BIG] ([-BIG, 0,
    BIG] binary), or a censored trait's bounds from its <name>_l / _u
    columns (a missing one infinite, clipped to +-BIG); the liabilities
    start from truncated normals of sd sqrt(vare0) within the bounds,
    drawn by scipy.stats.truncnorm on numpy's default_rng(seed) (0 for
    None), as the reference draws them. Returns a dict of numpy arrays:
    category_obs (None when censored), lower, upper, thresholds (None when
    censored), liab, and n_cat."""
    from scipy.stats import truncnorm

    from jwas_tpu_torch.io.table import to_numeric

    BIG = th.BIG
    trait_type, name, n = ws.model.traits_type[0], ws.model.lhs_vec[0], ws.n_obs
    rng = np.random.default_rng(seed if seed is not None else 0)
    out = dict(category_obs=None, thresholds=None, n_cat=0)
    if trait_type in CATEGORICAL:
        cats = np.asarray(np.nan_to_num(ws.y[:n]), dtype=np.int64)
        n_cat = int(cats.max())
        thr = (np.concatenate([[-BIG], np.linspace(0, 1, n_cat)[:-1], [BIG]])
               if trait_type == "categorical" else np.array([-BIG, 0.0, BIG]))
        lb = np.where(cats > 0, thr[np.maximum(cats - 1, 0)], -BIG)
        ub = np.where(cats > 0, thr[np.minimum(cats, len(thr) - 1)], BIG)
        out.update(category_obs=cats, thresholds=thr, n_cat=n_cat)
    else:
        lb = to_numeric(ws.df[f"{name}_l"], errors="coerce")
        ub = to_numeric(ws.df[f"{name}_u"], errors="coerce")
        lb = np.clip(np.nan_to_num(lb, nan=-np.inf), -BIG, BIG)
        ub = np.clip(np.nan_to_num(ub, nan=np.inf), -BIG, BIG)
    s0 = np.sqrt(float(ws.vare0))
    a, b = np.clip(lb / s0, -30, 30), np.clip(ub / s0, -30, 30)
    liab = np.where(lb < ub, truncnorm.rvs(a, np.maximum(b, a + 1e-6), scale=s0,
                                           random_state=rng, size=n), lb)
    out.update(lower=lb, upper=ub, liab=liab)
    return out


def annotation_design(g, p_pad: int) -> np.ndarray:
    """The annotation design A = [1, annotations] (p_pad, 1 + k), the
    padding's rows 0 (annotation_setup.jl:70-100)."""
    ann = np.asarray(g.annotations, dtype=np.float64)
    p = ann.shape[0]
    A = np.zeros((p_pad, 1 + ann.shape[1]))
    A[:p, 0] = 1.0
    A[:p, 1:] = ann
    return A


def annotation_start_st(g, k: int):
    """The probits' starting coefficients and slope variance
    (jwas_tpu/engine/mcmc.py:1057-1072): annotated BayesC's intercept is
    Phi^-1 of the mean inclusion 1 - pi (clipped to [1e-12, 1 - 1e-12]),
    its slopes 0, variance 1; annotated BayesR's (k, 3) zeros and (3,)
    ones. Returns (steps, coeffs, var) as numpy arrays."""
    from scipy.stats import norm

    if g.method == "BayesC":
        pi = np.full(g.n_markers, float(g.pi)) if np.ndim(g.pi) == 0 else (
            np.asarray(g.pi, dtype=np.float64))
        c0 = np.zeros(k)
        c0[0] = norm.ppf(float(np.clip(np.mean(1.0 - pi), 1e-12, 1 - 1e-12)))
        return 1, c0, np.asarray(1.0)
    return 3, np.zeros((k, 3)), np.ones(3)


def prediction_rows(ws: Workspace):
    """The sparse path's (n_out, K) prediction-equation rows as scipy CSR,
    from the workspace's sparse per-term rows (jwas_tpu/engine/mcmc.py:
    962-979); never a dense (n_out, K) matrix."""
    import scipy.sparse as sp

    rows, cols, vals = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], [np.zeros(0)]
    for name in ws.prediction_terms:
        Xt = sp.coo_matrix(ws.output_X[name])
        rows.append(Xt.row)
        cols.append(Xt.col + ws.model.term_dict[name].start_pos)
        vals.append(Xt.data)
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(len(ws.output_ids), ws.n_loc))


def _build_st_data_and_state(ws: Workspace, opts: MCMCOptions, device):
    """(cfg, data, state) of a single chain (_build_st_data_and_states)."""
    cfg, data, states = _build_st_data_and_states(ws, opts, device, 1)
    return cfg, data, states[0]


def _build_st_data_and_states(ws: Workspace, opts: MCMCOptions, device, n_chains: int):
    """The 2-bit grouped, the dense, the GBLUP and the no-marker branches
    of jwas_tpu's _build_st_data_and_state (:762-868, the random-effect
    groups :916-944, state :1128-1224): setup_markers' or
    setup_dense_markers' block choice and row order of the training rows
    (GBLUP: the workspace's eigenbasis), the residual weights, the chain's
    dtype (double_precision), the workspace's priors, the output IDs'
    store columns and prediction-equation rows, the groups' Vinv, scales
    and starting covariances, the residence of a 2-bit store
    (host_offload_genotypes) and the starting values (starting_value: the
    location parameters, :1131-1141; the genotypes' starting_alpha: the
    marker effects, :1142-1145). Returns (cfg, data, states): a state a
    chain, chain k's generator seeded seed + k (jwas_tpu/engine/mcmc.py:
    1262-1264; seed None counts as 0), every other starting value (a
    latent trait's liabilities among them) the same in every chain."""
    g = ws.geno
    K = ws.n_loc
    sparse = ws.W_sparse is not None
    dtype = torch.float64 if opts.double_precision else torch.float32
    sol0 = None
    if opts.starting_value is not None and opts.starting_value is not False:
        sol0 = np.asarray(opts.starting_value, dtype=np.float64).reshape(-1)
        if len(sol0) != K:
            raise ValueError(
                f"length of starting values for non-marker location "
                f"parameters is wrong (expected {K}, got {len(sol0)}); the "
                f"order is model.term_names()")
    if g is None:
        empty = torch.zeros(0, dtype=dtype, device=device)
        gm = NoMarkers(xpx=empty, valid=empty, n_obs=ws.n_obs,
                       rinv=None if ws.rinv is None else torch.as_tensor(
                           ws.rinv, dtype=dtype).to(device))
    elif g.method == "GBLUP":
        gm = build_gblup_markers(ws.gblup_L, ws.gblup_D, ws.gblup_out, rinv=ws.rinv)
    elif g.dense is not None:
        gm = setup_dense_markers(
            g.dense, g.obs_ids, ws.obs_ids, device, fast_blocks=opts.fast_blocks,
            rinv=ws.rinv, dtype=dtype)
    else:
        gm = setup_markers(g.packed_store, ws.obs_ids, device,
                           fast_blocks=opts.fast_blocks,
                           host_offload=opts.host_offload_genotypes)
    if opts.independent_blocks:
        sync_every = 0                   # one sync an outer iteration
    elif opts.sync_every is not None:
        sync_every = max(1, int(opts.sync_every))
    else:
        sync_every = None
    re_groups = [REGroupCfg(starts=grp.starts, n_levels=grp.n_levels, df=grp.df,
                            has_vinv=grp.Vinv is not None,
                            random_type=grp.random_type,
                            estimate_variance=grp.estimate_variance,
                            factor_rows=(0 if not sparse or grp.Vinv is None else
                                         grp.n_levels if grp.Vinv_factor is None
                                         else grp.Vinv_factor.shape[0]))
                 for grp in ws.re_groups]
    cfg = make_cfg(gm, "none" if g is None else g.method, nreps=opts.nreps,
                   sync_every=sync_every, chain_length=opts.chain_length,
                   df_R=ws.df_R, df_marker=ws.df_marker,
                   estimate_pi=g is not None and bool(g.estimate_pi),
                   estimate_marker_variance=g is not None and bool(g.G.estimate_variance),
                   estimate_scale=g is not None and bool(g.G.estimate_scale),
                   estimate_residual_variance=bool(ws.model.R.estimate_variance),
                   re_groups=re_groups)
    out_W = None
    if (ws.prediction_terms or g is None) and sparse:
        out_W = sm.csr(prediction_rows(ws), dtype, device)     # (jwas_tpu :593-597)
    elif ws.prediction_terms or g is None:
        out_W = np.zeros((len(ws.output_ids), K))
        for name in ws.prediction_terms:
            term = ws.model.term_dict[name]
            out_W[:, term.start_pos:term.start_pos + term.n_levels] += ws.output_X[name]
    trait_type = ws.model.traits_type[0]
    lat = latent_setup_st(ws, opts.seed) if trait_type in LATENT else None
    anno = g is not None and g.annotations is not None and g.method in ("BayesC",
                                                                         "BayesR")
    cfg = replace(cfg, trait_types=(trait_type,),
                  cat_counts=(lat["n_cat"],) if lat else (),
                  estimate_residual_variance=cfg.estimate_residual_variance
                  and trait_type not in CATEGORICAL)
    if sparse:
        cfg = replace(cfg, sparse_loc=True, cg_maxiter=int(opts.cg_maxiter),
                      cg_tol=1e-8 if opts.double_precision else 1e-6)
    sl = None if not sparse else sm.build_sparse_loc(ws.W_sparse, ws.rinv, ws.re_groups,
                                                      re_groups, dtype, device)
    data = make_data(gm, ws.y if lat is None else lat["liab"], ws.W, ws.scale_R,
                     ebv_rows=ws.output_store_rows,
                     out_W=out_W, Vinv=[grp.Vinv for grp in ws.re_groups],
                     vc_scale=[grp.scale for grp in ws.re_groups], sl=sl)

    def on_dev(x, dt=dtype):
        return None if x is None else torch.as_tensor(np.asarray(x), dtype=dt).to(device)

    if lat is not None and trait_type == "censored":
        data = data._replace(cens_lower=on_dev(lat["lower"]), cens_upper=on_dev(lat["upper"]))
    elif lat is not None:
        data = data._replace(category_obs=on_dev(lat["category_obs"], torch.int64))
    if anno:
        A = annotation_design(g, gm.valid.shape[0])
        steps, c0, v0 = annotation_start_st(g, A.shape[1])
        cfg = replace(cfg, anno_steps=steps)
        data = data._replace(anno_A=on_dev(A))
    def chain_state(seed):
        state = initial_state(cfg, data, vare0=ws.vare0, marker_var0=ws.marker_var0,
                              marker_scale0=ws.marker_scale0, pi0=ws.pi0, seed=seed,
                              sol0=sol0, alpha0=None if g is None else g.starting_alpha,
                              vc0=[grp.G0 for grp in ws.re_groups])
        if lat is not None:
            state = state._replace(liab=data.y.clone(),
                                   thresholds=on_dev(lat["thresholds"]))
        if anno:
            state = state._replace(ann_coeffs=on_dev(c0), ann_var=on_dev(v0))
            if g.method == "BayesR":      # one (4,) prior a marker, padding [1, 0, 0, 0]
                real = gm.valid > 0
                pad = torch.zeros(4, dtype=dtype, device=device)
                pad[0] = 1.0
                state = state._replace(pi=torch.where(real[:, None], state.pi[None, :], pad))
        return state

    seed0 = 0 if opts.seed is None else int(opts.seed)
    return cfg, data, [chain_state(seed0 + k) for k in range(n_chains)]


def runMCMC(model: Model, df, *, device="cuda", **kwargs) -> Dict:
    """Run MCMC for a model from build_model on phenotypes df (a Table, a
    {name: array} mapping or a DataFrame whose first column holds the IDs):
    the reference's runMCMC (JWAS.jl:161-511), one chain or n_chains
    (run_chains: the pooled means, a "PSRF" table and, with
    output_chain_samples, each chain's sample files under chain_<k>/ listed
    in "_chain_sample_folders"; random regression ignores n_chains, as
    jwas_tpu does), single-trait BayesC, BayesB or BayesR on the 2-bit store or a dense store, and
    RR-BLUP, BayesA, BayesL or GBLUP on a dense store or a relationship
    matrix (with residual weights, heterogeneous_residuals, and float64,
    double_precision), or no genotypes; with the random effects of
    set_random (i.i.d., pedigree and Vinv groups; the pedigree also as
    the option pedigree=); latent traits (build_model's categorical_trait,
    censored_trait) and annotations (get_genotypes's annotations: BayesC
    and BayesR on a dense store). A model of several equations runs the
    multi-trait chain (engine/mcmc_mt.py: BayesC and BayesB on a dense
    store, samplers I and II, the mega-trait constraint, latent traits,
    2-trait annotated BayesC, or no genotypes). RRM=Phi runs the random
    regression model of a longitudinal trait (engine/mcmc_rrm.py: long
    data with a 'time' column, BayesC, BayesB, RR-BLUP or BayesL on a dense
    store, its marker chain K10; the keys of jwas_tpu's RRM results,
    "EBV_trajectory" among them). kwargs are MCMCOptions' fields.

    device: where the chain runs, the GPU unless the caller asks for the
    CPU (device="cpu" runs the kernels' plain versions); without a GPU the
    default raises. Returns a dict of Tables (the keys of jwas_tpu's
    result dict: "location parameters", "residual variance", "marker
    effects <name>", "marker effects variances <name>", "pi_<name>",
    "ScaleEffectVar<name>", "polygenic effects covariance matrix", "random
    effect variances <term>", "EBV_<trait>", "genetic_variance",
    "heritability"), written as <key>.txt to output_folder with the
    per-parameter MCMC sample files. Options the reference rejects raise
    its ValueError before an option the port does not run yet raises
    NotImplementedError (prepare_workspace checks both, then the device).
    """
    opts = MCMCOptions(**kwargs)
    if opts.RRM is not None:
        # jwas_tpu's order (engine/mcmc.py:1441-1470): the ValueErrors of
        # validate_args, then run_mcmc_rrm, before the multi-trait branch
        from jwas_tpu_torch.engine.mcmc_rrm import run_mcmc_rrm
        validate_args(model, opts)
        reject_unported(opts)
        device = resolve_device(device)
        model.mcmc_info = opts
        if opts.printout_model_info:
            describe(model)
        return run_mcmc_rrm(model, df, opts, device)
    if model.n_models != 1:
        from jwas_tpu_torch.engine.mcmc_mt import run_mcmc_mt
        return run_mcmc_mt(model, df, opts, device)
    ws = prepare_workspace(model, df, opts, device=device)
    device = resolve_device(device)
    model.mcmc_info = opts
    if opts.printout_model_info:
        describe(model)
    n_chains = int(opts.n_chains)
    cfg, data, states = _build_st_data_and_states(ws, opts, device, n_chains)
    plan = chain_plan(opts.chain_length, opts.burnin, opts.output_samples_frequency,
                      cfg.nreps)
    stream = STSampleStream(ws, cfg, opts)
    chain_streams = multichain_streams(STSampleStream, ws, cfg, opts, n_chains)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length)
    try:
        with maybe_profile(opts):
            _, accums, samples, tracks, _, _ = run_chains(
                cfg, data, states, plan, stream, chain_streams, progress,
                update_priors_frequency=opts.update_priors_frequency)
    finally:
        stream.close()
        for cs in chain_streams:
            cs.close()
    accum = pool_accums(accums)
    accum = accum._replace(**{k: _host(v) if torch.is_tensor(v) else
                              tuple(_host(t) for t in v)
                              for k, v in accum._asdict().items()
                              if k != "n" and v is not None})
    results = build_results(ws, cfg, accum, samples, opts)
    if data.sl is not None:
        results["_location_cg"] = cg = dict(data.sl.stats.host or {},
                                            host_reads=data.sl.stats.host_reads)
        if cg.get("not_converged", 0) > 0:
            warnings.warn(
                f"{int(cg['not_converged'])} of {int(cg['solves'])} location draws' CG "
                f"stopped at cg_maxiter={cfg.cg_maxiter} above its tolerance "
                f"{cfg.cg_tol:.0e} (worst relative residual "
                f"{cg['worst_residual']:.2e}); raise cg_maxiter")
    if ws.ssbr is not None:
        results["_single_step"] = dict(ws.ssbr)
    if stream.enabled and stream.write_markers and ws.geno is not None:
        results["_marker_sample_file"] = stream.writer.path(
            f"marker_effects_{ws.geno.name}_{model.lhs_vec[0]}")
    if chain_streams:
        results["_chain_sample_folders"] = [cs.writer.folder for cs in chain_streams]
    if n_chains > 1 and plan.n_saved > 1:
        results["PSRF"] = st_psrf(tracks)
    return results
