"""The multi-trait engine: BayesC, BayesB, RR-BLUP and BayesL on a dense
store, GBLUP on its eigenbasis, or no genotypes, with random effects and
SEM's structural equations: Gibbs step, chain loop, runMCMC's multi-trait
branch.

Counterpart of jwas_tpu/engine/mcmc_mt.py: _pattern_Ri (:83), make_mt_step
(:97-525: the imputation of missing residuals :156-175, the location pass
:177-199, the markers of BayesC and BayesB :206-309, of RR-BLUP and BayesL
:310-364, of GBLUP :365-376, pi :378-399, the marker-effect covariance and
BayesL's local shrinkage :401-454, the random-effect covariances :456-464,
the residual covariance :466-487, SEM's structural coefficients
:489-516), make_mt_run_window (:567-629), pi_dict_to_vector (:632),
build_mt_data_and_state (:645-991), _apply_update_priors_mt (:1015-1034),
_run_mt_multichain (:1037-1230, here run_mt_chains: K states on one
device, a window each in turn; the single chain, :1270-1300, is its one
state) and run_mcmc_mt (:1232).

- Latent traits (binary, ordered categorical, censored; :112-148, set-up
  :758-830): each outer iteration first draws their liabilities
  (ops/threshold.py::sample_liabilities, 5 Gibbs passes when more than one
  trait is latent, tail-safe where jwas_tpu's truncated normal collapses,
  fault R13) and each categorical trait's free thresholds; with a binary
  trait R is Korsgaard's conditional draw, its variance pinned at 1.
- 2-trait annotated BayesC (:379-390, :852-888): a three-step tree probit
  (ops/annotations.py::anno_bayesc_mt_update) replaces the Dirichlet draw
  and gives every marker its own (4,) pattern prior, which K7 / K8 take
  per marker (csrc/mt_inner_rounds_pm.cu).

- The residual precision of an observation is Ri_p rinv_i, Ri_p (t, t)
  of its missing pattern p (the static set of observed-trait masks); the
  missing residuals are imputed each iteration from the observed ones
  (the best linear predictor plus its conditional noise).
- The location LHS W'R^-1W is assembled each iteration from pieces fixed
  at set-up (ops/location.py::MTLocationPieces, one product a trait
  pair, where jwas_tpu takes one einsum over every record), plus the
  random-effect blocks G^-1[i, j] Vinv; the pass is K6 with vare 1
  (gibbs_pass_general).
- The markers: samplers I (K7) or II (K8) for BayesC / BayesB, the
  RR-BLUP / BayesL chain (K9) over the dense store's groups
  (ops/multitrait.py), blocked (fast_blocks) or exact (one block a group,
  one sweep an outer iteration); GBLUP's joint draw of every
  pseudo-marker (ops/multitrait.py::mt_gblup); with G.constraint
  (mega-trait) the single-trait sweep of each trait in turn (K1, or
  GBLUP's sweep), against its own residual. BayesB has one (t, t)
  covariance a locus, drawn as one batched inverse-Wishart.
- SEM (causal_structure): ycorr holds Lambda y minus the effects; after
  the residual covariance, the structural coefficients are drawn from
  the raw residuals (sem_lambda) and ycorr moves to the new Lambda y.
- The EBVs of the output IDs are their rows of X alpha' over the store,
  one (n_store, p) x (p, t) product (never a dense (n_out, p) decode,
  reference fault R7).

A random-effect group set with estimate_variance=False keeps its G (the
reference draws it all the same, fault R10). update_priors_frequency > 0
refreshes the priors' scales from the running means between windows
(apply_update_priors_mt).
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from jwas_tpu_torch.engine.mcmc import (LATENT, NoMarkers, annotation_design, chain_plan,
                                        pool_accums, psrf_table, setup_dense_markers,
                                        to_host, _welford)
from jwas_tpu_torch.engine.output_mt import build_mt_results
from jwas_tpu_torch.engine.progress import ProgressPrinter, maybe_profile
from jwas_tpu_torch.engine.samples_io import MTSampleStream, multichain_streams
from jwas_tpu_torch.engine.setup import (MCMCOptions, Workspace, prepare_workspace,
                                         resolve_device, sem_edges)
from jwas_tpu_torch.engine.state import MTChainState, MTEngineCfg, REGroupCfg
from jwas_tpu_torch.io.table import Table
from jwas_tpu_torch.models.model import describe
from jwas_tpu_torch.ops import annotations as an
from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops import multitrait as mt
from jwas_tpu_torch.ops import threshold as th
from jwas_tpu_torch.ops.dists import sample_gamma_like
from jwas_tpu_torch.ops.gblup import build_gblup_markers, sweep_gblup
from jwas_tpu_torch.ops.grouped import (hbm_budget, sweep_blocks_abc_grouped,
                                        sweep_blocks_c0l_grouped)
from jwas_tpu_torch.ops.location import (MTLocationPieces, gibbs_pass_general,
                                         symmetric_upper)
from jwas_tpu_torch.ops.variance import (mt_covariance_effects,
                                         sample_marker_covariance,
                                         sample_marker_covariance_bayesb,
                                         sample_mt_bayesl_gamma,
                                         sample_pattern_pi, sample_pi_abc,
                                         sample_random_effect_vc,
                                         sample_residual_covariance)

# the share of the device's memory the location LHS pieces may take
# (above it each iteration computes the LHS blocks from W)
PIECES_SHARE = 0.1


class MTData(NamedTuple):
    """Static device data of a multi-trait chain, in the chain's dtype."""

    W: torch.Tensor            # (t n, K) stacked location design
    lhs: MTLocationPieces      # W'R^-1W a pattern and trait pair
    y: torch.Tensor            # (t, n)
    gm: object                 # DenseMarkers, GBLUPMarkers or NoMarkers
    rinv: Optional[torch.Tensor]      # (n,) inverse residual weights
    patterns: torch.Tensor     # (P, t) observed-trait masks, 0/1
    pattern_idx: torch.Tensor  # (n,) int64 pattern of each observation
    pattern_rows: Tuple[torch.Tensor, ...]  # each pattern's rows, int64
    scale_R: torch.Tensor      # (t, t) residual prior scale
    marker_scale: torch.Tensor  # (t, t) marker-effect prior scale
    ebv_rows: Optional[torch.Tensor]   # (n_out,) store columns of the EBVs' IDs
    out_W: Optional[torch.Tensor]      # (t, n_out, K) prediction-equation rows
    Vinv: tuple = ()           # a group's (q, q) Vinv, exactly symmetric;
                               # None for "I"
    vc_scale: tuple = ()       # a group's (k, k) prior scale
    category_obs: Optional[torch.Tensor] = None  # (t, n) int64 categories,
                                                 # 0 missing or not categorical
    cens_lower: Optional[torch.Tensor] = None    # (t, n) censoring bounds,
    cens_upper: Optional[torch.Tensor] = None    # +-BIG elsewhere
    anno_A: Optional[torch.Tensor] = None        # (p_pad, k) annotation design


class MTSampleOut(NamedTuple):
    R: torch.Tensor
    varg: torch.Tensor         # BayesB: the mean over the real loci
    pi: torch.Tensor
    ebv: torch.Tensor          # (t, n_out)
    genvar: torch.Tensor       # (t, t)
    h2: torch.Tensor           # (t,)
    lam: Optional[torch.Tensor] = None   # (n_edges,) SEM's coefficients


class MTAccum(NamedTuple):
    """Running posterior means (Welford)."""

    n: float
    sol_m: torch.Tensor
    sol_m2: torch.Tensor
    alpha_m: torch.Tensor
    alpha_m2: torch.Tensor
    delta_m: torch.Tensor
    R_m: torch.Tensor
    R_m2: torch.Tensor
    varg_m: torch.Tensor
    varg_m2: torch.Tensor
    pi_m: torch.Tensor
    pi_m2: torch.Tensor
    ebv_m: torch.Tensor
    ebv_m2: torch.Tensor
    vc_m: tuple = ()
    vc_m2: tuple = ()
    lam_m: Optional[torch.Tensor] = None   # SEM's structural coefficients
    lam_m2: Optional[torch.Tensor] = None
    ann_m: Optional[torch.Tensor] = None   # the tree probit's coefficients
    ann_m2: Optional[torch.Tensor] = None


def pattern_Ri(patterns, R):
    """Each missing pattern's residual precision (getRi, residual.jl:2-11):
    Ri_p = M_p inv(M_p R M_p + (I - M_p)) M_p, zero rows and columns for
    the missing traits; (P, t, t)."""
    t = R.shape[0]
    M = patterns[:, :, None] * patterns[:, None, :]
    eye = torch.eye(t, dtype=R.dtype, device=R.device)
    A = M * R + (eye - patterns[:, :, None] * eye)
    return torch.linalg.inv(A) * M


def impute_missing(ycorr, R, pattern_rows, pattern_masks, gen, zs=None):
    """sampleMissingResiduals (residual.jl:51-73): for each pattern with
    missing traits m and observed traits o, the missing residuals of its
    rows become R_mo R_oo^-1 e_o + chol(R_mm - R_mo R_oo^-1 R_om) z, in
    place. zs: a pattern's (|m|, rows) normals (tests inject jwas_tpu's),
    else drawn from gen."""
    for p, (rows, mask) in enumerate(zip(pattern_rows, pattern_masks)):
        obs = [i for i, m in enumerate(mask) if m]
        mis = [i for i, m in enumerate(mask) if not m]
        if not mis or rows.numel() == 0:
            continue
        o = torch.tensor(obs, device=R.device)
        m = torch.tensor(mis, device=R.device)
        Roo, Rmo, Rmm = R[o][:, o], R[m][:, o], R[m][:, m]
        Ri_oo = torch.linalg.inv(Roo)
        C = Rmm - Rmo @ Ri_oo @ Rmo.T
        Lc = torch.linalg.cholesky(0.5 * (C + C.T))
        z = (torch.randn((len(mis), rows.numel()), generator=gen, dtype=R.dtype,
                         device=R.device) if zs is None else zs[p])
        imput = (Rmo @ Ri_oo) @ ycorr[o][:, rows] + Lc @ z
        ycorr[m[:, None], rows[None, :]] = imput
    return ycorr


def location_rhs(data: MTData, Ri_pat, ycorr_plus):
    """W' R^-1 (ycorr + W sol): each observation's (t,) residual times its
    pattern's precision (and weight), then one product with the stacked
    design."""
    Ri_n = Ri_pat[data.pattern_idx]
    if data.rinv is not None:
        Ri_n = Ri_n * data.rinv[:, None, None]
    v = torch.einsum("nab,bn->an", Ri_n, ycorr_plus)
    return data.W.T @ v.reshape(-1)


def sample_markers(cfg: MTEngineCfg, state: MTChainState, data: MTData) -> MTChainState:
    """The marker effects (K7 / K8, K9, GBLUP's joint draw, or a trait at
    a time under the constraint), pi, the marker-effect covariance and
    BayesL's local shrinkage of one outer iteration (mcmc_mt.py:201-454);
    the marker tensors are updated in place."""
    t, method = cfg.n_traits, cfg.method
    bayesb, bayesl, gblup = method == "BayesB", method == "BayesL", method == "GBLUP"
    c0l = method in ("RR-BLUP", "BayesL")
    gen, gm, ycorr = state.gen, data.gm, state.ycorr
    alpha, beta, delta, pi, varg, gamma_l = (state.alpha, state.beta, state.delta,
                                             state.pi, state.varg, state.gamma_l)
    if cfg.constraint:
        # mega-trait: the single-trait sweep of each trait in turn, on
        # its own residual row (mcmc_mt.py:206-255, :311-337, :366-372)
        for k in range(t):
            if gblup:
                sweep_gblup(gm, alpha[k], ycorr[k], state.R[k, k], varg[k, k], gen)
            elif c0l:
                sweep_blocks_c0l_grouped(gm, alpha[k], ycorr[k], state.R[k, k],
                                         varg[k, k], gamma_l, gen, nreps=cfg.nreps,
                                         sync_every=cfg.sync_every)
            else:
                var_eff = varg[:, k, k] if bayesb else varg[k, k]
                pi_k = torch.where(gm.valid > 0, torch.clamp(pi[k], 1e-10, 1.0), 1.0)
                d_k = delta[k].to(torch.int32)
                sweep_blocks_abc_grouped(gm, alpha[k], beta[k], d_k, ycorr[k],
                                         state.R[k, k], var_eff, pi_k, gen,
                                         nreps=cfg.nreps, sync_every=cfg.sync_every)
                delta[k] = d_k.to(delta.dtype)
    elif gblup:
        mt.mt_gblup(gm, alpha, ycorr, state.R, varg, gen)
    elif c0l:
        mt.sweep_blocks_mt_c0l_grouped(gm, alpha, ycorr, state.R, torch.linalg.inv(varg),
                                       gamma_l, gen, nreps=cfg.nreps,
                                       sync_every=cfg.sync_every)
    else:
        ginv = torch.linalg.inv(varg)
        mt.sweep_blocks_mt_abc_grouped(gm, alpha, beta, delta, ycorr, state.R,
                                       ginv, pi, gen, sampler=cfg.mt_sampler,
                                       nreps=cfg.nreps, sync_every=cfg.sync_every)

    # pi (mcmc_mt.py:378-399), or the tree probit in its place
    ann_coeffs, ann_var = state.ann_coeffs, state.ann_var
    if cfg.anno_steps:
        ann_coeffs, ann_var, pi = an.anno_bayesc_mt_update(
            data.anno_A, delta, ann_coeffs, ann_var, gm.valid, an.ProbitDraws(gen))
    elif cfg.estimate_pi and cfg.constraint:
        pi = torch.stack([sample_pi_abc(gen, delta[k], cfg.n_markers, gm.valid)
                          for k in range(t)]).to(pi.dtype)
    elif cfg.estimate_pi:
        pi = sample_pattern_pi(gen, delta, gm.valid)

    # the marker-effect covariance, then BayesL's local shrinkage
    # (mcmc_mt.py:401-454)
    if cfg.estimate_marker_variance and bayesb:
        varg = sample_marker_covariance_bayesb(gen, beta, cfg.df_marker,
                                               data.marker_scale, cfg.constraint)
    elif cfg.estimate_marker_variance:
        eff = mt_covariance_effects(method, alpha, beta, gamma_l,
                                    gm.D if gblup else None)
        varg = sample_marker_covariance(gen, eff, gm.valid, cfg.n_markers,
                                        cfg.df_marker, data.marker_scale,
                                        cfg.constraint)
        if bayesl:
            gamma_l = sample_mt_bayesl_gamma(gen, gamma_l, alpha, varg, gm.valid)
    return state._replace(alpha=alpha, beta=beta, delta=delta, ycorr=ycorr,
                          pi=pi, varg=varg, gamma_l=gamma_l, ann_coeffs=ann_coeffs,
                          ann_var=ann_var)


def mt_latent_step(cfg: MTEngineCfg, state: MTChainState, data: MTData,
                   z_of=None, u_thr=None) -> MTChainState:
    """The latent traits' liabilities and thresholds (mcmc_mt.py:112-148):
    each latent trait's bounds (censoring, or its thresholds), then
    sample_liabilities over them with n_gibbs 5 when more than one trait
    is latent (z_of: its truncated normals, default from the chain's
    generator), then each categorical trait with more than 2 categories
    its free thresholds from 3 on (u_thr(k): trait k's uniforms, default
    drawn)."""
    t, n = state.ycorr.shape
    lower = torch.full((t, n), -th.BIG, dtype=state.ycorr.dtype, device=state.ycorr.device)
    upper = torch.full_like(lower, th.BIG)
    for k in cfg.latent_traits:
        if cfg.trait_types[k] == "censored":
            lower[k], upper[k] = data.cens_lower[k], data.cens_upper[k]
        else:
            lower[k], upper[k] = th.bounds_from_thresholds(state.thresholds[k],
                                                           data.category_obs[k])
    n_gibbs = 5 if len(cfg.latent_traits) > 1 else 1
    liab, ycorr = th.sample_liabilities(
        state.liab, state.ycorr, state.R, lower, upper, cfg.latent_traits, n_gibbs,
        th.truncated_normals(state.gen) if z_of is None else z_of)
    thresholds = state.thresholds.clone()
    for k in cfg.latent_traits:
        if cfg.trait_types[k] == "categorical" and cfg.cat_counts[k] > 2:
            args = (thresholds[k], liab[k], data.category_obs[k], cfg.cat_counts[k], 3)
            thresholds[k] = (th.draw_thresholds(state.gen, *args) if u_thr is None
                             else th.sample_thresholds_t(*args, u_thr(k)))
    return state._replace(liab=liab, ycorr=ycorr, thresholds=thresholds)


def sem_lambda(y, ycorr, R, Lambda, edges, z):
    """SEM's structural coefficients (get_Lambda, SEM.jl:125-165;
    mcmc_mt.py:489-516): ycorr is Lambda y less the effects; the raw
    residual ycorr - Lambda_old y + y, then lambda ~ N(F^-1 s, F^-1) with
    F = I + (y_j y_j' / R_ii over edge pairs into the same trait i) (prior
    N(0, 1)) and s_e = y_j' raw_i / R_ii for edge e = (i <- j); y the raw
    phenotypes (t, n), z (m,) standard normals. Returns (Lambda, ycorr at
    the new Lambda y)."""
    t, m = R.shape[0], len(edges)
    YY = y @ y.T
    rows = torch.tensor([e[0] for e in edges], device=y.device)
    cols = torch.tensor([e[1] for e in edges], device=y.device)

    def lam_y(lam):
        C = torch.zeros((t, t), dtype=y.dtype, device=y.device)
        C[rows, cols] = lam
        return y - C @ y

    raw = ycorr - lam_y(Lambda) + y
    Rd = torch.diagonal(R)
    first = torch.eye(m, dtype=y.dtype, device=y.device)
    for a, (i, j) in enumerate(edges):
        for b, (i2, j2) in enumerate(edges):
            if i == i2:
                first[a, b] += YY[j, j2] / Rd[i]
    second = torch.stack([y[j] @ raw[i] / Rd[i] for i, j in edges])
    Finv = torch.linalg.inv(first)
    Lc = torch.linalg.cholesky(0.5 * (Finv + Finv.T))
    Lambda = Finv @ second + Lc @ z
    return Lambda, raw - y + lam_y(Lambda)


def make_mt_step(cfg: MTEngineCfg):
    """One outer iteration: the latent traits' liabilities and thresholds
    (mt_latent_step), imputation of the missing residuals, location pass
    (K6), markers (sample_markers), pi, the marker-effect covariance,
    the random-effect covariances, the residual covariance, SEM's
    structural coefficients. The marker state of the returned state is the
    input's tensors, updated in place."""
    t = cfg.n_traits

    def step(state: MTChainState, data: MTData) -> MTChainState:
        gen, n = state.gen, data.y.shape[1]
        if cfg.latent_traits:
            state = mt_latent_step(cfg, state, data)
        ycorr = state.ycorr
        if cfg.missing_phenotypes:
            ycorr = impute_missing(ycorr, state.R, data.pattern_rows,
                                   cfg.pattern_masks, gen)

        # 1. location parameters (mcmc_mt.py:177-199), K6 with vare 1
        Ri_pat = pattern_Ri(data.patterns, state.R)
        ycorr_plus = ycorr + (data.W @ state.sol).view(t, n)
        lhs = data.lhs.assemble(Ri_pat, cfg.re_groups, data.Vinv, state.vc)
        sol = gibbs_pass_general(lhs, state.sol,
                                 location_rhs(data, Ri_pat, ycorr_plus), gen)
        ycorr = ycorr_plus - (data.W @ sol).view(t, n)
        state = state._replace(sol=sol, ycorr=ycorr)

        # 2. markers, pi and their covariance
        if cfg.method != "none":
            state = sample_markers(cfg, state, data)

        # 3.1 random-effect covariances; a group with estimate_variance=False
        # keeps its G (R10)
        vc = list(state.vc)
        for g, grp in enumerate(cfg.re_groups):
            if grp.estimate_variance:
                q = grp.n_levels
                sols = torch.stack([sol[s:s + q] for s in grp.starts])
                vc[g] = sample_random_effect_vc(gen, sols, data.Vinv[g], grp.df,
                                                data.vc_scale[g])

        # 3.2 residual covariance (mcmc_mt.py:466-487)
        R = state.R
        if cfg.estimate_residual_variance:
            # with binary traits Korsgaard's draw (r_constraint first)
            kw = dict(binary=cfg.binary_traits) if cfg.binary_traits else {}
            R = sample_residual_covariance(gen, state.ycorr, data.rinv, cfg.n_obs,
                                           cfg.df_residual, data.scale_R,
                                           cfg.r_constraint, **kw)
        state = state._replace(R=R, vc=tuple(vc))

        # 4. SEM's structural coefficients (mcmc_mt.py:489-516)
        if cfg.sem_edges:
            z = torch.randn(len(cfg.sem_edges), generator=gen, dtype=R.dtype,
                            device=R.device)
            Lambda, ycorr = sem_lambda(data.y, state.ycorr, R, state.Lambda,
                                       cfg.sem_edges, z)
            state = state._replace(Lambda=Lambda, ycorr=ycorr)
        return state

    return step


def sample_ebv(cfg: MTEngineCfg, data: MTData, state: MTChainState):
    """(t, n_out) EBVs of a sample: the prediction-equation terms plus the
    output IDs' rows of X alpha' over the store (one product for the t
    traits); without markers the prediction-equation terms alone."""
    ebv = None if data.out_W is None else torch.einsum("tok,k->to", data.out_W, state.sol)
    if cfg.method != "none" and data.ebv_rows is not None and data.ebv_rows.numel():
        xa = data.gm.matvec_store(state.alpha.T)[data.ebv_rows].T
        ebv = xa if ebv is None else ebv + xa
    if ebv is None:
        ebv = torch.zeros((cfg.n_traits, 0), dtype=state.R.dtype, device=state.R.device)
    return ebv


def make_mt_run_window(cfg: MTEngineCfg):
    step = make_mt_step(cfg)

    def run_window(state: MTChainState, data: MTData, accum: MTAccum,
                   n_iters: int, accumulate: bool = True):
        for _ in range(n_iters):
            state = step(state, data)
        ebv = sample_ebv(cfg, data, state)
        t, n_out = ebv.shape
        if n_out > 1:
            ebvc = ebv - ebv.mean(dim=1, keepdim=True)
            genvar = (ebvc @ ebvc.T) / (n_out - 1)
        else:
            genvar = torch.zeros((t, t), dtype=ebv.dtype, device=ebv.device)
        h2 = torch.diagonal(genvar) / (torch.diagonal(genvar) + torch.diagonal(state.R))
        varg_out = (state.varg[:cfg.n_markers].mean(dim=0) if state.varg.dim() == 3
                    else state.varg)
        pi_out = (state.pi[:cfg.n_markers].mean(dim=0) if state.pi.dim() == 2
                  else state.pi)
        out = MTSampleOut(R=state.R, varg=varg_out, pi=pi_out, ebv=ebv,
                          genvar=genvar, h2=h2, lam=state.Lambda)
        if accumulate:
            n = accum.n + 1.0
            pairs = dict(sol=state.sol, alpha=state.alpha, R=state.R, varg=state.varg,
                         pi=state.pi, ebv=ebv)
            if state.Lambda is not None:
                pairs["lam"] = state.Lambda
            if state.ann_coeffs is not None:
                pairs["ann"] = state.ann_coeffs
            upd = {}
            for k, x in pairs.items():
                upd[k + "_m"] = _welford(getattr(accum, k + "_m"), x, n)
                upd[k + "_m2"] = _welford(getattr(accum, k + "_m2"), x ** 2, n)
            accum = MTAccum(
                n=n, delta_m=_welford(accum.delta_m, state.delta, n),
                vc_m=tuple(_welford(m, v, n) for m, v in zip(accum.vc_m, state.vc)),
                vc_m2=tuple(_welford(m, v ** 2, n) for m, v in zip(accum.vc_m2, state.vc)),
                **upd)
        return state, accum, out

    return run_window


def init_mt_accum(data: MTData, state: MTChainState) -> MTAccum:
    def z(x):
        return torch.zeros_like(x)

    n_out = 0 if data.ebv_rows is None else data.ebv_rows.numel()
    if data.out_W is not None:
        n_out = data.out_W.shape[1]
    ebv = torch.zeros((state.R.shape[0], n_out), dtype=state.R.dtype,
                      device=state.R.device)
    vc = tuple(z(v) for v in state.vc)
    lam = None if state.Lambda is None else z(state.Lambda)
    ann = None if state.ann_coeffs is None else z(state.ann_coeffs)
    return MTAccum(n=0.0, sol_m=z(state.sol), sol_m2=z(state.sol),
                   alpha_m=z(state.alpha), alpha_m2=z(state.alpha),
                   delta_m=z(state.alpha), R_m=z(state.R), R_m2=z(state.R),
                   varg_m=z(state.varg), varg_m2=z(state.varg), pi_m=z(state.pi),
                   pi_m2=z(state.pi), ebv_m=ebv, ebv_m2=ebv, vc_m=vc, vc_m2=vc,
                   lam_m=lam, lam_m2=lam, ann_m=ann, ann_m2=ann)


SAMPLE_KEYS = ("R", "varg", "pi", "genvar", "h2")


def _read_back(state: MTChainState, out: MTSampleOut, stream, p: int) -> Dict:
    """A saved sample's values on the host, in one transfer: the tracks of
    SAMPLE_KEYS, SEM's lam and alpha (its indirect effects' samples), and
    what the sample files need (sol, alpha, BayesB's per-locus covariances,
    ebv, the random-effect covariances vc<g>)."""
    parts = {k: getattr(out, k) for k in SAMPLE_KEYS}
    if out.lam is not None:
        parts["lam"] = out.lam
        parts["alpha"] = state.alpha[:, :p]
    if stream is not None and stream.enabled:
        if stream.loc_slices:
            parts["sol"] = state.sol
        if stream.write_markers:
            parts["alpha"] = state.alpha[:, :p]
            if state.varg.dim() == 3:
                parts["varg_loci"] = state.varg[:p]
        if stream.ebv:
            parts["ebv"] = out.ebv
        parts.update((f"vc{g}", v) for g, v in enumerate(state.vc))
        if stream.latent:
            parts["liab"] = state.liab
            parts["thresholds"] = state.thresholds
    return to_host(parts, state.R.dtype)


def apply_update_priors_mt(cfg: MTEngineCfg, data: MTData, accum: MTAccum) -> MTData:
    """The empirical-Bayes refresh of the priors from the running means
    (_apply_update_priors_mt, mcmc_mt.py:1015-1034;
    MCMC_BayesianAlphabet.jl:381-395): the marker scale mean G (df - t - 1)
    (not BayesB's one a locus), each pedigree group's scale mean G0
    (df - k - 1), the residual scale mean R (df - 2) / df."""
    t = cfg.n_traits
    fields = dict(scale_R=accum.R_m * (cfg.df_residual - 2.0) / cfg.df_residual)
    if cfg.method not in ("BayesB", "none") and accum.varg_m.dim() == 2:
        fields["marker_scale"] = accum.varg_m * (cfg.df_marker - t - 1.0)
    if any(grp.random_type == "A" for grp in cfg.re_groups):
        fields["vc_scale"] = tuple(
            accum.vc_m[g] * (grp.df - len(grp.starts) - 1.0) if grp.random_type == "A"
            else scale for g, (grp, scale) in enumerate(zip(cfg.re_groups, data.vc_scale)))
    return data._replace(**fields)


def run_mt_chains(cfg: MTEngineCfg, data: MTData, states, plan, stream=None,
                  chain_streams=(), progress=None, update_priors_frequency: int = 0):
    """K multi-trait chains on one device (_run_mt_multichain, mcmc_mt.py:
    1037-1230), as engine/mcmc.py::run_chains runs single-trait ones: shared
    data, a state and generator a chain, a window each in turn, the priors
    refreshed from the chains' pooled means (apply_update_priors_mt), each
    chain's draws appended to samples one by one (posterior SDs over
    (sample, chain), mcmc_mt.py:1142-1147), SEM's lam and alpha from chain
    0, chain 0's sample written by stream and chain k's by
    chain_streams[k]. tracks holds each window's (K, t) h2 and (K, t, t)
    genvar, R and varg. Returns (states, accums, samples, tracks,
    burnin_seconds, window_seconds)."""
    K = len(states)
    states = list(states)
    run_window = make_mt_run_window(cfg)
    accums = [init_mt_accum(data, s) for s in states]
    samples = {k: [] for k in SAMPLE_KEYS + (("lam", "alpha") if cfg.sem_edges else ())}
    tracks = {k: [] for k in ("h2", "genvar", "R", "varg")}
    prior_epoch = 0
    window_seconds = []
    t0 = time.perf_counter()
    if plan.burnin_outer > 0:
        for k in range(K):
            states[k], accums[k], out = run_window(states[k], data, accums[k],
                                                   plan.burnin_outer, accumulate=False)
        out.R.cpu()                  # waits for the device
    t_burnin = time.perf_counter() - t0
    for w in range(plan.n_saved):
        t_w = time.perf_counter()
        hosts = []
        for k in range(K):
            states[k], accums[k], out = run_window(states[k], data, accums[k],
                                                   plan.thin_outer)
            hosts.append(_read_back(states[k], out, stream, cfg.n_markers))
        window_seconds.append(time.perf_counter() - t_w)
        iters = (plan.burnin_outer + (w + 1) * plan.thin_outer) * plan.nreps
        if update_priors_frequency > 0 and iters // update_priors_frequency > prior_epoch:
            prior_epoch = iters // update_priors_frequency
            data = apply_update_priors_mt(cfg, data, pool_accums(accums))
        for key in SAMPLE_KEYS:
            samples[key].extend(h[key] for h in hosts)
        if cfg.sem_edges:
            samples["lam"].append(hosts[0]["lam"])
            samples["alpha"].append(hosts[0]["alpha"])
        for key in tracks:
            tracks[key].append(np.stack([h[key] for h in hosts]))
        if stream is not None:
            stream.write_sample(hosts[0])
        for cs, h in zip(chain_streams, hosts):
            cs.write_sample(h)
        if progress is not None:
            progress.update(iters, vare=hosts[0]["R"], varg=hosts[0]["varg"],
                            pi=hosts[0]["pi"])
    return states, accums, samples, tracks, t_burnin, window_seconds


def mt_psrf(tracks, t: int) -> Table:
    """The multi-trait PSRF table (mcmc_mt.py:1194-1228): per trait h2[k],
    genvar[k], R[k] and varg[k] (the diagonals), then each pair's genetic
    correlation gencor[i,j] from the genvar draws; series constant in
    every chain are left out."""
    series = []
    for name, diag in (("h2", False), ("genvar", True), ("R", True), ("varg", True)):
        arr = np.stack(tracks[name])                       # (n_saved, K, ...)
        series += [(f"{name}[{k}]", arr[:, :, k, k] if diag else arr[:, :, k], True)
                   for k in range(t)]
    gv = np.stack(tracks["genvar"])
    for i in range(t):
        for j in range(i + 1, t):
            denom = np.sqrt(np.abs(gv[:, :, i, i] * gv[:, :, j, j]))
            series.append((f"gencor[{i},{j}]",
                           gv[:, :, i, j] / np.where(denom == 0, 1.0, denom), True))
    return psrf_table(series)


def pi_dict_to_vector(pi, t: int) -> np.ndarray:
    """A joint-pattern Pi dict -> the canonical (2^t,) vector (bit k =
    trait k); anything else: every marker in every trait."""
    vec = np.zeros(2 ** t)
    if isinstance(pi, dict):
        for pat, prob in pi.items():
            idx = sum(int(float(pat[k])) << k for k in range(t))
            vec[idx] = float(prob)
    else:
        vec[-1] = 1.0
    return vec


def latent_setup_mt(ws: Workspace, seed: Optional[int]) -> Dict:
    """The latent traits' data and starting values (mcmc_mt.py:758-823):
    a categorical trait's categories (t, n; 0 where missing) and
    thresholds [-BIG, 0, linspace(1, max(10 R_kk, 2), K - 1)[:-1].., BIG]
    ([-BIG, 0, BIG] binary), padded with BIG to (t, max(3, K + 1)); a
    censored trait's bounds from its <name>_l / _u columns; +-BIG
    elsewhere. The liabilities start from truncated normals of sd
    sqrt(R0_kk) within the bounds, scipy.stats.truncnorm on numpy's
    default_rng(seed + 7) (seed None: 7), the other rows from y (0 where
    missing). Returns a dict of numpy arrays: category_obs, lower, upper,
    thresholds, liab, and cat_counts (a trait's K, 0 for the others)."""
    from scipy.stats import truncnorm

    from jwas_tpu_torch.io.table import to_numeric

    model, t, n, BIG = ws.model, ws.n_traits, ws.n_obs, th.BIG
    y = ws.y.reshape(t, n)
    y_mask = ws.y_mask.reshape(t, n)
    R0 = np.atleast_2d(np.asarray(ws.vare0, dtype=np.float64))
    cats = np.zeros((t, n), np.int64)
    lower, upper = np.full((t, n), -BIG), np.full((t, n), BIG)
    counts, rows = [0] * t, {}
    latent = [k for k, tt in enumerate(model.traits_type) if tt in LATENT]
    for k in latent:
        tt = model.traits_type[k]
        if tt in ("categorical", "categorical(binary)"):
            cats[k] = np.where(y_mask[k], np.nan_to_num(y[k]), 0.0).astype(np.int64)
            counts[k] = int(cats[k].max())
            if tt == "categorical":
                inner = np.linspace(1.0, max(10.0 * float(R0[k, k]), 2.0),
                                    counts[k] - 1)[:-1]
                rows[k] = np.concatenate([[-BIG, 0.0], inner, [BIG]])
            else:
                rows[k] = np.array([-BIG, 0.0, BIG])
            thr = rows[k]
            lower[k] = np.where(cats[k] > 0, thr[np.maximum(cats[k] - 1, 0)], -BIG)
            upper[k] = np.where(cats[k] > 0, thr[np.minimum(cats[k], len(thr) - 1)], BIG)
        else:
            name = model.lhs_vec[k]
            lo = to_numeric(ws.df[f"{name}_l"], errors="coerce")
            hi = to_numeric(ws.df[f"{name}_u"], errors="coerce")
            lower[k] = np.clip(np.nan_to_num(lo, nan=-np.inf), -BIG, BIG)
            upper[k] = np.clip(np.nan_to_num(hi, nan=np.inf), -BIG, BIG)
    t_max = max(3, max((counts[k] + 1 for k in latent), default=3))
    thresholds = np.full((t, t_max), BIG)
    for k, thr in rows.items():
        thresholds[k, :len(thr)] = thr
    liab = np.where(y_mask, y, 0.0).astype(np.float64)
    rng = np.random.default_rng((seed if seed is not None else 0) + 7)
    for k in latent:
        s0 = np.sqrt(float(R0[k, k]))
        a, b = np.clip(lower[k] / s0, -30, 30), np.clip(upper[k] / s0, -30, 30)
        liab[k] = np.where(lower[k] < upper[k],
                           truncnorm.rvs(a, np.maximum(b, a + 1e-6), scale=s0,
                                         random_state=rng, size=n), lower[k])
    return dict(category_obs=cats, lower=lower, upper=upper, thresholds=thresholds,
                liab=liab, cat_counts=counts)


def annotation_start_mt(pi, t: int, k: int) -> np.ndarray:
    """The tree probit's starting coefficients (k, 3) (mcmc_mt.py:867-888):
    intercepts Phi^-1 of p1 = 1 - pi_00, p2 = pi_11 / p1, p3 = pi_10 /
    (p1 (1 - p2)) from the starting Pi dict (each clipped to [1e-6,
    1 - 1e-6]), slopes 0. Refuses a dict without mass in {10, 11}, {01, 11}
    and 11."""
    from scipy.stats import norm

    v = pi_dict_to_vector(pi, t)             # 00, 10, 01, 11
    if v[1] + v[3] <= 0 or v[2] + v[3] <= 0 or v[3] <= 0:
        raise ValueError("Annotated multi-trait BayesC requires positive startup "
                         "prior mass in states {10,11}, {01,11} and 11")
    eps = 1e-6
    p1 = float(np.clip(1.0 - v[0], eps, 1 - eps))
    p2 = float(np.clip(v[3] / p1, eps, 1 - eps))
    p3 = float(np.clip(v[1] / max(p1 * (1.0 - p2), eps), eps, 1 - eps))
    c0 = np.zeros((k, 3))
    c0[0, :] = norm.ppf([p1, p2, p3])
    return c0


def _sync_every(opts: MCMCOptions) -> Optional[int]:
    if opts.independent_blocks:
        return 0                        # one sync an outer iteration
    if opts.sync_every is not None:
        return max(1, int(opts.sync_every))
    return None


def trait_columns(model, t: int):
    """Each trait's (first, end) location column: its terms are contiguous,
    in equation order (models/design.py::build_design)."""
    cols = []
    for k in range(t):
        starts = [(trm.start_pos, trm.start_pos + trm.n_levels)
                  for trm in model.terms if trm.i_model == k]
        lo, hi = (min(a for a, _ in starts), max(b for _, b in starts)) if starts else (0, 0)
        if sum(b - a for a, b in starts) != hi - lo:
            raise ValueError(f"trait {k}'s location columns are not contiguous")
        cols.append((lo, hi))
    return cols


def build_mt_data_and_state(ws: Workspace, opts: MCMCOptions, device):
    """(cfg, data, state) of a single chain (build_mt_data_and_states)."""
    cfg, data, states = build_mt_data_and_states(ws, opts, device, 1)
    return cfg, data, states[0]


def build_mt_data_and_states(ws: Workspace, opts: MCMCOptions, device, n_chains: int):
    """The dense, GBLUP and no-marker parts of jwas_tpu's
    build_mt_data_and_state (mcmc_mt.py:645-991): the static missing
    patterns, the store's blocks (setup_dense_markers' choice; GBLUP: the
    workspace's eigenbasis, no blocks, nreps 1) and the chain's dtype, the
    t x t priors (R.constraint and G.constraint transform theirs,
    :730-749; BayesL divides the marker prior by 4 (t + 1), :934-945), the
    sampler ("auto" is sampler I), SEM's edges (:830-850), the
    random-effect groups, the output IDs' store columns and
    prediction-equation rows, the starting values and the state: every
    marker included, the pattern priors from the Pi dict, BayesB's
    covariances one a locus, BayesL's local shrinkage 8 Gamma((t + 1) / 2)
    a real marker. Returns (cfg, data, states): a state a chain, chain k's
    generator seeded seed + k (seed None counts as 0; mcmc_mt.py:1047-1048)
    and BayesL's shrinkage drawn from it, the other starting values the
    same in every chain."""
    model, g = ws.model, ws.geno
    t, n, K = ws.n_traits, ws.n_obs, ws.W.shape[1]
    dtype = torch.float64 if opts.double_precision else torch.float32
    method = "none" if g is None else g.method
    constraint = g is not None and bool(g.G.constraint)
    sampler = getattr(g, "multi_trait_sampler", "I") if g is not None else "I"
    if method not in ("none", "GBLUP") and not constraint:
        mt.check_traits(t)
        b, gb, _ = mk.dense_blocks(len(ws.obs_ids), opts.fast_blocks, g.n_markers)
        mt.check_block_size(b)
        chain = ("C0L" if method in ("RR-BLUP", "BayesL")
                 else "II" if sampler == "II" else "I")
        mt.check_scratch(chain, t, b, gb, torch.finfo(dtype).bits // 8,
                         hbm_budget(device))

    def dev(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(device)

    y_mask = ws.y_mask.reshape(t, n)
    uniq, pat_idx = np.unique(y_mask.T, axis=0, return_inverse=True)
    pat_idx = pat_idx.reshape(-1)
    pattern_masks = tuple(tuple(bool(v) for v in row) for row in uniq)
    rinv = None if ws.rinv is None else dev(ws.rinv)

    edges = sem_edges(opts, model, t, pattern_masks)
    if g is None:
        empty = torch.zeros(0, dtype=dtype, device=device)
        gm = NoMarkers(xpx=empty, valid=empty, rinv=rinv, n_obs=n)
        nreps = 1
    elif method == "GBLUP":
        gm = build_gblup_markers(ws.gblup_L, ws.gblup_D, ws.gblup_out, rinv=ws.rinv)
        rinv = gm.rinv
        nreps = 1
    else:
        gm = setup_dense_markers(g.dense, g.obs_ids, ws.obs_ids, device,
                                 fast_blocks=opts.fast_blocks, rinv=ws.rinv,
                                 dtype=dtype)
        rinv = gm.rinv
        nreps = 1 if gm.exact else max(1, min(
            opts.nreps if opts.nreps is not None else gm.grams.shape[1],
            opts.chain_length))
    p, p_pad = (0, 0) if g is None else (int(gm.valid.sum().item()) if method == "GBLUP"
                                         else g.n_markers, gm.valid.shape[0])

    re_cfgs = tuple(REGroupCfg(starts=grp.starts, n_levels=grp.n_levels, df=grp.df,
                               has_vinv=grp.Vinv is not None,
                               random_type=grp.random_type,
                               estimate_variance=grp.estimate_variance)
                    for grp in ws.re_groups)

    df_marker = float(ws.df_marker)
    marker_var0 = np.atleast_2d(np.asarray(ws.marker_var0, dtype=np.float64))
    marker_scale0 = np.atleast_2d(np.asarray(ws.marker_scale0, dtype=np.float64))
    if marker_var0.shape != (t, t):
        marker_var0 = np.eye(t) * float(marker_var0.reshape(-1)[0])
        marker_scale0 = np.eye(t) * float(marker_scale0.reshape(-1)[0])
    if constraint:
        # G_constraint!: df -= t, scale = Diag(scale / (df - 1)) (df - 2) / df
        df_marker -= t
        marker_scale0 = (np.diag(np.diag(marker_scale0 / (df_marker - 1.0)))
                         * (df_marker - 2.0) / df_marker)
    df_R = float(ws.df_R)
    scale_R0 = np.atleast_2d(np.asarray(ws.scale_R, dtype=np.float64))
    r_constraint = bool(model.R.constraint)
    if r_constraint:
        df_R -= t
        scale_R0 = np.diag(np.diag(scale_R0 / (df_R - 1.0))) * (df_R - 2.0) / df_R
    if method == "BayesL":
        # MTBayesL's prior on the scaled effects (mcmc_mt.py:943-945)
        marker_var0 = marker_var0 / (4.0 * (t + 1))
        marker_scale0 = marker_scale0 / (4.0 * (t + 1))
    trait_types = tuple(model.traits_type)
    lat = latent_setup_mt(ws, opts.seed)
    latent = tuple(k for k, tt in enumerate(trait_types) if tt in LATENT)
    binary = tuple(k for k, tt in enumerate(trait_types) if tt == "categorical(binary)")
    if len(binary) == t and bool(model.R.estimate_variance):
        raise ValueError("all traits binary: residual covariance cannot be estimated; "
                         "set R estimate_variance=false")
    anno = (g is not None and g.annotations is not None and method == "BayesC"
            and t == 2 and not constraint)
    if anno:
        mt.check_prior_traits(t)
        ann_c0 = annotation_start_mt(g.pi, t, 1 + g.annotations.shape[1])
    cfg = MTEngineCfg(
        method=method, n_obs=n, n_markers=p, n_traits=t,
        estimate_pi=g is not None and bool(g.estimate_pi),
        estimate_marker_variance=g is not None and bool(g.G.estimate_variance),
        estimate_scale=False,
        estimate_residual_variance=bool(model.R.estimate_variance),
        nreps=nreps, sync_every=mk.resolve_sync_every(nreps, _sync_every(opts)),
        df_residual=df_R, df_marker=df_marker, re_groups=re_cfgs,
        pattern_masks=pattern_masks,
        missing_phenotypes=bool(opts.missing_phenotypes) and len(pattern_masks) > 1,
        constraint=constraint, r_constraint=r_constraint,
        mt_sampler="II" if sampler == "II" else "I", sem_edges=edges,
        trait_types=trait_types, cat_counts=tuple(lat["cat_counts"]),
        anno_steps=3 if anno else 0, latent_traits=latent, binary_traits=binary)

    W = dev(ws.W)
    patterns = dev(uniq.astype(np.float64))
    pattern_idx = torch.as_tensor(pat_idx, dtype=torch.int64).to(device)
    pieces = MTLocationPieces(W, t, trait_columns(model, t), patterns, pattern_idx,
                              rinv, int(PIECES_SHARE * hbm_budget(device)))
    out_W = None
    if ws.prediction_terms or g is None:
        out_np = np.zeros((t, len(ws.output_ids), K))
        for name in ws.prediction_terms:
            term = model.term_dict[name]
            out_np[term.i_model, :, term.start_pos:term.start_pos + term.n_levels] += (
                ws.output_X[name])
        out_W = dev(out_np)
    data = MTData(
        W=W, lhs=pieces, y=dev(ws.y.reshape(t, n)), gm=gm, rinv=rinv,
        patterns=patterns, pattern_idx=pattern_idx,
        pattern_rows=tuple(torch.nonzero(pattern_idx == k).flatten()
                           for k in range(len(uniq))),
        scale_R=dev(scale_R0), marker_scale=dev(marker_scale0),
        ebv_rows=None if ws.output_store_rows is None else dev(ws.output_store_rows,
                                                               torch.int64),
        out_W=out_W,
        Vinv=tuple(None if grp.Vinv is None else symmetric_upper(dev(grp.Vinv))
                   for grp in ws.re_groups),
        vc_scale=tuple(dev(grp.scale) for grp in ws.re_groups),
        category_obs=dev(lat["category_obs"], torch.int64) if latent else None,
        cens_lower=dev(lat["lower"]) if latent else None,
        cens_upper=dev(lat["upper"]) if latent else None,
        anno_A=dev(annotation_design(g, p_pad)) if anno else None)

    def chain_state(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        sol = torch.zeros(K, dtype=dtype, device=device)
        if opts.starting_value is not None and opts.starting_value is not False:
            sv = np.asarray(opts.starting_value, dtype=np.float64).reshape(-1)
            if len(sv) != K:
                raise ValueError(
                    f"length of starting values for non-marker location parameters "
                    f"is wrong (expected {K}, got {len(sv)}); the order is "
                    f"model.term_names()")
            sol = dev(sv)
        alpha = torch.zeros((t, p_pad), dtype=dtype, device=device)
        delta = (gm.valid[None, :] > 0).expand(t, p_pad).to(dtype).clone()
        # the latent traits start from their liabilities, which every record
        # has (mcmc_mt.py:946-955); a missing residual starts at 0
        keep = y_mask.copy()
        keep[list(latent)] = True
        y_eff = data.y if not latent else torch.where(
            dev(np.isin(np.arange(t), latent)[:, None], torch.bool), dev(lat["liab"]), data.y)
        ycorr = torch.where(dev(keep, torch.bool), y_eff - (W @ sol).view(t, n), 0.0)
        if constraint:
            pi = torch.zeros(t, dtype=dtype, device=device)
        else:
            pi = dev(pi_dict_to_vector(None if g is None else g.pi, t))
        if anno:                            # one (4,) prior a marker, padding [1, 0, 0, 0]
            pad = torch.zeros(4, dtype=dtype, device=device)
            pad[0] = 1.0
            pi = torch.where(gm.valid[:, None] > 0, pi[None, :], pad)
        varg = dev(marker_var0)
        if method == "BayesB":
            varg = varg.expand(p_pad, t, t).clone()
        gamma_l = None
        if method == "BayesL":
            gamma_l = torch.where(gm.valid > 0,
                                  sample_gamma_like(gen, (t + 1) / 2.0, gm.valid) * 8.0, 1.0)
        state = MTChainState(gen=gen, sol=sol, alpha=alpha, beta=alpha.clone(),
                             delta=delta, ycorr=ycorr, R=dev(np.atleast_2d(ws.vare0)),
                             varg=varg, pi=pi,
                             vc=tuple(dev(np.atleast_2d(grp.G0)) for grp in ws.re_groups),
                             gamma_l=gamma_l,
                             Lambda=torch.zeros(len(edges), dtype=dtype, device=device)
                             if edges else None,
                             liab=dev(lat["liab"]) if latent else None,
                             thresholds=dev(lat["thresholds"]) if latent else None,
                             ann_coeffs=dev(ann_c0) if anno else None,
                             ann_var=dev(np.ones(3)) if anno else None)
        return state

    seed0 = 0 if opts.seed is None else int(opts.seed)
    return cfg, data, [chain_state(seed0 + k) for k in range(n_chains)]


def _host(x):
    return x.detach().cpu().numpy()


def run_mcmc_mt(model, df, opts: MCMCOptions, device) -> Dict:
    """runMCMC's multi-trait branch (jwas_tpu/engine/mcmc.py:1474-1476 ->
    mcmc_mt.py:1232), one chain or n_chains (run_mt_chains, with the
    "PSRF" table and, with output_chain_samples, "_chain_sample_folders"),
    on device (resolve_device's rule)."""
    ws = prepare_workspace(model, df, opts, device=device)
    device = resolve_device(device)
    model.mcmc_info = opts
    if opts.printout_model_info:
        describe(model)
    n_chains = int(opts.n_chains)
    cfg, data, states = build_mt_data_and_states(ws, opts, device, n_chains)
    plan = chain_plan(opts.chain_length, opts.burnin, opts.output_samples_frequency,
                      cfg.nreps)
    stream = MTSampleStream(ws, cfg, opts)
    chain_streams = multichain_streams(MTSampleStream, ws, cfg, opts, n_chains)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length)
    try:
        with maybe_profile(opts):
            _, accums, samples, tracks, _, _ = run_mt_chains(
                cfg, data, states, plan, stream, chain_streams, progress,
                int(opts.update_priors_frequency or 0))
    finally:
        stream.close()
        for cs in chain_streams:
            cs.close()
    accum = pool_accums(accums)
    accum = accum._replace(**{k: _host(v) if torch.is_tensor(v) else
                              tuple(_host(x) for x in v)
                              for k, v in accum._asdict().items()
                              if k != "n" and v is not None})
    results = build_mt_results(ws, cfg, accum, samples, opts)
    if stream.enabled and stream.write_markers and ws.geno is not None:
        results["_marker_sample_files"] = {
            trait: stream.writer.path(f"marker_effects_{ws.geno.name}_{trait}")
            for trait in model.lhs_vec}
    if chain_streams:
        results["_chain_sample_folders"] = [cs.writer.folder for cs in chain_streams]
    if n_chains > 1 and plan.n_saved > 1:
        results["PSRF"] = mt_psrf(tracks, cfg.n_traits)
    return results
