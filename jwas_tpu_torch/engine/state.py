"""Chain state and static configuration of the single-trait engine.

Counterpart of jwas_tpu/engine/state.py (ChainState :18, REGroupCfg :60,
EngineCfg :75), trimmed to the fields the single-trait methods read on the
packed or a dense store, GBLUP's eigenbasis or no markers (method "none"),
with random-effect groups, latent traits' liabilities and thresholds,
annotations' probit coefficients and the sparse location path's CG. The
JAX package's threefry key becomes one torch.Generator per chain, on the
chain's device. Marker state tensors are updated in place by the sweep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch


class ChainState(NamedTuple):
    gen: torch.Generator      # the chain's only source of randomness
    sol: torch.Tensor         # (K,) location parameters
    alpha: torch.Tensor       # (p_pad,) marker effects (GBLUP: (n,)
                              # pseudo-effects on the eigenbasis)
    beta: torch.Tensor        # (p_pad,) underlying effects (BayesC/B's
                              # spike-slab; unused by BayesR)
    delta: torch.Tensor       # (p_pad,) int32: BayesC/B inclusion indicators,
                              # BayesR class labels 0..3 (0 = null class)
    ycorr: torch.Tensor       # (n,) phenotypes corrected for all effects
    vare: torch.Tensor        # 0-d residual variance
    varg: torch.Tensor        # 0-d common marker-effect variance (BayesR:
                              # sigma^2, class k has variance gamma_k sigma^2;
                              # BayesB: (p_pad,), one a marker)
    pi: torch.Tensor          # BayesC/B (p_pad,) P(excluded), 1 for padding;
                              # BayesR (4,) class prior, annotated (p_pad, 4)
                              # with padding [1, 0, 0, 0]; RR-BLUP, BayesL,
                              # GBLUP (0,)
    scale_g: torch.Tensor     # 0-d prior scale of varg
    gamma_l: Optional[torch.Tensor] = None  # (p_pad,) BayesL's local
                              # shrinkage, 1 for padding (ones otherwise)
    vc: Tuple[torch.Tensor, ...] = ()  # a (k, k) covariance a random-effect
                              # group
    liab: Optional[torch.Tensor] = None        # (n,) a latent trait's
                              # liabilities (None for a continuous trait)
    thresholds: Optional[torch.Tensor] = None  # (n_cat + 1,) a categorical
                              # trait's [-BIG, 0, t2.., BIG]
    ann_coeffs: Optional[torch.Tensor] = None  # annotated BayesC (k,),
                              # BayesR (k, 3): the probits' coefficients
    ann_var: Optional[torch.Tensor] = None     # their slope variance: 0-d,
                              # (3,)


@dataclass(frozen=True)
class REGroupCfg:
    """One random-effect group: its k terms' first columns in the location
    parameters, each over the same q levels."""

    starts: Tuple[int, ...]
    n_levels: int             # q
    df: float                 # prior df (set_random's df + k)
    has_vinv: bool            # False: the identity ("I")
    random_type: str          # "A" | "V" | "I"
    estimate_variance: bool   # False: G stays at its starting value
    factor_rows: int = 0      # the sparse location path: rows m of the
                              # factor F (Vinv = F'F), the length of its
                              # normals z_g (the pedigree's size for
                              # single-step's epsilon); 0 otherwise


@dataclass(frozen=True)
class EngineCfg:
    method: str               # "BayesC", "BayesB" (BayesA), "BayesR",
                              # "RR-BLUP", "BayesL", "GBLUP" or "none" (no
                              # genotypes)
    n_obs: int                # observations (residual-variance df)
    n_markers: int            # real markers, before padding
    estimate_pi: bool
    estimate_marker_variance: bool
    estimate_scale: bool
    estimate_residual_variance: bool
    nreps: int                # effective sweeps per outer iteration
    sync_every: int           # inner reps between exact residual syncs
    df_residual: float
    df_marker: float
    re_groups: Tuple[REGroupCfg, ...] = ()
    trait_types: Tuple[str, ...] = ("continuous",)   # a trait's "continuous",
                              # "categorical", "categorical(binary)" or
                              # "censored"
    cat_counts: Tuple[int, ...] = ()   # a categorical trait's categories
    anno_steps: int = 0       # the annotation probit's steps: 0 (none), 1
                              # (BayesC), 3 (BayesR, 2-trait BayesC)
    sparse_loc: bool = False  # the sparse location path (ops/sparse_mme.py:
                              # CSR design, the PO-CG joint draw)
    cg_tol: float = 1e-6      # its CG's relative tolerance: 1e-6 in float32,
                              # 1e-8 in float64 (jwas_tpu/engine/mcmc.py:
                              # 1102-1105)
    cg_maxiter: int = 200     # its CG's iteration cap


class MTChainState(NamedTuple):
    """State of a multi-trait chain (jwas_tpu/engine/state.py
    MTChainState)."""

    gen: torch.Generator      # the chain's only source of randomness
    sol: torch.Tensor         # (K,) location parameters
    alpha: torch.Tensor       # (t, p_pad) marker effects
    beta: torch.Tensor        # (t, p_pad) underlying effects
    delta: torch.Tensor       # (t, p_pad) inclusion indicators, 0/1 in the
                              # chain's dtype
    ycorr: torch.Tensor       # (t, n) residuals, the missing ones imputed
    R: torch.Tensor           # (t, t) residual covariance
    varg: torch.Tensor        # (t, t) marker-effect covariance; BayesB
                              # (p_pad, t, t), one a locus
    pi: torch.Tensor          # (2^t,) pattern priors (bit k = trait k),
                              # annotated (p_pad, 2^t) one row a marker;
                              # mega-trait (t,) P(excluded) a trait;
                              # RR-BLUP, BayesL, GBLUP: every marker in
                              # every trait
    vc: Tuple[torch.Tensor, ...] = ()  # a (k, k) covariance a random-effect
                              # group
    gamma_l: Optional[torch.Tensor] = None  # (p_pad,) BayesL's local
                              # shrinkage, 1 for padding (None otherwise)
    Lambda: Optional[torch.Tensor] = None   # (n_edges,) SEM's structural
                              # coefficients (None without SEM)
    liab: Optional[torch.Tensor] = None     # (t, n) the traits' liabilities
                              # (a continuous trait's row unused); None
                              # without latent traits
    thresholds: Optional[torch.Tensor] = None  # (t, Tmax) thresholds a trait
    ann_coeffs: Optional[torch.Tensor] = None  # 2-trait annotated BayesC:
                              # (k, 3) the tree probit's coefficients
    ann_var: Optional[torch.Tensor] = None     # (3,) its slope variances


@dataclass(frozen=True)
class MTEngineCfg(EngineCfg):
    """A multi-trait chain's static configuration (jwas_tpu's MTEngineCfg).
    The rows of each missing pattern are tensors of the chain's data
    (engine/mcmc_mt.py::MTData.pattern_rows)."""

    n_traits: int = 2
    pattern_masks: Tuple[Tuple[bool, ...], ...] = ()   # observed traits a
                                                       # pattern
    missing_phenotypes: bool = False   # impute the missing residuals
    constraint: bool = False           # mega-trait (G.constraint): one
                                       # single-trait sweep a trait
    r_constraint: bool = False         # diagonal residual covariance
    mt_sampler: str = "I"              # "I" | "II"
    sem_edges: Tuple[Tuple[int, int], ...] = ()   # causal edges (i <- j):
                                       # trait j's phenotype in trait i's
                                       # equation, row-major
    latent_traits: Tuple[int, ...] = ()   # traits with liabilities
    binary_traits: Tuple[int, ...] = ()   # residual variance pinned at 1
