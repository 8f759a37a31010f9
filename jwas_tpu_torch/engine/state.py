"""Chain state and static configuration of the single-trait engine.

Counterpart of jwas_tpu/engine/state.py (ChainState :18, REGroupCfg :60,
EngineCfg :75), trimmed to the fields the single-trait methods read on the
packed or a dense store, GBLUP's eigenbasis or no markers (method "none"),
with random-effect groups. The
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
                              # BayesR (4,) class prior; RR-BLUP, BayesL,
                              # GBLUP (0,)
    scale_g: torch.Tensor     # 0-d prior scale of varg
    gamma_l: Optional[torch.Tensor] = None  # (p_pad,) BayesL's local
                              # shrinkage, 1 for padding (ones otherwise)
    vc: Tuple[torch.Tensor, ...] = ()  # a (k, k) covariance a random-effect
                              # group


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
