"""Chain state and static configuration of the single-trait engine.

Counterpart of jwas_tpu/engine/state.py (ChainState :18, EngineCfg :75),
trimmed to the fields single-trait BayesC, BayesB and BayesR on the packed
store read. The
JAX package's threefry key becomes one torch.Generator per chain, on the
chain's device. Marker state tensors are updated in place by the sweep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


class ChainState(NamedTuple):
    gen: torch.Generator      # the chain's only source of randomness
    sol: torch.Tensor         # (K,) location parameters
    alpha: torch.Tensor       # (p_pad,) marker effects
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
                              # BayesR (4,) class prior
    scale_g: torch.Tensor     # 0-d prior scale of varg


@dataclass(frozen=True)
class EngineCfg:
    method: str               # "BayesC", "BayesB" or "BayesR"
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
