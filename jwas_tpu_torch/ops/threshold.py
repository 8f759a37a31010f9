"""Latent traits: the liability, threshold and Korsgaard residual draws of
binary, ordered categorical and censored traits.

Counterpart of jwas_tpu/ops/threshold.py: bounds_from_thresholds (:31),
sample_thresholds_t (:43), sample_liabilities (:71) and
sample_conditional_inv_wishart_korsgaard (:111) (reference:
categorical_and_censored_trait.jl:98-260). Each function takes its draws
as inputs (the uniforms of the thresholds, the truncated normals of the
liabilities, the Wishart draw and normal panel of Korsgaard's draw), so
that tests can feed the JAX package's; each has a sampling form that draws
them from a torch.Generator on the chain's device.

The liabilities' truncated normals are drawn tail-safe
(ops/dists.py::truncated_normal_from_uniform): jwas_tpu draws them with
jax.random.truncated_normal, which in float32 collapses to the bound past
about 5 standard deviations (fault R13, ROADMAP.md).

Parameterisation (reference table :16-26): a single-trait categorical trait
fixes vare = 1 and thresholds [-BIG, 0, t2.. < 1, BIG]; a multi-trait one
fixes t1 = 0, t2 = 1; a binary trait [-BIG, 0, BIG]. Category 0 is a
missing record.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Sequence, Tuple

import torch

from jwas_tpu_torch.ops.dists import (BIG, sample_wishart,
                                      truncated_normal_from_uniform)


@lru_cache(maxsize=None)
def _index(idx: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The int64 tensor of idx on device, made once: a host-to-device copy
    waits for the stream, so the step never makes one (nor a checked
    linalg call: the _ex forms, which do not wait)."""
    return torch.tensor(idx, dtype=torch.int64, device=device)


def bounds_from_thresholds(thresholds_t, category_obs_t):
    """Each record's liability bounds (lower, upper) from its category
    (update_lower_upper_bound_with_threshold, :98-124): thresholds[c - 1]
    and thresholds[c], unbounded where the category is 0 (missing)."""
    cat = category_obs_t.to(torch.int64)
    last = thresholds_t.shape[0] - 1
    lb = thresholds_t[(cat - 1).clamp(0, last)]
    ub = thresholds_t[cat.clamp(0, last)]
    missing = cat <= 0
    return (torch.where(missing, -BIG, lb), torch.where(missing, BIG, ub))


def sample_thresholds_t(thresholds_t, liab_t, category_obs_t, n_cat: int,
                        start_index: int, u):
    """The free thresholds of one categorical trait (:147-162): threshold i
    (start_index <= i < n_cat, between categories i and i + 1) ~
    Uniform(max liability of category i, min liability of category i + 1)
    as lo + u[i] (hi - lo). thresholds_t (Tmax,) [-BIG, 0, (1,) t.., BIG,
    pad..]; u (n_cat,) uniforms (u[i] for threshold i). Returns a new
    tensor."""
    th = thresholds_t.clone()
    for i in range(start_index, n_cat):
        lo = torch.where(category_obs_t == i, liab_t, -BIG).max()
        hi = torch.where(category_obs_t == i + 1, liab_t, BIG).min()
        th[i] = lo + u[i] * (hi - lo)
    return th


def draw_thresholds(gen: torch.Generator, thresholds_t, liab_t, category_obs_t,
                    n_cat: int, start_index: int):
    """sample_thresholds_t with its uniforms drawn from gen."""
    u = torch.rand(max(1, n_cat), generator=gen, dtype=liab_t.dtype,
                   device=liab_t.device)
    return sample_thresholds_t(thresholds_t, liab_t, category_obs_t, n_cat,
                               start_index, u)


def conditional_moments(R, ycorr, trait: int):
    """The conditional mean (n,) and variance (0-d) of trait's residual
    given the other traits' (:174-186): w = R_oo^-1 R_o,trait, mean = w'
    ycorr_o, variance R_tt - R_trait,o w; mean 0 and R_tt for one trait."""
    t = R.shape[0]
    others = [m for m in range(t) if m != trait]
    if not others:
        return torch.zeros_like(ycorr[trait]), R[trait, trait]
    o = _index(tuple(others), R.device)
    R22 = R[o][:, o]
    R12 = R[trait][o]
    w = torch.linalg.solve_ex(R22, R12)[0]
    return w @ ycorr[o], R[trait, trait] - R12 @ w


def sample_liabilities(liab, ycorr, R, lower, upper,
                       latent_traits: Sequence[int], n_gibbs: int,
                       z_of: Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor]):
    """The liabilities and residuals of the latent traits (:166-210), n_gibbs
    passes over latent_traits in order. liab, ycorr, lower, upper (t, n);
    R (t, t). Draw ki (pass-major) of trait k: eps ~ N(mu, s2) truncated to
    the bounds less the current mean (liab - ycorr), as mu + sqrt(s2) z
    with z = z_of(ki, a, b) the standard normal truncated to [a, b] =
    clip((bound - mu) / sqrt(s2), +-BIG); records whose lower bound is not
    below the upper one (a point observation) keep their residual. Returns
    new (liab, ycorr)."""
    liab, ycorr = liab.clone(), ycorr.clone()
    cmean = liab - ycorr
    ki = 0
    for _ in range(n_gibbs):
        for trait in latent_traits:
            mu, s2 = conditional_moments(R, ycorr, trait)
            lb = lower[trait] - cmean[trait]
            ub = upper[trait] - cmean[trait]
            fixed = lb >= ub
            std = torch.sqrt(s2)
            a = ((torch.where(fixed, mu - 1.0, lb) - mu) / std).clamp(-BIG, BIG)
            b = ((torch.where(fixed, mu + 1.0, ub) - mu) / std).clamp(-BIG, BIG)
            eps = mu + std * z_of(ki, a, b)
            ki += 1
            eps = torch.where(fixed, ycorr[trait], eps)
            liab[trait] = cmean[trait] + eps
            ycorr[trait] = eps
    return liab, ycorr


def truncated_normals(gen: torch.Generator):
    """A z_of for sample_liabilities that draws from gen: float64 uniforms
    through truncated_normal_from_uniform."""
    def z_of(ki, a, b):
        u = torch.rand(a.shape, generator=gen, dtype=torch.float64, device=a.device)
        return truncated_normal_from_uniform(u, a, b)
    return z_of


def conditional_inv_wishart_korsgaard(precision_scale, binary_idx: Tuple[int, ...],
                                      X1, Z):
    """Korsgaard's (1999) conditional inverse-Wishart draw of R with the
    binary traits' variances pinned at 1
    (sample_from_conditional_inverse_Wishart, :228-260), from its draws:
    X1 ~ Wishart(df, V11) (n1, n1) over the other traits and Z (n1, n2)
    standard normals. precision_scale V = inv(scale + SSE). X2 = V11^-1
    V12 + chol(X1^-1) Z chol(V22.1)'; R in [others; binary] order is
    [[X1^-1 + X2 X2', -X2], [-X2', I]], reordered to trait order."""
    t = precision_scale.shape[0]
    idx2 = list(binary_idx)
    idx1 = [i for i in range(t) if i not in idx2]
    dev = precision_scale.device
    i1 = _index(tuple(idx1), dev)
    i2 = _index(tuple(idx2), dev)
    V = precision_scale
    V11 = V[i1][:, i1]
    V12 = V[i1][:, i2]
    X1inv = torch.linalg.inv_ex(X1)[0]
    V11inv = torch.linalg.inv_ex(V11)[0]
    V22_1 = V[i2][:, i2] - V12.T @ V11inv @ V12
    mu = V11inv @ V12
    L_col = torch.linalg.cholesky_ex(0.5 * (V22_1 + V22_1.T))[0]
    L_row = torch.linalg.cholesky_ex(0.5 * (X1inv + X1inv.T))[0]
    X2 = mu + L_row @ Z @ L_col.T
    T11 = X1inv + X2 @ X2.T
    eye = torch.eye(len(idx2), dtype=V.dtype, device=dev)
    Rp = torch.cat([torch.cat([T11, -X2], 1), torch.cat([-X2.T, eye], 1)], 0)
    order = idx1 + idx2
    perm = _index(tuple(order.index(i) for i in range(t)), dev)
    return Rp[perm][:, perm]


def sample_conditional_inv_wishart_korsgaard(gen: torch.Generator, df,
                                             precision_scale,
                                             binary_idx: Tuple[int, ...],
                                             bartlett: Optional[torch.Tensor] = None,
                                             Z: Optional[torch.Tensor] = None):
    """conditional_inv_wishart_korsgaard with X1 ~ Wishart(df, V11) and Z
    drawn from gen (the Bartlett factor and Z injected when given)."""
    t = precision_scale.shape[0]
    idx1 = tuple(i for i in range(t) if i not in binary_idx)
    i1 = _index(idx1, precision_scale.device)
    V11 = precision_scale[i1][:, i1]
    X1 = sample_wishart(gen, df, V11, bartlett)
    if Z is None:
        Z = torch.randn((len(idx1), len(binary_idx)), generator=gen,
                        dtype=precision_scale.dtype, device=precision_scale.device)
    return conditional_inv_wishart_korsgaard(precision_scale, binary_idx, X1, Z)
