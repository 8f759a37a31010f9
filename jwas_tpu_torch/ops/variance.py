"""Variance-component and class-prior draws of single-trait BayesC and BayesR.

Counterpart of jwas_tpu/ops/variance.py: sample_residual_variance_st (:28),
sample_marker_variance_common (:41), bayesr_sigma_sufficient_statistics and
sample_marker_variance_bayesr (:60-80), sample_pi_abc (:102),
sample_pi_bayesr (:111) and sample_scale_st (:118). Unweighted only:
residual weights (rinv) are not part of this port yet.
"""

from __future__ import annotations

import torch

from jwas_tpu_torch.ops.dists import (
    sample_dirichlet,
    sample_gamma,
    sample_pi_beta,
    sample_scaled_inv_chi2,
)
from jwas_tpu_torch.ops.markers import BAYESR_GAMMA


def sample_residual_variance_st(gen, ycorr, n_obs: int, df: float, scale):
    """Residual variance (variance_components.jl:60-66)."""
    return sample_scaled_inv_chi2(gen, torch.sum(ycorr * ycorr), n_obs, df,
                                  scale)


def sample_marker_variance_common(gen, alpha, n_loci, df: float, scale):
    """BayesC common marker-effect variance with n_loci = sum(delta)
    (variance_components.jl:159-163); alpha holds zeros for excluded
    markers."""
    return sample_scaled_inv_chi2(gen, torch.sum(alpha * alpha),
                                  n_loci.to(alpha.dtype), df, scale)


def bayesr_sigma_sufficient_statistics(alpha, delta):
    """(ssq, nnz) of the BayesR sigma^2 draw (variance_components.jl:68-79):
    ssq = sum over delta > 0 of alpha^2 / gamma_delta, nnz = the number of
    markers in the slab classes. Padded markers stay in class 0."""
    nz = delta > 0
    _, g1, g2, g3 = BAYESR_GAMMA
    gamma = torch.where(delta == 1, g1, torch.where(delta == 2, g2, g3))
    ssq = torch.sum(torch.where(nz, alpha * alpha / gamma, 0.0))
    return ssq, torch.sum(nz)


def sample_marker_variance_bayesr(gen, alpha, delta, df: float, scale):
    """BayesR shared sigma^2 (variance_components.jl:68-79, :166-168)."""
    ssq, nnz = bayesr_sigma_sufficient_statistics(alpha, delta)
    return sample_scaled_inv_chi2(gen, ssq, nnz.to(alpha.dtype), df, scale)


def sample_pi_abc(gen, delta, n_markers: int, valid):
    """pi for BayesC: Beta(p - k + 1, k + 1), k = included real markers
    (Pi.jl:7-9)."""
    k = torch.sum(torch.where(valid > 0, delta, torch.zeros_like(delta)))
    return sample_pi_beta(gen, k, n_markers)


def sample_pi_bayesr(gen, delta, valid):
    """(4,) class priors for BayesR: Dirichlet(class counts over the real
    markers + 1) (Pi.jl:11-17)."""
    w = (valid > 0).to(torch.float32)
    counts = torch.zeros(4, dtype=torch.float32, device=delta.device)
    counts.index_add_(0, delta.clamp(0, 3).long(), w)
    return sample_dirichlet(gen, counts + 1.0)


def sample_scale_st(gen, var_eff, df: float):
    """Prior scale of the marker-effect variance: Gamma(a, 1/b) with
    a = m df / 2 + 1, b = sum(df / (2 var)) + 1 (MCMC_BayesianAlphabet.jl:
    330-336)."""
    v = torch.atleast_1d(var_eff)
    a = torch.full((), v.shape[0] * df / 2.0 + 1.0, dtype=v.dtype,
                   device=v.device)
    b = torch.sum(df / (2.0 * v)) + 1.0
    return sample_gamma(gen, a) / b
