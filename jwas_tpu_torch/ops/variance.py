"""Variance-component and class-prior draws of the single-trait methods.

Counterpart of jwas_tpu/ops/variance.py: sample_residual_variance_st (:28),
sample_marker_variance_common (:41, with the invweights of BayesL and
GBLUP), sample_marker_variance_bayesb (:54),
bayesr_sigma_sufficient_statistics and sample_marker_variance_bayesr
(:60-80), sample_bayesl_gamma (:83), sample_pi_abc (:102),
sample_pi_bayesr (:111), sample_scale_st (:118) and
sample_random_effect_vc (:130, in the step's form of
jwas_tpu/engine/mcmc.py:486-507), with BayesB's scale
draw (jwas_tpu/engine/mcmc.py:478-482). The BayesB and BayesL draws also
come as functions of their chi-square, gamma and uniform draws
(bayesb_variance, bayesb_scale, bayesl_gamma), so tests can feed both
packages the same draws. The residual variance takes the residual weights
(invweights, R^-1) of a dense store.

The multi-trait draws of jwas_tpu/engine/mcmc_mt.py: the residual
covariance (:466-487, inverse-Wishart, or with R.constraint one
chi-square a trait on the diagonal), the marker-effect covariance of
BayesC, RR-BLUP, BayesL and GBLUP (:428-443, on mt_covariance_effects:
BayesC's beta, the others' alpha, BayesL's alpha / sqrt(gamma), GBLUP's
alpha / sqrt(D)) and BayesB's one a locus (:401-427, one batched
inverse-Wishart draw over the loci), multi-trait BayesL's local shrinkage
(:444-454, mt_bayesl_gamma) and the Dirichlet over the 2^t pattern counts
(:395-399).
"""

from __future__ import annotations

import torch

from jwas_tpu_torch.ops.dists import (
    sample_chi2,
    sample_dirichlet,
    sample_gamma,
    sample_gamma_like,
    sample_inv_wishart,
    sample_pi_beta,
    sample_scaled_inv_chi2,
)
from jwas_tpu_torch.ops.markers import BAYESR_GAMMA
from jwas_tpu_torch.ops.threshold import sample_conditional_inv_wishart_korsgaard


def sample_residual_variance_st(gen, ycorr, n_obs: int, df: float, scale,
                                invweights=None):
    """Residual variance (variance_components.jl:60-66): the SSE
    ycorr' R^-1 ycorr, with invweights R^-1 (None: unit weights)."""
    sq = ycorr * ycorr
    sse = torch.sum(sq if invweights is None else sq * invweights)
    return sample_scaled_inv_chi2(gen, sse, n_obs, df, scale)


def sample_marker_variance_common(gen, alpha, n_loci, df: float, scale,
                                  invweights=None, chi=None):
    """The common marker-effect variance (variance_components.jl:159-163):
    BayesC's with n_loci = sum(delta) (alpha holds zeros for excluded
    markers), RR-BLUP's with n_loci = p, BayesL's and GBLUP's with the
    SSE weighted by invweights (1 / gamma, 1 / D). chi: the chi-square
    (n_loci + df) draw (tests feed the JAX package's), else drawn from
    gen."""
    sq = alpha * alpha
    sse = torch.sum(sq if invweights is None else sq * invweights)
    if chi is None:
        return sample_scaled_inv_chi2(gen, sse, n_loci, df, scale)
    return (sse + df * scale) / chi


def bayesb_variance(beta, df: float, scale, chi):
    """BayesB's per-marker variances (beta^2 + df scale) / chi, chi (p_pad,)
    chi-square(1 + df) draws (variance_components.jl:169-172)."""
    return (beta * beta + df * scale) / chi


def sample_marker_variance_bayesb(gen, beta, df: float, scale):
    """BayesB's per-marker variances, one chi-square(1 + df) draw a marker,
    padding included, as jwas_tpu draws them."""
    return bayesb_variance(beta, df, scale,
                           sample_chi2(gen, torch.full_like(beta, 1.0 + df)))


def bayesb_scale(varg, valid, df: float, gamma):
    """BayesB's prior scale gamma / b with b = sum over the real markers of
    df / (2 var) + 1; gamma a Gamma(n_markers df / 2 + 1) draw
    (jwas_tpu/engine/mcmc.py:478-482)."""
    real = valid > 0
    v = torch.where(real, varg, torch.ones_like(varg))
    b = torch.sum(torch.where(real, df / (2.0 * v), torch.zeros_like(v))) + 1.0
    return gamma / b


def sample_scale_bayesb(gen, varg, valid, n_markers: int, df: float):
    a = torch.full((), n_markers * df / 2.0 + 1.0, dtype=varg.dtype,
                   device=varg.device)
    return bayesb_scale(varg, valid, df, sample_gamma(gen, a))


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


def bayesl_gamma(gamma, alpha, var_eff, valid, g_half, u):
    """BayesL's local shrinkage after one Metropolis-Hastings step
    (variance_components.jl:191-218): candidate 1 / (4 g_half), g_half
    Gamma(0.5) draws, accepted where u < exp(Q / 4 (2 / gamma -
    candidate)), Q = alpha^2 / var_eff, as 2 / candidate; padding kept
    at 1."""
    q = alpha * alpha / var_eff
    candidate = 1.0 / (g_half * 4.0)
    accept = torch.exp(q / 4.0 * (2.0 / gamma - candidate))
    new = torch.where(u < accept, 2.0 / candidate, gamma)
    return torch.where(valid > 0, new, torch.ones_like(new))


def sample_bayesl_gamma(gen, gamma, alpha, var_eff, valid):
    """bayesl_gamma with its Gamma(0.5) candidates, then its uniforms,
    drawn from gen, one of each a marker, padding included, as jwas_tpu
    draws them."""
    g_half = sample_gamma_like(gen, 0.5, gamma)
    u = torch.rand(gamma.shape, generator=gen, dtype=gamma.dtype,
                   device=gamma.device)
    return bayesl_gamma(gamma, alpha, var_eff, valid, g_half, u)


def sample_pi_abc(gen, delta, n_markers: int, valid):
    """pi for BayesC: Beta(p - k + 1, k + 1), k = included real markers
    (Pi.jl:7-9)."""
    k = torch.sum(torch.where(valid > 0, delta, torch.zeros_like(delta)))
    return sample_pi_beta(gen, k, n_markers, valid.dtype)


def sample_pi_bayesr(gen, delta, valid):
    """(4,) class priors for BayesR: Dirichlet(class counts over the real
    markers + 1) (Pi.jl:11-17)."""
    w = (valid > 0).to(valid.dtype)
    counts = torch.zeros(4, dtype=valid.dtype, device=delta.device)
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


def sample_random_effect_vc(gen, sols, Vinv, df: float, scale, bartlett=None):
    """The (k, k) covariance of a random-effect group (sampleVCs,
    variance_components.jl:115-147): sols (k, q) holds its k terms'
    effects, Vinv (q, q) its structure (None: the identity, an i.i.d.
    group; a CSR tensor on the sparse location path); S = sols Vinv sols',
    symmetrised, and the draw is
    InverseWishart(df + q, scale + S). bartlett: injected Bartlett factor
    (tests)."""
    q = sols.shape[1]
    if Vinv is None:
        S = sols @ sols.T
    elif Vinv.layout == torch.sparse_csr:       # the sparse location path
        from jwas_tpu_torch.ops.sparse_mme import spmv
        S = sols @ spmv(Vinv, sols.T)
    else:
        S = sols @ (Vinv @ sols.T)
    S = 0.5 * (S + S.T)
    return sample_inv_wishart(gen, df + q, scale + S, bartlett)


def _diag_chi2(gen, sse_diag, n, df: float, scale_diag):
    """(sse + df scale) / chi^2(n + df), one a trait (a constraint's
    diagonal covariance, mcmc_mt.py:407-418, :436-439, :470-473)."""
    chi = sample_chi2(gen, torch.full_like(sse_diag, float(n) + df))
    return (sse_diag + df * scale_diag) / chi


def sample_residual_covariance(gen, ycorr, rinv, n_obs: int, df: float, scale,
                               constraint: bool = False, bartlett=None, binary=()):
    """R | ycorr ~ InverseWishart(df + n, scale + Y' R^-1 Y) over the (t, n)
    residuals (the missing ones imputed); constraint: diagonal, one scaled
    inverse chi-square a trait; else with binary traits (their indices)
    Korsgaard's conditional draw with their variances pinned at 1, on the
    precision inv(scale + SSE) symmetrised (jwas_tpu/engine/mcmc_mt.py:
    474-483; bartlett: that of X1 over the other traits)."""
    yw = ycorr if rinv is None else ycorr * rinv
    SSE = yw @ ycorr.T
    if constraint:
        return torch.diag(_diag_chi2(gen, torch.diagonal(SSE), n_obs, df,
                                     torch.diagonal(scale)))
    if binary:
        prec = torch.linalg.inv_ex(scale + SSE)[0]
        return sample_conditional_inv_wishart_korsgaard(
            gen, df + n_obs, 0.5 * (prec + prec.T), tuple(binary), bartlett)
    return sample_inv_wishart(gen, df + n_obs, scale + SSE, bartlett)


def sample_marker_covariance(gen, beta, valid, n_markers: int, df: float, scale,
                             constraint: bool = False, bartlett=None):
    """The (t, t) marker-effect covariance from the real markers' effects
    (t, p_pad) (mt_covariance_effects: BayesC's beta, the others' weighted
    alpha): InverseWishart(df + p, scale + B B'); constraint: diagonal, one
    scaled inverse chi-square a trait. Padding markers are left out
    (jwas_tpu's blocked BayesC counts their beta, which the prior alone
    draws)."""
    b = beta * valid
    SSE = b @ b.T
    if constraint:
        return torch.diag(_diag_chi2(gen, torch.diagonal(SSE), n_markers, df,
                                     torch.diagonal(scale)))
    return sample_inv_wishart(gen, df + n_markers, scale + SSE, bartlett)


def mt_covariance_effects(method: str, alpha, beta, gamma_l=None, D=None):
    """The (t, p_pad) effects whose sum of squares enters the multi-trait
    marker covariance (mcmc_mt.py:428-435): BayesC's beta, RR-BLUP's
    alpha, BayesL's alpha / sqrt(gamma) and GBLUP's alpha / sqrt(D), each
    marker's effect weighted by its prior scale."""
    if method == "BayesC":
        return beta
    if method == "BayesL":
        return alpha / torch.sqrt(gamma_l)
    if method == "GBLUP":
        return alpha / torch.sqrt(D)
    return alpha


def mt_bayesl_gamma(gamma, alpha, Ginv, valid, g, u):
    """Multi-trait BayesL's local shrinkage after one Metropolis-Hastings
    step (mcmc_mt.py:444-454): Q = alpha_j' Ginv alpha_j a marker, the
    candidate 1 / (8 g), g Gamma((t + 1) / 2) draws, accepted where u <
    exp(Q / 4 (2 / gamma - candidate)) as 2 / candidate; padding kept at
    1. alpha (t, p_pad); gamma, valid, g, u (p_pad,)."""
    Q = torch.einsum("tp,sp,ts->p", alpha, alpha, Ginv)
    candidate = 1.0 / (g * 8.0)
    accept = torch.exp(Q / 4.0 * (2.0 / gamma - candidate))
    new = torch.where(u < accept, 2.0 / candidate, gamma)
    return torch.where(valid > 0, new, torch.ones_like(new))


def sample_mt_bayesl_gamma(gen, gamma, alpha, varg, valid):
    """mt_bayesl_gamma with Ginv = varg^-1, its Gamma((t + 1) / 2)
    candidates, then its uniforms, drawn from gen, one of each a marker,
    padding included, as jwas_tpu draws them."""
    t = alpha.shape[0]
    g = sample_gamma_like(gen, (t + 1) / 2.0, gamma)
    u = torch.rand(gamma.shape, generator=gen, dtype=gamma.dtype, device=gamma.device)
    return mt_bayesl_gamma(gamma, alpha, torch.linalg.inv(varg), valid, g, u)


def sample_marker_covariance_bayesb(gen, beta, df: float, scale,
                                    constraint: bool = False, bartlett=None):
    """Multi-trait BayesB's (p_pad, t, t) covariances, one a locus:
    InverseWishart(df + 1, scale + beta_j beta_j') as one batched draw;
    constraint: diagonal, (beta_kj^2 + df scale_kk) / chi^2(1 + df)."""
    t = beta.shape[0]
    if constraint:
        d = _diag_chi2(gen, beta ** 2, 1, df, torch.diagonal(scale)[:, None])
        return torch.diag_embed(d.T)
    SSE = beta.T[:, :, None] * beta.T[:, None, :]
    return sample_inv_wishart(gen, df + 1.0, scale.expand(beta.shape[1], t, t) + SSE,
                              bartlett)


def sample_pattern_pi(gen, delta, valid):
    """(2^t,) pattern priors: Dirichlet(counts of the real markers' patterns
    + 1), pattern s = sum_k delta_k 2^k."""
    t = delta.shape[0]
    w = 2 ** torch.arange(t, device=delta.device)
    idx = (w[:, None] * (delta > 0).to(torch.int64)).sum(0)
    counts = torch.zeros(1 << t, dtype=valid.dtype, device=valid.device)
    counts.index_add_(0, idx, (valid > 0).to(valid.dtype))
    return sample_dirichlet(gen, counts + 1.0)
