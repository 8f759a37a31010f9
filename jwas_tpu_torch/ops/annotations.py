"""Annotation-driven marker priors: annotated BayesC, BayesR and 2-trait
BayesC.

Counterpart of jwas_tpu/ops/annotations.py: _sample_liabilities (:33),
_coordinate_gibbs (:44), _slope_variance (:67), _probit_step (:76),
anno_bayesc_update (:89), anno_bayesc_mt_update (:105) and
anno_bayesr_update (:155) (reference: annotation_updates.jl). A binary
probit on the annotation design A = [1, annotations] (p_pad, k) drives each
marker's prior: its liabilities are truncated normals around A c, its
coefficients are drawn one at a time (a flat prior on the intercept,
N(0, sigma2) on the slopes), sigma2 from a scaled inverse chi-square.
Rows outside a probit's active set are weighted 0, not gathered, as in the
reference. The coordinate loop runs over the k columns, each step a
length-p dot product: PyTorch operations, no kernel (the reference runs no
Pallas kernel and no scan here).

Each function takes its draws from a `draws` object with three methods,
for probit step s: liability(s, a, b) -> the standard normals truncated to
[a, b] (p_pad,), normals(s, k, like) -> (k,) and gamma(s, shape, like) -> a
0-d Gamma(shape) draw, in like's dtype on its device. ProbitDraws draws
them from a torch.Generator; tests give the JAX package's, from its keys.
"""

from __future__ import annotations

import torch

from jwas_tpu_torch.ops.dists import (BIG, sample_gamma,
                                      truncated_normal_from_uniform)

EPS = 1e-7      # the per-marker priors are clipped to [EPS, 1 - EPS]


class ProbitDraws:
    """The probit updates' draws from a generator, in the order they are
    asked for."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def liability(self, s, a, b):
        u = torch.rand(a.shape, generator=self.gen, dtype=torch.float64,
                       device=a.device)
        return truncated_normal_from_uniform(u, a, b)

    def normals(self, s, k, like):
        return torch.randn(k, generator=self.gen, dtype=like.dtype, device=like.device)

    def gamma(self, s, shape, like):
        return sample_gamma(self.gen, torch.full((), shape, dtype=like.dtype,
                                                 device=like.device))


def norm_cdf(x):
    """Phi(x) = (1 + erf(x / sqrt 2)) / 2, the reference's form."""
    return 0.5 * (1.0 + torch.erf(x / 2.0 ** 0.5))


def coordinate_gibbs(A, resid, coeffs, slope_var, weights, zs):
    """One pass over the k coefficients (:98-123): for column c, with
    x = A[:, c] weights, diag = x' A[:, c] and the prior precision 0
    (intercept) or 1 / slope_var, c ~ N(ahat, 1 / (diag + prec)) with
    ahat = (x' resid + diag c_old) / (diag + prec), as ahat + zs[c]
    sqrt(inverse); resid += A[:, c] (old - new). Returns new (coeffs,
    resid)."""
    coeffs = coeffs.clone()
    for c in range(A.shape[1]):
        xk = A[:, c] * weights
        diag = torch.dot(xk, A[:, c])
        prec = 0.0 if c == 0 else 1.0 / slope_var
        inv_lhs = 1.0 / (diag + prec)
        old = coeffs[c]
        ahat = inv_lhs * (torch.dot(xk, resid) + diag * old)
        new = ahat + zs[c] * torch.sqrt(inv_lhs)
        resid = resid + A[:, c] * (old - new)
        coeffs[c] = new
    return coeffs, resid


def slope_variance(coeffs, gamma):
    """sigma2 = (sum slopes^2 + 2) / chi^2(k + 1), chi^2 = 2 gamma with
    gamma ~ Gamma((k + 1) / 2) given (:135-137)."""
    return (torch.sum(coeffs[1:] ** 2) + 2.0) / (2.0 * gamma)


def probit_step(A, response, coeffs, slope_var, active, draws, s: int):
    """One binary probit submodel update (step s of its tree): the
    liabilities l = mu + z, z the standard normal truncated to (-inf, -mu]
    where response is 0 and [-mu, inf) where it is 1, mu where the row is
    not active (:43-58); the coefficients, the slope variance (with
    slopes), then mu = A c. Returns (coeffs, slope_var, mu)."""
    mu = A @ coeffs
    a = (torch.where(response > 0, 0.0, -BIG) - mu).clamp(-BIG, BIG)
    b = (torch.where(response > 0, BIG, 0.0) - mu).clamp(-BIG, BIG)
    liab = torch.where(active > 0, mu + draws.liability(s, a, b), mu)
    resid = (liab - mu) * active
    coeffs, _ = coordinate_gibbs(A, resid, coeffs, slope_var, active,
                                 draws.normals(s, A.shape[1], A))
    if A.shape[1] > 1:
        slope_var = slope_variance(coeffs, draws.gamma(s, (A.shape[1] + 1.0) / 2.0, A))
    return coeffs, slope_var, A @ coeffs


def _clip(p):
    return p.clamp(EPS, 1.0 - EPS)


def anno_bayesc_update(A, delta, coeffs, slope_var, valid, draws):
    """Annotated single-trait BayesC (update_bayesc_binary_priors!,
    :179-192): the probit of the inclusion indicators delta (p_pad,) over
    the valid markers. coeffs (k,), slope_var 0-d. Returns (coeffs,
    slope_var, pi) with pi_j = 1 - Phi(mu_j), P(excluded), padding 1."""
    response = (delta > 0).to(A.dtype)
    coeffs, slope_var, mu = probit_step(A, response, coeffs, slope_var, valid, draws, 0)
    pi = _clip(1.0 - norm_cdf(mu))
    return coeffs, slope_var, torch.where(valid > 0, pi, 1.0)


def _rows(valid, probs):
    """(p_pad, 4) priors with padding pinned at [1, 0, 0, 0]."""
    pi = torch.stack(probs, dim=1)
    base = torch.zeros(4, dtype=pi.dtype, device=pi.device)
    base[0] = 1.0
    return torch.where((valid > 0)[:, None], pi, base)


def anno_bayesr_update(A, delta, coeffs, slope_var, valid, draws):
    """Annotated single-trait BayesR (:205-273): three nested step-up
    probits z_s = 1(class > s) over the markers of class >= s. delta
    (p_pad,) classes 0..3; coeffs (k, 3); slope_var (3,). Returns (coeffs,
    slope_var, pi (p_pad, 4)) with pi = [1 - p1, p1 (1 - p2), p1 p2
    (1 - p3), p1 p2 p3], padding [1, 0, 0, 0]."""
    coeffs, slope_var = coeffs.clone(), slope_var.clone()
    ps = []
    for s in range(3):
        response = (delta > s).to(A.dtype)
        active = valid if s == 0 else valid * (delta > s - 1).to(A.dtype)
        cs, vs, mu = probit_step(A, response, coeffs[:, s], slope_var[s], active, draws, s)
        coeffs[:, s], slope_var[s] = cs, vs
        ps.append(_clip(norm_cdf(mu)))
    p1, p2, p3 = ps
    return coeffs, slope_var, _rows(
        valid, [1.0 - p1, p1 * (1.0 - p2), p1 * p2 * (1.0 - p3), p1 * p2 * p3])


def anno_bayesc_mt_update(A, delta_t, coeffs, slope_var, valid, draws):
    """Annotated 2-trait BayesC (bayesc_mt_tree_step_indicators and
    rebuild_bayesc_mt_tree_priors!, :275-326): the joint state
    s = delta_1 + 2 delta_2 through a three-step tree probit, z1 = 1(s != 0)
    over every marker, z2 = 1(s == 3) over s != 0, z3 = 1(s == 1) over
    s in {1, 2}. delta_t (2, p_pad); coeffs (k, 3); slope_var (3,).
    Returns (coeffs, slope_var, pi (p_pad, 4)) in pattern order (bit k =
    trait k): [1 - p1, p1 (1 - p2) p3, p1 (1 - p2) (1 - p3), p1 p2],
    padding [1, 0, 0, 0]."""
    dt = A.dtype
    state = (delta_t[0] > 0).to(torch.int64) + 2 * (delta_t[1] > 0).to(torch.int64)
    responses = [(state != 0).to(dt), (state == 3).to(dt), (state == 1).to(dt)]
    actives = [valid, valid * (state != 0).to(dt),
               valid * ((state == 1) | (state == 2)).to(dt)]
    coeffs, slope_var = coeffs.clone(), slope_var.clone()
    ps = []
    for s in range(3):
        cs, vs, mu = probit_step(A, responses[s], coeffs[:, s], slope_var[s],
                                 actives[s], draws, s)
        coeffs[:, s], slope_var[s] = cs, vs
        ps.append(_clip(norm_cdf(mu)))
    p1, p2, p3 = ps
    return coeffs, slope_var, _rows(
        valid, [1.0 - p1, p1 * (1.0 - p2) * p3, p1 * (1.0 - p2) * (1.0 - p3), p1 * p2])
