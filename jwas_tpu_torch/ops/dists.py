"""Conjugate draws used by the single-trait Gibbs sampler.

Counterpart of jwas_tpu/ops/dists.py:21-124 (sample_chi2,
sample_scaled_inv_chi2, _standard_wishart_chol, sample_wishart,
sample_inv_wishart, sample_beta, sample_pi_beta) and of
jax.random.dirichlet and jax.random.gamma over an array of shapes. Every
draw takes the chain's torch.Generator and returns a tensor on its device,
so a chain step never waits for the host. The reference's
parameterisations are those of variance_components.jl and markers/Pi.jl.
"""

from __future__ import annotations

import torch


def _param(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def sample_gamma(gen: torch.Generator, shape) -> torch.Tensor:
    """Gamma(shape, scale=1); shape is a tensor."""
    return torch._standard_gamma(shape, generator=gen)


def sample_gamma_like(gen: torch.Generator, shape: float, like: torch.Tensor):
    """Gamma(shape, scale=1) draws, one for each element of like, in its
    dtype on its device (BayesL's Gamma(0.5) candidates)."""
    return sample_gamma(gen, torch.full_like(like, shape))


def sample_chi2(gen: torch.Generator, df) -> torch.Tensor:
    """chi^2(df) == 2 * Gamma(df / 2)."""
    return 2.0 * sample_gamma(gen, df / 2.0)


def sample_scaled_inv_chi2(gen: torch.Generator, sse, n, df, scale):
    """(sse + df * scale) / chi^2(n + df): the conditional posterior of a
    scalar variance (variance_components.jl:60-66)."""
    return (sse + df * scale) / sample_chi2(gen, _param(n, sse) + df)


def standard_wishart_chol(gen: torch.Generator, df, dim: int, like: torch.Tensor,
                          batch=()):
    """Lower-triangular Bartlett factor A of a Wishart(df, I) draw: sqrt of
    chi^2(df - i) on the diagonal (i = 0..dim-1), N(0, 1) below it, so
    that A A' ~ Wishart(df, I); in like's dtype on its device. batch: the
    leading shape of a batch of independent factors (one call, no loop)."""
    batch = tuple(batch)
    dfs = df - torch.arange(dim, dtype=like.dtype, device=like.device)
    diag = torch.sqrt(sample_chi2(gen, dfs.expand(batch + (dim,)).contiguous()))
    normals = torch.randn(batch + (dim, dim), generator=gen, dtype=like.dtype,
                          device=like.device)
    return torch.tril(normals, diagonal=-1) + torch.diag_embed(diag)


def sample_wishart(gen: torch.Generator, df, scale, bartlett=None):
    """W ~ Wishart(df, scale) as (L A)(L A)' with L the Cholesky factor of
    scale and A the Bartlett factor (bartlett: injected, e.g. the JAX
    package's; else drawn from gen); scale (dim, dim) or a batch (..., dim,
    dim) of independent draws. No host sync."""
    L = torch.linalg.cholesky_ex(scale)[0]
    A = (standard_wishart_chol(gen, df, scale.shape[-1], scale, scale.shape[:-2])
         if bartlett is None else bartlett)
    LA = L @ A
    return LA @ LA.mT


def sample_inv_wishart(gen: torch.Generator, df, scale, bartlett=None):
    """X ~ InverseWishart(df, scale) as inv(W), W ~ Wishart(df, inv(scale))
    (Distributions.jl's parameterisation, variance_components.jl:101);
    both inverses by a solve, symmetrised. scale (dim, dim), or (..., dim,
    dim) for a batch of independent draws (multi-trait BayesB's one a
    locus, jwas_tpu/engine/mcmc_mt.py:420-426, as one draw of a
    (..., dim, dim) Bartlett factor)."""
    eye = torch.eye(scale.shape[-1], dtype=scale.dtype, device=scale.device)
    scale_inv = torch.linalg.solve_ex(scale, eye.expand(scale.shape))[0]
    W = sample_wishart(gen, df, 0.5 * (scale_inv + scale_inv.mT), bartlett)
    X = torch.linalg.solve_ex(W, eye.expand(W.shape))[0]
    return 0.5 * (X + X.mT)


def sample_beta(gen: torch.Generator, a, b):
    """Beta(a, b) as Ga / (Ga + Gb)."""
    ga = sample_gamma(gen, a)
    gb = sample_gamma(gen, b)
    return ga / (ga + gb)


def sample_dirichlet(gen: torch.Generator, conc):
    """Dirichlet(conc) as normalised Gamma(conc_k) draws on the chain's
    generator (torch.distributions.Dirichlet takes none)."""
    g = sample_gamma(gen, conc)
    return g / g.sum()


def sample_pi_beta(gen: torch.Generator, n_included, n_total,
                   dtype=torch.float32):
    """pi | delta ~ Beta(nTotal - nIncluded + 1, nIncluded + 1) in dtype;
    pi is the prior probability of EXCLUSION (markers/Pi.jl:7-9)."""
    n_included = n_included.to(dtype)
    return sample_beta(gen, _param(n_total, n_included) - n_included + 1.0,
                       n_included + 1.0)


BIG = 1e30      # stands in for +/- infinity in liability bounds, as in jwas_tpu


def _ndtr(x):
    """Phi(x) as erfc(-x / sqrt 2) / 2: accurate on the lower tail, where
    torch.special.ndtr's 1 + erf loses the digits (Phi(-8) 2% low)."""
    return 0.5 * torch.special.erfc(-x * 0.7071067811865476)


def truncated_normal_from_uniform(u, a, b):
    """The standard normal truncated to [a, b] at the uniform u, by the
    inverse CDF in float64, cast back to a's dtype: for a >= 0 on the
    upper tail's side, -ndtri(Phi(-a) - u (Phi(-a) - Phi(-b))), for b <= 0
    on the lower tail's, ndtri(Phi(a) + u (Phi(b) - Phi(a))), and that
    form too for an interval around 0. Each side takes Phi where it is far
    from 1, so the tails hold in float64 to |a| ~ 37 (where float32's erf
    collapses the draw to the bound past |a| ~ 5, fault R13). Past that,
    where both Phi underflow to the same value, the draw is the bound
    nearer the mass. The result lies in [a, b]; |bounds| >= BIG are
    infinite. u, a, b broadcast."""
    dtype = a.dtype
    a64 = a.to(torch.float64).clamp(-BIG, BIG)
    b64 = torch.as_tensor(b, device=a.device).to(torch.float64).clamp(-BIG, BIG)
    u64 = torch.as_tensor(u, device=a.device).to(torch.float64)
    upper = a64 >= 0
    pa = _ndtr(torch.where(upper, -a64, a64))
    pb = _ndtr(torch.where(upper, -b64, b64))
    x = torch.special.ndtri(pa + u64 * (pb - pa))
    x = torch.where(upper, -x, x)
    x = torch.where(pa == pb, torch.where(upper, a64, b64), x)
    x = torch.minimum(torch.maximum(x, a64), b64)
    return x.to(dtype)


def sample_truncated_normal(gen: torch.Generator, mean, std, lower, upper):
    """mean + std z, z the standard normal truncated to [(lower - mean) /
    std, (upper - mean) / std] (truncated_normal_from_uniform on float64
    uniforms from gen), in mean's dtype on its device. An entry whose
    bounds are equal is the caller's to handle."""
    a = ((lower - mean) / std).clamp(-BIG, BIG)
    b = ((upper - mean) / std).clamp(-BIG, BIG)
    u = torch.rand(a.shape, generator=gen, dtype=torch.float64, device=a.device)
    return mean + std * truncated_normal_from_uniform(u, a, b)
