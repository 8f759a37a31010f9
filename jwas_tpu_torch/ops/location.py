"""Single-site Gibbs pass over the location-parameter MME.

Counterpart of jwas_tpu/ops/location.py:19-38 (gibbs_pass_lambda). K is the
number of location parameters (intercept and fixed effects: 1 to ~100 on
the ported paths), so a Python loop over K costs a few small launches per
parameter.
"""

from __future__ import annotations

import torch


def gibbs_pass_lambda(A, x, b, vare, gen: torch.Generator, zs=None):
    """One pass of x_i ~ N((b_i - A[:, i]'x) / A_ii + x_i, vare / A_ii),
    skipping zero diagonals (solver.jl:143-151). With residual weights A is
    W'R^-1W and b W'R^-1 ycorr. zs: the pass's K standard normal draws
    (tests inject the JAX package's), else drawn from gen. Returns a new
    x."""
    K = x.shape[0]
    if zs is None:
        zs = torch.randn(K, generator=gen, dtype=x.dtype, device=x.device)
    x = x.clone()
    one = torch.ones((), dtype=x.dtype, device=x.device)
    for i in range(K):
        a_col = A[:, i]
        diag = a_col[i]
        safe = diag != 0.0
        inv_lhs = torch.where(safe, one / torch.where(safe, diag, one), 0.0 * one)
        mu = inv_lhs * (b[i] - a_col @ x) + x[i]
        xi = mu + zs[i] * torch.sqrt(inv_lhs * vare)
        x[i] = torch.where(safe, xi, x[i])
    return x
