"""K6's order of work and its library yardstick, on the CPU.

(1) gibbs_pass_lambda_sliced_ref (ops/location.py), the plain pass in the
    order the kernel csrc/gibbs_pass.cu works (slices of S rows: the
    other slices' products, then the forward substitution inside the
    slice), against the plain pass gibbs_pass_lambda_ref and against
    jwas_tpu.ops.location.gibbs_pass_lambda (a lax.scan), jwas_tpu's normal
    draws injected, for S in {1, 7, 32, 160, K}, ragged K (2,000 at
    S = 160; 33), zero diagonals at a slice's first and last row, in
    float32 and float64 (JAX's x64 mode).
(2) The pass as one lower-triangular solve, (D + L) x_new = b - U x +
    sqrt(vare diag A) o z (chip_smoke.k6_triangular, the yardstick timed
    beside K6 on the card), against the plain pass and jwas_tpu's.

Tolerance: chip_smoke.K6_RTOL (1e-5 float32, 1e-12 float64) times max |x|:
the versions sum the dot products in other orders, and the difference
passes through K dependent steps of a contraction on a positive definite
LHS.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import K6_RTOL, k6_triangular  # noqa: E402
from jwas_tpu.ops.location import gibbs_pass_lambda as jax_pass  # noqa: E402
from jwas_tpu_torch.ops.location import (gibbs_pass_lambda,  # noqa: E402
                                         gibbs_pass_lambda_ref,
                                         gibbs_pass_lambda_sliced_ref)

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


def _problem(K, zero_rows, seed):
    """An exactly symmetric positive definite LHS (W'W of a Gaussian W plus
    its diagonal), zero_rows' rows and columns set to 0, x ~ N(0, 1/2),
    b = A x_true, vare 1.3; numpy float64."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(K + 8, K)) / np.sqrt(K)
    A = W.T @ W
    A += np.diag(np.abs(A).sum(axis=1) * 0.1 + 0.5)
    A = np.triu(A) + np.triu(A, 1).T
    for r in zero_rows:
        A[r, :] = 0.0
        A[:, r] = 0.0
    x = np.sqrt(0.5) * rng.normal(size=K)
    b = A @ rng.normal(size=K)
    return A, x, b, 1.3


def _jax_pass(A, x, b, vare, dtype, seed):
    """jwas_tpu's pass (a lax.scan; JAX's x64 mode for float64) and the
    standard normals it draws, as a torch tensor of dtype."""
    key = jax.random.PRNGKey(seed)
    x64 = dtype == F64
    jax.config.update("jax_enable_x64", x64)
    jdt = jnp.float64 if x64 else jnp.float32
    try:
        want = np.asarray(jax_pass(jnp.asarray(A, jdt), jnp.asarray(x, jdt),
                                   jnp.asarray(b, jdt), jnp.asarray(vare, jdt), key))
        zs = torch.from_numpy(np.array(jax.random.normal(key, (A.shape[0],), dtype=jdt)))
    finally:
        jax.config.update("jax_enable_x64", False)
    return want, zs


def _zero_rows(K, S):
    """A zero diagonal at the first and the last row of a slice: slice 1's
    where there is one, else the only slice's."""
    first = S if S < K else 0
    return sorted({first, min(first + S, K) - 1})


SLICED_CASES = [(400, S) for S in (1, 7, 32, 160, 400)] + [(2_000, 160), (33, 32), (33, 160)]


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("K,S", SLICED_CASES, ids=[f"K{K}-S{S}" for K, S in SLICED_CASES])
def test_sliced_pass_matches_plain_and_jwas_tpu(K, S, dtype):
    """The sliced order of work against the plain pass and against
    jwas_tpu's lax.scan with the same draws, within K6_RTOL x max |x|;
    the zero-diagonal rows keep their x."""
    rows = _zero_rows(K, S)
    A, x, b, vare = _problem(K, rows, seed=K + S)
    want_jax, zs = _jax_pass(A, x, b, vare, dtype, seed=K * 7 + S)
    At, xt, bt = (torch.from_numpy(v).to(dtype) for v in (A, x, b))
    vt = torch.tensor(vare, dtype=dtype)
    got = gibbs_pass_lambda_sliced_ref(At, xt, bt, vt, zs, S)
    want = gibbs_pass_lambda_ref(At, xt, bt, vt, zs)
    assert got.dtype == dtype and got.shape == (K,)
    assert torch.isfinite(got).all()
    tol = K6_RTOL[dtype] * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    assert np.abs(got.numpy() - want_jax).max() <= tol
    for r in rows:
        assert got[r] == xt[r]
    # the wrapper's CPU path is the plain pass
    assert torch.equal(gibbs_pass_lambda(At, xt, bt, vt, None, zs=zs), want)


TRI_CASES = [(33, ()), (400, (0, 160, 399)), (2_000, (159, 160))]


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("K,rows", TRI_CASES, ids=[f"K{K}" for K, _ in TRI_CASES])
def test_triangular_solve_matches_plain_and_jwas_tpu(K, rows, dtype):
    """One in-order Gibbs pass is one lower-triangular solve; a row with a
    zero diagonal is an identity row with right-hand side x_i. Held
    against the plain pass and jwas_tpu's with the same draws."""
    A, x, b, vare = _problem(K, rows, seed=3 * K)
    want_jax, zt = _jax_pass(A, x, b, vare, dtype, seed=K)
    At, xt, bt = (torch.from_numpy(v).to(dtype) for v in (A, x, b))
    vt = torch.tensor(vare, dtype=dtype)
    got = k6_triangular(At, xt, bt, vt, zt)()
    want = gibbs_pass_lambda_ref(At, xt, bt, vt, zt)
    assert got.dtype == dtype and torch.isfinite(got).all()
    tol = K6_RTOL[dtype] * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    assert np.abs(got.numpy() - want_jax).max() <= tol
    for r in rows:
        assert got[r] == xt[r]
