"""The port's multi-trait GBLUP against jwas_tpu's.

ops/multitrait.py::mt_gblup against jwas_tpu's mt_gblup (jwas_tpu/ops/
multitrait.py:508) on the same eigenbasis, effects and residuals, with its
(m, t) normals injected, with and without residual weights, in float32
(rtol 1e-5) and float64 (rtol 1e-10); one outer iteration of runMCMC's
multi-trait GBLUP, and of its mega-trait form (GBLUP's single-trait sweep a
trait), in float64 on jwas_tpu's draws (tests/test_torch_mt_c0l.py::
step_on_jwas_draws; the eigenbasis is the port's, as every genotyped
individual is phenotyped, where jwas_tpu's L = Z_t V is the same matrix up
to the eigenvectors' signs, so the port's is given to both), and of the
mega-trait BayesL; and the chain
within calibrated Monte-Carlo bounds of jwas_tpu.runMCMC
(tests/test_torch_mt_runmcmc.py's CHAINS), its result tables and sample
files with jwas_tpu's names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import multitrait as jmt
from jwas_tpu_torch.ops import gblup as tg
from jwas_tpu_torch.ops import multitrait as tmt

from test_torch_mt_c0l import check_setup, check_step, step_on_jwas_draws
from test_torch_mt_runmcmc import check_chain


@pytest.fixture(autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype,weighted", [("float32", False), ("float32", True),
                                            ("float64", True)])
def test_mt_gblup_matches_jax(dtype, weighted):
    """m = n = 48 pseudo-markers of 3 traits on an orthogonal L."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    np_dt = np.dtype(dtype)
    rng = np.random.default_rng(5)
    n, t = 48, 3
    L = np.linalg.qr(rng.normal(size=(n, n)))[0].astype(np_dt)
    D = rng.uniform(0.1, 3.0, n).astype(np_dt)
    alpha = (0.3 * rng.normal(size=(t, n))).astype(np_dt)
    ycorr = rng.normal(size=(t, n)).astype(np_dt)
    rinv = rng.uniform(0.5, 2.0, n).astype(np_dt)
    A, B = rng.normal(size=(t, t)), rng.normal(size=(t, t))
    R = (A @ A.T / t + np.eye(t)).astype(np_dt)
    G = (B @ B.T / t + np.eye(t)).astype(np_dt)
    key = jax.random.PRNGKey(3)
    wa, wy = jmt.mt_gblup(jnp.asarray(L), jnp.asarray(D), jnp.asarray(alpha),
                          jnp.asarray(ycorr), jnp.asarray(rinv) if weighted else None,
                          jnp.asarray(R), jnp.asarray(G), key)
    z = torch.from_numpy(np.array(jax.random.normal(key, (n, t), np_dt)))
    T = torch.from_numpy
    gm = tg.build_gblup_markers(T(L), T(D), rinv=T(rinv) if weighted else None)
    a, y = T(alpha.copy()), T(ycorr.copy())
    tmt.mt_gblup(gm, a, y, T(R), T(G), None, z=z)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a.numpy(), np.asarray(wa), **tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **tol)


@pytest.mark.parametrize("method,constraint", [("GBLUP", False), ("GBLUP", True),
                                               ("BayesL", True)])
def test_step_matches_jwas_tpu_on_its_draws(method, constraint, monkeypatch):
    """One outer iteration on jwas_tpu's draws and the set-up
    (tests/test_torch_mt_c0l.py::step_on_jwas_draws, check_setup): GBLUP,
    and the mega-trait GBLUP and BayesL (each trait's single-trait sweep on
    its key of split(k_mark, t), the diagonal covariance's chi-square
    draws)."""
    want, got, *built = step_on_jwas_draws(method, constraint, monkeypatch)
    check_setup(method, constraint, *built)
    check_step(want, got, method)


def test_gblup_chain_matches_jwas_tpu_within_monte_carlo_error(tmp_path):
    check_chain("GBLUP", tmp_path, files=True)
