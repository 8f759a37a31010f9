"""The port's latent-trait machinery (ops/threshold.py, ops/dists.py's
truncated normal) against jwas_tpu/ops/threshold.py.

Deterministic pieces equal jwas_tpu's at rtol 1e-5 / atol 1e-6 in float32
and 1e-10 / 1e-12 in float64: the liability bounds from the thresholds and
the conditional mean and variance of a trait's residual. Draws are replayed
(parity level (b) of ROADMAP.md): JAX's uniforms, truncated normals, Wishart
and normal draws from the functions' own keys in their own split order go
into the port's functions, which take draws as inputs: the thresholds, the
liabilities (single- and multi-trait, 5 Gibbs passes) and Korsgaard's
conditional inverse-Wishart.

The port's truncated normal passes a KS test against
scipy.stats.truncnorm up to |a| = 8 in float32 and float64, one-sided,
two-sided and narrow. jwas_tpu's jax.random.truncated_normal in float32 is
a point mass at a = 6 (reference fault R13, ROADMAP.md): the test shows it
beside the port's draw.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from jwas_tpu.ops import dists as jd
from jwas_tpu.ops import threshold as jth
from jwas_tpu_torch.ops import threshold as th
from jwas_tpu_torch.ops.dists import BIG, truncated_normal_from_uniform

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-10, atol=1e-12)}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@contextlib.contextmanager
def x64(dtype):
    jax.config.update("jax_enable_x64", dtype == torch.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _t(x, dtype):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bounds_from_thresholds_match_jax(dtype):
    rng = np.random.default_rng(1)
    thr = np.array([-BIG, 0.0, 0.4, 1.1, BIG, BIG])
    cats = rng.integers(0, 5, 200)             # 0: missing
    with x64(dtype):
        jl, ju = jth.bounds_from_thresholds(jnp.asarray(thr, JDT[dtype]), jnp.asarray(cats))
        pl, pu = th.bounds_from_thresholds(_t(thr, dtype), torch.as_tensor(cats))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL[dtype])
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), **TOL[dtype])
    assert (pl.numpy()[cats == 0] == -BIG).all() and (pu.numpy()[cats == 0] == BIG).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("start", [2, 3])
def test_thresholds_match_jax_on_its_uniforms(dtype, start):
    """sample_thresholds_t with jwas_tpu's uniforms: uniform(keys[i]) for
    threshold i, keys = split(key, n_cat)."""
    rng = np.random.default_rng(2)
    n_cat = 5
    cats = rng.integers(1, n_cat + 1, 300)
    liab = rng.normal(size=300) + cats
    thr = np.array([-BIG, 0.0, 1.0, 2.0, 3.0, BIG])
    key = jax.random.PRNGKey(3)
    with x64(dtype):
        want = jth.sample_thresholds_t(key, jnp.asarray(thr, JDT[dtype]),
                                       jnp.asarray(liab, JDT[dtype]), jnp.asarray(cats),
                                       n_cat, start)
        keys = jax.random.split(key, n_cat)
        u = np.array([float(jax.random.uniform(keys[i], dtype=JDT[dtype]))
                      for i in range(n_cat)])
    got = th.sample_thresholds_t(_t(thr, dtype), _t(liab, dtype), torch.as_tensor(cats),
                                 n_cat, start, _t(u, dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    assert (got.numpy()[start:n_cat] != thr[start:n_cat]).all()


def _covariance(t, rng):
    A = rng.normal(size=(t, t))
    return A @ A.T / t + np.eye(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_conditional_moments_match_jax(dtype):
    rng = np.random.default_rng(4)
    R = _covariance(3, rng)
    ycorr = rng.normal(size=(3, 50))
    for trait in range(3):
        others = [m for m in range(3) if m != trait]
        w = np.linalg.solve(R[np.ix_(others, others)], R[trait, others])
        mean, var = th.conditional_moments(_t(R, dtype), _t(ycorr, dtype), trait)
        with x64(dtype):
            Rj = jnp.asarray(R, JDT[dtype])
            idx = jnp.asarray(others)
            wj = jnp.linalg.solve(Rj[jnp.ix_(idx, idx)], Rj[trait][idx])
            mj = jnp.einsum("m,mn->n", wj, jnp.asarray(ycorr, JDT[dtype])[idx])
            sj = Rj[trait, trait] - Rj[trait][idx] @ wj
        np.testing.assert_allclose(mean.numpy(), np.asarray(mj), **TOL[dtype])
        np.testing.assert_allclose(float(var), float(sj), **TOL[dtype])
        np.testing.assert_allclose(float(var), R[trait, trait] - R[trait, others] @ w,
                                   rtol=1e-5)


def _latent_problem(rng, t, n):
    """Liabilities, residuals and bounds of t traits: trait 0 binary, 1
    censored (a third point observations), 2 continuous (when t > 2)."""
    liab = rng.normal(size=(t, n))
    ycorr = liab - 0.3 * rng.normal(size=(t, n))
    lower = np.full((t, n), -BIG)
    upper = np.full((t, n), BIG)
    cat = rng.integers(0, 2, n)
    lower[0] = np.where(cat == 1, 0.0, -BIG)
    upper[0] = np.where(cat == 1, BIG, 0.0)
    if t > 1:
        y = rng.normal(size=n)
        cens = rng.uniform(size=n) < 0.5
        lower[1] = np.where(cens, 0.2, y)
        upper[1] = np.where(cens, BIG, y)
    return liab, ycorr, lower, upper


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t,latent,n_gibbs", [(1, (0,), 1), (3, (0, 1), 5)])
def test_liabilities_match_jax_on_its_truncated_normals(dtype, t, latent, n_gibbs):
    """sample_liabilities given jwas_tpu's truncated normals: draw ki
    (pass-major) is truncated_normal(keys[ki], a, b) with keys =
    split(key, n_gibbs len(latent)), at the port's standardised bounds."""
    rng = np.random.default_rng(5 + t)
    n = 120
    R = _covariance(t, rng)
    liab, ycorr, lower, upper = _latent_problem(rng, t, n)
    key = jax.random.PRNGKey(6)
    with x64(dtype):
        jl, jy = jth.sample_liabilities(key, jnp.asarray(liab, JDT[dtype]),
                                        jnp.asarray(ycorr, JDT[dtype]),
                                        jnp.asarray(R, JDT[dtype]),
                                        jnp.asarray(lower, JDT[dtype]),
                                        jnp.asarray(upper, JDT[dtype]), latent, n_gibbs)
        keys = jax.random.split(key, n_gibbs * len(latent))

        def z_of(ki, a, b):
            return _t(jax.random.truncated_normal(keys[ki], jnp.asarray(a.numpy()),
                                                  jnp.asarray(b.numpy()), shape=a.shape,
                                                  dtype=JDT[dtype]), dtype)

        pl, py = th.sample_liabilities(_t(liab, dtype), _t(ycorr, dtype), _t(R, dtype),
                                       _t(lower, dtype), _t(upper, dtype), latent,
                                       n_gibbs, z_of)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL[dtype])
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL[dtype])
    moved = pl.numpy()[list(latent)] != liab[list(latent)]
    assert moved.mean() > 0.5
    inside = (pl.numpy() >= lower - 1e-6) & (pl.numpy() <= upper + 1e-6)
    point = lower >= upper                     # point observations keep theirs
    assert (inside | point)[list(latent)].all()
    np.testing.assert_allclose(pl.numpy()[point], liab[point], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_trait_liabilities_match_jax_step(dtype):
    """sample_liabilities on one trait with R = vare and one pass, as
    engine/mcmc.py::latent_step calls it, against jwas_tpu's single-trait
    latent branch (engine/mcmc.py:136-150) on its truncated normals; point
    observations keep their residual."""
    rng = np.random.default_rng(7)
    n = 150
    liab, ycorr, lower, upper = (x[0] for x in _latent_problem(rng, 1, n))
    lower[:20] = upper[:20] = liab[:20] - ycorr[:20]     # point observations
    vare = 1.7
    key = jax.random.PRNGKey(8)
    with x64(dtype):
        J = lambda x: jnp.asarray(x, JDT[dtype])  # noqa: E731
        cmean = J(liab) - J(ycorr)
        eps_lb, eps_ub = J(lower) - cmean, J(upper) - cmean
        fixed = eps_lb >= eps_ub
        std = jnp.sqrt(J(vare))
        a = jnp.clip(jnp.where(fixed, -1.0, eps_lb) / std, -BIG, BIG)
        b = jnp.clip(jnp.where(fixed, 1.0, eps_ub) / std, -BIG, BIG)
        z = jax.random.truncated_normal(key, a, b, shape=cmean.shape, dtype=JDT[dtype])
        eps = jnp.where(fixed, J(ycorr), std * z)
        row = lambda x: _t(x, dtype).view(1, -1)  # noqa: E731
        pl, py = th.sample_liabilities(row(liab), row(ycorr), _t(vare, dtype).view(1, 1),
                                       row(lower), row(upper), (0,), 1,
                                       lambda ki, a, b: _t(z, dtype))
        pl, py = pl[0], py[0]
    np.testing.assert_allclose(pl.numpy(), np.asarray(cmean + eps), **TOL[dtype])
    np.testing.assert_allclose(py.numpy(), np.asarray(eps), **TOL[dtype])
    assert np.array_equal(py.numpy()[:20], _t(ycorr, dtype).numpy()[:20])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t,binary", [(2, (1,)), (3, (0, 2))])
def test_korsgaard_matches_jax_on_its_draws(dtype, t, binary):
    """Korsgaard's conditional inverse-Wishart given jwas_tpu's X1 =
    sample_wishart(k1, df, V11) and Z = normal(k2, (n1, n2)), (k1, k2) =
    split(key): R equals jwas_tpu's and the binary traits' variances are
    exactly 1."""
    rng = np.random.default_rng(9 + t)
    S = _covariance(t, rng) * 40.0
    prec = np.linalg.inv(S)
    prec = 0.5 * (prec + prec.T)
    df = 50.0
    key = jax.random.PRNGKey(10)
    idx1 = [i for i in range(t) if i not in binary]
    with x64(dtype):
        want = jth.sample_conditional_inv_wishart_korsgaard(
            key, df, jnp.asarray(prec, JDT[dtype]), binary, t)
        k1, k2 = jax.random.split(key)
        V11 = jnp.asarray(prec, JDT[dtype])[jnp.ix_(jnp.asarray(idx1), jnp.asarray(idx1))]
        X1 = jd.sample_wishart(k1, df, V11)
        Z = jax.random.normal(k2, (len(idx1), len(binary)), dtype=JDT[dtype])
        bart = jd._standard_wishart_chol(k1, df, len(idx1), JDT[dtype])
    got = th.conditional_inv_wishart_korsgaard(_t(prec, dtype), binary, _t(X1, dtype),
                                               _t(Z, dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    for b in binary:
        assert float(got[b, b]) == 1.0
    sampled = th.sample_conditional_inv_wishart_korsgaard(None, df, _t(prec, dtype), binary,
                                                          bartlett=_t(bart, dtype),
                                                          Z=_t(Z, dtype))
    np.testing.assert_allclose(sampled.numpy(), np.asarray(want), **TOL[dtype])
    assert np.all(np.linalg.eigvalsh(got.numpy().astype(np.float64)) > 0)


KS_BOUNDS = [(-np.inf, -8.0), (-np.inf, 0.3), (2.0, np.inf), (5.0, np.inf), (8.0, np.inf),
             (-1.0, 2.0), (3.0, 3.05), (7.9, 8.0), (-8.0, -7.95), (-0.01, 0.01)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_truncated_normal_passes_ks_against_scipy(dtype):
    """20,000 draws a case from one seeded generator: KS p > 0.01 against
    scipy.stats.truncnorm, one-sided up to |a| = 8, two-sided and narrow;
    every draw inside its bounds."""
    gen = torch.Generator().manual_seed(11)
    n = 20_000
    for lo, hi in KS_BOUNDS:
        a = torch.full((n,), max(lo, -BIG), dtype=dtype)
        b = torch.full((n,), min(hi, BIG), dtype=dtype)
        u = torch.rand(n, generator=gen, dtype=torch.float64)
        x = truncated_normal_from_uniform(u, a, b).double().numpy()
        assert ((x >= max(lo, -BIG)) & (x <= min(hi, BIG))).all(), (lo, hi)
        p = stats.kstest(x, stats.truncnorm(lo, hi).cdf).pvalue
        assert p > 0.01, (dtype, lo, hi, p)
        drawn = th.truncated_normals(gen)(0, a, b).double().numpy()
        assert stats.kstest(drawn, stats.truncnorm(lo, hi).cdf).pvalue > 0.01, (lo, hi)
    # past ~37 SD both tail probabilities underflow: the draw is the bound
    # nearer the mass (the true draw lies within 1 / |a| of it)
    for lo, hi, near in [(40.0, BIG, 40.0), (-BIG, -40.0, -40.0), (40.0, 41.0, 40.0),
                         (-41.0, -40.0, -40.0)]:
        u = torch.rand(1000, generator=gen, dtype=torch.float64)
        x = truncated_normal_from_uniform(u, torch.full((1000,), lo, dtype=dtype),
                                          torch.full((1000,), hi, dtype=dtype))
        assert (x == near).all(), (dtype, lo, hi)


def test_reference_truncated_normal_collapses_in_the_tail_fault_r13():
    """Fault R13: jax.random.truncated_normal in float32 with lower bound
    a = 6 and no upper bound is a point mass at the bound (erf(a / sqrt 2)
    rounds to 1); its mean is 6.0, not phi(6) / (1 - Phi(6)) = 6.1577. The
    port's draw at the same bound passes the KS test and has that mean."""
    jax.config.update("jax_enable_x64", False)
    n = 50_000
    z = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(12), 6.0, np.inf,
                                               shape=(n,), dtype=jnp.float32))
    assert len(np.unique(z)) <= 2
    assert abs(z.mean() - 6.0) < 1e-4
    true_mean = stats.truncnorm(6.0, np.inf).mean()
    assert abs(true_mean - 6.1577) < 1e-3
    gen = torch.Generator().manual_seed(13)
    x = th.truncated_normals(gen)(0, torch.full((n,), 6.0), torch.full((n,), BIG))
    x = x.double().numpy()
    assert len(np.unique(x)) > n // 2
    assert abs(x.mean() - true_mean) < 0.01
    assert stats.kstest(x, stats.truncnorm(6.0, np.inf).cdf).pvalue > 0.01
