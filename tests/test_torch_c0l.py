"""RR-BLUP and BayesL in the port against jwas_tpu, fed the same draws.

(1) The grouped sweep (ops/grouped.py::sweep_blocks_c0l_grouped over a
    DenseMarkers: K1's plain version with every marker in the slab)
    against jwas_tpu's grouped_dense_sweep with mk.sweep_blocks_c0l, JAX's
    normal panels injected as fold_in(fold_in(key, g), r) -> normal
    (jwas_tpu/ops/markers.py:312-352, :524-566): RR-BLUP and BayesL (gamma
    from a seed), a remainder round (5 reps, sync every 2) and one round
    of all reps, float32 and float64, with and without residual weights.
    The two updates round differently (K1's g + z sqrt(1 / lhs) with
    lhs = xpx / vare + 1 / var, against _c0l_update's mean + z sqrt(vare /
    (xpx + vare / var))): alpha to rtol 1e-5 / atol 1e-6 in float32 and
    rtol 1e-10 / atol 1e-12 in float64, ycorr to rtol 1e-4 / atol 1e-5 and
    1e-10 / 1e-12; the padding markers stay exactly 0.
(2) The exact sweep (the same sweep with nreps = 1 over single-block
    groups) against jwas_tpu's sweep_exact_c0l, its (p,) normals rebuilt
    from the key, and against the port's step-by-step sweep_exact_c0l_ref,
    to the same tolerances.
(3) BayesL's local-shrinkage step and the weighted common variance draw
    against jwas_tpu's sample_bayesl_gamma and
    sample_marker_variance_common(invweights), fed the same Gamma(0.5),
    uniform and chi-square draws: rtol 1e-6.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import markers as jmk
from jwas_tpu.ops import variance as jvar
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks, from_jax_state
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops import grouped as tgr
from jwas_tpu_torch.ops import variance as tvar

TOL = {"float32": dict(alpha=(1e-5, 1e-6), ycorr=(1e-4, 1e-5)),
       "float64": dict(alpha=(1e-10, 1e-12), ycorr=(1e-10, 1e-12))}


@pytest.fixture(autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


@contextlib.contextmanager
def precision(dtype):
    """JAX's x64 mode for a float64 comparison, off again afterwards."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield np.dtype(dtype).type, getattr(torch, dtype)
    finally:
        jax.config.update("jax_enable_x64", False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(n, p, seed, f):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, p)).astype(f)
    X -= X.mean(axis=0)
    return rng, X, rng.uniform(0.5, 2.0, n).astype(f)


def _close(got, want, tol):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("method", ["RR-BLUP", "BayesL"])
def test_grouped_c0l_matches_jax_with_injected_draws(method, dtype, weighted):
    """b = 8, 24 blocks of which the last is ragged (p = 190), gb = 4 from
    stable_group_blocks."""
    n, p, b = 100, 190, 8
    with precision(dtype) as (f, tdt):
        rng, X, rinv = _problem(n, p, 0, f)
        w = rinv if weighted else None
        md = jmk.build_marker_blocks(jnp.asarray(X), None if w is None else jnp.asarray(w),
                                     block_size=b)
        nblocks = md.grams.shape[2]
        gb = jmk.stable_group_blocks(n, b, nblocks)
        assert 1 < gb < nblocks
        dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=w,
                                    dtype=tdt)
        pp = nblocks * b
        real = np.arange(pp) < p
        key = jax.random.PRNGKey(3)
        for nreps, sync_every in ((5, 2), (4, None)):
            alpha = np.where(real, 0.05 * rng.normal(size=pp), 0.0).astype(f)
            y = rng.normal(size=n).astype(f)
            gamma = np.where(real, rng.gamma(1.0, size=pp) * 8.0 if method == "BayesL"
                             else 1.0, 1.0).astype(f)
            vare, varg = f(1.1), f(0.05)
            rinv_j = None if w is None else jnp.asarray(w)

            def cg(md_g, sts, yc, g, kg):
                a, gam_g = sts
                a, yc = jmk.sweep_blocks_c0l(md_g, a, yc, rinv_j, jnp.asarray(vare),
                                             jnp.asarray(varg), gam_g, kg, nreps=nreps,
                                             sync_every=sync_every)
                return (a, gam_g), yc

            (ra, _), ryc = jmk.grouped_dense_sweep(
                cg, md, (jnp.asarray(alpha), jnp.asarray(gamma)), jnp.asarray(y), key, gb)

            def draws(g, r, reps):
                kr = jax.random.fold_in(jax.random.fold_in(key, g), r)
                return (_t(jax.random.normal(kr, (reps * b, gb), dtype=f)),)

            st = from_jax_state(alpha=alpha, ycorr=y, gamma=gamma, dtype=tdt)
            tgr.sweep_blocks_c0l_grouped(
                dm, st["alpha"], st["ycorr"], torch.tensor(vare), torch.tensor(varg),
                st["gamma"] if method == "BayesL" else None, None, nreps=nreps,
                sync_every=sync_every, draws=draws)
            assert st["alpha"].dtype == tdt
            _close(st["alpha"].numpy(), ra, TOL[dtype]["alpha"])
            _close(st["ycorr"].numpy(), ryc, TOL[dtype]["ycorr"])
            assert (st["alpha"].numpy()[~real] == 0).all()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("method", ["RR-BLUP", "BayesL"])
def test_exact_c0l_matches_jax_and_the_step_by_step_plain_version(method, weighted):
    """p = 300 in chunks of b = 128 (the last one 44 markers), float32."""
    n, p = 150, 300
    rng, X, rinv = _problem(n, p, 6, np.float32)
    w = rinv if weighted else None
    key = jax.random.PRNGKey(7)
    Xs = torch.from_numpy(np.ascontiguousarray(X.T))
    dm = td.build_dense_markers(Xs, n, 128, 1, rinv=None if w is None else _t(w), exact=True)
    pp = dm.valid.shape[0]
    xw = X if w is None else X * w[:, None]
    xpx = jnp.asarray(np.einsum("np,np->p", xw, X))
    alpha = (0.05 * rng.normal(size=p)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    gamma = (rng.gamma(1.0, size=p) * 8.0 if method == "BayesL" else np.ones(p)).astype(np.float32)
    vare, varg = np.float32(1.1), np.float32(0.05)
    ra, ryc = jmk.sweep_exact_c0l(
        jnp.asarray(X), xpx, jnp.asarray(alpha), jnp.asarray(y),
        None if w is None else jnp.asarray(w), jnp.asarray(vare), jnp.asarray(varg),
        jnp.asarray(gamma), key)
    zs = _t(jax.random.normal(key, (p,)))

    def pad(x, fill):
        out = np.full(pp, fill, x.dtype)
        out[:p] = x
        return _t(out)

    runs = {}
    for name in ("chunked", "plain"):
        a, yc = pad(alpha, 0), _t(y)
        gam = pad(gamma, 1) if method == "BayesL" else None
        if name == "chunked":
            tgr.sweep_blocks_c0l_grouped(dm, a, yc, torch.tensor(vare), torch.tensor(varg),
                                         gam, None, nreps=1, draws=td.sweep_draws(128, zs))
        else:
            td.sweep_exact_c0l_ref(dm, a, yc, torch.tensor(vare), torch.tensor(varg), gam, zs)
        runs[name] = a
        _close(a.numpy()[:p], ra, TOL["float32"]["alpha"])
        _close(yc.numpy(), ryc, TOL["float32"]["ycorr"])
    assert (runs["chunked"][p:] == 0).all()
    _close(runs["chunked"].numpy(), runs["plain"].numpy(), TOL["float32"]["alpha"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bayesl_gamma_and_weighted_variance_match_jax(dtype):
    """jwas_tpu draws BayesL's candidates and uniforms from split(key, 3)
    (its kc, ku) and the variance's chi-square from its key; the port's
    bayesl_gamma and sample_marker_variance_common take the same draws.
    Half the markers' steps are accepted; padding stays at 1."""
    p, p_pad, df, scale = 90, 96, 4.0, 0.02
    with precision(dtype) as (f, tdt):
        rng = np.random.default_rng(11)
        valid = (np.arange(p_pad) < p).astype(f)
        alpha = np.where(valid > 0, 0.1 * rng.normal(size=p_pad), 0.0).astype(f)
        gamma = np.where(valid > 0, rng.gamma(1.0, size=p_pad) * 8.0, 1.0).astype(f)
        varg = f(0.03)
        key = jax.random.PRNGKey(12)
        want = np.asarray(jvar.sample_bayesl_gamma(key, jnp.asarray(gamma), jnp.asarray(alpha),
                                                   jnp.asarray(varg), jnp.asarray(valid)))
        _, kc, ku = jax.random.split(key, 3)
        g_half = jax.random.gamma(kc, jnp.full((p_pad,), 0.5))
        u = jax.random.uniform(ku, (p_pad,), dtype=f)
        t = from_jax_state(gamma=gamma, alpha=alpha, valid=valid, g_half=g_half, u=u, dtype=tdt)
        got = tvar.bayesl_gamma(t["gamma"], t["alpha"], torch.tensor(varg), t["valid"],
                                t["g_half"], t["u"])
        assert got.dtype == tdt
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        moved = (want != gamma)[:p].mean()
        assert 0.2 < moved < 0.9 and (got.numpy()[p:] == 1).all()

        for n_loci, inv in ((p, None), (p, 1.0 / gamma)):
            k2 = jax.random.PRNGKey(13)
            ref = jvar.sample_marker_variance_common(
                k2, jnp.asarray(alpha), n_loci, df, jnp.asarray(f(scale)),
                invweights=None if inv is None else jnp.asarray(inv))
            chi = 2.0 * jax.random.gamma(k2, jnp.asarray(n_loci + df) / 2.0)
            got = tvar.sample_marker_variance_common(
                None, t["alpha"], p, df, torch.tensor(f(scale)),
                invweights=None if inv is None else _t(inv), chi=torch.tensor(np.array(chi)))
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
