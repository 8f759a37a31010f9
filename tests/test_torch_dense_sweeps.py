"""The port's dense sweeps against jwas_tpu's, fed the same draws.

The grouped sweeps (sweep_blocks_abc_grouped / sweep_blocks_bayesr_grouped
over a DenseMarkers) against grouped_dense_sweep with mk.sweep_blocks_abc /
mk.sweep_blocks_bayesr, BayesB with its per-marker variances, with and
without residual weights: JAX's draws come in through the `draws` hook as
fold_in(fold_in(key, g), r) -> split -> uniform / normal (Gumbel / normal
for BayesR) (jwas_tpu/ops/markers.py:215-238, :524-566), and the chains
must agree to the tolerances of tests/test_pallas_sweep.py:42-45 (delta
exactly equal). The exact sweep (the same grouped sweeps with nreps = 1
over a store of one block a group: one K1 / K3 launch a chunk of b
markers) against jwas_tpu's sweep_exact_abc / sweep_exact_bayesr, the
draws rebuilt from the key as jwas_tpu/ops/markers.py:413-415 (and
:470-472) draw them and served chunk by chunk by ops/dense.py::sweep_draws,
to rtol 1e-5 / atol 1e-6 on alpha and equal delta, and against the port's
step-by-step plain versions (one dot product a marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import markers as jmk
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops import grouped as tgr


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _problem(n=100, p=190, b=8, seed=0):
    """Centered scores (n, p), weights, and a chain state over p_pad."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return rng, X, rinv


def _t(x):
    return torch.from_numpy(np.array(x))


def _draws_abc(key, b, gb):
    def draws(g, r, reps):
        ku, kz = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, g), r))
        return (_t(jax.random.uniform(ku, (reps * b, gb))),
                _t(jax.random.normal(kz, (reps * b, gb))))
    return draws


def _draws_bayesr(key, b, gb):
    def draws(g, r, reps):
        kg, kz = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, g), r))
        return (_t(jax.random.gumbel(kg, (reps * b, gb, 4))),
                _t(jax.random.normal(kz, (reps * b, gb))))
    return draws


def test_grouped_abc_matches_jax_with_injected_draws():
    """BayesC and BayesB (per-marker variances), unweighted and weighted;
    b = 8, 24 blocks of which the last is ragged (p = 190), gb = 4 from
    stable_group_blocks; a remainder round (5 reps, sync every 2) and one
    round of all reps."""
    n, p, b = 100, 190, 8
    rng, X, rinv = _problem(n, p, b)
    key = jax.random.PRNGKey(3)
    for method in ("BayesC", "BayesB"):
        for w in (None, rinv):
            md = jmk.build_marker_blocks(jnp.asarray(X), None if w is None else jnp.asarray(w),
                                         block_size=b)
            nblocks = md.grams.shape[2]
            gb = jmk.stable_group_blocks(n, b, nblocks)
            assert 1 < gb < nblocks
            dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=w)
            pp = nblocks * b
            for nreps, sync_every in ((5, 2), (4, None)):
                alpha = np.where(np.arange(pp) < p, 0.05 * rng.normal(size=pp), 0.0)
                alpha = alpha.astype(np.float32)
                delta = (alpha != 0).astype(np.int32)
                y = rng.normal(size=n).astype(np.float32)
                pi = np.where(np.arange(pp) < p, 0.8, 1.0).astype(np.float32)
                vare = np.float32(1.1)
                varg = (np.where(np.arange(pp) < p, rng.uniform(0.02, 0.08, pp), 1.0)
                        .astype(np.float32) if method == "BayesB" else np.float32(0.05))
                rinv_j = None if w is None else jnp.asarray(w)

                def cg(md_g, sts, yc, g, kg):
                    a, be, d, pi_g = sts[:4]
                    ve = sts[4] if method == "BayesB" else jnp.asarray(varg)
                    a, be, d, yc = jmk.sweep_blocks_abc(
                        md_g, a, be, d, yc, rinv_j, jnp.asarray(vare), ve, pi_g, kg,
                        nreps=nreps, sync_every=sync_every)
                    return (a, be, d, pi_g) + sts[4:], yc

                sts = (jnp.asarray(alpha), jnp.asarray(alpha), jnp.asarray(delta),
                       jnp.asarray(pi)) + ((jnp.asarray(varg),) if method == "BayesB" else ())
                out, yc = jmk.grouped_dense_sweep(cg, md, sts, jnp.asarray(y), key, gb)
                a, be, d, ycr = _t(alpha), _t(alpha), _t(delta), _t(y)
                tgr.sweep_blocks_abc_grouped(
                    dm, a, be, d, ycr, torch.tensor(vare), _t(varg), _t(pi), None,
                    nreps=nreps, sync_every=sync_every, draws=_draws_abc(key, b, gb))
                np.testing.assert_array_equal(d.numpy(), np.asarray(out[2]))
                np.testing.assert_allclose(a.numpy(), np.asarray(out[0]), rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(be.numpy()[:p], np.asarray(out[1])[:p],
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(ycr.numpy(), np.asarray(yc), rtol=1e-4, atol=1e-5)


def test_grouped_bayesr_matches_jax_with_injected_draws():
    """BayesR on the same layout, unweighted and weighted, every class
    visited."""
    n, p, b = 100, 190, 8
    rng, X, rinv = _problem(n, p, b, seed=4)
    key = jax.random.PRNGKey(5)
    for w in (None, rinv):
        md = jmk.build_marker_blocks(jnp.asarray(X), None if w is None else jnp.asarray(w),
                                     block_size=b)
        nblocks = md.grams.shape[2]
        gb = jmk.stable_group_blocks(n, b, nblocks)
        dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=w)
        pp = nblocks * b
        for nreps, sync_every in ((5, 2), (4, None)):
            real = np.arange(pp) < p
            delta = np.where(real, rng.choice(4, size=pp, p=[0.7, 0.1, 0.1, 0.1]), 0)
            delta = delta.astype(np.int32)
            alpha = np.where(delta > 0, 0.05 * rng.normal(size=pp), 0.0).astype(np.float32)
            y = rng.normal(size=n).astype(np.float32)
            pi_mat = np.where(real[:, None], [0.7, 0.1, 0.1, 0.1],
                              [1.0, 0.0, 0.0, 0.0]).astype(np.float32)
            vare, sigma_sq = np.float32(1.1), np.float32(0.05)
            rinv_j = None if w is None else jnp.asarray(w)

            def cg(md_g, sts, yc, g, kg):
                a, d, piT = sts
                a, d, yc = jmk.sweep_blocks_bayesr(
                    md_g, a, d, yc, rinv_j, jnp.asarray(vare), jnp.asarray(sigma_sq),
                    piT.T, kg, nreps=nreps, sync_every=sync_every)
                return (a, d, piT), yc

            (ra, rd, _), yc = jmk.grouped_dense_sweep(
                cg, md, (jnp.asarray(alpha), jnp.asarray(delta), jnp.asarray(pi_mat.T)),
                jnp.asarray(y), key, gb)
            a, d, ycr = _t(alpha), _t(delta), _t(y)
            tgr.sweep_blocks_bayesr_grouped(
                dm, a, d, ycr, torch.tensor(vare), torch.tensor(sigma_sq), _t(pi_mat),
                None, nreps=nreps, sync_every=sync_every, draws=_draws_bayesr(key, b, gb))
            np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
            assert len(np.unique(np.asarray(rd)[:p])) == 4
            np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(ycr.numpy(), np.asarray(yc), rtol=1e-4, atol=1e-5)


def test_exact_sweeps_match_jax_and_the_step_by_step_plain_versions():
    """BayesC and BayesR, unweighted and weighted, p = 300 in chunks of
    b = 128 (the last one 44 markers): the chunked sweep against jwas_tpu's
    sweep_exact_* and against the port's one-dot-product-a-marker plain
    version, on the same draws."""
    n, p = 150, 300
    rng, X, rinv = _problem(n, p, seed=6)
    key = jax.random.PRNGKey(7)
    Xs = torch.from_numpy(np.ascontiguousarray(X.T))
    for w in (None, rinv):
        dm = td.build_dense_markers(Xs, n, 128, 1, rinv=None if w is None else _t(w),
                                    exact=True)
        pp = dm.valid.shape[0]
        xw = X if w is None else X * w[:, None]
        xpx = jnp.asarray(np.einsum("np,np->p", xw, X))
        rinv_j = None if w is None else jnp.asarray(w)
        vare = np.float32(1.1)
        y = rng.normal(size=n).astype(np.float32)

        def pad(x, fill):
            out = np.full((pp,) + x.shape[1:], fill, x.dtype)
            out[:p] = x
            return _t(out)

        # BayesC
        alpha = (0.05 * rng.normal(size=p)).astype(np.float32)
        delta = (alpha != 0).astype(np.int32)
        pi = np.full(p, 0.8, np.float32)
        ra, rb, rd, ryc = jmk.sweep_exact_abc(
            jnp.asarray(X), xpx, jnp.asarray(alpha), jnp.asarray(alpha), jnp.asarray(delta),
            jnp.asarray(y), rinv_j, jnp.asarray(vare), jnp.asarray(np.float32(0.05)),
            jnp.asarray(pi), key)
        ku, kz = jax.random.split(key)
        us, zs = _t(jax.random.uniform(ku, (p,))), _t(jax.random.normal(kz, (p,)))
        runs = {}
        for name in ("chunked", "plain"):
            st = [pad(alpha, 0), pad(alpha, 0), pad(delta, 0), _t(y)]
            args = (torch.tensor(vare), torch.tensor(0.05), pad(pi, 1.0))
            if name == "chunked":
                tgr.sweep_blocks_abc_grouped(dm, *st, *args, None, nreps=1,
                                             draws=td.sweep_draws(128, us, zs))
            else:
                td.sweep_exact_abc_ref(dm, *st, *args, us, zs)
            runs[name] = st
            np.testing.assert_array_equal(st[2].numpy()[:p], np.asarray(rd))
            np.testing.assert_allclose(st[0].numpy()[:p], np.asarray(ra), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(st[1].numpy()[:p], np.asarray(rb), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(st[3].numpy(), np.asarray(ryc), rtol=1e-4, atol=1e-5)
        assert (runs["chunked"][0][p:] == 0).all()
        np.testing.assert_allclose(runs["chunked"][0].numpy(), runs["plain"][0].numpy(),
                                   rtol=1e-5, atol=1e-6)

        # BayesR
        delta = rng.choice(4, size=p, p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
        alpha = np.where(delta > 0, 0.05 * rng.normal(size=p), 0.0).astype(np.float32)
        pi_mat = np.broadcast_to(np.array([0.7, 0.1, 0.1, 0.1], np.float32), (p, 4)).copy()
        ra, rd, ryc = jmk.sweep_exact_bayesr(
            jnp.asarray(X), xpx, jnp.asarray(alpha), jnp.asarray(delta), jnp.asarray(y),
            rinv_j, jnp.asarray(vare), jnp.asarray(np.float32(0.05)), jnp.asarray(pi_mat), key)
        kg, kz = jax.random.split(key)
        gum, zs = _t(jax.random.gumbel(kg, (p, 4))), _t(jax.random.normal(kz, (p,)))
        pim = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (pp, 1))
        pim[:p] = pi_mat
        for name in ("chunked", "plain"):
            st = [pad(alpha, 0), pad(delta, 0), _t(y)]
            args = (torch.tensor(vare), torch.tensor(0.05), _t(pim))
            if name == "chunked":
                tgr.sweep_blocks_bayesr_grouped(dm, *st, *args, None, nreps=1,
                                                draws=td.sweep_draws(128, gum, zs))
            else:
                td.sweep_exact_bayesr_ref(dm, *st, *args, gum, zs)
            np.testing.assert_array_equal(st[1].numpy()[:p], np.asarray(rd))
            assert len(np.unique(np.asarray(rd))) == 4
            np.testing.assert_allclose(st[0].numpy()[:p], np.asarray(ra), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(st[2].numpy(), np.asarray(ryc), rtol=1e-4, atol=1e-5)
