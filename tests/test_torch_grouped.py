"""The port's Gram tiles, grouped GEMVs and grouped sweep against jwas_tpu.

Inputs are made with numpy from a seed. Gram tiles agree to float32
summation order (rtol 1e-5, atol 1e-4 as tests/test_grouped.py; the exact
bf16 path to rtol 1e-4, atol 1e-3 against the f32 path); the sweep gets
JAX's own draws through the `draws` hook, rebuilt as
fold_in(fold_in(key, g), r) -> split -> uniform / normal
(jwas_tpu/ops/grouped.py:553-555,580, ops/markers.py:215-238), and must
give the same chain to the tolerances of tests/test_pallas_sweep.py:42-45
(delta exactly equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import grouped as jgr
from jwas_tpu_torch.engine.convert import from_jax_arrays
from jwas_tpu_torch.io.packed import pack_codes
from jwas_tpu_torch.ops import grouped as tgr


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _problem(n=50, p=96, b=8, gb=4, seed=0, missing=True, permuted=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4 if missing else 3, size=(n, p)).astype(np.uint8)
    packed = pack_codes(codes)
    means = np.array([c[c < 3].mean() for c in codes.T], np.float32)
    perm = rng.permutation(n) if permuted else None
    store3 = packed.reshape(p // (b * gb), b * gb, -1)
    valid = np.ones(p, np.float32)
    grams, xpx = jgr.grouped_stats(
        jnp.asarray(store3), jnp.asarray(means), jnp.asarray(valid),
        None if perm is None else jnp.asarray(perm, jnp.int32), None, b, n)
    gmj = jgr.GroupedPackedMarkers(
        store=jnp.asarray(store3), means=jnp.asarray(means),
        row_perm=None if perm is None else jnp.asarray(perm, jnp.int32),
        xpx=xpx, grams=grams, valid=jnp.asarray(valid))
    return gmj, store3, means, valid, perm, n


def _fetch(store3):
    """A GroupFetcher over a (ngroups, G, bpm) store, every group resident."""
    ngroups, G, bpm = store3.shape
    return tgr.GroupFetcher(torch.from_numpy(store3.reshape(-1, bpm).copy()), G,
                            "cpu", ngroups)


def test_grouped_stats_and_gemvs_match_jax():
    """Gram tiles on the f32 path with and without missing codes and a row
    permutation, and on the exact bf16 path, which refuses a permutation;
    then the whole-store X v and X'w."""
    for missing, permuted in ((True, True), (False, False)):
        gmj, store3, means, valid, perm, n = _problem(missing=missing,
                                                      permuted=permuted)
        grams, xpx = tgr.grouped_stats(
            _fetch(store3), torch.from_numpy(means),
            torch.from_numpy(valid),
            None if perm is None else torch.from_numpy(perm), 8, n)
        jgrams = np.transpose(np.asarray(gmj.grams), (2, 0, 1))
        np.testing.assert_allclose(grams.numpy(), jgrams, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(xpx.numpy(), np.asarray(gmj.xpx), rtol=1e-5,
                                   atol=1e-4)

    jg, jx = jgr.grouped_stats(gmj.store, gmj.means, gmj.valid, None, None, 8,
                               n, exact_bf16=True)
    grams, xpx = tgr.grouped_stats(
        _fetch(store3), torch.from_numpy(means),
        torch.from_numpy(valid), None, 8, n, exact_bf16=True)
    np.testing.assert_allclose(grams.numpy(), np.transpose(np.asarray(jg), (2, 0, 1)),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(xpx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):
        tgr.grouped_stats(_fetch(store3), torch.from_numpy(means),
                          torch.from_numpy(valid), torch.arange(n), 8, n,
                          exact_bf16=True)

    gmj, store3, means, valid, perm, n = _problem(seed=4)
    gm, _ = from_jax_arrays(store3, means, valid, gmj.xpx, gmj.grams, n, perm)
    rng = np.random.default_rng(5)
    v = rng.normal(size=valid.shape[0]).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    np.testing.assert_allclose(
        tgr.grouped_matvec(gm, torch.from_numpy(v)).numpy(),
        np.asarray(jgr.grouped_matvec(gmj, jnp.asarray(v), n_obs=n)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tgr.grouped_rhs(gm, torch.from_numpy(w)).numpy(),
        np.asarray(jgr.grouped_rhs(gmj, jnp.asarray(w))), rtol=1e-4, atol=1e-4)


def _jax_draws(key, b, gb):
    def draws(g, r, reps):
        kr = jax.random.fold_in(jax.random.fold_in(key, g), r)
        ku, kz = jax.random.split(kr)
        us = jax.random.uniform(ku, (reps * b, gb), dtype=jnp.float32)
        zs = jax.random.normal(kz, (reps * b, gb), dtype=jnp.float32)
        return torch.from_numpy(np.array(us)), torch.from_numpy(np.array(zs))
    return draws


def test_sweep_matches_jax_with_injected_draws():
    """3 groups of gb = 4 blocks, missing codes, permuted observations; a
    remainder round (5 reps, sync every 2) and one round of all reps."""
    gmj, store3, means, valid, perm, n = _problem(seed=6)
    assert store3.shape[0] == 3
    for nreps, sync_every in ((5, 2), (4, None)):
        rng = np.random.default_rng(7)
        p = valid.shape[0]
        alpha = (rng.normal(size=p) * 0.05).astype(np.float32)
        delta = (rng.uniform(size=p) < 0.5).astype(np.int32)
        y = rng.normal(size=n).astype(np.float32)
        pi = np.full(p, 0.8, np.float32)
        vare, varg = np.float32(1.1), np.float32(0.05)
        key = jax.random.PRNGKey(3)
        ref = jgr.sweep_blocks_abc_grouped(
            gmj, jnp.asarray(alpha), jnp.asarray(alpha), jnp.asarray(delta),
            jnp.asarray(y), None, jnp.asarray(vare), jnp.asarray(varg),
            jnp.asarray(pi), key, nreps=nreps, sync_every=sync_every)
        gm, st = from_jax_arrays(store3, means, valid, gmj.xpx, gmj.grams, n,
                                 perm, alpha=alpha, beta=alpha, delta=delta,
                                 ycorr=y, pi=pi, vare=vare, varg=varg)
        got = tgr.sweep_blocks_abc_grouped(
            gm, st["alpha"], st["beta"], st["delta"], st["ycorr"], st["vare"],
            st["varg"], st["pi"], None, nreps=nreps, sync_every=sync_every,
            draws=_jax_draws(key, 8, 4))
        a, be, d, yc = (np.asarray(x) for x in ref)
        np.testing.assert_array_equal(got[2].numpy(), d)
        np.testing.assert_allclose(got[0].numpy(), a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), be, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[3].numpy(), yc, rtol=1e-4, atol=1e-5)
