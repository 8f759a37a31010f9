"""The port's BayesR pieces against jwas_tpu: the inner-rounds chain, the
grouped sweep and the samplers.

Inputs are made with numpy from a seed; JAX's own Gumbel and normal panels
are handed to the port, so both compute the same chain. Tolerances are
those of tests/test_pallas_sweep.py:76-80 (float32, same update order; only
the log implementations differ): class labels exactly equal, alpha rtol
1e-5 atol 1e-6, rhs and ycorr rtol 1e-4 atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import grouped as jgr
from jwas_tpu.ops import variance as jvar
from jwas_tpu.ops.pallas_sweep import bayesr_inner_rounds_pallas
from jwas_tpu_torch.engine.convert import from_jax_arrays
from jwas_tpu_torch.io.packed import pack_codes
from jwas_tpu_torch.ops import grouped as tgr
from jwas_tpu_torch.ops import variance as tvar
from jwas_tpu_torch.ops.inner_rounds import (bayesr_inner_rounds,
                                             bayesr_inner_rounds_ref)

PI = np.array([0.95, 0.03, 0.015, 0.005], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _chain_problem(nblocks, b, seed):
    """Block-major numpy inputs: Grams of n = 4b random observations, a few
    markers in each slab class; the last 3 markers are padding (zero Gram
    rows, xpx 1, rhs 0, class priors [1, 0, 0, 0] before the log)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nblocks, b, 4 * b)).astype(np.float32)
    x[-1, -3:] = 0.0
    grams = np.einsum("kjn,krn->kjr", x, x).astype(np.float32)
    xpx = np.einsum("kjj->kj", grams).copy()
    xpx[-1, -3:] = 1.0
    rhs = np.einsum("kjn,n->kj", x, rng.normal(size=4 * b)).astype(np.float32)
    delta = rng.choice(4, size=(nblocks, b), p=PI).astype(np.int32)
    alpha = np.where(delta > 0, 0.1 * rng.normal(size=(nblocks, b)), 0.0)
    pi = np.broadcast_to(PI, (nblocks, b, 4)).copy()
    pi[-1, -3:] = [1.0, 0.0, 0.0, 0.0]
    delta[-1, -3:] = 0
    alpha[-1, -3:] = 0.0
    return dict(grams=grams, xpx=xpx,
                log_pi=np.log(np.clip(pi, 1e-12, 1.0)).astype(np.float32),
                alpha=alpha.astype(np.float32), delta=delta, rhs=rhs)


def test_ref_matches_pallas_interpret():
    """bayesr_inner_rounds_ref fed the panels the Pallas wrapper draws from
    its keys; the CPU wrapper is the plain version and launches nothing."""
    b, inv_vare, sigma_sq = 8, np.float32(1.0 / 1.3), np.float32(0.05)
    for nblocks, nreps in ((128, 1), (128, 3), (256, 1), (256, 3)):
        inp = _chain_problem(nblocks, b, seed=nblocks + nreps)
        kg, kz = jax.random.split(jax.random.PRNGKey(nblocks * nreps))
        a, d, r = bayesr_inner_rounds_pallas(
            jnp.asarray(np.transpose(inp["grams"], (1, 2, 0))),
            jnp.asarray(inp["xpx"].T),
            jnp.asarray(np.transpose(inp["log_pi"], (1, 0, 2))),
            jnp.asarray(inp["alpha"].T), jnp.asarray(inp["delta"].T),
            jnp.asarray(inp["rhs"].T), jnp.float32(inv_vare),
            jnp.float32(sigma_sq), kg, kz, nreps=nreps, interpret=True)
        draws = dict(
            gumbel=np.asarray(jax.random.gumbel(kg, (nreps * b, nblocks, 4))),
            zs=np.asarray(jax.random.normal(kz, (nreps * b, nblocks))),
            inv_vare=np.asarray([inv_vare]), sigma_sq=np.asarray([sigma_sq]))
        t = {k: torch.from_numpy(v.copy()) for k, v in {**inp, **draws}.items()}
        bayesr_inner_rounds_ref(**t, nreps=nreps)
        np.testing.assert_array_equal(t["delta"].numpy(), np.asarray(d).T)
        np.testing.assert_allclose(t["alpha"].numpy(), np.asarray(a).T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["rhs"].numpy(), np.asarray(r).T,
                                   rtol=1e-4, atol=1e-5)
        labels = t["delta"].numpy()
        assert 0.01 < (labels > 0).mean() < 0.2, (labels > 0).mean()
        assert (labels[-1, -3:] == 0).all() and (t["alpha"].numpy()[-1, -3:] == 0).all()

    t2 = {k: v.clone() for k, v in t.items()}
    before = bayesr_inner_rounds.launches
    bayesr_inner_rounds(**t, nreps=nreps)
    bayesr_inner_rounds_ref(**t2, nreps=nreps)
    assert bayesr_inner_rounds.launches == before
    for k in ("alpha", "delta", "rhs"):
        assert torch.equal(t[k], t2[k])


def _grouped_problem(n=50, p=96, b=8, gb=4, seed=0):
    """3 groups of gb blocks; missing codes and a row permutation."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, p)).astype(np.uint8)
    means = np.array([c[c < 3].mean() for c in codes.T], np.float32)
    perm = rng.permutation(n)
    store3 = pack_codes(codes).reshape(p // (b * gb), b * gb, -1)
    valid = np.ones(p, np.float32)
    grams, xpx = jgr.grouped_stats(
        jnp.asarray(store3), jnp.asarray(means), jnp.asarray(valid),
        jnp.asarray(perm, jnp.int32), None, b, n)
    gmj = jgr.GroupedPackedMarkers(
        store=jnp.asarray(store3), means=jnp.asarray(means),
        row_perm=jnp.asarray(perm, jnp.int32), xpx=xpx, grams=grams,
        valid=jnp.asarray(valid))
    return gmj, store3, means, valid, perm, n


def test_sweep_matches_jax_with_injected_draws():
    """3 groups, missing codes, permuted observations; a remainder round
    (5 reps, sync every 2) and one round of all reps. The JAX draws come in
    through the `draws` hook as fold_in(fold_in(key, g), r) -> split ->
    gumbel / normal (jwas_tpu/ops/grouped.py:704-716, 732)."""
    gmj, store3, means, valid, perm, n = _grouped_problem(seed=6)
    assert store3.shape[0] == 3
    b, gb = 8, 4
    key = jax.random.PRNGKey(3)

    def draws(g, r, reps):
        kg, kz = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, g), r))
        return (torch.from_numpy(np.array(jax.random.gumbel(kg, (reps * b, gb, 4)))),
                torch.from_numpy(np.array(jax.random.normal(kz, (reps * b, gb)))))

    for nreps, sync_every in ((5, 2), (4, None)):
        rng = np.random.default_rng(7)
        p = valid.shape[0]
        delta = rng.choice(4, size=p, p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
        alpha = np.where(delta > 0, 0.05 * rng.normal(size=p), 0.0).astype(np.float32)
        y = rng.normal(size=n).astype(np.float32)
        pi_mat = np.broadcast_to(np.array([0.7, 0.1, 0.1, 0.1], np.float32), (p, 4))
        vare, sigma_sq = np.float32(1.1), np.float32(0.05)
        ref = jgr.sweep_blocks_bayesr_grouped(
            gmj, jnp.asarray(alpha), jnp.asarray(delta), jnp.asarray(y), None,
            jnp.asarray(vare), jnp.asarray(sigma_sq), jnp.asarray(pi_mat), key,
            nreps=nreps, sync_every=sync_every)
        gm, st = from_jax_arrays(store3, means, valid, gmj.xpx, gmj.grams, n,
                                 perm, alpha=alpha, delta=delta, ycorr=y,
                                 pi_mat=pi_mat, vare=vare, sigma_sq=sigma_sq)
        got = tgr.sweep_blocks_bayesr_grouped(
            gm, st["alpha"], st["delta"], st["ycorr"], st["vare"],
            st["sigma_sq"], st["pi_mat"], None, nreps=nreps,
            sync_every=sync_every, draws=draws)
        a, d, yc = (np.asarray(x) for x in ref)
        np.testing.assert_array_equal(got[1].numpy(), d)
        assert len(np.unique(d)) == 4
        np.testing.assert_allclose(got[0].numpy(), a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), yc, rtol=1e-4, atol=1e-5)


def test_samplers():
    """sigma^2 sufficient statistics equal JAX's (ssq to float32 summation
    order); the Dirichlet class counts skip padded markers, shown by the
    sample mean of 4,000 pi draws within 4 sd of (counts + 1) / sum."""
    rng = np.random.default_rng(11)
    p = 3000
    delta = rng.integers(0, 4, size=p).astype(np.int32)
    alpha = np.where(delta > 0, rng.normal(size=p), 0.0).astype(np.float32)
    ssq, nnz = tvar.bayesr_sigma_sufficient_statistics(
        torch.from_numpy(alpha), torch.from_numpy(delta))
    jssq, jnnz = jvar.bayesr_sigma_sufficient_statistics(
        jnp.asarray(alpha), jnp.asarray(delta))
    np.testing.assert_allclose(ssq.item(), float(jssq), rtol=1e-5)
    assert nnz.item() == int(jnnz)

    # 200 real markers with counts (150, 30, 15, 5); 100 padded ones in class
    # 3 would move its share from 6/204 to 106/304 if they were counted
    delta = np.repeat(np.arange(4), (150, 30, 15, 105)).astype(np.int32)
    valid = np.r_[np.ones(200), np.zeros(100)].astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    draws = torch.stack([tvar.sample_pi_bayesr(gen, torch.from_numpy(delta),
                                               torch.from_numpy(valid))
                         for _ in range(4000)]).numpy()
    conc = np.array([150, 30, 15, 5]) + 1.0
    a0 = conc.sum()
    mean = conc / a0
    sd = np.sqrt(conc * (a0 - conc) / (a0 ** 2 * (a0 + 1)) / len(draws))
    assert np.all(np.abs(draws.mean(axis=0) - mean) < 4 * sd), (draws.mean(0), mean)
    np.testing.assert_allclose(draws.sum(axis=1), 1.0, rtol=1e-5)
