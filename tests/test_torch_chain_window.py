"""The window schedule of the port's inner-rounds kernels, in plain PyTorch.

The CUDA kernels (jwas_tpu_torch/csrc/smem_plan.cuh::run_chain) do not walk
a block's markers one step at a time: the 32 markers of a warp evaluate
their updates together, the markers up to the first one whose effect
changes commit at once, and a window's changes reach the other rows at the
window's end. abc_inner_rounds_window_ref and bayesr_inner_rounds_window_ref
model that schedule; here they are held against the step-by-step plain
versions with torch.equal on every output (the schedules must agree bit for
bit: each rhs receives the same additions in the same order), and against
jwas_tpu's Pallas kernels in interpret mode on the same injected draws with
the tolerances of tests/test_pallas_sweep.py:42-45 (float32, same update
order; only exp/log differ): alpha and beta rtol 1e-5 atol 1e-6, rhs rtol
1e-4 atol 1e-5, inclusion indicators and BayesR class labels exactly equal.
Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops.pallas_sweep import (abc_inner_rounds_pallas,
                                       bayesr_inner_rounds_pallas)
from jwas_tpu_torch.ops.inner_rounds import (abc_inner_rounds_ref,
                                             abc_inner_rounds_window_ref,
                                             bayesr_inner_rounds_ref,
                                             bayesr_inner_rounds_window_ref)

SHAPES = ((8, 6, 3), (40, 4, 2), (128, 3, 2), (152, 2, 2))   # b, nblocks, nreps
REGIMES = ("dense", "null95", "null")


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _grams(rng, nblocks, b):
    x = rng.normal(size=(nblocks, b, 4 * b)).astype(np.float32)
    x[-1, -3:] = 0.0                                  # padded markers
    grams = np.einsum("kjn,krn->kjr", x, x).astype(np.float32)
    xpx = np.einsum("kjj->kj", grams).copy()
    xpx[-1, -3:] = 1.0
    rhs = np.einsum("kjn,n->kj", x, rng.normal(size=4 * b)).astype(np.float32)
    return grams, xpx, rhs


def _abc_problem(b, nblocks, nreps, regime, seed):
    """dense: every marker is included and moves each step; null95: 95% of
    the effects start at 0 under pi = 0.95; null: pi = 1, nothing moves."""
    rng = np.random.default_rng(seed)
    grams, xpx, rhs = _grams(rng, nblocks, b)
    pi0 = {"dense": 1e-10, "null95": 0.95, "null": 1.0}[regime]
    pi = np.full((nblocks, b), pi0, np.float32)
    pi[-1, -3:] = 1.0
    with np.errstate(divide="ignore"):               # log1p(-1) = -inf
        log_pi_comp = np.log1p(-pi + np.float32(1e-12))
    alpha = (0.1 * rng.normal(size=(nblocks, b))).astype(np.float32)
    alpha *= {"dense": 1.0, "null95": rng.uniform(size=alpha.shape) > 0.95,
              "null": 0.0}[regime]
    alpha[-1, -3:] = 0.0
    return dict(
        grams=grams, xpx=xpx, var_eff=np.full((nblocks, b), 0.02, np.float32),
        log_pi=np.log(pi), log_pi_comp=log_pi_comp, alpha=alpha,
        beta=alpha.copy(), delta=(alpha != 0).astype(np.int32), rhs=rhs,
        us=rng.uniform(size=(nreps * b, nblocks)).astype(np.float32),
        zs=rng.normal(size=(nreps * b, nblocks)).astype(np.float32),
        inv_vare=np.asarray([1.0 / 1.3], np.float32))


def _bayesr_problem(b, nblocks, nreps, regime, seed, draws=None):
    rng = np.random.default_rng(seed)
    grams, xpx, rhs = _grams(rng, nblocks, b)
    pi = np.array({"dense": [0.01, 0.33, 0.33, 0.33],
                   "null95": [0.95, 0.03, 0.015, 0.005],
                   "null": [1.0, 0.0, 0.0, 0.0]}[regime])
    delta = rng.choice(4, size=(nblocks, b), p=pi).astype(np.int32)
    delta[-1, -3:] = 0
    alpha = np.where(delta > 0, 0.1 * rng.normal(size=(nblocks, b)), 0.0)
    prior = np.broadcast_to(pi, (nblocks, b, 4)).copy()
    prior[-1, -3:] = [1.0, 0.0, 0.0, 0.0]
    if draws is None:
        u = rng.uniform(np.finfo(np.float32).tiny, 1.0,
                        size=(nreps * b, nblocks, 4))
        draws = (-np.log(-np.log(u)), rng.normal(size=(nreps * b, nblocks)))
    return dict(
        grams=grams, xpx=xpx,
        log_pi=np.log(np.clip(prior, 1e-12, 1.0)).astype(np.float32),
        alpha=alpha.astype(np.float32), delta=delta, rhs=rhs,
        gumbel=np.asarray(draws[0], np.float32),
        zs=np.asarray(draws[1], np.float32),
        inv_vare=np.asarray([1.0 / 1.3], np.float32),
        sigma_sq=np.asarray([0.05], np.float32))


def _torch(inp):
    return {k: torch.from_numpy(v.copy()) for k, v in inp.items()}


def test_abc_window_schedule_equals_sequential_chain():
    for b, nblocks, nreps in SHAPES:
        for regime in REGIMES:
            inp = _abc_problem(b, nblocks, nreps, regime, seed=b + nreps)
            seq, win, stats = _torch(inp), _torch(inp), {}
            abc_inner_rounds_ref(**seq, nreps=nreps)
            abc_inner_rounds_window_ref(**win, nreps=nreps, stats=stats)
            for name in ("alpha", "beta", "delta", "rhs"):
                assert torch.equal(seq[name], win[name]), (b, regime, name)
            nwin = nblocks * nreps * -(-b // 32)
            assert stats["windows"] == nwin
            if regime == "dense":     # every real marker changes every step
                assert stats["changes"] == (nblocks * b - 3) * nreps
            if regime == "null":      # one evaluation settles a window
                assert (stats["changes"], stats["evaluations"]) == (0, nwin)
                assert not win["alpha"].any() and not win["delta"].any()
            assert stats["evaluations"] <= stats["changes"] + nwin
            if regime == "null95" and b >= 128:
                assert 0 < stats["changes"] < 0.3 * nblocks * b * nreps
    # a window narrower than the warp's is the same chain too
    inp = _abc_problem(40, 3, 2, "null95", seed=1)
    seq, win = _torch(inp), _torch(inp)
    abc_inner_rounds_ref(**seq, nreps=2)
    abc_inner_rounds_window_ref(**win, nreps=2, window=8)
    for name in ("alpha", "beta", "delta", "rhs"):
        assert torch.equal(seq[name], win[name]), name


def test_bayesr_window_schedule_equals_sequential_chain():
    for b, nblocks, nreps in SHAPES:
        for regime in REGIMES:
            inp = _bayesr_problem(b, nblocks, nreps, regime, seed=b + nreps)
            seq, win, stats = _torch(inp), _torch(inp), {}
            bayesr_inner_rounds_ref(**seq, nreps=nreps)
            bayesr_inner_rounds_window_ref(**win, nreps=nreps, stats=stats)
            for name in ("alpha", "delta", "rhs"):
                assert torch.equal(seq[name], win[name]), (b, regime, name)
            nwin = nblocks * nreps * -(-b // 32)
            assert stats["windows"] == nwin
            assert stats["evaluations"] <= stats["changes"] + nwin
            if regime == "null":
                assert (stats["changes"], stats["evaluations"]) == (0, nwin)
            if regime == "dense":
                assert stats["changes"] > 0.9 * (nblocks * b - 3) * nreps
            if regime == "null95" and b >= 128:
                share = stats["changes"] / (nblocks * b * nreps)
                assert 0.01 < share < 0.3, share
            labels = win["delta"].numpy()
            assert (labels[-1, -3:] == 0).all()
            assert (win["alpha"].numpy()[-1, -3:] == 0).all()


def test_window_schedule_matches_pallas_interpret():
    """One case each: b = 8 (the Pallas kernels' test shape), 128 blocks,
    3 reps, the draws JAX makes."""
    b, nblocks, nreps = 8, 128, 3
    inp = _abc_problem(b, nblocks, nreps, "null95", seed=21)
    jm = {k: jnp.asarray(inp[k].T) for k in
          ("xpx", "var_eff", "log_pi", "log_pi_comp", "alpha", "beta",
           "delta", "rhs")}
    ref = abc_inner_rounds_pallas(
        jnp.asarray(np.transpose(inp["grams"], (1, 2, 0))), jm["xpx"],
        jm["var_eff"], jm["log_pi"], jm["log_pi_comp"], jm["alpha"],
        jm["beta"], jm["delta"], jm["rhs"], jnp.asarray(inp["us"]),
        jnp.asarray(inp["zs"]), jnp.float32(inp["inv_vare"][0]),
        nreps=nreps, interpret=True)
    a, be, d, r = (np.asarray(o).T for o in ref)
    t = _torch(inp)
    abc_inner_rounds_window_ref(**t, nreps=nreps)
    np.testing.assert_array_equal(t["delta"].numpy(), d)
    assert 0 < d.mean() < 0.5
    np.testing.assert_allclose(t["alpha"].numpy(), a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["beta"].numpy(), be, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["rhs"].numpy(), r, rtol=1e-4, atol=1e-5)

    kg, kz = jax.random.split(jax.random.PRNGKey(5))
    draws = (np.asarray(jax.random.gumbel(kg, (nreps * b, nblocks, 4))),
             np.asarray(jax.random.normal(kz, (nreps * b, nblocks))))
    inp = _bayesr_problem(b, nblocks, nreps, "null95", seed=22, draws=draws)
    a, d, r = bayesr_inner_rounds_pallas(
        jnp.asarray(np.transpose(inp["grams"], (1, 2, 0))),
        jnp.asarray(inp["xpx"].T),
        jnp.asarray(np.transpose(inp["log_pi"], (1, 0, 2))),
        jnp.asarray(inp["alpha"].T), jnp.asarray(inp["delta"].T),
        jnp.asarray(inp["rhs"].T), jnp.float32(inp["inv_vare"][0]),
        jnp.float32(inp["sigma_sq"][0]), kg, kz, nreps=nreps, interpret=True)
    t = _torch(inp)
    bayesr_inner_rounds_window_ref(**t, nreps=nreps)
    np.testing.assert_array_equal(t["delta"].numpy(), np.asarray(d).T)
    assert 0.01 < (np.asarray(d) > 0).mean() < 0.3
    np.testing.assert_allclose(t["alpha"].numpy(), np.asarray(a).T,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["rhs"].numpy(), np.asarray(r).T,
                               rtol=1e-4, atol=1e-5)
