"""The window schedule of the multi-trait chains K7 and K8
(csrc/mt_inner_rounds.cu) in plain PyTorch.

ops/inner_rounds.py::mt_abc_inner_rounds_window_ref runs samplers I and II
on the kernels' schedule: a window's 32 markers evaluate together, those
before the first one whose t values of d = a_old - a_new are not all zero
commit at once, that one hands d on and the rest evaluate again; a
window's changes reach the other rows at its end. It must equal the
sequential plain version (ops/multitrait.py::mt_abc_inner_rounds_ref) bit
for bit, which is what lets the kernels keep the sequential chain's
result; here on the CPU at t = 2, 3, 4 and 6, with a shared and a
per-locus Ginv, padding markers, a ragged b, a single block with one rep
(the exact form), float32 and float64, in a dense regime (a third of the
indicators on) and a sparse one (the all-out pattern at prior 0.99, from
alpha = 0), where its counts show fewer evaluations than steps.

Then the model against jwas_tpu's mt_abc_blocks_I / _II under
grouped_dense_sweep on jwas_tpu's own draws (the window model in place of
the kernels' plain version in the port's grouped sweep), at the
tolerances of tests/test_pallas_sweep.py:42-45, as
tests/test_torch_multitrait.py holds the sequential chain.

A per-marker pattern prior (2-trait annotated BayesC's, one (2^t,) row a
marker; csrc/mt_inner_rounds_pm.cu): the window model equals the
sequential chain with it too, at t = 2 and 3; rows that all equal one
global vector give the global form's bits; and the marker updates, the
blocked sweeps and the exact forms with a 2-D pi hold against jwas_tpu's
(_take_logpi, multitrait.py:38-43) at the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import markers as jmk
from jwas_tpu.ops import multitrait as jmt
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks
from jwas_tpu_torch.ops import inner_rounds as ir
from jwas_tpu_torch.ops import multitrait as tmt
from test_torch_multitrait import (TOL_STATE, TOL_YCORR, _draws, _pi, _problem,
                                   _start, _t)

STATE = ("alpha", "beta", "delta", "rhs")


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; the comparisons with jwas_tpu are float32."""
    jax.config.update("jax_enable_x64", False)


def chain_inputs(t, b, nblocks, nreps, sampler, per_locus, seed, dtype,
                 regime="dense", n_padding=3, per_marker=False):
    """K7 / K8 inputs made with numpy: Gram tiles of 4b-observation blocks,
    the last n_padding markers of the last block padding (valid 0, zero
    Gram rows, xpx 1), Rinv, Ginv (shared or one a locus), the draws of
    nreps rounds (uniforms for sampler I, Gumbels for II). regime "dense":
    random pattern priors, a third of the indicators on; "sparse": the
    all-out pattern at prior 0.99, every effect 0, and 4% of the markers
    with an effect of sd 0.5 in the data, which some steps include.
    per_marker: log_pi (nblocks, b, 2^t), each row the regime's prior
    reweighted at random (the padding's [1, 0, ..] clipped to 1e-12)."""
    rng = np.random.default_rng(seed)
    S = 2 ** t
    x = rng.normal(size=(nblocks, b, 4 * b))
    if n_padding:
        x[-1, -n_padding:] = 0.0
    grams = x @ x.transpose(0, 2, 1)
    xpx = np.diagonal(grams, axis1=1, axis2=2).copy()
    valid = np.ones((nblocks, b))
    if n_padding:
        xpx[-1, -n_padding:], valid[-1, -n_padding:] = 1.0, 0.0
    rhs = (x @ rng.normal(size=(nblocks, 4 * b, t))).transpose(0, 2, 1)
    beta = 0.05 * rng.normal(size=(nblocks, t, b))
    A, B = rng.normal(size=(t, t)), rng.normal(size=(t, t))
    Ginv = np.linalg.inv(0.002 * (B @ B.T / t + np.eye(t)))
    if per_locus:
        Ginv = Ginv * rng.uniform(0.5, 2.0, (nblocks, b, 1, 1))
    if regime == "sparse":
        qtl = rng.uniform(size=(nblocks, b, 1)) < 0.04
        rhs += (grams @ (qtl * 0.5 * rng.normal(size=(nblocks, b, t)))).transpose(0, 2, 1)
        delta = np.zeros((nblocks, t, b))
        pi = np.full(S, 0.01 / (S - 1))
        pi[0] = 0.99
    else:
        delta = (rng.uniform(size=(nblocks, t, b)) < 1 / 3) * valid[:, None]
        pi = rng.uniform(0.2, 1.2, S)
        pi /= pi.sum()
    log_pi = np.log(pi)
    if per_marker:
        rows = pi * rng.uniform(0.3, 3.0, (nblocks, b, S))
        rows /= rows.sum(-1, keepdims=True)
        rows[valid == 0] = np.r_[1.0, np.full(S - 1, 1e-12)]
        log_pi = np.log(rows)
    u = rng.uniform(size=(nreps * b, t if sampler == "I" else S, nblocks))
    inp = dict(grams=grams, xpx=xpx, valid=valid, alpha=beta * delta, beta=beta,
               delta=delta, rhs=rhs, Rinv=np.linalg.inv(A @ A.T / t + np.eye(t)),
               Ginv=Ginv, log_pi=log_pi,
               draw_a=u if sampler == "I" else -np.log(-np.log(u)),
               zs=rng.normal(size=(nreps * b, t, nblocks)))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
            for k, v in inp.items()}


F32, F64 = torch.float32, torch.float64
# t, b, nblocks, nreps, per_locus, dtype, regime, n_padding
CASES = [
    (2, 40, 3, 2, False, F32, "dense", 3),
    (3, 64, 3, 2, True, F32, "dense", 3),
    (3, 136, 2, 2, False, F64, "dense", 17),     # a ragged b: a last window of 8
    (4, 48, 2, 2, True, F64, "dense", 3),
    (3, 64, 1, 1, False, F32, "dense", 0),       # the exact form's single block
    (6, 36, 2, 1, True, F32, "dense", 3),
    (3, 64, 3, 2, False, F32, "sparse", 3),
    (4, 40, 2, 2, True, F64, "sparse", 5),
]


@pytest.mark.parametrize("sampler", ["I", "II"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"t{c[0]}-b{c[1]}-{c[6]}")
def test_window_model_equals_the_sequential_chain(sampler, case):
    t, b, nblocks, nreps, per_locus, dtype, regime, n_padding = case
    inp = chain_inputs(t, b, nblocks, nreps, sampler, per_locus, 31 + t, dtype,
                       regime, n_padding)
    w = {k: v.clone() for k, v in inp.items()}
    r = {k: v.clone() for k, v in inp.items()}
    stats = {}
    ir.mt_abc_inner_rounds_window_ref(sampler, **w, nreps=nreps, stats=stats)
    tmt.mt_abc_inner_rounds_ref(sampler, **r, nreps=nreps)
    for k in STATE:
        assert torch.equal(w[k], r[k]), k
    assert not torch.equal(w["beta"], inp["beta"])
    if n_padding:
        assert not w["alpha"][-1, :, -n_padding:].any()
        assert not w["delta"][-1, :, -n_padding:].any()
    steps = nreps * b * nblocks
    assert stats["windows"] == nreps * nblocks * -(-b // 32)
    assert stats["changes"] <= stats["evaluations"]
    if regime == "sparse":
        assert 0 < stats["changes"] < steps / 4
        assert stats["evaluations"] < steps / 2
    else:
        assert stats["changes"] > steps / 2


@pytest.mark.parametrize("sampler", ["I", "II"])
@pytest.mark.parametrize("t,per_locus,nreps,sync_every", [(3, False, 3, 2), (2, True, 2, None)])
def test_window_model_matches_jax(monkeypatch, sampler, t, per_locus, nreps, sync_every):
    """The port's grouped sweep with the window model as its chain against
    grouped_dense_sweep over mt_abc_blocks_I / _II, on jwas_tpu's draws:
    b = 32 over 6 blocks (p = 180, the last block ragged), gb = 3."""
    n, p, b = 330, 180, 32
    rng, X, rinv, R, G = _problem(n, p, t, seed=60 + t)
    key = jax.random.PRNGKey(70 + t)
    md = jmk.build_marker_blocks(jnp.asarray(X), jnp.asarray(rinv), block_size=b)
    nblocks = md.grams.shape[2]
    gb = jmk.stable_group_blocks(n, b, nblocks)
    assert (nblocks, gb) == (6, 3)
    pp = nblocks * b
    alpha, beta, delta = _start(rng, t, pp, p)
    y = rng.normal(size=(t, n)).astype(np.float32)
    pi = _pi(t, rng)
    ginv = np.linalg.inv(G).astype(np.float32)
    if per_locus:
        ginv = (ginv[None] * rng.uniform(0.5, 2.0, pp)[:, None, None]).astype(np.float32)
    sweep = jmt.mt_abc_blocks_I if sampler == "I" else jmt.mt_abc_blocks_II

    def cg(md_g, sts, yc, g, kg):
        gi = jnp.moveaxis(sts[3], -1, 0) if per_locus else jnp.asarray(ginv)
        a, be, d, yc = sweep(md_g, *sts[:3], yc, jnp.asarray(rinv), jnp.asarray(R), gi,
                             jnp.asarray(pi), kg, nreps=nreps, sync_every=sync_every)
        return (a, be, d) + sts[3:], yc

    sts = (jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(delta))
    if per_locus:
        sts += (jnp.moveaxis(jnp.asarray(ginv), 0, -1),)
    out, yc = jmk.grouped_dense_sweep(cg, md, sts, jnp.asarray(y), key, gb)

    calls = []

    def window_chain(*args):
        calls.append(args[0].shape)
        return ir.mt_abc_inner_rounds_window_ref(sampler, *args)

    monkeypatch.setattr(ir, f"mt_abc_inner_rounds_{sampler}", window_chain)
    dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=rinv)
    a, be, d, ycr = _t(alpha), _t(beta), _t(delta), _t(y)
    tmt.sweep_blocks_mt_abc_grouped(
        dm, a, be, d, ycr, _t(R), _t(ginv), _t(pi), None, sampler=sampler,
        nreps=nreps, sync_every=sync_every, draws=_draws(key, b, gb, t, sampler))
    rounds = 1 if sync_every is None else -(-nreps // sync_every)
    assert calls == [(gb, b, b)] * (nblocks // gb) * rounds
    np.testing.assert_array_equal(d.numpy(), np.asarray(out[2]))
    np.testing.assert_allclose(a.numpy(), np.asarray(out[0]), **TOL_STATE)
    np.testing.assert_allclose(be.numpy()[:, :p], np.asarray(out[1])[:, :p], **TOL_STATE)
    np.testing.assert_allclose(ycr.numpy(), np.asarray(yc), **TOL_YCORR)


def test_blocks_above_the_kernels_limit_are_refused():
    """K7 and K8 take blocks of up to 2,048 markers: a multi-trait BayesC
    with fast_blocks above that is refused at set-up with a
    NotImplementedError naming its ROADMAP item, on the CPU as on the card;
    the mega-trait chain (K1 a trait) is not refused by it: its set-up
    builds a block of 4,096."""
    import jwas_tpu_torch as jt

    rng = np.random.default_rng(5)
    n = 40
    X = rng.integers(0, 3, (n, 12)).astype(float)
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(n)], dtype=object),
                      "y1": rng.normal(size=n), "y2": rng.normal(size=n)})
    eq = "y1 = intercept + geno\ny2 = intercept + geno"
    geno = jt.get_genotypes(X, method="BayesC", device="cpu")
    for fast_blocks in (tmt.MAX_BLOCK + 8, 4096):
        with pytest.raises(NotImplementedError,
                           match="samplers I and II above 2,048 markers a block"):
            jt.runMCMC(jt.build_model(eq, genotypes=geno), table, device="cpu",
                       chain_length=2, output_folder="", printout_model_info=False,
                       fast_blocks=fast_blocks)
    with pytest.raises(NotImplementedError, match="2,048 markers a block"):
        tmt.check_block_size(tmt.MAX_BLOCK + 1)
    tmt.check_block_size(tmt.MAX_BLOCK)
    # the mega-trait chain runs K1 a trait, which the block limit leaves alone
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    mega = jt.get_genotypes(X, method="BayesC", device="cpu", constraint=True)
    opts = MCMCOptions(chain_length=2, output_folder="", fast_blocks=4096)
    ws = prepare_workspace(jt.build_model(eq, genotypes=mega), table, opts, device="cpu")
    cfg, data, _ = tm.build_mt_data_and_state(ws, opts, "cpu")
    assert cfg.constraint and data.gm.grams.shape[1] == 4096


def _two_trait_run(sampler, fast_blocks):
    import jwas_tpu_torch as jt

    rng = np.random.default_rng(6)
    n = 40
    X = rng.integers(0, 3, (n, 12)).astype(float)
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(n)], dtype=object),
                      "y1": rng.normal(size=n), "y2": rng.normal(size=n)})
    geno = jt.get_genotypes(X, method="BayesC", device="cpu", multi_trait_sampler=sampler)
    model = jt.build_model("y1 = intercept + geno\ny2 = intercept + geno", genotypes=geno)
    return jt.runMCMC(model, table, device="cpu", chain_length=2, output_folder="",
                      printout_model_info=False, fast_blocks=fast_blocks)


@pytest.mark.parametrize("sampler", ["I", "II"])
def test_constants_scratch_above_a_quarter_of_the_card_is_refused(sampler, monkeypatch):
    """A group round's call allocates nblocks x ceil(b / 32) x 32 x E
    values of constants (E = t (8 + 3 (t - 1)) for sampler I, 2^t (t (t + 1)
    + 1) for II); set-up refuses a model whose scratch would take more than
    a quarter of the card (JWAS_HBM_BYTES stands in for it here) with a
    NotImplementedError naming its ROADMAP item, and runs it below."""
    assert tmt.scratch_values("I", 3, 256, 23) == 23 * 256 * 3 * 14
    assert tmt.scratch_values("II", 3, 136, 8) == 8 * 160 * 8 * 13
    # t = 8, b = 2,048, 128 blocks a group in float64 (~39 GB) on an 80 GB
    # card: refused; t = 4 at 256 blocks (~1.4 GB): taken
    with pytest.raises(NotImplementedError, match="scratch above a quarter of the card"):
        tmt.check_scratch("II", 8, 2048, 128, 8, int(80e9))
    tmt.check_scratch("II", 4, 2048, 256, 8, int(80e9))
    e = 2 * (8 + 3) if sampler == "I" else 4 * 7
    nbytes = 64 * e * 4                  # b = 64, one block of 12 markers, float32
    monkeypatch.setenv("JWAS_HBM_BYTES", str(4 * nbytes - 4))
    with pytest.raises(NotImplementedError, match="scratch above a quarter of the card"):
        _two_trait_run(sampler, 64)
    monkeypatch.setenv("JWAS_HBM_BYTES", str(4 * nbytes))
    _two_trait_run(sampler, 64)


# t, b, nblocks, nreps, per_locus, dtype, regime, n_padding
PM_CASES = [
    (2, 40, 3, 2, False, F32, "dense", 3),
    (3, 136, 2, 2, False, F64, "dense", 17),
    (2, 64, 3, 2, False, F32, "sparse", 3),
]


@pytest.mark.parametrize("sampler", ["I", "II"])
@pytest.mark.parametrize("case", PM_CASES, ids=lambda c: f"t{c[0]}-b{c[1]}-{c[6]}")
def test_window_model_equals_the_sequential_chain_with_a_per_marker_prior(sampler, case):
    t, b, nblocks, nreps, per_locus, dtype, regime, n_padding = case
    inp = chain_inputs(t, b, nblocks, nreps, sampler, per_locus, 51 + t, dtype,
                       regime, n_padding, per_marker=True)
    assert inp["log_pi"].shape == (nblocks, b, 2 ** t)
    w = {k: v.clone() for k, v in inp.items()}
    r = {k: v.clone() for k, v in inp.items()}
    ir.mt_abc_inner_rounds_window_ref(sampler, **w, nreps=nreps)
    tmt.mt_abc_inner_rounds_ref(sampler, **r, nreps=nreps)
    for k in STATE:
        assert torch.equal(w[k], r[k]), k
    assert not torch.equal(w["beta"], inp["beta"])
    # the rows matter: the global prior of the same regime gives another chain
    g = chain_inputs(t, b, nblocks, nreps, sampler, per_locus, 51 + t, dtype, regime,
                     n_padding)
    tmt.mt_abc_inner_rounds_ref(sampler, **g, nreps=nreps)
    assert not torch.equal(g["delta"], r["delta"])


@pytest.mark.parametrize("sampler", ["I", "II"])
def test_per_marker_rows_equal_to_the_global_prior_give_its_bits(sampler):
    t, b, nblocks, nreps = 3, 64, 3, 2
    inp = chain_inputs(t, b, nblocks, nreps, sampler, False, 58, F32)
    pm = {k: v.clone() for k, v in inp.items()}
    pm["log_pi"] = inp["log_pi"].expand(nblocks, b, 2 ** t).contiguous()
    ir.mt_abc_inner_rounds_window_ref(sampler, **pm, nreps=nreps)
    tmt.mt_abc_inner_rounds_ref(sampler, **inp, nreps=nreps)
    for k in STATE:
        assert torch.equal(pm[k], inp[k]), k


@pytest.mark.parametrize("t", [2, 3])
def test_per_marker_marker_updates_match_jax(t):
    """Both samplers' marker updates with a (B, 2^t) log pi, one row a
    marker, against _mt_abc_marker_update_I / _II (_take_logpi's
    per-marker branch)."""
    B = 64
    rng = np.random.default_rng(90 + t)
    A, Bm = rng.normal(size=(t, t)), rng.normal(size=(t, t))
    Rinv = np.linalg.inv(A @ A.T / t + np.eye(t)).astype(np.float32)
    Ginv = np.linalg.inv(0.02 * (Bm @ Bm.T / t + np.eye(t))).astype(np.float32)
    xpx = rng.uniform(20.0, 80.0, B).astype(np.float32)
    w = (rng.normal(size=(t, B)) * rng.uniform(0.1, 8.0, B)).astype(np.float32)
    beta = (0.2 * rng.normal(size=(t, B))).astype(np.float32)
    delta = rng.integers(0, 2, size=(t, B)).astype(np.float32)
    rows = rng.dirichlet(np.ones(2 ** t), B)
    log_pi = np.log(np.clip(rows, 1e-12, 1.0)).astype(np.float32)     # (B, S)
    us = rng.uniform(size=(t, B)).astype(np.float32)
    zs = rng.normal(size=(t, B)).astype(np.float32)
    gum = rng.gumbel(size=(2 ** t, B)).astype(np.float32)
    J = jnp.asarray
    jb, jd, ja = jmt._mt_abc_marker_update_I(J(w), J(beta), J(delta), J(beta * delta),
                                             J(xpx), J(Rinv), J(Ginv), J(log_pi), J(us),
                                             J(zs))
    pb, pd, pa = tmt.mt_marker_update_I_ref(_t(w.T), _t(beta.T), _t(delta.T),
                                            _t((beta * delta).T), _t(xpx), _t(Rinv),
                                            _t(Ginv), _t(log_pi), _t(us.T), _t(zs.T))
    np.testing.assert_array_equal(pd.numpy().T, np.asarray(jd))
    np.testing.assert_allclose(pb.numpy().T, np.asarray(jb), **TOL_STATE)
    np.testing.assert_allclose(pa.numpy().T, np.asarray(ja), **TOL_STATE)
    jb, jd, ja = jmt._mt_abc_marker_update_II(J(w), J(xpx), J(Rinv), J(Ginv), J(log_pi),
                                              jmt.all_patterns(t), J(gum), J(zs))
    pb, pd, pa = tmt.mt_marker_update_II_ref(_t(w.T), _t(xpx), _t(Rinv), _t(Ginv),
                                             _t(log_pi), _t(gum.T), _t(zs.T))
    np.testing.assert_array_equal(pd.numpy().T, np.asarray(jd))
    np.testing.assert_allclose(pb.numpy().T, np.asarray(jb), **TOL_STATE)
    assert len(np.unique(np.asarray(jmt.pattern_index(jd)))) > 2


def _per_marker_pi(rng, t, pp, p):
    rows = rng.dirichlet(np.ones(2 ** t), pp)
    rows[p:] = np.r_[1.0, np.zeros(2 ** t - 1)]
    return rows.astype(np.float32)


@pytest.mark.parametrize("sampler", ["I", "II"])
@pytest.mark.parametrize("t", [2, 3])
def test_per_marker_blocked_sweep_matches_jax(sampler, t):
    """The grouped sweep with a (p_pad, 2^t) pi through the window model
    against grouped_dense_sweep over mt_abc_blocks_I / _II with the
    per-marker pi carried with the group (jwas_tpu/engine/mcmc_mt.py:
    263-299), on jwas_tpu's draws: b = 32, 6 blocks, gb = 3."""
    n, p, b, nreps = 330, 180, 32, 2
    rng, X, rinv, R, G = _problem(n, p, t, seed=80 + t)
    key = jax.random.PRNGKey(81 + t)
    md = jmk.build_marker_blocks(jnp.asarray(X), jnp.asarray(rinv), block_size=b)
    nblocks = md.grams.shape[2]
    gb = jmk.stable_group_blocks(n, b, nblocks)
    pp = nblocks * b
    alpha, beta, delta = _start(rng, t, pp, p)
    y = rng.normal(size=(t, n)).astype(np.float32)
    pi = _per_marker_pi(rng, t, pp, p)
    ginv = np.linalg.inv(G).astype(np.float32)
    sweep = jmt.mt_abc_blocks_I if sampler == "I" else jmt.mt_abc_blocks_II

    def cg(md_g, sts, yc, g, kg):
        a, be, d, yc = sweep(md_g, *sts[:3], yc, jnp.asarray(rinv), jnp.asarray(R),
                             jnp.asarray(ginv), sts[3].T, kg, nreps=nreps)
        return (a, be, d, sts[3]), yc

    sts = (jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(delta), jnp.asarray(pi.T))
    out, yc = jmk.grouped_dense_sweep(cg, md, sts, jnp.asarray(y), key, gb)

    def window_chain(*args):
        assert args[9].shape == (gb, b, 2 ** t)          # the per-marker log pi
        return ir.mt_abc_inner_rounds_window_ref(sampler, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ir, f"mt_abc_inner_rounds_{sampler}", window_chain)
        dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=rinv)
        a, be, d, ycr = _t(alpha), _t(beta), _t(delta), _t(y)
        tmt.sweep_blocks_mt_abc_grouped(
            dm, a, be, d, ycr, _t(R), _t(ginv), _t(pi), None, sampler=sampler,
            nreps=nreps, draws=_draws(key, b, gb, t, sampler))
    np.testing.assert_array_equal(d.numpy(), np.asarray(out[2]))
    np.testing.assert_allclose(a.numpy(), np.asarray(out[0]), **TOL_STATE)
    np.testing.assert_allclose(be.numpy()[:, :p], np.asarray(out[1])[:, :p], **TOL_STATE)
    np.testing.assert_allclose(ycr.numpy(), np.asarray(yc), **TOL_YCORR)


@pytest.mark.parametrize("sampler", ["I", "II"])
def test_per_marker_exact_sweep_matches_jax(sampler):
    """p = 70 in chunks of b = 32, t = 2: the grouped sweep over a store of
    one block a group (nreps = 1) with a (p_pad, 4) pi against
    mt_abc_exact_I / _II with the (p, 4) one."""
    from jwas_tpu_torch.ops import dense as td

    n, p, t, b = 50, 70, 2, 32
    rng, X, rinv, R, G = _problem(n, p, t, seed=45)
    key = jax.random.PRNGKey(46)
    dm = td.build_dense_markers(_t(np.ascontiguousarray(X.T)), n, b, 1, rinv=_t(rinv),
                                exact=True)
    pp = dm.valid.shape[0]
    alpha, beta, delta = _start(rng, t, p, p)
    y = rng.normal(size=(t, n)).astype(np.float32)
    pi = _per_marker_pi(rng, t, pp, p)
    ginv = np.linalg.inv(G).astype(np.float32)
    xpx = np.einsum("np,np->p", X * rinv[:, None], X)
    sweep = jmt.mt_abc_exact_I if sampler == "I" else jmt.mt_abc_exact_II
    ra, rb, rd, ryc = sweep(jnp.asarray(X), jnp.asarray(xpx), jnp.asarray(alpha),
                            jnp.asarray(beta), jnp.asarray(delta), jnp.asarray(y),
                            jnp.asarray(rinv), jnp.asarray(R), jnp.asarray(ginv),
                            jnp.asarray(pi[:p]), key)
    ka, kz = jax.random.split(key)
    panel_a = (jax.random.uniform(ka, (p, t, 1)) if sampler == "I"
               else jax.random.gumbel(ka, (p, 2 ** t, 1)))
    zs = jax.random.normal(kz, (p, t, 1))

    def pad(x):
        out = np.zeros((x.shape[0], pp), np.float32)
        out[:, :p] = x
        return _t(out)

    a, be, d, ycr = pad(alpha), pad(beta), pad(delta), _t(y)
    draws = td.sweep_draws(b, _t(panel_a)[..., 0], _t(zs)[..., 0])
    tmt.sweep_blocks_mt_abc_grouped(
        dm, a, be, d, ycr, _t(R), _t(ginv), _t(pi), None, sampler=sampler, nreps=1,
        draws=lambda g, r, reps: tuple(x.mT for x in draws(g, r, reps)))
    np.testing.assert_array_equal(d.numpy()[:, :p], np.asarray(rd))
    np.testing.assert_allclose(a.numpy()[:, :p], np.asarray(ra), **TOL_STATE)
    np.testing.assert_allclose(be.numpy()[:, :p], np.asarray(rb), **TOL_STATE)
    np.testing.assert_allclose(ycr.numpy(), np.asarray(ryc), **TOL_YCORR)


def test_a_per_marker_prior_above_four_traits_is_refused():
    """K7 and K8 take a per-marker prior for t <= 4
    (ops/multitrait.py::MAX_PRIOR_TRAITS): a larger one is refused with
    the ROADMAP item that would bring it, before anything runs."""
    with pytest.raises(NotImplementedError, match="per-marker pattern prior above 4"):
        tmt.check_prior_traits(5)
    tmt.check_prior_traits(4)
