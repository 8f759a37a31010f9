"""The port's multi-trait samplers against jwas_tpu's, fed the same draws.

Parity (b) of ROADMAP.md: the marker updates of samplers I and II
(ops/multitrait.py::mt_marker_update_I_ref / _II_ref against
_mt_abc_marker_update_I / _II) at t = 2, 3 and 4 with a shared and a
per-locus Ginv; the group-sequential sweep (sweep_blocks_mt_abc_grouped
over a DenseMarkers, through the wrappers' plain versions of K7 and K8)
against grouped_dense_sweep with mt_abc_blocks_I / _II, JAX's draws
rebuilt from its keys as fold_in(fold_in(key, g), r) -> split ->
uniform / Gumbel and normal (jwas_tpu/ops/markers.py:215-238, :524-566);
the exact form (one block a group, nreps = 1) against mt_abc_exact_I /
_II, the panels drawn as they draw them (jwas_tpu/ops/multitrait.py:241-
243, :381-383) and served in marker order by ops/dense.py::sweep_draws.
Tolerances of tests/test_pallas_sweep.py:42-45: delta equal, alpha and
beta rtol 1e-5 / atol 1e-6, ycorr rtol 1e-4 / atol 1e-5. Sampler II
inverts each pattern's LHS through its Cholesky factor where jwas_tpu
takes LU: the two agree to float32 rounding.

The analytic checks of tests/test_multitrait.py, ported: a one-marker,
two-trait model has a posterior over its four inclusion patterns that can
be computed exactly; sampler II draws from it directly, and sampler I's
chain converges to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

from jwas_tpu.ops import markers as jmk
from jwas_tpu.ops import multitrait as jmt
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops import multitrait as tmt

TOL_STATE = dict(rtol=1e-5, atol=1e-6)
TOL_YCORR = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _covs(t, rng):
    """A residual covariance R and a marker-effect covariance G, (t, t)."""
    A = rng.normal(size=(t, t))
    R = (A @ A.T / t + np.eye(t)).astype(np.float32)
    B = rng.normal(size=(t, t))
    G = (0.02 * (B @ B.T / t + np.eye(t))).astype(np.float32)
    return R, G


def _pi(t, rng):
    pi = rng.uniform(0.2, 1.0, 2 ** t)
    return (pi / pi.sum()).astype(np.float32)


@pytest.mark.parametrize("t", [2, 3, 4])
@pytest.mark.parametrize("per_locus", [False, True])
def test_marker_updates_match_jax(t, per_locus):
    """One marker of each of B = 64 blocks, with random states and draws;
    both samplers, every pattern and both branches of sampler I visited."""
    B = 64
    rng = np.random.default_rng(10 * t + per_locus)
    R, G = _covs(t, rng)
    Rinv = np.linalg.inv(R).astype(np.float32)
    if per_locus:
        Gs = np.stack([G * rng.uniform(0.5, 2.0) for _ in range(B)])
        Ginv_p = np.linalg.inv(Gs).astype(np.float32)          # (B, t, t)
    else:
        Ginv_p = np.linalg.inv(G).astype(np.float32)
    xpx = rng.uniform(20.0, 80.0, B).astype(np.float32)
    w = (rng.normal(size=(t, B)) * rng.uniform(0.1, 8.0, B)).astype(np.float32)
    beta = (0.2 * rng.normal(size=(t, B))).astype(np.float32)
    delta = rng.integers(0, 2, size=(t, B)).astype(np.float32)
    alpha = beta * delta
    log_pi = np.log(_pi(t, rng))
    us = rng.uniform(size=(t, B)).astype(np.float32)
    zs = rng.normal(size=(t, B)).astype(np.float32)
    gum = rng.gumbel(size=(2 ** t, B)).astype(np.float32)

    ginv_j = np.moveaxis(Ginv_p, 0, -1) if per_locus else Ginv_p    # JAX's (t, t, B)
    jb, jd, ja = jmt._mt_abc_marker_update_I(
        jnp.asarray(w), jnp.asarray(beta), jnp.asarray(delta), jnp.asarray(alpha),
        jnp.asarray(xpx), jnp.asarray(Rinv), jnp.asarray(ginv_j), jnp.asarray(log_pi),
        jnp.asarray(us), jnp.asarray(zs))
    pb, pd, pa = tmt.mt_marker_update_I_ref(
        _t(w.T), _t(beta.T), _t(delta.T), _t(alpha.T), _t(xpx), _t(Rinv), _t(Ginv_p),
        _t(log_pi), _t(us.T), _t(zs.T))
    np.testing.assert_array_equal(pd.numpy().T, np.asarray(jd))
    np.testing.assert_allclose(pb.numpy().T, np.asarray(jb), **TOL_STATE)
    np.testing.assert_allclose(pa.numpy().T, np.asarray(ja), **TOL_STATE)
    assert 0 < np.asarray(jd).mean() < 1

    jb, jd, ja = jmt._mt_abc_marker_update_II(
        jnp.asarray(w), jnp.asarray(xpx), jnp.asarray(Rinv), jnp.asarray(Ginv_p),
        jnp.asarray(log_pi), jmt.all_patterns(t), jnp.asarray(gum), jnp.asarray(zs))
    pb, pd, pa = tmt.mt_marker_update_II_ref(
        _t(w.T), _t(xpx), _t(Rinv), _t(Ginv_p), _t(log_pi), _t(gum.T), _t(zs.T))
    np.testing.assert_array_equal(pd.numpy().T, np.asarray(jd))
    np.testing.assert_allclose(pb.numpy().T, np.asarray(jb), **TOL_STATE)
    np.testing.assert_allclose(pa.numpy().T, np.asarray(ja), **TOL_STATE)
    assert len(np.unique(np.asarray(jmt.pattern_index(jd)))) > 2


def _problem(n, p, t, seed):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    R, G = _covs(t, rng)
    G = (G * 3.0).astype(np.float32)
    return rng, X, rinv, R, G


def _draws(key, b, gb, t, sampler):
    def draws(g, r, reps):
        ka, kz = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, g), r))
        a = (jax.random.uniform(ka, (reps * b, t, gb)) if sampler == "I"
             else jax.random.gumbel(ka, (reps * b, 2 ** t, gb)))
        return _t(a), _t(jax.random.normal(kz, (reps * b, t, gb)))
    return draws


def _start(rng, t, pp, p):
    real = np.arange(pp) < p
    beta = np.where(real, 0.05 * rng.normal(size=(t, pp)), 0.0).astype(np.float32)
    delta = (rng.uniform(size=(t, pp)) < 0.6).astype(np.float32) * real
    return beta * delta, beta, delta.astype(np.float32)


@pytest.mark.parametrize("sampler", ["I", "II"])
@pytest.mark.parametrize("t,weighted,per_locus,nreps,sync_every",
                         [(2, False, False, 1, None), (3, True, False, 3, 2),
                          (2, False, True, 3, None), (4, False, False, 3, 2)])
def test_grouped_sweep_matches_jax(sampler, t, weighted, per_locus, nreps, sync_every):
    """b = 8, 12 blocks of which the last is ragged (p = 94), gb = 3 from
    stable_group_blocks; a remainder round with sync_every = 2."""
    n, p, b = 60, 94, 8
    rng, X, rinv, R, G = _problem(n, p, t, seed=20 + t)
    key = jax.random.PRNGKey(t)
    w = rinv if weighted else None
    md = jmk.build_marker_blocks(jnp.asarray(X), None if w is None else jnp.asarray(w),
                                 block_size=b)
    nblocks = md.grams.shape[2]
    gb = jmk.stable_group_blocks(n, b, nblocks)
    assert 1 < gb < nblocks
    ngroups = nblocks // gb
    pp = nblocks * b
    alpha, beta, delta = _start(rng, t, pp, p)
    y = rng.normal(size=(t, n)).astype(np.float32)
    pi = _pi(t, rng)
    ginv = np.linalg.inv(G).astype(np.float32)
    if per_locus:
        scale = rng.uniform(0.5, 2.0, pp).astype(np.float32)
        ginv = (ginv[None] * scale[:, None, None]).astype(np.float32)
    sweep = jmt.mt_abc_blocks_I if sampler == "I" else jmt.mt_abc_blocks_II
    rinv_j = None if w is None else jnp.asarray(w)

    def cg(md_g, sts, yc, g, kg):
        a, be, d = sts[:3]
        gi = jnp.moveaxis(sts[3], -1, 0) if per_locus else jnp.asarray(ginv)
        a, be, d, yc = sweep(md_g, a, be, d, yc, rinv_j, jnp.asarray(R), gi,
                             jnp.asarray(pi), kg, nreps=nreps, sync_every=sync_every)
        return (a, be, d) + sts[3:], yc

    sts = (jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(delta))
    if per_locus:
        sts += (jnp.moveaxis(jnp.asarray(ginv), 0, -1),)
    out, yc = jmk.grouped_dense_sweep(cg, md, sts, jnp.asarray(y), key, gb)

    dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=w)
    assert dm.ngroups == ngroups
    a, be, d, ycr = _t(alpha), _t(beta), _t(delta), _t(y)
    tmt.sweep_blocks_mt_abc_grouped(
        dm, a, be, d, ycr, _t(R), _t(ginv), _t(pi), None, sampler=sampler,
        nreps=nreps, sync_every=sync_every, draws=_draws(key, b, gb, t, sampler))
    np.testing.assert_array_equal(d.numpy(), np.asarray(out[2]))
    np.testing.assert_allclose(a.numpy(), np.asarray(out[0]), **TOL_STATE)
    np.testing.assert_allclose(be.numpy()[:, :p], np.asarray(out[1])[:, :p], **TOL_STATE)
    np.testing.assert_allclose(ycr.numpy(), np.asarray(yc), **TOL_YCORR)


@pytest.mark.parametrize("sampler", ["I", "II"])
@pytest.mark.parametrize("per_locus", [False, True])
def test_exact_sweep_matches_jax(sampler, per_locus):
    """p = 70 in chunks of b = 32 (the last 6 markers), weighted: the
    grouped sweep over a store of one block a group with nreps = 1, against
    mt_abc_exact_I / _II."""
    n, p, t, b = 50, 70, 3, 32
    rng, X, rinv, R, G = _problem(n, p, t, seed=40)
    key = jax.random.PRNGKey(41)
    dm = td.build_dense_markers(_t(np.ascontiguousarray(X.T)), n, b, 1, rinv=_t(rinv),
                                exact=True)
    pp = dm.valid.shape[0]
    alpha, beta, delta = _start(rng, t, p, p)
    y = rng.normal(size=(t, n)).astype(np.float32)
    pi = _pi(t, rng)
    ginv = np.linalg.inv(G).astype(np.float32)
    if per_locus:
        ginv = (ginv[None] * rng.uniform(0.5, 2.0, p)[:, None, None]).astype(np.float32)
    xpx = np.einsum("np,np->p", X * rinv[:, None], X)
    sweep = jmt.mt_abc_exact_I if sampler == "I" else jmt.mt_abc_exact_II
    ra, rb, rd, ryc = sweep(jnp.asarray(X), jnp.asarray(xpx), jnp.asarray(alpha),
                            jnp.asarray(beta), jnp.asarray(delta), jnp.asarray(y),
                            jnp.asarray(rinv), jnp.asarray(R), jnp.asarray(ginv),
                            jnp.asarray(pi), key)
    ka, kz = jax.random.split(key)
    panel_a = (jax.random.uniform(ka, (p, t, 1)) if sampler == "I"
               else jax.random.gumbel(ka, (p, 2 ** t, 1)))
    zs = jax.random.normal(kz, (p, t, 1))

    def pad(x):
        out = np.zeros((x.shape[0], pp), np.float32)
        out[:, :p] = x
        return _t(out)

    a, be, d, ycr = pad(alpha), pad(beta), pad(delta), _t(y)
    gi = _t(ginv)
    if per_locus:
        gi = torch.cat([gi, torch.eye(t).expand(pp - p, t, t)])
    # the (b, 1, t) panels of sweep_draws, as the (b, t, 1) a multi-trait round takes
    draws = td.sweep_draws(b, _t(panel_a)[..., 0], _t(zs)[..., 0])
    tmt.sweep_blocks_mt_abc_grouped(
        dm, a, be, d, ycr, _t(R), gi, _t(pi), None, sampler=sampler, nreps=1,
        draws=lambda g, r, reps: tuple(x.mT for x in draws(g, r, reps)))
    np.testing.assert_array_equal(d.numpy()[:, :p], np.asarray(rd))
    assert not d[:, p:].any() and not a[:, p:].any()
    np.testing.assert_allclose(a.numpy()[:, :p], np.asarray(ra), **TOL_STATE)
    np.testing.assert_allclose(be.numpy()[:, :p], np.asarray(rb), **TOL_STATE)
    np.testing.assert_allclose(ycr.numpy(), np.asarray(ryc), **TOL_YCORR)


def test_per_locus_ginv_matches_shared():
    """tests/test_mt_end2end.py::test_mt_per_locus_ginv_matches_shared,
    ported: with every locus sharing G, the per-locus path of both samplers
    gives the shared path's chain (the same draws)."""
    rng = np.random.default_rng(4)
    n, p, t, b = 40, 24, 2, 8
    X = rng.normal(size=(n, p)).astype(np.float32)
    dm = td.build_dense_markers(_t(np.ascontiguousarray(X.T)), n, b, 3)
    pp = dm.valid.shape[0]
    y = rng.normal(size=(t, n)).astype(np.float32)
    R = np.array([[1.0, 0.2], [0.2, 1.2]], np.float32)
    G = np.array([[0.05, 0.01], [0.01, 0.04]], np.float32)
    ginv = torch.linalg.inv(_t(G))
    pi = _t(np.array([0.5, 0.1, 0.1, 0.3], np.float32))
    for sampler in ("I", "II"):
        outs = []
        for gi in (ginv, ginv.expand(pp, t, t).contiguous()):
            gen = torch.Generator().manual_seed(3)
            st = [torch.zeros(t, pp), torch.zeros(t, pp), torch.ones(t, pp), _t(y)]
            tmt.sweep_blocks_mt_abc_grouped(dm, *st, _t(R), gi, pi, gen, sampler=sampler,
                                            nreps=2)
            outs.append(st)
        for x, y2 in zip(*outs):
            np.testing.assert_allclose(x.numpy(), y2.numpy(), rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(outs[0][2].numpy(), outs[1][2].numpy())


# ---------------------------------------------- analytic one-marker checks


def _one_marker_mt(seed=0, n=25):
    rng = np.random.default_rng(seed)
    x = rng.binomial(2, 0.4, size=n).astype(np.float64)
    x = x - x.mean()
    R = np.array([[1.0, 0.3], [0.3, 0.8]])
    G = np.array([[0.5, 0.2], [0.2, 0.4]])
    eff = np.array([0.7, -0.5])
    err = rng.multivariate_normal(np.zeros(2), R, size=n)
    Y = x[:, None] * eff[None, :] + err
    return x, Y.T, R, G


def _analytic_state_posterior(x, Ycorr, R, G, pi_vec):
    """P(pattern | y) for patterns s = d1 + 2 d2 (bit k = trait k)."""
    n = len(x)
    y = Ycorr.reshape(-1)
    logps = []
    for s in range(4):
        D = np.diag([s & 1, (s >> 1) & 1]).astype(np.float64)
        cov = np.kron(D @ G @ D, np.outer(x, x)) + np.kron(R, np.eye(n))
        logps.append(np.log(max(pi_vec[s], 1e-300))
                     + multivariate_normal.logpdf(y, np.zeros(2 * n), cov))
    pr = np.exp(np.array(logps) - max(logps))
    return pr / pr.sum()


def _one_marker_blocks(x, Ycorr, R, G, B):
    """B blocks of the one marker, each from effects 0: Gram x'x, rhs
    x'Ycorr', the state zero."""
    x32 = x.astype(np.float32)
    xpx = float(x32 @ x32)
    rhs = torch.from_numpy(Ycorr.astype(np.float32) @ x32).reshape(1, 2, 1)
    return dict(grams=torch.full((B, 1, 1), xpx), xpx=torch.full((B, 1), xpx),
                valid=torch.ones(B, 1), alpha=torch.zeros(B, 2, 1),
                beta=torch.zeros(B, 2, 1), delta=torch.zeros(B, 2, 1),
                rhs=rhs.expand(B, 2, 1).contiguous(),
                Rinv=torch.linalg.inv(_t(R.astype(np.float32))),
                Ginv=torch.linalg.inv(_t(G.astype(np.float32))))


def _freq(delta):
    return np.bincount(tmt.pattern_index(delta[:, :, 0].T).numpy(), minlength=4) / delta.shape[0]


def test_sampler_II_draws_the_exact_pattern_posterior():
    """tests/test_multitrait.py::test_mt_samplerII_single_marker_exact:
    8,000 independent one-marker draws of sampler II (8,000 blocks of the
    marker, one step each), pattern frequencies within 0.025 of the exact
    posterior."""
    x, Ycorr, R, G = _one_marker_mt()
    pi_vec = np.full(4, 0.25)
    truth = _analytic_state_posterior(x, Ycorr, R, G, pi_vec)
    B = 8000
    st = _one_marker_blocks(x, Ycorr, R, G, B)
    gen = torch.Generator().manual_seed(0)
    from jwas_tpu_torch.ops.grouped import gumbel_panel
    tmt.mt_abc_inner_rounds_ref(
        "II", **st, log_pi=torch.log(torch.full((4,), 0.25)),
        draw_a=gumbel_panel((1, 4, B), gen, "cpu"),
        zs=torch.randn((1, 2, B), generator=gen), nreps=1)
    np.testing.assert_allclose(_freq(st["delta"]), truth, atol=0.025)


def test_sampler_I_chain_converges_to_the_exact_pattern_posterior():
    """tests/test_multitrait.py::
    test_mt_samplerI_chain_converges_to_exact_posterior: sampler I's chain
    on one marker, 400 independent chains (blocks) of 60 steps, the first
    10 dropped: 20,000 pattern draws within 0.04 of the exact posterior."""
    x, Ycorr, R, G = _one_marker_mt(seed=1)
    truth = _analytic_state_posterior(x, Ycorr, R, G, np.full(4, 0.25))
    B = 400
    st = _one_marker_blocks(x, Ycorr, R, G, B)
    gen = torch.Generator().manual_seed(2)
    draws = []
    for step in range(60):
        tmt.mt_abc_inner_rounds_ref(
            "I", **st, log_pi=torch.log(torch.full((4,), 0.25)),
            draw_a=torch.rand((1, 2, B), generator=gen),
            zs=torch.randn((1, 2, B), generator=gen), nreps=1)
        if step >= 10:
            draws.append(tmt.pattern_index(st["delta"][:, :, 0].T))
    freq = np.bincount(torch.cat(draws).numpy(), minlength=4) / (50 * B)
    np.testing.assert_allclose(freq, truth, atol=0.04)


# ------------------------------------- the engine's pieces against jwas_tpu


def _mt_setup(weights=True):
    """A 3-trait model with missing phenotypes (a pattern a trait missing,
    and rows with two missing), residual weights, a herd factor, an i.i.d.
    random "litter" with a 3 x 3 G and dense genotypes, set up by jwas_tpu
    (prepare_workspace, build_mt_data_and_state), with the port's MTData
    from the same arrays."""
    import pandas as pd

    import jwas_tpu as jw
    from jwas_tpu.engine.mcmc_mt import build_mt_data_and_state
    from jwas_tpu.engine.setup import MCMCOptions, prepare_workspace
    from jwas_tpu_torch.engine.convert import mt_data_from_jax, mt_state_from_jax

    rng = np.random.default_rng(50)
    n, p, t = 120, 40, 3
    ids = [f"a{i}" for i in range(n)]
    X = rng.integers(0, 3, size=(n, p)).astype(np.float64)
    Y = rng.normal(size=(n, t)) + np.array([1.0, -2.0, 0.5])
    Y[rng.uniform(size=(n, t)) < 0.15] = np.nan
    Y[np.isnan(Y).all(axis=1), 0] = 0.3
    ph = pd.DataFrame({"ID": ids, "y1": Y[:, 0], "y2": Y[:, 1], "y3": Y[:, 2],
                       "herd": [f"h{k}" for k in rng.integers(0, 5, n)],
                       "litter": [f"l{k}" for k in rng.integers(0, 12, n)],
                       "weights": rng.uniform(0.5, 2.0, n)})
    geno = jw.get_genotypes(pd.DataFrame(X, columns=[f"m{j}" for j in range(p)]).assign(
        ID=ids)[["ID"] + [f"m{j}" for j in range(p)]], method="BayesC", name="geno")
    model = jw.build_model("y1 = intercept + herd + litter + geno\n"
                           "y2 = intercept + litter + geno\ny3 = intercept + herd + geno",
                           genotypes=geno)
    jw.set_random(model, "litter", np.array([[0.3, 0.1], [0.1, 0.2]]))
    opts = MCMCOptions(chain_length=10, heterogeneous_residuals=weights, seed=1,
                       output_folder="")
    ws = prepare_workspace(model, ph, opts)
    cfg, data, state = build_mt_data_and_state(ws, opts, jnp.float32)
    cols = []
    for k in range(t):
        spans = [(trm.start_pos, trm.start_pos + trm.n_levels) for trm in model.terms
                 if trm.i_model == k]
        cols.append((min(a for a, _ in spans), max(b for _, b in spans)))
    return cfg, data, state, cols, mt_data_from_jax, mt_state_from_jax


def test_pattern_precisions_imputation_lhs_rhs_and_the_pass_match_jax():
    """Parity (a): the pattern precisions (_pattern_Ri), the imputation of
    the missing residuals with injected normals (mcmc_mt.py:156-175), the
    location LHS W'R^-1W plus the random effects' G^-1 blocks (:181-197)
    by both routes (the pieces fixed at set-up, and the blocks from W), each
    exactly symmetric, and the rhs (:198); parity (b): gibbs_pass_general
    (K6's plain version with vare 1) with JAX's normals injected."""
    from jwas_tpu.engine.mcmc_mt import _pattern_Ri
    from jwas_tpu.ops.location import gibbs_pass_general as j_pass
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.ops.location import gibbs_pass_general

    cfg, data, state, cols, mt_data_from_jax, mt_state_from_jax = _mt_setup()
    t, n = np.shape(data.y)
    assert len(cfg.pattern_rows) >= 4
    rng = np.random.default_rng(51)
    A = rng.normal(size=(t, t))
    R = (A @ A.T + np.eye(t)).astype(np.float32)
    want = np.asarray(_pattern_Ri(data.patterns, jnp.asarray(R), None))
    got = tm.pattern_Ri(_t(np.asarray(data.patterns)), _t(R))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    # imputation with the same normals
    y = rng.normal(size=(t, n)).astype(np.float32)
    zs = [rng.normal(size=(sum(not m for m in mask), len(rows))).astype(np.float32)
          for rows, mask in zip(cfg.pattern_rows, cfg.pattern_masks)]
    ref = jnp.asarray(y)
    Rj = jnp.asarray(R)
    for p, (rows, mask) in enumerate(zip(cfg.pattern_rows, cfg.pattern_masks)):
        obs = [i for i, m in enumerate(mask) if m]
        mis = [i for i, m in enumerate(mask) if not m]
        if not mis or not rows:
            continue
        ra, oa, ma = jnp.asarray(rows), jnp.asarray(obs), jnp.asarray(mis)
        Ri_oo = jnp.linalg.inv(Rj[jnp.ix_(oa, oa)])
        Rmo = Rj[jnp.ix_(ma, oa)]
        C = Rj[jnp.ix_(ma, ma)] - Rmo @ Ri_oo @ Rmo.T
        imput = (Rmo @ Ri_oo) @ ref[oa][:, ra] + jnp.linalg.cholesky(0.5 * (C + C.T)) @ zs[p]
        ref = ref.at[jnp.ix_(ma, ra)].set(imput)
    port = tm.impute_missing(_t(y), _t(R), tuple(torch.tensor(r) for r in cfg.pattern_rows),
                             cfg.pattern_masks, None, zs=[_t(z) for z in zs])
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    # LHS and rhs: jwas_tpu's einsum and random-effect blocks
    Ri_pat = _pattern_Ri(data.patterns, jnp.asarray(R), None)
    Ri_n = Ri_pat[data.pattern_idx] * data.rinv[:, None, None]
    LHS = jnp.einsum("ank,nab,bnl->kl", data.W3, Ri_n, data.W3)
    vc = [jnp.asarray([[0.3, 0.05], [0.05, 0.2]], jnp.float32)]
    for grp, v in zip(cfg.re_groups, vc):
        Gi = jnp.linalg.inv(v)
        for i, si in enumerate(grp.starts):
            for j, sj in enumerate(grp.starts):
                idx = si + jnp.arange(grp.n_levels)
                LHS = LHS.at[idx, sj + jnp.arange(grp.n_levels)].add(Gi[i, j])
    ycp = jnp.asarray(y)
    rhs = jnp.einsum("ank,nab,bn->k", data.W3, Ri_n, ycp)
    from jwas_tpu_torch.engine.convert import from_jax_random_effects
    re_cfg = from_jax_random_effects(cfg.re_groups, np.zeros((1, 1)), data.Vinv, vc)[0]
    for budget in (1 << 30, 0):
        pd_ = mt_data_from_jax(data, cfg.re_groups, cols, group_blocks=0, budget=budget)
        assert pd_.lhs.use_pieces == (budget > 0)
        L = pd_.lhs.assemble(_t(np.asarray(Ri_pat)), re_cfg, pd_.Vinv,
                             tuple(_t(np.asarray(v)) for v in vc))
        assert torch.equal(L, L.T)
        np.testing.assert_allclose(L.numpy(), np.asarray(LHS), rtol=1e-5, atol=1e-4)
        if pd_.lhs.use_pieces:
            Lw = pd_.lhs.assemble_from_W(_t(np.asarray(Ri_pat)), re_cfg, pd_.Vinv,
                                         tuple(_t(np.asarray(v)) for v in vc))
            torch.testing.assert_close(Lw, L, rtol=1e-5, atol=1e-4)
        r = tm.location_rhs(pd_, _t(np.asarray(Ri_pat)), _t(y))
        np.testing.assert_allclose(r.numpy(), np.asarray(rhs), rtol=1e-5, atol=1e-4)

    # the pass with JAX's normals
    key = jax.random.PRNGKey(52)
    K = LHS.shape[0]
    x0 = rng.normal(size=K).astype(np.float32)
    LHS_s = 0.5 * (LHS + LHS.T)
    want = j_pass(LHS_s, jnp.asarray(x0), rhs, key)
    got = gibbs_pass_general(_t(np.asarray(LHS_s)), _t(x0), _t(np.asarray(rhs)), None,
                             zs=_t(jax.random.normal(key, (K,))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    st = mt_state_from_jax(state)
    assert st.alpha.shape == np.shape(state.alpha) and st.R.shape == (t, t)
