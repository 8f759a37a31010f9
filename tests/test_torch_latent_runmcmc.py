"""Latent traits and annotations through runMCMC: the port's set-up and
one outer iteration against jwas_tpu's, and the reference's chains.

Set-up on the same data (deterministic, rtol 1e-5 / atol 1e-6 in
float32): a categorical trait's categories, thresholds and bounds, a
censored trait's bounds, the starting liabilities (both packages draw them
with scipy's truncnorm on numpy's default_rng(seed), seed + 7 for several
traits), a categorical trait's fixed residual variance, a binary trait's
unit row of R; the annotation design A and the probits' starting
coefficients (annotated BayesC, BayesR, 2-trait BayesC with its per-marker
prior), at p = 256, a whole number of blocks.

One outer iteration (parity level (b) of ROADMAP.md) from a common state
carried across by engine/convert.py: the single-trait latent step (a
4-category trait: liabilities, then thresholds), the annotated BayesC step
(the probit in place of pi) and the multi-trait latent step (a binary and a
continuous trait: liabilities, then Korsgaard's R), each fed jwas_tpu's
draws from the step's own keys. The location pass, the marker sweep and
the marker variance are held where they are on both sides (their parity is
tested in tests/test_torch_location_sliced.py, test_torch_dense_sweeps.py,
test_torch_multitrait.py and test_torch_mt_window.py); the residual draw
is jwas_tpu's on the port's residuals.

Chains (parity level (c)): the four models of tests/test_threshold_traits.py
through jt.runMCMC on the CPU on its data and seeds, with its assertions
(accuracy floors, vare = 1 for a single-trait categorical trait, R_bb = 1
within 1e-5). The binary chain runs at the reference's 800 sweeps, and its
posterior means are held against jwas_tpu's within calibrated 99%
Monte-Carlo bounds at that length; the other three at a quarter of the
reference's chain lengths and burn-ins (SHORTER): the port's CPU plain
versions take one Python-level step a marker (the 2-trait chain about
0.24 s an exact sweep here), and the reference's lengths cost the suite
minutes. jwas_tpu draws the
liabilities with jax.random.truncated_normal, which collapses past about 5
residual SDs in float32 (fault R13, ROADMAP.md): at these data no bound
lies that far out (the probability under the model is below 1e-6), so the
comparison is not affected.

Recalibrate the bounds (one core a process, PYTHONPATH=.:tests):
    python tests/test_torch_latent_runmcmc.py calibrate port|jwas_tpu SEED0 N out.json
    python tests/test_torch_latent_runmcmc.py summarize a.json b.json ...
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jwas_tpu as jw
import jwas_tpu_torch as jt
from jwas_tpu.io.datasets import simulate_genomic_data

TOL = dict(rtol=1e-5, atol=1e-6)
# |difference| / sqrt(sd_port^2 + sd_jwas^2) of the binary chain's three
# posterior means: 99% for the test as a whole (Bonferroni over the three)
Z99_3 = 2.935
SHORTER = 4     # the reference tests' chain lengths and burn-ins over this


@pytest.fixture(autouse=True)
def _jax_float32():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


# ------------------------------------------------------------- the data


def _liability_sim(seed=5, n=400, p=200):
    return simulate_genomic_data(n=n, p=p, n_qtl=20, h2=0.6, seed=seed)


def binary_df(sim):
    df = sim["phenotypes"].copy()
    liab = df["y"].to_numpy()
    df["y"] = np.where(liab > np.median(liab), 2, 1)
    return df


def categorical_df(sim):
    df = sim["phenotypes"].copy()
    liab = df["y"].to_numpy()
    df["y"] = 1 + np.searchsorted(np.quantile(liab, [0.3, 0.6, 0.85]), liab)
    return df


def censored_df(sim):
    df = sim["phenotypes"].copy()
    y = df["y"].to_numpy()
    cut = np.quantile(y, 0.6)
    df = df.drop(columns=["y"])
    df["y_l"] = np.where(y > cut, cut, y)
    df["y_u"] = np.where(y > cut, np.inf, y)
    return df


def mt_binary_df(sim):
    rng = np.random.default_rng(3)
    df = sim["phenotypes"].copy()
    bv = sim["true_bv"]
    liab2 = 0.8 * bv / bv.std() + rng.normal(size=len(bv))
    df["y2"] = np.where(liab2 > 0, 2, 1)
    return df


def _accuracy(out, sim, trait="y"):
    ebv = dict(zip(out[f"EBV_{trait}"]["ID"], out[f"EBV_{trait}"]["EBV"]))
    ids = [f"ind{i + 1}" for i in range(len(sim["true_bv"]))]
    return np.corrcoef([ebv[s] for s in ids], sim["true_bv"])[0, 1]


def _model(pkg, sim, eq="y = intercept + geno", geno_kw=None, **kw):
    gkw = dict(dict(method="BayesC", name="geno"), **(geno_kw or {}))
    if pkg is jt:
        gkw["device"] = "cpu"
    geno = pkg.get_genotypes(sim["genotypes"], **gkw)
    return pkg.build_model(eq, genotypes=geno, **kw)


def _run(pkg, model, df, **kw):
    if pkg is jt:
        kw["device"] = "cpu"
    return pkg.runMCMC(model, df, output_folder="", printout_model_info=False, **kw)


# -------------------------------------------------------------- set-up


def _workspaces(sim, df, eq="y = intercept + geno", geno_kw=None, **kw):
    """Both packages' chain data and state of one model on df
    (fast_blocks=True, seed 4): ((cfg, data, state) of jwas_tpu, of the
    port)."""
    from jwas_tpu.engine import mcmc as jm
    from jwas_tpu.engine import mcmc_mt as jmm
    from jwas_tpu.engine.setup import MCMCOptions as JOpts
    from jwas_tpu.engine.setup import prepare_workspace as j_prepare
    from jwas_tpu_torch.engine import mcmc as tm
    from jwas_tpu_torch.engine import mcmc_mt as tmm
    from jwas_tpu_torch.engine.setup import MCMCOptions as TOpts
    from jwas_tpu_torch.engine.setup import prepare_workspace as t_prepare

    opts = dict(chain_length=10, seed=4, fast_blocks=True, output_folder="")
    jws = j_prepare(_model(jw, sim, eq, geno_kw, **kw), df, JOpts(**opts))
    tws = t_prepare(_model(jt, sim, eq, geno_kw, **kw), df, TOpts(**opts), device="cpu")
    if jws.n_traits == 1:
        return (jm._build_st_data_and_state(jws, JOpts(**opts), jnp.float32),
                tm._build_st_data_and_state(tws, TOpts(**opts), torch.device("cpu")))
    return (jmm.build_mt_data_and_state(jws, JOpts(**opts), jnp.float32),
            tmm.build_mt_data_and_state(tws, TOpts(**opts), torch.device("cpu")))


def _np(x):
    return None if x is None else np.asarray(x.cpu() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("kind", ["binary", "categorical", "censored"])
def test_single_trait_latent_set_up_matches_jax(kind):
    sim = _liability_sim(p=256)
    df = {"binary": binary_df, "categorical": categorical_df, "censored": censored_df}[kind](sim)
    kw = dict(censored_trait=["y"]) if kind == "censored" else dict(categorical_trait=["y"])
    (jcfg, jdata, jstate), (cfg, data, state) = _workspaces(sim, df, **kw)
    assert cfg.trait_types == tuple(jcfg.trait_types)
    assert cfg.estimate_residual_variance == jcfg.estimate_residual_variance == (
        kind == "censored")
    np.testing.assert_allclose(_np(state.liab), _np(jstate.liab), **TOL)
    np.testing.assert_allclose(_np(state.ycorr), _np(jstate.ycorr), **TOL)
    assert float(state.vare) == float(jstate.vare)
    if kind == "censored":
        np.testing.assert_allclose(_np(data.cens_lower), _np(jdata.cens_lower), **TOL)
        np.testing.assert_allclose(_np(data.cens_upper), _np(jdata.cens_upper), **TOL)
    else:
        assert cfg.cat_counts == tuple(jcfg.cat_counts)
        np.testing.assert_array_equal(_np(data.category_obs), _np(jdata.category_obs))
        np.testing.assert_allclose(_np(state.thresholds), _np(jstate.thresholds), **TOL)
        assert float(state.vare) == 1.0


@pytest.mark.parametrize("method", ["BayesC", "BayesR"])
def test_single_trait_annotation_set_up_matches_jax(method):
    sim = _liability_sim(p=256)
    anno = np.random.default_rng(1).normal(size=(256, 3))
    gkw = dict(method=method, annotations=anno, **({"Pi": 0.8} if method == "BayesC" else {}))
    (jcfg, jdata, jstate), (cfg, data, state) = _workspaces(sim, sim["phenotypes"],
                                                            geno_kw=gkw)
    assert cfg.anno_steps == jcfg.anno_steps == (1 if method == "BayesC" else 3)
    assert data.anno_A.shape == jdata.anno_A.shape == (256, 4)
    np.testing.assert_allclose(_np(data.anno_A), _np(jdata.anno_A), **TOL)
    np.testing.assert_allclose(_np(state.ann_coeffs), _np(jstate.ann_coeffs), **TOL)
    np.testing.assert_allclose(_np(state.ann_var), _np(jstate.ann_var), **TOL)
    np.testing.assert_allclose(_np(state.pi), _np(jstate.pi), **TOL)


def test_multi_trait_set_up_matches_jax():
    """A binary and a 4-category trait beside a continuous one; then 2-trait
    annotated BayesC: A, the tree's intercepts and the per-marker prior."""
    sim = _liability_sim(seed=12, p=256)
    df = mt_binary_df(sim)
    df["y3"] = categorical_df(sim)["y"]
    eq = "y = intercept + geno\ny2 = intercept + geno\ny3 = intercept + geno"
    (jcfg, jdata, jstate), (cfg, data, state) = _workspaces(
        sim, df, eq, categorical_trait=["y2", "y3"])
    assert cfg.latent_traits == jcfg.latent_traits == (1, 2)
    assert cfg.binary_traits == jcfg.binary_traits == (1,)
    assert cfg.cat_counts == tuple(jcfg.cat_counts)
    np.testing.assert_array_equal(_np(data.category_obs), _np(jdata.category_obs))
    np.testing.assert_allclose(_np(state.thresholds), _np(jstate.thresholds), **TOL)
    np.testing.assert_allclose(_np(state.liab), _np(jstate.liab), **TOL)
    np.testing.assert_allclose(_np(state.ycorr), _np(jstate.ycorr), **TOL)
    np.testing.assert_allclose(_np(state.R), _np(jstate.R), **TOL)
    assert float(state.R[1, 1]) == 1.0 and float(state.R[0, 1]) == 0.0

    anno = np.random.default_rng(2).normal(size=(256, 2))
    pi0 = {(0.0, 0.0): 0.85, (1.0, 0.0): 0.05, (0.0, 1.0): 0.04, (1.0, 1.0): 0.06}
    df = sim["phenotypes"].copy()
    df["y2"] = df["y"] + np.random.default_rng(3).normal(size=len(df))
    (jcfg, jdata, jstate), (cfg, data, state) = _workspaces(
        sim, df, "y = intercept + geno\ny2 = intercept + geno",
        geno_kw=dict(annotations=anno, Pi=pi0))
    assert cfg.anno_steps == jcfg.anno_steps == 3
    np.testing.assert_allclose(_np(data.anno_A), _np(jdata.anno_A), **TOL)
    np.testing.assert_allclose(_np(state.ann_coeffs), _np(jstate.ann_coeffs), **TOL)
    np.testing.assert_allclose(_np(state.pi), _np(jstate.pi), **TOL)
    assert state.pi.shape == (256, 4)
    with pytest.raises(ValueError, match="positive startup prior mass"):
        _workspaces(sim, df, "y = intercept + geno\ny2 = intercept + geno",
                    geno_kw=dict(annotations=anno,
                                 Pi={(0.0, 0.0): 0.9, (1.0, 0.0): 0.1,
                                     (0.0, 1.0): 0.0, (1.0, 1.0): 0.0}))


# ------------------------------------------------- one outer iteration


def _common_st_state(jstate, state, rng):
    """A common state: jwas_tpu's (its liabilities, thresholds, probit
    coefficients and pi carried across by engine/convert.py), with effects
    and indicators drawn here; returned for both packages."""
    from jwas_tpu_torch.engine.convert import latent_state_from_jax

    p_pad = jstate.alpha.shape[0]
    delta = (rng.uniform(size=p_pad) < 0.3).astype(np.int32)
    alpha = 0.05 * rng.normal(size=p_pad) * delta
    common = dict(alpha=alpha.astype(np.float32), beta=alpha.astype(np.float32),
                  delta=delta, sol=np.asarray(jstate.sol))
    jst = jstate._replace(**{k: jnp.asarray(v) for k, v in common.items()})
    st = state._replace(**{k: torch.from_numpy(np.array(v)) for k, v in common.items()},
                        ycorr=torch.from_numpy(np.array(jstate.ycorr)),
                        vare=torch.tensor(float(jstate.vare)),
                        varg=torch.tensor(float(jstate.varg)),
                        **latent_state_from_jax(jstate))
    return jst, st


def _hold_st(monkeypatch, jstate, state):
    """Location pass, marker sweep and marker variance held on both sides."""
    import jwas_tpu.engine.mcmc as jm
    import jwas_tpu.ops.markers as jmk
    import jwas_tpu_torch.engine.mcmc as tm

    monkeypatch.setattr(jm, "gibbs_pass_lambda", lambda LHS, sol, rhs, vare, key: sol)
    monkeypatch.setattr(jmk, "grouped_dense_sweep", lambda cg, md, sts, yc, key, gb: (sts, yc))
    monkeypatch.setattr(jmk, "sweep_blocks_abc",
                        lambda md, a, b, d, yc, *args, **kw: (a, b, d, yc))
    monkeypatch.setattr(jm, "sample_marker_variance_common",
                        lambda *a, **k: jstate.varg)
    monkeypatch.setattr(tm, "gibbs_pass_lambda", lambda A, x, b, vare, gen: x)
    monkeypatch.setattr(tm, "sweep_blocks_abc_grouped",
                        lambda gm, a, b, d, yc, *args, **kw: (a, b, d, yc))
    monkeypatch.setattr(tm, "sample_marker_variance_common", lambda *a, **k: state.varg)


def _jax_residual(monkeypatch, key):
    """The port's residual-variance draw replaced by jwas_tpu's from its
    key, on the port's residuals."""
    from jwas_tpu.ops import variance as jv
    import jwas_tpu_torch.engine.mcmc as tm

    def draw(gen, ycorr, n, df, scale, invweights=None):
        return torch.tensor(float(jv.sample_residual_variance_st(
            key, jnp.asarray(ycorr.numpy()), n, df, jnp.asarray(scale.numpy()))))

    monkeypatch.setattr(tm, "sample_residual_variance_st", draw)


def test_single_trait_latent_step_matches_jax_on_its_draws(monkeypatch):
    """A 4-category trait: the liabilities from jwas_tpu's truncated
    normals (k_liab), the thresholds from its uniforms (k_thr), then the
    residual variance stays 1."""
    import jwas_tpu.engine.mcmc as jm
    import jwas_tpu_torch.engine.mcmc as tm

    from jwas_tpu_torch.engine.convert import latent_data_from_jax

    sim = _liability_sim(seed=6, p=256)
    (jcfg, jdata, jstate), (cfg, data, state) = _workspaces(
        sim, categorical_df(sim), categorical_trait=["y"])
    data = data._replace(**latent_data_from_jax(jdata))   # jwas_tpu's categories
    jst, st = _common_st_state(jstate, state, np.random.default_rng(7))
    _hold_st(monkeypatch, jst, st)
    want = jm.make_st_step(jcfg)(jst, jdata)
    keys = jax.random.split(jst.key, 11)
    k_liab, k_thr = keys[8], keys[9]
    n_cat = cfg.cat_counts[0]
    u = np.array([float(jax.random.uniform(k, dtype=jnp.float32))
                  for k in jax.random.split(k_thr, n_cat)])

    def z_of(ki, a, b):
        return torch.from_numpy(np.array(jax.random.truncated_normal(
            k_liab, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), shape=a.shape,
            dtype=jnp.float32)))

    step = tm.latent_step
    monkeypatch.setattr(tm, "latent_step", lambda cfg, s, d: step(
        cfg, s, d, z_of=z_of, u_thr=torch.from_numpy(u)))
    got = tm.make_st_step(cfg)(st, data)
    assert n_cat == 4
    for k in ("liab", "ycorr", "thresholds"):
        np.testing.assert_allclose(_np(getattr(got, k)), _np(getattr(want, k)), err_msg=k,
                                   **TOL)
    assert float(got.vare) == float(want.vare) == 1.0
    assert not np.allclose(_np(got.thresholds), _np(st.thresholds))


@pytest.mark.parametrize("method", ["BayesC", "BayesR"])
def test_annotated_step_matches_jax_on_its_draws(method, monkeypatch):
    """Annotated BayesC and BayesR: the probit update (k_ann) in place of
    pi, its per-marker prior with the padding pinned, then the residual
    variance."""
    import jwas_tpu.engine.mcmc as jm
    import jwas_tpu_torch.engine.mcmc as tm
    from jwas_tpu_torch.ops import annotations as an
    from test_torch_annotations import JaxDraws

    sim = _liability_sim(seed=8, p=256)
    anno = np.column_stack([np.random.default_rng(9).integers(0, 2, 256),
                            np.random.default_rng(10).normal(size=256)])
    gkw = dict(method=method, annotations=anno, **({"Pi": 0.8} if method == "BayesC" else {}))
    (jcfg, jdata, jstate), (cfg, data, state) = _workspaces(sim, sim["phenotypes"],
                                                            geno_kw=gkw)
    from jwas_tpu_torch.engine.convert import latent_data_from_jax

    data = data._replace(**latent_data_from_jax(jdata))   # jwas_tpu's A
    rng = np.random.default_rng(11)
    jst, st = _common_st_state(jstate, state, rng)
    if method == "BayesR":
        klass = rng.integers(0, 4, jst.alpha.shape[0]).astype(np.int32)
        jst = jst._replace(delta=jnp.asarray(klass))
        st = st._replace(delta=torch.from_numpy(klass))
        monkeypatch.setattr(jm.mk, "sweep_blocks_bayesr",
                            lambda md, a, d, yc, *args, **kw: (a, d, yc))
        monkeypatch.setattr(jm, "sample_marker_variance_bayesr", lambda *a, **k: jst.varg)
        monkeypatch.setattr(tm, "sweep_blocks_bayesr_grouped",
                            lambda gm, a, d, yc, *args, **kw: (a, d, yc))
        monkeypatch.setattr(tm, "sample_marker_variance_bayesr", lambda *a, **k: st.varg)
    _hold_st(monkeypatch, jst, st)
    want = jm.make_st_step(jcfg)(jst, jdata)
    keys = jax.random.split(jst.key, 11)
    _jax_residual(monkeypatch, keys[7])
    monkeypatch.setattr(an, "ProbitDraws", lambda gen: JaxDraws(
        keys[10], cfg.anno_steps, torch.float32))
    got = tm.make_st_step(cfg)(st, data)
    for k in ("pi", "ann_coeffs", "ann_var", "ycorr", "vare"):
        np.testing.assert_allclose(_np(getattr(got, k)), _np(getattr(want, k)), err_msg=k,
                                   **TOL)
    p = cfg.n_markers
    assert p == 256 and got.pi.shape[0] == 256
    assert not np.allclose(_np(got.ann_coeffs), _np(st.ann_coeffs))


def test_multi_trait_latent_step_matches_jax_on_its_draws(monkeypatch):
    """A continuous and a binary trait: the liabilities (k_sc; one latent
    trait, one Gibbs pass) and Korsgaard's R (k_res: X1 and Z), the binary
    trait's variance 1."""
    import jwas_tpu.engine.mcmc_mt as jmm
    import jwas_tpu.ops.markers as jmk
    import jwas_tpu.ops.multitrait as jmt
    import jwas_tpu_torch.engine.mcmc_mt as tmm
    import jwas_tpu_torch.ops.multitrait as tmt
    from jwas_tpu.ops import dists as jd
    from jwas_tpu_torch.engine.convert import latent_state_from_jax
    from jwas_tpu_torch.ops import threshold as th
    from jwas_tpu_torch.ops import variance as tv

    sim = _liability_sim(seed=12, p=256)
    (jcfg, jdata, jstate), (cfg, data, state) = _workspaces(
        sim, mt_binary_df(sim), "y = intercept + geno\ny2 = intercept + geno",
        categorical_trait=["y2"])
    rng = np.random.default_rng(13)
    t, p_pad = 2, jstate.alpha.shape[1]
    delta = (rng.uniform(size=(t, p_pad)) < 0.3).astype(np.float32)
    beta = (0.05 * rng.normal(size=(t, p_pad))).astype(np.float32)
    common = dict(alpha=beta * delta, beta=beta, delta=delta)
    jst = jstate._replace(**{k: jnp.asarray(v) for k, v in common.items()})
    st = state._replace(**{k: torch.from_numpy(v.copy()) for k, v in common.items()},
                        ycorr=torch.from_numpy(np.array(jstate.ycorr)),
                        R=torch.from_numpy(np.array(jstate.R)),
                        varg=torch.from_numpy(np.array(jstate.varg)),
                        **latent_state_from_jax(jstate))
    monkeypatch.setattr(jmm, "gibbs_pass_general", lambda LHS, sol, rhs, key: sol)
    monkeypatch.setattr(jmk, "grouped_dense_sweep", lambda cg, md, sts, yc, key, gb: (sts, yc))
    monkeypatch.setattr(jmt, "mt_abc_blocks_I",
                        lambda md, a, b, d, yc, *args, **kw: (a, b, d, yc))
    monkeypatch.setattr(jmm, "sample_inv_wishart", lambda key, df, scale: jst.varg)
    want = jmm.make_mt_step(jcfg)(jst, jdata)

    keys = jax.random.split(jst.key, 11)
    k_res, k_sc = keys[6], keys[9]
    monkeypatch.setattr(tmm, "gibbs_pass_general", lambda A, x, b, gen: x)
    monkeypatch.setattr(tmt, "sweep_blocks_mt_abc_grouped",
                        lambda gm, a, b, d, yc, *args, **kw: (a, b, d, yc))
    monkeypatch.setattr(tmm, "sample_marker_covariance", lambda *a, **k: st.varg)
    lat_keys = jax.random.split(k_sc, 1)

    def z_of(ki, a, b):
        return torch.from_numpy(np.array(jax.random.truncated_normal(
            lat_keys[ki], jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), shape=a.shape,
            dtype=jnp.float32)))

    step = tmm.mt_latent_step
    monkeypatch.setattr(tmm, "mt_latent_step", lambda cfg, s, d: step(cfg, s, d, z_of=z_of))

    def korsgaard(gen, df, prec, binary, bartlett=None, Z=None):
        k1, k2 = jax.random.split(k_res)
        idx1 = [i for i in range(t) if i not in binary]
        V11 = jnp.asarray(prec.numpy())[jnp.ix_(jnp.asarray(idx1), jnp.asarray(idx1))]
        X1 = torch.from_numpy(np.array(jd.sample_wishart(k1, df, V11)))
        Z = torch.from_numpy(np.array(jax.random.normal(k2, (len(idx1), len(binary)))))
        return th.conditional_inv_wishart_korsgaard(prec, binary, X1, Z)

    monkeypatch.setattr(tv, "sample_conditional_inv_wishart_korsgaard", korsgaard)
    got = tmm.make_mt_step(cfg)(st, data)
    for k in ("liab", "ycorr", "R"):
        np.testing.assert_allclose(_np(getattr(got, k)), _np(getattr(want, k)), err_msg=k,
                                   **TOL)
    assert float(got.R[1, 1]) == 1.0
    assert not np.allclose(_np(got.liab)[1], _np(st.liab)[1])


# --------------------------------------------------------------- chains


@pytest.fixture(scope="module")
def binary_chain():
    """The port's chain of tests/test_threshold_traits.py's binary model
    (seed 7, its 800 sweeps), shared by the two tests that read it."""
    sim = _liability_sim()
    return sim, _run(jt, _model(jt, sim, categorical_trait=["y"]), binary_df(sim),
                     chain_length=800, burnin=160, seed=7)


def test_single_trait_binary(binary_chain):
    sim, out = binary_chain
    acc = _accuracy(out, sim)
    assert acc > 0.45, f"binary-trait EBV accuracy {acc:.3f}"
    assert float(out["residual variance"].Estimate[0]) == pytest.approx(1.0)


def test_single_trait_ordered_categorical():
    sim = _liability_sim(seed=6)
    out = _run(jt, _model(jt, sim, categorical_trait=["y"]), categorical_df(sim),
               chain_length=800 // SHORTER, burnin=160 // SHORTER, seed=8)
    acc = _accuracy(out, sim)
    assert acc > 0.45, f"4-category EBV accuracy {acc:.3f}"


def test_single_trait_censored():
    sim = _liability_sim(seed=9)
    out = _run(jt, _model(jt, sim, censored_trait=["y"]), censored_df(sim),
               chain_length=600 // SHORTER, burnin=120 // SHORTER, seed=10)
    acc = _accuracy(out, sim)
    assert acc > 0.5, f"censored EBV accuracy {acc:.3f}"


def test_multi_trait_binary_plus_continuous():
    sim = _liability_sim(seed=12)
    out = _run(jt, _model(jt, sim, "y = intercept + geno\ny2 = intercept + geno",
                          categorical_trait=["y2"]), mt_binary_df(sim),
               chain_length=600 // SHORTER, burnin=120 // SHORTER, seed=13)
    acc1, acc2 = _accuracy(out, sim, "y"), _accuracy(out, sim, "y2")
    assert acc1 > 0.5, f"continuous-trait accuracy {acc1:.3f}"
    assert acc2 > 0.35, f"binary-trait accuracy {acc2:.3f}"
    R = out["residual variance"]
    r22 = float(np.asarray(R.Estimate)[list(R.Covariance).index("y2_y2")])
    assert r22 == pytest.approx(1.0, abs=1e-5)


def binary_means(pkg, seed, sim=None, out=None):
    """The binary chain of test_single_trait_binary by pkg at seed (or its
    results out on sim): its posterior means of the marker-effect
    variance, the intercept and pi, and its EBV accuracy."""
    if out is None:
        sim = _liability_sim()
        out = _run(pkg, _model(pkg, sim, categorical_trait=["y"]), binary_df(sim),
                   chain_length=800, burnin=160, seed=seed)
    loc = out["location parameters"]
    return dict(varg=float(np.asarray(out["marker effects variances geno"]["Estimate"])[0]),
                intercept=float(np.asarray(loc["Estimate"])[0]),
                pi=float(np.asarray(out["pi_geno"]["Estimate"])[0]),
                acc=float(_accuracy(out, sim)))


# the spread (sd) of each package's posterior means over seeds 1..16 at the
# reference's 800 sweeps (python tests/test_torch_latent_runmcmc.py
# calibrate ..., summarize); their means over the seeds: varg 0.2243 /
# 0.2245, intercept 0.0228 / 0.0246, pi 0.8747 / 0.8748, accuracy 0.9076 /
# 0.9082 (port / jwas_tpu). The bounds Z99_3 sqrt(sd_port^2 + sd_jwas^2):
# varg 0.0486, intercept 0.0264, pi 0.0213.
CALIBRATED_SD = {
    "jwas_tpu_torch": dict(varg=0.014159, intercept=0.007065, pi=0.005829),
    "jwas_tpu": dict(varg=0.008555, intercept=0.005545, pi=0.004343),
}


def test_binary_chain_matches_jwas_tpu_within_monte_carlo_error(binary_chain):
    mp, mj = binary_means(jt, 7, *binary_chain), binary_means(jw, 7)
    for k in ("varg", "intercept", "pi"):
        sp, sj = CALIBRATED_SD["jwas_tpu_torch"][k], CALIBRATED_SD["jwas_tpu"][k]
        bound = Z99_3 * np.sqrt(sp ** 2 + sj ** 2)
        assert abs(mp[k] - mj[k]) <= bound, (k, mp[k], mj[k], bound)
    assert mp["acc"] > 0.45 and mj["acc"] > 0.45


if __name__ == "__main__":
    if sys.argv[1] == "calibrate":
        pkg = jt if sys.argv[2] == "port" else jw
        seed0, n = int(sys.argv[3]), int(sys.argv[4])
        rows = [binary_means(pkg, s) for s in range(seed0, seed0 + n)]
        with open(sys.argv[5], "w") as f:
            json.dump({"pkg": pkg.__name__, "rows": rows}, f)
    elif sys.argv[1] == "summarize":
        by = {}
        for path in sys.argv[2:]:
            with open(path) as f:
                d = json.load(f)
            by.setdefault(d["pkg"], []).extend(d["rows"])
        for name, rows in by.items():
            print(name, len(rows), {k: float(np.std([r[k] for r in rows], ddof=1))
                                    for k in rows[0]},
                  {k: float(np.mean([r[k] for r in rows])) for k in rows[0]})
