"""The port's multi-trait RR-BLUP / BayesL against jwas_tpu's, fed the same
draws.

The marker update (ops/multitrait.py::mt_c0l_marker_update_ref against
_mt_c0l_marker_update) at t = 2, 3 and 4; the group-sequential sweep
(sweep_blocks_mt_c0l_grouped over a DenseMarkers, through the wrapper's
plain version of K9) against grouped_dense_sweep with mt_c0l_blocks, JAX's
normals rebuilt from its keys as fold_in(fold_in(key, g), r) -> normal
(jwas_tpu/ops/multitrait.py:459-466), RR-BLUP and BayesL, float32 and
float64, with and without residual weights, a remainder round among them;
the exact form (one block a group, nreps = 1) against mt_c0l_exact, its
(p, t) panel served in marker order by ops/dense.py::sweep_draws.
Tolerances of tests/test_torch_c0l.py: alpha rtol 1e-5 / atol 1e-6 in
float32 and 1e-10 / 1e-12 in float64, ycorr 1e-4 / 1e-5 and 1e-10 /
1e-12; padding stays exactly 0. One outer iteration of runMCMC's
multi-trait RR-BLUP and BayesL (and their mega-trait forms) in float64
from the same state: jwas_tpu's step against the port's make_mt_step fed
jwas_tpu's draws (the location pass, the sweep, the Bartlett factors of
the marker and residual covariances, BayesL's Gamma((t + 1) / 2)
candidates and uniforms; the mega-trait sweeps' panels of each trait's
key), every piece of the state to rtol 1e-9: the weighted covariance
draws, the gamma step and the prior scale BayesL divides by 4 (t + 1).
The prior update's fields from one accumulator against
_apply_update_priors_mt. The RR-BLUP chain within calibrated Monte-Carlo
bounds of jwas_tpu.runMCMC (tests/test_torch_mt_runmcmc.py's CHAINS), its
result tables and sample files with jwas_tpu's names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jwas_tpu as jw
import jwas_tpu_torch as jt
from jwas_tpu.io.datasets import simulate_genomic_data_mt
from jwas_tpu.ops import markers as jmk
from jwas_tpu.ops import multitrait as jmt
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops import multitrait as tmt

from test_torch_mt_runmcmc import check_chain

TOL = {"float32": dict(alpha=(1e-5, 1e-6), ycorr=(1e-4, 1e-5)),
       "float64": dict(alpha=(1e-10, 1e-12), ycorr=(1e-10, 1e-12))}


@pytest.fixture(autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, dtype, key):
    rtol, atol = TOL[dtype][key]
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _covs(t, rng, dtype):
    A = rng.normal(size=(t, t))
    R = A @ A.T / t + np.eye(t)
    B = rng.normal(size=(t, t))
    G = 0.06 * (B @ B.T / t + np.eye(t))
    return R.astype(dtype), G.astype(dtype)


@pytest.mark.parametrize("t", [2, 3, 4])
@pytest.mark.parametrize("bayesl", [False, True])
def test_marker_update_matches_jax(t, bayesl):
    """One marker of each of B = 64 blocks, random w, effects, normals and
    (BayesL) per-marker gamma."""
    B = 64
    rng = np.random.default_rng(7 * t + bayesl)
    R, G = _covs(t, rng, np.float32)
    Rinv, Ginv = np.linalg.inv(R).astype(np.float32), np.linalg.inv(G).astype(np.float32)
    xpx = rng.uniform(20.0, 80.0, B).astype(np.float32)
    gamma = (rng.uniform(0.2, 3.0, B) if bayesl else np.ones(B)).astype(np.float32)
    w = (rng.normal(size=(t, B)) * rng.uniform(0.1, 8.0, B)).astype(np.float32)
    a = (0.2 * rng.normal(size=(t, B))).astype(np.float32)
    z = rng.normal(size=(t, B)).astype(np.float32)
    want = jmt._mt_c0l_marker_update(
        jnp.asarray(w), jnp.asarray(a), jnp.asarray(xpx), jnp.asarray(Rinv),
        jnp.asarray(Ginv[:, :, None] / gamma[None, None, :]), jnp.asarray(z))
    P, Q, S = tmt.mt_c0l_constants(_t(xpx), _t(Rinv), _t(Ginv), _t(gamma),
                                   torch.ones(B, dtype=torch.float32))
    rhs = _t(w.T) - _t(xpx)[:, None] * _t(a.T)
    got = tmt.mt_c0l_marker_update_ref(rhs, _t(a.T), P, Q, S, _t(z.T))
    np.testing.assert_allclose(got.numpy().T, np.asarray(want), rtol=1e-5, atol=1e-6)


def _jax_normals(key, b, gb, t, dtype, grouped=True):
    """draws(g, r, reps) of JAX's normal panels: (reps b, t, gb), or
    (reps b, gb) for t None (a single-trait sweep), from fold_in(fold_in(key,
    g), r) (fold_in(key, r) for a flat sweep, grouped False)."""
    def draws(g, r, reps):
        kr = jax.random.fold_in(jax.random.fold_in(key, g) if grouped else key, r)
        shape = (reps * b, gb) if t is None else (reps * b, t, gb)
        return (_t(jax.random.normal(kr, shape, dtype)),)
    return draws


@pytest.mark.parametrize("bayesl,dtype,weighted,nreps,sync_every", [
    (False, "float32", False, 1, None), (True, "float32", True, 3, 2),
    (False, "float64", True, 3, 2), (True, "float64", False, 2, None)])
def test_grouped_sweep_matches_jax(bayesl, dtype, weighted, nreps, sync_every):
    """b = 8, 12 blocks of which the last is ragged (p = 94), gb from
    stable_group_blocks; with sync_every = 2 a remainder round."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    np_dt = np.dtype(dtype)
    n, p, b, t = 60, 94, 8, 3 if bayesl else 2
    rng = np.random.default_rng(30 + bayesl)
    X = rng.integers(0, 3, size=(n, p)).astype(np_dt)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n).astype(np_dt)
    R, G = _covs(t, rng, np_dt)
    w = rinv if weighted else None
    md = jmk.build_marker_blocks(jnp.asarray(X), None if w is None else jnp.asarray(w),
                                 block_size=b)
    nblocks = md.grams.shape[2]
    gb = jmk.stable_group_blocks(n, b, nblocks)
    assert 1 < gb < nblocks
    pp = nblocks * b
    real = np.arange(pp) < p
    alpha = np.where(real, 0.05 * rng.normal(size=(t, pp)), 0.0).astype(np_dt)
    gamma = (np.where(real, rng.uniform(0.3, 3.0, pp), 1.0) if bayesl
             else np.ones(pp)).astype(np_dt)
    y = rng.normal(size=(t, n)).astype(np_dt)
    ginv = np.linalg.inv(G).astype(np_dt)
    key = jax.random.PRNGKey(t)

    def cg(md_g, sts, yc, g, kg):
        a, gam = sts
        a, yc = jmt.mt_c0l_blocks(md_g, a, yc, None if w is None else jnp.asarray(w),
                                  jnp.asarray(R), jnp.asarray(ginv), gam, kg,
                                  nreps=nreps, sync_every=sync_every)
        return (a, gam), yc

    out, yc = jmk.grouped_dense_sweep(cg, md, (jnp.asarray(alpha), jnp.asarray(gamma)),
                                      jnp.asarray(y), key, gb)
    tdt = getattr(torch, dtype)
    dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=w, dtype=tdt)
    a, ycr = _t(alpha), _t(y)
    tmt.sweep_blocks_mt_c0l_grouped(
        dm, a, ycr, _t(R), _t(ginv), _t(gamma) if bayesl else None, None, nreps=nreps,
        sync_every=sync_every, draws=_jax_normals(key, b, gb, t, np_dt))
    _close(a.numpy(), out[0], dtype, "alpha")
    _close(ycr.numpy(), yc, dtype, "ycorr")
    assert not a[:, p:].any()


@pytest.mark.parametrize("bayesl", [False, True])
def test_exact_sweep_matches_jax(bayesl):
    """p = 70 in chunks of b = 32 (the last 6 markers), weighted: the
    grouped sweep over a store of one block a group with nreps = 1, against
    mt_c0l_exact."""
    n, p, t, b = 50, 70, 3, 32
    rng = np.random.default_rng(41)
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    R, G = _covs(t, rng, np.float32)
    key = jax.random.PRNGKey(42)
    dm = td.build_dense_markers(_t(np.ascontiguousarray(X.T)), n, b, 1, rinv=_t(rinv),
                                exact=True)
    pp = dm.valid.shape[0]
    alpha = (0.05 * rng.normal(size=(t, p))).astype(np.float32)
    gamma = (rng.uniform(0.3, 3.0, p) if bayesl else np.ones(p)).astype(np.float32)
    y = rng.normal(size=(t, n)).astype(np.float32)
    ginv = np.linalg.inv(G).astype(np.float32)
    xpx = np.einsum("np,np->p", X * rinv[:, None], X)
    ra, ryc = jmt.mt_c0l_exact(jnp.asarray(X), jnp.asarray(xpx), jnp.asarray(alpha),
                               jnp.asarray(y), jnp.asarray(rinv), jnp.asarray(R),
                               jnp.asarray(ginv), jnp.asarray(gamma), key)
    zs = jax.random.normal(key, (p, t, 1))
    a = torch.zeros((t, pp))
    a[:, :p] = _t(alpha)
    gam = torch.ones(pp)
    gam[:p] = _t(gamma)
    ycr = _t(y)
    draws = td.sweep_draws(b, _t(zs)[..., 0])
    tmt.sweep_blocks_mt_c0l_grouped(
        dm, a, ycr, _t(R), _t(ginv), gam if bayesl else None, None, nreps=1,
        draws=lambda g, r, reps: tuple(x.mT for x in draws(g, r, reps)))
    assert not a[:, p:].any()
    np.testing.assert_allclose(a.numpy()[:, :p], np.asarray(ra), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ycr.numpy(), np.asarray(ryc), rtol=1e-4, atol=1e-5)


def _setup_both(method, constraint, sim, **opt_kw):
    """Both packages' (cfg, data, state) of y1 y2 = intercept + geno,
    method on a float64 dense store, fast_blocks 8 (GBLUP: its
    eigenbasis)."""
    import jwas_tpu.engine.mcmc_mt as jmm
    from jwas_tpu.engine.setup import MCMCOptions as JOpts
    from jwas_tpu.engine.setup import prepare_workspace as j_prepare
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.engine.setup import MCMCOptions as TOpts
    from jwas_tpu_torch.engine.setup import prepare_workspace as t_prepare

    built = {}
    for pkg, Opts, prepare in ((jw, JOpts, j_prepare), (jt, TOpts, t_prepare)):
        kw = dict(device="cpu") if pkg is jt else {}
        geno = pkg.get_genotypes(sim["genotypes"], method=method, name="geno",
                                 constraint=constraint, **kw)
        model = pkg.build_model("y1 = intercept + geno\ny2 = intercept + geno",
                                genotypes=geno)
        opts = Opts(chain_length=10, seed=1, output_folder="", double_precision=True,
                    fast_blocks=False if method == "GBLUP" else 8, nreps=2, **opt_kw)
        built[pkg] = (prepare(model, sim["phenotypes"], opts, **kw), opts)
    return (jmm.build_mt_data_and_state(*built[jw], jnp.float64),
            tm.build_mt_data_and_state(*built[jt], "cpu"))


def step_on_jwas_draws(method, constraint, monkeypatch):
    """One outer iteration of y1 y2 = intercept + geno in float64 from one
    state: jwas_tpu's step and the port's make_mt_step fed jwas_tpu's
    draws. Returns (want, got, jcfg, cfg, jdata, data, jstate, state)."""
    import jwas_tpu.engine.mcmc_mt as jmm
    from jwas_tpu.ops import dists as jd
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.ops import gblup as tg
    from jwas_tpu_torch.ops import grouped as tgr
    from jwas_tpu_torch.ops import variance as tv

    jax.config.update("jax_enable_x64", True)
    sim = simulate_genomic_data_mt(n=60, p=40, n_qtl=6, h2=(0.5, 0.4), rg=0.5, re=0.2,
                                   seed=9)
    (jcfg, jdata, jstate), (cfg, data, state) = _setup_both(method, constraint, sim)
    if method == "GBLUP":
        # one eigenbasis for both (eigenvectors' signs are arbitrary)
        jdata = jdata._replace(X=jnp.asarray(data.gm.L.numpy()),
                               xpx=jnp.asarray(data.gm.D.numpy()))
    t, p_pad = 2, state.alpha.shape[1]
    assert jstate.alpha.shape == state.alpha.shape
    rng = np.random.default_rng(4)
    common = dict(sol=0.1 * rng.normal(size=state.sol.shape[0]),
                  alpha=np.where(np.asarray(data.gm.valid) > 0,
                                 0.05 * rng.normal(size=(t, p_pad)), 0.0),
                  ycorr=rng.normal(size=state.ycorr.shape))
    if method == "BayesL":
        common["gamma_l"] = np.where(np.asarray(data.gm.valid) > 0,
                                     rng.uniform(0.3, 3.0, p_pad), 1.0)
    jst = jstate._replace(**{k: jnp.asarray(v) for k, v in common.items()})
    st = state._replace(**{k: torch.from_numpy(v.copy()) for k, v in common.items()})
    want = jmm.make_mt_step(jcfg)(jst, jdata)

    keys = jax.random.split(jst.key, 11)
    k_loc, k_mark, k_var, k_gam, k_res = (keys[i] for i in (1, 2, 4, 5, 6))
    f64 = jnp.float64

    def T(x):
        return torch.from_numpy(np.array(x))

    K = st.sol.shape[0]
    pass_ = tm.gibbs_pass_general
    monkeypatch.setattr(tm, "gibbs_pass_general", lambda A, x, b, gen: pass_(
        A, x, b, gen, zs=T(jax.random.normal(k_loc, (K,), f64))))
    if method == "GBLUP" and constraint:
        zt = [T(jax.random.normal(kt, (p_pad,), f64)) for kt in jax.random.split(k_mark, t)]
        sweep = tg.sweep_gblup
        monkeypatch.setattr(tm, "sweep_gblup",
                            lambda *a: sweep(*a, z=zt.pop(0)))
    elif method == "GBLUP":
        gblup = tmt.mt_gblup
        monkeypatch.setattr(tmt, "mt_gblup", lambda *a: gblup(
            *a, z=T(jax.random.normal(k_mark, (p_pad, t), f64))))
    else:
        b = data.gm.grams.shape[1]
        gb = jcfg.group_blocks or data.gm.grams.shape[0]
        assert data.gm.ngroups * gb == data.gm.grams.shape[0]
        grouped = jcfg.group_blocks > 0
        if constraint:
            panels = [_jax_normals(kt, b, gb, None, f64, grouped)
                      for kt in jax.random.split(k_mark, t)]
            sweep = tgr.sweep_blocks_c0l_grouped
            monkeypatch.setattr(tm, "sweep_blocks_c0l_grouped", lambda *a, **kw: sweep(
                *a, draws=panels.pop(0), **kw))
        else:
            sweep = tmt.sweep_blocks_mt_c0l_grouped
            monkeypatch.setattr(tmt, "sweep_blocks_mt_c0l_grouped", lambda *a, **kw: sweep(
                *a, draws=_jax_normals(k_mark, b, gb, t, f64, grouped), **kw))

    def bartlett(key, df):
        return T(jd._standard_wishart_chol(key, df, t, f64))

    if constraint:
        # the diagonal covariance's one chi-square a trait, from k_var
        monkeypatch.setattr(tv, "sample_chi2", lambda gen, df: T(jd.sample_chi2(
            k_var, jnp.full(df.shape, df.reshape(-1)[0].item(), f64))))
    else:
        cov = tm.sample_marker_covariance
        monkeypatch.setattr(tm, "sample_marker_covariance",
                            lambda gen, e, valid, n, df, scale, constraint: cov(
                                gen, e, valid, n, df, scale, constraint,
                                bartlett(k_var, df + n)))
    if method == "BayesL":
        kc, ku = jax.random.split(k_gam)
        monkeypatch.setattr(tv, "sample_gamma_like", lambda gen, shape, like: T(
            jax.random.gamma(kc, jnp.full(like.shape, shape, f64))))
        rand = torch.rand
        monkeypatch.setattr(tv.torch, "rand", lambda shape, **kw: T(
            jax.random.uniform(ku, tuple(shape), f64)) if tuple(shape) == (p_pad,)
            else rand(shape, **kw))
    res = tm.sample_residual_covariance
    monkeypatch.setattr(tm, "sample_residual_covariance",
                        lambda gen, yc, rinv, n, df, scale, rc: res(
                            gen, yc, rinv, n, df, scale, rc, bartlett(k_res, df + n)))
    got = tm.make_mt_step(cfg)(st, data)
    return want, got, jcfg, cfg, jdata, data, jstate, state


def check_step(want, got, method):
    tol = dict(rtol=1e-9, atol=1e-12)
    for k in ("sol", "alpha", "ycorr", "varg", "R"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   err_msg=k, **tol)
    if method == "BayesL":
        np.testing.assert_allclose(got.gamma_l.numpy(), np.asarray(want.gamma_l), **tol)


def check_setup(method, constraint, jcfg, cfg, jdata, data, jstate, state):
    """The priors at set-up (BayesL: the marker covariance and scale divided
    by 4 (t + 1); G.constraint: df - t and the diagonal scale), gamma's
    padding at 1."""
    assert cfg.df_marker == jcfg.df_marker and cfg.constraint == constraint
    np.testing.assert_allclose(data.marker_scale.numpy(), np.asarray(jdata.marker_scale),
                               rtol=1e-12)
    np.testing.assert_allclose(state.varg.numpy(), np.asarray(jstate.varg), rtol=1e-12)
    if method == "BayesL":
        real = data.gm.valid > 0
        assert torch.all(state.gamma_l[~real] == 1.0) and torch.all(state.gamma_l[real] > 0)


@pytest.mark.parametrize("method,constraint", [("RR-BLUP", False), ("BayesL", False)])
def test_step_matches_jwas_tpu_on_its_draws(method, constraint, monkeypatch):
    """One outer iteration on jwas_tpu's draws (step_on_jwas_draws) and the
    set-up (check_setup); the mega-trait BayesL step is in
    tests/test_torch_mt_gblup.py, beside the mega-trait GBLUP step."""
    want, got, *built = step_on_jwas_draws(method, constraint, monkeypatch)
    check_setup(method, constraint, *built)
    check_step(want, got, method)


def test_prior_update_matches_jwas_tpu():
    """apply_update_priors_mt's fields from one accumulator against
    _apply_update_priors_mt: the marker scale, the residual scale and a
    pedigree group's scale (an i.i.d. group's kept)."""
    import jwas_tpu.engine.mcmc_mt as jmm
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.engine.state import MTEngineCfg, REGroupCfg

    rng = np.random.default_rng(3)
    groups = (REGroupCfg(starts=(1, 9), n_levels=8, df=6.0, has_vinv=True,
                         random_type="A", estimate_variance=True),
              REGroupCfg(starts=(17,), n_levels=5, df=4.0, has_vinv=False,
                         random_type="I", estimate_variance=True))
    cfg = MTEngineCfg(method="BayesL", n_obs=90, n_markers=40, estimate_pi=False,
                      estimate_marker_variance=True, estimate_scale=False,
                      estimate_residual_variance=True, nreps=1, sync_every=1,
                      df_residual=7.0, df_marker=6.5, re_groups=groups, n_traits=2)
    vc_m = (np.cov(rng.normal(size=(2, 9))), np.array([[0.7]]))
    accum = dict(R_m=np.cov(rng.normal(size=(2, 9))), varg_m=np.cov(rng.normal(size=(2, 9))),
                 vc_m=vc_m)
    scales = dict(scale_R=np.eye(2), marker_scale=2 * np.eye(2),
                  vc_scale=(3 * np.eye(2), np.array([[0.5]])))
    jcfg = type("Cfg", (), dict(n_traits=2, method="BayesL", df_marker=6.5,
                                df_residual=7.0, re_groups=groups))
    want = jmm._apply_update_priors_mt(
        jcfg, type("D", (), dict(vc_scale=scales["vc_scale"],
                                 _replace=lambda self, **kw: kw))(),
        type("A", (), accum))
    data = type("D", (), dict(vc_scale=tuple(torch.from_numpy(v) for v in scales["vc_scale"]),
                              _replace=lambda self, **kw: kw))()
    got = tm.apply_update_priors_mt(
        cfg, data, type("A", (), {k: (tuple(torch.from_numpy(x) for x in v)
                                      if isinstance(v, tuple) else torch.from_numpy(v))
                                  for k, v in accum.items()}))
    assert sorted(got) == sorted(want)
    for k in ("scale_R", "marker_scale"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12)
    for g, w in zip(got["vc_scale"], want["vc_scale"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12)


def test_rr_blup_chain_matches_jwas_tpu_within_monte_carlo_error(tmp_path):
    check_chain("RR-BLUP", tmp_path, files=True)
