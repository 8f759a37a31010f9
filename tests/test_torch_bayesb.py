"""BayesB, starting values, prior updates and the per-marker pi of the
port, against jwas_tpu.

(a) BayesB's per-marker variance and scale draws, fed the same chi-square
    and gamma draws as jwas_tpu's, agree within rel 1e-6.
(b) A per-marker pi (linspace(0.1, 0.9) over 48 markers, estimatePi=false)
    is kept and padded with 1.0, as jwas_tpu keeps it (ROADMAP.md Queue 3
    item 1; earlier versions of the port collapsed it to its mean); the
    outer iteration's sweep then equals jwas_tpu's with its own draws
    injected.
(c) starting_value and the genotypes' starting values: the starting
    residual equals jwas_tpu's within rel 1e-5. jwas_tpu's get_genotypes
    drops starting_value on the 2-bit store, so its Genotypes gets
    starting_alpha set directly.
(d) update_priors_frequency: the refreshed scales equal jwas_tpu's
    _apply_update_priors on the same accumulators, and a runMCMC chain
    with it runs.
(e) BayesB through runMCMC against jwas_tpu.runMCMC at n = 400 x p = 2,048
    (fast_blocks = 8 -> b = 8, gb = 20, 13 groups, the last short), 2,000
    sweeps: posterior means within 99% Monte-Carlo bounds (see BOUNDS_B),
    EBVs correlated, and the same sample files.
"""

import os
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jwas_tpu
from jwas_tpu.engine import mcmc as jmcmc
from jwas_tpu.engine.setup import MCMCOptions as RefOptions
from jwas_tpu.engine.setup import prepare_workspace as ref_prepare
from jwas_tpu.io.datasets import simulate_genomic_data
from jwas_tpu.ops import grouped as jgr
from jwas_tpu.ops import variance as jvar
import jwas_tpu_torch as jt
from jwas_tpu_torch.engine import mcmc as tmcmc
from jwas_tpu_torch.engine.convert import from_jax_arrays
from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu_torch.ops import grouped as tgr
from jwas_tpu_torch.ops import variance as tvar

QUIET = dict(printout_model_info=False, fast_blocks=8, output_folder="")
# 99% bounds on the difference of one chain of each package: 2.576 sqrt(2)
# s, s the larger of the two packages' between-seed standard deviations of
# a chain's posterior mean, seeds 1-8 each (tests/test_torch_seed_spread.py
# run <package> 1 8 out.json BayesB): vare 2.085 (sd 0.121) jwas_tpu, 2.101
# (0.119) port; varg 0.005066 (8.38e-5), 0.005052 (4.51e-5); pi 0.0887
# (0.0584), 0.0777 (0.0623); every mean within 0.44 standard errors
BOUNDS_B = {"vare": 0.45, "varg": 0.00031, "pi": 0.23}


@pytest.fixture(scope="module", autouse=True)
def _float32():
    jax.config.update("jax_enable_x64", False)


def test_bayesb_draws_match_jax():
    """Per-marker variances and the scale, padding included, from the
    draws jwas_tpu makes with its keys."""
    rng = np.random.default_rng(0)
    p_pad, p, df, scale = 1000, 960, 4.0, 0.013
    beta = (rng.normal(size=p_pad) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    chi = 2.0 * jax.random.gamma(key, jnp.full((p_pad,), (1.0 + df) / 2.0))
    want = np.asarray(jvar.sample_marker_variance_bayesb(key, jnp.asarray(beta), df,
                                                         jnp.float32(scale)))
    got = tvar.bayesb_variance(torch.from_numpy(beta), df, torch.tensor(scale),
                               torch.from_numpy(np.array(chi)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the scale draw of jwas_tpu/engine/mcmc.py:478-482
    valid = jnp.asarray((np.arange(p_pad) < p).astype(np.float32))
    varg = jnp.where(valid > 0, jnp.asarray(want), 1.0)
    a = p * df / 2.0 + 1.0
    b = jnp.sum(jnp.where(valid > 0, df / (2.0 * varg), 0.0)) + 1.0
    gam = jax.random.gamma(jax.random.PRNGKey(6), a)
    got = tvar.bayesb_scale(torch.from_numpy(np.array(varg)),
                            torch.from_numpy(np.array(valid)), df,
                            torch.tensor(float(gam)))
    np.testing.assert_allclose(float(got), float(gam / b), rtol=1e-6)
    # the sampling wrappers draw one chi-square a marker and one gamma
    gen = torch.Generator().manual_seed(1)
    v = tvar.sample_marker_variance_bayesb(gen, torch.from_numpy(beta), df,
                                           torch.tensor(scale))
    assert v.shape == (p_pad,) and bool((v > 0).all())
    s = tvar.sample_scale_bayesb(gen, v, torch.from_numpy(np.array(valid)), p, df)
    assert s.dim() == 0 and float(s) > 0


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """n = 100, p = 48 with missing codes, phenotypes shuffled; b = 8, gb =
    5: two groups of 40, p_pad = 80."""
    sim = simulate_genomic_data(n=100, p=48, n_qtl=5, h2=0.5, seed=4)
    path = str(tmp_path_factory.mktemp("small") / "geno")
    geno = sim["genotypes"].copy()
    geno.iloc[3, 5] = 9
    jwas_tpu.prepare_packed_genotypes(geno, save_path=path)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=2).reset_index(drop=True)
    rng = np.random.default_rng(1)
    pheno["herd"] = rng.integers(1, 4, len(pheno))
    return dict(path=path, pheno=pheno)


def _models(path, eq="y = intercept + geno", **geno):
    """The same model in jwas_tpu and in the port, on the store at path."""
    return [pkg.build_model(eq, genotypes=pkg.get_genotypes(
                pkg.Packed2BitStore.load(path), storage="2bit", **geno))
            for pkg in (jwas_tpu, jt)]


def test_per_marker_pi_is_kept_and_swept_as_jwas_tpu(small):
    pi = np.linspace(0.1, 0.9, 48)
    opts = dict(QUIET, chain_length=8, seed=1)
    ref_model, port_model = _models(small["path"], method="BayesC", Pi=pi,
                                    estimatePi=False)
    ws_r = ref_prepare(ref_model, small["pheno"], RefOptions(**opts))
    _, data_r, st_r = jmcmc._build_st_data_and_state(ws_r, RefOptions(**opts),
                                                     jnp.float32)
    ws = prepare_workspace(port_model, small["pheno"], MCMCOptions(**opts))
    cfg, _, st = tmcmc._build_st_data_and_state(ws, MCMCOptions(**opts), "cpu")
    want = np.concatenate([pi, np.ones(32)]).astype(np.float32)
    assert np.array_equal(st.pi.numpy(), want)
    assert np.array_equal(st.pi.numpy(), np.asarray(st_r.pi))

    # one outer iteration's sweep (nreps = 8, a sync every 8) with JAX's
    # draws, from the residual as the location pass leaves it (centred)
    n, b, gb = ws.n_obs, 8, 5
    ycorr = st_r.ycorr - jnp.mean(st_r.ycorr)
    gmj = jgr.GroupedPackedMarkers(data_r.packed, data_r.packed_means, data_r.row_perm,
                                   data_r.xpx, data_r.grams, data_r.valid)
    key = jax.random.PRNGKey(9)
    ref = jgr.sweep_blocks_abc_grouped(
        gmj, st_r.alpha, st_r.beta, st_r.delta, ycorr, None, st_r.vare,
        st_r.varg, st_r.pi, key, nreps=cfg.nreps, sync_every=cfg.sync_every)
    gm, s = from_jax_arrays(np.asarray(data_r.packed), data_r.packed_means,
                            data_r.valid, data_r.xpx, data_r.grams, n,
                            data_r.row_perm, alpha=st_r.alpha, beta=st_r.beta,
                            delta=st_r.delta, ycorr=ycorr, vare=st_r.vare,
                            varg=st_r.varg)
    got = tgr.sweep_blocks_abc_grouped(
        gm, s["alpha"], s["beta"], s["delta"], s["ycorr"], s["vare"], s["varg"],
        st.pi, None, nreps=cfg.nreps, sync_every=cfg.sync_every,
        draws=_jax_draws(key, b, gb))
    a, be, d, yc = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(got[2].numpy(), d)
    np.testing.assert_allclose(got[0].numpy(), a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), be, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), yc, rtol=1e-4, atol=1e-5)


def _jax_draws(key, b, gb):
    """The uniform and normal panels jwas_tpu's grouped sweep draws for
    round r of group g (as tests/test_torch_grouped.py rebuilds them)."""
    def draws(g, r, reps):
        kr = jax.random.fold_in(jax.random.fold_in(key, g), r)
        ku, kz = jax.random.split(kr)
        us = jax.random.uniform(ku, (reps * b, gb), dtype=jnp.float32)
        zs = jax.random.normal(kz, (reps * b, gb), dtype=jnp.float32)
        return torch.from_numpy(np.array(us)), torch.from_numpy(np.array(zs))
    return draws


def test_starting_values_give_jwas_tpus_starting_residual(small):
    """y = intercept + herd + geno: 4 location parameters and 48 effects
    from a seed; the starting residual y - W sol - X alpha of both packages
    (the port's X alpha one K5 pass over the store), and the length check."""
    rng = np.random.default_rng(3)
    sv = rng.normal(size=4)
    alpha0 = (rng.normal(size=48) * 0.2).astype(np.float32)
    eq = "y = intercept + herd + geno"
    opts = dict(QUIET, chain_length=8, starting_value=sv)
    ref_model, _ = _models(small["path"], eq)
    ref_model.M[0].starting_alpha = alpha0
    port_model = jt.build_model(eq, genotypes=jt.get_genotypes(
        jt.Packed2BitStore.load(small["path"]), storage="2bit",
        starting_value=alpha0))
    assert np.array_equal(port_model.M[0].starting_alpha, alpha0)
    ws_r = ref_prepare(ref_model, small["pheno"], RefOptions(**opts))
    _, _, st_r = jmcmc._build_st_data_and_state(ws_r, RefOptions(**opts), jnp.float32)
    ws = prepare_workspace(port_model, small["pheno"], MCMCOptions(**opts))
    _, _, st = tmcmc._build_st_data_and_state(ws, MCMCOptions(**opts), "cpu")
    assert ws.obs_ids == [str(s) for s in ws_r.obs_ids]
    np.testing.assert_allclose(st.sol.numpy(), np.float32(sv), rtol=0)
    np.testing.assert_allclose(st.alpha.numpy()[:48], alpha0, rtol=0)
    want = np.asarray(st_r.ycorr)
    err = np.abs(st.ycorr.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-5, err
    with pytest.raises(ValueError, match="length of starting values"):
        tmcmc._build_st_data_and_state(ws, MCMCOptions(**dict(opts, starting_value=sv[:3])),
                                       "cpu")
    with pytest.raises(ValueError, match="one effect for each"):
        jt.get_genotypes(jt.Packed2BitStore.load(small["path"]), starting_value=alpha0[:5])
    port_model = jt.build_model(eq, genotypes=jt.get_genotypes(
        jt.Packed2BitStore.load(small["path"]), starting_value=alpha0))
    out = jt.runMCMC(port_model, small["pheno"], device="cpu", seed=1, **opts)
    assert np.isfinite(out["EBV_y"].EBV).all()


def test_update_priors_match_jwas_tpu(small):
    """_apply_update_priors of both packages on the same accumulators:
    the marker scale (not BayesB's) and the residual scale."""
    RefData = namedtuple("RefData", "vc_scale scale_r")
    RefState = namedtuple("RefState", "scale_g")
    RefCfg = namedtuple("RefCfg", "method df_marker df_residual re_groups")
    RefAccum = namedtuple("RefAccum", "varg_m vare_m vc_m")
    for method in ("BayesC", "BayesB", "BayesR"):
        acc = dict(varg_m=np.float32(0.0123), vare_m=np.float32(2.71))
        d_r, s_r = jmcmc._apply_update_priors(
            RefCfg(method, 4.5, 5.0, ()), RefData((), np.float32(1.0)),
            RefState(np.float32(0.5)), RefAccum(vc_m=(), **acc))
        cfg = tmcmc.EngineCfg(method=method, n_obs=10, n_markers=5, estimate_pi=True,
                              estimate_marker_variance=True, estimate_scale=False,
                              estimate_residual_variance=True, nreps=8, sync_every=8,
                              df_residual=5.0, df_marker=4.5)
        state = tmcmc.ChainState(gen=None, sol=None, alpha=None, beta=None, delta=None,
                                 ycorr=None, vare=None, varg=None, pi=None,
                                 scale_g=torch.tensor(0.5))
        data = tmcmc.STData(W=None, WtW=None, y=None, gm=None,
                            scale_r=torch.tensor(1.0), ebv_rows=None, out_W=None)
        accum = tmcmc.Accum(*([None] * 16))._replace(
            **{k: torch.tensor(v) for k, v in acc.items()})
        d, s = tmcmc.apply_update_priors(cfg, data, state, accum)
        assert float(d.scale_r) == pytest.approx(float(d_r.scale_r), rel=1e-6)
        assert float(s.scale_g) == pytest.approx(float(s_r.scale_g), rel=1e-6)
        assert (float(s.scale_g) == 0.5) == (method == "BayesB")
    # through runMCMC: a refresh every 16 sweeps moves the marker scale
    outs = [jt.runMCMC(_models(small["path"])[1], small["pheno"], device="cpu",
                       seed=4, chain_length=64, update_priors_frequency=k, **QUIET)
            for k in (16, 0)]
    for out in outs:
        assert np.isfinite(out["residual variance"].Estimate).all()
    assert outs[0]["residual variance"].Estimate[0] != outs[1]["residual variance"].Estimate[0]


@pytest.fixture(scope="module")
def bayesb(tmp_path_factory):
    sim = simulate_genomic_data(n=400, p=2048, n_qtl=20, h2=0.5, seed=11)
    folder = tmp_path_factory.mktemp("bayesb")
    path = str(folder / "geno")
    jwas_tpu.prepare_packed_genotypes(sim["genotypes"], save_path=path)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=1).reset_index(drop=True)
    return dict(path=path, pheno=pheno, folder=folder,
                tbv=dict(zip(sim["phenotypes"].ID.astype(str), sim["true_bv"])))


def test_bayesb_chain_matches_jwas_tpu_within_mc_error(bayesb):
    opts = dict(QUIET, chain_length=2000, burnin=400, seed=7)
    ref_model, model = _models(bayesb["path"], method="BayesB")
    ref = jwas_tpu.runMCMC(ref_model, bayesb["pheno"], **opts)
    out = jt.runMCMC(model, bayesb["pheno"], device="cpu", **opts)
    for key, k in (("residual variance", "vare"),
                   ("marker effects variances geno", "varg"), ("pi_geno", "pi")):
        got, want = out[key].Estimate[0], ref[key].Estimate[0]
        assert abs(got - want) < BOUNDS_B[k], (k, got, want, BOUNDS_B[k])
    ours = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    theirs = dict(zip(ref["EBV_y"].ID, ref["EBV_y"].EBV))
    ids = list(theirs)
    r = np.corrcoef([ours[s] for s in ids], [theirs[s] for s in ids])[0, 1]
    acc = [np.corrcoef([e[s] for s in ids], [bayesb["tbv"][s] for s in ids])[0, 1]
           for e in (ours, theirs)]
    print(f"BayesB: EBV correlation {r:.4f}; accuracy port {acc[0]:.4f}, jwas_tpu "
          f"{acc[1]:.4f}; varg_mean port {out['marker effects variances geno'].Estimate[0]:.6g}, "
          f"jwas_tpu {ref['marker effects variances geno'].Estimate[0]:.6g}")
    assert r >= 0.95, r
    assert acc[0] > acc[1] - 0.05


def test_bayesb_sample_files_match_jwas_tpu(bayesb):
    """A short BayesB run of each package into a folder: the same files;
    the variance file holds one variance a marker a saved sample."""
    folders = [str(bayesb["folder"] / d) for d in ("ref_out", "port_out")]
    opts = dict(QUIET, chain_length=32, output_samples_frequency=8, seed=2)
    opts.pop("output_folder")
    ref_model, model = _models(bayesb["path"], method="BayesB")
    jwas_tpu.runMCMC(ref_model, bayesb["pheno"], output_folder=folders[0], **opts)
    out = jt.runMCMC(model, bayesb["pheno"], device="cpu", output_folder=folders[1],
                     **opts)
    assert sorted(os.listdir(folders[1])) == sorted(os.listdir(folders[0]))
    name = "MCMC_samples_marker_effects_variances_geno.txt"
    for folder in folders:
        rows = open(os.path.join(folder, name)).read().splitlines()
        assert len(rows) == 4 and all(len(r.split(",")) == 2048 for r in rows)
    mean = np.mean([float(x) for x in rows[-1].split(",")])
    assert np.isfinite(out["marker effects variances geno"].Estimate).all() and mean > 0
