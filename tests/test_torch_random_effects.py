"""Random effects (i.i.d., pedigree and user-given Vinv groups) in the port
against jwas_tpu, on the CPU.

(1) assemble_lhs_lambda (ops/location.py) against jwas_tpu's
    (engine/mcmc.py:86-106) for i.i.d., pedigree (k = 1 and k = 2) and
    Vinv groups, jwas_tpu's state carried across by engine/convert.py:
    rtol 1e-6 (float32 sums in another order); the port's LHS is exactly
    symmetric.
(2) The plain gibbs_pass_lambda against jwas_tpu's (a lax.scan) on such an
    LHS (K = 289), jwas_tpu's normal draws injected: rtol 1e-5, atol 1e-6
    of max |x| (float32 dot products of K terms in another order).
(3) The inverse-Wishart draw with jwas_tpu's Bartlett factor injected
    equals jwas_tpu's sample_inv_wishart to rtol 1e-6; the port's own
    draws' mean lies within 4 standard errors of scale / (df - k - 1);
    the group covariance draw against jwas_tpu's sample_random_effect_vc.
(4) set_random's ValueErrors are jwas_tpu's; the workspace's groups
    (starts, levels, Vinv, default G, df, scale), design, output IDs and
    prediction terms equal jwas_tpu's prepare_workspace's.
(5) Whole chains through runMCMC against jwas_tpu.runMCMC on
    simulate_pedigree_genomic_data (40 founders, 3 generations of 80,
    p = 200; the 240 non-founders phenotyped, 8 herds, the dam's ID), 600
    sweeps, 100 burn-in: "ID_geno" y = intercept + ID + geno on the 2-bit
    and the f32 stores (BayesC, default blocks), "herd_ID_dam" y = intercept + herd + ID + dam
    without genotypes (herd i.i.d., "ID dam" a pedigree group with a 2 x 2
    G), "V" y = intercept + herd + ID with ID a Vinv group (A^-1 given as
    Vinv). Posterior means within the 99% Monte-Carlo BOUNDS (calibrated
    below, as tests/test_torch_bayesb.py sets them), the posterior EBVs'
    correlation at least EBV_CORR, and the result keys and sample-file
    headers equal to jwas_tpu's.
(6) Fault R10: with set_random(..., estimate_variance=False) the port keeps
    G; jwas_tpu draws it all the same (its step never reads the flag).
(7) update_priors_frequency refreshes a pedigree group's scale as
    jwas_tpu's _apply_update_priors does.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

CHAIN = dict(chain_length=600, burnin=100)
CONFIGS = ("ID_geno_2bit", "ID_geno_f32", "herd_ID_dam", "V")
KEYS = {
    "ID_geno_2bit": ("vare", "varg", "G_0"),
    "ID_geno_f32": ("vare", "varg", "G_0"),
    "herd_ID_dam": ("vare", "G_0", "G_1", "G_3", "herd"),
    "V": ("vare", "V_0", "herd"),
}
# 99% bounds on the difference of one chain of each package: 2.576 sqrt(2)
# s, s the pooled between-seed standard deviation of a chain's posterior
# mean, seeds 1-8 of each package (1-16 for herd_ID_dam, whose direct and
# maternal variances mix slowly on 240 records); EBV_CORR: the lowest
# correlation of the posterior EBVs over the cross-package seed pairs, less
# 0.01. Chain means port / jwas_tpu: ID_geno_2bit vare 12.07 / 11.24 (sd
# 1.09 / 1.28), varg 0.116 / 0.118, G 4.79 / 5.39 (1.05 / 1.13);
# ID_geno_f32 vare 11.28 / 11.22, varg 0.871 / 0.850, G 3.71 / 3.70;
# herd_ID_dam vare 15.55 / 14.41 (2.04 / 2.02), G 7.57 / 9.49 (3.70 /
# 3.63), 1.83 / 1.58, 1.44 / 0.97, herd 0.2105 / 0.2128; V vare 12.05 /
# 12.03, V 14.64 / 14.44, herd 0.2092 / 0.2163 (python
# tests/test_torch_random_effects.py calibrate ..., PYTHONPATH=.)
BOUNDS = {
    "ID_geno_2bit": {"vare": 4.336, "varg": 0.0954, "G_0": 3.974},
    "ID_geno_f32": {"vare": 1.283, "varg": 0.5932, "G_0": 2.558},
    "herd_ID_dam": {"vare": 7.395, "G_0": 13.35, "G_1": 4.06, "G_3": 3.025,
                    "herd": 0.04782},
    "V": {"vare": 3.258, "V_0": 4.651, "herd": 0.03437},
}
EBV_CORR = {"ID_geno_2bit": 0.8611, "ID_geno_f32": 0.9789, "herd_ID_dam": 0.8503}
G2 = [[1.0, 0.1], [0.1, 0.5]]


def _jax():
    import jax
    jax.config.update("jax_enable_x64", False)
    return jax


@pytest.fixture(autouse=True)
def _x64_off():
    _jax()
    yield
    _jax()


# ------------------------------------------------------------ the data


def ped_problem():
    """simulate_pedigree_genomic_data (280 animals, p = 200), the 240
    non-founders phenotyped with a herd (8 levels, effects N(0, 1)) and
    their dam."""
    from jwas_tpu.io.datasets import simulate_pedigree_genomic_data

    sim = simulate_pedigree_genomic_data(n_founders=40, n_gen=3, n_per_gen=80,
                                         p=200, seed=11)
    rng = np.random.default_rng(3)
    ph = sim["phenotypes"].iloc[40:].reset_index(drop=True)
    ph["herd"] = [f"h{h}" for h in rng.integers(0, 8, len(ph))]
    ph["dam"] = list(sim["pedigree"]["Dam"].iloc[40:])
    ph["y"] = ph["y"] + rng.normal(0.0, 1.0, 8)[rng.integers(0, 8, len(ph))]
    return sim, ph


def as_table(df):
    import jwas_tpu_torch as jt
    return jt.Table({c: (np.array([str(x) for x in df[c]], dtype=object)
                         if df[c].dtype == object else df[c].to_numpy()) for c in df.columns})


def _pkg(package):
    if package == "port":
        import jwas_tpu_torch as jt
        return jt, dict(device="cpu")
    import jwas_tpu
    return jwas_tpu, {}


def build(package, config, sim):
    """The model of a configuration (module docstring) in one package."""
    pkg, dev = _pkg(package)
    ped = pkg.get_pedigree(sim["pedigree"] if package == "jwas_tpu"
                           else as_table(sim["pedigree"]))
    if config.startswith("ID_geno"):
        storage = "2bit" if config.endswith("2bit") else "f32"
        geno = pkg.get_genotypes(sim["genotypes"] if package == "jwas_tpu"
                                 else as_table(sim["genotypes"]),
                                 method="BayesC", storage=storage, **dev)
        model = pkg.build_model("y = intercept + ID + geno", genotypes=geno)
        pkg.set_random(model, "ID", ped)
    elif config == "herd_ID_dam":
        model = pkg.build_model("y = intercept + herd + ID + dam")
        pkg.set_random(model, "herd", 0.3)
        pkg.set_random(model, "ID dam", ped, G2)
    else:
        model = pkg.build_model("y = intercept + herd + ID")
        pkg.set_random(model, "herd", 0.3)
        pkg.set_random(model, "ID", 1.0, Vinv=ped.a_inverse(), names=ped.ids)
    return model


def run_chain(package, config, seed, sim, ph, **extra):
    """One runMCMC chain; returns (results, posterior means of KEYS)."""
    pkg, dev = _pkg(package)
    opts = dict(CHAIN, seed=seed, output_folder="", printout_model_info=False)
    opts.update(extra)
    out = pkg.runMCMC(build(package, config, sim), ph if package == "jwas_tpu"
                      else as_table(ph), **dev, **opts)
    return out, means_of(out, config)


def means_of(out, config):
    m = {"vare": float(np.asarray(out["residual variance"]["Estimate"])[0])}
    if "varg" in KEYS[config]:
        m["varg"] = float(np.asarray(out["marker effects variances geno"]["Estimate"])[0])
    key = ("random effect variances y:ID" if config == "V"
           else "polygenic effects covariance matrix")
    prefix = "V_" if config == "V" else "G_"
    for i, v in enumerate(np.asarray(out[key]["Estimate"])):
        m[prefix + str(i)] = float(v)
    if "herd" in KEYS[config]:
        m["herd"] = float(np.asarray(out["random effect variances y:herd"]["Estimate"])[0])
    return m


def ebv_of(out):
    """The posterior EBVs by ID ({} without output IDs, as in "V": no
    genotypes and no pedigree)."""
    if "EBV_y" not in out:
        return {}
    return dict(zip(list(out["EBV_y"]["ID"]), np.asarray(out["EBV_y"]["EBV"])))


# ------------------------------------------------------------ (1)-(4)


def _jax_lhs(config):
    """jwas_tpu's random-effect state for a configuration, from its own
    set-up (prepare_workspace, _build_st_data_and_state), and its LHS at
    the starting covariances and residual variance; the same state carried
    to the port by engine/convert.py::from_jax_random_effects."""
    import jax.numpy as jnp
    from jwas_tpu.engine import mcmc as jm
    from jwas_tpu.engine.setup import MCMCOptions as RefOptions
    from jwas_tpu.engine.setup import prepare_workspace as ref_prepare
    from jwas_tpu_torch.engine.convert import from_jax_random_effects

    sim, ph = ped_problem()
    opts = RefOptions(printout_model_info=False, output_folder="")
    ws = ref_prepare(build("jwas_tpu", config, sim), ph, opts)
    cfg, data, state = jm._build_st_data_and_state(ws, opts, jnp.float32)
    want = np.asarray(jm.assemble_lhs_lambda(cfg.re_groups, data.WtRinvW, data.Vinv,
                                             state.vc, state.vare))
    ours = from_jax_random_effects(cfg.re_groups, data.WtRinvW, data.Vinv, state.vc)
    return ours, torch.as_tensor(np.array(state.vare)), want


@pytest.mark.parametrize("config", ["ID_geno_2bit", "herd_ID_dam", "V"])
def test_assemble_lhs_matches_jwas_tpu(config):
    """jwas_tpu's W'R^-1W, Vinv and covariances carried across: the port's
    LHS with a pedigree group of one term (ID_geno), an i.i.d. group and a
    pedigree group of two terms (herd_ID_dam), an i.i.d. and a Vinv group
    (V) equals jwas_tpu's to rtol 1e-6 of the largest entry, and is exactly
    symmetric."""
    from jwas_tpu_torch.ops.location import assemble_lhs_lambda

    (cfg, WtW, Vinv, vc), vare, want = _jax_lhs(config)
    assert [g.random_type for g in cfg] == {"ID_geno_2bit": ["A"], "herd_ID_dam": ["I", "A"],
                                           "V": ["I", "V"]}[config]
    got = assemble_lhs_lambda(cfg, WtW, Vinv, vc, vare)
    assert torch.equal(got, got.T)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_plain_gibbs_pass_matches_jwas_tpu():
    """The plain pass on the V configuration's LHS (K = 289: an i.i.d. and
    a Vinv group), jwas_tpu's normal draws injected: rtol 1e-5, atol 1e-6
    of max |x| (float32 dot products of K terms in another order)."""
    jax = _jax()
    import jax.numpy as jnp
    from jwas_tpu.ops.location import gibbs_pass_lambda as jpass
    from jwas_tpu_torch.ops.location import assemble_lhs_lambda, gibbs_pass_lambda

    (cfg, WtW, Vinv, vc), vare, _ = _jax_lhs("V")
    lhs = assemble_lhs_lambda(cfg, WtW, Vinv, vc, vare)
    K = lhs.shape[0]
    assert K == 289
    rng = np.random.default_rng(9)
    x = rng.normal(size=K).astype(np.float32)
    b = (lhs.numpy() @ rng.normal(size=K)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jpass(jnp.asarray(lhs.numpy()), jnp.asarray(x), jnp.asarray(b),
                            jnp.float32(vare), key))
    zs = torch.from_numpy(np.array(jax.random.normal(key, (K,), dtype=jnp.float32)))
    got = gibbs_pass_lambda(lhs, torch.from_numpy(x), torch.from_numpy(b), vare, None,
                            zs=zs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_inverse_wishart_matches_jwas_tpu():
    """In float64: the port's InverseWishart and group covariance draws
    with jwas_tpu's Bartlett factor injected equal jwas_tpu's to rtol 1e-6;
    the port's own draws' mean lies within 4 standard errors of
    scale / (df - k - 1)."""
    jax = _jax()
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jwas_tpu.ops import dists as jd
    from jwas_tpu.ops import variance as jvar
    from jwas_tpu_torch.ops.dists import sample_inv_wishart
    from jwas_tpu_torch.ops.variance import sample_random_effect_vc

    rng = np.random.default_rng(2)
    for k, df in ((1, 5.0), (2, 6.5), (3, 9.0)):
        M = rng.normal(size=(k, k + 2))
        scale = M @ M.T + np.eye(k)
        key = jax.random.PRNGKey(k)
        want = np.asarray(jd.sample_inv_wishart(key, df, jnp.asarray(scale)))
        A = torch.from_numpy(np.array(jd._standard_wishart_chol(key, df, k, jnp.float64)))
        got = sample_inv_wishart(None, df, torch.from_numpy(scale), bartlett=A)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        sols = rng.normal(size=(k, 40))
        V = np.eye(40) + 0.1
        want = np.asarray(jvar.sample_random_effect_vc(key, jnp.asarray(sols), jnp.asarray(V),
                                                       df, jnp.asarray(scale)))
        A = torch.from_numpy(np.array(jd._standard_wishart_chol(key, df + 40, k, jnp.float64)))
        got = sample_random_effect_vc(None, torch.from_numpy(sols), torch.from_numpy(V), df,
                                      torch.from_numpy(scale), bartlett=A)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        # the port's own draws
        gen = torch.Generator()
        gen.manual_seed(k)
        draws = torch.stack([sample_inv_wishart(gen, df, torch.from_numpy(scale))
                             for _ in range(2000)]).numpy()
        mean, se = draws.mean(axis=0), draws.std(axis=0) / np.sqrt(len(draws))
        assert (np.abs(mean - scale / (df - k - 1)) < 4 * se).all(), (k, mean, se)
    jax.config.update("jax_enable_x64", False)


def _model_pair(eq):
    import jwas_tpu
    import jwas_tpu_torch as jt
    return (jwas_tpu.build_model(eq), jt.build_model(eq))


def test_set_random_errors_match_jwas_tpu():
    import jwas_tpu
    import jwas_tpu_torch as jt

    sim, _ = ped_problem()
    peds = (jwas_tpu.get_pedigree(sim["pedigree"]), jt.get_pedigree(as_table(sim["pedigree"])))
    cases = [
        lambda pkg, m, ped: pkg.set_random(m, "ID", ped, -1.0),
        lambda pkg, m, ped: pkg.set_random(m, "ID dam", ped, [[1.0, 2.0], [2.0, 1.0]]),
        lambda pkg, m, ped: pkg.set_random(m, "litter", 1.0),
        lambda pkg, m, ped: (pkg.set_random(m, "ID", ped, 1.0),
                             pkg.set_random(m, "dam", ped, 1.0)),
        lambda pkg, m, ped: pkg.set_random(m, "herd", 1.0, constraint=True),
        lambda pkg, m, ped: pkg.set_random(m, "herd", 1.0, estimate_scale=True),
        lambda pkg, m, ped: pkg.set_random(m, "ID dam", ped, 1.0),
        lambda pkg, m, ped: pkg.set_random(m, "herd", 1.0, Vinv=np.eye(3)),
        lambda pkg, m, ped: pkg.set_random(m, "herd", 1.0, Vinv=np.eye(3),
                                           names=["a", "a", "b"]),
        lambda pkg, m, ped: pkg.set_random(m, "herd", 1.0, Vinv=np.eye(3),
                                           names=["a", "b"]),
        lambda pkg, m, ped: pkg.set_random(m, "herd", 1.0, 2.0),
    ]
    for i, case in enumerate(cases):
        errors = []
        for pkg, ped, m in zip((jwas_tpu, jt), peds,
                               _model_pair("y = intercept + herd + ID + dam")):
            with pytest.raises((ValueError, TypeError)) as e:
                case(pkg, m, ped)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1], (i, errors)
    # a group with a pedigree ties its terms to the pedigree's order
    m = jt.build_model("y = intercept + herd + ID + dam")
    jt.set_random(m, "ID dam", peds[1], G2)
    assert [m.term_dict[t].names for t in ("y:ID", "y:dam")] == [peds[1].ids] * 2
    assert m.ped_term_vec == ["y:ID", "y:dam"] and m.random_effects[0].G.df == 6.0


@pytest.mark.parametrize("config", CONFIGS)
def test_workspace_matches_jwas_tpu(config):
    """The random-effect groups (starts, levels, dense Vinv, the default or
    given G and its prior), the location design, the output IDs and the
    prediction terms of both packages' prepare_workspace."""
    from jwas_tpu.engine.setup import MCMCOptions as RefOptions
    from jwas_tpu.engine.setup import prepare_workspace as ref_prepare
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    sim, ph = ped_problem()
    opts = dict(printout_model_info=False, output_folder="")
    ref = ref_prepare(build("jwas_tpu", config, sim), ph, RefOptions(**opts))
    ours = prepare_workspace(build("port", config, sim), as_table(ph), MCMCOptions(**opts))
    assert ours.model.term_names() == ref.model.term_names()
    np.testing.assert_array_equal(ours.W, ref.W)
    np.testing.assert_array_equal(ours.y, ref.y)
    assert ours.output_ids == ref.output_ids and ours.obs_ids == ref.obs_ids
    assert ours.prediction_terms == ref.prediction_terms
    assert float(ours.vare0) == float(ref.vare0) and float(ours.scale_R) == float(ref.scale_R)
    assert len(ours.re_groups) == len(ref.re_groups)
    for a, b in zip(ours.re_groups, ref.re_groups):
        assert (a.starts, a.n_levels, a.term_array, a.random_type, a.df,
                a.estimate_variance) == (b.starts, b.n_levels, b.term_array,
                                         b.random_type, b.df, b.estimate_variance)
        np.testing.assert_allclose(a.G0, b.G0, rtol=1e-12)
        np.testing.assert_allclose(a.scale, b.scale, rtol=1e-12)
        assert (a.Vinv is None) == (b.Vinv is None)
        if a.Vinv is not None:
            np.testing.assert_allclose(a.Vinv, b.Vinv, rtol=0, atol=1e-12)
    for name in ours.prediction_terms:
        np.testing.assert_array_equal(ours.output_X[name], ref.output_X[name])
    if ours.geno is not None:
        assert float(ours.marker_var0) == pytest.approx(float(ref.marker_var0), rel=1e-12)


def test_pedigree_option_matches_jwas_tpu():
    """runMCMC's pedigree option (no set_random): phenotyped individuals
    outside the pedigree are removed and the output IDs are the pedigree's,
    as in jwas_tpu's workspace; the chain runs."""
    import jwas_tpu
    import jwas_tpu_torch as jt
    from jwas_tpu.engine.setup import MCMCOptions as RefOptions
    from jwas_tpu.engine.setup import prepare_workspace as ref_prepare
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    sim, ph = ped_problem()
    extra = ph.iloc[:3].copy()
    extra["ID"] = ["x1", "x2", "x3"]
    ph2 = pd_concat(ph, extra)
    ref = ref_prepare(jwas_tpu.build_model("y = intercept + herd"), ph2,
                      RefOptions(pedigree=jwas_tpu.get_pedigree(sim["pedigree"]),
                                 printout_model_info=False, output_folder=""))
    ped = jt.get_pedigree(as_table(sim["pedigree"]))
    ours = prepare_workspace(jt.build_model("y = intercept + herd"), as_table(ph2),
                             MCMCOptions(pedigree=ped, printout_model_info=False,
                                         output_folder=""))
    assert ours.obs_ids == ref.obs_ids and len(ours.obs_ids) == len(ph)
    assert ours.output_ids == ref.output_ids == ped.ids
    assert ours.geno is None and ours.re_groups == []
    out = jt.runMCMC(jt.build_model("y = intercept + herd"), as_table(ph2), device="cpu",
                     pedigree=ped, chain_length=20, output_folder="",
                     printout_model_info=False)
    assert list(out["EBV_y"].ID) == ped.ids and not np.asarray(out["EBV_y"].EBV).any()


def pd_concat(a, b):
    import pandas as pd
    return pd.concat([a, b], ignore_index=True)


# ------------------------------------------------------------ (5)-(7)


@pytest.fixture(scope="module")
def problem():
    _jax()
    return ped_problem()


@pytest.mark.parametrize("config", CONFIGS)
def test_chain_matches_jwas_tpu_within_mc_error(problem, config):
    """One runMCMC chain of each package (seed 7, outside the calibration's
    seeds): every posterior mean of KEYS within BOUNDS, the posterior EBVs
    correlated at least EBV_CORR, the same result keys and columns."""
    ref, ref_m = run_chain("jwas_tpu", config, 7, *problem)
    out, our_m = run_chain("port", config, 7, *problem)
    for k in KEYS[config]:
        assert abs(our_m[k] - ref_m[k]) < BOUNDS[config][k], (k, our_m, ref_m)
    ours, theirs = ebv_of(out), ebv_of(ref)
    assert sorted(ours) == sorted(theirs)
    if config in EBV_CORR:
        ids = list(theirs)
        assert len(ids) == 280
        assert np.corrcoef([ours[s] for s in ids], [theirs[s] for s in ids])[0, 1] >= EBV_CORR[config]
    keys = sorted(k for k in out if not k.startswith("_"))
    assert keys == sorted(k for k in ref if not k.startswith("_"))
    assert {k: list(out[k].columns) for k in keys} == {k: list(ref[k].columns) for k in keys}


def _numbers(row):
    try:
        [float(x) for x in row.split(",") if x]
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("config", ["ID_geno_2bit", "herd_ID_dam"])
def test_result_and_sample_files_match_jwas_tpu(problem, config, tmp_path):
    """Short chains writing their files: the same file names, header rows
    (the covariance files' "y:ID_y:dam"... pairs, polygenic_effects_variance)
    and rows."""
    folders = {}
    for package in ("port", "jwas_tpu"):
        folders[package] = str(tmp_path / package)
        run_chain(package, config, 5, *problem, chain_length=40, burnin=0,
                  output_samples_frequency=10, output_folder=folders[package])
    names = sorted(os.listdir(folders["jwas_tpu"]))
    assert sorted(os.listdir(folders["port"])) == names
    assert "MCMC_samples_polygenic_effects_variance.txt" in names
    for name in names:
        rows = {}
        for package in folders:
            with open(os.path.join(folders[package], name)) as f:
                rows[package] = f.read().splitlines()
        ours, theirs = rows["port"], rows["jwas_tpu"]
        assert len(ours) == len(theirs), name
        if name.startswith("MCMC_samples"):
            if not _numbers(theirs[0]):
                assert ours[0] == theirs[0], name
            assert [r.count(",") for r in ours] == [r.count(",") for r in theirs], name
        else:
            assert ours[0] == theirs[0], name


def test_fixed_group_covariance_stays_fault_r10(problem, tmp_path):
    """set_random(..., estimate_variance=False): the port keeps the herd's
    G (every sample 0.3, SD 0) while the pedigree group moves; jwas_tpu
    draws the herd's G all the same (fault R10: its step never reads the
    flag)."""
    import jwas_tpu
    import jwas_tpu_torch as jt

    sim, ph = problem
    outs = {}
    for package, pkg, dev, data in (("port", jt, dict(device="cpu"), as_table(ph)),
                                    ("jwas_tpu", jwas_tpu, {}, ph)):
        ped = pkg.get_pedigree(sim["pedigree"] if package == "jwas_tpu"
                               else as_table(sim["pedigree"]))
        model = pkg.build_model("y = intercept + herd + ID + dam")
        pkg.set_random(model, "herd", 0.3, estimate_variance=False)
        pkg.set_random(model, "ID dam", ped, G2)
        folder = str(tmp_path / package)
        outs[package] = pkg.runMCMC(model, data, chain_length=30, seed=3,
                                    output_samples_frequency=5, output_folder=folder,
                                    printout_model_info=False, **dev)
    herd = outs["port"]["random effect variances y:herd"]
    assert float(herd.Estimate[0]) == float(np.float32(0.3)) and float(herd.SD[0]) == 0.0
    with open(tmp_path / "port" / "MCMC_samples_y.herd_variances.txt") as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) == 6 and {float(r) for r in rows} == {float(np.float32(0.3))}
    assert float(outs["port"]["polygenic effects covariance matrix"].SD[0]) > 0
    # jwas_tpu's: drawn (R10)
    assert float(outs["jwas_tpu"]["random effect variances y:herd"]["SD"][0]) > 0


def test_update_priors_match_jwas_tpu(problem):
    """_apply_update_priors of both packages on the same accumulators: a
    pedigree group's scale becomes mean(G) (df - k - 1), an i.i.d. group's
    stays, and a runMCMC chain with update_priors_frequency runs."""
    from collections import namedtuple

    import jwas_tpu_torch as jt
    from jwas_tpu.engine import mcmc as jm
    from jwas_tpu.engine.state import REGroupCfg as JCfg
    from jwas_tpu_torch.engine import mcmc as tm
    from jwas_tpu_torch.engine.state import REGroupCfg

    RefData = namedtuple("RefData", "vc_scale scale_r")
    RefState = namedtuple("RefState", "scale_g")
    RefCfg = namedtuple("RefCfg", "method df_marker df_residual re_groups")
    RefAccum = namedtuple("RefAccum", "varg_m vare_m vc_m")
    vc_m = (np.array([[1.5, 0.2], [0.2, 0.7]], np.float32), np.array([[0.4]], np.float32))
    scales = (np.eye(2, dtype=np.float32), np.array([[0.9]], np.float32))
    groups = [dict(starts=(3, 100), n_levels=97, df=6.0, has_vinv=True, random_type="A"),
              dict(starts=(1,), n_levels=2, df=5.0, has_vinv=False, random_type="I")]
    for method in ("none", "BayesC"):
        d_r, s_r = jm._apply_update_priors(
            RefCfg(method, 4.0, 4.0, tuple(JCfg(**g) for g in groups)),
            RefData(scales, np.float32(1.0)), RefState(np.float32(0.5)),
            RefAccum(np.float32(0.01), np.float32(2.5), vc_m))
        cfg = tm.EngineCfg(method=method, n_obs=10, n_markers=0, estimate_pi=False,
                           estimate_marker_variance=True, estimate_scale=False,
                           estimate_residual_variance=True, nreps=1, sync_every=1,
                           df_residual=4.0, df_marker=4.0,
                           re_groups=tuple(REGroupCfg(estimate_variance=True, **g)
                                           for g in groups))
        data = tm.STData(W=None, WtW=None, y=None, gm=None, scale_r=torch.tensor(1.0),
                         ebv_rows=None, out_W=None,
                         vc_scale=tuple(torch.from_numpy(v) for v in scales))
        state = tm.ChainState(gen=None, sol=None, alpha=None, beta=None, delta=None,
                              ycorr=None, vare=None, varg=None, pi=None,
                              scale_g=torch.tensor(0.5))
        accum = tm.Accum(*([None] * 16))._replace(
            varg_m=torch.tensor(0.01), vare_m=torch.tensor(2.5),
            vc_m=tuple(torch.from_numpy(v) for v in vc_m))
        d, s = tm.apply_update_priors(cfg, data, state, accum)
        for got, want in zip(d.vc_scale, d_r.vc_scale):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert float(d.scale_r) == pytest.approx(float(d_r.scale_r), rel=1e-6)
        assert float(s.scale_g) == pytest.approx(float(s_r.scale_g), rel=1e-6)
    sim, ph = problem
    model = build("port", "herd_ID_dam", sim)
    out = jt.runMCMC(model, as_table(ph), device="cpu", chain_length=40, seed=2,
                     update_priors_frequency=10, output_folder="", printout_model_info=False)
    assert np.isfinite(out["polygenic effects covariance matrix"].Estimate).all()


@pytest.mark.parametrize("storage", ["f64", "int8"])
def test_pedigree_model_runs_on_every_dense_store(problem, storage):
    """y = intercept + ID + geno, a pedigree group of one term, on the
    float64 (double_precision) and int8 stores: the results of a short
    chain are finite, with the f32 store's keys and the chain's dtype."""
    import jwas_tpu_torch as jt

    sim, ph = problem
    outs = {}
    for st in ("f32", storage):
        geno = jt.get_genotypes(as_table(sim["genotypes"]), method="BayesC", storage=st,
                                device="cpu")
        model = jt.build_model("y = intercept + ID + geno", genotypes=geno)
        jt.set_random(model, "ID", jt.get_pedigree(as_table(sim["pedigree"])), 2.0)
        outs[st] = jt.runMCMC(model, as_table(ph), device="cpu", chain_length=30, seed=4,
                              double_precision=st == "f64", output_folder="",
                              printout_model_info=False)
    assert sorted(outs[storage]) == sorted(outs["f32"])
    G = outs[storage]["polygenic effects covariance matrix"]
    assert np.isfinite(np.asarray(G.Estimate)).all() and float(G.SD[0]) > 0
    assert np.isfinite(np.asarray(outs[storage]["EBV_y"].EBV)).all()


# ------------------------------------------------------------ calibration


def calibrate(package, config, first, last, out):
    """Chain means and EBVs of seeds first..last of one package and
    configuration, written to out (JSON); `summarize` prints BOUNDS."""
    import time
    torch.set_num_threads(1)
    sim, ph = ped_problem()
    rows = []
    for s in range(first, last + 1):
        t0 = time.perf_counter()
        res, means = run_chain(package, config, s, sim, ph)
        ebv = ebv_of(res)
        rows.append(dict(seed=s, **means, seconds=time.perf_counter() - t0,
                         ebv=[float(ebv[k]) for k in sorted(ebv)]))
    with open(out, "w") as f:
        json.dump({"package": package, "config": config, "rows": rows}, f)


def summarize(files):
    by = {}
    for name in files:
        with open(name) as f:
            d = json.load(f)
        by.setdefault(d["config"], {}).setdefault(d["package"], []).extend(d["rows"])
    for config, pk in sorted(by.items()):
        parts = []
        for k in KEYS[config]:
            sds = [np.std([r[k] for r in rows], ddof=1) for rows in pk.values()]
            s = float(np.sqrt(np.mean(np.square(sds))))
            means = {p: round(float(np.mean([r[k] for r in rows])), 4) for p, rows in pk.items()}
            parts.append(f"{k}: means {means}, sd {[round(float(x), 4) for x in sds]}, "
                         f"bound {2.576 * np.sqrt(2) * s:.4g}")
        cors = [np.corrcoef(a["ebv"], b["ebv"])[0, 1]
                for a in pk.get("port", []) for b in pk.get("jwas_tpu", [])]
        secs = {p: round(float(np.mean([r["seconds"] for r in rows])), 1) for p, rows in pk.items()}
        print(config, {p: len(r) for p, r in pk.items()}, secs, "; ".join(parts),
              f"; EBV corr min {min(cors) if cors else None}")


if __name__ == "__main__":
    # python tests/test_torch_random_effects.py calibrate port|jwas_tpu CONFIG 1 8 out.json
    # python tests/test_torch_random_effects.py summarize out*.json
    if sys.argv[1] == "calibrate":
        calibrate(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    else:
        summarize(sys.argv[2:])
