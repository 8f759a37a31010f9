"""Single-trait chains run several at once (runMCMC(..., n_chains=K);
jwas_tpu_torch/engine/mcmc.py::run_chains) against tests/test_multichain.py
and the single-chain path.

- tests/test_multichain.py's single-trait tests (:10, :69) at their
  lengths on the port: EBV accuracy, vare's PSRF, the chain_<k>/ sample
  files and PSRF_per_parameter on them;
- n_chains = 1 is today's path: run_chains with one chain gives the
  single-chain loop's chain bit for bit;
- without a prior refresh, chain k's sample files equal, bit for bit, a
  single-chain run seeded seed + k, and the pooled posterior means equal
  the mean of those runs' means within 1e-6;
- the prior refresh of several chains: each chain's marker-variance scale
  from its own running mean, the shared scales from the pooled means;
- every single-trait path runs with n_chains = 2 (the 2-bit and dense
  stores, BayesR, BayesB, BayesL, GBLUP, no markers with random effects, a
  binary trait, annotations, the sparse location path).
"""

import os

import numpy as np
import pytest
import torch

import jwas_tpu_torch as jt
import jwas_tpu_torch.engine.mcmc as em
from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu_torch.io.datasets import simulate_genomic_data

CPU = dict(device="cpu", printout_model_info=False)


def test_multichain_results_and_psrf():
    """tests/test_multichain.py:10-22: 3 chains of 600 sweeps."""
    sim = simulate_genomic_data(n=300, p=120, n_qtl=12, h2=0.5, seed=61)
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", name="geno", device="cpu")
    model = jt.build_model("y = intercept + geno", genotypes=geno)
    out = jt.runMCMC(model, sim["phenotypes"], chain_length=600, burnin=120, seed=3,
                     n_chains=3, output_samples_frequency=5, output_folder="", **CPU)
    acc = np.corrcoef(out["EBV_y"].EBV, sim["true_bv"])[0, 1]
    assert acc > 0.85, f"multi-chain EBV accuracy {acc:.3f}"
    psrf = dict(zip(out["PSRF"]["parameter"], out["PSRF"]["PSRF"]))
    assert list(psrf) == ["vare", "h2", "genvar", "varg", "pi[0]"]
    assert 0.8 < psrf["vare"] < 1.3, psrf
    assert "_chain_sample_folders" not in out


def test_st_multichain_sample_files_and_per_parameter_psrf(tmp_path):
    """tests/test_multichain.py:69-115: chain 0 streams the top-level files,
    output_chain_samples=True every chain's under chain_<k>/."""
    sim = simulate_genomic_data(n=250, p=80, n_qtl=10, h2=0.5, seed=31)
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", name="geno", device="cpu")
    model = jt.build_model("y = intercept + geno", genotypes=geno)
    jt.outputMCMCsamples(model, "intercept")
    folder = str(tmp_path / "mc_out")
    out = jt.runMCMC(model, sim["phenotypes"], chain_length=400, burnin=80, seed=11,
                     n_chains=3, output_samples_frequency=8, output_folder=folder,
                     output_chain_samples=True, **CPU)
    assert out["_chain_sample_folders"] == [os.path.join(folder, f"chain_{k}")
                                            for k in (1, 2, 3)]
    top = os.path.join(folder, "MCMC_samples_marker_effects_geno_y.txt")
    assert os.path.isfile(top)
    with open(top) as f, open(os.path.join(folder, "chain_1",
                                           "MCMC_samples_marker_effects_geno_y.txt")) as g:
        assert f.read() == g.read()
    c1, c2 = (open(os.path.join(folder, f"chain_{k}", "MCMC_samples_residual_variance.txt")
                   ).read().splitlines() for k in (1, 2))
    assert len(c1) == len(c2) > 2 and c1[1:] != c2[1:]
    marker_files = [os.path.join(folder, f"chain_{k}", "MCMC_samples_marker_effects_geno_y.txt")
                    for k in (1, 2, 3)]
    psrf_m = jt.PSRF_per_parameter(*marker_files, max_params=20)
    assert len(psrf_m) > 0 and np.isfinite(psrf_m["PSRF"]).all()
    assert (psrf_m["PSRF"] < 2.5).all()
    loc_files = [os.path.join(folder, f"chain_{k}", "MCMC_samples_y.intercept.txt")
                 for k in (1, 2, 3)]
    psrf_l = jt.PSRF_per_parameter(*loc_files)
    assert len(psrf_l) == 1 and float(psrf_l["PSRF"][0]) < 1.5


def _small(seed=7, n=80, p=30):
    sim = simulate_genomic_data(n=n, p=p, n_qtl=5, h2=0.5, seed=seed)
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", name="geno", device="cpu")
    return sim, jt.build_model("y = intercept + geno", genotypes=geno)


RUN = dict(chain_length=60, burnin=12, output_samples_frequency=4, **CPU)


def _files(folder):
    out = {}
    for f in sorted(os.listdir(folder)):
        if f.startswith("MCMC_samples_"):
            with open(os.path.join(folder, f)) as fh:
                out[f] = fh.read()
    return out


def test_chain_k_equals_a_single_chain_seeded_seed_plus_k(tmp_path):
    """Without a prior refresh each chain is the single chain of seed + k:
    its sample files bit for bit; the pooled posterior means are the mean
    of the single runs' means within 1e-6; the posterior SDs of the
    genetic variance pool every chain's draws."""
    sim, model = _small()
    multi = jt.runMCMC(model, sim["phenotypes"], seed=5, n_chains=3,
                       output_folder=str(tmp_path / "multi"), output_chain_samples=True,
                       **RUN)
    singles = []
    for k in range(3):
        sim, model = _small()
        singles.append(jt.runMCMC(model, sim["phenotypes"], seed=5 + k,
                                  output_folder=str(tmp_path / f"single{k}"), **RUN))
        assert _files(str(tmp_path / "multi" / f"chain_{k + 1}")) == _files(
            str(tmp_path / f"single{k}"))
    assert _files(str(tmp_path / "multi")) == _files(str(tmp_path / "single0"))
    for key, col in (("location parameters", "Estimate"), ("marker effects geno", "Estimate"),
                     ("residual variance", "Estimate"), ("EBV_y", "EBV"),
                     ("pi_geno", "Estimate"), ("marker effects variances geno", "Estimate")):
        mean = np.mean([np.asarray(s[key][col], dtype=np.float64) for s in singles], axis=0)
        np.testing.assert_allclose(np.asarray(multi[key][col], dtype=np.float64), mean,
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    gv = np.concatenate([[float(v) for v in open(
        tmp_path / f"single{k}" / "MCMC_samples_genetic_variance.txt").read().split()[1:]]
        for k in range(3)])
    np.testing.assert_allclose(float(multi["genetic_variance"]["SD"][0]), gv.std(),
                               rtol=1e-5)


def _single_chain_loop(cfg, data, state, plan, update_priors_frequency):
    """The single-chain loop as runMCMC ran it before it ran several chains:
    burn-in, then each window's sample read back, the priors refreshed every
    update_priors_frequency sweeps. Returns (state, accum, samples)."""
    run_window = em.make_run_window(cfg)
    accum = em._init_accum(cfg, data, state)
    samples = {k: [] for k in em.SAMPLE_KEYS}
    prior_epoch = 0
    if plan.burnin_outer > 0:
        state, accum, _ = run_window(state, data, accum, plan.burnin_outer,
                                     accumulate=False)
    for w in range(plan.n_saved):
        state, accum, out = run_window(state, data, accum, plan.thin_outer)
        iters_done = (plan.burnin_outer + (w + 1) * plan.thin_outer) * plan.nreps
        if iters_done // update_priors_frequency > prior_epoch:
            prior_epoch = iters_done // update_priors_frequency
            data, state = em.apply_update_priors(cfg, data, state, accum)
        host = em._read_back(state, out, None, cfg.n_markers)
        for k in em.SAMPLE_KEYS:
            samples[k].append(host[k])
    return state, accum, samples


def test_one_chain_is_todays_path():
    """run_chain (run_chains with one state) gives the single-chain loop's
    chain bit for bit, prior refresh included, and runMCMC(n_chains=1) the
    default run's results."""
    sim, model = _small(seed=8)
    opts = MCMCOptions(chain_length=40, burnin=8, output_samples_frequency=4, seed=2,
                       output_folder="", printout_model_info=False)
    ws = prepare_workspace(model, sim["phenotypes"], opts, device="cpu")
    cfg, data, state = em._build_st_data_and_state(ws, opts, torch.device("cpu"))
    plan = em.chain_plan(40, 8, 4, cfg.nreps)
    s1, a1, samples1 = _single_chain_loop(cfg, data, state, plan, 12)
    cfg, data, states = em._build_st_data_and_states(ws, opts, torch.device("cpu"), 1)
    s2, a2, samples2, _, _ = em.run_chain(cfg, data, states[0], plan,
                                          update_priors_frequency=12)
    for f in a1._fields:
        x, y = getattr(a1, f), getattr(a2, f)
        if torch.is_tensor(x):
            assert torch.equal(x, y), f
    assert torch.equal(s1.alpha, s2.alpha) and torch.equal(s1.scale_g, s2.scale_g)
    for k in samples1:
        np.testing.assert_array_equal(np.asarray(samples1[k]), np.asarray(samples2[k]))
    _, _, _, tracks, _, _ = em.run_chains(cfg, data, states, plan)
    assert np.stack(tracks["vare"]).shape == (plan.n_saved, 1)
    run = dict(chain_length=40, burnin=8, output_samples_frequency=4, seed=2,
               output_folder="", **CPU)
    a, b = jt.runMCMC(model, sim["phenotypes"], **run), jt.runMCMC(
        model, sim["phenotypes"], n_chains=1, **run)
    assert "PSRF" not in b
    for key in a:
        for c in a[key].columns:
            assert np.asarray(a[key][c]).tolist() == np.asarray(b[key][c]).tolist(), key


def test_prior_refresh_pools_the_shared_scales():
    """apply_update_priors_mc: each chain's marker-variance scale from its
    own running mean, the residual scale from the chains' pooled mean; a
    refreshing run differs from the independent chains and stays finite."""
    sim, model = _small(seed=9)
    opts = MCMCOptions(chain_length=40, seed=2, output_folder="", n_chains=2,
                       printout_model_info=False)
    ws = prepare_workspace(model, sim["phenotypes"], opts, device="cpu")
    cfg, data, states = em._build_st_data_and_states(ws, opts, torch.device("cpu"), 2)
    accums = [em._init_accum(cfg, data, s) for s in states]
    accums = [a._replace(vare_m=torch.tensor(v), varg_m=torch.tensor(g))
              for a, v, g in zip(accums, (1.0, 3.0), (0.5, 0.25))]
    data2, states2 = em.apply_update_priors_mc(cfg, data, states, accums)
    df_r, df_m = cfg.df_residual, cfg.df_marker
    assert float(data2.scale_r) == pytest.approx(2.0 * (df_r - 2) / df_r)
    assert [float(s.scale_g) for s in states2] == pytest.approx(
        [0.5 * (df_m - 2) / df_m, 0.25 * (df_m - 2) / df_m])
    run = dict(chain_length=60, burnin=0, output_samples_frequency=4, seed=5, n_chains=2,
               output_folder="", **CPU)
    a = jt.runMCMC(model, sim["phenotypes"], **run)
    b = jt.runMCMC(model, sim["phenotypes"], update_priors_frequency=8, **run)
    assert not np.array_equal(a["marker effects geno"]["Estimate"],
                              b["marker effects geno"]["Estimate"])
    assert np.isfinite(b["PSRF"]["PSRF"]).all()


def _pedigree(n):
    ids = np.array([str(i + 1) for i in range(n)], dtype=object)
    sire = np.array(["0"] * 20 + [str(1 + i % 10) for i in range(n - 20)], dtype=object)
    dam = np.array(["0"] * 20 + [str(11 + i % 10) for i in range(n - 20)], dtype=object)
    return jt.get_pedigree(jt.Table({"ID": ids, "Sire": sire, "Dam": dam}))


@pytest.mark.parametrize("path", ["2bit_BayesC", "2bit_BayesR", "BayesB", "BayesL",
                                  "GBLUP", "none_random", "binary", "annotated",
                                  "sparse_location"])
def test_every_single_trait_path_runs_several_chains(path, tmp_path):
    rng = np.random.default_rng(3)
    n, p = 100, 40
    sim = simulate_genomic_data(n=n, p=p, n_qtl=5, h2=0.5, seed=12)
    ph = sim["phenotypes"]
    ph["ID"] = np.array([str(i + 1) for i in range(n)], dtype=object)
    sim["genotypes"]["ID"] = ph["ID"]
    ph["herd"] = rng.integers(1, 6, n)
    method = {"2bit_BayesR": "BayesR", "BayesB": "BayesB", "BayesL": "BayesL",
              "GBLUP": "GBLUP"}.get(path, "BayesC")
    kw = {}
    if path.startswith("2bit"):
        kw["storage"] = "2bit"
    if path == "annotated":
        kw["annotations"] = rng.integers(0, 2, (p, 2)).astype(float)
    geno = None if path == "none_random" else jt.get_genotypes(
        sim["genotypes"], method=method, name="geno", device="cpu", **kw)
    eq = "y = intercept + herd" + ("" if geno is None else " + geno")
    model_kw = {}
    if path == "binary":
        ph["y"] = (ph["y"] > np.median(ph["y"])).astype(np.int64) + 1
        model_kw["categorical_trait"] = ["y"]
    if path == "none_random":
        eq = "y = intercept + herd + ID"
    model = jt.build_model(eq, genotypes=geno, **model_kw)
    if path == "none_random":
        jt.set_random(model, "herd", np.array(1.0))
        jt.set_random(model, "ID", _pedigree(n), np.array(1.0))
    run = dict(chain_length=32, burnin=8, output_samples_frequency=4, seed=1, n_chains=2,
               output_folder=str(tmp_path / "r"), output_chain_samples=True,
               fast_blocks=8 if path.startswith("2bit") else False, **CPU)
    if path == "sparse_location":
        run["sparse_location"] = True
    out = jt.runMCMC(model, ph, **run)
    psrf = dict(zip(out["PSRF"]["parameter"], out["PSRF"]["PSRF"]))
    assert np.isfinite(psrf["h2"]), psrf         # vare is pinned at 1 for a binary trait
    assert np.isfinite(np.asarray(out["location parameters"]["Estimate"], float)).all()
    ebv_key = [k for k in out if k.startswith("EBV_")]
    assert ebv_key and np.isfinite(np.asarray(out[ebv_key[0]]["EBV"], float)).all()
    for folder in out["_chain_sample_folders"]:
        assert os.path.isfile(os.path.join(folder, "MCMC_samples_residual_variance.txt"))
    if path == "sparse_location":
        assert out["_location_cg"]["solves"] == 2 * 32
