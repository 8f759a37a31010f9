"""Multi-trait chains run several at once (jwas_tpu_torch/engine/mcmc_mt.py::
run_mt_chains) against tests/test_multichain.py and the single-chain path:
tests/test_multichain.py:42-66 at its length (2 chains of 600 sweeps;
jwas_tpu's chains on a mesh there, the port's on one device),
run_mt_chains with one chain bit for bit the single-chain loop's, chain
k's sample files bit for bit a single-chain run seeded seed + k, the
pooled means the mean of those runs' means within 1e-6, and the per-trait
PSRF table's names."""

import os

import numpy as np
import torch

import jwas_tpu_torch as jt
import jwas_tpu_torch.engine.mcmc as em
import jwas_tpu_torch.engine.mcmc_mt as emt
from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu_torch.io.datasets import simulate_genomic_data_mt

CPU = dict(device="cpu", printout_model_info=False)
EQ = "y1 = intercept + geno\ny2 = intercept + geno"


def _model(sim):
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", name="geno", device="cpu")
    return jt.build_model(EQ, genotypes=geno)


def test_mt_multichain_psrf_and_accuracy():
    """tests/test_multichain.py:42-66: the PSRF table finite and below 1.5,
    each trait's EBV accuracy above 0.6."""
    sim = simulate_genomic_data_mt(n=300, p=128, n_qtl=15, h2=(0.5, 0.4), rg=0.6, re=0.2,
                                   seed=4)
    out = jt.runMCMC(_model(sim), sim["phenotypes"], chain_length=600, burnin=120,
                     output_samples_frequency=6, seed=17, n_chains=2, output_folder="",
                     **CPU)
    psrf = out["PSRF"]
    assert len(psrf) >= 2 and np.isfinite(psrf["PSRF"]).all()
    assert (psrf["PSRF"] < 1.5).all(), dict(zip(psrf["parameter"], psrf["PSRF"]))
    assert list(psrf["parameter"]) == ["h2[0]", "h2[1]", "genvar[0]", "genvar[1]", "R[0]",
                                       "R[1]", "varg[0]", "varg[1]", "gencor[0,1]"]
    ids = [f"ind{i + 1}" for i in range(sim["true_bv"].shape[0])]
    for ti in range(2):
        table = out[f"EBV_y{ti + 1}"]
        ebv = dict(zip(table["ID"], np.asarray(table["EBV"], dtype=np.float64)))
        acc = np.corrcoef([ebv[i] for i in ids], sim["true_bv"][:, ti])[0, 1]
        assert acc > 0.6, f"trait {ti} accuracy {acc:.3f}"


def _small():
    return simulate_genomic_data_mt(n=80, p=24, n_qtl=5, seed=9, missing_frac=0.1)


RUN = dict(chain_length=24, burnin=6, output_samples_frequency=3, **CPU)


def _files(folder):
    return {f: open(os.path.join(folder, f)).read() for f in sorted(os.listdir(folder))
            if f.startswith("MCMC_samples_")}


def test_mt_chain_k_equals_a_single_chain_seeded_seed_plus_k(tmp_path):
    sim = _small()
    multi = jt.runMCMC(_model(sim), sim["phenotypes"], seed=3, n_chains=2,
                       output_folder=str(tmp_path / "multi"), output_chain_samples=True,
                       **RUN)
    assert multi["_chain_sample_folders"] == [str(tmp_path / "multi" / f"chain_{k}")
                                              for k in (1, 2)]
    singles = []
    for k in range(2):
        singles.append(jt.runMCMC(_model(sim), sim["phenotypes"], seed=3 + k,
                                  output_folder=str(tmp_path / f"single{k}"), **RUN))
        assert _files(str(tmp_path / "multi" / f"chain_{k + 1}")) == _files(
            str(tmp_path / f"single{k}"))
    assert _files(str(tmp_path / "multi")) == _files(str(tmp_path / "single0"))
    for key, col in (("location parameters", "Estimate"), ("marker effects geno", "Estimate"),
                     ("residual variance", "Estimate"), ("EBV_y1", "EBV"), ("EBV_y2", "EBV")):
        mean = np.mean([np.asarray(s[key][col], dtype=np.float64) for s in singles], axis=0)
        np.testing.assert_allclose(np.asarray(multi[key][col], dtype=np.float64), mean,
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    assert "PSRF" in multi and np.isfinite(multi["PSRF"]["PSRF"]).all()


def _single_chain_loop(cfg, data, state, plan, update_priors_frequency):
    """The multi-trait single-chain loop as runMCMC ran it before it ran
    several chains. Returns (state, accum, samples)."""
    run_window = emt.make_mt_run_window(cfg)
    accum = emt.init_mt_accum(data, state)
    samples = {k: [] for k in emt.SAMPLE_KEYS}
    prior_epoch = 0
    if plan.burnin_outer > 0:
        state, accum, _ = run_window(state, data, accum, plan.burnin_outer,
                                     accumulate=False)
    for w in range(plan.n_saved):
        state, accum, out = run_window(state, data, accum, plan.thin_outer)
        host = emt._read_back(state, out, None, cfg.n_markers)
        iters = (plan.burnin_outer + (w + 1) * plan.thin_outer) * plan.nreps
        if iters // update_priors_frequency > prior_epoch:
            prior_epoch = iters // update_priors_frequency
            data = emt.apply_update_priors_mt(cfg, data, accum)
        for k in samples:
            samples[k].append(host[k])
    return state, accum, samples


def test_mt_one_chain_is_todays_path():
    """run_mt_chains with one state gives the single-chain loop's chain bit
    for bit, prior refresh included."""
    sim = _small()
    opts = MCMCOptions(chain_length=24, burnin=6, output_samples_frequency=3, seed=2,
                       output_folder="", printout_model_info=False)
    model = _model(sim)
    ws = prepare_workspace(model, sim["phenotypes"], opts, device="cpu")
    cfg, data, state = emt.build_mt_data_and_state(ws, opts, torch.device("cpu"))
    plan = em.chain_plan(24, 6, 3, cfg.nreps)
    s1, a1, samples1 = _single_chain_loop(cfg, data, state, plan, 6)
    cfg, data, states = emt.build_mt_data_and_states(ws, opts, torch.device("cpu"), 1)
    s2, a2, samples2, tracks, _, _ = emt.run_mt_chains(cfg, data, states, plan,
                                                       update_priors_frequency=6)
    for f in a1._fields:
        x, y = getattr(a1, f), getattr(a2[0], f)
        if torch.is_tensor(x):
            assert torch.equal(x, y), f
    assert torch.equal(s1.alpha, s2[0].alpha)
    for k in samples1:
        np.testing.assert_array_equal(np.asarray(samples1[k]), np.asarray(samples2[k]))
    assert np.stack(tracks["genvar"]).shape == (plan.n_saved, 1, 2, 2)


def test_mt_prior_refresh_and_rr_blup_chains():
    """The prior refresh from the pooled means, and multi-trait RR-BLUP (K9's
    plain version) with two chains."""
    sim = _small()
    for method, kw in (("BayesC", dict(update_priors_frequency=6)), ("RR-BLUP", {})):
        geno = jt.get_genotypes(sim["genotypes"], method=method, name="geno", device="cpu")
        out = jt.runMCMC(jt.build_model(EQ, genotypes=geno), sim["phenotypes"], seed=1,
                         n_chains=2, output_folder="", **RUN, **kw)
        assert np.isfinite(np.asarray(out["marker effects geno"]["Estimate"], float)).all()
        assert np.isfinite(out["PSRF"]["PSRF"]).all()
