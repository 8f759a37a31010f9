"""The BayesR slice against jwas_tpu: runMCMC vs run_st(method="BayesR").

Both packages run single-trait BayesR (fast_blocks = 8 -> b = 8, gb = 20,
7 groups) on one 2-bit store (n = 400, p = 1,000, 20 QTL, h2 = 0.5,
phenotype rows shuffled so the row permutation is exercised), with the
priors of jwas_tpu's prepare_workspace (pi0 the default class prior). Their
random streams differ, so posterior means agree only within Monte-Carlo
error.

Bounds (BOUNDS below) are 99% bounds on the difference of two independent
1,000-sweep chains if the port samples jwas_tpu's posterior with
jwas_tpu's mixing: 2.576 * sqrt(2) * s, where s is the between-seed
standard deviation of jwas_tpu's posterior means over seeds 1-34 on this
data. sigma^2 and the class shares trade off against each other between
chains, and sigma^2's chain means have a heavy right tail in both packages
(a chain may spend its first few hundred sweeps at sigma^2 2-7 with few
markers in the slab classes: port seed 1 2.62, jwas_tpu seed 17 2.27,
medians 0.83 and 0.85), so sigma^2 is held on the log scale. The genetic
variance and h^2 do not swing with that trade-off and are held tightest.
"""

import jax
import numpy as np
import pytest
import torch

from jwas_tpu import build_model, get_genotypes, prepare_packed_genotypes, runMCMC
from jwas_tpu.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu.io.datasets import simulate_genomic_data
import jwas_tpu_torch as jt

CHAIN = dict(chain_length=1000, burnin=200)
# seeds 1-34, mean (between-seed sd) of the chains' posterior means,
# jwas_tpu then port: vare 3.596 (0.086), 3.604 (0.083); log sigma^2
# -0.115 (0.258), -0.139 (0.295); genetic variance 5.714 (0.122), 5.675
# (0.117); h2 0.6132 (0.0102), 0.6111 (0.0101); pi 0.8950 (0.0396), 0.8971
# (0.0437) | 0.0655 (0.0399), 0.0636 (0.0443) | 0.0180 (0.0069), 0.0181
# (0.0061) | 0.0215 (0.0025), 0.0213 (0.0030). No difference of means
# exceeds 1.4 standard errors.
BOUNDS = {"vare": 0.3125, "log_varg": 0.9414, "genvar": 0.4445, "h2": 0.0370,
          "pi": np.array([0.1441, 0.1455, 0.0253, 0.0092])}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    # runMCMC(double_precision=True) elsewhere in a worker leaves JAX's x64
    # mode on; both chains here are float32
    jax.config.update("jax_enable_x64", False)
    sim = simulate_genomic_data(n=400, p=1000, n_qtl=20, h2=0.5, seed=11)
    path = str(tmp_path_factory.mktemp("store") / "geno")
    store = prepare_packed_genotypes(sim["genotypes"], save_path=path)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=1).reset_index(drop=True)
    opts = dict(fast_blocks=8, output_folder="", printout_model_info=False, **CHAIN)

    def model():
        return build_model("y = intercept + geno",
                           genotypes=get_genotypes(store, method="BayesR", name="geno"))

    ws = prepare_workspace(model(), pheno, MCMCOptions(**opts))
    ref = runMCMC(model(), pheno, seed=7, **opts)
    tbv = dict(zip(sim["phenotypes"].ID, sim["true_bv"]))
    gm = jt.setup_markers(jt.Packed2BitStore.load(path, mmap=True), ws.obs_ids,
                          "cpu", fast_blocks=8)
    priors = dict(W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R, df_R=ws.df_R,
                  marker_var0=ws.marker_var0, marker_scale0=ws.marker_scale0,
                  df_marker=ws.df_marker, pi0=ws.pi0)
    return dict(ws=ws, ref=ref, tbv=tbv, gm=gm, priors=priors)


def test_bayesr_chain_matches_jwas_tpu_within_mc_error(problem):
    ref, ws, gm = problem["ref"], problem["ws"], problem["gm"]
    assert gm.row_perm is not None and (gm.grams.shape[1], gm.store.shape[0]) == (8, 7)
    np.testing.assert_allclose(ws.pi0, jt.engine.mcmc.DEFAULT_BAYESR_PI)
    res = jt.run_st(gm, ws.y, **problem["priors"], method="BayesR", seed=7, **CHAIN)
    smp = res["samples"]
    got = {"vare": res["vare"], "log_varg": np.log(res["varg"]),
           "genvar": smp["genvar"].mean(), "h2": smp["h2"].mean(), "pi": res["pi"]}
    want = {"vare": ref["residual variance"].Estimate[0],
            "log_varg": np.log(ref["marker effects variances geno"].Estimate[0]),
            "genvar": ref["genetic_variance"].Estimate[0],
            "h2": ref["heritability"].Estimate[0],
            "pi": np.asarray(ref["pi_geno"].Estimate, dtype=np.float64)}
    for k, bound in BOUNDS.items():
        assert np.all(np.abs(got[k] - want[k]) < bound), (k, got[k], want[k], bound)
    # every outer iteration draws vare, sigma^2 and pi anew: no track sticks
    for track in (smp["vare"], smp["varg"], smp["pi"][:, 0]):
        assert np.unique(track).size == track.size
    ebv_ref = dict(zip(ref["EBV_y"].ID, ref["EBV_y"].EBV))
    ebv_ref = np.array([ebv_ref[s] for s in ws.obs_ids])
    assert np.corrcoef(res["ebv"], ebv_ref)[0, 1] >= 0.95
    tbv = np.array([problem["tbv"][s] for s in ws.obs_ids])
    acc = np.corrcoef(res["ebv"], tbv)[0, 1]
    assert acc > np.corrcoef(ebv_ref, tbv)[0, 1] - 0.05
    assert res["pi"].shape == (4,) and smp["pi"].shape == ((1000 - 200) // 8, 4)
    freq = res["model_frequency"]
    assert freq.shape == (1000,) and 0.0 <= freq.min() and freq.max() <= 1.0
    assert abs(freq.mean() - (1.0 - res["pi"][0])) < 0.02


def test_bayesr_options(problem):
    """Each draw switched off keeps its start; pi is (4,) and sums to 1 and
    samples["pi"] is (n_saved, 4); a pi0 of 0 takes the default class
    prior; a bad pi0 raises ValueError."""
    gm, y = problem["gm"], problem["ws"].y
    priors = dict(problem["priors"], pi0=[0.9, 0.05, 0.03, 0.02])
    f32 = np.float32
    for flags in (dict(), dict(estimate_pi=False),
                  dict(estimate_marker_variance=False),
                  dict(estimate_residual_variance=False),
                  dict(estimate_scale=True), dict(nreps=4, sync_every=3)):
        res = jt.run_st(gm, y, **priors, method="BayesR", chain_length=64,
                        seed=2, **flags)
        s = res["samples"]
        nreps = flags.get("nreps", 8)
        assert res["nreps"] == nreps and s["pi"].shape == (64 // nreps, 4), flags
        assert all(np.isfinite(s[k]).all() for k in s), flags
        np.testing.assert_allclose(s["pi"].sum(axis=1), 1.0, rtol=1e-5)
        assert res["pi"].shape == res["pi_sd"].shape == (4,)
        keeps_pi = (s["pi"] == np.asarray(priors["pi0"], f32)).all()
        assert keeps_pi == (not flags.get("estimate_pi", True)), flags
        assert (s["varg"] == f32(priors["marker_var0"])).all() == (
            not flags.get("estimate_marker_variance", True)), flags
        assert (s["vare"] == f32(priors["vare0"])).all() == (
            not flags.get("estimate_residual_variance", True)), flags
        assert (res["scale"] != f32(priors["marker_scale0"])) == flags.get(
            "estimate_scale", False), flags
    res = jt.run_st(gm, y, **dict(priors, pi0=0.0), method="BayesR",
                    chain_length=16, estimate_pi=False)
    np.testing.assert_allclose(res["pi"], jt.engine.mcmc.DEFAULT_BAYESR_PI,
                               rtol=1e-6)
    for bad in ([0.9, 0.1], [0.5, 0.3, 0.3, -0.1], [0.9, 0.05, 0.03, 0.03]):
        with pytest.raises(ValueError, match="BayesR Pi"):
            jt.run_st(gm, y, **dict(priors, pi0=bad), method="BayesR",
                      chain_length=8)
