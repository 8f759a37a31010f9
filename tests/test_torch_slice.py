"""The whole slice against jwas_tpu: runMCMC vs run_st on the same store.

Both packages run single-trait BayesC (fast_blocks = 8 -> b = 8, gb = 20,
13 groups) on one 2-bit store (n = 400, p = 2,000, 20 QTL, h2 = 0.5,
phenotype rows shuffled so the row permutation is exercised), with the
priors of jwas_tpu's prepare_workspace. Their random streams differ, so
posterior means agree only within Monte-Carlo error.

Bounds (BOUNDS below) are 99% bounds on the difference of two
independent 2,000-sweep chains, calibrated on this data with seeds 1-6 of
both packages: 2.576 * sqrt(2) * s, where s is the between-seed standard
deviation of a chain's posterior mean pooled over the two packages. The
posterior is bimodal in (vare, varg) at p >> n, which is why s is large.
"""

import jax
import numpy as np
import pytest
import torch

from jwas_tpu import build_model, get_genotypes, prepare_packed_genotypes, runMCMC
from jwas_tpu.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu.io.datasets import simulate_genomic_data
import jwas_tpu_torch as jt

CHAIN = dict(chain_length=2000, burnin=400)
# seeds 1-6: vare means 9.00 (sd 0.61) jwas_tpu, 9.21 (sd 1.14) port;
# varg 0.0136 (0.0022), 0.0124 (0.0031); pi 0.111 (0.086), 0.058 (0.027)
BOUNDS = {"vare": 3.33, "varg": 0.0098, "pi": 0.23}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    # runMCMC(double_precision=True) elsewhere in a worker leaves JAX's x64
    # mode on; both chains here are float32
    jax.config.update("jax_enable_x64", False)
    sim = simulate_genomic_data(n=400, p=2000, n_qtl=20, h2=0.5, seed=11)
    path = str(tmp_path_factory.mktemp("store") / "geno")
    store = prepare_packed_genotypes(sim["genotypes"], save_path=path)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=1).reset_index(drop=True)
    opts = dict(fast_blocks=8, output_folder="", printout_model_info=False, **CHAIN)

    def model():
        return build_model("y = intercept + geno",
                           genotypes=get_genotypes(store, method="BayesC", name="geno"))

    ws = prepare_workspace(model(), pheno, MCMCOptions(**opts))
    ref = runMCMC(model(), pheno, seed=7, **opts)
    tbv = dict(zip(sim["phenotypes"].ID, sim["true_bv"]))
    gm = jt.setup_markers(jt.Packed2BitStore.load(path, mmap=True), ws.obs_ids,
                          "cpu", fast_blocks=8)
    priors = dict(W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R, df_R=ws.df_R,
                  marker_var0=ws.marker_var0, marker_scale0=ws.marker_scale0,
                  df_marker=ws.df_marker, pi0=ws.pi0)
    return dict(ws=ws, ref=ref, tbv=tbv, gm=gm, priors=priors)


def test_chain_matches_jwas_tpu_within_mc_error(problem):
    ref, ws, gm = problem["ref"], problem["ws"], problem["gm"]
    assert gm.row_perm is not None and (gm.grams.shape[1], gm.ngroups) == (8, 13)
    got = jt.run_st(gm, ws.y, **problem["priors"], seed=7, **CHAIN)
    want = {"vare": ref["residual variance"].Estimate[0],
            "varg": ref["marker effects variances geno"].Estimate[0],
            "pi": ref["pi_geno"].Estimate[0]}
    for k, bound in BOUNDS.items():
        assert abs(got[k] - want[k]) < bound, (k, got[k], want[k], bound)
    ebv_ref = dict(zip(ref["EBV_y"].ID, ref["EBV_y"].EBV))
    ebv_ref = np.array([ebv_ref[s] for s in ws.obs_ids])
    assert np.corrcoef(got["ebv"], ebv_ref)[0, 1] >= 0.95
    tbv = np.array([problem["tbv"][s] for s in ws.obs_ids])
    acc = np.corrcoef(got["ebv"], tbv)[0, 1]
    assert acc > np.corrcoef(ebv_ref, tbv)[0, 1] - 0.05
    assert len(got["samples"]["vare"]) == (2000 - 400) // 8
    assert np.isfinite(got["alpha"]).all() and got["alpha"].shape == (2000,)


def test_run_st_options(problem):
    """Options outside the slice raise NotImplementedError naming the
    option. Each draw that is switched off keeps its starting value; the
    scale draw moves the scale; nreps sets the sweeps per saved sample."""
    for option, value in (
            ("method", "BayesA"), ("rinv", np.ones(400)), ("dtype", torch.float64),
            ("random_effects", ["ID"]), ("trait_type", "categorical"),
            ("annotations", np.ones((2000, 1))), ("n_genotype_categories", 2)):
        with pytest.raises(NotImplementedError, match=option):
            jt.run_st(problem["gm"], problem["ws"].y, **problem["priors"],
                      chain_length=8, **{option: value})
    priors = dict(problem["priors"], pi0=0.3)
    f32 = np.float32
    for flags in (dict(estimate_pi=False), dict(estimate_marker_variance=False),
                  dict(estimate_residual_variance=False),
                  dict(estimate_scale=True), dict(nreps=4, sync_every=2),
                  dict(nreps=4, sync_every=0)):
        res = jt.run_st(problem["gm"], problem["ws"].y, **priors,
                        chain_length=64, seed=1, **flags)
        s = res["samples"]
        assert all(np.isfinite(s[k]).all() for k in s), flags
        assert (s["pi"] == f32(0.3)).all() == (not flags.get("estimate_pi", True))
        assert (s["varg"] == f32(priors["marker_var0"])).all() == (
            not flags.get("estimate_marker_variance", True))
        assert (s["vare"] == f32(priors["vare0"])).all() == (
            not flags.get("estimate_residual_variance", True))
        assert (res["scale"] != f32(priors["marker_scale0"])) == flags.get(
            "estimate_scale", False)
        assert res["nreps"] == flags.get("nreps", 8)
        assert len(s["vare"]) == 64 // res["nreps"]
