"""runMCMC(model, df) on dense genotypes: against its own run_st, and
against jwas_tpu.runMCMC within Monte-Carlo error.

Data: simulate_genomic_data(n = 300, p = 300, 15 QTL, h2 = 0.5, seed 21),
phenotype rows shuffled (numpy seed 4) so the row order is exercised, a
'weights' column ~ U(0.5, 2), storage "f32", BayesC, y = intercept + geno.
Three configurations: blocked (fast_blocks = 8: b = 8, 38 blocks, gb = 2,
19 groups; 2,000 sweeps, 400 burn-in), exact (fast_blocks = False: the
single-site sweep, in the port chunks of b = 128 through K1's plain
version; 1,000 sweeps, 200 burn-in) and weighted (blocked with
heterogeneous_residuals = True; tests/test_torch_weights.py).

BOUNDS are 99% bounds on the difference of two independent chains'
posterior means, calibrated on this data with seeds 1-8 of each package
(python tests/test_torch_dense_runmcmc.py calibrate ...): 2.576 * sqrt(2) *
s, s the between-seed standard deviation of a chain's posterior mean
pooled over the two packages. The marker-variance bound is such a
calibrated bound (fault R6: tests/test_parity.py:111 uses a relative 0.25
where the calibrated 99% bound is 0.105), not a loose relative one.
"""

import json
import sys

import numpy as np
import pytest

CHAINS = {"blocked": dict(fast_blocks=8, chain_length=2000, burnin=400),
          "exact": dict(fast_blocks=False, chain_length=1000, burnin=200),
          "weighted": dict(fast_blocks=8, chain_length=2000, burnin=400,
                           heterogeneous_residuals=True)}
KEYS = ("vare", "varg", "pi")
# seeds 1-8 of each package (calibrate below). Chain means, port / jwas_tpu:
# blocked vare 8.270 / 8.156 (sd 0.155 / 0.135), varg 0.983 / 0.972 (0.143 /
# 0.161), pi 0.880 / 0.858 (0.088 / 0.108); exact vare 8.239 / 8.232 (0.054 /
# 0.012), varg 1.093 / 1.081 (0.038 / 0.033), pi 0.9226 / 0.9224 (0.0035 /
# 0.0024); weighted vare 7.087 / 7.018 (0.103 / 0.146), varg 0.938 / 0.924
# (0.131 / 0.141), pi 0.879 / 0.854 (0.046 / 0.085)
BOUNDS = {
    "blocked": {"vare": 0.5286, "varg": 0.5537, "pi": 0.3586},
    "exact": {"vare": 0.1438, "varg": 0.1285, "pi": 0.01087},
    "weighted": {"vare": 0.4602, "varg": 0.4948, "pi": 0.2491},
}


def dense_problem():
    """(simulated data, shuffled phenotypes with weights as a DataFrame and
    as the port's Table)."""
    import jwas_tpu_torch as jt
    from jwas_tpu.io.datasets import simulate_genomic_data

    sim = simulate_genomic_data(n=300, p=300, n_qtl=15, h2=0.5, seed=21)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=4).reset_index(drop=True)
    pheno["weights"] = np.random.default_rng(4).uniform(0.5, 2.0, len(pheno))
    table = jt.Table({c: (np.array([str(x) for x in pheno[c]], dtype=object)
                          if c == "ID" else np.asarray(pheno[c])) for c in pheno.columns})
    return sim, pheno, table


def run_chain(package, config, seed, sim, pheno, table, **extra):
    """One runMCMC chain of a package ("port" on the CPU, or "jwas_tpu");
    returns (its results, the posterior means of KEYS)."""
    opts = dict(CHAINS[config], seed=seed, output_folder="", printout_model_info=False,
                **extra)
    if package == "port":
        import jwas_tpu_torch as jt
        model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
            sim["genotypes"], method="BayesC", device="cpu"))
        out = jt.runMCMC(model, table, device="cpu", **opts)
    else:
        import jwas_tpu
        model = jwas_tpu.build_model("y = intercept + geno", genotypes=jwas_tpu.get_genotypes(
            sim["genotypes"], method="BayesC"))
        out = jwas_tpu.runMCMC(model, pheno, **opts)
    means = dict(vare=float(out["residual variance"].Estimate[0]),
                 varg=float(out["marker effects variances geno"].Estimate[0]),
                 pi=float(out["pi_geno"].Estimate[0]))
    return out, means


@pytest.fixture(scope="module")
def problem():
    import jax
    jax.config.update("jax_enable_x64", False)
    return dense_problem()


def assert_within_mc_error(problem, config, seed=7):
    """One chain of each package: KEYS within BOUNDS[config], the EBVs of
    all 300 IDs correlate >= 0.95."""
    ref, ref_m = run_chain("jwas_tpu", config, seed, *problem)
    out, our_m = run_chain("port", config, seed, *problem)
    for k in KEYS:
        assert abs(our_m[k] - ref_m[k]) < BOUNDS[config][k], (config, k, our_m, ref_m)
    ours = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    theirs = dict(zip(ref["EBV_y"].ID, ref["EBV_y"].EBV))
    ids = list(theirs)
    assert sorted(ours) == sorted(theirs) and len(ids) == 300
    assert np.corrcoef([ours[s] for s in ids], [theirs[s] for s in ids])[0, 1] >= 0.95


def test_dense_runmcmc_equals_run_st(problem):
    """runMCMC on a dense store equals run_st fed the same workspace's
    priors, W and row order on setup_dense_markers' store, bit for bit, for
    BayesC, BayesB and BayesR, blocked (fast_blocks = 8 or True) and exact
    (fast_blocks = False), from f32, int8 and f64 storage (the last with
    double_precision)."""
    import torch

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine.mcmc import setup_dense_markers
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    sim, _, table = problem
    cases = (("BayesC", 8, "f32"), ("BayesC", False, "f32"), ("BayesB", True, "int8"),
             ("BayesB", False, "f32"), ("BayesR", 8, "f32"), ("BayesR", False, "f64"))
    for method, fb, storage in cases:
        dp = storage == "f64"
        opts = dict(fast_blocks=fb, chain_length=48, burnin=16, seed=3, output_folder="",
                    printout_model_info=False, double_precision=dp)

        def model():
            return jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
                sim["genotypes"], method=method, storage=storage, device="cpu"))

        out = jt.runMCMC(model(), table, device="cpu", **opts)
        ws = prepare_workspace(model(), table, MCMCOptions(**opts))
        gm = setup_dense_markers(ws.geno.dense, ws.geno.obs_ids, ws.obs_ids, "cpu",
                                 fast_blocks=fb)
        assert gm.row_perm is not None and gm.exact == (fb is False)
        assert gm.X.dtype == (torch.float64 if dp else torch.float32)
        res = jt.run_st(gm, ws.y, W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R,
                        df_R=ws.df_R, marker_var0=ws.marker_var0,
                        marker_scale0=ws.marker_scale0, df_marker=ws.df_marker,
                        pi0=ws.pi0, method=method, chain_length=48, burnin=16, seed=3)
        case = (method, fb, storage)
        assert res["nreps"] == (1 if fb is False else min(gm.grams.shape[1], 48)), case
        assert np.array_equal(out["marker effects geno"].Estimate, res["alpha"]), case
        dtype = res["alpha"].dtype.type
        assert dtype(out["residual variance"].Estimate[0]) == res["vare"], case
        ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
        assert np.array_equal(np.array([ebv[s] for s in ws.obs_ids]), res["ebv"]), case
        assert np.isfinite(res["alpha"]).all() and np.isfinite(res["vare"]), case


def test_blocked_matches_jwas_tpu_within_mc_error(problem):
    assert_within_mc_error(problem, "blocked")


def test_exact_matches_jwas_tpu_within_mc_error(problem):
    assert_within_mc_error(problem, "exact")


def calibrate(package, config, first, last, out):
    """Chain means of seeds first..last of one package and configuration,
    written to out (JSON); `summarize` turns such files into BOUNDS."""
    import torch
    torch.set_num_threads(1)
    problem = dense_problem()
    rows = [dict(seed=s, **run_chain(package, config, s, *problem)[1])
            for s in range(first, last + 1)]
    with open(out, "w") as f:
        json.dump({"package": package, "config": config, "rows": rows}, f)


def summarize(files):
    by = {}
    for name in files:
        with open(name) as f:
            d = json.load(f)
        by.setdefault(d["config"], {}).setdefault(d["package"], []).extend(d["rows"])
    for config, pk in sorted(by.items()):
        line = []
        for k in KEYS:
            sds = [np.std([r[k] for r in rows], ddof=1) for rows in pk.values()]
            s = float(np.sqrt(np.mean(np.square(sds))))
            means = {p: np.mean([r[k] for r in rows]) for p, rows in pk.items()}
            line.append(f"{k}: means {means}, sd {sds}, bound {2.576 * np.sqrt(2) * s:.4g}")
        print(config, {p: len(r) for p, r in pk.items()}, "; ".join(line))


if __name__ == "__main__":
    # python tests/test_torch_dense_runmcmc.py calibrate port|jwas_tpu CONFIG 1 8 out.json
    # python tests/test_torch_dense_runmcmc.py summarize out*.json
    if sys.argv[1] == "calibrate":
        calibrate(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    else:
        summarize(sys.argv[2:])
