"""runMCMC with RR-BLUP, BayesL and BayesA on dense genotypes: against its
own run_st bit for bit, against jwas_tpu.runMCMC within Monte-Carlo error,
and the result tables and sample files against jwas_tpu's.

Data: simulate_genomic_data(n = 300, p = 300, 15 QTL, h2 = 0.5, seed 21),
phenotype rows shuffled (numpy seed 4), storage "f32", y = intercept +
geno, as tests/test_torch_dense_runmcmc.py. The chains: fast_blocks = 8
(b = 8, 38 blocks, gb = 2, 19 groups), 800 sweeps, 200 burn-in.

BOUNDS are 99% bounds on the difference of two independent chains'
posterior means, calibrated on this data with seeds 1-8 of each package
(python tests/test_torch_methods_runmcmc.py calibrate ..., PYTHONPATH=.):
2.576 * sqrt(2) * s, s the between-seed standard deviation of a chain's
posterior mean pooled over the two packages.
"""

import json
import os
import sys

import numpy as np
import pytest

METHODS = ("RR-BLUP", "BayesL", "BayesA")
CHAIN = dict(fast_blocks=8, chain_length=800, burnin=200)
KEYS = ("vare", "varg")
# seeds 1-8 of each package (calibrate below); chain means port / jwas_tpu:
BOUNDS = {
    # RR-BLUP vare 8.827 / 8.914 (sd 0.241 / 0.520), varg 0.0803 / 0.0805
    # (0.0060 / 0.0079); BayesL vare 6.955 / 6.973 (0.430 / 0.287), varg
    # 0.0106 / 0.0109 (0.0005 / 0.0009); BayesA vare 6.572 / 6.587 (0.214 /
    # 0.281), varg 0.0895 / 0.0904 (0.0016 / 0.0011)
    "RR-BLUP": {"vare": 1.476, "varg": 0.02557},
    "BayesL": {"vare": 1.331, "varg": 0.002603},
    "BayesA": {"vare": 0.9088, "varg": 0.005128},
}


def dense_problem():
    """(simulated data, shuffled phenotypes as a DataFrame and as the
    port's Table)."""
    import jwas_tpu_torch as jt
    from jwas_tpu.io.datasets import simulate_genomic_data

    sim = simulate_genomic_data(n=300, p=300, n_qtl=15, h2=0.5, seed=21)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=4).reset_index(drop=True)
    table = jt.Table({c: (np.array([str(x) for x in pheno[c]], dtype=object)
                          if c == "ID" else np.asarray(pheno[c])) for c in pheno.columns})
    return sim, pheno, table


def run_chain(package, method, seed, sim, pheno, table, **extra):
    """One runMCMC chain of a package ("port" on the CPU, or "jwas_tpu");
    returns (its results, the posterior means of KEYS)."""
    opts = dict(CHAIN, seed=seed, output_folder="", printout_model_info=False)
    opts.update(extra)
    if package == "port":
        import jwas_tpu_torch as jt
        model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
            sim["genotypes"], method=method, device="cpu"))
        out = jt.runMCMC(model, table, device="cpu", **opts)
    else:
        import jwas_tpu
        model = jwas_tpu.build_model("y = intercept + geno", genotypes=jwas_tpu.get_genotypes(
            sim["genotypes"], method=method))
        out = jwas_tpu.runMCMC(model, pheno, **opts)
    means = dict(vare=float(out["residual variance"].Estimate[0]),
                 varg=float(out["marker effects variances geno"].Estimate[0]))
    return out, means


@pytest.fixture(scope="module")
def problem():
    import jax
    jax.config.update("jax_enable_x64", False)
    return dense_problem()


@pytest.mark.parametrize("method", METHODS)
def test_chain_matches_jwas_tpu_within_mc_error(problem, method):
    """One chain of each package: KEYS within BOUNDS[method], the EBVs of
    all 300 IDs correlate >= 0.95, as tests/test_torch_dense_runmcmc.py
    holds BayesC."""
    ref, ref_m = run_chain("jwas_tpu", method, 7, *problem)
    out, our_m = run_chain("port", method, 7, *problem)
    for k in KEYS:
        assert abs(our_m[k] - ref_m[k]) < BOUNDS[method][k], (method, k, our_m, ref_m)
    ours = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    theirs = dict(zip(ref["EBV_y"].ID, ref["EBV_y"].EBV))
    ids = list(theirs)
    assert sorted(ours) == sorted(theirs) and len(ids) == 300
    assert np.corrcoef([ours[s] for s in ids], [theirs[s] for s in ids])[0, 1] >= 0.95


@pytest.mark.parametrize("storage", ["f32", "int8", "f64"])
@pytest.mark.parametrize("fast_blocks", [8, False], ids=["blocked", "exact"])
@pytest.mark.parametrize("method", METHODS)
def test_runmcmc_equals_run_st(problem, method, fast_blocks, storage):
    """runMCMC on a dense store equals run_st fed the same workspace's
    priors, W and row order on setup_dense_markers' store, bit for bit;
    BayesA is run_st's BayesB with pi0 0 and estimate_pi False, as
    normalize_method makes it. int8 storage rounds the scores; f64
    storage runs with double_precision."""
    import torch

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine.mcmc import setup_dense_markers
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    sim, _, table = problem
    dp = storage == "f64"
    opts = dict(fast_blocks=fast_blocks, chain_length=24, burnin=8, seed=3,
                output_folder="", printout_model_info=False, double_precision=dp,
                heterogeneous_residuals=fast_blocks is False)
    table = jt.Table({**{c: table[c] for c in table.columns},
                      "weights": np.linspace(0.5, 2.0, len(table))})

    def model():
        return jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
            sim["genotypes"], method=method, storage=storage, device="cpu"))

    out = jt.runMCMC(model(), table, device="cpu", **opts)
    ws = prepare_workspace(model(), table, MCMCOptions(**opts))
    assert (ws.geno.method, ws.geno.estimate_pi) == (
        "BayesB" if method == "BayesA" else method, False)
    gm = setup_dense_markers(ws.geno.dense, ws.geno.obs_ids, ws.obs_ids, "cpu",
                             fast_blocks=fast_blocks, rinv=ws.rinv)
    assert gm.exact == (fast_blocks is False)
    assert gm.X.dtype == (torch.float64 if dp else torch.float32)
    res = jt.run_st(gm, ws.y, W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R,
                    df_R=ws.df_R, marker_var0=ws.marker_var0,
                    marker_scale0=ws.marker_scale0, df_marker=ws.df_marker,
                    pi0=ws.pi0, method=ws.geno.method, estimate_pi=False,
                    chain_length=24, burnin=8, seed=3)
    assert np.array_equal(out["marker effects geno"].Estimate, res["alpha"])
    dtype = res["alpha"].dtype.type
    assert dtype(out["residual variance"].Estimate[0]) == res["vare"]
    ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    assert np.array_equal(np.array([ebv[s] for s in ws.obs_ids]), res["ebv"])
    assert np.isfinite(res["alpha"]).all() and np.isfinite(res["vare"])
    assert res["samples"]["pi"].shape[1:] == (() if method == "BayesA" else (0,))


def _numbers(row):
    try:
        [float(x) for x in row.split(",") if x]
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("method", METHODS)
def test_results_and_sample_files_match_jwas_tpu(problem, method, tmp_path):
    """One short chain of each package writing its files: the same result
    keys and columns, the same sample files with the same header rows and
    values a row (BayesA's pi row its 0, RR-BLUP's and BayesL's empty),
    the same number of rows."""
    files, keys = {}, {}
    for package in ("port", "jwas_tpu"):
        folder = str(tmp_path / package)
        out, _ = run_chain(package, method, 5, *problem, chain_length=32, burnin=0,
                           output_samples_frequency=8, output_folder=folder)
        keys[package] = {k: list(v.columns) for k, v in out.items() if not k.startswith("_")}
        files[package] = {}
        for name in sorted(os.listdir(folder)):
            with open(os.path.join(folder, name)) as f:
                files[package][name] = f.read().splitlines()
    assert keys["port"] == keys["jwas_tpu"]
    assert sorted(files["port"]) == sorted(files["jwas_tpu"])
    for name, theirs in files["jwas_tpu"].items():
        ours = files["port"][name]
        assert len(ours) == len(theirs), name
        if name.startswith("MCMC_samples"):
            if not _numbers(theirs[0]):
                assert ours[0] == theirs[0], name
            assert [r.count(",") for r in ours] == [r.count(",") for r in theirs], name
            assert [r == "" for r in ours] == [r == "" for r in theirs], name


def calibrate(package, method, first, last, out):
    """Chain means of seeds first..last of one package and method, written
    to out (JSON); `summarize` turns such files into BOUNDS."""
    import time

    import torch
    torch.set_num_threads(1)
    problem = dense_problem()
    rows = []
    for s in range(first, last + 1):
        t0 = time.perf_counter()
        rows.append(dict(seed=s, **run_chain(package, method, s, *problem)[1],
                         seconds=time.perf_counter() - t0))
    with open(out, "w") as f:
        json.dump({"package": package, "method": method, "rows": rows}, f)


def summarize(files):
    by = {}
    for name in files:
        with open(name) as f:
            d = json.load(f)
        by.setdefault(d["method"], {}).setdefault(d["package"], []).extend(d["rows"])
    for method, pk in sorted(by.items()):
        line = []
        for k in KEYS:
            sds = [np.std([r[k] for r in rows], ddof=1) for rows in pk.values()]
            s = float(np.sqrt(np.mean(np.square(sds))))
            means = {p: round(float(np.mean([r[k] for r in rows])), 4) for p, rows in pk.items()}
            line.append(f"{k}: means {means}, sd {[round(float(x), 4) for x in sds]}, "
                        f"bound {2.576 * np.sqrt(2) * s:.4g}")
        secs = {p: round(float(np.mean([r["seconds"] for r in rows])), 1) for p, rows in pk.items()}
        print(method, {p: len(r) for p, r in pk.items()}, secs, "; ".join(line))


if __name__ == "__main__":
    # python tests/test_torch_methods_runmcmc.py calibrate port|jwas_tpu METHOD 1 8 out.json
    # python tests/test_torch_methods_runmcmc.py summarize out*.json
    if sys.argv[1] == "calibrate":
        calibrate(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    else:
        summarize(sys.argv[2:])
