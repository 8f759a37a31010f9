"""GBLUP in the port against jwas_tpu.

(1) The relationship matrix: from genotypes (QC, centering, Z Z' / p with
    the ridge and its Cholesky retries; float32, float64 and int8 with
    missing codes) against jwas_tpu's get_genotypes(method="GBLUP"): atol
    1e-5 (float32 sums of p products in another order); a symmetric
    n x n input is passed through as the matrix (array, tensor, CSV).
(2) The workspace: L diag(D) L' and the output map times L' (both free of
    the eigenvectors' signs) against jwas_tpu's, to 1e-5 relative to the
    largest entry; where some genotyped individuals have no phenotype,
    jwas_tpu's sweep fails (fault R9) and the port's eigenbasis of the
    training block still reproduces G (out_map diag(D) L' = G[out, train]).
(3) sweep_gblup on jwas_tpu's L, D and normal draws: rtol 1e-5 / atol
    1e-6 on alpha, 1e-4 / 1e-5 on ycorr (float32 GEMVs in another order).
(4) runMCMC GBLUP (simulate_genomic_data(n = 300, p = 300, seed 21),
    phenotypes shuffled, 2,000 iterations, 400 burn-in) against
    jwas_tpu.runMCMC within 99% Monte-Carlo bounds calibrated with seeds
    1-8 of each package (python tests/test_torch_gblup.py calibrate ...,
    PYTHONPATH=.): vare and varg 2.576 * sqrt(2) * s (s the pooled
    between-seed sd of a chain's mean), and the posterior EBVs' correlation
    at least the lowest of the 64 cross-package seed pairs less 0.01;
    runMCMC equals run_st bit for bit; the result tables and sample files
    have jwas_tpu's keys, columns and rows (pseudo-markers "1".."n"); the
    GBLUP rules of validate_args fire through runMCMC.
"""

import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

CHAIN = dict(chain_length=2000, burnin=400)
KEYS = ("vare", "varg")
# seeds 1-8 of each package (calibrate below); chain means port / jwas_tpu:
# vare 9.641 / 9.685 (sd 0.082 / 0.124), varg 7.763 / 7.696 (0.171 / 0.221);
# the posterior EBVs of the 64 cross-package pairs correlate 0.99877-0.99923
BOUNDS = {"vare": 0.3841, "varg": 0.72}
EBV_CORR = 0.9888


def _jax():
    import jax
    jax.config.update("jax_enable_x64", False)
    return jax


@pytest.fixture(autouse=True)
def _x64_off():
    _jax()
    yield
    _jax()


def _codes(n, p, seed, missing=0.0):
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, rng.uniform(0.05, 0.95, p), size=(n, p)).astype(np.float64)
    X[:, 2] = 1.0                              # fixed: dropped by QC
    X[rng.random((n, p)) < missing] = 9.0
    return X


@pytest.mark.parametrize("storage", ["f32", "f64", "int8"])
def test_grm_from_genotypes_matches_jwas_tpu(storage):
    import jwas_tpu
    import jwas_tpu_torch as jt

    X = _codes(60, 150, 1, missing=0.02)
    ref = jwas_tpu.get_genotypes(X, method="GBLUP", storage=storage)
    ours = jt.get_genotypes(X, method="GBLUP", storage=storage, device="cpu")
    assert ours.dense is None and ours.grm.shape == (60, 60)
    assert ours.grm.dtype == (torch.float64 if storage == "f64" else torch.float32)
    np.testing.assert_allclose(ours.grm.numpy(), ref.genotypes, atol=1e-5)
    assert ours.marker_ids == ref.marker_ids and ours.n_markers == ref.n_markers
    assert ours.obs_ids == ref.obs_ids
    np.testing.assert_allclose(ours.allele_freq, ref.allele_freq, rtol=1e-6)
    # the Cholesky retry: a rank-deficient G (more individuals than markers)
    # needs more than the first ridge in both packages
    few = _codes(40, 12, 2)
    few[:, 2] = few[:, 3]
    np.testing.assert_allclose(
        jt.get_genotypes(few, method="GBLUP", storage=storage, device="cpu").grm.numpy(),
        jwas_tpu.get_genotypes(few, method="GBLUP", storage=storage).genotypes, atol=1e-5)


def test_given_grm_is_the_relationship_matrix(tmp_path):
    import jwas_tpu
    import jwas_tpu_torch as jt

    G = jt.get_genotypes(_codes(30, 80, 3), method="GBLUP", storage="f64", device="cpu").grm
    G = G.numpy()
    ids = [f"a{i}" for i in range(30)]
    path = tmp_path / "grm.csv"
    frame = pd.DataFrame(G, columns=ids)
    frame.insert(0, "ID", ids)
    frame.to_csv(path, index=False)
    for src in (G, torch.from_numpy(G), str(path)):
        ours = jt.get_genotypes(src, method="GBLUP", storage="f64", device="cpu")
        np.testing.assert_array_equal(ours.grm.numpy(), G)
        assert ours.n_markers == 30
    ref = jwas_tpu.get_genotypes(str(path), method="GBLUP", storage="f64")
    ours = jt.get_genotypes(str(path), method="GBLUP", storage="f64", device="cpu")
    assert ours.obs_ids == ref.obs_ids == ids and ours.marker_ids == ref.marker_ids
    np.testing.assert_allclose(ours.allele_freq, ref.allele_freq, rtol=0, atol=1e-12)
    for pkg, kw in ((jwas_tpu, {}), (jt, dict(device="cpu"))):
        with pytest.raises(ValueError, match="genetic variance, not a marker variance"):
            pkg.get_genotypes(G, method="GBLUP", G=1.0, G_is_marker_variance=True, **kw)
        with pytest.raises(ValueError, match="BayesC/BayesB/BayesR only"):
            pkg.get_genotypes(G, method="GBLUP", storage="2bit", **kw)


def _pheno(ids, n_pheno, seed=4):
    rng = np.random.default_rng(seed)
    keep = rng.permutation(len(ids))[:n_pheno]
    df = pd.DataFrame({"ID": [ids[i] for i in keep], "y": rng.normal(10.0, 2.0, n_pheno),
                       "weights": rng.uniform(0.5, 2.0, n_pheno)})
    return df


def _table(df):
    import jwas_tpu_torch as jt
    return jt.Table({c: (np.array(df[c].astype(str), dtype=object) if c == "ID"
                         else df[c].to_numpy()) for c in df.columns})


def _workspaces(X, df, **opts):
    import jwas_tpu
    import jwas_tpu_torch as jt
    from jwas_tpu.engine.setup import MCMCOptions as RefOptions
    from jwas_tpu.engine.setup import prepare_workspace as ref_prepare
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    ref = ref_prepare(jwas_tpu.build_model("y = intercept + geno", genotypes=jwas_tpu.get_genotypes(
        X, method="GBLUP")), df, RefOptions(**opts))
    ours = prepare_workspace(jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
        X, method="GBLUP", device="cpu")), _table(df), MCMCOptions(**opts))
    return ref, ours


def test_workspace_matches_jwas_tpu():
    """All 60 genotyped individuals phenotyped, in shuffled order; then 50
    of them, where jwas_tpu's sweep cannot run."""
    import jwas_tpu
    import jwas_tpu_torch as jt

    X = _codes(60, 200, 5)
    ids = [str(i + 1) for i in range(60)]
    ref, ours = _workspaces(X, _pheno(ids, 60))
    assert ours.obs_ids == ref.obs_ids and ours.output_ids == ref.output_ids
    for got, want in (
            ((ours.gblup_L * ours.gblup_D) @ ours.gblup_L.T,
             (ref.gblup_L * ref.gblup_D) @ ref.gblup_L.T),
            (ours.gblup_out @ ours.gblup_L.T, ref.output_genotypes @ ref.gblup_L.T)):
        got = got.double().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np.sort(ours.gblup_D.numpy()), np.sort(ref.gblup_D), rtol=1e-5)
    assert ours.marker_var0 == ref.marker_var0 and ours.marker_scale0 == ref.marker_scale0

    df = _pheno(ids, 50)
    model = jwas_tpu.build_model("y = intercept + geno",
                                 genotypes=jwas_tpu.get_genotypes(X, method="GBLUP"))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jwas_tpu.runMCMC(model, df, chain_length=4, output_folder="",
                         printout_model_info=False)
    _, ours = _workspaces(X, df)
    G = jt.get_genotypes(X, method="GBLUP", device="cpu").grm.double()
    row = {s: i for i, s in enumerate(ids)}
    train = [row[s] for s in ours.obs_ids]
    out = [row[s] for s in ours.output_ids]
    L = ours.gblup_L.double()
    assert L.shape == (50, 50) and len(out) == 60
    np.testing.assert_allclose((L.T @ L).numpy(), np.eye(50), atol=1e-5)
    got = (ours.gblup_out.double() * ours.gblup_D.double()) @ L.T
    np.testing.assert_allclose(got.numpy(), G[out][:, train].numpy(), atol=1e-5)
    res = jt.runMCMC(jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
        X, method="GBLUP", device="cpu")), _table(df), device="cpu", chain_length=40,
        output_folder="", printout_model_info=False, seed=2)
    assert len(res["EBV_y"].ID) == 60 and np.isfinite(res["EBV_y"].EBV).all()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_sweep_gblup_matches_jwas_tpu(weighted):
    jax = _jax()
    import jax.numpy as jnp
    from jwas_tpu.ops import markers as jmk
    from jwas_tpu_torch.engine.convert import from_jax_gblup
    from jwas_tpu_torch.ops.gblup import sweep_gblup

    X = _codes(80, 200, 7)
    ref, _ = _workspaces(X, _pheno([str(i + 1) for i in range(80)], 80))
    rng = np.random.default_rng(8)
    L, D = ref.gblup_L.astype(np.float32), ref.gblup_D.astype(np.float32)
    rinv = rng.uniform(0.5, 2.0, 80).astype(np.float32) if weighted else None
    alpha = (0.1 * rng.normal(size=80)).astype(np.float32)
    y = rng.normal(size=80).astype(np.float32)
    key = jax.random.PRNGKey(9)
    vare, var_a = np.float32(1.3), np.float32(0.7)
    ra, ryc = jmk.sweep_gblup(jnp.asarray(L), jnp.asarray(D), jnp.asarray(alpha),
                              jnp.asarray(y), None if rinv is None else jnp.asarray(rinv),
                              jnp.asarray(vare), jnp.asarray(var_a), key)
    z = torch.from_numpy(np.array(jax.random.normal(key, (80,))))
    gm = from_jax_gblup(L, D, rinv=rinv)
    a, yc = torch.from_numpy(alpha.copy()), torch.from_numpy(y.copy())
    sweep_gblup(gm, a, yc, torch.tensor(vare), torch.tensor(var_a), None, z=z)
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(yc.numpy(), np.asarray(ryc), rtol=1e-4, atol=1e-5)


def gblup_problem():
    import jwas_tpu_torch as jt
    from jwas_tpu.io.datasets import simulate_genomic_data

    sim = simulate_genomic_data(n=300, p=300, n_qtl=15, h2=0.5, seed=21)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=4).reset_index(drop=True)
    table = jt.Table({c: (np.array([str(x) for x in pheno[c]], dtype=object)
                          if c == "ID" else np.asarray(pheno[c])) for c in pheno.columns})
    return sim, pheno, table


def run_chain(package, seed, sim, pheno, table, **extra):
    """One GBLUP runMCMC chain; returns (results, means of KEYS)."""
    opts = dict(CHAIN, seed=seed, output_folder="", printout_model_info=False)
    opts.update(extra)
    if package == "port":
        import jwas_tpu_torch as jt
        model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
            sim["genotypes"], method="GBLUP", device="cpu"))
        out = jt.runMCMC(model, table, device="cpu", **opts)
    else:
        import jwas_tpu
        model = jwas_tpu.build_model("y = intercept + geno", genotypes=jwas_tpu.get_genotypes(
            sim["genotypes"], method="GBLUP"))
        out = jwas_tpu.runMCMC(model, pheno, **opts)
    means = dict(vare=float(out["residual variance"].Estimate[0]),
                 varg=float(out["marker effects variances geno"].Estimate[0]))
    return out, means


@pytest.fixture(scope="module")
def problem():
    _jax()
    return gblup_problem()


def _ebv(out):
    return dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))


def test_gblup_chain_matches_jwas_tpu_within_mc_error(problem):
    ref, ref_m = run_chain("jwas_tpu", 7, *problem)
    out, our_m = run_chain("port", 7, *problem)
    for k in KEYS:
        assert abs(our_m[k] - ref_m[k]) < BOUNDS[k], (k, our_m, ref_m)
    ours, theirs = _ebv(out), _ebv(ref)
    ids = list(theirs)
    assert sorted(ours) == sorted(theirs) and len(ids) == 300
    assert np.corrcoef([ours[s] for s in ids], [theirs[s] for s in ids])[0, 1] >= EBV_CORR


def test_gblup_runmcmc_equals_run_st_and_writes_jwas_tpus_files(problem, tmp_path):
    """runMCMC against run_st on the workspace's eigenbasis, float32 and
    float64, bit for bit; then one chain of each package writing its files:
    the same result keys and columns, marker IDs "1".."300", and the same
    sample files, header rows and row counts."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
    from jwas_tpu_torch.ops.gblup import build_gblup_markers

    sim, pheno, table = problem
    for dp in (False, True):
        opts = dict(chain_length=48, burnin=16, seed=3, output_folder="",
                    printout_model_info=False, double_precision=dp, fast_blocks=8)

        def model():
            return jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
                sim["genotypes"], method="GBLUP", device="cpu"))

        out = jt.runMCMC(model(), table, device="cpu", **opts)
        ws = prepare_workspace(model(), table, MCMCOptions(**opts))
        gm = build_gblup_markers(ws.gblup_L, ws.gblup_D)
        res = jt.run_st(gm, ws.y, W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R,
                        df_R=ws.df_R, marker_var0=ws.marker_var0,
                        marker_scale0=ws.marker_scale0, df_marker=ws.df_marker,
                        method="GBLUP", chain_length=48, burnin=16, seed=3)
        assert res["nreps"] == 1 and res["alpha"].dtype == (np.float64 if dp else np.float32)
        assert np.array_equal(out["marker effects geno"].Estimate, res["alpha"]), dp
        assert res["alpha"].dtype.type(out["residual variance"].Estimate[0]) == res["vare"]
        assert np.array_equal(out["marker effects variances geno"].Estimate[0], res["varg"])

    folders = {}
    for package in ("port", "jwas_tpu"):
        folders[package] = str(tmp_path / package)
        out, _ = run_chain(package, 5, *problem, chain_length=40, burnin=0,
                           output_samples_frequency=10, output_folder=folders[package])
        assert list(out["marker effects geno"].Marker_ID) == [str(i + 1) for i in range(300)]
        folders[package + "_keys"] = sorted(k for k in out if not k.startswith("_"))
        folders[package + "_cols"] = {k: list(v.columns) for k, v in out.items()
                                      if not k.startswith("_")}
    assert folders["port_keys"] == folders["jwas_tpu_keys"]
    assert folders["port_cols"] == folders["jwas_tpu_cols"]
    names = sorted(os.listdir(folders["jwas_tpu"]))
    assert sorted(os.listdir(folders["port"])) == names
    for name in names:
        with open(os.path.join(folders["port"], name)) as f:
            ours = f.read().splitlines()
        with open(os.path.join(folders["jwas_tpu"], name)) as f:
            theirs = f.read().splitlines()
        assert len(ours) == len(theirs), name
        if name.startswith("MCMC_samples"):
            if not _numbers(theirs[0]):          # a header row
                assert ours[0] == theirs[0], name
            assert [r.count(",") for r in ours] == [r.count(",") for r in theirs], name


def _numbers(row):
    try:
        [float(x) for x in row.split(",") if x]
    except ValueError:
        return False
    return True


def test_gblup_rules_fire_through_runmcmc(problem):
    import jwas_tpu_torch as jt

    sim, _, table = problem
    g = jt.get_genotypes(sim["genotypes"], method="GBLUP", device="cpu")
    g.G.val = 1.0
    with pytest.raises(ValueError, match="genetic variance for GBLUP"):
        jt.runMCMC(jt.build_model("y = intercept + geno", genotypes=g), table,
                   device="cpu", chain_length=4, output_folder="")
    g = jt.get_genotypes(sim["genotypes"], method="GBLUP", device="cpu")
    with pytest.raises(ValueError, match="SSGBLUP is not available"):
        jt.runMCMC(jt.build_model("y = intercept + geno", genotypes=g), table,
                   device="cpu", chain_length=4, output_folder="",
                   single_step_analysis=True)


def calibrate(package, first, last, out):
    """Chain means and EBVs of seeds first..last of one package, written to
    out (JSON); `summarize` turns such files into BOUNDS and EBV_CORR."""
    import time
    torch.set_num_threads(1)
    problem = gblup_problem()
    rows = []
    for s in range(first, last + 1):
        t0 = time.perf_counter()
        res, means = run_chain(package, s, *problem)
        ebv = _ebv(res)
        rows.append(dict(seed=s, **means, seconds=time.perf_counter() - t0,
                         ebv=[float(ebv[k]) for k in sorted(ebv)]))
    with open(out, "w") as f:
        json.dump({"package": package, "rows": rows}, f)


def summarize(files):
    pk = {}
    for name in files:
        with open(name) as f:
            d = json.load(f)
        pk.setdefault(d["package"], []).extend(d["rows"])
    for k in KEYS:
        sds = [np.std([r[k] for r in rows], ddof=1) for rows in pk.values()]
        s = float(np.sqrt(np.mean(np.square(sds))))
        means = {p: round(float(np.mean([r[k] for r in rows])), 4) for p, rows in pk.items()}
        print(f"{k}: means {means}, sd {[round(float(x), 4) for x in sds]}, "
              f"bound {2.576 * np.sqrt(2) * s:.4g}")
    cors = [np.corrcoef(a["ebv"], b["ebv"])[0, 1] for a in pk["port"] for b in pk["jwas_tpu"]]
    print(f"EBV correlation across packages: min {min(cors):.5f}, mean {np.mean(cors):.5f}; "
          f"seconds {[round(float(np.mean([r['seconds'] for r in v])), 1) for v in pk.values()]}")


if __name__ == "__main__":
    # python tests/test_torch_gblup.py calibrate port|jwas_tpu 1 8 out.json
    # python tests/test_torch_gblup.py summarize out*.json
    if sys.argv[1] == "calibrate":
        calibrate(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        summarize(sys.argv[2:])
