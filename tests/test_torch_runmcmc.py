"""runMCMC(model, df) of the port: against its own run_st, and against
jwas_tpu.runMCMC.

Data: tests/test_torch_slice.py's (n = 400, p = 2,000, 20 QTL, h2 = 0.5,
phenotype rows shuffled, fast_blocks = 8), with a herd factor (numpy seed
3) and, where said, 50 phenotypes removed so those IDs are output only.

(a) runMCMC(device="cpu") equals run_st fed the same workspace's priors, W
    and row order bit for bit: one chain loop, one initial state.
(b) One chain of 2,000 sweeps of each package: vare, varg and pi agree
    within test_torch_slice.py's BOUNDS and the EBVs of all 400 IDs
    correlate >= 0.95. The EBVs of the 50 output-only IDs (the port: K5's
    plain version over the store's rows) equal the reference's dense decode
    of those rows times the port's effects, and correlate >= 0.85 with
    jwas_tpu's (two jwas_tpu chains: 0.930).
(c) One short run of each package into an output folder: the same result
    keys, columns and row labels, the same files with the same headers and
    line counts, every value finite.
"""

import os

import jax
import numpy as np
import pytest

import jwas_tpu
from jwas_tpu.io.datasets import simulate_genomic_data
import jwas_tpu_torch as jt
from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
from test_torch_slice import BOUNDS

QUIET = dict(printout_model_info=False, fast_blocks=8)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    jax.config.update("jax_enable_x64", False)
    sim = simulate_genomic_data(n=400, p=2000, n_qtl=20, h2=0.5, seed=11)
    folder = tmp_path_factory.mktemp("runmcmc")
    path = str(folder / "geno")
    jwas_tpu.prepare_packed_genotypes(sim["genotypes"], save_path=path)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=1).reset_index(drop=True)
    rng = np.random.default_rng(3)
    pheno["herd"] = rng.integers(1, 9, len(pheno))
    dropped = pheno.copy()
    held_out = rng.choice(len(pheno), 50, replace=False)
    dropped.loc[held_out, "y"] = np.nan
    csv = str(folder / "pheno.csv")
    dropped.to_csv(csv, index=False)
    return dict(path=path, pheno=pheno, dropped=dropped, table=jt.read_csv(csv),
                held_out=[str(s) for s in dropped.ID[held_out]], folder=folder)


def _port_model(problem, eq="y = intercept + geno", **geno):
    store = jt.Packed2BitStore.load(problem["path"])
    return jt.build_model(eq, genotypes=jt.get_genotypes(store, **geno))


def _ref_model(problem, eq="y = intercept + geno", **geno):
    store = jwas_tpu.Packed2BitStore.load(problem["path"])
    return jwas_tpu.build_model(eq, genotypes=jwas_tpu.get_genotypes(store, **geno))


@pytest.mark.parametrize("method", ["BayesC", "BayesR"])
def test_runmcmc_equals_run_st(problem, method):
    geno = dict(method=method, estimate_scale=method == "BayesC")
    eq = "y = intercept + herd + geno"
    opts = dict(QUIET, chain_length=64, burnin=16, seed=7, output_folder="")
    out = jt.runMCMC(_port_model(problem, eq, **geno), problem["table"],
                     device="cpu", **opts)
    ws = prepare_workspace(_port_model(problem, eq, **geno), problem["table"],
                           MCMCOptions(**opts))
    gm = jt.setup_markers(ws.geno.packed_store, ws.obs_ids, "cpu", fast_blocks=8)
    res = jt.run_st(gm, ws.y, W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R,
                    df_R=ws.df_R, marker_var0=ws.marker_var0,
                    marker_scale0=ws.marker_scale0, df_marker=ws.df_marker,
                    pi0=ws.pi0, method=method, chain_length=64, burnin=16, seed=7,
                    estimate_scale=geno["estimate_scale"])
    f32 = np.float32
    assert np.array_equal(f32(out["location parameters"].Estimate), res["sol"])
    markers = out["marker effects geno"]
    assert np.array_equal(markers.Estimate, res["alpha"])
    assert np.array_equal(markers.Model_Frequency, res["model_frequency"])
    assert f32(out["residual variance"].Estimate[0]) == res["vare"]
    assert f32(out["marker effects variances geno"].Estimate[0]) == res["varg"]
    assert np.array_equal(f32(out["pi_geno"].Estimate), np.atleast_1d(f32(res["pi"])))
    if method == "BayesC":
        assert f32(out["ScaleEffectVargeno"].Estimate[0]) == res["scale"]
    ebv = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    assert len(ebv) == 400 and ws.n_obs == 350
    assert np.array_equal(np.array([ebv[s] for s in ws.obs_ids]), res["ebv"])


def test_runmcmc_matches_jwas_tpu_within_mc_error(problem):
    opts = dict(QUIET, chain_length=2000, burnin=400, seed=7, output_folder="")
    ref = jwas_tpu.runMCMC(_ref_model(problem), problem["dropped"], **opts)
    out = jt.runMCMC(_port_model(problem), problem["table"], device="cpu", **opts)
    for key, k in (("residual variance", "vare"),
                   ("marker effects variances geno", "varg"), ("pi_geno", "pi")):
        got, want = out[key].Estimate[0], ref[key].Estimate[0]
        assert abs(got - want) < BOUNDS[k], (k, got, want)
    ours = dict(zip(out["EBV_y"].ID, out["EBV_y"].EBV))
    theirs = dict(zip(ref["EBV_y"].ID, ref["EBV_y"].EBV))
    assert sorted(ours) == sorted(theirs) and len(ours) == 400
    ids = list(theirs)
    assert np.corrcoef([ours[s] for s in ids], [theirs[s] for s in ids])[0, 1] >= 0.95
    # the output-only IDs: the port's K5 rows of the store against the
    # reference's dense decode times the port's own posterior mean effects
    held = problem["held_out"]
    store = jwas_tpu.Packed2BitStore.load(problem["path"])
    row = {s: i for i, s in enumerate(store.obs_ids)}
    x = store.decode(np.arange(store.n_markers))[[row[s] for s in held]]
    alpha = out["marker effects geno"].Estimate
    np.testing.assert_allclose([ours[s] for s in held], x @ alpha, rtol=1e-4, atol=1e-5)
    # between packages the output-only EBVs differ by Monte-Carlo error:
    # two jwas_tpu chains (seeds 7, 8) correlate 0.930 on these IDs
    r = np.corrcoef([ours[s] for s in held], [theirs[s] for s in held])[0, 1]
    assert r >= 0.85, r


def _read_lines(folder):
    return {name: open(os.path.join(folder, name)).read().splitlines()
            for name in os.listdir(folder)}


def _numbers(line):
    """The fields of a line as floats, or None if one is not a number."""
    try:
        return [float(f) for f in line.split(",") if f]
    except ValueError:
        return None


def test_result_tables_and_files_match_jwas_tpu(problem):
    eq = "y = intercept + herd + geno"
    folders = [str(problem["folder"] / d) for d in ("ref_out", "port_out")]
    opts = dict(QUIET, chain_length=48, burnin=16, seed=2, output_samples_frequency=8)
    ref_model = _ref_model(problem, eq, estimate_scale=True)
    jwas_tpu.outputMCMCsamples(ref_model, "herd")
    ref = jwas_tpu.runMCMC(ref_model, problem["dropped"], output_folder=folders[0], **opts)
    model = _port_model(problem, eq, estimate_scale=True)
    jt.models.model.outputMCMCsamples(model, "herd")
    out = jt.runMCMC(model, problem["table"], device="cpu", output_folder=folders[1],
                     **opts)
    assert sorted(out) == sorted(ref)
    for key, table in ref.items():
        if isinstance(table, str):
            assert os.path.basename(out[key]) == os.path.basename(table)
            continue
        ours = out[key]
        assert ours.columns == list(table.columns), key
        assert len(ours) == len(table), key
        for c in table.columns:
            if table[c].dtype.kind in "fiu":
                assert np.isfinite(np.asarray(ours[c], dtype=float)).all(), (key, c)
            else:
                assert [str(x) for x in ours[c]] == [str(x) for x in table[c]], (key, c)
    ref_files, our_files = _read_lines(folders[0]), _read_lines(folders[1])
    assert sorted(our_files) == sorted(ref_files)
    for name, lines in ref_files.items():
        ours = our_files[name]
        assert len(ours) == len(lines), name
        if _numbers(lines[0]) is None:                # a header line
            assert ours[0] == lines[0], name
        for line in ours:
            values = _numbers(line)
            if values is not None:
                assert np.isfinite(values).all(), name
