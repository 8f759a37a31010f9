"""The port's diagnostics (jwas_tpu_torch/analysis/diagnostics.py) against
jwas_tpu's: PSRF and PSRF_per_parameter on the same arrays and on the
per-chain sample files of the port's multi-chain run (within 1e-12), the
sample-file reader's two header conventions, LOOCV's two branches (float64
on the CPU here, within 1e-10 relative), traceplot, and lsmeans and getEBV
on tests/test_diagnostics.py's model run through the port."""

import os

import numpy as np
import pandas as pd
import pytest

import jwas_tpu
import jwas_tpu_torch as jt
from jwas_tpu.analysis.diagnostics import _read_sample_file as jwas_read
from jwas_tpu_torch.engine.samples_io import read_sample_file
from jwas_tpu_torch.io.datasets import simulate_genomic_data

TOL = 1e-12


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Three chains of the port writing their sample files under chain_<k>/."""
    folder = str(tmp_path_factory.mktemp("mc") / "out")
    sim = simulate_genomic_data(n=150, p=40, n_qtl=6, h2=0.5, seed=31)
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", name="geno", device="cpu")
    model = jt.build_model("y = intercept + geno", genotypes=geno)
    jt.outputMCMCsamples(model, "intercept")
    out = jt.runMCMC(model, sim["phenotypes"], chain_length=160, burnin=40, seed=11,
                     n_chains=3, output_samples_frequency=4, output_folder=folder,
                     output_chain_samples=True, device="cpu", printout_model_info=False)
    return folder, out


def test_psrf_matches_jwas_tpu_on_arrays():
    rng = np.random.default_rng(0)
    for shape, shift in (((4, 4000), 0.0), ((2, 2000), 5.0), ((3, 50, 3), 0.3)):
        chains = [rng.normal(shift * k, 1.0, size=shape[1:]) for k in range(shape[0])]
        ours, ref = jt.PSRF(*chains), jwas_tpu.PSRF(*chains)
        assert abs(ours - ref) <= TOL * abs(ref)
    uneven = [rng.normal(size=100), rng.normal(size=80)]
    assert abs(jt.PSRF(*uneven) - jwas_tpu.PSRF(*uneven)) <= TOL
    with pytest.raises(ValueError):
        jt.PSRF(uneven[0])
    with pytest.raises(ValueError):
        jt.PSRF([1.0], [2.0])


@pytest.mark.parametrize("kind", ["residual_variance", "marker_effects_geno_y",
                                  "y.intercept", "pi_geno",
                                  "marker_effects_variances_geno"])
def test_psrf_per_parameter_matches_jwas_tpu_on_the_ports_files(chains, kind):
    folder, out = chains
    files = [os.path.join(f, f"MCMC_samples_{kind}.txt") for f in out["_chain_sample_folders"]]
    ours = jt.PSRF_per_parameter(*files, max_params=25)
    ref = jwas_tpu.PSRF_per_parameter(*files, max_params=25)
    assert list(ours["parameter"]) == list(ref["parameter"])
    np.testing.assert_allclose(ours["PSRF"], ref["PSRF"].to_numpy(), rtol=TOL, atol=0)
    assert len(ours) > 0
    # the whole-file PSRF, with the reader's header convention for its kind
    header = kind not in ("pi_geno", "marker_effects_variances_geno")
    assert abs(jt.PSRF(*files, header=header) - jwas_tpu.PSRF(*files, header=header)) <= (
        TOL * abs(jwas_tpu.PSRF(*files, header=header)))


def test_read_sample_file_matches_jwas_tpu(chains, tmp_path):
    """tests/test_diagnostics.py:148-166's two conventions of
    marker_effects_variances_ (headerless single-trait, a header from
    RRM), an all-numeric marker header, and every file of the port's run:
    the labels jwas_tpu reads, the values exactly as written."""
    st = tmp_path / "MCMC_samples_marker_effects_variances_geno.txt"
    st.write_text("0.5\n0.6\n0.7\n")
    labels, arr = read_sample_file(str(st))
    assert arr.shape == (3, 1) and arr[0, 0] == 0.5
    rrm = tmp_path / "MCMC_samples_marker_effects_variances_geno2.txt"
    rrm.write_text("coeff1_coeff1,coeff1_coeff2,coeff2_coeff2\n0.1,0.0,0.2\n0.3,0.1,0.4\n")
    labels, arr = read_sample_file(str(rrm))
    assert labels == ["coeff1_coeff1", "coeff1_coeff2", "coeff2_coeff2"]
    assert arr.shape == (2, 3)
    numeric = tmp_path / "MCMC_samples_marker_effects_g_y.txt"
    numeric.write_text("1,2,3\n0.5,0.0,-1.5\n")
    folder, out = chains
    paths = [str(p) for p in (st, rrm, numeric)] + [
        os.path.join(folder, f) for f in sorted(os.listdir(folder)) if f.endswith(".txt")
        and f.startswith("MCMC_samples_")]
    for path in paths:
        ours, ref = read_sample_file(path), jwas_read(path)
        assert ours[0] == ref[0], path
        # pandas' default float parser is not correctly rounded (an ulp off
        # in places); its round-trip parser is, and equals the port's
        np.testing.assert_allclose(ours[1], ref[1], rtol=1e-13, atol=0)
        exact = pd.read_csv(path, header=0 if len(ours[0]) and ours[0][0] != "0" else None,
                            float_precision="round_trip").to_numpy(dtype=np.float64)
        np.testing.assert_array_equal(ours[1], exact)


def test_loocv_matches_jwas_tpu_and_brute_force():
    """Both branches within 1e-10 of jwas_tpu's; the eMEM branch against a
    ridge refit leaving each of three observations out
    (tests/test_diagnostics.py:35-57)."""
    rng = np.random.default_rng(2)
    n, p = 40, 8
    X = rng.normal(size=(n, p))
    y = 1.0 + X @ rng.normal(size=p) + rng.normal(0, 0.5, n)
    e = jt.LOOCV(X, y, 1.0, 0.25, verbose=False, device="cpu")
    ref = jwas_tpu.LOOCV(X, y, 1.0, 0.25, verbose=False)
    np.testing.assert_allclose(e, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    Xf = np.column_stack([np.ones(n), X])
    ident = np.eye(p + 1)
    ident[0, 0] = 0.0
    for i in (0, 7, 23):
        keep = np.arange(n) != i
        bi = np.linalg.solve(Xf[keep].T @ Xf[keep] + ident * 0.25, Xf[keep].T @ y[keep])
        np.testing.assert_allclose(e[i], y[i] - Xf[i] @ bi, rtol=1e-8)

    rng = np.random.default_rng(3)
    for n, p in ((30, 100), (20, 20), (25, 10 + 25)):
        X = rng.normal(size=(n, p))
        y = X @ rng.normal(size=p) * 0.1 + rng.normal(size=n)
        e = jt.LOOCV(X, y, 1.0, 1.0, verbose=False, device="cpu")
        ref = jwas_tpu.LOOCV(X, y, 1.0, 1.0, verbose=False)
        assert e.shape == (n,) and np.isfinite(e).all()
        np.testing.assert_allclose(e, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    # a singular X X' takes the 0.01 ridge in both
    X = rng.normal(size=(12, 5)) @ rng.normal(size=(5, 30))
    y = rng.normal(size=12)
    np.testing.assert_allclose(jt.LOOCV(X, y, 1.0, 2.0, verbose=False, device="cpu"),
                               jwas_tpu.LOOCV(X, y, 1.0, 2.0, verbose=False), rtol=1e-8)


def test_loocv_prints_and_needs_a_device(capsys):
    rng = np.random.default_rng(4)
    X, y = rng.normal(size=(20, 3)), rng.normal(size=20)
    jt.LOOCV(X, y, 1.0, 1.0, device="cpu")
    printed = capsys.readouterr().out
    assert "mean square of error is" in printed and "prediction accuracy is" in printed
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jt.LOOCV(X, y, 1.0, 1.0)


def test_traceplot_writes_png(tmp_path, chains):
    """traceplot saves a PNG from an array and from a sample file; without
    matplotlib it raises ImportError naming it."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="matplotlib"):
            jt.traceplot(np.zeros((10, 2)), save_path=str(tmp_path / "t.png"))
        return
    rng = np.random.default_rng(4)
    path = str(tmp_path / "trace.png")
    fig = jt.traceplot(rng.normal(size=(200, 3)), nplots=2, save_path=path)
    assert fig is not None and os.path.getsize(path) > 0
    folder, out = chains
    path2 = str(tmp_path / "trace2.png")
    fig = jt.traceplot(os.path.join(folder, "MCMC_samples_marker_effects_geno_y.txt"),
                       nplots=3, save_path=path2)
    assert [ax.get_title(loc="left") for ax in fig.axes] == ["m1", "m2", "m3"]
    with open(path2, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_traceplot_without_matplotlib(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        jt.traceplot(np.zeros((10, 2)), save_path="")


def test_lsmeans_and_getebv(tmp_path):
    """tests/test_diagnostics.py:111-145 through the port: the male
    lsmean exceeds the female one by about the simulated 2, every level
    once; each lsmean equals the hand sum from the location-parameter
    table; getEBV returns the EBV table."""
    sim = simulate_genomic_data(n=200, p=80, n_qtl=8, h2=0.5, seed=2)
    ph = sim["phenotypes"]
    rng = np.random.default_rng(0)
    ph["sex"] = rng.choice(["m", "f"], size=len(ph))
    ph["age"] = rng.uniform(1.0, 3.0, size=len(ph))
    ph["y"] = ph["y"] + 2.0 * (ph["sex"] == "m")
    geno = jt.get_genotypes(sim["genotypes"], method="RR-BLUP", name="geno", device="cpu")
    model = jt.build_model("y = intercept + sex + age + geno", genotypes=geno)
    jt.set_covariate(model, "age")
    out = jt.runMCMC(model, ph, chain_length=300, burnin=50, seed=4,
                     output_folder=str(tmp_path / "r"), device="cpu",
                     printout_model_info=False)
    ls = jt.lsmeans(model, out)
    assert set(ls.columns) == {"Trait", "Effect", "Level", "lsmean"}
    sex = {lev: v for eff, lev, v in zip(ls["Effect"], ls["Level"], ls["lsmean"])
           if eff == "sex"}
    assert len(sex) == 2 and 1.0 < sex["m"] - sex["f"] < 3.0
    lp = out["location parameters"]
    est = {(e, lev): v for e, lev, v in zip(lp["Effect"], lp["Level"], lp["Estimate"])}
    base = est[("intercept", "intercept")] + np.mean(ph["age"]) * est[("age", "age")]
    for lev in ("m", "f"):
        assert abs(sex[lev] - (est[("sex", lev)] + base)) <= 1e-12 * max(1.0, abs(sex[lev]))
    # jwas_tpu's lsmeans on the same model terms and table gives the same
    ref = jwas_tpu.lsmeans(model, {"location parameters": lp.to_pandas()})
    np.testing.assert_allclose(ls["lsmean"], ref["lsmean"].to_numpy(), rtol=1e-12)
    assert list(ls["Level"]) == list(ref["Level"])

    assert jt.getEBV(out) is out["EBV_y"] and jt.getEBV(out, "y") is out["EBV_y"]
    with pytest.raises(KeyError):
        jt.getEBV(out, "nope")
    with pytest.raises(ValueError, match="specify the trait"):
        jt.getEBV({"EBV_a": 1, "EBV_b": 2})


def test_sample_rows_are_written_as_repr_and_read_back_exactly(tmp_path):
    """The writer's row is the reference's ",".join(repr(float(v))) for
    float32, float64 and integer values across magnitudes and the special
    values; read_sample_file gives the values back bit for bit, and
    columns= its first columns."""
    from jwas_tpu_torch.engine.samples_io import text_row

    rng = np.random.default_rng(9)
    x = np.concatenate([rng.normal(size=20_000) * 10.0 ** rng.integers(-30, 30, 20_000),
                        [0.0, -0.0, 1.0, 1e16, 1e-5, 1e-4, 0.1, np.inf, -np.inf, np.nan,
                         5e-324, 1.7976931348623157e308, 123456789012345678.0]])
    with np.errstate(over="ignore"):                 # above float32's range: inf
        x32 = x.astype(np.float32)
    for values in (x, x32, rng.integers(-5, 5, 50)):
        assert text_row(values) == ",".join(repr(float(v)) for v in values) + "\n"
    path = tmp_path / "MCMC_samples_marker_effects_g_y.txt"
    rows = rng.normal(size=(4, 30)).astype(np.float32)
    path.write_text(",".join(f"m{j}" for j in range(30)) + "\n"
                    + "".join(text_row(r) for r in rows))
    labels, got = read_sample_file(str(path))
    assert labels == [f"m{j}" for j in range(30)]
    np.testing.assert_array_equal(got, rows.astype(np.float64))
    labels, got = read_sample_file(str(path), columns=7)
    assert labels == [f"m{j}" for j in range(7)] and got.shape == (4, 7)
    np.testing.assert_array_equal(got, rows[:, :7].astype(np.float64))
    assert read_sample_file(str(path), columns=99)[1].shape == (4, 30)
