"""The port's window GWAS (jwas_tpu_torch/analysis/gwas.py) against
jwas_tpu.GWAS on the same sample file, map and genotypes.

One chain of the port's runMCMC on tests/test_gwas.py's data and settings
(n = 500, p = 200, 4 QTL, h2 0.7, 1,000 sweeps, seed 12) writes the
marker-effect sample file; both packages read it. Tolerances: the model
frequencies equal; prGenVar within rtol 1e-4, atol 1e-6 (float32 products
summed in another order); local EBVs within atol 1e-4; the correlation's
four columns within rtol 1e-4 (atol 1e-6). WPPA equal, but in a window
where a sample's proportion lies within 1e-5 (relative) of the threshold,
where `prop > threshold` may flip: there the WPPAs may differ by 1/S for
each such sample. Rows are compared keyed by `window`: jwas_tpu sorts by
WPPA with pandas' unstable sort, so the order of ties is unspecified
there; the port sorts stably by (-WPPA, window), and the test checks that
its order never rises in WPPA and breaks ties by window.

The reference tests' own assertions (tests/test_gwas.py) are run on the
port's chain, and fault R16: jwas_tpu's GWAS(..., header=False) raises
AttributeError on a headerless map, the port reads it.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jwas_tpu
import jwas_tpu_torch as jt
from jwas_tpu.io.packed import prepare_packed_genotypes as jwas_packed
from jwas_tpu_torch.engine.samples_io import read_sample_file
from jwas_tpu_torch.io.datasets import simulate_genomic_data

RTOL, ATOL, ATOL_EBV, NEAR = 1e-4, 1e-6, 1e-4, 1e-5
THRESHOLD = 0.001


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("gwas")
    sim = simulate_genomic_data(n=500, p=200, n_qtl=4, h2=0.7, seed=55)
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", Pi=0.95, name="geno",
                            device="cpu")
    model = jt.build_model("y = intercept + geno", genotypes=geno)
    out = jt.runMCMC(model, sim["phenotypes"], chain_length=1000, burnin=200, seed=12,
                     output_folder=str(folder / "res"), output_marker_samples=True,
                     output_samples_frequency=5, device="cpu", printout_model_info=False)
    p = len(geno.marker_ids)
    map_df = pd.DataFrame({"markerID": geno.marker_ids, "chromosome": [1] * p,
                           "position": np.arange(p) * 50_000 + 1})
    map_file = str(folder / "map.csv")
    map_df.to_csv(map_file, index=False)
    X = np.column_stack([sim["genotypes"][c] for c in sim["genotypes"].columns[1:]])
    jstore = jwas_packed(sim["genotypes"].to_pandas())
    jstore.save(str(folder / "store"))
    # a second marker-effect file: the same samples, rolled by one row
    f = out["_marker_sample_file"]
    with open(f) as fh:
        lines = fh.read().splitlines()
    f2 = str(folder / "MCMC_samples_marker_effects_geno_y2.txt")
    with open(f2, "w") as fh:
        fh.write("\n".join([lines[0]] + lines[2:] + lines[1:2]) + "\n")
    return dict(sim=sim, model=model, out=out, file=f, file2=f2, map_df=map_df,
                map_file=map_file, X=X, jstore=jstore,
                store=jt.Packed2BitStore.load(str(folder / "store")), folder=folder)


def _pair(port, ref):
    """The port's and jwas_tpu's result rows, both in window order."""
    order = np.argsort(np.asarray(port["window"]))
    ref = ref.sort_values("window")
    assert list(np.asarray(port["window"])[order]) == list(ref["window"])
    return {c: np.asarray(port[c])[order] for c in port.columns}, ref


def _check_sorted(res):
    w, a = np.asarray(res["window"]), np.asarray(res["WPPA"])
    assert (np.diff(a) <= 0).all()
    ties = np.diff(a) == 0
    assert (np.diff(w)[ties] > 0).all()


def _compare(port, ref, props_port, props_ref):
    """prGenVar, WPPA by the near-threshold rule, the window columns."""
    res, ref_sorted = _pair(port, ref)
    for c in ("chr", "start", "numSNP", "start_SNP", "end_SNP"):
        assert list(res[c]) == list(ref_sorted[c]), c
    np.testing.assert_allclose(res["prGenVar"], ref_sorted["prGenVar"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(props_port, props_ref, rtol=RTOL, atol=ATOL)
    S = props_ref.shape[1]
    near = (np.abs(props_ref - THRESHOLD) <= NEAR * THRESHOLD).sum(axis=1)
    w = res["window"] - 1
    diff = np.abs(res["WPPA"] - ref_sorted["WPPA"].to_numpy())
    assert (diff <= near[w] / S + 1e-12).all(), (diff, near)
    _check_sorted(port)


@pytest.mark.parametrize("form", ["model", "numpy", "packed", "packed_genotypes"])
@pytest.mark.parametrize("sliding", [False, True], ids=["fixed", "sliding"])
def test_windows_match_jwas_tpu(run, form, sliding):
    """prGenVar, the variance proportions, WPPA and local EBVs against
    jwas_tpu's, with the genotypes as the model's dense store, a numpy
    matrix, a 2-bit store saved by jwas_tpu and loaded by the port, and
    that store as the port's Genotypes."""
    genotypes = {"model": None, "numpy": run["X"], "packed": run["store"],
                 "packed_genotypes": jt.get_genotypes(run["store"], storage="2bit")}[form]
    ref_geno = run["jstore"] if form.startswith("packed") else run["X"]
    port = jt.GWAS(run["model"], run["map_file"], run["file"], genotypes=genotypes,
                   sliding_window=sliding, output_winVarProps=True, local_EBV=True,
                   device="cpu")
    ref = jwas_tpu.GWAS(None, run["map_file"], run["file"], genotypes=ref_geno,
                        sliding_window=sliding, output_winVarProps=True, local_EBV=True)
    _compare(port[0], ref[0], port[1], ref[1])
    assert port[2].columns == list(ref[2].columns)
    for c in ref[2].columns:
        np.testing.assert_allclose(port[2][c], ref[2][c].to_numpy(), atol=ATOL_EBV)


def test_model_frequency_matches_jwas_tpu(run):
    port, ref = jt.GWAS(run["file"]), jwas_tpu.GWAS(run["file"])
    assert port.columns == ["marker_ID", "modelfrequency"]
    assert list(port["marker_ID"]) == list(ref["marker_ID"])
    np.testing.assert_array_equal(port["modelfrequency"], ref["modelfrequency"].to_numpy())


def test_genetic_correlation_matches_jwas_tpu(run):
    files = [run["file"], run["file2"]]
    port = jt.GWAS(run["model"], run["map_df"], files, genetic_correlation=True,
                   device="cpu")
    ref = jwas_tpu.GWAS(None, run["map_df"], files, genotypes=run["X"],
                        genetic_correlation=True)
    assert port.columns == list(ref.columns)
    for c in ("trait", "window", "chr", "wStart", "numSNP", "start_SNP", "end_SNP"):
        assert list(port[c]) == list(ref[c]), c
    for c in ("estimate_cov", "std_cov", "estimate_cor", "std_cor"):
        np.testing.assert_allclose(port[c], ref[c].to_numpy(), rtol=RTOL, atol=ATOL)


def test_reference_assertions_on_the_ports_chain(run):
    """tests/test_gwas.py's assertions (model frequency, QTL windows ranked
    top, numSNP, WPPA in [0, 1], sliding windows, local-EBV accuracy, the
    correlation pair check) on the port's chain."""
    sim, model, f, map_df = run["sim"], run["model"], run["file"], run["map_df"]
    mf = jt.GWAS(f)
    assert ((mf["modelfrequency"] >= 0) & (mf["modelfrequency"] <= 1)).all()
    qtl_names = {f"m{q + 1}" for q in sim["qtl"]}
    is_qtl = np.array([m in qtl_names for m in mf["marker_ID"]])
    assert mf["modelfrequency"][is_qtl].mean() > mf["modelfrequency"].mean()

    res = jt.GWAS(model, map_df, f, window_size="1 Mb", device="cpu")
    assert res["numSNP"].sum() == 200
    qtl_windows = set(sim["qtl"] // 20 + 1)
    top = set(res["window"][:len(qtl_windows)].tolist())
    assert len(top & qtl_windows) >= max(1, len(qtl_windows) - 1), (qtl_windows, top)
    assert ((res["WPPA"] <= 1) & (res["WPPA"] >= 0)).all()

    res, props = jt.GWAS(model, map_df, f, sliding_window=True, output_winVarProps=True,
                         device="cpu")
    assert len(res) == 200 and props.shape[0] == 200

    res, lebv = jt.GWAS(model, map_df, f, local_EBV=True, device="cpu")
    total = np.column_stack([lebv[c] for c in lebv.columns]).sum(axis=1)
    assert total.shape == (500,) and len(lebv.columns) == 10
    assert np.corrcoef(total, sim["true_bv"])[0, 1] > 0.6

    res = jt.GWAS(model, map_df, [f, f], genetic_correlation=True, device="cpu")
    qtl_rows = np.isin(res["window"], sorted(qtl_windows))
    cov, cor = res["estimate_cov"][qtl_rows], res["estimate_cor"][qtl_rows]
    assert (cor[np.argsort(-cov, kind="stable")[:3]] > 0.9).all()
    with pytest.raises(ValueError, match="pair"):
        jt.GWAS(model, map_df, f, genetic_correlation=True, device="cpu")


def test_local_ebvs_sum_to_x_alpha(run):
    """Over fixed windows that cover every marker, the local EBVs sum to X
    times the samples' mean effects."""
    res, lebv = jt.GWAS(run["model"], run["map_df"], run["file"], local_EBV=True,
                        device="cpu")
    _, samples = read_sample_file(run["file"])
    X = run["X"] - run["X"].mean(axis=0)
    total = np.column_stack([lebv[c] for c in lebv.columns]).sum(axis=1)
    np.testing.assert_allclose(total, X @ samples.mean(axis=0), rtol=1e-4, atol=1e-4)


def test_headerless_map_fault_r16(run, tmp_path):
    """R16: jwas_tpu's GWAS(..., header=False) reads the map's columns as 0,
    1, 2 and fails lower-casing them; the port reads the first three
    columns as ID, chromosome and position with or without a header."""
    path = str(tmp_path / "map_noheader.csv")
    run["map_df"].to_csv(path, index=False, header=False)
    with pytest.raises(AttributeError):
        jwas_tpu.GWAS(None, path, run["file"], genotypes=run["X"], header=False)
    port = jt.GWAS(run["model"], path, run["file"], header=False, device="cpu")
    with_header = jt.GWAS(run["model"], run["map_file"], run["file"], device="cpu")
    for c in port.columns:
        assert list(port[c]) == list(with_header[c]), c


def test_errors_and_the_default_device(run):
    with pytest.raises(ValueError, match="marker_effects_file"):
        jt.GWAS(run["model"], run["map_df"])
    with pytest.raises(ValueError, match="genotypes are required"):
        jt.GWAS(None, run["map_df"], run["file"], device="cpu")
    with pytest.raises(ValueError, match="must match"):
        jt.GWAS(None, run["map_df"], run["file"], genotypes=run["X"][:, :50],
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jt.GWAS(run["model"], run["map_df"], run["file"])


def test_packed_columns_decode_in_chunks_without_a_dense_matrix(run, monkeypatch):
    """A 2-bit store's X A is taken a chunk of columns at a time: with the
    chunk cut to 7 markers no decoded tile is wider, and the product
    equals the centred matrix's (missing codes none here)."""
    from jwas_tpu_torch.analysis import gwas

    cols = gwas.genotype_columns(run["store"], None, torch.device("cpu"))
    assert cols.chunk == gwas._DECODE_BYTES // (4 * 500)
    cols.chunk = 7
    widths = []
    rows = gwas.PackedColumns.rows

    def spy(self, idx):
        widths.append(idx.numel())
        return rows(self, idx)

    monkeypatch.setattr(gwas.PackedColumns, "rows", spy)
    A = np.random.default_rng(3).normal(size=(200, 5)).astype(np.float32)
    got = cols.matmul(torch.as_tensor(A)).numpy()
    X = run["X"] - run["X"].mean(axis=0)
    np.testing.assert_allclose(got, X @ A, rtol=1e-4, atol=1e-4)
    assert max(widths) == 7 and sum(widths) == 200
