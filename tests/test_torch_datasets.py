"""The port's packaged datasets and simulators (jwas_tpu_torch/io/datasets.py)
against jwas_tpu/io/datasets.py: every table of the three datasets and the
simulators' outputs equal value for value, in memory and as CSV files;
tests/test_datasets.py's assertions and its JWAS_REFERENCE_DATA hook on
the port; fault R17: a file planted at jwas_tpu's shared path is what
jwas_tpu returns, never what the port returns."""

import os
import tempfile

import numpy as np
import pandas as pd
import pytest

import jwas_tpu.io.datasets as ref
import jwas_tpu_torch.io.datasets as port
from jwas_tpu_torch import dataset


def _equal(table, df, label):
    """A Table equals a DataFrame: the same columns in order, each with the
    same values (float columns bit for bit, of the same dtype)."""
    assert list(table.columns) == list(df.columns), label
    for c in df.columns:
        a, b = np.asarray(table[c]), df[c].to_numpy()
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            assert a.dtype == b.dtype, (label, c)
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {c}")
        else:
            assert a.tolist() == b.tolist(), (label, c)


@pytest.mark.parametrize("name", ["demo_7animals", "simulated_omics",
                                  "simulated_annotations"])
def test_dataset_tables_equal_jwas_tpu(name):
    tables = port.dataset_tables(name)
    ref_tables = ref.__dict__["_" + name]()
    assert sorted(tables) == sorted(ref_tables)
    for k, df in ref_tables.items():
        _equal(tables[k], df, (name, k))
        ours = pd.read_csv(dataset(k, dataset_name=name))
        pd.testing.assert_frame_equal(ours, pd.read_csv(ref.dataset(k, dataset_name=name)))


@pytest.mark.parametrize("fn, kwargs", [
    ("simulate_genomic_data", dict(n=300, p=120, n_qtl=12, h2=0.5, seed=61)),
    ("simulate_genomic_data", dict(n=500, p=200, n_qtl=4, h2=0.7, seed=55)),
    ("simulate_genomic_data", dict(n=60, p=30, n_qtl=5, h2=0.0, seed=1, maf_low=0.2)),
    ("simulate_genomic_data_mt", dict(n=300, p=128, n_qtl=15, h2=(0.5, 0.4), rg=0.6,
                                      re=0.2, seed=4)),
    ("simulate_genomic_data_mt", dict(n=80, p=40, n_qtl=6, seed=9, missing_frac=0.2,
                                      n_traits=3)),
    ("simulate_pedigree_genomic_data", dict()),
    ("simulate_pedigree_genomic_data", dict(n_founders=40, n_gen=2, n_per_gen=50, p=60,
                                            seed=3)),
])
def test_simulators_equal_jwas_tpu(fn, kwargs):
    ours, theirs = getattr(port, fn)(**kwargs), getattr(ref, fn)(**kwargs)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        if isinstance(v, pd.DataFrame):
            _equal(ours[k], v, k)
        else:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="n_traits"):
        port.simulate_genomic_data_mt(n_traits=1)


def test_simulated_annotations_tables():
    """tests/test_datasets.py:10-33 on the port's files."""
    geno = pd.read_csv(dataset("genotypes", dataset_name="simulated_annotations"))
    anno = pd.read_csv(dataset("annotations.csv", dataset_name="simulated_annotations"))
    truth = pd.read_csv(dataset("truth", dataset_name="simulated_annotations"))
    ph = pd.read_csv(dataset("phenotypes", dataset_name="simulated_annotations"))
    assert geno.shape == (400, 965)
    assert list(anno.columns) == ["marker_id", "functional", "random_anno"]
    assert truth.is_causal.sum() == 10
    m = truth.merge(anno, on="marker_id")
    assert m[m.is_causal].functional.mean() > m.functional.mean()
    assert len(ph) == 400
    tmt = pd.read_csv(dataset("truth_mt", dataset_name="simulated_annotations"),
                      dtype={"state": str})
    assert set(tmt.state) <= {"00", "01", "10", "11"}
    assert (tmt.state != "00").sum() > 10
    pmt = pd.read_csv(dataset("phenotypes_mt", dataset_name="simulated_annotations"))
    assert list(pmt.columns) == ["ID", "y1", "y2"]


def test_simulated_omics_consistency():
    """tests/test_datasets.py:36-50 on the port's files."""
    ph = pd.read_csv(dataset("phenotypes", dataset_name="simulated_omics"))
    ped = pd.read_csv(dataset("pedigree", dataset_name="simulated_omics"))
    geno = pd.read_csv(dataset("genotypes_1000snps", dataset_name="simulated_omics"))
    assert len(ped) == 6473 and len(ph) == 3534
    assert geno.shape == (3534, 1001)
    assert set(ph.ID.astype(str)) <= set(ped.ID.astype(str))
    np.testing.assert_allclose(ph.genetic_total, ph.genetic_direct + ph.genetic_indirect,
                               atol=1e-9)
    r = ph.genetic_direct.var() / ph.genetic_total.var()
    assert 0.1 < r < 0.35


def test_unknown_dataset_errors():
    with pytest.raises(ValueError, match="unknown dataset"):
        dataset("phenotypes", dataset_name="nope")
    with pytest.raises(ValueError, match="unknown table"):
        dataset("nope", dataset_name="demo_7animals")


def test_dataset_reference_data_hook(tmp_path, monkeypatch):
    """JWAS_REFERENCE_DATA (tests/test_datasets.py:53-73): a file in the
    checkout's data directory is returned as it is; a table it lacks falls
    back to the port's generated file."""
    data = tmp_path / "data" / "demo_7animals"
    data.mkdir(parents=True)
    (data / "phenotypes.txt").write_text("ID,y\na1,1.0\n")
    monkeypatch.setenv("JWAS_REFERENCE_DATA", str(tmp_path / "data"))
    p = dataset("phenotypes")
    assert p == str(data / "phenotypes.txt")
    assert open(p).read() == "ID,y\na1,1.0\n"
    p2 = dataset("genotypes")
    assert os.path.isfile(p2) and p2.startswith(port._private_dir())
    assert pd.read_csv(p2).shape == (7, 6)


def test_planted_file_is_not_returned_fault_r17(tmp_path, monkeypatch):
    """R17: jwas_tpu returns whatever file sits at <tmp>/jwas_tpu_<dataset>/
    <table>.csv; the port writes its own file into a directory private to
    the process, under a temporary name and then renamed, and returns it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    shared = tmp_path / "jwas_tpu_demo_7animals"
    shared.mkdir()
    (shared / "pedigree.csv").write_text("ID,Sire,Dam\nplanted,0,0\n")
    assert open(ref.dataset("pedigree")).read() == "ID,Sire,Dam\nplanted,0,0\n"
    monkeypatch.setattr(port, "_DIR", {})
    monkeypatch.setattr(port, "_WRITTEN", {})
    path = dataset("pedigree")
    assert os.path.dirname(os.path.dirname(path)) == port._DIR["root"]
    assert os.path.basename(port._DIR["root"]).startswith("jwas_tpu_torch_data_")
    assert "planted" not in open(path).read()
    assert pd.read_csv(path).ID.tolist() == ["S1", "D1", "O1", "O2", "O3", "D2", "O4"]
    # a file planted at the port's own path after it wrote it is not taken
    # for a table it has not written
    planted = os.path.join(port._DIR["root"], "demo_7animals", "phenotypes.csv")
    with open(planted, "w") as f:
        f.write("ID,y\nplanted,1\n")
    path = dataset("phenotypes")
    assert path == planted and "planted" not in open(path).read()
    assert not [f for f in os.listdir(os.path.dirname(path)) if f.endswith(".tmp")]
