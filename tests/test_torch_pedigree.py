"""The port's pedigree module (jwas_tpu_torch/io/pedigree.py and its host
C++, csrc/pedigree.cpp) against jwas_tpu's, on the CPU.

(1) Coding: every parent precedes its offspring, and parents that appear
    only in the parent columns become founders, with jwas_tpu's IDs, codes
    and parents.
(2) Inbreeding on Mrode's example (2nd ed., example 2.1) and on a random,
    deep 300-animal pedigree: the C++ code and the plain Python copy
    against jwas_tpu's, to 1e-12 (the same sums in the same order:
    floating-point equal up to the last bits); inbreeding_tolerance = 1e-8
    within 1e-6 of the exact values and equal to jwas_tpu's truncated walk;
    a deep generational pedigree (parents from the two generations before)
    bit for bit the Python walk.
(3) A^-1 against jwas_tpu's a_inverse() to 1e-12; A^-1 A = I to 1e-8; its
    factor F with F'F = A^-1.
(4) A CSV (with and without a header, other missing strings), a Table, an
    (n, 3) array of strings and a DataFrame give jwas_tpu.get_pedigree's
    pedigree from the same rows.
(5) The C++ library is built into the package's _build/ directory under a
    name with a hash of its source, never into the temporary directory
    (fault R5); get_info prints jwas_tpu's summary.
(6) A pedigree of two columns is refused by both packages (jwas_tpu with
    pandas' IndexError, the port with a ValueError).
"""

import os

import numpy as np
import pandas as pd
import pytest

import jwas_tpu
import jwas_tpu_torch as jt
from jwas_tpu_torch.io import pedigree as tped


def _mrode():
    # Mrode (2nd ed.), example 2.1: 6 animals, 1 and 2 only as parents
    # among the first four rows
    return pd.DataFrame({"id": ["3", "4", "5", "6", "1", "2"],
                         "sire": ["1", "1", "4", "5", "0", "0"],
                         "dam": ["2", "0", "3", "2", "0", "0"]})


def _random(n=300, seed=11, founders=4):
    """A deep random pedigree with inbreeding: each animal's parents drawn
    from all earlier animals."""
    rng = np.random.default_rng(seed)
    ids = [f"z{i}" for i in range(n)]
    sire = ["0" if i < founders else ids[int(rng.integers(0, i))] for i in range(n)]
    dam = ["0" if i < founders else ids[int(rng.integers(0, i))] for i in range(n)]
    return pd.DataFrame({"ID": ids, "S": sire, "D": dam})


def _table(df):
    return jt.Table({c: np.array(df[c].tolist(), dtype=object) for c in df.columns})


def _same(ped, ref):
    assert ped.ids == ref.ids
    np.testing.assert_array_equal(ped.sire, ref.sire)
    np.testing.assert_array_equal(ped.dam, ref.dam)


def test_topological_order_and_founders_from_parent_columns():
    for df in (_mrode().iloc[:4], _mrode(), _random()):
        ped, ref = jt.get_pedigree(_table(df)), jwas_tpu.get_pedigree(df)
        _same(ped, ref)
        for i, (s, d) in enumerate(zip(ped.sire, ped.dam)):
            assert s < i and d < i
    ped = jt.get_pedigree(_table(_mrode().iloc[:4]))
    assert set(ped.ids) == {"1", "2", "3", "4", "5", "6"} and len(ped) == 6
    for founder in ("1", "2"):
        i = ped.id_index[founder]
        assert ped.sire[i] == ped.dam[i] == -1


def test_inbreeding_matches_jwas_tpu():
    for df in (_mrode(), _random()):
        ref = jwas_tpu.get_pedigree(df)
        ped = jt.get_pedigree(_table(df))
        _same(ped, ref)
        np.testing.assert_allclose(ped.inbreeding, ref.inbreeding, rtol=0, atol=1e-12)
        F_py = tped._inbreeding_meuwissen_luo_py(ped.sire, ped.dam)
        np.testing.assert_allclose(F_py, ref.inbreeding, rtol=0, atol=1e-12)
    f = dict(zip(ped.ids, ped.inbreeding))
    assert f["z0"] == 0.0 and max(f.values()) > 0.05
    mrode = jt.get_pedigree(_table(_mrode()))
    F = dict(zip(mrode.ids, mrode.inbreeding))
    assert [F[s] for s in "123456"] == pytest.approx([0, 0, 0, 0, 0.125, 0.125])

    # inbreeding_tolerance: a truncated walk, near the exact one and equal
    # to jwas_tpu's truncated walk
    df = _random(n=1_500, seed=2, founders=30)
    exact = jt.get_pedigree(_table(df))
    trunc = jt.get_pedigree(_table(df), inbreeding_tolerance=1e-8)
    np.testing.assert_allclose(trunc.inbreeding, exact.inbreeding, atol=1e-6)
    ref = jwas_tpu.get_pedigree(df, inbreeding_tolerance=1e-8)
    np.testing.assert_allclose(trunc.inbreeding, ref.inbreeding, rtol=0, atol=1e-12)
    assert exact.inbreeding.max() > 0.05


def test_inbreeding_of_a_deep_generational_pedigree():
    """A generational pedigree whose parents come from the two generations
    before (tests/integration/test_ssbr_scale.py:41-52's design, 3,000
    animals, 100 a generation; a parent may be the animal just before):
    the C++ code, which walks levels of independent animals in parallel
    and scans the codes below once an ancestor set grows dense, equals the
    plain Python walk bit for bit and jwas_tpu's to 1e-12, exact and with
    inbreeding_tolerance = 1e-8."""
    rng = np.random.default_rng(31)
    n, gen = 3_000, 100
    ids = np.array([f"a{k}" for k in range(n)])
    lo, hi = np.maximum(np.arange(n) - 2 * gen, 0), np.maximum(np.arange(n) - 1, 1)
    anc = np.stack([rng.integers(lo, hi), rng.integers(lo, hi)])
    sire = np.where(np.arange(n) < gen, "0", ids[anc[0]])
    dam = np.where(np.arange(n) < gen, "0", ids[anc[1]])
    df = pd.DataFrame({"ID": ids, "Sire": sire, "Dam": dam})
    ped = jt.get_pedigree(_table(df))
    assert np.array_equal(ped.inbreeding, tped._inbreeding_meuwissen_luo_py(ped.sire, ped.dam))
    np.testing.assert_allclose(ped.inbreeding, jwas_tpu.get_pedigree(df).inbreeding,
                               rtol=0, atol=1e-12)
    trunc = jt.get_pedigree(_table(df), inbreeding_tolerance=1e-8)
    np.testing.assert_allclose(trunc.inbreeding, jwas_tpu.get_pedigree(
        df, inbreeding_tolerance=1e-8).inbreeding, rtol=0, atol=1e-12)
    assert ped.inbreeding.mean() > 0.0


def test_a_inverse_matches_jwas_tpu_and_inverts_a():
    for df in (_mrode(), _random()):
        ped, ref = jt.get_pedigree(_table(df)), jwas_tpu.get_pedigree(df)
        Ai = ped.a_inverse()
        np.testing.assert_allclose(Ai.toarray(), ref.a_inverse().toarray(),
                                   rtol=0, atol=1e-12)
        A = ped.a_matrix()
        np.testing.assert_allclose(A, ref.a_matrix(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(Ai.toarray() @ A, np.eye(len(ped)), atol=1e-8)
        F = ped.a_inverse_factor()
        np.testing.assert_allclose((F.T @ F).toarray(), Ai.toarray(), atol=1e-12)


def test_inputs_match_jwas_tpu(tmp_path):
    """The same rows as a CSV (header or not, other missing strings), a
    Table, an array of strings and a DataFrame."""
    df = _random(n=120, seed=5)
    df.loc[7, "S"] = "unknown"
    df.loc[11, "S"] = " NA"                     # pandas reads it as an ID
    ref = jwas_tpu.get_pedigree(df, missingstring=("0", "unknown"))
    for src in (_table(df), df.to_numpy(dtype=str), df):
        _same(jt.get_pedigree(src, missingstring=("0", "unknown")), ref)
    for header in (True, False):
        path = tmp_path / f"ped_{header}.csv"
        df.to_csv(path, index=False, header=header)
        want = jwas_tpu.get_pedigree(str(path), header=header,
                                     missingstring=("0", "unknown"))
        got = jt.get_pedigree(str(path), header=header, missingstring=("0", "unknown"))
        _same(got, want)
        np.testing.assert_allclose(got.inbreeding, want.inbreeding, rtol=0, atol=1e-12)
    path = tmp_path / "ped.txt"
    df.to_csv(path, index=False, header=False, sep=" ")
    _same(jt.get_pedigree(str(path), separator=" ", missingstring=("0", "unknown")),
          jwas_tpu.get_pedigree(str(path), separator=" ", missingstring=("0", "unknown")))


def test_host_library_builds_in_the_package(capsys):
    from jwas_tpu_torch import _build

    lib = _build.host_library()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(_build._BUILD)
    assert os.path.basename(path).startswith("libjwas_tpu_torch_host-")
    assert len(os.path.basename(path).split("-")[1].split(".")[0]) == 16
    df = _mrode()
    ped, ref = jt.get_pedigree(_table(df)), jwas_tpu.get_pedigree(df)
    capsys.readouterr()
    jwas_tpu.get_info(ref)
    want = capsys.readouterr().out
    assert jt.get_info(ped) is None
    assert capsys.readouterr().out == want
    ids, Ai, F = jt.get_info(ped, Ai=True)
    assert ids == ped.ids and Ai.shape == (6, 6) and F is ped.inbreeding


def test_two_columns_are_refused(tmp_path):
    df = _random(n=20)[["ID", "S"]]
    path = tmp_path / "ped2.csv"
    df.to_csv(path, index=False, header=False)
    with pytest.raises(IndexError):
        jwas_tpu.get_pedigree(df)
    for src in (str(path), _table(df), df.to_numpy(dtype=str)):
        with pytest.raises(ValueError, match="three columns"):
            jt.get_pedigree(src)
