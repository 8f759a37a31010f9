"""The port's column table against pandas: read_csv's typing, to_csv's
text, as_table of a DataFrame."""

import io

import numpy as np
import pandas as pd

from jwas_tpu_torch.io.table import NA_VALUES, Table, as_table, read_csv

CSVS = {
    "typed": "ID,y,herd,age,breed\n"
             "a1,1.5,1,3,Angus\n"
             "a2,-2,2,4.25,Hereford\n"
             "a3,0.125,1,1e3,Angus\n",
    "missing": "ID,y,herd,sex,z\n"
               "1,NA,3,M,\n"
               "2,2.5,,F,\n"
               "3,nan,4,NULL,\n"
               "4,7,5,F,\n",
    "separator": "ID;y;herd\nx1;1;h1\nx2;;h2\nx3;3.5;h1\n",
    "no_header": "a,1,2\nb,3,\nc,5,6\n",
}
READ_ARGS = {"separator": dict(sep=";"), "no_header": dict(header=False)}


def _both(text, **kw):
    ours = read_csv(io.StringIO(text), **kw)
    pkw = dict(sep=kw.get("sep", ","), header=0 if kw.get("header", True) else None)
    return ours, pd.read_csv(io.StringIO(text), **pkw)


def _same_column(got, want):
    want = want.to_numpy()
    if want.dtype.kind in "iuf":
        assert got.dtype.kind == want.dtype.kind and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == object
        assert [None if x != x else x for x in got.tolist()] == [
            None if x != x else x for x in want.tolist()]


def test_read_csv_types_like_pandas():
    for name, text in CSVS.items():
        ours, theirs = _both(text, **READ_ARGS.get(name, {}))
        assert ours.columns == list(theirs.columns), name
        assert len(ours) == len(theirs), name
        for c in ours.columns:
            _same_column(ours[c], theirs[c])


def test_every_default_missing_token():
    for token in sorted(NA_VALUES):
        ours, theirs = _both(f"ID,y,f\n1,{token},a\n2,2,{token}\n")
        for c in ours.columns:
            _same_column(ours[c], theirs[c])


def test_to_csv_text_and_as_table(tmp_path):
    for name, text in CSVS.items():
        ours, theirs = _both(text, **READ_ARGS.get(name, {}))
        ours.to_csv(tmp_path / "ours.csv")
        assert (tmp_path / "ours.csv").read_text() == theirs.to_csv(index=False), name
        again = as_table(theirs)
        assert again.columns == ours.columns, name
        for c in ours.columns:
            _same_column(again[c], theirs[c])


def test_result_table_text(tmp_path):
    """float32 and float64 columns, strings with separators, NaN: the
    result tables' text is pandas'."""
    cols = {"ID": ["a", "b,c", 'say "x"'],
            "EBV": np.array([0.1, -1e-7, np.nan], dtype=np.float32),
            "PEV": np.array([1 / 3, 2.0, 1e20])}
    Table(cols).to_csv(tmp_path / "t.txt")
    assert (tmp_path / "t.txt").read_text() == pd.DataFrame(cols).to_csv(index=False)
    t = Table(cols)
    assert len(t) == 3 and t.EBV is t["EBV"]
    sub = t[np.array([True, False, True])]
    assert sub.ID.tolist() == ["a", 'say "x"'] and len(t[[1]]) == 1
    assert t.to_pandas().equals(pd.DataFrame({k: t[k] for k in cols}))
