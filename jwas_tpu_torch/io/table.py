"""A column table in place of pandas at the edges: phenotype input, result
tables, their CSV files.

Counterpart of the pandas DataFrames that jwas_tpu's model layer reads and
writes (jwas_tpu/engine/setup.py:348, jwas_tpu/engine/output.py:37). A Table
is an ordered mapping from column name to a 1-D numpy array; t["col"],
t.col, len(t), t.columns and row selection t[mask or indices] work as on a
DataFrame. read_csv types columns as pandas.read_csv does in the cases the
model layer relies on: all-integer columns are int64, numeric columns with
missing values float64 (so a factor level reads "1.0", as under pandas),
anything else strings with NaN where a value is missing; the missing tokens
are pandas' default na_values.
"""

from __future__ import annotations

import csv
import re
from typing import Iterator, List, Mapping

import numpy as np

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
])
_INT = re.compile(r"[+-]?\d+$")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$|[+-]?(inf|infinity)$",
                    re.IGNORECASE)


class Table:
    """Ordered columns of equal length, each a 1-D numpy array."""

    def __init__(self, columns: Mapping = None):
        self._cols = {}
        for name, values in (columns or {}).items():
            self[name] = values

    @property
    def columns(self) -> List:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, key):
        if isinstance(key, str) or np.isscalar(key):
            return self._cols[key]
        return self.take(key)

    def __setitem__(self, name, values) -> None:
        arr = np.asarray(values)
        if arr.dtype.kind == "U":
            arr = arr.astype(object)
        if arr.ndim == 0:
            arr = np.full(len(self), arr.item(), dtype=arr.dtype)
        if arr.ndim != 1:
            raise ValueError(f"column {name!r} must be 1-D")
        if self._cols and len(arr) != len(self):
            raise ValueError(f"column {name!r} has {len(arr)} rows, the table {len(self)}")
        self._cols[name] = arr

    def __getattr__(self, name):
        cols = self.__dict__.get("_cols", {})
        if name in cols:
            return cols[name]
        raise AttributeError(name)

    def __repr__(self) -> str:
        return f"Table({len(self)} rows; columns {self.columns})"

    def take(self, rows) -> "Table":
        """The rows at rows: a boolean mask, integer indices or a slice."""
        rows = rows if isinstance(rows, slice) else np.asarray(rows)
        out = Table()
        out._cols = {c: v[rows] for c, v in self._cols.items()}
        return out

    def to_csv(self, path) -> None:
        """Write the table as DataFrame.to_csv(path, index=False) does:
        floats in their shortest round-trip form, missing values empty."""
        cols = [_csv_strings(v) for v in self._cols.values()]
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([str(c) for c in self._cols])
            w.writerows(zip(*cols))

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(dict(self._cols))


def _csv_strings(v: np.ndarray) -> List[str]:
    if v.dtype.kind == "f":
        s = v.astype(str)
        s[np.isnan(v)] = ""
        return s.tolist()
    return ["" if is_missing_value(x) else str(x) for x in v.tolist()]


def is_missing_value(x) -> bool:
    return x is None or (isinstance(x, float) and x != x)


def parse_column(tokens: List[str]) -> np.ndarray:
    """One column of tokens: int64, float64 or strings, as pandas types it."""
    missing = [t in NA_VALUES for t in tokens]
    present = [t.strip() for t, m in zip(tokens, missing) if not m]
    if all(_INT.match(t) for t in present) and present and not any(missing):
        return np.array([int(t) for t in present], dtype=np.int64)
    if all(_FLOAT.match(t) for t in present):
        return np.array([np.nan if m else float(t.strip())
                         for t, m in zip(tokens, missing)], dtype=np.float64)
    return np.array([np.nan if m else t for t, m in zip(tokens, missing)],
                    dtype=object)


def read_csv_rows(path, sep: str = ",") -> Iterator[List[str]]:
    """The rows of a delimited text file as lists of strings; blank lines
    are skipped, as pandas skips them."""
    if hasattr(path, "read"):
        yield from (r for r in csv.reader(path, delimiter=sep) if r)
        return
    with open(path, newline="") as f:
        yield from (r for r in csv.reader(f, delimiter=sep) if r)


def read_csv(path, sep: str = ",", header: bool = True) -> Table:
    """Read a delimited text file into a Table (pandas.read_csv's typing,
    see the module docstring). header=False names the columns 0, 1, ..."""
    rows = list(read_csv_rows(path, sep))
    names = rows.pop(0) if header and rows else None
    width = len(names) if names is not None else (len(rows[0]) if rows else 0)
    if names is None:
        names = list(range(width))
    out = Table()
    for j, name in enumerate(names):
        out[name] = parse_column([r[j] if j < len(r) else "" for r in rows])
    return out


def as_table(obj) -> Table:
    """A Table from a Table, a {name: array} mapping, or any object with
    .columns whose obj[c].to_numpy() gives a column (a pandas DataFrame,
    without importing pandas)."""
    if isinstance(obj, Table):
        return obj
    if isinstance(obj, Mapping):
        return Table(obj)
    if hasattr(obj, "columns"):
        return Table({c: np.asarray(obj[c].to_numpy()) for c in obj.columns})
    raise TypeError(f"cannot read a table from {type(obj).__name__}")


def to_numeric(col: np.ndarray, errors: str = "coerce") -> np.ndarray:
    """float64 values of a column (pandas.to_numeric then to_numpy(float64)):
    numbers as they are, numeric strings parsed, missing values NaN; any
    other value is NaN (errors="coerce") or raises (errors="raise")."""
    col = np.asarray(col)
    if col.dtype.kind in "biuf":
        return col.astype(np.float64)
    out = np.empty(len(col), dtype=np.float64)
    for i, x in enumerate(col.tolist()):
        if is_missing_value(x):
            out[i] = np.nan
        elif isinstance(x, (int, float)):
            out[i] = float(x)
        elif isinstance(x, str) and _FLOAT.match(x.strip()):
            out[i] = float(x.strip())
        elif errors == "coerce":
            out[i] = np.nan
        else:
            raise ValueError(f'Unable to parse string "{x}" at position {i}')
    return out


def append_rows(t: Table, id_col, ids: List[str]) -> Table:
    """t with one row per id appended, every other column missing there, as
    pandas.concat([t, DataFrame({id_col: ids})], ignore_index=True) types
    it: integer and boolean columns become float64 or object."""
    out = Table()
    k = len(ids)
    for c, v in t._cols.items():
        if c == id_col:
            out._cols[c] = np.concatenate([v.astype(object), np.array(ids, dtype=object)])
        elif v.dtype.kind in "iuf":
            out._cols[c] = np.concatenate([v.astype(np.float64), np.full(k, np.nan)])
        else:
            out._cols[c] = np.concatenate([v.astype(object), np.full(k, np.nan, dtype=object)])
    return out
