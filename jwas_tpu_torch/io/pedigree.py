"""Pedigrees: topological coding, inbreeding and the inverse relationship
matrix.

Counterpart of jwas_tpu/io/pedigree.py: Pedigree (:33-125),
_topological_codes (:128), the Meuwissen-Luo inbreeding (:212-272),
get_pedigree (:275-338) and get_info (:341), reading a CSV file, a Table
(or any object with .columns) or an (n, 3) array of strings, without
pandas. Individuals that appear only as parents become founders; IDs are
coded so that parents precede their offspring.

The inbreeding coefficients come from csrc/pedigree.cpp, host C++ built
with g++ on first use (_build.py::host_library; a failed build raises);
_inbreeding_meuwissen_luo_py is its plain Python copy and test oracle.
A^-1 is Henderson's factor with inbreeding, built with vectorised numpy and
scipy.sparse: A^-1 = hAi' hAi.
"""

from __future__ import annotations

import ctypes
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as sp

from jwas_tpu_torch.io.table import NA_VALUES, as_table, read_csv_rows

MISSING = "missing"


@dataclass
class Pedigree:
    """A coded pedigree. ids: individual IDs in coding order (parents
    first), the row and column order of A; sire, dam: int64 parent codes,
    -1 where unknown; inbreeding: F of each individual in that order."""

    ids: List[str]
    sire: np.ndarray
    dam: np.ndarray
    inbreeding: np.ndarray
    id_index: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.id_index:
            self.id_index = {s: i for i, s in enumerate(self.ids)}

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def n(self) -> int:
        return len(self.ids)

    def a_inverse_factor(self) -> sp.csc_matrix:
        """Henderson's factor hAi with A^-1 = hAi' hAi (PedModule.jl:
        174-219): row i is d (e_i - e_s / 2 - e_d / 2) over the known
        parents, d = sqrt(4 / (2 - F_s - F_d)) with both, sqrt(4 / (3 - F_p))
        with one, 1 with none."""
        n = self.n
        s, d, F = self.sire, self.dam, self.inbreeding
        has_s, has_d = s >= 0, d >= 0
        Fs = np.where(has_s, F[np.maximum(s, 0)], 0.0)
        Fd = np.where(has_d, F[np.maximum(d, 0)], 0.0)
        dd = np.ones(n)
        both = has_s & has_d
        dd[both] = np.sqrt(4.0 / (2.0 - Fs[both] - Fd[both]))
        only_s, only_d = has_s & ~has_d, has_d & ~has_s
        dd[only_s] = np.sqrt(4.0 / (3.0 - Fs[only_s]))
        dd[only_d] = np.sqrt(4.0 / (3.0 - Fd[only_d]))
        idx = np.arange(n)
        rows = np.concatenate([idx[has_s], idx[has_d], idx])
        cols = np.concatenate([s[has_s], d[has_d], idx])
        vals = np.concatenate([-0.5 * dd[has_s], -0.5 * dd[has_d], dd])
        return sp.csc_matrix((vals, (rows, cols)), shape=(n, n))

    def a_inverse(self) -> sp.csc_matrix:
        """A^-1 = hAi' hAi (a_inverse_factor)."""
        hAi = self.a_inverse_factor()
        return (hAi.T @ hAi).tocsc()

    def a_matrix(self) -> np.ndarray:
        """The dense numerator relationship matrix A by the tabular method,
        one row a step (tests and small pedigrees: O(n^2) memory)."""
        n = self.n
        A = np.zeros((n, n))
        for i in range(n):
            s, d = int(self.sire[i]), int(self.dam[i])
            row = np.zeros(i)
            if s >= 0:
                row += 0.5 * A[s, :i]
            if d >= 0:
                row += 0.5 * A[d, :i]
            A[i, :i] = A[:i, i] = row
            A[i, i] = 1.0 + (0.5 * A[s, d] if s >= 0 and d >= 0 else 0.0)
        return A


def _topological_codes(parents: Dict[str, tuple], order_hint: Sequence[str]) -> Dict[str, int]:
    """Codes in which every parent precedes its offspring, iteratively
    (the recursive code!, PedModule.jl:79-94)."""
    codes: Dict[str, int] = {}
    for start in order_hint:
        if start in codes:
            continue
        stack = [start]
        while stack:
            node = stack[-1]
            if node in codes:
                stack.pop()
                continue
            s, d = parents.get(node, (MISSING, MISSING))
            pending = [p for p in (s, d) if p != MISSING and p not in codes]
            if pending:
                stack.extend(pending)
            else:
                codes[node] = len(codes)
                stack.pop()
    return codes


def _inbreeding_meuwissen_luo(sire: np.ndarray, dam: np.ndarray,
                              tolerance: float = 0.0) -> np.ndarray:
    """Inbreeding coefficients of a coded pedigree (Meuwissen & Luo 1992)
    from csrc/pedigree.cpp. tolerance > 0 stops each ancestor walk at path
    coefficients below it (the node's own contribution kept)."""
    from jwas_tpu_torch import _build

    lib = _build.host_library()
    sire = np.ascontiguousarray(sire, dtype=np.int64)
    dam = np.ascontiguousarray(dam, dtype=np.int64)
    F = np.zeros(len(sire), dtype=np.float64)
    lib.jt_inbreeding_ml(sire.ctypes.data_as(ctypes.c_void_p),
                         dam.ctypes.data_as(ctypes.c_void_p), len(sire),
                         float(tolerance), F.ctypes.data_as(ctypes.c_void_p))
    return F


def _inbreeding_meuwissen_luo_py(sire: np.ndarray, dam: np.ndarray) -> np.ndarray:
    """Plain Python Meuwissen-Luo, the C++ code's oracle: F_i is the sum
    over the ancestors j of i of L_j^2 D_j, less 1, with D_j = 1/2 -
    (F_s + F_d) / 4 (F = -1 for an unknown parent)."""
    n = len(sire)
    F = np.zeros(n)
    for i in range(n):
        s, d = int(sire[i]), int(dam[i])
        if s < 0 or d < 0:
            continue
        L: Dict[int, float] = {i: 1.0}
        heap = [-i]
        visited = set()
        f_acc = -1.0
        while heap:
            j = -heapq.heappop(heap)
            if j in visited:
                continue
            visited.add(j)
            Lj = L.pop(j)
            sj, dj = int(sire[j]), int(dam[j])
            fs = F[sj] if sj >= 0 else -1.0
            fd = F[dj] if dj >= 0 else -1.0
            f_acc += Lj * Lj * (0.5 - 0.25 * (fs + fd))
            for p in (sj, dj):
                if p >= 0:
                    if p in L:
                        L[p] += 0.5 * Lj
                    else:
                        L[p] = 0.5 * Lj
                        heapq.heappush(heap, -p)
        F[i] = f_acc
    return F


def _pedigree_columns(pedfile, header: bool, separator: str):
    """The first three columns of a pedigree as lists of raw strings, with
    the values pandas reads as missing (NA_VALUES) as "nan"."""
    if isinstance(pedfile, np.ndarray):
        return [[str(v) for v in pedfile[:, k].tolist()]
                for k in range(min(3, pedfile.shape[1]))]
    if isinstance(pedfile, (str, bytes)) or hasattr(pedfile, "__fspath__") \
            or hasattr(pedfile, "read"):
        rows = list(read_csv_rows(pedfile, separator))
        if header and rows:
            rows.pop(0)
        width = min(3, max((len(r) for r in rows), default=3))
        return [["nan" if (t := r[k] if k < len(r) else "") in NA_VALUES else t
                 for r in rows] for k in range(width)]
    t = as_table(pedfile)
    return [[str(v) for v in t[c].tolist()] for c in t.columns[:3]]


def get_pedigree(pedfile, header: bool = False, separator: str = ",",
                 missingstring: Sequence[str] = ("0",),
                 inbreeding_tolerance: float = 0.0) -> Pedigree:
    """Read a pedigree (id, sire, dam) from a CSV file, a Table (or an
    object with .columns, such as a DataFrame) or an (n, 3) array of
    strings (PedModule.jl:22-58). Values in missingstring, empty ones and
    those pandas reads as missing are unknown parents; parents that appear
    only as parents become founders; the IDs are coded topologically and
    every individual's inbreeding is computed. inbreeding_tolerance: stop
    the ancestor walks at path coefficients below it (0: exact), as
    jwas_tpu's get_pedigree does."""
    missing_set = set(missingstring) | {"", "nan", "NaN", MISSING}
    raw = _pedigree_columns(pedfile, header, separator)
    if len(raw) < 3 or any(len(c) != len(raw[0]) for c in raw):
        raise ValueError("a pedigree has three columns: ID, sire, dam")
    cols = [[MISSING if (s := v.strip()) in missing_set else s for v in c] for c in raw]
    parents: Dict[str, tuple] = {}
    order_hint: List[str] = []
    for ind, s, d in zip(*cols):
        if ind == MISSING:
            continue
        for p in (s, d):
            if p != MISSING and p not in parents:
                parents[p] = (MISSING, MISSING)
                order_hint.append(p)
        parents[ind] = (s, d)
        order_hint.append(ind)

    codes = _topological_codes(parents, order_hint)
    ids = [""] * len(codes)
    for name, c in codes.items():
        ids[c] = name
    sire = np.full(len(codes), -1, dtype=np.int64)
    dam = np.full(len(codes), -1, dtype=np.int64)
    for name, (s, d) in parents.items():
        if s != MISSING:
            sire[codes[name]] = codes[s]
        if d != MISSING:
            dam[codes[name]] = codes[d]
    F = _inbreeding_meuwissen_luo(sire, dam, tolerance=inbreeding_tolerance)
    return Pedigree(ids=ids, sire=sire, dam=dam, inbreeding=F)


def get_info(ped: Pedigree, Ai: bool = False):
    """Print a summary of the pedigree; with Ai, return (IDs, A^-1,
    inbreeding) (PedModule.jl:289-305)."""
    sires = set(int(s) for s in ped.sire if s >= 0)
    dams = set(int(d) for d in ped.dam if d >= 0)
    founders = int(np.sum((ped.sire < 0) | (ped.dam < 0)))
    print("Pedigree information:")
    print(f"#individuals: {ped.n}")
    print(f"#sires:       {len(sires)}")
    print(f"#dams:        {len(dams)}")
    print(f"#founders:    {founders}")
    if Ai:
        return ped.ids, ped.a_inverse(), ped.inbreeding
    return None
