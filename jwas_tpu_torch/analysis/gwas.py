"""Window GWAS of MCMC marker-effect samples, and model frequencies.

Counterpart of jwas_tpu/analysis/gwas.py (GWAS.jl): model_frequency (:94),
_build_windows (:101-134), GWAS (:135): the full-genome breeding values
BV = X A (:235) of every saved sample, each window's var(X_w A_w) over
the genomic variance var(BV) (both dividing by n, as jnp.var does), WPPA
(the share of samples whose proportion exceeds threshold), the variance
proportions (output_winVarProps), the windows' local EBVs (local_EBV) and
the windows' genetic covariances and correlations between two
marker-effect files (genetic_correlation, :196-234, dividing by n - 1).

The genotypes are read a column chunk at a time on a device, the GPU
unless the caller asks for another (device="cpu"; a missing GPU raises):
DenseColumns over a dense store (a Genotypes' marker-major (p, n) store,
or an (n, p) matrix) centred by its own column means, as jwas_tpu's
_DenseX centres (:25); PackedColumns over a 2-bit store (a Genotypes'
packed_store or a bare Packed2BitStore; its bytes a numpy array, a memmap
or a tensor, used where they lie when on the device), decoded in
observation order with plain torch operations, code 3 (missing) taking the
marker's mean, then centred by the store's means (jwas_tpu's _PackedX,
:44). A chunk is at most ops/grouped.py's decode budget (1 GB of float32
columns), so no dense (n, p) matrix of a 2-bit store is ever formed. The
products are torch.mm under full_precision_matmul (no TF32 rounding), as
jwas_tpu takes them outside any Pallas kernel.

Two departures from jwas_tpu, each with a test: the map's first three
columns are read as ID, chromosome and position with or without a header
row (jwas_tpu's header=False raises AttributeError, fault R16), and the
windows are sorted stably by (-WPPA, window), where pandas' unstable sort
leaves the order of WPPA's ties unspecified.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from jwas_tpu_torch.engine.samples_io import read_sample_file
from jwas_tpu_torch.engine.setup import resolve_device
from jwas_tpu_torch.io.packed import Packed2BitStore
from jwas_tpu_torch.io.table import Table, as_table, read_csv
from jwas_tpu_torch.ops.grouped import _DECODE_BYTES, _decode_codes, full_precision_matmul

CORRELATION_COLUMNS = ("trait", "window", "chr", "wStart", "numSNP", "start_SNP",
                       "end_SNP", "estimate_cov", "std_cov", "estimate_cor", "std_cor")
WINDOW_COLUMNS = ("window", "chr", "start", "numSNP", "start_SNP", "end_SNP",
                  "prGenVar", "WPPA")


class Columns:
    """Centred float32 genotype columns on a device, a chunk of markers
    at a time (at most budget bytes of decoded columns)."""

    def __init__(self, n: int, p: int, device, budget: int = _DECODE_BYTES):
        self.shape = (n, p)
        self.device = device
        self.chunk = max(1, budget // (4 * max(1, n)))

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """(len(idx), n) centred columns of the markers idx (on the device)."""
        raise NotImplementedError

    def product(self, idx: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        """X[:, idx] @ A (n, S), A (len(idx), S), summed over chunks."""
        out = None
        with full_precision_matmul():
            for c0 in range(0, idx.numel(), self.chunk):
                part = torch.mm(self.rows(idx[c0:c0 + self.chunk]).T,
                                A[c0:c0 + self.chunk])
                out = part if out is None else out + part
        return out

    def matmul(self, A: torch.Tensor) -> torch.Tensor:
        """X @ A over every marker."""
        return self.product(torch.arange(self.shape[1], device=self.device), A)


class DenseColumns(Columns):
    """A dense (p, n) marker-major store (a Genotypes' store, or the
    transpose of an (n, p) matrix), centred by its column means."""

    def __init__(self, Xt: torch.Tensor, device):
        super().__init__(Xt.shape[1], Xt.shape[0], device)
        self.Xt = Xt
        self.means = Xt.mean(dim=1).to(device=device, dtype=torch.float32)

    def rows(self, idx):
        x = self.Xt.index_select(0, idx.to(self.Xt.device))
        return x.to(device=self.device, dtype=torch.float32) - self.means[idx, None]


class PackedColumns(Columns):
    """A 2-bit store, decoded in observation order as ops/grouped.py::
    _decode_codes decodes it: code - mean, a missing code (3) 0."""

    def __init__(self, store: Packed2BitStore, device):
        super().__init__(int(store.n_obs), int(store.n_markers), device)
        packed = store.packed
        self.on_device = torch.is_tensor(packed) and packed.device == device
        self.packed = packed
        self.means = torch.as_tensor(np.asarray(store.means, dtype=np.float64),
                                     dtype=torch.float32).to(device)

    def rows(self, idx):
        if self.on_device:
            raw = self.packed.index_select(0, idx)
        elif torch.is_tensor(self.packed):
            raw = self.packed.index_select(0, idx.to(self.packed.device)).to(self.device)
        else:
            raw = torch.from_numpy(np.ascontiguousarray(
                self.packed[idx.cpu().numpy()])).to(self.device)
        codes = _decode_codes(raw, self.shape[0], None)
        x = codes.to(torch.float32)
        x -= self.means[idx, None]
        return x.masked_fill_(codes == 3, 0.0)


def genotype_columns(genotypes, model_or_file, device) -> Optional[Columns]:
    """The genotypes of GWAS (jwas_tpu's _resolve_X, :69): genotypes given,
    else the model's first marker set; a Genotypes with a 2-bit store or a
    dense one, a Packed2BitStore, or an (n, p) matrix. None when there are
    none."""
    cand = genotypes
    if cand is None and getattr(model_or_file, "M", None):
        cand = model_or_file.M[0]
    if cand is None:
        return None
    store = getattr(cand, "packed_store", None)
    if store is not None:
        return PackedColumns(store, device)
    if isinstance(cand, Packed2BitStore):
        return PackedColumns(cand, device)
    if hasattr(cand, "packed_store"):            # a Genotypes without a 2-bit store
        return None if cand.dense is None else DenseColumns(cand.dense, device)
    X = cand if torch.is_tensor(cand) else torch.as_tensor(np.asarray(cand, dtype=np.float32))
    return DenseColumns(X.to(device=device, dtype=torch.float32).T.contiguous(), device)


def read_marker_samples(path: str):
    """A marker-effect sample file: (marker IDs, (S, p) float64)."""
    return read_sample_file(path, header=True)


def model_frequency(marker_effects_file: str) -> Table:
    """Each marker's share of saved samples with a nonzero effect
    (GWAS.jl:6-18), on the host."""
    marker_ids, samples = read_marker_samples(marker_effects_file)
    return Table({"marker_ID": np.asarray(marker_ids, dtype=object),
                  "modelfrequency": (samples != 0.0).mean(axis=0)})


def build_windows(map_table, marker_ids: List[str], window_size_mb: float, sliding: bool):
    """Windows of the map (GWAS.jl:89-134): its first three columns are ID,
    chromosome and position; rows whose ID has no samples are dropped;
    chromosomes in order of first appearance; a chromosome's markers sorted
    by position (np.argsort, as jwas_tpu); fixed windows [w, w + 1) Mb
    (empty ones skipped; start w Mb) or one sliding window from each
    marker to the first position >= its own + the size (start its
    position). Returns a list of (chromosome as str, start, marker indices)."""
    cols = map_table.columns
    order = dict(zip(marker_ids, range(len(marker_ids))))
    idx_all = np.array([order.get(m, -1) for m in
                        np.asarray(map_table[cols[0]]).astype(str).tolist()], dtype=np.int64)
    keep = idx_all >= 0
    chrom = np.asarray(map_table[cols[1]])[keep]
    pos_all = np.asarray(map_table[cols[2]], dtype=np.float64)[keep]
    idx_all = idx_all[keep]
    _, first, inv = np.unique(chrom, return_index=True, return_inverse=True)
    rows = np.argsort(inv.reshape(-1), kind="stable")     # by chromosome, in map order
    bounds = np.concatenate([[0], np.cumsum(np.bincount(inv.reshape(-1)))])
    win = int(window_size_mb * 1_000_000)
    windows = []
    for g in np.argsort(first, kind="stable"):          # order of first appearance
        sub = rows[bounds[g]:bounds[g + 1]]
        c = str(chrom[sub[0]])
        pos, idx = pos_all[sub], idx_all[sub]
        srt = np.argsort(pos)
        pos, idx = pos[srt], idx[srt]
        if sliding:
            ends = np.searchsorted(pos, pos + win, side="left")
            windows.extend((c, pos[i], idx[i:ends[i]]) for i in range(len(pos)))
            continue
        nwin = int(pos.max() // win) + 1 if len(pos) else 0
        edges = np.searchsorted(pos, np.arange(nwin + 1, dtype=np.float64) * win, side="left")
        windows.extend((c, w * win, idx[edges[w]:edges[w + 1]]) for w in range(nwin)
                       if edges[w + 1] > edges[w])
    return windows


def _read_map(map_file, header: bool) -> Table:
    if isinstance(map_file, str):
        return read_csv(map_file, header=header)
    return as_table(map_file)


def GWAS(model_or_file, map_file=None, marker_effects_file=None, *, genotypes=None,
         header: bool = True, window_size: str = "1 Mb", sliding_window: bool = False,
         threshold: float = 0.001, output_winVarProps: bool = False,
         genetic_correlation: bool = False, local_EBV: bool = False, device="cuda"):
    """Window GWAS (GWAS.jl:49-249), or model frequencies.

    GWAS(marker_effects_file): each marker's model frequency (a Table of
    marker_ID, modelfrequency; host only). GWAS(model, map_file,
    marker_effects_file): the genotypes from genotypes= (a Genotypes, a
    Packed2BitStore or an (n, p) matrix) or the model's marker set; the
    map a CSV path (header: whether it has a header row) or a table;
    returns a Table of window, chr, start, numSNP, start_SNP, end_SNP,
    prGenVar and WPPA sorted by WPPA (ties by window), and after it the
    (windows, samples) variance proportions (output_winVarProps, in window
    order) and a Table of local EBVs, a column a window (local_EBV).
    genetic_correlation=True takes a pair of marker-effect files and
    returns each window's genetic covariance and correlation between them
    (their means and sds over the samples). The products run on device."""
    if map_file is None:
        return model_frequency(model_or_file)
    if marker_effects_file is None:
        raise ValueError("marker_effects_file is required for window-based GWAS")
    if genetic_correlation:
        files = marker_effects_file
        if not (isinstance(files, (list, tuple)) and len(files) == 2):
            raise ValueError("genetic_correlation=True requires a pair of marker-effect files")
        marker_ids, samples = read_marker_samples(files[0])
        _, samples2 = read_marker_samples(files[1])
        if samples2.shape != samples.shape:
            raise ValueError("the two marker-effect files must match in shape")
    else:
        marker_ids, samples = read_marker_samples(marker_effects_file)
        samples2 = None
    S, p = samples.shape

    device = resolve_device(device)
    X = genotype_columns(genotypes, model_or_file, device)
    if X is None:
        raise ValueError(
            "genotypes are required (pass genotypes= a matrix, a Genotypes object, "
            "or a Packed2BitStore; or a model whose marker set has either a dense "
            "store or a packed_store)")
    if X.shape[1] != p:
        raise ValueError("genotype columns must match the marker-effect samples")
    wsize = float(str(window_size).split()[0])
    windows = build_windows(_read_map(map_file, header), marker_ids, wsize, sliding_window)
    A = torch.as_tensor(samples.T, dtype=torch.float32).to(device)          # (p, S)
    lengths = [len(idx) for _, _, idx in windows]
    all_idx = torch.as_tensor(np.concatenate([idx for _, _, idx in windows])
                              if windows else np.zeros(0, np.int64)).to(device)
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)

    def window_idx(w):
        return all_idx[starts[w]:starts[w + 1]]

    def meta(w):
        chrom, start, idx = windows[w]
        return (w + 1, chrom, float(start), len(idx), marker_ids[idx[0]],
                marker_ids[idx[-1]])

    if genetic_correlation:
        AA = torch.cat([A, torch.as_tensor(samples2.T, dtype=torch.float32).to(device)], 1)
        cov, cor = [], []
        for w in range(len(windows)):
            idx = window_idx(w)
            B = X.product(idx, AA[idx])                  # (n, 2S)
            Bc = B - B.mean(dim=0, keepdim=True)
            B1c, B2c = Bc[:, :S], Bc[:, S:]
            n_ind = B.shape[0]
            cov_s = torch.sum(B1c * B2c, dim=0) / (n_ind - 1)
            sd = torch.sqrt(torch.sum(B1c ** 2, dim=0) * torch.sum(B2c ** 2, dim=0)) / (n_ind - 1)
            cov.append(cov_s)
            cor.append(torch.where(sd > 0, cov_s / torch.clamp(sd, min=1e-30), 0.0))
        cov_h = np.nan_to_num(torch.stack(cov).cpu().numpy()) if cov else np.zeros((0, S))
        cor_h = np.nan_to_num(torch.stack(cor).cpu().numpy()) if cor else np.zeros((0, S))
        rows = [("cor(t1,t2)",) + meta(w) + (float(cov_h[w].mean()), float(cov_h[w].std()),
                                             float(cor_h[w].mean()), float(cor_h[w].std()))
                for w in range(len(windows))]
        return _table(rows, CORRELATION_COLUMNS)

    BV = X.matmul(A)                                     # (n, S)
    gen_var = torch.clamp(torch.var(BV, dim=0, correction=0), min=1e-30)
    del BV
    props, lebv = [], []
    for w in range(len(windows)):
        idx = window_idx(w)
        BVw = X.product(idx, A[idx])
        props.append(torch.var(BVw, dim=0, correction=0) / gen_var)
        if local_EBV:
            lebv.append(BVw.mean(dim=1))
    props_h = torch.stack(props).cpu().numpy() if props else np.zeros((0, S), np.float32)
    rows = [meta(w) + (float(props_h[w].mean()), float((props_h[w] > threshold).mean()))
            for w in range(len(windows))]
    out = _table(rows, WINDOW_COLUMNS)
    order = np.lexsort((out["window"], -out["WPPA"]))
    out = out.take(order)
    extras = []
    if output_winVarProps:
        extras.append(props_h.astype(np.float64))
    if local_EBV:
        lebv_h = torch.stack(lebv).cpu().numpy() if lebv else np.zeros((0, X.shape[0]))
        extras.append(Table({f"window{w + 1}": lebv_h[w] for w in range(len(windows))}))
    return (out, *extras) if extras else out


def _table(rows, columns) -> Table:
    cols = list(zip(*rows)) if rows else [()] * len(columns)
    out = Table()
    for name, values in zip(columns, cols):
        kind = (np.int64 if name in ("window", "numSNP") else
                object if name in ("trait", "chr", "start_SNP", "end_SNP") else np.float64)
        out[name] = np.asarray(values, dtype=kind)
    return out
