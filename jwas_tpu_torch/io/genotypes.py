"""Genotype input: VarianceSpec, Genotypes and get_genotypes for the 2-bit
packed store, the dense stores and GBLUP's relationship matrix.

Counterpart of jwas_tpu/io/genotypes.py: VarianceSpec (:42), Genotypes
(:58) and get_genotypes (:218-453) with jwas_tpu's full signature, for
every single-trait method (BayesC, BayesB, BayesR with its class-prior
checks, RR-BLUP, BayesA, BayesL and GBLUP) and starting_value as the
starting marker effects (:451-452; jwas_tpu drops it on the 2-bit
branch, which returns before :451; the port keeps it).

storage="2bit" or a Packed2BitStore takes the 2-bit branch (:257-309),
which runs BayesC, BayesB and BayesR only. storage "f32", "f64" and
"int8" take the dense branch (:311-453): missing codes become the column
mean (rounded for int8), MAF and fixed-locus QC, centering, allele
frequencies and sum 2pq, and int8's integer check. The centered matrix is
written marker-major, (p, n) float32 (float64 for "f64" or
double_precision), straight into the store on the given device, a chunk
of columns at a time, so the host never holds a float copy of the matrix
beside the caller's. int8 keeps jwas_tpu's semantics (integer scores,
their rounded means) but not its raw int8 copy, which nothing downstream
reads.

GBLUP (:327-334, :392-410) keeps no store: a symmetric n x n input is the
relationship matrix itself (no centering, no QC); genotypes become
G = (Z Z' + 1e-5 I) / p, Z the centered scores over sqrt(2pq), built on
the device from the marker-major store a chunk of markers at a time, its
diagonal raised by 1e-5 until a float64 Cholesky succeeds; the store is
freed once G exists.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from jwas_tpu_torch.io.packed import (Packed2BitStore, _genotype_chunks,
                                      prepare_packed_genotypes)
from jwas_tpu_torch.ops.grouped import full_precision_matmul

# BayesR class prior when Pi is 0 (jwas_tpu/io/genotypes.py:28)
DEFAULT_BAYESR_PI = (0.95, 0.03, 0.015, 0.005)
_SUPPORTED_METHODS = ("RR-BLUP", "BayesA", "BayesB", "BayesC", "BayesL",
                      "BayesR", "GBLUP")


@dataclass
class VarianceSpec:
    """A variance component's value, degrees of freedom, scale and
    estimation flags (types.jl:56-64)."""

    val: Optional[Union[float, np.ndarray]]
    df: float = 4.0
    scale: Optional[Union[float, np.ndarray]] = None
    estimate_variance: bool = True
    estimate_scale: bool = False
    constraint: bool = False


@dataclass
class Genotypes:
    """One marker set on the 2-bit store or a dense store
    (types.jl:98-165)."""

    obs_ids: List[str]
    marker_ids: List[str]
    n_obs: int
    n_markers: int
    allele_freq: np.ndarray
    sum2pq: float
    packed_store: Optional[Packed2BitStore] = None   # the 2-bit store
    dense: Optional[torch.Tensor] = None   # (p, n) centered genotypes,
                                           # marker-major, on a device
    grm: Optional[torch.Tensor] = None     # GBLUP: (n, n) relationship
                                           # matrix on a device
    col_means: Optional[np.ndarray] = None  # (p,) the dense store's means
    storage: str = "2bit"
    method: str = "BayesC"
    pi: Union[float, np.ndarray] = 0.0
    estimate_pi: bool = True
    G: VarianceSpec = field(default_factory=lambda: VarianceSpec(val=None))
    genetic_variance: VarianceSpec = field(
        default_factory=lambda: VarianceSpec(val=None))
    name: str = "geno"
    annotations: Optional[np.ndarray] = None    # (p, k) annotation design of
                                                # the kept markers, no intercept
    starting_alpha: Optional[np.ndarray] = None  # (p,) starting marker effects
    multi_trait_sampler: str = "I"   # "auto" | "I" | "II" (MTBayesABC.jl:20-25;
                                     # "auto" runs sampler I, as jwas_tpu does)

    def aligned_to(self, obs_ids: Sequence[str]) -> "Genotypes":
        """This marker set with the dense store's columns in the order of
        obs_ids (align_genotypes, tools4genotypes.jl:288-323; jwas_tpu's
        Genotypes.aligned_to, io/genotypes.py:96): the marker-major
        (p, len(obs_ids)) store, each marker's row contiguous, on the
        store's device; the store itself when the order is already its own
        (no copy). A set without a dense store, or an ID without genotypes,
        raises ValueError."""
        if self.dense is None:
            raise ValueError("aligned_to takes a dense store")
        index = {s: i for i, s in enumerate(self.obs_ids)}
        try:
            rows = np.array([index[s] for s in obs_ids], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"individual {e} has no genotypes") from None
        same = len(rows) == len(self.obs_ids) and np.array_equal(rows, np.arange(len(rows)))
        dense = self.dense if same else self.dense[:, torch.as_tensor(
            rows, device=self.dense.device)]
        return replace(self, obs_ids=list(obs_ids), n_obs=len(rows), dense=dense)


def bayesr_pi(Pi) -> np.ndarray:
    """BayesR's (4,) class prior: the default when Pi is 0, else Pi, which
    must be 4 nonnegative shares summing to 1
    (jwas_tpu/io/genotypes.py:266-273)."""
    if np.ndim(Pi) == 0 and Pi == 0.0:
        return np.asarray(DEFAULT_BAYESR_PI)
    pi = np.asarray(Pi, dtype=np.float64)
    if pi.shape != (4,):
        raise ValueError("BayesR Pi must be a length-4 vector")
    if not np.isclose(pi.sum(), 1.0, atol=1e-8) or (pi < 0).any():
        raise ValueError("BayesR Pi must be nonnegative and sum to 1")
    return pi


def get_genotypes(file, G=None, *, method: str = "BayesC", Pi=0.0,
                  estimatePi: bool = True, G_is_marker_variance: bool = False,
                  df: float = 4.0, estimate_variance: bool = True,
                  estimate_scale: bool = False, constraint: bool = False,
                  separator: str = ",", header: bool = True,
                  double_precision: bool = False, quality_control: bool = True,
                  MAF: float = 0.01, missing_value: float = 9.0,
                  center: bool = True, starting_value=None, annotations=None,
                  storage: str = "f32", name: str = "geno",
                  multi_trait_sampler: str = "I", device="cuda") -> Genotypes:
    """Genotypes for a 2-bit packed store (storage="2bit" or a
    Packed2BitStore: a CSV path, table or (n, p) array is packed with
    prepare_packed_genotypes) or a dense store (storage "f32", "f64",
    "int8": a CSV path, table, or (n, p) numpy array or tensor). QC drops
    markers with frequency outside (MAF, 1 - MAF) and fixed loci unless
    quality_control=False. G is the genetic variance, or the marker-effect
    variance with G_is_marker_variance=True.

    method: every single-trait method on a dense store; on the 2-bit
    store only "BayesC", "BayesB" and "BayesR", the others raising
    ValueError as jwas_tpu does. annotations: a (p, k) array (one row a
    raw marker, before QC), or a CSV path, Table or DataFrame whose first
    column holds the marker IDs (validate_annotations), for BayesC and
    BayesR on a dense store; estimatePi is then True. GBLUP keeps the relationship matrix (grm)
    of the input, or of its genotypes, in place of a store; G must then be
    the genetic variance. device: where a dense store or the relationship
    matrix is written (the GPU unless the caller asks for another; "cpu"
    runs the plain versions). starting_value: (p,) starting marker
    effects, one a marker after QC (GBLUP ignores them, as jwas_tpu does).
    Multi-trait (a model of several equations): G is the t x t genetic
    covariance (or marker-effect covariance), Pi a dict of the prior
    probabilities of the inclusion patterns, e.g. {(1.0, 1.0): 0.6,
    (1.0, 0.0): 0.2, (0.0, 1.0): 0.1, (0.0, 0.0): 0.1} (default: every
    marker affects every trait), multi_trait_sampler "I", "II" or "auto"
    (sampler I), and constraint=True the mega-trait model (one
    single-trait sweep a trait, a diagonal covariance).
    """
    if method not in _SUPPORTED_METHODS:
        raise ValueError(f"method {method!r} is not available; use one of {_SUPPORTED_METHODS}")
    if storage not in ("f32", "f64", "int8", "2bit"):
        raise ValueError("storage must be 'f32', 'f64', 'int8', or '2bit'")
    packed = isinstance(file, Packed2BitStore) or storage == "2bit"
    if packed and method not in ("BayesC", "BayesB", "BayesR"):
        raise ValueError("storage='2bit' supports BayesC/BayesB/BayesR only")
    if packed and annotations is not None:
        raise ValueError("annotations are not supported with storage='2bit'")
    if annotations is not None and method not in ("BayesC", "BayesR"):
        raise ValueError('annotations are only supported with method="BayesC" or '
                         'method="BayesR"')
    if method == "BayesR":
        Pi = bayesr_pi(Pi).copy()

    def spec(val):
        return VarianceSpec(val=val, df=df, estimate_variance=estimate_variance,
                            estimate_scale=estimate_scale, constraint=constraint)

    if packed:
        store = file if isinstance(file, Packed2BitStore) else prepare_packed_genotypes(
            file, separator=separator, header=header, missing_value=missing_value,
            MAF=MAF if quality_control else 0.0)
        obs_ids, marker_ids = list(store.obs_ids), list(store.marker_ids)
        freqs = np.asarray(store.allele_freq, dtype=np.float64)
        fields = dict(packed_store=store)
        dtype = np.float32
    elif method == "GBLUP":
        if G_is_marker_variance:
            raise ValueError("GBLUP requires the genetic variance, not a marker variance")
        dtype = np.float64 if (double_precision or storage == "f64") else np.float32
        obs_ids, marker_ids, grm, freqs = relationship_matrix(
            file, torch.float64 if dtype is np.float64 else torch.float32,
            device, separator=separator, header=header,
            quality_control=quality_control, MAF=MAF,
            missing_value=missing_value, center=center,
            round_missing=storage == "int8")
        fields = dict(grm=grm, storage=storage)
    else:
        dtype = np.float64 if (double_precision or storage == "f64") else np.float32
        obs_ids, marker_ids, X, means, freqs = dense_store(
            file, torch.float64 if dtype is np.float64 else torch.float32,
            device, separator=separator, header=header,
            quality_control=quality_control, MAF=MAF,
            missing_value=missing_value, center=center,
            integer=storage == "int8", annotations=annotations, method=method)
        fields = dict(dense=X, col_means=means, storage=storage)
        if annotations is not None:
            fields["annotations"], freqs = freqs
            if not estimatePi:
                warnings.warn(f"estimatePi=False is ignored when annotations are "
                              f"provided; Annotated {method} requires estimatePi=True.")
                estimatePi = True

    starting_alpha = None
    if starting_value is not None:
        starting_alpha = np.asarray(starting_value, dtype=dtype).reshape(-1)
        if starting_alpha.shape != (len(marker_ids),):
            raise ValueError(f"starting_value must hold one effect for each of "
                             f"the {len(marker_ids)} markers")
    return Genotypes(
        obs_ids=obs_ids, marker_ids=marker_ids, n_obs=len(obs_ids),
        n_markers=len(marker_ids), allele_freq=freqs,
        sum2pq=float(np.sum(2.0 * freqs * (1.0 - freqs))), method=method, pi=Pi,
        estimate_pi=estimatePi, G=spec(G if G_is_marker_variance else None),
        genetic_variance=spec(None if G_is_marker_variance else G),
        name=name, starting_alpha=starting_alpha,
        multi_trait_sampler=multi_trait_sampler, **fields,
    )


_CHUNK_BYTES = 1 << 29      # a float64 chunk of columns of the dense set-up


def _as_matrix(file, separator, header, np_dtype):
    """(obs_ids, marker_ids, (n, p) matrix): a tensor or numpy array kept
    as it is, a CSV path or a table read into a numpy array of np_dtype."""
    if torch.is_tensor(file) or isinstance(file, np.ndarray):
        if file.ndim != 2:
            raise ValueError("genotypes must be an (n, p) matrix")
        n, p = file.shape
        return [str(i + 1) for i in range(n)], [str(j + 1) for j in range(p)], file
    marker_ids, chunks = _genotype_chunks(file, separator, header, 8192, np_dtype)
    ids, parts = [], []
    for i, m in chunks:
        ids.extend(i)
        parts.append(m)
    mat = np.concatenate(parts) if parts else np.zeros((0, len(marker_ids)), np_dtype)
    return ids, marker_ids, mat


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); "
                           "pass device='cpu' to build the store on the CPU")
    return device


def validate_annotations(annotations, marker_ids, n_markers: int, method: str):
    """The annotation design's checks (_validate_annotations,
    jwas_tpu/io/genotypes.py:135-189; validate_annotations_input,
    readgenotypes.jl:56-158): a numeric (p, k) array or tensor, one row a
    raw marker, or a CSV path (io/table.py, no pandas), Table or DataFrame
    whose first column, when it holds strings or is named marker_id,
    markerid, id or snp, is the marker ID: its rows are aligned to
    marker_ids and every marker must be there. BayesC and BayesR only;
    finite, p rows, no constant column, full rank beside an intercept.
    Returns the (p, k) float64 design."""
    from jwas_tpu_torch.io.table import as_table, read_csv, to_numeric

    if isinstance(annotations, str):
        annotations = read_csv(annotations)
    if not (torch.is_tensor(annotations) or isinstance(annotations, np.ndarray)) and (
            hasattr(annotations, "columns")):
        tab = as_table(annotations)
        cols = tab.columns
        first = tab[cols[0]]
        if first.dtype == object or str(cols[0]).lower() in (
                "marker_id", "markerid", "id", "snp"):
            row_of = {str(m): i for i, m in enumerate(first.tolist())}
            missing = [m for m in marker_ids if m not in row_of]
            if missing:
                raise ValueError(f"annotations are missing marker(s) {missing[:5]}"
                                 + ("..." if len(missing) > 5 else ""))
            rows = np.asarray([row_of[m] for m in marker_ids], dtype=np.int64)
            cols = cols[1:]
        else:
            rows = np.arange(len(tab))
        ann = np.stack([to_numeric(tab[c])[rows] for c in cols], axis=1) if cols else (
            np.zeros((len(rows), 0)))
    else:
        ann = np.asarray(annotations.cpu() if torch.is_tensor(annotations) else annotations)
    if method not in ("BayesC", "BayesR"):
        raise ValueError('annotations are only supported with method="BayesC" or '
                         'method="BayesR"')
    ann = np.asarray(ann, dtype=np.float64)
    if ann.ndim != 2 or not np.isfinite(ann).all():
        raise ValueError("annotations must be a finite numeric matrix with one row "
                         "per marker")
    if ann.shape[0] != n_markers:
        raise ValueError(f"annotations rows ({ann.shape[0]}) must match the number "
                         f"of raw markers ({n_markers})")
    const_cols = [j for j in range(ann.shape[1]) if np.unique(ann[:, j]).size == 1]
    if const_cols:
        raise ValueError(f"annotations contain constant column(s) {const_cols}; "
                         f"remove them (an intercept is added automatically)")
    design = np.hstack([np.ones((ann.shape[0], 1)), ann])
    if np.linalg.matrix_rank(design) != design.shape[1]:
        raise ValueError("annotations are collinear after adding the intercept; "
                         "remove duplicate or perfectly collinear annotation columns")
    return ann


def dense_store(file, dtype, device, *, separator=",", header=True,
                quality_control=True, MAF=0.01, missing_value=9.0, center=True,
                integer=False, annotations=None, method="BayesC"):
    """The dense branch of jwas_tpu's get_genotypes
    (jwas_tpu/io/genotypes.py:311-453) on a device, a chunk of columns at a
    time, in two passes: the columns' statistics, then the kept columns,
    centered, written into the (p_kept, n) store of dtype.

    With quality_control, values equal to missing_value become the mean of
    the column's other values (rounded when integer, storage="int8") and
    markers with frequency outside (MAF, 1 - MAF) or a constant column are
    dropped. integer: every value must be within isclose of an integer
    score (jwas_tpu's int8 check), and the rounded scores are the store's.
    Returns (obs_ids, marker_ids, store, col_means (p_kept,) float64,
    allele frequencies (p_kept,) float64); with annotations (checked
    against the raw markers by validate_annotations) the last is the pair
    (the kept markers' annotation rows, allele frequencies)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    obs_ids, marker_ids, mat = _as_matrix(file, separator, header, np_dtype)
    if annotations is not None:
        annotations = validate_annotations(annotations, marker_ids, mat.shape[1],
                                           method)
    ids, store, means, freqs, kept = _store_of(
        mat, marker_ids, dtype, _device(device), quality_control=quality_control,
        MAF=MAF, missing_value=missing_value, center=center, integer=integer,
        round_missing=integer)
    if annotations is not None:
        freqs = (annotations[kept], freqs)
    return obs_ids, ids, store, means, freqs


def _store_of(mat, marker_ids, dtype, device, *, quality_control, MAF,
              missing_value, center, integer, round_missing):
    """dense_store's two passes over an (n, p) matrix; round_missing: the
    imputed means are rounded (storage="int8", also without integer's
    check, as jwas_tpu's GBLUP branch does). Returns (marker_ids, store,
    col_means, allele frequencies) of the kept markers and the (p,) mask
    of the kept ones."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    n, p = mat.shape
    step = max(1, _CHUNK_BYTES // (8 * max(n, 1)))
    mv = torch.tensor(float(np_dtype(missing_value)), dtype=dtype, device=device)

    def columns(c0, c1):
        """Columns c0:c1 in dtype on the device, missing values imputed."""
        x = mat[:, c0:c1]
        x = (x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x)))
        x = x.to(device=device, dtype=dtype)
        if quality_control:
            miss = x == mv
            if bool(miss.any()):
                cnt = (~miss).sum(0).clamp(min=1)
                m = torch.where(miss, 0.0, x).sum(0, dtype=torch.float64) / cnt
                if round_missing:
                    m = torch.round(m)
                x = torch.where(miss, m.to(dtype)[None, :], x)
        if integer:
            raw = torch.round(x)
            if not bool(torch.isclose(raw, x, rtol=1e-5, atol=1e-6).all()):
                raise ValueError(
                    "storage='int8' requires integer genotype scores "
                    "(use storage='f32' for fractional imputed values)")
            x = raw
        return x

    means = torch.zeros(p, dtype=torch.float64, device=device)
    varies = torch.ones(p, dtype=torch.bool, device=device)
    out_of_range = False
    for c0 in range(0, p, step):
        c1 = min(p, c0 + step)
        x = columns(c0, c1)
        means[c0:c1] = x.sum(0, dtype=torch.float64) / max(n, 1)
        varies[c0:c1] = (x != x[:1]).any(0) if n else False
        out_of_range |= quality_control and bool(((x < 0) | (x > 2)).any())
    if out_of_range:
        warnings.warn("genotype scores out of the range 0 to 2 are found.")
    freqs = means / 2.0
    keep = torch.ones(p, dtype=torch.bool, device=device)
    if quality_control:
        keep = (freqs > MAF) & (freqs < 1 - MAF) & varies
        n_removed = int((~keep).sum())
        if n_removed:
            print(f"{n_removed} loci which are fixed or have minor allele "
                  f"frequency < {MAF} are removed.")
    kept = keep.cpu().numpy()
    store = torch.empty((int(kept.sum()), n), dtype=dtype, device=device)
    k = 0
    for c0 in range(0, p, step):
        c1 = min(p, c0 + step)
        sel = keep[c0:c1]
        if not bool(sel.any()):
            continue
        x = columns(c0, c1)[:, sel]
        if center:
            x = (x.to(torch.float64) - means[c0:c1][sel]).to(dtype)
        store[k:k + x.shape[1]] = x.T
        k += x.shape[1]
    marker_ids = [m for m, kk in zip(marker_ids, kept) if kk]
    return (marker_ids, store, means[keep].cpu().numpy(),
            freqs[keep].cpu().numpy(), kept)


GRM_RIDGE = 1e-5            # jwas_tpu's diagonal term and its retry step
GRM_TRIES = 10


def relationship_matrix(file, dtype, device, *, separator=",", header=True,
                        quality_control=True, MAF=0.01, missing_value=9.0,
                        center=True, round_missing=False):
    """GBLUP's branch of jwas_tpu's get_genotypes
    (jwas_tpu/io/genotypes.py:327-334, :392-410) on a device: an n x n
    input that is symmetric within numpy's allclose (rtol 1e-5, atol 1e-6)
    is the relationship matrix as given (no centering, no QC); otherwise
    the genotypes go through dense_store's QC and centering, and
    G = (Z Z' + 1e-5 I) / p with Z = X / sqrt(2pq) is summed a chunk of
    markers at a time from the marker-major store, which is then freed.
    While a float64 Cholesky of G fails, 1e-5 is added to its diagonal,
    at most GRM_TRIES times. Returns (obs_ids, marker_ids, G (n, n) of
    dtype on the device, allele frequencies (p,) float64: of the kept
    markers, or G's column means / 2 for a given matrix)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    device = _device(device)
    obs_ids, marker_ids, mat = _as_matrix(file, separator, header, np_dtype)
    n, p = mat.shape
    if n == p:
        G = torch.as_tensor(mat).to(device=device, dtype=dtype)
        if torch.allclose(G, G.T, rtol=1e-5, atol=1e-6):
            freqs = G.sum(0, dtype=torch.float64) / max(n, 1) / 2.0
            return obs_ids, marker_ids, G, freqs.cpu().numpy()
        del G
    marker_ids, X, _, freqs, _ = _store_of(
        mat, marker_ids, dtype, device, quality_control=quality_control,
        MAF=MAF, missing_value=missing_value, center=center, integer=False,
        round_missing=round_missing)
    p = X.shape[0]
    denom = torch.as_tensor(np.sqrt(2.0 * freqs * (1.0 - freqs))).to(device=device, dtype=dtype)
    G = torch.zeros((n, n), dtype=dtype, device=device)
    step = max(1, _CHUNK_BYTES // (X.element_size() * max(n, 1)))
    with full_precision_matmul():
        for c0 in range(0, p, step):
            z = X[c0:c0 + step] / denom[c0:c0 + step, None]
            G.addmm_(z.T, z)
    del X
    eye = torch.eye(n, dtype=dtype, device=device) * GRM_RIDGE
    G = (G + eye) / p
    for tries in range(GRM_TRIES + 1):
        if int(torch.linalg.cholesky_ex(G.double()).info) == 0:
            return obs_ids, marker_ids, G, freqs
        G += eye
    raise ValueError("could not make the relationship matrix positive definite")
