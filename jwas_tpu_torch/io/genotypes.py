"""Genotype input: VarianceSpec, Genotypes and get_genotypes for the 2-bit
packed store.

Counterpart of jwas_tpu/io/genotypes.py: VarianceSpec (:42), Genotypes
(:58) and get_genotypes (:218-309) with jwas_tpu's full signature, on the
branch it takes for storage="2bit" or a Packed2BitStore (:257-309): BayesC
and BayesR (with BayesR's class-prior checks). The dense storages and
BayesB are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np

from jwas_tpu_torch.io.packed import Packed2BitStore, prepare_packed_genotypes

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
    """One marker set on the 2-bit store (types.jl:98-165)."""

    obs_ids: List[str]
    marker_ids: List[str]
    n_obs: int
    n_markers: int
    allele_freq: np.ndarray
    sum2pq: float
    packed_store: Packed2BitStore
    method: str = "BayesC"
    pi: Union[float, np.ndarray] = 0.0
    estimate_pi: bool = True
    G: VarianceSpec = field(default_factory=lambda: VarianceSpec(val=None))
    genetic_variance: VarianceSpec = field(
        default_factory=lambda: VarianceSpec(val=None))
    name: str = "geno"
    annotations: Optional[np.ndarray] = None    # always None on the 2-bit store


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
                  multi_trait_sampler: str = "I") -> Genotypes:
    """Genotypes for a 2-bit packed store: a Packed2BitStore, or a CSV
    path, table or (n, p) array packed with prepare_packed_genotypes
    (storage="2bit"; QC drops markers with frequency outside (MAF, 1 - MAF)
    unless quality_control=False). G is the genetic variance, or the
    marker-effect variance with G_is_marker_variance=True.

    Ported: method "BayesC" or "BayesR". storage "f32", "f64" or "int8" and
    method "BayesB" raise NotImplementedError; the other methods raise
    ValueError on the 2-bit store, as jwas_tpu does.
    """
    if method not in _SUPPORTED_METHODS:
        raise ValueError(f"method {method!r} is not available; use one of {_SUPPORTED_METHODS}")
    if storage not in ("f32", "f64", "int8", "2bit"):
        raise ValueError("storage must be 'f32', 'f64', 'int8', or '2bit'")
    if not isinstance(file, Packed2BitStore) and storage != "2bit":
        raise NotImplementedError(
            f"storage={storage!r} (dense genotypes) is not ported yet "
            f"(ROADMAP.md Queue 1 item 5); use storage='2bit'")
    if method not in ("BayesC", "BayesB", "BayesR"):
        raise ValueError("storage='2bit' supports BayesC/BayesB/BayesR only")
    if method == "BayesB":
        raise NotImplementedError(
            "method='BayesB' is not ported yet (ROADMAP.md Queue 1 item 7)")
    if annotations is not None:
        raise ValueError("annotations are not supported with storage='2bit'")
    if method == "BayesR":
        Pi = bayesr_pi(Pi).copy()
    if isinstance(file, Packed2BitStore):
        store = file
    else:
        store = prepare_packed_genotypes(
            file, separator=separator, header=header, missing_value=missing_value,
            MAF=MAF if quality_control else 0.0)

    def spec(val):
        return VarianceSpec(val=val, df=df, estimate_variance=estimate_variance,
                            estimate_scale=estimate_scale, constraint=constraint)

    return Genotypes(
        obs_ids=list(store.obs_ids), marker_ids=list(store.marker_ids),
        n_obs=store.n_obs, n_markers=store.n_markers,
        allele_freq=np.asarray(store.allele_freq, dtype=np.float64),
        sum2pq=store.sum2pq, packed_store=store, method=method, pi=Pi,
        estimate_pi=estimatePi,
        G=spec(G if G_is_marker_variance else None),
        genetic_variance=spec(None if G_is_marker_variance else G),
        name=name,
    )
