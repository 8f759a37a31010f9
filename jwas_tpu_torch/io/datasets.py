"""Packaged example datasets and the simulators of known truth.

Counterpart of jwas_tpu/io/datasets.py: the simulators
simulate_genomic_data (:52), simulate_genomic_data_mt (:89) and
simulate_pedigree_genomic_data (:149) with _drop_pedigree (:216) and
_scaled (:245), the packaged analogues _demo_7animals (:21),
_simulated_omics (:250) and _simulated_annotations (:317), and dataset
(:391) with its JWAS_REFERENCE_DATA hook (:407-416). Every table is a
Table (io/table.py) in place of a DataFrame, made by the same numpy
default_rng calls in the same order, so each equals jwas_tpu's value for
value.

dataset() writes a table's CSV into a directory private to the process
(one tempfile.mkdtemp a process, removed at exit), under a temporary name
and then renamed, and returns only files it wrote itself: jwas_tpu returns
whatever file already sits at <tmp>/jwas_tpu_<dataset>/<table>.csv in the
shared temporary directory (fault R17, ROADMAP.md).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np

from jwas_tpu_torch.io.table import Table

_CACHE: Dict[str, Dict[str, Table]] = {}
_WRITTEN: Dict[tuple, str] = {}      # (dataset, table) -> the file this process wrote
_DIR: Dict[str, str] = {}            # "root": this process's private directory


def _marker_table(ids, X, names=None) -> Table:
    """ID then one column a marker (a DataFrame of X with "ID" inserted first)."""
    names = names or [f"m{j + 1}" for j in range(X.shape[1])]
    cols = {"ID": np.asarray(ids, dtype=object)}
    cols.update((name, X[:, j]) for j, name in enumerate(names))
    return Table(cols)


def _demo_7animals() -> Dict[str, Table]:
    """7 animals (3 founders), 3 traits, 5 markers (jwas_tpu :21-49)."""
    ids = ["S1", "D1", "O1", "O2", "O3", "D2", "O4"]
    pedigree = Table({"ID": ids, "Sire": ["0", "0", "S1", "S1", "S1", "0", "S1"],
                      "Dam": ["0", "0", "D1", "D1", "D2", "0", "D2"]})
    rng = np.random.default_rng(7)
    geno = rng.integers(0, 3, size=(7, 5))
    both = np.column_stack([np.asarray(ids, dtype=object), geno])
    genotypes = Table({c: both[:, j] for j, c in
                       enumerate(["ID", "m1", "m2", "m3", "m4", "m5"])})
    phenotypes = Table({
        "ID": ids,
        "y1": [100.0, 50.0, 150.0, 40.0, 90.0, 105.0, 70.0],
        "y2": [10.0, 12.9, 13.0, 5.0, 7.5, 11.0, 9.0],
        "y3": [1.0, 2.0, 2.0, 1.0, 2.0, 1.0, 2.0],
        "x1": [1.0, 2.0, 3.0, 2.5, 1.5, 2.2, 1.8],
        "x2": [1, 1, 2, 2, 1, 2, 1],
        "x3": ["m", "f", "m", "f", "m", "f", "m"],
        "dam": ["0", "0", "D1", "D1", "D2", "0", "D2"],
    })
    return {"phenotypes": phenotypes, "pedigree": pedigree, "genotypes": genotypes}


def simulate_genomic_data(n: int = 1000, p: int = 2000, n_qtl: int = 50,
                          h2: float = 0.5, seed: int = 42,
                          maf_low: float = 0.05) -> Dict[str, object]:
    """Genotypes and a quantitative trait with known truth. Returns
    'phenotypes' (Table: ID, y), 'genotypes' (Table: ID + markers),
    'true_bv' (n,), 'qtl_effects' (p,), 'h2' and 'qtl'."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(maf_low, 1 - maf_low, size=p)
    X = rng.binomial(2, freqs[None, :], size=(n, p)).astype(np.float32)
    effects = np.zeros(p)
    qtl = rng.choice(p, size=n_qtl, replace=False)
    effects[qtl] = rng.normal(0.0, 1.0, size=n_qtl)
    bv = (X - X.mean(axis=0)) @ effects
    var_g = bv.var()
    var_e = var_g * (1 - h2) / h2 if h2 > 0 else 1.0
    y = 10.0 + bv + rng.normal(0.0, np.sqrt(var_e), size=n)
    ids = [f"ind{i + 1}" for i in range(n)]
    return {"phenotypes": Table({"ID": ids, "y": y.astype(np.float64)}),
            "genotypes": _marker_table(ids, X), "true_bv": bv,
            "qtl_effects": effects, "h2": h2, "qtl": qtl}


def simulate_genomic_data_mt(n: int = 500, p: int = 400, n_qtl: int = 30, h2=(0.5, 0.3),
                             rg: float = 0.6, re: float = 0.2, seed: int = 42,
                             missing_frac: float = 0.0,
                             n_traits: int = 2) -> Dict[str, object]:
    """n_traits correlated traits with shared QTL: rg the QTL effects'
    correlation, re the residuals' (all pairs); missing_frac of trait 2's
    phenotypes missing; h2 cycled or cut to n_traits entries."""
    t = int(n_traits)
    if t < 2:
        raise ValueError("simulate_genomic_data_mt needs n_traits >= 2")
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.05, 0.95, size=p)
    X = rng.binomial(2, freqs[None, :], size=(n, p)).astype(np.float32)
    Xc = X - X.mean(axis=0)
    qtl = rng.choice(p, size=n_qtl, replace=False)
    G_eff = np.full((t, t), rg)
    np.fill_diagonal(G_eff, 1.0)
    eff = rng.multivariate_normal(np.zeros(t), G_eff, size=n_qtl)
    effects = np.zeros((p, t))
    effects[qtl] = eff
    bv = Xc @ effects
    var_g = bv.var(axis=0)
    h2v = np.resize(np.asarray(h2, dtype=np.float64), t)
    var_e = var_g * (1 - h2v) / h2v
    sd_e = np.sqrt(var_e)
    Re = re * np.outer(sd_e, sd_e)
    np.fill_diagonal(Re, var_e)
    err = rng.multivariate_normal(np.zeros(t), Re, size=n)
    mu = np.resize(np.array([5.0, -2.0, 1.0, -0.5]), t)
    y = mu[None, :] + bv + err
    ids = [f"ind{i + 1}" for i in range(n)]
    pheno = Table({"ID": ids})
    for k in range(t):
        pheno[f"y{k + 1}"] = y[:, k]
    if missing_frac > 0:
        miss = rng.uniform(size=n) < missing_frac
        pheno["y2"] = np.where(miss, np.nan, pheno["y2"])
    return {"phenotypes": pheno, "genotypes": _marker_table(ids, X), "true_bv": bv,
            "effects": effects, "Re": Re, "qtl": qtl}


def simulate_pedigree_genomic_data(n_founders: int = 60, n_gen: int = 3,
                                   n_per_gen: int = 120, p: int = 200, n_qtl: int = 20,
                                   h2: float = 0.5, seed: int = 11) -> Dict[str, object]:
    """A multi-generation pedigree with gene-dropped genotypes: founders
    Binomial(2, freq), each offspring one allele a parent (Bernoulli of the
    parent's dosage / 2, unlinked loci). Returns 'pedigree' (ID, Sire,
    Dam), 'genotypes', 'phenotypes', 'true_bv', 'ids', 'var_g' and
    'qtl_effects'."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.1, 0.9, size=p)
    X = [rng.binomial(2, freqs[None, :], size=(n_founders, p))]
    ids = [f"f{i + 1}" for i in range(n_founders)]
    sires = ["0"] * n_founders
    dams = ["0"] * n_founders
    gen_start = 0
    gen_ids = list(ids)
    for g in range(n_gen):
        prev = gen_ids
        prev_X = np.concatenate(X)[gen_start:gen_start + len(prev)]
        males = prev[:len(prev) // 2]
        females = prev[len(prev) // 2:]
        s_idx = rng.integers(0, len(males), n_per_gen)
        d_idx = rng.integers(0, len(females), n_per_gen)
        row_of = {s: i for i, s in enumerate(prev)}
        Xs = prev_X[[row_of[males[i]] for i in s_idx]]
        Xd = prev_X[[row_of[females[i]] for i in d_idx]]
        child = rng.binomial(1, Xs / 2.0) + rng.binomial(1, Xd / 2.0)
        new_ids = [f"g{g + 1}_{i + 1}" for i in range(n_per_gen)]
        ids += new_ids
        sires += [males[i] for i in s_idx]
        dams += [females[i] for i in d_idx]
        gen_start += len(prev)
        gen_ids = new_ids
        X.append(child)
    Xall = np.concatenate(X).astype(np.float32)
    effects = np.zeros(p)
    qtl = rng.choice(p, size=n_qtl, replace=False)
    effects[qtl] = rng.normal(0.0, 1.0, size=n_qtl)
    bv = (Xall - Xall.mean(axis=0)) @ effects
    var_g = bv.var()
    var_e = var_g * (1 - h2) / h2 if h2 > 0 else 1.0
    y = 3.0 + bv + rng.normal(0.0, np.sqrt(var_e), size=len(ids))
    return {"pedigree": Table({"ID": ids, "Sire": sires, "Dam": dams}),
            "genotypes": _marker_table(ids, Xall),
            "phenotypes": Table({"ID": ids, "y": y.astype(np.float64)}),
            "true_bv": bv, "ids": ids, "var_g": float(var_g), "qtl_effects": effects}


def _drop_pedigree(rng, n_founders: int, gen_sizes, p: int, freqs):
    """Gene-drop genotypes through a random multi-generation pedigree.
    Returns (ids, sires, dams, X), founders first, generations appended."""
    X = [rng.binomial(2, freqs[None, :], size=(n_founders, p))]
    ids = [str(i + 1) for i in range(n_founders)]
    sires = ["0"] * n_founders
    dams = ["0"] * n_founders
    prev_ids = list(ids)
    prev_X = X[0]
    next_id = n_founders + 1
    for size in gen_sizes:
        half = len(prev_ids) // 2
        males, females = prev_ids[:half], prev_ids[half:]
        mX, fX = prev_X[:half], prev_X[half:]
        s_idx = rng.integers(0, len(males), size)
        d_idx = rng.integers(0, len(females), size)
        child = rng.binomial(1, mX[s_idx] / 2.0) + rng.binomial(1, fX[d_idx] / 2.0)
        new_ids = [str(next_id + i) for i in range(size)]
        next_id += size
        ids += new_ids
        sires += [males[i] for i in s_idx]
        dams += [females[i] for i in d_idx]
        X.append(child)
        prev_ids, prev_X = new_ids, child
    return ids, sires, dams, np.concatenate(X).astype(np.float32)


def _scaled(bv: np.ndarray, target_var: float) -> np.ndarray:
    v = bv.var()
    return bv * np.sqrt(target_var / v) if v > 0 else bv


def _simulated_omics() -> Dict[str, Table]:
    """The analogue of JWAS's simulated_omics dataset (jwas_tpu :250-314):
    6,473 pedigree animals, the last 3,534 genotyped at 1,000 SNPs; 10
    omics layers each driven by 8 QTL in one block of 100 SNPs; trait1 =
    group + litter + direct genetic + omics + residual, total genetic h2
    ~ 0.25 split 20% direct / 80% through the omics, with the true
    genetic_direct / indirect / total columns."""
    rng = np.random.default_rng(20260818)
    p, n_geno = 1000, 3534
    gen_sizes = (1200, 1200, 1200, 1200, 1200)
    n_founders = 6473 - sum(gen_sizes)
    freqs = rng.uniform(0.05, 0.95, size=p)
    ids, sires, dams, X = _drop_pedigree(rng, n_founders, gen_sizes, p, freqs)
    n_all = len(ids)
    pedigree = Table({"ID": ids, "SIRE": sires, "DAM": dams})

    geno_rows = np.arange(n_all - n_geno, n_all)
    Xc = X - X.mean(axis=0)

    beta_d = np.zeros(p)
    qtl_d = rng.choice(p, size=30, replace=False)
    beta_d[qtl_d] = rng.normal(size=30)
    g_direct = _scaled(Xc @ beta_d, 0.2)

    n_omics, block = 10, 100
    g_omic = np.zeros((n_all, n_omics))
    for k in range(n_omics):
        beta_k = np.zeros(p)
        qtl_k = rng.choice(np.arange(k * block, (k + 1) * block), 8, replace=False)
        beta_k[qtl_k] = rng.normal(size=8)
        g_omic[:, k] = _scaled(Xc @ beta_k, 1.0)
    w = rng.normal(size=n_omics)
    g_indirect = _scaled(g_omic @ w, 0.8)
    g_total = g_direct + g_indirect
    vg = g_total.var()

    groups = rng.integers(1, 21, size=n_all)
    group_eff = rng.normal(0.0, np.sqrt(0.2 * vg), size=21)
    litters = rng.integers(1, 301, size=n_all)
    litter_eff = rng.normal(0.0, np.sqrt(0.1 * vg), size=301)
    e = rng.normal(0.0, np.sqrt(3.0 * vg - 0.3 * vg), size=n_all)
    trait1 = group_eff[groups] + litter_eff[litters] + g_total + e
    omics_obs = g_omic + rng.normal(0.0, 1.0, size=g_omic.shape)

    geno_ids = [ids[i] for i in geno_rows]
    pheno = Table({"ID": geno_ids, "trait1": trait1[geno_rows],
                   "group": groups[geno_rows], "litter": litters[geno_rows],
                   "genetic": g_direct[geno_rows]})
    for k in range(n_omics):
        pheno[f"omic{k + 1}"] = omics_obs[geno_rows, k]
    pheno["genetic_direct"] = g_direct[geno_rows]
    pheno["genetic_indirect"] = g_indirect[geno_rows]
    pheno["genetic_total"] = g_total[geno_rows]
    return {"phenotypes": pheno, "pedigree": pedigree,
            "genotypes_1000snps": _marker_table(geno_ids, X[geno_rows])}


def _simulated_annotations() -> Dict[str, Table]:
    """The analogue of JWAS's simulated_annotations fixture (jwas_tpu
    :317-388): 400 animals, 964 markers, 10 causal SNPs concentrated in the
    functional annotation class (single trait), and a 2-trait scenario
    with the inclusion states 00 / 10 / 01 / 11 driven by continuous
    annotation signals."""
    rng = np.random.default_rng(123)
    n, p = 400, 964
    freqs = rng.uniform(0.05, 0.95, size=p)
    X = rng.binomial(2, freqs[None, :], size=(n, p)).astype(np.float32)
    Xc = X - X.mean(axis=0)
    marker_ids = [f"m{j + 1}" for j in range(p)]
    ids = [f"id_{i + 1}" for i in range(n)]

    functional = (rng.uniform(size=p) < 0.15).astype(int)
    random_anno = (rng.uniform(size=p) < 0.15).astype(int)
    func_idx = np.flatnonzero(functional)
    causal = rng.choice(func_idx, size=8, replace=False)
    causal = np.concatenate([causal, rng.choice(
        np.setdiff1d(np.arange(p), func_idx), size=2, replace=False)])
    beta = np.zeros(p)
    beta[causal] = rng.normal(size=10)
    bv = _scaled(Xc @ beta, 1.0)
    y1 = bv + rng.normal(0.0, 1.0, size=n)

    annotations = Table({"marker_id": marker_ids, "functional": functional,
                         "random_anno": random_anno})
    truth = Table({"marker_id": marker_ids, "is_causal": beta != 0.0, "true_effect": beta})
    phenotypes = Table({"ID": ids, "y1": y1})

    act = rng.normal(size=p)
    plei = rng.normal(size=p)
    direction = rng.normal(size=p)
    rand_sig = rng.normal(size=p)
    z_act = 0.9 * act + 0.3 * rng.normal(size=p)
    active = z_act > np.quantile(z_act, 0.96)
    z_shared = 0.9 * plei + 0.3 * rng.normal(size=p)
    shared = active & (z_shared > np.quantile(z_shared, 0.5))
    only1 = active & ~shared & (direction > 0)
    only2 = active & ~shared & (direction <= 0)
    b1 = np.where(shared | only1, rng.normal(size=p), 0.0)
    b2 = np.where(shared, 0.7 * b1 + 0.5 * rng.normal(size=p),
                  np.where(only2, rng.normal(size=p), 0.0))
    bv1 = _scaled(Xc @ b1, 1.0)
    bv2 = _scaled(Xc @ b2, 1.0)
    y1m = bv1 + rng.normal(0.0, 1.0, size=n)
    y2m = -10.0 + bv2 + rng.normal(0.0, 1.0, size=n)
    state = np.where(shared, "11", np.where(only1, "10", np.where(only2, "01", "00")))
    annotations_mt = Table({"marker_id": marker_ids, "active_signal": act,
                            "pleiotropy_signal": plei, "direction_signal": direction,
                            "random_signal": rand_sig})
    truth_mt = Table({"marker_id": marker_ids, "state": state,
                      "is_active_y1": shared | only1, "is_active_y2": shared | only2,
                      "is_shared": shared, "true_effect_y1": b1, "true_effect_y2": b2})
    phenotypes_mt = Table({"ID": ids, "y1": y1m, "y2": y2m})
    return {"genotypes": _marker_table(ids, X, marker_ids), "annotations": annotations,
            "truth": truth, "phenotypes": phenotypes, "annotations_mt": annotations_mt,
            "truth_mt": truth_mt, "phenotypes_mt": phenotypes_mt}


GENERATORS = {"demo_7animals": _demo_7animals, "simulated_omics": _simulated_omics,
              "simulated_annotations": _simulated_annotations}


def dataset_tables(dataset_name: str = "demo_7animals") -> Dict[str, Table]:
    """The tables of a packaged dataset, made once a process."""
    if dataset_name not in _CACHE:
        if dataset_name not in GENERATORS:
            raise ValueError(f"unknown dataset {dataset_name!r}; "
                             f"options: {sorted(GENERATORS)}")
        _CACHE[dataset_name] = GENERATORS[dataset_name]()
    return _CACHE[dataset_name]


def _private_dir() -> str:
    if "root" not in _DIR:
        _DIR["root"] = tempfile.mkdtemp(prefix="jwas_tpu_torch_data_")
        atexit.register(shutil.rmtree, _DIR["root"], True)
    return _DIR["root"]


def dataset(name: str, dataset_name: Optional[str] = None) -> str:
    """The path of a packaged table's CSV file (the reference's
    dataset(file), Datasets.jl:4-12): name is one of the dataset's tables
    ("phenotypes", "pedigree", "genotypes" of demo_7animals; a suffix such
    as ".txt" is ignored), dataset_name one of "demo_7animals" (the
    default), "simulated_omics" and "simulated_annotations". The tables are
    deterministic simulations with the shapes and semantics of JWAS's data,
    not its values; with JWAS_REFERENCE_DATA pointing at a JWAS.jl
    checkout's src/4.Datasets/data directory, a file found there under
    <dataset_name>/ (as name, <name>.txt or <name>.csv) is returned as it
    is. Otherwise the table is written, once a process, into a directory
    private to the process (fault R17)."""
    ds_name = dataset_name or "demo_7animals"
    ref_root = os.environ.get("JWAS_REFERENCE_DATA", "")
    if ref_root:
        base = os.path.splitext(name)[0]
        ref_dir = os.path.join(ref_root, ds_name)
        if os.path.isdir(ref_dir):
            for cand in (name, f"{base}.txt", f"{base}.csv"):
                path = os.path.join(ref_dir, cand)
                if os.path.isfile(path):
                    return path
    tables = dataset_tables(ds_name)
    name = os.path.splitext(name)[0]
    if name not in tables:
        raise ValueError(f"unknown table {name!r}; options: {sorted(tables)}")
    path = _WRITTEN.get((ds_name, name))
    if path is None or not os.path.isfile(path):
        outdir = os.path.join(_private_dir(), ds_name)
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{name}.csv")
        fd, tmp = tempfile.mkstemp(dir=outdir, suffix=".tmp")
        os.close(fd)
        tables[name].to_csv(tmp)
        os.replace(tmp, path)
        _WRITTEN[(ds_name, name)] = path
    return path
