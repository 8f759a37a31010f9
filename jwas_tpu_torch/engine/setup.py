"""Host-side assembly: (model, phenotypes, options) -> workspace.

Counterpart of jwas_tpu/engine/setup.py: MCMCOptions (:33-103, every field
and default), REGroupData (:119), Workspace (:134), _default_priors
(:163-222), _genetic2marker (:225-262), set_marker_hyperparameters
(:265-284), normalize_method (:287-297) and prepare_workspace (:348-669),
for the 2-bit and the dense stores, GBLUP's relationship matrix and
models without genotypes, on the dense location path or, for a single
trait above 20,000 location levels or with sparse_location=True, the
sparse one (:445-467: the design kept as scipy CSR, the groups' Vinv and
the prediction rows sparse), with single-step's set-up (ssbr_setup,
engine/single_step.py: the dense store of the data's individuals imputed,
J and epsilon added), with
random-effect groups, single-trait and multi-trait (t x t residual and
marker-effect priors, the joint pattern Pi; BayesC, BayesB, RR-BLUP,
BayesL and GBLUP on dense stores or a relationship matrix, models without
genotypes, SEM's causal structure, sem_edges): ID reconciliation (phenotyped
individuals without genotypes, or not in the pedigree, are removed),
default output IDs (the genotyped individuals, else the pedigree's), the
whole-data table with output-only rows, training rows, priors, the
location design and the prediction equation (by default the pedigree's
terms), the random-effect groups with dense Vinv (:569-600), the residual
weights rinv = 1 / weights (:512-516), GBLUP's eigendecomposition
(:521-535; in float64 by torch.linalg.eigh on the chain's device,
ops/gblup.py::gblup_eigen) and the memory guard (:616-641). Everything
else here is numpy/scipy on the host.

The EBVs of the output IDs are not a dense (n_out, p) matrix of their
genotypes, as jwas_tpu's are (setup.py:549-567): the workspace keeps the
output IDs' store columns, and the chain selects them from its X alpha
pass over the store (engine/mcmc.py). Nor is the dense store copied to the
training rows (aligned_to, :558): the chain finds them through a row
permutation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from jwas_tpu_torch.engine.validation import validate_args, validate_phenotypes
from jwas_tpu_torch.io.genotypes import Genotypes
from jwas_tpu_torch.io.table import Table, append_rows, as_table, to_numeric
from jwas_tpu_torch.models.design import build_design, stack_phenotypes
from jwas_tpu_torch.models.model import Model
from jwas_tpu_torch.ops import location
from jwas_tpu_torch.ops.gblup import gblup_eigen
from jwas_tpu_torch.ops.grouped import plan_store
from jwas_tpu_torch.ops.markers import BAYESR_GAMMA, dense_blocks
from jwas_tpu_torch.utils.memory import (check_marker_memory_guard,
                                         estimate_dense_memory,
                                         estimate_gblup_memory,
                                         estimate_imputation_memory,
                                         estimate_marker_memory)


@dataclass
class MCMCOptions:
    """Keyword options of `runMCMC` (reference JWAS.jl:161-202); the same
    fields and defaults as jwas_tpu's. Those outside the ported slice must
    keep their defaults (reject_unported)."""

    chain_length: int = 100
    burnin: int = 0
    output_samples_frequency: int = 0   # 0 -> chain_length / 1000, at least 1
    seed: Optional[int] = None
    double_precision: bool = False
    fast_blocks: object = False         # False | True | int block size
    nreps: Optional[int] = None         # sweeps an outer iteration (default b)
    outputEBV: bool = True
    output_heritability: bool = True
    output_folder: str = "results"
    output_marker_samples: bool = False
    heterogeneous_residuals: bool = False
    missing_phenotypes: bool = True
    constraint: bool = False
    single_step_analysis: bool = False
    fitting_J_vector: bool = True
    pedigree: object = None
    causal_structure: object = None
    RRM: object = None
    update_priors_frequency: int = 0
    printout_model_info: bool = True
    printout_frequency: int = 0         # progress line every K iterations
    profile: bool = False               # torch.profiler trace of the chain
                                        # under <output_folder>/profile
    starting_value: object = None
    mesh: object = None
    memory_guard: str = "warn"
    host_offload_genotypes: object = "auto"
    memory_guard_ratio: float = 0.9
    n_chains: int = 1
    output_chain_samples: bool = False
    use_pallas: object = "auto"
    sync_every: Optional[int] = None    # reps between residual syncs
                                        # (default min(8, nreps))
    independent_blocks: bool = False    # sync once an outer iteration
    checkpoint_frequency: int = 0
    checkpoint_folder: Optional[str] = None
    checkpoint_keep: int = 3
    resume: bool = False
    prediction_equation: object = False  # EBV terms, e.g. "herd"; False =
                                         # the genotypes only
    sparse_location: object = None
    cg_maxiter: int = 200


# option -> (its one accepted value, the part of ROADMAP.md that brings
# the others)
_UNPORTED = {
    "mesh": (None, "multi-GPU"),
    "checkpoint_frequency": (0, "ops layer: checkpoint and resume"),
    "resume": (False, "ops layer: checkpoint and resume"),
    "use_pallas": ("auto", "ground rules for the port"),
}
SPARSE_LEVELS = 20_000      # a single-trait model above this many location
                            # levels takes the sparse path on its own


def not_ported(what: str, label: str) -> NotImplementedError:
    """The refusal of what the port does not run yet, naming the part of
    ROADMAP.md (a heading or an item's title) that brings it."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {label})")


def resolve_device(device) -> torch.device:
    """The chain's device: the GPU unless the caller asks for another; a
    missing GPU raises (the CPU is never taken silently)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false); pass "
            "device='cpu' to run the plain versions on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def reject_unported(opts: MCMCOptions) -> None:
    """NotImplementedError naming the first option that is set to what the
    port does not run yet."""
    for name, (default, label) in _UNPORTED.items():
        value = getattr(opts, name)
        same = value is default if default is None else (
            not isinstance(value, np.ndarray) and value == default)
        if not same:
            raise not_ported(f"runMCMC option {name}={value!r}", label)


def sem_edges(opts: MCMCOptions, model: Model, t: int,
              pattern_masks) -> Tuple[Tuple[int, int], ...]:
    """SEM's causal edges (SEM_setup, SEM.jl:53-62; jwas_tpu/engine/
    mcmc_mt.py:830-850): the option's causal_structure, else the model's;
    a (t, t) lower-triangular 0/1 matrix whose entry (i, j) = 1 puts trait
    j's phenotype in trait i's equation, with no missing phenotype (every
    missing pattern observes every trait). The edges in row-major order,
    () without a structure; the model keeps the matrix, as jwas_tpu's
    does."""
    causal = opts.causal_structure
    if causal is None:
        causal = model.causal_structure
    if causal is None or causal is False:
        return ()
    causal = np.asarray(causal, dtype=np.float64)
    if causal.shape != (t, t):
        raise ValueError(f"causal_structure must be {t}x{t}")
    if np.any(np.triu(causal) != 0):
        raise ValueError("the causal structure needs to be a lower triangular matrix")
    if not np.all(np.isin(causal, (0.0, 1.0))):
        raise ValueError("causal_structure entries must be 0 or 1")
    if not all(all(row) for row in pattern_masks):
        raise ValueError("missing phenotypes are not allowed in SEM")
    model.causal_structure = causal
    return tuple((i, j) for i in range(t) for j in range(t) if causal[i, j] == 1.0)


@dataclass
class REGroupData:
    """A random-effect group as the chain sees it."""

    starts: Tuple[int, ...]             # first location column of each term
    n_levels: int                       # q, shared by the terms
    Vinv: Optional[np.ndarray]          # dense (q, q), scipy CSR on the
                                        # sparse location path; None: the
                                        # identity
    G0: np.ndarray                      # (k, k) starting covariance
    df: float
    scale: np.ndarray                   # (k, k) prior scale
    term_array: List[str]
    random_type: str                    # "A" | "V" | "I"
    estimate_variance: bool = True
    Vinv_factor: object = None          # scipy F with Vinv = F'F, or None


@dataclass
class Workspace:
    model: Model
    df: Table                           # training rows
    n_obs: int
    n_traits: int
    W: np.ndarray                       # (n, K) dense location design
    y: np.ndarray                       # (n,)
    y_mask: np.ndarray                  # (n,) False where missing
    geno: Optional[Genotypes]           # None: no genotypes (method "none")
    vare0: np.ndarray
    scale_R: np.ndarray
    df_R: float
    marker_var0: np.ndarray
    marker_scale0: np.ndarray
    df_marker: float
    pi0: object
    output_ids: List[str]
    prediction_terms: List[str]
    output_X: Dict[str, np.ndarray]     # term -> dense (n_out, n_levels)
    obs_ids: List[str] = field(default_factory=list)
    output_store_rows: np.ndarray = None   # (n_out,) store column of each
                                           # output ID (GBLUP: the output
                                           # map's row; None without
                                           # genotypes)
    re_groups: List[REGroupData] = field(default_factory=list)
    rinv: Optional[np.ndarray] = None      # (n,) inverse residual weights
    gblup_L: Optional[torch.Tensor] = None    # GBLUP (ops/gblup.py): (n, n)
    gblup_D: Optional[torch.Tensor] = None    # eigenvectors over the training
    gblup_out: Optional[torch.Tensor] = None  # rows, |eigenvalues|, (n_out, n)
                                              # output map, in the chain's dtype
    W_sparse: object = None             # the sparse location path: scipy
                                        # CSR (n, K) design; W is then (n, 0)
    ssbr: Optional[dict] = None         # single-step's set-up seconds and
                                        # imputation (ssbr_setup)

    @property
    def n_loc(self) -> int:
        """K, the location parameters."""
        return (self.W if self.W_sparse is None else self.W_sparse).shape[1]


def _default_priors(model: Model, df: Table) -> np.ndarray:
    """Phenotypic variance split with h^2 = 0.5
    (set_default_priors_for_variance_components,
    input_data_validation.jl:296-373): the genetic half over the marker
    sets and pedigree groups, the other half over the residual and the
    other random-effect groups. Fills in missing priors on the model in
    place and returns the genetic variance matrix."""
    t = model.n_models
    myvar = np.zeros(t)
    for i, lhs in enumerate(model.lhs_vec):
        col = to_numeric(df[lhs], errors="coerce")
        col = col[np.isfinite(col)]
        myvar[i] = np.var(col, ddof=1) if len(col) > 1 else 1.0
    phenovar = np.diag(myvar)
    h2 = 0.5
    genetic_count = len(model.M) + sum(re.random_type == "A" for re in model.random_effects)
    nongenetic_count = 1 + sum(re.random_type != "A" for re in model.random_effects)
    varg = phenovar * h2 / max(genetic_count, 1)
    vare = phenovar * h2 / nongenetic_count
    for g in model.M:
        if g.G.val is None and g.genetic_variance.val is None:
            g.genetic_variance.val = varg[0, 0] if t == 1 else varg
    # a latent trait's residual (jwas_tpu/engine/setup.py:192-207): a
    # single-trait categorical one is 1 and not estimated; a binary trait's
    # row and column of R are the unit vector
    is_cat = model.traits_type in (["categorical"], ["categorical(binary)"])
    if model.R.val is None and t == 1:
        model.R.val = 1.0 if is_cat else float(vare[0, 0])
        model.R.scale = model.R.val * (model.R.df - 2.0) / model.R.df
        if is_cat:
            model.R.estimate_variance = False
    elif model.R.val is None:
        vmat = vare.copy()
        for i, tt in enumerate(model.traits_type):
            if tt == "categorical(binary)":
                vmat[i, :] = vmat[:, i] = 0.0
                vmat[i, i] = 1.0
        model.R.val = vmat
        model.R.scale = vmat * (model.R.df - t - 1.0)
    for re in model.random_effects:
        if re.G.val is None:
            k = len(re.term_array)
            base = varg if re.random_type == "A" else vare
            traits = [model.lhs_vec.index(term.split(":")[0]) for term in re.term_array]
            G = np.diag([base[i, i] for i in traits])
            re.G.val = G
            re.G.scale = G * (re.G.df - k - 1.0)
    return varg


def _genetic2marker(g: Genotypes, t: int = 1) -> None:
    """The marker-effect variance from the genetic variance
    (tools4genotypes.jl:426-478); GBLUP's is the genetic variance.
    Multi-trait: G_ij / (sum2pq times the prior mass of the patterns that
    include traits i and j)."""
    if g.G.val is not None:
        return
    gv = np.asarray(g.genetic_variance.val, dtype=np.float64)
    if g.method == "GBLUP":
        g.G.val = gv
        return
    if t > 1:
        denom = np.full((t, t), g.sum2pq)
        if isinstance(g.pi, dict):
            for i in range(t):
                for j in range(i, t):
                    tot = sum(v for pat, v in g.pi.items()
                              if pat[i] == 1.0 and pat[j] == 1.0)
                    denom[i, j] = denom[j, i] = g.sum2pq * tot
        g.G.val = gv / denom
        return
    if g.method == "BayesR":
        pi = np.asarray(g.pi, dtype=np.float64)
        denom = g.sum2pq * float(np.sum(np.asarray(BAYESR_GAMMA) * pi))
        if denom <= 0:
            raise ValueError("BayesR implied variance denominator must be positive")
    elif np.ndim(g.pi) == 0:
        denom = (1.0 - float(g.pi)) * g.sum2pq
    else:
        # per-marker pi: 2pq-weighted inclusion (tools4genotypes.jl:461-477)
        include = 1.0 - np.clip(np.asarray(g.pi, dtype=np.float64), 0.0, 1.0)
        twopq = 2.0 * g.allele_freq * (1.0 - g.allele_freq)
        denom = float(np.sum(twopq * include))
    g.G.val = gv / denom


def set_marker_hyperparameters(model: Model) -> None:
    """set_marker_hyperparameters_variances_and_pi
    (tools4genotypes.jl:353-424). Multi-trait: a Pi of 0 becomes the
    pattern dict in which every marker affects every trait, and the scale
    is G (df - t - 1)."""
    t = model.n_models
    for g in model.M:
        if (t > 1 and not isinstance(g.pi, dict) and np.ndim(g.pi) == 0
                and g.pi == 0.0 and g.method not in ("RR-BLUP", "BayesL")):
            g.pi = {tuple(float(c) for c in np.binary_repr(s, t)): 0.0
                    for s in range(2 ** t)}
            g.pi[(1.0,) * t] = 1.0
        _genetic2marker(g, t)
        gval = np.asarray(g.G.val, dtype=np.float64)
        if t == 1:
            g.G.scale = gval * (g.G.df - 1.0 - 1.0) / g.G.df
        else:
            g.G.scale = gval * (g.G.df - t - 1.0)
        if t == 1 and g.method in ("BayesB", "BayesC") and np.ndim(g.pi) == 0:
            g.pi = float(g.pi)


def normalize_method(g: Genotypes, model: Model) -> None:
    """Method shims of errors_args (input_data_validation.jl:20-44): RR-BLUP,
    BayesL and GBLUP have pi 0 and estimate none; BayesA is BayesB with pi
    0, not estimated; BayesR is single-trait."""
    if g.method in ("RR-BLUP", "BayesL", "GBLUP", "BayesA"):
        g.estimate_pi = False
        if g.method != "BayesA":
            g.pi = 0.0
    if g.method == "BayesA":
        g.method = "BayesB"
        g.pi = 0.0
    if g.method == "BayesR" and model.n_models != 1:
        raise ValueError("BayesR supports single-trait analysis only")


def add_censored_trait_columns(model: Model, df: Table) -> None:
    """A censored trait's column from its bounds <name>_l and <name>_u
    (_add_censored_trait_columns, jwas_tpu/engine/setup.py:300-328;
    add_censored_trait_column!, categorical_and_censored_trait.jl:263-296):
    the bound that is finite where one is, a uniform point between them
    (numpy's default_rng(0)) where both are, missing where neither is; a
    missing bound becomes infinite. In place."""
    rng = np.random.default_rng(0)
    for ti, tt in enumerate(model.traits_type):
        if tt != "censored":
            continue
        name = model.lhs_vec[ti]
        for suffix in ("_l", "_u"):
            if f"{name}{suffix}" not in df.columns:
                raise ValueError(f"censored trait {name} requires columns {name}_l and "
                                 f"{name}_u in the phenotype data frame")
        lo = to_numeric(df[f"{name}_l"], errors="coerce")
        hi = to_numeric(df[f"{name}_u"], errors="coerce")
        both_missing = np.isnan(lo) & np.isnan(hi)
        lo = np.where(np.isnan(lo), -np.inf, lo)
        hi = np.where(np.isnan(hi), np.inf, hi)
        y = np.where(np.isinf(lo) & np.isinf(hi), np.nan,
                     np.where(np.isinf(lo), hi,
                              np.where(np.isinf(hi), lo,
                                       lo + rng.uniform(size=len(lo)) * (hi - lo))))
        df[name] = np.where(both_missing, np.nan, y)
        df[f"{name}_l"] = lo
        df[f"{name}_u"] = hi


def detect_binary_traits(model: Model, df: Table) -> None:
    """A categorical trait must use the categories 1..K; K = 2 makes it
    "categorical(binary)" (_detect_binary_traits, jwas_tpu/engine/
    setup.py:331-345; input_data_validation.jl:258-274). In place on the
    model."""
    for ti, tt in enumerate(model.traits_type):
        if tt != "categorical":
            continue
        name = model.lhs_vec[ti]
        vals = to_numeric(df[name], errors="coerce")
        cats = sorted(set(int(v) for v in vals[np.isfinite(vals)] if int(v) != 0))
        if cats != list(range(1, len(cats) + 1)):
            raise ValueError(f"categorical trait {name} must use categories 1..K; "
                             f"got {cats}")
        if len(cats) == 2:
            model.traits_type[ti] = "categorical(binary)"


def prediction_terms_of(model: Model, pe) -> List[str]:
    """The terms of a prediction equation, e.g. "herd" or "y:herd"
    (prediction_setup, output.jl:29-59); by default (False) the pedigree's
    terms (model.ped_term_vec), which the EBVs add to the genotypes' part."""
    terms: List[str] = []
    if not pe:
        return list(model.ped_term_vec)
    for tok in str(pe).split("+"):
        tok = tok.strip()
        if not tok:
            continue
        cands = [tok] if ":" in tok else [f"{lhs}:{tok}" for lhs in model.lhs_vec]
        found = [c for c in cands if c in model.term_dict]
        if not found:
            raise ValueError(f"term {tok!r} in the prediction equation is not found")
        terms.extend(c for c in found if c not in terms)
    return terms


def prepare_workspace(model: Model, df, opts: MCMCOptions,
                      device=None) -> Workspace:
    """The set-up pipeline of runMCMC (JWAS.jl:272-459) for the ported
    slice; df is a Table, a {name: array} mapping or a DataFrame whose
    first column holds the IDs. The options are checked first: the JAX
    package's ValueErrors (validate_args, validate_phenotypes), then
    NotImplementedError for what the port does not run (reject_unported).
    device: the chain's (resolve_device, after those checks), whose memory
    the guard measures against (None: the JAX package's 16 GiB default)."""
    df = as_table(df)
    df = Table({c: df[c] for c in df.columns})   # the caller's table stays
    id_col = df.columns[0]
    df[id_col] = np.array([str(x).strip() for x in df[id_col].tolist()], dtype=object)
    add_censored_trait_columns(model, df)
    detect_binary_traits(model, df)
    if opts.pedigree is not None and model.ped is None:
        model.ped = opts.pedigree
    for g in model.M:
        normalize_method(g, model)
    validate_args(model, opts)
    validate_phenotypes(opts, df.columns)
    t = model.n_models
    if opts.sparse_location is True and (
            t != 1 or opts.RRM is not None or opts.causal_structure is not None):
        raise ValueError(
            "sparse_location=True supports single-trait (non-RRM, non-SEM) "
            "models only; multi-trait/RRM/SEM MMEs use the dense location path")
    reject_unported(opts)
    if device is not None:
        device = resolve_device(device)
    g0 = model.M[0] if model.M else None

    # ID reconciliation (input_data_validation.jl:198-294); single-step
    # keeps the non-genotyped
    ssbr = bool(opts.single_step_analysis)
    geno_ids = set(g0.obs_ids) if g0 is not None else None
    if g0 is not None and not ssbr:
        keep = np.array([s in geno_ids for s in df[id_col].tolist()], dtype=bool)
        if not keep.all():
            print(f"{int((~keep).sum())} phenotyped individuals are not genotyped; removed.")
            df = df[keep]
    if model.ped is not None:
        keep = np.array([s in model.ped.id_index for s in df[id_col].tolist()], dtype=bool)
        if not keep.all():
            print(f"{int((~keep).sum())} phenotyped individuals are not in the pedigree; "
                  f"removed.")
            df = df[keep]

    # default output IDs (check_outputID, input_data_validation.jl:143-196)
    if opts.outputEBV or opts.output_heritability:
        output_ids = model.output_ids
        if output_ids is None and g0 is not None and ssbr and opts.output_heritability:
            output_ids = list(model.ped.ids)        # every pedigree member (:170-174)
        elif output_ids is None and g0 is not None:
            output_ids = list(g0.obs_ids)
        elif output_ids is None and model.ped is not None:
            output_ids = list(model.ped.ids)
        elif output_ids is None and opts.prediction_equation:
            output_ids = list(dict.fromkeys(str(x) for x in df[id_col].tolist()))
        elif output_ids is None:
            output_ids = []
        if g0 is not None and not ssbr:
            output_ids = [s for s in output_ids if s in geno_ids]
        elif model.ped is not None:
            output_ids = [s for s in output_ids if s in model.ped.id_index]
    else:
        output_ids = []

    # whole-data table: output individuals without phenotypes appended
    df_ids = set(df[id_col].tolist())
    extra = [s for s in output_ids if s not in df_ids]
    df_whole = append_rows(df, id_col, extra) if extra else df

    # training rows: at least one non-missing phenotype
    miss = np.ones((len(df_whole), t), dtype=bool)
    for i, lhs in enumerate(model.lhs_vec):
        miss[:, i] = ~np.isfinite(to_numeric(df_whole[lhs], errors="coerce"))
    train_rows = np.where(~miss.all(axis=1))[0]

    _default_priors(model, df_whole[train_rows])
    ssbr_info = None
    if ssbr:
        # genotypes imputed, J and epsilon added (engine/single_step.py)
        from jwas_tpu_torch.engine.single_step import ssbr_setup

        def imputation_guard(nn, chunk, rows):
            """The memory guard at the imputation's peak, before it allocates."""
            X = g0.dense
            est = estimate_imputation_memory(
                n_markers=X.shape[0], n_geno=X.shape[1], n_rows=rows, n_nongeno=nn,
                chunk=chunk, store_itemsize=X.element_size())
            check_marker_memory_guard(est, policy=opts.memory_guard,
                                      ratio=opts.memory_guard_ratio,
                                      device=X.device if X.device.type == "cuda" else None)

        ssbr_info = ssbr_setup(model, df_whole, opts, check_memory=imputation_guard)
    set_marker_hyperparameters(model)

    # design over the whole table, then the training rows
    X_whole = build_design(model, df_whole)
    n_whole = len(df_whole)
    row_sel = np.concatenate([m * n_whole + train_rows for m in range(t)])
    K = X_whole.shape[1]
    # the sparse location path (jwas_tpu/engine/setup.py:445-467): auto for
    # a single trait above SPARSE_LEVELS levels, not RRM, not SEM
    sparse = bool(opts.sparse_location is True or (
        opts.sparse_location is None and t == 1 and K > SPARSE_LEVELS
        and opts.RRM is None and opts.causal_structure is None))
    limit = 0 if device is None or sparse else location.pass_limit(
        device, torch.float64 if opts.double_precision else torch.float32)
    if limit and K > limit:
        raise not_ported(
            f"{K} location parameters on the dense location path: the location "
            f"pass (K6) takes at most {limit} on {device}, and a dense model above "
            f"that", "a location pass above K6's limit")
    W_sparse = None
    if sparse:
        W_sparse = X_whole[row_sel, :].tocsr()      # never made dense
        W = np.zeros((len(row_sel), 0))
    else:
        W = np.asarray(X_whole[row_sel, :].todense())
    df_train = df_whole[train_rows]
    obs_ids = [str(x) for x in df_train[id_col].tolist()]
    y, y_mask = stack_phenotypes(model, df_train)

    # prediction equation and output incidence (output.jl:29-59)
    prediction_terms = prediction_terms_of(model, opts.prediction_equation)
    id_rows: Dict[str, int] = {}
    for i, s in enumerate(df_whole[id_col].tolist()):
        id_rows.setdefault(str(s), i)
    output_X = {}
    for name in prediction_terms:
        term = model.term_dict[name]
        rows = [term.i_model * n_whole + id_rows[s] for s in output_ids]
        Xt = term.X[rows, :]
        output_X[name] = Xt.tocsr() if sparse else np.asarray(Xt.todense())
    for term in model.terms:
        term.X = term.X[row_sel, :]

    # residual weights (jwas_tpu/engine/setup.py:512-516)
    rinv = None
    if opts.heterogeneous_residuals:
        w = to_numeric(df_train["weights"], errors="raise").astype(np.float64)
        rinv = 1.0 / w

    # random-effect groups (jwas_tpu/engine/setup.py:569-600), Vinv dense
    # (scipy CSR on the sparse path)
    re_groups = []
    for re in model.random_effects:
        terms = [model.term_dict[s] for s in re.term_array]
        q = terms[0].n_levels
        if any(trm.n_levels != q for trm in terms):
            raise ValueError("terms in one random-effect group must share levels")
        re_groups.append(REGroupData(
            starts=tuple(trm.start_pos for trm in terms), n_levels=q,
            Vinv=None if re.Vinv is None else (
                re.Vinv.tocsr() if sparse else np.asarray(re.Vinv.todense())),
            Vinv_factor=re.Vinv_factor,
            G0=np.asarray(re.G.val, dtype=np.float64), df=float(re.G.df),
            scale=np.asarray(re.G.scale, dtype=np.float64),
            term_array=list(re.term_array), random_type=re.random_type,
            estimate_variance=bool(re.G.estimate_variance)))

    as_prior = (lambda v: np.asarray(float(np.asarray(v).reshape(-1)[0]))) if t == 1 else (
        lambda v: np.asarray(v, dtype=np.float64))
    common = dict(
        model=model, df=df_train, n_obs=len(obs_ids), n_traits=t, W=W, y=y,
        y_mask=y_mask, geno=g0, vare0=as_prior(model.R.val),
        scale_R=as_prior(model.R.scale), df_R=float(model.R.df),
        output_ids=list(output_ids), prediction_terms=prediction_terms,
        output_X=output_X, obs_ids=obs_ids, rinv=rinv, re_groups=re_groups,
        W_sparse=W_sparse, ssbr=ssbr_info)
    n_loc = K
    # the sparse path's design: its CSR structures (the PO draw's and the
    # prediction rows), not a dense (n, K)
    design_bytes = None if not sparse else 24 * (W_sparse.nnz + sum(
        0 if grp.Vinv is None else grp.Vinv.nnz + grp.Vinv.shape[0]
        for grp in re_groups))
    if g0 is None:
        return Workspace(marker_var0=np.asarray(0.0), marker_scale0=np.asarray(0.0),
                         df_marker=4.0, pi0=None, **common)

    geno_ids = set(g0.obs_ids)            # single-step: now every row's
    missing_geno = [s for s in obs_ids if s not in geno_ids]
    if missing_geno:
        raise ValueError(f"individual {missing_geno[0]} has no genotypes")
    row_of = {s: i for i, s in enumerate(g0.obs_ids)}

    # memory guard (jwas_tpu/engine/setup.py:616-641) over the port's own
    # device buffers, with the residence runMCMC will choose
    dev = "cpu" if device is None else device
    itemsize = 8 if opts.double_precision else 4
    if g0.grm is not None:
        est = estimate_gblup_memory(
            n_geno=g0.grm.shape[0], n_obs=len(obs_ids), n_out=len(output_ids),
            n_loc=n_loc, itemsize=itemsize, grm_itemsize=g0.grm.element_size(),
            design_bytes=design_bytes)
    elif g0.dense is not None:
        b, gb, _ = dense_blocks(len(obs_ids), opts.fast_blocks, g0.n_markers)
        est = estimate_dense_memory(
            n_store=g0.dense.shape[1], n_obs=len(obs_ids), n_markers=g0.n_markers,
            block_size=b, group_blocks=gb, n_loc=n_loc,
            itemsize=itemsize, store_itemsize=g0.dense.element_size(),
            method=g0.method, design_bytes=design_bytes)
    else:
        store = g0.packed_store
        b, gb, _, resident = plan_store(len(obs_ids), store.packed, opts.fast_blocks,
                                        opts.host_offload_genotypes, dev)
        est = estimate_marker_memory(
            n_obs=len(obs_ids), n_markers=store.n_markers, block_size=b,
            group_blocks=gb, bytes_per_marker=store.packed.shape[1],
            n_loc=n_loc, resident_groups=resident, design_bytes=design_bytes)
    check_marker_memory_guard(est, policy=opts.memory_guard,
                              ratio=opts.memory_guard_ratio,
                              device=device)
    gblup = {}
    output_store_rows = np.array([row_of[s] for s in output_ids], dtype=np.int64)
    if g0.grm is not None:
        # the eigenbasis of the training rows' block of G; the EBVs are the
        # output map's rows, in output order
        L, D, out = gblup_eigen(
            g0.grm if device is None else g0.grm.to(device),
            [row_of[s] for s in obs_ids], output_store_rows,
            torch.float64 if opts.double_precision else torch.float32)
        gblup = dict(gblup_L=L, gblup_D=D, gblup_out=out)
        output_store_rows = np.arange(len(output_ids), dtype=np.int64)
    return Workspace(
        marker_var0=np.asarray(g0.G.val, dtype=np.float64),
        marker_scale0=np.asarray(g0.G.scale, dtype=np.float64),
        df_marker=float(g0.G.df), pi0=g0.pi,
        output_store_rows=output_store_rows, **common, **gblup,
    )
