"""Host-side assembly: (model, phenotypes, options) -> workspace.

Counterpart of jwas_tpu/engine/setup.py: MCMCOptions (:33-103, every field
and default), Workspace (:134), _default_priors (:163-222),
_genetic2marker (:225-262), set_marker_hyperparameters (:265-284),
normalize_method (:287-297) and prepare_workspace (:348-669), on its
single-trait, continuous, 2-bit, dense-location branch: ID reconciliation,
default output IDs, the whole-data table with output-only rows, training
rows, priors, the location design and the prediction equation over fixed
terms, and the memory guard (:616-641). Everything here is numpy/scipy on
the host.

The EBVs of the output IDs are not a dense (n_out, p) decode of the store,
as jwas_tpu's are (setup.py:549-557): the workspace keeps the output IDs'
store columns, and the chain selects them from its X alpha pass over the
store (engine/mcmc.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from jwas_tpu_torch.engine.validation import validate_args
from jwas_tpu_torch.io.genotypes import Genotypes
from jwas_tpu_torch.io.table import Table, append_rows, as_table, to_numeric
from jwas_tpu_torch.models.design import build_design, stack_phenotypes
from jwas_tpu_torch.models.model import Model
from jwas_tpu_torch.ops.grouped import plan_store
from jwas_tpu_torch.ops.markers import BAYESR_GAMMA
from jwas_tpu_torch.utils.memory import (check_marker_memory_guard,
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


# option -> its one accepted value; every other value is not ported yet
_UNPORTED = {
    "n_chains": 1, "mesh": None, "checkpoint_frequency": 0, "resume": False,
    "heterogeneous_residuals": False, "double_precision": False,
    "single_step_analysis": False, "pedigree": None, "causal_structure": None,
    "RRM": None, "use_pallas": "auto",
}


def reject_unported(opts: MCMCOptions) -> None:
    """NotImplementedError naming the first option that is set to what the
    port does not run yet."""
    for name, default in _UNPORTED.items():
        value = getattr(opts, name)
        same = value is default if default is None else (
            not isinstance(value, np.ndarray) and value == default)
        if not same:
            raise NotImplementedError(
                f"runMCMC option {name}={value!r} is not ported yet (single "
                f"chain, float32, single-trait, no weights, pedigree or "
                f"checkpoints; see ROADMAP.md Queue 1)")
    if opts.sparse_location is True:
        raise NotImplementedError("runMCMC option sparse_location=True is not "
                                  "ported yet (ROADMAP.md Queue 1 item 11)")


@dataclass
class Workspace:
    model: Model
    df: Table                           # training rows
    n_obs: int
    n_traits: int
    W: np.ndarray                       # (n, K) dense location design
    y: np.ndarray                       # (n,)
    y_mask: np.ndarray                  # (n,) False where missing
    geno: Genotypes
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
                                           # output ID


def _default_priors(model: Model, df: Table) -> np.ndarray:
    """Phenotypic variance split with h^2 = 0.5
    (set_default_priors_for_variance_components,
    input_data_validation.jl:296-373); fills in missing priors on the model
    in place and returns the genetic variance matrix."""
    t = model.n_models
    myvar = np.zeros(t)
    for i, lhs in enumerate(model.lhs_vec):
        col = to_numeric(df[lhs], errors="coerce")
        col = col[np.isfinite(col)]
        myvar[i] = np.var(col, ddof=1) if len(col) > 1 else 1.0
    phenovar = np.diag(myvar)
    h2 = 0.5
    varg = phenovar * h2 / max(len(model.M), 1)
    vare = phenovar * h2
    for g in model.M:
        if g.G.val is None and g.genetic_variance.val is None:
            g.genetic_variance.val = varg[0, 0]
    if model.R.val is None:
        model.R.val = float(vare[0, 0])
        model.R.scale = model.R.val * (model.R.df - 2.0) / model.R.df
    return varg


def _genetic2marker(g: Genotypes) -> None:
    """The marker-effect variance from the genetic variance, single-trait
    (tools4genotypes.jl:426-478)."""
    if g.G.val is not None:
        return
    gv = np.asarray(g.genetic_variance.val, dtype=np.float64)
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
    """set_marker_hyperparameters_variances_and_pi, single-trait
    (tools4genotypes.jl:353-424)."""
    for g in model.M:
        _genetic2marker(g)
        gval = np.asarray(g.G.val, dtype=np.float64)
        g.G.scale = gval * (g.G.df - 1.0 - 1.0) / g.G.df
        if g.method in ("BayesB", "BayesC") and np.ndim(g.pi) == 0:
            g.pi = float(g.pi)


def normalize_method(g: Genotypes, model: Model) -> None:
    """Method shims of errors_args (input_data_validation.jl:20-44); the
    ported methods need none but BayesR's single-trait check."""
    if g.method == "BayesR" and model.n_models != 1:
        raise ValueError("BayesR supports single-trait analysis only")


def prediction_terms_of(model: Model, pe) -> List[str]:
    """The terms of a prediction equation, e.g. "herd" or "y:herd"
    (prediction_setup, output.jl:29-59); none (False) by default: the EBVs
    are then the genotypes' part alone."""
    terms: List[str] = []
    if not pe:
        return terms
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
    first column holds the IDs. device: the chain's, whose memory the
    guard measures against (None: the JAX package's 16 GiB default)."""
    df = as_table(df)
    df = Table({c: df[c] for c in df.columns})   # the caller's table stays
    id_col = df.columns[0]
    df[id_col] = np.array([str(x).strip() for x in df[id_col].tolist()], dtype=object)
    for g in model.M:
        normalize_method(g, model)
    validate_args(model, opts)
    reject_unported(opts)
    if not model.M:
        raise NotImplementedError("runMCMC without genotypes is not ported yet: "
                                  "pass genotypes=get_genotypes(..., storage='2bit')")
    g0 = model.M[0]

    # ID reconciliation (input_data_validation.jl:198-294)
    geno_ids = set(g0.obs_ids)
    keep = np.array([s in geno_ids for s in df[id_col].tolist()], dtype=bool)
    if not keep.all():
        print(f"{int((~keep).sum())} phenotyped individuals are not genotyped; removed.")
        df = df[keep]

    # default output IDs (check_outputID, input_data_validation.jl:143-196)
    if opts.outputEBV or opts.output_heritability:
        output_ids = model.output_ids
        if output_ids is None:
            output_ids = list(g0.obs_ids)
        output_ids = [s for s in output_ids if s in geno_ids]
    else:
        output_ids = []

    # whole-data table: output individuals without phenotypes appended
    df_ids = set(df[id_col].tolist())
    extra = [s for s in output_ids if s not in df_ids]
    df_whole = append_rows(df, id_col, extra) if extra else df

    # training rows: a non-missing phenotype
    t = model.n_models
    miss = np.ones((len(df_whole), t), dtype=bool)
    for i, lhs in enumerate(model.lhs_vec):
        miss[:, i] = ~np.isfinite(to_numeric(df_whole[lhs], errors="coerce"))
    train_rows = np.where(~miss.all(axis=1))[0]

    _default_priors(model, df_whole[train_rows])
    set_marker_hyperparameters(model)

    # design over the whole table, then the training rows
    X_whole = build_design(model, df_whole)
    n_whole = len(df_whole)
    row_sel = np.concatenate([m * n_whole + train_rows for m in range(t)])
    if opts.sparse_location is None and X_whole.shape[1] > 20_000:
        raise NotImplementedError(
            f"{X_whole.shape[1]} location levels: jwas_tpu would take its sparse "
            f"location path (sparse_location=None, K > 20,000), which is not "
            f"ported yet (ROADMAP.md Queue 1 item 11)")
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
        output_X[name] = np.asarray(term.X[rows, :].todense())
    for term in model.terms:
        term.X = term.X[row_sel, :]

    store = g0.packed_store
    missing_geno = [s for s in obs_ids if s not in geno_ids]
    if missing_geno:
        raise ValueError(f"individual {missing_geno[0]} has no genotypes")
    row_of = {s: i for i, s in enumerate(store.obs_ids)}

    # memory guard (jwas_tpu/engine/setup.py:616-641) over the port's own
    # device buffers, with the residence runMCMC will choose
    dev = "cpu" if device is None else device
    b, gb, _, resident = plan_store(len(obs_ids), store.packed, opts.fast_blocks,
                                    opts.host_offload_genotypes, dev)
    est = estimate_marker_memory(
        n_obs=len(obs_ids), n_markers=store.n_markers, block_size=b,
        group_blocks=gb, bytes_per_marker=store.packed.shape[1],
        n_loc=W.shape[1], resident_groups=resident)
    check_marker_memory_guard(est, policy=opts.memory_guard,
                              ratio=opts.memory_guard_ratio,
                              device=device)
    return Workspace(
        model=model, df=df_train, n_obs=len(obs_ids), n_traits=t, W=W, y=y,
        y_mask=y_mask, geno=g0,
        vare0=np.asarray(float(model.R.val)),
        scale_R=np.asarray(float(model.R.scale)), df_R=float(model.R.df),
        marker_var0=np.asarray(g0.G.val, dtype=np.float64),
        marker_scale0=np.asarray(g0.G.scale, dtype=np.float64),
        df_marker=float(g0.G.df), pi0=g0.pi, output_ids=list(output_ids),
        prediction_terms=prediction_terms, output_X=output_X, obs_ids=obs_ids,
        output_store_rows=np.array([row_of[s] for s in output_ids], dtype=np.int64),
    )
