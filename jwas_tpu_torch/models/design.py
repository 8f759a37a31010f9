"""Design matrices of the model terms, on the host with scipy.sparse.

Counterpart of jwas_tpu/models/design.py: get_term_data (:37-62),
build_term_X (:65-118), build_design (:121-135), stack_phenotypes
(:138-151) and incidence_for_ids (:154-163), reading a Table. Every
variable is a categorical fixed factor unless set_covariate made it a
covariate; an interaction "A*B" multiplies covariate values and joins
factor levels; a missing level gives an all-zero row. Fixed and i.i.d.
("I") terms number their levels in order of first appearance; a pedigree
("A") or Vinv ("V") term has the structure's levels in its order
(term.names, set by set_random), matched by any factor of an interaction.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp

from jwas_tpu_torch.io.table import Table, to_numeric
from jwas_tpu_torch.models.model import Model, ModelTerm

MISSING = "missing"


def _is_missing(x) -> bool:
    return x is None or (isinstance(x, float) and np.isnan(x)) or (
        isinstance(x, str) and x.strip() in ("", "missing", "NA", "nan"))


def get_term_data(term: ModelTerm, df: Table, model: Model) -> None:
    """Fill term.data (level strings) and term.val (build_MME.jl:183-221)."""
    n_obs = len(df)
    if term.factors[0] == "intercept":
        term.data = ["intercept"] * n_obs
        term.val = np.ones(n_obs)
        return
    strs = None
    vals = np.ones(n_obs)
    for factor in term.factors:
        if factor not in df.columns:
            raise ValueError(f"column {factor!r} not found in the phenotype data")
        col = df[factor]
        if factor in model.cov_vec:
            cv = to_numeric(col, errors="raise")
            vals = vals * np.where(np.isnan(cv), 0.0, cv)
            part = [factor] * n_obs
        else:
            part = [MISSING if _is_missing(v) else str(v) for v in col.tolist()]
        strs = part if strs is None else [f"{a} * {b}" for a, b in zip(strs, part)]
    term.data = strs
    term.val = vals


def _structured_levels(term: ModelTerm, data: List[str]) -> List[str]:
    """Each observation's level of a pedigree or Vinv term: the first
    factor of its level string that is one of term.names."""
    known = set(term.names)
    resolved = []
    for s in data:
        hit = MISSING if s == MISSING else next(
            (f for f in s.split(" * ") if f in known), None)
        if hit is None:
            raise ValueError(
                f"level {s!r} of {term.trm_str} not found in the random-effect levels")
        resolved.append(hit)
    return resolved


def build_term_X(term: ModelTerm, model: Model, start_pos: int) -> None:
    """term.X over the stacked rows (build_MME.jl:229-290)."""
    n_obs = len(term.data)
    rows = term.i_model * n_obs + np.arange(n_obs)
    vals = np.array(term.val, dtype=np.float64, copy=True)
    # any interaction containing a missing level is fully missing
    data = [MISSING if MISSING in s.split(" * ") else s for s in term.data]
    if term.random_type in ("fixed", "I"):
        level_of: dict = {}
        for s in data:
            if s != MISSING and s not in level_of:
                level_of[s] = len(level_of)
        term.names = list(level_of)
    elif term.random_type in ("V", "A"):
        level_of = {name: i for i, name in enumerate(term.names)}
        data = _structured_levels(term, data)
    else:
        raise ValueError(f"unexpected random_type {term.random_type!r}")
    term.n_levels = len(term.names)
    cols = np.zeros(n_obs, dtype=np.int64)
    for i, s in enumerate(data):
        if s == MISSING:
            vals[i] = 0.0
        else:
            cols[i] = level_of[s]
    term.X = sp.csc_matrix((vals, (rows, cols)),
                           shape=(n_obs * model.n_models, term.n_levels))
    term.X.eliminate_zeros()
    term.start_pos = start_pos


def build_design(model: Model, df: Table) -> sp.csc_matrix:
    """Every term's incidence matrix and their concatenation X, (n_obs *
    n_models, total levels); sets each term's start_pos and model.mme_pos."""
    pos = 0
    blocks = []
    for term in model.terms:
        get_term_data(term, df, model)
        build_term_X(term, model, pos)
        pos += term.n_levels
        blocks.append(term.X)
    model.mme_pos = pos
    return sp.hstack(blocks, format="csc")


def stack_phenotypes(model: Model, df: Table):
    """Stacked response vector and mask, trait-major: y[t * n_obs + i] is
    trait t of observation i; missing -> 0 with mask False."""
    ys, masks = [], []
    for lhs in model.lhs_vec:
        col = to_numeric(df[lhs], errors="coerce")
        mask = ~np.isnan(col)
        ys.append(np.where(mask, col, 0.0))
        masks.append(mask)
    return np.concatenate(ys), np.concatenate(masks)


def incidence_for_ids(target_ids: List[str], source_ids: List[str]) -> sp.csc_matrix:
    """Z with target = Z @ source (mkmat_incidence_factor,
    tools4genotypes.jl:334)."""
    index = {s: i for i, s in enumerate(source_ids)}
    try:
        cols = np.array([index[s] for s in target_ids], dtype=np.int64)
    except KeyError as e:
        raise ValueError(f"{e} is not found!") from None
    return sp.csc_matrix((np.ones(len(target_ids)), (np.arange(len(target_ids)), cols)),
                         shape=(len(target_ids), len(source_ids)))
