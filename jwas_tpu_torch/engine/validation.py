"""Fail-fast admission control: the method x feature compatibility matrix.

A copy of jwas_tpu/engine/validation.py (the reference's `errors_args`,
input_data_validation.jl:9-141): the same rules in the same order, with the
same messages, evaluated before any device work, and jwas_tpu's rule on the
phenotype table (validate_phenotypes: residual weights need a 'weights'
column). Options and methods the port does not run yet are refused
separately, after these, with NotImplementedError
(engine/setup.py::reject_unported).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np


class Rule(NamedTuple):
    check: Callable  # ctx -> bool (True = violation)
    message: str     # reference-style error text (may be a format string)


class ValidationContext(NamedTuple):
    model: object
    opts: object
    geno: object           # first marker set or None
    n_traits: int
    method: str            # "none" if no markers
    is_packed: bool
    has_annotations: bool
    has_pedigree: bool
    trait_types: tuple


def _ctx(model, opts) -> ValidationContext:
    geno = model.M[0] if model.M else None
    return ValidationContext(
        model=model,
        opts=opts,
        geno=geno,
        n_traits=model.n_models,
        method=geno.method if geno is not None else "none",
        is_packed=geno is not None and geno.packed_store is not None,
        has_annotations=geno is not None and geno.annotations is not None,
        has_pedigree=model.ped is not None or opts.pedigree is not None,
        trait_types=tuple(model.traits_type),
    )


def _pi_sum_bad(c):
    pi = c.geno.pi
    if isinstance(pi, dict):
        return abs(sum(pi.values()) - 1.0) > 0.01
    return False


def _mt_pi_scalar(c):
    pi = c.geno.pi
    return (not isinstance(pi, dict)) and np.ndim(pi) == 0 and float(pi) != 0.0


# The compatibility matrix (errors_args, input_data_validation.jl:9-141).
RULES: List[Rule] = [
    # --- GBLUP (:38-44) ---
    Rule(lambda c: c.method == "GBLUP" and c.geno.genetic_variance.val is None
         and c.geno.G.val is not None,
         "Please provide values for the genetic variance for GBLUP analysis"),
    Rule(lambda c: c.method == "GBLUP" and c.opts.single_step_analysis,
         "SSGBLUP is not available"),
    # --- BayesR (:45-66) ---
    Rule(lambda c: c.method == "BayesR" and c.n_traits != 1,
         "BayesR supports single-trait analysis only."),
    Rule(lambda c: c.method == "BayesR" and c.opts.RRM is not None,
         "BayesR does not support random regression model (RRM)."),
    # --- annotated multi-trait BayesC (:67-72) ---
    Rule(lambda c: c.has_annotations and c.method == "BayesC"
         and c.n_traits > 2,
         "Annotated multi-trait BayesC currently supports exactly 2 traits."),
    Rule(lambda c: c.has_annotations and c.n_traits > 1
         and c.geno.G.constraint,
         "Annotated multi-trait BayesC supports constraint=false only."),
    Rule(lambda c: c.has_annotations and c.opts.RRM is not None,
         "Annotated Bayes methods do not support random regression model (RRM)."),
    Rule(lambda c: c.has_annotations and c.opts.single_step_analysis,
         "Annotated Bayes methods do not support single-step analysis."),
    # --- multi-trait sampler override (:73-80) ---
    Rule(lambda c: c.geno is not None
         and getattr(c.geno, "multi_trait_sampler", "I") not in ("auto", "I", "II"),
         "multi_trait_sampler must be one of 'auto', 'I', or 'II'."),
    Rule(lambda c: c.geno is not None
         and getattr(c.geno, "multi_trait_sampler", "I") == "II"
         and c.n_traits > 1 and c.method not in ("BayesC", "BayesB"),
         "multi_trait_sampler overrides are supported for BayesC/BayesB only."),
    # --- packed 2-bit backend (:81-111; divergences documented above) ---
    Rule(lambda c: c.is_packed and c.method not in ("BayesC", "BayesB",
                                                    "BayesR"),
         "storage='2bit' supports BayesC/BayesB/BayesR only."),
    Rule(lambda c: c.is_packed and c.n_traits != 1,
         "storage='2bit' supports single-trait analysis only."),
    Rule(lambda c: c.is_packed and c.opts.double_precision,
         "storage='2bit' supports Float32 only (double_precision=False)."),
    Rule(lambda c: c.is_packed and c.opts.single_step_analysis,
         "storage='2bit' does not support single-step analysis."),
    Rule(lambda c: c.is_packed and c.opts.RRM is not None,
         "storage='2bit' does not support random regression model (RRM)."),
    Rule(lambda c: c.is_packed and c.has_annotations,
         "storage='2bit' does not support annotations."),
    Rule(lambda c: c.is_packed
         and any(tt != "continuous" for tt in c.trait_types),
         "storage='2bit' supports continuous traits only."),
    Rule(lambda c: c.is_packed and c.opts.heterogeneous_residuals,
         "storage='2bit' does not support heterogeneous residuals."),
    # --- multi-trait Pi shape (:112-119) ---
    Rule(lambda c: c.geno is not None and c.n_traits > 1
         and isinstance(c.geno.pi, dict) and _pi_sum_bad(c),
         "Summation of probabilities of Pi is not equal to one."),
    Rule(lambda c: c.geno is not None and c.n_traits > 1
         and c.method in ("BayesC", "BayesB") and _mt_pi_scalar(c),
         "Pi cannot be a number in multi-trait analysis."),
    # --- single-step (:121-123) ---
    Rule(lambda c: c.opts.single_step_analysis and c.geno is None,
         "Genomic information is required for single-step analysis."),
    Rule(lambda c: c.opts.single_step_analysis and not c.has_pedigree,
         "A pedigree is required for single-step analysis."),
    # --- causal structures / SEM (:130-132) ---
    Rule(lambda c: (c.opts.causal_structure is not None
                    or c.model.causal_structure is not None)
         and c.n_traits == 1,
         "Causal structures are only allowed in multi-trait analysis"),
    Rule(lambda c: (c.opts.causal_structure is not None
                    or c.model.causal_structure is not None)
         and any(tt != "continuous" for tt in c.trait_types),
         "Causal structures (SEM) support continuous traits only."),
    # --- estimate_scale (:134-140) ---
    Rule(lambda c: c.geno is not None and c.n_traits > 1
         and c.geno.G.estimate_scale,
         "estimate_scale=true is only supported for single trait now."),
    # --- RRM constraints (MCMC_BayesianAlphabet_RRM.jl) ---
    Rule(lambda c: c.opts.RRM is not None and c.n_traits != 1,
         "Random regression models support a single longitudinal trait."),
    Rule(lambda c: c.opts.RRM is not None and c.opts.single_step_analysis,
         "Random regression models do not support single-step analysis."),
    Rule(lambda c: c.opts.RRM is not None
         and any(tt != "continuous" for tt in c.trait_types),
         "Random regression models support continuous traits only."),
    # --- latent traits ---
    Rule(lambda c: c.opts.heterogeneous_residuals
         and any(tt in ("categorical", "categorical(binary)") for tt in c.trait_types),
         "Heterogeneous residuals are not supported for categorical traits "
         "(the liability residual variance is fixed)."),
    Rule(lambda c: c.opts.single_step_analysis
         and any(tt != "continuous" for tt in c.trait_types),
         "Single-step analysis supports continuous traits only."),
    # --- chain-length knobs ---
    Rule(lambda c: c.opts.chain_length <= 0,
         "chain_length should be an integer > 0."),
    Rule(lambda c: c.opts.burnin < 0 or c.opts.burnin >= c.opts.chain_length,
         "burnin should satisfy 0 <= burnin < chain_length."),
    Rule(lambda c: c.opts.n_chains < 1,
         "n_chains should be an integer >= 1."),
]


def validate_args(model, opts) -> None:
    """Run the full admission matrix; raise on the first violation
    (errors_args, input_data_validation.jl:9-141)."""
    if model.mme_pos not in (0, 1):
        raise ValueError("Please build your model again using build_model().")
    ctx = _ctx(model, opts)
    for rule in RULES:
        # predicates are total (every rule guards its own preconditions);
        # a raising predicate is a bug in the matrix and must surface, not
        # silently stop vetoing (tests/test_validation.py exercises every
        # rule both ways)
        if bool(rule.check(ctx)):
            raise ValueError(rule.message)

    # censored traits need their bound columns; checked against the model only
    # here (the data-frame columns are validated in prepare_workspace)
    for ti, tt in enumerate(model.traits_type):
        if tt == "censored" and model.lhs_vec[ti] in model.lhs_vec[:ti]:
            raise ValueError("duplicated censored trait names")


def validate_phenotypes(opts, columns) -> None:
    """jwas_tpu's rule on the phenotype table's columns
    (jwas_tpu/engine/setup.py:368-372): heterogeneous_residuals reads the
    residual weights from a 'weights' column."""
    if opts.heterogeneous_residuals and "weights" not in columns:
        raise ValueError(
            "heterogeneous_residuals=True requires a 'weights' column in the "
            "phenotype data frame")
