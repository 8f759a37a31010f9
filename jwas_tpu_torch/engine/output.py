"""Posterior summaries: accumulators -> result tables and their files.

Counterpart of jwas_tpu/engine/output.py: check_finite_posteriors (:22-34)
and build_results (:37-196) for the keys single-trait BayesC, BayesB and
BayesR on the 2-bit store produce: "location parameters", "residual
variance", "marker effects <name>", "marker effects variances <name>"
(BayesB's: the posterior mean of its variances' mean over the markers),
"pi_<name>", "ScaleEffectVar<name>", "EBV_<trait>", "genetic_variance"
and "heritability". Each is a Table with the reference's columns, written to
output_folder as <key>.txt (spaces as "_") as the reference writes it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from jwas_tpu_torch.io.table import Table


def _sd(m, m2):
    return np.sqrt(np.abs(np.asarray(m2) - np.asarray(m) ** 2))


def check_finite_posteriors(vare_m, where: str = "the chain") -> None:
    """A non-finite posterior mean of the residual variance means the
    sampler exploded: raise instead of writing inf/nan results."""
    if not np.all(np.isfinite(np.asarray(vare_m))):
        raise RuntimeError(
            f"MCMC diverged: non-finite residual-variance posterior in "
            f"{where}. Typical causes: an unstable blocked-update "
            f"configuration (too many markers updated in parallel per sync "
            f"round — lower fast_blocks / sync_every), or degenerate priors. "
        )


def _one(label, m, m2, name="Covariance") -> Table:
    return Table({name: [label], "Estimate": [float(np.asarray(m))],
                  "SD": [float(_sd(m, m2))]})


def build_results(ws, cfg, accum, samples, opts) -> Dict[str, Table]:
    """The result tables of a chain from its host-side accumulators (numpy
    fields of engine.mcmc.Accum) and saved sample tracks."""
    model = ws.model
    trait = model.lhs_vec[0]
    check_finite_posteriors(accum.vare_m)
    results: Dict[str, Table] = {}

    rows = [name.split(":", 2) for name in model.term_names()]
    sol_sd = _sd(accum.sol_m, accum.sol_m2)
    results["location parameters"] = Table({
        "Trait": [r[0] for r in rows], "Effect": [r[1] for r in rows],
        "Level": [r[2] for r in rows],
        "Estimate": [float(x) for x in accum.sol_m],
        "SD": [float(x) for x in sol_sd]})
    results["residual variance"] = _one(f"{trait}_{trait}", accum.vare_m,
                                        accum.vare_m2)

    g, p = ws.geno, cfg.n_markers
    results[f"marker effects {g.name}"] = Table({
        "Trait": np.full(p, trait, dtype=object), "Marker_ID": list(g.marker_ids),
        "Estimate": accum.alpha_m[:p], "SD": _sd(accum.alpha_m, accum.alpha_m2)[:p],
        "Model_Frequency": accum.delta_m[:p]})
    results[f"marker effects variances {g.name}"] = _one(trait, accum.varg_m,
                                                         accum.varg_m2)
    if cfg.estimate_pi and g.method == "BayesR":
        results[f"pi_{g.name}"] = Table({
            "pi": [f"class{i}" for i in range(4)], "Estimate": accum.pi_m,
            "SD": _sd(accum.pi_m, accum.pi_m2)})
    elif cfg.estimate_pi:
        results[f"pi_{g.name}"] = _one("pi", accum.pi_m, accum.pi_m2, name="pi")
    if cfg.estimate_scale:
        results[f"ScaleEffectVar{g.name}"] = _one(trait, accum.scale_m, accum.scale_m2)

    if ws.output_ids and (opts.outputEBV or opts.output_heritability):
        ebv = np.asarray(accum.ebv_m)
        results[f"EBV_{trait}"] = Table({
            "ID": list(ws.output_ids), "EBV": ebv,
            "PEV": np.abs(np.asarray(accum.ebv_m2) - ebv ** 2)})
        if opts.output_heritability:
            gv = np.asarray(samples["genvar"], dtype=np.float64)
            h2 = np.asarray(samples["h2"], dtype=np.float64)
            results["genetic_variance"] = Table({
                "Covariance": [f"{trait}_{trait}"], "Estimate": [gv.mean()],
                "SD": [gv.std()]})
            results["heritability"] = Table({
                "Covariance": [trait], "Estimate": [h2.mean()], "SD": [h2.std()]})

    if opts.output_folder:
        os.makedirs(opts.output_folder, exist_ok=True)
        for key, table in results.items():
            safe = key.replace(" ", "_").replace("*", ".")
            table.to_csv(os.path.join(opts.output_folder, safe + ".txt"))
    return results
