"""Multi-trait posterior summaries: accumulators -> result tables and their
files.

Counterpart of jwas_tpu/engine/output_mt.py (build_mt_results, output.jl:
108-212): "location
parameters", "residual variance" (trait pairs), "marker effects <name>"
(a row a trait and marker, with Model_Frequency), "marker effects
variances <name>" (BayesB: the mean over the loci of the per-locus
posterior means and SDs), "pi_<name>" (the patterns "[1.0, 0.0]"..., or
one a trait under the constraint; under annotations the mean over the
markers of the per-marker prior's posterior mean and SD), "annotation
coefficients <name>" (2-trait annotated BayesC's tree probit, by
annotation and step, :81-105), "polygenic effects covariance matrix"
and "random effect variances <term>", "EBV_<trait>" a trait,
"genetic_variance" and "heritability"; with SEM's causal structure
(SEM.jl:179-316, jwas_tpu's :139-184) "structural coefficients" (an edge
"yj->yi" a row) and "indirect marker effects <name>" and "overall marker
effects <name>" from the saved samples (indirect = sum over i < t of
C^i alpha, overall = alpha + indirect, C the sample's coefficients). GBLUP's
pseudo-markers are numbered from 1. Each is a Table with the reference's
columns, written to output_folder as <key>.txt.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from jwas_tpu_torch.engine.output import (_sd, annotation_table, check_finite_posteriors,
                                          result_marker_ids)
from jwas_tpu_torch.io.table import Table


def _cov_table(names, m, sd) -> Table:
    return Table({"Covariance": [f"{a}_{b}" for a in names for b in names],
                  "Estimate": np.asarray(m, dtype=np.float64).reshape(-1),
                  "SD": np.asarray(sd, dtype=np.float64).reshape(-1)})


def sem_tables(ws, cfg, accum, samples) -> Dict[str, Table]:
    """SEM's tables: the structural coefficients' posterior means and SDs,
    and the indirect and overall marker effects from the saved samples'
    coefficients and effects (samples["lam"], samples["alpha"], (t, p)
    each), their means and SDs over the samples."""
    traits = list(ws.model.lhs_vec)
    t, edges = cfg.n_traits, cfg.sem_edges
    out = {"structural coefficients": Table({
        "Edge": [f"{traits[j]}->{traits[i]}" for i, j in edges],
        "Estimate": np.asarray(accum.lam_m, dtype=np.float64),
        "SD": np.asarray(_sd(accum.lam_m, accum.lam_m2), dtype=np.float64)})}
    g = ws.geno
    if g is None or not samples["lam"]:
        return out
    lam = np.asarray(samples["lam"], dtype=np.float64)          # (S, m)
    alpha = np.asarray(samples["alpha"], dtype=np.float64)      # (S, t, p)
    C = np.zeros((len(lam), t, t))
    rows, cols = zip(*edges)
    C[:, rows, cols] = lam
    indirect = np.zeros_like(alpha)
    Ci = np.broadcast_to(np.eye(t), C.shape)
    for _ in range(t - 1):
        Ci = Ci @ C
        indirect += Ci @ alpha
    p = alpha.shape[2]
    for key, x in (("indirect", indirect), ("overall", alpha + indirect)):
        m = x.mean(axis=0)
        out[f"{key} marker effects {g.name}"] = Table({
            "Trait": np.repeat(np.asarray(traits, dtype=object), p),
            "Marker_ID": list(result_marker_ids(g, p)) * t,
            "Estimate": m.reshape(-1),
            "SD": np.sqrt(np.abs((x ** 2).mean(axis=0) - m ** 2)).reshape(-1)})
    return out


def build_mt_results(ws, cfg, accum, samples, opts) -> Dict[str, Table]:
    """The result tables of a multi-trait chain from its host-side
    accumulators (numpy fields of engine.mcmc_mt.MTAccum) and saved sample
    tracks."""
    check_finite_posteriors(accum.R_m, "the multi-trait chain")
    model = ws.model
    traits = list(model.lhs_vec)
    t = cfg.n_traits
    results: Dict[str, Table] = {}
    rows = [name.split(":", 2) for name in model.term_names()]
    results["location parameters"] = Table({
        "Trait": [r[0] for r in rows], "Effect": [r[1] for r in rows],
        "Level": [r[2] for r in rows],
        "Estimate": [float(x) for x in accum.sol_m],
        "SD": [float(x) for x in _sd(accum.sol_m, accum.sol_m2)]})
    results["residual variance"] = _cov_table(traits, accum.R_m,
                                              _sd(accum.R_m, accum.R_m2))
    g, p = ws.geno, cfg.n_markers
    if g is not None:
        results[f"marker effects {g.name}"] = Table({
            "Trait": np.repeat(np.asarray(traits, dtype=object), p),
            "Marker_ID": list(result_marker_ids(g, p)) * t,
            "Estimate": accum.alpha_m[:, :p].reshape(-1),
            "SD": _sd(accum.alpha_m, accum.alpha_m2)[:, :p].reshape(-1),
            "Model_Frequency": accum.delta_m[:, :p].reshape(-1)})
        vm, vsd = accum.varg_m, _sd(accum.varg_m, accum.varg_m2)
        if vm.ndim == 3:
            vm, vsd = vm[:p].mean(axis=0), vsd[:p].mean(axis=0)
        results[f"marker effects variances {g.name}"] = _cov_table(traits, vm, vsd)
        if cfg.estimate_pi or cfg.anno_steps:
            labels = (traits if cfg.constraint else
                      ["[" + ", ".join(str(float((s >> k) & 1)) for k in range(t)) + "]"
                       for s in range(2 ** t)])
            pm, psd = np.asarray(accum.pi_m), _sd(accum.pi_m, accum.pi_m2)
            if pm.ndim == 2:                 # one prior a marker
                pm, psd = pm[:p].mean(axis=0), psd[:p].mean(axis=0)
            results[f"pi_{g.name}"] = Table({"pi": labels, "Estimate": pm, "SD": psd})
        if cfg.anno_steps:
            results[f"annotation coefficients {g.name}"] = annotation_table(accum.ann_m,
                                                                            accum.ann_m2)
    for grp, m, m2 in zip(ws.re_groups, accum.vc_m, accum.vc_m2):
        key = ("polygenic effects covariance matrix" if grp.random_type == "A"
               else f"random effect variances {grp.term_array[0]}")
        results[key] = _cov_table(grp.term_array, m, _sd(m, m2))
    if ws.output_ids and (opts.outputEBV or opts.output_heritability):
        ebv = np.asarray(accum.ebv_m)
        pev = np.abs(np.asarray(accum.ebv_m2) - ebv ** 2)
        for k, trait in enumerate(traits):
            results[f"EBV_{trait}"] = Table({"ID": list(ws.output_ids), "EBV": ebv[k],
                                             "PEV": pev[k]})
        if opts.output_heritability:
            gv = np.asarray(samples["genvar"], dtype=np.float64)
            h2 = np.asarray(samples["h2"], dtype=np.float64)
            results["genetic_variance"] = _cov_table(traits, gv.mean(axis=0),
                                                     gv.std(axis=0))
            results["heritability"] = Table({"Covariance": traits,
                                             "Estimate": h2.mean(axis=0),
                                             "SD": h2.std(axis=0)})
    if cfg.sem_edges:
        results.update(sem_tables(ws, cfg, accum, samples))
    if opts.output_folder:
        os.makedirs(opts.output_folder, exist_ok=True)
        for key, table in results.items():
            safe = key.replace(" ", "_").replace("*", ".")
            table.to_csv(os.path.join(opts.output_folder, safe + ".txt"))
    return results
