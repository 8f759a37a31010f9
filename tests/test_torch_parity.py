"""The port's BayesR against the independent NumPy chain (BASELINE.json
config 3), as tests/test_parity.py holds jwas_tpu's.

The fixed parity dataset (benchmarks/parity_common.build_bayesr_parity_
dataset: n = 40, p = 12, three causal markers) goes through the port's
runMCMC on the CPU, with the options of benchmarks/parity_run.py's engine
chain (marker variance given, no QC, no centering, seed 11) and the
single-site sampler as one block of 16 markers (the 12 and 4 padding)
swept once an iteration (fast_blocks=16, nreps=1: each marker's rhs is
kept current through the Gram rows, as the exact sweep keeps it; the
exact sweep's block of default_block_size(40) = 128 would take eight
times the steps, about 290 s a chain here), and through benchmarks/parity_numpy_chain.
numpy_bayesr_chain (seed 7), each 8,000 iterations with 2,000 burn-in, in
fixed_pi and estimate_pi modes. The summaries are compared with
tests/test_parity.py::_check_report at the calibrated 99% Monte-Carlo
bounds of benchmarks/parity_mc_error.py: sigmaSq within a relative 0.092
(fixed_pi) and 0.105 (estimate_pi; ROADMAP.md fault R6: test_parity.py
uses 0.25 there), mean nonzero frequency 0.02 and 0.055, pi 0.03.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.parity_common import (  # noqa: E402
    DEFAULT_START_PI,
    build_bayesr_parity_dataset,
    compare_parity_summaries,
    default_start_hyperparameters,
    read_parity_summary,
    write_parity_dataset,
    write_parity_summary,
)
from benchmarks.parity_run import numpy_summary_to_csvs, run_numpy_chain  # noqa: E402
from test_parity import _check_report  # noqa: E402

CHAIN_LENGTH, BURNIN = 8000, 2000
BOUNDS = {"fixed_pi": dict(sigma_rtol=0.092),
          "estimate_pi": dict(sigma_rtol=0.105, pi_atol=0.03, mnf_atol=0.055)}


def run_port_chain(datadir, *, mode, sigma_sq0, vare0, output_folder, seed=11):
    """benchmarks/parity_run.py::run_engine_chain through the port's
    runMCMC on the CPU; returns (results as DataFrames, posterior sigmaSq)."""
    import jwas_tpu_torch as jt

    geno = jt.get_genotypes(
        os.path.join(datadir, "genotypes.csv"), sigma_sq0, method="BayesR",
        Pi=np.asarray(DEFAULT_START_PI), estimatePi=mode == "estimate_pi",
        G_is_marker_variance=True, estimate_variance=True, estimate_scale=False,
        quality_control=False, center=False, name="geno", device="cpu")
    model = jt.build_model("y1 = intercept + geno", vare0, genotypes=geno)
    results = jt.runMCMC(
        model, jt.read_csv(os.path.join(datadir, "phenotypes.csv")), device="cpu",
        chain_length=CHAIN_LENGTH, burnin=BURNIN, output_samples_frequency=1,
        seed=seed, output_folder=output_folder, outputEBV=False,
        output_heritability=False, printout_model_info=False, fast_blocks=16, nreps=1)
    frames = {k: pd.DataFrame({c: v[c] for c in v.columns})
              for k, v in results.items() if not k.startswith("_")}
    return frames, float(frames["marker effects variances geno"]["Estimate"].iloc[0])


@pytest.mark.parametrize("mode", ["fixed_pi", "estimate_pi"])
def test_port_bayesr_matches_the_numpy_chain(tmp_path, mode):
    ds = build_bayesr_parity_dataset(seed=2026, n_obs=40, n_markers=12)
    vare0, sigma_sq0 = default_start_hyperparameters(ds.y, 12, 0.5)
    datadir = str(tmp_path / "data")
    write_parity_dataset(
        datadir, ids=ds.ids, marker_ids=ds.marker_ids, X=ds.X, y=ds.y,
        gamma=np.array([0.0, 0.01, 0.1, 1.0]), start_pi=DEFAULT_START_PI,
        estimate_pi=mode != "fixed_pi", chain_length=CHAIN_LENGTH, burnin=BURNIN,
        start_h2=0.5, start_sigma_sq=sigma_sq0, start_vare=vare0, seed=2026)
    port_dir = str(tmp_path / f"port_{mode}")
    results, sigma_sq = run_port_chain(datadir, mode=mode, sigma_sq0=sigma_sq0,
                                       vare0=vare0, output_folder="")
    write_parity_summary(results, port_dir, sigma_sq=sigma_sq,
                         pi_values=None if "pi_geno" in results else DEFAULT_START_PI)
    ref_dir = str(tmp_path / f"ref_{mode}")
    out, pi_values = run_numpy_chain(datadir, mode=mode, sigma_sq0=sigma_sq0,
                                     vare0=vare0, chain_length=CHAIN_LENGTH,
                                     burnin=BURNIN, marker_ids=ds.marker_ids)
    numpy_summary_to_csvs(out, pi_values, ds.marker_ids, ref_dir)
    report = compare_parity_summaries(read_parity_summary(port_dir),
                                      read_parity_summary(ref_dir))
    _check_report(report, **BOUNDS[mode])
