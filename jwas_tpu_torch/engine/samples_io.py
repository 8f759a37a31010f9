"""Per-parameter MCMC sample files in the reference text format.

Counterpart of jwas_tpu/engine/samples_io.py: MARKER_FILE_MAX_P and
resolve_write_markers (:29-43), MCMCSampleWriter (:46-91) and the
single-trait STSampleStream (:98-216) for BayesC, BayesB and BayesR on the
2-bit store. One comma-separated file per parameter, MCMC_samples_<var>.txt
under the output folder (":" replaced by "."), with the reference's header
row where it writes one and one row per saved sample:
residual_variance, <trait>.<term> (terms requested by outputMCMCsamples),
marker_effects_<geno>_<trait>, marker_effects_variances_<geno>,
pi_<geno>, EBV_<trait>, genetic_variance, heritability. BayesB's
marker_effects_variances_<geno> row holds every marker's variance when the
marker effects are written, else their mean (jwas_tpu's :190-195).

A sample arrives as host arrays read back in one transfer
(engine/mcmc.py::_read_back); the stream says which of sol, alpha (with
BayesB's per-marker variances) and the EBVs it needs (loc_slices,
write_markers, ebv).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# marker-effect sample files grow as p * n_saved; above this marker count the
# file is skipped unless the user explicitly asks (output_marker_samples=True)
MARKER_FILE_MAX_P = 200_000


def resolve_write_markers(p: int, output_marker_samples) -> bool:
    """Decide (and announce) whether per-marker sample files are written."""
    if bool(output_marker_samples) or p <= MARKER_FILE_MAX_P:
        return True
    print(
        f"NOTE: marker-effect sample files are skipped at p={p:,} markers "
        f"(> {MARKER_FILE_MAX_P:,}; the files grow as p x saved samples). "
        f"Pass output_marker_samples=True to runMCMC to force writing."
    )
    return False


class MCMCSampleWriter:
    """Writer of the per-parameter sample files, one row a write."""

    def __init__(self, folder: str):
        self.folder = folder
        self._files: Dict[str, object] = {}
        os.makedirs(folder, exist_ok=True)

    def path(self, var: str) -> str:
        return os.path.join(self.folder, f"MCMC_samples_{var.replace(':', '.')}.txt")

    def register(self, var: str, header: Optional[Sequence[str]] = None):
        if var in self._files:
            return
        f = open(self.path(var), "w")
        if header is not None:
            f.write(",".join(str(h) for h in header) + "\n")
        self._files[var] = f

    def write(self, var: str, values):
        arr = np.asarray(values).reshape(-1)
        self._files[var].write(",".join(repr(float(v)) for v in arr) + "\n")

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}


def _trait_pair_header(traits: List[str]) -> List[str]:
    return [f"{a}_{b}" for a in traits for b in traits]


class STSampleStream:
    """Single-trait sample files: set up from the workspace, one row per
    file a saved sample. Disabled when output_folder is empty."""

    def __init__(self, ws, cfg, opts):
        model = ws.model
        self.enabled = bool(opts.output_folder)
        self.writer = None
        self.loc_slices = []
        self.write_markers = False
        self.ebv = False
        if not self.enabled:
            return
        self.heritability = bool(opts.output_heritability)
        trait = model.lhs_vec[0]
        w = MCMCSampleWriter(opts.output_folder)
        w.register("residual_variance", _trait_pair_header([trait]))
        for trm_str in model.output_samples_terms:
            trm = model.term_dict.get(trm_str)
            if trm is None:
                continue
            w.register(trm_str, [f"{trm_str}:{s}" for s in trm.names])
            self.loc_slices.append((trm_str, trm.start_pos, trm.n_levels))
        g = ws.geno
        self.write_markers = resolve_write_markers(cfg.n_markers,
                                                   opts.output_marker_samples)
        if self.write_markers:
            w.register(f"marker_effects_{g.name}_{trait}", g.marker_ids)
        w.register(f"marker_effects_variances_{g.name}")
        w.register(f"pi_{g.name}")
        self.ebv = bool(opts.outputEBV) and bool(ws.output_ids)
        if self.ebv:
            w.register(f"EBV_{trait}", list(ws.output_ids))
            if opts.output_heritability:
                w.register("genetic_variance", _trait_pair_header([trait]))
                w.register("heritability", [trait])
        self.geno_name = g.name
        self.trait = trait
        self.writer = w

    def write_sample(self, host: Dict[str, np.ndarray]) -> None:
        """One saved sample: host holds vare, varg, pi, genvar, h2 and, as
        the stream asked, sol, alpha, varg_markers (BayesB) and ebv."""
        if not self.enabled:
            return
        w = self.writer
        w.write("residual_variance", host["vare"])
        for trm_str, start, nlev in self.loc_slices:
            w.write(trm_str, host["sol"][start:start + nlev])
        if self.write_markers:
            w.write(f"marker_effects_{self.geno_name}_{self.trait}", host["alpha"])
        w.write(f"marker_effects_variances_{self.geno_name}",
                host.get("varg_markers", host["varg"]))
        w.write(f"pi_{self.geno_name}", host["pi"])
        if self.ebv:
            w.write(f"EBV_{self.trait}", host["ebv"])
            if self.heritability:
                w.write("genetic_variance", host["genvar"])
                w.write("heritability", host["h2"])

    def close(self):
        if self.writer is not None:
            self.writer.close()
