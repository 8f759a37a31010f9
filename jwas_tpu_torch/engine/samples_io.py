"""Per-parameter MCMC sample files in the reference text format.

Counterpart of jwas_tpu/engine/samples_io.py: MARKER_FILE_MAX_P and
resolve_write_markers (:29-43), MCMCSampleWriter (:46-91) and the
single-trait STSampleStream (:98-216) and the multi-trait MTSampleStream
(:322-437, its files a trait where the single-trait stream has one) and
the random-regression RRMSampleStream (:244-310, a marker-effect file a
Legendre coefficient) for the single-trait methods on the
2-bit or a dense store or GBLUP's eigenbasis (its pseudo-markers numbered
"1".."n", :141; the pi row empty for the methods without a pi), or without
genotypes. One comma-separated file per parameter, MCMC_samples_<var>.txt
under the output folder (":" replaced by "."), with the reference's header
row where it writes one and one row per saved sample:
residual_variance, <trait>.<term> (terms requested by outputMCMCsamples),
<term>_<term>..._variances (a random-effect group's covariance, :123-131),
polygenic_effects_variance (the pedigree groups', :174-180), and with
genotypes marker_effects_<geno>_<trait>, marker_effects_variances_<geno>
and pi_<geno>; EBV_<trait>, genetic_variance, heritability. BayesB's
marker_effects_variances_<geno> row holds every marker's variance when the
marker effects are written, else their mean (jwas_tpu's :190-195). A
latent trait adds liabilities_<trait> and, when categorical,
threshold_<trait> (:154-160, :209-212, :381-385, :429-433).

read_sample_file is the numeric reader of these files (jwas_tpu/analysis/
diagnostics.py:71-103, _read_sample_file): the header row is decided by
the writer's file-name convention, marker_effects_variances_ sniffed (a
headerless row a sample from the single- and multi-trait streams, a
coefficient-pair header from the RRM stream), and the rows parsed by
numpy into float64. multichain_streams (:219-239) makes a chain's stream
a chain_<k>/ folder for runMCMC(..., n_chains=K,
output_chain_samples=True).

A sample arrives as host arrays read back in one transfer, in the chain's
dtype (engine/mcmc.py::_read_back); the stream says which of sol, alpha (with
BayesB's per-marker variances), the EBVs and the group covariances (vc<g>)
it needs (loc_slices, write_markers, ebv, re_vars).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from jwas_tpu_torch.engine.output import result_marker_ids

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


def text_row(values) -> str:
    """One line of a sample file: repr(float(v)) of each value, the
    reference's format (samples_io.py:75-77), the values taken to Python
    floats in one tolist()."""
    return ",".join(map(repr, np.asarray(values, dtype=np.float64).reshape(-1).tolist())) + "\n"


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
        self._files[var].write(text_row(values))

    def write_rows(self, var: str, matrix):
        """A 2-D array as one text row per matrix row, as the reference
        writes a matrix (output.jl:471-475): the multi-trait marker
        covariance is t rows a sample."""
        f = self._files[var]
        for row in np.atleast_2d(np.asarray(matrix)):
            f.write(text_row(row))

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}


def _trait_pair_header(traits: List[str]) -> List[str]:
    return [f"{a}_{b}" for a in traits for b in traits]


class STSampleStream:
    """Single-trait sample files: set up from the workspace, one row per
    file a saved sample. Disabled when output_folder is empty. The set-up
    registers the files of every trait of the model (MTSampleStream writes
    them for several)."""

    def __init__(self, ws, cfg, opts):
        model = ws.model
        self.enabled = bool(opts.output_folder)
        self.writer = None
        self.loc_slices = []
        self.write_markers = False
        self.ebv = False
        self.re_vars = []
        self.latent = ()
        if not self.enabled:
            return
        self.heritability = bool(opts.output_heritability)
        self.traits = list(model.lhs_vec)
        w = MCMCSampleWriter(opts.output_folder)
        w.register("residual_variance", _trait_pair_header(self.traits))
        for trm_str in model.output_samples_terms:
            trm = model.term_dict.get(trm_str)
            if trm is None:
                continue
            w.register(trm_str, [f"{trm_str}:{s}" for s in trm.names])
            self.loc_slices.append((trm_str, trm.start_pos, trm.n_levels))
        for grp in ws.re_groups:
            var = "_".join(grp.term_array) + "_variances"
            w.register(var, _trait_pair_header(grp.term_array))
            self.re_vars.append(var)
        self.ped_groups = [g for g, grp in enumerate(ws.re_groups)
                           if grp.random_type == "A"]
        if self.ped_groups:
            w.register("polygenic_effects_variance", _trait_pair_header(
                [t for g in self.ped_groups for t in ws.re_groups[g].term_array]))
        g = ws.geno
        self.geno_name = None if g is None else g.name
        if g is not None:
            self.write_markers = resolve_write_markers(cfg.n_markers,
                                                       opts.output_marker_samples)
            if self.write_markers:
                for trait in self.traits:
                    w.register(f"marker_effects_{g.name}_{trait}",
                               result_marker_ids(g, cfg.n_markers))
            w.register(f"marker_effects_variances_{g.name}")
            w.register(f"pi_{g.name}")
        self.ebv = bool(opts.outputEBV) and bool(ws.output_ids)
        if self.ebv:
            for trait in self.traits:
                w.register(f"EBV_{trait}", list(ws.output_ids))
            if opts.output_heritability:
                w.register("genetic_variance", _trait_pair_header(self.traits))
                w.register("heritability", self.traits)
        # (trait index, name, categorical) of each latent trait
        latent = (cfg.latent_traits if hasattr(cfg, "latent_traits") else
                  (0,) if cfg.trait_types[0] != "continuous" else ())
        self.latent = tuple((k, self.traits[k], cfg.trait_types[k] != "censored")
                            for k in latent)
        for k, trait, categorical in self.latent:
            w.register(f"liabilities_{trait}")
            if categorical:
                w.register(f"threshold_{trait}")
        self.trait = self.traits[0]
        self.writer = w

    def write_latent(self, host: Dict[str, np.ndarray]) -> None:
        """A sample's liabilities and thresholds of the latent traits: host's
        liab (n,) or (t, n) and thresholds (T,) or (t, T)."""
        if not self.latent:
            return
        liab = np.atleast_2d(host["liab"])
        thr = np.atleast_2d(host["thresholds"]) if "thresholds" in host else None
        for k, trait, categorical in self.latent:
            row = k if liab.shape[0] > 1 else 0
            self.writer.write(f"liabilities_{trait}", liab[row])
            if categorical:
                self.writer.write(f"threshold_{trait}", thr[row])

    def write_sample(self, host: Dict[str, np.ndarray]) -> None:
        """One saved sample: host holds vare, varg, pi, genvar, h2 and, as
        the stream asked, sol, alpha, varg_markers (BayesB), ebv and the
        group covariances vc<g>."""
        if not self.enabled:
            return
        w = self.writer
        w.write("residual_variance", host["vare"])
        for trm_str, start, nlev in self.loc_slices:
            w.write(trm_str, host["sol"][start:start + nlev])
        for g, var in enumerate(self.re_vars):
            w.write(var, host[f"vc{g}"])
        if self.ped_groups:
            w.write("polygenic_effects_variance",
                    np.concatenate([host[f"vc{g}"].reshape(-1) for g in self.ped_groups]))
        if self.geno_name is not None:
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
        self.write_latent(host)

    def close(self):
        if self.writer is not None:
            self.writer.close()


class MTSampleStream(STSampleStream):
    """Multi-trait sample files (jwas_tpu's MTSampleStream): the
    single-trait files with a (t, t) residual covariance and genetic
    variance, a marker-effect and an EBV file a trait, the marker
    covariance as t rows a sample (BayesB: the p per-locus (t, t) blocks
    side by side, t rows of p t values, when the marker effects are
    written, else their mean block) and the pattern priors (or a trait's
    pi under the constraint)."""

    def write_sample(self, host: Dict[str, np.ndarray]) -> None:
        """One saved sample: host holds R, varg, pi, genvar, h2, the group
        covariances vc<g> and, as the stream asked, sol, alpha (t, p),
        varg_loci (BayesB's (p, t, t)) and ebv (t, n_out)."""
        if not self.enabled:
            return
        w = self.writer
        w.write("residual_variance", host["R"])
        for trm_str, start, nlev in self.loc_slices:
            w.write(trm_str, host["sol"][start:start + nlev])
        for g, var in enumerate(self.re_vars):
            w.write(var, host[f"vc{g}"])
        if self.ped_groups:
            w.write("polygenic_effects_variance",
                    np.concatenate([host[f"vc{g}"].reshape(-1) for g in self.ped_groups]))
        if self.geno_name is not None:
            name = self.geno_name
            if self.write_markers:
                for k, trait in enumerate(self.traits):
                    w.write(f"marker_effects_{name}_{trait}", host["alpha"][k])
            varg = host["varg"]
            if "varg_loci" in host:
                v = host["varg_loci"]
                varg = v.transpose(1, 0, 2).reshape(v.shape[1], -1)
            w.write_rows(f"marker_effects_variances_{name}", varg)
            w.write(f"pi_{name}", host["pi"])
        if self.ebv:
            for k, trait in enumerate(self.traits):
                w.write(f"EBV_{trait}", host["ebv"][k])
            if self.heritability:
                w.write("genetic_variance", host["genvar"])
                w.write("heritability", host["h2"])
        self.write_latent(host)


class RRMSampleStream:
    """Random-regression sample files (jwas_tpu's RRMSampleStream,
    samples_io.py:244-310; MCMC_BayesianAlphabet_RRM.jl:99,201): the
    residual variance, the location terms of outputMCMCsamples, each
    random-effect group's covariance, the marker effects a Legendre
    coefficient (marker_effects_<geno>_coeff<k>, marker IDs as the
    header), the c x c marker covariance (coefficient-pair header) and pi
    over the 2^c labels (no header). Disabled when output_folder is
    empty."""

    def __init__(self, model, geno, cfg, opts):
        self.enabled = bool(opts.output_folder)
        self.writer = None
        self.loc_slices = []
        self.write_markers = False
        if not self.enabled:
            return
        self.geno_name = geno.name
        self.ncoeff = cfg.ncoeff
        trait = model.lhs_vec[0]
        w = MCMCSampleWriter(opts.output_folder)
        w.register("residual_variance", _trait_pair_header([trait]))
        for trm_str in model.output_samples_terms:
            trm = model.term_dict.get(trm_str)
            if trm is None:
                continue
            w.register(trm_str, [f"{trm_str}:{s}" for s in trm.names])
            self.loc_slices.append((trm_str, trm.start_pos, trm.n_levels))
        self.re_vars = []
        for grp in model.random_effects:
            var = "_".join(grp.term_array) + "_variances"
            w.register(var, _trait_pair_header(list(grp.term_array)))
            self.re_vars.append(var)
        self.write_markers = resolve_write_markers(cfg.n_markers, opts.output_marker_samples)
        coeffs = [f"coeff{i + 1}" for i in range(cfg.ncoeff)]
        if self.write_markers:
            for cname in coeffs:
                w.register(f"marker_effects_{geno.name}_{cname}", geno.marker_ids)
        w.register(f"marker_effects_variances_{geno.name}", _trait_pair_header(coeffs))
        w.register(f"pi_{geno.name}")
        self.writer = w

    def write_sample(self, host: Dict[str, np.ndarray]) -> None:
        """One saved sample: host holds vare, varg (c, c), pi and, as the
        stream asked, sol, alpha (c, p) and the group covariances vc<g>."""
        if not self.enabled:
            return
        w = self.writer
        w.write("residual_variance", host["vare"])
        for trm_str, start, nlev in self.loc_slices:
            w.write(trm_str, host["sol"][start:start + nlev])
        for g, var in enumerate(self.re_vars):
            w.write(var, host[f"vc{g}"])
        if self.write_markers:
            for i in range(self.ncoeff):
                w.write(f"marker_effects_{self.geno_name}_coeff{i + 1}", host["alpha"][i])
        w.write(f"marker_effects_variances_{self.geno_name}", host["varg"])
        w.write(f"pi_{self.geno_name}", host["pi"])

    def close(self):
        if self.writer is not None:
            self.writer.close()


# the kinds the writers register without a header row; marker_effects_variances_
# is headerless from STSampleStream / MTSampleStream but has a header from
# RRMSampleStream, so it is sniffed
HEADERLESS_KINDS = ("pi_", "liabilities_", "threshold_")


def _sample_file_header(path: str) -> bool:
    """Whether a sample file starts with a header row, by the writers'
    convention for its kind, else by its first row (a header when a token
    is not a number)."""
    base = os.path.basename(path)
    stem = base[13:] if base.startswith("MCMC_samples_") else base
    if not stem.startswith("marker_effects_variances_"):
        if any(stem.startswith(k) for k in HEADERLESS_KINDS):
            return False
        if stem.startswith(("marker_effects_", "EBV_")):
            return True
    with open(path) as fh:
        first = fh.readline().strip()
    for tok in first.split(","):
        try:
            float(tok)
        except ValueError:
            return True
    return False


def read_sample_file(path: str, header: Optional[bool] = None, columns: int = 0
                     ) -> Tuple[List[str], np.ndarray]:
    """One sample file as (labels, (n_samples, k) float64 array). header
    None follows the writers' convention (_sample_file_header), so a
    marker-effect file whose IDs are all numeric still has its IDs taken
    as labels; True or False overrides it. Without a header the labels are
    "0".."k-1", as pandas names the columns. columns > 0 reads only the
    first that many columns. Blank lines are skipped."""
    if header is None:
        header = _sample_file_header(path)
    with open(path) as fh, warnings.catch_warnings():
        warnings.simplefilter("ignore")          # loadtxt's "no data"
        first = fh.readline().rstrip("\r\n").split(",")
        width = min(len(first), columns) if columns > 0 else len(first)
        if not header:
            fh.seek(0)
        data = np.loadtxt(fh, delimiter=",", dtype=np.float64, ndmin=2,
                          usecols=range(width) if width < len(first) else None)
    labels = first[:width] if header else [str(j) for j in range(data.shape[1])]
    if data.size == 0:
        data = np.zeros((0, width))
    return labels, data


def multichain_streams(stream_cls, ws, cfg, opts, n_chains: int) -> list:
    """A stream a chain, writing under <output_folder>/chain_<k>/ (k = 1..K),
    when output_chain_samples is set and output_folder is not empty; the
    inputs of analysis.diagnostics.PSRF_per_parameter."""
    if not opts.output_folder or not bool(opts.output_chain_samples):
        return []
    return [stream_cls(ws, cfg, dataclasses.replace(
        opts, output_folder=os.path.join(opts.output_folder, f"chain_{k + 1}")))
        for k in range(n_chains)]
