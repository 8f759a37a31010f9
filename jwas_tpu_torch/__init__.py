"""jwas_tpu_torch: the PyTorch / CUDA port of jwas_tpu, for NVIDIA Hopper.

It runs single-trait BayesC, BayesB and BayesR on one device over the
2-bit packed genotype store (fast blocks on the group-sequential
schedule, the path jwas_tpu's runMCMC takes for storage='2bit'), or over a
dense store (storage "f32", "f64" or "int8": the same schedule, or the
exact single-site sweep with fast_blocks=False), with residual weights
(heterogeneous_residuals) and in float64 (double_precision) on a dense
store. The 2-bit store lives on the card, or in pinned host memory from
which its groups stream to the card (runMCMC's host_offload_genotypes),
the leading ones on the card where they fit. Random effects (set_random:
i.i.d., pedigree and user-given Vinv groups) run beside the genotypes or
without them (the pedigree-BLUP animal model). Multi-trait models (several
equations) run BayesC and BayesB on a dense store with samplers I and II
(hand-written kernels K7 and K8), RR-BLUP and BayesL (their marker chain
the hand-written kernel K9) and GBLUP, the mega-trait constraint, missing
phenotypes, t x t covariances, the prior update and structural equations
(causal_structure), or no genotypes. Latent traits (build_model's
categorical_trait and censored_trait: binary, ordered categorical and
censored, single- and multi-trait) and annotations (get_genotypes's
annotations: annotated BayesC and BayesR, and 2-trait annotated BayesC,
whose per-marker pattern prior K7 and K8 take) run on dense stores. A
single-trait model above 20,000 location levels (or with
sparse_location=True) takes the sparse location path: its design and
random-effect structures as CSR tensors and a joint PO-CG draw of the
location parameters. Single-step (runMCMC(..., single_step_analysis=True,
pedigree=ped)) imputes the non-genotyped animals' genotypes into the dense
store and adds the J covariate and the imputation residual epsilon
(engine/single_step.py, with get_Hi and the APY helpers); solve(model, df,
solver=...) solves the MME of a model without markers. runMCMC(model, df,
RRM=Phi), Phi from generate_full_phi, runs the random regression model of
a longitudinal trait (test days, growth curves) on a dense store, its
marker chain the hand-written kernel K10. runMCMC(..., n_chains=K) runs K
chains of a single- or multi-trait model on one device, sharing the store
and its Gram tiles, chain k seeded seed + k, and returns the pooled
posterior means with a "PSRF" table (output_chain_samples=True writes
each chain's sample files under chain_<k>/). After a run, GWAS reads the
marker-effect sample file and takes window variance proportions, WPPA,
local EBVs and window genetic correlations from decoded genotype columns
on the device (analysis/gwas.py); PSRF, PSRF_per_parameter, traceplot,
LOOCV (float64 on the device), lsmeans and getEBV are the diagnostics
(analysis/diagnostics.py), and dataset the packaged example tables
(io/datasets.py, with the simulators of known truth). It imports torch,
numpy and scipy only (matplotlib inside traceplot); never jax, pandas or
jwas_tpu.

Entry points, as in jwas_tpu: read_csv (a pandas-free column table),
get_pedigree and get_info, get_genotypes (storage "2bit", or a dense one
written to a device) or prepare_packed_genotypes, build_model,
set_covariate, set_random, outputEBV, describe and runMCMC(model, df),
which returns the result tables and writes the result and sample files,
and solve(model, df). Below them: Packed2BitStore.load (a stored 2-bit
store), engine.mcmc.setup_markers and setup_dense_markers (block sizes,
row order, Gram tiles, on a device) and engine.mcmc.run_st (the chain with
explicit priors). On a CUDA device the chain runs hand-written kernels
(csrc/), built with nvcc on first use: the BayesC/B or BayesR inner rounds
(float32 and float64 builds) between two GEMVs, the packed ones on the
2-bit store, the location parameters' Gibbs pass (K6), the multi-trait
chains (K7-K9) and the random-regression chain (K10). On the CPU
(device="cpu") it runs their plain PyTorch versions. The pedigree's
inbreeding is host C++ (csrc/pedigree.cpp), built with g++ on first use.
"""

from jwas_tpu_torch.analysis.diagnostics import (LOOCV, PSRF, PSRF_per_parameter, getEBV,
                                                 lsmeans, traceplot)
from jwas_tpu_torch.analysis.gwas import GWAS
from jwas_tpu_torch.engine.mcmc import runMCMC, run_st, setup_dense_markers, setup_markers
from jwas_tpu_torch.engine.solve import solve
from jwas_tpu_torch.io.datasets import dataset
from jwas_tpu_torch.io.genotypes import Genotypes, get_genotypes
from jwas_tpu_torch.io.packed import Packed2BitStore, pack_codes, prepare_packed_genotypes
from jwas_tpu_torch.io.pedigree import Pedigree, get_info, get_pedigree
from jwas_tpu_torch.io.table import Table, read_csv
from jwas_tpu_torch.models.model import (Model, add_genotypes, build_model, describe,
                                         getMCMCinfo, outputEBV, outputMCMCsamples,
                                         set_covariate, set_random)
from jwas_tpu_torch.ops.grouped import build_grouped_markers, pick_stable_blocks
from jwas_tpu_torch.ops.inner_rounds import (abc_inner_rounds, bayesr_inner_rounds,
                                             mt_abc_inner_rounds_I,
                                             mt_abc_inner_rounds_II,
                                             mt_c0l_inner_rounds)
from jwas_tpu_torch.ops.location import gibbs_pass_lambda
from jwas_tpu_torch.ops.packed_gemv import packed_matvec, packed_rhs
from jwas_tpu_torch.ops.rrm import generate_full_phi, sweep_rrm_abc

# jwas_tpu's name for the packed store's preparation (jwas_tpu/__init__.py:44)
prepare_streaming_genotypes = prepare_packed_genotypes

# the kernel wrappers, each counting its own launches (the inner rounds,
# K6 and K10 also their float64 build's, launches_f64; K7 and K8 their
# per-marker prior's, launches_pm)
KERNELS = (abc_inner_rounds, bayesr_inner_rounds, packed_rhs, packed_matvec,
           gibbs_pass_lambda, mt_abc_inner_rounds_I, mt_abc_inner_rounds_II,
           mt_c0l_inner_rounds, sweep_rrm_abc)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "launches_f64"):
            k.launches_f64 = 0
        if hasattr(k, "launches_pm"):
            k.launches_pm = 0


__all__ = [
    "GWAS", "Genotypes", "KERNELS", "LOOCV", "Model", "PSRF", "PSRF_per_parameter",
    "Packed2BitStore", "Pedigree", "Table",
    "abc_inner_rounds", "add_genotypes", "bayesr_inner_rounds",
    "build_grouped_markers", "build_model", "dataset", "describe", "generate_full_phi",
    "getEBV", "getMCMCinfo",
    "get_genotypes", "get_info", "get_pedigree", "gibbs_pass_lambda", "lsmeans",
    "mt_abc_inner_rounds_I", "mt_abc_inner_rounds_II", "mt_c0l_inner_rounds",
    "outputEBV",
    "outputMCMCsamples", "pack_codes", "packed_matvec", "packed_rhs",
    "pick_stable_blocks", "prepare_packed_genotypes",
    "prepare_streaming_genotypes", "read_csv", "reset_launches", "runMCMC",
    "run_st", "set_covariate", "set_random", "setup_dense_markers",
    "setup_markers", "solve", "sweep_rrm_abc", "traceplot",
]
