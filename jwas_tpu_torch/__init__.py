"""jwas_tpu_torch: the PyTorch / CUDA port of jwas_tpu, for NVIDIA Hopper.

It runs single-trait BayesC and BayesR with fast blocks over the 2-bit
packed genotype store on the group-sequential schedule, the path jwas_tpu's
runMCMC takes for storage='2bit' on one device. It imports torch, numpy and
scipy only; never jax, pandas or jwas_tpu.

Entry points, as in jwas_tpu: read_csv (a pandas-free column table),
get_genotypes(..., storage="2bit") or prepare_packed_genotypes,
build_model, set_covariate, outputEBV, describe and runMCMC(model, df),
which returns the result tables and writes the result and sample files.
Below them: Packed2BitStore.load (a stored 2-bit store),
engine.mcmc.setup_markers (block sizes, Gram tiles, on a device) and
engine.mcmc.run_st (the chain with explicit priors). On a CUDA device the
sweep runs hand-written kernels (csrc/), built with nvcc on first use: the
BayesC or BayesR inner rounds between the two packed GEMVs. On the CPU
(device="cpu") it runs their plain PyTorch versions.
"""

from jwas_tpu_torch.engine.mcmc import runMCMC, run_st, setup_markers
from jwas_tpu_torch.io.genotypes import get_genotypes
from jwas_tpu_torch.io.packed import Packed2BitStore, pack_codes, prepare_packed_genotypes
from jwas_tpu_torch.io.table import Table, read_csv
from jwas_tpu_torch.models.model import build_model, describe, outputEBV, set_covariate
from jwas_tpu_torch.ops.grouped import build_grouped_markers, pick_stable_blocks
from jwas_tpu_torch.ops.inner_rounds import abc_inner_rounds, bayesr_inner_rounds
from jwas_tpu_torch.ops.packed_gemv import packed_matvec, packed_rhs

# the kernel wrappers, each counting its own launches
KERNELS = (abc_inner_rounds, bayesr_inner_rounds, packed_rhs, packed_matvec)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS", "Packed2BitStore", "Table", "abc_inner_rounds",
    "bayesr_inner_rounds", "build_grouped_markers", "build_model", "describe",
    "get_genotypes", "outputEBV", "pack_codes", "packed_matvec", "packed_rhs",
    "pick_stable_blocks", "prepare_packed_genotypes", "read_csv",
    "reset_launches", "runMCMC", "run_st", "set_covariate", "setup_markers",
]
