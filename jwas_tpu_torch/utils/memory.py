"""Device-memory guard of the marker path.

Counterpart of jwas_tpu/utils/memory.py (format_bytes_human,
MarkerMemoryEstimate, estimate_marker_memory and check_marker_memory_guard,
:62-124): the same policies and errors, with an estimate of the port's own
device buffers for the 2-bit grouped store:

- the store's device part: all of it when resident, the leading groups
  when hybrid, nothing when streamed;
- the Gram tiles, p_pad * b float32;
- the staging ring of a streamed store, RING_DEPTH groups of G * bpm
  bytes, or the zero-padded copy of a short last group read in place;
- the largest decoded tile of the Gram set-up (ops/grouped.py
  _DECODE_BYTES);
- the location design, n * K float32.

and, for a dense store (estimate_dense_memory; jwas_tpu's dense count,
:62-90), the store at its itemsize (and its source when the chain's dtype
differs from the store's, which costs one copy), the Gram tiles p_pad * b
at the chain's itemsize, one weighted chunk of the Gram set-up
(ops/dense.py _GRAM_BYTES) and the location design.

and for GBLUP (estimate_gblup_memory) the relationship matrix G at its
itemsize, the float64 block of the training rows, its eigenvectors and
the eigensolver's workspace (about 2 n^2 doubles), the float64 product of
the output map, and L and the output map in the chain's dtype.

jwas_tpu's estimate also counts a dense float32 (n_out, p) matrix of the
output IDs' genotypes (bytes_output); the port never builds one (ROADMAP.md
fault R7), so its bytes_output is 0. The budget is the residence plan's
(ops/grouped.py::hbm_budget: JWAS_HBM_BYTES, else the card's total memory,
else the JAX package's 16 GiB default here), or total_bytes.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

from jwas_tpu_torch.ops.dense import _GRAM_BYTES
from jwas_tpu_torch.ops.grouped import RING_DEPTH, _DECODE_BYTES, _sub_chunk, hbm_budget

_DEFAULT_HBM_BYTES = 16 * 1024**3


def format_bytes_human(nbytes: float) -> str:
    """Human-readable byte count (format_bytes_human, tools4genotypes.jl)."""
    units = ["B", "KiB", "MiB", "GiB", "TiB"]
    x = float(nbytes)
    for u in units:
        if abs(x) < 1024.0 or u == units[-1]:
            return f"{x:.2f} {u}"
        x /= 1024.0
    return f"{x:.2f} TiB"


@dataclass(frozen=True)
class MarkerMemoryEstimate:
    bytes_genotypes: int      # the store's device part
    bytes_grams: int
    bytes_staging: int        # ring buffers, or a short last group's copy
    bytes_decode: int         # one decoded tile of the Gram set-up
    bytes_design: int
    bytes_output: int = 0     # none: the output IDs' EBVs come from K5 (R7)
    bytes_state: int = 0      # marker state beyond the common (BayesL's gamma)

    @property
    def bytes_total(self) -> int:
        return (self.bytes_genotypes + self.bytes_grams + self.bytes_staging
                + self.bytes_decode + self.bytes_design + self.bytes_output
                + self.bytes_state)


def estimate_marker_memory(n_obs: int, n_markers: int, block_size: int,
                           group_blocks: int,
                           bytes_per_marker: Optional[int] = None,
                           n_loc: int = 0, n_traits: int = 1,
                           resident_groups: Optional[int] = None,
                           itemsize: int = 4,
                           design_bytes: Optional[int] = None) -> MarkerMemoryEstimate:
    """Device bytes of the 2-bit grouped marker path for n_obs training
    observations: blocks of block_size, groups of group_blocks blocks, a
    store of bytes_per_marker bytes a marker (default ceil(n_obs / 4)),
    resident_groups of its groups on the device (None: all). design_bytes:
    the sparse location path's CSR structures in place of the dense
    design."""
    b, G = block_size, block_size * group_blocks
    bpm = (n_obs + 3) // 4 if bytes_per_marker is None else bytes_per_marker
    ngroups = max(1, -(-n_markers // G))
    k = ngroups if resident_groups is None else max(0, min(resident_groups, ngroups))
    return MarkerMemoryEstimate(
        bytes_genotypes=min(n_markers, k * G) * bpm,
        bytes_grams=ngroups * G * b * itemsize,
        bytes_staging=(RING_DEPTH * G * bpm if k < ngroups
                       else G * bpm if n_markers % G else 0),
        bytes_decode=_sub_chunk(G, b, n_obs, _DECODE_BYTES) * n_obs * 4,
        bytes_design=(n_obs * n_traits * n_loc * itemsize if design_bytes is None
                      else design_bytes),
    )


def estimate_dense_memory(n_store: int, n_obs: int, n_markers: int,
                          block_size: int, group_blocks: int, n_loc: int = 0,
                          itemsize: int = 4,
                          store_itemsize: Optional[int] = None,
                          method: str = "BayesC",
                          design_bytes: Optional[int] = None) -> MarkerMemoryEstimate:
    """Device bytes of a dense store's chain: the (n_markers, n_store)
    store in the chain's itemsize, its source when that is of another
    itemsize (store_itemsize), Gram tiles of blocks of block_size in groups
    of group_blocks, one weighted chunk of the Gram set-up, the location
    design and BayesL's local shrinkage, one value a marker."""
    b, G = block_size, block_size * group_blocks
    p_pad = -(-n_markers // G) * G
    store = n_markers * n_store
    src = store_itemsize if store_itemsize not in (None, itemsize) else 0
    return MarkerMemoryEstimate(
        bytes_genotypes=store * itemsize, bytes_grams=p_pad * b * itemsize,
        bytes_staging=store * src,
        bytes_decode=min(_GRAM_BYTES, store * itemsize),
        bytes_design=n_obs * n_loc * itemsize if design_bytes is None else design_bytes,
        bytes_state=p_pad * itemsize if method == "BayesL" else 0)


def estimate_gblup_memory(n_geno: int, n_obs: int, n_out: int, n_loc: int = 0,
                          itemsize: int = 4,
                          grm_itemsize: int = 4,
                          design_bytes: Optional[int] = None) -> MarkerMemoryEstimate:
    """Device bytes of GBLUP's set-up and chain (ops/gblup.py::gblup_eigen):
    G (n_geno^2 at grm_itemsize); the float64 block G_tt of the n_obs
    training rows, its eigenvectors and the eigensolver's workspace
    (4 n_obs^2 doubles); the float64 output map (n_out x n_obs); L and the
    output map at the chain's itemsize; the location design."""
    block = n_obs * n_obs
    return MarkerMemoryEstimate(
        bytes_genotypes=n_geno * n_geno * grm_itemsize,
        bytes_grams=0,
        bytes_staging=4 * block * 8,
        bytes_decode=n_out * n_obs * 8,
        bytes_design=n_obs * n_loc * itemsize if design_bytes is None else design_bytes,
        bytes_output=(block + n_out * n_obs) * itemsize)


def estimate_imputation_memory(n_markers: int, n_geno: int, n_rows: int,
                               n_nongeno: int, chunk: int,
                               store_itemsize: int = 4) -> MarkerMemoryEstimate:
    """Device bytes at single-step's peak (engine/single_step.py::
    ssbr_setup): the genotyped animals' store (n_markers, n_geno) and the
    imputed store of the data's n_rows individuals beside it, and the
    blocked CG's working blocks, 8 float64 (n_nongeno, chunk) arrays."""
    return MarkerMemoryEstimate(
        bytes_genotypes=n_markers * (n_geno + n_rows) * store_itemsize,
        bytes_grams=0, bytes_staging=8 * 8 * n_nongeno * chunk, bytes_decode=0,
        bytes_design=0)


def check_marker_memory_guard(estimate: MarkerMemoryEstimate,
                              policy: str = "warn", ratio: float = 0.9,
                              total_bytes: Optional[int] = None,
                              device=None) -> None:
    """Enforce the guard (check_marker_memory_guard!, tools4genotypes.jl:
    162-235): policy "error" raises MemoryError, "warn" warns, "off" does
    nothing, when the estimate exceeds ratio of total_bytes (default: the
    memory of device, ops/grouped.py::hbm_budget, which the residence plan
    reads too)."""
    if policy not in ("error", "warn", "off"):
        raise ValueError("memory_guard must be 'error', 'warn', or 'off'")
    if policy == "off":
        return
    budget = (total_bytes if total_bytes is not None
              else hbm_budget(device, default=_DEFAULT_HBM_BYTES))
    limit = ratio * budget
    if estimate.bytes_total <= limit:
        return
    msg = (
        f"estimated marker-path device memory {format_bytes_human(estimate.bytes_total)} "
        f"(genotypes {format_bytes_human(estimate.bytes_genotypes)}, "
        f"block Grams {format_bytes_human(estimate.bytes_grams)}, "
        f"staging {format_bytes_human(estimate.bytes_staging)}, "
        f"decode {format_bytes_human(estimate.bytes_decode)}) exceeds "
        f"{ratio:.0%} of device memory {format_bytes_human(budget)}; "
        "reduce fast_blocks block size or stream the store from host memory "
        "(host_offload_genotypes=True)"
    )
    if policy == "error":
        raise MemoryError(msg)
    warnings.warn(msg)
