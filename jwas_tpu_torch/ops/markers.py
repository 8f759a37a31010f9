"""Marker-update math and the sync-round schedule of the blocked sweeps.

Counterpart of jwas_tpu/ops/markers.py: BAYESR_GAMMA (:52),
default_block_size (:74), _abc_update (:118-137), bayesr_class_logprobs
and _bayesr_update (:150-188), resolve_sync_every (:208, with the default
of jwas_tpu/engine/setup.py:105-113), _sync_rounds (:215-238) and
stable_group_blocks (:569) with jwas_tpu/ops/grouped.py::pick_group_blocks
(:241), and the dense store's block rule (jwas_tpu/engine/mcmc.py:802-836).

Marker state stays flat (p_pad,); a block-major view x.view(nblocks, b)
takes the place of the JAX package's _to_jmajor / _from_jmajor (:241-248).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch


def default_block_size(n_obs: int) -> int:
    """floor(sqrt(n_obs)) rounded up to a multiple of 128 (at least 128),
    as jwas_tpu picks it, so both packages run the same schedule."""
    b = int(math.sqrt(max(n_obs, 1)))
    return max(128, ((b + 127) // 128) * 128)


# the stability cap b * gb <= STALE_FRACTION * n of the grouped schedule
# (jwas_tpu/ops/grouped.py:101-116 has the measurements behind it)
STALE_FRACTION = 0.4


def pick_group_blocks(nblocks: int, prefer: int = 128, cap: int = 256) -> int:
    """Blocks a group: the largest divisor of nblocks up to cap that is a
    multiple of prefer, else the largest divisor up to cap, else nblocks
    (jwas_tpu/ops/grouped.py:241). The preference is kept because it fixes
    the schedule that both packages run."""
    best = 0
    for gb in range(min(cap, nblocks), 0, -1):
        if nblocks % gb:
            continue
        if gb % prefer == 0:
            return gb
        if best == 0:
            best = gb
    return best or nblocks


def stable_group_blocks(n_obs: int, b: int, nblocks: int) -> int:
    """Blocks a group of the dense schedule: the largest group whose stale
    set b * gb honours STALE_FRACTION * n_obs (pick_group_blocks), or 0
    when all nblocks fit under the cap and one group (the flat sweep) is
    stable (jwas_tpu/ops/markers.py:569)."""
    cap = max(1, int(STALE_FRACTION * n_obs) // b)
    if nblocks <= cap:
        return 0
    return pick_group_blocks(nblocks, prefer=128, cap=cap)


def dense_blocks(n_obs: int, fast_blocks, p: int):
    """(b, gb, exact) of a dense store as jwas_tpu's runMCMC picks them
    (jwas_tpu/engine/mcmc.py:802-836): fast_blocks True gives
    default_block_size(n_obs), an int is rounded up to a multiple of 8 (at
    least 8), and gb = stable_group_blocks (0, one group, becomes nblocks).
    fast_blocks False is the exact single-site sweep (exact True), which
    the port runs in chunks of b = default_block_size(n_obs) markers, one
    block a group."""
    exact = fast_blocks is False or fast_blocks is None or (
        fast_blocks is not True and not int(fast_blocks))
    if exact or fast_blocks is True:
        b = default_block_size(n_obs)
    else:
        b = max(8, ((int(fast_blocks) + 7) // 8) * 8)
    nblocks = -(-p // b)
    if exact:
        return b, 1, True
    return b, stable_group_blocks(n_obs, b, nblocks) or nblocks, False


class ABCConstants(NamedTuple):
    """Per-marker terms of the spike-slab update that do not change during a
    round (they depend on xpx, var_eff and 1/vare only)."""

    inv_lhs: torch.Tensor     # 1 / (xpx / vare + 1 / var_eff)
    c: torch.Tensor           # log(lhs) + log(var_eff)
    sq_inv_lhs: torch.Tensor  # sqrt(1 / lhs)
    sq_var_eff: torch.Tensor  # sqrt(var_eff)


def abc_constants(xpx, var_eff, inv_vare) -> ABCConstants:
    lhs = xpx * inv_vare + 1.0 / var_eff
    inv_lhs = 1.0 / lhs
    return ABCConstants(inv_lhs, torch.log(lhs) + torch.log(var_eff),
                        torch.sqrt(inv_lhs), torch.sqrt(var_eff))


def abc_update(rhs_j, alpha_j, xpx_j, inv_vare, k: ABCConstants, log_pi_j,
               log_pi_comp_j, u, z):
    """Spike-slab (BayesC) marker update (BayesABC.jl:24-58), the math of
    jwas_tpu's _abc_update with its round constants precomputed in k.

    pi is P(excluded). Returns (alpha_new, beta_new, include).
    """
    r = (rhs_j + xpx_j * alpha_j) * inv_vare
    g = r * k.inv_lhs
    log_delta1 = -0.5 * (k.c - g * r) + log_pi_comp_j
    prob_delta1 = 1.0 / (1.0 + torch.exp(log_pi_j - log_delta1))
    include = u < prob_delta1
    beta_in = g + z * k.sq_inv_lhs
    alpha_new = torch.where(include, beta_in, 0.0)
    beta_new = torch.where(include, beta_in, z * k.sq_var_eff)
    return alpha_new, beta_new, include


# BayesR class variance scales: class k has effect variance gamma_k * sigma^2
BAYESR_GAMMA = (0.0, 0.01, 0.1, 1.0)


class BayesRConstants(NamedTuple):
    """Per-marker terms of the BayesR update that do not change during a
    round, for the slab classes k = 1..3 (last axis)."""

    inv_lhs: torch.Tensor     # 1 / (xpx / vare + 1 / var_k)
    d: torch.Tensor           # log(inv_lhs) - log(var_k)
    sq_inv_lhs: torch.Tensor  # sqrt(inv_lhs)


def bayesr_constants(xpx, inv_vare, sigma_sq) -> BayesRConstants:
    """xpx (...,) -> (..., 3) per-class constants; inv_vare and sigma_sq
    are 0-d or 1-element tensors. Each operation is the one jwas_tpu's
    bayesr_class_logprobs applies, in its order, so precomputing changes
    no rounding."""
    var = torch.stack([g * sigma_sq.reshape(()) for g in BAYESR_GAMMA[1:]])
    lhs = xpx[..., None] * inv_vare.reshape(()) + 1.0 / var
    inv_lhs = 1.0 / lhs
    return BayesRConstants(inv_lhs, torch.log(inv_lhs) - torch.log(var),
                           torch.sqrt(inv_lhs))


def bayesr_update(rhs_j, alpha_j, xpx_j, inv_vare, k: BayesRConstants,
                  log_pi_j, gumbel, z):
    """BayesR 4-class mixture update (BayesR.jl:45-97), the math of
    jwas_tpu's _bayesr_update with its round constants precomputed in k.

    rhs_j, alpha_j, xpx_j, z: (B,); k fields, log_pi_j, gumbel: (B, 3) and
    (B, 4). The class is the Gumbel-max draw: scores (lp_k + ll_k) + g_k,
    class 0 scoring lp_0 + g_0, the first maximum winning ties as argmax
    does. Returns (alpha_new, class) with class int32 in {0, 1, 2, 3}.
    """
    r = (rhs_j + xpx_j * alpha_j) * inv_vare
    best = log_pi_j[:, 0] + gumbel[:, 0]
    klass = torch.zeros_like(r, dtype=torch.int32)
    bh_b = torch.zeros_like(r)
    sq_b = torch.zeros_like(r)
    for c in range(3):
        bh = k.inv_lhs[:, c] * r
        ll = 0.5 * (k.d[:, c] + bh * r)
        score = (log_pi_j[:, c + 1] + ll) + gumbel[:, c + 1]
        upd = score > best
        best = torch.where(upd, score, best)
        klass = torch.where(upd, c + 1, klass)
        bh_b = torch.where(upd, bh, bh_b)
        sq_b = torch.where(upd, k.sq_inv_lhs[:, c], sq_b)
    alpha_new = torch.where(klass == 0, 0.0, bh_b + z * sq_b)
    return alpha_new, klass


def resolve_sync_every(nreps: int, sync_every: Optional[int] = None) -> int:
    """Inner reps between exact residual syncs.

    None -> min(8, nreps), the engine default (setup.py:105-113); 0 or less
    -> nreps, the reference's fully amortized independent_blocks mode;
    otherwise clamped to [1, nreps].
    """
    if sync_every is None:
        return min(8, nreps)
    if int(sync_every) <= 0:
        return nreps
    return max(1, min(int(sync_every), nreps))


def sync_rounds(nreps: int, sync_every: int) -> List[int]:
    """Round lengths of one group visit: nreps // sync_every rounds of
    sync_every reps plus a remainder round (_sync_rounds). Round r of group
    g draws from fold_in(fold_in(key, g), r) in the JAX package."""
    n_full, rem = divmod(nreps, sync_every)
    return [sync_every] * n_full + ([rem] if rem else [])
