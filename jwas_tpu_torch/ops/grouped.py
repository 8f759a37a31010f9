"""Group-sequential fast-blocks BayesC and BayesR over a device-resident
2-bit store.

Counterpart of jwas_tpu/ops/grouped.py: GroupedPackedMarkers (:47),
STALE_FRACTION and pick_stable_blocks (:117-162), grouped_matvec and
grouped_rhs (:411-454), sweep_blocks_abc_grouped (:460-617),
sweep_blocks_bayesr_grouped (:623-764), grouped_stats (:808-882) and
build_grouped_markers (:885-969).

The store lives in device memory as (ngroups, G, bpm) uint8. Groups are
visited in order (exact across groups); within a group the b * gb markers
of gb blocks update in parallel against a residual that is reconciled every
sync round. Each round is one X'w GEMV (packed_rhs), one inner-rounds launch
(abc_inner_rounds or bayesr_inner_rounds) and one Xv GEMV (packed_matvec);
on a CUDA device all three are hand-written kernels. Host streaming of
stores larger than device memory (the JAX package's _stage / hybridize /
prefetch) is not ported yet.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops.inner_rounds import abc_inner_rounds, bayesr_inner_rounds
from jwas_tpu_torch.ops.packed_gemv import packed_matvec, packed_rhs

# Parallel-update stability cap b * gb <= STALE_FRACTION * n: see the JAX
# package (ops/grouped.py:101-116) for the measurements behind it.
STALE_FRACTION = 0.4

Draws = Callable[[int, int, int], Tuple[torch.Tensor, torch.Tensor]]

# float32 tiny: the lower end of the uniforms under jax.random.gumbel
_TINY = torch.finfo(torch.float32).tiny


class GroupedPackedMarkers(NamedTuple):
    """Device-resident grouped store: ngroups, G, bpm = store.shape;
    nblocks, b, _ = grams.shape; gb = nblocks // ngroups."""

    store: torch.Tensor               # (ngroups, G, bpm) uint8
    means: torch.Tensor               # (p_pad,) float32
    row_perm: Optional[torch.Tensor]  # (n_obs,) int64 store column per
                                      # observation, or None (identity)
    xpx: torch.Tensor                 # (p_pad,) diag of X'X (1 for padding)
    grams: torch.Tensor               # (nblocks, b, b) block-major Grams
    valid: torch.Tensor               # (p_pad,) 1 real marker, 0 padding
    n_obs: int
    has_missing: bool = True          # False: the store holds no code 3


def pick_stable_blocks(n_obs: int, block_size: int, p: int,
                       warn: bool = True):
    """(block_size, group_blocks) with b * gb <= STALE_FRACTION * n, exactly
    as jwas_tpu chooses them (prefers gb = 128, shrinking b in steps of 8)."""
    req = max(8, (int(block_size) // 8) * 8)
    cap = min(max(8, int(STALE_FRACTION * n_obs)), max(p, 8))
    b = max(8, (min(int(block_size), max(cap, 8)) // 8) * 8)
    out = None
    if -(-p // b) >= 128:
        if b * 128 > cap:
            b = (cap // 128) // 8 * 8
        if b >= 8 and -(-p // b) >= 128:
            out = (b, 128)
        else:
            b = 8
    if out is None:
        gb = min(-(-p // b), max(1, cap // b))
        while b > 8 and b * gb > cap:
            b = max(8, b - 8)
            gb = min(-(-p // b), max(1, cap // b))
        out = (b, gb)
    if warn and out[0] != req:
        warnings.warn(
            f"fast_blocks size {block_size} exceeds the parallel-update "
            f"stability cap (b*group_blocks <= {STALE_FRACTION}*n = "
            f"{STALE_FRACTION * n_obs:.0f}): using block_size={out[0]}, "
            f"group_blocks={out[1]}."
        )
    return out


def pad_w(w, bpm: int, row_perm):
    """Observation vector -> store-ordered (4 * bpm,) GEMV source (w itself
    when it already is one: identity order and n_obs == 4 * bpm)."""
    if row_perm is None and w.shape[0] == 4 * bpm and w.is_contiguous():
        return w
    w_pad = torch.zeros(4 * bpm, dtype=w.dtype, device=w.device)
    if row_perm is None:
        w_pad[: w.shape[0]] = w
    else:
        w_pad.index_add_(0, row_perm, w)
    return w_pad


def unpad(out_pad, n_obs: int, row_perm):
    """Store-ordered (4 * bpm,) Xv result -> (n_obs,) observation order."""
    return out_pad[:n_obs] if row_perm is None else out_pad[row_perm]


def grouped_matvec_store(gm: GroupedPackedMarkers, v):
    """X v over the whole store, (4 * bpm,) in store column order: one
    entry for every genotyped individual of the store, phenotyped or not."""
    ngroups, G, _ = gm.store.shape
    acc = None
    for g in range(ngroups):
        sl = slice(g * G, (g + 1) * G)
        part = packed_matvec(gm.store[g], gm.means[sl], v[sl])
        acc = part if acc is None else acc + part
    return acc


def grouped_matvec(gm: GroupedPackedMarkers, v):
    """X v over the whole store, (n_obs,) in observation order."""
    return unpad(grouped_matvec_store(gm, v), gm.n_obs, gm.row_perm)


def grouped_rhs(gm: GroupedPackedMarkers, w):
    """X' w over the whole store, (p_pad,)."""
    ngroups, G, bpm = gm.store.shape
    w_pad = pad_w(w, bpm, gm.row_perm)
    return torch.cat([packed_rhs(gm.store[g], gm.means[g * G:(g + 1) * G],
                                 w_pad, gm.has_missing)
                      for g in range(ngroups)])


def _walk_groups(gm: GroupedPackedMarkers, alpha_b, ycorr, nreps: int,
                 sync_every: Optional[int], inner) -> None:
    """The grouped schedule shared by the sweeps: groups in order, sync
    rounds within a group. A round is X'w of the group (K4), then
    inner(blk, rhs, g, r, reps), which updates alpha_b[blk] in place, then
    X times the change in alpha (K5) into ycorr, in place."""
    ngroups, G, bpm = gm.store.shape
    nblocks, b = alpha_b.shape
    gb = nblocks // ngroups
    rounds = mk.sync_rounds(nreps, mk.resolve_sync_every(nreps, sync_every))
    for g in range(ngroups):
        rows = gm.store[g]
        mns = gm.means[g * G:(g + 1) * G]
        blk = slice(g * gb, (g + 1) * gb)
        a_g = alpha_b[blk]
        for r, reps in enumerate(rounds):
            rhs = packed_rhs(rows, mns, pad_w(ycorr, bpm, gm.row_perm),
                             gm.has_missing)
            a_start = a_g.clone()
            inner(blk, rhs.view(gb, b), g, r, reps)
            d_alpha = (a_start - a_g).view(-1)
            ycorr += unpad(packed_matvec(rows, mns, d_alpha), gm.n_obs,
                           gm.row_perm)


def sweep_blocks_abc_grouped(gm: GroupedPackedMarkers, alpha, beta, delta,
                             ycorr, vare, var_eff, pi,
                             gen: Optional[torch.Generator], nreps: int = 1,
                             sync_every: Optional[int] = None,
                             draws: Optional[Draws] = None):
    """Group-sequential fast-blocks BayesC sweep (BayesABC.jl:111-188).

    alpha, beta (p_pad,) float32, delta (p_pad,) int32 and ycorr (n_obs,)
    are updated in place (the chain keeps one copy of its marker state) and
    returned. vare and var_eff are 0-d tensors, pi (p_pad,) P(excluded).
    Round r of group g takes its (reps * b, gb) uniform and normal panels
    from draws(g, r, reps) when given (tests inject the JAX package's),
    else from the chain's generator gen, in group and round order.
    """
    nblocks, b, _ = gm.grams.shape
    gb = nblocks // gm.store.shape[0]
    p_pad = nblocks * b
    inv_vare = (1.0 / vare).reshape(1)
    var_eff_b = var_eff.reshape(1).expand(p_pad).contiguous().view(nblocks, b)
    pi_c = torch.clamp(pi, 1e-10, 1.0)
    log_pi = torch.log(pi_c).view(nblocks, b)
    log_pi_comp = torch.log1p(-pi_c + 1e-12).view(nblocks, b)
    xpx_b = gm.xpx.view(nblocks, b)
    alpha_b, beta_b, delta_b = (x.view(nblocks, b) for x in (alpha, beta, delta))
    if draws is None:
        def draws(g, r, reps):
            return (torch.rand((reps * b, gb), generator=gen, device=ycorr.device),
                    torch.randn((reps * b, gb), generator=gen, device=ycorr.device))

    def inner(blk, rhs, g, r, reps):
        us, zs = draws(g, r, reps)
        abc_inner_rounds(gm.grams[blk], xpx_b[blk], var_eff_b[blk],
                         log_pi[blk], log_pi_comp[blk], alpha_b[blk],
                         beta_b[blk], delta_b[blk], rhs, us, zs, inv_vare,
                         reps)

    _walk_groups(gm, alpha_b, ycorr, nreps, sync_every, inner)
    return alpha, beta, delta, ycorr


def gumbel_panel(shape, gen: Optional[torch.Generator], device):
    """Standard Gumbel draws -log(-log(u)), u uniform on [float32 tiny, 1)
    as jax.random.gumbel draws it: always finite."""
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=_TINY)
    return u.log_().neg_().log_().neg_()


def sweep_blocks_bayesr_grouped(gm: GroupedPackedMarkers, alpha, delta,
                                ycorr, vare, sigma_sq, pi_mat,
                                gen: Optional[torch.Generator],
                                nreps: int = 1,
                                sync_every: Optional[int] = None,
                                draws: Optional[Draws] = None):
    """Group-sequential fast-blocks BayesR sweep (BayesR.jl:45-97) on the
    schedule of sweep_blocks_abc_grouped.

    alpha (p_pad,) float32, delta (p_pad,) int32 class labels 0..3 and
    ycorr (n_obs,) are updated in place and returned. vare and sigma_sq are
    0-d tensors; pi_mat (p_pad, 4) class priors, padded rows [1, 0, 0, 0].
    Round r of group g takes its (reps * b, gb, 4) Gumbel and (reps * b, gb)
    normal panels from draws(g, r, reps) when given (tests inject the JAX
    package's), else from gen, in group and round order.
    """
    nblocks, b, _ = gm.grams.shape
    gb = nblocks // gm.store.shape[0]
    inv_vare = (1.0 / vare).reshape(1)
    sigma = sigma_sq.reshape(1)
    log_pi = torch.log(torch.clamp(pi_mat, 1e-12, 1.0)).view(nblocks, b, 4)
    xpx_b = gm.xpx.view(nblocks, b)
    alpha_b, delta_b = alpha.view(nblocks, b), delta.view(nblocks, b)
    if draws is None:
        def draws(g, r, reps):
            return (gumbel_panel((reps * b, gb, 4), gen, ycorr.device),
                    torch.randn((reps * b, gb), generator=gen, device=ycorr.device))

    def inner(blk, rhs, g, r, reps):
        gum, zs = draws(g, r, reps)
        bayesr_inner_rounds(gm.grams[blk], xpx_b[blk], log_pi[blk],
                            alpha_b[blk], delta_b[blk], rhs, gum, zs,
                            inv_vare, sigma, reps)

    _walk_groups(gm, alpha_b, ycorr, nreps, sync_every, inner)
    return alpha, delta, ycorr


@contextlib.contextmanager
def _full_f32_matmul():
    """Gram tiles feed the exact-conditional marker updates, so the f32
    path must not round its inputs to TF32's 10-bit mantissa; the flag is
    set explicitly rather than trusted to its default."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _decode_codes(rows, n_obs: int, row_perm):
    """(sc, bpm) bytes -> (sc, n_obs) uint8 codes in observation order."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=rows.device)
    codes = ((rows[:, :, None] >> shifts) & 3).reshape(rows.shape[0], -1)
    if row_perm is None:
        return codes[:, :n_obs]
    return codes.index_select(1, row_perm)


def _gram_exact(codes, mns, b: int, n_obs: int):
    """Z'Z - m s' - s m' + n m m' with the integer code matrix Z; exact in
    bf16 with f32 accumulation (sums stay below 2^24)."""
    scb = codes.shape[0] // b
    zc = codes.view(scb, b, n_obs)
    s = zc.sum(dim=2, dtype=torch.float32)
    if codes.is_cuda:
        z = zc.to(torch.bfloat16)
        zz = torch.bmm(z, z.transpose(1, 2), out_dtype=torch.float32)
    else:
        # CPU bf16 matmuls return bf16; f32 is exact for these integers
        z = zc.to(torch.float32)
        zz = torch.bmm(z, z.transpose(1, 2))
    m = mns.view(scb, b)
    return (zz - m[:, :, None] * s[:, None, :] - s[:, :, None] * m[:, None, :]
            + n_obs * m[:, :, None] * m[:, None, :])


def _gram_f32(codes, mns, b: int, n_obs: int):
    scb = codes.shape[0] // b
    x = codes.to(torch.float32)
    m = mns[:, None]
    x = torch.where(x == 3.0, m, x) - m
    xb = x.view(scb, b, n_obs)
    with _full_f32_matmul():
        return torch.bmm(xb, xb.transpose(1, 2))


def _sub_chunk(G: int, b: int, n_obs: int, budget_bytes: int) -> int:
    """Markers per decode sub-chunk: the (sc, n) f32 tile within budget,
    sc a multiple of b that divides G."""
    sc = max(b, min(G, (budget_bytes // max(4 * n_obs, 1)) // b * b))
    while G % sc:
        sc -= b
    return max(b, sc)


_DECODE_BYTES = 1 << 30     # bound on one decoded (markers, n) f32 tile


def grouped_stats(store, means, valid, row_perm, b: int, n_obs: int,
                  exact_bf16: bool = False):
    """Gram tiles (nblocks, b, b) and xpx (p_pad,) in one pass over the
    store (GibbsMats, tools4genotypes.jl:237-275), a plain decode plus
    batched matmuls.

    exact_bf16 needs unit weights, identity row order and no missing codes
    (callers check the last with store_has_missing): the integer codes go
    through bf16 tensor-core matmuls with f32 accumulation, exactly.
    """
    if exact_bf16 and row_perm is not None:
        raise ValueError("grouped_stats(exact_bf16=True) requires identity "
                         "row order (row_perm=None)")
    ngroups, G, _ = store.shape
    sc = _sub_chunk(G, b, n_obs, _DECODE_BYTES)
    gram_fn = _gram_exact if exact_bf16 else _gram_f32
    grams = torch.empty((ngroups * G // b, b, b), dtype=torch.float32,
                        device=store.device)
    for g in range(ngroups):
        for c0 in range(0, G, sc):
            k0 = g * G + c0
            codes = _decode_codes(store[g, c0:c0 + sc], n_obs, row_perm)
            grams[k0 // b:(k0 + sc) // b] = gram_fn(
                codes, means[k0:k0 + sc], b, n_obs)
    xpx = torch.diagonal(grams, dim1=1, dim2=2).reshape(-1)
    xpx = torch.where(valid > 0, torch.clamp(xpx, min=1e-10),
                      torch.ones_like(xpx))
    return grams, xpx


def build_grouped_markers(packed, means, n_obs: int, block_size: int,
                          group_blocks: int, device, row_perm=None,
                          has_missing: bool = True) -> GroupedPackedMarkers:
    """Place a (p, bpm) 2-bit store on `device` in the grouped layout and
    compute its Gram tiles.

    packed: numpy array (a memmap is copied in chunks) or a tensor (used
    without a copy when it is already on the device and p needs no
    padding). means: (p,) marker means. row_perm: (n_obs,) store column of
    each observation, or None for the identity. has_missing=False promises
    that no code is 3 (the store's flag): X'w then builds one lookup table
    instead of two, and with the identity row order the Gram tiles take
    the exact bf16 path.
    """
    device = torch.device(device)
    p, bpm = packed.shape
    b, gb = block_size, group_blocks
    align = b * gb
    p_pad = -(-p // align) * align
    ngroups = p_pad // align
    if row_perm is None and n_obs > 4 * bpm:
        raise ValueError(f"n_obs={n_obs} exceeds the store's {4 * bpm} columns")
    if row_perm is not None:
        row_perm = np.asarray(row_perm, dtype=np.int64)
        if row_perm.shape != (n_obs,) or not ((0 <= row_perm) & (row_perm < 4 * bpm)).all():
            raise ValueError(f"row_perm must hold {n_obs} store columns in "
                             f"[0, {4 * bpm})")
    in_place = torch.is_tensor(packed) and packed.device == device and p_pad == p
    need = (0 if in_place else p_pad * bpm) + p_pad * b * 4     # + Gram tiles
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if need > free:
            raise NotImplementedError(
                f"store of {need / 1e9:.1f} GB (with Gram tiles) exceeds free "
                f"device memory ({free / 1e9:.1f} GB); host streaming is not "
                f"ported yet"
            )
    if in_place:
        flat = packed.contiguous()
    else:
        flat = torch.zeros((p_pad, bpm), dtype=torch.uint8, device=device)
        step = max(1, (1 << 28) // max(bpm, 1))
        for c0 in range(0, p, step):
            src = packed[c0:c0 + step]
            if not torch.is_tensor(src):
                src = torch.from_numpy(np.array(src))   # a copy: memmaps are read-only
            flat[c0:c0 + src.shape[0]] = src.to(device)
    store = flat.view(ngroups, align, bpm)
    means_d = torch.zeros(p_pad, dtype=torch.float32, device=device)
    means_d[:p] = torch.as_tensor(means, dtype=torch.float32).to(device)
    valid = torch.zeros(p_pad, dtype=torch.float32, device=device)
    valid[:p] = 1.0
    perm = None
    if row_perm is not None:
        perm = torch.from_numpy(row_perm).to(device)
    grams, xpx = grouped_stats(store, means_d, valid, perm, b, n_obs,
                               exact_bf16=perm is None and not has_missing)
    return GroupedPackedMarkers(store=store, means=means_d, row_perm=perm,
                                xpx=xpx, grams=grams, valid=valid,
                                n_obs=n_obs, has_missing=has_missing)
