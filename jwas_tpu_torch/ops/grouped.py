"""Group-sequential fast-blocks BayesC/B and BayesR over a 2-bit store held
on the device, in pinned host memory, or split between the two.

Counterpart of jwas_tpu/ops/grouped.py: GroupedPackedMarkers (:47),
STALE_FRACTION and pick_stable_blocks (:117-162), plan_device_groups
(:165-185), grouped_matvec and grouped_rhs (:411-454),
sweep_blocks_abc_grouped (:460-617), sweep_blocks_bayesr_grouped
(:623-764), grouped_stats (:808-882) and build_grouped_markers (:885-969),
with jwas_tpu/engine/mcmc.py::_resolve_host_offload (:738-759).

The store is (p, bpm) uint8, marker-major, never padded or copied whole:
groups of G = b * gb markers are visited in order (exact across groups),
and the last group may be short in the store. The fetcher serves it as G
rows, its missing rows zero (the padding markers of the p_pad layout: code
0, mean 0, so they decode to zero), so means, valid, Grams and the chain
state stay at p_pad and the chain is the padded layout's. Within a group the b * gb markers of gb blocks update in parallel
against a residual that is reconciled every sync round. Each round is one
X'w GEMV (packed_rhs), one inner-rounds launch (abc_inner_rounds or
bayesr_inner_rounds) and one Xv GEMV (packed_matvec); on a CUDA device all
three are hand-written kernels.

GroupFetcher serves each group's rows on the chain's device. Groups are
resident (the whole store on the device, used in place), or the leading k
of them are (hybrid) and the rest are copied from pinned host memory, one
group ahead, into a ring of device buffers on a copy stream of their own.
This replaces the JAX package's _stage / hybridize / _hybrid_copy /
prefetch.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from jwas_tpu_torch.ops import markers as mk
from jwas_tpu_torch.ops.inner_rounds import abc_inner_rounds, bayesr_inner_rounds
from jwas_tpu_torch.ops.packed_gemv import packed_matvec, packed_rhs

# Parallel-update stability cap b * gb <= STALE_FRACTION * n: see the JAX
# package (ops/grouped.py:101-116) for the measurements behind it.
STALE_FRACTION = 0.4

# host offload "auto": stream when the store exceeds this share of the
# device's memory (jwas_tpu/engine/mcmc.py:738-759)
OFFLOAD_SHARE = 0.6
RING_DEPTH = 2            # device buffers a streamed store cycles through

Draws = Callable[[int, int, int], Tuple[torch.Tensor, torch.Tensor]]

# float32 tiny: the lower end of the uniforms under jax.random.gumbel
_TINY = torch.finfo(torch.float32).tiny


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def hbm_budget(device=None, default: int = int(16e9)) -> int:
    """Bytes of device memory the residence decisions and the memory guard
    plan with: the JWAS_HBM_BYTES environment variable when set, else the
    card's total memory, else (no card) default, the JAX package's 16e9 of
    plan_device_groups (its memory guard stands in 16 GiB)."""
    env = os.environ.get("JWAS_HBM_BYTES")
    if env:
        return int(float(env))
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(default)


def store_nbytes(packed) -> int:
    """Bytes of a (p, bpm) store: a numpy array, a memmap or a tensor."""
    if torch.is_tensor(packed):
        return packed.numel() * packed.element_size()
    return int(packed.nbytes)


def resolve_host_offload(flag, packed_bytes: int, device) -> bool:
    """Whether the store streams from host memory (runMCMC's
    host_offload_genotypes): True, False, or "auto", which streams when the
    store's host-side bytes exceed OFFLOAD_SHARE of the device's memory
    (hbm_budget). Decided before anything of the store reaches the device;
    "auto" never offloads on the CPU."""
    if flag is True or flag is False:
        return flag
    if flag != "auto":
        raise ValueError("host_offload_genotypes must be True, False or 'auto'")
    device = torch.device(device)
    if device.type != "cuda":
        return False
    return packed_bytes > OFFLOAD_SHARE * hbm_budget(device)


def hybrid_budget(k: int, ngroups: int, G: int, b: int, bpm: int,
                  cushion: int = 7 << 29) -> int:
    """The budget (JWAS_HBM_BYTES) with which plan_store keeps exactly the
    leading k of a streamed store's ngroups groups on the device."""
    return ngroups * G * b * 4 + cushion + k * G * bpm


def plan_device_groups(ngroups: int, G: int, bpm: int, grams_bytes: int,
                       budget: Optional[int] = None,
                       cushion: int = 7 << 29) -> int:
    """Hybrid split: how many leading groups of a streamed store fit in the
    device memory left beside the Gram tiles and a cushion (3.5 GB by
    default) for the chain state, the staging ring and decode tiles.
    budget defaults to hbm_budget() of the current CUDA device."""
    if budget is None:
        budget = hbm_budget(torch.device("cuda", torch.cuda.current_device())
                            if torch.cuda.is_available() else None)
    free = budget - int(grams_bytes) - cushion
    per_group = G * bpm
    if per_group <= 0 or free <= 0:
        return 0
    return max(0, min(ngroups, free // per_group))


def _copy_rows(src, dst, step_bytes: int = 1 << 28) -> None:
    """dst[:] = src in row chunks; src a numpy array (a read-only memmap is
    read a chunk at a time) or a tensor on any device."""
    p, bpm = dst.shape
    step = max(1, step_bytes // max(bpm, 1))
    for c0 in range(0, p, step):
        part = src[c0:min(p, c0 + step)]
        if not torch.is_tensor(part):
            part = torch.from_numpy(np.array(part))   # memmaps are read-only
        dst[c0:c0 + part.shape[0]].copy_(part)


def pinned_copy(packed) -> torch.Tensor:
    """A (p, bpm) store copied, in chunks, into pinned host memory, from
    which a streamed store is copied to the card asynchronously."""
    p, bpm = packed.shape
    out = torch.empty((p, bpm), dtype=torch.uint8, pin_memory=True)
    _copy_rows(packed, out)
    return out


class GroupFetcher:
    """Serves each group of a (p, bpm) store on the chain's device as G
    rows: rows g * G .. (g + 1) * G, the missing rows of a short last group
    as zero rows.

    The leading `resident` groups are read on the device: the store itself
    when it lies there whole, else a zero-padded device copy of their rows.
    The others stream: on a CUDA device the store must be in pinned host
    memory, and a group's rows are copied into one of RING_DEPTH
    preallocated device buffers of G rows on a dedicated stream (the rows
    after a short last group's are zeroed there). The copy of group g + 1 is
    enqueued before group g's work, the compute stream waits on an event
    recorded after the copy, and the copy stream waits on an event recorded
    after a buffer's last reader before it overwrites that buffer. On the
    CPU the streamed groups are read from the store in place. A short last
    group that would be read in place is served from a zero-padded copy of
    its rows, made once.

    With record set, each copy's start and end events and bytes are kept in
    `copies` (timing only)."""

    def __init__(self, store: torch.Tensor, G: int, device, resident: int):
        self.device = torch.device(device)
        self.store = store
        self.G = G
        self.p, self.bpm = store.shape
        self.ngroups = max(1, _cdiv(self.p, G))
        self.resident = k = max(0, min(int(resident), self.ngroups))
        in_place = k == self.ngroups and store.device == self.device
        if in_place:
            self.dev = store
        elif k > 0:
            self.dev = torch.zeros((k * G, self.bpm), dtype=torch.uint8,
                                   device=self.device)
            _copy_rows(store, self.dev[:min(self.p, k * G)])
        else:
            self.dev = None
        self.ring = None
        self.record = False
        self.copies = []
        if k < self.ngroups and self.device.type == "cuda":
            if store.device.type != "cpu" or not store.is_pinned():
                raise ValueError(
                    "a store that streams to the card must be a CPU tensor in "
                    "pinned host memory (grouped.pinned_copy); a pageable "
                    "source would make every copy synchronous")
            self.ring = [torch.empty((G, self.bpm), dtype=torch.uint8,
                                     device=self.device)
                         for _ in range(RING_DEPTH)]
            self.copy_stream = torch.cuda.Stream(self.device)
            self.ready = [torch.cuda.Event() for _ in self.ring]
            self.free = [None] * len(self.ring)
        last = (self.ngroups - 1) * G
        self.tail = None
        if self.p - last < G and (in_place or (k < self.ngroups and self.ring is None)):
            self.tail = torch.zeros((G, self.bpm), dtype=torch.uint8,
                                    device=self.device)
            self.tail[:self.p - last].copy_(store[last:])

    def _slot(self, g: int) -> int:
        return (g - self.resident) % len(self.ring)

    def _enqueue(self, g: int) -> None:
        """Start the copy of streamed group g into its ring buffer."""
        if self.ring is None or not self.resident <= g < self.ngroups:
            return
        s = self._slot(g)
        r0, r1 = g * self.G, min(self.p, (g + 1) * self.G)
        cs = self.copy_stream
        if self.free[s] is not None:
            cs.wait_event(self.free[s])
        with torch.cuda.stream(cs):
            if self.record:
                t0 = torch.cuda.Event(enable_timing=True)
                t0.record(cs)
            self.ring[s][:r1 - r0].copy_(self.store[r0:r1], non_blocking=True)
            if r1 - r0 < self.G:
                self.ring[s][r1 - r0:].zero_()
            self.ready[s].record(cs)
            if self.record:
                t1 = torch.cuda.Event(enable_timing=True)
                t1.record(cs)
                self.copies.append((t0, t1, (r1 - r0) * self.bpm))

    def rows(self, g: int) -> torch.Tensor:
        """Group g's G rows, ready for the current stream."""
        r0 = g * self.G
        if g == self.ngroups - 1 and self.tail is not None:
            return self.tail
        if g < self.resident:
            return self.dev[r0:r0 + self.G]
        if self.ring is None:
            return self.store[r0:r0 + self.G]
        s = self._slot(g)
        torch.cuda.current_stream(self.device).wait_event(self.ready[s])
        return self.ring[s]

    def release(self, g: int) -> None:
        """Group g's rows have had their last reader on the current stream."""
        if self.ring is None or g < self.resident:
            return
        s = self._slot(g)
        if self.free[s] is None:
            self.free[s] = torch.cuda.Event()
        self.free[s].record(torch.cuda.current_stream(self.device))

    def groups(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """(g, rows) in group order. The copy of group g + 1 is enqueued
        before group g is handed out; group g is released when the caller
        asks for the next one."""
        self._enqueue(0)
        for g in range(self.ngroups):
            rows = self.rows(g)
            self._enqueue(g + 1)
            yield g, rows
            self.release(g)

    def copy_seconds(self) -> Tuple[float, int]:
        """(seconds, bytes) of the recorded copies; waits for them."""
        if not self.copies:
            return 0.0, 0
        torch.cuda.synchronize(self.device)
        ms = sum(t0.elapsed_time(t1) for t0, t1, _ in self.copies)
        return ms / 1e3, sum(nb for _, _, nb in self.copies)


class GroupedPackedMarkers(NamedTuple):
    """A grouped store: fetch serves its groups; nblocks, b, _ = grams.shape;
    gb = nblocks // fetch.ngroups; p_pad = nblocks * b."""

    fetch: GroupFetcher
    means: torch.Tensor               # (p_pad,) float32, 0 for padding
    row_perm: Optional[torch.Tensor]  # (n_obs,) int64 store column per
                                      # observation, or None (identity)
    xpx: torch.Tensor                 # (p_pad,) diag of X'X (1 for padding)
    grams: torch.Tensor               # (nblocks, b, b) block-major Grams
    valid: torch.Tensor               # (p_pad,) 1 real marker, 0 padding
    n_obs: int
    has_missing: bool = True          # False: the store holds no code 3

    @property
    def store(self) -> torch.Tensor:
        """The (p, bpm) store, wherever it lives."""
        return self.fetch.store

    @property
    def ngroups(self) -> int:
        return self.fetch.ngroups

    @property
    def device(self) -> torch.device:
        return self.means.device


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


def resolve_blocks(n_obs: int, fast_blocks, p: int, warn: bool = True):
    """(b, gb) as runMCMC picks them for storage='2bit'
    (jwas_tpu/engine/mcmc.py:786-844): fast_blocks True or False for the
    default block size from n_obs, else an int block size, rounded up to a
    multiple of 8 and cut by pick_stable_blocks, which warns (with warn)
    only when the caller sized the blocks."""
    if fast_blocks is True or not fast_blocks:
        bs = mk.default_block_size(n_obs)
    else:
        bs = int(fast_blocks)
    bs = max(8, ((bs + 7) // 8) * 8)
    user_sized = fast_blocks is not True and bool(fast_blocks)
    return pick_stable_blocks(n_obs, bs, p, warn=warn and user_sized)


def plan_store(n_obs: int, packed, fast_blocks, host_offload, device,
               warn: bool = False):
    """(b, gb, host, resident): the blocks, whether the store streams from
    host memory (resolve_host_offload; "auto" keeps a store that already
    lies on the card there) and how many leading groups are on the device
    (all unless it streams, else plan_device_groups with hbm_budget)."""
    device = torch.device(device)
    p, bpm = packed.shape
    b, gb = resolve_blocks(n_obs, fast_blocks, p, warn=warn)
    on_card = torch.is_tensor(packed) and packed.device.type == "cuda"
    host = resolve_host_offload(host_offload, 0 if on_card else store_nbytes(packed),
                                device)
    G = b * gb
    ngroups = _cdiv(p, G)
    resident = ngroups
    if host:
        resident = plan_device_groups(ngroups, G, bpm, ngroups * G * b * 4,
                                      hbm_budget(device))
    return b, gb, host, resident


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
    G = gm.fetch.G
    acc = None
    for g, rows in gm.fetch.groups():
        sl = slice(g * G, (g + 1) * G)
        part = packed_matvec(rows, gm.means[sl], v[sl])
        acc = part if acc is None else acc + part
    return acc


def grouped_matvec(gm: GroupedPackedMarkers, v):
    """X v over the whole store, (n_obs,) in observation order."""
    return unpad(grouped_matvec_store(gm, v), gm.n_obs, gm.row_perm)


def grouped_rhs(gm: GroupedPackedMarkers, w):
    """X' w over the whole store, (p_pad,)."""
    G = gm.fetch.G
    w_pad = pad_w(w, gm.fetch.bpm, gm.row_perm)
    return torch.cat([packed_rhs(rows, gm.means[g * G:(g + 1) * G], w_pad,
                                 gm.has_missing)
                      for g, rows in gm.fetch.groups()])


def _walk_groups(gm: GroupedPackedMarkers, alpha_b, ycorr, nreps: int,
                 sync_every: Optional[int], inner) -> None:
    """The grouped schedule shared by the sweeps: groups in order, sync
    rounds within a group. A round is X'w of the group (K4), then
    inner(blk, rhs, g, r, reps), which updates alpha_b[blk] in place, then
    X times the change in alpha (K5) into ycorr, in place."""
    fetch = gm.fetch
    G, bpm = fetch.G, fetch.bpm
    nblocks, b = alpha_b.shape
    gb = nblocks // fetch.ngroups
    rounds = mk.sync_rounds(nreps, mk.resolve_sync_every(nreps, sync_every))
    for g, rows in fetch.groups():
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
    """Group-sequential fast-blocks BayesC / BayesB sweep
    (BayesABC.jl:111-188).

    alpha, beta (p_pad,) float32, delta (p_pad,) int32 and ycorr (n_obs,)
    are updated in place (the chain keeps one copy of its marker state) and
    returned. vare is a 0-d tensor; var_eff the common marker variance
    (0-d, BayesC) or one a marker ((p_pad,), BayesB); pi (p_pad,)
    P(excluded). Round r of group g takes its (reps * b, gb) uniform and
    normal panels from draws(g, r, reps) when given (tests inject the JAX
    package's), else from the chain's generator gen, in group and round
    order.
    """
    nblocks, b, _ = gm.grams.shape
    gb = nblocks // gm.ngroups
    p_pad = nblocks * b
    inv_vare = (1.0 / vare).reshape(1)
    if var_eff.numel() == 1:
        var_eff_b = var_eff.reshape(1).expand(p_pad).contiguous().view(nblocks, b)
    else:
        var_eff_b = var_eff.contiguous().view(nblocks, b)
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
    gb = nblocks // gm.ngroups
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


def grouped_stats(fetch: GroupFetcher, means, valid, row_perm, b: int, n_obs: int,
                  exact_bf16: bool = False):
    """Gram tiles (nblocks, b, b) and xpx (p_pad,) in one pass over the
    store (GibbsMats, tools4genotypes.jl:237-275), a plain decode plus
    batched matmuls, over the groups fetch serves (a streamed store's
    copies overlap the matmuls).

    exact_bf16 needs unit weights, identity row order and no missing codes
    (callers check the last with store_has_missing): the integer codes go
    through bf16 tensor-core matmuls with f32 accumulation, exactly.
    """
    if exact_bf16 and row_perm is not None:
        raise ValueError("grouped_stats(exact_bf16=True) requires identity "
                         "row order (row_perm=None)")
    G = fetch.G
    sc = _sub_chunk(G, b, n_obs, _DECODE_BYTES)
    gram_fn = _gram_exact if exact_bf16 else _gram_f32
    grams = torch.empty((fetch.ngroups * G // b, b, b), dtype=torch.float32,
                        device=means.device)
    for g, rows in fetch.groups():
        for c0 in range(0, G, sc):
            k0 = g * G + c0
            codes = _decode_codes(rows[c0:c0 + sc], n_obs, row_perm)
            grams[k0 // b:(k0 + sc) // b] = gram_fn(
                codes, means[k0:k0 + sc], b, n_obs)
    xpx = torch.diagonal(grams, dim1=1, dim2=2).reshape(-1)
    xpx = torch.where(valid > 0, torch.clamp(xpx, min=1e-10),
                      torch.ones_like(xpx))
    return grams, xpx


def _place(packed, device, host: bool) -> torch.Tensor:
    """The (p, bpm) store as a tensor where it is to live: on the device,
    or with host in host memory (pinned when the device is a card). A
    tensor already there is used in place; anything else is copied once, in
    chunks."""
    target = torch.device("cpu") if host else device
    if torch.is_tensor(packed):
        if packed.dtype != torch.uint8 or packed.dim() != 2:
            raise ValueError("the store must be a (p, bpm) uint8 tensor")
        if host and packed.device.type != "cpu":
            raise ValueError("host_offload needs the store in host memory; it "
                             f"is on {packed.device}")
        if packed.device == target and packed.is_contiguous():
            return packed
    if host and device.type == "cuda":
        return pinned_copy(packed)
    out = torch.empty(tuple(packed.shape), dtype=torch.uint8, device=target)
    _copy_rows(packed, out)
    return out


def build_grouped_markers(packed, means, n_obs: int, block_size: int,
                          group_blocks: int, device, row_perm=None,
                          has_missing: bool = True,
                          host: bool = False) -> GroupedPackedMarkers:
    """A (p, bpm) 2-bit store in the grouped layout with its Gram tiles.

    packed: numpy array (a memmap is copied in chunks) or a tensor. With
    host=False the store lives on `device`: a tensor already there is used
    in place, never copied or padded. With host=True it stays in host
    memory and streams (on a CUDA device it must then be a pinned CPU
    tensor, see pinned_copy), except as many leading groups as
    plan_device_groups fits in the device's memory (hbm_budget), which are
    copied to the device once. means: (p,) marker means.
    row_perm: (n_obs,) store column of each observation, or None for the
    identity. has_missing=False promises that no code is 3 (the store's
    flag): X'w then builds one lookup table instead of two, and with the
    identity row order the Gram tiles take the exact bf16 path.
    """
    device = torch.device(device)
    p, bpm = packed.shape
    b, gb = block_size, group_blocks
    G = b * gb
    p_pad = _cdiv(p, G) * G
    ngroups = p_pad // G
    if row_perm is None and n_obs > 4 * bpm:
        raise ValueError(f"n_obs={n_obs} exceeds the store's {4 * bpm} columns")
    if row_perm is not None:
        row_perm = np.asarray(row_perm, dtype=np.int64)
        if row_perm.shape != (n_obs,) or not ((0 <= row_perm) & (row_perm < 4 * bpm)).all():
            raise ValueError(f"row_perm must hold {n_obs} store columns in "
                             f"[0, {4 * bpm})")
    store = _place(packed, device, host)
    resident = ngroups
    if host:
        resident = plan_device_groups(ngroups, G, bpm, p_pad * b * 4,
                                      hbm_budget(device))
    fetch = GroupFetcher(store, G, device, resident)
    means_d = torch.zeros(p_pad, dtype=torch.float32, device=device)
    means_d[:p] = torch.as_tensor(means, dtype=torch.float32).to(device)
    valid = torch.zeros(p_pad, dtype=torch.float32, device=device)
    valid[:p] = 1.0
    perm = None
    if row_perm is not None:
        perm = torch.from_numpy(row_perm).to(device)
    grams, xpx = grouped_stats(fetch, means_d, valid, perm, b, n_obs,
                               exact_bf16=perm is None and not has_missing)
    return GroupedPackedMarkers(fetch=fetch, means=means_d, row_perm=perm,
                                xpx=xpx, grams=grams, valid=valid,
                                n_obs=n_obs, has_missing=has_missing)
