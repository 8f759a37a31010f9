"""Table-driven GEMVs over one 2-bit packed tile: the CUDA kernels, their
plain versions, and the table arithmetic of the kernels in plain PyTorch.

Counterparts: jwas_tpu/ops/pallas_packed_gemv.py:55 (_rhs_kernel, X'w) and
:105 (_matvec_kernel, Xv), and the grouped path's XLA plane GEMVs
jwas_tpu/ops/grouped.py:298 (_plane_rhs) and :319 (_plane_matvec), with
missing codes (3 -> marker mean) handled. The CUDA kernels are in
csrc/packed_gemv.cu; its head note says what bounds them and why they look
up tables in shared memory instead of decoding code by code.

Both work in store order: rows (G, bpm) uint8, a byte holding observations
4i..4i+3 (low bits first); w_pad / the Xv result are (4 * bpm,) float32. The
observation permutation (row_perm) is applied by the caller
(ops/grouped.py: store_order / unpad).

packed_rhs_ref / packed_matvec_ref are the plain versions (bit planes and
matrix products). packed_rhs_tables_ref / packed_matvec_tables_ref repeat
the kernels' own arithmetic (byte-position tables in the kernel's bank
layout; compaction of the rows with v != 0, the two-row nibble index and
the 16-entry pair tables), so that the index and layout logic the CUDA code
relies on is tested on the CPU.
"""

from __future__ import annotations

import functools

import torch

from jwas_tpu_torch import _build


def _planes(rows, dtype):
    for j in range(4):
        yield ((rows >> (2 * j)) & 3).to(dtype)


def packed_rhs_ref(rows, means, w_pad):
    """X' w for one tile, from the four bit planes (grouped.py:298-316)."""
    dtype = w_pad.dtype
    w4 = w_pad.view(-1, 4)                       # (bpm, 4)
    m = means.to(dtype)
    acc = torch.zeros(rows.shape[0], dtype=dtype, device=rows.device)
    miss = torch.zeros_like(acc)
    for j, cj in enumerate(_planes(rows, dtype)):
        acc += cj @ w4[:, j]
        miss += (cj == 3.0).to(dtype) @ w4[:, j]
    return acc - m * w_pad.sum() + (m - 3.0) * miss


def packed_matvec_ref(rows, means, v):
    """X v for one tile in store order (4 * bpm,), (grouped.py:319-334)."""
    dtype = v.dtype
    m = means.to(dtype)
    mv3 = (m - 3.0) * v
    parts = [cj.T @ v + (cj == 3.0).to(dtype).T @ mv3
             for cj in _planes(rows, dtype)]
    return torch.stack(parts, dim=1).reshape(-1) - m @ v


# Byte positions of a row that one CTA of the X'w kernel owns: one 128 KB
# table without missing codes, T and M of 64 KB each with them.
RHS_SLAB = {False: 128, True: 64}
_RHS_ROWS = 512          # rows one pass of a CTA's 16 warps covers
_RHS_TABLE_ROWS = 128    # a CTA's table build costs about this many rows
MV_MAX_CHUNK = 512       # rows of v one CTA of the Xv kernel compacts
MV_BATCH = 16            # listed rows a lane of the Xv kernel loads at once
_MV_WORDS = 256          # 32-bit words of a row one CTA of the Xv kernel owns


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slab_column(i, slab: int):
    """Column of a slab's table row that holds byte position i of the slab.
    A lane holds positions 4l..4l+3, so byte q of every lane lies in columns
    q * slab / 4 + l: 32 lanes, 32 banks."""
    return (i % 4) * (slab // 4) + i // 4


def _code_terms(dtype, device):
    """(256, 4) value c of code s of a byte where c < 3 (else 0), and the
    indicator of c == 3."""
    beta = torch.arange(256, device=device)
    c = (beta[:, None] >> (2 * torch.arange(4, device=device))) & 3
    return torch.where(c < 3, c, 0).to(dtype), (c == 3).to(dtype)


def byte_tables(w_pad, slab: int, missing: bool):
    """The X'w kernel's tables, (nslabs, 256, slab) in its layout:
    T[s, beta, slab_column(i)] = sum_j [beta_j < 3] beta_j w[4 (s slab + i) + j]
    and, when missing, M likewise with [beta_j == 3] (else None)."""
    bpm = w_pad.shape[0] // 4
    nslabs = _cdiv(bpm, slab)
    w4 = torch.zeros((nslabs * slab, 4), dtype=w_pad.dtype, device=w_pad.device)
    w4[:bpm] = w_pad.view(bpm, 4)
    col = slab_column(torch.arange(slab, device=w_pad.device), slab)

    def table(terms):
        t = terms[None, :, :] * w4[:, None, :]            # (pos, 256, 4)
        t = (t[..., 3] + t[..., 2]) + (t[..., 1] + t[..., 0])
        out = torch.empty((nslabs, 256, slab), dtype=w_pad.dtype,
                          device=w_pad.device)
        out[:, :, col] = t.view(nslabs, slab, 256).transpose(1, 2)
        return out

    vt, vm = _code_terms(w_pad.dtype, w_pad.device)
    return table(vt), table(vm) if missing else None


def packed_rhs_tables_ref(rows, means, w_pad, has_missing: bool = True):
    """X' w as the CUDA kernel computes it: per-slab byte tables, one lookup
    a byte, m_k times the slab's sum of w taken off, per-slab partial sums
    added in slab order."""
    G, bpm = rows.shape
    slab = RHS_SLAB[bool(has_missing)]
    T, M = byte_tables(w_pad, slab, has_missing)
    nslabs = T.shape[0]
    beta = torch.zeros((G, nslabs * slab), dtype=torch.long, device=rows.device)
    beta[:, :bpm] = rows
    beta = beta.view(G, nslabs, slab)
    s_idx = torch.arange(nslabs, device=rows.device)[None, :, None]
    col = slab_column(torch.arange(slab, device=rows.device), slab)[None, None, :]
    m = means.to(w_pad.dtype)
    partial = T[s_idx, beta, col].sum(dim=2)               # (G, nslabs)
    if has_missing:
        partial = partial + m[:, None] * M[s_idx, beta, col].sum(dim=2)
    wsum = torch.zeros(nslabs * slab * 4, dtype=w_pad.dtype, device=rows.device)
    wsum[:4 * bpm] = w_pad
    partial = partial - m[:, None] * wsum.view(nslabs, -1).sum(dim=1)
    out = torch.zeros(G, dtype=w_pad.dtype, device=rows.device)
    for s in range(nslabs):
        out = out + partial[:, s]
    return out


def nonzero_rows(v, k0: int, k1: int, batch: int = MV_BATCH):
    """Rows k0 <= k < k1 with v[k] != 0, in order, filled up to a multiple of
    `batch` with k0; and the (len, 4) values {0, v, 2v, 0} of each listed row
    (all 0 for the fill), whose last column the caller sets to m v."""
    idx = k0 + torch.nonzero(v[k0:k1] != 0)[:, 0]
    fill = -idx.shape[0] % batch
    vk = torch.cat([v[idx], v.new_zeros(fill)])
    idx = torch.cat([idx, idx.new_full((fill,), k0)])
    zero = torch.zeros_like(vk)
    return idx, torch.stack([zero, vk, 2.0 * vk, zero], dim=1)


def pair_index_words(a, b):
    """The same 32-bit word (int64 tensors) of two rows -> (even, odd):
    nibble k of `even` is a_f | b_f << 2 for the 2-bit field f = 2k, of `odd`
    for f = 2k + 1."""
    m3, mc = 0x33333333, 0xCCCCCCCC
    return (a & m3) | ((b << 2) & mc), ((a >> 2) & m3) | (b & mc)


def _row_words(rows):
    """(G, bpm) bytes -> (G, nwords) little-endian 32-bit words as int64."""
    G, bpm = rows.shape
    nwords = _cdiv(bpm, 4)
    b = torch.zeros((G, nwords * 4), dtype=torch.long, device=rows.device)
    b[:, :bpm] = rows
    b = b.view(G, nwords, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def packed_matvec_tables_ref(rows, means, v, rows_per_chunk: int = MV_MAX_CHUNK):
    """X v as the CUDA kernel computes it: per chunk of rows, the rows with
    v != 0 two at a time, one 16-entry table a pair indexed by the two rows'
    codes of an observation, the chunk's share of m'v taken off; chunks
    added in order."""
    G, bpm = rows.shape
    words = _row_words(rows)
    nwords = words.shape[1]
    m = means.to(v.dtype)
    e = torch.arange(16, device=rows.device)
    shifts = 4 * torch.arange(8, device=rows.device)
    out = torch.zeros((nwords, 16), dtype=v.dtype, device=rows.device)
    for k0 in range(0, G, rows_per_chunk):
        idx, lut = nonzero_rows(v, k0, min(G, k0 + rows_per_chunk))
        lut[:, 3] = m[idx] * lut[:, 1]
        lut = lut.view(-1, 2, 4)                           # (pairs, row, code)
        table = lut[:, 0, e & 3] + lut[:, 1, e >> 2]       # (pairs, 16)
        w = words[idx].view(-1, 2, nwords)
        even, odd = pair_index_words(w[:, 0], w[:, 1])
        # (pairs, nwords, 8, 2): field 2k of `even`, 2k + 1 of `odd`
        nib = torch.stack([(even[..., None] >> shifts) & 15,
                           (odd[..., None] >> shifts) & 15], dim=-1)
        pair = torch.arange(table.shape[0], device=rows.device)[:, None, None, None]
        part = table[pair, nib].sum(dim=0).reshape(nwords, 16)
        out = out + (part - lut[:, :, 3].sum())
    return out.reshape(-1)[:4 * bpm]


def _check(name, rows, means, vec, vec_len):
    G, bpm = rows.shape
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rows.device}")
    if rows.dtype != torch.uint8 or not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous uint8 (G, bpm)")
    for label, t, n in (("means", means, G), ("vector", vec, vec_len)):
        if t.device != rows.device:
            raise ValueError(f"{name}: {label} is on {t.device}, rows on {rows.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous float32 ({n},)")


@functools.lru_cache(maxsize=None)
def rhs_plan(G: int, bpm: int, has_missing: bool, sms: int):
    """(slab, rows_per_cta) of the X'w kernel: a CTA takes one slab of byte
    positions and rows_per_cta rows. One CTA fits an SM (its tables take
    128 KB), so the split of the rows is the one whose waves of CTAs over
    the SMs cost least, a table build counted as _RHS_TABLE_ROWS rows."""
    slab = RHS_SLAB[bool(has_missing)]
    nslabs = _cdiv(bpm, slab)
    best = None
    for split in range(1, 33):
        rows_per_cta = _cdiv(G, split * _RHS_ROWS) * _RHS_ROWS
        waves = _cdiv(nslabs * _cdiv(G, rows_per_cta), sms)
        cost = waves * (rows_per_cta + _RHS_TABLE_ROWS)
        if best is None or cost < best[0]:
            best = (cost, rows_per_cta)
    return slab, best[1]


def packed_rhs(rows, means, w_pad, has_missing: bool = True):
    """X' w over a (G, bpm) tile; w_pad is store-ordered (4 * bpm,).

    has_missing=False promises that the tile holds no code 3 (the store's
    flag): the kernel then builds and reads one table instead of two.
    CUDA tensors launch the kernel (raising if it cannot run); CPU tensors
    take packed_rhs_ref.
    """
    if rows.device.type == "cpu":
        return packed_rhs_ref(rows, means, w_pad)
    G, bpm = rows.shape
    _check("packed_rhs", rows, means, w_pad, 4 * bpm)
    slab, rows_per_cta = rhs_plan(G, bpm, bool(has_missing),
                                  _sm_count(rows.device.index or 0))
    partial = torch.empty((_cdiv(bpm, slab), G), dtype=torch.float32,
                          device=rows.device)
    out = torch.empty(G, dtype=torch.float32, device=rows.device)
    err = _build.library().jt_packed_rhs(
        rows.data_ptr(), means.data_ptr(), w_pad.data_ptr(),
        partial.data_ptr(), out.data_ptr(), G, bpm, int(bool(has_missing)),
        slab, rows_per_cta, _build.stream_of(rows),
    )
    _build.check(err, "packed_rhs")
    packed_rhs.launches += 1
    return out


packed_rhs.launches = 0


@functools.lru_cache(maxsize=None)
def matvec_plan(G: int, bpm: int, slots: int) -> int:
    """rows_per_chunk of the Xv kernel: as many row chunks as fill the
    card's `slots` resident CTAs once (a CTA owns _MV_WORDS words of the row
    and one chunk), chunks of 16 to MV_MAX_CHUNK rows."""
    col_ctas = _cdiv(_cdiv(bpm, 4), _MV_WORDS)
    nchunks = min(max(slots // col_ctas, _cdiv(G, MV_MAX_CHUNK)), _cdiv(G, 16))
    return _cdiv(G, nchunks)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _slots(index: int) -> int:
    per_sm = _build.library().jt_packed_matvec_ctas_per_sm()
    if per_sm <= 0:
        raise RuntimeError(f"packed_matvec: occupancy query failed ({per_sm})")
    return per_sm * _sm_count(index)


def matvec_slots(device) -> int:
    """CTAs of the Xv kernel that the card holds at once."""
    return _slots(torch.device(device).index or 0)


def packed_matvec(rows, means, v):
    """X v over a (G, bpm) tile, returned in store order (4 * bpm,).

    CUDA tensors launch the kernel (raising if it cannot run); CPU tensors
    take packed_matvec_ref.
    """
    if rows.device.type == "cpu":
        return packed_matvec_ref(rows, means, v)
    G, bpm = rows.shape
    _check("packed_matvec", rows, means, v, G)
    rows_per_chunk = matvec_plan(G, bpm, matvec_slots(rows.device))
    partial = torch.empty((_cdiv(G, rows_per_chunk), 4 * bpm),
                          dtype=torch.float32, device=rows.device)
    out = torch.empty(4 * bpm, dtype=torch.float32, device=rows.device)
    err = _build.library().jt_packed_matvec(
        rows.data_ptr(), means.data_ptr(), v.data_ptr(), partial.data_ptr(),
        out.data_ptr(), G, bpm, rows_per_chunk, _build.stream_of(rows),
    )
    _build.check(err, "packed_matvec")
    packed_matvec.launches += 1
    return out


packed_matvec.launches = 0


HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA's data sheet
ZERO_SHARES = (0.0, 0.95, 0.999)     # shares of v zero at which Xv is timed


def bound_ms(G: int, bpm: int, rows_read: int) -> float:
    """Least milliseconds the card could take for one X'w or X v over a
    (G, bpm) tile: the rows the function needs read once (all G for X'w,
    those with v != 0 for X v), means and the G-vector read or written
    once, the (4 * bpm,) vector likewise, over the memory rate. What a
    kernel moves besides (its partial sums) is no part of the bound."""
    return (rows_read * bpm + 8 * G + 16 * bpm) / HBM_BYTES_PER_S * 1e3
