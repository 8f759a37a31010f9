"""The table arithmetic of the port's CUDA GEMV kernels, on the CPU.

csrc/packed_gemv.cu looks up small tables instead of decoding the 2-bit
codes one by one. The index and layout logic it relies on is repeated in
plain PyTorch in jwas_tpu_torch/ops/packed_gemv.py (byte_tables,
slab_column, packed_rhs_tables_ref; nonzero_rows, pair_index_words,
packed_matvec_tables_ref; rhs_plan, matvec_plan) and held here, on stores
made with numpy from a seed (codes 0..3, a sub-byte tail at n = 53,
bpm % 4 != 0, several slabs with a ragged last one at n = 1001), against the
plain versions, the Pallas kernels in interpret mode and dense float64.
Tolerances as in tests/test_torch_packed_gemv.py: rtol = atol = 1e-4
between float32 versions, 1e-3 against float64 (only the order of summation
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops.pallas_packed_gemv import packed_matvec_fused, packed_rhs_fused
from jwas_tpu_torch.io.packed import pack_codes
from jwas_tpu_torch.ops import packed_gemv as pg
from jwas_tpu_torch.ops.grouped import store_order, unpad


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _store(n, p, seed, missing=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4 if missing else 3, size=(n, p)).astype(np.uint8)
    means = np.array([c[c < 3].mean() for c in codes.T], np.float32)
    x = np.where(codes == 3, means[None, :], codes) - means[None, :]
    return pack_codes(codes), means, x.astype(np.float64), rng


def _t(a):
    return torch.from_numpy(np.array(a))


def test_byte_tables_bank_layout_and_rhs():
    # the layout is a permutation of a slab's positions, and the lanes of a
    # warp (lane l holds positions 4l..4l+3; with a 64-byte slab the upper
    # half-warp holds a second row and takes byte q ^ 1) hit 32 banks
    for slab in (64, 128):
        col = pg.slab_column(torch.arange(slab), slab)
        assert sorted(col.tolist()) == list(range(slab))
        lanes = torch.arange(32)
        lw, half = lanes % (slab // 4), lanes // (slab // 4)
        for step in range(4):
            banks = pg.slab_column(4 * lw + (step ^ half), slab) % 32
            assert len(set(banks.tolist())) == 32, (slab, step)

    # table entries against their definition, ragged last slab included
    rng = np.random.default_rng(5)
    bpm = 150
    w = rng.normal(size=4 * bpm).astype(np.float32)
    for slab in (64, 128):
        T, M = pg.byte_tables(_t(w), slab, True)
        assert T.shape == M.shape == (-(-bpm // slab), 256, slab)
        assert pg.byte_tables(_t(w), slab, False)[1] is None
        for i, beta in ((0, 0b11100100), (77, 0b00011011), (149, 0b10110001)):
            c = [(beta >> (2 * s)) & 3 for s in range(4)]
            t = sum(cs * w[4 * i + s] for s, cs in enumerate(c) if cs < 3)
            m = sum(w[4 * i + s] for s, cs in enumerate(c) if cs == 3)
            at = (i // slab, beta, int(pg.slab_column(i % slab, slab)))
            np.testing.assert_allclose(T[at], t, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(M[at], m, rtol=1e-6, atol=1e-6)
        # positions past the row's end hold zero weights
        pad = pg.slab_column(torch.arange(bpm % slab, slab), slab)
        assert (T[-1][:, pad] == 0).all() and (M[-1][:, pad] == 0).all()

    for n, p, missing in ((53, 512, True), (1001, 96, True), (1001, 96, False)):
        packed, means, x, rng = _store(n, p, n + missing, missing)
        w = rng.normal(size=n).astype(np.float32)
        w_pad = store_order(_t(w), 4 * packed.shape[1], None)
        ref = pg.packed_rhs_ref(_t(packed), _t(means), w_pad).numpy()
        pallas = np.asarray(packed_rhs_fused(jnp.asarray(packed), jnp.asarray(means),
                                             jnp.asarray(w), interpret=True))
        for flag in ((True,) if missing else (False, True)):
            got = pg.packed_rhs_tables_ref(_t(packed), _t(means), w_pad, flag).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got, x.T @ w, rtol=1e-3, atol=1e-3)


def test_pair_tables_compaction_and_matvec():
    # compaction: the rows with v != 0 in order, filled up with rows that
    # add nothing; nothing at all for an all-zero chunk
    v = torch.tensor([0.0, 1.5, 0.0, 0.0, -2.0, 0.0, 0.25, 0.0, 3.0, 0.0])
    idx, lut = pg.nonzero_rows(v, 1, 9, batch=4)
    assert idx.tolist() == [1, 4, 6, 8]
    idx, lut = pg.nonzero_rows(v, 1, 8, batch=4)
    assert idx.tolist() == [1, 4, 6, 1]
    assert lut.tolist() == [[0, 1.5, 3.0, 0], [0, -2.0, -4.0, 0],
                            [0, 0.25, 0.5, 0], [0, 0, 0, 0]]
    assert pg.nonzero_rows(v, 2, 4)[0].numel() == 0
    assert len(pg.nonzero_rows(v, 0, 10)[0]) == pg.MV_BATCH

    # the two-row nibble index against the codes it stands for
    rng = np.random.default_rng(9)
    a, b = (torch.from_numpy(rng.integers(0, 2 ** 32, size=200)) for _ in range(2))
    even, odd = pg.pair_index_words(a, b)
    for f in range(16):
        want = ((a >> (2 * f)) & 3) | (((b >> (2 * f)) & 3) << 2)
        got = ((odd if f % 2 else even) >> (4 * (f // 2))) & 15
        assert (got == want).all(), f

    for n, p in ((53, 512), (1001, 96)):
        packed, means, x, rng = _store(n, p, 100 + n)
        dense = rng.normal(size=p).astype(np.float32)
        sparse = np.where(rng.uniform(size=p) < 0.9, 0.0, dense).astype(np.float32)
        odd_one = np.zeros(p, np.float32)      # a ragged last pair: 3 rows
        odd_one[[3, p // 2, p - 1]] = dense[:3]
        for v, chunk in ((dense, 37), (dense, pg.MV_MAX_CHUNK), (sparse, 64),
                         (odd_one, p), (np.zeros(p, np.float32), 64)):
            got = unpad(pg.packed_matvec_tables_ref(_t(packed), _t(means), _t(v),
                                                    chunk), n, None).numpy()
            ref = unpad(pg.packed_matvec_ref(_t(packed), _t(means), _t(v)),
                        n, None).numpy()
            pallas = np.asarray(packed_matvec_fused(
                jnp.asarray(packed), jnp.asarray(means), jnp.asarray(v),
                n_obs=n, interpret=True))
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got, x @ v, rtol=1e-3, atol=1e-3)


def test_launch_plans_cover_the_tile():
    """rhs_plan and matvec_plan hand the kernels their grids: every row is
    in one CTA's range, a chunk fits the kernel's list, and at the main
    path's shape the CTAs fill the card's 132 SMs in whole waves."""
    assert pg.rhs_plan(16_384, 12_500, False, 132) == (128, 4096)   # 392 CTAs
    assert pg.rhs_plan(16_384, 12_500, True, 132)[0] == 64
    rows_per_chunk = pg.matvec_plan(16_384, 12_500, 5 * 132)
    assert 13 * -(-16_384 // rows_per_chunk) <= 5 * 132 < 13 * (-(-16_384 // rows_per_chunk) + 1)
    for G, bpm, sms, slots in ((1, 1, 132, 660), (7, 14, 132, 660),
                               (3000, 14, 132, 528), (4096, 251, 4, 8),
                               (100_000, 12_500, 132, 660), (16_384, 300_000, 132, 660)):
        for missing in (False, True):
            slab, rows_per_cta = pg.rhs_plan(G, bpm, missing, sms)
            assert slab == pg.RHS_SLAB[missing]
            assert rows_per_cta > 0 and rows_per_cta % 32 == 0
        chunk = pg.matvec_plan(G, bpm, slots)
        assert 1 <= chunk <= pg.MV_MAX_CHUNK
        assert -(-G // chunk) * chunk >= G
