"""The port's store loader, packer, missing-code scan, block-size choice
and marker set-up against jwas_tpu, on stores written by jwas_tpu's
prepare_packed_genotypes or packed with numpy from a seed.

Block sizes must be identical (both packages run the same schedule); Gram
tiles agree to float32 summation order (rtol 1e-5, atol 1e-4).
"""

import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from jwas_tpu.io.packed import _pack_numpy, prepare_packed_genotypes
from jwas_tpu.ops import grouped as jgr
from jwas_tpu_torch.engine.mcmc import setup_markers
from jwas_tpu_torch.io.packed import Packed2BitStore, pack_codes, store_has_missing
from jwas_tpu_torch.ops import grouped as tgr


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _geno_df(n=90, p=37, seed=7, missing_frac=0.05):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    x[rng.uniform(size=x.shape) < missing_frac] = 9.0
    df = pd.DataFrame(x, columns=[f"m{j}" for j in range(p)])
    df.insert(0, "ID", [f"i{k}" for k in range(n)])
    return df


def test_loader_packer_and_missing_scan_match_jax(tmp_path):
    path = str(tmp_path / "geno")
    ref = prepare_packed_genotypes(_geno_df(), save_path=path)
    for mmap in (False, True):
        got = Packed2BitStore.load(path, mmap=mmap)
        np.testing.assert_array_equal(np.asarray(got.packed), ref.packed)
        assert got.obs_ids == ref.obs_ids and got.marker_ids == ref.marker_ids
        np.testing.assert_allclose(got.means, ref.means)
        np.testing.assert_allclose(got.allele_freq, ref.allele_freq)
        assert got.has_missing is True and got.sum2pq == pytest.approx(ref.sum2pq)
    for missing_frac in (0.0, 0.05):
        packed = prepare_packed_genotypes(_geno_df(missing_frac=missing_frac)).packed
        assert store_has_missing(packed) == jgr.store_has_missing(packed)
        assert store_has_missing(packed) == (missing_frac > 0)
    codes = np.random.default_rng(1).integers(0, 4, size=(33, 9)).astype(np.uint8)
    np.testing.assert_array_equal(pack_codes(codes), _pack_numpy(codes))


def test_blocks_and_setup_markers_match_jax(tmp_path):
    """pick_stable_blocks over a grid of (n, b, p); then the same (b, gb),
    padding, row order and statistics as jwas_tpu's build_grouped_markers
    for a store read back from disk."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in (40, 150, 400, 2_000, 50_000, 200_000):
            for b in (8, 64, 128, 256, 512):
                for p in (100, 2_000, 100_000, 2_097_152):
                    assert (tgr.pick_stable_blocks(n, b, p)
                            == jgr.pick_stable_blocks(n, b, p)), (n, b, p)

    path = str(tmp_path / "geno")
    ref = prepare_packed_genotypes(_geno_df(n=120, p=150, seed=3), save_path=path)
    store = Packed2BitStore.load(path)
    obs = list(np.random.default_rng(2).permutation(store.obs_ids))
    if not torch.cuda.is_available():
        # the default device is the GPU: without one setup_markers raises
        # and never takes the CPU silently
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup_markers(store, obs, fast_blocks=8)
    gm = setup_markers(store, obs, "cpu", fast_blocks=8)
    b, gb = jgr.pick_stable_blocks(len(obs), 8, store.n_markers)
    gmj = jgr.build_grouped_markers(ref, obs, b, group_blocks=gb, host=False)
    # the port keeps the (p, bpm) store unpadded: jwas_tpu's padded groups
    # hold the same rows, then zero rows up to p_pad
    jstore = np.asarray(gmj.store).reshape(-1, gm.store.shape[1])
    assert gm.ngroups == gmj.store.shape[0] and jstore.shape[0] == gm.valid.shape[0]
    np.testing.assert_array_equal(gm.store.numpy(), jstore[:store.n_markers])
    assert not jstore[store.n_markers:].any()
    np.testing.assert_array_equal(gm.row_perm.numpy(), np.asarray(gmj.row_perm))
    np.testing.assert_allclose(gm.grams.numpy(),
                               np.transpose(np.asarray(gmj.grams), (2, 0, 1)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gm.xpx.numpy(), np.asarray(gmj.xpx), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(gm.valid.numpy(), np.asarray(gmj.valid))
