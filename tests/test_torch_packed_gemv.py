"""The port's decode-fused GEMVs against jwas_tpu's and against dense numpy.

packed_rhs_ref / packed_matvec_ref (jwas_tpu_torch/ops/packed_gemv.py) are
held against three references on the same store, made with numpy from a
seed: the Pallas kernels in interpret mode (packed_rhs_fused /
packed_matvec_fused), the grouped path's plane GEMVs (_plane_rhs /
_plane_matvec, with missing codes and a non-identity row_perm), and dense
float64 numpy. Tolerances: rtol = atol = 1e-4 between float32
implementations (summation order differs), 1e-3 against float64, as in
tests/test_pallas_packed_gemv.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops.grouped import _pad_w, _plane_matvec, _plane_rhs
from jwas_tpu.ops.pallas_packed_gemv import packed_matvec_fused, packed_rhs_fused
from jwas_tpu_torch.io.packed import pack_codes
from jwas_tpu_torch.ops.grouped import store_order, unpad
from jwas_tpu_torch.ops.packed_gemv import (packed_matvec, packed_matvec_ref,
                                            packed_rhs, packed_rhs_ref)


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def store():
    """n = 53 observations (a sub-byte tail), p = 512 markers, codes 0..3."""
    rng = np.random.default_rng(0)
    n, p = 53, 512
    codes = rng.integers(0, 4, size=(n, p)).astype(np.uint8)
    packed = pack_codes(codes)
    means = np.array([c[c < 3].mean() for c in codes.T], np.float32)
    x = np.where(codes == 3, means[None, :], codes) - means[None, :]
    return packed, means, x.astype(np.float64), n, p


def _t(a):
    return torch.from_numpy(np.array(a))


def test_gemvs_match_pallas_and_dense(store):
    packed, means, x, n, p = store
    rng = np.random.default_rng(1)
    w = rng.normal(size=n).astype(np.float32)
    got = packed_rhs_ref(_t(packed), _t(means), store_order(_t(w), 4 * packed.shape[1], None))
    pallas = np.asarray(packed_rhs_fused(jnp.asarray(packed), jnp.asarray(means),
                                         jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x.T @ w, rtol=1e-3, atol=1e-3)

    v = rng.normal(size=p).astype(np.float32)
    got = unpad(packed_matvec_ref(_t(packed), _t(means), _t(v)), n, None)
    pallas = np.asarray(packed_matvec_fused(
        jnp.asarray(packed), jnp.asarray(means), jnp.asarray(v), n_obs=n,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ v, rtol=1e-3, atol=1e-3)


def test_row_perm_padding_and_cpu_dispatch(store):
    """Observations in another order than the store's (w scattered and Xv
    gathered through row_perm, as the grouped path does) against the plane
    GEMVs of jwas_tpu; padded marker rows (zero bytes, mean 0) add nothing;
    on CPU tensors the wrappers are the plain versions and launch nothing."""
    packed, means, x, n, p = store
    rng = np.random.default_rng(3)
    perm = rng.permutation(n)
    w = rng.normal(size=n).astype(np.float32)
    v = rng.normal(size=p).astype(np.float32)
    bpm = packed.shape[1]
    jp = jnp.asarray(perm, jnp.int32)
    ref_rhs = np.asarray(_plane_rhs(jnp.asarray(packed), jnp.asarray(means),
                                    _pad_w(jnp.asarray(w), bpm, jp), True))
    ref_mv = np.asarray(_plane_matvec(jnp.asarray(packed), jnp.asarray(means),
                                      jnp.asarray(v), n, jp, True))
    tp = torch.from_numpy(perm)
    got_rhs = packed_rhs(_t(packed), _t(means), store_order(_t(w), 4 * bpm, tp))
    got_mv = unpad(packed_matvec(_t(packed), _t(means), _t(v)), n, tp)
    np.testing.assert_allclose(got_rhs.numpy(), ref_rhs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_mv.numpy(), ref_mv, rtol=1e-4, atol=1e-4)
    xp = x[perm]                                      # rows in observation order
    np.testing.assert_allclose(got_rhs.numpy(), xp.T @ w, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_mv.numpy(), xp @ v, rtol=1e-3, atol=1e-3)

    rng = np.random.default_rng(4)
    pad = 64
    packed_pad = np.concatenate([packed, np.zeros((pad, packed.shape[1]), np.uint8)])
    means_pad = np.concatenate([means, np.zeros(pad, np.float32)])
    w = rng.normal(size=n).astype(np.float32)
    before = (packed_rhs.launches, packed_matvec.launches)
    r = packed_rhs(_t(packed_pad), _t(means_pad),
                   store_order(_t(w), 4 * packed.shape[1], None)).numpy()
    np.testing.assert_allclose(r[p:], 0.0, atol=1e-4)
    v = np.zeros(p + pad, np.float32)
    v[:p] = rng.normal(size=p)
    m = unpad(packed_matvec(_t(packed_pad), _t(means_pad), _t(v)), n, None)
    np.testing.assert_allclose(m.numpy(), x @ v[:p].astype(np.float64),
                               rtol=1e-3, atol=1e-3)
    assert (packed_rhs.launches, packed_matvec.launches) == before
