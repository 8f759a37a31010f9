"""The port's dense genotypes against jwas_tpu: get_genotypes, the store and
its Gram tiles, the dense block rule.

Inputs are made with numpy from a seed. The centered matrices are equal
in float32 (both center in float64 and round once) and within 1e-12 in
float64 (the column means are sums in another order); Gram tiles and xpx,
float32 sums of n products in another order, agree to rtol 1e-5, atol
1e-4 as tests/test_torch_grouped.py holds the 2-bit ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jwas_tpu
from jwas_tpu.ops import markers as jmk
import jwas_tpu_torch as jt
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks
from jwas_tpu_torch.engine.mcmc import setup_dense_markers
from jwas_tpu_torch.io.table import Table
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops import grouped as tgr
from jwas_tpu_torch.ops.markers import dense_blocks


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """runMCMC(double_precision=True) elsewhere in a worker leaves JAX's
    x64 mode on; these comparisons are float32."""
    jax.config.update("jax_enable_x64", False)


def _genotypes(n=90, p=70, seed=1):
    """Scores 0..2 with missing codes (9), a fixed locus and a rare one."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, p)).astype(np.float64)
    X[:, 3] = 1.0
    X[:, 5] = 0.0
    X[0, 5] = 1.0
    X[rng.uniform(size=(n, p)) < 0.05] = 9.0
    return X


def test_get_genotypes_matches_jwas_tpu(tmp_path):
    """f32, f64 and int8, with and without double_precision, QC on and off,
    center off: the centered matrix (the port's is marker-major), its
    dtype, allele frequencies, sum 2pq and the kept markers; a table and a
    CSV give the IDs jwas_tpu reads; int8 refuses fractional scores;
    RR-BLUP, BayesA, BayesL and GBLUP return jwas_tpu's Genotypes (method,
    pi, estimatePi; the store, or GBLUP's relationship matrix) and
    normalize_method turns them into jwas_tpu's (BayesA: BayesB with pi
    0, not estimated)."""
    X = _genotypes()
    cases = [dict(storage=s, double_precision=dp) for s in ("f32", "f64", "int8")
             for dp in (False, True)]
    cases += [dict(storage="f32", quality_control=False),
              dict(storage="f32", center=False), dict(storage="int8", MAF=0.2)]
    for kw in cases:
        ref = jwas_tpu.get_genotypes(X, **kw)
        ours = jt.get_genotypes(X, device="cpu", **kw)
        want = np.asarray(ref.genotypes)
        got = ours.dense.numpy().T
        assert got.dtype == want.dtype and ours.marker_ids == ref.marker_ids, kw
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 if got.dtype == np.float64 else 0)
        np.testing.assert_allclose(ours.allele_freq, ref.allele_freq, rtol=1e-14)
        np.testing.assert_allclose(ours.col_means, ref.col_means, rtol=1e-14)
        assert abs(ours.sum2pq - ref.sum2pq) < 1e-10 and ours.n_obs == ref.n_obs

    ids = np.array([f"a{i}" for i in range(X.shape[0])], dtype=object)
    cols = {"ID": ids, **{f"m{j}": X[:, j] for j in range(X.shape[1])}}
    path = tmp_path / "geno.csv"
    Table(cols).to_csv(str(path))
    ref = jwas_tpu.get_genotypes(str(path))
    for source in (Table(cols), str(path)):
        ours = jt.get_genotypes(source, device="cpu")
        assert ours.obs_ids == ref.obs_ids and ours.marker_ids == ref.marker_ids
        np.testing.assert_array_equal(ours.dense.numpy().T, np.asarray(ref.genotypes))
    # a tensor source gives the numpy source's store
    np.testing.assert_array_equal(
        jt.get_genotypes(torch.from_numpy(X), device="cpu").dense.numpy(),
        jt.get_genotypes(X, device="cpu").dense.numpy())

    frac = X.copy()
    frac[frac == 9.0] = 0.5
    for pkg, kw in ((jwas_tpu, {}), (jt, dict(device="cpu"))):
        with pytest.raises(ValueError, match="requires integer genotype scores"):
            pkg.get_genotypes(frac, storage="int8", **kw)
    from jwas_tpu.engine.setup import normalize_method as ref_normalize
    from jwas_tpu_torch.engine.setup import normalize_method
    for method in ("RR-BLUP", "BayesA", "BayesL", "GBLUP"):
        ref = jwas_tpu.get_genotypes(X, method=method)
        ours = jt.get_genotypes(X, method=method, device="cpu")
        assert (ours.method, ours.pi, ours.estimate_pi) == (ref.method, ref.pi,
                                                            ref.estimate_pi)
        assert (ours.grm is None, ours.dense is None) == (
            (False, True) if method == "GBLUP" else (True, False))
        ref_normalize(ref, jwas_tpu.build_model("y = intercept"))
        normalize_method(ours, jt.build_model("y = intercept"))
        assert (ours.method, ours.pi, ours.estimate_pi) == (ref.method, ref.pi,
                                                            ref.estimate_pi)
        assert ours.method == ("BayesB" if method == "BayesA" else method)
    starting = np.arange(ours.n_markers, dtype=np.float64)
    g = jt.get_genotypes(str(path), starting_value=starting, storage="f64", device="cpu")
    assert g.starting_alpha.dtype == np.float64


def test_store_and_grams_match_build_marker_blocks():
    """Unweighted and weighted Gram tiles and xpx against
    build_marker_blocks (a ragged last block: p = 70, b = 8), the dense
    store of convert.py against the port's own, the store's X'R^-1 w and
    X v against numpy, and (b, gb) against jwas_tpu's rule over a grid."""
    rng = np.random.default_rng(2)
    n, p, b = 90, 70, 8
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    Xs = torch.from_numpy(np.ascontiguousarray(X.T))
    for w in (None, rinv):
        md = jmk.build_marker_blocks(jnp.asarray(X), None if w is None else jnp.asarray(w),
                                     block_size=b)
        gb = jmk.stable_group_blocks(n, b, md.grams.shape[2]) or md.grams.shape[2]
        dm = td.build_dense_markers(Xs, n, b, gb,
                                    rinv=None if w is None else torch.from_numpy(w))
        conv = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=w)
        np.testing.assert_allclose(dm.grams.numpy(), conv.grams.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(dm.xpx.numpy(), conv.xpx.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(dm.X.numpy(), conv.X.numpy())
        assert (dm.G, dm.valid.shape[0], dm.ngroups) == (conv.G, conv.valid.shape[0],
                                                        conv.ngroups)
        y = rng.normal(size=n).astype(np.float32)
        ww = y if w is None else w * y
        np.testing.assert_allclose(tgr.grouped_rhs(dm, torch.from_numpy(y)).numpy()[:p],
                                   X.T @ ww, rtol=1e-4, atol=1e-4)
        v = rng.normal(size=dm.valid.shape[0]).astype(np.float32)
        np.testing.assert_allclose(tgr.grouped_matvec(dm, torch.from_numpy(v)).numpy(),
                                   X @ v[:p], rtol=1e-4, atol=1e-4)

    for n_obs in (50, 200, 1000, 45_000):
        for p_ in (100, 999, 4096, 100_000):
            for fb in (True, 8, 20, 136, 256):
                bs = (jmk.default_block_size(n_obs) if fb is True
                      else max(8, ((fb + 7) // 8) * 8))
                nblocks = -(-p_ // bs)
                want = (bs, jmk.stable_group_blocks(n_obs, bs, nblocks) or nblocks, False)
                assert dense_blocks(n_obs, fb, p_) == want, (n_obs, p_, fb)
            assert dense_blocks(n_obs, False, p_) == (jmk.default_block_size(n_obs), 1, True)
    assert dense_blocks(45_000, True, 100_000) == (256, 23, False)


def test_training_rows_are_found_through_the_row_order():
    """A store over every genotyped individual, a shuffled subset
    phenotyped with weights: the Grams and the GEMVs read the training
    rows through row_perm (no copy of the store), equal to the store
    gathered to those rows in numpy; the output IDs' X alpha is one GEMV
    over all store columns."""
    rng = np.random.default_rng(3)
    n_store, p, b = 120, 60, 8
    X = rng.normal(size=(n_store, p)).astype(np.float32)
    store_ids = [f"i{k}" for k in range(n_store)]
    rows = rng.permutation(n_store)[:90]
    obs_ids = [store_ids[k] for k in rows]
    rinv = rng.uniform(0.5, 2.0, len(rows)).astype(np.float32)
    Xs = torch.from_numpy(np.ascontiguousarray(X.T))
    dm = setup_dense_markers(Xs, store_ids, obs_ids, "cpu", fast_blocks=b,
                             rinv=torch.from_numpy(rinv))
    assert dm.X is Xs and dm.row_perm is not None and not dm.exact
    Xt = X[rows]
    full = td.build_dense_markers(torch.from_numpy(np.ascontiguousarray(Xt.T)),
                                  len(rows), b, dm.G // b, rinv=torch.from_numpy(rinv))
    np.testing.assert_allclose(dm.grams.numpy(), full.grams.numpy(), rtol=1e-5, atol=1e-4)
    y = rng.normal(size=len(rows)).astype(np.float32)
    np.testing.assert_allclose(tgr.grouped_rhs(dm, torch.from_numpy(y)).numpy()[:p],
                               Xt.T @ (rinv * y), rtol=1e-4, atol=1e-4)
    v = rng.normal(size=dm.valid.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tgr.grouped_matvec(dm, torch.from_numpy(v)).numpy(),
                               Xt @ v[:p], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dm.matvec_store(torch.from_numpy(v)).numpy(), X @ v[:p],
                               rtol=1e-4, atol=1e-4)
    exact = setup_dense_markers(Xs, store_ids, obs_ids, "cpu", fast_blocks=False)
    assert exact.exact and exact.G == exact.grams.shape[1] == 128
    with pytest.raises(ValueError, match="has no genotypes"):
        setup_dense_markers(Xs, store_ids, ["nobody"], "cpu")
