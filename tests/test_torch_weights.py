"""Residual weights (runMCMC's heterogeneous_residuals) in the port against
jwas_tpu: R^-1 = 1 / weights enters the location pass (W'R^-1W and
W'R^-1 ycorr), the residual variance's SSE, xpx, the Gram tiles and every
rhs of the marker sweep.

The location pass is fed JAX's own normal draws and must agree to float32
rounding (rtol 1e-5, atol 1e-6); the residual variance's SSE is checked
through the draw it divides by. The weighted chain of
tests/test_torch_dense_runmcmc.py ("weighted") must agree with
jwas_tpu.runMCMC within that file's calibrated 99% Monte-Carlo bounds.
The sweeps' weighted rhs are held to jwas_tpu's with injected draws in
tests/test_torch_dense_sweeps.py, the weighted Grams in
tests/test_torch_dense.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jwas_tpu
from jwas_tpu.engine.setup import MCMCOptions as RefOptions
from jwas_tpu.engine.setup import prepare_workspace as ref_workspace
from jwas_tpu.ops import location as jloc
from jwas_tpu.ops import variance as jvar
import jwas_tpu_torch as jt
from jwas_tpu_torch.engine.mcmc import make_data
from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops.dists import sample_chi2
from jwas_tpu_torch.ops.location import gibbs_pass_lambda
from jwas_tpu_torch.ops.variance import sample_residual_variance_st
from test_torch_dense_runmcmc import assert_within_mc_error, dense_problem


@pytest.fixture(scope="module")
def problem():
    jax.config.update("jax_enable_x64", False)
    return dense_problem()


def test_weighted_location_pass_and_residual_variance():
    """make_data's W'R^-1W and the pass over W'R^-1 ycorr against
    jwas_tpu's gibbs_pass_lambda on the same draws; the weighted SSE
    ycorr'R^-1 ycorr of the residual variance against jwas_tpu's."""
    rng = np.random.default_rng(8)
    n, K = 80, 4
    W = np.column_stack([np.ones(n), rng.normal(size=(n, K - 1))]).astype(np.float32)
    rinv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ycorr = rng.normal(size=n).astype(np.float32)
    x = rng.normal(size=K).astype(np.float32)
    vare = np.float32(1.3)
    X = torch.from_numpy(rng.normal(size=(16, n)).astype(np.float32))
    dm = td.build_dense_markers(X, n, 8, 2, rinv=torch.from_numpy(rinv))
    data = make_data(dm, ycorr, W, 1.0)
    lhs = (W * rinv[:, None]).T @ W
    np.testing.assert_allclose(data.WtW.numpy(), lhs, rtol=1e-5, atol=1e-5)
    key = jax.random.PRNGKey(11)
    want = jloc.gibbs_pass_lambda(jnp.asarray(lhs), jnp.asarray(x),
                                  jnp.asarray(W.T @ (rinv * ycorr)), jnp.asarray(vare), key)
    zs = torch.from_numpy(np.array(jax.random.normal(key, (K,))))
    got = gibbs_pass_lambda(data.WtW, torch.from_numpy(x),
                            data.W.T @ (data.gm.rinv * data.y), torch.tensor(vare), None,
                            zs=zs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    df, scale = 4.0, 0.7
    sse = float(jnp.sum(jnp.asarray(ycorr) ** 2 * jnp.asarray(rinv)))
    ref = jvar.sample_residual_variance_st(jax.random.PRNGKey(1), jnp.asarray(ycorr), n, df,
                                           scale, invweights=jnp.asarray(rinv))
    assert np.isfinite(float(ref))
    for w in (rinv, None):
        gen = torch.Generator().manual_seed(5)
        chi = float(sample_chi2(gen, torch.tensor(float(n)) + df))
        gen = torch.Generator().manual_seed(5)
        v = sample_residual_variance_st(gen, torch.from_numpy(ycorr), n, df,
                                        torch.tensor(scale),
                                        None if w is None else torch.from_numpy(w))
        want_sse = sse if w is not None else float(np.sum(ycorr.astype(np.float64) ** 2))
        assert abs(float(v) * chi - df * scale - want_sse) < 1e-4 * want_sse


def test_weights_enter_the_workspace_as_jwas_tpu_reads_them(problem):
    """rinv = 1 / weights of the training rows in their order, as
    jwas_tpu's prepare_workspace reads them; a missing 'weights' column and
    weights on the 2-bit store raise jwas_tpu's ValueError in both
    packages."""
    sim, pheno, table = problem
    opts = dict(heterogeneous_residuals=True, fast_blocks=8, chain_length=10,
                printout_model_info=False, output_folder="")
    ref = ref_workspace(jwas_tpu.build_model("y = intercept + geno",
                                             genotypes=jwas_tpu.get_genotypes(sim["genotypes"])),
                        pheno, RefOptions(**opts))
    ws = prepare_workspace(jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
        sim["genotypes"], device="cpu")), table, MCMCOptions(**opts))
    assert ws.obs_ids == list(ref.obs_ids)
    np.testing.assert_array_equal(ws.rinv, ref.rinv)
    no_w = jt.Table({c: table[c] for c in table.columns if c != "weights"})
    model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
        sim["genotypes"], device="cpu"))
    with pytest.raises(ValueError, match="requires a 'weights' column"):
        jt.runMCMC(model, no_w, device="cpu", **opts)
    store = jt.prepare_packed_genotypes(np.asarray(sim["genotypes"].iloc[:, 1:]))
    model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(store))
    with pytest.raises(ValueError, match="does not support heterogeneous residuals"):
        jt.runMCMC(model, table, device="cpu", **opts)


def test_weighted_chain_matches_jwas_tpu_within_mc_error(problem):
    assert_within_mc_error(problem, "weighted")
