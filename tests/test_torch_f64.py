"""float64 end to end (runMCMC's double_precision) in the port against
jwas_tpu with JAX's x64 mode.

(1) The float64 inner-rounds chains (K1/K2's and K3's plain versions, the
    functions the float64 kernels are held to on the card) against their
    window-schedule models bit for bit, as the float32 ones are
    (tests/test_torch_chain_window.py).
(2) The dense grouped and exact BayesC sweeps in float64 against
    jwas_tpu's float64 sweeps fed the same draws: delta equal, alpha to
    rtol 1e-10 / atol 1e-12 (sums of the same terms in another order).
(3) runMCMC(double_precision=True) on a float64 store: every array of the
    chain in float64, and the posterior means within the blocked
    configuration's 99% Monte-Carlo bounds of jwas_tpu's float64 chain
    (tests/test_torch_dense_runmcmc.py); a float32 store is cast once for
    a float64 chain and a float64 store for a float32 one.
jwas_tpu's runMCMC(double_precision=True) turns JAX's x64 mode on for the
process (fault R8); each test here restores it.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jwas_tpu
from jwas_tpu.ops import markers as jmk
import jwas_tpu_torch as jt
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops import grouped as tgr
from jwas_tpu_torch.ops.inner_rounds import (abc_inner_rounds,
                                             abc_inner_rounds_window_ref,
                                             bayesr_inner_rounds,
                                             bayesr_inner_rounds_window_ref)
from test_torch_dense_runmcmc import BOUNDS, KEYS, dense_problem, run_chain

F64 = torch.float64


@contextlib.contextmanager
def enable_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


def test_float64_chains_equal_their_window_models():
    """K1 (with per-marker variances) and K3 in float64 at b = 40 and 72
    (ragged windows) over 3 blocks and 2 reps: the step-by-step plain
    version equals the window schedule the kernels run, to the last bit."""
    rng = np.random.default_rng(9)
    for b in (40, 72):
        nb, reps = 3, 2
        x = rng.normal(size=(nb, b, 96))
        grams = torch.from_numpy(np.einsum("kjn,krn->kjr", x, x))
        xpx = torch.diagonal(grams, dim1=1, dim2=2).contiguous()
        rhs = torch.from_numpy(np.einsum("kjn,n->kj", x, rng.normal(size=96)))
        alpha = torch.from_numpy(0.1 * rng.normal(size=(nb, b)))
        pi = torch.full((nb, b), 0.7, dtype=F64)
        abc = dict(grams=grams, xpx=xpx,
                   var_eff=torch.from_numpy(rng.uniform(0.01, 0.05, (nb, b))),
                   log_pi=torch.log(pi), log_pi_comp=torch.log1p(-pi + 1e-12),
                   alpha=alpha, beta=alpha.clone(),
                   delta=(alpha != 0).to(torch.int32), rhs=rhs,
                   us=torch.from_numpy(rng.uniform(size=(reps * b, nb))),
                   zs=torch.from_numpy(rng.normal(size=(reps * b, nb))),
                   inv_vare=torch.tensor([1 / 1.3], dtype=F64))
        a = {k: v.clone() for k, v in abc.items()}
        w = {k: v.clone() for k, v in abc.items()}
        abc_inner_rounds(**a, nreps=reps)
        abc_inner_rounds_window_ref(**w, nreps=reps)
        assert a["alpha"].dtype == F64
        for k in ("alpha", "beta", "delta", "rhs"):
            assert torch.equal(a[k], w[k]), (b, k)
        pim = torch.tensor([0.9, 0.05, 0.03, 0.02], dtype=F64).expand(nb, b, 4)
        u = torch.from_numpy(rng.uniform(1e-300, 1.0, (reps * b, nb, 4)))
        br = dict(grams=grams, xpx=xpx, log_pi=torch.log(pim).contiguous(),
                  alpha=torch.zeros((nb, b), dtype=F64),
                  delta=torch.zeros((nb, b), dtype=torch.int32), rhs=rhs,
                  gumbel=-torch.log(-torch.log(u)),
                  zs=torch.from_numpy(rng.normal(size=(reps * b, nb))),
                  inv_vare=torch.tensor([1 / 1.3], dtype=F64),
                  sigma_sq=torch.tensor([0.01], dtype=F64))
        a = {k: v.clone() for k, v in br.items()}
        w = {k: v.clone() for k, v in br.items()}
        bayesr_inner_rounds(**a, nreps=reps)
        bayesr_inner_rounds_window_ref(**w, nreps=reps)
        assert int((a["delta"] > 0).sum()) > 0
        for k in ("alpha", "delta", "rhs"):
            assert torch.equal(a[k], w[k]), (b, k)


def test_float64_dense_sweeps_match_jax_x64():
    """The weighted grouped BayesC sweep (b = 8, 24 blocks, gb = 4) and the
    exact sweep in float64 against jwas_tpu's, the same draws injected."""
    rng = np.random.default_rng(12)
    n, p, b = 100, 190, 8
    X = rng.integers(0, 3, size=(n, p)).astype(np.float64)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n)
    y = rng.normal(size=n)
    with enable_x64():
        key = jax.random.PRNGKey(3)
        md = jmk.build_marker_blocks(jnp.asarray(X), jnp.asarray(rinv), block_size=b)
        nblocks = md.grams.shape[2]
        gb = jmk.stable_group_blocks(n, b, nblocks)
        pp = nblocks * b
        alpha = np.where(np.arange(pp) < p, 0.05 * rng.normal(size=pp), 0.0)
        delta = (alpha != 0).astype(np.int32)
        pi = np.where(np.arange(pp) < p, 0.8, 1.0)

        def cg(md_g, sts, yc, g, kg):
            a, be, d, pi_g = sts
            a, be, d, yc = jmk.sweep_blocks_abc(md_g, a, be, d, yc, jnp.asarray(rinv),
                                                jnp.asarray(1.1), jnp.asarray(0.05), pi_g,
                                                kg, nreps=5, sync_every=2)
            return (a, be, d, pi_g), yc

        out, yc = jmk.grouped_dense_sweep(
            cg, md, (jnp.asarray(alpha), jnp.asarray(alpha), jnp.asarray(delta),
                     jnp.asarray(pi)), jnp.asarray(y), key, gb)

        def draws(g, r, reps):
            ku, kz = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, g), r))
            return (torch.from_numpy(np.array(jax.random.uniform(ku, (reps * b, gb),
                                                                 dtype=jnp.float64))),
                    torch.from_numpy(np.array(jax.random.normal(kz, (reps * b, gb),
                                                                dtype=jnp.float64))))

        dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=rinv,
                                    dtype=F64)
        st = [torch.from_numpy(alpha.copy()), torch.from_numpy(alpha.copy()),
              torch.from_numpy(delta.copy()), torch.from_numpy(y.copy())]
        tgr.sweep_blocks_abc_grouped(dm, *st, torch.tensor(1.1, dtype=F64),
                                     torch.tensor(0.05, dtype=F64), torch.from_numpy(pi),
                                     None, nreps=5, sync_every=2, draws=draws)
        np.testing.assert_array_equal(st[2].numpy(), np.asarray(out[2]))
        np.testing.assert_allclose(st[0].numpy(), np.asarray(out[0]), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(st[3].numpy(), np.asarray(yc), rtol=1e-10, atol=1e-12)

        xpx = jnp.asarray(np.einsum("np,np->p", X * rinv[:, None], X))
        a0 = alpha[:p]
        ra, _, rd, ryc = jmk.sweep_exact_abc(
            jnp.asarray(X), xpx, jnp.asarray(a0), jnp.asarray(a0), jnp.asarray(delta[:p]),
            jnp.asarray(y), jnp.asarray(rinv), jnp.asarray(1.1), jnp.asarray(0.05),
            jnp.asarray(pi[:p]), key)
        ku, kz = jax.random.split(key)
        us = torch.from_numpy(np.array(jax.random.uniform(ku, (p,), dtype=jnp.float64)))
        zs = torch.from_numpy(np.array(jax.random.normal(kz, (p,), dtype=jnp.float64)))
    dme = td.build_dense_markers(torch.from_numpy(np.ascontiguousarray(X.T)), n, 128, 1,
                                 rinv=torch.from_numpy(rinv), exact=True)
    pe = dme.valid.shape[0]

    def pad(x, fill):
        out = np.full(pe, fill, x.dtype)
        out[:p] = x
        return torch.from_numpy(out)

    st = [pad(a0, 0.0), pad(a0, 0.0), pad(delta[:p], 0), torch.from_numpy(y.copy())]
    tgr.sweep_blocks_abc_grouped(dme, *st, torch.tensor(1.1, dtype=F64),
                                 torch.tensor(0.05, dtype=F64), pad(pi[:p], 1.0), None,
                                 nreps=1, draws=td.sweep_draws(128, us, zs))
    np.testing.assert_array_equal(st[2].numpy()[:p], np.asarray(rd))
    np.testing.assert_allclose(st[0].numpy()[:p], np.asarray(ra), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(st[3].numpy(), np.asarray(ryc), rtol=1e-10, atol=1e-12)


def test_double_precision_runmcmc_matches_jwas_tpu():
    """runMCMC(double_precision=True) on a float64 store: float64 results
    and sample files' values, within the blocked bounds of jwas_tpu's
    float64 chain; the store casts between dtypes once."""
    problem = dense_problem()
    sim, pheno, table = problem
    ref, ref_m = run_chain("jwas_tpu", "blocked", 7, *problem, double_precision=True)
    jax.config.update("jax_enable_x64", False)
    import jwas_tpu_torch.engine.mcmc as em
    built = {}
    saved = em.run_chains

    def keep(cfg, data, states, *a, **k):
        built["state"], built["data"] = states[0], data
        return saved(cfg, data, states, *a, **k)

    em.run_chains = keep
    try:
        g = jt.get_genotypes(sim["genotypes"], storage="f64", device="cpu")
        out = jt.runMCMC(jt.build_model("y = intercept + geno", genotypes=g), table,
                         device="cpu", double_precision=True, fast_blocks=8,
                         chain_length=2000, burnin=400, seed=7, output_folder="",
                         printout_model_info=False)
    finally:
        em.run_chains = saved
    st, data = built["state"], built["data"]
    assert data.gm.X is g.dense and data.gm.grams.dtype == F64
    for t in (st.alpha, st.beta, st.ycorr, st.vare, st.varg, st.pi, st.sol, data.W,
              data.y):
        assert t.dtype == F64
    ours = dict(vare=out["residual variance"].Estimate[0],
                varg=out["marker effects variances geno"].Estimate[0],
                pi=out["pi_geno"].Estimate[0])
    for k in KEYS:
        assert abs(ours[k] - ref_m[k]) < BOUNDS["blocked"][k], (k, ours, ref_m)
    ebv = np.asarray(out["EBV_y"].EBV)
    assert ebv.dtype == np.float64 and np.isfinite(ebv).all()
    assert not np.array_equal(ebv, ebv.astype(np.float32).astype(np.float64))

    from jwas_tpu_torch.engine.mcmc import setup_dense_markers
    g32 = jt.get_genotypes(sim["genotypes"], device="cpu")
    ids = list(g32.obs_ids)
    up = setup_dense_markers(g32.dense, ids, ids, "cpu", fast_blocks=8, dtype=F64)
    assert up.X.dtype == F64 and up.X.data_ptr() != g32.dense.data_ptr()
    down = setup_dense_markers(g.dense, ids, ids, "cpu", fast_blocks=8,
                               dtype=torch.float32)
    assert down.X.dtype == torch.float32
