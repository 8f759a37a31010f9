"""K9's affine map and run schedule (csrc/mt_c0l_rounds.cu) in plain
PyTorch.

The plain version's step is the reference's trait loop written as a
per-marker affine map, a_new = P rhs + Q a_old + S z
(ops/multitrait.py::mt_c0l_constants): here against jwas_tpu's
_mt_c0l_marker_update at t = 2, 3, 4 and 8, RR-BLUP and BayesL, float32
and float64; the grouped sweep against mt_c0l_blocks and the exact form
against mt_c0l_exact at t = 4 and 8 (t = 2 and 3 are in
tests/test_torch_mt_c0l.py), at that file's tolerances: alpha rtol 1e-5 /
atol 1e-6 in float32 and 1e-10 / 1e-12 in float64, ycorr 1e-4 / 1e-5 and
1e-10 / 1e-12.

ops/inner_rounds.py::mt_c0l_inner_rounds_window_ref runs the chain on
K9's schedule (runs of 32 markers a warp, d handed on through a ring of
tagged slots, the other warps' lazy adds in ascending steps, the ring's
back-pressure, the runs' staging buffers), its warps interleaved in a
random order at random speeds: it must equal the sequential plain version
(mt_c0l_inner_rounds_ref) bit for bit at small b, t and nreps, with
padding, a ragged last run, two and four markers a thread, two buffers to
as many as warps, and the smallest ring it allows. Then K9's scratch at
its new size (3 t t a marker) and its refusal above a quarter of the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jwas_tpu.ops import markers as jmk
from jwas_tpu.ops import multitrait as jmt
from jwas_tpu_torch.engine.convert import from_jax_marker_blocks
from jwas_tpu_torch.ops import dense as td
from jwas_tpu_torch.ops import inner_rounds as ir
from jwas_tpu_torch.ops import multitrait as tmt

from test_torch_mt_c0l import _close, _covs, _jax_normals, _t

ORDER = ("grams", "xpx", "valid", "alpha", "rhs", "Rinv", "Ginv", "gamma", "zs")


@pytest.fixture(autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("t", [2, 3, 4, 8])
@pytest.mark.parametrize("bayesl", [False, True])
def test_affine_map_matches_jax_marker_update(t, bayesl, dtype):
    """One marker of each of B = 64 blocks: rhs, effects, normals and
    (BayesL) gamma at random; jwas_tpu is given w = rhs + xpx a_old."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    np_dt = np.dtype(dtype)
    B = 64
    rng = np.random.default_rng(100 + 7 * t + bayesl)
    R, G = _covs(t, rng, np_dt)
    Rinv, Ginv = np.linalg.inv(R).astype(np_dt), np.linalg.inv(G).astype(np_dt)
    xpx = rng.uniform(20.0, 80.0, B).astype(np_dt)
    gamma = (rng.uniform(0.2, 3.0, B) if bayesl else np.ones(B)).astype(np_dt)
    rhs = (rng.normal(size=(B, t)) * rng.uniform(0.1, 8.0, (B, 1))).astype(np_dt)
    a = (0.2 * rng.normal(size=(B, t))).astype(np_dt)
    z = rng.normal(size=(B, t)).astype(np_dt)
    w = (rhs + xpx[:, None] * a).astype(np_dt)
    want = jmt._mt_c0l_marker_update(
        jnp.asarray(w.T), jnp.asarray(a.T), jnp.asarray(xpx), jnp.asarray(Rinv),
        jnp.asarray(Ginv[:, :, None] / gamma[None, None, :]), jnp.asarray(z.T))
    P, Q, S = tmt.mt_c0l_constants(_t(xpx), _t(Rinv), _t(Ginv), _t(gamma),
                                   torch.ones(B, dtype=getattr(torch, dtype)))
    got = tmt.mt_c0l_marker_update_ref(_t(rhs), _t(a), P, Q, S, _t(z))
    _close(got.numpy().T, want, dtype, "alpha")
    # valid 0 folds into the constants: the effect is 0
    P0, Q0, S0 = tmt.mt_c0l_constants(_t(xpx), _t(Rinv), _t(Ginv), _t(gamma),
                                      torch.zeros(B, dtype=getattr(torch, dtype)))
    assert not tmt.mt_c0l_marker_update_ref(_t(rhs), _t(a), P0, Q0, S0, _t(z)).any()


@pytest.mark.parametrize("t,bayesl,dtype,weighted,nreps,sync_every", [
    (4, True, "float32", True, 3, 2), (8, False, "float64", False, 2, None),
    (8, True, "float32", False, 1, None)])
def test_grouped_sweep_matches_jax_at_more_traits(t, bayesl, dtype, weighted, nreps,
                                                  sync_every):
    """The grouped sweep through the plain version (b = 8, 12 blocks, the
    last ragged) against grouped_dense_sweep with mt_c0l_blocks on JAX's
    normals, as tests/test_torch_mt_c0l.py at t = 2 and 3."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    np_dt = np.dtype(dtype)
    n, p, b = 60, 94, 8
    rng = np.random.default_rng(50 + t + bayesl)
    X = rng.integers(0, 3, size=(n, p)).astype(np_dt)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n).astype(np_dt)
    R, G = _covs(t, rng, np_dt)
    w = rinv if weighted else None
    md = jmk.build_marker_blocks(jnp.asarray(X), None if w is None else jnp.asarray(w),
                                 block_size=b)
    nblocks = md.grams.shape[2]
    gb = jmk.stable_group_blocks(n, b, nblocks)
    pp = nblocks * b
    real = np.arange(pp) < p
    alpha = np.where(real, 0.05 * rng.normal(size=(t, pp)), 0.0).astype(np_dt)
    gamma = (np.where(real, rng.uniform(0.3, 3.0, pp), 1.0) if bayesl
             else np.ones(pp)).astype(np_dt)
    y = rng.normal(size=(t, n)).astype(np_dt)
    ginv = np.linalg.inv(G).astype(np_dt)
    key = jax.random.PRNGKey(t)

    def cg(md_g, sts, yc, g, kg):
        a, gam = sts
        a, yc = jmt.mt_c0l_blocks(md_g, a, yc, None if w is None else jnp.asarray(w),
                                  jnp.asarray(R), jnp.asarray(ginv), gam, kg,
                                  nreps=nreps, sync_every=sync_every)
        return (a, gam), yc

    out, yc = jmk.grouped_dense_sweep(cg, md, (jnp.asarray(alpha), jnp.asarray(gamma)),
                                      jnp.asarray(y), key, gb)
    dm = from_jax_marker_blocks(md.X, md.xpx, md.grams, md.valid, gb, rinv=w,
                                dtype=getattr(torch, dtype))
    a, ycr = _t(alpha), _t(y)
    tmt.sweep_blocks_mt_c0l_grouped(
        dm, a, ycr, _t(R), _t(ginv), _t(gamma) if bayesl else None, None, nreps=nreps,
        sync_every=sync_every, draws=_jax_normals(key, b, gb, t, np_dt))
    _close(a.numpy(), out[0], dtype, "alpha")
    _close(ycr.numpy(), yc, dtype, "ycorr")
    assert not a[:, p:].any()


@pytest.mark.parametrize("t,bayesl", [(2, True), (4, False), (8, True)])
def test_exact_sweep_matches_jax_at_more_traits(t, bayesl):
    """p = 70 in chunks of b = 32, weighted, float32: against mt_c0l_exact,
    as tests/test_torch_mt_c0l.py at t = 3."""
    n, p, b = 50, 70, 32
    rng = np.random.default_rng(60 + t)
    X = rng.integers(0, 3, size=(n, p)).astype(np.float32)
    X -= X.mean(axis=0)
    rinv = rng.uniform(0.5, 2.0, n).astype(np.float32)
    R, G = _covs(t, rng, np.float32)
    key = jax.random.PRNGKey(43)
    dm = td.build_dense_markers(_t(np.ascontiguousarray(X.T)), n, b, 1, rinv=_t(rinv),
                                exact=True)
    pp = dm.valid.shape[0]
    alpha = (0.05 * rng.normal(size=(t, p))).astype(np.float32)
    gamma = (rng.uniform(0.3, 3.0, p) if bayesl else np.ones(p)).astype(np.float32)
    y = rng.normal(size=(t, n)).astype(np.float32)
    ginv = np.linalg.inv(G).astype(np.float32)
    xpx = np.einsum("np,np->p", X * rinv[:, None], X)
    ra, ryc = jmt.mt_c0l_exact(jnp.asarray(X), jnp.asarray(xpx), jnp.asarray(alpha),
                               jnp.asarray(y), jnp.asarray(rinv), jnp.asarray(R),
                               jnp.asarray(ginv), jnp.asarray(gamma), key)
    zs = jax.random.normal(key, (p, t, 1))
    a = torch.zeros((t, pp))
    a[:, :p] = _t(alpha)
    gam = torch.ones(pp)
    gam[:p] = _t(gamma)
    ycr = _t(y)
    draws = td.sweep_draws(b, _t(zs)[..., 0])
    tmt.sweep_blocks_mt_c0l_grouped(
        dm, a, ycr, _t(R), _t(ginv), gam if bayesl else None, None, nreps=1,
        draws=lambda g, r, reps: tuple(x.mT for x in draws(g, r, reps)))
    assert not a[:, p:].any()
    _close(a.numpy()[:, :p], ra, "float32", "alpha")
    _close(ycr.numpy(), ryc, "float32", "ycorr")


def chain_inputs(t, b, nblocks, nreps, seed, dtype, n_padding=3, bayesl=True):
    """K9 inputs made with numpy: Gram tiles of 3b-observation blocks, the
    last n_padding markers of the last block padding (valid 0, zero Gram
    rows, xpx 1), covariances, effects, gamma and normals at random."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nblocks, b, 3 * b))
    if n_padding:
        x[-1, -n_padding:] = 0.0
    grams = x @ x.transpose(0, 2, 1)
    xpx = np.diagonal(grams, axis1=1, axis2=2).copy()
    valid = np.ones((nblocks, b))
    if n_padding:
        xpx[-1, -n_padding:], valid[-1, -n_padding:] = 1.0, 0.0
    rhs = (x @ rng.normal(size=(nblocks, 3 * b, t))).transpose(0, 2, 1)
    A, B = rng.normal(size=(t, t)), rng.normal(size=(t, t))
    Rinv = np.linalg.inv(A @ A.T / t + np.eye(t))
    Ginv = np.linalg.inv(0.01 * (B @ B.T / t + np.eye(t)))
    gamma = np.where(valid > 0, rng.uniform(0.2, 3.0, (nblocks, b)), 1.0) if bayesl \
        else np.ones((nblocks, b))
    alpha = 0.05 * rng.normal(size=(nblocks, t, b)) * valid[:, None]
    zs = rng.normal(size=(nreps * b, t, nblocks))
    out = dict(grams=grams, xpx=xpx, valid=valid, alpha=alpha, rhs=rhs, Rinv=Rinv,
               Ginv=Ginv, gamma=gamma, zs=zs)
    return {k: torch.tensor(v, dtype=dtype) for k, v in out.items()}


@pytest.mark.parametrize("t,b,nblocks,nreps,nbuf,ring,dtype,seed", [
    (2, 40, 2, 3, None, 128, torch.float32, 0),    # two warps, a run of 8
    (3, 72, 2, 2, 2, 96, torch.float64, 1),        # two buffers, the smallest ring
    (3, 20, 1, 3, None, 96, torch.float32, 2),     # one warp, one short run a rep
    (2, 300, 1, 2, None, 128, torch.float32, 3),   # two markers a thread, a run of 12
    (2, 264, 1, 2, 2, 128, torch.float64, 4),      # a warp owns two runs in a row
    (2, 520, 1, 1, 3, 96, torch.float32, 5),       # four markers a thread
])
def test_run_schedule_equals_the_sequential_chain(t, b, nblocks, nreps, nbuf, ring, dtype,
                                                  seed):
    inp = chain_inputs(t, b, nblocks, nreps, seed, dtype)
    want = {k: v.clone() for k, v in inp.items()}
    tmt.mt_c0l_inner_rounds_ref(*(want[k] for k in ORDER), nreps)
    for order_seed in (seed, seed + 100) if b <= 72 else (seed,):
        got = {k: v.clone() for k, v in inp.items()}
        stats = {}
        ir.mt_c0l_inner_rounds_window_ref(*(got[k] for k in ORDER), nreps, nbuf=nbuf,
                                          ring=ring, seed=order_seed, stats=stats)
        for k in ("alpha", "rhs"):
            assert torch.equal(got[k], want[k]), (k, order_seed)
        assert not got["alpha"][-1, :, -3:].any()
        assert stats["runs"] == nreps * -(-b // 32)


@pytest.mark.parametrize("nbuf,ring", [(2, 64), (1, 128)])
def test_run_schedule_refuses_a_ring_below_three_runs_or_one_buffer(nbuf, ring):
    """The ring holds three runs at least (a warp's lag: the run it takes,
    the one it set up ahead, and one); a warp stages its run while the run
    before it runs, so two buffers at least."""
    inp = chain_inputs(2, 40, 1, 1, 0, torch.float32)
    with pytest.raises(ValueError, match="nbuf"):
        ir.mt_c0l_inner_rounds_window_ref(*(inp[k] for k in ORDER), 1, nbuf=nbuf, ring=ring)


def test_c0l_scratch_is_three_t_squared_a_marker_and_refused_above_a_quarter(monkeypatch):
    """K9's scratch holds P, Q and S, 3 t t values a marker; set-up
    refuses a multi-trait RR-BLUP whose scratch would take more than a
    quarter of the card (JWAS_HBM_BYTES stands in for it here) with a
    NotImplementedError naming its ROADMAP item, and runs it below."""
    import jwas_tpu_torch as jt

    assert tmt.scratch_values("C0L", 3, 256, 23) == 23 * 256 * 27
    assert tmt.scratch_values("C0L", 8, 2048, 1) == 2048 * 192
    # t = 8, b = 2,048, 256 blocks a group in float64 (~0.8 GB): taken on
    # an 80 GB card, refused on a 3 GB one
    tmt.check_scratch("C0L", 8, 2048, 256, 8, int(80e9))
    with pytest.raises(NotImplementedError, match="scratch above a quarter of the card"):
        tmt.check_scratch("C0L", 8, 2048, 256, 8, int(3e9))
    rng = np.random.default_rng(6)
    n = 40
    X = rng.integers(0, 3, (n, 12)).astype(float)
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(n)], dtype=object),
                      "y1": rng.normal(size=n), "y2": rng.normal(size=n)})
    nbytes = 64 * 3 * 4 * 4      # b = 64, one block, t = 2, float32

    def run():
        geno = jt.get_genotypes(X, method="RR-BLUP", device="cpu")
        model = jt.build_model("y1 = intercept + geno\ny2 = intercept + geno",
                               genotypes=geno)
        return jt.runMCMC(model, table, device="cpu", chain_length=2, output_folder="",
                          printout_model_info=False, fast_blocks=64)

    monkeypatch.setenv("JWAS_HBM_BYTES", str(4 * nbytes - 4))
    with pytest.raises(NotImplementedError, match="scratch above a quarter of the card"):
        run()
    monkeypatch.setenv("JWAS_HBM_BYTES", str(4 * nbytes))
    run()
