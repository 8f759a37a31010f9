"""The port's random regression model (RRM) against jwas_tpu's, on the CPU.

jwas_tpu_torch.ops.rrm (generate_full_phi, build_m_phiphi and the plain
version of K10, sweep_rrm_abc_ref, fed the draws jwas_tpu's sweep_rrm_abc
makes; K10's cross-Grams, build_rrm_cross_grams, against an einsum, and
its chunk algebra, sweep_rrm_abc_chunked_ref, against the plain version
and jwas_tpu at p ragged against the chunk), engine/mcmc_rrm.py's set-up and one step's deterministic parts
given jwas_tpu's state (engine/convert.py::rrm_data_from_jax,
rrm_state_from_jax), the four chains of tests/test_rrm.py through the
port's runMCMC(device="cpu") with the reference's assertions and the
trajectory accuracy within 0.05 of jwas_tpu's on the same data, the result
tables and sample files against jwas_tpu's, its ValueErrors, the
refusals (checkpoints: "ops layer"; K10's limits) and fault R15.

Tolerances: float32 sweeps at tests/test_pallas_sweep.py:42-45's (alpha and
beta rtol 1e-5, atol 1e-6; the grid rtol 1e-4, atol 1e-5), every delta
equal; float64 within 1e-10, every delta equal.
"""

import functools
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jwas_tpu
import jwas_tpu_torch as jt
from jwas_tpu.ops import rrm as jrrm
from jwas_tpu_torch.engine import mcmc_rrm
from jwas_tpu_torch.engine.convert import rrm_data_from_jax, rrm_state_from_jax
from jwas_tpu_torch.ops import rrm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_rrm import _rrm_sim  # noqa: E402

RUN = dict(printout_model_info=False)


def _jax():
    import jax
    jax.config.update("jax_enable_x64", False)
    return jax


@pytest.fixture(autouse=True)
def _x64_off():
    _jax()
    yield
    _jax()


def _port_geno(geno_df, method="BayesC", **kw):
    return jt.get_genotypes(geno_df, method=method, name="geno", device="cpu", **kw)


def _trajectory_accuracy(traj, U, ids, times):
    """tests/test_rrm.py:73-84: every (ID, time) cell of the trajectory."""
    est = {(str(s), float(t)): float(e) for s, t, e in
           zip(np.asarray(traj["ID"]), np.asarray(traj["time"]), np.asarray(traj["EBV"]))}
    got = [est[(s, float(t))] for t in times for s in ids]
    return float(np.corrcoef(np.asarray(U).reshape(-1), got)[0, 1])


# ------------------------------------------------------------ ops/rrm.py


@pytest.mark.parametrize("times,ncoeff", [
    (np.array([1.0, 2.0, 3.0, 4.0, 5.0]), 3), (np.array([3.0, 1.0, 2.0, 1.0, 7.5]), 2),
    (np.linspace(5.0, 305.0, 10), 5)])
def test_generate_full_phi_matches_jwas_tpu(times, ncoeff):
    np.testing.assert_allclose(rrm.generate_full_phi(times, ncoeff),
                               jrrm.generate_full_phi(times, ncoeff), atol=1e-12)
    np.testing.assert_array_equal(rrm._labels(ncoeff), jrrm._labels(ncoeff))


def test_build_m_phiphi_matches_jwas_tpu():
    rng = np.random.default_rng(0)
    nind, p, ntimes, c = 37, 23, 6, 3
    X = rng.normal(size=(nind, p))
    phi = rng.normal(size=(ntimes, c))
    mask = (rng.uniform(size=(ntimes, nind)) < 0.7).astype(float)
    got = rrm.build_m_phiphi(torch.as_tensor(X.T.copy()), torch.as_tensor(phi),
                             torch.as_tensor(mask), chunk=5)
    np.testing.assert_allclose(got.numpy(), jrrm.build_m_phiphi(X, phi, mask), atol=1e-10)


def _sweep_inputs(c, p=30, nind=40, ntimes=5, seed=1):
    rng = np.random.default_rng(seed + c)
    X = rng.binomial(2, rng.uniform(0.1, 0.9, p), size=(nind, p)).astype(float)
    X -= X.mean(0)
    phi = jrrm.generate_full_phi(np.arange(ntimes), c)
    mask = (rng.uniform(size=(ntimes, nind)) >= 0.15).astype(float)
    varg = 0.05 * (0.7 * np.eye(c) + 0.3)
    pi = rng.dirichlet(np.ones(2**c))
    return dict(X=X, phi=phi, mphiphi=jrrm.build_m_phiphi(X, phi, mask), obs_mask=mask,
                alpha=0.2 * rng.normal(size=(c, p)), Wgrid=rng.normal(size=(ntimes, nind)) * mask,
                vare=np.array(1.3), Ginv=np.linalg.inv(varg), log_pi=np.log(pi))


def _replay_draws(jax, key, p, c, dtype):
    """sweep_rrm_abc's draws: per marker split(key, 3) -> gumbel(k_lab,
    (2^c,)), normal(k_z, (c,)) (jwas_tpu/ops/rrm.py:86, :104, :113)."""
    gum, zs = [], []
    for _ in range(p):
        key, k_lab, k_z = jax.random.split(key, 3)
        gum.append(np.asarray(jax.random.gumbel(k_lab, (2**c,), dtype)))
        zs.append(np.asarray(jax.random.normal(k_z, (c,), dtype)))
    return np.stack(gum), np.stack(zs)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("method", ["BayesC", "RR-BLUP"])
def test_plain_sweep_matches_jwas_tpu(method, c, dtype):
    """sweep_rrm_abc_ref given the draws jwas_tpu's sweep_rrm_abc makes
    equals it: every delta, alpha and beta, and the grid."""
    jax = _jax()
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    inp = _sweep_inputs(c)
    p = inp["X"].shape[1]
    estimate = method == "BayesC"
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    key = jax.random.PRNGKey(7 + c)
    J = {k: jnp.asarray(v, jdt) for k, v in inp.items()}
    zeros = jnp.zeros((c, p), jdt)
    want = jrrm.sweep_rrm_abc(J["X"], J["phi"], J["mphiphi"], J["obs_mask"], J["alpha"],
                              zeros, zeros, J["Wgrid"], J["vare"], J["Ginv"], J["log_pi"],
                              key, estimate_delta=estimate)
    gum, zs = _replay_draws(jax, key, p, c, jdt)
    tdt = torch.float64 if dtype == "float64" else torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=tdt)

    got = rrm.sweep_rrm_abc(t(inp["X"].T.copy()), t(inp["phi"]), t(inp["mphiphi"]),
                            t(inp["obs_mask"]), t(inp["alpha"]), t(inp["Wgrid"]),
                            t(inp["vare"]), t(inp["Ginv"]), t(inp["log_pi"]), None,
                            estimate_delta=estimate, gumbel=t(gum) if estimate else None,
                            zs=t(zs))
    want = [np.asarray(w, dtype=np.float64) for w in want]
    got = [g.numpy().astype(np.float64) for g in got]
    np.testing.assert_array_equal(got[2], want[2])
    tol = (dict(rtol=1e-10, atol=1e-12), dict(rtol=1e-10, atol=1e-12)) if dtype == "float64" \
        else (dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-5))
    for k in (0, 1):
        np.testing.assert_allclose(got[k], want[k], **tol[0])
    np.testing.assert_allclose(got[3], want[3], **tol[1])
    if not estimate:
        np.testing.assert_array_equal(got[2], 1.0)


def _assert_sweeps_equal(got, want, dtype, grid=True):
    """test_plain_sweep_matches_jwas_tpu's tolerances: every delta equal."""
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    np.testing.assert_array_equal(got[2], want[2])
    tol = (dict(rtol=1e-10, atol=1e-12), dict(rtol=1e-10, atol=1e-12)) if dtype == "float64" \
        else (dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-5))
    for k in (0, 1):
        np.testing.assert_allclose(got[k], want[k], **tol[0])
    if grid:
        np.testing.assert_allclose(got[3], want[3], **tol[1])


@pytest.mark.parametrize("p,b", [(5, 8), (8, 8), (9, 8), (23, 8), (13, 4)])
@pytest.mark.parametrize("c", [1, 3])
def test_build_rrm_cross_grams_matches_einsum(c, p, b):
    """K10's cross-Grams against a numpy einsum of phi' (X_k' diag(mask_t)
    X_s) phi: the upper triangle of each chunk's (b, b) blocks, zero below
    it and for the last chunk's padding; the diagonal blocks equal
    build_m_phiphi; float32 within 1e-5 of float64; pack_cross_grams'
    layout, in both dtypes."""
    rng = np.random.default_rng(c * 100 + p + b)
    nind, ntimes = 37, 6
    X = rng.normal(size=(nind, p))
    phi = rng.normal(size=(ntimes, c))
    mask = (rng.uniform(size=(ntimes, nind)) < 0.7).astype(float)
    full = np.einsum("ti,ik,is,ta,td->ksad", mask, X, X, phi, phi)
    args = (torch.as_tensor(X.T.copy()), torch.as_tensor(phi), torch.as_tensor(mask))
    got = rrm.build_rrm_cross_grams(*args, b).numpy()
    nq = -(-p // b)
    assert got.shape == (nq, b, b, c, c)
    want = np.zeros_like(got)
    for q in range(nq):
        for k in range(b):
            for s_ in range(k, b):
                if q * b + s_ < p:
                    want[q, k, s_] = full[q * b + k, q * b + s_]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    diag = got[:, np.arange(b), np.arange(b)].reshape(nq * b, c, c)[:p]
    np.testing.assert_allclose(diag, rrm.build_m_phiphi(*args).numpy(), rtol=1e-12, atol=1e-12)
    got32 = rrm.build_rrm_cross_grams(*(a.float() for a in args), b).numpy()
    np.testing.assert_allclose(got32, want, rtol=1e-5, atol=1e-5)
    # K10's packed layout: the pairs k < s in row order, the entries a <= d,
    # zeros to whole 8-byte words
    for dtype, cg in ((torch.float64, torch.as_tensor(got)), (torch.float32, torch.as_tensor(got32))):
        packed = rrm.pack_cross_grams(cg).numpy()
        entries = [(a, d) for a in range(c) for d in range(a, c)]
        words = 8 // cg.element_size()
        assert packed.shape == (nq, b * (b - 1) // 2, -(-len(entries) // words) * words)
        pairs = [(k, s_) for k in range(b) for s_ in range(k + 1, b)]
        for q in range(nq):
            for i, (k, s_) in enumerate(pairs):
                np.testing.assert_array_equal(packed[q, i, :len(entries)],
                                              [cg[q, k, s_, a, d] for a, d in entries])
        np.testing.assert_array_equal(packed[:, :, len(entries):], 0.0)


_CHUNK_B = 8
_RAGGED_P = (5, 8, 9, 23)          # p < b, p = b, p = b + 1, p = 2b + 7


@functools.lru_cache(maxsize=None)
def _jwas_sweep_at(method, c, dtype):
    """jwas_tpu's sweep_rrm_abc at p = 2b + 7 on _sweep_inputs, and the
    draws it makes, replayed (numpy)."""
    jax = _jax()
    jax.config.update("jax_enable_x64", dtype == "float64")
    import jax.numpy as jnp

    p = max(_RAGGED_P)
    inp = _sweep_inputs(c, p=p)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    key = jax.random.PRNGKey(11 + c)
    J = {k: jnp.asarray(v, jdt) for k, v in inp.items()}
    zeros = jnp.zeros((c, p), jdt)
    want = jrrm.sweep_rrm_abc(J["X"], J["phi"], J["mphiphi"], J["obs_mask"], J["alpha"],
                              zeros, zeros, J["Wgrid"], J["vare"], J["Ginv"], J["log_pi"],
                              key, estimate_delta=method == "BayesC")
    gum, zs = _replay_draws(jax, key, p, c, jdt)
    return inp, [np.asarray(w) for w in want], gum, zs


@pytest.mark.parametrize("p", _RAGGED_P)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("c", [1, 2, 3, 5])
@pytest.mark.parametrize("method", ["BayesC", "RR-BLUP"])
def test_chunked_sweep_matches_plain_and_jwas_tpu(method, c, dtype, p):
    """K10's chunk algebra (sweep_rrm_abc_chunked_ref, chunks of b = 8
    against build_rrm_cross_grams) on jwas_tpu's replayed draws, at p
    ragged against b: equal to sweep_rrm_abc_ref on the first p markers
    (every output), and to jwas_tpu's sweep: a sweep is sequential, so the
    first p markers' alpha, beta and delta are those of jwas_tpu's pass
    over 2b + 7 markers, and at p = 2b + 7 the grid too."""
    inp, want, gum, zs = _jwas_sweep_at(method, c, dtype)
    estimate = method == "BayesC"
    tdt = torch.float64 if dtype == "float64" else torch.float32

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=tdt)

    X = t(inp["X"][:, :p].T)
    phi, mask = t(inp["phi"]), t(inp["obs_mask"])
    args = (t(inp["mphiphi"][:p]), mask, t(inp["alpha"][:, :p]), t(inp["Wgrid"]),
            t(inp["vare"]), t(inp["Ginv"]), t(inp["log_pi"]),
            t(gum[:p]) if estimate else None, t(zs[:p]))
    cg = rrm.build_rrm_cross_grams(X, phi, mask, _CHUNK_B)
    got = rrm.sweep_rrm_abc_chunked_ref(X, phi, args[0], cg, *args[1:], estimate)
    plain = rrm.sweep_rrm_abc_ref(X, phi, *args, estimate)
    _assert_sweeps_equal([g.numpy() for g in got], [w.numpy() for w in plain], dtype)
    _assert_sweeps_equal([g.numpy() for g in got], [w[:, :p] for w in want[:3]] + [want[3]],
                         dtype, grid=p == max(_RAGGED_P))
    if not estimate:
        np.testing.assert_array_equal(got[2].numpy(), 1.0)


# ------------------------------------------------------------ set-up and step


def _capture(monkeypatch, module, name, sink):
    """Record the (state, data) of a chain's first window; the chain runs on."""
    real = getattr(module, name)
    if module is mcmc_rrm:
        def wrapped(cfg, state, data, *a, **k):
            sink.setdefault("run", (cfg, state, data))
            return real(cfg, state, data, *a, **k)
        monkeypatch.setattr(module, name, wrapped)
    else:
        def make(cfg):
            run = real(cfg)

            def wrapped(state, data, *a, **k):
                sink.setdefault("run", (cfg, state, data))
                return run(state, data, *a, **k)
            return wrapped
        monkeypatch.setattr(module, name, make)


def _iid_problem():
    rng = np.random.default_rng(11)
    df, geno_df, U, ids, times, phi = _rrm_sim(seed=11, nind=200, p=80, c=2)
    pe = rng.normal(0, 0.8 * U.std(), size=len(ids))
    df = df.copy()
    df["y"] = df["y"] + df["ID"].map(dict(zip(ids, pe)))
    return df, geno_df, U, ids, times, phi, pe


def _iid_model(pkg, geno_df, U):
    geno = (_port_geno(geno_df) if pkg is jt
            else jwas_tpu.get_genotypes(geno_df, method="BayesC", name="geno"))
    model = pkg.build_model("y = intercept + time + ID + geno", genotypes=geno)
    pkg.set_covariate(model, "time")
    pkg.set_random(model, "ID", float(0.64 * U.std() ** 2))
    return model


def test_set_up_and_one_step_match_jwas_tpu(monkeypatch):
    """The port's set-up of the iid model equals jwas_tpu's (the design,
    W'W, the aligned store, the Grams, the mask and cells, the priors and
    the starting state), and given jwas_tpu's data and a state with random
    location parameters the step's deterministic parts equal jwas_tpu's:
    the location LHS, its right-hand side, the scatter to the grid and the
    gather back."""
    from jwas_tpu.engine import mcmc_rrm as jmr
    from jwas_tpu.engine.mcmc import assemble_lhs_lambda as j_lhs
    import jax.numpy as jnp

    df, geno_df, U, ids, times, phi, _ = _iid_problem()
    sinks = {}
    for pkg, module, name in ((jwas_tpu, jmr, "make_rrm_run_window"),
                              (jt, mcmc_rrm, "run_window")):
        sinks[pkg.__name__] = {}
        _capture(monkeypatch, module, name, sinks[pkg.__name__])
        kw = {"device": "cpu"} if pkg is jt else {}
        pkg.runMCMC(_iid_model(pkg, geno_df, U), df, chain_length=2, seed=2, RRM=phi,
                    output_folder="", **RUN, **kw)
    jcfg, jstate, jdata = sinks["jwas_tpu"]["run"]
    cfg, state, data = sinks["jwas_tpu_torch"]["run"]
    cfg_j, data_j = rrm_data_from_jax(jdata, jcfg, dtype=torch.float64)
    assert cfg == cfg_j
    # float32 sums: the port's Grams from its float32 store, jwas_tpu's in
    # float64 from its float64 copy, then cast
    for k in ("WtW", "X", "mphiphi", "obs_mask", "phi"):
        np.testing.assert_allclose(getattr(data, k).double().numpy(),
                                   getattr(data_j, k).numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(data.cell.numpy(), data_j.cell.numpy())
    np.testing.assert_array_equal(data.W.to_dense().numpy(), np.asarray(jdata.W))
    state_j = rrm_state_from_jax(jstate)
    for k in ("sol", "alpha", "beta", "delta", "ycorr", "vare", "varg", "pi", "marker_scale"):
        np.testing.assert_allclose(getattr(state, k).numpy(), getattr(state_j, k).numpy(),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(state.vc[0].numpy(), state_j.vc[0].numpy(), rtol=1e-6)

    # one step's deterministic parts from jwas_tpu's data and a random state
    rng = np.random.default_rng(3)
    sol = rng.normal(size=jstate.sol.shape)
    jstate = jstate._replace(sol=jnp.asarray(sol, jnp.float32))
    sol = np.asarray(jstate.sol, np.float64)
    state_j = rrm_state_from_jax(jstate, dtype=torch.float64)
    LHS, rhs, ycorr = mcmc_rrm.location_system(cfg_j, state_j, data_j)
    jL = j_lhs(jcfg.re_groups, jdata.WtW, jdata.Vinv, jstate.vc, jstate.vare)
    np.testing.assert_allclose(LHS.numpy(), np.asarray(jL), rtol=1e-5, atol=1e-4)
    jy = np.asarray(jstate.ycorr, np.float64) + np.asarray(jdata.W, np.float64) @ sol
    np.testing.assert_allclose(ycorr.numpy(), jy, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rhs.numpy(), np.asarray(jdata.W, np.float64).T @ jy,
                               rtol=1e-6, atol=1e-5)
    grid = mcmc_rrm.to_grid(data_j, ycorr)
    jgrid = np.zeros(np.shape(jdata.obs_mask))
    jgrid[np.asarray(jdata.time_idx), np.asarray(jdata.ind_idx)] = jy
    np.testing.assert_allclose(grid.numpy(), jgrid, rtol=1e-12)
    np.testing.assert_array_equal(mcmc_rrm.from_grid(data_j, grid).numpy(), ycorr.numpy())


# ------------------------------------------------------------ chains


def test_rrm_trajectory_recovery_matches_jwas_tpu():
    """tests/test_rrm.py::test_rrm_trajectory_recovery through the port:
    accuracy > 0.55, coefficients "1", "2"; within 0.05 of jwas_tpu's
    accuracy on the same data and chain settings."""
    df, geno_df, U, ids, times, phi = _rrm_sim()
    acc = {}
    for pkg in (jt, jwas_tpu):
        geno = (_port_geno(geno_df) if pkg is jt
                else jwas_tpu.get_genotypes(geno_df, method="BayesC", name="geno"))
        model = pkg.build_model("y = intercept + time + geno", genotypes=geno)
        kw = {"device": "cpu"} if pkg is jt else {}
        out = pkg.runMCMC(model, df, chain_length=600, burnin=150, seed=9, RRM=phi,
                          output_folder="", **RUN, **kw)
        acc[pkg.__name__] = _trajectory_accuracy(out["EBV_trajectory"], U, ids, times)
        if pkg is jt:
            assert set(out["marker effects geno"]["Trait"]) == {"1", "2"}
    assert acc["jwas_tpu_torch"] > 0.55, acc
    assert acc["jwas_tpu_torch"] >= acc["jwas_tpu"] - 0.05, acc


def test_rrm_unique_times_error():
    """tests/test_rrm.py::test_rrm_validation through the port."""
    df, geno_df, U, ids, times, phi = _rrm_sim(nind=30, p=20, seed=5)
    model = jt.build_model("y = intercept + time + geno", genotypes=_port_geno(geno_df))
    with pytest.raises(ValueError, match="unique times"):
        jt.runMCMC(model, df, device="cpu", chain_length=5, RRM=phi[:3], output_folder="",
                   **RUN)


def _per_time_accuracy(traj, U, ids, times):
    traj = pd.DataFrame({k: np.asarray(traj[k]) for k in ("ID", "time", "EBV")})
    acc = []
    for ti, tval in enumerate(times):
        sub = traj[traj["time"] == tval].set_index("ID")["EBV"]
        acc.append(np.corrcoef(sub.loc[ids].to_numpy(), U[ti])[0, 1])
    return float(np.mean(acc))


def test_rrm_with_iid_random_effect_matches_jwas_tpu():
    """tests/test_rrm.py::test_rrm_with_iid_random_effect through the port,
    with its assertions; the mean per-time accuracy within 0.05 of
    jwas_tpu's on the same data."""
    df, geno_df, U, ids, times, phi, pe = _iid_problem()
    acc = {}
    for pkg in (jt, jwas_tpu):
        kw = {"device": "cpu"} if pkg is jt else {}
        out = pkg.runMCMC(_iid_model(pkg, geno_df, U), df, chain_length=400, burnin=80,
                          output_samples_frequency=5, seed=2, RRM=phi, output_folder="",
                          **RUN, **kw)
        acc[pkg.__name__] = _per_time_accuracy(out["EBV_trajectory"], U, ids, times)
        if pkg is not jt:
            continue
        key = "random effect variances y:ID"
        pe_var = float(out[key]["Estimate"][0])
        assert 0.25 * np.var(pe) < pe_var < 4.0 * np.var(pe)
        assert acc["jwas_tpu_torch"] > 0.4, acc
        loc = out["location parameters"]
        sol = {lv: e for ef, lv, e in zip(loc["Effect"], loc["Level"], loc["Estimate"])
               if ef == "ID"}
        assert np.corrcoef([sol[s] for s in ids], pe)[0, 1] > 0.4
    assert acc["jwas_tpu_torch"] >= acc["jwas_tpu"] - 0.05, acc


def test_rrm_with_pedigree_polygenic_effect():
    """tests/test_rrm.py::test_rrm_with_pedigree_polygenic_effect through
    the port (RR-BLUP, ID on the pedigree's A^-1)."""
    from jwas_tpu.io.datasets import simulate_pedigree_genomic_data

    fam = simulate_pedigree_genomic_data(n_founders=30, n_gen=2, n_per_gen=60,
                                         p=60, n_qtl=8, h2=0.5, seed=4)
    ped = jt.get_pedigree(fam["pedigree"])
    ids = [str(s) for s in fam["genotypes"]["ID"]]
    rng = np.random.default_rng(4)
    times = np.arange(1.0, 5.0)
    phi = jt.generate_full_phi(times, ncoeff=2)
    bv = dict(zip(ids, np.asarray(fam["true_bv"], dtype=float)))
    rows = [(s, t, 1.0 + bv[s] + rng.normal(0, 1.0)) for t in times for s in ids]
    df = pd.DataFrame(rows, columns=["ID", "time", "y"])
    model = jt.build_model("y = intercept + ID + geno",
                           genotypes=_port_geno(fam["genotypes"], method="RR-BLUP"))
    jt.set_random(model, "ID", ped)
    out = jt.runMCMC(model, df, device="cpu", chain_length=200, burnin=40,
                     output_samples_frequency=5, seed=5, RRM=phi, output_folder="", **RUN)
    assert "polygenic effects covariance matrix" in out
    assert float(out["polygenic effects covariance matrix"]["Estimate"][0]) > 0
    assert "pi_geno" not in out


def _files_run(pkg, df, geno_df, phi, folder, **kw):
    geno = (_port_geno(geno_df) if pkg is jt
            else jwas_tpu.get_genotypes(geno_df, method="BayesC", name="geno"))
    model = pkg.build_model("y = intercept + time + ID + geno", genotypes=geno)
    pkg.set_random(model, "ID", 0.3)
    pkg.outputMCMCsamples(model, "time")
    return pkg.runMCMC(model, df, chain_length=60, burnin=20, seed=9, RRM=phi,
                       output_folder=folder, output_samples_frequency=10, **RUN, **kw)


def test_result_tables_and_sample_files_match_jwas_tpu(tmp_path):
    """tests/test_rrm.py::test_rrm_sample_files_progress_checkpoint without
    its checkpoints: the same result keys, columns, row order and label
    columns, and the same files with the same headers and row counts, as
    jwas_tpu's (a marker-effect file a coefficient, the c x c marker
    covariance, the location terms asked for, the group's covariance)."""
    df, geno_df, U, ids, times, phi = _rrm_sim(nind=120, p=40, seed=7)
    out_t = _files_run(jt, df, geno_df, phi, str(tmp_path / "port"), device="cpu")
    out_j = _files_run(jwas_tpu, df, geno_df, phi, str(tmp_path / "ref"))
    assert sorted(k for k in out_t if not k.startswith("_")) == sorted(out_j)
    for key, ref in out_j.items():
        got = out_t[key]
        assert list(got.columns) == list(ref.columns), key
        assert len(got) == len(ref), key
        for col in ref.columns:
            if ref[col].dtype == object:
                assert [str(v) for v in got[col]] == [str(v) for v in ref[col]], (key, col)
        if key == "EBV_trajectory":
            np.testing.assert_array_equal(np.asarray(got["time"], dtype=float),
                                          ref["time"].to_numpy(dtype=float))
    files_t = sorted(os.listdir(tmp_path / "port"))
    assert files_t == sorted(os.listdir(tmp_path / "ref"))
    assert "MCMC_samples_marker_effects_geno_coeff2.txt" in files_t
    for f in files_t:
        with open(tmp_path / "port" / f) as a, open(tmp_path / "ref" / f) as b:
            la, lb = a.read().splitlines(), b.read().splitlines()
        assert len(la) == len(lb), f
        header = not lb[0].split(",")[0].lstrip("-").replace(".", "").replace("e-", "").isdigit()
        assert la[0] == lb[0] or not header, f
        assert len(la[1].split(",")) == len(lb[1].split(",")), f
    with open(tmp_path / "port" / "MCMC_samples_residual_variance.txt") as f:
        assert len(f.read().splitlines()) == 1 + (60 - 20) // 10


# ------------------------------------------------------------ errors and refusals


def _error_case(pkg, case):
    df, geno_df, U, ids, times, phi = _rrm_sim(nind=30, p=20, seed=5)
    kw = {"device": "cpu"} if pkg is jt else {}
    gkw = {"device": "cpu"} if pkg is jt else {}
    method, eq, opts = "BayesC", "y = intercept + time + geno", {}
    if case == "unique times":
        phi = phi[:1]
    elif case == "duplicates":
        df = pd.concat([df, df.iloc[:3]], ignore_index=True)
    elif case == "BayesR":
        method = "BayesR"
    elif case == "multi-trait":
        df = df.assign(y2=df["y"])
        eq = "y = intercept + geno\ny2 = intercept + geno"
    elif case == "single-step":
        opts = dict(single_step_analysis=True, pedigree=object())
    storage = "2bit" if case == "2-bit" else None
    gk = dict(gkw, storage=storage) if storage else gkw
    geno = pkg.get_genotypes(geno_df, method=method, name="geno", **gk)
    model = pkg.build_model(eq, genotypes=geno)
    with pytest.raises(ValueError) as e:
        pkg.runMCMC(model, df, chain_length=5, RRM=phi, output_folder="", **RUN, **opts, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["unique times", "duplicates", "BayesR", "2-bit",
                                  "multi-trait", "single-step"])
def test_rrm_errors_match_jwas_tpu(case):
    """The RRM ValueErrors as jwas_tpu raises them."""
    assert _error_case(jt, case) == _error_case(jwas_tpu, case)


def test_rrm_refusals():
    """RRM with checkpoints is refused naming "ops layer"; without a card
    the default device raises; K10's limits (above 5 coefficients or 32
    time points) are refused at set-up, naming their entry in ROADMAP.md."""
    df, geno_df, U, ids, times, phi = _rrm_sim(nind=30, p=20, seed=5)

    def run(phi_, data=df, **kw):
        model = jt.build_model("y = intercept + time + geno", genotypes=_port_geno(geno_df))
        return jt.runMCMC(model, data, device="cpu", chain_length=5, RRM=phi_,
                          output_folder="", **RUN, **kw)

    with pytest.raises(NotImplementedError, match="ops layer"):
        run(phi, checkpoint_frequency=2)
    if not torch.cuda.is_available():         # the card is the default device
        model = jt.build_model("y = intercept + time + geno", genotypes=_port_geno(geno_df))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jt.runMCMC(model, df, chain_length=5, RRM=phi, output_folder="", **RUN)
    with pytest.raises(NotImplementedError, match=r"\(K10\) above its limits"):
        run(jt.generate_full_phi(times, 6))
    many = pd.DataFrame({"ID": [f"i{k % 30}" for k in range(30 * 33)],
                         "time": np.repeat(np.arange(33.0), 30), "y": np.arange(990.0)})
    with pytest.raises(NotImplementedError, match="33 time points"):
        run(jt.generate_full_phi(np.arange(33.0), 2), data=many)


def test_bayesb_runs_as_bayesc_and_bayesl_as_rr_blup_fault_r15():
    """Fault R15: jwas_tpu's run_mcmc_rrm runs BayesB as BayesC (no per-marker
    variance, engine/mcmc_rrm.py:113, :153) and BayesL as RR-BLUP (no
    lambda draw); the port keeps those semantics: the same seed gives the
    same chain bit for bit, in jwas_tpu and in the port."""
    df, geno_df, U, ids, times, phi = _rrm_sim(nind=60, p=30, seed=8)
    for a, b in (("BayesB", "BayesC"), ("BayesL", "RR-BLUP")):
        for pkg in (jt, jwas_tpu):
            kw = {"device": "cpu"} if pkg is jt else {}
            outs = []
            for method in (a, b):
                geno = (_port_geno(geno_df, method=method) if pkg is jt else
                        jwas_tpu.get_genotypes(geno_df, method=method, name="geno"))
                model = pkg.build_model("y = intercept + time + geno", genotypes=geno)
                outs.append(pkg.runMCMC(model, df, chain_length=30, seed=4, RRM=phi,
                                        output_folder="", **RUN, **kw))
            for key in ("marker effects geno", "EBV_trajectory", "residual variance"):
                col = "EBV" if key == "EBV_trajectory" else "Estimate"
                np.testing.assert_array_equal(np.asarray(outs[0][key][col]),
                                              np.asarray(outs[1][key][col]),
                                              err_msg=f"{pkg.__name__} {a} {key}")


def test_float64_vinv_and_fixed_group():
    """double_precision runs the chain in float64; a Vinv ("V") group
    enters the LHS; a group set with estimate_variance=False keeps its G
    (the port's R10 repair), while an estimated one moves."""
    df, geno_df, U, ids, times, phi = _rrm_sim(nind=50, p=25, seed=6)
    rng = np.random.default_rng(6)
    A = rng.normal(size=(50, 50))
    V = A @ A.T / 50 + np.eye(50)
    model = jt.build_model("y = intercept + time + ID + geno",
                           genotypes=_port_geno(geno_df, double_precision=True))
    jt.set_covariate(model, "time")
    jt.set_random(model, "ID", 0.4, Vinv=np.linalg.inv(V), names=ids,
                  estimate_variance=False)
    out = jt.runMCMC(model, df, device="cpu", chain_length=20, seed=1, RRM=phi,
                     double_precision=True, output_folder="", **RUN)
    vc = out["random effect variances y:ID"]
    assert float(vc["Estimate"][0]) == 0.4 and float(vc["SD"][0]) == 0.0
    assert np.asarray(out["EBV_trajectory"]["EBV"]).dtype == np.float64
    assert np.isfinite(np.asarray(out["marker effects geno"]["Estimate"])).all()


def test_aligned_to_matches_jwas_tpu():
    """Genotypes.aligned_to: the store's columns in the given order, as
    jwas_tpu's rows; the store itself for its own order; an unknown ID
    raises."""
    df, geno_df, U, ids, times, phi = _rrm_sim(nind=20, p=12, seed=2)
    g = _port_geno(geno_df)
    ref = jwas_tpu.get_genotypes(geno_df, method="BayesC", name="geno")
    order = list(np.random.default_rng(1).permutation(g.obs_ids))
    np.testing.assert_allclose(g.aligned_to(order).dense.numpy().T,
                               ref.aligned_to(order).genotypes, rtol=1e-6)
    assert g.aligned_to(list(g.obs_ids)).dense is g.dense
    with pytest.raises(ValueError, match="has no genotypes"):
        g.aligned_to(["nobody"])
