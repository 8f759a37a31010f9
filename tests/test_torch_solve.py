"""The port's solve (jwas_tpu_torch/engine/solve.py) against jwas_tpu.solve
(tests/test_solve.py, tests/test_sparse_mme.py::test_solve_sparse_100k_levels).

(a) Dense: the "default" MME (names, W, LHS, RHS) equals jwas_tpu's to
    1e-10 for a single trait and for two (the trait-block assembly);
    Jacobi, Gauss-Seidel (a K6 pass with zero normals a sweep), CG and
    Gibbs (K6 passes' running mean) give fitted values W x within 1e-3 of
    jwas_tpu's solvers' (Gibbs within 0.05, Monte-Carlo error).
(b) Sparse (sparse_location=True): the LHS equals jwas_tpu's; Jacobi, CG
    and Gauss-Seidel equal jwas_tpu's within 1e-5; CG agrees between the
    dense and sparse paths (the reference test's 1e-4 / 1e-5).
(c) 100,001 levels (the reference test's design, auto-sparse): CG BLUPs
    correlate with the simulated u above 0.55, Jacobi with CG above
    0.999, within 300 s.
(d) Fault R4 repaired: the sparse Gibbs draws maxiter joint draws (1,100
    here) in float64 with double_precision, where jwas_tpu draws at most
    1,000 in float32; both means within Monte-Carlo error of the CG
    solution.
"""

import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import jwas_tpu
import jwas_tpu_torch as jt


def _sim_st(n=400, seed=0):
    rng = np.random.default_rng(seed)
    herd = rng.integers(0, 8, size=n)
    x1 = rng.normal(size=n)
    y = 2.0 + 0.5 * x1 + herd * 0.3 + rng.normal(size=n) * 0.6
    return {"ID": [f"i{i}" for i in range(n)], "y": y,
            "herd": [f"h{h}" for h in herd], "x1": x1}


def _st_models():
    def jmodel():
        m = jwas_tpu.build_model("y = intercept + herd + x1", 1.0)
        jwas_tpu.set_covariate(m, "x1")
        return m

    def tmodel():
        m = jt.build_model("y = intercept + herd + x1", 1.0)
        jt.set_covariate(m, "x1")
        return m
    return jmodel, tmodel


def _tables(cols):
    return pd.DataFrame(cols), jt.Table({k: np.asarray(v, dtype=object) if isinstance(v[0], str)
                                         else np.asarray(v) for k, v in cols.items()})


def test_default_mme_matches_jwas_tpu():
    """solver="default" returns jwas_tpu's names, W, LHS and RHS (to
    1e-10), single-trait and two-trait (tests/test_solve.py:48-66)."""
    jmodel, tmodel = _st_models()
    jdf, tdf = _tables(_sim_st())
    jn, jW, jL, jR = jwas_tpu.solve(jmodel(), jdf, solver="default")
    tn, tW, tL, tR = jt.solve(tmodel(), tdf, solver="default", device="cpu")
    assert tn == jn
    for a, b in ((tW, jW), (tL, jL), (tR, jR)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    rng = np.random.default_rng(3)
    n = 120
    herd = rng.integers(0, 5, size=n)
    cols = {"ID": [f"i{i}" for i in range(n)], "y1": 1.0 + herd * 0.4 + rng.normal(size=n),
            "y2": -0.5 + herd * 0.2 + rng.normal(size=n), "herd": [f"h{h}" for h in herd]}
    jdf, tdf = _tables(cols)
    R = np.array([[1.0, 0.3], [0.3, 0.8]])
    eq = "y1 = intercept + herd\ny2 = intercept + herd"
    jn, jW, jL, jR = jwas_tpu.solve(jwas_tpu.build_model(eq, R), jdf, solver="default")
    tn, tW, tL, tR = jt.solve(jt.build_model(eq, R), tdf, solver="default", device="cpu")
    assert tn == jn
    np.testing.assert_allclose(tL, jL, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tR, jR, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("solver", ["Jacobi", "Gauss-Seidel", "CG", "Gibbs"])
def test_dense_solvers_match_jwas_tpu(solver):
    """Each dense solver's fitted values W x against jwas_tpu's same solver
    within 1e-3 (Gibbs: 5,000 passes' means within 0.05), and against the
    least-squares solution of the singular MME (tests/test_solve.py:31-45)."""
    jmodel, tmodel = _st_models()
    jdf, tdf = _tables(_sim_st())
    maxiter = 5000 if solver == "Gibbs" else 20000
    kw = dict(solver=solver, maxiter=maxiter)
    if solver == "CG":
        kw["tolerance"] = 1e-12
    ref = jwas_tpu.solve(jmodel(), jdf, **kw)
    got = jt.solve(tmodel(), tdf, device="cpu", **kw)
    _, W, LHS, RHS = jt.solve(tmodel(), tdf, solver="default", device="cpu")
    direct = W @ np.linalg.lstsq(LHS, RHS, rcond=None)[0]
    tol = 0.05 if solver == "Gibbs" else 1e-3
    assert list(got["Name"]) == list(ref["Name"])
    np.testing.assert_allclose(W @ np.asarray(got["Estimate"]),
                               W @ ref["Estimate"].to_numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(W @ np.asarray(got["Estimate"]), direct, rtol=tol, atol=tol)


def _ped_data(n=150, seed=8):
    """tests/test_solve.py:94-113's pedigree model data in both packages."""
    rng = np.random.default_rng(seed)
    ids = [f"g{i}" for i in range(n)]
    sire = ["missing" if i < 5 else ids[int(rng.integers(0, i))] for i in range(n)]
    dam = ["missing" if i < 5 else ids[int(rng.integers(0, i))] for i in range(n)]
    y = 1.5 + rng.normal(size=n)
    pcols = {"ID": ids, "S": sire, "D": dam}
    jped = jwas_tpu.get_pedigree(pd.DataFrame(pcols))
    tped = jt.get_pedigree(jt.Table({k: np.asarray(v, dtype=object) for k, v in pcols.items()}),
                           missingstring=("missing",))
    return jped, tped, _tables({"ID": ids, "y": y})


def _ped_models(jped, tped):
    def jmodel():
        m = jwas_tpu.build_model("y = intercept + ID")
        jwas_tpu.set_random(m, "ID", jped, np.array(1.0))
        return m

    def tmodel():
        m = jt.build_model("y = intercept + ID")
        jt.set_random(m, "ID", tped, np.array(1.0))
        return m
    return jmodel, tmodel


@pytest.mark.parametrize("solver", ["Jacobi", "Gauss-Seidel", "CG"])
def test_sparse_solvers_match_jwas_tpu(solver):
    """sparse_location=True: the CSR LHS equals jwas_tpu's; Jacobi, CG (on
    the device with a CSR tensor) and Gauss-Seidel (scipy's triangular
    solves on the host) equal jwas_tpu's within 1e-5; CG equals the dense
    path's within the reference's 1e-4 / 1e-5."""
    jped, tped, (jdf, tdf) = _ped_data()
    jmodel, tmodel = _ped_models(jped, tped)
    _, _, jL, jR = jwas_tpu.solve(jmodel(), jdf, solver="default", sparse_location=True)
    _, _, tL, tR = jt.solve(tmodel(), tdf, solver="default", sparse_location=True, device="cpu")
    np.testing.assert_allclose(tL.toarray(), jL.toarray(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tR, jR, rtol=1e-12, atol=1e-12)
    kw = dict(solver=solver, maxiter=2000, tolerance=1e-12)
    ref = jwas_tpu.solve(jmodel(), jdf, sparse_location=True, **kw)["Estimate"].to_numpy()
    got = np.asarray(jt.solve(tmodel(), tdf, sparse_location=True, device="cpu", **kw)["Estimate"])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if solver == "CG":
        dense = np.asarray(jt.solve(tmodel(), tdf, sparse_location=False, device="cpu",
                                    **kw)["Estimate"])
        np.testing.assert_allclose(dense, got, rtol=1e-4, atol=1e-5)


def test_solve_sparse_100k_levels():
    """solve() at 100,001 levels (tests/test_sparse_mme.py:176-226's design:
    a 100,000-animal pedigree, 30,000 phenotyped, u = hAi^-1 z): the sparse
    path is taken on its own; CG's BLUPs correlate with u above 0.55 and
    Jacobi's with CG's above 0.999, all within 300 s."""
    from scipy.sparse.linalg import spsolve_triangular

    n_ped = 100_000
    rng = np.random.default_rng(17)
    ids = np.array([f"i{k}" for k in range(n_ped)], dtype=object)
    anc = rng.integers(0, np.maximum(np.arange(n_ped), 1), size=(2, n_ped))
    sire = np.where(np.arange(n_ped) < 50, "missing", ids[anc[0]]).astype(object)
    dam = np.where(np.arange(n_ped) < 50, "missing", ids[anc[1]]).astype(object)
    t0 = time.time()
    ped = jt.get_pedigree(jt.Table({"ID": ids, "S": sire, "D": dam}),
                          missingstring=("missing",))
    hAi = ped.a_inverse_factor()
    u = spsolve_triangular(hAi.tocsr(), rng.normal(size=n_ped), lower=True)
    u = u / u.std()
    obs = rng.choice(n_ped, size=30_000, replace=False)
    code = ped.id_index
    y = 5.0 + u[[code[ids[i]] for i in obs]] + rng.normal(size=len(obs))
    df = jt.Table({"ID": ids[obs], "y": y})

    def fresh():
        m = jt.build_model("y = intercept + ID")
        jt.set_random(m, "ID", ped, np.array(1.0))
        return m

    out = jt.solve(fresh(), df, solver="CG", maxiter=500, tolerance=1e-10, device="cpu")
    assert len(out) == 1 + n_ped
    est = np.asarray(out["Estimate"])[1:]
    assert np.corrcoef(est, u)[0, 1] > 0.55
    out_j = jt.solve(fresh(), df, solver="Jacobi", maxiter=2000, tolerance=1e-12, device="cpu")
    assert np.corrcoef(np.asarray(out_j["Estimate"])[1:], est)[0, 1] > 0.999
    assert time.time() - t0 < 300


def test_sparse_gibbs_takes_maxiter_float64_draws_fault_r4(monkeypatch):
    """Fault R4 repaired: the port's sparse Gibbs solver takes all maxiter =
    1,100 joint draws, in float64 with double_precision=True; jwas_tpu's
    takes 1,000 (its cap, engine/solve.py:239-241) in float32 whatever it
    is asked. Both running means lie within Monte-Carlo error of the CG
    solution (5 posterior sd over sqrt(draws), plus 0.02)."""
    from jwas_tpu_torch.ops import sparse_mme as sm

    jped, tped, (jdf, tdf) = _ped_data(n=80)
    jmodel, tmodel = _ped_models(jped, tped)
    calls, dtypes = [0], set()
    draw = sm.sample_location_po

    def counted(gen, sl, re_cfgs, rhs, *a, **k):
        calls[0] += 1
        dtypes.add(rhs.dtype)
        return draw(gen, sl, re_cfgs, rhs, *a, **k)

    monkeypatch.setattr(sm, "sample_location_po", counted)
    got = np.asarray(jt.solve(tmodel(), tdf, solver="Gibbs", maxiter=1100,
                              sparse_location=True, double_precision=True,
                              device="cpu")["Estimate"])
    assert calls[0] == 1100 and dtypes == {torch.float64}
    folds = [0]
    fold_in = jax.random.fold_in

    def counted_fold(key, i):
        folds[0] += 1
        return fold_in(key, i)

    monkeypatch.setattr(jax.random, "fold_in", counted_fold)
    ref = jwas_tpu.solve(jmodel(), jdf, solver="Gibbs", maxiter=1100,
                         sparse_location=True)["Estimate"].to_numpy()
    assert folds[0] == 1000
    exact = np.asarray(jt.solve(tmodel(), tdf, solver="CG", maxiter=2000, tolerance=1e-12,
                                sparse_location=True, device="cpu")["Estimate"])
    _, _, L, _ = jt.solve(tmodel(), tdf, solver="default", sparse_location=True, device="cpu")
    vare = float(np.var(np.asarray(tdf["y"]), ddof=1)) / 2     # the default prior
    sd = np.sqrt(vare * np.diag(np.linalg.inv(L.toarray())))
    assert np.all(np.abs(got - exact) <= 5 * sd / np.sqrt(1100) + 0.02)
    assert np.all(np.abs(ref - exact) <= 5 * sd / np.sqrt(1000) + 0.02)
