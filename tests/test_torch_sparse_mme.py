"""The port's sparse location path (jwas_tpu_torch/ops/sparse_mme.py and
its branch of runMCMC) against jwas_tpu's (jwas_tpu/ops/sparse_mme.py),
on tests/test_sparse_mme.py's data.

(a) The CSR operators (W x, W'v, the lambda-MME's A x and diag(A)) equal
    jwas_tpu's in float32 within rtol 2e-4 (the reference test's
    tolerance) and the dense product in float64 within 1e-12; cg_solve
    equals jwas_tpu's in float32 and the dense solve in float64.
(b) The PO draw fed jwas_tpu's own normals (replayed with jax.random.split
    as sample_location_po does, :160-169) equals jwas_tpu's draw in float32
    at 1e-6 within 1e-3 of the draw's scale, and in float64 the exact draw
    within 1e-7; its moments are N(A^-1 rhs, vare A^-1). (jwas_tpu runs in
    float32 here: in JAX's x64 mode on this 8-device CPU platform its prior
    matvec returned wrong sums in some runs.)
(c) One runMCMC sparse chain of the pedigree animal model at the reference
    test's length (3,000 sweeps, 500 burn-in) against jwas_tpu's sparse
    chain on the same data, within calibrated 99% Monte-Carlo bounds
    (CALIBRATED_SD, from 24 seeds of each package; recalibrate with
    `python tests/test_torch_sparse_mme.py calibrate port|jwas_tpu 1 24
    out.json` (or a few processes of a few seeds each), then
    `... summarize *.json`, PYTHONPATH=.:tests).
(d) sparse_location=True outside a single trait raises jwas_tpu's
    ValueError; a model above 20,000 levels takes the sparse path on its
    own; weights, float64, a binary trait and markers run on it; a chain
    whose CG stops unconverged warns at the end of the run (fault R3) and
    counts the draws.
"""

import json
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

F32, F64 = torch.float32, torch.float64
SWEEPS, BURNIN = 3000, 500          # tests/test_sparse_mme.py:165
# between-seed sd of the chains' posterior means (seeds 1..24 a package,
# from the calibrate command, on the CPU): residual variance, polygenic variance, intercept; the
# means over the seeds were 0.5064 / 0.5953 / 2.3088 (port) and 0.5085 /
# 0.5892 / 2.3047 (jwas_tpu)
CALIBRATED_SD = {
    "port": {"vare": 0.010373, "varu": 0.022086, "mu": 0.014675},
    "jwas_tpu": {"vare": 0.007071, "varu": 0.016831, "mu": 0.013014},
}
Z99 = 2.576


def _ped_frames(n, seed):
    rng = np.random.default_rng(seed)
    ids = [f"a{i}" for i in range(n)]
    sire, dam = [], []
    for i in range(n):
        if i < 4:
            sire.append("missing")
            dam.append("missing")
        else:
            s, d = rng.choice(i, size=2, replace=False)
            sire.append(ids[s])
            dam.append(ids[d])
    return ids, sire, dam


def _peds(n, seed):
    """The same pedigree read by both packages."""
    import pandas as pd

    import jwas_tpu_torch as jt
    from jwas_tpu.io.pedigree import get_pedigree as jget

    ids, sire, dam = _ped_frames(n, seed)
    jped = jget(pd.DataFrame({"ID": ids, "Sire": sire, "Dam": dam}))
    tped = jt.get_pedigree(jt.Table({"ID": np.array(ids, dtype=object),
                                     "Sire": np.array(sire, dtype=object),
                                     "Dam": np.array(dam, dtype=object)}),
                           missingstring=("missing",))
    assert jped.ids == tped.ids
    return jped, tped


class _Grp:        # the REGroupData fields build_sparse_loc reads
    def __init__(self, q, Vinv, F):
        self.n_levels, self.Vinv, self.Vinv_factor = q, Vinv, F


def _problem(n=60, seed=1, dtype=F32):
    """tests/test_sparse_mme.py::_small_problem in both packages: W = [1 |
    x | Z_animal | Z_litter], weights, a pedigree term and an i.i.d. one."""
    from jwas_tpu.engine.state import REGroupCfg as JCfg
    from jwas_tpu.ops import sparse_mme as jsm

    from jwas_tpu_torch.engine.state import REGroupCfg
    from jwas_tpu_torch.ops import sparse_mme as sm

    rng = np.random.default_rng(seed)
    jped, tped = _peds(24, seed)
    q, lit_q = 24, 6
    animal, litter = rng.integers(0, q, n), rng.integers(0, lit_q, n)
    W = np.zeros((n, 2 + q + lit_q))
    W[:, 0] = 1.0
    W[:, 1] = rng.normal(size=n)
    W[np.arange(n), 2 + animal] = 1.0
    W[np.arange(n), 2 + q + litter] = 1.0
    rinv = rng.uniform(0.5, 2.0, n)
    hAi = jped.a_inverse_factor()
    np.testing.assert_allclose(tped.a_inverse_factor().toarray(), hAi.toarray(), atol=1e-14)
    Ai = (hAi.T @ hAi).tocsr()
    groups = [_Grp(q, Ai, hAi), _Grp(lit_q, None, None)]
    jcfgs = [JCfg(starts=(2,), n_levels=q, df=4.0, has_vinv=True, random_type="A",
                  factor_rows=hAi.shape[0]),
             JCfg(starts=(2 + q,), n_levels=lit_q, df=4.0, has_vinv=False, random_type="I")]
    tcfgs = [REGroupCfg(starts=(2,), n_levels=q, df=4.0, has_vinv=True, random_type="A",
                        estimate_variance=True, factor_rows=hAi.shape[0]),
             REGroupCfg(starts=(2 + q,), n_levels=lit_q, df=4.0, has_vinv=False,
                        random_type="I", estimate_variance=True)]
    jdt = jnp.float32
    jsl = jsm.build_sparse_loc(sp.csr_matrix(W), rinv, groups, jcfgs, dtype=jdt)
    tsl = sm.build_sparse_loc(sp.csr_matrix(W), rinv, groups, tcfgs, dtype, "cpu")
    A = (W * rinv[:, None]).T @ W
    return dict(W=W, rinv=rinv, Ai=Ai, jsl=jsl, tsl=tsl, jcfgs=jcfgs, tcfgs=tcfgs,
                jdt=jdt, A_w=A, q=q, lit_q=lit_q)


def _dense_A(pb, gis, vare):
    A = pb["A_w"].copy()
    q = pb["q"]
    A[2:2 + q, 2:2 + q] += pb["Ai"].toarray() * gis[0] * vare
    A[2 + q:, 2 + q:] += np.eye(pb["lit_q"]) * gis[1] * vare
    return A


@pytest.mark.parametrize("dtype", [F32, F64])
def test_operators_match_jwas_tpu(dtype):
    """W x, W'v, A x and diag(A) against jwas_tpu's in float32 (rtol 2e-4,
    the reference test's) and against the dense products in float64
    within 1e-12. (jwas_tpu in JAX's x64 mode is not used: on this
    8-device CPU platform its prior matvec returned wrong sums in some
    runs.)"""
    from jwas_tpu.ops import sparse_mme as jsm

    from jwas_tpu_torch.ops import sparse_mme as sm

    pb = _problem(dtype=dtype)
    W, K, n = pb["W"], pb["W"].shape[1], pb["W"].shape[0]
    gis, vare = [0.7, 2.1], 1.3
    rng = np.random.default_rng(2)
    x, v = rng.normal(size=K), rng.normal(size=n)
    tg = [torch.tensor([[g]], dtype=dtype) for g in gis]
    tx, tv = torch.as_tensor(x, dtype=dtype), torch.as_tensor(v, dtype=dtype)
    tvare = torch.tensor(vare, dtype=dtype)
    got = {
        "Ax": sm.mme_matvec(pb["tsl"], pb["tcfgs"], tx, tg, tvare),
        "diag": sm.mme_diag(pb["tsl"], pb["tcfgs"], tg, tvare),
        "Wx": sm.w_matvec(pb["tsl"], tx), "Wtv": sm.w_rhs(pb["tsl"], tv)}
    if dtype == F32:
        jg = [jnp.asarray([[g]], jnp.float32) for g in gis]
        jx, jv = jnp.asarray(x, jnp.float32), jnp.asarray(v, jnp.float32)
        jvare = jnp.asarray(vare, jnp.float32)
        ref = {
            "Ax": jsm.mme_matvec(pb["jsl"], pb["jcfgs"], jx, jg, jvare,
                                 jnp.asarray(pb["rinv"], jnp.float32), n),
            "diag": jsm.mme_diag(pb["jsl"], pb["jcfgs"], jg, jvare),
            "Wx": jsm.w_matvec(pb["jsl"], jx, n), "Wtv": jsm.w_rhs(pb["jsl"], jv, K)}
        tol = dict(rtol=2e-4, atol=2e-4)
    else:
        A = _dense_A(pb, gis, vare)
        ref = {"Ax": A @ x, "diag": np.diag(A), "Wx": W @ x, "Wtv": W.T @ v}
        tol = dict(rtol=1e-12, atol=1e-12)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **tol, err_msg=k)


def test_cg_solve_matches_jwas_tpu():
    """cg_solve against jwas_tpu's in float32 at the chain's tolerance 1e-6
    (within 1e-3 of the solution's scale), and in float64 at 1e-12 against
    the dense solve (1e-8); the counters see the solves, none
    unconverged."""
    from jwas_tpu.ops import sparse_mme as jsm

    from jwas_tpu_torch.ops import sparse_mme as sm

    gis, vare = [0.9, 1.7], 0.8
    for dtype in (F32, F64):
        pb = _problem(dtype=dtype)
        K, n = pb["W"].shape[1], pb["W"].shape[0]
        b = np.random.default_rng(4).normal(size=K)
        tol = 1e-6 if dtype == F32 else 1e-12
        x = sm.cg_solve(pb["tsl"], pb["tcfgs"], torch.as_tensor(b, dtype=dtype),
                        [torch.tensor([[g]], dtype=dtype) for g in gis],
                        torch.tensor(vare, dtype=dtype), tol=tol, maxiter=500).numpy()
        exact = np.linalg.solve(_dense_A(pb, gis, vare), b)
        if dtype == F32:
            xj = np.asarray(jsm.cg_solve(
                pb["jsl"], pb["jcfgs"], jnp.asarray(b, jnp.float32),
                [jnp.asarray([[g]], jnp.float32) for g in gis], jnp.asarray(vare, jnp.float32),
                jnp.asarray(pb["rinv"], jnp.float32), n, tol=tol, maxiter=500))
            assert np.abs(x - xj).max() <= 1e-3 * np.abs(exact).max()
        else:
            np.testing.assert_allclose(x, exact, rtol=1e-8, atol=1e-8)
        st = pb["tsl"].stats.read()
        assert st["solves"] == 1 and st["not_converged"] == 0 and st["worst_residual"] <= tol


def _jax_normals(key, n_obs, cfgs, jdt):
    """sample_location_po's normals (jwas_tpu/ops/sparse_mme.py:160-169)."""
    keys = jax.random.split(key, 1 + len(cfgs))
    z0 = jax.random.normal(keys[0], (n_obs,), jdt)
    zs = [jax.random.normal(keys[1 + g], (len(c.starts), c.factor_rows if c.has_vinv
                                          else c.n_levels), jdt)
          for g, c in enumerate(cfgs)]
    return z0, zs


def test_po_draw_fed_jwas_normals_matches_jwas_tpu():
    """The PO draw from jwas_tpu's own normals (float32, as its chain
    draws) equals jwas_tpu's draw at the chain's CG tolerance 1e-6 within
    1e-3 of the draw's largest entry; in float64 at tolerance 1e-12 the same
    normals give the exact draw A^-1 (rhs + sqrt(vare) W' R^-1/2 z0 +
    vare (L (x) F') z) within 1e-7 (the CG's 1e-12 times A's condition
    number, ~1e4 here)."""
    from jwas_tpu.ops import sparse_mme as jsm

    from jwas_tpu_torch.ops import sparse_mme as sm

    gis, vare = [1.1, 2.0], 0.7
    for dtype in (F32, F64):
        pb = _problem(dtype=dtype)
        K, n, q = pb["W"].shape[1], pb["W"].shape[0], pb["q"]
        tol = 1e-6 if dtype == F32 else 1e-12
        rhs = np.random.default_rng(5).normal(size=K)
        x0 = np.random.default_rng(6).normal(size=K)
        jg = [jnp.asarray([[g]], jnp.float32) for g in gis]
        tg = [torch.tensor([[g]], dtype=dtype) for g in gis]
        A = _dense_A(pb, gis, vare)
        F = pb["jsl"].groups[0]
        hAi = sp.coo_matrix((np.asarray(F.f_vals, np.float64),
                             (np.asarray(F.f_rows), np.asarray(F.f_cols))), shape=(q, q))
        for seed in range(3):
            key = jax.random.PRNGKey(seed)
            z0, zs = _jax_normals(key, n, pb["jcfgs"], jnp.float32)
            got = sm.sample_location_po_from_normals(
                pb["tsl"], pb["tcfgs"], torch.as_tensor(rhs, dtype=dtype), tg,
                torch.tensor(vare, dtype=dtype), [torch.linalg.cholesky(g) for g in tg],
                torch.as_tensor(np.asarray(z0), dtype=dtype),
                [torch.as_tensor(np.asarray(z), dtype=dtype) for z in zs],
                x0=torch.as_tensor(x0, dtype=dtype), tol=tol, maxiter=500).numpy()
            if dtype == F32:
                ref = np.asarray(jsm.sample_location_po(
                    key, pb["jsl"], pb["jcfgs"], jnp.asarray(rhs, jnp.float32), jg,
                    jnp.asarray(vare, jnp.float32), jnp.asarray(pb["rinv"], jnp.float32), n,
                    [jnp.linalg.cholesky(g) for g in jg], x0=jnp.asarray(x0, jnp.float32),
                    tol=tol, maxiter=500))
                assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()
            else:
                z0n, zsn = np.asarray(z0, np.float64), [np.asarray(z, np.float64) for z in zs]
                e = np.sqrt(vare) * (pb["W"].T @ (np.sqrt(pb["rinv"]) * z0n))
                e[2:2 + q] += vare * np.sqrt(gis[0]) * (hAi.T @ zsn[0][0])
                e[2 + q:] += vare * np.sqrt(gis[1]) * zsn[1][0]
                np.testing.assert_allclose(got, np.linalg.solve(A, rhs + e), rtol=1e-7,
                                           atol=1e-7)


def test_po_draw_moments():
    """600 draws of sol ~ N(A^-1 rhs, vare A^-1) (the reference test's
    pattern, tests/test_sparse_mme.py:111-141): means within 5 standard
    errors plus 5e-3, variances within 25% (5 standard errors at 600)."""
    from jwas_tpu_torch.ops import sparse_mme as sm

    pb = _problem(n=40, dtype=F64)
    K = pb["W"].shape[1]
    gis, vare = [1.1, 2.0], 0.7
    A = _dense_A(pb, gis, vare)
    rhs = np.random.default_rng(5).normal(size=K)
    mu, cov = np.linalg.solve(A, rhs), vare * np.linalg.inv(A)
    tg = [torch.tensor([[g]], dtype=F64) for g in gis]
    chols = [torch.linalg.cholesky(g) for g in tg]
    gen = torch.Generator().manual_seed(0)
    xs = np.stack([sm.sample_location_po(gen, pb["tsl"], pb["tcfgs"], torch.as_tensor(rhs), tg,
                                         torch.tensor(vare, dtype=F64), chols, tol=1e-8,
                                         maxiter=400).numpy() for _ in range(600)])
    se = np.sqrt(np.diag(cov) / len(xs))
    assert np.all(np.abs(xs.mean(0) - mu) < 5 * se + 5e-3)
    np.testing.assert_allclose(xs.var(0), np.diag(cov), rtol=0.25, atol=5e-3)


def chain_data(seed=7):
    """tests/test_sparse_mme.py::test_runmcmc_sparse_matches_dense_location's
    data: a 120-animal pedigree, u ~ N(0, A), y = 3 + u + N(0, 0.49)."""
    jped, tped = _peds(120, seed)
    rng = np.random.default_rng(seed)
    A = jped.a_matrix()
    ids = list(jped.ids)
    u = np.linalg.cholesky(A + 1e-8 * np.eye(len(ids))) @ rng.normal(size=len(ids))
    y = 3.0 + u + rng.normal(size=len(ids)) * 0.7
    return jped, tped, ids, u, y


def run_chain(pkg, seed, chain_length=SWEEPS, burnin=BURNIN, **kw):
    """The animal model y = intercept + ID with sparse_location=True in one
    package; returns the posterior means (vare, varu, mu), the EBVs in
    pedigree order and the results."""
    jped, tped, ids, u, y = chain_data()
    if pkg == "port":
        import jwas_tpu_torch as jt

        model = jt.build_model("y = intercept + ID")
        jt.set_random(model, "ID", tped, np.array(1.0))
        out = jt.runMCMC(model, jt.Table({"ID": np.array(ids, dtype=object), "y": y}),
                         device="cpu", chain_length=chain_length, burnin=burnin, seed=seed,
                         output_folder="", sparse_location=True, printout_model_info=False,
                         **kw)
        ebv = dict(zip(out["EBV_y"]["ID"].tolist(), np.asarray(out["EBV_y"]["EBV"])))
        loc = out["location parameters"]
        mu = float(np.asarray(loc["Estimate"])[0])
    else:
        import pandas as pd

        from jwas_tpu import build_model, runMCMC, set_random

        model = build_model("y = intercept + ID")
        set_random(model, "ID", jped, np.array(1.0))
        out = runMCMC(model, pd.DataFrame({"ID": ids, "y": y}), chain_length=chain_length,
                      burnin=burnin, seed=seed, output_folder="", sparse_location=True,
                      printout_model_info=False, **kw)
        ebv = dict(zip(out["EBV_y"]["ID"], out["EBV_y"]["EBV"]))
        mu = float(out["location parameters"]["Estimate"].iloc[0])
    vare = float(np.asarray(out["residual variance"]["Estimate"])[0])
    varu = float(np.asarray(out["polygenic effects covariance matrix"]["Estimate"])[0])
    return dict(vare=vare, varu=varu, mu=mu), np.array([ebv[s] for s in ids]), u, out


def test_sparse_chain_matches_jwas_tpu_within_monte_carlo_error():
    """One sparse chain of each package at the reference test's length
    (2,999 sweeps run: 500 of burn-in and 833 saved samples of 3):
    the posterior means of the residual and polygenic variances and the
    intercept within 2.576 sqrt(sd_port^2 + sd_jwas^2) of each other
    (CALIBRATED_SD), the EBVs correlated above 0.95 (the reference test's
    bound for its sparse and dense chains) and the port's accuracy within
    0.1 of jwas_tpu's; the CG counted every draw, none unconverged."""
    from jwas_tpu_torch.engine.mcmc import chain_plan

    port, ebv_p, u, out = run_chain("port", 10)
    ref, ebv_j, _, _ = run_chain("jwas_tpu", 10)
    for k in port:
        bound = Z99 * np.hypot(CALIBRATED_SD["port"][k], CALIBRATED_SD["jwas_tpu"][k])
        assert abs(port[k] - ref[k]) <= bound, (k, port[k], ref[k], bound)
    assert np.corrcoef(ebv_p, ebv_j)[0, 1] > 0.95
    assert np.corrcoef(ebv_p, u)[0, 1] > np.corrcoef(ebv_j, u)[0, 1] - 0.1
    plan = chain_plan(SWEEPS, BURNIN, 0, 1)
    cg = out["_location_cg"]
    assert cg["solves"] == plan.burnin_outer + plan.n_saved * plan.thin_outer
    assert cg["not_converged"] == 0 and cg["worst_residual"] <= 1e-6


def test_sparse_location_invalid_combinations_raise():
    """sparse_location=True with several traits raises jwas_tpu's
    ValueError (tests/test_sparse_mme.py:229-239), before any set-up."""
    import jwas_tpu_torch as jt

    rng = np.random.default_rng(2)
    table = jt.Table({"ID": np.array([f"q{i}" for i in range(30)], dtype=object),
                      "y1": rng.normal(size=30), "y2": rng.normal(size=30)})
    model = jt.build_model("y1 = intercept\ny2 = intercept")
    with pytest.raises(ValueError, match="single-trait"):
        jt.runMCMC(model, table, device="cpu", chain_length=5, output_folder="",
                   sparse_location=True)
    model = jt.build_model("y1 = intercept\ny2 = intercept")
    with pytest.raises(ValueError, match="single-trait"):
        jt.runMCMC(model, table, device="cpu", chain_length=5, output_folder="",
                   sparse_location=True, causal_structure=np.array([[0.0, 0], [1, 0]]))


def test_above_20000_levels_goes_sparse_on_its_own(monkeypatch):
    """A single-trait model above SPARSE_LEVELS (lowered here to 100) takes
    the sparse path with sparse_location=None: its workspace keeps the CSR
    design and no dense one, and the chain runs the PO draw; at or below
    it, the dense path."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.setup as es

    monkeypatch.setattr(es, "SPARSE_LEVELS", 100)
    _, tped, ids, _, y = chain_data()
    table = jt.Table({"ID": np.array(ids, dtype=object), "y": y})
    model = jt.build_model("y = intercept + ID")
    jt.set_random(model, "ID", tped, np.array(1.0))
    ws = es.prepare_workspace(model, table, es.MCMCOptions(output_folder=""))
    assert ws.W_sparse is not None and ws.W.shape[1] == 0 and ws.n_loc == 121
    model = jt.build_model("y = intercept + ID")
    jt.set_random(model, "ID", tped, np.array(1.0))
    out = jt.runMCMC(model, table, device="cpu", chain_length=20, seed=1, output_folder="",
                     printout_model_info=False)
    assert out["_location_cg"]["solves"] == 20
    monkeypatch.setattr(es, "SPARSE_LEVELS", 121)
    model = jt.build_model("y = intercept + ID")
    jt.set_random(model, "ID", tped, np.array(1.0))
    assert es.prepare_workspace(model, table, es.MCMCOptions(output_folder="")).W_sparse is None


@pytest.mark.parametrize("option", ["weights", "double_precision", "binary", "markers"])
def test_sparse_path_runs_the_single_trait_options(option):
    """The options that reach jwas_tpu's sparse branch run on the port's:
    residual weights (W' R^-1 W and the PO draw's R^-1/2), float64 (CG
    tolerance 1e-8), a binary trait's liabilities, and BayesC on a dense
    store beside the pedigree; 30 sweeps, finite results, one PO-CG draw a
    sweep."""
    import jwas_tpu_torch as jt

    _, tped, ids, u, y = chain_data()
    rng = np.random.default_rng(4)
    cols = {"ID": np.array(ids, dtype=object), "y": y}
    kw, mkw, eq, geno = {}, {}, "y = intercept + ID", None
    if option == "weights":
        cols["weights"] = rng.uniform(0.5, 2.0, len(ids))
        kw["heterogeneous_residuals"] = True
    elif option == "double_precision":
        kw["double_precision"] = True
    elif option == "binary":
        cols["y"] = np.where(y > np.median(y), 2.0, 1.0)
        mkw["categorical_trait"] = ["y"]
    else:
        X = rng.integers(0, 3, (len(ids), 50)).astype(float)
        geno = jt.get_genotypes(jt.Table({"ID": cols["ID"], **{f"m{j}": X[:, j]
                                                              for j in range(50)}}),
                                device="cpu")
        eq = "y = intercept + ID + geno"
    model = jt.build_model(eq, genotypes=geno, **mkw)
    jt.set_random(model, "ID", tped, np.array(1.0))
    out = jt.runMCMC(model, jt.Table(cols), device="cpu", chain_length=30, seed=2,
                     output_folder="", sparse_location=True, printout_model_info=False, **kw)
    assert out["_location_cg"]["solves"] == 30
    assert np.isfinite(np.asarray(out["location parameters"]["Estimate"], dtype=float)).all()
    assert np.isfinite(np.asarray(out["EBV_y"]["EBV"], dtype=float)).all()


def test_unconverged_cg_warns_fault_r3():
    """Fault R3 repaired: with cg_maxiter = 2 every draw stops unconverged;
    the chain counts them on the device, reads the counters with its
    samples and warns once at the end of the run (jwas_tpu discards the
    residual, ops/sparse_mme.py:144). At the default cap none is counted."""
    with pytest.warns(UserWarning, match="stopped at cg_maxiter=2"):
        _, _, _, out = run_chain("port", 3, chain_length=40, burnin=0, cg_maxiter=2)
    cg = out["_location_cg"]
    assert cg["solves"] == 40 and cg["not_converged"] == 40 and cg["iterations"] == 80
    assert cg["worst_residual"] > 1e-6
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, _, _, out = run_chain("port", 3, chain_length=40, burnin=0)
    assert out["_location_cg"]["not_converged"] == 0


def _calibrate(pkg, first, last, path):
    res = [run_chain(pkg, s)[0] for s in range(int(first), int(last) + 1)]
    with open(path, "w") as f:
        json.dump({"pkg": pkg, "means": res}, f)


def _summarize(paths):
    by = {}
    for p in paths:
        d = json.load(open(p))
        by.setdefault(d["pkg"], []).extend(d["means"])
    for pkg, means in by.items():
        print(pkg, len(means), {k: float(np.std([m[k] for m in means], ddof=1))
                                for k in means[0]},
              {k: float(np.mean([m[k] for m in means])) for k in means[0]})


if __name__ == "__main__":
    if sys.argv[1] == "calibrate":
        _calibrate(*sys.argv[2:6])
    else:
        _summarize(sys.argv[2:])
