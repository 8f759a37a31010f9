"""Structural equations (SEM, runMCMC's causal_structure) in the port
against jwas_tpu's.

One outer iteration of a 3-trait model with the fully recursive structure
y1 -> y2, y1 -> y3, y2 -> y3 and no genotypes, in float64 from the same
state: jwas_tpu's step (mcmc_mt.py:489-516) against the port's
make_mt_step fed jwas_tpu's draws (the location pass's normals, the
residual covariance's Bartlett factor, the structural coefficients'
normals): lambda, Lambda y in ycorr, sol and R to rtol 1e-9. The checks of
the causal structure raise jwas_tpu's ValueErrors. On tests/test_sem.py's
data (y2 = 0.8 y1 + genetic + residual) the port's chain (blocked BayesC,
fast_blocks 16) recovers lambda within 0.15, with overall = direct +
indirect marker effects and no indirect effect on y1. The SEM chain of
tests/test_torch_mt_runmcmc.py's CHAINS within calibrated Monte-Carlo
bounds of jwas_tpu.runMCMC, its result tables (structural coefficients,
indirect and overall marker effects) and sample files with jwas_tpu's
names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jwas_tpu as jw
import jwas_tpu_torch as jt

from test_sem import _sem_sim
from test_torch_mt_runmcmc import check_chain

CAUSAL3 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0]])


@pytest.fixture(autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


def _three_traits(n=150, seed=12):
    rng = np.random.default_rng(seed)
    herd = rng.integers(0, 5, n)
    y1 = rng.normal(size=n) + 0.3 * herd
    y2 = 0.6 * y1 + rng.normal(size=n)
    y3 = 0.4 * y1 - 0.5 * y2 + rng.normal(size=n)
    return {"ID": np.array([f"a{i}" for i in range(n)], dtype=object),
            "y1": y1, "y2": y2, "y3": y3, "herd": [f"h{k}" for k in herd]}


def test_sem_step_matches_jwas_tpu_on_its_draws(monkeypatch):
    import jwas_tpu.engine.mcmc_mt as jmm
    from jwas_tpu.engine.setup import MCMCOptions as JOpts
    from jwas_tpu.engine.setup import prepare_workspace as j_prepare
    from jwas_tpu.ops import dists as jd
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.engine.setup import MCMCOptions as TOpts
    from jwas_tpu_torch.engine.setup import prepare_workspace as t_prepare

    jax.config.update("jax_enable_x64", True)
    cols = _three_traits()
    eq = "\n".join(f"y{k} = intercept + herd" for k in (1, 2, 3))
    import pandas as pd
    built = {}
    for pkg, Opts, prepare, df in ((jw, JOpts, j_prepare, pd.DataFrame(cols)),
                                   (jt, TOpts, t_prepare, jt.Table(cols))):
        kw = dict(device="cpu") if pkg is jt else {}
        opts = Opts(chain_length=10, seed=2, output_folder="", double_precision=True,
                    causal_structure=CAUSAL3)
        built[pkg] = (prepare(pkg.build_model(eq), df, opts, **kw), opts)
    jcfg, jdata, jstate = jmm.build_mt_data_and_state(*built[jw], jnp.float64)
    cfg, data, state = tm.build_mt_data_and_state(*built[jt], "cpu")
    assert cfg.sem_edges == jcfg.sem_edges == ((1, 0), (2, 0), (2, 1))
    rng = np.random.default_rng(3)
    lam = np.array([0.5, 0.2, -0.3])
    common = dict(sol=0.1 * rng.normal(size=state.sol.shape[0]),
                  ycorr=rng.normal(size=state.ycorr.shape), Lambda=lam)
    jst = jstate._replace(**{k: jnp.asarray(v) for k, v in common.items()})
    st = state._replace(**{k: torch.from_numpy(v.copy()) for k, v in common.items()})
    want = jmm.make_mt_step(jcfg)(jst, jdata)

    keys = jax.random.split(jst.key, 11)
    k_loc, k_res, k_sem = keys[1], keys[6], keys[10]
    f64 = jnp.float64

    def T(x):
        return torch.from_numpy(np.array(x))

    K = st.sol.shape[0]
    pass_ = tm.gibbs_pass_general
    monkeypatch.setattr(tm, "gibbs_pass_general", lambda A, x, b, gen: pass_(
        A, x, b, gen, zs=T(jax.random.normal(k_loc, (K,), f64))))
    res = tm.sample_residual_covariance
    monkeypatch.setattr(tm, "sample_residual_covariance",
                        lambda gen, yc, rinv, n, df, scale, rc: res(
                            gen, yc, rinv, n, df, scale, rc,
                            T(jd._standard_wishart_chol(k_res, df + n, 3, f64))))
    sem = tm.sem_lambda
    monkeypatch.setattr(tm, "sem_lambda", lambda y, yc, R, lam, edges, z: sem(
        y, yc, R, lam, edges, T(jax.random.normal(k_sem, (len(edges),), f64))))
    got = tm.make_mt_step(cfg)(st, data)
    for k in ("sol", "ycorr", "R", "Lambda"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    assert not np.allclose(got.Lambda.numpy(), lam)


@pytest.mark.parametrize("causal,missing,match", [
    (np.array([[0.0, 1.0], [1.0, 0.0]]), False, "lower triangular"),
    (np.array([[0.0, 0.0], [2.0, 0.0]]), False, "entries must be 0 or 1"),
    (np.zeros((3, 3)), False, "must be 2x2"),
    (np.array([[0.0, 0.0], [1.0, 0.0]]), True, "missing phenotypes are not allowed")])
def test_sem_errors_match_jwas_tpu(causal, missing, match):
    sim, df, _ = _sem_sim(seed=23, n=100, p=40)
    if missing:
        df = df.copy()
        df.loc[0, "y2"] = np.nan
    msgs = []
    for pkg in (jw, jt):
        kw = dict(device="cpu") if pkg is jt else {}
        geno = pkg.get_genotypes(sim["genotypes"], method="BayesC", name="geno", **kw)
        model = pkg.build_model("y1 = intercept + geno\ny2 = intercept + geno",
                                genotypes=geno)
        with pytest.raises(ValueError, match=match) as e:
            pkg.runMCMC(model, df, chain_length=5, output_folder="", causal_structure=causal,
                        printout_model_info=False, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sem_recovers_structural_coefficient():
    """tests/test_sem.py's check on the port (blocked BayesC)."""
    sim, df, lam = _sem_sim()
    geno = jt.get_genotypes(sim["genotypes"], method="BayesC", name="geno", device="cpu")
    model = jt.build_model("y1 = intercept + geno\ny2 = intercept + geno", genotypes=geno)
    model.causal_structure = np.array([[0.0, 0.0], [1.0, 0.0]])
    out = jt.runMCMC(model, df, device="cpu", chain_length=800, burnin=200, seed=5,
                     fast_blocks=16, nreps=4, output_samples_frequency=8,
                     output_folder="", printout_model_info=False)
    sc = out["structural coefficients"]
    assert list(sc["Edge"]) == ["y1->y2"]
    est = float(sc["Estimate"][0])
    assert abs(est - lam) < 0.15, f"lambda estimate {est:.3f} vs truth {lam}"
    direct, indirect, overall = (np.asarray(out[k]["Estimate"], dtype=float) for k in (
        "marker effects geno", "indirect marker effects geno", "overall marker effects geno"))
    np.testing.assert_allclose(overall, direct + indirect, atol=1e-6)
    p = len(direct) // 2
    assert np.all(indirect[:p] == 0.0) and np.any(indirect[p:] != 0.0)


def test_sem_chain_matches_jwas_tpu_within_monte_carlo_error(tmp_path):
    check_chain("SEM", tmp_path, files=True)
