"""runMCMC's multi-trait branch in the port against jwas_tpu's.

Parity (c) of ROADMAP.md: both packages run the same model on
simulate_genomic_data_mt(n=400, p=250, ..., seed=21) (the data of
tests/test_mt_end2end.py) on the CPU: sampler I and sampler II (exact
sweeps), the mega-trait constraint, missing phenotypes, BayesB and
fast_blocks=16. Each chain reaches the reference test's accuracy
thresholds (a1 > 0.5, a2 > 0.4; 0.3 for the trait with missing records),
and the posterior means of R and G of the port (read from the sample
files) lie within 99% Monte-Carlo bounds of jwas_tpu's: |difference| <=
3.144 sqrt(sd_port^2 + sd_jwas^2), sd the spread of each package's chain
across seeds (CALIBRATED_SD; for mega_trait the reference's spread stands
for both), 3.144 the two-sided 99% point Bonferroni-corrected over the six
distinct entries. The mega-trait marker step (set-up, each trait's sweep,
pi and the diagonal G draw) is held to jwas_tpu's on its draws. The
blocked chains run p = 256 (see CHAINS). The result tables' keys and
columns and the sample files' names and headers equal jwas_tpu's. A model with residual
weights, an i.i.d. and a pedigree random effect with t x t covariances and
double_precision runs through both, and one outer iteration of it equals
jwas_tpu's on jwas_tpu's draws. Slice 7b's methods and options run; K9's
limits (9 traits, blocks above 2,048) are refused at set-up, as are
several traits on the 2-bit store.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest

import jwas_tpu as jw
import jwas_tpu_torch as jt
from jwas_tpu.io.datasets import simulate_genomic_data_mt

TOL_STATE = dict(rtol=1e-5, atol=1e-6)
TOL_YCORR = dict(rtol=1e-4, atol=1e-5)

# |difference| / sqrt(sd_port^2 + sd_jwas^2) of a chain's six distinct R
# and G entries: 99% for the test as a whole (Bonferroni over the six)
Z99 = 3.144


@pytest.fixture(autouse=True)
def _jax_float32():
    """runMCMC(double_precision=True) leaves JAX's x64 mode on; the chains
    here are float32 unless a test asks."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", False)


def _sim(missing_frac=0.0, p=250):
    return simulate_genomic_data_mt(n=400, p=p, n_qtl=25, h2=(0.5, 0.4), rg=0.7,
                                    re=0.2, seed=21, missing_frac=missing_frac)


def _run(pkg, sim, folder, method="BayesC", sampler="I", constraint=False,
         chain_length=300, **kw):
    kw = dict(dict(fast_blocks=False, seed=11), **kw)
    if pkg is jt:
        kw["device"] = "cpu"
        geno = jt.get_genotypes(sim["genotypes"], method=method, name="geno",
                                constraint=constraint, multi_trait_sampler=sampler,
                                device="cpu")
    else:
        geno = jw.get_genotypes(sim["genotypes"], method=method, name="geno",
                                constraint=constraint, multi_trait_sampler=sampler)
    model = pkg.build_model("y1 = intercept + geno\ny2 = intercept + geno", genotypes=geno)
    return pkg.runMCMC(model, sim["phenotypes"], chain_length=chain_length,
                       burnin=chain_length // 5,
                       output_samples_frequency=max(1, chain_length // 100),
                       output_folder=folder, printout_model_info=False, **kw)


def _acc(out, sim, k):
    ebv = dict(zip(out[f"EBV_y{k + 1}"]["ID"], out[f"EBV_y{k + 1}"]["EBV"]))
    ids = [f"ind{i + 1}" for i in range(sim["true_bv"].shape[0])]
    return np.corrcoef([ebv[s] for s in ids], sim["true_bv"][:, k])[0, 1]


def _track(folder, var, t):
    """A sample file's rows, (n_saved, t, t): the residual covariance, or
    the marker covariance (t rows a sample; BayesB's t rows of p (t, t)
    blocks side by side, averaged over the loci)."""
    with open(os.path.join(folder, f"MCMC_samples_{var}.txt")) as f:
        lines = [line for line in f.read().splitlines() if line]
    if var == "residual_variance":
        return np.array([[float(v) for v in line.split(",")] for line in lines[1:]]
                        ).reshape(-1, t, t)
    rows = np.array([[float(v) for v in line.split(",")] for line in lines])
    rows = rows.reshape(-1, t, rows.shape[1])
    return rows.reshape(rows.shape[0], t, -1, t).mean(axis=2)


# name: (run keywords, chain length, accuracy thresholds, markers). The
# blocked chains run p = 256, a whole number of blocks of 16: jwas_tpu's
# blocked multi-trait BayesC counts its padding markers' beta, draws of the
# prior alone, in the marker covariance's sum of squares (mcmc_mt.py:428-
# 429, fault R11 in ROADMAP.md), which at p = 250 (6 padding markers)
# raises its posterior mean of G by about half; the port leaves them out.
CHAINS = {
    "sampler_I": (dict(), 300, (0.5, 0.4), 250),
    "sampler_II": (dict(sampler="II"), 200, (0.5, 0.4), 250),
    "mega_trait": (dict(constraint=True), 300, (0.5, 0.4), 250),
    "missing": (dict(fast_blocks=16, nreps=4), 600, (0.5, 0.3), 256),
    "BayesB": (dict(method="BayesB", fast_blocks=16, nreps=4), 600, (0.5, 0.4), 256),
    "fast_blocks_16": (dict(fast_blocks=16, nreps=4), 1200, (0.5, 0.4), 256),
    # slice 7b, run by tests/test_torch_mt_c0l.py, test_torch_mt_gblup.py
    # and test_torch_sem.py: RR-BLUP and BayesL through K9's plain version,
    # GBLUP's joint draw, SEM's y1 -> y2 beside sampler I
    "RR-BLUP": (dict(method="RR-BLUP", fast_blocks=16, nreps=4), 600, (0.5, 0.4), 256),
    "BayesL": (dict(method="BayesL", fast_blocks=16, nreps=4), 600, (0.5, 0.4), 256),
    "GBLUP": (dict(method="GBLUP"), 300, (0.5, 0.4), 250),
    "SEM": (dict(causal_structure=[[0.0, 0.0], [1.0, 0.0]], fast_blocks=16, nreps=4), 600,
            (0.5, 0.4), 256),
}
TRACKS = ("residual_variance", "marker_effects_variances_geno")


def chain_means(pkg, name, folder, seed=11, p=None, outs=None):
    """One chain of CHAINS[name] by pkg (p markers: CHAINS' unless given):
    its EBV accuracy a trait and the means of its saved R and G samples;
    outs, when given, receives its results under pkg's name."""
    kw, chain_length, _, p_default = CHAINS[name]
    p = p or p_default
    sim = _sim(0.3 if name == "missing" else 0.0, p)
    out = _run(pkg, sim, folder, chain_length=chain_length, **dict(kw, seed=seed))
    if outs is not None:
        outs[pkg.__name__] = out
    return ([_acc(out, sim, k) for k in range(2)],
            {v: _track(folder, v, 2).mean(axis=0) for v in TRACKS})


def check_chain(name, tmp_path, files=False):
    """CHAINS[name] by both packages: each above the accuracy floors, R and
    G within the bounds; files: the port's result tables have jwas_tpu's
    keys and columns, its sample files jwas_tpu's names and headers."""
    floors = CHAINS[name][2]
    res, outs = {}, {}
    for pkg in (jt, jw):
        acc, res[pkg.__name__] = chain_means(pkg, name, str(tmp_path / pkg.__name__),
                                             outs=outs)
        assert acc[0] > floors[0] and acc[1] > floors[1], (pkg.__name__, acc)
    if files:
        port, ref = outs["jwas_tpu_torch"], outs["jwas_tpu"]
        keys = sorted(k for k in ref if not k.startswith("_"))
        assert sorted(k for k in port if not k.startswith("_")) == keys
        for k in keys:
            assert list(port[k].columns) == list(ref[k].columns), k
            assert len(port[k]) == len(ref[k]), k
        assert _headers(str(tmp_path / "jwas_tpu_torch")) == _headers(
            str(tmp_path / "jwas_tpu"))
    for var in TRACKS:
        mp, mj = res["jwas_tpu_torch"][var], res["jwas_tpu"][var]
        sd = CALIBRATED_SD[name]
        sj = np.asarray(sd["jwas_tpu"][var])
        sp = np.asarray(sd["jwas_tpu_torch"][var]) if "jwas_tpu_torch" in sd else sj
        bound = Z99 * np.sqrt(sp ** 2 + sj ** 2) + 1e-12
        assert (np.abs(mp - mj) <= bound).all(), (var, mp, mj, bound)


# the exact sweeps here, the blocked ones in tests/test_torch_mt_blocked.py
@pytest.mark.parametrize("name", ["sampler_I", "sampler_II", "mega_trait"])
def test_chain_matches_jwas_tpu_within_monte_carlo_error(name, tmp_path):
    check_chain(name, tmp_path)


@pytest.mark.parametrize("method", ["BayesC", "BayesB"])
def test_mega_trait_set_up_and_marker_step_match_jwas_tpu(method, monkeypatch):
    """The mega-trait chain's pieces against jwas_tpu's, exact sweeps in
    float32. At set-up: G_constraint's df and scale (mcmc_mt.py:740-744),
    the starting pi, marker covariance(s) and indicators. Then one marker
    step from the same state: jwas_tpu's own step (mcmc_mt.py:97) with its
    location pass held still, against the port's sample_markers fed
    jwas_tpu's draws: each trait's sweep the panels sweep_exact_abc draws
    from its key of split(k_mark, t) (so each trait's pi_k and var_eff
    count), pi jwas_tpu's sample_pi_abc on the port's indicators, the
    diagonal covariance's chi-square draws from jwas_tpu's k_var on the
    port's degrees of freedom. alpha, beta and ycorr within parity (b)'s
    tolerances, delta equal, pi and G to rtol 1e-5."""
    import jax.numpy as jnp

    import jwas_tpu.engine.mcmc_mt as jmm
    import torch
    from jwas_tpu.engine.setup import MCMCOptions as JOpts
    from jwas_tpu.engine.setup import prepare_workspace as j_prepare
    from jwas_tpu.ops import dists as jd
    from jwas_tpu.ops import variance as jv
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.engine.setup import MCMCOptions as TOpts
    from jwas_tpu_torch.engine.setup import prepare_workspace as t_prepare
    from jwas_tpu_torch.ops import dense as td
    from jwas_tpu_torch.ops import variance as tv

    sim = simulate_genomic_data_mt(n=80, p=40, n_qtl=6, h2=(0.5, 0.4), rg=0.7, re=0.2,
                                   seed=4)
    p, t = 40, 2
    ws = {}
    for pkg, Opts, prepare in ((jw, JOpts, j_prepare), (jt, TOpts, t_prepare)):
        kw = dict(device="cpu") if pkg is jt else {}
        geno = pkg.get_genotypes(sim["genotypes"], method=method, name="geno",
                                 constraint=True, **kw)
        model = pkg.build_model("y1 = intercept + geno\ny2 = intercept + geno",
                                genotypes=geno)
        opts = Opts(chain_length=10, seed=1, output_folder="", fast_blocks=False)
        ws[pkg] = (prepare(model, sim["phenotypes"], opts, **kw), opts)
    jcfg, jdata, jstate = jmm.build_mt_data_and_state(*ws[jw], jnp.float32)
    cfg, data, state = tm.build_mt_data_and_state(*ws[jt], "cpu")

    # set-up
    assert cfg.constraint and jcfg.constraint and cfg.n_markers == jcfg.n_markers == p
    assert cfg.df_marker == jcfg.df_marker and cfg.estimate_pi == jcfg.estimate_pi
    np.testing.assert_allclose(data.marker_scale.numpy(), np.asarray(jdata.marker_scale),
                               rtol=1e-6)
    np.testing.assert_array_equal(state.pi.numpy(), np.asarray(jstate.pi))
    np.testing.assert_allclose(state.varg.numpy()[..., :p, :, :] if method == "BayesB"
                               else state.varg.numpy(),
                               np.asarray(jstate.varg)[..., :p, :, :] if method == "BayesB"
                               else np.asarray(jstate.varg), rtol=1e-6)
    np.testing.assert_array_equal(state.delta.numpy()[:, :p], np.asarray(jstate.delta)[:, :p])

    # one marker step from the same state
    rng = np.random.default_rng(5)
    pj, pt = jstate.alpha.shape[1], state.alpha.shape[1]
    n = state.ycorr.shape[1]
    beta = (0.1 * rng.normal(size=(t, p))).astype(np.float32)
    delta = (rng.uniform(size=(t, p)) < 0.5).astype(np.float32)
    ycorr = rng.normal(size=(t, n)).astype(np.float32)
    R = np.array([[1.2, 0.3], [0.3, 0.9]], np.float32)
    pi = np.array([0.3, 0.7], np.float32)
    var_eff = rng.uniform(0.01, 0.05, size=(p, t)).astype(np.float32)

    def pad(x, width):
        out = np.zeros((t, width), np.float32)
        out[:, :p] = x
        return out

    def varg_for(width):
        if method == "BayesB":
            v = np.tile(np.eye(t, dtype=np.float32), (width, 1, 1))
            v[:p] = var_eff[:, :, None] * np.eye(t, dtype=np.float32)
            return v
        return np.diag(var_eff[0])

    jst = jstate._replace(sol=jnp.zeros_like(jstate.sol),
                          alpha=jnp.asarray(pad(beta * delta, pj)), beta=jnp.asarray(pad(beta, pj)),
                          delta=jnp.asarray(pad(delta, pj)), ycorr=jnp.asarray(ycorr),
                          R=jnp.asarray(R), pi=jnp.asarray(pi), varg=jnp.asarray(varg_for(pj)))
    monkeypatch.setattr(jmm, "gibbs_pass_general", lambda LHS, sol, rhs, key: sol)
    want = jmm.make_mt_step(jcfg)(jst, jdata)

    keys = jax.random.split(jst.key, 11 + len(jcfg.re_groups))
    k_mark, k_pi, k_var = keys[2], keys[3], keys[4]
    b = data.gm.grams.shape[1]
    panels = []
    for kt in jax.random.split(k_mark, t):
        ku, kz = jax.random.split(kt)
        panels.append((torch.from_numpy(np.array(jax.random.uniform(ku, (pj,))))[:p],
                       torch.from_numpy(np.array(jax.random.normal(kz, (pj,))))[:p]))
    sweep = tm.sweep_blocks_abc_grouped
    monkeypatch.setattr(tm, "sweep_blocks_abc_grouped", lambda *a, **kw: sweep(
        *a, draws=td.sweep_draws(b, *panels.pop(0)), **kw))
    kp = list(jax.random.split(k_pi, t))
    monkeypatch.setattr(tm, "sample_pi_abc", lambda gen, d, n_markers, valid: torch.tensor(
        float(jv.sample_pi_abc(kp.pop(0), jnp.asarray(d.numpy()[:p]).astype(jnp.int32),
                               n_markers))))

    def chi2(gen, df):
        v = df.reshape(-1)[0].item()
        assert torch.all(df == v)
        shape = (t, pj) if method == "BayesB" else (t,)
        out = torch.ones_like(df)
        out[..., :p] = torch.from_numpy(np.array(jd.sample_chi2(k_var, jnp.full(shape, v))))[
            ..., :p]
        return out

    monkeypatch.setattr(tv, "sample_chi2", chi2)
    st = state._replace(alpha=torch.from_numpy(pad(beta * delta, pt)),
                        beta=torch.from_numpy(pad(beta, pt)),
                        delta=torch.from_numpy(pad(delta, pt)), ycorr=torch.from_numpy(ycorr),
                        R=torch.from_numpy(R), pi=torch.from_numpy(pi),
                        varg=torch.from_numpy(varg_for(pt)))
    got = tm.sample_markers(cfg, st, data)
    assert not panels and not kp
    np.testing.assert_array_equal(got.delta.numpy()[:, :p], np.asarray(want.delta)[:, :p])
    for k in ("alpha", "beta"):
        np.testing.assert_allclose(getattr(got, k).numpy()[:, :p],
                                   np.asarray(getattr(want, k))[:, :p], **TOL_STATE)
    np.testing.assert_allclose(got.ycorr.numpy(), np.asarray(want.ycorr), **TOL_YCORR)
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi), rtol=1e-5)
    gv, wv = got.varg.numpy(), np.asarray(want.varg)
    if method == "BayesB":
        gv, wv = gv[:p], wv[:p]
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-9)


def test_beta_and_chi_square_draws_follow_their_laws():
    """The port's Beta draws at the mega-trait pi's shapes (Beta(p - k + 1,
    k + 1), p = 250) and its chi-square draws at the diagonal G's and small
    degrees of freedom: 20,000 draws each pass a Kolmogorov-Smirnov test
    against scipy's law (p > 0.001), their generator seeded."""
    import torch
    from scipy import stats

    from jwas_tpu_torch.ops.dists import sample_beta, sample_chi2

    gen = torch.Generator().manual_seed(0)
    n = 20_000
    for a, b in ((1.0, 251.0), (201.0, 51.0), (30.0, 222.0)):
        x = sample_beta(gen, torch.full((n,), a), torch.full((n,), b)).numpy()
        assert stats.kstest(x, stats.beta(a, b).cdf).pvalue > 1e-3, (a, b)
    for df in (252.0, 3.0, 1.5):
        x = sample_chi2(gen, torch.full((n,), df)).numpy()
        assert stats.kstest(x, stats.chi2(df).cdf).pvalue > 1e-3, df


def _headers(folder):
    """Each sample file's header row (its first three fields), None where the
    file has none (its first row is a sample)."""
    out = {}
    for f in sorted(os.listdir(folder)):
        if f.startswith("MCMC_samples_"):
            with open(os.path.join(folder, f)) as fh:
                first = fh.readline().strip().split(",")[:3]
            try:
                float(first[0])
                out[f] = None
            except ValueError:
                out[f] = first
    return out


def _re_data():
    """simulate_genomic_data_mt's data with residual weights, a herd and a
    three-generation pedigree over its individuals."""
    sim = simulate_genomic_data_mt(n=200, p=120, n_qtl=15, seed=5, missing_frac=0.2)
    ph = sim["phenotypes"].copy()
    rng = np.random.default_rng(6)
    ph["weights"] = rng.uniform(0.5, 2.0, len(ph))
    ph["herd"] = [f"h{k}" for k in rng.integers(0, 6, len(ph))]
    ids = list(ph["ID"])
    sire = ["0"] * 40 + [ids[k] for k in rng.integers(0, 40, 160)]
    dam = ["0"] * 40 + [ids[k] for k in rng.integers(0, 40, 160)]
    return sim, ph, pd.DataFrame({"ID": ids, "sire": sire, "dam": dam})


def _re_model(pkg, method, sampler, ped_path):
    """y1 y2 = intercept + herd + ID + geno on _re_data's genotypes in
    float64, herd i.i.d. and ID on the pedigree at ped_path, each with a
    2 x 2 G."""
    kw = dict(device="cpu") if pkg is jt else {}
    geno = pkg.get_genotypes(_re_data()[0]["genotypes"], method=method, name="geno",
                             multi_trait_sampler=sampler, double_precision=True, **kw)
    model = pkg.build_model("y1 = intercept + herd + ID + geno\n"
                            "y2 = intercept + herd + ID + geno", genotypes=geno)
    pkg.set_random(model, "herd", np.array([[0.2, 0.05], [0.05, 0.2]]))
    pkg.set_random(model, "ID", pkg.get_pedigree(ped_path),
                   np.array([[0.5, 0.1], [0.1, 0.5]]))
    return model


RE_CHAINS = {"re_BayesB_I": ("BayesB", "I"), "re_BayesC_II": ("BayesC", "II")}
RE_OPTS = dict(fast_blocks=8, heterogeneous_residuals=True, double_precision=True)
# the posterior means compared: R, herd's G and ID's G
RE_TRACKS = ("residual variance", "random effect variances y1:herd",
             "polygenic effects covariance matrix")
# two-sided 99% point Bonferroni-corrected over their nine distinct entries
Z99_RE = 3.261


def run_re(pkg, name, folder, seed=3):
    """RE_CHAINS[name] by pkg: _re_model with residual weights and the
    missing records, 300 sweeps, output in folder/out; runMCMC's result."""
    method, sampler = RE_CHAINS[name]
    _, ph, ped_df = _re_data()
    os.makedirs(folder, exist_ok=True)
    ped_path = os.path.join(folder, "ped.csv")
    ped_df.to_csv(ped_path, index=False)
    model = _re_model(pkg, method, sampler, ped_path)
    pkg.outputMCMCsamples(model, "herd")
    kw = dict(device="cpu") if pkg is jt else {}
    return pkg.runMCMC(model, ph, chain_length=300, burnin=60, output_samples_frequency=3,
                       seed=seed, output_folder=os.path.join(folder, "out"),
                       printout_model_info=False, **RE_OPTS, **kw)


def re_means(out):
    """The (2, 2) posterior means of RE_TRACKS in runMCMC's result."""
    return {k: np.asarray(out[k]["Estimate"], dtype=float).reshape(2, 2) for k in RE_TRACKS}


@pytest.mark.parametrize("method,sampler", [("BayesB", "I"), ("BayesC", "II")])
def test_weights_random_effects_and_float64_run_with_jwas_tpu_tables(method, sampler,
                                                                     tmp_path):
    """RE_CHAINS' chain of method and sampler (run_re) by both packages: the
    port's result tables have jwas_tpu's keys and columns, its sample files
    jwas_tpu's names and headers, its posterior means are finite with
    positive definite covariances, and its R, herd G and ID G lie within
    99% Monte-Carlo bounds of jwas_tpu's: |difference| <= 3.261 sqrt(sd_port^2 +
    sd_jwas^2), sd the spread across seeds (CALIBRATED_SD)."""
    name = f"re_{method}_{sampler}"
    outs = {}
    for pkg in (jt, jw):
        folder = str(tmp_path / pkg.__name__)
        outs[pkg.__name__] = run_re(pkg, name, folder)
        outs[pkg.__name__ + "/files"] = _headers(os.path.join(folder, "out"))
    port, ref = outs["jwas_tpu_torch"], outs["jwas_tpu"]
    keys = sorted(k for k in ref if not k.startswith("_"))
    assert sorted(k for k in port if not k.startswith("_")) == keys
    for k in keys:
        assert list(port[k].columns) == list(ref[k].columns), k
        assert len(port[k]) == len(ref[k]), k
        if "Estimate" in port[k].columns:
            assert np.isfinite(np.asarray(port[k]["Estimate"], dtype=float)).all(), k
    assert outs["jwas_tpu_torch/files"] == outs["jwas_tpu/files"]
    mp, mj = re_means(port), re_means(ref)
    for k in RE_TRACKS:
        assert np.all(np.linalg.eigvalsh(mp[k]) > 0), k
        sp, sj = (np.asarray(CALIBRATED_SD[name][pkg][k]) for pkg in ("jwas_tpu_torch",
                                                                        "jwas_tpu"))
        bound = Z99_RE * np.sqrt(sp ** 2 + sj ** 2)
        assert (np.abs(mp[k] - mj[k]) <= bound).all(), (k, mp[k], mj[k], bound)


@pytest.mark.parametrize("method,sampler", [("BayesB", "I"), ("BayesC", "II")])
def test_weights_random_effects_step_matches_jwas_tpu_on_its_draws(method, sampler,
                                                                   tmp_path, monkeypatch):
    """_re_model's model, one outer iteration in float64 from the
    same state: jwas_tpu's step (mcmc_mt.py:97) against the port's
    make_mt_step fed jwas_tpu's draws from the step's keys: the imputation's
    normals, the location pass's, the blocked sweep's panels
    (fold_in(fold_in(k_mark, g), r)), pi's Dirichlet on the port's pattern
    counts, and the Bartlett factors of the marker covariance (one a locus
    for BayesB), of each random-effect group's covariance (herd i.i.d., ID
    with its A^-1) and of the weighted residual covariance. Every piece of
    the state agrees to rtol 1e-9 (delta equal): the vc draw's sol slices,
    degrees of freedom and trait order, the Vinv product and the weights
    in R are jwas_tpu's."""
    import jax.numpy as jnp

    import jwas_tpu.engine.mcmc_mt as jmm
    import torch
    from jwas_tpu.engine.setup import MCMCOptions as JOpts
    from jwas_tpu.engine.setup import prepare_workspace as j_prepare
    from jwas_tpu.ops import dists as jd
    from jwas_tpu.ops import multitrait as jmt
    from jwas_tpu_torch.engine import mcmc_mt as tm
    from jwas_tpu_torch.engine.setup import MCMCOptions as TOpts
    from jwas_tpu_torch.engine.setup import prepare_workspace as t_prepare
    from jwas_tpu_torch.ops import multitrait as tmt

    jax.config.update("jax_enable_x64", True)
    _, ph, ped_df = _re_data()
    ped_path = str(tmp_path / "ped.csv")
    ped_df.to_csv(ped_path, index=False)
    ws = {}
    for pkg, Opts, prepare in ((jw, JOpts, j_prepare), (jt, TOpts, t_prepare)):
        kw = dict(device="cpu") if pkg is jt else {}
        opts = Opts(chain_length=10, seed=3, output_folder="", **RE_OPTS)
        ws[pkg] = (prepare(_re_model(pkg, method, sampler, ped_path), ph, opts, **kw), opts)
    jcfg, jdata, jstate = jmm.build_mt_data_and_state(*ws[jw], jnp.float64)
    cfg, data, state = tm.build_mt_data_and_state(*ws[jt], "cpu")
    assert cfg.pattern_masks == jcfg.pattern_masks and len(cfg.re_groups) == 2
    assert cfg.missing_phenotypes and jcfg.missing_phenotypes
    assert data.gm.ngroups * jcfg.group_blocks == data.gm.grams.shape[0]
    t, p = 2, cfg.n_markers
    assert jstate.alpha.shape == state.alpha.shape == (t, p)

    # a common state: the sol, marker state, ycorr and pattern priors drawn here
    rng = np.random.default_rng(8)
    sol = 0.1 * rng.normal(size=state.sol.shape[0])
    beta = 0.05 * rng.normal(size=(t, p))
    delta = (rng.uniform(size=(t, p)) < 0.6).astype(np.float64)
    ycorr = np.where(np.asarray(ws[jt][0].y_mask).reshape(t, -1),
                     rng.normal(size=state.ycorr.shape), 0.0)
    common = dict(sol=sol, alpha=beta * delta, beta=beta, delta=delta, ycorr=ycorr,
                  pi=np.array([0.4, 0.2, 0.15, 0.25]))
    jst = jstate._replace(**{k: jnp.asarray(v) for k, v in common.items()})
    st = state._replace(**{k: torch.from_numpy(v.copy()) for k, v in common.items()})
    want = jmm.make_mt_step(jcfg)(jst, jdata)

    keys = jax.random.split(jst.key, 11 + len(jcfg.re_groups))
    k_loc, k_mark, k_pi, k_var, k_res, k_imp = (keys[i] for i in (1, 2, 3, 4, 6, 7))
    k_vc = list(keys[11:])
    f64 = jnp.float64

    def T(x):
        return torch.from_numpy(np.array(x))

    kk = jax.random.split(k_imp, len(data.pattern_rows))
    zs_imp = [T(jax.random.normal(kk[i], (sum(not m for m in mask), rows.numel()), f64))
              for i, (rows, mask) in enumerate(zip(data.pattern_rows, cfg.pattern_masks))]
    impute = tm.impute_missing
    monkeypatch.setattr(tm, "impute_missing",
                        lambda *a: impute(*a, zs=zs_imp))
    K = st.sol.shape[0]
    pass_ = tm.gibbs_pass_general
    monkeypatch.setattr(tm, "gibbs_pass_general", lambda A, x, b, gen: pass_(
        A, x, b, gen, zs=T(jax.random.normal(k_loc, (K,), f64))))
    b = data.gm.grams.shape[1]
    gb = jcfg.group_blocks

    def draws(g, r, reps):
        ka, kz = jax.random.split(jax.random.fold_in(jax.random.fold_in(k_mark, g), r))
        a = (jax.random.uniform(ka, (reps * b, t, gb), f64) if sampler == "I"
             else jax.random.gumbel(ka, (reps * b, 2 ** t, gb), f64))
        return T(a), T(jax.random.normal(kz, (reps * b, t, gb), f64))

    sweep = tmt.sweep_blocks_mt_abc_grouped
    monkeypatch.setattr(tmt, "sweep_blocks_mt_abc_grouped",
                        lambda *a, **kw: sweep(*a, draws=draws, **kw))

    def pattern_pi(gen, d, valid):
        idx = np.asarray(jmt.pattern_index(jnp.asarray(d.numpy())))
        counts = np.bincount(idx, weights=valid.numpy() > 0, minlength=2 ** t)
        return T(jax.random.dirichlet(k_pi, jnp.asarray(counts, jnp.float32) + 1.0)
                 ).to(torch.float64)

    monkeypatch.setattr(tm, "sample_pattern_pi", pattern_pi)

    def bartlett(key, df, batch=None):
        if batch is None:
            return T(jd._standard_wishart_chol(key, df, t, f64))
        return T(jax.vmap(lambda k: jd._standard_wishart_chol(k, df, t, f64))(
            jax.random.split(key, batch)))

    if method == "BayesB":
        cov_b = tm.sample_marker_covariance_bayesb
        monkeypatch.setattr(tm, "sample_marker_covariance_bayesb",
                            lambda gen, be, df, scale, constraint: cov_b(
                                gen, be, df, scale, constraint,
                                bartlett(k_var, df + 1.0, be.shape[1])))
    else:
        cov = tm.sample_marker_covariance
        monkeypatch.setattr(tm, "sample_marker_covariance",
                            lambda gen, be, valid, n, df, scale, constraint: cov(
                                gen, be, valid, n, df, scale, constraint,
                                bartlett(k_var, df + n)))
    vc = tm.sample_random_effect_vc
    monkeypatch.setattr(tm, "sample_random_effect_vc",
                        lambda gen, sols, Vinv, df, scale: vc(
                            gen, sols, Vinv, df, scale,
                            bartlett(k_vc.pop(0), df + sols.shape[1])))
    res = tm.sample_residual_covariance
    monkeypatch.setattr(tm, "sample_residual_covariance",
                        lambda gen, yc, rinv, n, df, scale, constraint: res(
                            gen, yc, rinv, n, df, scale, constraint, bartlett(k_res, df + n)))
    got = tm.make_mt_step(cfg)(st, data)
    assert not k_vc
    tol = dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))
    assert 0 < np.asarray(want.delta).mean() < 1
    for k in ("sol", "alpha", "beta", "ycorr", "pi", "varg", "R"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   err_msg=k, **tol)
    for g in range(2):
        np.testing.assert_allclose(got.vc[g].numpy(), np.asarray(want.vc[g]), **tol)


def test_refusals_of_slice_7b_and_the_2bit_store():
    """Slice 7b's methods and options run (RR-BLUP, BayesL, GBLUP, SEM, the
    MT prior update raise nothing); what K9 cannot run is refused at
    set-up with NotImplementedError: 9 traits and blocks above 2,048
    markers; more than one trait on the 2-bit store raises jwas_tpu's
    ValueError, sparse_location=True its single-trait ValueError."""
    sim = simulate_genomic_data_mt(n=60, p=30, n_qtl=5, seed=1)
    eq = "y1 = intercept + geno\ny2 = intercept + geno"

    def run(method="BayesC", storage="f32", eq=eq, table=sim["phenotypes"], **kw):
        geno = jt.get_genotypes(sim["genotypes"], method=method, storage=storage,
                                device="cpu")
        return jt.runMCMC(jt.build_model(eq, genotypes=geno), table,
                          device="cpu", chain_length=10, output_folder="",
                          printout_model_info=False, **kw)

    for method in ("RR-BLUP", "BayesL", "GBLUP"):
        run(method)
    run(causal_structure=np.array([[0.0, 0.0], [1.0, 0.0]]))
    run(update_priors_frequency=5)
    rng = np.random.default_rng(1)
    table = sim["phenotypes"].copy()
    for k in range(3, 10):
        table[f"y{k}"] = rng.normal(size=len(table))
    with pytest.raises(NotImplementedError, match="9 traits"):
        run("RR-BLUP", eq="\n".join(f"y{k} = intercept + geno" for k in range(1, 10)),
            table=table, fast_blocks=8)
    with pytest.raises(NotImplementedError, match="blocks of 2056 markers"):
        run("BayesL", fast_blocks=2056)
    with pytest.raises(ValueError, match="single-trait analysis only"):
        run(storage="2bit")
    with pytest.raises(ValueError, match="sparse_location=True supports single-trait"):
        run(sparse_location=True)


# The spread of a chain's posterior means of R and G across seeds: the
# standard deviation over 6 seeds (96 for mega_trait, 24 for RE_CHAINS) of
# each package's chain on the same data (python tests/test_torch_mt_runmcmc.py calibrate
# port|jwas_tpu NAME FIRST_SEED COUNT out.json [P], then ... summarize
# out*.json, PYTHONPATH=., one core a process; P overrides CHAINS' markers,
# e.g. 250 for a blocked chain shows fault R11).
CALIBRATED_SD = {
    "sampler_I": {
        "jwas_tpu_torch": {"residual_variance": [[0.1224, 0.0714], [0.0714, 0.0825]],
                 "marker_effects_variances_geno": [[0.0488, 0.0456], [0.0456, 0.07]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.1505, 0.082], [0.082, 0.1549]],
                 "marker_effects_variances_geno": [[0.1466, 0.0925], [0.0925, 0.0789]]},  # 6 seeds
    },
    "sampler_II": {
        "jwas_tpu_torch": {"residual_variance": [[0.0952, 0.0447], [0.0447, 0.0651]],
                 "marker_effects_variances_geno": [[0.0362, 0.0855], [0.0855, 0.1256]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.1343, 0.0836], [0.0836, 0.0873]],
                 "marker_effects_variances_geno": [[0.0798, 0.0664], [0.0664, 0.0994]]},  # 6 seeds
    },
    # the reference's spread stands for both chains: the port's G11 has a
    # longer upper tail over 96 seeds (ROADMAP.md, Queue 3's watch item)
    "mega_trait": {
        "jwas_tpu": {"residual_variance": [[0.091, 0.0838], [0.0838, 0.1829]],
                 "marker_effects_variances_geno": [[0.1188, 0.0], [0.0, 0.0695]]},  # 96 seeds
    },
    "missing": {
        "jwas_tpu_torch": {"residual_variance": [[0.0661, 0.1516], [0.1516, 0.3079]],
                 "marker_effects_variances_geno": [[0.04, 0.0584], [0.0584, 0.0901]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.0655, 0.1338], [0.1338, 0.1739]],
                 "marker_effects_variances_geno": [[0.0278, 0.0716], [0.0716, 0.1093]]},  # 6 seeds
    },
    "BayesB": {
        "jwas_tpu_torch": {"residual_variance": [[0.1001, 0.025], [0.025, 0.1002]],
                 "marker_effects_variances_geno": [[0.0009, 0.0004], [0.0004, 0.0009]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.0711, 0.0589], [0.0589, 0.1198]],
                 "marker_effects_variances_geno": [[0.0005, 0.0006], [0.0006, 0.001]]},  # 6 seeds
    },
    "re_BayesB_I": {
        "jwas_tpu_torch": {"residual variance": [[0.3156, 0.3308], [0.3308, 0.4463]],
                 "random effect variances y1:herd": [[0.0309, 0.0158], [0.0158, 0.0193]],
                 "polygenic effects covariance matrix": [[0.147, 0.1109], [0.1109, 0.1795]]},
        "jwas_tpu": {"residual variance": [[0.2466, 0.2082], [0.2082, 0.4765]],
                 "random effect variances y1:herd": [[0.0217, 0.0213], [0.0213, 0.0233]],
                 "polygenic effects covariance matrix": [[0.1768, 0.1177], [0.1177, 0.1657]]},
    },  # 24 seeds each
    "re_BayesC_II": {
        "jwas_tpu_torch": {"residual variance": [[0.3104, 0.4668], [0.4668, 0.6044]],
                 "random effect variances y1:herd": [[0.0271, 0.0201], [0.0201, 0.0192]],
                 "polygenic effects covariance matrix": [[0.1656, 0.0996], [0.0996, 0.196]]},
        "jwas_tpu": {"residual variance": [[0.3491, 0.4039], [0.4039, 0.5748]],
                 "random effect variances y1:herd": [[0.0207, 0.0214], [0.0214, 0.0277]],
                 "polygenic effects covariance matrix": [[0.1698, 0.1153], [0.1153, 0.16]]},
    },  # 24 seeds each
    "fast_blocks_16": {
        "jwas_tpu_torch": {"residual_variance": [[0.1038, 0.0575], [0.0575, 0.1511]],
                 "marker_effects_variances_geno": [[0.0242, 0.0324], [0.0324, 0.0639]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.1065, 0.0474], [0.0474, 0.1164]],
                 "marker_effects_variances_geno": [[0.023, 0.0467], [0.0467, 0.0979]]},  # 6 seeds
    },
    "RR-BLUP": {
        "jwas_tpu_torch": {"residual_variance": [[0.0929, 0.0788], [0.0788, 0.1653]],
                 "marker_effects_variances_geno": [[0.0019, 0.0022], [0.0022, 0.0051]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.0597, 0.1379], [0.1379, 0.1548]],
                 "marker_effects_variances_geno": [[0.0027, 0.0037], [0.0037, 0.0041]]},  # 6 seeds
    },
    # G to six decimals: its entries are ~0.002
    "BayesL": {
        "jwas_tpu_torch": {"residual_variance": [[0.0929, 0.1112], [0.1112, 0.1137]],
                 "marker_effects_variances_geno": [[7.1e-05, 7.9e-05], [7.9e-05, 0.000109]]},
        "jwas_tpu": {"residual_variance": [[0.0698, 0.0949], [0.0949, 0.1262]],
                 "marker_effects_variances_geno": [[8.2e-05, 0.000102],
                                                   [0.000102, 0.000145]]},
    },  # 6 seeds each
    "GBLUP": {
        "jwas_tpu_torch": {"residual_variance": [[0.1438, 0.1279], [0.1279, 0.1827]],
                 "marker_effects_variances_geno": [[0.3622, 0.4007], [0.4007, 0.3085]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.1478, 0.1576], [0.1576, 0.173]],
                 "marker_effects_variances_geno": [[0.2735, 0.2405], [0.2405, 0.2815]]},  # 6 seeds
    },
    "SEM": {
        "jwas_tpu_torch": {"residual_variance": [[0.0905, 0.1672], [0.1672, 0.3208]],
                 "marker_effects_variances_geno": [[0.0466, 0.0414], [0.0414, 0.0969]]},  # 6 seeds
        "jwas_tpu": {"residual_variance": [[0.092, 0.1004], [0.1004, 0.1788]],
                 "marker_effects_variances_geno": [[0.0223, 0.0262], [0.0262, 0.067]]},  # 6 seeds
    },
}


def _calibrate(pkg_name, name, first, count, path, p=None):
    import json
    import tempfile

    pkg = jt if pkg_name == "port" else jw
    rows = []
    for seed in range(first, first + count):
        with tempfile.TemporaryDirectory() as folder:
            if name in RE_CHAINS:
                acc, means = None, re_means(run_re(pkg, name, folder, seed))
            else:
                acc, means = chain_means(pkg, name, folder, seed, p)
        rows.append(dict(name=name, package=pkg.__name__, seed=seed, acc=acc,
                         **{v: m.tolist() for v, m in means.items()}))
        with open(path, "w") as f:
            json.dump(rows, f)


def _summarize(paths):
    import json

    rows = [r for p in paths for r in json.load(open(p))]
    table = {}
    for r in rows:
        table.setdefault(r["name"], {}).setdefault(r["package"], []).append(r)
    for name, by_pkg in sorted(table.items()):
        for pkg, rs in sorted(by_pkg.items()):
            tracks = RE_TRACKS if name in RE_CHAINS else TRACKS
            sd = {v: np.round(np.std([r[v] for r in rs], axis=0, ddof=1), 4).tolist()
                  for v in tracks}
            mean = {v: np.round(np.mean([r[v] for r in rs], axis=0), 4).tolist()
                    for v in tracks}
            acc = ("" if name in RE_CHAINS else "; min accuracy "
                   f"{np.round(np.min([r['acc'] for r in rs], axis=0), 3).tolist()}")
            print(f"{name} {pkg} ({len(rs)} seeds): sd {sd}; mean {mean}{acc}")


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "calibrate":
        _calibrate(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6],
                   int(sys.argv[7]) if len(sys.argv) > 7 else None)
    else:
        _summarize(sys.argv[2:])


def test_model_without_genotypes_keeps_a_fixed_group_covariance_fault_r10():
    """y1 y2 = intercept + herd + litter without genotypes (method "none"):
    the herd group set with estimate_variance=False keeps its 2 x 2 G (the
    reference's MT step draws it all the same, mcmc_mt.py:456-464, fault
    R10), the litter group's is drawn."""
    rng = np.random.default_rng(8)
    n = 120
    herd = rng.integers(0, 6, n)
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(n)], dtype=object),
                      "y1": rng.normal(size=n) + 0.5 * herd,
                      "y2": rng.normal(size=n) - 0.3 * herd,
                      "herd": [f"h{k}" for k in herd],
                      "litter": [f"l{k}" for k in rng.integers(0, 15, n)]})
    model = jt.build_model("y1 = intercept + herd + litter\ny2 = intercept + herd + litter")
    G = np.array([[0.3, 0.1], [0.1, 0.4]])
    jt.set_random(model, "herd", G, estimate_variance=False)
    jt.set_random(model, "litter", np.array([[0.2, 0.0], [0.0, 0.2]]))
    out = jt.runMCMC(model, table, device="cpu", chain_length=20, seed=2,
                     output_folder="", printout_model_info=False)
    herd_vc = out["random effect variances y1:herd"]
    np.testing.assert_array_equal(np.asarray(herd_vc.Estimate, dtype=np.float32),
                                  G.reshape(-1).astype(np.float32))
    assert not np.any(np.asarray(out["random effect variances y1:litter"].SD, dtype=float)
                      == 0.0)
