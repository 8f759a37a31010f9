"""Between-seed spread of BayesC (or BayesB) posterior means, port against
jwas_tpu.

On tests/test_torch_slice.py's data and chain settings (n = 400, p =
2,000, fast_blocks = 8, 2,000 sweeps, 400 burn-in), each package runs one
chain a seed; the spread of a chain's posterior mean over the seeds is
compared between the packages with a two-sided F-test. A port whose chains
spread more than the reference's beyond chance would sample another
posterior, or mix worse. With the method BayesB the data are
tests/test_torch_bayesb.py's (p = 2,048, so the last group is short) and
both packages run runMCMC; varg is the posterior mean of the markers'
mean variance. The spreads of those runs calibrate that test's bounds.
With the method exact both packages run BayesC through runMCMC on the same
data as a dense float32 store with fast_blocks=False: the exact
single-site sweep, which has no blocked schedule (the port: chunks of b
markers through K1's plain version).

    python tests/test_torch_seed_spread.py run jwas_tpu 1 15 out.json [BayesB|exact]
    python tests/test_torch_seed_spread.py run port 1 15 out.json [BayesB|exact]
    python tests/test_torch_seed_spread.py compare out1.json out2.json ...

The test below holds the F-test itself; the chains take minutes a seed.
"""

import json
import sys

import numpy as np
from scipy import stats

KEYS = ("vare", "varg", "pi")


def f_test(a, b):
    """Two-sided F-test of equal variances: (F = var a / var b, p)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    f = a.var(ddof=1) / b.var(ddof=1)
    d1, d2 = len(a) - 1, len(b) - 1
    p = 2.0 * min(stats.f.cdf(f, d1, d2), stats.f.sf(f, d1, d2))
    return float(f), float(p)


def test_f_test_matches_its_definition():
    rng = np.random.default_rng(0)
    a, b = rng.normal(0, 1, 30), rng.normal(0, 1, 30)
    f, p = f_test(a, b)
    assert f == a.var(ddof=1) / b.var(ddof=1) and 0.01 < p <= 1.0
    f2, p2 = f_test(b, a)
    assert np.isclose(f2, 1.0 / f) and np.isclose(p2, p)
    assert f_test(4.0 * a, b)[1] < 1e-6


def _problem(method="BayesC"):
    import os
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from jwas_tpu import build_model, get_genotypes, prepare_packed_genotypes
    from jwas_tpu.engine.setup import MCMCOptions, prepare_workspace
    from jwas_tpu.io.datasets import simulate_genomic_data
    import tempfile

    p = 2048 if method == "BayesB" else 2000
    sim = simulate_genomic_data(n=400, p=p, n_qtl=20, h2=0.5, seed=11)
    path = os.path.join(tempfile.mkdtemp(), "geno")
    store = prepare_packed_genotypes(sim["genotypes"], save_path=path)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=1).reset_index(drop=True)
    opts = dict(fast_blocks=8, output_folder="", printout_model_info=False,
                chain_length=2000, burnin=400)

    def model():
        return build_model("y = intercept + geno", genotypes=get_genotypes(
            store, method="BayesB" if method == "BayesB" else "BayesC", name="geno"))

    ws = prepare_workspace(model(), pheno, MCMCOptions(**opts))
    return path, pheno, model, opts, ws, sim["genotypes"]


def _summary(res):
    return dict(vare=float(res["residual variance"].Estimate[0]),
                varg=float(res["marker effects variances geno"].Estimate[0]),
                pi=float(res["pi_geno"].Estimate[0]))


def run(package, first, last, out, method="BayesC"):
    import torch
    torch.set_num_threads(1)
    path, pheno, model, opts, ws, geno = _problem(method)
    rows = []
    if method == "exact":
        import jwas_tpu
        import jwas_tpu_torch as jt
        opts = dict(opts, fast_blocks=False)
        for seed in range(first, last + 1):
            if package == "jwas_tpu":
                res = jwas_tpu.runMCMC(jwas_tpu.build_model(
                    "y = intercept + geno", genotypes=jwas_tpu.get_genotypes(
                        geno, method="BayesC", name="geno")), pheno, seed=seed, **opts)
            else:
                res = jt.runMCMC(jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
                    geno, method="BayesC", name="geno", device="cpu")),
                    pheno, device="cpu", seed=seed, **opts)
            rows.append(dict(seed=seed, **_summary(res)))
    elif method == "BayesB":
        import jwas_tpu_torch as jt
        from jwas_tpu import runMCMC
        for seed in range(first, last + 1):
            if package == "jwas_tpu":
                res = runMCMC(model(), pheno, seed=seed, **opts)
            else:
                res = jt.runMCMC(jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
                    jt.Packed2BitStore.load(path), method="BayesB", name="geno")),
                    pheno, device="cpu", seed=seed, **opts)
            rows.append(dict(seed=seed, **_summary(res)))
    elif package == "jwas_tpu":
        from jwas_tpu import runMCMC
        for seed in range(first, last + 1):
            ref = runMCMC(model(), pheno, seed=seed, **opts)
            rows.append(dict(seed=seed, **_summary(ref)))
    else:
        import jwas_tpu_torch as jt
        gm = jt.setup_markers(jt.Packed2BitStore.load(path), ws.obs_ids, "cpu",
                              fast_blocks=8)
        priors = dict(W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R, df_R=ws.df_R,
                      marker_var0=ws.marker_var0, marker_scale0=ws.marker_scale0,
                      df_marker=ws.df_marker, pi0=ws.pi0)
        for seed in range(first, last + 1):
            res = jt.run_st(gm, ws.y, **priors, seed=seed, chain_length=2000,
                            burnin=400)
            rows.append(dict(seed=seed, **{k: float(res[k]) for k in KEYS}))
    with open(out, "w") as f:
        json.dump({"package": package, "method": method, "rows": rows}, f)


def compare(files):
    by = {}
    for name in files:
        with open(name) as f:
            d = json.load(f)
        by.setdefault(d["package"], []).extend(d["rows"])
    ref, port = by["jwas_tpu"], by["port"]
    print(f"seeds: jwas_tpu {len(ref)}, port {len(port)}")
    for k in KEYS:
        a = np.array([r[k] for r in port])
        b = np.array([r[k] for r in ref])
        f, p = f_test(a, b)
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        print(f"{k}: port mean {a.mean():.6g} sd {a.std(ddof=1):.6g}; jwas_tpu "
              f"mean {b.mean():.6g} sd {b.std(ddof=1):.6g}; difference of means "
              f"{(a.mean() - b.mean()) / se:.3f} SE; F = {f:.4f}, two-sided p = {p:.4g}")


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
            *sys.argv[6:7])
    else:
        compare(sys.argv[2:])
