"""Between-seed spread of BayesC posterior means, port against jwas_tpu.

On tests/test_torch_slice.py's data and chain settings (n = 400, p =
2,000, fast_blocks = 8, 2,000 sweeps, 400 burn-in), each package runs one
chain a seed; the spread of a chain's posterior mean over the seeds is
compared between the packages with a two-sided F-test. A port whose chains
spread more than the reference's beyond chance would sample another
posterior, or mix worse.

    python tests/test_torch_seed_spread.py run jwas_tpu 1 15 out.json
    python tests/test_torch_seed_spread.py run port 1 15 out.json
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


def _problem():
    import os
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from jwas_tpu import build_model, get_genotypes, prepare_packed_genotypes
    from jwas_tpu.engine.setup import MCMCOptions, prepare_workspace
    from jwas_tpu.io.datasets import simulate_genomic_data
    import tempfile

    sim = simulate_genomic_data(n=400, p=2000, n_qtl=20, h2=0.5, seed=11)
    path = os.path.join(tempfile.mkdtemp(), "geno")
    store = prepare_packed_genotypes(sim["genotypes"], save_path=path)
    pheno = sim["phenotypes"].sample(frac=1.0, random_state=1).reset_index(drop=True)
    opts = dict(fast_blocks=8, output_folder="", printout_model_info=False,
                chain_length=2000, burnin=400)

    def model():
        return build_model("y = intercept + geno",
                           genotypes=get_genotypes(store, method="BayesC", name="geno"))

    ws = prepare_workspace(model(), pheno, MCMCOptions(**opts))
    return path, pheno, model, opts, ws


def run(package, first, last, out):
    import torch
    torch.set_num_threads(1)
    path, pheno, model, opts, ws = _problem()
    rows = []
    if package == "jwas_tpu":
        from jwas_tpu import runMCMC
        for seed in range(first, last + 1):
            ref = runMCMC(model(), pheno, seed=seed, **opts)
            rows.append(dict(seed=seed,
                             vare=float(ref["residual variance"].Estimate[0]),
                             varg=float(ref["marker effects variances geno"].Estimate[0]),
                             pi=float(ref["pi_geno"].Estimate[0])))
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
        json.dump({"package": package, "rows": rows}, f)


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
        run(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        compare(sys.argv[2:])
