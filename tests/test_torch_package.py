"""The port as a package: what importing each of its modules loads, the
whole entry path where pandas cannot be imported (BayesC from a CSV, and
BayesB on a store packed out of core and streamed from host memory), and
chip_smoke.py's refusal to run without a GPU (it must print no result
then)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_out_jax_pandas_and_jwas_tpu():
    code = ("import sys, importlib, pkgutil, jwas_tpu_torch; "
            "mods = [m.name for m in pkgutil.walk_packages(jwas_tpu_torch.__path__, "
            "'jwas_tpu_torch.')]; [importlib.import_module(m) for m in mods]; "
            "assert 'jwas_tpu_torch.utils.memory' in mods, mods; "
            "assert 'jwas_tpu_torch.io.pedigree' in mods, mods; "
            "assert {'jwas_tpu_torch.analysis.gwas', 'jwas_tpu_torch.analysis.diagnostics', "
            "'jwas_tpu_torch.io.datasets'} <= set(mods), mods; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'pandas', 'jwas_tpu', 'matplotlib'}); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PANDAS_FREE = """
import os, sys
sys.modules["pandas"] = None                  # import pandas now fails
import numpy as np
import jwas_tpu_torch as jt
folder = sys.argv[1]
rng = np.random.default_rng(0)
n, p = 60, 40
codes = rng.binomial(2, rng.uniform(0.2, 0.8, p), size=(n, p))
with open(os.path.join(folder, "geno.csv"), "w") as f:
    f.write("ID," + ",".join(f"m{j}" for j in range(p)) + "\\n")
    for i in range(n):
        f.write(f"a{i}," + ",".join(map(str, codes[i])) + "\\n")
with open(os.path.join(folder, "pheno.csv"), "w") as f:
    f.write("ID,y,herd\\n")
    for i in range(0, n, 2):
        f.write(f"a{i},{rng.normal():.4f},h{i % 3}\\n")
geno = jt.get_genotypes(os.path.join(folder, "geno.csv"), storage="2bit")
model = jt.build_model("y = intercept + herd + geno", genotypes=geno)
out = jt.runMCMC(model, jt.read_csv(os.path.join(folder, "pheno.csv")),
                 device="cpu", chain_length=16, fast_blocks=8, seed=1,
                 printout_model_info=False, output_folder=os.path.join(folder, "res"))
assert len(out["EBV_y"]) == n and np.isfinite(out["EBV_y"].EBV).all()
store = jt.prepare_packed_genotypes(os.path.join(folder, "geno.csv"), low_memory=True,
                                   save_path=os.path.join(folder, "geno"))
model = jt.build_model("y = intercept + geno",
                       genotypes=jt.get_genotypes(store, method="BayesB"))
outb = jt.runMCMC(model, jt.read_csv(os.path.join(folder, "pheno.csv")),
                  device="cpu", chain_length=16, fast_blocks=8, seed=1,
                  host_offload_genotypes=True, printout_model_info=False,
                  output_folder="")
assert np.isfinite(outb["marker effects variances geno"].Estimate).all()
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v}
assert not loaded & {"pandas", "jax", "jaxlib", "jwas_tpu"}, loaded
print(sorted(os.listdir(os.path.join(folder, "res"))))
"""


def test_runmcmc_without_pandas(tmp_path):
    proc = subprocess.run([sys.executable, "-c", PANDAS_FREE, str(tmp_path)],
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "EBV_y.txt" in proc.stdout and "MCMC_samples_EBV_y.txt" in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the smoke would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# jwas_tpu's public names that the port does not have yet
NOT_YET = set()


def test_public_names_match_jwas_tpu():
    """Every name of jwas_tpu.__all__ is an attribute of the port;
    add_genotypes warns that it is deprecated."""
    import warnings

    import jwas_tpu
    import jwas_tpu_torch as jt

    missing = sorted(n for n in jwas_tpu.__all__ if not hasattr(jt, n))
    assert missing == sorted(NOT_YET) == [], missing
    assert jt.prepare_streaming_genotypes is jt.prepare_packed_genotypes
    model = jt.build_model("y1 = intercept\ny2 = intercept")
    rng = np.random.default_rng(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g = jt.add_genotypes(model, rng.integers(0, 3, (20, 8)).astype(float),
                             device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert model.M == [g] and g.G.df == 6.0


def _refusals(monkeypatch):
    """The text of each NotImplementedError the port raises for what it does
    not run yet."""
    import re

    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.setup as es
    from jwas_tpu_torch.ops import location
    from jwas_tpu_torch.ops.multitrait import check_prior_traits, check_traits

    rng = np.random.default_rng(1)
    X = rng.integers(0, 3, (30, 10)).astype(float)
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(30)], dtype=object),
                      "y1": rng.normal(size=30), "y2": rng.normal(size=30),
                      "x": np.arange(30)})
    texts = []

    def expect(fn):
        with pytest.raises(NotImplementedError) as e:
            fn()
        texts.append(str(e.value))

    def run(eq, method="BayesC", **kw):
        geno = jt.get_genotypes(X, method=method, device="cpu") if "geno" in eq else None
        model = jt.build_model(eq, genotypes=geno)
        return jt.runMCMC(model, table, device="cpu", chain_length=4, output_folder="",
                          printout_model_info=False, **kw)

    expect(lambda: check_prior_traits(5))
    expect(lambda: check_traits(9))
    for name, (default, _) in es._UNPORTED.items():
        value = {"n_chains": 2, "mesh": object(), "checkpoint_frequency": 5,
                 "resume": True, "single_step_analysis": True, "RRM": object(),
                 "use_pallas": True}[name]
        extra = {"pedigree": object()} if name == "single_step_analysis" else {}
        expect(lambda: run("y1 = intercept + geno", **{name: value}, **extra))
    # RRM: checkpoints (the ops layer) and K10's limits, on long data
    long = jt.Table({"ID": np.repeat(table["ID"], 3), "time": np.tile([1.0, 2.0, 3.0], 30),
                     "y1": rng.normal(size=90)})
    for phi, extra in ((jt.generate_full_phi([1.0, 2.0, 3.0], 2), {"checkpoint_frequency": 2}),
                       (jt.generate_full_phi([1.0, 2.0, 3.0], 6), {})):
        expect(lambda: jt.runMCMC(
            jt.build_model("y1 = intercept + geno", genotypes=jt.get_genotypes(
                X, device="cpu")), long, device="cpu", chain_length=4, output_folder="",
            printout_model_info=False, RRM=phi, **extra))
    expect(lambda: run("y1 = intercept + geno\ny2 = intercept + geno", method="RR-BLUP",
                       fast_blocks=4096))
    expect(lambda: run("y1 = intercept + geno\ny2 = intercept + geno", fast_blocks=4096))
    monkeypatch.setattr(location, "pass_limit", lambda device, dtype=None: 40)
    expect(lambda: run("y1 = intercept + x\ny2 = intercept + x"))
    # multi-trait single-step stays on the dense path: its 30 non-genotyped
    # animals' epsilon levels make K = 64 there, above the limit
    ids = np.array([str(i + 1) for i in range(60)], dtype=object)
    founders = np.array(["0"] * 60, dtype=object)
    ped = jt.get_pedigree(jt.Table({"ID": ids, "S": founders, "D": founders}))
    ssbr = jt.Table({"ID": ids[:30], "y1": rng.normal(size=30), "y2": rng.normal(size=30)})
    expect(lambda: jt.runMCMC(
        jt.build_model("y1 = intercept + geno\ny2 = intercept + geno",
                       genotypes=jt.get_genotypes(X, device="cpu")),
        ssbr, device="cpu", chain_length=4, output_folder="", printout_model_info=False,
        single_step_analysis=True, pedigree=ped))
    return [re.search(r"ROADMAP\.md: ([^)]+)\)", t) for t in texts], texts


def test_refusals_name_their_part_of_the_roadmap(monkeypatch):
    """Each refusal names the part of ROADMAP.md that brings what it refuses
    (a heading or an item's title, not an item number), and that text is in
    ROADMAP.md (in any case, its code spans' backticks left out)."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = " ".join(f.read().replace("`", "").split()).lower()
    found, texts = _refusals(monkeypatch)
    for m, text in zip(found, texts):
        assert m is not None, text
        assert m.group(1).lower() in roadmap, text


def test_location_limit_is_refused_before_the_design_is_densified(monkeypatch):
    """K above K6's limit (injected here: 40) is refused by prepare_workspace
    for every sparse_location and every number of traits, before the
    location design is made dense."""
    import scipy.sparse as sp

    import jwas_tpu_torch as jt
    from jwas_tpu_torch.ops import location

    def boom(self, *a, **k):
        raise AssertionError("the design was densified")

    monkeypatch.setattr(location, "pass_limit", lambda device, dtype=None: 40)
    monkeypatch.setattr(sp.csc_matrix, "todense", boom)
    rng = np.random.default_rng(2)
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(60)], dtype=object),
                      "y1": rng.normal(size=60), "y2": rng.normal(size=60),
                      "x": np.arange(60)})
    for eq in ("y1 = intercept + x", "y1 = intercept + x\ny2 = intercept + x"):
        for sparse in (None, False):
            model = jt.build_model(eq)
            with pytest.raises(NotImplementedError, match="K6"):
                jt.runMCMC(model, table, device="cpu", chain_length=4, output_folder="",
                           printout_model_info=False, sparse_location=sparse)
