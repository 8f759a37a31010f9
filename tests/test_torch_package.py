"""The port as a package: what importing each of its modules loads, the
whole entry path where pandas cannot be imported (BayesC from a CSV, and
BayesB on a store packed out of core and streamed from host memory), and
chip_smoke.py's refusal to run without a GPU (it must print no result
then)."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_out_jax_pandas_and_jwas_tpu():
    code = ("import sys, importlib, pkgutil, jwas_tpu_torch; "
            "mods = [m.name for m in pkgutil.walk_packages(jwas_tpu_torch.__path__, "
            "'jwas_tpu_torch.')]; [importlib.import_module(m) for m in mods]; "
            "assert 'jwas_tpu_torch.utils.memory' in mods, mods; "
            "assert 'jwas_tpu_torch.io.pedigree' in mods, mods; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'pandas', 'jwas_tpu'}); print(bad); "
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
