"""Convergence diagnostics, closed-form cross-validation, lsmeans and getEBV.

Counterpart of jwas_tpu/analysis/diagnostics.py: PSRF (:33), the sample
file reader (:71-103, here engine/samples_io.py::read_sample_file),
PSRF_per_parameter (:106), traceplot (:137), LOOCV (:171), lsmeans (:211)
and getEBV (:253), over Tables in place of DataFrames.

PSRF and PSRF_per_parameter are a few sums over small arrays on the host.
LOOCV runs in float64 with torch.linalg on a device, the GPU unless the
caller asks for another (device="cpu"; a missing GPU raises). traceplot
imports matplotlib when it is called and raises ImportError naming it
where it is missing; nothing else here needs it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from jwas_tpu_torch.engine.samples_io import read_sample_file
from jwas_tpu_torch.engine.setup import resolve_device
from jwas_tpu_torch.io.table import Table


def _load_chain(obj, header: bool = True) -> np.ndarray:
    if isinstance(obj, str):
        return read_sample_file(obj, header=header)[1]
    return np.asarray(obj, dtype=np.float64)


def PSRF(*chains, header: bool = True) -> float:
    """Gelman-Rubin potential scale reduction factor (convergence_diagnosis.jl:
    31-57) of >= 2 chains: sample files (header: whether each starts with a
    header row) or arrays, each flattened whole as the reference flattens
    its table; chains of unequal length are cut to the shortest. Values
    near 1 indicate convergence."""
    if len(chains) < 2:
        raise ValueError("PSRF needs at least two chains")
    flat = [_load_chain(c, header=header).reshape(-1) for c in chains]
    N = min(len(x) for x in flat)
    flat = [x[:N] for x in flat]
    if N < 2:
        raise ValueError("PSRF needs at least two samples per chain")
    means = np.asarray([x.mean() for x in flat])
    variances = [x.std(ddof=1) ** 2 for x in flat]
    M = len(chains)
    B = N / (M - 1) * np.sum((means - means.mean()) ** 2)
    W = float(np.mean(variances))
    V = (N - 1) / N * W + (M + 1) / (N * M) * B
    return V / W


def PSRF_per_parameter(*paths, max_params: int = 0) -> Table:
    """The PSRF of each column (parameter level or marker) of the same
    parameter's sample file from >= 2 chains (chain_<k>/MCMC_samples_*.txt
    of runMCMC(..., n_chains=K, output_chain_samples=True)), over the
    shortest chain's samples and the first max_params columns (0: all);
    columns constant in every chain are left out. Returns a Table of
    parameter and PSRF."""
    if len(paths) < 2:
        raise ValueError("PSRF_per_parameter needs files from >=2 chains")
    labels, mats = None, []
    for path in paths:
        lab, arr = read_sample_file(path, columns=int(max_params or 0))
        labels = lab if labels is None else labels
        mats.append(arr)
    N = min(m.shape[0] for m in mats)
    k = min(m.shape[1] for m in mats)
    names, values = [], []
    for j in range(k):
        cols = [m[:N, j] for m in mats]
        if all(np.std(c) == 0.0 for c in cols):
            continue
        names.append(labels[j])
        values.append(float(PSRF(*cols, header=False)))
    return Table({"parameter": np.asarray(names, dtype=object),
                  "PSRF": np.asarray(values, dtype=np.float64)})


def traceplot(samples, labels: Sequence[str] = (), nplots: int = 4, header: bool = True,
              save_path: str = "traceplot.png"):
    """Trace and running mean of the first nplots parameters
    (convergence_diagnosis.jl:1-29), saved as a PNG at save_path (none
    when empty). samples: a sample file (its header's labels) or an array,
    one row a sample. Returns the matplotlib figure."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("traceplot needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(samples, str):
        labels, chain = read_sample_file(samples, header=header)
    else:
        chain = np.atleast_2d(np.asarray(samples, dtype=np.float64))
        if chain.shape[0] == 1:
            chain = chain.T
        if not labels:
            labels = [f"param{i + 1}" for i in range(chain.shape[1])]
    k = min(nplots, chain.shape[1])
    steps = np.arange(1, chain.shape[0] + 1)
    fig, axes = plt.subplots(k, 1, figsize=(8, 2.2 * k), squeeze=False)
    for i in range(k):
        ax = axes[i][0]
        ax.plot(steps, chain[:, i], lw=0.6)
        ax.plot(steps, np.cumsum(chain[:, i]) / steps, color="green", lw=1.2)
        ax.set_title(str(labels[i]), loc="left", fontsize=9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig


def LOOCV(X, y, vara: float, vare: float, verbose: bool = True,
          device="cuda") -> np.ndarray:
    """Closed-form leave-one-out PRESS residuals (LOOCV.jl), e_i = (y_i -
    yhat_i) / (1 - h_ii), in float64 on device. X: (n, p) marker
    covariates (an intercept is added), y: (n,), vara / vare: the
    marker-effect and residual variances. n > p takes the marker-effect
    model (eMEM: the ridge hat matrix of [1 X]), otherwise the
    breeding-value model (eBV: u ~ N(0, X X' vara), 0.01 added to the
    diagonal of a singular X X'). Returns e (n,) on the host."""
    device = resolve_device(device)
    X = torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X,
                        dtype=torch.float64).to(device)
    y = torch.as_tensor(np.asarray(y) if not torch.is_tensor(y) else y,
                        dtype=torch.float64).to(device).reshape(-1)
    n, p = X.shape
    lam = vare / vara
    if n > p:
        Xf = torch.cat([torch.ones((n, 1), dtype=X.dtype, device=device), X], dim=1)
        ident = torch.eye(p + 1, dtype=X.dtype, device=device)
        ident[0, 0] = 0.0
        H0 = torch.linalg.inv(Xf.T @ Xf + ident * lam)
        beta = H0 @ (Xf.T @ y)
        h = ((Xf @ H0) * Xf).sum(dim=1)
        e = (y - Xf @ beta) / (1.0 - h)
    else:
        G = X @ X.T
        eye = torch.eye(n, dtype=X.dtype, device=device)
        if int(torch.linalg.matrix_rank(G)) < n:
            G = G + eye * 0.01
        Hsub = eye + torch.linalg.inv(G) * lam
        ones = torch.ones((1, n), dtype=X.dtype, device=device)
        lhs = torch.cat([torch.cat([torch.full((1, 1), float(n), dtype=X.dtype,
                                               device=device), ones], dim=1),
                         torch.cat([ones.T, Hsub], dim=1)], dim=0)
        H0 = torch.linalg.inv(lhs)
        beta = H0 @ torch.cat([y.sum().view(1), y])       # Z'y, Z = [1 I]
        h = H0[0, 0] + H0[0, 1:] + H0[1:, 0] + torch.diagonal(H0)[1:]
        e = (y - (beta[0] + beta[1:])) / (1.0 - h)
    e = e.cpu().numpy()
    if verbose:
        yh = y.cpu().numpy()
        print(f"mean square of error is {float(e @ e / n)}")
        print(f"prediction accuracy is {float(np.corrcoef(yh, yh + e)[0, 1])}")
    return e


def lsmeans(model, results) -> Table:
    """Least-squares means of the fixed categorical effects (misc.jl:7-38):
    lsmean(level) = its estimate plus every other fixed term of the same
    trait at its mean (a covariate and the intercept at their data mean
    times the estimate, a factor at the mean of its estimates). model: the
    fitted Model; results: runMCMC's results (its "location parameters").
    Returns a Table of Trait, Effect, Level and lsmean."""
    lp = results["location parameters"]
    trait_col = np.asarray(lp["Trait"]).astype(str)
    effect_col = np.asarray(lp["Effect"]).astype(str)
    rows = []
    for trait in model.lhs_vec:
        contribs = {}
        for t in model.terms:
            if t.random_type != "fixed" or t.trait_name != trait:
                continue
            effect = t.trm_str.split(":", 1)[1]
            sel = (trait_col == str(trait)) & (effect_col == effect)
            est = np.asarray(lp["Estimate"], dtype=float)[sel]
            if len(est) == 0:
                continue
            if t.n_levels == 1:
                xbar = float(np.mean(t.val)) if t.val is not None else 1.0
                contribs[effect] = ("scalar", xbar * est[0])
            else:
                contribs[effect] = ("cat", list(np.asarray(lp["Level"])[sel]), est)
        for effect, c in contribs.items():
            if c[0] != "cat":
                continue
            base = 0.0
            for e2, c2 in contribs.items():
                if e2 != effect:
                    base += c2[1] if c2[0] == "scalar" else float(np.mean(c2[2]))
            rows.extend((trait, effect, lev, float(e) + base) for lev, e in zip(c[1], c[2]))
    return Table({"Trait": np.asarray([r[0] for r in rows], dtype=object),
                  "Effect": np.asarray([r[1] for r in rows], dtype=object),
                  "Level": np.asarray([r[2] for r in rows], dtype=object),
                  "lsmean": np.asarray([r[3] for r in rows], dtype=np.float64)})


def getEBV(results, trait: str = None) -> Table:
    """The EBV table of trait from runMCMC's results (output.jl:281-306);
    with one trait the name may be left out."""
    keys = [k for k in results if k.startswith("EBV_")]
    if trait is not None:
        key = f"EBV_{trait}"
        if key not in results:
            raise KeyError(f"no {key!r} in results; available: {keys}")
        return results[key]
    if len(keys) != 1:
        raise ValueError(f"specify the trait; available: {keys}")
    return results[keys[0]]
