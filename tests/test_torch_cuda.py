"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor jwas_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX, which the card's machine
may not have.) Inputs are made with numpy or torch from a seed; both
versions get identical inputs and draws. Tolerances: the inner-rounds
chain follows the plain version's rounding operation by operation, so
blocks whose inclusion indicators agree are held to the tolerances of
tests/test_pallas_sweep.py:42-45; an indicator (a BayesR class) may flip
only where u lies within an ulp of the inclusion probability (two Gumbel
scores within an ulp of each other): expf/logf differ by an ulp from the
host's. The GEMVs sum n float32 terms in another order:
rtol 1e-4, atol 1e-4 * sqrt(n).
"""

import os
import sys

import numpy as np
import pytest
import torch

from jwas_tpu_torch import run_st, setup_markers
from jwas_tpu_torch.io.packed import Packed2BitStore, pack_codes
from jwas_tpu_torch.ops import grouped as gr
from jwas_tpu_torch.ops.inner_rounds import (abc_inner_rounds,
                                             abc_inner_rounds_ref,
                                             abc_inner_rounds_window_ref,
                                             bayesr_inner_rounds,
                                             bayesr_inner_rounds_ref,
                                             bayesr_inner_rounds_window_ref,
                                             gram_resident)
from jwas_tpu_torch.ops.packed_gemv import (packed_matvec, packed_matvec_ref,
                                            packed_rhs, packed_rhs_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _chain_inputs(nblocks, b, nreps, seed, device, regime="mixed"):
    """regime: mixed (pi = 0.9, random effects: a third of the steps change
    one), dense (pi clamped at 1e-10: every marker is included and every
    step changes its effect) or sparse (pi = 0.999 from alpha = 0: almost
    no step changes one), the three the main path runs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nblocks, b, min(4 * b, 512))).astype(np.float32)
    grams = np.einsum("kjn,krn->kjr", x, x).astype(np.float32)
    pi = np.full((nblocks, b), {"mixed": 0.9, "dense": 1e-10,
                                "sparse": 0.999}[regime], np.float32)
    pi[-1, -3:] = 1.0
    with np.errstate(divide="ignore"):
        lpc = np.log1p(-pi + np.float32(1e-12))
    alpha = (0.1 * rng.normal(size=(nblocks, b))).astype(np.float32)
    if regime == "sparse":
        alpha[:] = 0.0
    inp = dict(
        grams=grams, xpx=np.einsum("kjj->kj", grams).copy(),
        var_eff=np.full((nblocks, b), 0.02, np.float32), log_pi=np.log(pi),
        log_pi_comp=lpc, alpha=alpha, beta=alpha.copy(),
        delta=(alpha != 0).astype(np.int32),
        rhs=np.einsum("kjn,n->kj", x, rng.normal(size=x.shape[2])).astype(np.float32),
        us=rng.uniform(size=(nreps * b, nblocks)).astype(np.float32),
        zs=rng.normal(size=(nreps * b, nblocks)).astype(np.float32),
        inv_vare=np.asarray([1.0 / 1.3], np.float32),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in inp.items()}


def test_inner_rounds_kernel_matches_plain(cuda):
    """b = 256 reads Gram rows from global memory (the tile exceeds shared
    memory); b = 224 and 240 keep the tile resident; b = 152 (the default
    block size at n = 50,000) and b = 8 leave a warp's window partly empty;
    b = 520 and 1040 give a thread 2 and 4 markers. The path's shape
    (b = 128, 128 blocks, 8 reps) runs in its three regimes, where the plain
    model of the kernel's window schedule must equal the step-by-step plain
    version bit for bit. A non-contiguous argument is refused."""
    cases = [(8, 256, 3, True, "mixed"), (128, 128, 8, True, "mixed"),
             (128, 128, 8, True, "dense"), (128, 128, 8, True, "sparse"),
             (256, 16, 2, False, "mixed"), (224, 8, 12, True, "mixed"),
             (240, 4, 2, True, "dense"), (152, 16, 3, True, "mixed"),
             (152, 16, 3, True, "sparse"), (520, 2, 1, False, "mixed"),
             (1040, 2, 1, False, "mixed")]
    for b, nblocks, nreps, resident, regime in cases:
        assert gram_resident(b, nreps) == resident
        k = _chain_inputs(nblocks, b, nreps, b, cuda, regime)
        r = {n: t.clone() for n, t in k.items()}
        w = {n: t.clone() for n, t in k.items()}
        before = abc_inner_rounds.launches
        abc_inner_rounds(**k, nreps=nreps)
        abc_inner_rounds_ref(**r, nreps=nreps)
        torch.cuda.synchronize()
        assert abc_inner_rounds.launches == before + 1
        same = (k["delta"] == r["delta"]).all(dim=1)
        assert same.float().mean().item() >= 0.99, (b, regime)
        for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("beta", 1e-5, 1e-6),
                                 ("rhs", 1e-4, 1e-5)):
            torch.testing.assert_close(k[name][same], r[name][same], rtol=rtol,
                                       atol=atol)
        assert (k["delta"][-1, -3:] == 0).all()
        if b == 128:
            stats = {}
            abc_inner_rounds_window_ref(**w, nreps=nreps, stats=stats)
            for name in ("alpha", "beta", "delta", "rhs"):
                assert torch.equal(w[name], r[name]), (regime, name)
            share = stats["changes"] / (nblocks * b * nreps)
            lo, hi = {"mixed": (0.05, 0.9), "dense": (0.99, 1.0),
                      "sparse": (0.0, 0.02)}[regime]
            assert lo <= share <= hi, (regime, share)
    t = _chain_inputs(4, 16, 1, 1, cuda)
    t["rhs"] = t["rhs"].t().contiguous().t()
    with pytest.raises(ValueError):
        abc_inner_rounds(**t, nreps=1)


def _bayesr_inputs(nblocks, b, nreps, seed, device, from_zero=False):
    """Random Grams, a few markers in each slab class (none when from_zero:
    every effect starts at 0, as a chain does), the last 3 markers padding
    (zero Gram rows, xpx 1, rhs 0, class priors [1, 0, 0, 0])."""
    rng = np.random.default_rng(seed)
    pi = np.array([0.95, 0.03, 0.015, 0.005])
    x = rng.normal(size=(nblocks, b, min(4 * b, 512))).astype(np.float32)
    x[-1, -3:] = 0.0
    grams = np.einsum("kjn,krn->kjr", x, x).astype(np.float32)
    xpx = np.einsum("kjj->kj", grams).copy()
    xpx[-1, -3:] = 1.0
    delta = rng.choice(4, size=(nblocks, b), p=pi).astype(np.int32)
    delta[-1, -3:] = 0
    if from_zero:
        delta[:] = 0
    lp = np.broadcast_to(pi, (nblocks, b, 4)).copy()
    lp[-1, -3:] = [1.0, 0.0, 0.0, 0.0]
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, size=(nreps * b, nblocks, 4))
    inp = dict(
        grams=grams, xpx=xpx, log_pi=np.log(np.clip(lp, 1e-12, 1.0)),
        alpha=np.where(delta > 0, 0.1 * rng.normal(size=(nblocks, b)), 0.0),
        delta=delta,
        rhs=np.einsum("kjn,n->kj", x, rng.normal(size=x.shape[2])),
        gumbel=-np.log(-np.log(u)), zs=rng.normal(size=(nreps * b, nblocks)),
        inv_vare=np.asarray([1.0 / 1.3]), sigma_sq=np.asarray([0.01]),
    )
    return {k: torch.from_numpy(v.astype(np.int32 if k == "delta" else np.float32)).to(device)
            for k, v in inp.items()}


def test_bayesr_kernel_and_path_on_card(cuda):
    """The BayesR kernel against its plain version: b = 128 keeps the Gram
    tile resident (also from alpha = 0, the path's regime), b = 256 reads
    rows from global memory, b = 224 and 240 keep it resident, b = 152 and
    b = 8 leave a warp's window partly empty, b = 520 and 1040 give a
    thread 2 and 4 markers. At the path's shape the plain model of the
    kernel's window schedule must equal the step-by-step plain version bit
    for bit. Then the grouped BayesR sweep on the kernels against the plain
    versions with the same draws, and a short run_st(BayesR)."""
    cases = [(8, 256, 3, True, False), (128, 128, 8, True, False),
             (128, 128, 8, True, True), (256, 16, 2, False, False),
             (224, 8, 8, True, False), (240, 4, 2, True, True),
             (152, 16, 3, True, False), (152, 16, 3, True, True),
             (520, 2, 1, False, True), (1040, 2, 1, False, False)]
    for b, nblocks, nreps, resident, from_zero in cases:
        assert gram_resident(b, nreps, "BayesR") == resident
        k = _bayesr_inputs(nblocks, b, nreps, b, cuda, from_zero)
        r = {n: t.clone() for n, t in k.items()}
        w = {n: t.clone() for n, t in k.items()}
        before = bayesr_inner_rounds.launches
        bayesr_inner_rounds(**k, nreps=nreps)
        bayesr_inner_rounds_ref(**r, nreps=nreps)
        torch.cuda.synchronize()
        assert bayesr_inner_rounds.launches == before + 1
        assert (k["delta"] == r["delta"]).float().mean().item() >= 0.999, b
        same = (k["delta"] == r["delta"]).all(dim=1)
        assert same.float().mean().item() >= 0.99, b
        for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("rhs", 1e-4, 1e-5)):
            torch.testing.assert_close(k[name][same], r[name][same], rtol=rtol,
                                       atol=atol)
        assert (k["delta"][-1, -3:] == 0).all() and (k["alpha"][-1, -3:] == 0).all()
        share = (k["delta"] > 0).float().mean().item()
        assert 0.005 < share < 0.3, (b, share)
        if b == 128:
            stats = {}
            bayesr_inner_rounds_window_ref(**w, nreps=nreps, stats=stats)
            for name in ("alpha", "delta", "rhs"):
                assert torch.equal(w[name], r[name]), (from_zero, name)
            assert stats["evaluations"] < 0.5 * nblocks * b * nreps
    t = _bayesr_inputs(4, 16, 1, 1, cuda)
    t["gumbel"] = t["gumbel"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        bayesr_inner_rounds(**t, nreps=1)

    store = _store()
    b, gb = 8, 4
    gms = {d: gr.build_grouped_markers(store.packed, store.means, store.n_obs,
                                       b, gb, d) for d in ("cpu", cuda)}
    rng = np.random.default_rng(4)
    p_pad = gms["cpu"].xpx.shape[0]
    y = rng.normal(size=store.n_obs).astype(np.float32)
    panels = {}

    def draws_on(device):
        def draws(g, r, reps):
            if (g, r) not in panels:
                u = rng.uniform(1e-30, 1.0, size=(reps * b, gb, 4))
                panels[g, r] = ((-np.log(-np.log(u))).astype(np.float32),
                                rng.normal(size=(reps * b, gb)).astype(np.float32))
            return tuple(torch.from_numpy(a).to(device) for a in panels[g, r])
        return draws

    out = {}
    for d in ("cpu", cuda):
        pi_mat = torch.tensor([0.9, 0.05, 0.03, 0.02], device=d).expand(p_pad, 4)
        out[d] = gr.sweep_blocks_bayesr_grouped(
            gms[d], torch.zeros(p_pad, device=d),
            torch.zeros(p_pad, dtype=torch.int32, device=d),
            torch.from_numpy(y.copy()).to(d), torch.tensor(1.1, device=d),
            torch.tensor(0.05, device=d), pi_mat, None, nreps=3, sync_every=2,
            draws=draws_on(d))
    agree = (out[cuda][1].cpu() == out["cpu"][1]).float().mean().item()
    assert agree >= 0.99
    if agree == 1.0:
        for a, c in zip(out[cuda], out["cpu"]):
            torch.testing.assert_close(a.cpu(), c.to(a.dtype), rtol=1e-4, atol=1e-4)

    store = _store(n=400, p=1000, missing=False)
    y = np.random.default_rng(5).normal(size=400)
    gm = setup_markers(store, store.obs_ids, cuda)
    before = bayesr_inner_rounds.launches
    res = run_st(gm, y, vare0=0.5, scale_R=0.25, df_R=4.0, marker_var0=0.05,
                 marker_scale0=0.025, df_marker=4.0, pi0=0.0, method="BayesR",
                 chain_length=256, burnin=64, seed=1)
    assert bayesr_inner_rounds.launches > before
    assert np.isfinite(res["vare"]) and np.isfinite(res["varg"])
    assert res["pi"].shape == (4,) and abs(res["pi"].sum() - 1.0) < 1e-5
    assert np.isfinite(res["ebv"]).all()


def _store(n=300, p=960, seed=0, missing=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4 if missing else 3, size=(n, p)).astype(np.uint8)
    means = np.array([c[c < 3].mean() for c in codes.T])
    return Packed2BitStore(
        obs_ids=[f"i{k}" for k in range(n)], marker_ids=[f"m{j}" for j in range(p)],
        packed=pack_codes(codes), means=means, allele_freq=means / 2, n_obs=n,
        n_markers=p, has_missing=missing)


def test_gemvs_and_grouped_path_on_card(cuda):
    """The GEMV kernels against their plain versions (bpm % 4 == 0 at
    n = 4000 takes the 4-byte path, n = 53 the byte path; G = 3001 is no
    multiple of 4 or 32; neither bpm fills its last slab of 64 or 128 byte
    positions). X'w with the missing-code table and, on a tile without
    code 3, also without it; Xv with every third v zero, with 95% and 99.9%
    of v zero (rows the kernel never reads) and with every v zero. Then the
    whole sweep (30 groups of 4 blocks, missing codes, permuted rows) on the
    kernels against the plain versions with the same draws; the exact bf16
    Gram path against the f32 one; a short chain of run_st."""
    for n, missing in ((53, True), (4000, True), (4000, False)):
        rng = np.random.default_rng(n)
        p = 3001
        codes = rng.integers(0, 4 if missing else 3, size=(n, p)).astype(np.uint8)
        packed = torch.from_numpy(pack_codes(codes)).to(cuda)
        means = torch.rand(p, device=cuda) * 2
        perm = torch.from_numpy(rng.permutation(n)).to(cuda)
        w = gr.store_order(torch.randn(n, device=cuda), 4 * packed.shape[1], perm)
        atol = 1e-4 * n ** 0.5
        before = (packed_rhs.launches, packed_matvec.launches)
        want = packed_rhs_ref(packed, means, w)
        flags = (True,) if missing else (False, True)
        for flag in flags:
            torch.testing.assert_close(packed_rhs(packed, means, w, flag), want,
                                       rtol=1e-4, atol=atol)
        v_full = torch.randn(p, device=cuda)
        keep = torch.rand(p, device=cuda)
        third = v_full.clone()
        third[::3] = 0.0
        vs = [third] + [torch.where(keep >= share, v_full, torch.zeros_like(v_full))
                        for share in (0.0, 0.95, 0.999, 1.0)]
        assert (vs[-1] == 0).all()
        for v in vs:
            torch.testing.assert_close(packed_matvec(packed, means, v),
                                       packed_matvec_ref(packed, means, v),
                                       rtol=1e-4, atol=atol)
        assert (packed_rhs.launches, packed_matvec.launches) == (
            before[0] + len(flags), before[1] + len(vs))
    store = _store()
    obs = list(np.random.default_rng(1).permutation(store.obs_ids))
    b, gb = 8, 4
    perm = [store.obs_ids.index(s) for s in obs]
    gms = {d: gr.build_grouped_markers(store.packed, store.means, len(obs), b,
                                       gb, d, row_perm=perm)
           for d in ("cpu", cuda)}
    assert gms["cpu"].ngroups == 30
    torch.testing.assert_close(gms[cuda].grams.cpu(), gms["cpu"].grams,
                               rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(2)
    p_pad = gms["cpu"].xpx.shape[0]
    y = rng.normal(size=len(obs)).astype(np.float32)
    panels = {}

    def draws_on(device):
        def draws(g, r, reps):
            if (g, r) not in panels:
                panels[g, r] = (rng.uniform(size=(reps * b, gb)).astype(np.float32),
                                rng.normal(size=(reps * b, gb)).astype(np.float32))
            return tuple(torch.from_numpy(a).to(device) for a in panels[g, r])
        return draws

    out = {}
    for d in ("cpu", cuda):
        gm = gms[d]
        st = [torch.zeros(p_pad, device=d), torch.zeros(p_pad, device=d),
              torch.ones(p_pad, dtype=torch.int32, device=d),
              torch.from_numpy(y.copy()).to(d)]
        out[d] = gr.sweep_blocks_abc_grouped(
            gm, *st, torch.tensor(1.1, device=d), torch.tensor(0.01, device=d),
            torch.where(gm.valid > 0, 0.8, 1.0), None, nreps=3,
            sync_every=2, draws=draws_on(d))
    agree = (out[cuda][2].cpu() == out["cpu"][2]).float().mean().item()
    assert agree >= 0.99
    if agree == 1.0:
        for a, c in zip(out[cuda], out["cpu"]):
            torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-4)

    store = _store(missing=False)
    exact = gr.build_grouped_markers(store.packed, store.means, store.n_obs,
                                     8, 4, cuda, has_missing=False)
    f32 = gr.build_grouped_markers(store.packed, store.means, store.n_obs,
                                   8, 4, "cpu")
    torch.testing.assert_close(exact.grams.cpu(), f32.grams, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(exact.xpx.cpu(), f32.xpx, rtol=1e-4, atol=1e-3)

    store = _store(n=400, p=1000, missing=False)
    rng = np.random.default_rng(3)
    y = rng.normal(size=400)
    gm = setup_markers(store, store.obs_ids, cuda)
    res = run_st(gm, y, vare0=0.5, scale_R=0.25, df_R=4.0, marker_var0=0.001,
                 marker_scale0=0.0005, df_marker=4.0, pi0=0.9,
                 chain_length=256, burnin=64, seed=1)
    for k in ("vare", "varg", "pi"):
        assert np.isfinite(res[k])
    assert np.isfinite(res["ebv"]).all()


def test_runmcmc_on_card(cuda):
    """runMCMC on the card (a Table with 50 of 400 phenotypes missing, so
    those IDs are output only): its EBVs of the training IDs equal run_st's
    on the card from the same workspace (one chain loop; rtol 1e-5), and
    its EBVs are as accurate as the same run's on the CPU (another
    generator's stream, so an independent chain: accuracy against the
    simulated breeding values at most 0.05 lower, chip_smoke.py's
    margin)."""
    from jwas_tpu_torch import Table, build_model, get_genotypes, runMCMC
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace

    rng = np.random.default_rng(8)
    n, p = 400, 1000
    codes = rng.binomial(2, rng.uniform(0.1, 0.9, p), size=(n, p)).astype(np.uint8)
    means = codes.mean(axis=0)
    store = Packed2BitStore(
        obs_ids=[f"i{k}" for k in range(n)], marker_ids=[f"m{j}" for j in range(p)],
        packed=pack_codes(codes), means=means, allele_freq=means / 2, n_obs=n,
        n_markers=p, has_missing=False)
    bv = (codes - means) @ (rng.normal(size=p) * (rng.random(p) < 0.02))
    y = bv + rng.normal(0.0, bv.std(), n)
    y[rng.choice(n, 50, replace=False)] = np.nan
    order = rng.permutation(n)
    table = Table({"ID": np.array(store.obs_ids, dtype=object)[order], "y": y[order]})
    opts = dict(chain_length=512, burnin=128, seed=3, output_folder="",
                printout_model_info=False)

    def model():
        return build_model("y = intercept + geno",
                           genotypes=get_genotypes(store, storage="2bit"))

    before = abc_inner_rounds.launches
    out = {d: runMCMC(model(), table, device=d, **opts) for d in ("cpu", cuda)}
    assert abc_inner_rounds.launches > before
    ebv = {d: np.asarray(o["EBV_y"].EBV, dtype=np.float64) for d, o in out.items()}
    assert all(np.isfinite(e).all() and e.shape == (n,) for e in ebv.values())
    acc = {d: np.corrcoef(e, bv)[0, 1] for d, e in ebv.items()}
    assert acc[cuda] >= acc["cpu"] - 0.05, acc

    ws = prepare_workspace(model(), table, MCMCOptions(**opts))
    gm = setup_markers(store, ws.obs_ids, cuda)
    res = run_st(gm, ws.y, W=ws.W, vare0=ws.vare0, scale_R=ws.scale_R,
                 df_R=ws.df_R, marker_var0=ws.marker_var0,
                 marker_scale0=ws.marker_scale0, df_marker=ws.df_marker,
                 pi0=ws.pi0, chain_length=512, burnin=128, seed=3)
    row = {s: i for i, s in enumerate(out[cuda]["EBV_y"].ID)}
    np.testing.assert_allclose(ebv[cuda][[row[s] for s in ws.obs_ids]], res["ebv"],
                               rtol=1e-5, atol=1e-6)


def test_streamed_store_on_card(cuda, monkeypatch):
    """A store in pinned host memory, streamed through the ring of staging
    buffers with no resident group, and with half of its groups resident:
    BayesC, BayesB and BayesR chains equal the resident chain bit for bit
    (the same kernels read the same bytes). The copies are timed when
    recorded. A pageable host store, or a device store, refuses to stream."""
    store = _store(n=400, p=1000, missing=True)
    y = np.random.default_rng(4).normal(size=400)
    obs = list(np.random.default_rng(5).permutation(store.obs_ids))
    res = setup_markers(store, obs, cuda, fast_blocks=8)
    assert res.ngroups > 4 and res.store.shape[0] == 1000
    kw = dict(vare0=0.5, scale_R=0.25, df_R=4.0, marker_var0=0.01,
              marker_scale0=0.005, df_marker=4.0, chain_length=64, seed=2)
    keys = ("alpha", "ebv", "vare", "varg", "pi")
    want = {m: run_st(res, y, method=m, **kw) for m in ("BayesC", "BayesB", "BayesR")}
    pinned = Packed2BitStore(**{**store.__dict__,
                                "packed": gr.pinned_copy(store.packed)})
    b, G, bpm = res.grams.shape[1], res.fetch.G, res.store.shape[1]
    for k in (0, res.ngroups // 2):
        monkeypatch.setenv("JWAS_HBM_BYTES",
                           str(gr.hybrid_budget(k, res.ngroups, G, b, bpm)))
        gm = setup_markers(pinned, obs, cuda, fast_blocks=8, host_offload=True)
        assert gm.fetch.ring is not None and gm.fetch.resident == k
        assert gm.store.data_ptr() == pinned.packed.data_ptr()
        assert torch.equal(gm.grams, res.grams)
        gm.fetch.record = True
        for method, ref in want.items():
            got = run_st(gm, y, method=method, **kw)
            assert all(np.array_equal(got[key], ref[key]) for key in keys), (k, method)
        secs, nbytes = gm.fetch.copy_seconds()
        assert secs > 0 and nbytes > 0
    pageable = Packed2BitStore(**{**store.__dict__,
                                  "packed": torch.from_numpy(store.packed)})
    monkeypatch.setenv("JWAS_HBM_BYTES", str(gr.hybrid_budget(0, res.ngroups, G, b, bpm)))
    with pytest.raises(ValueError, match="pinned"):
        setup_markers(pageable, obs, cuda, fast_blocks=8, host_offload=True)
    on_card = Packed2BitStore(**{**store.__dict__,
                                 "packed": torch.from_numpy(store.packed).to(cuda)})
    with pytest.raises(ValueError, match="host memory"):
        setup_markers(on_card, obs, cuda, fast_blocks=8, host_offload=True)


def test_float64_kernels_and_single_block_chunks_match_plain(cuda):
    """The float64 builds of K1/K2 (per-marker variances) and K3 at a
    resident (b = 136) and a global (b = 256) tile, and K1 / K3 with
    nblocks = 1 and one rep at b = 256 and a ragged b = 160 (the exact
    sweep's chunks), in float32 and float64, against their plain versions
    on the card; their float64 launches are counted apart."""
    f64 = torch.float64
    for b, nblocks, nreps, dtype in ((136, 16, 2, f64), (256, 8, 2, f64),
                                     (256, 1, 1, torch.float32), (160, 1, 1, torch.float32),
                                     (256, 1, 1, f64), (160, 1, 1, f64)):
        k = {n: t.to(dtype) if t.is_floating_point() else t
             for n, t in _chain_inputs(nblocks, b, nreps, b + 1, cuda).items()}
        k["var_eff"] = 0.01 + 0.04 * torch.rand_like(k["var_eff"])
        r = {n: t.clone() for n, t in k.items()}
        before = abc_inner_rounds.launches_f64
        abc_inner_rounds(**k, nreps=nreps)
        abc_inner_rounds_ref(**r, nreps=nreps)
        torch.cuda.synchronize()
        assert abc_inner_rounds.launches_f64 == before + (dtype == f64)
        assert gram_resident(b, nreps, dtype=dtype) == (b <= (170 if dtype == f64 else 240))
        same = (k["delta"] == r["delta"]).all(dim=1)
        assert same.float().mean().item() >= 0.99, (b, dtype)
        for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("beta", 1e-5, 1e-6),
                                 ("rhs", 1e-4, 1e-5)):
            torch.testing.assert_close(k[name][same], r[name][same], rtol=rtol, atol=atol)
        q = {n: t.to(dtype) if t.is_floating_point() else t
             for n, t in _bayesr_inputs(nblocks, b, nreps, b + 2, cuda).items()}
        s = {n: t.clone() for n, t in q.items()}
        bayesr_inner_rounds(**q, nreps=nreps)
        bayesr_inner_rounds_ref(**s, nreps=nreps)
        torch.cuda.synchronize()
        same = (q["delta"] == s["delta"]).all(dim=1)
        assert same.float().mean().item() >= 0.99, (b, dtype)
        for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("rhs", 1e-4, 1e-5)):
            torch.testing.assert_close(q[name][same], s[name][same], rtol=rtol, atol=atol)
    bad = _chain_inputs(2, 16, 1, 1, cuda)
    bad["rhs"] = bad["rhs"].to(f64)
    with pytest.raises(ValueError):
        abc_inner_rounds(**bad, nreps=1)


def test_dense_chain_on_card_equals_the_plain_chain(cuda, monkeypatch):
    """A weighted dense store on the card (n = 300 of 360 genotyped
    individuals phenotyped, p = 900): run_st's grouped (b = 8) and exact
    (b = 128 chunks) BayesC chains and a grouped BayesR chain, in float32
    and float64, through the kernels and again through their plain
    versions on the same card with the same draws: the effects agree to
    rtol 1e-4 (the kernels follow the plain versions' rounding; expf / exp
    may differ by an ulp) and the kernels were launched."""
    import jwas_tpu_torch.ops.grouped as tg
    from jwas_tpu_torch import setup_dense_markers

    rng = np.random.default_rng(12)
    n_store, n, p = 360, 300, 900
    X = rng.binomial(2, rng.uniform(0.1, 0.9, p), size=(n_store, p)).astype(np.float64)
    X -= X.mean(axis=0)
    ids = [f"i{k}" for k in range(n_store)]
    rows = rng.permutation(n_store)[:n]
    y = X[rows] @ (rng.normal(size=p) * (rng.random(p) < 0.02)) + rng.normal(size=n)
    rinv = rng.uniform(0.5, 2.0, n)
    priors = dict(vare0=0.5, scale_R=0.25, df_R=4.0, marker_var0=0.01,
                  marker_scale0=0.005, df_marker=4.0)
    for dtype in (torch.float32, torch.float64):
        store = torch.as_tensor(np.ascontiguousarray(X.T), dtype=dtype, device=cuda)
        for fb, method in ((8, "BayesC"), (False, "BayesC"), (8, "BayesR")):
            gm = setup_dense_markers(store, ids, [ids[k] for k in rows], cuda,
                                     fast_blocks=fb, rinv=torch.as_tensor(rinv))
            runs = {}
            for plain in (False, True):
                if plain:
                    monkeypatch.setattr(tg, "abc_inner_rounds", abc_inner_rounds_ref)
                    monkeypatch.setattr(tg, "bayesr_inner_rounds", bayesr_inner_rounds_ref)
                launches = abc_inner_rounds.launches + bayesr_inner_rounds.launches
                runs[plain] = run_st(gm, y, **priors, method=method, chain_length=16,
                                     seed=5, pi0=0.0)
                launched = abc_inner_rounds.launches + bayesr_inner_rounds.launches > launches
                assert launched != plain, (fb, method, plain)
                monkeypatch.undo()
            a, b_ = runs[False]["alpha"], runs[True]["alpha"]
            assert a.dtype == b_.dtype == (np.float64 if dtype == torch.float64 else np.float32)
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b_, rtol=1e-4, atol=1e-5, err_msg=f"{fb} {method}")


def test_c0l_regime_kernels_and_exact_step_order_on_card(cuda):
    """K1/K2 in RR-BLUP's and BayesL's regime (ops/grouped.py::
    sweep_blocks_c0l_grouped: every real marker in the slab, pi 1e-10, zero
    uniforms, per-marker variances; the last 3 markers padding, held at 0
    by log(1 - pi) = -inf) at a global (b = 256) and a resident (b = 136)
    tile, in float32 and float64, against their plain versions; then the
    exact RR-BLUP and BayesL sweeps on a dense store on the card (K1 with
    nblocks = 1 a chunk of b = 128) against the step-by-step
    sweep_exact_c0l_ref on the same card and draws: alpha rtol 1e-4."""
    from jwas_tpu_torch.ops import dense as td

    for b, nblocks, nreps, dtype in ((256, 23, 2, torch.float32), (136, 16, 2, torch.float32),
                                     (256, 8, 2, torch.float64), (136, 16, 2, torch.float64)):
        k = {n: t.to(dtype) if t.is_floating_point() else t
             for n, t in _chain_inputs(nblocks, b, nreps, b + 3, cuda, "dense").items()}
        k["var_eff"] = 0.01 + 0.04 * torch.rand_like(k["var_eff"])
        k["us"].zero_()
        k["alpha"][-1, -3:] = 0.0
        r = {n: t.clone() for n, t in k.items()}
        before = abc_inner_rounds.launches
        abc_inner_rounds(**k, nreps=nreps)
        abc_inner_rounds_ref(**r, nreps=nreps)
        torch.cuda.synchronize()
        assert abc_inner_rounds.launches == before + 1
        assert int(k["delta"].sum()) == nblocks * b - 3, (b, dtype)
        assert bool((k["alpha"][-1, -3:] == 0).all()), (b, dtype)
        torch.testing.assert_close(k["delta"], r["delta"])
        for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("rhs", 1e-4, 1e-5)):
            torch.testing.assert_close(k[name], r[name], rtol=rtol, atol=atol)

    rng = np.random.default_rng(14)
    n, p = 150, 300
    X = rng.binomial(2, rng.uniform(0.1, 0.9, p), size=(n, p)).astype(np.float32)
    X -= X.mean(axis=0)
    dm = td.build_dense_markers(torch.from_numpy(np.ascontiguousarray(X.T)).to(cuda),
                                n, 128, 1, exact=True)
    pp = dm.valid.shape[0]
    y = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    zs = torch.as_tensor(rng.normal(size=p), dtype=torch.float32, device=cuda)
    vare, varg = (torch.tensor(v, device=cuda) for v in (1.1, 0.05))
    for bayesl in (False, True):
        gamma = None
        if bayesl:
            gamma = torch.ones(pp, device=cuda)
            gamma[:p] = torch.as_tensor(8.0 * rng.gamma(1.0, size=p), dtype=torch.float32)
        runs = []
        for kernel in (True, False):
            alpha, ycorr = torch.zeros(pp, device=cuda), y.clone()
            before = abc_inner_rounds.launches
            if kernel:
                gr.sweep_blocks_c0l_grouped(dm, alpha, ycorr, vare, varg, gamma, None,
                                            nreps=1, draws=td.sweep_draws(128, zs))
                assert abc_inner_rounds.launches == before + dm.ngroups
            else:
                td.sweep_exact_c0l_ref(dm, alpha, ycorr, vare, varg, gamma, zs)
            runs.append((alpha, ycorr))
        torch.cuda.synchronize()
        (a, yc), (ra, ryc) = runs
        assert bool((a[p:] == 0).all())
        torch.testing.assert_close(a, ra, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(yc, ryc, rtol=1e-4, atol=1e-4)


def _spd_lhs(K, seed, device, zero_rows=()):
    """An exactly symmetric, diagonally dominant K x K LHS (float64) with
    3K random couplings; zero_rows: levels with no records (their rows,
    columns and diagonals zero, which the pass skips)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    A = torch.zeros((K, K), dtype=torch.float64, device=device)
    i = torch.randint(0, K, (3 * K,), generator=g, device=device)
    j = torch.randint(0, K, (3 * K,), generator=g, device=device)
    A[i, j] = -torch.rand(3 * K, generator=g, device=device, dtype=torch.float64)
    A = torch.triu(A, 1)
    A = A + A.T
    A += torch.diag(A.abs().sum(dim=1) + 0.5)
    for r in zero_rows:
        A[r, :] = 0.0
        A[:, r] = 0.0
    return A


# K: phase 5's and GBLUP's 102, a random 2,000, phase 9a's 19,902, and the
# ragged edges of K6's slices of S = 160 (one level, 33, S - 1, S + 1, the
# largest K); zero diagonals at a slice's first and last rows
K6_CASES = {1: (), 33: (0, 32), 102: (), 159: (0, 158), 161: (159, 160), 2_000: (7, 160, 319),
            19_902: (), 20_480: (19_840, 20_479)}


@pytest.mark.parametrize("K", list(K6_CASES))
def test_gibbs_pass_kernel_matches_plain(cuda, K):
    """K6 (csrc/gibbs_pass.cu) against its plain version at K = 1 to
    20,480, zero-diagonal rows left as they were, in float32 and float64,
    with the same draws, one launch a call counted, a second launch on the
    same inputs equal bit for bit, and P = ceil(K / 160) blocks (more
    than one at K = 19,902). The products are summed in another order and
    pass through K dependent steps of a contraction: max |err| within 1e-5
    (float32) and 1e-12 (float64) of max |x|."""
    from jwas_tpu_torch.ops.location import gibbs_pass_lambda, gibbs_pass_lambda_ref

    zero_rows = K6_CASES[K]
    A64 = _spd_lhs(K, K, cuda, zero_rows=zero_rows)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x64 = torch.randn(K, generator=g, device=cuda, dtype=torch.float64)
    b64 = A64 @ torch.randn(K, generator=g, device=cuda, dtype=torch.float64)
    z64 = torch.randn(K, generator=g, device=cuda, dtype=torch.float64)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        A, x, b, zs = (t.to(dtype) for t in (A64, x64, b64, z64))
        vare = torch.tensor(1.3, dtype=dtype, device=cuda)
        n0, f0 = gibbs_pass_lambda.launches, gibbs_pass_lambda.launches_f64
        got = gibbs_pass_lambda(A, x, b, vare, None, zs=zs)
        torch.cuda.synchronize()
        assert gibbs_pass_lambda.launches == n0 + 1
        assert gibbs_pass_lambda.launches_f64 == f0 + (dtype == torch.float64)
        S, P = gibbs_pass_lambda.last_grid
        assert P == -(-K // S) and (K < 19_902 or P > 1)
        want = gibbs_pass_lambda_ref(A, x, b, vare, zs)
        err = (got - want).abs().max().item()
        assert err <= rtol * want.abs().max().item(), (K, dtype, err)
        for r in zero_rows:
            assert got[r] == x[r]
        for _ in range(3):
            assert torch.equal(gibbs_pass_lambda(A, x, b, vare, None, zs=zs), got)
        # the draws come from the chain's generator when none are given
        g1, g2 = (torch.Generator(device=cuda) for _ in range(2))
        g1.manual_seed(3)
        g2.manual_seed(3)
        a = gibbs_pass_lambda(A, x, b, vare, g1)
        z = torch.randn(K, generator=g2, dtype=dtype, device=cuda)
        assert torch.equal(a, gibbs_pass_lambda(A, x, b, vare, None, zs=z))


def test_pedigree_chain_on_card_equals_the_plain_chain(cuda, monkeypatch):
    """y = intercept + herd + ID + dam without genotypes (the herd i.i.d.,
    "ID dam" on a 220-animal pedigree with a 2 x 2 G) through runMCMC on
    the card, then with the location pass through K6's plain version on
    the same card and the same draws: the EBVs and the covariances'
    posterior means agree to rtol 1e-3 (the pass sums in another order;
    every draw has the same shape parameters, so the chains part only by
    rounding) and K6 was launched once an iteration."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.mcmc as em
    from jwas_tpu_torch.ops.location import gibbs_pass_lambda, gibbs_pass_lambda_ref

    rng = np.random.default_rng(4)
    ids = [f"a{i}" for i in range(220)]
    sire = ["0"] * 40 + [ids[rng.integers(0, 20) + 60 * (k // 60)] for k in range(180)]
    dam = ["0"] * 40 + [ids[rng.integers(20, 40) + 60 * (k // 60)] for k in range(180)]
    ped = jt.get_pedigree(jt.Table({"ID": ids, "S": sire, "D": dam}))
    pheno = jt.Table({"ID": ids[40:], "y": rng.normal(size=180),
                      "herd": [f"h{h}" for h in rng.integers(0, 6, 180)],
                      "dam": dam[40:]})

    def run():
        model = jt.build_model("y = intercept + herd + ID + dam")
        jt.set_random(model, "herd", 0.2)
        jt.set_random(model, "ID dam", ped, [[0.5, 0.1], [0.1, 0.3]])
        return jt.runMCMC(model, pheno, device=cuda, chain_length=30, seed=5,
                          output_folder="", printout_model_info=False)

    n0 = gibbs_pass_lambda.launches
    kernel = run()
    assert gibbs_pass_lambda.launches == n0 + 30

    def plain(A, x, b, vare, gen, zs=None):
        zs = torch.randn(x.shape[0], generator=gen, dtype=x.dtype, device=x.device)
        return gibbs_pass_lambda_ref(A, x, b, vare, zs)

    monkeypatch.setattr(em, "gibbs_pass_lambda", plain)
    reference = run()
    assert gibbs_pass_lambda.launches == n0 + 30
    for key, col in (("EBV_y", "EBV"), ("polygenic effects covariance matrix", "Estimate"),
                     ("random effect variances y:herd", "Estimate"),
                     ("residual variance", "Estimate")):
        got, want = np.asarray(kernel[key][col]), np.asarray(reference[key][col])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("sampler", ["I", "II"])
def test_mt_inner_rounds_kernels_match_plain(cuda, sampler):
    """K7 (sampler I) and K8 (sampler II) against their sequential plain
    versions on the card, float32 and float64: alpha, beta, delta and rhs
    equal bit for bit (the kernels round as the plain versions do and keep
    the sequential chain's order of the rhs additions) at t = 2, 3, 4, 5
    and 8, a shared and a per-locus Ginv, padding, a ragged b = 37, a
    single block with one rep (the exact form), b = 300 (two markers a
    thread), b = 700 (four), b = 256 over 23 blocks, dense and sparse; a
    second launch gives the same bits and padding markers stay at 0."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import mt_inputs
    from jwas_tpu_torch.ops import inner_rounds as ir
    from jwas_tpu_torch.ops.multitrait import mt_abc_inner_rounds_ref

    kernel = ir.mt_abc_inner_rounds_I if sampler == "I" else ir.mt_abc_inner_rounds_II
    for dtype in (torch.float32, torch.float64):
        for t, b, nblocks, nreps, per_locus, regime in (
                (2, 37, 5, 2, False, "dense"), (3, 37, 5, 2, True, "dense"),
                (4, 16, 1, 3, False, "dense"), (5, 40, 3, 1, True, "dense"),
                (8, 24, 2, 1, False, "dense"), (2, 256, 1, 1, False, "dense"),
                (3, 300, 2, 1, True, "sparse"), (3, 700, 1, 1, True, "dense"),
                (3, 256, 23, 1, False, "dense"),
                (3, 256, 23, 1, False, "sparse")):
            inp = mt_inputs(t, b, nblocks, nreps, sampler, per_locus, 7 + t, cuda, dtype,
                            regime=regime)
            outs = []
            for _ in range(2):
                a = {k: v.clone() for k, v in inp.items()}
                n0 = kernel.launches
                kernel(**{("us" if sampler == "I" else "gum") if k == "draw_a" else k: v
                          for k, v in a.items()}, nreps=nreps)
                assert kernel.launches == n0 + 1
                outs.append(a)
            r = {k: v.clone() for k, v in inp.items()}
            mt_abc_inner_rounds_ref(sampler, **r, nreps=nreps)
            torch.cuda.synchronize()
            case = (sampler, dtype, t, b, nblocks, regime)
            for k in ("alpha", "beta", "delta", "rhs"):
                assert torch.equal(outs[0][k], outs[1][k]), (case, k)
                assert torch.equal(outs[0][k], r[k]), (case, k)
            assert not outs[0]["alpha"][-1, :, -3:].any()
            assert not outs[0]["delta"][-1, :, -3:].any()


@pytest.mark.parametrize("sampler", ["I", "II"])
def test_mt_inner_rounds_per_marker_prior_matches_plain(cuda, sampler):
    """K7 and K8 with a per-marker pattern prior (csrc/mt_inner_rounds_pm.cu,
    log_pi (nblocks, b, 2^t)) against their plain versions on the card, bit
    for bit, float32 and float64, at t = 2 and 3, b = 40, 256, 300 and
    2,048, with and without padding; a second launch gives the same bits;
    rows that all equal a global prior give the global form's bits; t = 5
    is refused before a launch."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import mt_inputs
    from jwas_tpu_torch.ops import inner_rounds as ir
    from jwas_tpu_torch.ops.multitrait import mt_abc_inner_rounds_ref

    kernel = ir.mt_abc_inner_rounds_I if sampler == "I" else ir.mt_abc_inner_rounds_II
    state = ("alpha", "beta", "delta", "rhs")
    for dtype in (torch.float32, torch.float64):
        for t, b, nblocks, nreps, n_padding in ((2, 40, 5, 2, 3), (3, 40, 3, 2, 0),
                                                (2, 256, 3, 2, 0), (3, 256, 2, 1, 3),
                                                (3, 300, 2, 1, 5), (2, 2048, 1, 1, 3)):
            inp = mt_inputs(t, b, nblocks, nreps, sampler, False, 17 + t, cuda, dtype,
                            n_padding=n_padding, per_marker=True)
            assert inp["log_pi"].shape == (nblocks, b, 2 ** t)
            outs = []
            for _ in range(2):
                a = {k: v.clone() for k, v in inp.items()}
                n0 = kernel.launches_pm
                kernel(*a.values(), nreps)
                assert kernel.launches_pm == n0 + 1
                outs.append(a)
            r = {k: v.clone() for k, v in inp.items()}
            mt_abc_inner_rounds_ref(sampler, **r, nreps=nreps)
            torch.cuda.synchronize()
            case = (sampler, dtype, t, b, nblocks, n_padding)
            for k in state:
                assert torch.equal(outs[0][k], outs[1][k]), (case, k)
                assert torch.equal(outs[0][k], r[k]), (case, k)
            if n_padding:
                assert not outs[0]["alpha"][-1, :, -n_padding:].any()
        inp = mt_inputs(3, 256, 3, 2, sampler, False, 23, cuda, dtype)
        glob = {k: v.clone() for k, v in inp.items()}
        pm = {k: v.clone() for k, v in inp.items()}
        pm["log_pi"] = inp["log_pi"].expand(3, 256, 8).contiguous()
        kernel(*glob.values(), 2)
        kernel(*pm.values(), 2)
        for k in state:
            assert torch.equal(glob[k], pm[k]), (sampler, dtype, k)
    inp = mt_inputs(5, 40, 1, 1, sampler, False, 3, cuda, per_marker=False)
    inp["log_pi"] = inp["log_pi"].expand(1, 40, 32).contiguous()
    n0 = kernel.launches
    with pytest.raises(NotImplementedError, match="per-marker pattern prior above 4"):
        kernel(*inp.values(), 1)
    assert kernel.launches == n0


def test_mt_inner_rounds_block_limit(cuda):
    """At the largest block, b = MAX_BLOCK (eight markers a thread), K7 and
    K8 equal their plain versions bit for bit in float32 and float64; a
    block above it is refused with NotImplementedError before a launch."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import mt_inputs
    from jwas_tpu_torch.ops import inner_rounds as ir
    from jwas_tpu_torch.ops.multitrait import MAX_BLOCK, mt_abc_inner_rounds_ref

    for sampler in ("I", "II"):
        kernel = ir.mt_abc_inner_rounds_I if sampler == "I" else ir.mt_abc_inner_rounds_II
        for dtype in (torch.float32, torch.float64):
            inp = mt_inputs(2, MAX_BLOCK, 1, 1, sampler, True, 3, cuda, dtype)
            a = {k: v.clone() for k, v in inp.items()}
            kernel(*a.values(), 1)
            r = {k: v.clone() for k, v in inp.items()}
            mt_abc_inner_rounds_ref(sampler, **r, nreps=1)
            for k in ("alpha", "beta", "delta", "rhs"):
                assert torch.equal(a[k], r[k]), (sampler, dtype, k)
    t, b = 2, MAX_BLOCK + 8
    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    n0 = ir.mt_abc_inner_rounds_I.launches
    with pytest.raises(NotImplementedError, match="2,048 markers a block"):
        ir.mt_abc_inner_rounds_I(z(1, b, b), z(1, b), z(1, b), z(1, t, b), z(1, t, b),
                                 z(1, t, b), z(1, t, b), z(t, t), z(t, t), z(4),
                                 z(b, t, 1), z(b, t, 1), 1)
    assert ir.mt_abc_inner_rounds_I.launches == n0


def test_location_pass_limit_is_refused_on_the_card(cuda):
    """A model whose K is just above K6's limit on this card (read from the
    library for the device) is refused by prepare_workspace with a
    NotImplementedError naming K6, single-trait with sparse_location=False
    and multi-trait, before the design is made dense; at the limit's K the
    single-trait model passes the check."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine.setup import MCMCOptions, prepare_workspace
    from jwas_tpu_torch.ops.location import pass_limit

    limit = pass_limit(cuda)
    assert 0 < limit <= 20_480
    rng = np.random.default_rng(3)
    for eq, levels, K in (("y1 = intercept + x", limit, limit + 1),
                          ("y1 = intercept + x\ny2 = intercept + x", limit // 2,
                           2 * (1 + limit // 2))):
        assert K > limit
        table = jt.Table({"ID": np.array([f"a{i}" for i in range(levels)], dtype=object),
                          "y1": rng.normal(size=levels), "y2": rng.normal(size=levels),
                          "x": np.arange(levels)})
        with pytest.raises(NotImplementedError, match="K6"):
            jt.runMCMC(jt.build_model(eq), table, device=cuda, chain_length=2,
                       output_folder="", printout_model_info=False,
                       sparse_location=False)
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(limit - 1)], dtype=object),
                      "y1": rng.normal(size=limit - 1), "x": np.arange(limit - 1)})
    ws = prepare_workspace(jt.build_model("y1 = intercept + x"), table,
                           MCMCOptions(sparse_location=False, output_folder=""),
                           device=cuda)
    assert ws.W.shape[1] == limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mt_c0l_kernel_matches_plain(cuda, dtype):
    """K9, the multi-trait RR-BLUP / BayesL chain, against its plain version
    (ops/multitrait.py::mt_c0l_inner_rounds_ref) on the card: alpha and rhs
    equal bit for bit (the kernel rounds as the plain version does and adds
    the rhs changes in the sequential chain's order) at t = 2, 3, 4, 5 and
    8, b = 256 (one marker a thread), 264 (two; nine runs of 32 over eight
    warps, so that one warp owns two runs in a row), 700 (four) and 2,048
    (eight), RR-BLUP (gamma 1) and BayesL (a random gamma a marker), with padding
    markers (valid 0, zero Gram rows) that stay at 0; a second launch gives
    the same bits."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import k9_inputs
    from jwas_tpu_torch.ops.inner_rounds import mt_c0l_inner_rounds
    from jwas_tpu_torch.ops.multitrait import mt_c0l_inner_rounds_ref

    order = ("grams", "xpx", "valid", "alpha", "rhs", "Rinv", "Ginv", "gamma", "zs")
    for t in (2, 3, 4, 5, 8):
        for b, nblocks, nreps in ((256, 4, 2), (264, 1, 2), (700, 2, 1), (2048, 1, 1)):
            for bayesl in (False, True):
                inp = k9_inputs(t, b, nblocks, nreps, bayesl, 5 + t, cuda, dtype,
                                n_padding=5)
                outs = []
                for _ in range(2):
                    a = {k: v.clone() for k, v in inp.items()}
                    n0 = mt_c0l_inner_rounds.launches
                    mt_c0l_inner_rounds(*(a[k] for k in order), nreps)
                    assert mt_c0l_inner_rounds.launches == n0 + 1
                    outs.append(a)
                r = {k: v.clone() for k, v in inp.items()}
                mt_c0l_inner_rounds_ref(*(r[k] for k in order), nreps)
                torch.cuda.synchronize()
                case = (dtype, t, b, nblocks, bayesl)
                for k in ("alpha", "rhs"):
                    assert torch.equal(outs[0][k], outs[1][k]), (case, k)
                    assert torch.equal(outs[0][k], r[k]), (case, k)
                assert not outs[0]["alpha"][-1, :, -5:].any(), case


def test_mt_rr_blup_chain_on_card_equals_the_plain_chain(cuda, monkeypatch):
    """A short multi-trait RR-BLUP runMCMC on the card (K9, fast_blocks 16,
    a remainder round) against the same chain with K9's wrapper replaced by
    its plain version on the card: the same draws, the same results bit for
    bit."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.ops import inner_rounds as ir
    from jwas_tpu_torch.ops import multitrait as tmt

    rng = np.random.default_rng(4)
    n, p = 300, 160
    X = rng.integers(0, 3, (n, p)).astype(np.float32)
    beta = rng.normal(size=(p, 2)) * (rng.uniform(size=(p, 1)) < 0.1)
    y = (X - X.mean(0)) @ beta + rng.normal(size=(n, 2))
    table = jt.Table({"ID": np.array([f"a{i}" for i in range(n)], dtype=object),
                      "y1": y[:, 0], "y2": y[:, 1]})
    outs = {}
    n0 = ir.mt_c0l_inner_rounds.launches
    for how in ("kernel", "plain"):
        if how == "plain":
            assert ir.mt_c0l_inner_rounds.launches > n0
            monkeypatch.setattr(ir, "mt_c0l_inner_rounds", tmt.mt_c0l_inner_rounds_ref)
        geno = jt.get_genotypes(X, method="RR-BLUP", storage="f32", device=cuda)
        model = jt.build_model("y1 = intercept + geno\ny2 = intercept + geno",
                               genotypes=geno)
        outs[how] = jt.runMCMC(model, table, device=cuda, chain_length=40, fast_blocks=16,
                               nreps=6, sync_every=4, seed=3, output_folder="",
                               printout_model_info=False)
    for key, col in (("EBV_y1", "EBV"), ("EBV_y2", "EBV"), ("marker effects geno", "Estimate"),
                     ("residual variance", "Estimate")):
        got, want = np.asarray(outs["kernel"][key][col]), np.asarray(outs["plain"][key][col])
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want, err_msg=key)


# K10 (nind, ntimes, c, p): phase 14's shape and a ragged nind, one block
# with n < 64 individuals, 32 time points at c = 5, one time point at c = 1;
# p ragged against the chunk b (b = 64 at phase 14's shape, c = 3: 4 b + 1,
# and p < b)
K10_CASES = ((10_000, 10, 3, 256), (9_999, 10, 3, 128), (37, 3, 2, 64),
             (2_000, 32, 5, 64), (500, 1, 1, 100), (10_000, 10, 3, 257),
             (10_000, 10, 3, 37))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("estimate_delta", [True, False], ids=["BayesC", "RR-BLUP"])
def test_rrm_sweep_kernel_matches_plain(cuda, dtype, estimate_delta):
    """K10 against its plain version on the same inputs and draws
    (chip_smoke.check_k10's tolerances: tests/test_pallas_sweep.py:42-45 in
    float32, every delta equal in float64; a second launch bit for bit);
    in float64 also c = 5 over two chunks of its b and a ragged third;
    then above phase 14's herd (chip_smoke.K10_LARGE: 40,000 individuals
    to the most it takes), where a block's genotype rows of a chunk exceed
    its shared memory and are read in tiles of individuals, and nearer the
    edge the chunk b shrinks (to 1), the plan asserted from the launch."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from jwas_tpu_torch.ops.rrm import sweep_chunk

    for seed, (nind, ntimes, c, p) in enumerate(K10_CASES):
        chip_smoke.check_k10(nind, ntimes, c, p, cuda, dtype, estimate_delta, seed=60 + seed)
    if dtype == torch.float64:
        b = sweep_chunk(10_000, 10, 5, dtype, cuda)
        chip_smoke.check_k10(10_000, 10, 5, 2 * b + 7, cuda, dtype, estimate_delta, seed=59)
    chip_smoke.check_k10_large(cuda, dtype, estimate_delta, seed=70 if estimate_delta else 80)


def test_rrm_sweep_limits_on_the_card(cuda):
    """A block's slice above its shared memory, c above 5 and ntimes above
    32 are refused by sweep_limit_error (and so by the wrapper and at
    runMCMC's set-up)."""
    from jwas_tpu_torch.ops.rrm import sweep_limit_error

    assert sweep_limit_error(10_000, 10, 3, torch.float32, cuda) is None
    # the first design's edges (547,000 and 283,000 individuals at 10 time
    # points) are still taken
    assert sweep_limit_error(547_000, 10, 3, torch.float32, cuda) is None
    assert sweep_limit_error(283_000, 10, 3, torch.float64, cuda) is None
    assert "shared memory" in sweep_limit_error(5_000_000, 32, 3, torch.float64, cuda)
    assert "coefficients" in sweep_limit_error(100, 10, 6, torch.float32, cuda)
    assert "time points" in sweep_limit_error(100, 33, 3, torch.float32, cuda)


def test_rrm_chain_on_card_equals_the_plain_chain(cuda, monkeypatch):
    """runMCMC(RRM=Phi) on the card, float64, BayesC with an i.i.d.
    permanent-environment effect: K10 against the same chain with K10's
    wrapper replaced by its plain version on the card (the same draws from
    the same generator): the same results within 1e-8."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.engine import mcmc_rrm
    from jwas_tpu_torch.ops import rrm

    rng = np.random.default_rng(5)
    n, p, ntimes, c = 300, 120, 6, 3
    X = rng.binomial(2, rng.uniform(0.1, 0.9, p), size=(n, p)).astype(np.float64)
    times = np.arange(1.0, ntimes + 1)
    phi = jt.generate_full_phi(times, c)
    eff = rng.normal(size=(c, p)) * (rng.uniform(size=p) < 0.1)
    U = phi @ (eff @ (X - X.mean(0)).T)
    keep = rng.uniform(size=(ntimes, n)) >= 0.15
    t_idx, i_idx = np.nonzero(keep.T)[1], np.nonzero(keep.T)[0]
    y = 1.0 + 0.3 * times[t_idx] + U[t_idx, i_idx] + rng.normal(0, U.std(), len(t_idx))
    ids = np.array([f"i{k}" for k in range(n)], dtype=object)
    table = jt.Table({"ID": ids[i_idx], "time": times[t_idx], "y": y})

    def plain(X, phi, mpp, mask, alpha, W, vare, Ginv, log_pi, gen, estimate_delta=True,
              gumbel=None, zs=None, cross_grams=None):
        gumbel, zs = rrm.draw_sweep_normals(gen, X.shape[0], phi.shape[1], W, estimate_delta)
        return rrm.sweep_rrm_abc_ref(X, phi, mpp, mask, alpha, W, vare, Ginv, log_pi,
                                     gumbel, zs, estimate_delta)

    outs = {}
    n0 = rrm.sweep_rrm_abc.launches_f64
    for how in ("kernel", "plain"):
        if how == "plain":
            assert rrm.sweep_rrm_abc.launches_f64 > n0
            monkeypatch.setattr(mcmc_rrm, "sweep_rrm_abc", plain)
        geno = jt.get_genotypes(X, method="BayesC", device=cuda, double_precision=True)
        geno.obs_ids = list(ids)
        model = jt.build_model("y = intercept + time + ID + geno", genotypes=geno)
        jt.set_covariate(model, "time")
        jt.set_random(model, "ID", 0.5)
        outs[how] = jt.runMCMC(model, table, device=cuda, chain_length=60, burnin=10,
                               output_samples_frequency=5, seed=3, RRM=phi,
                               double_precision=True, output_folder="",
                               printout_model_info=False)
    for key, col in (("EBV_trajectory", "EBV"), ("marker effects geno", "Estimate"),
                     ("residual variance", "Estimate"), ("pi_geno", "Estimate"),
                     ("random effect variances y:ID", "Estimate")):
        got, want = np.asarray(outs["kernel"][key][col]), np.asarray(outs["plain"][key][col])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10, err_msg=key)


def _gwas_inputs(tmp_path, n=600, p=1200, S=12, seed=19):
    """A 2-bit store, a marker-effect sample file (sparse draws), a rolled
    copy of it and a map of 3 chromosomes, 1 Mb windows of ~25 markers."""
    rng = np.random.default_rng(seed)
    codes = rng.binomial(2, rng.uniform(0.1, 0.9, p), size=(n, p)).astype(np.uint8)
    codes[rng.random((n, p)) < 0.01] = 3                      # missing codes
    known = np.where(codes == 3, np.nan, codes)
    means = np.nanmean(known, axis=0)
    store = Packed2BitStore(
        obs_ids=[f"i{k}" for k in range(n)], marker_ids=[f"m{j}" for j in range(p)],
        packed=pack_codes(codes), means=means, allele_freq=means / 2, n_obs=n,
        n_markers=p, has_missing=True)
    samples = rng.normal(size=(S, p)) * (rng.random((S, p)) < 0.1)
    files = []
    for k, rows in enumerate((samples, np.roll(samples, 1, axis=0))):
        path = str(tmp_path / f"MCMC_samples_marker_effects_geno_y{k}.txt")
        with open(path, "w") as f:
            f.write(",".join(store.marker_ids) + "\n")
            f.writelines(",".join(repr(float(v)) for v in r) + "\n" for r in rows)
        files.append(path)
    j = np.arange(p)
    map_path = str(tmp_path / "map.csv")
    with open(map_path, "w") as f:
        f.write("id,chr,pos\n")
        f.writelines(f"m{i},{i // 400 + 1},{(i % 400) * 40_000 + 1}\n" for i in j)
    return store, files, map_path


def test_gwas_on_card_against_cpu(cuda, tmp_path):
    """GWAS on the card against the CPU, as chip_smoke.py's phase 15c holds
    it: prGenVar and the variance proportions within rtol 1e-4, atol 1e-6;
    WPPA equal but where a proportion lies within 1e-5 (relative) of the
    threshold (1/S a such sample); local EBVs within atol 1e-4; the
    correlation's columns within rtol 1e-4, atol 1e-6; with the store's
    bytes on the host and on the card."""
    import jwas_tpu_torch as jt

    store, (f, f2), map_path = _gwas_inputs(tmp_path)
    on_card = Packed2BitStore(**{**store.__dict__,
                                 "packed": torch.as_tensor(store.packed).to(cuda)})
    for sliding in (False, True):
        ref = jt.GWAS(None, map_path, f, genotypes=store, sliding_window=sliding,
                      output_winVarProps=True, local_EBV=True, device="cpu")
        for geno in (store, on_card):
            got = jt.GWAS(None, map_path, f, genotypes=geno, sliding_window=sliding,
                          output_winVarProps=True, local_EBV=True, device=cuda)
            np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)
            o, oc = np.argsort(got[0]["window"]), np.argsort(ref[0]["window"])
            np.testing.assert_allclose(np.asarray(got[0]["prGenVar"])[o],
                                       np.asarray(ref[0]["prGenVar"])[oc], rtol=1e-4,
                                       atol=1e-6)
            near = (np.abs(ref[1] - 0.001) <= 1e-5 * 0.001).sum(axis=1)
            w = np.asarray(ref[0]["window"])[oc] - 1
            diff = np.abs(np.asarray(got[0]["WPPA"])[o] - np.asarray(ref[0]["WPPA"])[oc])
            assert (diff <= near[w] / ref[1].shape[1] + 1e-12).all()
            for c in ref[2].columns:
                np.testing.assert_allclose(got[2][c], ref[2][c], atol=1e-4)
    ref = jt.GWAS(None, map_path, [f, f2], genotypes=store, genetic_correlation=True,
                  device="cpu")
    got = jt.GWAS(None, map_path, [f, f2], genotypes=on_card, genetic_correlation=True,
                  device=cuda)
    for c in ("estimate_cov", "std_cov", "estimate_cor", "std_cor"):
        np.testing.assert_allclose(got[c], ref[c], rtol=1e-4, atol=1e-6)


def test_loocv_on_card_against_cpu(cuda):
    """LOOCV's two branches in float64 on the card within 1e-8 (relative to
    the largest residual) of the CPU's."""
    import jwas_tpu_torch as jt

    rng = np.random.default_rng(20)
    for n, p in ((400, 60), (150, 500)):
        X = rng.binomial(2, 0.4, size=(n, p)).astype(np.float64)
        y = X @ (rng.normal(size=p) * 0.1) + rng.normal(size=n)
        got = jt.LOOCV(X, y, 0.05, 1.0, verbose=False, device=cuda)
        ref = jt.LOOCV(X, y, 0.05, 1.0, verbose=False, device="cpu")
        assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()


def test_several_chains_on_card(cuda):
    """Two chains on the card: chain k's EBVs equal a single chain seeded
    seed + k on the card (the chains share the store and Grams), and the
    pooled EBVs are the mean of the two within 1e-5."""
    import jwas_tpu_torch as jt

    rng = np.random.default_rng(21)
    n, p = 300, 500
    codes = rng.binomial(2, rng.uniform(0.1, 0.9, p), size=(n, p)).astype(np.uint8)
    means = codes.mean(axis=0)
    store = Packed2BitStore(
        obs_ids=[f"i{k}" for k in range(n)], marker_ids=[f"m{j}" for j in range(p)],
        packed=pack_codes(codes), means=means, allele_freq=means / 2, n_obs=n,
        n_markers=p, has_missing=False)
    y = (codes - means) @ (rng.normal(size=p) * (rng.random(p) < 0.05))
    table = jt.Table({"ID": np.array(store.obs_ids, dtype=object),
                      "y": y + rng.normal(0.0, y.std(), n)})
    run = dict(chain_length=64, burnin=16, output_samples_frequency=8, fast_blocks=8,
               output_folder="", printout_model_info=False, device=cuda)

    def model():
        return jt.build_model("y = intercept + geno",
                              genotypes=jt.get_genotypes(store, storage="2bit"))

    multi = jt.runMCMC(model(), table, seed=4, n_chains=2, **run)
    singles = [np.asarray(jt.runMCMC(model(), table, seed=4 + k, **run)["EBV_y"].EBV,
                          dtype=np.float64) for k in range(2)]
    np.testing.assert_allclose(np.asarray(multi["EBV_y"].EBV, dtype=np.float64),
                               np.mean(singles, axis=0), rtol=1e-5, atol=1e-5)
    assert np.isfinite(multi["PSRF"]["PSRF"]).all()
