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
        w = gr.pad_w(torch.randn(n, device=cuda), packed.shape[1], perm)
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
