#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jwas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. the card (nvidia-smi name and power limit) and the nvcc build of the
     kernels under jwas_tpu_torch/csrc/;
  2. each kernel against its plain PyTorch version on identical inputs on
     the card, with the tolerance stated, both times and the kernel's bound
     (the larger of its bytes over 3.35 TB/s and its operations over
     67 TFLOP/s float32, H100 SXM); the chain kernels K1 and K3 also in the
     main path's three regimes at its shape (every step changes an effect,
     almost none does, the default BayesR class prior from alpha = 0), with
     ns a dependent step, the share of the steps that changed an effect and
     the evaluations a window of 32 markers, and at ragged and large block
     sizes;
  3. the main paths at full width: a 2-bit store of N = 50,000 x
     P = 2,097,152 generated on the device, its Gram tiles, then run_st
     (single-trait, b = 128, gb = 128, nreps = 128, sync_every = 8) for
     three outer iterations of BayesC and then of BayesR on the same store
     and Grams, with the launch count of every kernel in each path;
  4. a statistical check: a small simulation run through run_st, BayesC
     on the card and on the CPU (plain versions), BayesR on the card; EBV
     accuracy must hold. Then runMCMC on the same data through a Table:
     its EBVs must equal run_st's on the card;
  5. runMCMC, the user's entry point, at full width: phase 3's device store
     (its Gram tiles freed) as a Packed2BitStore, 45,000 of its 50,000
     individuals phenotyped in shuffled order with a 100-level herd factor
     and an age covariate, the other 5,000 prediction candidates;
     y = intercept + herd + age + geno, BayesC, fast_blocks = 128, three
     outer iterations, result and sample files written to a temporary
     folder. Set-up and chain seconds, peak memory, launches, samples, EBV
     accuracy of candidates and training individuals, herd estimates
     against the true herd effects;
  6. (a) runMCMC BayesB on phase 5's data at runMCMC's default block size
     (b = 136, gb = 128: 121 groups, the last one short and served from a
     zero-padded copy of its rows), three outer iterations on the same
     device store, used in place, peak memory within store + Grams + 4 GB;
     (b) BayesC through runMCMC on phase 3's problem at fast_blocks = 128,
     the store resident, then streamed from a pinned host copy with no group
     and with half of the groups on the card, each of the two twice, in the
     order streamed, hybrid, hybrid, streamed: the chains equal bit for bit;
     seconds per outer iteration, the copies' GB/s and, from a profiled
     chain, the device's busy share and the share of the copies' device
     time during which a kernel ran.

Then one JSON line with the kernels, the card's line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Imports torch and numpy and the port; never jax or jwas_tpu.
"""

import bisect
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ATOL_GEMV = 1e-4      # x sqrt(n): an f32 sum of n terms of size ~1
RTOL_GEMV = 1e-4
DELTA_AGREE = 0.999   # K1: inclusion indicators equal on >= 99.9% of markers
# EBV accuracy of jwas_tpu.runMCMC on the phase-4 data, measured on the CPU
# with the same chain settings and seed 5, was 0.7043 (seeds 6, 7: 0.6982,
# 0.7119); the floor is that minus 0.1
ACC_FLOOR = 0.6043
ACC_MARGIN = 0.05     # kernel path may trail the plain path by at most this
# EBV accuracy of jwas_tpu.runMCMC BayesR (storage='2bit', default class
# prior) on the phase-4 data, measured on the CPU with the same chain
# settings, seeds 5, 6, 7: 0.9327, 0.9389, 0.9490; the floor is the lowest
# minus 0.1
ACC_FLOOR_BAYESR = 0.8327
RTOL_RUNMCMC = 1e-5   # phase 4: runMCMC's EBVs against run_st's, same chain
# phase 5: the posterior mean EBV (float32 sums of 2M terms a sample)
# against X times the posterior mean effects in float64, relative to the
# largest of them
RTOL_DIRECT_EBV = 1e-3
PHASE5_KEYS = ("location parameters", "residual variance", "marker effects geno",
               "marker effects variances geno", "pi_geno", "EBV_y",
               "genetic_variance", "heritability")

REPLACES = {
    "abc_inner_rounds": "jwas_tpu/ops/pallas_sweep.py:68",
    "bayesr_inner_rounds": "jwas_tpu/ops/pallas_sweep.py:327",
    "packed_rhs": "jwas_tpu/ops/pallas_packed_gemv.py:55",
    "packed_matvec": "jwas_tpu/ops/pallas_packed_gemv.py:105",
}
SOURCES = {
    "abc_inner_rounds": "jwas_tpu_torch/csrc/abc_inner_rounds.cu",
    "bayesr_inner_rounds": "jwas_tpu_torch/csrc/bayesr_inner_rounds.cu",
    "packed_rhs": "jwas_tpu_torch/csrc/packed_gemv.cu",
    "packed_matvec": "jwas_tpu_torch/csrc/packed_gemv.cu",
}


def say(*args):
    print(*args, flush=True)


HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12             # float32 outside the tensor cores


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over iters calls, after one warm-up.
    The device first spins ~10 ms while the host queues the launches, so a
    short kernel's time is the device's and not the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2


def chain_bounds(inp, written, b, nblocks, nreps):
    """Roofline bound of one inner-rounds call (every input read once, the
    updated arrays written once; a step's rank-1 update of 2 b operations
    and ~20 for the marker itself). The chain of nreps * b dependent steps
    keeps a call far above it: the line prints the measured time a step."""
    nbytes = sum(t.numel() * t.element_size() for t in inp.values())
    nbytes += sum(inp[k].numel() * inp[k].element_size() for k in written)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nreps * b * nblocks * (2 * b + 20) / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


K1_REGIMES = {
    # pi0 (the sweep clamps it to [1e-10, 1], ops/grouped.py), effects start at 0
    "mixed": (0.9, False),     # random effects, a third of the steps change one
    "dense": (0.0, False),     # every marker is included: every step changes
    "sparse": (0.999, True),   # from alpha = 0: almost no step changes
}


def k1_inputs(n, b, nblocks, nreps, seed, dev, regime="mixed", per_marker=False):
    """Random Gram tiles of n-observation blocks and a chain state of one of
    K1_REGIMES; per_marker: one variance a marker (BayesB), else 0.02 for
    every marker."""
    pi0, from_zero = K1_REGIMES[regime]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((nblocks, b, n), generator=g, device=dev)
    grams = torch.bmm(x, x.transpose(1, 2))
    xpx = torch.diagonal(grams, dim1=1, dim2=2).contiguous()
    rhs = torch.bmm(x, torch.randn((nblocks, n, 1), generator=g, device=dev))[..., 0]
    alpha = 0.1 * torch.randn((nblocks, b), generator=g, device=dev)
    if from_zero:
        alpha.zero_()
    pi = torch.clamp(torch.full((nblocks, b), pi0, device=dev), 1e-10, 1.0)
    return dict(
        grams=grams, xpx=xpx,
        var_eff=(0.005 + 0.03 * torch.rand((nblocks, b), generator=g, device=dev)
                 if per_marker else torch.full((nblocks, b), 0.02, device=dev)),
        log_pi=torch.log(pi), log_pi_comp=torch.log1p(-pi + 1e-12),
        alpha=alpha, beta=alpha.clone(),
        delta=(alpha != 0).to(torch.int32),
        rhs=rhs.contiguous(),
        us=torch.rand((nreps * b, nblocks), generator=g, device=dev),
        zs=torch.randn((nreps * b, nblocks), generator=g, device=dev),
        inv_vare=torch.tensor([1.0 / 1.3], device=dev),
    )


def window_stats(window_ref, inp, outs, plain, nreps):
    """Share of the steps that changed an effect and evaluations a window,
    counted by the plain model of the kernels' schedule (ops/inner_rounds.py)
    on the same inputs; its outputs must equal the step-by-step plain
    version's, `plain`, to the last bit."""
    w = {k: v.clone() for k, v in inp.items()}
    stats = {}
    window_ref(**w, nreps=nreps, stats=stats)
    for k in outs:
        if not torch.equal(w[k], plain[k]):
            raise AssertionError(f"window model and plain version part in {k}")
    nblocks, b = inp["xpx"].shape
    return dict(changed_share=stats["changes"] / (nreps * b * nblocks),
                evals_per_window=stats["evaluations"] / stats["windows"])


def chain_line(rec, ms, plain, stats, steps):
    """The timing part of a K1/K3 line; fills rec."""
    rec.update(ms=ms, plain_ms=plain, step_ns=ms * 1e6 / steps)
    line = (f"; kernel {ms:.4f} ms ({rec['step_ns']:.1f} ns a dependent step), "
            f"plain {plain:.2f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    if stats:
        rec.update(stats)
        line += (f"; {stats['changed_share']:.2%} of the steps changed an "
                 f"effect, {stats['evals_per_window']:.2f} evaluations a window")
    return line


def check_k1(n, b, nblocks, nreps, dev, time_it, regime="mixed", per_marker=False):
    from jwas_tpu_torch.ops.inner_rounds import (abc_inner_rounds,
                                                 abc_inner_rounds_ref,
                                                 abc_inner_rounds_window_ref,
                                                 gram_resident)

    inp = k1_inputs(n, b, nblocks, nreps, 7, dev, regime, per_marker)
    fresh = lambda: {k: v.clone() for k, v in inp.items()}  # noqa: E731
    a = fresh()
    abc_inner_rounds(**a, nreps=nreps)
    r = fresh()
    abc_inner_rounds_ref(**r, nreps=nreps)
    torch.cuda.synchronize()
    same = a["delta"] == r["delta"]
    agree = same.float().mean().item()
    ok_blocks = same.all(dim=1)          # blocks whose chains never parted
    err = 0.0
    for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("beta", 1e-5, 1e-6),
                             ("rhs", 1e-4, 1e-5)):
        x, y = a[name][ok_blocks], r[name][ok_blocks]
        err = max(err, (x - y).abs().max().item())
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol)
    if agree < DELTA_AGREE:
        raise AssertionError(f"K1 b={b}: delta agreement {agree:.5f} < {DELTA_AGREE}")
    line = (f"K1 {regime}{' per-marker var_eff' if per_marker else ''} b={b} "
            f"nblocks={nblocks} reps={nreps} "
            f"gram={'resident' if gram_resident(b, nreps) else 'global'}: "
            f"delta agree {agree:.6f}, max |err| {err:.3g} "
            f"(alpha/beta rtol 1e-5 atol 1e-6, rhs rtol 1e-4 atol 1e-5)")
    rec = None
    if time_it:
        a = fresh()
        ms = cuda_ms(lambda: abc_inner_rounds(**a, nreps=nreps), 20)
        t = fresh()
        plain = cuda_ms(lambda: abc_inner_rounds_ref(**t, nreps=nreps), 1)
        rec = dict(max_abs_err=err,
                   **chain_bounds(inp, ("alpha", "beta", "delta", "rhs"), b,
                                  nblocks, nreps))
        stats = None
        if regime != "mixed":
            stats = window_stats(abc_inner_rounds_window_ref, inp,
                                 ("alpha", "beta", "delta", "rhs"), r, nreps)
        line += chain_line(rec, ms, plain, stats, nreps * b)
    say(line)
    return rec


def k3_inputs(n, b, nblocks, nreps, seed, dev, from_zero=False):
    """Random Gram tiles of n-observation blocks, the default class prior,
    a few markers in each slab class (none when from_zero: every effect
    starts at 0, as a chain does), and the last 3 markers padding (zero
    Gram rows, xpx 1, rhs 0, class prior [1, 0, 0, 0])."""
    from jwas_tpu_torch.engine.mcmc import DEFAULT_BAYESR_PI
    from jwas_tpu_torch.ops.grouped import gumbel_panel

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((nblocks, b, n), generator=g, device=dev)
    x[-1, -3:] = 0.0
    grams = torch.bmm(x, x.transpose(1, 2))
    xpx = torch.diagonal(grams, dim1=1, dim2=2).contiguous()
    xpx[-1, -3:] = 1.0
    rhs = torch.bmm(x, torch.randn((nblocks, n, 1), generator=g, device=dev))[..., 0]
    pi = torch.tensor(DEFAULT_BAYESR_PI, device=dev).expand(nblocks, b, 4).clone()
    pi[-1, -3:] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    cum = torch.cumsum(torch.tensor(DEFAULT_BAYESR_PI, device=dev), 0)
    u = torch.rand((nblocks, b), generator=g, device=dev)
    delta = (u[..., None] > cum[:3]).sum(-1).to(torch.int32)
    delta[-1, -3:] = 0
    if from_zero:
        delta.zero_()
    alpha = torch.where(delta > 0, 0.1 * torch.randn((nblocks, b), generator=g,
                                                      device=dev), 0.0)
    return dict(
        grams=grams, xpx=xpx, log_pi=torch.log(torch.clamp(pi, 1e-12, 1.0)),
        alpha=alpha, delta=delta, rhs=rhs.contiguous(),
        gumbel=gumbel_panel((nreps * b, nblocks, 4), g, dev),
        zs=torch.randn((nreps * b, nblocks), generator=g, device=dev),
        inv_vare=torch.tensor([1.0 / 1.3], device=dev),
        # class 3 (variance sigma^2) explains ~n / 1.3 * sigma^2 of a
        # marker's rhs variance: a few percent land in classes 1-3
        sigma_sq=torch.tensor([0.5 / n], device=dev),
    )


def check_k3(n, b, nblocks, nreps, dev, time_it, from_zero=False):
    from jwas_tpu_torch.ops.inner_rounds import (bayesr_inner_rounds,
                                                 bayesr_inner_rounds_ref,
                                                 bayesr_inner_rounds_window_ref,
                                                 gram_resident)

    inp = k3_inputs(n, b, nblocks, nreps, 9, dev, from_zero)
    fresh = lambda: {k: v.clone() for k, v in inp.items()}  # noqa: E731
    a = fresh()
    bayesr_inner_rounds(**a, nreps=nreps)
    r = fresh()
    bayesr_inner_rounds_ref(**r, nreps=nreps)
    torch.cuda.synchronize()
    same = a["delta"] == r["delta"]
    agree = same.float().mean().item()
    ok_blocks = same.all(dim=1)          # blocks whose chains never parted
    err = 0.0
    for name, rtol, atol in (("alpha", 1e-5, 1e-6), ("rhs", 1e-4, 1e-5)):
        x, y = a[name][ok_blocks], r[name][ok_blocks]
        err = max(err, (x - y).abs().max().item())
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol)
    if agree < DELTA_AGREE:
        raise AssertionError(f"K3 b={b}: class agreement {agree:.5f} < {DELTA_AGREE}")
    if not ((a["delta"][-1, -3:] == 0).all() and (a["alpha"][-1, -3:] == 0).all()):
        raise AssertionError(f"K3 b={b}: a padded marker left class 0")
    exact = all(torch.equal(a[k], r[k]) for k in ("alpha", "delta", "rhs"))
    shares = torch.bincount(a["delta"].view(-1).long(), minlength=4).float()
    shares = (shares / shares.sum()).tolist()
    line = (f"K3 {'from alpha = 0 ' if from_zero else ''}b={b} nblocks={nblocks} "
            f"reps={nreps} "
            f"gram={'resident' if gram_resident(b, nreps, 'BayesR') else 'global'}: "
            f"class agree {agree:.6f}, max |err| {err:.3g} (alpha rtol 1e-5 "
            f"atol 1e-6, rhs rtol 1e-4 atol 1e-5; bit for bit: {exact}); class "
            f"shares {', '.join(f'{x:.4f}' for x in shares)}")
    rec = None
    if time_it:
        a = fresh()
        ms = cuda_ms(lambda: bayesr_inner_rounds(**a, nreps=nreps), 20)
        t = fresh()
        plain = cuda_ms(lambda: bayesr_inner_rounds_ref(**t, nreps=nreps), 1)
        rec = dict(max_abs_err=err,
                   **chain_bounds(inp, ("alpha", "delta", "rhs"), b, nblocks,
                                  nreps))
        stats = None
        if from_zero:
            stats = window_stats(bayesr_inner_rounds_window_ref, inp,
                                 ("alpha", "delta", "rhs"), r, nreps)
        line += chain_line(rec, ms, plain, stats, nreps * b)
    say(line)
    return rec


def check_gemv(n, G, dev, missing, permuted, time_it):
    """K4 and K5 against their plain versions on one tile: K4 with the
    missing-code table and, on a tile without code 3, also without it; K5
    with none, 95%, 99.9% and all of v zero. A last slab of K4 is ragged
    whenever ceil(n / 4) is no multiple of 128 (or 64), as at every shape
    here."""
    from jwas_tpu_torch.ops import packed_gemv as pg
    from jwas_tpu_torch.ops.grouped import _decode_codes, pad_w, unpad

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bpm = (n + 3) // 4
    codes = torch.randint(0, 4 if missing else 3, (G, bpm, 4), generator=g,
                          device=dev, dtype=torch.uint8)
    codes.view(G, -1)[:, n:] = 0     # sub-byte padding, as the packer writes
    rows = (codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4)
            | (codes[..., 3] << 6))
    del codes
    means = 2.0 * torch.rand(G, generator=g, device=dev)
    perm = torch.randperm(n, generator=g, device=dev) if permuted else None
    w = torch.randn(n, generator=g, device=dev)
    v_full = torch.randn(G, generator=g, device=dev)
    keep = torch.rand(G, generator=g, device=dev)
    w_pad = pad_w(w, bpm, perm)
    atol = ATOL_GEMV * n ** 0.5

    def err_of(got, want):
        torch.testing.assert_close(got, want, rtol=RTOL_GEMV, atol=atol)
        return (got - want).abs().max().item()

    rhs_p = pg.packed_rhs_ref(rows, means, w_pad)
    flags = (True,) if missing else (False, True)
    err_rhs = max(err_of(pg.packed_rhs(rows, means, w_pad, f), rhs_p)
                  for f in flags)
    vs = {share: torch.where(keep >= share, v_full, torch.zeros_like(v_full))
          for share in (*pg.ZERO_SHARES, 1.0)}
    err_mv = max(err_of(unpad(pg.packed_matvec(rows, means, v), n, perm),
                        unpad(pg.packed_matvec_ref(rows, means, v), n, perm))
                 for v in vs.values())
    say(f"K4/K5 n={n} G={G} missing={missing} row_perm={permuted}: "
        f"max |err| X'w {err_rhs:.3g} (missing table {flags}), Xv {err_mv:.3g} "
        f"(v zero shares {list(vs)}) (rtol {RTOL_GEMV}, atol "
        f"{ATOL_GEMV}*sqrt(n) = {atol:.3g})")
    if not time_it:
        return None

    # the yardstick no path calls: one torch.mv on the decoded float32 tile
    m = means[:, None]
    x = _decode_codes(rows, n, perm).to(torch.float32)
    x = torch.where(x == 3.0, m, x) - m
    err_of(torch.mv(x, w), rhs_p)
    mv_ms = {"packed_rhs": cuda_ms(lambda: torch.mv(x, w), 5),
             "packed_matvec": cuda_ms(lambda: torch.mv(x.T, v_full), 5)}
    del x
    out = {}
    ms = cuda_ms(lambda: pg.packed_rhs(rows, means, w_pad, False), 20)
    out["packed_rhs"] = dict(
        max_abs_err=err_rhs, ms=ms,
        ms_missing_table=cuda_ms(lambda: pg.packed_rhs(rows, means, w_pad, True), 20),
        plain_ms=cuda_ms(lambda: pg.packed_rhs_ref(rows, means, w_pad), 3),
        bound_ms=pg.bound_ms(G, bpm, G))
    sparse = {}
    for share in pg.ZERO_SHARES:
        v = vs[share]
        nnz = int((v != 0).sum())
        sparse[f"{share:.1%}"] = dict(
            nnz=nnz, ms=cuda_ms(lambda: pg.packed_matvec(rows, means, v), 20),
            bound_ms=pg.bound_ms(G, bpm, nnz))
    dense = sparse.pop(f"{pg.ZERO_SHARES[0]:.1%}")
    out["packed_matvec"] = dict(
        max_abs_err=err_mv, ms=dense["ms"],
        plain_ms=cuda_ms(lambda: pg.packed_matvec_ref(rows, means, v_full), 3),
        bound_ms=dense["bound_ms"], zero_rows=sparse)
    for name, rec in out.items():
        rec.update(bound_by="bytes", library_ms=None, decoded_mv_ms=mv_ms[name])
        say(f"  {name}: kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"(bytes; {rec['bound_ms'] / rec['ms']:.1%} of it reached), plain "
            f"{rec['plain_ms']:.3f} ms; no PyTorch call takes the packed tile "
            f"(library_ms null), torch.mv on the decoded float32 tile "
            f"{mv_ms[name]:.3f} ms")
    say(f"  packed_rhs with the missing-code table: "
        f"{out['packed_rhs']['ms_missing_table']:.4f} ms")
    for share, r in sparse.items():
        say(f"  packed_matvec, {share} of v zero ({r['nnz']} rows read): kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of it reached)")
    return out


def phase2(dev):
    say("== phase 2: kernels against their plain versions on the card")
    check_k1(64, 8, 256, 3, dev, time_it=False)    # tests/test_pallas_sweep.py:21
    recs = {"abc_inner_rounds": check_k1(512, 128, 128, 8, dev, time_it=True)}
    # the path's two BayesC regimes at its shape: pi0 = 0 and pi0 = 0.999
    regimes = {r: check_k1(512, 128, 128, 8, dev, time_it=True, regime=r)
               for r in ("dense", "sparse")}
    recs["abc_inner_rounds"]["regimes"] = regimes
    check_k1(512, 256, 64, 2, dev, time_it=True)   # global-memory Gram branch
    check_k1(512, 152, 128, 2, dev, time_it=False)  # a last window of 24
    # BayesB at runMCMC's default block size (phase 6): b = 136
    check_k1(512, 136, 128, 2, dev, time_it=False, per_marker=True)
    check_k1(256, 1040, 2, 1, dev, time_it=False)   # 4 markers a thread
    check_k3(64, 8, 256, 3, dev, time_it=False)
    recs["bayesr_inner_rounds"] = check_k3(512, 128, 128, 8, dev, time_it=True)
    # the path's BayesR regime: the default class prior from alpha = 0
    recs["bayesr_inner_rounds"]["regimes"] = {
        "from_zero": check_k3(512, 128, 128, 8, dev, time_it=True,
                              from_zero=True)}
    check_k3(512, 256, 64, 2, dev, time_it=True)   # global-memory Gram branch
    check_k3(512, 152, 128, 2, dev, time_it=False)
    check_k3(256, 1040, 2, 1, dev, time_it=False)
    recs.update(check_gemv(50_000, 16_384, dev, missing=False, permuted=False,
                           time_it=True))
    check_gemv(50_000, 16_384, dev, missing=True, permuted=True, time_it=False)
    # runMCMC's default block size (phase 6a): G = 136 * 128
    check_gemv(50_000, 17_408, dev, missing=False, permuted=True, time_it=False)
    check_gemv(1_001, 4_096, dev, missing=True, permuted=True, time_it=False)
    check_gemv(4_000, 1_023, dev, missing=False, permuted=False, time_it=False)
    return recs


# ---------------------------------------------------------------- phase 3


def device_store(n, p, seed, dev):
    """Binomial(2, f) codes, f ~ U(0.1, 0.9), packed 4 per byte on the
    device (the generator of bench.py's north-star mode)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bpm = (n + 3) // 4
    freqs = 0.1 + 0.8 * torch.rand(p, generator=g, device=dev)
    q0 = (1.0 - freqs) ** 2
    q01 = q0 + 2.0 * freqs * (1.0 - freqs)
    packed = torch.empty((p, bpm), dtype=torch.uint8, device=dev)
    sub = 2048
    for c0 in range(0, p, sub):
        c1 = min(p, c0 + sub)
        u = torch.rand((c1 - c0, 4 * bpm), generator=g, device=dev)
        codes = ((u > q0[c0:c1, None]).to(torch.uint8)
                 + (u > q01[c0:c1, None]).to(torch.uint8))
        codes[:, n:] = 0
        c = codes.view(c1 - c0, bpm, 4)
        packed[c0:c1] = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    return packed, freqs


def default_priors(y, sum2pq, pi0=0.0, df=4.0, method="BayesC"):
    """The priors jwas_tpu's prepare_workspace derives for y = intercept +
    geno: h2 = 0.5 split of the phenotypic variance (setup.py:163-277).
    BayesR's marker variance is sigma^2 = genetic variance /
    (sum2pq * sum_k gamma_k pi_k) (setup.py:234-239), pi0 0 meaning the
    default class prior."""
    from jwas_tpu_torch.io.genotypes import bayesr_pi
    from jwas_tpu_torch.ops.markers import BAYESR_GAMMA

    var = float(np.var(y, ddof=1))
    vare0 = 0.5 * var
    if method == "BayesR":
        pi0 = bayesr_pi(pi0)
        denom = sum2pq * float(np.dot(BAYESR_GAMMA, pi0))
    else:
        denom = (1.0 - pi0) * sum2pq
    marker_var0 = 0.5 * var / denom
    return dict(vare0=vare0, scale_R=vare0 * (df - 2.0) / df, df_R=df,
                marker_var0=marker_var0,
                marker_scale0=marker_var0 * (df - 2.0) / df, df_marker=df,
                pi0=pi0)


def full_width_problem(dev, n=50_000, p=2_097_152):
    """The main paths' problem: a device-generated store of n x p, its Gram
    tiles at b = gb = 128, 0.1% QTL and h2 = 0.5. Returns gm, the centred
    phenotype and true breeding values on the host, sum 2pq, and the
    set-up seconds of the store and of the Grams."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.ops.grouped import grouped_matvec

    t0 = time.perf_counter()
    packed, freqs = device_store(n, p, 1, dev)
    torch.cuda.synchronize(dev)
    t_store = time.perf_counter() - t0
    b, gb = jt.pick_stable_blocks(n, 128, p)     # fast_blocks=128, as bench.py
    t0 = time.perf_counter()
    gm = jt.build_grouped_markers(packed, 2.0 * freqs, n, b, gb, dev,
                                  has_missing=False)
    torch.cuda.synchronize()
    t_gram = time.perf_counter() - t0

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    qtl = torch.rand(p, generator=g, device=dev) < 0.001
    beta_true = torch.randn(p, generator=g, device=dev) * qtl
    tbv = grouped_matvec(gm, beta_true)
    y = tbv + torch.randn(n, generator=g, device=dev) * tbv.std()
    y = (y - y.mean()).cpu().numpy()
    sum2pq = float(torch.sum(2.0 * freqs * (1.0 - freqs)))
    return gm, y, tbv.cpu().numpy(), sum2pq, t_store, t_gram


def phase3(dev, n=50_000, p=2_097_152):
    import jwas_tpu_torch as jt

    say(f"== phase 3: main path at full width, N={n} x P={p}")
    torch.cuda.reset_peak_memory_stats(dev)
    gm, y, tbv, sum2pq, t_store, t_gram = full_width_problem(dev, n, p)
    nblocks, b, _ = gm.grams.shape
    say(f"store: {gm.store.numel() / 1e9:.2f} GB packed on the device in {t_store:.1f} s")
    say(f"Gram tiles (b={b}, gb={nblocks // gm.ngroups}, "
        f"{gm.ngroups} groups, exact bf16): "
        f"{t_gram:.1f} s, {gm.grams.numel() * 4 / 1e9:.2f} GB")
    paths = {"BayesC": ("abc_inner_rounds", "packed_rhs", "packed_matvec"),
             "BayesR": ("bayesr_inner_rounds", "packed_rhs", "packed_matvec")}
    launches = {"phase 3": {}}
    for method, kernels in paths.items():
        priors = default_priors(y, sum2pq, method=method)
        jt.reset_launches()
        res = jt.run_st(gm, y, **priors, method=method, chain_length=3 * b,
                        output_samples_frequency=b, seed=3)
        counts = {k.__name__: k.launches for k in jt.KERNELS}
        report_path(method, res, counts, p, n, tbv, dev)
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"phase 3 {method}: kernels never launched: {missing}")
        for k in kernels:
            launches["phase 3"][k] = launches["phase 3"].get(k, 0) + counts[k]
    # phase 5 keeps the store (used in place: no padding at b = gb = 128),
    # not the Gram tiles
    kept = dict(packed=gm.store, freqs=gm.means[:p].double().cpu().numpy() / 2.0,
                tbv=tbv, y=y)
    return launches, kept


def report_path(method, res, launches, p, n, tbv, dev):
    """Print one full-width run's times, rates, memory, launches and
    samples; raise on non-finite samples or EBVs."""
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    secs = res["window_seconds"]
    rates = [p * res["nreps"] / s for s in secs]
    say(f"run_st {method}: nreps={res['nreps']}, seconds per outer iteration "
        f"{', '.join(f'{s:.3f}' for s in secs)}; effective marker updates/s "
        f"{', '.join(f'{r:.4g}' for r in rates)}")
    say(f"peak device memory {peak:.2f} GB; launches {launches}")
    track = {k: res["samples"][k].tolist() for k in ("vare", "varg", "pi")}
    acc = float(np.corrcoef(res["ebv"], tbv)[0, 1])
    say(f"samples: {track}; EBV accuracy after {len(secs)} outer iterations "
        f"{acc:.4f}")
    for k, v in track.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"phase 3 {method}: non-finite {k} samples {v}")
    if res["ebv"].shape != (n,) or not np.isfinite(acc):
        raise AssertionError(f"phase 3 {method}: EBV shape {res['ebv'].shape}, "
                             f"accuracy {acc}")


# ---------------------------------------------------------------- phase 4


def stat_data(n=2_000, p=8_192, n_qtl=50, h2=0.5, seed=2024):
    """Simulated codes, phenotypes and true breeding values (numpy only, so
    the same data can be rebuilt anywhere from the seed)."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.1, 0.9, size=p)
    codes = rng.binomial(2, freqs[None, :], size=(n, p)).astype(np.uint8)
    effects = np.zeros(p)
    effects[rng.choice(p, size=n_qtl, replace=False)] = rng.normal(size=n_qtl)
    x = codes.astype(np.float64)
    bv = (x - x.mean(axis=0)) @ effects
    y = 10.0 + bv + rng.normal(0.0, np.sqrt(bv.var() * (1 - h2) / h2), size=n)
    return codes, y, bv


def stat_store(codes):
    from jwas_tpu_torch.io.packed import Packed2BitStore, pack_codes

    n, p = codes.shape
    means = codes.mean(axis=0)
    return Packed2BitStore(
        obs_ids=[f"ind{i + 1}" for i in range(n)],
        marker_ids=[f"m{j + 1}" for j in range(p)], packed=pack_codes(codes),
        means=means, allele_freq=means / 2.0, n_obs=n, n_markers=p,
        has_missing=False,
    )


def phase4(dev):
    import jwas_tpu_torch as jt

    say("== phase 4: statistical check, kernel path vs plain path")
    codes, y, bv = stat_data()
    store = stat_store(codes)
    priors = default_priors(y, store.sum2pq)
    acc, ebv = {}, {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        gm = jt.setup_markers(store, store.obs_ids, where)
        res = jt.run_st(gm, y, **priors, chain_length=1024, burnin=256, seed=5)
        ebv[where.type] = res["ebv"]
        acc[where.type] = float(np.corrcoef(res["ebv"], bv)[0, 1])
        say(f"{where.type}: EBV accuracy {acc[where.type]:.4f}, vare "
            f"{res['vare']:.4g}, varg {res['varg']:.4g}, pi {res['pi']:.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
    if acc["cuda"] < acc["cpu"] - ACC_MARGIN or acc["cuda"] < ACC_FLOOR:
        raise AssertionError(
            f"phase 4: kernel-path accuracy {acc['cuda']:.4f} vs plain "
            f"{acc['cpu']:.4f} (margin {ACC_MARGIN}, floor {ACC_FLOOR})")

    # the same chain through the model layer: a Table, build_model, runMCMC
    t0 = time.perf_counter()
    model = jt.build_model("y = intercept + geno", genotypes=jt.get_genotypes(
        store, method="BayesC", storage="2bit"))
    out = jt.runMCMC(model, jt.Table({"ID": store.obs_ids, "y": y}),
                     chain_length=1024, burnin=256, seed=5, output_folder="",
                     printout_model_info=False)
    got = np.asarray(out["EBV_y"].EBV)
    rel = float(np.abs(got - ebv["cuda"]).max() / np.abs(ebv["cuda"]).max())
    say(f"cuda runMCMC (Table, y = intercept + geno): EBVs against run_st's "
        f"max relative error {rel:.3g}, bit for bit {np.array_equal(got, ebv['cuda'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    if list(out["EBV_y"].ID) != store.obs_ids or not rel <= RTOL_RUNMCMC:
        raise AssertionError(f"phase 4: runMCMC's EBVs differ from run_st's "
                             f"(relative {rel:.3g} > {RTOL_RUNMCMC})")

    t0 = time.perf_counter()
    gm = jt.setup_markers(store, store.obs_ids, dev)
    res = jt.run_st(gm, y, **default_priors(y, store.sum2pq, method="BayesR"),
                    method="BayesR", chain_length=1024, burnin=256, seed=5)
    acc_r = float(np.corrcoef(res["ebv"], bv)[0, 1])
    say(f"cuda BayesR: EBV accuracy {acc_r:.4f}, vare {res['vare']:.4g}, "
        f"sigma^2 {res['varg']:.4g}, pi {', '.join(f'{x:.4f}' for x in res['pi'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not acc_r >= ACC_FLOOR_BAYESR:
        raise AssertionError(f"phase 4: BayesR kernel-path accuracy {acc_r:.4f} "
                             f"< floor {ACC_FLOOR_BAYESR}")


# ---------------------------------------------------------------- phase 5


def phase5_problem(packed, freqs, tbv, seed=5, n_train=45_000, n_herds=100):
    """Phase 3's store as a Packed2BitStore (IDs ind1.., markers m1..,
    means 2f, no missing codes) and a phenotype Table of n_train of its
    individuals in shuffled order: y = TBV + herd effect + 0.5 age + noise
    of the TBV's variance. Returns (store, table, true herd effects,
    training IDs, candidate IDs)."""
    from jwas_tpu_torch.io.packed import Packed2BitStore
    from jwas_tpu_torch.io.table import Table

    p, n = packed.shape[0], tbv.shape[0]
    ids = np.array([f"ind{i + 1}" for i in range(n)], dtype=object)
    store = Packed2BitStore(
        obs_ids=list(ids), marker_ids=[f"m{j + 1}" for j in range(p)],
        packed=packed, means=2.0 * freqs, allele_freq=freqs, n_obs=n,
        n_markers=p, has_missing=False)
    rng = np.random.default_rng(seed)
    sd = float(np.std(tbv))
    herd_effect = rng.normal(0.0, sd, n_herds)
    herd = rng.integers(1, n_herds + 1, n)
    age = np.round(rng.uniform(1.0, 5.0, n), 2)
    y = tbv + herd_effect[herd - 1] + 0.5 * age + rng.normal(0.0, sd, n)
    order = rng.permutation(n)
    train, cand = order[:n_train], order[n_train:]
    table = Table({"ID": ids[train], "y": y[train], "herd": herd[train],
                   "age": age[train]})
    return store, table, herd_effect, list(ids[train]), list(ids[cand])


def run_phase5(store, table, method="BayesC", eq="y = intercept + herd + age + geno",
               on_markers=None, around_chain=None, **kw):
    """runMCMC at full width on phase5_problem's data (or another table and
    equation), with the set-up (workspace; Grams on the row-permuted
    float32 path) and the chain timed inside it. on_markers(gm) is called
    on the grouped store before the chain runs, which runs inside the
    context manager around_chain when one is given. Returns (results, seconds
    by part, what the timed parts returned: "store and Grams" the grouped
    store, "chain" run_chain's tuple, whose last item holds the seconds of
    each saved sample's window)."""
    import jwas_tpu_torch as jt
    import jwas_tpu_torch.engine.mcmc as em

    seconds, built = {}, {}

    def timed(name, fn):
        def call(*a, **k):
            ctx = around_chain if name == "chain" and around_chain else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            built[name] = out
            if name == "store and Grams" and on_markers is not None:
                on_markers(out)
            return out
        return call

    saved = em.prepare_workspace, em.setup_markers, em.run_chain
    em.prepare_workspace = timed("workspace", em.prepare_workspace)
    em.setup_markers = timed("store and Grams", em.setup_markers)
    em.run_chain = timed("chain", em.run_chain)
    try:
        model = jt.build_model(eq, genotypes=jt.get_genotypes(store, method=method,
                                                              storage="2bit"))
        if "age" in table.columns:
            jt.set_covariate(model, "age")
        t0 = time.perf_counter()
        kw = dict(dict(fast_blocks=128, chain_length=384,
                       output_samples_frequency=128, seed=3,
                       printout_model_info=False), **kw)
        out = jt.runMCMC(model, table, **kw)
        seconds["runMCMC"] = time.perf_counter() - t0
    finally:
        em.prepare_workspace, em.setup_markers, em.run_chain = saved
    return out, seconds, built


def direct_ebv(packed, means, alpha, cols):
    """X alpha in float64 for a few store columns of a store without missing
    codes, decoded on the device: X_ij = code - mean_j."""
    dev = packed.device
    cols = torch.as_tensor(cols, device=dev)
    shift = (2 * (cols % 4)).to(torch.uint8)
    codes = (packed[:, cols // 4] >> shift) & 3                 # (p, k)
    x = codes.to(torch.float64) - torch.as_tensor(means, device=dev)[:, None]
    a = torch.as_tensor(np.asarray(alpha, dtype=np.float64), device=dev)
    return (x * a[:, None]).sum(dim=0).cpu().numpy()


def phase5(dev, kept, n_train=45_000):
    import tempfile

    import jwas_tpu_torch as jt

    say("== phase 5: runMCMC at full width")
    tbv = kept["tbv"]
    store, table, herd_effect, train, cand = phase5_problem(
        kept["packed"], kept["freqs"], tbv, n_train=n_train)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    with tempfile.TemporaryDirectory() as folder:
        out, seconds, built = run_phase5(store, table, output_folder=folder,
                                         device=dev)
        gm = built.pop("store and Grams")
        in_place = gm.store.data_ptr() == kept["packed"].data_ptr()
        b, gb = gm.grams.shape[1], gm.grams.shape[0] // gm.ngroups
        del gm, built["workspace"]
        windows = built.pop("chain")[-1]
        counts = {k.__name__: k.launches for k in jt.KERNELS}
        samples = {}
        for name in ("residual_variance", "marker_effects_variances_geno", "pi_geno"):
            with open(f"{folder}/MCMC_samples_{name}.txt") as f:
                rows = [line.strip() for line in f if line.strip()]
            samples[name] = [float(r.split(",")[0]) for r in rows
                             if not r[0].isalpha()]
        files = sorted(os.listdir(folder))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    say(f"store {store.n_obs} x {store.n_markers} used in place: {in_place}; "
        f"b={b}, gb={gb}; "
        f"{len(table)} phenotyped in shuffled order, "
        f"{store.n_obs - len(table)} candidates")
    say("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + "; the chain's windows (an outer iteration and a saved sample each) "
        + ", ".join(f"{t:.3f}" for t in windows))
    say(f"peak device memory {peak:.2f} GB; launches {counts}; files {files}")
    say(f"samples: {samples}")
    missing = [k for k in PHASE5_KEYS if k not in out]
    if missing:
        raise AssertionError(f"phase 5: result keys missing: {missing}")
    ebv_t = out["EBV_y"]
    if len(ebv_t) != store.n_obs or list(ebv_t.ID) != store.obs_ids:
        raise AssertionError(f"phase 5: EBV_y has {len(ebv_t)} rows, not {store.n_obs}")
    ebv = dict(zip(ebv_t.ID, ebv_t.EBV))
    truth = dict(zip(store.obs_ids, tbv))
    acc = {who: float(np.corrcoef([ebv[s] for s in ids], [truth[s] for s in ids])[0, 1])
           for who, ids in (("candidates", cand), ("training", train))}
    # the route of the output IDs' EBVs: K5's pass over every store column,
    # here against a direct decode of a few candidates' columns on the card
    check = [store.obs_ids.index(s) for s in cand[:64]]
    direct = direct_ebv(kept["packed"], store.means, out["marker effects geno"].Estimate,
                        check)
    got = np.array([ebv[store.obs_ids[c]] for c in check])
    err = float(np.abs(got - direct).max() / np.abs(direct).max())
    say(f"EBVs of 64 candidates against X alpha decoded directly: max relative "
        f"error {err:.3g} (tolerance {RTOL_DIRECT_EBV})")
    if not err <= RTOL_DIRECT_EBV:
        raise AssertionError(f"phase 5: candidates' EBVs off by {err:.3g}")
    loc = out["location parameters"]
    herd = [(int(float(lv)), est) for eff, lv, est in
            zip(loc.Effect, loc.Level, loc.Estimate) if eff == "herd"]
    r_herd = float(np.corrcoef([herd_effect[h - 1] for h, _ in herd],
                               [e for _, e in herd])[0, 1])
    say(f"EBV accuracy after 3 outer iterations: candidates {acc['candidates']:.4f}, "
        f"training {acc['training']:.4f}; herd estimates against the true herd "
        f"effects r = {r_herd:.4f} ({len(herd)} levels)")
    values = [np.asarray(t[c], dtype=np.float64) for k in PHASE5_KEYS
              for t in (out[k],) for c in t.columns if t[c].dtype.kind == "f"]
    values += [np.asarray(v) for v in samples.values()]
    if not all(np.isfinite(v).all() for v in values) or not np.isfinite(list(acc.values())).all():
        raise AssertionError("phase 5: non-finite results")
    path = ("abc_inner_rounds", "packed_rhs", "packed_matvec")
    if any(counts[k] == 0 for k in path):
        raise AssertionError(f"phase 5: kernels never launched: {counts}")
    if not in_place:
        raise AssertionError("phase 5: runMCMC copied the device store")
    return {k: counts[k] for k in path}


# ---------------------------------------------------------------- phase 6

PATH_ABC = ("abc_inner_rounds", "packed_rhs", "packed_matvec")
# device memory beyond the store and the Gram tiles that phase 6(a) may use
PHASE6_MARGIN_BYTES = 4e9


def phase6a(dev, kept, n_train=45_000):
    """BayesB through runMCMC at its default block size on phase 5's data:
    b = 136, gb = 128 at 45,000 phenotyped, so the last group is short and
    is served as G rows from a zero-padded copy of its rows; the store is
    used in place and peak memory stays within store + Grams +
    PHASE6_MARGIN_BYTES."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.ops.grouped import resolve_blocks
    from jwas_tpu_torch.ops.inner_rounds import gram_resident

    p = kept["packed"].shape[0]
    b, gb = resolve_blocks(n_train, False, p, warn=False)
    say(f"== phase 6a: runMCMC BayesB at the default block size (b={b}, gb={gb})")
    store, table, _, _, _ = phase5_problem(kept["packed"], kept["freqs"], kept["tbv"],
                                           n_train=n_train)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    jt.reset_launches()
    out, seconds, built = run_phase5(store, table, method="BayesB", device=dev,
                                     fast_blocks=False, chain_length=3 * b,
                                     output_samples_frequency=b, output_folder="")
    counts = {k.__name__: k.launches for k in jt.KERNELS}
    gm = built.pop("store and Grams")
    in_place = gm.store.data_ptr() == kept["packed"].data_ptr()
    tail = gm.fetch.tail
    padded_tail = (tail is not None and tail.shape[0] == gm.fetch.G
                   and not bool(tail[p - (gm.ngroups - 1) * gm.fetch.G:].any()))
    shape = (gm.grams.shape[1], gm.grams.shape[0] // gm.ngroups, gm.ngroups,
             gm.valid.shape[0] - p)
    grams_bytes = gm.grams.numel() * 4
    resident = gram_resident(b, b)
    state, _, samples, _, windows = built.pop("chain")
    varg_real = state.varg[:p]
    finite = bool(torch.isfinite(varg_real).all()) and bool(torch.isfinite(state.alpha).all())
    del gm, state, built, tail
    peak = torch.cuda.max_memory_allocated(dev)
    limit = kept["packed"].numel() + grams_bytes + PHASE6_MARGIN_BYTES
    say(f"b={shape[0]}, gb={shape[1]}, {shape[2]} groups, {shape[3]} padding markers "
        f"(the last group short, served from a zero-padded copy of G rows: "
        f"{padded_tail}); store used in place: {in_place}; K1 Gram tile "
        f"{'resident (K2)' if resident else 'global (K1)'}")
    say("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + "; the chain's windows " + ", ".join(f"{t:.3f}" for t in windows))
    say(f"peak device memory {peak / 1e9:.2f} GB (store {kept['packed'].numel() / 1e9:.2f}"
        f" + Grams {grams_bytes / 1e9:.2f} + {PHASE6_MARGIN_BYTES / 1e9:.0f} GB = "
        f"{limit / 1e9:.2f} GB allowed); launches {counts}")
    say(f"samples: vare {samples['vare']}, varg (mean over markers) {samples['varg']}, "
        f"pi {samples['pi']}; results: marker effects variances "
        f"{out['marker effects variances geno'].Estimate[0]:.6g}")
    values = [np.asarray(out[k].Estimate, dtype=np.float64) for k in
              ("residual variance", "marker effects variances geno", "pi_geno",
               "marker effects geno")]
    values.append(np.asarray(out["EBV_y"].EBV, dtype=np.float64))
    if not finite or not all(np.isfinite(v).all() for v in values):
        raise AssertionError("phase 6a: non-finite results")
    if shape[:2] != (b, gb) or shape[3] <= 0:
        raise AssertionError(f"phase 6a: blocks {shape}, expected b={b}, gb={gb}, padding")
    if not in_place:
        raise AssertionError("phase 6a: runMCMC copied the device store")
    if not padded_tail:
        raise AssertionError("phase 6a: the short last group is not served as G rows")
    if not resident:
        raise AssertionError(f"phase 6a: b={b} does not take K1's resident branch (K2)")
    if peak > limit:
        raise AssertionError(f"phase 6a: peak {peak / 1e9:.2f} GB > {limit / 1e9:.2f} GB")
    if any(counts[k] == 0 for k in PATH_ABC):
        raise AssertionError(f"phase 6a: kernels never launched: {counts}")
    return {k: counts[k] for k in PATH_ABC}


def host_ram_available() -> int:
    """MemAvailable of /proc/meminfo, bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def copy_overlap(prof):
    """From a torch.profiler trace of a streamed store: the host-to-device
    copies' device seconds, the share of them during which a kernel ran (1:
    every copy hidden behind kernels, 0: copies in series with them; None
    without copies), and how many of the copies had a kernel running for at
    least half of their time, out of how many."""
    kern, copies = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        iv = (e.time_range.start, e.time_range.end)
        if "memcpy htod" in name:
            copies.append(iv)
        elif "memcpy" not in name and "memset" not in name:
            kern.append(iv)
    if not copies:
        return 0.0, None, 0, 0
    merged = []
    for t0, t1 in sorted(kern):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    starts = [m[0] for m in merged]
    total = hidden = 0.0
    mostly = 0
    for c0, c1 in copies:
        h = 0.0
        i = max(0, bisect.bisect_right(starts, c0) - 1)
        while i < len(merged) and merged[i][0] < c1:
            h += max(0.0, min(c1, merged[i][1]) - max(c0, merged[i][0]))
            i += 1
        total += c1 - c0
        hidden += h
        mostly += 2 * h >= c1 - c0
    return total / 1e6, (hidden / total if total else None), mostly, len(copies)


@contextlib.contextmanager
def busy_shares(out):
    """Profile the block with torch.profiler; then out holds the self
    device time of its kernels and of its memory copies over its wall time
    ("kernels", "copies"), the wall seconds ("wall") and the share of the
    host-to-device copies' device time during which a kernel ran
    ("overlap") and how many copies were at least half hidden, of how
    many ("mostly_hidden"; see copy_overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = copy = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if "memcpy" in e.key.lower() or "memset" in e.key.lower():
            copy += us
        else:
            kern += us
    _, overlap, mostly, ncopies = copy_overlap(prof)
    out.update(kernels=kern / 1e6 / wall, copies=copy / 1e6 / wall, wall=wall,
               overlap=overlap, mostly_hidden=(mostly, ncopies))


def phase6b(dev, kept, fast_blocks=128):
    """BayesC pi0 = 0 through runMCMC on phase 3's problem (every
    individual phenotyped, in store order) at fast_blocks = 128: the store
    resident on the card, then streamed from a pinned host copy with no
    group resident and with half of them resident (the split set through
    JWAS_HBM_BYTES), each twice, in the order streamed, hybrid, hybrid,
    streamed. Alpha, the EBVs and the vare / varg / pi tracks must equal the
    resident run's bit for bit. Each streamed run is then profiled for two
    outer iterations: busy shares and the copies' overlap with kernels."""
    import jwas_tpu_torch as jt
    from jwas_tpu_torch.io.packed import Packed2BitStore
    from jwas_tpu_torch.io.table import Table
    from jwas_tpu_torch.ops import grouped as gr

    say("== phase 6b: the store streamed from pinned host memory")
    packed = kept["packed"]
    p, bpm = packed.shape
    n = kept["tbv"].shape[0]
    b, gb = gr.resolve_blocks(n, fast_blocks, p, warn=False)
    G = b * gb
    avail = host_ram_available()
    p_b = p
    if avail < 1.25 * p * bpm + 8e9:             # pinned copy, headroom
        p_b = max(G, int((avail - 8e9) / 1.25 / bpm) // G * G)
        say(f"host RAM available {avail / 1e9:.1f} GB cannot pin the "
            f"{p * bpm / 1e9:.1f} GB store: P cut to {p_b} for phase 6b")
    t0 = time.perf_counter()
    host = gr.pinned_copy(packed[:p_b])
    t_pin = time.perf_counter() - t0
    freqs = kept["freqs"][:p_b]
    ids = [f"ind{i + 1}" for i in range(n)]
    table = Table({"ID": np.array(ids, dtype=object), "y": kept["y"]})

    def store_of(x):
        return Packed2BitStore(obs_ids=ids, marker_ids=[f"m{j + 1}" for j in range(p_b)],
                               packed=x, means=2.0 * freqs, allele_freq=freqs,
                               n_obs=n, n_markers=p_b, has_missing=False)

    ngroups = -(-p_b // G)
    split = {"streamed": 0, "hybrid": ngroups // 2}
    runs = [("resident", store_of(packed[:p_b]), False, None)]
    for i, name in enumerate(("streamed", "hybrid", "hybrid", "streamed")):
        runs.append((name if i < 2 else f"{name} again", store_of(host), True,
                     gr.hybrid_budget(split[name], ngroups, G, b, bpm)))
    say(f"host copy: {host.numel() / 1e9:.2f} GB pinned in {t_pin:.1f} s; P = {p_b}, "
        f"b={b}, gb={gb}, {ngroups} groups of {G * bpm / 1e6:.1f} MB")
    results, launches = {}, {}
    for name, store, offload, budget in runs:
        fetch = {}

        def on_markers(gm):
            fetch["f"] = gm.fetch
            gm.fetch.record = True

        saved = os.environ.get("JWAS_HBM_BYTES")
        if budget is not None:
            os.environ["JWAS_HBM_BYTES"] = str(budget)
        try:
            torch.cuda.empty_cache()
            jt.reset_launches()
            kw = dict(method="BayesC", eq="y = intercept + geno", device=dev,
                      fast_blocks=fast_blocks, chain_length=3 * b,
                      output_samples_frequency=b, output_folder="",
                      host_offload_genotypes=offload)
            out, seconds, built = run_phase5(store, table, on_markers=on_markers, **kw)
            counts = {k.__name__: k.launches for k in jt.KERNELS}
            f = fetch["f"]
            copy_s, copy_b = f.copy_seconds()
            state, _, samples, _, windows = built["chain"]
            results[name] = dict(alpha=state.alpha.cpu().numpy(),
                                 ebv=np.asarray(out["EBV_y"].EBV),
                                 **{k: np.asarray(samples[k]) for k in ("vare", "varg", "pi")})
            del built, state, out
            busy = {}
            if offload:
                _, _, prof_built = run_phase5(store, table, around_chain=busy_shares(busy),
                                              **dict(kw, chain_length=2 * b))
                busy["windows"] = prof_built["chain"][-1]
                del prof_built
        finally:
            if saved is None:
                os.environ.pop("JWAS_HBM_BYTES", None)
            else:
                os.environ["JWAS_HBM_BYTES"] = saved
        launches[name] = {k: counts[k] for k in PATH_ABC}
        line = (f"{name}: {f.resident} of {f.ngroups} groups on the card; seconds: "
                + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
                + "; s / outer iteration " + ", ".join(f"{t:.4f}" for t in windows))
        if copy_b:
            line += (f"; host-to-device copies during the chain: {copy_b / 1e9:.1f} GB in "
                     f"{copy_s:.3f} s of copy-stream time, {copy_b / copy_s / 1e9:.1f} GB/s")
        if busy:
            overlap = ("none" if busy["overlap"] is None
                       else f"{busy['overlap']:.4f}")
            line += (f"; profiled chain of 2 outer iterations ({busy['wall']:.2f} s, "
                     f"windows {', '.join(f'{t:.4f}' for t in busy['windows'])}): "
                     f"kernels busy {busy['kernels']:.4f}, copies {busy['copies']:.4f} "
                     f"of the wall time; share of the copies' device time with a "
                     f"kernel running {overlap}, copies at least half hidden "
                     f"{busy['mostly_hidden'][0]} of {busy['mostly_hidden'][1]}")
        say(line)
        say(f"  launches {counts}")
    ref = results["resident"]
    for name in results:
        if name == "resident":
            continue
        same = {k: bool(np.array_equal(results[name][k], ref[k])) for k in ref}
        say(f"{name} vs resident, bit for bit: {same}")
        if not all(same.values()):
            raise AssertionError(f"phase 6b: the {name} chain differs from the resident "
                                 f"one in {[k for k, v in same.items() if not v]}")
    for name, c in launches.items():
        if any(c[k] == 0 for k in PATH_ABC):
            raise AssertionError(f"phase 6b {name}: kernels never launched: {c}")
    if not all(np.isfinite(ref[k]).all() for k in ref):
        raise AssertionError("phase 6b: non-finite results")
    del host
    return launches["streamed"]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from jwas_tpu_torch import _build

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say("== phase 1: device and build")
    say(f"card: {card}")
    say(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    _build.library()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    say("\n".join(line for line in _build.build_log.splitlines()
                  if "registers" in line or "spill" in line
                  or line.endswith(" s")))      # seconds a source

    recs = phase2(dev)
    launches, kept = phase3(dev)
    phase4(dev)
    launches["phase 5"] = phase5(dev, kept)
    launches["phase 6a"] = phase6a(dev, kept)
    launches["phase 6b"] = phase6b(dev, kept)

    # launches: phase 3's (run_st, both methods), phase 5's (runMCMC),
    # phase 6's (runMCMC BayesB; BayesC streamed with no group resident)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name],
                    launches=sum(c.get(name, 0) for c in launches.values()),
                    launches_by_phase={ph: c.get(name, 0) for ph, c in launches.items()},
                    **recs[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
