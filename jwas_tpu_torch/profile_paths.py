"""Where the time goes in the port's main paths at full width, on one GPU.

    python3 -m jwas_tpu_torch.profile_paths [BayesC,BayesC0999,BayesR,runMCMC,Streamed,Hybrid,Dense,Methods,GBLUP,MT,MTPedigree,MTC0L,MTAnno]

Run it from the root of the repository: it imports chip_smoke.py.

Builds chip_smoke.py's phase-3 problem (a 2-bit store of N = 50,000 x
P = 2,097,152 generated on the device, 0.1% QTL, h2 = 0.5, Gram tiles at
b = gb = 128) and, for each named path:

  1. runs run_st for three outer iterations (nreps = 128, sync every 8)
     while nvidia-smi samples the SM clock and power every 250 ms, and
     prints the unprofiled seconds of each outer iteration (run_st's
     window_seconds) with the median clock and power after the first
     quarter of the samples;
  2. runs run_st again for two outer iterations under torch.profiler and
     prints the device busy share, the sum of the self device times of all
     CUDA events over the host wall time of that run_st call (its set-up,
     one X alpha, included), the device time a round (that sum over the
     rounds run), and the ten largest device-time rows with their share of
     the device time;
  3. measures the host's time a round directly: the sweep of one group (its
     16 rounds, ~250 launches, fewer than the launch queue holds) is
     enqueued on an idle device and never waits for it, so the wall time
     until the last launch is queued is the host's alone; beside it the
     time between CUDA events around the same rounds, which is the larger
     of the host's and the device's, and the host's time for the same
     rounds queued behind a device spin, where no launch finds the stream
     empty.

Paths: BayesC from pi0 = 0 (every marker moves), BayesC0999 from
pi0 = 0.999 (most effects stay 0), BayesR from the default class prior.
runMCMC is chip_smoke.py's phase 5 on the same store (45,000 phenotyped
individuals in shuffled order, y = intercept + herd + age + geno, BayesC,
fast_blocks = 128): its unprofiled set-up and chain seconds, then step 2
for a runMCMC call of two outer iterations (its set-up included in the
wall time; the Grams' float32 matmuls among the device rows).
Streamed and Hybrid are BayesC from pi0 = 0 on a pinned host copy of the
store streamed to the card through the ring of staging buffers, with no
group resident and with half of the groups resident: steps 1 and 2, with
the host-to-device copies' GB/s (copy-stream time of the chain's copies),
the device time of the kernels and of the copies apart, and the share of
the copies' device time during which a kernel ran (chip_smoke.copy_overlap).
Dense is chip_smoke.py's phase 7a: a dense float32 store of N = 50,000 x
P = 100,000 written by get_genotypes on the device, 45,000 phenotyped with
weights, runMCMC BayesC at fast_blocks = True (b = 256, gb = 23): its
unprofiled set-up and window seconds, step 2 for a call of two outer
iterations (the kernel K1 and the dense GEMVs, torch.mv, among the device
rows) and step 3 on the first group (its 32 rounds). Methods is
chip_smoke.py's phase 8a on the same dense store without weights: runMCMC
RR-BLUP and BayesL at fast_blocks = True (K1 with every marker in the
slab), each unprofiled, then step 2 and step 3 as for Dense. GBLUP is
chip_smoke.py's phase 8b (the first 20,000 individuals' relationship
matrix, 18,000 phenotyped; their breeding values here a numpy draw, as
only the times are read): runMCMC's unprofiled set-up and windows, then
step 2 for run_st's chain alone, 100 iterations on the workspace's
eigenbasis, whose device time a round is a time an iteration. None of the
three builds a 2-bit store. MT is chip_smoke.py's phase 10a (3 traits on
phase 7's store, runMCMC BayesC sampler I at fast_blocks = True: K7 and the
two products of a round, torch.mm over the group's rows with the t
columns), then 10b (sampler II, K8) and 10c's BayesB (K7, a covariance a
locus): step 2 for a call of two outer iterations after an unprofiled one
of three, each. MTPedigree is phase 10d (the 3-trait animal model, K =
18,303, 20 iterations; the pedigree, workspace and LHS pieces' set-up
included in the profiled call): step 2, the LHS assembly's kernels,
K6 and the GEMVs with W among the device rows. MTC0L is chip_smoke.py's
phase 11a and 11b on phase 10's store and design (runMCMC multi-trait
RR-BLUP and BayesL at fast_blocks = True: K9 and the two products of a
round): step 2 for a call of two outer iterations after an unprofiled one
of three, each. MTAnno is chip_smoke.py's phase 12d on the same store: 2
traits with 4 annotations, runMCMC annotated BayesC, sampler I (K7) then
sampler II (K8), each with its per-marker pattern prior: step 2 for a call
of two outer iterations after an unprofiled one of three, each, the tree
probit's operations among the device rows. Each is a start-of-chain measurement: pi has not settled after three outer
iterations. Imports torch, numpy, the port and chip_smoke.py; never jax.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
import jwas_tpu_torch as jt
from jwas_tpu_torch import _build
from jwas_tpu_torch.io.genotypes import bayesr_pi
from jwas_tpu_torch.ops import grouped as gr
from jwas_tpu_torch.ops.dense import DenseMarkers

PATHS = {"BayesC": ("BayesC", 0.0), "BayesC0999": ("BayesC", 0.999),
         "BayesR": ("BayesR", 0.0), "Streamed": ("BayesC", 0.0),
         "Hybrid": ("BayesC", 0.0), "Dense": ("BayesC", 0.0),
         "Methods": ("RR-BLUP", 0.0), "GBLUP": ("GBLUP", 0.0)}
DENSE_METHODS = ("RR-BLUP", "BayesL")
STREAMED = {"Streamed": lambda ngroups: 0, "Hybrid": lambda ngroups: ngroups // 2}


def device_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def host_ms_a_round(name, gm, y, sum2pq, repeats=5, method=None):
    """Host and elapsed milliseconds a round of the first group's sweep
    (nreps = b, sync every 8: the path's schedule), medians of `repeats`
    sweeps after a warm-up one. The chain state carries on from sweep to
    sweep, as it does from one outer iteration to the next. method: the
    path's own (PATHS) unless given."""
    method, pi0 = (method, 0.0) if method else PATHS[name]
    dev = gm.grams.device
    G = gm.G
    nblocks, b, _ = gm.grams.shape
    gb = nblocks // gm.ngroups
    if isinstance(gm, DenseMarkers):
        sub = gm._replace(X=gm.X[:G], xpx=gm.xpx[:G], grams=gm.grams[:gb],
                          valid=gm.valid[:G])
    else:
        sub = gm._replace(fetch=gr.GroupFetcher(gm.store[:G], G, dev, 1),
                          means=gm.means[:G], xpx=gm.xpx[:G], grams=gm.grams[:gb],
                          valid=gm.valid[:G])
    priors = cs.default_priors(y, sum2pq, pi0=pi0, method=method)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    f32 = dict(dtype=torch.float32, device=dev)
    alpha = torch.zeros(G, **f32)
    ycorr = torch.as_tensor(y, **f32).clone()
    vare = torch.tensor(priors["vare0"], **f32)
    varg = torch.tensor(priors["marker_var0"], **f32)
    if method == "BayesR":
        delta = torch.zeros(G, dtype=torch.int32, device=dev)
        pi_mat = torch.as_tensor(bayesr_pi(pi0), **f32).expand(G, 4).contiguous()

        def sweep():
            gr.sweep_blocks_bayesr_grouped(sub, alpha, delta, ycorr, vare, varg,
                                           pi_mat, gen, nreps=b, sync_every=8)
    elif method in DENSE_METHODS:
        gamma = None
        if method == "BayesL":
            gamma = 8.0 * torch.empty(G, **f32).exponential_(generator=gen)
            varg = varg / 8.0

        def sweep():
            gr.sweep_blocks_c0l_grouped(sub, alpha, ycorr, vare, varg, gamma, gen,
                                        nreps=b, sync_every=8)
    else:
        beta = alpha.clone()
        delta = torch.ones(G, dtype=torch.int32, device=dev)
        pi = torch.full((G,), pi0, **f32)

        def sweep():
            gr.sweep_blocks_abc_grouped(sub, alpha, beta, delta, ycorr, vare,
                                        varg, pi, gen, nreps=b, sync_every=8)
    rounds = b // 8
    sweep()
    host, elapsed, behind = [], [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        sweep()
        host.append((time.perf_counter() - t0) * 1e3 / rounds)
        end.record()
        torch.cuda.synchronize()
        elapsed.append(start.elapsed_time(end) / rounds)
        # the same with the device busy: every launch queues behind a spin
        # of ~50 ms and none finds the stream empty
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        sweep()
        behind.append((time.perf_counter() - t0) * 1e3 / rounds)
    torch.cuda.synchronize()
    cs.say(f"{name}: host {np.median(host):.4f} ms a round (enqueueing one "
           f"group's {rounds} rounds on an idle device; {repeats} sweeps: "
           f"{', '.join(f'{h:.4f}' for h in host)}), elapsed between events "
           f"{np.median(elapsed):.4f} ms a round; host behind a busy device "
           f"{np.median(behind):.4f} ms a round "
           f"({', '.join(f'{h:.4f}' for h in behind)})")


def profile_path(name, gm, y, sum2pq):
    method, pi0 = PATHS[name]
    b = gm.grams.shape[1]
    priors = cs.default_priors(y, sum2pq, pi0=pi0, method=method)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "250"],
        stdout=subprocess.PIPE, text=True)
    gm.fetch.record, gm.fetch.copies = True, []
    try:
        res = jt.run_st(gm, y, **priors, method=method, chain_length=3 * b,
                        output_samples_frequency=b, seed=3)
    finally:
        smi.terminate()
        smi_out = smi.communicate()[0]
    rows = np.array([[float(x) for x in line.split(",")]
                     for line in smi_out.strip().splitlines() if line.strip()])
    rows = rows[len(rows) // 4:]                 # drop the ramp-up
    cs.say(f"{name}: unprofiled s / outer iteration "
           f"{', '.join(f'{t:.4f}' for t in res['window_seconds'])}; SM clock "
           f"median {np.median(rows[:, 0]):.0f} MHz, power median "
           f"{np.median(rows[:, 1]):.1f} W (max {rows[:, 1].max():.1f} W, "
           f"limit {rows[0, 2]:.0f} W)")
    copy_s, copy_b = gm.fetch.copy_seconds()
    gm.fetch.record = False
    if copy_b:
        cs.say(f"{name}: {gm.fetch.resident} of {gm.ngroups} groups on the card; "
               f"host-to-device {copy_b / 1e9:.2f} GB in {copy_s:.4f} s of copy-stream "
               f"time: {copy_b / copy_s / 1e9:.2f} GB/s")

    profiled(name, lambda: jt.run_st(gm, y, **priors, method=method,
                                      chain_length=2 * b,
                                      output_samples_frequency=b, seed=4),
             2 * gm.ngroups * (b // 8))


def profiled(name, run, rounds, top=10):
    """Step 2: run() under torch.profiler; device busy share (the memory
    copies' device time apart), device time a round and the `top` largest
    device-time rows."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    total = sum(device_us(e) for e in events)
    copies = sum(device_us(e) for e in events if "memcpy" in e.key.lower())
    cs.say(f"{name}: profiled run: wall {wall:.3f} s, "
           f"device {total / 1e6:.3f} s, busy {total / 1e6 / wall:.4f} (copies "
           f"{copies / 1e6:.3f} s, kernels alone busy {(total - copies) / 1e6 / wall:.4f}); "
           f"device {total / 1e3 / rounds:.4f} ms a round ({rounds} rounds)")
    copy_s, overlap, mostly, ncopies = cs.copy_overlap(prof)
    if overlap is not None:
        cs.say(f"{name}: host-to-device copies {copy_s:.3f} s of device time, "
               f"{overlap:.4f} of it with a kernel running; {mostly} of {ncopies} "
               f"copies at least half hidden")
    for e in sorted(events, key=device_us, reverse=True)[:top]:
        cs.say(f"   {e.key[:64]:64s} {device_us(e) / 1e3:10.2f} ms "
               f"{device_us(e) / total:7.4f}  calls {e.count:7d}  "
               f"mean {device_us(e) / e.count:8.2f} us")


def profile_runmcmc(gm, tbv):
    """chip_smoke.py's phase 5 on gm's store, unprofiled then profiled."""
    p = gm.store.shape[0]
    store, table, _, _, _ = cs.phase5_problem(
        gm.store, gm.means[:p].double().cpu().numpy() / 2.0, tbv)
    out, seconds, built = cs.run_phase5(store, table, output_folder="",
                                        device=gm.device)
    cs.say("runMCMC: unprofiled seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()) + "; windows " + ", ".join(
        f"{t:.4f}" for t in built["chain"][-1]))
    grouped = built["store and Grams"]
    ngroups, b = grouped.ngroups, grouped.grams.shape[1]
    del built, grouped, out
    profiled("runMCMC", lambda: cs.run_phase5(store, table, output_folder="",
                                              device=gm.device,
                                              chain_length=2 * b),
             2 * ngroups * (b // 8), top=20)


def profile_dense(dev, methods=("BayesC",)):
    """chip_smoke.py's phase 7a (BayesC with weights) or phase 8a (methods
    of DENSE_METHODS, no weights), unprofiled then profiled, and the host's
    time a round on its first group."""
    codes = cs.dense_codes(50_000, 100_000, 7, dev)
    geno = jt.get_genotypes(codes, method="BayesC", storage="f32", device=dev)
    del codes
    table, _, _, _ = cs.phase7_problem(geno)
    kw = dict(device=dev, fast_blocks=True, output_folder="",
              heterogeneous_residuals=methods == ("BayesC",))
    for method in methods:
        name = "Dense" if method == "BayesC" else method
        out, seconds, built = cs.run_phase5(cs.fresh(geno, method), table,
                                            chain_length=768,
                                            output_samples_frequency=256, **kw)
        cs.say(f"{name}: unprofiled seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in seconds.items()) + "; windows " + ", ".join(
            f"{t:.4f}" for t in built["chain"][-1]))
        gm = built["store and Grams"]
        b = gm.grams.shape[1]
        del built, out
        profiled(name, lambda: cs.run_phase5(cs.fresh(geno, method), table,
                                             chain_length=2 * b,
                                             output_samples_frequency=b, **kw),
                 2 * gm.ngroups * (b // 8), top=16)
        y = np.asarray(table["y"], dtype=np.float64)
        host_ms_a_round(name, gm, y - y.mean(), geno.sum2pq, method=method)
        del gm
        torch.cuda.empty_cache()


def profile_gblup(dev, n=20_000, n_train=18_000):
    """chip_smoke.py's phase 8b, unprofiled, then its chain alone
    profiled."""
    from jwas_tpu_torch.ops.gblup import build_gblup_markers

    codes = cs.dense_codes(50_000, 100_000, 7, dev)[:n]
    g = jt.get_genotypes(codes, method="GBLUP", storage="f32", device=dev)
    del codes
    tbv = np.random.default_rng(2).normal(size=n)
    table, _, _, _ = cs.design_table(g.obs_ids, tbv, 6, n_train)
    table = type(table)({c: table[c] for c in table.columns if c != "weights"})
    out, seconds, built = cs.run_phase5(g, table, device=dev, chain_length=200,
                                        output_samples_frequency=50, output_folder="")
    cs.say("GBLUP: unprofiled seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()) + "; windows of 50 iterations "
        + ", ".join(f"{t:.4f}" for t in built["chain"][-1]))
    ws = built["workspace"]
    gm = build_gblup_markers(ws.gblup_L, ws.gblup_D, ws.gblup_out)
    del built, out
    priors = dict(vare0=ws.vare0, scale_R=ws.scale_R, df_R=ws.df_R,
                  marker_var0=ws.marker_var0, marker_scale0=ws.marker_scale0,
                  df_marker=ws.df_marker)
    profiled("GBLUP", lambda: jt.run_st(gm, ws.y, W=ws.W, **priors, method="GBLUP",
                                        chain_length=100, output_samples_frequency=50,
                                        seed=4),
             100, top=16)


def profile_mt(dev, pedigree=False, c0l=False, anno=False):
    """chip_smoke.py's phase 10a (pedigree: 10d; c0l: 11a and 11b; anno:
    12d) under torch.profiler."""
    import dataclasses

    if pedigree:
        profiled("MTPedigree", lambda: cs.phase10d(dev), 20, top=20)
        return
    codes = cs.dense_codes(50_000, 100_000, 7, dev)
    geno = jt.get_genotypes(codes, method="BayesC", storage="f32", device=dev)
    del codes
    tbv = cs.mt_truth(geno.dense, seed=10)
    t = 2 if anno else 3
    table, _, _ = cs.mt_table(geno.obs_ids, tbv[:, :t], 123 if anno else 10, 45_000)
    eq = "\n".join(f"y{k} = intercept + herd + age + geno" for k in range(1, t + 1))
    kw = dict(fast_blocks=True, output_samples_frequency=256, output_folder="")
    A = cs.anno_columns(cs.qtl_mask(geno.dense.shape[0], 10, dev), 121) if anno else None

    def genotypes(method, sampler):
        g = cs.fresh(geno, method)
        g.multi_trait_sampler = sampler
        if anno:
            g = dataclasses.replace(g, annotations=A, estimate_pi=True,
                                    pi=dict(cs.PI_MT_ANNO))
        return g

    paths = ((("MTC0L RR-BLUP", "RR-BLUP", "I"), ("MTC0L BayesL", "BayesL", "I")) if c0l
             else (("MTAnno sampler I", "BayesC", "I"), ("MTAnno sampler II", "BayesC", "II"))
             if anno else (("MT", "BayesC", "I"), ("MT sampler II", "BayesC", "II"),
                           ("MT BayesB", "BayesB", "I")))
    for name, method, sampler in paths:
        kernels = (cs.C0L,) if c0l else (f"mt_abc_inner_rounds_{sampler}",)
        cs.run_mt(f"{name}, unprofiled", dev, genotypes(method, sampler), table, eq,
                  kernels, chain_length=768, **kw)
        profiled(name, lambda: cs.run_mt(f"{name}, profiled", dev, genotypes(method, sampler),
                                         table, eq, kernels, chain_length=512, **kw),
                 2 * 17 * 32, top=16)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch.cuda.is_available() is false")
    names = (sys.argv[1] if len(sys.argv) > 1 else "BayesC,BayesR").split(",")
    for name in names:
        if name not in PATHS and name not in ("runMCMC", "MT", "MTPedigree", "MTC0L",
                                              "MTAnno"):
            raise SystemExit(f"unknown path {name!r}; choose from {sorted(PATHS)}")
    dev = torch.device("cuda", 0)
    cs.say(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.library()                  # the nvcc build stays out of the windows
    cs.say(f"kernels built (nvcc {_build.build_seconds:.1f} s)")
    for name, methods in (("Dense", ("BayesC",)), ("Methods", DENSE_METHODS)):
        if name in names:
            profile_dense(dev, methods)
            names = [n for n in names if n != name]
            torch.cuda.empty_cache()
    if "GBLUP" in names:
        profile_gblup(dev)
        names = [n for n in names if n != "GBLUP"]
    for name in ("MT", "MTPedigree", "MTC0L", "MTAnno"):
        if name in names:
            profile_mt(dev, pedigree=name == "MTPedigree", c0l=name == "MTC0L",
                       anno=name == "MTAnno")
            names = [n for n in names if n != name]
            torch.cuda.empty_cache()
    if not names:
        return
    gm, y, tbv, sum2pq, _, _ = cs.full_width_problem(dev)
    host = None
    for name in names:
        if name == "runMCMC":
            profile_runmcmc(gm, tbv)
            continue
        if name in STREAMED:
            if host is None:
                host = gr.pinned_copy(gm.store)
            b, gb = gm.grams.shape[1], gm.grams.shape[0] // gm.ngroups
            os.environ["JWAS_HBM_BYTES"] = str(gr.hybrid_budget(
                STREAMED[name](gm.ngroups), gm.ngroups, gm.fetch.G, b, host.shape[1]))
            try:
                g_s = gr.build_grouped_markers(host, gm.means[:host.shape[0]], gm.n_obs,
                                               b, gb, dev, has_missing=False, host=True)
            finally:
                os.environ.pop("JWAS_HBM_BYTES")
            profile_path(name, g_s, y, sum2pq)
            del g_s
            continue
        profile_path(name, gm, y, sum2pq)
        host_ms_a_round(name, gm, y, sum2pq)


if __name__ == "__main__":
    main()
