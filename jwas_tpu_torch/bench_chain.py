"""Time the inner-chain kernels K1 (abc_inner_rounds) and K3
(bayesr_inner_rounds) at the main path's shape on one GPU, and K9
(mt_c0l_inner_rounds) at chip_smoke.py phase 11a's round, beside what a
dependent step must cost there.

    python3 -m jwas_tpu_torch.bench_chain [--b 128] [--nblocks 128] [--reps 8]

Run it from the root of the repository: it takes its inputs from
chip_smoke.py. It prints

  1. the probes of csrc/chain_probe.cu, one CTA each, ns a dependent step:
     (a) a barrier of 128 threads with a shared-memory round trip, (b) a
     shuffle and a multiply-add, (c) a marker update's arithmetic on
     registers (K1's, K3's), (d) = (b) + (c), the floor of a step that
     changes an effect, (e) = (d) as the kernels do a changing step (d
     from the next uncommitted lane, the test that it changed, the Gram
     entry from shared memory);
  2. K1 and K3 in the path's three regimes (K1 with every marker included,
     K1 from alpha = 0 at pi0 = 0.999, K3 from alpha = 0 at the default
     class prior): ms a launch with CUDA events over 20 launches queued
     behind a device spin, ns a step, the share of the steps that changed
     an effect and the evaluations a window (counted by the plain model of
     the schedule, which must equal the plain version bit for bit), and
     the roofline bound of chip_smoke.chain_bounds; each result is first
     held against the plain version;
  3. the host's time for one call of each wrapper (argument checks,
     pointers, launch), with the device kept busy so that no call waits;
  4. K9 at phase 11a's round (t = 3, b = 256, 8 reps) over 23 blocks and
     over one (a single CTA: the step without other CTAs beside it), in
     float32 and float64: ms a launch, ns a step, each result first held
     against the plain version bit for bit. Its probes (f)-(l) are in 1.

Imports torch, the port and chip_smoke.py; never jax.
"""

import argparse
import json
import subprocess
import time

PROBES = {
    0: "(a) barrier of 128 threads + shared-memory round trip",
    1: "(b) shuffle + multiply-add",
    2: "(c) K1 update arithmetic on registers",
    3: "(c) K3 update arithmetic on registers",
    4: "(d) K1: (b) + (c)",
    5: "(d) K3: (b) + (c)",
    6: "(e) K1: a whole changing step of the kernel",
    7: "(e) K3: a whole changing step of the kernel",
    8: "(f) K9 first design's serial step: 256 threads, barrier, global loads, divisions",
    9: "(g) K9 first design's step arithmetic on registers",
    10: "(h) barrier of 256 threads + shared-memory round trip",
    11: "(i) K9 affine-map step arithmetic on registers",
    12: "(j) hand-off by a tagged word in shared memory, two warps",
    13: "(k) K9 affine-map step: (i) + shuffle",
    14: "(l) K9 affine-map step as the kernel runs it in a run",
}
K9_PROBES = range(8, 15)
PROBE_STEPS = 1024 * 64


def probe_ns(lib, which, dev):
    """ns a dependent step of probe `which`; the launch's own few
    microseconds are spread over PROBE_STEPS steps."""
    import torch

    import chip_smoke as cs
    from jwas_tpu_torch import _build

    io = torch.zeros(16, device=dev)
    io[:4] = torch.tensor([20.0, 0.05, 1.0, 0.0])
    stream = _build.stream_of(io)

    def launch():
        _build.check(lib.jt_chain_probe(which, io.data_ptr(), PROBE_STEPS,
                                        stream), "chain_probe")
    ms = cs.cuda_ms(launch, 5)
    if not torch.isfinite(io).all():
        raise AssertionError(f"probe {which} left {io.tolist()}")
    return ms * 1e6 / PROBE_STEPS


def host_us(fn, calls=100, batches=5):
    """Host microseconds a call of fn, the median of `batches` loops of
    `calls` calls (a shared host's clock wanders): the device is busy behind
    a spin and the launch queue never fills, so a loop times the host alone."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def k9_cases(dev, t=3, b=256, reps=8):
    """K9 at phase 11a's round over 23 blocks and over one, float32 and
    float64 (RR-BLUP inputs of chip_smoke.k9_inputs, no padding): held
    against the plain version bit for bit, then ms a launch (CUDA events
    over 20 launches) and ns a step."""
    import torch

    import chip_smoke as cs
    from jwas_tpu_torch.ops import inner_rounds as ir
    from jwas_tpu_torch.ops import multitrait as mt

    order = ("grams", "xpx", "valid", "alpha", "rhs", "Rinv", "Ginv", "gamma", "zs")
    out = {}
    for dtype in (torch.float32, torch.float64):
        for nblocks in (23, 1):
            inp = cs.k9_inputs(t, b, nblocks, reps, False, 34, dev, dtype, n_padding=0)
            got = {k: v.clone() for k, v in inp.items()}
            want = {k: v.clone() for k, v in inp.items()}
            ir.mt_c0l_inner_rounds(*(got[k] for k in order), reps)
            mt.mt_c0l_inner_rounds_ref(*(want[k] for k in order), reps)
            exact = all(torch.equal(got[k], want[k]) for k in ("alpha", "rhs"))
            if not exact:
                raise AssertionError(f"K9 {dtype} nblocks={nblocks}: not the plain "
                                     "version's bits")
            a = {k: v.clone() for k, v in inp.items()}
            ms = cs.cuda_ms(lambda: ir.mt_c0l_inner_rounds(*(a[k] for k in order), reps), 20)
            name = f"K9 {str(dtype).replace('torch.', '')} t={t} b={b} reps={reps} nblocks={nblocks}"
            out[name] = dict(ms=ms, step_ns=ms * 1e6 / (reps * b), equals_plain_bit_for_bit=exact,
                             **cs.k9_bounds(inp, reps))
            print(f"{name}: {ms:.4f} ms a launch, {ms * 1e6 / (reps * b):.1f} ns a step "
                  f"(bit for bit the plain version); bound {out[name]['bound_ms']:.4f} ms",
                  flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--nblocks", type=int, default=128)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--n", type=int, default=512,
                    help="observations behind the random Gram tiles")
    args = ap.parse_args()
    b, nblocks, reps, n = args.b, args.nblocks, args.reps, args.n

    import torch

    import chip_smoke as cs
    from jwas_tpu_torch import _build
    from jwas_tpu_torch.ops import inner_rounds as ir

    if not torch.cuda.is_available():
        raise SystemExit("bench_chain: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = _build.library()
    print("\n".join(line for line in _build.build_log.splitlines()
                    if "inner_rounds" in line or "probe" in line
                    or "registers" in line or "spill" in line), flush=True)
    dev = torch.device("cuda", 0)

    probes = {}
    for which, what in PROBES.items():
        probes[what] = probe_ns(lib, which, dev)
        print(f"probe {what}: {probes[what]:.1f} ns a step", flush=True)
    out = k9_cases(dev)

    k1 = ("alpha", "beta", "delta", "rhs")
    k3 = ("alpha", "delta", "rhs")
    cases = {
        "K1 dense (pi0 = 0)": (
            ir.abc_inner_rounds, ir.abc_inner_rounds_ref,
            ir.abc_inner_rounds_window_ref, k1,
            cs.k1_inputs(n, b, nblocks, reps, 7, dev, "dense")),
        "K1 sparse (pi0 = 0.999, from alpha = 0)": (
            ir.abc_inner_rounds, ir.abc_inner_rounds_ref,
            ir.abc_inner_rounds_window_ref, k1,
            cs.k1_inputs(n, b, nblocks, reps, 7, dev, "sparse")),
        "K3 default class prior, from alpha = 0": (
            ir.bayesr_inner_rounds, ir.bayesr_inner_rounds_ref,
            ir.bayesr_inner_rounds_window_ref, k3,
            cs.k3_inputs(n, b, nblocks, reps, 9, dev, from_zero=True)),
    }
    for name, (kernel, plain, window_ref, outs, inp) in cases.items():
        fresh = lambda: {k: v.clone() for k, v in inp.items()}  # noqa: E731
        got, want = fresh(), fresh()
        kernel(**got, nreps=reps)
        plain(**want, nreps=reps)
        torch.cuda.synchronize()
        labels = (got["delta"] == want["delta"]).float().mean().item()
        exact = all(torch.equal(got[k], want[k]) for k in outs)
        if labels < cs.DELTA_AGREE:
            raise AssertionError(f"{name}: labels agree on {labels:.5f}")
        stats = cs.window_stats(window_ref, inp, outs, want, reps)
        a = fresh()
        ms = cs.cuda_ms(lambda: kernel(**a, nreps=reps), 20)
        a = fresh()
        rec = dict(ms=ms, step_ns=ms * 1e6 / (reps * b), labels_agree=labels,
                   equals_plain_bit_for_bit=exact,
                   host_us=host_us(lambda: kernel(**a, nreps=reps)), **stats,
                   **cs.chain_bounds(inp, outs, b, nblocks, reps))
        out[name] = rec
        print(f"{name}: {ms:.4f} ms a launch, {rec['step_ns']:.1f} ns a step; "
              f"{stats['changed_share']:.2%} of the steps changed an effect, "
              f"{stats['evals_per_window']:.2f} evaluations a window; bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); labels agree with "
              f"the plain version on {labels:.6f} (bit for bit: {exact}); host "
              f"{rec['host_us']:.1f} us a call", flush=True)
    print(json.dumps({"b": b, "nblocks": nblocks, "reps": reps,
                      "probes_ns_a_step": probes, "cases": out}))


if __name__ == "__main__":
    main()
