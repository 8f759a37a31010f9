"""Time K10, the random-regression marker chain (csrc/rrm_sweep.cu), on
one GPU: at chip_smoke.py phase 14's shape for each chunk size b, with the
parts of a chunk apart, or at several herd sizes at the plan's own b.

    python3 -m jwas_tpu_torch.bench_k10 [--nind 10000] [--ntimes 10] [--c 3]
                                        [--p 50000] [--chunks 64,32,16,8,1]
    python3 -m jwas_tpu_torch.bench_k10 --herds 10000:50000,100000:5000,...

Run it from the root of the repository: it runs chip_smoke.py's K10
checks and timing, from the checkout it is run in. With --chunks, for
each build (float32, float64) and each b the plan takes (sweep_chunk with
that b at most; b = 1 is one exchange a marker, as K10's first design),
it holds the kernel against the plain version at p = 256
(chip_smoke.check_k10), then prints at the full shape (chip_smoke.time_k10):
ms a sweep and ns a marker, the cross-Grams' bytes and build seconds, and
the probes of ops/rrm.py::_launch: a chunk's fixed cost (the update, the
partial sums, the exchange), the wait on the arrival counter and the loads
of the blocks' partials in it, the next chunk's inputs made alone (which
the chain hides when it is longer), and the chain's step, ns a marker.
With --herds (nind:p pairs), for each build and each herd the plan takes,
it prints chip_smoke.time_k10's ms a sweep and ns a marker and the
launch's plan (sweep_rrm_abc.last_grid). Only those two calls are made
there, so the same file, copied to the root of another checkout of the
repository whose chip_smoke.py has time_k10(nind, ntimes, c, p, dev,
dtype), times that checkout's K10 on the same herds:

    cp jwas_tpu_torch/bench_k10.py OTHER/ && cd OTHER && python3 bench_k10.py --herds ...

The card's name and power limit come first. Imports torch, the port and
chip_smoke.py; never jax.
"""

import argparse
import os
import subprocess
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nind", type=int, default=10_000)
    ap.add_argument("--ntimes", type=int, default=10)
    ap.add_argument("--c", type=int, default=3)
    ap.add_argument("--p", type=int, default=50_000)
    ap.add_argument("--chunks", default="64,32,16,8,1")
    ap.add_argument("--herds", default=None,
                    help="nind:p pairs, comma-separated: time at each herd at the plan's b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k10: torch.cuda.is_available() is false")
    sys.path.insert(0, os.getcwd())       # the checkout run in: its chip_smoke.py and port
    import chip_smoke
    from jwas_tpu_torch import _build
    from jwas_tpu_torch.ops import rrm

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; checkout {os.getcwd()}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    nt, c = args.ntimes, args.c
    for dtype in (torch.float32, torch.float64):
        if not args.herds and rrm.sweep_limit_error(args.nind, nt, c, dtype, dev) is not None:
            print(f"K10 {str(dtype)[6:]} nind = {args.nind}: refused", flush=True)
            continue
        if args.herds:
            for herd in args.herds.split(","):
                n, p = (int(x) for x in herd.split(":"))
                if rrm.sweep_limit_error(n, nt, c, dtype, dev) is not None:
                    print(f"K10 {str(dtype)[6:]} nind = {n}: refused", flush=True)
                    continue
                r = chip_smoke.time_k10(n, nt, c, p, dev, dtype)
                print(f"K10 {str(dtype)[6:]} nind = {n}, ntimes = {nt}, c = {c}, p = {p}: "
                      f"{r['ms']:.3f} ms a sweep ({r['step_ns']:.1f} ns a marker); plan "
                      f"{rrm.sweep_rrm_abc.last_grid}", flush=True)
            continue
        done = set()
        for cap in (int(x) for x in args.chunks.split(",")):
            b = rrm.sweep_chunk(args.nind, nt, c, dtype, dev, cap)
            if b in done:
                continue
            done.add(b)
            chip_smoke.check_k10(args.nind, nt, c, 256, dev, dtype, max_chunk=b)
            r = chip_smoke.time_k10(args.nind, nt, c, args.p, dev, dtype, max_chunk=b)
            print(f"K10 {str(dtype)[6:]} b = {b}: {r['ms']:.3f} ms a sweep ({r['step_ns']:.1f} ns "
                  f"a marker); a chunk: fixed {r['chunk_us']:.2f} us (wait {r['wait_us']:.2f}, "
                  f"loads {r['loads_us']:.2f}), next inputs alone {r['prepare_us']:.2f} us; step "
                  f"{r['chain_ns']:.1f} ns; cross-Grams {r['cross_gram_bytes'] / 1e6:.1f} MB in "
                  f"{r['cross_gram_s']:.3f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
