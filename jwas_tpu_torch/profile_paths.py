"""Where the time goes in the port's main paths at full width, on one GPU.

    python3 -m jwas_tpu_torch.profile_paths [BayesC,BayesC0999,BayesR]

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
     one X alpha, included), and the ten largest device-time rows with
     their share of the device time.

Paths: BayesC from pi0 = 0 (every marker moves), BayesC0999 from
pi0 = 0.999 (most effects stay 0), BayesR from the default class prior.
Each is a start-of-chain measurement: pi has not settled after three outer
iterations. Imports torch, numpy, the port and chip_smoke.py; never jax.
"""

import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
import jwas_tpu_torch as jt

PATHS = {"BayesC": ("BayesC", 0.0), "BayesC0999": ("BayesC", 0.999),
         "BayesR": ("BayesR", 0.0)}


def device_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def profile_path(name, gm, y, sum2pq):
    method, pi0 = PATHS[name]
    b = gm.grams.shape[1]
    priors = cs.default_priors(y, sum2pq, pi0=pi0, method=method)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "250"],
        stdout=subprocess.PIPE, text=True)
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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        jt.run_st(gm, y, **priors, method=method, chain_length=2 * b,
                  output_samples_frequency=b, seed=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    total = sum(device_us(e) for e in events)
    cs.say(f"{name}: profiled run_st of 2 outer iterations: wall {wall:.3f} s, "
           f"device {total / 1e6:.3f} s, busy {total / 1e6 / wall:.4f}")
    for e in sorted(events, key=device_us, reverse=True)[:10]:
        cs.say(f"   {e.key[:64]:64s} {device_us(e) / 1e3:10.2f} ms "
               f"{device_us(e) / total:7.4f}  calls {e.count:7d}  "
               f"mean {device_us(e) / e.count:8.2f} us")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch.cuda.is_available() is false")
    names = (sys.argv[1] if len(sys.argv) > 1 else "BayesC,BayesR").split(",")
    for name in names:
        if name not in PATHS:
            raise SystemExit(f"unknown path {name!r}; choose from {sorted(PATHS)}")
    dev = torch.device("cuda", 0)
    cs.say(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gm, y, _, sum2pq, _, _ = cs.full_width_problem(dev)
    for name in names:
        profile_path(name, gm, y, sum2pq)


if __name__ == "__main__":
    main()
