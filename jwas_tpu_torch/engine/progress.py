"""Console progress and the profiler hook of the chain loop.

Counterpart of jwas_tpu/engine/progress.py: ProgressPrinter (:18-65, the
reference's printout_frequency printouts, MCMC_BayesianAlphabet.jl:417-420)
and maybe_profile (:68-84), here a torch.profiler trace of the chain
written as a Chrome trace under <output_folder>/profile.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class ProgressPrinter:
    """A posterior printout every `every` iterations, with wall-clock
    seconds since the last one."""

    def __init__(self, every: int, chain_length: int):
        self.every = int(every or 0)
        self.chain_length = chain_length
        self.last_epoch = 0
        self.t_start = time.perf_counter()
        self.t_last = self.t_start

    def update(self, iters_done: int, *, vare, varg=None, pi=None) -> None:
        if self.every <= 0:
            return
        epoch = iters_done // self.every
        if epoch <= self.last_epoch and iters_done < self.chain_length:
            return
        self.last_epoch = epoch
        now = time.perf_counter()
        window_s = now - self.t_last
        self.t_last = now
        parts = [f"iteration {iters_done}/{self.chain_length}",
                 f"residual variance: {_fmt(vare)}"]
        if varg is not None:
            parts.append(f"marker variance: {_fmt(varg)}")
        if pi is not None:
            p = np.asarray(pi)
            parts.append("pi: " + (np.array2string(p, precision=3) if p.ndim
                                   else f"{float(p):.3g}"))
        parts.append(f"[{window_s:.2f}s window, {now - self.t_start:.1f}s total]")
        print("  ".join(parts), flush=True)


def _fmt(x) -> str:
    """A scalar as %.6g, a (t, t) covariance of several traits as rows."""
    x = np.asarray(x)
    return np.array2string(x, precision=4) if x.ndim else f"{float(x):.6g}"


@contextlib.contextmanager
def maybe_profile(opts):
    """With opts.profile, a torch.profiler trace (host and, on a GPU, the
    device) of the enclosed chain, written to
    <output_folder>/profile/trace.json."""
    if not getattr(opts, "profile", False):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    folder = os.path.join(opts.output_folder or "results", "profile")
    os.makedirs(folder, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield folder
    prof.export_chrome_trace(os.path.join(folder, "trace.json"))
    print(f"torch profiler trace written to {folder}", flush=True)
