"""Build and load the package's CUDA kernels (nvcc + ctypes).

The kernels under ``csrc/`` have a plain C interface. On first use they are
compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` a source and all
at once, and linked into one shared library under
``jwas_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. The library's file name carries a hash of the sources and the
flags, so an edited source is never served by a stale build.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is not 0. There is no
fallback: a failed build or launch raises. They allocate nothing: a
kernel's scratch is a tensor its wrapper passes in.

No ``--use_fast_math``: the inclusion test ``u < p`` of the spike-slab
update and the class argmax of BayesR have to see the same ``expf``,
``logf`` and division as the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Sources whose kernels nvcc optimises in parallel, on every core: K7 /
# K8's 140 instantiations build in about 2 minutes so (their per-marker
# prior's, mt_inner_rounds_pm.cu, beside them), and in more than 15
# on one thread; K9's 70 in 47 s (144 s on one thread). Not the others: it
# changes their code (K4 spills with it and takes twice the time).
_SPLIT = {"mt_inner_rounds": ["-split-compile=0"], "mt_inner_rounds_pm": ["-split-compile=0"],
          "mt_c0l_rounds": ["-split-compile=0"]}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0      # wall time of the last nvcc build (0 = cached)
build_log: str = ""             # nvcc's output of the last build (-Xptxas -v)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # grams, xpx, var_eff, log_pi, log_pi_comp, alpha, beta, delta, rhs, us,
    # zs, inv_vare, b, nblocks, nreps, stream; float32 and float64 builds
    "jt_abc_inner_rounds": [_P] * 12 + [_I] * 3 + [_P],
    "jt_abc_inner_rounds_f64": [_P] * 12 + [_I] * 3 + [_P],
    # b, nreps, itemsize -> 1 resident Gram tile, 0 global, <0 -cudaError
    "jt_abc_resident": [_I, _I, _I],
    # grams, xpx, log_pi, alpha, delta, rhs, gumbel, zs, inv_vare, sigma_sq,
    # b, nblocks, nreps, stream; float32 and float64 builds
    "jt_bayesr_inner_rounds": [_P] * 10 + [_I] * 3 + [_P],
    "jt_bayesr_inner_rounds_f64": [_P] * 10 + [_I] * 3 + [_P],
    "jt_bayesr_resident": [_I, _I, _I],
    # which, io (16 floats), steps, stream: csrc/chain_probe.cu
    "jt_chain_probe": [_I, _P, _I, _P],
    # A, x_in, b, zs, vare, x_out, partial, flags, K, stream:
    # csrc/gibbs_pass.cu (K6); float32 and float64 builds, the largest K
    # they take and the slice S of a block (P = ceil(K / S) blocks)
    "jt_gibbs_pass": [_P] * 8 + [_I, _P],
    "jt_gibbs_pass_f64": [_P] * 8 + [_I, _P],
    "jt_gibbs_pass_max_k": [],
    "jt_gibbs_pass_device_max_k": [_I],
    # grams, xpx, valid, alpha, beta, delta, rhs, Rinv, Ginv, log_pi,
    # us (I) or gum (II), zs, scratch, t, b, nblocks, nreps, per_locus,
    # stream: csrc/mt_inner_rounds.cu (K7, K8); float32 and float64 builds
    "jt_mt_inner_rounds_I": [_P] * 13 + [_I] * 5 + [_P],
    "jt_mt_inner_rounds_I_f64": [_P] * 13 + [_I] * 5 + [_P],
    "jt_mt_inner_rounds_II": [_P] * 13 + [_I] * 5 + [_P],
    "jt_mt_inner_rounds_II_f64": [_P] * 13 + [_I] * 5 + [_P],
    # the same with log_pi (nblocks, b, 2^t), one row a marker, t <= 4:
    # csrc/mt_inner_rounds_pm.cu
    "jt_mt_inner_rounds_I_pm": [_P] * 13 + [_I] * 5 + [_P],
    "jt_mt_inner_rounds_I_pm_f64": [_P] * 13 + [_I] * 5 + [_P],
    "jt_mt_inner_rounds_II_pm": [_P] * 13 + [_I] * 5 + [_P],
    "jt_mt_inner_rounds_II_pm_f64": [_P] * 13 + [_I] * 5 + [_P],
    "jt_gibbs_pass_slice": [],
    # grams, xpx, valid, alpha, rhs, Rinv, Ginv, gamma, zs, scratch, t, b,
    # nblocks, nreps, stream: csrc/mt_c0l_rounds.cu (K9); float32 and
    # float64 builds
    "jt_mt_c0l_inner_rounds": [_P] * 10 + [_I] * 4 + [_P],
    "jt_mt_c0l_inner_rounds_f64": [_P] * 10 + [_I] * 4 + [_P],
    # X, phi, mpp, cg, mask, alpha_in, W_in, vare, Ginv, log_pi, gumbel,
    # zs, alpha_out, beta_out, delta_out, W_out, partial, counter, p, nind,
    # ntimes, c, estimate_delta, ctas, slice, b, xt, probe, stream:
    # csrc/rrm_sweep.cu (K10); float32 and float64 builds, and the plan of
    # a sweep (nind, ntimes, c, itemsize, the largest b asked -> out: ctas,
    # slice, b, xt)
    "jt_rrm_sweep": [_P] * 18 + [_I] * 10 + [_P],
    "jt_rrm_sweep_f64": [_P] * 18 + [_I] * 10 + [_P],
    "jt_rrm_sweep_plan": [_I] * 5 + [_P],
    # rows, means, w_pad, partial, out, G, bpm, has_missing, slab,
    # rows_per_cta, stream
    "jt_packed_rhs": [_P] * 5 + [_I] * 5 + [_P],
    # -> resident CTAs of the Xv kernel per SM, <0 -cudaError
    "jt_packed_matvec_ctas_per_sm": [],
    # rows, means, v, partial, out, G, bpm, rows_per_chunk, stream
    "jt_packed_matvec": [_P] * 5 + [_I] * 3 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS + sorted(map(str, _SPLIT.items()))).encode())
    for src in sorted(_CSRC.glob("*.cu*")):       # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libjwas_tpu_torch-{h.hexdigest()[:16]}.so"


def _run(cmd) -> str:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return f"{Path(cmd[-1]).name}: {time.perf_counter() - t0:.1f} s\n{log}"


def _compile_and_link(path: Path) -> str:
    """Compile every source to an object, all at once (one nvcc a source),
    and link them into `path`; returns nvcc's output."""
    nvcc = _nvcc()
    stem = f"{path.stem}.{os.getpid()}"
    srcs = _sources()
    objs = [_BUILD / f"{stem}.{src.stem}.o" for src in srcs]
    tmp = _BUILD / f"{stem}.tmp"
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *_NVCC_FLAGS, *_SPLIT.get(so[0].stem, []), "-c",
                                 "-o", str(so[1]), str(so[0])]), zip(srcs, objs)))
        logs.append(_run([nvcc, *_NVCC_FLAGS, "-shared", *map(str, objs),
                          "-o", str(tmp)]))
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return "".join(logs)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if nvcc fails."""
    global _lib, build_seconds, build_log
    if _lib is not None:          # the hot path: no lock once it is loaded
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _compile_and_link(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


_host_lib: Optional[ctypes.CDLL] = None
# g++ flags of the host library; OpenMP first, the sequential build where
# the compiler has no OpenMP (the same results, one thread)
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_CXX_OPENMP = (["-fopenmp"], [])


def host_library() -> ctypes.CDLL:
    """csrc/pedigree.cpp (host C++, Meuwissen-Luo inbreeding), built with
    g++ on first use into _build/ under a name that carries a hash of the
    source and the flags, and loaded with ctypes. Raises if g++ fails."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    with _lock:
        if _host_lib is not None:
            return _host_lib
        src = _CSRC / "pedigree.cpp"
        h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
        h.update(src.read_bytes())
        path = _BUILD / f"libjwas_tpu_torch_host-{h.hexdigest()[:16]}.so"
        if not path.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("g++ not found: csrc/pedigree.cpp cannot be built")
            tmp = _BUILD / f"{path.stem}.{os.getpid()}.tmp"
            logs = []
            for extra in _CXX_OPENMP:
                cmd = [cxx, *_CXX_FLAGS, *extra, str(src), "-o", str(tmp)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode == 0:
                    os.replace(tmp, path)
                    break
                logs.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            else:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("g++ failed to build csrc/pedigree.cpp:\n"
                                   + "\n".join(logs))
        lib = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64
        lib.jt_inbreeding_ml.argtypes = [_P, _P, i64, ctypes.c_double, _P]
        lib.jt_inbreeding_ml.restype = None
        _host_lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> int:
    """The current PyTorch stream on t's device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream
