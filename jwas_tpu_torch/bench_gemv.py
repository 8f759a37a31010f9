"""Time the 2-bit GEMV kernels K4 (packed_rhs, X'w) and K5 (packed_matvec,
Xv) at the main path's shape on one GPU, beside their bounds.

    python3 -m jwas_tpu_torch.bench_gemv [--n 50000] [--G 16384]

Run it from the root of the repository. It builds one G-marker tile of n
observations without missing codes on the device and times, with CUDA events
over 20 launches queued behind a device spin, K4 without and with the
missing-code table, and K5 with 0%, 95% and 99.9% of v zero; each result is
first held against the plain version. The tile (205 MB at the default
shape) exceeds the L2 cache, so every launch finds it cold.

The bound of a case is ops.packed_gemv.bound_ms: the bytes the function
needs (the tile's rows that the vector needs, the vectors, the result) over
3.35 TB/s (H100 SXM). Beside it K5's line prints what the kernel itself
moves: those bytes and its per-chunk partial sums, written and read back.
Imports torch and the port; never jax.
"""

import argparse
import json
import subprocess


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--G", type=int, default=16_384)
    args = ap.parse_args()
    n, G = args.n, args.G

    import torch

    from jwas_tpu_torch import _build
    from jwas_tpu_torch.ops import packed_gemv as pg

    if not torch.cuda.is_available():
        raise SystemExit("bench_gemv: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.library()
    print("\n".join(line for line in _build.build_log.splitlines()
                    if "packed_" in line or "registers" in line or "spill" in line),
          flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bpm = (n + 3) // 4
    codes = torch.randint(0, 3, (G, bpm, 4), generator=g, device=dev,
                          dtype=torch.uint8)
    codes.view(G, -1)[:, n:] = 0
    rows = (codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4)
            | (codes[..., 3] << 6))
    del codes
    means = 2.0 * torch.rand(G, generator=g, device=dev)
    keep = torch.rand(G, generator=g, device=dev)
    v_full = torch.randn(G, generator=g, device=dev)
    w = torch.zeros(4 * bpm, device=dev)
    w[:n] = torch.randn(n, generator=g, device=dev)

    def ms_of(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # the device spins ~10 ms while the host queues the launches, so a
        # short kernel's time is the device's and not the host's
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    def held(got, want):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * n ** 0.5)
        return (got - want).abs().max().item()

    rows_per_chunk = pg.matvec_plan(G, bpm, pg.matvec_slots(dev))
    nchunks = -(-G // rows_per_chunk)
    print("plan:", dict(rhs=pg.rhs_plan(
        G, bpm, False, torch.cuda.get_device_properties(dev).multi_processor_count),
                        rows_per_chunk=rows_per_chunk,
                        slots=pg.matvec_slots(dev)), flush=True)
    cases = {}
    want = pg.packed_rhs_ref(rows, means, w)
    for flag in (False, True):
        cases["K4" + (" missing table" if flag else "")] = dict(
            err=held(pg.packed_rhs(rows, means, w, flag), want),
            ms=ms_of(lambda: pg.packed_rhs(rows, means, w, flag)),
            bound_ms=pg.bound_ms(G, bpm, G))
    for share in pg.ZERO_SHARES:
        v = torch.where(keep >= share, v_full, torch.zeros_like(v_full))
        nnz = int((v != 0).sum())
        bound = pg.bound_ms(G, bpm, nnz)
        cases[f"K5 {share:.1%} zero"] = dict(
            err=held(pg.packed_matvec(rows, means, v),
                     pg.packed_matvec_ref(rows, means, v)),
            ms=ms_of(lambda: pg.packed_matvec(rows, means, v)), nnz=nnz,
            bound_ms=bound,
            moved_ms=bound + 32 * bpm * nchunks / pg.HBM_BYTES_PER_S * 1e3)
    for name, c in cases.items():
        moved = (f", its own traffic {c['moved_ms']:.5f} ms"
                 if "moved_ms" in c else "")
        print(f"{name:20s} {c['ms']:.4f} ms, bound {c['bound_ms']:.5f} ms "
              f"({c['bound_ms'] / c['ms']:.1%} of it reached){moved}, "
              f"max |err| {c['err']:.3g}", flush=True)
    print(json.dumps({"n": n, "G": G, "cases": cases}))


if __name__ == "__main__":
    main()
