// The structure shared by the inner-rounds kernels (abc_inner_rounds.cu,
// bayesr_inner_rounds.cu): launch geometry, the shared-memory plan and the
// schedule of the chain. The two kernels differ only in the marker update
// they plug into run_chain.
//
// One CTA per marker block. Thread i owns markers i, i + T, ... (R of them,
// a compile-time count) and keeps their rhs, effect and round constants in
// registers for the whole call. The 32 consecutive markers that one warp
// owns form a window:
//
//  - Every lane evaluates its own marker's update from the rhs it holds: 32
//    candidates for the price of one. The first lane f whose candidate
//    changes its effect is the next uncommitted lane where that one changes
//    (a shuffle from a lane known in advance: every step of a dense model),
//    else the first set bit of a ballot. The lanes before f commit at once:
//    no rhs moved before their turn, so each saw exactly the inputs the
//    sequential chain gives it. Lane f commits and broadcasts
//    d = a_old - a_new by shuffle, every lane adds d * G[j_f][i] to its
//    rhs, and the lanes after f evaluate again. A window costs
//    1 + (markers that change) evaluations and no barrier.
//  - A lane writes its candidate to a shadow copy of its state as long as
//    the chain has not passed it, so committing waits for nothing. At the
//    end of the window the warp leaves each lane's d and a mask of the
//    lanes that changed in shared memory. One __syncthreads hands them to
//    the other warps (and to this warp's other rows), which add
//    d * G[j][i] to their rhs in ascending j before the next window
//    starts. The lists are double buffered, so one barrier a window is
//    enough.
//
// Each rhs[i] so receives the additions of the sequential chain in the same
// order with the same rounding (a multiply, then an add: never an FMA), and
// the result equals the one-step-one-barrier schedule bit for bit.
//
// Shared memory holds the two lists and the b x b Gram tile when it fits
// (b <= 240 on the H100); otherwise a window's owner stages the window's
// 32 x 32 diagonal block there and the list updates read Gram rows from
// global memory/L2.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace jt {

constexpr int kWindow = 32;        // markers one warp resolves together
constexpr int kMaxThreads = 512;   // threads of a CTA
constexpr int kMaxRows = 4;        // markers a thread owns: b <= 2048
constexpr int kMaxDevices = 64;
constexpr int kFewChanges = 6;     // up to here a window's changes are
                                   // handed over one by one
constexpr unsigned kFullWarp = 0xffffffffu;

// Head of the dynamic shared memory: the changes of two windows, d by lane
// and a mask of the lanes that changed.
struct ChainLists {
  float d[2][kWindow];
  unsigned mask[2];
  int pad[2];                      // keeps what follows 16-byte aligned
};

struct ChainPlan {
  int dev;
  int optin;      // largest dynamic shared memory a CTA may ask for
  int threads;
  int rows;       // markers a thread owns, rounded up to 1, 2 or 4
  int resident;   // Gram tile in shared memory
  size_t smem;
};

// Fills *p for block size b on the current device; returns a cudaError_t
// (cudaErrorInvalidValue for b > kMaxThreads * kMaxRows).
inline int chain_plan(int b, ChainPlan* p) {
  static int optin_of[kMaxDevices];     // 0: not asked yet
  int err = cudaGetDevice(&p->dev);
  if (err != 0) return err;
  int optin = p->dev < kMaxDevices ? optin_of[p->dev] : 0;
  if (optin == 0) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, p->dev);
    if (err != 0) return err;
    if (p->dev < kMaxDevices) optin_of[p->dev] = optin;
  }
  p->optin = optin;
  const int t = ((b + 31) / 32) * 32;
  p->threads = t > kMaxThreads ? kMaxThreads : t;
  const int rows = (b + p->threads - 1) / p->threads;
  if (b <= 0 || rows > kMaxRows) return cudaErrorInvalidValue;
  p->rows = 1;
  while (p->rows < rows) p->rows *= 2;
  // a row's worth of padding lets a lane past the end of a last, partial
  // window read its (unused) Gram entry without a bounds test
  const size_t tile = (static_cast<size_t>(b) * b + kWindow) * 4;
  // (an odd b would leave a block's tile off the 16-byte grid of the copy)
  p->resident = b % 2 == 0 &&
                sizeof(ChainLists) + tile <= static_cast<size_t>(optin);
  p->smem = sizeof(ChainLists) +
            (p->resident ? tile : static_cast<size_t>(kWindow) * kWindow * 4);
  return 0;
}

// Allows `kernel` the device's largest dynamic shared memory, once a device.
// `ready` is the caller's per-kernel array of kMaxDevices flags.
template <class Kernel>
inline int allow_smem(Kernel kernel, const ChainPlan& p, bool* ready) {
  if (p.dev < kMaxDevices && ready[p.dev]) return 0;
  const int err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.optin);
  if (err == 0 && p.dev < kMaxDevices) ready[p.dev] = true;
  return err;
}

// Adds the changes `mask` of a window to rhs[rr] for every owned row but the
// window's own (rr == r for the owner warp), in ascending j. rows points at
// the Gram row of the window's first marker: in the shared-memory tile or
// in global memory, which the caller tells apart at compile time so that
// the loads need no generic addressing.
template <int R>
__device__ __forceinline__ void hand_over(float (&rhs)[R], const float* d,
                                          unsigned mask, const float* rows,
                                          int b, int nact, int r, bool owner) {
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  if (__popc(mask) > kFewChanges) {
    // many changes: all loads first (they are independent), then the
    // additions, which are a chain
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = rr * T + tid;
      if (i < b && !(rr == r && owner)) {
        float dq[kWindow], gq[kWindow];
#pragma unroll
        for (int q = 0; q < kWindow; ++q) {
          dq[q] = d[q];
          gq[q] = rows[min(q, nact - 1) * b + i];
        }
#pragma unroll
        for (int q = 0; q < kWindow; ++q)
          if (mask >> q & 1)
            rhs[rr] = __fadd_rn(rhs[rr], __fmul_rn(dq[q], gq[q]));
      }
    }
  } else {
    while (mask) {
      const int q = __ffs(mask) - 1;
      mask &= mask - 1;
      const float dq = d[q];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int i = rr * T + tid;
        if (i < b && !(rr == r && owner))
          rhs[rr] = __fadd_rn(rhs[rr], __fmul_rn(dq, rows[q * b + i]));
      }
    }
  }
}

// The chain of one marker block: nreps passes over its b markers, on the
// schedule described at the top of this file. M holds the per-thread marker
// state and supplies
//   fetch(rep)      start loading the draws of pass `rep` (none past the end)
//   advance()       make the fetched draws the current ones
//   eval(r, rhs)    candidate update of owned marker r from its state, which
//                   it leaves alone; returns a_old - a_new
//   keep()          copy the last candidate to the shadow state
//   finish(r)       make the shadow marker r's state; returns a_old - a_new
// rhs[r] is the rhs of owned marker r, marker r * blockDim.x + threadIdx.x.
template <int R, class M>
__device__ __forceinline__ void run_chain(M& m, float (&rhs)[R],
                                          const float* __restrict__ G,
                                          float4* smem4, int b, int nreps,
                                          int resident) {
  ChainLists* ls = reinterpret_cast<ChainLists*>(smem4);
  float* tile = reinterpret_cast<float*>(smem4) + sizeof(ChainLists) / 4;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;

  if (resident) {
    // asynchronous 16-byte copies (the entry points refuse a tile that is
    // not 16-byte aligned): all of a thread's loads are in flight at once,
    // where a loop through registers keeps four
    const float4* G4 = reinterpret_cast<const float4*>(G);
    float4* tile4 = reinterpret_cast<float4*>(tile);
    for (int i = tid; i < b * b / 4; i += T)
      __pipeline_memcpy_async(tile4 + i, G4 + i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  int seq = 0;                     // windows so far: picks the list buffer
  for (int rep = 0; rep < nreps; ++rep) {
    m.fetch(rep + 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int ww = 0; ww < nwarps; ++ww) {
        const int j0 = (r * nwarps + ww) * kWindow;
        if (j0 >= b) break;
        const int buf = seq & 1;
        ++seq;
        const int nact = min(kWindow, b - j0);
        if (warp == ww) {
          const float* gw;         // G[j0 + f][j0 + lane] = gw[f * gs + lane]
          int gs;
          if (resident) {
            gw = tile + static_cast<size_t>(j0) * b + j0;
            gs = b;
          } else {
            for (int t = 0; t < kWindow; ++t)
              tile[t * kWindow + lane] =
                  (t < nact && lane < nact)
                      ? G[static_cast<size_t>(j0 + t) * b + j0 + lane]
                      : 0.0f;
            __syncwarp();
            gw = tile;
            gs = kWindow;
          }
          int pos = 0;             // the chain has passed the lanes below pos
          for (;;) {
            // The Gram entry a change at lane pos needs: its address is
            // known before the evaluation, so the load leaves the chain.
            const float g_pos = gw[pos * gs + lane];
            const float d = m.eval(r, rhs[r]);
            // A lane the chain has not passed keeps its newest candidate;
            // the one it holds when the chain passes it is its update.
            if (lane >= pos) m.keep();
            // Lane pos is the next marker of the chain. Where it changes
            // (every step of a dense model) its d comes by a shuffle from a
            // lane known in advance; the ballot, issued beside it, is read
            // only where it does not.
            const unsigned changing = __ballot_sync(
                kFullWarp, lane > pos && lane < nact && d != 0.0f);
            float df = __shfl_sync(kFullWarp, d, pos);
            float gf = g_pos;
            int f = pos;
            if (df == 0.0f) {
              if (!changing) break;
              f = __ffs(changing) - 1;
              df = __shfl_sync(kFullWarp, d, f);
              gf = gw[f * gs + lane];
            }
            rhs[r] = __fadd_rn(rhs[r], __fmul_rn(df, gf));
            pos = f + 1;
            if (pos >= nact) break;
          }
          const float dm = m.finish(r);
          const unsigned changed =
              __ballot_sync(kFullWarp, lane < nact && dm != 0.0f);
          ls->d[buf][lane] = dm;
          if (lane == 0) ls->mask[buf] = changed;
        }
        __syncthreads();
        const unsigned mask = ls->mask[buf];
        if (mask && resident)
          hand_over<R>(rhs, ls->d[buf], mask, tile + j0 * b, b, nact, r,
                       warp == ww);
        else if (mask)
          hand_over<R>(rhs, ls->d[buf], mask,
                       G + static_cast<size_t>(j0) * b, b, nact, r,
                       warp == ww);
      }
    }
    m.advance();
  }
}

}  // namespace jt
