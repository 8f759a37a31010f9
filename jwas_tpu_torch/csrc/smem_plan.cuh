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
// (b <= 240 in float32, b <= 170 in float64 on the H100); otherwise a
// window's owner stages the window's 32 x 32 diagonal block there and the
// list updates read Gram rows from global memory/L2.
//
// Everything is templated on the element type T, float or double: the
// float64 build keeps the float32 build's schedule and its explicit
// roundings (__dadd_rn where float uses __fadd_rn), through the overloads
// of add_rn, sub_rn, mul_rn, div_rn and sqrt_rn below.

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

// Round-to-nearest arithmetic that nvcc may not contract into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float exp_of(float a) { return expf(a); }
__device__ __forceinline__ double exp_of(double a) { return exp(a); }
__device__ __forceinline__ float log_of(float a) { return logf(a); }
__device__ __forceinline__ double log_of(double a) { return log(a); }

// Head of the dynamic shared memory: the changes of two windows, d by lane
// and a mask of the lanes that changed.
template <class T>
struct ChainLists {
  T d[2][kWindow];
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

// Fills *p for block size b and element type T on the current device;
// returns a cudaError_t (cudaErrorInvalidValue for b > kMaxThreads *
// kMaxRows).
template <class T>
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
  const size_t tile = (static_cast<size_t>(b) * b + kWindow) * sizeof(T);
  // (an odd b would leave a block's tile off the 16-byte grid of the copy)
  p->resident = b % 2 == 0 &&
                sizeof(ChainLists<T>) + tile <= static_cast<size_t>(optin);
  p->smem = sizeof(ChainLists<T>) +
            (p->resident ? tile
                         : static_cast<size_t>(kWindow) * kWindow * sizeof(T));
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
template <class T, int R>
__device__ __forceinline__ void hand_over(T (&rhs)[R], const T* d,
                                          unsigned mask, const T* rows,
                                          int b, int nact, int r, bool owner) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (__popc(mask) > kFewChanges) {
    // many changes: all loads first (they are independent), then the
    // additions, which are a chain; in float64 half a window at a time, so
    // that the loads fit the registers
    constexpr int kLoads = sizeof(T) == 4 ? kWindow : kWindow / 2;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = rr * nt + tid;
      if (i < b && !(rr == r && owner)) {
#pragma unroll
        for (int q0 = 0; q0 < kWindow; q0 += kLoads) {
          T dq[kLoads], gq[kLoads];
#pragma unroll
          for (int q = 0; q < kLoads; ++q) {
            dq[q] = d[q0 + q];
            gq[q] = rows[min(q0 + q, nact - 1) * b + i];
          }
#pragma unroll
          for (int q = 0; q < kLoads; ++q)
            if (mask >> (q0 + q) & 1)
              rhs[rr] = add_rn(rhs[rr], mul_rn(dq[q], gq[q]));
        }
      }
    }
  } else {
    while (mask) {
      const int q = __ffs(mask) - 1;
      mask &= mask - 1;
      const T dq = d[q];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int i = rr * nt + tid;
        if (i < b && !(rr == r && owner))
          rhs[rr] = add_rn(rhs[rr], mul_rn(dq, rows[q * b + i]));
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
template <class T, int R, class M>
__device__ __forceinline__ void run_chain(M& m, T (&rhs)[R],
                                          const T* __restrict__ G,
                                          float4* smem4, int b, int nreps,
                                          int resident) {
  ChainLists<T>* ls = reinterpret_cast<ChainLists<T>*>(smem4);
  T* tile = reinterpret_cast<T*>(smem4 + sizeof(ChainLists<T>) / 16);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  if (resident) {
    // asynchronous 16-byte copies (the entry points refuse a tile that is
    // not 16-byte aligned): all of a thread's loads are in flight at once,
    // where a loop through registers keeps four
    const float4* G4 = reinterpret_cast<const float4*>(G);
    float4* tile4 = reinterpret_cast<float4*>(tile);
    const int n16 = b * b * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < n16; i += nt)
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
          const T* gw;             // G[j0 + f][j0 + lane] = gw[f * gs + lane]
          int gs;
          if (resident) {
            gw = tile + static_cast<size_t>(j0) * b + j0;
            gs = b;
          } else {
            for (int t = 0; t < kWindow; ++t)
              tile[t * kWindow + lane] =
                  (t < nact && lane < nact)
                      ? G[static_cast<size_t>(j0 + t) * b + j0 + lane]
                      : T(0);
            __syncwarp();
            gw = tile;
            gs = kWindow;
          }
          int pos = 0;             // the chain has passed the lanes below pos
          for (;;) {
            // The Gram entry a change at lane pos needs: its address is
            // known before the evaluation, so the load leaves the chain.
            const T g_pos = gw[pos * gs + lane];
            const T d = m.eval(r, rhs[r]);
            // A lane the chain has not passed keeps its newest candidate;
            // the one it holds when the chain passes it is its update.
            if (lane >= pos) m.keep();
            // Lane pos is the next marker of the chain. Where it changes
            // (every step of a dense model) its d comes by a shuffle from a
            // lane known in advance; the ballot, issued beside it, is read
            // only where it does not.
            const unsigned changing = __ballot_sync(
                kFullWarp, lane > pos && lane < nact && d != T(0));
            T df = __shfl_sync(kFullWarp, d, pos);
            T gf = g_pos;
            int f = pos;
            if (df == T(0)) {
              if (!changing) break;
              f = __ffs(changing) - 1;
              df = __shfl_sync(kFullWarp, d, f);
              gf = gw[f * gs + lane];
            }
            rhs[r] = add_rn(rhs[r], mul_rn(df, gf));
            pos = f + 1;
            if (pos >= nact) break;
          }
          const T dm = m.finish(r);
          const unsigned changed =
              __ballot_sync(kFullWarp, lane < nact && dm != T(0));
          ls->d[buf][lane] = dm;
          if (lane == 0) ls->mask[buf] = changed;
        }
        __syncthreads();
        const unsigned mask = ls->mask[buf];
        if (mask && resident)
          hand_over<T, R>(rhs, ls->d[buf], mask, tile + j0 * b, b, nact, r,
                          warp == ww);
        else if (mask)
          hand_over<T, R>(rhs, ls->d[buf], mask,
                          G + static_cast<size_t>(j0) * b, b, nact, r,
                          warp == ww);
      }
    }
    m.advance();
  }
}

}  // namespace jt
