// Multi-trait RR-BLUP / BayesL inner rounds on Hopper (K9): the marker
// chain of every block, nreps * b strictly sequential marker steps a
// block, all blocks in parallel.
//
// Replaces the lax.scan chain of jwas_tpu/ops/multitrait.py: the scan at
// :467 over the step of mt_c0l_blocks (:436), whose marker update is
// _mt_c0l_marker_update (:414), and its exact form, the scan at :498 of
// mt_c0l_exact (:478), which is this kernel with one block a call
// (ops/multitrait.py).
//
// Step s works on marker j = s mod b of each block:
//   a_old = alpha[:, j]; w = rhs_j + xpx_j a_old; Rhs = Rinv w;
//   for k in 0..t-1: r = Rhs_k - sum_m Lhs[k][m] a[m];
//                    a[k] = (r / Lhs_kk + a[k]) + z_k sqrt(1 / Lhs_kk);
//   a_new = a valid_j; rhs += (a_old - a_new) (x) Gram row j,
// with Lhs = xpx_j Rinv + Ginv / gamma_j (gamma = 1 for RR-BLUP).
//
// What bounds it: latency. A slab draw is never 0, so every step changes
// the effects and the next step reads an rhs that this one moved: a window
// schedule (K7's) would commit one lane at a time. The kernel is the plain
// serial chain instead, one barrier a step:
//
//  - One CTA a block, up to 256 threads; thread i owns markers i, i + T,
//    ... (R = 1, 2, 4 or 8 of them: b <= 2,048) and holds their t rhs
//    values in registers for the whole call.
//  - The owner of marker j runs the step on its registers, writes a_new to
//    alpha and d = a_old - a_new to one of two shared buffers; after the
//    step's barrier every thread adds d_m G[j][i] to its rhs values. Each
//    rhs[m][i] so receives its additions in ascending j, as the sequential
//    chain adds them. Double buffering makes one barrier a step enough.
//  - Nothing that does not depend on the rhs runs inside a step: the
//    prologue writes each marker's Lhs (t x t) and sqrt(1 / Lhs_kk) to the
//    caller's scratch, computed by the marker's owner with the operations
//    of the plain version; the owner of the next step loads its constants,
//    alpha, draws, xpx and valid into registers while the current step
//    runs, and every thread loads its values of the current Gram row for
//    the next step's update.
//
// Rounding follows the plain PyTorch version (ops/multitrait.py::
// mt_c0l_inner_rounds_ref) operation by operation: the __f*_rn / __d*_rn
// intrinsics keep nvcc from contracting a*b+c into an FMA, so the kernel
// and its plain version give the same bits on the card.
//
// The scratch is the caller's: (nblocks, b, t t + t) values of T
// (ops/multitrait.py::scratch_values). Two builds, float32 and float64
// (runMCMC's double_precision), each instantiated for t = 2..8 traits and
// R = 1, 2, 4, 8 markers a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

#include "smem_plan.cuh"

namespace {

using jt::add_rn;
using jt::div_rn;
using jt::mul_rn;
using jt::sqrt_rn;
using jt::sub_rn;

template <typename T> struct Args {
  const T* grams;      // (nblocks, b, b), row j of block k at [k][j]
  const T* xpx;        // (nblocks, b)
  const T* valid;      // (nblocks, b), 0 or 1
  T* alpha;            // (nblocks, t, b), in place
  T* rhs;              // (nblocks, t, b), in place
  const T* Rinv;       // (t, t), row-major
  const T* Ginv;       // (t, t), row-major
  const T* gamma;      // (nblocks, b)
  const T* zs;         // (nreps b, t, nblocks)
  T* scratch;          // (nblocks, b, t t + t): Lhs, then sqrt(1 / Lhs_kk)
  int b, nblocks, nreps;
};

constexpr int kThreads = 256;   // threads of a CTA at most
constexpr int kMaxRows = 8;     // markers a thread owns: b <= 2048
                                // (ops/multitrait.py::MAX_BLOCK)

// The inputs of one step, loaded by its owner a step ahead.
template <class T, int NT>
struct StepIn {
  static constexpr int E = NT * NT + NT;
  T a[NT];       // alpha before the step
  T z[NT];       // the step's normals
  T c[E];        // Lhs by rows, then sqrt(1 / Lhs_kk)
  T x, v;        // xpx, valid
};

template <class T, int NT>
__device__ __forceinline__ void load_step(const Args<T>& A, int k, int j, int s,
                                          StepIn<T, NT>& in) {
  const size_t kb = static_cast<size_t>(k) * A.b;
  const T* c = A.scratch + (kb + j) * StepIn<T, NT>::E;
#pragma unroll
  for (int e = 0; e < StepIn<T, NT>::E; ++e) in.c[e] = c[e];
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    in.a[m] = A.alpha[(kb * NT) + static_cast<size_t>(m) * A.b + j];
    in.z[m] = A.zs[(static_cast<size_t>(s) * NT + m) * A.nblocks + k];
  }
  in.x = A.xpx[kb + j];
  in.v = A.valid[kb + j];
}

template <class T, int NT, int R>
__global__ void __launch_bounds__(kThreads, 1) c0l_chain(Args<T> A) {
  constexpr int E = StepIn<T, NT>::E;
  __shared__ T s_rinv[NT * NT];
  __shared__ T s_d[2][NT];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = A.b;
  const size_t kb = static_cast<size_t>(k) * b;
  const T* gram = A.grams + kb * b;

  if (tid < NT * NT) s_rinv[tid] = A.Rinv[tid];
  // the rhs of the markers this thread owns, and their constants
  T rhs[R][NT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * nt;
#pragma unroll
    for (int m = 0; m < NT; ++m)
      rhs[r][m] = i < b ? A.rhs[kb * NT + static_cast<size_t>(m) * b + i] : T(0);
    if (i < b) {
      const T x = A.xpx[kb + i];
      const T g = A.gamma[kb + i];
      T* c = A.scratch + (kb + i) * E;
      // Lhs = xpx Rinv + Ginv / gamma, then sqrt(1 / Lhs_kk), as the plain
      // version's mt_c0l_constants computes them
#pragma unroll
      for (int e = 0; e < NT * NT; ++e)
        c[e] = add_rn(mul_rn(x, A.Rinv[e]), div_rn(A.Ginv[e], g));
#pragma unroll
      for (int m = 0; m < NT; ++m)
        c[NT * NT + m] = sqrt_rn(div_rn(T(1), c[m * NT + m]));
    }
  }
  // the owner of step 0 (marker 0, thread 0) loads its inputs; its own
  // constants, just written by itself
  StepIn<T, NT> in;
  if (tid == 0) load_step<T, NT>(A, k, 0, 0, in);
  T gnext[R];
  __syncthreads();

  const int steps = A.nreps * b;
  int j = 0;
  for (int s = 0; s < steps; ++s) {
    // 1. the previous step's change reaches this thread's rhs values
    if (s > 0) {
      const T* d = s_d[(s - 1) & 1];
      T dv[NT];
#pragma unroll
      for (int m = 0; m < NT; ++m) dv[m] = d[m];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int m = 0; m < NT; ++m) rhs[r][m] = add_rn(rhs[r][m], mul_rn(dv[m], gnext[r]));
    }
    // 2. this step's Gram row, added at the next step
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * nt;
      gnext[r] = i < b ? gram[static_cast<size_t>(j) * b + i] : T(0);
    }
    const int j1 = j + 1 == b ? 0 : j + 1;
    // 3. the owner's step
    if (tid == j % nt) {
      const int row = j / nt;
      T w[NT];
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        T rj = rhs[0][m];
#pragma unroll
        for (int r = 1; r < R; ++r) rj = r == row ? rhs[r][m] : rj;
        w[m] = add_rn(rj, mul_rn(in.x, in.a[m]));
      }
      T Rhs[NT];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        T acc = mul_rn(s_rinv[q * NT], w[0]);
#pragma unroll
        for (int m = 1; m < NT; ++m) acc = add_rn(acc, mul_rn(s_rinv[q * NT + m], w[m]));
        Rhs[q] = acc;
      }
      T a[NT];
#pragma unroll
      for (int m = 0; m < NT; ++m) a[m] = in.a[m];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        T acc = mul_rn(in.c[q * NT], a[0]);
#pragma unroll
        for (int m = 1; m < NT; ++m) acc = add_rn(acc, mul_rn(in.c[q * NT + m], a[m]));
        const T mu = add_rn(div_rn(sub_rn(Rhs[q], acc), in.c[q * NT + q]), a[q]);
        a[q] = add_rn(mu, mul_rn(in.z[q], in.c[NT * NT + q]));
      }
      T* alpha = A.alpha + kb * NT + j;
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        const T a_new = mul_rn(a[m], in.v);
        s_d[s & 1][m] = sub_rn(in.a[m], a_new);
        alpha[static_cast<size_t>(m) * b] = a_new;
      }
    }
    // 4. the next step's owner loads its inputs (after writing alpha, when
    // it owns both steps)
    if (s + 1 < steps && tid == j1 % nt) load_step<T, NT>(A, k, j1, s + 1, in);
    __syncthreads();
    j = j1;
  }
  // the last step's change, then the rhs back
  {
    const T* d = s_d[(steps - 1) & 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * nt;
      if (i >= b) continue;
#pragma unroll
      for (int m = 0; m < NT; ++m)
        A.rhs[kb * NT + static_cast<size_t>(m) * b + i] =
            add_rn(rhs[r][m], mul_rn(d[m], gnext[r]));
    }
  }
}

template <class T, int NT>
int launch_t(const Args<T>& A, cudaStream_t stream) {
  const int rounded = (A.b + 31) / 32 * 32;
  const int threads = rounded < kThreads ? rounded : kThreads;
  int rows = 1;
  while (rows * threads < A.b) rows *= 2;
  if (rows > kMaxRows) return cudaErrorInvalidValue;
  switch (rows) {
    case 1: c0l_chain<T, NT, 1><<<A.nblocks, threads, 0, stream>>>(A); break;
    case 2: c0l_chain<T, NT, 2><<<A.nblocks, threads, 0, stream>>>(A); break;
    case 4: c0l_chain<T, NT, 4><<<A.nblocks, threads, 0, stream>>>(A); break;
    default: c0l_chain<T, NT, 8><<<A.nblocks, threads, 0, stream>>>(A); break;
  }
  return cudaGetLastError();
}

template <typename T>
int launch(int t, const Args<T>& A, void* stream) {
  if (A.b < 1 || A.nblocks < 1 || A.nreps < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 2: return launch_t<T, 2>(A, st);
    case 3: return launch_t<T, 3>(A, st);
    case 4: return launch_t<T, 4>(A, st);
    case 5: return launch_t<T, 5>(A, st);
    case 6: return launch_t<T, 6>(A, st);
    case 7: return launch_t<T, 7>(A, st);
    case 8: return launch_t<T, 8>(A, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define JT_C0L_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const T* grams, const T* xpx, const T* valid, T* alpha,        \
                      T* rhs, const T* Rinv, const T* Ginv, const T* gamma,          \
                      const T* zs, T* scratch, int t, int b, int nblocks, int nreps, \
                      void* stream) {                                                \
    return launch<T>(t, Args<T>{grams, xpx, valid, alpha, rhs, Rinv, Ginv, gamma,    \
                                zs, scratch, b, nblocks, nreps}, stream);            \
  }

JT_C0L_ENTRY(jt_mt_c0l_inner_rounds, float)
JT_C0L_ENTRY(jt_mt_c0l_inner_rounds_f64, double)
