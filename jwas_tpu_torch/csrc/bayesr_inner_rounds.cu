// Fast-blocks BayesR inner rounds on Hopper: the 4-class mixture Gibbs chain
// of every marker block, nreps * b strictly sequential updates per block,
// with all blocks in parallel.
//
// Replaces the Pallas kernel jwas_tpu/ops/pallas_sweep.py::
// _bayesr_kernel_resident (:327, entered through bayesr_inner_rounds_pallas
// :412), which needs the Gram tile resident in VMEM. Here residency of the
// b x b Gram tile in shared memory is a launch-time choice: rows are read
// from global memory/L2 when the tile does not fit (b > 240 on the H100).
//
// What bounds it: latency, not bytes or operations. The nreps * b steps of
// a block depend on each other through rhs, so the time is (steps on the
// critical path) x (latency of one step). Most steps are null: the marker
// stays in class 0 with effect 0 and rhs does not move.
//
// What the design (smem_plan.cuh::run_chain, shared with
// abc_inner_rounds.cu) does about it:
//  - A marker's rhs, effect, class, xpx, draws, log class priors and
//    per-class constants (1/lhs_k, log(1/lhs_k) - log(var_k), sqrt(1/lhs_k),
//    var_k = gamma_k sigma^2: computed once per call, so a step needs no
//    transcendental and no division) live in its owner thread's registers;
//    the next pass's draws (one 16-byte Gumbel load and one normal per
//    marker) are fetched from global memory while the current pass runs.
//  - The 32 markers of a warp are one window: d = a_old - a_new travels by
//    shuffle, one __syncthreads a window hands the window's changes to the
//    other warps.
//  - All 32 lanes evaluate at once, the three slab classes side by side,
//    and the markers up to the first one whose effect changes are resolved
//    together, so a window costs 1 + (markers that change) evaluations
//    instead of 32: about four with ~95% of the markers in the null class.
//
// The class is the Gumbel-max draw: class 0 scores lp_0 + g_0, and a strict
// > keeps the first maximum, as argmax does. Rounding follows the plain
// PyTorch version (bayesr_inner_rounds_ref) operation by operation: the
// __f*_rn intrinsics (__d*_rn) keep nvcc from contracting a*b+c into an FMA, so the
// class argmax sees the plain version's rounding (logf may differ from the
// host's by an ulp, in the constants only).
//
// Two builds: float32 (jt_bayesr_inner_rounds) and float64
// (jt_bayesr_inner_rounds_f64, runMCMC's double_precision), whose class
// priors and Gumbel draws come as 32-byte groups of four doubles.
//
// Layouts (all C-contiguous, block-major): grams (nblocks, b, b); xpx,
// alpha, delta (int32 class labels 0..3), rhs (nblocks, b); log_pi
// (nblocks, b, 4); gumbel (nreps * b, nblocks, 4) and zs (nreps * b,
// nblocks) as the JAX sweep draws them; inv_vare and sigma_sq 1-element
// device arrays. alpha, delta, rhs are updated in place. Every
// floating-point array has the build's type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_plan.cuh"

namespace {

using jt::add_rn;
using jt::div_rn;
using jt::log_of;
using jt::mul_rn;
using jt::sqrt_rn;
using jt::sub_rn;

// Four values of a marker (class priors, Gumbel draws) in one aligned load.
struct alignas(32) Double4 {
  double x, y, z, w;
};
template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<double> { using type = Double4; };

// The R markers one thread owns, in registers.
template <class T, int R>
struct BayesRMarkers {
  using V4 = typename Vec4<T>::type;
  T alpha[R], xpx[R];
  int delta[R];
  T il[R][3], dd[R][3], sq[R][3];       // 1/lhs_k, log il - log var_k, sqrt(il)
  V4 lp[R];                             // log class priors
  V4 g[R], next_g[R];                   // Gumbel draws
  T z[R], next_z[R];
  T a_new;                              // the candidate of the last eval
  int cls;
  T kept_a;                             // shadow state of the window's marker
  int kept_cls;
  T inv_vare;
  const V4* gumbel;                     // column k of the draw panels
  const T* zs;
  int b, nblocks, nreps;

  __device__ __forceinline__ void fetch(int rep) {
    if (rep >= nreps) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * blockDim.x + threadIdx.x;
      if (i < b) {
        const size_t t = (static_cast<size_t>(rep) * b + i) * nblocks;
        next_g[r] = gumbel[t];
        next_z[r] = zs[t];
      }
    }
  }

  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      g[r] = next_g[r];
      z[r] = next_z[r];
    }
  }

  // jwas_tpu/ops/markers.py:150-188 (bayesr_class_logprobs,
  // _bayesr_update), constants precomputed
  __device__ __forceinline__ T eval(int r, T rhs) {
    const T a_old = alpha[r];
    const T t = mul_rn(add_rn(rhs, mul_rn(xpx[r], a_old)), inv_vare);
    const T lpk[3] = {lp[r].y, lp[r].z, lp[r].w};
    const T gk[3] = {g[r].y, g[r].z, g[r].w};
    // the three slab classes side by side: score, and the effect the class
    // would draw (off the chain: only the scan below is sequential)
    T score[3], drawn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T bh = mul_rn(il[r][c], t);
      const T ll = mul_rn(T(0.5), add_rn(dd[r][c], mul_rn(bh, t)));
      score[c] = add_rn(add_rn(lpk[c], ll), gk[c]);
      drawn[c] = add_rn(bh, mul_rn(z[r], sq[r][c]));
    }
    const T s0 = add_rn(lp[r].x, g[r].x);
    const bool u1 = score[0] > s0;
    const T b1 = u1 ? score[0] : s0;
    const bool u2 = score[1] > b1;
    const T b2 = u2 ? score[1] : b1;
    const bool u3 = score[2] > b2;
    cls = u3 ? 3 : u2 ? 2 : u1 ? 1 : 0;
    a_new = u3 ? drawn[2] : u2 ? drawn[1] : u1 ? drawn[0] : T(0);
    return sub_rn(a_old, a_new);
  }

  __device__ __forceinline__ void keep() {
    kept_a = a_new;
    kept_cls = cls;
  }

  __device__ __forceinline__ T finish(int r) {
    const T d = sub_rn(alpha[r], kept_a);
    alpha[r] = kept_a;
    delta[r] = kept_cls;
    return d;
  }
};

template <class T, int R>
__global__ void __launch_bounds__(jt::kMaxThreads) bayesr_inner_rounds_kernel(
    const T* __restrict__ grams, const T* __restrict__ xpx,
    const T* __restrict__ log_pi, T* __restrict__ alpha,
    int32_t* __restrict__ delta, T* __restrict__ rhs,
    const typename Vec4<T>::type* __restrict__ gumbel,
    const T* __restrict__ zs, const T* __restrict__ inv_vare_ptr,
    const T* __restrict__ sigma_sq_ptr, int b, int nblocks, int nreps,
    int resident) {
  using V4 = typename Vec4<T>::type;
  extern __shared__ float4 smem4[];
  const int k = blockIdx.x;
  const size_t base = static_cast<size_t>(k) * b;
  // ops/markers.py BAYESR_GAMMA, each rounded to T as the plain version
  // rounds it
  const T gamma[3] = {static_cast<T>(0.01), static_cast<T>(0.1), T(1)};
  const T sigma_sq = *sigma_sq_ptr;

  BayesRMarkers<T, R> m;
  T rhs_r[R];
  m.inv_vare = *inv_vare_ptr;
  m.gumbel = gumbel + k;
  m.zs = zs + k;
  m.b = b;
  m.nblocks = nblocks;
  m.nreps = nreps;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * blockDim.x + threadIdx.x;
    const bool own = i < b;
    const T x = own ? xpx[base + i] : T(1);
    rhs_r[r] = own ? rhs[base + i] : T(0);
    m.alpha[r] = own ? alpha[base + i] : T(0);
    m.delta[r] = own ? delta[base + i] : 0;
    m.xpx[r] = x;
    m.lp[r] = own ? reinterpret_cast<const V4*>(log_pi)[base + i]
                  : V4{T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T var = mul_rn(gamma[c], sigma_sq);
      const T lhs = add_rn(mul_rn(x, m.inv_vare), div_rn(T(1), var));
      const T il = div_rn(T(1), lhs);
      m.il[r][c] = il;
      m.dd[r][c] = sub_rn(log_of(il), log_of(var));
      m.sq[r][c] = sqrt_rn(il);
    }
    m.next_g[r] = V4{T(0), T(0), T(0), T(0)};
    m.next_z[r] = T(0);
  }
  m.fetch(0);
  m.advance();

  jt::run_chain<T, R>(m, rhs_r, grams + base * b, smem4, b, nreps, resident);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * blockDim.x + threadIdx.x;
    if (i < b) {
      rhs[base + i] = rhs_r[r];
      alpha[base + i] = m.alpha[r];
      delta[base + i] = m.delta[r];
    }
  }
}

template <class T, int R>
int launch(const jt::ChainPlan& p, const T* grams, const T* xpx,
           const T* log_pi, T* alpha, int32_t* delta, T* rhs, const T* gumbel,
           const T* zs, const T* inv_vare, const T* sigma_sq, int b,
           int nblocks, int nreps, cudaStream_t stream) {
  static bool ready[jt::kMaxDevices];
  const int err = jt::allow_smem(bayesr_inner_rounds_kernel<T, R>, p, ready);
  if (err != 0) return err;
  bayesr_inner_rounds_kernel<T, R><<<nblocks, p.threads, p.smem, stream>>>(
      grams, xpx, log_pi, alpha, delta, rhs,
      reinterpret_cast<const typename Vec4<T>::type*>(gumbel), zs, inv_vare,
      sigma_sq, b, nblocks, nreps, p.resident);
  return cudaGetLastError();
}

template <class T>
int inner_rounds(const T* grams, const T* xpx, const T* log_pi, T* alpha,
                 int32_t* delta, T* rhs, const T* gumbel, const T* zs,
                 const T* inv_vare, const T* sigma_sq, int b, int nblocks,
                 int nreps, void* stream) {
  if (b <= 0 || nblocks <= 0 || nreps <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(grams) % 16 ||
      reinterpret_cast<uintptr_t>(gumbel) % (4 * sizeof(T)) ||
      reinterpret_cast<uintptr_t>(log_pi) % (4 * sizeof(T)))
    return cudaErrorMisalignedAddress;
  jt::ChainPlan p;
  const int err = jt::chain_plan<T>(b, &p);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JT_BAYESR_LAUNCH(R)                                                \
  launch<T, R>(p, grams, xpx, log_pi, alpha, delta, rhs, gumbel, zs,      \
               inv_vare, sigma_sq, b, nblocks, nreps, s)
  switch (p.rows) {
    case 1: return JT_BAYESR_LAUNCH(1);
    case 2: return JT_BAYESR_LAUNCH(2);
    default: return JT_BAYESR_LAUNCH(4);
  }
#undef JT_BAYESR_LAUNCH
}

}  // namespace

// b, nreps, itemsize (4 or 8) -> 1 resident Gram tile, 0 global, <0 -error
extern "C" int jt_bayesr_resident(int b, int nreps, int itemsize) {
  (void)nreps;                     // the draws take no shared memory
  jt::ChainPlan p;
  const int err = itemsize == 8 ? jt::chain_plan<double>(b, &p)
                                : jt::chain_plan<float>(b, &p);
  return err != 0 ? -err : p.resident;
}

extern "C" int jt_bayesr_inner_rounds(
    const float* grams, const float* xpx, const float* log_pi, float* alpha,
    int32_t* delta, float* rhs, const float* gumbel, const float* zs,
    const float* inv_vare, const float* sigma_sq, int b, int nblocks,
    int nreps, void* stream) {
  return inner_rounds<float>(grams, xpx, log_pi, alpha, delta, rhs, gumbel,
                             zs, inv_vare, sigma_sq, b, nblocks, nreps,
                             stream);
}

extern "C" int jt_bayesr_inner_rounds_f64(
    const double* grams, const double* xpx, const double* log_pi,
    double* alpha, int32_t* delta, double* rhs, const double* gumbel,
    const double* zs, const double* inv_vare, const double* sigma_sq, int b,
    int nblocks, int nreps, void* stream) {
  return inner_rounds<double>(grams, xpx, log_pi, alpha, delta, rhs, gumbel,
                              zs, inv_vare, sigma_sq, b, nblocks, nreps,
                              stream);
}
