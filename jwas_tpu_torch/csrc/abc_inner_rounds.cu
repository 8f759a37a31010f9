// Fast-blocks BayesC inner rounds on Hopper: the spike-slab Gibbs chain of
// every marker block, nreps * b strictly sequential updates per block, with
// all blocks in parallel.
//
// Replaces the Pallas kernels jwas_tpu/ops/pallas_sweep.py::_abc_kernel
// (:68, Gram rows streamed by DMA) and ::_abc_kernel_resident (:162, Gram
// tile resident in VMEM). Both become one kernel here; residency of the
// b x b Gram tile in shared memory is a launch-time choice.
//
// What bounds it: latency, not bytes or operations. A call moves a Gram
// tile and a few vectors once, but its nreps * b steps depend on each
// other through rhs: step j reads rhs[j], which every earlier step that
// changed its marker's effect has updated. The time is (steps on the
// critical path) x (latency of one step).
//
// What the design (smem_plan.cuh::run_chain) does about it:
//  - A marker's rhs, effect, xpx, draws and round constants (1/lhs,
//    log lhs + log var_eff, the square roots, the log priors) live in its
//    owner thread's registers for the whole call, so a step waits for no
//    shared-memory load; the next pass's draws are fetched from global
//    memory while the current pass runs.
//  - The 32 markers of a warp are one window: d = a_old - a_new travels by
//    shuffle, and one __syncthreads a window (not a step) hands the
//    window's changes to the other warps, whose row updates leave the
//    critical path.
//  - All 32 lanes evaluate at once; the null steps (a_old = a_new = 0: most
//    markers of a sparse model) before the first marker whose effect
//    changes are resolved together, so a window costs 1 + (markers that
//    change) evaluations. When every marker changes, a step is one
//    evaluation (an expf and a reciprocal among ~25 dependent operations),
//    one shuffle from the next lane and one multiply-add.
//
// Rounding follows the plain PyTorch version operation by operation: the
// __f*_rn intrinsics (__d*_rn in float64) keep nvcc from contracting
// a*b+c into an FMA, so the inclusion test u < prob sees the same rounding
// as the plain version (expf and logf, exp and log may still differ from
// the host's by an ulp).
//
// Two builds: float32 (jt_abc_inner_rounds) and float64
// (jt_abc_inner_rounds_f64, runMCMC's double_precision). A float64 step
// does the same ~25 dependent operations at the card's float64 latency;
// its Gram tile is resident up to b = 170.
//
// Layouts (all C-contiguous, block-major): grams (nblocks, b, b); xpx,
// var_eff, log_pi, log_pi_comp, alpha, beta, delta (int32), rhs
// (nblocks, b); us, zs (nreps * b, nblocks) as the JAX sweep draws them;
// inv_vare a 1-element device array. alpha, beta, delta, rhs are updated
// in place. Every floating-point array has the build's type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_plan.cuh"

namespace {

using jt::add_rn;
using jt::div_rn;
using jt::exp_of;
using jt::log_of;
using jt::mul_rn;
using jt::sqrt_rn;
using jt::sub_rn;

// The R markers one thread owns, in registers.
template <class T, int R>
struct AbcMarkers {
  T alpha[R], beta[R], xpx[R];
  int delta[R];
  T inv_lhs[R], c[R], sq_inv[R], sq_ve[R], lp[R], lpc[R];
  T u[R], z[R], next_u[R], next_z[R];
  T a_new, b_new;                  // the candidate of the last eval
  int inc;
  T kept_a, kept_b;                // shadow state of the window's marker
  int kept_inc;
  T inv_vare;
  const T* us;                     // column k of the draw panels
  const T* zs;
  int b, nblocks, nreps;

  __device__ __forceinline__ void fetch(int rep) {
    if (rep >= nreps) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * blockDim.x + threadIdx.x;
      if (i < b) {
        const size_t t = (static_cast<size_t>(rep) * b + i) * nblocks;
        next_u[r] = us[t];
        next_z[r] = zs[t];
      }
    }
  }

  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u[r] = next_u[r];
      z[r] = next_z[r];
    }
  }

  // jwas_tpu/ops/markers.py:118 (_abc_update), constants precomputed
  __device__ __forceinline__ T eval(int r, T rhs) {
    const T a_old = alpha[r];
    const T t = mul_rn(add_rn(rhs, mul_rn(xpx[r], a_old)), inv_vare);
    const T g = mul_rn(t, inv_lhs[r]);
    const T ld1 =
        add_rn(mul_rn(T(-0.5), sub_rn(c[r], mul_rn(g, t))), lpc[r]);
    // (__frcp_rn gives the same bits and measured 8 ns a step slower on
    // an H100)
    const T prob = div_rn(T(1), add_rn(T(1), exp_of(sub_rn(lp[r], ld1))));
    inc = u[r] < prob;
    const T b_in = add_rn(g, mul_rn(z[r], sq_inv[r]));
    a_new = inc ? b_in : T(0);
    b_new = inc ? b_in : mul_rn(z[r], sq_ve[r]);
    return sub_rn(a_old, a_new);
  }

  __device__ __forceinline__ void keep() {
    kept_a = a_new;
    kept_b = b_new;
    kept_inc = inc;
  }

  __device__ __forceinline__ T finish(int r) {
    const T d = sub_rn(alpha[r], kept_a);
    alpha[r] = kept_a;
    beta[r] = kept_b;
    delta[r] = kept_inc;
    return d;
  }
};

template <class T, int R>
__global__ void __launch_bounds__(jt::kMaxThreads) abc_inner_rounds_kernel(
    const T* __restrict__ grams, const T* __restrict__ xpx,
    const T* __restrict__ var_eff, const T* __restrict__ log_pi,
    const T* __restrict__ log_pi_comp, T* __restrict__ alpha,
    T* __restrict__ beta, int32_t* __restrict__ delta, T* __restrict__ rhs,
    const T* __restrict__ us, const T* __restrict__ zs,
    const T* __restrict__ inv_vare_ptr, int b, int nblocks, int nreps,
    int resident) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.x;
  const size_t base = static_cast<size_t>(k) * b;

  AbcMarkers<T, R> m;
  T rhs_r[R];
  m.inv_vare = *inv_vare_ptr;
  m.us = us + k;
  m.zs = zs + k;
  m.b = b;
  m.nblocks = nblocks;
  m.nreps = nreps;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * blockDim.x + threadIdx.x;
    const bool own = i < b;
    const T ve = own ? var_eff[base + i] : T(1);
    const T x = own ? xpx[base + i] : T(1);
    const T inv_ve = div_rn(T(1), ve);
    const T lhs = add_rn(mul_rn(x, m.inv_vare), inv_ve);
    const T inv_lhs = div_rn(T(1), lhs);
    rhs_r[r] = own ? rhs[base + i] : T(0);
    m.alpha[r] = own ? alpha[base + i] : T(0);
    m.beta[r] = own ? beta[base + i] : T(0);
    m.delta[r] = own ? delta[base + i] : 0;
    m.xpx[r] = x;
    m.inv_lhs[r] = inv_lhs;
    m.c[r] = add_rn(log_of(lhs), log_of(ve));
    m.sq_inv[r] = sqrt_rn(inv_lhs);
    m.sq_ve[r] = sqrt_rn(ve);
    m.lp[r] = own ? log_pi[base + i] : T(0);
    m.lpc[r] = own ? log_pi_comp[base + i] : T(0);
    m.next_u[r] = T(0);
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
      beta[base + i] = m.beta[r];
      delta[base + i] = m.delta[r];
    }
  }
}

template <class T, int R>
int launch(const jt::ChainPlan& p, const T* grams, const T* xpx,
           const T* var_eff, const T* log_pi, const T* log_pi_comp, T* alpha,
           T* beta, int32_t* delta, T* rhs, const T* us, const T* zs,
           const T* inv_vare, int b, int nblocks, int nreps,
           cudaStream_t stream) {
  static bool ready[jt::kMaxDevices];
  const int err = jt::allow_smem(abc_inner_rounds_kernel<T, R>, p, ready);
  if (err != 0) return err;
  abc_inner_rounds_kernel<T, R><<<nblocks, p.threads, p.smem, stream>>>(
      grams, xpx, var_eff, log_pi, log_pi_comp, alpha, beta, delta, rhs, us,
      zs, inv_vare, b, nblocks, nreps, p.resident);
  return cudaGetLastError();
}

template <class T>
int inner_rounds(const T* grams, const T* xpx, const T* var_eff,
                 const T* log_pi, const T* log_pi_comp, T* alpha, T* beta,
                 int32_t* delta, T* rhs, const T* us, const T* zs,
                 const T* inv_vare, int b, int nblocks, int nreps,
                 void* stream) {
  if (b <= 0 || nblocks <= 0 || nreps <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(grams) % 16)
    return cudaErrorMisalignedAddress;
  jt::ChainPlan p;
  const int err = jt::chain_plan<T>(b, &p);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JT_ABC_LAUNCH(R)                                                     \
  launch<T, R>(p, grams, xpx, var_eff, log_pi, log_pi_comp, alpha, beta,    \
               delta, rhs, us, zs, inv_vare, b, nblocks, nreps, s)
  switch (p.rows) {
    case 1: return JT_ABC_LAUNCH(1);
    case 2: return JT_ABC_LAUNCH(2);
    default: return JT_ABC_LAUNCH(4);
  }
#undef JT_ABC_LAUNCH
}

}  // namespace

// b, nreps, itemsize (4 or 8) -> 1 resident Gram tile, 0 global, <0 -error
extern "C" int jt_abc_resident(int b, int nreps, int itemsize) {
  (void)nreps;                     // the draws take no shared memory
  jt::ChainPlan p;
  const int err = itemsize == 8 ? jt::chain_plan<double>(b, &p)
                                : jt::chain_plan<float>(b, &p);
  return err != 0 ? -err : p.resident;
}

extern "C" int jt_abc_inner_rounds(
    const float* grams, const float* xpx, const float* var_eff,
    const float* log_pi, const float* log_pi_comp, float* alpha, float* beta,
    int32_t* delta, float* rhs, const float* us, const float* zs,
    const float* inv_vare, int b, int nblocks, int nreps, void* stream) {
  return inner_rounds<float>(grams, xpx, var_eff, log_pi, log_pi_comp, alpha,
                             beta, delta, rhs, us, zs, inv_vare, b, nblocks,
                             nreps, stream);
}

extern "C" int jt_abc_inner_rounds_f64(
    const double* grams, const double* xpx, const double* var_eff,
    const double* log_pi, const double* log_pi_comp, double* alpha,
    double* beta, int32_t* delta, double* rhs, const double* us,
    const double* zs, const double* inv_vare, int b, int nblocks, int nreps,
    void* stream) {
  return inner_rounds<double>(grams, xpx, var_eff, log_pi, log_pi_comp, alpha,
                              beta, delta, rhs, us, zs, inv_vare, b, nblocks,
                              nreps, stream);
}
