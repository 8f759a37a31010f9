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
// __f*_rn intrinsics keep nvcc from contracting a*b+c into an FMA, so the
// inclusion test u < prob sees the same rounding as the plain version
// (expf and logf may still differ from the host's by an ulp).
//
// Layouts (all C-contiguous, block-major): grams (nblocks, b, b); xpx,
// var_eff, log_pi, log_pi_comp, alpha, beta, delta (int32), rhs
// (nblocks, b); us, zs (nreps * b, nblocks) as the JAX sweep draws them;
// inv_vare a 1-element device array. alpha, beta, delta, rhs are updated
// in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_plan.cuh"

namespace {

// The R markers one thread owns, in registers.
template <int R>
struct AbcMarkers {
  float alpha[R], beta[R], xpx[R];
  int delta[R];
  float inv_lhs[R], c[R], sq_inv[R], sq_ve[R], lp[R], lpc[R];
  float u[R], z[R], next_u[R], next_z[R];
  float a_new, b_new;              // the candidate of the last eval
  int inc;
  float kept_a, kept_b;            // shadow state of the window's marker
  int kept_inc;
  float inv_vare;
  const float* us;                 // column k of the draw panels
  const float* zs;
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
  __device__ __forceinline__ float eval(int r, float rhs) {
    const float a_old = alpha[r];
    const float t =
        __fmul_rn(__fadd_rn(rhs, __fmul_rn(xpx[r], a_old)), inv_vare);
    const float g = __fmul_rn(t, inv_lhs[r]);
    const float ld1 = __fadd_rn(
        __fmul_rn(-0.5f, __fsub_rn(c[r], __fmul_rn(g, t))), lpc[r]);
    // (__frcp_rn gives the same bits and measured 8 ns a step slower on
    // an H100)
    const float prob =
        __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(__fsub_rn(lp[r], ld1))));
    inc = u[r] < prob;
    const float b_in = __fadd_rn(g, __fmul_rn(z[r], sq_inv[r]));
    a_new = inc ? b_in : 0.0f;
    b_new = inc ? b_in : __fmul_rn(z[r], sq_ve[r]);
    return __fsub_rn(a_old, a_new);
  }

  __device__ __forceinline__ void keep() {
    kept_a = a_new;
    kept_b = b_new;
    kept_inc = inc;
  }

  __device__ __forceinline__ float finish(int r) {
    const float d = __fsub_rn(alpha[r], kept_a);
    alpha[r] = kept_a;
    beta[r] = kept_b;
    delta[r] = kept_inc;
    return d;
  }
};

template <int R>
__global__ void __launch_bounds__(jt::kMaxThreads) abc_inner_rounds_kernel(
    const float* __restrict__ grams, const float* __restrict__ xpx,
    const float* __restrict__ var_eff, const float* __restrict__ log_pi,
    const float* __restrict__ log_pi_comp, float* __restrict__ alpha,
    float* __restrict__ beta, int32_t* __restrict__ delta,
    float* __restrict__ rhs, const float* __restrict__ us,
    const float* __restrict__ zs, const float* __restrict__ inv_vare_ptr,
    int b, int nblocks, int nreps, int resident) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.x;
  const size_t base = static_cast<size_t>(k) * b;

  AbcMarkers<R> m;
  float rhs_r[R];
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
    const float ve = own ? var_eff[base + i] : 1.0f;
    const float x = own ? xpx[base + i] : 1.0f;
    const float inv_ve = __fdiv_rn(1.0f, ve);
    const float lhs = __fadd_rn(__fmul_rn(x, m.inv_vare), inv_ve);
    const float inv_lhs = __fdiv_rn(1.0f, lhs);
    rhs_r[r] = own ? rhs[base + i] : 0.0f;
    m.alpha[r] = own ? alpha[base + i] : 0.0f;
    m.beta[r] = own ? beta[base + i] : 0.0f;
    m.delta[r] = own ? delta[base + i] : 0;
    m.xpx[r] = x;
    m.inv_lhs[r] = inv_lhs;
    m.c[r] = __fadd_rn(logf(lhs), logf(ve));
    m.sq_inv[r] = __fsqrt_rn(inv_lhs);
    m.sq_ve[r] = __fsqrt_rn(ve);
    m.lp[r] = own ? log_pi[base + i] : 0.0f;
    m.lpc[r] = own ? log_pi_comp[base + i] : 0.0f;
    m.next_u[r] = 0.0f;
    m.next_z[r] = 0.0f;
  }
  m.fetch(0);
  m.advance();

  jt::run_chain<R>(m, rhs_r, grams + base * b, smem4, b, nreps, resident);

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

template <int R>
int launch(const jt::ChainPlan& p, const float* grams, const float* xpx,
           const float* var_eff, const float* log_pi,
           const float* log_pi_comp, float* alpha, float* beta,
           int32_t* delta, float* rhs, const float* us, const float* zs,
           const float* inv_vare, int b, int nblocks, int nreps,
           cudaStream_t stream) {
  static bool ready[jt::kMaxDevices];
  const int err = jt::allow_smem(abc_inner_rounds_kernel<R>, p, ready);
  if (err != 0) return err;
  abc_inner_rounds_kernel<R><<<nblocks, p.threads, p.smem, stream>>>(
      grams, xpx, var_eff, log_pi, log_pi_comp, alpha, beta, delta, rhs, us,
      zs, inv_vare, b, nblocks, nreps, p.resident);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jt_abc_resident(int b, int nreps) {
  (void)nreps;                     // the draws take no shared memory
  jt::ChainPlan p;
  const int err = jt::chain_plan(b, &p);
  return err != 0 ? -err : p.resident;
}

extern "C" int jt_abc_inner_rounds(
    const float* grams, const float* xpx, const float* var_eff,
    const float* log_pi, const float* log_pi_comp, float* alpha, float* beta,
    int32_t* delta, float* rhs, const float* us, const float* zs,
    const float* inv_vare, int b, int nblocks, int nreps, void* stream) {
  if (b <= 0 || nblocks <= 0 || nreps <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(grams) % 16)
    return cudaErrorMisalignedAddress;
  jt::ChainPlan p;
  const int err = jt::chain_plan(b, &p);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JT_ABC_LAUNCH(R)                                                     \
  launch<R>(p, grams, xpx, var_eff, log_pi, log_pi_comp, alpha, beta, delta, \
            rhs, us, zs, inv_vare, b, nblocks, nreps, s)
  switch (p.rows) {
    case 1: return JT_ABC_LAUNCH(1);
    case 2: return JT_ABC_LAUNCH(2);
    default: return JT_ABC_LAUNCH(4);
  }
#undef JT_ABC_LAUNCH
}
