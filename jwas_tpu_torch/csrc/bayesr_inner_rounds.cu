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
// __f*_rn intrinsics keep nvcc from contracting a*b+c into an FMA, so the
// class argmax sees the plain version's rounding (logf may differ from the
// host's by an ulp, in the constants only).
//
// Layouts (all C-contiguous, block-major): grams (nblocks, b, b); xpx,
// alpha, delta (int32 class labels 0..3), rhs (nblocks, b); log_pi
// (nblocks, b, 4); gumbel (nreps * b, nblocks, 4) and zs (nreps * b,
// nblocks) as the JAX sweep draws them; inv_vare and sigma_sq 1-element
// device arrays. alpha, delta, rhs are updated in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_plan.cuh"

namespace {

// The R markers one thread owns, in registers.
template <int R>
struct BayesRMarkers {
  float alpha[R], xpx[R];
  int delta[R];
  float il[R][3], dd[R][3], sq[R][3];   // 1/lhs_k, log il - log var_k, sqrt(il)
  float4 lp[R];                         // log class priors
  float4 g[R], next_g[R];               // Gumbel draws
  float z[R], next_z[R];
  float a_new;                          // the candidate of the last eval
  int cls;
  float kept_a;                         // shadow state of the window's marker
  int kept_cls;
  float inv_vare;
  const float4* gumbel;                 // column k of the draw panels
  const float* zs;
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
  __device__ __forceinline__ float eval(int r, float rhs) {
    const float a_old = alpha[r];
    const float t =
        __fmul_rn(__fadd_rn(rhs, __fmul_rn(xpx[r], a_old)), inv_vare);
    const float lpk[3] = {lp[r].y, lp[r].z, lp[r].w};
    const float gk[3] = {g[r].y, g[r].z, g[r].w};
    // the three slab classes side by side: score, and the effect the class
    // would draw (off the chain: only the scan below is sequential)
    float score[3], drawn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float bh = __fmul_rn(il[r][c], t);
      const float ll = __fmul_rn(0.5f, __fadd_rn(dd[r][c], __fmul_rn(bh, t)));
      score[c] = __fadd_rn(__fadd_rn(lpk[c], ll), gk[c]);
      drawn[c] = __fadd_rn(bh, __fmul_rn(z[r], sq[r][c]));
    }
    const float s0 = __fadd_rn(lp[r].x, g[r].x);
    const bool u1 = score[0] > s0;
    const float b1 = u1 ? score[0] : s0;
    const bool u2 = score[1] > b1;
    const float b2 = u2 ? score[1] : b1;
    const bool u3 = score[2] > b2;
    cls = u3 ? 3 : u2 ? 2 : u1 ? 1 : 0;
    a_new = u3 ? drawn[2] : u2 ? drawn[1] : u1 ? drawn[0] : 0.0f;
    return __fsub_rn(a_old, a_new);
  }

  __device__ __forceinline__ void keep() {
    kept_a = a_new;
    kept_cls = cls;
  }

  __device__ __forceinline__ float finish(int r) {
    const float d = __fsub_rn(alpha[r], kept_a);
    alpha[r] = kept_a;
    delta[r] = kept_cls;
    return d;
  }
};

template <int R>
__global__ void __launch_bounds__(jt::kMaxThreads) bayesr_inner_rounds_kernel(
    const float* __restrict__ grams, const float* __restrict__ xpx,
    const float* __restrict__ log_pi, float* __restrict__ alpha,
    int32_t* __restrict__ delta, float* __restrict__ rhs,
    const float4* __restrict__ gumbel, const float* __restrict__ zs,
    const float* __restrict__ inv_vare_ptr,
    const float* __restrict__ sigma_sq_ptr, int b, int nblocks, int nreps,
    int resident) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.x;
  const size_t base = static_cast<size_t>(k) * b;
  const float gamma[3] = {0.01f, 0.1f, 1.0f};   // ops/markers.py BAYESR_GAMMA
  const float sigma_sq = *sigma_sq_ptr;

  BayesRMarkers<R> m;
  float rhs_r[R];
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
    const float x = own ? xpx[base + i] : 1.0f;
    rhs_r[r] = own ? rhs[base + i] : 0.0f;
    m.alpha[r] = own ? alpha[base + i] : 0.0f;
    m.delta[r] = own ? delta[base + i] : 0;
    m.xpx[r] = x;
    m.lp[r] = own ? reinterpret_cast<const float4*>(log_pi)[base + i]
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float var = __fmul_rn(gamma[c], sigma_sq);
      const float lhs =
          __fadd_rn(__fmul_rn(x, m.inv_vare), __fdiv_rn(1.0f, var));
      const float il = __fdiv_rn(1.0f, lhs);
      m.il[r][c] = il;
      m.dd[r][c] = __fsub_rn(logf(il), logf(var));
      m.sq[r][c] = __fsqrt_rn(il);
    }
    m.next_g[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
      delta[base + i] = m.delta[r];
    }
  }
}

template <int R>
int launch(const jt::ChainPlan& p, const float* grams, const float* xpx,
           const float* log_pi, float* alpha, int32_t* delta, float* rhs,
           const float* gumbel, const float* zs, const float* inv_vare,
           const float* sigma_sq, int b, int nblocks, int nreps,
           cudaStream_t stream) {
  static bool ready[jt::kMaxDevices];
  const int err = jt::allow_smem(bayesr_inner_rounds_kernel<R>, p, ready);
  if (err != 0) return err;
  bayesr_inner_rounds_kernel<R><<<nblocks, p.threads, p.smem, stream>>>(
      grams, xpx, log_pi, alpha, delta, rhs,
      reinterpret_cast<const float4*>(gumbel), zs, inv_vare, sigma_sq, b,
      nblocks, nreps, p.resident);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jt_bayesr_resident(int b, int nreps) {
  (void)nreps;                     // the draws take no shared memory
  jt::ChainPlan p;
  const int err = jt::chain_plan(b, &p);
  return err != 0 ? -err : p.resident;
}

extern "C" int jt_bayesr_inner_rounds(
    const float* grams, const float* xpx, const float* log_pi, float* alpha,
    int32_t* delta, float* rhs, const float* gumbel, const float* zs,
    const float* inv_vare, const float* sigma_sq, int b, int nblocks,
    int nreps, void* stream) {
  if (b <= 0 || nblocks <= 0 || nreps <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(grams) % 16 ||
      reinterpret_cast<uintptr_t>(gumbel) % 16 ||
      reinterpret_cast<uintptr_t>(log_pi) % 16)
    return cudaErrorMisalignedAddress;
  jt::ChainPlan p;
  const int err = jt::chain_plan(b, &p);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JT_BAYESR_LAUNCH(R)                                                 \
  launch<R>(p, grams, xpx, log_pi, alpha, delta, rhs, gumbel, zs, inv_vare, \
            sigma_sq, b, nblocks, nreps, s)
  switch (p.rows) {
    case 1: return JT_BAYESR_LAUNCH(1);
    case 2: return JT_BAYESR_LAUNCH(2);
    default: return JT_BAYESR_LAUNCH(4);
  }
#undef JT_BAYESR_LAUNCH
}
