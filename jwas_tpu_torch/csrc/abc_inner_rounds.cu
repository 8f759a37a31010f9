// Fast-blocks BayesC inner rounds on Hopper: the spike-slab Gibbs chain of
// every marker block, nreps * b strictly sequential updates per block, with
// all blocks in parallel.
//
// Replaces the Pallas kernels jwas_tpu/ops/pallas_sweep.py::_abc_kernel
// (:68, Gram rows streamed by DMA) and ::_abc_kernel_resident (:162, Gram
// tile resident in VMEM). Both become one kernel here; residency of the
// b x b Gram tile in shared memory is a launch-time choice.
//
// Design. One CTA per marker block; thread i owns row i of the block (rows
// i, i+T, ... when b > T). Step j of a rep: the owner of marker j computes
// the _abc_update of jwas_tpu/ops/markers.py:118 from shared-memory state,
// writes a_old - a_new to a two-slot shared scalar, one __syncthreads, then
// every thread adds (a_old - a_new) * Gram[j][i] to its own rhs[i]. A step
// is skipped by all threads when a_old == a_new (both 0: most markers of a
// sparse BayesC model). The two slots let the next step's owner write
// while slower threads still read, so a step costs one barrier.
//
// What bounds it: the chain of b * nreps dependent steps, each a barrier
// plus one expf and one division on the owner thread (latency, not bytes:
// the Gram tile is read once per call when resident, b * nreps rows of
// it from L2 otherwise). Per-marker constants that do not depend on the
// chain (1/lhs, log lhs + log var_eff, square roots) are computed once per
// call; the plain version computes the same values the same way.
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

constexpr int kStateArrays = 11;   // per-marker arrays kept in shared memory

__global__ void abc_inner_rounds_kernel(
    const float* __restrict__ grams, const float* __restrict__ xpx,
    const float* __restrict__ var_eff, const float* __restrict__ log_pi,
    const float* __restrict__ log_pi_comp, float* __restrict__ alpha,
    float* __restrict__ beta, int32_t* __restrict__ delta,
    float* __restrict__ rhs, const float* __restrict__ us,
    const float* __restrict__ zs, const float* __restrict__ inv_vare_ptr,
    int b, int nblocks, int nreps, int reps_per_chunk, int resident) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;

  float* s_dd = smem;                       // 2 slots (4 for alignment)
  float* s_rhs = smem + 4;
  float* s_alpha = s_rhs + b;
  float* s_beta = s_alpha + b;
  int* s_delta = reinterpret_cast<int*>(s_beta + b);
  float* s_xpx = s_beta + 2 * b;
  float* s_inv_lhs = s_xpx + b;
  float* s_c = s_inv_lhs + b;               // log(lhs) + log(var_eff)
  float* s_sq_inv = s_c + b;                // sqrt(1 / lhs)
  float* s_sq_ve = s_sq_inv + b;            // sqrt(var_eff)
  float* s_lp = s_sq_ve + b;
  float* s_lpc = s_lp + b;
  float* s_us = s_lpc + b;                  // reps_per_chunk * b
  float* s_zs = s_us + reps_per_chunk * b;
  float* s_gram = s_zs + reps_per_chunk * b;  // b * b when resident

  const float inv_vare = *inv_vare_ptr;
  const size_t base = static_cast<size_t>(k) * b;
  const float* G = grams + base * b;

  for (int i = tid; i < b; i += T) {
    const float ve = var_eff[base + i];
    const float x = xpx[base + i];
    const float inv_ve = __fdiv_rn(1.0f, ve);
    const float lhs = __fadd_rn(__fmul_rn(x, inv_vare), inv_ve);
    const float inv_lhs = __fdiv_rn(1.0f, lhs);
    s_rhs[i] = rhs[base + i];
    s_alpha[i] = alpha[base + i];
    s_beta[i] = beta[base + i];
    s_delta[i] = delta[base + i];
    s_xpx[i] = x;
    s_inv_lhs[i] = inv_lhs;
    s_c[i] = __fadd_rn(logf(lhs), logf(ve));
    s_sq_inv[i] = __fsqrt_rn(inv_lhs);
    s_sq_ve[i] = __fsqrt_rn(ve);
    s_lp[i] = log_pi[base + i];
    s_lpc[i] = log_pi_comp[base + i];
  }
  if (resident) {
    for (int i = tid; i < b * b; i += T) s_gram[i] = G[i];
  }

  int r0 = 0;
  for (int rep = 0; rep < nreps; ++rep) {
    if (rep == r0) {
      // (re)fill the draw chunk: reps [r0, r0 + reps_per_chunk). Every
      // read of the previous chunk happened before the last step's barrier.
      const int nr = min(reps_per_chunk, nreps - r0);
      for (int i = tid; i < nr * b; i += T) {
        const size_t t = static_cast<size_t>(r0) * b + i;
        s_us[i] = us[t * nblocks + k];
        s_zs[i] = zs[t * nblocks + k];
      }
      __syncthreads();
    }
    const float* cu = s_us + (rep - r0) * b;
    const float* cz = s_zs + (rep - r0) * b;
    for (int j = 0; j < b; ++j) {
      const int slot = (rep * b + j) & 1;
      if (tid == j % T) {
        const float a_old = s_alpha[j];
        const float r = __fmul_rn(
            __fadd_rn(s_rhs[j], __fmul_rn(s_xpx[j], a_old)), inv_vare);
        const float g = __fmul_rn(r, s_inv_lhs[j]);
        const float ld1 = __fadd_rn(
            __fmul_rn(-0.5f, __fsub_rn(s_c[j], __fmul_rn(g, r))), s_lpc[j]);
        const float prob =
            __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(__fsub_rn(s_lp[j], ld1))));
        const float z = cz[j];
        const bool inc = cu[j] < prob;
        const float b_in = __fadd_rn(g, __fmul_rn(z, s_sq_inv[j]));
        const float a_new = inc ? b_in : 0.0f;
        s_beta[j] = inc ? b_in : __fmul_rn(z, s_sq_ve[j]);
        s_alpha[j] = a_new;
        s_delta[j] = inc ? 1 : 0;
        s_dd[slot] = __fsub_rn(a_old, a_new);
      }
      __syncthreads();
      const float d = s_dd[slot];
      if (d != 0.0f) {
        const float* row = resident ? s_gram + j * b : G + static_cast<size_t>(j) * b;
        for (int i = tid; i < b; i += T)
          s_rhs[i] = __fadd_rn(s_rhs[i], __fmul_rn(d, row[i]));
      }
    }
    if (rep + 1 - r0 == reps_per_chunk) {
      r0 = rep + 1;
      __syncthreads();
    }
  }

  // each thread wrote only its own rows: no barrier needed before this
  for (int i = tid; i < b; i += T) {
    rhs[base + i] = s_rhs[i];
    alpha[base + i] = s_alpha[i];
    beta[base + i] = s_beta[i];
    delta[base + i] = s_delta[i];
  }
}

size_t plan(int b, int nreps, int* resident, int* reps_per_chunk, int* err) {
  const size_t state = (4 + static_cast<size_t>(kStateArrays) * b) * 4;
  return jt::smem_plan(b, nreps, state, static_cast<size_t>(b) * 8,  // u, z
                       resident, reps_per_chunk, err);
}

}  // namespace

extern "C" int jt_abc_resident(int b, int nreps) {
  int resident = 0, rpc = 0, err = 0;
  const size_t smem = plan(b, nreps, &resident, &rpc, &err);
  if (err != 0) return -err;
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return resident;
}

extern "C" int jt_abc_inner_rounds(
    const float* grams, const float* xpx, const float* var_eff,
    const float* log_pi, const float* log_pi_comp, float* alpha, float* beta,
    int32_t* delta, float* rhs, const float* us, const float* zs,
    const float* inv_vare, int b, int nblocks, int nreps, void* stream) {
  if (b <= 0 || nblocks <= 0 || nreps <= 0) return cudaErrorInvalidValue;
  int resident = 0, rpc = 0, err = 0;
  const size_t smem = plan(b, nreps, &resident, &rpc, &err);
  if (err != 0) return err;
  if (smem == 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(abc_inner_rounds_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != 0) return err;
  abc_inner_rounds_kernel<<<nblocks, jt::max_threads(b), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      grams, xpx, var_eff, log_pi, log_pi_comp, alpha, beta, delta, rhs, us,
      zs, inv_vare, b, nblocks, nreps, rpc, resident);
  return cudaGetLastError();
}
