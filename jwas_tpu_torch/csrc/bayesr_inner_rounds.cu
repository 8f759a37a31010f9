// Fast-blocks BayesR inner rounds on Hopper: the 4-class mixture Gibbs chain
// of every marker block, nreps * b strictly sequential updates per block,
// with all blocks in parallel.
//
// Replaces the Pallas kernel jwas_tpu/ops/pallas_sweep.py::
// _bayesr_kernel_resident (:327, entered through bayesr_inner_rounds_pallas
// :412), which needs the Gram tile resident in VMEM. Here residency of the
// b x b Gram tile in shared memory is a launch-time choice: rows are read
// from global memory/L2 when the tile does not fit (b > 224 on the H100).
//
// Design (that of abc_inner_rounds.cu). One CTA per marker block; thread i
// owns row i of the block (rows i, i+T, ... when b > T). Step j of a rep:
// the owner of marker j computes the three slab-class scores from
// shared-memory state, takes the Gumbel-max class (class 0 scores
// lp_0 + g_0; a strict > keeps the first maximum, as argmax does), draws
// the effect, and writes a_old - a_new to a two-slot shared scalar; one
// __syncthreads; then every thread adds (a_old - a_new) * Gram[j][i] to its
// own rhs[i]. The update is skipped when a_old == a_new, which is the
// common case: most markers stay in class 0 with effect 0.
//
// What bounds it: the chain of b * nreps dependent steps, each a barrier
// plus ~20 dependent flops on the owner thread (latency, not bytes). The
// per-marker, per-class constants (1/lhs_k, log(1/lhs_k) - log(var_k),
// sqrt(1/lhs_k), var_k = gamma_k sigma^2) depend only on xpx, 1/vare and
// sigma^2, so they are computed once per call and a step needs no
// transcendental. Draws are an input: the Gumbel panel (4 per step) and
// the normals (1 per step) are staged into shared memory a chunk of reps
// at a time, 16 bytes per Gumbel load.
//
// Rounding follows the plain PyTorch version (bayesr_inner_rounds_ref)
// operation by operation: the __f*_rn intrinsics keep nvcc from contracting
// a*b+c into an FMA, so the class argmax sees the plain version's rounding
// (logf may differ from the host's by an ulp, in the constants only).
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

// per-marker shared state: rhs, alpha, delta, xpx, three classes of
// (1/lhs, d, sqrt(1/lhs)), and the 4 log class priors
constexpr int kStateArrays = 17;

__global__ void bayesr_inner_rounds_kernel(
    const float* __restrict__ grams, const float* __restrict__ xpx,
    const float* __restrict__ log_pi, float* __restrict__ alpha,
    int32_t* __restrict__ delta, float* __restrict__ rhs,
    const float4* __restrict__ gumbel, const float* __restrict__ zs,
    const float* __restrict__ inv_vare_ptr,
    const float* __restrict__ sigma_sq_ptr, int b, int nblocks, int nreps,
    int reps_per_chunk, int resident) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;

  // 16-byte arrays first, so each stays aligned
  float* s_dd = reinterpret_cast<float*>(smem4);    // 2 slots (4 for alignment)
  float4* s_lp = smem4 + 1;                          // b: log class priors
  float4* s_gum = s_lp + b;                          // reps_per_chunk * b
  float* s_zs = reinterpret_cast<float*>(s_gum + reps_per_chunk * b);
  float* s_rhs = s_zs + reps_per_chunk * b;
  float* s_alpha = s_rhs + b;
  int* s_delta = reinterpret_cast<int*>(s_alpha + b);
  float* s_xpx = s_alpha + 2 * b;
  float* s_il = s_xpx + b;                           // 3 * b: 1 / lhs_k
  float* s_d = s_il + 3 * b;                         // 3 * b: log il - log var
  float* s_sq = s_d + 3 * b;                         // 3 * b: sqrt(il)
  float* s_gram = s_sq + 3 * b;                      // b * b when resident

  const float gamma[3] = {0.01f, 0.1f, 1.0f};   // ops/markers.py BAYESR_GAMMA
  const float inv_vare = *inv_vare_ptr;
  const float sigma_sq = *sigma_sq_ptr;
  const size_t base = static_cast<size_t>(k) * b;
  const float* G = grams + base * b;

  for (int i = tid; i < b; i += T) {
    const float x = xpx[base + i];
    s_rhs[i] = rhs[base + i];
    s_alpha[i] = alpha[base + i];
    s_delta[i] = delta[base + i];
    s_xpx[i] = x;
    const float* lp = log_pi + (base + i) * 4;
    s_lp[i] = make_float4(lp[0], lp[1], lp[2], lp[3]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float var = __fmul_rn(gamma[c], sigma_sq);
      const float lhs = __fadd_rn(__fmul_rn(x, inv_vare), __fdiv_rn(1.0f, var));
      const float il = __fdiv_rn(1.0f, lhs);
      s_il[c * b + i] = il;
      s_d[c * b + i] = __fsub_rn(logf(il), logf(var));
      s_sq[c * b + i] = __fsqrt_rn(il);
    }
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
        s_gum[i] = gumbel[t * nblocks + k];
        s_zs[i] = zs[t * nblocks + k];
      }
      __syncthreads();
    }
    const float4* cg = s_gum + (rep - r0) * b;
    const float* cz = s_zs + (rep - r0) * b;
    for (int j = 0; j < b; ++j) {
      const int slot = (rep * b + j) & 1;
      if (tid == j % T) {
        const float a_old = s_alpha[j];
        const float r = __fmul_rn(
            __fadd_rn(s_rhs[j], __fmul_rn(s_xpx[j], a_old)), inv_vare);
        const float4 g = cg[j];
        const float4 lp = s_lp[j];
        const float lpk[3] = {lp.y, lp.z, lp.w};
        const float gk[3] = {g.y, g.z, g.w};
        float best = __fadd_rn(lp.x, g.x);
        int cls = 0;
        float bh_b = 0.0f, sq_b = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float bh = __fmul_rn(s_il[c * b + j], r);
          const float ll =
              __fmul_rn(0.5f, __fadd_rn(s_d[c * b + j], __fmul_rn(bh, r)));
          const float score = __fadd_rn(__fadd_rn(lpk[c], ll), gk[c]);
          if (score > best) {
            best = score;
            cls = c + 1;
            bh_b = bh;
            sq_b = s_sq[c * b + j];
          }
        }
        const float a_new =
            cls == 0 ? 0.0f : __fadd_rn(bh_b, __fmul_rn(cz[j], sq_b));
        s_alpha[j] = a_new;
        s_delta[j] = cls;
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
    delta[base + i] = s_delta[i];
  }
}

size_t plan(int b, int nreps, int* resident, int* reps_per_chunk, int* err) {
  const size_t state = (4 + static_cast<size_t>(kStateArrays) * b) * 4;
  return jt::smem_plan(b, nreps, state, static_cast<size_t>(b) * 20,  // g, z
                       resident, reps_per_chunk, err);
}

}  // namespace

extern "C" int jt_bayesr_resident(int b, int nreps) {
  int resident = 0, rpc = 0, err = 0;
  const size_t smem = plan(b, nreps, &resident, &rpc, &err);
  if (err != 0) return -err;
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return resident;
}

extern "C" int jt_bayesr_inner_rounds(
    const float* grams, const float* xpx, const float* log_pi, float* alpha,
    int32_t* delta, float* rhs, const float* gumbel, const float* zs,
    const float* inv_vare, const float* sigma_sq, int b, int nblocks,
    int nreps, void* stream) {
  if (b <= 0 || nblocks <= 0 || nreps <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(gumbel) % 16) return cudaErrorMisalignedAddress;
  int resident = 0, rpc = 0, err = 0;
  const size_t smem = plan(b, nreps, &resident, &rpc, &err);
  if (err != 0) return err;
  if (smem == 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bayesr_inner_rounds_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != 0) return err;
  bayesr_inner_rounds_kernel<<<nblocks, jt::max_threads(b), smem,
                               static_cast<cudaStream_t>(stream)>>>(
      grams, xpx, log_pi, alpha, delta, rhs,
      reinterpret_cast<const float4*>(gumbel), zs, inv_vare, sigma_sq, b,
      nblocks, nreps, rpc, resident);
  return cudaGetLastError();
}
