// Probes of what one dependent step of the inner-rounds chains
// (abc_inner_rounds.cu, bayesr_inner_rounds.cu) must cost on the card. Each
// probe is one CTA running `steps` steps, every step depending on the one
// before; jwas_tpu_torch/bench_chain.py launches them, nothing else does.
//
//   0  (a)  one __syncthreads of 128 threads and a shared-memory store ->
//           load of the value the next step needs (a step of the
//           one-barrier-a-step schedule, without its arithmetic)
//   1  (b)  one __shfl_sync broadcast and one dependent multiply, then add
//   2  (c1) the spike-slab update's arithmetic on registers (expf and an
//           IEEE division among ~15 dependent operations), closed by the
//           multiply-add that feeds d back into rhs
//   3  (c3) the BayesR update's arithmetic likewise (three class scores, a
//           strict > scan, no transcendental)
//   4  (d1) (c1) with the shuffle of (b) between d and the multiply-add:
//           the floor of a step that changes the marker's effect
//   5  (d3) (c3) likewise
//   6  (e1) (d1) as run_chain does a changing step: the candidate kept by
//           the lanes not yet passed, d shuffled from the next of them, the
//           test that it changed, the Gram entry from shared memory
//   7  (e3) (d3) likewise
//
// The arithmetic copies AbcMarkers::eval and BayesRMarkers::eval. The
// constants are a marker's at n = 512 observations; d is never 0, and
// rhs + xpx * alpha is invariant, so the values stay put for any number of
// steps. `io` holds 16 floats: in, the starting rhs and alpha and what the
// compiler must not know (io[2] = 1, io[3] = 0); out, the final state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kTileStride = 128;

struct Abc {
  float xpx, inv_vare, inv_lhs, c, sq_inv, sq_ve, lp, lpc, u;
  __device__ __forceinline__ float eval(float rhs, float a_old, float z,
                                        float* a_new) const {
    const float t = __fmul_rn(__fadd_rn(rhs, __fmul_rn(xpx, a_old)), inv_vare);
    const float g = __fmul_rn(t, inv_lhs);
    const float ld1 =
        __fadd_rn(__fmul_rn(-0.5f, __fsub_rn(c, __fmul_rn(g, t))), lpc);
    const float prob =
        __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(__fsub_rn(lp, ld1))));
    const bool inc = u < prob;
    const float b_in = __fadd_rn(g, __fmul_rn(z, sq_inv));
    *a_new = inc ? b_in : 0.0f;
    return __fsub_rn(a_old, *a_new);
  }
};

struct BayesR {
  float xpx, inv_vare, il[3], dd[3], sq[3], lp[4], g[4];
  __device__ __forceinline__ float eval(float rhs, float a_old, float z,
                                        float* a_new) const {
    const float t = __fmul_rn(__fadd_rn(rhs, __fmul_rn(xpx, a_old)), inv_vare);
    float score[3], drawn[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float bh = __fmul_rn(il[k], t);
      const float ll = __fmul_rn(0.5f, __fadd_rn(dd[k], __fmul_rn(bh, t)));
      score[k] = __fadd_rn(__fadd_rn(lp[k + 1], ll), g[k + 1]);
      drawn[k] = __fadd_rn(bh, __fmul_rn(z, sq[k]));
    }
    const float s0 = __fadd_rn(lp[0], g[0]);
    const bool u1 = score[0] > s0;
    const float b1 = u1 ? score[0] : s0;
    const bool u2 = score[1] > b1;
    const float b2 = u2 ? score[1] : b1;
    const bool u3 = score[2] > b2;
    *a_new = u3 ? drawn[2] : u2 ? drawn[1] : u1 ? drawn[0] : 0.0f;
    return __fsub_rn(a_old, *a_new);
  }
};

__device__ Abc abc_marker(float one) {
  Abc m;
  m.xpx = 512.0f * one;
  m.inv_vare = one / 1.3f;
  const float lhs = m.xpx * m.inv_vare + 50.0f;
  m.inv_lhs = 1.0f / lhs;
  m.c = logf(lhs) + logf(0.02f * one);
  m.sq_inv = sqrtf(m.inv_lhs);
  m.sq_ve = sqrtf(0.02f * one);
  m.lp = -23.0f * one;       // pi = 1e-10: the marker is always included
  m.lpc = 0.0f;
  m.u = 0.5f * one;
  return m;
}

__device__ BayesR bayesr_marker(float one) {
  BayesR m;
  const float gamma[3] = {0.01f, 0.1f, 1.0f};
  const float prior[4] = {-20.0f, -1.0f, -1.2f, -1.4f};   // never class 0
  const float gum[4] = {0.1f, 0.5f, -0.3f, 0.2f};
  m.xpx = 512.0f * one;
  m.inv_vare = one / 1.3f;
  for (int k = 0; k < 3; ++k) {
    const float var = gamma[k] * 0.001f * one;
    m.il[k] = 1.0f / (m.xpx * m.inv_vare + 1.0f / var);
    m.dd[k] = logf(m.il[k]) - logf(var);
    m.sq[k] = sqrtf(m.il[k]);
  }
  for (int k = 0; k < 4; ++k) {
    m.lp[k] = prior[k] * one;
    m.g[k] = gum[k] * one;
  }
  return m;
}

__global__ void probe_barrier(float* io, int steps) {
  __shared__ float s_x[2];
  const int tid = threadIdx.x;
  float x = io[0];
  for (int s = 0; s < steps; ++s) {
    if (tid == (s & 127)) s_x[s & 1] = __fadd_rn(x, 1e-3f);
    __syncthreads();
    x = s_x[s & 1];
  }
  if (tid == 0) io[8] = x;
}

__global__ void probe_shuffle(float* io, int steps) {
  float x = io[0] + threadIdx.x;
  // add differs by lane as far as the compiler knows, so x does after every
  // step and no shuffle can be dropped as a broadcast of a uniform value
  const float mul = io[2], add = io[3] * threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    x = __shfl_sync(kFullWarp, x, s & 31);
    x = __fadd_rn(__fmul_rn(x, mul), add);
  }
  if (threadIdx.x == 0) io[8] = x;
}

// level 0: arithmetic; 1: + shuffle; 2: the whole changing step of run_chain
template <class M, int kLevel>
__device__ __forceinline__ void probe_marker(const M& m, float* io,
                                             int steps) {
  __shared__ float tile[32 * kTileStride];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 32 * kTileStride; i += blockDim.x)
    tile[i] = m.xpx;
  __syncthreads();
  // rhs differs by lane as far as the compiler knows (io[3] is 0), so the
  // shuffles of d stay
  float rhs = io[0] + io[3] * lane, alpha = io[1];
  const float zabs = 0.7f * io[2];
  const float gram = m.xpx;
  int pos = 0;
  float kept = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const float z = (s & 1) ? zabs : -zabs;
    float a_new;
    float d = m.eval(rhs, alpha, z, &a_new);
    float gf = gram;
    if (kLevel == 2) {
      if (lane >= pos) kept = a_new;
      // run_chain's step: the Gram entry of lane pos is loaded ahead, d
      // comes from lane pos, and the ballot issued beside the shuffle is
      // read only where that lane does not change (never here)
      gf = tile[pos * kTileStride + lane];
      int f = pos;
      const unsigned changing =
          __ballot_sync(kFullWarp, lane > pos && d != 0.0f);
      float df = __shfl_sync(kFullWarp, d, pos);
      if (df == 0.0f) {
        f = changing ? __ffs(changing) - 1 : 31;
        df = __shfl_sync(kFullWarp, d, f);
        gf = tile[f * kTileStride + lane];
      }
      d = df;
      pos = (f + 1) & 31;
    } else if (kLevel == 1) {
      d = __shfl_sync(kFullWarp, d, s & 31);
    }
    alpha = a_new;
    rhs = __fadd_rn(rhs, __fmul_rn(d, gf));
  }
  if (threadIdx.x == 0) {
    io[8] = rhs;
    io[9] = alpha;
    io[10] = kept;
  }
}

template <int kLevel>
__global__ void probe_abc(float* io, int steps) {
  probe_marker<Abc, kLevel>(abc_marker(io[2]), io, steps);
}

template <int kLevel>
__global__ void probe_bayesr(float* io, int steps) {
  probe_marker<BayesR, kLevel>(bayesr_marker(io[2]), io, steps);
}

}  // namespace

extern "C" int jt_chain_probe(int which, float* io, int steps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: probe_barrier<<<1, 128, 0, s>>>(io, steps); break;
    case 1: probe_shuffle<<<1, 32, 0, s>>>(io, steps); break;
    case 2: probe_abc<0><<<1, 32, 0, s>>>(io, steps); break;
    case 3: probe_bayesr<0><<<1, 32, 0, s>>>(io, steps); break;
    case 4: probe_abc<1><<<1, 32, 0, s>>>(io, steps); break;
    case 5: probe_bayesr<1><<<1, 32, 0, s>>>(io, steps); break;
    case 6: probe_abc<2><<<1, 32, 0, s>>>(io, steps); break;
    case 7: probe_bayesr<2><<<1, 32, 0, s>>>(io, steps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
