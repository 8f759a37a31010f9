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
// K9 (mt_c0l_rounds.cu), the multi-trait RR-BLUP / BayesL chain at t = 3:
//
//   8  (f)  the step of K9's first, serial design: 256 threads, the
//           previous d from shared memory into every rhs, the Gram entry
//           loaded one step ahead from global memory, the owner's Rinv w
//           and trait loop (three IEEE divisions in series), d to shared
//           memory, the next owner's inputs loaded from global memory, one
//           barrier
//   9  (g)  (f)'s owner arithmetic alone, on registers (one thread)
//   10 (h)  one __syncthreads of 256 threads and a shared-memory round trip
//   11 (i)  the affine map's step on registers: rhs += d g, then
//           a_new = P rhs + c (t products and t - 1 sums a trait, + c_k)
//           and d = a_old - a_new
//   12 (j)  a hand-off by a tagged word in shared memory: two warps take
//           turns, each spinning on the other's word (one hand-off a step)
//   13 (k)  (i) with d shuffled from lane s mod 32: a step inside a run
//   14 (l)  (k) as the kernel runs it in a run: the Gram entry from shared
//           memory a step ahead, d published by lane 0 as tagged words,
//           a_new stored by the stepping lane
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

// ------------------------------------------------------------- K9 (t = 3)

constexpr int kT = 3;
__device__ float k9_gram[256 * 256];     // (f)'s Gram block
__device__ float k9_in[256 * 16];        // (f)'s inputs a marker

// (f)/(g)'s owner step: Rhs = Rinv w, the trait loop with its divisions
__device__ __forceinline__ void k9_serial_update(const float* rinv, const float* c,
                                                 const float* a_in, const float* z,
                                                 float x, float v, const float (&rj)[kT],
                                                 float (&d)[kT], float (&a_out)[kT]) {
  float w[kT], Rhs[kT], a[kT];
#pragma unroll
  for (int m = 0; m < kT; ++m) w[m] = __fadd_rn(rj[m], __fmul_rn(x, a_in[m]));
#pragma unroll
  for (int q = 0; q < kT; ++q) {
    float acc = __fmul_rn(rinv[q * kT], w[0]);
#pragma unroll
    for (int m = 1; m < kT; ++m) acc = __fadd_rn(acc, __fmul_rn(rinv[q * kT + m], w[m]));
    Rhs[q] = acc;
  }
#pragma unroll
  for (int m = 0; m < kT; ++m) a[m] = a_in[m];
#pragma unroll
  for (int q = 0; q < kT; ++q) {
    float acc = __fmul_rn(c[q * kT], a[0]);
#pragma unroll
    for (int m = 1; m < kT; ++m) acc = __fadd_rn(acc, __fmul_rn(c[q * kT + m], a[m]));
    const float mu = __fadd_rn(__fdiv_rn(__fsub_rn(Rhs[q], acc), c[q * kT + q]), a[q]);
    a[q] = __fadd_rn(mu, __fmul_rn(z[q], c[kT * kT + q]));
  }
#pragma unroll
  for (int m = 0; m < kT; ++m) {
    a_out[m] = __fmul_rn(a[m], v);
    d[m] = __fsub_rn(a_in[m], a_out[m]);
  }
}

// a marker's constants for (f)/(g): Lhs = 512 Rinv + 50 I, sqrt(1 / Lhs_kk),
// alpha, z, xpx, valid (16 floats)
__device__ void k9_marker(float one, float* m) {
  const float rinv[9] = {0.77f, 0.1f, 0.05f, 0.1f, 0.8f, 0.02f, 0.05f, 0.02f, 0.9f};
  for (int e = 0; e < 9; ++e) m[e] = 512.0f * rinv[e] * one + (e % 4 == 0 ? 50.0f : 0.0f);
  for (int q = 0; q < 3; ++q) m[9 + q] = sqrtf(1.0f / m[q * 4]);
  m[12] = 0.05f * one;     // alpha (the same for every trait)
  m[13] = 0.7f * one;      // z
  m[14] = 512.0f * one;    // xpx
  m[15] = one;             // valid
}

__global__ void probe_k9_serial(float* io, int steps) {
  __shared__ float s_d[2][kT];
  __shared__ float s_rinv[kT * kT];
  const int tid = threadIdx.x;
  const float one = io[2];
  for (int j = 0; j < 256; ++j) k9_gram[j * 256 + tid] = 1e-6f * one;
  k9_marker(one, k9_in + tid * 16);
  if (tid < kT * kT) s_rinv[tid] = (tid % 4 == 0 ? 0.8f : 0.05f) * one;
  float rj[kT];
  for (int m = 0; m < kT; ++m) rj[m] = io[0] + io[3] * tid;
  float c[kT * kT + kT], a_in[kT], z[kT], x = 0.0f, v = 0.0f, gnext = 0.0f;
  __syncthreads();
  if (tid == 0) {
    for (int e = 0; e < 12; ++e) c[e] = k9_in[e];
    for (int m = 0; m < kT; ++m) { a_in[m] = k9_in[12]; z[m] = k9_in[13]; }
    x = k9_in[14];
    v = k9_in[15];
  }
  for (int s = 0; s < steps; ++s) {
    const int j = s & 255;
    if (s > 0)
      for (int m = 0; m < kT; ++m) rj[m] = __fadd_rn(rj[m], __fmul_rn(s_d[(s - 1) & 1][m], gnext));
    gnext = k9_gram[j * 256 + tid];
    if (tid == j) {
      float d[kT], a_out[kT];
      k9_serial_update(s_rinv, c, a_in, z, x, v, rj, d, a_out);
      for (int m = 0; m < kT; ++m) s_d[s & 1][m] = d[m];
      io[4] = a_out[0];
    }
    const int j1 = (j + 1) & 255;
    if (tid == j1) {
      const float* in = k9_in + j1 * 16;
      for (int e = 0; e < 12; ++e) c[e] = in[e];
      for (int m = 0; m < kT; ++m) { a_in[m] = in[12]; z[m] = (s & 1) ? -in[13] : in[13]; }
      x = in[14];
      v = in[15];
    }
    __syncthreads();
  }
  if (tid == 0) io[8] = rj[0];
}

__global__ void probe_k9_serial_arith(float* io, int steps) {
  float m[16];
  k9_marker(io[2], m);
  const float rinv[9] = {0.8f * io[2], 0.05f, 0.05f, 0.05f, 0.8f, 0.05f, 0.05f, 0.05f, 0.8f};
  float rj[kT], a_in[kT], z[kT];
  for (int q = 0; q < kT; ++q) { rj[q] = io[0] + io[3] * threadIdx.x; a_in[q] = m[12]; }
  for (int s = 0; s < steps; ++s) {
    for (int q = 0; q < kT; ++q) z[q] = (s & 1) ? -m[13] : m[13];
    float d[kT], a_out[kT];
    k9_serial_update(rinv, m, a_in, z, m[14], m[15], rj, d, a_out);
    for (int q = 0; q < kT; ++q) rj[q] = __fadd_rn(rj[q], __fmul_rn(d[q], 1e-6f));
  }
  if (threadIdx.x == 0) io[8] = rj[0];
}

// (i)/(k)/(l): the new step; P = T^-1 Rinv of (f)'s marker, scaled
struct K9Map {
  float P[kT * kT], c[kT], a[kT];
};
__device__ K9Map k9_map(float one, int lane, float lane_var) {
  K9Map k;
  for (int e = 0; e < 9; ++e) k.P[e] = (e % 4 == 0 ? 1.4e-3f : 1e-4f) * one;
  for (int q = 0; q < kT; ++q) {
    k.c[q] = 0.01f * one + lane_var * lane;
    k.a[q] = 0.05f * one;
  }
  return k;
}

template <int kLevel>
__global__ void probe_k9_map(float* io, int steps) {
  __shared__ float g_tile[32 * 33];
  __shared__ unsigned long long ring[128 * kT];
  __shared__ float alpha_sink[32 * kT];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 32 * 33; i += blockDim.x) g_tile[i] = 1e-3f * io[2];
  __syncthreads();
  const K9Map k = k9_map(io[2], lane, io[3]);
  float cur[kT];
  for (int q = 0; q < kT; ++q) cur[q] = io[0] + io[3] * lane;
  float d[kT] = {0.0f, 0.0f, 0.0f};
  float g_next = g_tile[lane];
  for (int s = 0; s < steps; ++s) {
    const int l = s & 31;
    float g = 1e-3f * io[2];
    if (kLevel == 2) {
      g = g_next;
      g_next = g_tile[((l + 1) & 31) * 33 + lane];
    }
    float an[kT];
#pragma unroll
    for (int q = 0; q < kT; ++q) {
      float acc = __fmul_rn(k.P[q * kT], cur[0]);
#pragma unroll
      for (int m = 1; m < kT; ++m) acc = __fadd_rn(acc, __fmul_rn(k.P[q * kT + m], cur[m]));
      an[q] = __fadd_rn(acc, k.c[q]);
      d[q] = __fsub_rn(k.a[q], an[q]);
      if (kLevel >= 1) d[q] = __shfl_sync(kFullWarp, d[q], l);
    }
    if (kLevel == 2) {
      if (lane == l)
        for (int q = 0; q < kT; ++q) alpha_sink[q * 32 + lane] = an[q];
      if (lane == 0) {
        volatile unsigned long long* slot = ring + (s & 127) * kT;
        const unsigned long long tag = static_cast<unsigned long long>(s + 1) << 32;
        for (int q = 0; q < kT; ++q) slot[q] = tag | __float_as_uint(d[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kT; ++q) cur[q] = __fadd_rn(cur[q], __fmul_rn(d[q], g));
  }
  if (threadIdx.x == 0) {
    io[8] = cur[0];
    if (kLevel == 2) io[9] = alpha_sink[0] + static_cast<float>(ring[0] & 1u);
  }
}

__global__ void probe_k9_flag(float* io, int steps) {
  __shared__ unsigned long long word;
  const int w = threadIdx.x >> 5;
  if (threadIdx.x == 0) word = 0;
  __syncthreads();
  volatile unsigned long long* p = &word;
  float x = io[0];
  for (int s = w; s < steps; s += 2) {
    // wait for step s - 1's word (the other warp's), then publish step s
    if (s > 0)
      while (static_cast<unsigned>(*p >> 32) != static_cast<unsigned>(s)) {
      }
    x = __fadd_rn(__uint_as_float(static_cast<unsigned>(*p)), 1e-3f) + 0.0f * x;
    if ((threadIdx.x & 31) == 0)
      *p = (static_cast<unsigned long long>(s + 1) << 32) | __float_as_uint(x);
  }
  if (threadIdx.x == 0) io[8] = x;
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
    case 8: probe_k9_serial<<<1, 256, 0, s>>>(io, steps); break;
    case 9: probe_k9_serial_arith<<<1, 1, 0, s>>>(io, steps); break;
    case 10: probe_barrier<<<1, 256, 0, s>>>(io, steps); break;
    case 11: probe_k9_map<0><<<1, 32, 0, s>>>(io, steps); break;
    case 12: probe_k9_flag<<<1, 64, 0, s>>>(io, steps); break;
    case 13: probe_k9_map<1><<<1, 32, 0, s>>>(io, steps); break;
    case 14: probe_k9_map<2><<<1, 32, 0, s>>>(io, steps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
