// Multi-trait BayesC / BayesB inner rounds on Hopper: the marker chain of
// every block, nreps * b strictly sequential marker steps per block, all
// blocks in parallel. K7 is sampler I (one trait's inclusion at a time),
// K8 sampler II (a joint draw over the 2^t inclusion patterns).
//
// Replaces the lax.scan chains of jwas_tpu/ops/multitrait.py: K7 the scan
// at :214 over _mt_abc_marker_update_I (:64) of mt_abc_blocks_I (:162), and
// its exact form, the scan at :263 of mt_abc_exact_I (:230); K8 the scan at
// :354 over _mt_abc_marker_update_II (:274) of mt_abc_blocks_II (:308), and
// :403 of mt_abc_exact_II (:370). The exact forms are this kernel with one
// block a call (ops/multitrait.py).
//
// What bounds it: latency. A call moves a Gram tile and the block's state
// once, but step j reads the rhs of marker j, which every earlier step
// that changed an effect has updated. The time is (steps) x (one step's
// latency): the marker update (t traits in a row for K7; 2^t patterns,
// each a (t, t) Cholesky, inverse and log-determinant, for K8), then a
// rank-t update of the block's rhs by Gram row j.
//
// The design is the simple one, for a kernel that is right first:
//  - one CTA a block; the block's (t, b) rhs lives in shared memory, so
//    whichever thread updates marker j reads its current rhs;
//  - K7: thread 0 runs marker j's trait loop; K8: warp 0 does, one lane a
//    pattern (lanes loop over patterns beyond 32), a warp argmax of
//    log weight + Gumbel (the first index on a tie), then lane 0 draws the
//    effects from the chosen pattern's Cholesky factor of LHS^-1 (the
//    factor the reference takes, MTBayesABC.jl:199);
//  - the worker publishes d = a_old - a_new (t values) in shared memory;
//    one barrier, then every thread adds d_k * gram[j][i] to its markers'
//    rhs (skipped when no effect changed); a second barrier;
//  - each thread fetches its markers' Gram row j+1 entries before the
//    worker starts step j, and the worker the next step's draws.
//
// Rounding follows the plain PyTorch versions (ops/multitrait.py)
// operation by operation: the __f*_rn / __d*_rn intrinsics keep nvcc from
// contracting a*b+c into an FMA, so the inclusion test u < prob1 and the
// argmax see the same rounding as the plain versions on the card.
//
// Two builds a kernel, float32 and float64 (runMCMC's double_precision),
// each instantiated for t = 2..8 traits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCols = 4;          // rhs columns a thread owns: b <= 4096
constexpr int kMaxThreads = 1024;

template <typename T> struct Op;
template <> struct Op<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float log_(float a) { return logf(a); }
  static __device__ __forceinline__ float exp_(float a) { return expf(a); }
};
template <> struct Op<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double log_(double a) { return log(a); }
  static __device__ __forceinline__ double exp_(double a) { return exp(a); }
};

// Arguments shared by both kernels.
template <typename T> struct Args {
  const T* grams;      // (nblocks, b, b)
  const T* xpx;        // (nblocks, b)
  const T* valid;      // (nblocks, b)
  T* alpha;            // (nblocks, t, b), in place
  T* beta;
  T* delta;
  T* rhs;
  const T* Rinv;       // (t, t)
  const T* Ginv;       // (t, t), or (nblocks, b, t, t) when per_locus
  const T* log_pi;     // (2^t,)
  const T* draw_a;     // K7: us (nreps b, t, nblocks); K8: gum (nreps b, 2^t, nblocks)
  const T* zs;         // (nreps b, t, nblocks)
  int b, nblocks, nreps, per_locus;
};

// Shared memory: rhs (t, b), d (t), Rinv (t, t), Ginv (t, t), log_pi (2^t).
template <typename T, int NT>
__host__ __device__ constexpr size_t smem_elems(int b) {
  return (size_t)NT * b + NT + 2 * NT * NT + (1u << NT);
}

// ---------------------------------------------------------------- K7 step

// Sampler I for marker j of this block (thread 0): the trait loop of
// ops/multitrait.py::mt_marker_update_I_ref, then the valid mask; writes
// alpha/beta/delta and d = a_old - a_new; returns whether d != 0.
template <typename T, int NT>
__device__ bool step_I(const Args<T>& A, int k, int j, int s, const T* rhs_s,
                       const T* Rinv, const T* Gsh, const T* log_pi, T* d_out,
                       const T (&u)[NT], const T (&z)[NT]) {
  using O = Op<T>;
  const size_t base = (size_t)k * NT * A.b + j;
  const T x = A.xpx[(size_t)k * A.b + j];
  const T* G = A.per_locus ? A.Ginv + ((size_t)k * A.b + j) * NT * NT : Gsh;
  T a_old[NT], w[NT], be[NT], de[NT], al[NT];
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    a_old[m] = A.alpha[base + (size_t)m * A.b];
    be[m] = A.beta[base + (size_t)m * A.b];
    de[m] = A.delta[base + (size_t)m * A.b];
    w[m] = O::add(rhs_s[m * A.b + j], O::mul(x, a_old[m]));
    al[m] = a_old[m];
  }
  const T one = T(1);
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    const T g_kk = G[kt * NT + kt];
    T acc0 = T(0), c12 = T(0);
    bool first = true;
    int idx0 = 0;
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      if (m == kt) continue;
      const T g_km = G[kt * NT + m];
      const T gb = O::mul(g_km, be[m]);
      const T term = O::mul(O::add(g_km, O::mul(O::mul(x, de[m]), Rinv[kt * NT + m])), be[m]);
      acc0 = first ? gb : O::add(acc0, gb);
      c12 = first ? term : O::add(c12, term);
      first = false;
      idx0 += (de[m] != T(0)) << m;
    }
    const T rhs0 = -acc0;
    const T c11 = O::add(g_kk, O::mul(Rinv[kt * NT + kt], x));
    const T inv_lhs0 = O::div(one, g_kk);
    const T g_hat0 = O::mul(rhs0, inv_lhs0);
    const T inv_lhs1 = O::div(one, c11);
    T rw = O::mul(w[0], Rinv[0 * NT + kt]);
#pragma unroll
    for (int m = 1; m < NT; ++m) rw = O::add(rw, O::mul(w[m], Rinv[m * NT + kt]));
    const T g_hat1 = O::mul(O::sub(rw, c12), inv_lhs1);
    const T lp0 = log_pi[idx0], lp1 = log_pi[idx0 + (1 << kt)];
    const T log_d0 = O::add(O::mul(T(-0.5), O::sub(O::log_(g_kk),
                            O::mul(O::mul(g_hat0, g_hat0), g_kk))), lp0);
    const T log_d1 = O::add(O::mul(T(-0.5), O::sub(O::log_(c11),
                            O::mul(O::mul(g_hat1, g_hat1), c11))), lp1);
    const T prob1 = O::div(one, O::add(one, O::exp_(O::sub(log_d0, log_d1))));
    const bool inc = u[kt] < prob1;
    be[kt] = inc ? O::add(g_hat1, O::mul(z[kt], O::sqrt_(inv_lhs1)))
                 : O::add(g_hat0, O::mul(z[kt], O::sqrt_(inv_lhs0)));
    de[kt] = inc ? one : T(0);
    al[kt] = inc ? be[kt] : T(0);
  }
  const T v = A.valid[(size_t)k * A.b + j];
  bool moved = false;
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    const T a_new = O::mul(al[m], v);
    A.alpha[base + (size_t)m * A.b] = a_new;
    A.beta[base + (size_t)m * A.b] = be[m];
    A.delta[base + (size_t)m * A.b] = O::mul(de[m], v);
    d_out[m] = O::sub(a_old[m], a_new);
    moved |= d_out[m] != T(0);
  }
  (void)s;
  return moved;
}

// ---------------------------------------------------------------- K8 step

// Lower Cholesky factor of a (t, t) SPD matrix, in the plain version's
// order (ops/multitrait.py::_cholesky).
template <typename T, int NT>
__device__ void cholesky(const T (&A)[NT][NT], T (&L)[NT][NT]) {
  using O = Op<T>;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    T s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = O::sub(s, O::mul(L[j][k], L[j][k]));
    L[j][j] = O::sqrt_(s);
#pragma unroll
    for (int i = j + 1; i < NT; ++i) {
      T r = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r = O::sub(r, O::mul(L[i][k], L[j][k]));
      L[i][j] = O::div(r, L[j][j]);
    }
#pragma unroll
    for (int i = 0; i < j; ++i) L[i][j] = T(0);
  }
}

// Pattern s's LHS inverse, g_hat and log weight (without the Gumbel), as
// ops/multitrait.py::mt_marker_update_II_ref computes them.
template <typename T, int NT>
__device__ T pattern_eval(int s, T x, const T* Rinv, const T* G, const T (&rw)[NT],
                          const T* log_pi, T (&inv)[NT][NT], T (&g)[NT]) {
  using O = Op<T>;
  T lhs[NT][NT], L[NT][NT], Li[NT][NT], rhs[NT];
#pragma unroll
  for (int a = 0; a < NT; ++a) {
    rhs[a] = ((s >> a) & 1) ? rw[a] : T(0);
#pragma unroll
    for (int c = 0; c < NT; ++c)
      lhs[a][c] = (((s >> a) & (s >> c)) & 1)
                      ? O::add(O::mul(Rinv[a * NT + c], x), G[a * NT + c])
                      : G[a * NT + c];
  }
  cholesky<T, NT>(lhs, L);
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    Li[c][c] = O::div(T(1), L[c][c]);
#pragma unroll
    for (int i = c + 1; i < NT; ++i) {
      T r = O::mul(L[i][c], Li[c][c]);
#pragma unroll
      for (int k = c + 1; k < i; ++k) r = O::add(r, O::mul(L[i][k], Li[k][c]));
      Li[i][c] = O::div(-r, L[i][i]);
    }
  }
#pragma unroll
  for (int a = 0; a < NT; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int k0 = a > c ? a : c;
      T r = O::mul(Li[k0][a], Li[k0][c]);
#pragma unroll
      for (int k = k0 + 1; k < NT; ++k) r = O::add(r, O::mul(Li[k][a], Li[k][c]));
      inv[a][c] = r;
    }
  T ld = O::log_(L[0][0]);
#pragma unroll
  for (int i = 1; i < NT; ++i) ld = O::add(ld, O::log_(L[i][i]));
  const T logdet = O::mul(T(2), ld);
#pragma unroll
  for (int a = 0; a < NT; ++a) {
    T r = O::mul(inv[a][0], rhs[0]);
#pragma unroll
    for (int c = 1; c < NT; ++c) r = O::add(r, O::mul(inv[a][c], rhs[c]));
    g[a] = r;
  }
  T quad = O::mul(rhs[0], g[0]);
#pragma unroll
  for (int a = 1; a < NT; ++a) quad = O::add(quad, O::mul(rhs[a], g[a]));
  return O::add(O::mul(T(-0.5), O::sub(logdet, quad)), log_pi[s]);
}

// Sampler II for marker j of this block (warp 0); lane 0 writes the state
// and d = a_old - a_new; returns (on lane 0) whether d != 0.
template <typename T, int NT>
__device__ bool step_II(const Args<T>& A, int k, int j, int s, const T* rhs_s,
                        const T* Rinv, const T* Gsh, const T* log_pi, T* d_out) {
  using O = Op<T>;
  constexpr int S = 1 << NT;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)k * NT * A.b + j;
  const T x = A.xpx[(size_t)k * A.b + j];
  const T* G = A.per_locus ? A.Ginv + ((size_t)k * A.b + j) * NT * NT : Gsh;
  T a_old[NT], w[NT], rw[NT];
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    a_old[m] = A.alpha[base + (size_t)m * A.b];
    w[m] = O::add(rhs_s[m * A.b + j], O::mul(x, a_old[m]));
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    T r = O::mul(w[0], Rinv[0 * NT + i]);
#pragma unroll
    for (int m = 1; m < NT; ++m) r = O::add(r, O::mul(w[m], Rinv[m * NT + i]));
    rw[i] = r;
  }
  const T* gum = A.draw_a + (size_t)s * S * A.nblocks + k;
  T best = T(0);
  int best_p = S;
  T inv[NT][NT], g[NT];
  for (int p = lane; p < S; p += 32) {
    const T score = O::add(pattern_eval<T, NT>(p, x, Rinv, G, rw, log_pi, inv, g),
                           gum[(size_t)p * A.nblocks]);
    if (best_p == S || score > best) { best = score; best_p = p; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ob = __shfl_down_sync(0xffffffffu, best, off);
    const int op = __shfl_down_sync(0xffffffffu, best_p, off);
    if (op != S && (best_p == S || ob > best || (ob == best && op < best_p))) {
      best = ob;
      best_p = op;
    }
  }
  const int which = __shfl_sync(0xffffffffu, best_p, 0);
  if (lane != 0) return false;
  pattern_eval<T, NT>(which, x, Rinv, G, rw, log_pi, inv, g);
  T C[NT][NT];
  cholesky<T, NT>(inv, C);
  const T* z = A.zs + (size_t)s * NT * A.nblocks + k;
  T zz[NT];
#pragma unroll
  for (int m = 0; m < NT; ++m) zz[m] = z[(size_t)m * A.nblocks];
  const T v = A.valid[(size_t)k * A.b + j];
  bool moved = false;
#pragma unroll
  for (int a = 0; a < NT; ++a) {
    T acc = O::mul(C[a][0], zz[0]);
#pragma unroll
    for (int c = 1; c <= a; ++c) acc = O::add(acc, O::mul(C[a][c], zz[c]));
    const T be = O::add(g[a], acc);
    const T pa = ((which >> a) & 1) ? T(1) : T(0);
    const T a_new = O::mul(O::mul(be, pa), v);
    A.alpha[base + (size_t)a * A.b] = a_new;
    A.beta[base + (size_t)a * A.b] = be;
    A.delta[base + (size_t)a * A.b] = O::mul(pa, v);
    d_out[a] = O::sub(a_old[a], a_new);
    moved |= d_out[a] != T(0);
  }
  return moved;
}

// ---------------------------------------------------------------- the chain

template <typename T, int NT, bool kII>
__global__ void __launch_bounds__(kMaxThreads)
mt_inner_rounds_kernel(Args<T> A) {
  using O = Op<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rhs_s = reinterpret_cast<T*>(smem_raw);
  T* d_s = rhs_s + (size_t)NT * A.b;
  T* Rinv = d_s + NT;
  T* Gsh = Rinv + NT * NT;
  T* log_pi = Gsh + NT * NT;
  __shared__ int moved_s;
  const int k = blockIdx.x;
  const int b = A.b;
  const T* gram = A.grams + (size_t)k * b * b;
  T* rhs_g = A.rhs + (size_t)k * NT * b;
  for (int i = threadIdx.x; i < NT * b; i += blockDim.x) rhs_s[i] = rhs_g[i];
  for (int i = threadIdx.x; i < NT * NT; i += blockDim.x) {
    Rinv[i] = A.Rinv[i];
    if (!A.per_locus) Gsh[i] = A.Ginv[i];
  }
  for (int i = threadIdx.x; i < (1 << NT); i += blockDim.x) log_pi[i] = A.log_pi[i];
  __syncthreads();

  const int steps = A.nreps * b;
  T gnext[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    gnext[c] = i < b ? gram[i] : T(0);             // Gram row 0
  }
  T u[NT], z[NT];
  if (!kII && threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      u[m] = A.draw_a[(size_t)m * A.nblocks + k];
      z[m] = A.zs[(size_t)m * A.nblocks + k];
    }
  }
  for (int s = 0; s < steps; ++s) {
    const int j = s % b;
    T grow[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) grow[c] = gnext[c];
    if (s + 1 < steps) {                            // next step's Gram row
      const T* nrow = gram + (size_t)((s + 1) % b) * b;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int i = threadIdx.x + c * blockDim.x;
        if (i < b) gnext[c] = nrow[i];
      }
    }
    if (kII) {
      if (threadIdx.x < 32) {
        const bool m = step_II<T, NT>(A, k, j, s, rhs_s, Rinv, Gsh, log_pi, d_s);
        if (threadIdx.x == 0) moved_s = m;
      }
    } else if (threadIdx.x == 0) {
      T un[NT], zn[NT];
      if (s + 1 < steps) {                          // next step's draws
#pragma unroll
        for (int m = 0; m < NT; ++m) {
          un[m] = A.draw_a[((size_t)(s + 1) * NT + m) * A.nblocks + k];
          zn[m] = A.zs[((size_t)(s + 1) * NT + m) * A.nblocks + k];
        }
      }
      moved_s = step_I<T, NT>(A, k, j, s, rhs_s, Rinv, Gsh, log_pi, d_s, u, z);
#pragma unroll
      for (int m = 0; m < NT; ++m) { u[m] = un[m]; z[m] = zn[m]; }
    }
    __syncthreads();
    if (moved_s) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int i = threadIdx.x + c * blockDim.x;
        if (i < b) {
#pragma unroll
          for (int m = 0; m < NT; ++m)
            rhs_s[m * b + i] = O::add(rhs_s[m * b + i], O::mul(d_s[m], grow[c]));
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < NT * b; i += blockDim.x) rhs_g[i] = rhs_s[i];
}

template <typename T, int NT, bool kII>
int launch_t(const Args<T>& A, cudaStream_t stream) {
  const size_t smem = smem_elems<T, NT>(A.b) * sizeof(T);
  auto kern = mt_inner_rounds_kernel<T, NT, kII>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = (A.b + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kern<<<A.nblocks, threads, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

template <typename T, bool kII>
int launch(int t, const Args<T>& A, void* stream) {
  if (A.b < 1 || A.b > kMaxCols * kMaxThreads || A.nblocks < 1 || A.nreps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 2: return launch_t<T, 2, kII>(A, st);
    case 3: return launch_t<T, 3, kII>(A, st);
    case 4: return launch_t<T, 4, kII>(A, st);
    case 5: return launch_t<T, 5, kII>(A, st);
    case 6: return launch_t<T, 6, kII>(A, st);
    case 7: return launch_t<T, 7, kII>(A, st);
    case 8: return launch_t<T, 8, kII>(A, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
Args<T> args(const T* grams, const T* xpx, const T* valid, T* alpha, T* beta,
             T* delta, T* rhs, const T* Rinv, const T* Ginv, const T* log_pi,
             const T* draw_a, const T* zs, int b, int nblocks, int nreps,
             int per_locus) {
  return Args<T>{grams, xpx, valid, alpha, beta, delta, rhs, Rinv, Ginv, log_pi,
                 draw_a, zs, b, nblocks, nreps, per_locus};
}

}  // namespace

#define JT_MT_ENTRY(NAME, T, KII)                                                   \
  extern "C" int NAME(const T* grams, const T* xpx, const T* valid, T* alpha,       \
                      T* beta, T* delta, T* rhs, const T* Rinv, const T* Ginv,      \
                      const T* log_pi, const T* draw_a, const T* zs, int t, int b,  \
                      int nblocks, int nreps, int per_locus, void* stream) {        \
    return launch<T, KII>(t, args<T>(grams, xpx, valid, alpha, beta, delta, rhs,   \
                                     Rinv, Ginv, log_pi, draw_a, zs, b, nblocks,   \
                                     nreps, per_locus), stream);                   \
  }

JT_MT_ENTRY(jt_mt_inner_rounds_I, float, false)
JT_MT_ENTRY(jt_mt_inner_rounds_I_f64, double, false)
JT_MT_ENTRY(jt_mt_inner_rounds_II, float, true)
JT_MT_ENTRY(jt_mt_inner_rounds_II_f64, double, true)
