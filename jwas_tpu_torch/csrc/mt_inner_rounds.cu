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
// that changed an effect has updated: the time is (dependent steps) x (one
// step's latency). What the design does about it:
//
//  - Nothing that does not depend on the rhs runs inside a step. A
//    pre-pass, one thread a marker (K7) or a (marker, pattern) (K8), writes
//    each marker's constants for the call to device scratch, with the
//    operations and rounding the step used to do: K7 per trait g_kk, c11 =
//    g_kk + Rinv_kk x, their logs, reciprocals and the square roots of
//    those, and per other trait m g_km and g_km + (x delta_m) Rinv_km for
//    delta_m = 0 and 1 (the step picks one by delta_m); K8 per pattern the
//    inverse of its (t, t) LHS (lower triangle: L^-T L^-1 is exactly
//    symmetric), its log-determinant and the Cholesky factor of the
//    inverse. What is left of a K8 step is rw = w Rinv, per pattern the
//    masked rhs, g = inv rhs, the quadratic form and the score, the argmax
//    (first index on a tie) and beta = g + C z for the chosen pattern.
//  - A marker's state (its t rhs values, alpha, beta, delta, valid) lives
//    in its owner thread's registers for the whole call, and is written
//    back once at the end; its xpx comes with its window's draws.
//  - The window schedule of smem_plan.cuh::run_chain with d a vector of t
//    values (the loop is this file's own: it stages each window's inputs
//    and hands on t values a lane): a warp's 32 markers form a window,
//    every lane evaluates its candidate at once; the lanes before the
//    first lane f whose d is not 0
//    commit, lane f broadcasts its t values of d by shuffle, every lane adds
//    d_m G[j_f][i] to its t rhs values and the lanes after f evaluate again.
//    One __syncthreads a window hands the window's d lists and mask
//    (smem_plan.cuh's ChainLists, double buffered) to the other warps, which
//    add them in ascending j. Each rhs[m][i] so receives its d_m G[j][i]
//    additions in the sequential chain's order, and the result equals the
//    sequential chain bit for bit. A thread's 32 Gram values of a window
//    are loaded at once; with one marker a thread, while the window runs.
//  - K7's inclusion test is decided from ex2.approx where u is not within
//    1e-4 of the probability (fast_inclusion), and a lane where it is not
//    runs its marker again with the exact test: the plain version's
//    decision, bit for bit, without its expf, division or a branch on the
//    chain; a trait's pattern priors are loaded while the trait before it
//    runs, and its products with that trait's effect are made for both of
//    that effect's candidates.
//  - What a window reads besides the state comes from shared memory, copied
//    there (cp.async) by the warps that do not run the current window, two
//    windows ahead into one of three buffers where they fit, else one
//    ahead into one of two: the window's constants (while two buffers of
//    them fit: always for K7, t <= 4 for K8; K8 at t >= 5 reads them from
//    the scratch, which the pre-pass has just written to L2), its draws
//    (uniforms or Gumbels, and normals), its markers' xpx, their 2^t pattern
//    priors where the prior is one a marker (kPM), and the 32 x 32
//    diagonal block of its Gram rows. The window's marker holds the
//    constants an evaluation reads in registers where they fit beside the
//    state (t <= 3 or 4).
//  - A CTA is a block, 256 threads at most (__launch_bounds__(256, 1): up
//    to 255 registers a thread), each owning R = 1, 2, 4 or 8 markers: b <=
//    2,048. The window works on a copy of its row's state, so its code is
//    compiled once, not once a row. K8's patterns are an unrolled loop up to
//    t = 4 and a loop above.
//
// Rounding follows the plain PyTorch versions (ops/multitrait.py)
// operation by operation: the __f*_rn / __d*_rn intrinsics keep nvcc from
// contracting a*b+c into an FMA, so the inclusion test u < prob1 and the
// argmax see the same rounding as the plain versions on the card.
// delta and valid hold 0 or 1 (the chain writes nothing else), kept as bits.
//
// The constants' scratch is the caller's: (nblocks, ceil(b / 32), E, 32)
// values of T, E = t (8 + 3 (t - 1)) for K7 and 2^t (t (t + 1) + 1) for K8
// (ops/multitrait.py::scratch_values), 16-byte aligned.
//
// Two builds a kernel, float32 and float64 (runMCMC's double_precision),
// each instantiated for t = 2..8 traits with one (2^t,) pattern prior. A
// prior of one (2^t,) row a marker (2-trait annotated BayesC's, jwas_tpu's
// MarkerSpecificPiPrior, multitrait.py:38-43) is the kPM instantiation, t
// = 2..4, built from mt_inner_rounds_pm.cu (this file with
// JT_MT_PER_MARKER_PRIOR defined, its own nvcc in parallel): a marker's row
// is staged with its window's draws and read at stride kWindow; the global
// prior's code is unchanged.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

#include "smem_plan.cuh"

namespace {

using jt::add_rn;
using jt::div_rn;
using jt::exp_of;
using jt::kFullWarp;
using jt::kWindow;
using jt::log_of;
using jt::mul_rn;
using jt::sqrt_rn;
using jt::sub_rn;

// d of a multi-trait marker, and its rhs: one value a trait.
template <class T, int N>
struct Vec {
  T v[N];
};

// rhs += d * g for each trait, rounded as the plain versions round it (a
// multiply, then an add).
template <class T, int N>
__device__ __forceinline__ void axpy(Vec<T, N>& y, const Vec<T, N>& d, T g) {
#pragma unroll
  for (int m = 0; m < N; ++m) y.v[m] = add_rn(y.v[m], mul_rn(d.v[m], g));
}

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
  const T* log_pi;     // (2^t,), or (nblocks, b, 2^t) per marker (kPM)
  const T* draw_a;     // K7: us (nreps b, t, nblocks); K8: gum (nreps b, 2^t, nblocks)
  const T* zs;         // (nreps b, t, nblocks)
  T* scratch;          // the constants, written by the pre-pass
  int b, nblocks, nreps, per_locus;
};

constexpr int kThreads = 256;        // threads of a chain CTA at most
constexpr int kMaxRows = 8;          // markers a thread owns: b <= 2048
                                     // (ops/multitrait.py::MAX_BLOCK)
constexpr int kPrepThreads = 256;
constexpr size_t kSmemCap = 232448;  // the H100's shared memory a block
constexpr int kMaxPriorTraits = 4;   // a per-marker pattern prior: t <= 4
                                     // (ops/multitrait.py::MAX_PRIOR_TRAITS)

// Sizes of the per-marker constants, draws and shared memory.
template <class T, int NT, bool kII, bool kPM = false>
struct Plan {
  static constexpr int S = 1 << NT;
  static constexpr int kTri = NT * (NT + 1) / 2;
  static constexpr int kPat = 2 * kTri + 1;         // K8: inv, logdet, C
  static constexpr int kEvalPat = kTri + 1;         // K8: inv, logdet
  static constexpr int kFactors = S * kEvalPat;     // K8: where the C start
  static constexpr int kTrait = 8 + 3 * (NT - 1);   // K7: one trait's
  static constexpr int E = kII ? S * kPat : NT * kTrait;   // a marker's
  static constexpr int D = kII ? S + NT : 2 * NT;          // draws a marker
  // and its xpx, then its S pattern priors where they are per marker
  static constexpr int kInputs = D + 1 + (kPM ? S : 0);
  static constexpr size_t kLists = sizeof(jt::ChainLists<Vec<T, NT>>);
  // log_pi and Rinv, rounded up to 16 bytes
  static constexpr size_t kShared = ((S + NT * NT) * sizeof(T) + 15) / 16 * 16;
  __host__ __device__ static constexpr size_t kBuf(int values) {
    return static_cast<size_t>(values) * kWindow * sizeof(T);
  }
  static constexpr bool kStaged =
      kLists + kShared + 2 * kBuf(E + kInputs + kWindow) <= kSmemCap;
  static constexpr int kSlot = (kStaged ? E : 0) + kInputs + kWindow;

  // constants an evaluation reads (K7: all; K8: inv and logdet) and the
  // registers they take, held for a window where they fit beside the
  // markers' state
  static constexpr int kEvalConsts = kII ? kFactors : E;
  __host__ __device__ static constexpr int regs(int values) {
    return values * static_cast<int>(sizeof(T)) / 4;
  }
  __host__ __device__ static constexpr bool hoisted(int rows) {
    return kStaged && regs(kEvalConsts) + rows * regs(3 * NT + 1) <= 120;
  }
  // K8's argmax as a tree (every pattern's score and g live at once)
  __host__ __device__ static constexpr bool tree(int rows) {
    return S <= 16 && regs(S * (NT + 1)) + rows * regs(3 * NT + 1) <= 150;
  }
  // window inputs staged ahead: two windows where three buffers fit
  static constexpr int kBuffers = kLists + kShared + 3 * kBuf(kSlot) <= kSmemCap ? 3 : 2;
  static constexpr size_t smem = kLists + kShared + kBuffers * kBuf(kSlot);
};

// ------------------------------------------------------- the pre-passes

// Sampler I's constants of marker (k, window w, lane): field
// kt * kTrait + [g_kk, c11, log g_kk, log c11, 1/g_kk, 1/c11, sqrt(1/g_kk),
// sqrt(1/c11)], then for the q-th trait m != kt, 8 + 3q + [g_km,
// g_km + (x 0) Rinv_km, g_km + (x 1) Rinv_km]; as
// ops/multitrait.py::mt_marker_update_I_ref computes them.
template <class T, int NT>
__global__ void __launch_bounds__(kPrepThreads)
consts_I(Args<T> A, T* __restrict__ scratch, int nw) {
  using P = Plan<T, NT, false>;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(A.nblocks) * nw * kWindow) return;
  const int lane = idx % kWindow;
  const size_t kw = idx / kWindow;
  const int k = kw / nw;
  const int j = (kw % nw) * kWindow + lane;
  T* out = scratch + kw * P::E * kWindow + lane;
  if (j >= A.b) {
    for (int e = 0; e < P::E; ++e) out[e * kWindow] = T(0);
    return;
  }
  const T x = A.xpx[static_cast<size_t>(k) * A.b + j];
  const T* G = A.per_locus ? A.Ginv + (static_cast<size_t>(k) * A.b + j) * NT * NT
                           : A.Ginv;
  const T* R = A.Rinv;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    T* o = out + kt * P::kTrait * kWindow;
    const T g_kk = G[kt * NT + kt];
    const T c11 = add_rn(g_kk, mul_rn(R[kt * NT + kt], x));
    const T i0 = div_rn(T(1), g_kk);
    const T i1 = div_rn(T(1), c11);
    o[0] = g_kk;
    o[kWindow] = c11;
    o[2 * kWindow] = log_of(g_kk);
    o[3 * kWindow] = log_of(c11);
    o[4 * kWindow] = i0;
    o[5 * kWindow] = i1;
    o[6 * kWindow] = sqrt_rn(i0);
    o[7 * kWindow] = sqrt_rn(i1);
    int q = 0;
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      if (m == kt) continue;
      const T g_km = G[kt * NT + m];
      const T r = R[kt * NT + m];
      o[(8 + 3 * q) * kWindow] = g_km;
      o[(9 + 3 * q) * kWindow] = add_rn(g_km, mul_rn(mul_rn(x, T(0)), r));
      o[(10 + 3 * q) * kWindow] = add_rn(g_km, mul_rn(mul_rn(x, T(1)), r));
      ++q;
    }
  }
}

// Lower Cholesky factor of a (t, t) SPD matrix, in the plain version's
// order (ops/multitrait.py::_cholesky); the upper triangle of L is not set.
template <typename T, int NT>
__device__ __forceinline__ void cholesky(const T (&A)[NT][NT], T (&L)[NT][NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    T s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = sub_rn(s, mul_rn(L[j][k], L[j][k]));
    L[j][j] = sqrt_rn(s);
#pragma unroll
    for (int i = j + 1; i < NT; ++i) {
      T r = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r = sub_rn(r, mul_rn(L[i][k], L[j][k]));
      L[i][j] = div_rn(r, L[j][j]);
    }
  }
}

// Sampler II's constants of pattern s of marker (k, window w, lane): fields
// s * kEvalPat + [the LHS inverse's lower triangle by rows (kTri), the
// log-determinant], and kFactors + s * kTri + [the Cholesky factor of the
// inverse by rows]; as ops/multitrait.py::mt_marker_update_II_ref computes
// them (_cholesky, _spd_inverse).
template <class T, int NT>
__global__ void __launch_bounds__(kPrepThreads)
consts_II(Args<T> A, T* __restrict__ scratch, int nw) {
  using P = Plan<T, NT, true>;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(A.nblocks) * nw * P::S * kWindow) return;
  const int lane = idx % kWindow;
  const int s = (idx / kWindow) % P::S;
  const size_t kw = idx / kWindow / P::S;
  const int k = kw / nw;
  const int j = (kw % nw) * kWindow + lane;
  T* out = scratch + (kw * P::E + s * P::kEvalPat) * kWindow + lane;
  T* out_c = scratch + (kw * P::E + P::kFactors + s * P::kTri) * kWindow + lane;
  if (j >= A.b) {
    for (int e = 0; e < P::kEvalPat; ++e) out[e * kWindow] = T(0);
    for (int e = 0; e < P::kTri; ++e) out_c[e * kWindow] = T(0);
    return;
  }
  const T x = A.xpx[static_cast<size_t>(k) * A.b + j];
  const T* G = A.per_locus ? A.Ginv + (static_cast<size_t>(k) * A.b + j) * NT * NT
                           : A.Ginv;
  T lhs[NT][NT], L[NT][NT], Li[NT][NT], inv[NT][NT], C[NT][NT];
#pragma unroll
  for (int a = 0; a < NT; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c)
      lhs[a][c] = ((s >> a) & (s >> c) & 1)
                      ? add_rn(mul_rn(A.Rinv[a * NT + c], x), G[a * NT + c])
                      : G[a * NT + c];
  cholesky<T, NT>(lhs, L);
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    Li[c][c] = div_rn(T(1), L[c][c]);
#pragma unroll
    for (int i = c + 1; i < NT; ++i) {
      T r = mul_rn(L[i][c], Li[c][c]);
#pragma unroll
      for (int k2 = c + 1; k2 < i; ++k2) r = add_rn(r, mul_rn(L[i][k2], Li[k2][c]));
      Li[i][c] = div_rn(-r, L[i][i]);
    }
  }
#pragma unroll
  for (int a = 0; a < NT; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) {
      T r = mul_rn(Li[a][a], Li[a][c]);             // k0 = max(a, c) = a
#pragma unroll
      for (int k2 = a + 1; k2 < NT; ++k2) r = add_rn(r, mul_rn(Li[k2][a], Li[k2][c]));
      inv[a][c] = r;
      inv[c][a] = r;
    }
  T ld = log_of(L[0][0]);
#pragma unroll
  for (int i = 1; i < NT; ++i) ld = add_rn(ld, log_of(L[i][i]));
  cholesky<T, NT>(inv, C);
  int e = 0;
#pragma unroll
  for (int a = 0; a < NT; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) out[(e++) * kWindow] = inv[a][c];
  out[e * kWindow] = mul_rn(T(2), ld);
  e = 0;
#pragma unroll
  for (int a = 0; a < NT; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) out_c[(e++) * kWindow] = C[a][c];
}

// Index of (a, c), c <= a, in a lower triangle stored by rows.
__host__ __device__ constexpr int tri(int a, int c) { return a * (a + 1) / 2 + c; }

// ------------------------------------------------------- the chain's markers

// u < 1 / (1 + exp(x)) as the plain version rounds it (expf or exp, then an
// IEEE division), decided without them where that is safe. With e ~ exp(x)
// from ex2.approx (relative error under 1e-5 for |x| <= 88, the float
// argument's rounding included), u (1 + e) - 1 = (u - p)(1 + e) for p =
// 1 / (1 + e): where it is farther than 1e-4 from 0 (u farther than 1e-4 p
// from p) and u >= 1e-6, its sign is the plain version's answer. Elsewhere
// *unsure is set and the caller decides exactly (exact_inclusion).
template <class T>
__device__ __forceinline__ bool fast_inclusion(T u, T x, bool* unsure) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(static_cast<float>(x) * 1.44269504f));
  const float uf = static_cast<float>(u);
  const float y = fmaf(uf, e, uf);
  *unsure |= !(uf >= 1e-6f && (y < 1.0f - 1e-4f || y > 1.0f + 1e-4f));
  return y < 1.0f - 1e-4f;
}

template <class T>
__device__ __forceinline__ bool exact_inclusion(T u, T x) {
  return u < div_rn(T(1), add_rn(T(1), exp_of(x)));
}

// The R markers one thread owns, in registers, and the candidate of the
// window's marker. The window works on a copy of its row's state (cur_*,
// picked by the row: the window's code is compiled once, not once a row).
// cst and drw point at this lane's constants and draws of the current
// window (stride kWindow), lp and Rv at log_pi and Rinv in shared memory.
template <class T, int NT, bool kII, bool kPM, int R>
struct MtMarkers {
  using P = Plan<T, NT, kII, kPM>;
  static constexpr int kLp = kPM ? kWindow : 1;   // stride of lp
  using V = Vec<T, NT>;
  static constexpr unsigned kValid = 1u << NT;
  static constexpr unsigned kDelta = kValid - 1;

  V alpha[R], beta[R];
  unsigned bits[R];                 // delta by trait, valid at bit NT
  V cur_alpha, cur_beta;            // the window's row
  T cur_xpx;
  unsigned cur_bits;
  const T* cst;
  const T* drw;
  const T* lp;                      // log pi: shared, or the window's marker's row
  const T* Rv;
  V a_new, b_new;                   // the candidate of the last eval
  unsigned d_new;
  V kept_a, kept_b;                 // shadow state of the window's marker
  unsigned kept_d;
  static constexpr bool kHoisted = P::hoisted(R);
  T kc[kHoisted ? P::kEvalConsts : 1];   // the window's constants, when hoisted

  // constant e of the window's marker
  __device__ __forceinline__ T con(int e) const {
    if constexpr (kHoisted) return kc[e];
    else return cst[e * kWindow];
  }

  __device__ __forceinline__ void load(int r) {
    if constexpr (kHoisted) {
#pragma unroll
      for (int e = 0; e < P::kEvalConsts; ++e) kc[e] = cst[e * kWindow];
    }
    cur_alpha = alpha[0];
    cur_beta = beta[0];
    cur_bits = bits[0];
#pragma unroll
    for (int rr = 1; rr < R; ++rr)
      if (r == rr) {
        cur_alpha = alpha[rr];
        cur_beta = beta[rr];
        cur_bits = bits[rr];
      }
    cur_xpx = drw[P::D * kWindow];  // staged with the draws
    if constexpr (kPM) lp = drw + (P::D + 1) * kWindow;   // and its priors
  }

  // w = rhs + x a_old and rw = w Rinv (rw[i] = sum_m w[m] Rinv[m][i])
  __device__ __forceinline__ void rhs_w(const V& rhs, T (&rw)[NT]) const {
    T w[NT];
#pragma unroll
    for (int m = 0; m < NT; ++m) w[m] = add_rn(rhs.v[m], mul_rn(cur_xpx, cur_alpha.v[m]));
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      T acc = mul_rn(w[0], Rv[i]);
#pragma unroll
      for (int m = 1; m < NT; ++m) acc = add_rn(acc, mul_rn(w[m], Rv[m * NT + i]));
      rw[i] = acc;
    }
  }

  // The pattern priors trait k needs, for both values of trait k - 1's
  // indicator (the last one it waits for): lp[0..1] with trait k out,
  // lp[2..3] with it in. de's bits below k - 1 must be final.
  __device__ __forceinline__ void priors(int k, unsigned de, T (&out)[4]) const {
    const unsigned prev = k > 0 ? 1u << (k - 1) : 0u;
    const unsigned rest = de & ~(1u << k) & ~prev;
    out[0] = lp[rest * kLp];
    out[1] = lp[(rest | prev) * kLp];
    out[2] = lp[(rest | 1u << k) * kLp];
    out[3] = lp[(rest | prev | 1u << k) * kLp];
  }

  // sampler I: the trait loop of mt_marker_update_I_ref on the constants.
  // The priors of trait k + 1 are loaded while trait k runs; trait k's
  // products with trait k - 1's effect are made for both of its candidates
  // before its test and picked after it. kExact: every inclusion test
  // exact; else the fast test, *unsure set where it cannot decide.
  template <bool kExact>
  __device__ __forceinline__ void eval_I(const T (&rw)[NT], V& be, unsigned& de,
                                         V& al, bool* unsure) const {
    be = cur_beta;
    de = cur_bits & kDelta;
    T lpk[4];
    priors(0, de, lpk);
    T gb_in = T(0), gb_out = T(0), term_in = T(0), term_out = T(0);
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      T lpn[4];
      if (kt + 1 < NT) priors(kt + 1, de, lpn);
      const int c = kt * P::kTrait;
      const bool prev_in = kt > 0 && (de >> (kt - 1) & 1);
      T acc0 = T(0), c12 = T(0);
      int q = 0;
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        if (m == kt) continue;
        T gb, term;
        if (m == kt - 1) {
          gb = prev_in ? gb_in : gb_out;
          term = prev_in ? term_in : term_out;
        } else {
          const T c_km = (de >> m & 1) ? con(c + 10 + 3 * q) : con(c + 9 + 3 * q);
          gb = mul_rn(con(c + 8 + 3 * q), be.v[m]);
          term = mul_rn(c_km, be.v[m]);
        }
        acc0 = q == 0 ? gb : add_rn(acc0, gb);
        c12 = q == 0 ? term : add_rn(c12, term);
        ++q;
      }
      const T g_kk = con(c), c11 = con(c + 1);
      const T g_hat0 = mul_rn(-acc0, con(c + 4));
      const T g_hat1 = mul_rn(sub_rn(rw[kt], c12), con(c + 5));
      const T log_d0 = add_rn(
          mul_rn(T(-0.5), sub_rn(con(c + 2), mul_rn(mul_rn(g_hat0, g_hat0), g_kk))),
          prev_in ? lpk[1] : lpk[0]);
      const T log_d1 = add_rn(
          mul_rn(T(-0.5), sub_rn(con(c + 3), mul_rn(mul_rn(g_hat1, g_hat1), c11))),
          prev_in ? lpk[3] : lpk[2]);
      const T z = drw[(NT + kt) * kWindow];
      const T b_in = add_rn(g_hat1, mul_rn(z, con(c + 7)));
      const T b_out = add_rn(g_hat0, mul_rn(z, con(c + 6)));
      if (kt + 1 < NT) {             // trait kt + 1's products with this effect
        const int cn = (kt + 1) * P::kTrait + 3 * kt;   // its q-th other trait: q = kt
        gb_in = mul_rn(con(cn + 8), b_in);
        gb_out = mul_rn(con(cn + 8), b_out);
        term_in = mul_rn(con(cn + 10), b_in);
        term_out = mul_rn(con(cn + 9), b_out);
      }
      const T u = drw[kt * kWindow];
      const T x = sub_rn(log_d0, log_d1);
      const bool inc = kExact ? exact_inclusion(u, x) : fast_inclusion(u, x, unsure);
      be.v[kt] = inc ? b_in : b_out;
      de = inc ? de | 1u << kt : de & ~(1u << kt);
      al.v[kt] = inc ? b_in : T(0);
#pragma unroll
      for (int i = 0; i < 4; ++i) lpk[i] = lpn[i];
    }
  }

  // pattern s's g = inv rhs_s and its score (without the Gumbel)
  __device__ __forceinline__ T pattern(int s, const T (&rw)[NT], T (&g)[NT]) const {
    const int c = s * P::kEvalPat;
    T rr[NT];
#pragma unroll
    for (int a = 0; a < NT; ++a) rr[a] = (s >> a & 1) ? rw[a] : T(0);
#pragma unroll
    for (int a = 0; a < NT; ++a) {
      T acc = mul_rn(con(c + tri(a, 0)), rr[0]);
#pragma unroll
      for (int k2 = 1; k2 < NT; ++k2)
        acc = add_rn(acc, mul_rn(con(c + (a >= k2 ? tri(a, k2) : tri(k2, a))), rr[k2]));
      g[a] = acc;
    }
    T quad = mul_rn(rr[0], g[0]);
#pragma unroll
    for (int a = 1; a < NT; ++a) quad = add_rn(quad, mul_rn(rr[a], g[a]));
    return add_rn(mul_rn(T(-0.5), sub_rn(con(c + P::kTri), quad)), lp[s * kLp]);
  }

  // sampler II: the scores of all patterns, the first argmax with the
  // Gumbels (a tree where the registers allow, in which a later pattern
  // wins only by a larger score; else in order), beta = g + C z of the
  // chosen one
  __device__ __forceinline__ void eval_II(const T (&rw)[NT], V& be, unsigned& de,
                                          V& al) const {
    T gsel[NT];
    int which = 0;
    if constexpr (P::tree(R)) {
      T sc[P::S], gs[P::S][NT];
      int id[P::S];
#pragma unroll
      for (int s = 0; s < P::S; ++s) {
        sc[s] = add_rn(pattern(s, rw, gs[s]), drw[s * kWindow]);
        id[s] = s;
      }
#pragma unroll
      for (int w = 1; w < P::S; w *= 2)
#pragma unroll
        for (int i = 0; i < P::S; i += 2 * w)
          if (sc[i + w] > sc[i]) {
            sc[i] = sc[i + w];
            id[i] = id[i + w];
#pragma unroll
            for (int a = 0; a < NT; ++a) gs[i][a] = gs[i + w][a];
          }
      which = id[0];
#pragma unroll
      for (int a = 0; a < NT; ++a) gsel[a] = gs[0][a];
    } else {
      T best = T(0);
#pragma unroll 1
      for (int s = 0; s < P::S; ++s) {
        T g[NT];
        const T score = add_rn(pattern(s, rw, g), drw[s * kWindow]);
        if (s == 0 || score > best) {
          best = score;
          which = s;
#pragma unroll
          for (int a = 0; a < NT; ++a) gsel[a] = g[a];
        }
      }
    }
    const T* C = cst + (P::kFactors + which * P::kTri) * kWindow;
    const T* z = drw + P::S * kWindow;
#pragma unroll
    for (int a = 0; a < NT; ++a) {
      T acc = mul_rn(C[tri(a, 0) * kWindow], z[0]);
#pragma unroll
      for (int c = 1; c <= a; ++c)
        acc = add_rn(acc, mul_rn(C[tri(a, c) * kWindow], z[c * kWindow]));
      be.v[a] = add_rn(gsel[a], acc);
      al.v[a] = mul_rn(be.v[a], (which >> a & 1) ? T(1) : T(0));
    }
    de = which;
  }

  // candidate update of the window's marker from its state, which it
  // leaves alone; returns a_old - a_new
  __device__ __forceinline__ V eval(const V& rhs) {
    T rw[NT];
    rhs_w(rhs, rw);
    V al;
    if constexpr (kII) {
      eval_II(rw, b_new, d_new, al);
    } else {
      // the lanes whose fast inclusion tests could not decide them run
      // the marker again with exact tests (a uniform branch, rarely taken)
      bool unsure = false;
      eval_I<false>(rw, b_new, d_new, al, &unsure);
      if (__any_sync(kFullWarp, unsure) && unsure)
        eval_I<true>(rw, b_new, d_new, al, &unsure);
    }
    const bool valid = cur_bits & kValid;
    const T v = valid ? T(1) : T(0);
    V d;
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      a_new.v[m] = mul_rn(al.v[m], v);
      d.v[m] = sub_rn(cur_alpha.v[m], a_new.v[m]);
    }
    if (!valid) d_new = 0;
    return d;
  }

  __device__ __forceinline__ void keep() {
    kept_a = a_new;
    kept_b = b_new;
    kept_d = d_new;
  }

  // makes the shadow row r's state; returns a_old - a_new
  __device__ __forceinline__ V finish(int r) {
    V d;
#pragma unroll
    for (int m = 0; m < NT; ++m) d.v[m] = sub_rn(cur_alpha.v[m], kept_a.v[m]);
    const unsigned b_r = (cur_bits & kValid) | kept_d;
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
      if (r == rr) {
        alpha[rr] = kept_a;
        beta[rr] = kept_b;
        bits[rr] = b_r;
      }
    return d;
  }
};

// The window's Gram values G[j0 + q0 + q][i], q < N, of column i (rows: G's
// row j0), all loads in flight at once; the rows past nact are not needed.
template <class T, int N>
__device__ __forceinline__ void gram_column(T (&g)[N], const T* rows, int b, int nact,
                                            int i, int q0 = 0) {
#pragma unroll
  for (int q = 0; q < N; ++q)
    g[q] = rows[static_cast<size_t>(min(q0 + q, nact - 1)) * b + i];
}

// rhs += d_q G[j0 + q][i] for the window's changes q = q0 + 0..N-1 (mask),
// in ascending q, with d from shared memory.
template <class T, int NT, int N>
__device__ __forceinline__ void add_changes(Vec<T, NT>& rhs, const Vec<T, NT>* d,
                                            unsigned mask, const T (&g)[N], int q0 = 0) {
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (mask >> (q0 + q) & 1) axpy(rhs, d[q0 + q], g[q]);
}

template <class T, int NT>
__device__ __forceinline__ bool nonzero(const Vec<T, NT>& d) {
  bool any = false;
#pragma unroll
  for (int m = 0; m < NT; ++m) any |= d.v[m] != T(0);
  return any;
}

template <class T, int NT>
__device__ __forceinline__ Vec<T, NT> shfl(const Vec<T, NT>& d, int src) {
  Vec<T, NT> out;
#pragma unroll
  for (int m = 0; m < NT; ++m) out.v[m] = __shfl_sync(kFullWarp, d.v[m], src);
  return out;
}

// Copies window (rep, wi)'s constants (when staged), draws, xpx and Gram
// diagonal block to dst, all threads of the CTA but the warp busy_warp;
// lanes past b get zeros.
template <class T, int NT, bool kII, bool kPM>
__device__ __forceinline__ void stage(const Args<T>& A, const T* scratch, int nw,
                                      int rep, int wi, T* dst, int busy_warp) {
  using P = Plan<T, NT, kII, kPM>;
  constexpr int kA = kII ? P::S : NT;        // draw_a values a step
  // the warp that runs the current window copies nothing, unless it is the
  // only one
  int tid = threadIdx.x;
  int nt = blockDim.x;
  if (nt > kWindow && busy_warp >= 0) {
    if (tid / kWindow == busy_warp) return;
    if (tid / kWindow > busy_warp) tid -= kWindow;
    nt -= kWindow;
  }
  const int k = blockIdx.x;
  const int j0 = wi * kWindow;
  const int nact = min(kWindow, A.b - j0);
  if constexpr (P::kStaged) {
    const float4* src = reinterpret_cast<const float4*>(
        scratch + (static_cast<size_t>(k) * nw + wi) * P::E * kWindow);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    constexpr int n16 = P::E * kWindow * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < n16; i += nt) __pipeline_memcpy_async(dst4 + i, src + i, 16);
    dst += P::E * kWindow;
  }
  for (int i = tid; i < P::kInputs * kWindow; i += nt) {
    const int f = i / kWindow, l = i % kWindow;
    if (l < nact) {
      const size_t s = static_cast<size_t>(rep) * A.b + j0 + l;
      const size_t jm = static_cast<size_t>(k) * A.b + j0 + l;   // the marker
      const T* src = f < kA     ? A.draw_a + (s * kA + f) * A.nblocks + k
                     : f < P::D ? A.zs + (s * NT + f - kA) * A.nblocks + k
                     : f == P::D ? A.xpx + jm
                                 : A.log_pi + jm * P::S + (f - P::D - 1);
      __pipeline_memcpy_async(dst + i, src, sizeof(T));
    } else {
      dst[i] = T(0);
    }
  }
  dst += P::kInputs * kWindow;
  const T* G = A.grams + (static_cast<size_t>(k) * A.b + j0) * A.b + j0;
  for (int i = tid; i < kWindow * kWindow; i += nt) {
    const int q = i / kWindow, l = i % kWindow;
    if (q < nact && l < nact)
      __pipeline_memcpy_async(dst + i, G + static_cast<size_t>(q) * A.b + l, sizeof(T));
    else
      dst[i] = T(0);
  }
}

// ------------------------------------------------------- the chain

template <class T, int NT, bool kII, bool kPM, int R>
__global__ void __launch_bounds__(kThreads, 1)
mt_chain(Args<T> A, const T* __restrict__ scratch, int nw) {
  using P = Plan<T, NT, kII, kPM>;
  using V = Vec<T, NT>;
  extern __shared__ float4 smem4[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem4);
  auto* ls = reinterpret_cast<jt::ChainLists<V>*>(raw);
  T* lp = reinterpret_cast<T*>(raw + P::kLists);
  T* Rv = lp + P::S;
  T* const buf0 = reinterpret_cast<T*>(raw + P::kLists + P::kShared);
  auto buffer = [&](int i) { return buf0 + i * P::kSlot * kWindow; };
  constexpr bool kEarly = R == 1;  // Gram values loaded before the barrier
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int b = A.b;
  const T* G = A.grams + static_cast<size_t>(k) * b * b;

  if constexpr (!kPM)
    for (int i = tid; i < P::S; i += nt) lp[i] = A.log_pi[i];
  for (int i = tid; i < NT * NT; i += nt) Rv[i] = A.Rinv[i];

  MtMarkers<T, NT, kII, kPM, R> m;
  V rhs[R];
  m.lp = lp;
  m.Rv = Rv;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * nt + tid;
    const bool own = i < b;
    const size_t base = static_cast<size_t>(k) * NT * b + i;
    unsigned bits = own && A.valid[static_cast<size_t>(k) * b + i] != T(0)
                        ? MtMarkers<T, NT, kII, kPM, R>::kValid : 0u;
#pragma unroll
    for (int mm = 0; mm < NT; ++mm) {
      rhs[r].v[mm] = own ? A.rhs[base + mm * b] : T(0);
      m.alpha[r].v[mm] = own ? A.alpha[base + mm * b] : T(0);
      m.beta[r].v[mm] = own ? A.beta[base + mm * b] : T(0);
      bits |= (own && A.delta[base + mm * b] != T(0)) ? 1u << mm : 0u;
    }
    m.bits[r] = bits;
  }

  // Window n's inputs are staged in buffer n % kBuffers, kBuffers - 1
  // windows ahead: (srep, swi) is the next window to stage.
  int srep = 0, swi = 0;
  auto stage_next = [&](int into, int busy_warp) {
    if (srep < A.nreps)
      stage<T, NT, kII, kPM>(A, scratch, nw, srep, swi, buffer(into), busy_warp);
    __pipeline_commit();
    if (++swi == nw) {
      swi = 0;
      ++srep;
    }
  };
#pragma unroll
  for (int i = 0; i + 1 < P::kBuffers; ++i) stage_next(i, -1);
  __pipeline_wait_prior(0);
  __syncthreads();

  int n = 0;                       // windows so far: picks the buffers
  for (int rep = 0; rep < A.nreps; ++rep) {
    for (int wi = 0, r = 0, ww = 0; wi < nw; ++wi) {   // window wi: row r of warp ww
      const int j0 = wi * kWindow;
      const int buf = n & 1;       // the d lists
      stage_next((n + P::kBuffers - 1) % P::kBuffers, ww);
      const int nact = min(kWindow, b - j0);
      // one marker a thread: the other warps load their Gram values of this
      // window's rows while it runs
      T gcol[kEarly ? kWindow : 1];
      if constexpr (kEarly)
        if (warp != ww && tid < b)
          gram_column(gcol, G + static_cast<size_t>(j0) * b, b, nact, tid);
      if (warp == ww) {
        const T* sb = buffer(n % P::kBuffers);
        m.cst = P::kStaged
                    ? sb + lane
                    : scratch + (static_cast<size_t>(k) * nw + wi) * P::E * kWindow + lane;
        m.drw = sb + (P::kStaged ? P::E * kWindow : 0) + lane;
        const T* gw = sb + P::kSlot * kWindow - kWindow * kWindow;   // G[j0 + f][j0 + lane]
        m.load(r);
        V cur_rhs = rhs[0];
#pragma unroll
        for (int rr = 1; rr < R; ++rr)
          if (r == rr) cur_rhs = rhs[rr];
        int pos = 0;               // the chain has passed the lanes below pos
        for (;;) {
          // the Gram entry a change at lane pos needs: its address is known
          // before the evaluation, so the load leaves the chain
          const T g_pos = gw[pos * kWindow + lane];
          const V d = m.eval(cur_rhs);
          // a lane the chain has not passed keeps its newest candidate
          if (lane >= pos) m.keep();
          const unsigned changing = __ballot_sync(
              kFullWarp, lane > pos && lane < nact && nonzero(d));
          V df = shfl(d, pos);
          T gf = g_pos;
          int f = pos;
          if (!nonzero(df)) {
            if (!changing) break;
            f = __ffs(changing) - 1;
            df = shfl(d, f);
            gf = gw[f * kWindow + lane];
          }
          axpy(cur_rhs, df, gf);
          pos = f + 1;
          if (pos >= nact) break;
        }
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          if (r == rr) rhs[rr] = cur_rhs;
        const V dm = m.finish(r);
        const unsigned changed = __ballot_sync(kFullWarp, lane < nact && nonzero(dm));
        ls->d[buf][lane] = dm;
        if (lane == 0) ls->mask[buf] = changed;
      }
      __pipeline_wait_prior(P::kBuffers - 2);   // window n + 1's inputs have landed
      __syncthreads();
      // the window's changes reach the other rows, in ascending j
      const unsigned mask = ls->mask[buf];
      if (mask) {
        if constexpr (kEarly) {
          if (warp != ww && tid < b) add_changes(rhs[0], ls->d[buf], mask, gcol);
        } else {
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const int i = rr * nt + tid;
            if (i < b && !(rr == r && warp == ww)) {
              // half a window's loads at a time from 4 rows a thread
              constexpr int kChunk = R >= 4 ? kWindow / 2 : kWindow;
#pragma unroll
              for (int q0 = 0; q0 < kWindow; q0 += kChunk) {
                T g[kChunk];
                gram_column(g, G + static_cast<size_t>(j0) * b, b, nact, i, q0);
                add_changes(rhs[rr], ls->d[buf], mask, g, q0);
              }
            }
          }
        }
      }
      ++n;
      if (++ww == nwarps) {
        ww = 0;
        ++r;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * nt + tid;
    if (i < b) {
      const size_t base = static_cast<size_t>(k) * NT * b + i;
#pragma unroll
      for (int mm = 0; mm < NT; ++mm) {
        A.rhs[base + mm * b] = rhs[r].v[mm];
        A.alpha[base + mm * b] = m.alpha[r].v[mm];
        A.beta[base + mm * b] = m.beta[r].v[mm];
        A.delta[base + mm * b] = (m.bits[r] >> mm & 1) ? T(1) : T(0);
      }
    }
  }
}

// ------------------------------------------------------- launch

template <class T, int NT, bool kII, bool kPM, int R>
int launch_rows(const Args<T>& A, int threads, int nw, const T* scratch,
                const jt::ChainPlan& p, cudaStream_t stream) {
  using P = Plan<T, NT, kII, kPM>;
  static bool ready[jt::kMaxDevices];
  auto kern = mt_chain<T, NT, kII, kPM, R>;
  if (!(p.dev < jt::kMaxDevices && ready[p.dev])) {
    const int err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(P::smem));
    if (err != 0) return err;
    if (p.dev < jt::kMaxDevices) ready[p.dev] = true;
  }
  kern<<<A.nblocks, threads, P::smem, stream>>>(A, scratch, nw);
  return cudaGetLastError();
}

template <class T, int NT, bool kII, bool kPM>
int launch_t(const Args<T>& A, cudaStream_t stream) {
  using P = Plan<T, NT, kII, kPM>;
  if constexpr (kPM && NT > kMaxPriorTraits) {
    return cudaErrorInvalidValue;
  } else {
  jt::ChainPlan p{};
  int err = cudaGetDevice(&p.dev);
  if (err != 0) return err;
  err = cudaDeviceGetAttribute(&p.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, p.dev);
  if (err != 0) return err;
  if (P::smem > static_cast<size_t>(p.optin)) return cudaErrorInvalidConfiguration;
  const int rounded = (A.b + 31) / 32 * 32;
  const int threads = rounded < kThreads ? rounded : kThreads;
  int rows = 1;
  while (rows * threads < A.b) rows *= 2;
  if (rows > kMaxRows) return cudaErrorInvalidValue;

  const int nw = (A.b + kWindow - 1) / kWindow;
  const size_t lanes = static_cast<size_t>(A.nblocks) * nw * kWindow;
  const size_t prep = kII ? lanes * P::S : lanes;
  const unsigned grid = static_cast<unsigned>((prep + kPrepThreads - 1) / kPrepThreads);
  if constexpr (kII) consts_II<T, NT><<<grid, kPrepThreads, 0, stream>>>(A, A.scratch, nw);
  else consts_I<T, NT><<<grid, kPrepThreads, 0, stream>>>(A, A.scratch, nw);
  err = cudaGetLastError();
  if (err != 0) return err;
  switch (rows) {
    case 1: return launch_rows<T, NT, kII, kPM, 1>(A, threads, nw, A.scratch, p, stream);
    case 2: return launch_rows<T, NT, kII, kPM, 2>(A, threads, nw, A.scratch, p, stream);
    case 4: return launch_rows<T, NT, kII, kPM, 4>(A, threads, nw, A.scratch, p, stream);
    default: return launch_rows<T, NT, kII, kPM, 8>(A, threads, nw, A.scratch, p, stream);
  }
  }
}

template <typename T, bool kII, bool kPM>
int launch(int t, const Args<T>& A, void* stream) {
  if (A.b < 1 || A.nblocks < 1 || A.nreps < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(A.grams) % 16 || reinterpret_cast<uintptr_t>(A.scratch) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 2: return launch_t<T, 2, kII, kPM>(A, st);
    case 3: return launch_t<T, 3, kII, kPM>(A, st);
    case 4: return launch_t<T, 4, kII, kPM>(A, st);
    case 5: return launch_t<T, 5, kII, kPM>(A, st);
    case 6: return launch_t<T, 6, kII, kPM>(A, st);
    case 7: return launch_t<T, 7, kII, kPM>(A, st);
    case 8: return launch_t<T, 8, kII, kPM>(A, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define JT_MT_ENTRY(NAME, T, KII, KPM)                                              \
  extern "C" int NAME(const T* grams, const T* xpx, const T* valid, T* alpha,       \
                      T* beta, T* delta, T* rhs, const T* Rinv, const T* Ginv,      \
                      const T* log_pi, const T* draw_a, const T* zs, T* scratch,   \
                      int t, int b, int nblocks, int nreps, int per_locus,          \
                      void* stream) {                                               \
    return launch<T, KII, KPM>(t, Args<T>{grams, xpx, valid, alpha, beta, delta,   \
                                          rhs, Rinv, Ginv, log_pi, draw_a, zs,     \
                                          scratch, b, nblocks, nreps, per_locus},  \
                               stream);                                            \
  }

#ifndef JT_MT_PER_MARKER_PRIOR
JT_MT_ENTRY(jt_mt_inner_rounds_I, float, false, false)
JT_MT_ENTRY(jt_mt_inner_rounds_I_f64, double, false, false)
JT_MT_ENTRY(jt_mt_inner_rounds_II, float, true, false)
JT_MT_ENTRY(jt_mt_inner_rounds_II_f64, double, true, false)
#else   // mt_inner_rounds_pm.cu: the per-marker prior, t <= kMaxPriorTraits
JT_MT_ENTRY(jt_mt_inner_rounds_I_pm, float, false, true)
JT_MT_ENTRY(jt_mt_inner_rounds_I_pm_f64, double, false, true)
JT_MT_ENTRY(jt_mt_inner_rounds_II_pm, float, true, true)
JT_MT_ENTRY(jt_mt_inner_rounds_II_pm_f64, double, true, true)
#endif
