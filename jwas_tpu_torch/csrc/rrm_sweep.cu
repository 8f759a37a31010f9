// The random-regression marker chain on Hopper (K10).
//
// Replaces the lax.scan of jwas_tpu/ops/rrm.py:67-121 (sweep_rrm_abc, its
// body :82-116), not a Pallas kernel: one strictly sequential pass over the
// p markers. For marker j with genotype row x (nind), Gram mpp (c, c) and
// old coefficients a_old (c):
//   xw = phi' (Wg x) + mpp a_old,  Wg the (ntimes, nind) residual grid;
//   for each label D_l of the 2^c inclusion patterns (BayesC / BayesB; the
//   one label of ones for RR-BLUP / BayesL):
//     lhs_l = (D_l D_l') o mpp / vare + Ginv,  rhs_l = D_l o xw / vare,
//     logp_l = -(logdet lhs_l - rhs_l' lhs_l^-1 rhs_l) / 2 + log pi_l;
//   sel = argmax(logp + gumbel_j) (the first index on a tie, as jnp.argmax),
//   b = lhs_sel^-1 rhs_sel + L_sel'^-1 z_j, a = D_sel o b,
//   Wg += (phi dA) x' o mask,  dA = a_old - a.
// The Gumbel (p, 2^c) and normal (p, c) draws are inputs, drawn by the
// wrapper (ops/rrm.py), so the kernel and the plain version see the same.
//
// Bound on an H100: X read once, p nind items (50,000 x 10,000 float32 =
// 2.0 GB, 0.60 ms at 3.35 TB/s; 1.2 ms in float64). The chain is p
// dependent steps, and each needs a sum over every individual before it
// can pick a label, then changes every individual's cells.
//
// Design: a chunk of b markers against their cross-Grams. Within a chunk,
// marker k's statistic is exact from the grid W0 at the chunk's start:
//   xw_k = phi' (W0 x_k) + sum_{j<k} C_kj dA_j + mpp_k a_old_k,
//   C_kj = sum_i x_ki x_ji sum_t mask_ti phi_t phi_t'  (c x c, symmetric,
//          C_kj = C_jk; ops/rrm.py::build_rrm_cross_grams, once a run),
// so one grid-wide exchange of the chunk's b statistics phi' (W0 X_b')
// replaces b exchanges. A cooperative, persistent kernel: block k owns a
// contiguous slice of the individuals, its columns of the grid in shared
// memory for the whole pass and their observation mask as one 32-bit word
// an individual (ntimes <= 32). A chunk, in order:
//   A. every block applies the previous chunk's dA to its recorded cells
//      (w += phi u, u = dA' x of the individual) and sums its slice's share
//      of the chunk's statistics phi' (W X_b') (c, b), from the chunk's
//      genotype rows in shared memory (staged by cp.async during the
//      previous chunk when the slice fits, else read in tiles of
//      individuals);
//   B. writes its (c, b) partials to a double-buffered scratch and arrives
//      on a monotone counter;
//   D. the one exchange of the chunk: every block sums the blocks' partials
//      in eight groups of blocks (16-byte loads) and then the groups, in
//      the same fixed order, so the sums, and every decision after them,
//      are bit-identical in every block;
//   E. warp 0 runs the chunk's b steps with no global load and no barrier:
//      xw_k from the sums plus acc_k (held by lane k mod 32 and shuffled
//      out), rhs' lhs^-1 rhs and the label's score in each label's lane,
//      the Gumbel-max by redux.sync and a ballot, b by a shuffle; then lane
//      s adds C_sk dA_k to acc_s for the chunk's later markers s. A step's
//      inputs (the label factor, the marker's row, the cross-Grams of the
//      lane's markers) are loaded from shared memory a step ahead. Every
//      block runs the same chain.
//      Meanwhile warps 1-7 make the next chunk's inputs in the other half
//      of a double buffer: its cross-Grams staged by cp.async (packed once
//      a run in the layout of shared memory: the pairs k < s, c(c+1)/2
//      entries each), every marker's label factors
//      (L_l^-1 and the log-determinant of each label, which do not depend
//      on the residual), mpp a_old, the old coefficients, the draws; and
//      the chunk after's genotype rows. Then every block turns the chain's
//      draws into dA, and block 0 writes alpha, beta and delta.
// b is the largest power of two <= 64 whose plan fits shared memory: 64 at
// 10,000 individuals x 10 time points, c = 3, in float32 and 32 in float64
// (jt_rrm_sweep_plan; the cross-Grams are built for it). The rule "the
// exchange spread over a chunk at most a quarter of a step" asks for b =
// 128, beyond shared memory with the chunk's cross-Grams resident. Above
// ~19,000 individuals (float32; ~28,000 in float64) a block's rows of a
// chunk no longer fit beside its grid slice: they are read in tiles of
// individuals, each tile waiting on its loads, and the plan takes fewer,
// larger tiles before a larger b; near the edge b falls to 1. There, at
// 10 time points, c = 3, float32 (bench_k10.py on an H100 80GB HBM3 at
// 700 W): 100,000 individuals 1.06 us a marker at b = 32 in tiles of 256,
// 200,000 1.78, 500,000 5.78 at b = 16 in tiles of 256, against the first
// design's 6.28 at 100,000 and 13.97 at 500,000: the tiles' waits and a
// block's serial partial sums over its slice bound it there.
// What bounds it now, at 10,000 x 10, c = 3, p = 50,000 on an H100 80GB HBM3
// at 700 W (float32, b = 64; chip_smoke.py phase 2's probes): the chain's
// step, 232 ns, then a chunk's exchange and fixed cost, 6.1 us a chunk
// (95 ns a marker; the wait on the counter 1.0 us and the partials' loads
// 1.2 us of it): 16.33 ms a sweep (24.37 ms in float64 at b = 32) against
// 213.1 / 278.7 ms for the first design's one exchange a marker and a byte
// bound of 0.60 / 1.20 ms. No floating-point atomics: two launches on the
// same inputs give the same outputs bit for bit. A counter not reached
// within 10 s traps. The blocks must all be resident: the launch is
// cooperative and refused when they cannot be.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 5;
constexpr int kMaxTimes = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinPerBlock = 64;                 // individuals a block at the least
constexpr int kMaxChunk = 64;                    // b at the most
constexpr int kSlots = kMaxChunk / 32;           // a lane's markers of the chunk
static_assert(kSlots == 2, "the chain picks a lane's slot by k < 32");
constexpr int kPairs = (kMaxC * kMaxChunk + kThreads - 1) / kThreads;   // (a, k) a thread
constexpr int kLoads = 17;                       // partials loaded before they are added
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned long long kWaitNs = 10000000000ull;
// probe bits (jt_rrm_sweep's `probe`; 0 on the main path): skip the chain's
// steps, the wait on the counter, the loads of the blocks' partials, the
// next chunk's inputs made during the chain
constexpr int kNoChain = 1, kNoWait = 2, kNoReduce = 4, kNoPrepare = 8;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(gmem), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ void neg_inf(float& v) { v = __int_as_float(0xff800000); }
__device__ __forceinline__ void neg_inf(double& v) {
  v = __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
}

// entry (a, d) of a symmetric c x c block packed as its upper triangle
template <int C>
__host__ __device__ constexpr int sym(int a, int d) {
  return a <= d ? a * C - a * (a - 1) / 2 + (d - a) : d * C - d * (d - 1) / 2 + (a - d);
}
// entry (i, k), i >= k, of a lower-triangular c x c factor packed by rows
__host__ __device__ constexpr int tri(int i, int k) { return i * (i + 1) / 2 + k; }
// the first pair (k, s > k) of row k of a chunk's upper triangle
__host__ __device__ inline int row_off(int k, int b) { return k * (b - 1) - k * (k - 1) / 2; }

// order-preserving keys: a larger value has a larger key (-0 below +0)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long order_key(double v) {
  const unsigned long long u = static_cast<unsigned long long>(__double_as_longlong(v));
  return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
}
// the lowest lane holding the warp's largest key (0 for an inactive lane)
__device__ __forceinline__ int argmax_lane(unsigned key) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  return __ffs(__ballot_sync(0xffffffffu, key == top)) - 1;
}
__device__ __forceinline__ int argmax_lane(unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned top_hi = __reduce_max_sync(0xffffffffu, hi);
  const bool cand = hi == top_hi;
  const unsigned top_lo = __reduce_max_sync(0xffffffffu, cand ? lo : 0u);
  return __ffs(__ballot_sync(0xffffffffu, cand && lo == top_lo)) - 1;
}

// shared-memory loads of VB bytes (8 or 16) into a register array
template <typename T, int VB> struct Vec;
template <> struct Vec<float, 8> {
  using V = float2;
  static constexpr int n = 2;
  __device__ static void put(V v, float* d) { d[0] = v.x; d[1] = v.y; }
};
template <> struct Vec<float, 16> {
  using V = float4;
  static constexpr int n = 4;
  __device__ static void put(V v, float* d) { d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w; }
};
template <> struct Vec<double, 8> {
  using V = double;
  static constexpr int n = 1;
  __device__ static void put(V v, double* d) { d[0] = v; }
};
template <> struct Vec<double, 16> {
  using V = double2;
  static constexpr int n = 2;
  __device__ static void put(V v, double* d) { d[0] = v.x; d[1] = v.y; }
};
template <int VB, typename T, int N>
__device__ __forceinline__ void lds(T (&d)[N], const T* s) {
  using W = Vec<T, VB>;
  static_assert(N % W::n == 0, "a whole number of vectors");
#pragma unroll
  for (int i = 0; i < N / W::n; ++i)
    W::put(reinterpret_cast<const typename W::V*>(s)[i], d + i * W::n);
}
constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// shared memory of a block, in units of T (each array 16-byte aligned),
// then the mask words: its grid slice (ntimes, slice); two genotype tiles
// (xt individuals, b markers, a row of b + 1); phi' w of a tile (c, xt);
// the eight groups' partial sums (8, c, b); phi dA (ntimes, b); dA (b, c);
// phi (ntimes, c); Ginv (c, c); then twice, for the chunk the chain runs
// and the next one: the cross-Grams (the pairs k < s, CS each: c(c+1)/2
// entries and padding), the label factors (b, labels, FS: L^-1 packed by
// rows, the log-determinant, padding), a marker's sums, old coefficients
// and normals (b, MS) and its Gumbels (b, 2^c)
template <typename T, int C>
struct Smem {
  static constexpr int L = 1 << C, S = C * (C + 1) / 2, A = 16 / sizeof(T);
  static constexpr int FS = round_up(S + 1, 16 / sizeof(T));   // 16-byte loads
  static constexpr int CS = round_up(S, 8 / sizeof(T));         // 8-byte loads
  static constexpr int MS = round_up(3 * C, 16 / sizeof(T));
  static constexpr int kGroups = 8;                             // of blocks, summed apart
  T *wg, *xb, *v, *red, *dA, *so, *phis, *ginv, *ct[2], *fac[2], *mk[2], *gum[2];
  unsigned* mbits;

  // take(n) hands out n elements, 16-byte aligned; sm (or nullptr) keeps them
  template <typename F>
  __host__ __device__ static void layout(int slice, int ntimes, int b, int xt, F&& take,
                                         Smem* sm) {
    T* wg = take(static_cast<size_t>(ntimes) * slice);
    T* xb = take(2 * static_cast<size_t>(xt) * (b + 1));
    T* v = take(static_cast<size_t>(C) * xt);
    T* red = take(static_cast<size_t>(kGroups) * C * b);
    T* dA = take(static_cast<size_t>(b) * C);
    T* so = take(static_cast<size_t>(b) * (C + 1));
    T* phis = take(static_cast<size_t>(ntimes) * C);
    T* ginv = take(C * C);
    if (sm) {
      sm->wg = wg; sm->xb = xb; sm->v = v; sm->red = red; sm->dA = dA;
      sm->so = so; sm->phis = phis; sm->ginv = ginv;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T* ct = take(static_cast<size_t>(b) * (b - 1) / 2 * CS);
      T* fac = take(static_cast<size_t>(b) * L * FS);
      T* mk = take(static_cast<size_t>(b) * MS);
      T* gum = take(static_cast<size_t>(b) * L);
      if (sm) {
        sm->ct[i] = ct; sm->fac[i] = fac; sm->mk[i] = mk; sm->gum[i] = gum;
      }
    }
  }
  __host__ __device__ static size_t bytes(int slice, int ntimes, int b, int xt) {
    size_t n = 0;
    layout(slice, ntimes, b, xt, [&n](size_t k) -> T* {
      n += (k + A - 1) / A * A;
      return nullptr;
    }, nullptr);
    return n * sizeof(T) + static_cast<size_t>(slice) * sizeof(unsigned);
  }
  __device__ void carve(unsigned char* raw, int slice, int ntimes, int b, int xt) {
    T* at = reinterpret_cast<T*>(raw);
    layout(slice, ntimes, b, xt, [&at](size_t k) -> T* {
      T* r = at;
      at += (k + A - 1) / A * A;
      return r;
    }, this);
    mbits = reinterpret_cast<unsigned*>(at);
  }
};

// a double buffer's half, with no indexing by a run-time value (which
// would put the pair in local memory)
template <typename P>
__device__ __forceinline__ P pick(P const (&pair)[2], int buf) { return buf ? pair[1] : pair[0]; }

// genotype rows j0 .. j0 + cnt - 1 of individuals base .. base + m - 1 into
// a tile [individual][marker] (row stride bs), one cp.async an entry, by
// threads t0, t0 + nt, ...
template <typename T>
__device__ __forceinline__ void stage_x(T* dst, const T* X, int j0, int cnt, int nind,
                                        int base, int m, int bs, int t0, int nt) {
  for (int idx = t0; idx < cnt * m; idx += nt) {
    const int k = idx / m, li = idx - k * m;
    cp_async<sizeof(T)>(dst + li * bs + k, X + static_cast<size_t>(j0 + k) * nind + base + li);
  }
}

// the factor of label `label` of a marker with Gram m: L^-1 (packed by rows)
// and the log-determinant of lhs = (D D') o m / vare + Ginv
template <typename T, int C>
__device__ __forceinline__ void label_factor(const T* m, const T* ginv, T vare, int label,
                                             T* out) {
  T A[C][C], Lc[C][C], Li[C][C], logdet = T(0);
#pragma unroll
  for (int a = 0; a < C; ++a)
#pragma unroll
    for (int d = 0; d < C; ++d) {
      const bool in = ((label >> a) & 1) && ((label >> d) & 1);
      A[a][d] = (in ? m[a * C + d] : T(0)) / vare + ginv[a * C + d];
    }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T s = A[c][c];
#pragma unroll
    for (int k = 0; k < c; ++k) s -= Lc[c][k] * Lc[c][k];
    const T d = sqrt_t(s);
    Lc[c][c] = d;
    logdet += T(2) * log_t(abs_t(d));
    const T inv = T(1) / d;
#pragma unroll
    for (int i = c + 1; i < C; ++i) {
      T u = A[i][c];
#pragma unroll
      for (int k = 0; k < c; ++k) u -= Lc[i][k] * Lc[c][k];
      Lc[i][c] = u * inv;
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    Li[i][i] = T(1) / Lc[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) {
      T s = T(0);
#pragma unroll
      for (int m2 = k; m2 < i; ++m2) s += Lc[i][m2] * Li[m2][k];
      Li[i][k] = -s * Li[i][i];
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int k = 0; k <= i; ++k) out[tri(i, k)] = Li[i][k];
  out[C * (C + 1) / 2] = logdet;
}

// chunk q's inputs for its chain into buffer `buf`, by threads t0, t0 + nt,
// ...: the chunk's cross-Grams by cp.async (committed by the caller), each
// marker's mpp a_old, old coefficients and normals, its Gumbels and its
// label factors
template <typename T, int C>
__device__ __forceinline__ void prepare(Smem<T, C>& sm, int buf, int q, int cur, int b, int p,
                                        const T* cg, const T* mpp, const T* alpha_in,
                                        const T* zs, const T* gumbel, T vare, int nlab,
                                        int estimate_delta, int t0, int nt) {
  using Sm = Smem<T, C>;
  constexpr int L = Sm::L;
  const int j0 = q * b;
  {                                  // the chunk's packed cross-Grams, 8 bytes a copy
    constexpr int W8 = 8 / sizeof(T);
    const int words = b * (b - 1) / 2 * Sm::CS / W8;
    const T* src = cg + static_cast<size_t>(q) * b * (b - 1) / 2 * Sm::CS;
    T* dst = pick(sm.ct, buf);
    for (int i = t0; i < words; i += nt) cp_async<8>(dst + i * W8, src + i * W8);
  }
  for (int idx = t0; idx < cur * C; idx += nt) {
    const int k = idx / C, a = idx - k * C, j = j0 + k;
    T* row = pick(sm.mk, buf) + k * Sm::MS;
    const T* mj = mpp + (static_cast<size_t>(j) * C + a) * C;
    T s = T(0);
#pragma unroll
    for (int d = 0; d < C; ++d) s += mj[d] * alpha_in[static_cast<size_t>(d) * p + j];
    row[a] = s;
    row[C + a] = alpha_in[static_cast<size_t>(a) * p + j];
    row[2 * C + a] = zs[static_cast<size_t>(j) * C + a];
  }
  if (estimate_delta)
    for (int idx = t0; idx < cur * L; idx += nt)
      pick(sm.gum, buf)[idx] = gumbel[static_cast<size_t>(j0) * L + idx];
  for (int idx = t0; idx < cur * nlab; idx += nt) {
    const int k = idx / nlab, l = idx - k * nlab;
    T m[C * C];
#pragma unroll
    for (int i = 0; i < C * C; ++i) m[i] = mpp[static_cast<size_t>(j0 + k) * C * C + i];
    label_factor<T, C>(m, sm.ginv, vare, estimate_delta ? l : L - 1,
                       pick(sm.fac, buf) + static_cast<size_t>(idx) * Sm::FS);
  }
}

// step k's inputs from a chunk's buffers: this lane's label factor, the
// marker's row (sums, old coefficients, normals), this lane's Gumbel, and
// the cross-Grams C_sk of the lane's later markers s
template <typename T, int C>
__device__ __forceinline__ void load_step(const T* fac, const T* mkb, const T* gum,
                                          const T* ctb, int k, int li, int nlab, int b,
                                          int cur, int lane, bool gum_on,
                                          T (&f)[Smem<T, C>::FS], T (&mk)[Smem<T, C>::MS],
                                          T& g, T (&cr)[kSlots][Smem<T, C>::CS]) {
  using Sm = Smem<T, C>;
  lds<16>(f, fac + static_cast<size_t>(k * nlab + li) * Sm::FS);
  lds<16>(mk, mkb + k * Sm::MS);
  g = gum_on ? gum[k * Sm::L + lane] : T(0);
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {    // a slot with no pair reads pair 0, unused
    const int s = lane + 32 * sl;
    const int pair = s > k && s < cur ? row_off(k, b) + s - k - 1 : 0;
    lds<8>(cr[sl], ctb + static_cast<size_t>(pair) * Sm::CS);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
rrm_sweep_kernel(const T* __restrict__ X, const T* __restrict__ phi,
                 const T* __restrict__ mpp, const T* __restrict__ cg,
                 const T* __restrict__ mask, const T* __restrict__ alpha_in,
                 const T* __restrict__ W_in, const T* __restrict__ vare_p,
                 const T* __restrict__ Ginv_g, const T* __restrict__ log_pi,
                 const T* __restrict__ gumbel, const T* __restrict__ zs,
                 T* __restrict__ alpha_out, T* __restrict__ beta_out,
                 T* __restrict__ delta_out, T* __restrict__ W_out, T* partial,
                 unsigned* counter, int p, int nind, int ntimes, int slice, int b, int xt,
                 int estimate_delta, int probe) {
  using Sm = Smem<T, C>;
  constexpr int L = Sm::L, S = Sm::S, G = Sm::kGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm sm;
  sm.carve(smem_raw, slice, ntimes, b, xt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int base = blk * slice, n = min(slice, nind - base);
  const int nlab = estimate_delta ? L : 1, bs = b + 1, nq = (p + b - 1) / b;
  const bool resident = xt >= n;      // the slice's genotype rows of a chunk fit a tile
  const size_t tile = static_cast<size_t>(xt) * bs;
  const T vare = *vare_p, inv_vare = T(1) / vare;

  // the block's grid columns, mask words, phi, Ginv; chunk 0's rows and inputs
  for (int idx = tid; idx < ntimes * n; idx += kThreads) {
    const int t = idx / n, li = idx - t * n;
    sm.wg[static_cast<size_t>(t) * slice + li] = W_in[static_cast<size_t>(t) * nind + base + li];
  }
  for (int li = tid; li < n; li += kThreads) {
    unsigned bits = 0u;
    for (int t = 0; t < ntimes; ++t)
      if (mask[static_cast<size_t>(t) * nind + base + li] != T(0)) bits |= 1u << t;
    sm.mbits[li] = bits;
  }
  for (int i = tid; i < ntimes * C; i += kThreads) sm.phis[i] = phi[i];
  for (int i = tid; i < C * C; i += kThreads) sm.ginv[i] = Ginv_g[i];
  if (resident) stage_x(sm.xb, X, 0, min(b, p), nind, base, n, bs, tid, kThreads);
  __syncthreads();                     // Ginv, for the factors
  prepare<T, C>(sm, 0, 0, min(b, p), b, p, cg, mpp, alpha_in, zs, gumbel, vare, nlab,
                estimate_delta, tid, kThreads);
  cp_async_commit();

  for (int q = 0; q <= nq; ++q) {      // q == nq: the last chunk's update alone
    const int cur = q < nq ? min(b, p - q * b) : 0;
    const int prev = q > 0 ? min(b, p - (q - 1) * b) : 0;
    const int buf = q & 1;
    cp_async_wait_all();               // chunk q's rows and cross-Grams, staged a chunk ahead
    __syncthreads();

    // A. the previous chunk's dA into the cells, then this chunk's sums
    T part[kPairs];
#pragma unroll
    for (int r = 0; r < kPairs; ++r) part[r] = T(0);
    for (int i0 = 0; i0 < n; i0 += xt) {
      const int m = min(xt, n - i0);
      const T* xprev = resident ? sm.xb + ((q - 1) & 1) * tile : sm.xb;
      const T* xcur = resident ? sm.xb + (q & 1) * tile : sm.xb + tile;
      if (!resident) {
        if (prev) stage_x(sm.xb, X, (q - 1) * b, prev, nind, base + i0, m, bs, tid, kThreads);
        if (cur) stage_x(sm.xb + tile, X, q * b, cur, nind, base + i0, m, bs, tid, kThreads);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      if (prev) {                      // u = dA' x of each individual (c, m)
        for (int idx = tid; idx < C * m; idx += kThreads) {
          const int a = idx / m, li = idx - a * m;
          const T* xr = xprev + li * bs;
          T s = T(0);
          for (int j = 0; j < prev; ++j) s += sm.dA[j * C + a] * xr[j];
          sm.v[a * xt + li] = s;
        }
        __syncthreads();
      }
      // an individual a thread: its recorded cells take phi u, then v = phi' w
      for (int li = tid; li < m; li += kThreads) {
        T u[C], acc_v[C];
#pragma unroll
        for (int a = 0; a < C; ++a) {
          u[a] = prev ? sm.v[a * xt + li] : T(0);
          acc_v[a] = T(0);
        }
        const unsigned bits = prev ? sm.mbits[i0 + li] : 0u;
        for (int t = 0; t < ntimes; ++t) {
          T* cell = sm.wg + static_cast<size_t>(t) * slice + i0 + li;
          T w = *cell;
          if ((bits >> t) & 1u) {
            T d = T(0);
#pragma unroll
            for (int a = 0; a < C; ++a) d += sm.phis[t * C + a] * u[a];
            w += d;
            *cell = w;
          }
#pragma unroll
          for (int a = 0; a < C; ++a) acc_v[a] += sm.phis[t * C + a] * w;
        }
        if (cur)
#pragma unroll
          for (int a = 0; a < C; ++a) sm.v[a * xt + li] = acc_v[a];
      }
      __syncthreads();
      if (cur) {
#pragma unroll
        for (int r = 0; r < kPairs; ++r) {
          const int pr = tid + r * kThreads;
          if (pr < C * cur) {
            const int a = pr / cur, k = pr - a * cur;
            const T* va = sm.v + a * xt;
            T s = part[r];
            for (int li = 0; li < m; ++li) s += va[li] * xcur[li * bs + k];
            part[r] = s;
          }
        }
        __syncthreads();
      }
    }
    if (q == nq) break;

    // B. the block's partials, then its arrival
    {
      T* slot = partial + (static_cast<size_t>(q & 1) * nb + blk) * C * b;
#pragma unroll
      for (int r = 0; r < kPairs; ++r) {
        const int pr = tid + r * kThreads;
        if (pr < C * cur) {
          const int a = pr / cur, k = pr - a * cur;
          __stcg(slot + a * b + k, part[r]);
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicAdd(counter, 1u);
    }

    // D. the one exchange of the chunk: every block's partials are in; G
    // groups of blocks summed apart (V sums a 16-byte load where b allows),
    // then the groups in order
    if (tid == 0 && !(probe & kNoWait)) {
      const unsigned target = static_cast<unsigned>(nb) * static_cast<unsigned>(q + 1);
      if (ld_acquire(counter) < target) {
        const unsigned long long t0 = now_ns();
        while (ld_acquire(counter) < target)
          if (now_ns() - t0 > kWaitNs) __trap();
      }
      __threadfence();
    }
    __syncthreads();
    {
      const T* pq = partial + static_cast<size_t>(q & 1) * nb * C * b;
      const int np = C * cur, per = (nb + G - 1) / G;
      using Vw = Vec<T, 16>;
      constexpr int V = Vw::n;
      if (b % V == 0) {                // 16-byte loads of V neighbouring sums
        const int nvk = (cur + V - 1) / V, nv = C * nvk;
        for (int item = tid; item < G * nv; item += kThreads) {
          const int g = item / nv, iv = item - g * nv;
          const int a = iv / nvk, k0 = (iv - a * nvk) * V;
          const int lo = g * per, hi = min(nb, lo + per);
          const typename Vw::V* src = reinterpret_cast<const typename Vw::V*>(pq + a * b + k0);
          const size_t stride = static_cast<size_t>(C) * b / V;
          T acc_s[V];
#pragma unroll
          for (int e = 0; e < V; ++e) acc_s[e] = T(0);
          if (!(probe & kNoReduce))
            for (int b0 = lo; b0 < hi; b0 += kLoads) {
              T v[kLoads][V];
#pragma unroll
              for (int u = 0; u < kLoads; ++u) {
                if (b0 + u < hi) {
                  Vw::put(__ldcg(src + (b0 + u) * stride), v[u]);
                } else {
#pragma unroll
                  for (int e = 0; e < V; ++e) v[u][e] = T(0);
                }
              }
#pragma unroll
              for (int u = 0; u < kLoads; ++u)
#pragma unroll
                for (int e = 0; e < V; ++e) acc_s[e] += v[u][e];
            }
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (k0 + e < cur) sm.red[g * np + a * cur + k0 + e] = acc_s[e];
        }
      } else {
        for (int item = tid; item < G * np; item += kThreads) {
          const int g = item / np, pr = item - g * np;
          const int a = pr / cur, k = pr - a * cur;
          const int lo = g * per, hi = min(nb, lo + per);
          const T* src = pq + a * b + k;
          T acc_s = T(0);
          if (!(probe & kNoReduce))
            for (int b0 = lo; b0 < hi; b0 += kLoads) {
              T v[kLoads];
#pragma unroll
              for (int u = 0; u < kLoads; ++u)
                v[u] = b0 + u < hi ? __ldcg(src + static_cast<size_t>(b0 + u) * C * b) : T(0);
#pragma unroll
              for (int u = 0; u < kLoads; ++u) acc_s += v[u];
            }
          sm.red[g * np + pr] = acc_s;
        }
      }
      __syncthreads();
      for (int pr = tid; pr < np; pr += kThreads) {
        const int a = pr / cur, k = pr - a * cur;
        T s = sm.red[pr];
#pragma unroll
        for (int g = 1; g < G; ++g) s += sm.red[g * np + pr];
        pick(sm.mk, buf)[k * Sm::MS + a] += s;    // R + mpp a_old
      }
    }
    __syncthreads();

    // E. warp 0: the chunk's chain; warps 1 .. 7: the next chunk's inputs
    if (warp == 0) {
      if (!(probe & kNoChain)) {
        const T* fac = pick(sm.fac, buf);
        const T* mkb = pick(sm.mk, buf);
        const T* gum = pick(sm.gum, buf);
        const T* ctb = pick(sm.ct, buf);
        const int label = estimate_delta ? lane : L - 1;
        const bool active = estimate_delta ? lane < L : lane == 0;
        const int li = active && estimate_delta ? lane : 0;
        const bool gum_on = estimate_delta && active;
        const T lpi = active ? log_pi[label] : T(0);
        T dm[C];                                  // D_l o (.) / vare
#pragma unroll
        for (int kk = 0; kk < C; ++kk) dm[kk] = ((label >> kk) & 1) ? inv_vare : T(0);
        T acc[kSlots][C];
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl)
#pragma unroll
          for (int a = 0; a < C; ++a) acc[sl][a] = T(0);
        // step k on inputs (f, mk, g, cr), loading step k + 1's into (fn, mn, gn, cn)
        auto step = [&](int k, const auto& f, const auto& mk, T g, const auto& cr, auto& fn,
                        auto& mn, T& gn, auto& cn) {
          T xw[C];
#pragma unroll
          for (int a = 0; a < C; ++a) {
            const T mine = k < 32 ? acc[0][a] : acc[1][a];
            xw[a] = mk[a] + __shfl_sync(0xffffffffu, mine, k & 31);
          }
          load_step<T, C>(fac, mkb, gum, ctb, min(k + 1, cur - 1), li, nlab, b, cur, lane,
                          gum_on, fn, mn, gn, cn);
          T y[C], yy = T(0);
#pragma unroll
          for (int i = 0; i < C; ++i) {
            T s = T(0);
#pragma unroll
            for (int kk = 0; kk <= i; ++kk) s += f[tri(i, kk)] * (xw[kk] * dm[kk]);
            y[i] = s;
            yy += s * s;
          }
          T bl[C];
#pragma unroll
          for (int kk = 0; kk < C; ++kk) {
            T s = T(0);
#pragma unroll
            for (int i = kk; i < C; ++i) s += f[tri(i, kk)] * (y[i] + mk[2 * C + i]);
            bl[kk] = s;
          }
          int sel = 0;
          if (estimate_delta) {
            const T val = T(-0.5) * (f[S] - yy) + lpi + g;
            sel = argmax_lane(active ? order_key(val) : decltype(order_key(val))(0));
          }
          const int lab = estimate_delta ? sel : L - 1;
          T bk[C], da[C];
#pragma unroll
          for (int kk = 0; kk < C; ++kk) {
            bk[kk] = __shfl_sync(0xffffffffu, bl[kk], sel);
            da[kk] = mk[C + kk] - (((lab >> kk) & 1) ? T(1) : T(0)) * bk[kk];
          }
          // the chunk's later markers: acc_s += C_sk dA_k (a slot whose marker
          // is done or beyond the chunk takes a value it never reads)
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl)
#pragma unroll
            for (int a = 0; a < C; ++a) {
              T u = acc[sl][a];
#pragma unroll
              for (int d = 0; d < C; ++d) u += cr[sl][sym<C>(a, d)] * da[d];
              acc[sl][a] = u;
            }
          if (lane == 0) {
#pragma unroll
            for (int kk = 0; kk < C; ++kk) sm.so[k * (C + 1) + kk] = bk[kk];
            sm.so[k * (C + 1) + C] = static_cast<T>(lab);
          }
        };
        T f0[Sm::FS], m0[Sm::MS], g0 = T(0), c0[kSlots][Sm::CS];
        T f1[Sm::FS], m1[Sm::MS], g1 = T(0), c1[kSlots][Sm::CS];
        load_step<T, C>(fac, mkb, gum, ctb, 0, li, nlab, b, cur, lane, gum_on, f0, m0, g0, c0);
        for (int k = 0; k < cur; k += 2) {
          step(k, f0, m0, g0, c0, f1, m1, g1, c1);
          if (k + 1 < cur) step(k + 1, f1, m1, g1, c1, f0, m0, g0, c0);
        }
      }
    } else if (q + 1 < nq && !(probe & kNoPrepare)) {
      const int nxt = min(b, p - (q + 1) * b);
      prepare<T, C>(sm, buf ^ 1, q + 1, nxt, b, p, cg, mpp, alpha_in, zs, gumbel, vare, nlab,
                    estimate_delta, tid - 32, kThreads - 32);
      if (resident)
        stage_x(sm.xb + ((q + 1) & 1) * tile, X, (q + 1) * b, nxt, nind, base, n, bs, tid - 32,
                kThreads - 32);
      cp_async_commit();
    }
    __syncthreads();
    // the chain's draws: alpha, beta and delta (block 0), and dA
    {
      const T* mkb = pick(sm.mk, buf);
      for (int idx = tid; idx < C * cur; idx += kThreads) {
        const int a = idx / cur, k = idx - a * cur;
        const T bk = sm.so[k * (C + 1) + a];
        const int lab = static_cast<int>(sm.so[k * (C + 1) + C]);
        const T d = ((lab >> a) & 1) ? T(1) : T(0);
        const T a_new = d * bk;
        sm.dA[k * C + a] = (probe & kNoChain) ? T(0) : mkb[k * Sm::MS + C + a] - a_new;
        if (blk == 0) {
          const size_t o = static_cast<size_t>(a) * p + q * b + k;
          alpha_out[o] = a_new;
          beta_out[o] = bk;
          delta_out[o] = d;
        }
      }
    }
  }

  for (int idx = tid; idx < ntimes * n; idx += kThreads) {
    const int t = idx / n, li = idx - t * n;
    W_out[static_cast<size_t>(t) * nind + base + li] = sm.wg[static_cast<size_t>(t) * slice + li];
  }
}

struct Plan {
  int ctas = 0, slice = 0, b = 0, xt = 0;
};

// the plan of a sweep over nind individuals: a block a slice of them (one
// a multiprocessor, 64 individuals at the least), the largest chunk b <=
// max_b (a power of two, max_b <= 64) whose shared memory fits, the
// slice's genotype rows of a chunk in one tile where they fit (else tiles
// of 256 .. 32 individuals); ctas = 0 when nothing fits. First only b >=
// 8 with the rows in one tile, in tiles of >= 128 or in at most kSmallTiles
// smaller ones: each tile waits on its loads, and more tiles of 32 or 64
// cost more than a smaller b (on an H100, 10 time points, c = 3: 500,000
// individuals at b = 32 in tiles of 32 9.7 us a marker, at b = 16 in
// tiles of 256 5.8; 200,000 at b = 64 in tiles of 32 2.7, at b = 32 in
// tiles of 256 1.8; bench_k10.py); then any b at any tile.
constexpr int kSmallTiles = 4;
template <typename T, int C>
cudaError_t plan(int nind, int ntimes, int max_b, Plan* pl) {
  auto kernel = rrm_sweep_kernel<T, C>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int nb = (nind + kMinPerBlock - 1) / kMinPerBlock;
  if (nb > sms) nb = sms;
  *pl = Plan();
  for (int tries = 0; tries < 8 && nb > 0; ++tries) {
    const int s = (nind + nb - 1) / nb;
    const int used = (nind + s - 1) / s;
    int b = 0, xt = 0;
    size_t bytes = 0;
    for (int pass = 0; pass < 2 && b == 0; ++pass) {
      for (int bb = max_b; bb >= (pass ? 1 : (max_b < 8 ? max_b : 8)) && b == 0; bb /= 2) {
        const int tiles[] = {s, 256, 128, 64, 32};
        for (int i = 0; i < 5; ++i) {
          const int t = tiles[i];
          if (i > 0 && (t >= s || (pass == 0 && t < 128 && s > kSmallTiles * t))) continue;
          const size_t need = Smem<T, C>::bytes(s, ntimes, bb, t);
          if (need <= kMaxSmem) {
            b = bb;
            xt = t;
            bytes = need;
            break;
          }
        }
      }
    }
    if (b == 0) return cudaSuccess;                       // ctas = 0: does not fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (used <= per_sm * sms) {
      pl->ctas = used;
      pl->slice = s;
      pl->b = b;
      pl->xt = xt;
      return cudaSuccess;
    }
    nb = per_sm * sms;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_c(int c, int nind, int ntimes, int max_b, Plan* pl) {
  switch (c) {
    case 1: return plan<T, 1>(nind, ntimes, max_b, pl);
    case 2: return plan<T, 2>(nind, ntimes, max_b, pl);
    case 3: return plan<T, 3>(nind, ntimes, max_b, pl);
    case 4: return plan<T, 4>(nind, ntimes, max_b, pl);
    case 5: return plan<T, 5>(nind, ntimes, max_b, pl);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int C>
int launch_c(const T* X, const T* phi, const T* mpp, const T* cg, const T* mask,
             const T* alpha_in, const T* W_in, const T* vare, const T* Ginv, const T* log_pi,
             const T* gumbel, const T* zs, T* alpha_out, T* beta_out, T* delta_out, T* W_out,
             T* partial, unsigned* counter, int p, int nind, int ntimes, int estimate_delta,
             int ctas, int slice, int b, int xt, int probe, void* stream) {
  // the caller's plan (jt_rrm_sweep_plan): whole, within shared memory
  if (b < 1 || b > kMaxChunk || (b & (b - 1)) || ctas < 1 || slice < 1 || xt < 1 ||
      static_cast<long long>(ctas - 1) * slice >= nind ||
      static_cast<long long>(ctas) * slice < nind)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Smem<T, C>::bytes(slice, ntimes, b, xt);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rrm_sweep_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&X, &phi, &mpp, &cg, &mask, &alpha_in, &W_in, &vare, &Ginv, &log_pi,
                  &gumbel, &zs, &alpha_out, &beta_out, &delta_out, &W_out, &partial,
                  &counter, &p, &nind, &ntimes, &slice, &b, &xt, &estimate_delta, &probe};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* X, const T* phi, const T* mpp, const T* cg, const T* mask,
           const T* alpha_in, const T* W_in, const T* vare, const T* Ginv, const T* log_pi,
           const T* gumbel, const T* zs, T* alpha_out, T* beta_out, T* delta_out, T* W_out,
           T* partial, unsigned* counter, int p, int nind, int ntimes, int c,
           int estimate_delta, int ctas, int slice, int b, int xt, int probe, void* stream) {
  if (p <= 0 || nind <= 0 || ntimes <= 0 || ntimes > kMaxTimes)
    return static_cast<int>(cudaErrorInvalidValue);
#define JT_K10_LAUNCH(CC)                                                                      \
  return launch_c<T, CC>(X, phi, mpp, cg, mask, alpha_in, W_in, vare, Ginv, log_pi, gumbel, zs, \
                         alpha_out, beta_out, delta_out, W_out, partial, counter, p, nind,     \
                         ntimes, estimate_delta, ctas, slice, b, xt, probe, stream)
  switch (c) {
    case 1: JT_K10_LAUNCH(1);
    case 2: JT_K10_LAUNCH(2);
    case 3: JT_K10_LAUNCH(3);
    case 4: JT_K10_LAUNCH(4);
    case 5: JT_K10_LAUNCH(5);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef JT_K10_LAUNCH
}

}  // namespace

// The plan of a sweep over nind individuals at ntimes time points with c
// coefficients on the current device (itemsize 4 or 8: the build), its
// chunk b at most max_b (a power of two <= 64), into out: the blocks, the
// individuals a block (its slice), b and the tile of individuals whose
// genotype rows of a chunk a block holds at once (the slice itself where
// they fit, else 256 .. 32: read in tiles, once for the update and once
// for the sums); blocks 0 when a block's slice does not fit its shared
// memory beside a chunk of one marker with its rows in tiles of 32 (on an
// H100 at ntimes = 10 and c = 3: above 691,680 individuals in float32 and
// 359,436 in float64, chip_smoke.py phase 2). Returns a cudaError. The
// cross-Grams are built for its b (ops/rrm.py::build_rrm_cross_grams) and
// the wrapper sizes the partials' scratch, (2, blocks, c, b), from it.
extern "C" int jt_rrm_sweep_plan(int nind, int ntimes, int c, int itemsize, int max_b,
                                 int* out) {
  if (nind <= 0 || ntimes <= 0 || ntimes > kMaxTimes || c < 1 || c > kMaxC || max_b < 1 ||
      max_b > kMaxChunk || (max_b & (max_b - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const cudaError_t err = itemsize == 8 ? plan_c<double>(c, nind, ntimes, max_b, &pl)
                                        : plan_c<float>(c, nind, ntimes, max_b, &pl);
  out[0] = pl.ctas;
  out[1] = pl.slice;
  out[2] = pl.b;
  out[3] = pl.xt;
  return static_cast<int>(err);
}

// X (p, nind), phi (ntimes, c), mpp (p, c, c), cg the cross-Grams packed
// (ops/rrm.py::pack_cross_grams: ceil(p / b) chunks of b(b - 1)/2 pairs k <
// s in row order, each its c(c+1)/2 entries a <= d and zeros to whole
// 8-byte words), mask (ntimes, nind), alpha_in (c, p), W_in (ntimes,
// nind), vare (1,), Ginv (c, c), log_pi (2^c,), gumbel (p, 2^c; unread
// without estimate_delta), zs (p, c); alpha_out, beta_out, delta_out (c, p)
// and W_out (ntimes, nind) written; partial (2 ctas c b) and a zeroed
// counter are scratch; ctas, slice, b and xt a plan of jt_rrm_sweep_plan
// (checked whole and within shared memory); probe 0 (a probe's bits skip
// parts of a chunk and leave the outputs undefined)
extern "C" int jt_rrm_sweep(const float* X, const float* phi, const float* mpp,
                            const float* cg, const float* mask, const float* alpha_in,
                            const float* W_in, const float* vare, const float* Ginv,
                            const float* log_pi, const float* gumbel, const float* zs,
                            float* alpha_out, float* beta_out, float* delta_out, float* W_out,
                            float* partial, unsigned* counter, int p, int nind, int ntimes,
                            int c, int estimate_delta, int ctas, int slice, int b, int xt,
                            int probe, void* stream) {
  return launch<float>(X, phi, mpp, cg, mask, alpha_in, W_in, vare, Ginv, log_pi, gumbel, zs,
                       alpha_out, beta_out, delta_out, W_out, partial, counter, p, nind, ntimes,
                       c, estimate_delta, ctas, slice, b, xt, probe, stream);
}

extern "C" int jt_rrm_sweep_f64(const double* X, const double* phi, const double* mpp,
                                const double* cg, const double* mask, const double* alpha_in,
                                const double* W_in, const double* vare, const double* Ginv,
                                const double* log_pi, const double* gumbel, const double* zs,
                                double* alpha_out, double* beta_out, double* delta_out,
                                double* W_out, double* partial, unsigned* counter, int p,
                                int nind, int ntimes, int c, int estimate_delta, int ctas,
                                int slice, int b, int xt, int probe, void* stream) {
  return launch<double>(X, phi, mpp, cg, mask, alpha_in, W_in, vare, Ginv, log_pi, gumbel, zs,
                        alpha_out, beta_out, delta_out, W_out, partial, counter, p, nind,
                        ntimes, c, estimate_delta, ctas, slice, b, xt, probe, stream);
}
