// Single-site Gibbs pass over the dense location LHS on Hopper (K6).
//
// Replaces the lax.scan of jwas_tpu/ops/location.py:18-37
// (gibbs_pass_lambda), not a Pallas kernel: for i = 0..K-1 in order,
//   x_i ~ N((b_i - A[i, :] x) / A_ii + x_i, vare / A_ii),
// skipping rows with a zero diagonal. A is the (K, K) LHS
// W'R^-1W + sum over the random-effect groups of G^-1 (x) Vinv vare, kept
// exactly symmetric by its assembly (ops/location.py::assemble_lhs_lambda),
// so A[i, j] = A[j, i] bit for bit and a row read with unit stride serves
// for a column. The K standard normals zs come from the chain's generator,
// drawn by the wrapper, so the kernel and the plain version see the same
// draws.
//
// Bound on an H100: K^2 elements read once (19,902^2 float32 = 1.58 GB,
// 0.47 ms at 3.35 TB/s; 0.95 ms in float64), and K dependent steps.
//
// Design: a wavefront over the SMs. The rows (and columns) are cut into P
// slices of S = 160; block p owns slice p: its S entries of x and its row
// panel A[slice p, :]. By symmetry the panel holds every product the other
// slices need from x_p: for slice q, A[slice q, slice p] x_p is
// x_p' A[slice p, slice q], a sum over the panel's rows with the columns of
// slice q spread over the threads (coalesced, no reductions across lanes).
// Block p, in order:
//   1. from its old x_p, the products for every earlier slice q < p, each
//      written to its own slot partial[p, slice q] and published by a flag;
//   2. the S dependent steps of its slice: the diagonal block's upper
//      triangle in shared memory, times the old x_p, plus the other
//      slices' partials summed in a fixed order, each group as soon as it
//      has arrived (the last, slice p - 1's, in the stepping warp), then
//      one warp runs the forward substitution: a step is the owner lane's
//      scalar update, a shuffle broadcast of x_i and one FMA a lane per
//      later row, no block barrier. Beside it five warps fold each
//      finished chunk of 32 rows into the next slice's product, its rows
//      prefetched into L2, so the hand-off after the last step is one
//      chunk of FMAs, a store and a flag;
//   3. from its new x_p, the products for the slices after the next.
// The critical path is P x (S steps + one chunk + a hand-off); the K^2
// bytes are read once, spread over P <= 128 SMs, ahead of need: on an
// H100 at K = 19,902, 1.0 ms a pass in float32 (51 ns a parameter; the
// bound is 0.47 ms) and 1.6 ms in float64 (chip_smoke.py). Every sum
// has a fixed order and no floating-point atomics are used, so two launches
// on the same inputs give the same x bit for bit. Hand-offs are integer
// flags (flags[producer * P + consumer], zeroed by the wrapper each launch)
// stored after a GPU-scope fence (a release) and read with acquire
// semantics (ld.acquire, or relaxed loads and then a fence); all
// P blocks must be resident at once, so the launch is cooperative and is
// refused (not hung) when they cannot be. A flag not seen within 10 s
// traps. The scalar update uses the _rn intrinsics (no FMA contraction), so
// it rounds as the plain version does; only the order of the sums in the
// dot products differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 20480;
constexpr int kSlice = 160;              // S: P = ceil(K / S) <= 128 blocks
constexpr unsigned long long kWaitNs = 10000000000ull;
// the partials of the last kWindow - 1 earlier slices arrive just before
// a block's turn; a block sums them after all the others, as they come
constexpr int kWindow = 12;
// one block an SM: more dynamic shared memory than two blocks can share
constexpr size_t kMinSmem = 120 * 1024;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// after __threadfence(), a relaxed store is a release
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// named barriers: whole warps, `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// spin until *f is set; acquire: loads after it see the producer's writes
__device__ __forceinline__ void wait_acquire(const unsigned* f) {
  if (ld_acquire(f)) return;
  const unsigned long long t0 = now_ns();
  while (!ld_acquire(f))
    if (now_ns() - t0 > kWaitNs) __trap();
}
__device__ __forceinline__ void wait_relaxed(const unsigned* f) {
  if (ld_relaxed(f)) return;
  const unsigned long long t0 = now_ns();
  while (!ld_relaxed(f))
    if (now_ns() - t0 > kWaitNs) __trap();
}

// row k of the diagonal block's upper triangle (columns k..S-1) starts here
template <int S>
__host__ __device__ constexpr int tri_off(int k) { return k * S - k * (k - 1) / 2; }

template <int S, int R>
constexpr size_t smem_bytes(size_t item) {
  return (static_cast<size_t>(S) * (S + 1) / 2 + 2 * S + R * S) * item;
}

// partial[p, slice r] = x_p' A[slice p, slice r] (xs: x_p in shared memory),
// then flag (p -> r). Thread (g, j) sums the panel's rows k = g (mod R) of
// column j; the R sums are added in order g = 0..R-1. All threads call it.
template <typename T, int S, int R>
__device__ __forceinline__ void publish(const T* __restrict__ panel, const T* xs, T* red,
                                        T* partial, unsigned* flags, int K, int n, int p,
                                        int r, int tid) {
  const int c0 = r * S, w = min(S, K - c0), g = tid / S, j = tid - g * S;
  T acc = T(0);
  if (j < w) {
    const T* col = panel + c0 + j;
#pragma unroll 20
    for (int k = g; k < n; k += R) acc = fma_t(__ldg(col + static_cast<size_t>(k) * K), xs[k], acc);
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < w) {
    T s = red[tid];
#pragma unroll
    for (int gg = 1; gg < R; ++gg) s += red[gg * S + tid];
    __stcg(partial + static_cast<size_t>(p) * K + c0 + tid, s);
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    st_relaxed(flags + p * gridDim.x + r, 1u);
  }
}

// The forward substitution over the slice's n rows, in one warp: lane owns
// rows 32 v + lane, with their sums c, right-hand sides bb, old values xo,
// 1 / A_jj (inv, 0 for a zero diagonal) and noise nz. Step i: every lane
// computes its row's update, lane i % 32's is broadcast, and the later
// rows add A[i, j] x_i. A chunk of 32 rows done, its new values go to xs
// and the chunk warps are told (named barriers 2..). The loop over a
// chunk's steps is unrolled 16 times, not 32: fully unrolled, the steps'
// code outgrew the instruction cache, and the blocks that ran it cold took
// a few times as long for their slice as the others; 4 and 8 ran slower.
template <typename T, int S>
__device__ __forceinline__ void steps(T (&c)[S / 32], const T (&bb)[S / 32], const T (&xo)[S / 32],
                                      const T (&inv)[S / 32], const T (&nz)[S / 32],
                                      const T* tri, T* xs, int n, int lane, bool has_next) {
  constexpr int SLOTS = S / 32;
  // x's new value for lane's row of slot v: ((b - c) / A_jj + x) + noise as
  // the plain version rounds it; a zero diagonal keeps x
#define JT_K6_UPDATE(v)                                                              \
  (inv[v] != T(0) ? add_rn(add_rn(mul_rn(inv[v], sub_rn(bb[v], c[v])), xo[v]), nz[v]) \
                  : xo[v])
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    const int steps_u = min(32, n - 32 * u);
#pragma unroll 16
    for (int l = 0; l < steps_u; ++l) {
      const int i = 32 * u + l;
      const T xn = __shfl_sync(0xffffffffu, JT_K6_UPDATE(u), l);
      const T* row = tri + tri_off<S>(i) - i;   // row[j] = A[i, j], j >= i
      if (lane > l) c[u] = fma_t(row[32 * u + lane], xn, c[u]);
#pragma unroll
      for (int v = u + 1; v < SLOTS; ++v) c[v] = fma_t(row[32 * v + lane], xn, c[v]);
    }
    // the chunk's rows are final: their sums no longer change
    if (32 * u + lane < n) xs[32 * u + lane] = JT_K6_UPDATE(u);
    if (has_next) bar_arrive(2 + u, 32 + S);
  }
#undef JT_K6_UPDATE
}

template <typename T, int S, int R>
__global__ void __launch_bounds__(R * S, 1)
gibbs_wavefront_kernel(const T* __restrict__ A, const T* __restrict__ x_in,
                       const T* __restrict__ b, const T* __restrict__ zs,
                       const T* __restrict__ vare_p, T* __restrict__ x_out, T* partial,
                       unsigned* flags, int K) {
  constexpr int NT = R * S, SLOTS = S / 32, TRI = S * (S + 1) / 2;
  static_assert(S % 32 == 0 && R >= 2, "a slice is whole warps; R >= 2 for the chunk warps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tri = reinterpret_cast<T*>(smem_raw);   // the diagonal block's upper triangle
  T* xs = tri + TRI;                          // x_p: old, then new
  T* cs = xs + S;                             // the rows' sums before the last partial
  T* red = cs + S;                            // publish's R partial sums
  const int P = gridDim.x, p = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int r0 = p * S, n = min(S, K - r0);
  const bool has_next = p + 1 < P;            // then n == S
  const T* __restrict__ panel = A + static_cast<size_t>(r0) * K;

  for (int j = tid; j < S; j += NT) xs[j] = j < n ? x_in[r0 + j] : T(0);
  for (int k = tid >> 5; k < S; k += NT / 32) {
    T* dst = tri + tri_off<S>(k) - k;
    for (int j = k + lane; j < S; j += 32)
      dst[j] = (k < n && j < n) ? __ldg(panel + static_cast<size_t>(k) * K + r0 + j) : T(0);
  }
  __syncthreads();

  // 1. the earlier slices' products from the old x_p, first needed first
  for (int q = 0; q < p; ++q) publish<T, S, R>(panel, xs, red, partial, flags, K, n, p, q, tid);

  // 2. this slice's steps. The stepping warp's rows: right-hand sides, old
  // values, 1 / A_jj and noise, read while the sums are made
  T c[SLOTS], bb[SLOTS], xo[SLOTS], inv[SLOTS], nz[SLOTS];
  if (tid < 32) {
    const T vare = *vare_p;
#pragma unroll
    for (int v = 0; v < SLOTS; ++v) {
      const int j = 32 * v + lane;
      xo[v] = xs[j];
      bb[v] = inv[v] = nz[v] = T(0);
      if (j < n) {
        const T a = tri[tri_off<S>(j)];
        bb[v] = b[r0 + j];
        if (a != T(0)) {
          inv[v] = div_rn(T(1), a);
          nz[v] = mul_rn(zs[r0 + j], sqrt_rn(mul_rn(inv[v], vare)));
        }
      }
    }
  }
  // Row j's sum with x: the diagonal block's upper triangle times the old
  // x_p (the diagonal term included), then the other slices' partials in a
  // fixed order, each group once it has arrived: the early ones, the later
  // slices' and those more than kWindow back (thread (g, j) sums q = g
  // mod R ascending, the R sums added in order g); then slices
  // p - kWindow + 1 .. p - 3 ascending, loaded together; slice p - 2's;
  // and, in the stepping warp, slice p - 1's.
  {
    const int g = tid / S, j = tid - g * S;
    T acc = T(0);
    if (g == 0 && j < n) {
      const T* row = tri + tri_off<S>(j) - j;
      for (int k = j; k < n; ++k) acc = fma_t(row[k], xs[k], acc);
    }
    for (int q = tid; q < P; q += NT)
      if (q > p || q + kWindow <= p) wait_relaxed(flags + q * P + p);
    __threadfence();
    __syncthreads();
    const T* col = partial + r0 + j;
    if (j < n) {
      T part = T(0);
#pragma unroll 16
      for (int q = g; q < P; q += R)
        if (q > p || q + kWindow <= p) part += __ldcg(col + static_cast<size_t>(q) * K);
      red[tid] = part;
    }
    const int q0 = max(p - kWindow + 1, 0);
    if (tid < 32)
      for (int q = q0 + lane; q + 3 <= p; q += 32) wait_relaxed(flags + q * P + p);
    __threadfence();
    __syncthreads();
    if (tid < S) {
      if (j < n) {
#pragma unroll
        for (int gg = 0; gg < R; ++gg) acc += red[gg * S + j];
        T win[kWindow];
#pragma unroll
        for (int w = 0; w < kWindow; ++w)
          win[w] = q0 + w + 3 <= p ? __ldcg(col + static_cast<size_t>(q0 + w) * K) : T(0);
#pragma unroll
        for (int w = 0; w < kWindow; ++w)
          if (q0 + w + 3 <= p) acc += win[w];
        if (p >= 2) {
          wait_acquire(flags + (p - 2) * P + p);
          acc += __ldcg(col + static_cast<size_t>(p - 2) * K);
        }
      }
      cs[tid] = acc;
      bar_sync(1, S);
    }
  }
  if (tid < 32) {
#pragma unroll
    for (int v = 0; v < SLOTS; ++v) c[v] = cs[32 * v + lane];
    if (p > 0) {                 // the previous slice's partial, on the critical path
      wait_acquire(flags + (p - 1) * P + p);
#pragma unroll
      for (int v = 0; v < SLOTS; ++v)
        if (32 * v + lane < n)
          c[v] += __ldcg(partial + static_cast<size_t>(p - 1) * K + r0 + 32 * v + lane);
    }
    steps<T, S>(c, bb, xo, inv, nz, tri, xs, n, lane, has_next);
  } else if (has_next && tid >= S && tid < 2 * S) {
    // the next slice's product, a chunk of 32 rows at a time as they finish;
    // its rows and those of the slice after it (phase 3's first product)
    // brought into L2 first, so that their loads are short when x_p is final
    const int j = tid - S, c0 = r0 + S, w = min(S, K - c0);
    for (int c = c0; c < min(c0 + 2 * S, K); c += S) {
      const char* seg = reinterpret_cast<const char*>(panel + static_cast<size_t>(j) * K + c);
      const int bytes = min(S, K - c) * static_cast<int>(sizeof(T));
      for (int off = 0; off < bytes; off += 128) prefetch_l2(seg + off);
      prefetch_l2(seg + bytes - 1);
    }
    T y = T(0);
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      T a[32];
      const T* src = panel + static_cast<size_t>(32 * u) * K + c0 + j;
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) a[kk] = j < w ? __ldg(src + kk * K) : T(0);
      bar_sync(2 + u, 32 + S);
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) y = fma_t(a[kk], xs[32 * u + kk], y);
    }
    if (j < w) __stcg(partial + static_cast<size_t>(p) * K + c0 + j, y);
    bar_sync(2 + SLOTS, S);
    if (j == 0) {
      __threadfence();
      st_relaxed(flags + p * P + p + 1, 1u);
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += NT) x_out[r0 + j] = xs[j];

  // 3. the later slices' products from the new x_p
  for (int r = p + 2; r < P; ++r) publish<T, S, R>(panel, xs, red, partial, flags, K, n, p, r, tid);
}

template <typename T, int R>
int launch(const T* A, const T* x_in, const T* b, const T* zs, const T* vare, T* x_out,
           T* partial, unsigned* flags, int K, void* stream) {
  if (K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gibbs_wavefront_kernel<T, kSlice, R>;
  size_t smem = smem_bytes<kSlice, R>(sizeof(T));
  if (smem < kMinSmem) smem = kMinSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = (K + kSlice - 1) / kSlice;
  void* args[] = {&A, &x_in, &b, &zs, &vare, &x_out, &partial, &flags, &K};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(P),
                                    dim3(R * kSlice), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jt_gibbs_pass_max_k() { return kMaxK; }

namespace {
template <typename T>
int device_max_k() {
  auto kernel = gibbs_wavefront_kernel<T, kSlice, 2>;
  size_t smem = smem_bytes<kSlice, 2>(sizeof(T));
  if (smem < kMinSmem) smem = kMinSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 2 * kSlice, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long k = static_cast<long long>(kSlice) * sms * per_sm;
  return k < kMaxK ? static_cast<int>(k) : kMaxK;
}
}  // namespace

// The largest K a cooperative launch takes on the current device: kMaxK,
// or fewer when fewer than ceil(kMaxK / S) blocks can be resident at once;
// itemsize 4 or 8 (the build); < 0: -cudaError.
extern "C" int jt_gibbs_pass_device_max_k(int itemsize) {
  return itemsize == 8 ? device_max_k<double>() : device_max_k<float>();
}
extern "C" int jt_gibbs_pass_slice() { return kSlice; }

// partial: (P, K) of the element type, flags: P * P zeroed unsigned ints,
// P = ceil(K / jt_gibbs_pass_slice()); both scratch, allocated by the caller
extern "C" int jt_gibbs_pass(const float* A, const float* x_in, const float* b,
                             const float* zs, const float* vare, float* x_out,
                             float* partial, unsigned* flags, int K, void* stream) {
  return launch<float, 2>(A, x_in, b, zs, vare, x_out, partial, flags, K, stream);
}

extern "C" int jt_gibbs_pass_f64(const double* A, const double* x_in, const double* b,
                                 const double* zs, const double* vare, double* x_out,
                                 double* partial, unsigned* flags, int K, void* stream) {
  return launch<double, 2>(A, x_in, b, zs, vare, x_out, partial, flags, K, stream);
}
