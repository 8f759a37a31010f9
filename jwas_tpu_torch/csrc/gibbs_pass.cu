// Single-site Gibbs pass over the dense location LHS on Hopper (K6).
//
// Replaces the lax.scan of jwas_tpu/ops/location.py:18-37
// (gibbs_pass_lambda), not a Pallas kernel: for i = 0..K-1 in order,
//   x_i ~ N((b_i - A[i, :] x) / A_ii + x_i, vare / A_ii),
// skipping rows with a zero diagonal. A is the (K, K) LHS
// W'R^-1W + sum over the random-effect groups of G^-1 (x) Vinv vare, kept
// exactly symmetric by its assembly (ops/location.py::assemble_lhs_lambda),
// so row i, read here with unit stride, equals the column A[:, i] that the
// JAX package and the plain version read. The K standard normals zs come
// from the chain's generator, drawn by the wrapper, so the kernel and the
// plain version see the same draws.
//
// Bound on an H100: K^2 elements read once (19,902^2 float32 = 1.58 GB,
// 0.47 ms at 3.35 TB/s; 0.95 ms in float64), and K dependent steps, each a
// dot product of length K reduced across a block and a scalar update that
// the next step reads. The steps cannot overlap, so the pass is bound by
// K times the latency of one step unless a step's row can be read faster
// than the card's memory latency allows.
//
// Design, simple first: one thread block runs the whole pass. x lives in
// shared memory (K * sizeof(T): 80 KB float32, 160 KB float64 at
// K = 20,000, dynamic shared memory above 48 KB). Thread t owns the
// columns j = t + u * THREADS; the row's elements it needs sit in
// registers, PER of them, loaded one step ahead: the loads of row i + 1
// are issued right after row i's products, so they are in flight during
// row i's reduction, barrier and update (a row does not depend on x).
// Only the owner of column i (thread i % THREADS) reads x_i in the next
// step's product, so the update needs no barrier of its own: a step is one
// warp-shuffle reduction, one __syncthreads over double-buffered warp sums
// and, in the owner's warp, a second shuffle reduction and the update.
// The scalar update uses the _rn intrinsics (no FMA contraction), so it
// rounds as the plain version does; the products are summed in another
// order than the plain version's dot (per-thread FMA chains, then the
// shuffle trees).
//
// Later work: the pass uses one SM. Splitting a row's product over the SMs
// of a cluster, or a blocked pass that updates a tile of rows together
// from one read of its panel, would bring it nearer its byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32: 1024 threads x 20 columns; float64: 512 x 40 (80 registers of
// row a thread: some spill, yet it measured faster than 640 x 32, 1024 x
// 20 or 256 x 80 without spills, and than 4 accumulators a thread). Both
// take K <= 20,480.
constexpr int kMaxK = 20480;

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int THREADS, int PER>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int K, int tid,
                                         T (&r)[PER]) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = tid + u * THREADS;
    r[u] = j < K ? __ldg(row + j) : T(0);
  }
}

template <typename T, int THREADS, int PER>
__global__ void __launch_bounds__(THREADS, 1)
gibbs_pass_kernel(const T* __restrict__ A, const T* __restrict__ x_in,
                  const T* __restrict__ b, const T* __restrict__ zs,
                  const T* __restrict__ vare_p, T* __restrict__ x_out, int K) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ T warp_sums[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < K; j += THREADS) xs[j] = x_in[j];
  const T vare = *vare_p;
  T r[PER];
  load_row<T, THREADS, PER>(A, K, tid, r);
  // the next step's diagonal, right-hand side and draw, held by its owner
  T a_next = T(0), b_next = T(0), z_next = T(0);
  if (tid == 0) {
    a_next = A[0];
    b_next = b[0];
    z_next = zs[0];
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    T acc = T(0);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int j = tid + u * THREADS;
      if (j < K) acc = fma_t(r[u], xs[j], acc);
    }
    const T a_ii = a_next, b_i = b_next, z_i = z_next;
    if (i + 1 < K) {
      const size_t next = static_cast<size_t>(i + 1) * K;
      load_row<T, THREADS, PER>(A + next, K, tid, r);
      if (tid == (i + 1) % THREADS) {
        a_next = A[next + i + 1];
        b_next = b[i + 1];
        z_next = zs[i + 1];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[i & 1][warp] = acc;
    __syncthreads();
    const int owner = i % THREADS;
    if (warp == owner / 32) {
      T s = lane < kWarps ? warp_sums[i & 1][lane] : T(0);
      s = warp_sum(s);
      if (lane == owner % 32 && a_ii != T(0)) {
        const T inv = div_rn(T(1), a_ii);
        const T mu = add_rn(mul_rn(inv, sub_rn(b_i, s)), xs[i]);
        xs[i] = add_rn(mu, mul_rn(z_i, sqrt_rn(mul_rn(inv, vare))));
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < K; j += THREADS) x_out[j] = xs[j];
}

template <typename T, int THREADS, int PER>
int launch(const T* A, const T* x_in, const T* b, const T* zs, const T* vare,
           T* x_out, int K, void* stream) {
  static_assert(THREADS * PER == kMaxK, "both builds take the same K");
  if (K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gibbs_pass_kernel<T, THREADS, PER>;
  const size_t smem = static_cast<size_t>(K) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      A, x_in, b, zs, vare, x_out, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jt_gibbs_pass_max_k() { return kMaxK; }

extern "C" int jt_gibbs_pass(const float* A, const float* x_in, const float* b,
                             const float* zs, const float* vare, float* x_out,
                             int K, void* stream) {
  return launch<float, 1024, 20>(A, x_in, b, zs, vare, x_out, K, stream);
}

extern "C" int jt_gibbs_pass_f64(const double* A, const double* x_in,
                                 const double* b, const double* zs,
                                 const double* vare, double* x_out, int K,
                                 void* stream) {
  return launch<double, 512, 40>(A, x_in, b, zs, vare, x_out, K, stream);
}
