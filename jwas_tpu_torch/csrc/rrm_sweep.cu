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
//   Wg += (phi (a_old - a)) x' o mask.
// The Gumbel (p, 2^c) and normal (p, c) draws are inputs, drawn by the
// wrapper (ops/rrm.py), so the kernel and the plain version see the same.
//
// Bound on an H100: X read once, p nind items (50,000 x 10,000 float32 =
// 2.0 GB, 0.60 ms at 3.35 TB/s; 1.2 ms in float64). The chain is p
// dependent steps, and every step needs a sum over all individuals before
// it can pick a label, then changes every individual's cells: the whole
// grid is exchanged once a step.
//
// Design: a cooperative, persistent kernel. Block k owns a contiguous
// slice of the individuals: its columns of the grid in shared memory for
// the whole pass, their observation mask as one 32-bit word an individual
// (ntimes <= 32), and its slice of the genotype rows, staged by cp.async
// two markers ahead in a ring of three. A step, in order:
//   1. while thread 0 waits, the label warp (warp 1), one lane a label,
//      factors lhs_l for the marker: its Cholesky L_l, L_l^-1 and
//      log-determinant, which do not depend on the residual; the marker's
//      inputs (Gram, old coefficients, draws) were loaded a step ahead;
//   2. the grid-wide exchange: one thread a block waits until every block
//      has added its arrival for the marker to a monotone counter;
//   3. every block sums the blocks' partials of Wg x (a (ntimes, blocks)
//      slot of a double-buffered scratch) in the same fixed order, so the
//      sums, and every decision after them, are bit-identical in every
//      block;
//   4. the label warp: y_l = L_l^-1 rhs_l, so rhs' lhs^-1 rhs = |y_l|^2, the
//      Gumbel-max over the lanes by shuffles, b = L_sel'^-1 (y_sel + z);
//      lanes t < ntimes form (phi (a_old - a))_t; block 0 writes the
//      marker's alpha, beta and delta;
//   5. every block updates its cells and, in the same pass, sums its slice
//      of the next marker's Wg x into the other scratch slot (a warp a time
//      point: lanes over the slice, a shuffle tree), then arrives.
// One grid-wide exchange a marker and no floating-point atomics: two
// launches on the same inputs give the same outputs bit for bit. The
// exchange bounds a step: at 10,000 individuals x 10 time points, c = 3,
// p = 50,000, 209.9 ms a sweep in float32 (4.2 us a step) and 274.4 ms in
// float64 on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2), over
// two orders of magnitude above the byte bound: a chunk of markers against
// their cross-Grams (as K1 does) is the redesign that would cut it. A
// counter not reached within 10 s traps. The blocks must all be resident:
// the launch is cooperative and refused when they cannot be.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 5;
constexpr int kMaxTimes = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinPerBlock = 64;         // individuals a block at the least
constexpr int kRing = 3;                 // genotype rows staged: j, j+1, j+2
constexpr int kLabelWarp = 1;            // factors and draws; thread 0 waits
constexpr int kRowsPerWarp = kMaxTimes / kWarps;
constexpr int kLoadsPerLane = 5;         // a lane's partials: blocks <= 160
constexpr int kMaxBlocks = 32 * kLoadsPerLane;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned long long kWaitNs = 10000000000ull;

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
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;   // the same value in every lane: each level adds a pair both ways
}

// shared memory of a block: its grid slice, the ring of genotype rows, phi,
// the step's sums and grid change, then the mask words
template <typename T>
__host__ __device__ size_t smem_bytes(int slice, int ntimes, int c) {
  return (static_cast<size_t>(ntimes) * slice + static_cast<size_t>(kRing) * slice +
          static_cast<size_t>(ntimes) * c + 2 * kMaxTimes) * sizeof(T) +
         static_cast<size_t>(slice) * sizeof(unsigned);
}

// stage genotype row j's slice into ring slot `slot` (every thread its
// entries), one commit group a thread
template <typename T>
__device__ __forceinline__ void stage_row(T* ring, const T* X, int j, int p, int nind, int base,
                                          int n, int slice, int tid) {
  if (j < p) {
    T* dst = ring + static_cast<size_t>(j % kRing) * slice;
    const T* src = X + static_cast<size_t>(j) * nind + base;
    for (int li = tid; li < n; li += kThreads) cp_async<sizeof(T)>(dst + li, src + li);
  }
  cp_async_commit();
}

// marker j's Gram, old coefficients, normals and (with the labels drawn)
// this lane's Gumbel, into registers
template <typename T, int C>
__device__ __forceinline__ void load_marker(const T* mpp, const T* alpha_in, const T* zs,
                                            const T* gumbel, int j, int p, int L, int label,
                                            bool with_gumbel, T (&m)[C * C], T (&a)[C],
                                            T (&z)[C], T& g) {
  const T* mj = mpp + static_cast<size_t>(j) * C * C;
#pragma unroll
  for (int i = 0; i < C * C; ++i) m[i] = __ldg(mj + i);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    a[k] = __ldg(alpha_in + static_cast<size_t>(k) * p + j);
    z[k] = __ldg(zs + static_cast<size_t>(j) * C + k);
  }
  g = with_gumbel ? __ldg(gumbel + static_cast<size_t>(j) * L + label) : T(0);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
rrm_sweep_kernel(const T* __restrict__ X, const T* __restrict__ phi,
                 const T* __restrict__ mpp, const T* __restrict__ mask,
                 const T* __restrict__ alpha_in, const T* __restrict__ W_in,
                 const T* __restrict__ vare_p, const T* __restrict__ Ginv_g,
                 const T* __restrict__ log_pi, const T* __restrict__ gumbel,
                 const T* __restrict__ zs, T* __restrict__ alpha_out,
                 T* __restrict__ beta_out, T* __restrict__ delta_out, T* __restrict__ W_out,
                 T* partial, unsigned* counter, int p, int nind, int ntimes, int slice,
                 int estimate_delta) {
  constexpr int L = 1 << C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wg = reinterpret_cast<T*>(smem_raw);                 // (ntimes, slice)
  T* ring = wg + static_cast<size_t>(ntimes) * slice;     // (kRing, slice)
  T* phis = ring + static_cast<size_t>(kRing) * slice;     // (ntimes, C)
  T* xwf = phis + ntimes * C;                              // (kMaxTimes,) Wg x
  T* dphi = xwf + kMaxTimes;                               // (kMaxTimes,) grid change
  unsigned* mbits = reinterpret_cast<unsigned*>(dphi + kMaxTimes);   // (slice,)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int base = blk * slice, n = min(slice, nind - base);

  // the block's grid columns, mask words, phi and the first genotype rows
  for (int idx = tid; idx < ntimes * n; idx += kThreads) {
    const int t = idx / n, li = idx - t * n;
    wg[static_cast<size_t>(t) * slice + li] = W_in[static_cast<size_t>(t) * nind + base + li];
  }
  for (int li = tid; li < n; li += kThreads) {
    unsigned bits = 0u;
    for (int t = 0; t < ntimes; ++t)
      if (mask[static_cast<size_t>(t) * nind + base + li] != T(0)) bits |= 1u << t;
    mbits[li] = bits;
  }
  for (int i = tid; i < ntimes * C; i += kThreads) phis[i] = phi[i];
  stage_row(ring, X, 0, p, nind, base, n, slice, tid);
  stage_row(ring, X, 1, p, nind, base, n, slice, tid);
  asm volatile("cp.async.wait_group 1;" ::: "memory");    // row 0 is in
  __syncthreads();

  // marker 0's partial sums of Wg x, then the block's arrival
  for (int t = warp; t < ntimes; t += kWarps) {
    T acc = T(0);
    for (int li = lane; li < n; li += 32) acc += wg[static_cast<size_t>(t) * slice + li] * ring[li];
    acc = warp_sum(acc);
    if (lane == 0) __stcg(partial + static_cast<size_t>(t) * nb + blk, acc);
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }

  // the label warp's constants for the whole pass, and marker 0's inputs
  const T vare = *vare_p;
  T Ginv[C][C];
#pragma unroll
  for (int a = 0; a < C; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) Ginv[a][b] = Ginv_g[a * C + b];
  const int label = estimate_delta ? lane : L - 1;     // this lane's label
  const bool active = estimate_delta ? lane < L : lane == 0;
  const T lpi = active ? log_pi[label] : T(0);
  T nx_m[C * C], nx_a[C], nx_z[C], nx_g = T(0);       // the next marker's inputs
  if (warp == kLabelWarp)
    load_marker<T, C>(mpp, alpha_in, zs, gumbel, 0, p, L, label, active && estimate_delta,
                      nx_m, nx_a, nx_z, nx_g);

  for (int j = 0; j < p; ++j) {
    stage_row(ring, X, j + 2, p, nind, base, n, slice, tid);
    const T* xcur = ring + static_cast<size_t>(j % kRing) * slice;
    const T* xnext = ring + static_cast<size_t>((j + 1) % kRing) * slice;

    // 1. the label warp: the marker's label factors (independent of the
    // residual), while thread 0 waits; the next marker's inputs are loaded
    // a step ahead
    T Li[C][C], logdet = T(0), a_old[C], mpa[C], gum = T(0), z[C];
    if (warp == kLabelWarp) {
      T m[C * C], A[C][C], Lc[C][C];
#pragma unroll
      for (int i = 0; i < C * C; ++i) m[i] = nx_m[i];
#pragma unroll
      for (int a = 0; a < C; ++a) {
        a_old[a] = nx_a[a];
        z[a] = nx_z[a];
      }
      gum = nx_g;
      if (j + 1 < p)
        load_marker<T, C>(mpp, alpha_in, zs, gumbel, j + 1, p, L, label,
                          active && estimate_delta, nx_m, nx_a, nx_z, nx_g);
#pragma unroll
      for (int a = 0; a < C; ++a) {
        T s = T(0);
#pragma unroll
        for (int b = 0; b < C; ++b) {
          const T mab = m[a * C + b];
          s += mab * a_old[b];
          const bool in = ((label >> a) & 1) && ((label >> b) & 1);
          A[a][b] = (in ? mab : T(0)) / vare + Ginv[a][b];
        }
        mpa[a] = s;
      }
      // Cholesky, its log-determinant and the inverse of the factor
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
#pragma unroll
        for (int k = 0; k < C; ++k) Li[i][k] = T(0);
        Li[i][i] = T(1) / Lc[i][i];
#pragma unroll
        for (int k = 0; k < i; ++k) {
          T s = T(0);
#pragma unroll
          for (int m2 = k; m2 < i; ++m2) s += Lc[i][m2] * Li[m2][k];
          Li[i][k] = -s * Li[i][i];
        }
      }
    }

    // 2. the exchange: every block's partials of marker j are in
    if (tid == 0) {
      const unsigned target = static_cast<unsigned>(nb) * static_cast<unsigned>(j + 1);
      if (ld_acquire(counter) < target) {
        const unsigned long long t0 = now_ns();
        while (ld_acquire(counter) < target)
          if (now_ns() - t0 > kWaitNs) __trap();
      }
      __threadfence();
    }
    __syncthreads();

    // 3. the sums over the blocks, in one fixed order in every block: a
    // warp's rows (t = warp + 8 r) and a lane's blocks (b = lane + 32 k),
    // every load issued before the first add
    const T* part = partial + static_cast<size_t>(j & 1) * ntimes * nb;
    {
      T v[kRowsPerWarp][kLoadsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int t = warp + r * kWarps;
#pragma unroll
        for (int k = 0; k < kLoadsPerLane; ++k) {
          const int b = lane + 32 * k;
          v[r][k] = (t < ntimes && b < nb) ? __ldcg(part + static_cast<size_t>(t) * nb + b)
                                           : T(0);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int t = warp + r * kWarps;
        if (t < ntimes) {
          T s = v[r][0];
#pragma unroll
          for (int k = 1; k < kLoadsPerLane; ++k) s += v[r][k];
          s = warp_sum(s);
          if (lane == 0) xwf[t] = s;
        }
      }
    }
    __syncthreads();

    // 4. the label warp: the label, the draw and the grid's change
    if (warp == kLabelWarp) {
      T xw[C];
#pragma unroll
      for (int a = 0; a < C; ++a) xw[a] = mpa[a];
      for (int t = 0; t < ntimes; ++t) {
        const T v = xwf[t];
#pragma unroll
        for (int a = 0; a < C; ++a) xw[a] += phis[t * C + a] * v;
      }
      T y[C], yy = T(0);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k <= i; ++k) s += Li[i][k] * (((label >> k) & 1) ? xw[k] / vare : T(0));
        y[i] = s;
        yy += s * s;
      }
      T val;
      if (active)
        val = T(-0.5) * (logdet - yy) + lpi + gum;
      else
        neg_inf(val);
      int idx = active ? lane : 32;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_xor_sync(0xffffffffu, val, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ov > val || (ov == val && oi < idx)) {
          val = ov;
          idx = oi;
        }
      }
      const int sel = __shfl_sync(0xffffffffu, idx, 0);
      T b[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        T s = T(0);
#pragma unroll
        for (int i = k; i < C; ++i) s += Li[i][k] * (y[i] + z[i]);
        b[k] = __shfl_sync(0xffffffffu, s, sel);
      }
      const int lab = __shfl_sync(0xffffffffu, label, sel);
      T da[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const T d = ((lab >> k) & 1) ? T(1) : T(0);
        const T a_new = d * b[k];
        da[k] = a_old[k] - a_new;
        if (blk == 0 && lane == k) {
          alpha_out[static_cast<size_t>(k) * p + j] = a_new;
          beta_out[static_cast<size_t>(k) * p + j] = b[k];
          delta_out[static_cast<size_t>(k) * p + j] = d;
        }
      }
      if (lane < ntimes) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < C; ++k) s += phis[lane * C + k] * da[k];
        dphi[lane] = s;
      }
    }
    cp_async_wait_1();                 // row j + 1 is in (this thread's part)
    __syncthreads();

    // 5. the grid's update and, with it, the next marker's partial sums
    const bool more = j + 1 < p;
    T* part_next = partial + static_cast<size_t>((j + 1) & 1) * ntimes * nb;
    for (int t = warp; t < ntimes; t += kWarps) {
      const T dt = dphi[t];
      T* row = wg + static_cast<size_t>(t) * slice;
      T acc = T(0);
      for (int li = lane; li < n; li += 32) {
        T w = row[li];
        if ((mbits[li] >> t) & 1u) {
          w += dt * xcur[li];
          row[li] = w;
        }
        acc += w * xnext[li];
      }
      if (more) {
        acc = warp_sum(acc);
        if (lane == 0) __stcg(part_next + static_cast<size_t>(t) * nb + blk, acc);
      }
    }
    __syncthreads();
    if (more && tid == 0) {
      __threadfence();
      atomicAdd(counter, 1u);
    }
  }

  for (int idx = tid; idx < ntimes * n; idx += kThreads) {
    const int t = idx / n, li = idx - t * n;
    W_out[static_cast<size_t>(t) * nind + base + li] = wg[static_cast<size_t>(t) * slice + li];
  }
}

template <typename T, int C>
cudaError_t plan(int nind, int ntimes, int* ctas, int* slice, size_t* smem) {
  auto kernel = rrm_sweep_kernel<T, C>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int nb = (nind + kMinPerBlock - 1) / kMinPerBlock;
  if (nb > sms) nb = sms;
  if (nb > kMaxBlocks) nb = kMaxBlocks;
  *ctas = 0;
  for (int tries = 0; tries < 8 && nb > 0; ++tries) {
    const int s = (nind + nb - 1) / nb;
    const int used = (nind + s - 1) / s;
    const size_t bytes = smem_bytes<T>(s, ntimes, C);
    if (bytes > kMaxSmem) return cudaSuccess;            // *ctas = 0: does not fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (used <= per_sm * sms) {
      *ctas = used;
      *slice = s;
      *smem = bytes;
      return cudaSuccess;
    }
    nb = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_c(int c, int nind, int ntimes, int* ctas, int* slice, size_t* smem) {
  switch (c) {
    case 1: return plan<T, 1>(nind, ntimes, ctas, slice, smem);
    case 2: return plan<T, 2>(nind, ntimes, ctas, slice, smem);
    case 3: return plan<T, 3>(nind, ntimes, ctas, slice, smem);
    case 4: return plan<T, 4>(nind, ntimes, ctas, slice, smem);
    case 5: return plan<T, 5>(nind, ntimes, ctas, slice, smem);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int C>
int launch_c(const T* X, const T* phi, const T* mpp, const T* mask, const T* alpha_in,
             const T* W_in, const T* vare, const T* Ginv, const T* log_pi, const T* gumbel,
             const T* zs, T* alpha_out, T* beta_out, T* delta_out, T* W_out, T* partial,
             unsigned* counter, int p, int nind, int ntimes, int estimate_delta, int ctas,
             void* stream) {
  int nb = 0, slice = 0;
  size_t smem = 0;
  cudaError_t err = plan<T, C>(nind, ntimes, &nb, &slice, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 0 || nb != ctas) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rrm_sweep_kernel<T, C>;
  void* args[] = {&X, &phi, &mpp, &mask, &alpha_in, &W_in, &vare, &Ginv, &log_pi,
                  &gumbel, &zs, &alpha_out, &beta_out, &delta_out, &W_out, &partial,
                  &counter, &p, &nind, &ntimes, &slice, &estimate_delta};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(nb),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* X, const T* phi, const T* mpp, const T* mask, const T* alpha_in,
           const T* W_in, const T* vare, const T* Ginv, const T* log_pi, const T* gumbel,
           const T* zs, T* alpha_out, T* beta_out, T* delta_out, T* W_out, T* partial,
           unsigned* counter, int p, int nind, int ntimes, int c, int estimate_delta, int ctas,
           void* stream) {
  if (p <= 0 || nind <= 0 || ntimes <= 0 || ntimes > kMaxTimes)
    return static_cast<int>(cudaErrorInvalidValue);
#define JT_K10_LAUNCH(CC)                                                                    \
  return launch_c<T, CC>(X, phi, mpp, mask, alpha_in, W_in, vare, Ginv, log_pi, gumbel, zs, \
                         alpha_out, beta_out, delta_out, W_out, partial, counter, p, nind,   \
                         ntimes, estimate_delta, ctas, stream)
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

// The blocks of a sweep over nind individuals at ntimes time points with c
// coefficients on the current device (itemsize 4 or 8: the build); 0 when
// a block's slice does not fit its shared memory; < 0: -cudaError. The
// wrapper sizes the partials' scratch, (2, ntimes, blocks), from it.
extern "C" int jt_rrm_sweep_ctas(int nind, int ntimes, int c, int itemsize) {
  if (nind <= 0 || ntimes <= 0 || ntimes > kMaxTimes || c < 1 || c > kMaxC)
    return -static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0, slice = 0;
  size_t smem = 0;
  const cudaError_t err = itemsize == 8 ? plan_c<double>(c, nind, ntimes, &ctas, &slice, &smem)
                                        : plan_c<float>(c, nind, ntimes, &ctas, &slice, &smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return ctas;
}

// X (p, nind), phi (ntimes, c), mpp (p, c, c), mask (ntimes, nind),
// alpha_in (c, p), W_in (ntimes, nind), vare (1,), Ginv (c, c), log_pi
// (2^c,), gumbel (p, 2^c; unread without estimate_delta), zs (p, c);
// alpha_out, beta_out, delta_out (c, p) and W_out (ntimes, nind) written;
// partial (2 ntimes ctas) and a zeroed counter are scratch, ctas from
// jt_rrm_sweep_ctas
extern "C" int jt_rrm_sweep(const float* X, const float* phi, const float* mpp,
                            const float* mask, const float* alpha_in, const float* W_in,
                            const float* vare, const float* Ginv, const float* log_pi,
                            const float* gumbel, const float* zs, float* alpha_out,
                            float* beta_out, float* delta_out, float* W_out, float* partial,
                            unsigned* counter, int p, int nind, int ntimes, int c,
                            int estimate_delta, int ctas, void* stream) {
  return launch<float>(X, phi, mpp, mask, alpha_in, W_in, vare, Ginv, log_pi, gumbel, zs,
                       alpha_out, beta_out, delta_out, W_out, partial, counter, p, nind, ntimes,
                       c, estimate_delta, ctas, stream);
}

extern "C" int jt_rrm_sweep_f64(const double* X, const double* phi, const double* mpp,
                                const double* mask, const double* alpha_in,
                                const double* W_in, const double* vare, const double* Ginv,
                                const double* log_pi, const double* gumbel, const double* zs,
                                double* alpha_out, double* beta_out, double* delta_out,
                                double* W_out, double* partial, unsigned* counter, int p,
                                int nind, int ntimes, int c, int estimate_delta, int ctas,
                                void* stream) {
  return launch<double>(X, phi, mpp, mask, alpha_in, W_in, vare, Ginv, log_pi, gumbel, zs,
                        alpha_out, beta_out, delta_out, W_out, partial, counter, p, nind,
                        ntimes, c, estimate_delta, ctas, stream);
}
