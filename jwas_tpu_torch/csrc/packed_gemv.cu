// Table-driven GEMVs over the 2-bit packed genotype store on Hopper.
//
// Replaces the Pallas kernels jwas_tpu/ops/pallas_packed_gemv.py::_rhs_kernel
// (:55, X'w) and ::_matvec_kernel (:105, Xv), and on the grouped path the
// XLA plane GEMVs of jwas_tpu/ops/grouped.py:298-334 (_plane_rhs,
// _plane_matvec), which are the GEMVs the main path runs.
//
// A byte holds the 2-bit codes of observations 4i..4i+3 (low bits first);
// code 3 is missing and reads as the marker mean m_k. The centred value is
// x = (c == 3 ? m_k : c) - m_k, so
//   X'w:  out_k = sum_n (c == 3 ? m_k : c) w_n - m_k sum_n w_n
//   X v:  out_n = sum_k (c == 3 ? m_k : c) v_k - m'v
// The observation vector w enters in store order padded to 4 * bpm (the
// caller scatters it through row_perm); Xv returns store order, and the
// caller gathers it back. sum w and m'v come as 1-element device arrays.
//
// Bound on an H100: the packed bytes, read once. One 16,384-marker group at
// n = 50,000 is 204.8 MB, 0.061 ms at 3.35 TB/s. In that time the card
// can start about 2.5 thread instructions a code (132 SMs x 4 schedulers x 32
// lanes x 1.98 GHz over 8.19e8 codes). A decode code by code (shift, mask,
// compare with 3, select, convert, FMA: 6-7 instructions a code, plus four
// float4 loads of w a word in X'w) therefore cannot come below 0.16 ms, and
// took 0.37-0.47 ms. Both kernels below let a few packed bits index a small
// table that already holds the product with the vector, so that one lookup
// and one add serve several codes.
//
// X'w (packed_rhs_table_kernel). For byte position i every row meets the
// same four weights w[4i..4i+3], so T_i[beta] = sum_s [beta_s < 3] beta_s
// w[4i+s] over the 256 byte values holds a byte's whole contribution, and
// M_i[beta] = sum_s [beta_s == 3] w[4i+s] the weight its missing codes give
// to m_k. A CTA owns a slab of C byte positions and a range of rows: it
// builds its tables once in shared memory (C = 128 without missing codes, a
// 128 KB table; C = 64 with T and M, 64 KB each) and walks its rows with no
// loads of w at all. A lane holds one 32-bit word of a row, byte positions
// 4l..4l+3 of the slab; position i is stored at column (i % 4) * (C / 4) +
// i / 4 of row beta, so for each of a word's four bytes the lanes of a warp
// read 32 different banks whatever the data (with C = 64 a warp holds two
// rows, and the upper half takes its bytes in the order 1, 0, 3, 2). A
// lookup's byte offset is the word shifted and masked, or-ed with the
// lane's column: shift, mask-or, load, add for four codes. A warp takes 32
// rows at a time, 16 row words a lane in flight, and reduces the 32
// per-lane sums with a transposing butterfly (31 shuffles for 32 rows, not
// 160). Slabs add up across CTAs: each writes its rows' partial sums, less
// m_k times the slab's sum of w, and a second kernel adds the slabs in a
// fixed order. No float atomics. About 2.3 instructions a code as compiled.
//
// Xv (packed_matvec_pair_kernel). The TPU kernel accumulated across its
// sequential grid; CUDA blocks run in no order, so the G rows are cut into
// chunks, a CTA owns 256 words of the row (16 observations a thread) for
// one chunk and writes partial sums, and the second kernel adds the chunks
// in a fixed order. A CTA first compacts its chunk of v (ballot and prefix
// sum, on the device) into the list of rows with v_k != 0 in row order,
// with each row's values {0, v, 2v, m v} and the chunk's share of m'v, so a
// sync round that moved few markers reads only those rows and steps over
// nothing. The listed rows go two at a time: the two codes of one
// observation form a 4-bit index into U[idx] = val_0(c_0) v_0 + val_1(c_1)
// v_1, val_j(3) = m_j, missing codes included. The table lives in
// registers: lane e of each half-warp holds entry e, and a lookup is a
// 16-wide shuffle by the nibble, which the two rows' words give for eight
// observations at once with one shift and one mask-select. Shift, shuffle,
// add for two codes: about 1.8 instructions a code, no shared-memory table,
// no bank conflicts and no barrier after the compaction. (A 256-entry
// table in shared memory over four rows needs fewer instructions but its
// random indices collide about 3.5-way in the 32 banks; it was a third
// slower, with 2 or 4 interleaved copies slower still; 16-entry tables in
// shared memory with one copy a lane were a fifth slower.)
//
// Rows are bpm bytes apart: 4-byte but, at bpm = 12,500, not 16- or
// 32-byte aligned. Loads are one 32-bit word a lane (bytes when
// bpm % 4 != 0 or the base is unaligned); a warp's 128 bytes of a row then
// straddle five 32-byte sectors instead of four. Rows padded to a multiple
// of 128 bytes were 1% faster in X'w and no faster in Xv, so the store keeps
// its stride.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRhsThreads = 512;
constexpr int kRhsBatch = 32;     // rows a warp reduces together
constexpr int kRhsLoads = 16;     // row words a lane keeps in flight
constexpr int kMvThreads = 256;
constexpr int kMvMaxChunk = 512;  // rows of v a CTA compacts
constexpr int kMvPairs = 8;       // pairs of rows a lane keeps in flight

// Word wi of a row: bytes 4wi..4wi+3, low byte first; bytes past bpm read 0.
template <int VEC>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int wi,
                                              int bpm) {
  if (VEC == 4) return reinterpret_cast<const uint32_t*>(row)[wi];
  uint32_t x = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * wi + q;
    if (i < bpm) x |= static_cast<uint32_t>(row[i]) << (8 * q);
  }
  return x;
}

// Sum of x over the CTA's threads in a fixed order, returned to every thread.
// s_part holds one float a warp; the caller must not reuse it before its
// next barrier.
__device__ __forceinline__ float block_sum(float x, float* s_part) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s_part[w];
  return total;
}

// A code's term of T (c w for c < 3) or of M (w for c == 3).
template <bool MISS>
__device__ __forceinline__ float table_term(uint32_t c, float w) {
  if (MISS) return c == 3u ? w : 0.0f;
  return c == 1u ? w : (c == 2u ? 2.0f * w : 0.0f);
}

// Fill tab[beta * C + column] for the slab's C byte positions from its 4 * C
// weights. kRhsThreads / C threads share a column, each with its own high
// nibbles of beta.
template <int C, bool MISS>
__device__ __forceinline__ void build_byte_table(float* __restrict__ tab,
                                                 const float* __restrict__ s_w) {
  constexpr int LW = C / 4;
  constexpr int HI_PER = 16 / (kRhsThreads / C);
  const int col = threadIdx.x % C;
  const int part = threadIdx.x / C;
  const int i = (col % LW) * 4 + col / LW;      // position kept at this column
  const float w0 = s_w[4 * i], w1 = s_w[4 * i + 1];
  const float w2 = s_w[4 * i + 2], w3 = s_w[4 * i + 3];
  float lo[16];
#pragma unroll
  for (int l = 0; l < 16; ++l)
    lo[l] = table_term<MISS>(l >> 2, w1) + table_term<MISS>(l & 3, w0);
#pragma unroll
  for (int k = 0; k < HI_PER; ++k) {
    const uint32_t hi = part * HI_PER + k;
    const float h = table_term<MISS>(hi >> 2, w3) + table_term<MISS>(hi & 3u, w2);
#pragma unroll
    for (int l = 0; l < 16; ++l) tab[(hi * 16 + l) * C + col] = h + lo[l];
  }
}

// Transposing butterfly over the N lanes of a row: after the step with
// distance D a lane keeps the half of its sums whose index has bit D as its
// own lane index does, so lane lw ends with the sum of index lw in acc[0].
template <int D, int N>
__device__ __forceinline__ void fold_rows(float (&acc)[N], int lw) {
  const bool up = (lw & D) != 0;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float keep = up ? acc[j + D] : acc[j];
    const float send = up ? acc[j] : acc[j + D];
    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, D);
  }
  if constexpr (D > 1) fold_rows<D / 2>(acc, lw);
}

template <int C, bool MISSING, int VEC>
__global__ void __launch_bounds__(kRhsThreads, 1)
packed_rhs_table_kernel(const uint8_t* __restrict__ rows,
                        const float* __restrict__ means,
                        const float* __restrict__ w_pad,
                        float* __restrict__ partial, int G, int bpm,
                        int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_T = reinterpret_cast<float*>(smem_raw);
  float* s_M = s_T + 256 * C;                       // only when MISSING
  float* s_w = s_T + (MISSING ? 512 : 256) * C;     // the slab's 4 * C weights
  constexpr int LW = C / 4;          // lanes (words) a row's slab takes
  constexpr int R = 32 / LW;         // rows a warp loads at once
  constexpr int NV = kRhsBatch / R;  // sums a lane carries; NV == LW
  static_assert(NV == LW && NV % kRhsLoads == 0, "batch and slab must agree");
  const int slab = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = lane / LW, lw = lane % LW;

  __shared__ float s_part[kRhsThreads / 32];
  float wmine = 0.0f;
  for (int j = threadIdx.x; j < 4 * C; j += kRhsThreads) {
    const int gi = 4 * slab * C + j;
    s_w[j] = gi < 4 * bpm ? w_pad[gi] : 0.0f;
    wmine += s_w[j];
  }
  const float wsum = block_sum(wmine, s_part);     // the slab's sum of w
  build_byte_table<C, false>(s_T, s_w);
  if (MISSING) build_byte_table<C, true>(s_M, s_w);
  __syncthreads();

  const int nwords = (bpm + 3) / 4;
  const int wi = slab * LW + lw;                 // this lane's word of a row
  const bool in_row = wi < nwords;
  const int r_begin = blockIdx.y * rows_per_cta;
  const int r_end = min(G, r_begin + rows_per_cta);
  // Byte offset of a lookup: beta * 4C, straight from the word by one byte
  // permute (C = 64: beta << 8) or one shift (C = 128: beta << 9) and a mask,
  // or-ed with the lane's column offset, which lies below the mask's bits.
  uint32_t sel[4], colb[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int q = t ^ h;                         // byte taken at step t
    sel[t] = 0x4404u | (q << 4);                 // byte q -> bits 8..15
    colb[t] = (q * LW + lw) * 4;
  }
  const char* tT = reinterpret_cast<const char*>(s_T);
  const char* tM = reinterpret_cast<const char*>(s_M);
  for (int r0 = r_begin + warp * kRhsBatch; r0 < r_end;
       r0 += (kRhsThreads / 32) * kRhsBatch) {
    float acc[NV];
#pragma unroll
    for (int j0 = 0; j0 < NV; j0 += kRhsLoads) {    // 1 or 2 groups of loads
      uint32_t wd[kRhsLoads];
#pragma unroll
      for (int jj = 0; jj < kRhsLoads; ++jj) {
        const int row = r0 + (j0 + jj) * R + h;
        wd[jj] = (in_row && row < r_end)
                     ? load_word<VEC>(rows + static_cast<size_t>(row) * bpm, wi, bpm)
                     : 0u;
      }
#pragma unroll
      for (int jj = 0; jj < kRhsLoads; ++jj) {
        float a = 0.0f, am = 0.0f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t at;
          if (C == 64) {
            at = __byte_perm(wd[jj], 0u, sel[t]) | colb[t];
          } else {                               // h == 0: byte t
            const uint32_t x = t == 0 ? wd[jj] << 9
                             : t == 1 ? wd[jj] << 1 : wd[jj] >> (8 * t - 9);
            at = (x & 0x1fe00u) | colb[t];
          }
          a += *reinterpret_cast<const float*>(tT + at);
          if (MISSING) am += *reinterpret_cast<const float*>(tM + at);
        }
        if (MISSING) {
          const int row = r0 + (j0 + jj) * R + h;
          a = fmaf(row < r_end ? means[row] : 0.0f, am, a);
        }
        acc[j0 + jj] = a;
      }
    }
    fold_rows<NV / 2>(acc, lw);
    const int row = r0 + lw * R + h;
    if (row < r_end)
      partial[static_cast<size_t>(slab) * G + row] = acc[0] - means[row] * wsum;
  }
}

// out[i] = sum over the parts, in order, of partial[part][i].
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n,
                                    int nparts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < nparts; ++c) s += partial[static_cast<size_t>(c) * n + i];
  out[i] = s;
}

// Xv: lane e of each half-warp holds entry e = c0 | c1 << 2 of a row pair's
// table, and a lookup is a 16-wide shuffle by the nibble a_f | b_f << 2 of
// the two rows' codes of one observation.
template <int VEC>
__global__ void __launch_bounds__(kMvThreads)
packed_matvec_pair_kernel(const uint8_t* __restrict__ rows,
                          const float* __restrict__ means,
                          const float* __restrict__ v,
                          float* __restrict__ partial, int G, int bpm,
                          int rows_per_chunk) {
  __shared__ int s_row[kMvMaxChunk + 2 * kMvPairs];
  __shared__ float4 s_lut[kMvMaxChunk + 2 * kMvPairs];   // {0, v, 2v, m v}
  __shared__ int s_warp_count[kMvThreads / 32];
  __shared__ float s_part[kMvThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.y * rows_per_chunk;
  const int k1 = min(G, k0 + rows_per_chunk);

  // 1. the chunk's rows with v != 0, in row order, and its share of m'v
  int count = 0;
  float mv_mine = 0.0f;
  for (int base = k0; base < k1; base += kMvThreads) {
    const int k = base + tid;
    const float vk = k < k1 ? v[k] : 0.0f;
    const bool nz = vk != 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = count;
#pragma unroll
    for (int w = 0; w < kMvThreads / 32; ++w) {
      const int c = s_warp_count[w];
      if (w < warp) before += c;
      total += c;
    }
    if (nz) {
      const int slot = before + __popc(ballot & ((1u << lane) - 1u));
      s_row[slot] = k;
      const float mvk = means[k] * vk;
      s_lut[slot] = make_float4(0.0f, vk, 2.0f * vk, mvk);
      mv_mine += mvk;
    }
    count = total;
    __syncthreads();
  }
  const float mv = block_sum(mv_mine, s_part);
  // the list is filled up to whole batches of pairs with rows that add nothing
  const int nbatches = (count + 2 * kMvPairs - 1) / (2 * kMvPairs);
  if (tid < nbatches * 2 * kMvPairs - count) {
    s_row[count + tid] = k0;
    s_lut[count + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const int nwords = (bpm + 3) / 4;
  const int wi = blockIdx.x * kMvThreads + tid;
  const bool active = wi < nwords;
  const float* lut = reinterpret_cast<const float*>(s_lut);
  const int e0 = lane & 3, e1 = 4 + ((lane >> 2) & 3);   // this lane's entry
  float acc[16];
#pragma unroll
  for (int f = 0; f < 16; ++f) acc[f] = -mv;

  for (int bt = 0; bt < nbatches; ++bt) {
    const int r = bt * 2 * kMvPairs;
    uint32_t wd[2 * kMvPairs];
#pragma unroll
    for (int j = 0; j < 2 * kMvPairs; ++j)
      wd[j] = active ? load_word<VEC>(rows + static_cast<size_t>(s_row[r + j]) * bpm, wi, bpm)
                     : 0u;
#pragma unroll
    for (int pi = 0; pi < kMvPairs; ++pi) {
      const float entry = lut[4 * (r + 2 * pi) + e0] + lut[4 * (r + 2 * pi) + e1];
      const uint32_t a = wd[2 * pi], b = wd[2 * pi + 1];
      // nibble k of `even` is a_f | b_f << 2 for field f = 2k, of `odd` for 2k + 1
      const uint32_t even = (a & 0x33333333u) | ((b << 2) & 0xccccccccu);
      const uint32_t odd = ((a >> 2) & 0x33333333u) | (b & 0xccccccccu);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[2 * k] += __shfl_sync(0xffffffffu, entry, even >> (4 * k), 16);
        acc[2 * k + 1] += __shfl_sync(0xffffffffu, entry, odd >> (4 * k), 16);
      }
    }
  }

  if (active) {
    float* dst = partial + static_cast<size_t>(blockIdx.y) * 4 * bpm +
                 static_cast<size_t>(wi) * 16;
    if (VEC == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
#pragma unroll
      for (int f = 0; f < 16; ++f)
        if (4 * wi + f / 4 < bpm) dst[f] = acc[f];
    }
  }
}

bool word_aligned(const uint8_t* rows, int bpm) {
  return bpm % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 4 == 0;
}

template <int C, bool MISSING, int VEC>
int launch_rhs(const uint8_t* rows, const float* means, const float* w_pad,
               float* partial, int G, int bpm, int rows_per_cta,
               cudaStream_t s) {
  const int smem = ((MISSING ? 512 : 256) * C + 4 * C) * 4;
  int err = cudaFuncSetAttribute(packed_rhs_table_kernel<C, MISSING, VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
  if (err != 0) return err;
  const dim3 grid((bpm + C - 1) / C, (G + rows_per_cta - 1) / rows_per_cta);
  packed_rhs_table_kernel<C, MISSING, VEC><<<grid, kRhsThreads, smem, s>>>(rows, means, w_pad, partial, G, bpm, rows_per_cta);
  return cudaGetLastError();
}

template <int VEC>
int launch_matvec(const uint8_t* rows, const float* means, const float* v,
                       float* partial, int G, int bpm, int rows_per_chunk,
                       cudaStream_t s) {
  const dim3 grid(((bpm + 3) / 4 + kMvThreads - 1) / kMvThreads,
                  (G + rows_per_chunk - 1) / rows_per_chunk);
  packed_matvec_pair_kernel<VEC><<<grid, kMvThreads, 0, s>>>(rows, means, v, partial, G, bpm, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// partial: (ceil(bpm / slab), G) floats. slab is 128 without missing codes
// and 64 with them (two tables).
extern "C" int jt_packed_rhs(const uint8_t* rows, const float* means,
                             const float* w_pad, float* partial, float* out,
                             int G, int bpm,
                             int has_missing, int slab, int rows_per_cta,
                             void* stream) {
  if (G <= 0 || bpm <= 0 || rows_per_cta <= 0 ||
      slab != (has_missing ? 64 : 128))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = word_aligned(rows, bpm);
  int err;
  if (has_missing)
    err = al ? launch_rhs<64, true, 4>(rows, means, w_pad, partial, G, bpm, rows_per_cta, s)
             : launch_rhs<64, true, 1>(rows, means, w_pad, partial, G, bpm, rows_per_cta, s);
  else
    err = al ? launch_rhs<128, false, 4>(rows, means, w_pad, partial, G, bpm, rows_per_cta, s)
             : launch_rhs<128, false, 1>(rows, means, w_pad, partial, G, bpm, rows_per_cta, s);
  if (err != 0) return err;
  sum_partials_kernel<<<(G + 255) / 256, 256, 0, s>>>(partial, out, G, (bpm + slab - 1) / slab);
  return cudaGetLastError();
}

// CTAs of the Xv kernel that fit one SM, or -cudaError.
extern "C" int jt_packed_matvec_ctas_per_sm() {
  int n = 0;
  const int err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, packed_matvec_pair_kernel<4>, kMvThreads, 0);
  return err != 0 ? -err : n;
}

// partial: (ceil(G / rows_per_chunk), 4 * bpm) floats.
extern "C" int jt_packed_matvec(const uint8_t* rows, const float* means,
                                const float* v, float* partial, float* out,
                                int G, int bpm,
                                int rows_per_chunk, void* stream) {
  if (G <= 0 || bpm <= 0 || rows_per_chunk <= 0 || rows_per_chunk > kMvMaxChunk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = word_aligned(rows, bpm)
                ? launch_matvec<4>(rows, means, v, partial, G, bpm, rows_per_chunk, s)
                : launch_matvec<1>(rows, means, v, partial, G, bpm, rows_per_chunk, s);
  if (err != 0) return err;
  const int n4 = 4 * bpm;
  const int nchunks = (G + rows_per_chunk - 1) / rows_per_chunk;
  sum_partials_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(partial, out, n4, nchunks);
  return cudaGetLastError();
}
