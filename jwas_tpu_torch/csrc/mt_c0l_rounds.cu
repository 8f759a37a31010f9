// Multi-trait RR-BLUP / BayesL inner rounds on Hopper (K9): the marker
// chain of every block, nreps * b strictly sequential marker steps a
// block, all blocks in parallel.
//
// Replaces the lax.scan chain of jwas_tpu/ops/multitrait.py: the scan at
// :467 over the step of mt_c0l_blocks (:436), whose marker update is
// _mt_c0l_marker_update (:414), and its exact form, the scan at :498 of
// mt_c0l_exact (:478), which is this kernel with one block a call
// (ops/multitrait.py).
//
// The step as an affine map. With Lhs_j = xpx_j Rinv + Ginv / gamma_j =
// D + L + U (diagonal, strictly lower, strictly upper) and T = D + L, the
// reference's trait loop on marker j is exactly
//   a_new = P_j rhs_j + c_j,   c_j = Q_j a_old + S_j z,
// with P = T^-1 Rinv, Q = T^-1 (xpx Rinv - U), S = T^-1 diag(Lhs_kk
// sqrt(1 / Lhs_kk)), each times valid_j (ops/multitrait.py::
// mt_c0l_constants). A pre-pass kernel, a thread a marker, computes P, Q
// and S once a call (forward substitution, its divisions included); c_j
// needs only a_old, which marker j's previous step wrote b steps earlier,
// and the step's normals. What is left on the chain: rhs_j takes the last
// d, t products with P_j and t - 1 sums a trait, + c_j, d = a_old - a_new.
//
// The schedule. Thread i of a CTA (one CTA a block, up to 256 threads)
// owns markers i, i + T, ... (R = 1, 2, 4 or 8 of them: b <= 2,048) and
// holds their t rhs values in registers for the whole call. A run is 32
// consecutive markers of a rep (the last of a rep may be shorter); one
// warp owns it, lane l marker j0 + l:
//
//  - Every lane evaluates the map on its own registers (its P, c, a_old
//    and rhs, loaded from the run's stage at the run's start); at step l
//    lane l's candidate is the step's. d is shuffled from lane l, every
//    lane adds d G[j][i] to its rhs of the run's row, and the warp
//    publishes d (every lane the same words, so no branch) in a ring of
//    kRing slots in shared memory: each value split into
//    32-bit words, each word stored beside the step's tag (s + 1) in one
//    64-bit word, so a reader that sees every tag has the whole d without a
//    fence. No barrier, no global load, no division inside the run.
//  - Every other warp adds the ring's d's to its rhs values lazily,
//    strictly in ascending steps, so each rhs value receives the additions
//    of the sequential chain in the same order with the same rounding; it
//    takes them a batch of up to 8 steps at a time, as they come, the
//    batch's tags checked together: the owner of the next run on that run's
//    row alone, polling without pause (its other rows after its own run),
//    the others on all their rows, sleeping between polls.
//  - The ring's bound takes the place of the old kernel's double buffer:
//    each warp publishes in `done` the steps all its rows have taken, and a
//    run starts only when every warp has taken the steps whose slots it
//    will overwrite (done >= last step + 1 - kRing). A slot is reused only
//    after its d reached every rhs value, so the ring never has to be
//    larger than kRing, whatever a warp's lag.
//  - A run's inputs are staged in shared memory ahead of it by its own
//    warp: P (t t a lane), the run's 32 x 32 Gram block and the block of
//    the previous run's rows (which its progressive adds read) by
//    cp.async, c and a_old computed from Q, S, alpha and the normals. Run
//    u takes buffer u mod nbuf (nbuf as many as fit, at least 2, at most a
//    buffer a warp) and is staged once run u - nbuf is over (every read of
//    a buffer comes before its run publishes its last d). The next owner
//    sets its run up (its registers, the ring's bound) before the run
//    ahead of it ends, so that only the last batch's adds are left between
//    the two runs. The other consumers' Gram entries are loaded 16 steps at
//    a time, all 16 in flight before the first of their d's is read.
//  - A wait that lasts 2 s is a fault: the kernel traps rather than hang.
//
// Rounding follows the plain PyTorch version (ops/multitrait.py::
// mt_c0l_inner_rounds_ref) operation by operation: the __f*_rn / __d*_rn
// intrinsics keep nvcc from contracting a*b+c into an FMA, so the kernel
// and its plain version give the same bits on the card. The schedule's
// plain model is ops/inner_rounds.py::mt_c0l_inner_rounds_window_ref.
//
// The scratch is the caller's: (nblocks, b, 3 t t) values of T, P, Q and
// S a marker (ops/multitrait.py::scratch_values). Two builds, float32 and
// float64 (runMCMC's double_precision), each instantiated for t = 2..8
// traits and R = 1, 2, 4, 8 markers a thread.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

#include "smem_plan.cuh"

namespace {

using jt::add_rn;
using jt::div_rn;
using jt::mul_rn;
using jt::sqrt_rn;
using jt::sub_rn;

template <typename T> struct Args {
  const T* grams;      // (nblocks, b, b), row j of block k at [k][j]
  const T* xpx;        // (nblocks, b)
  const T* valid;      // (nblocks, b), 0 or 1
  T* alpha;            // (nblocks, t, b), in place
  T* rhs;              // (nblocks, t, b), in place
  const T* Rinv;       // (t, t), row-major
  const T* Ginv;       // (t, t), row-major
  const T* gamma;      // (nblocks, b)
  const T* zs;         // (nreps b, t, nblocks)
  T* scratch;          // (nblocks, b, 3 t t): P, Q, S a marker
  int b, nblocks, nreps;
};

constexpr int kThreads = 256;   // threads of a CTA at most
constexpr int kMaxRows = 8;     // markers a thread owns: b <= 2048
                                // (ops/multitrait.py::MAX_BLOCK)
constexpr int kRun = 32;        // markers of a run: one warp's lanes
constexpr int kRing = 128;      // slots of the ring of d's
                                // (ops/inner_rounds.py::C0L_RING)
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr unsigned long long kWaitNs = 2000000000ull;

typedef unsigned long long u64;

// 32-bit words of a value in the ring
template <class T> struct Words;
template <> struct Words<float> { static constexpr int n = 1; };
template <> struct Words<double> { static constexpr int n = 2; };

__device__ __forceinline__ unsigned word_of(float v, int) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned word_of(double v, int h) {
  return h ? static_cast<unsigned>(__double2hiint(v)) : static_cast<unsigned>(__double2loint(v));
}
__device__ __forceinline__ float value_of(const unsigned* w, float*) { return __uint_as_float(w[0]); }
__device__ __forceinline__ double value_of(const unsigned* w, double*) {
  return __hiloint2double(static_cast<int>(w[1]), static_cast<int>(w[0]));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A run's inputs in shared memory.
template <class T, int NT>
struct Stage {
  T P[kRun][NT * NT];   // lane l's P_j, by rows
  T c[kRun][NT];        // c_j = Q_j a_old + S_j z
  T a[kRun][NT];        // a_old
  T g[kRun][kRun];      // g[jj][l] = G[j0 + jj][j0 + l]
  T gp[kRun][kRun];     // gp[jj][l] = G[j0' + jj][j0 + l], j0' the previous run's
};

template <class T, int NT>
__host__ __device__ constexpr size_t ring_bytes() { return sizeof(u64) * kRing * NT * Words<T>::n; }
__host__ __device__ constexpr size_t done_bytes() { return sizeof(int) * (kThreads / 32); }

// The run geometry of run v: its first step, first marker, markers, warp
// and row.
struct Run {
  int s0, j0, n, warp, row;
};
__device__ __forceinline__ Run run_of(int v, int nruns, int nwarps, int b) {
  const int rep = v / nruns, rho = v - rep * nruns;
  const int j0 = rho * kRun;
  return Run{rep * b + j0, j0, min(kRun, b - j0), rho % nwarps, rho / nwarps};
}

// step s's d into its slot: word q of value m beside the tag s + 1
template <class T, int NT>
__device__ __forceinline__ void publish(u64* ring, int s, const T (&d)[NT]) {
  constexpr int W = Words<T>::n;
  volatile u64* slot = ring + static_cast<size_t>(s & (kRing - 1)) * NT * W;
  const u64 tag = static_cast<u64>(static_cast<unsigned>(s + 1)) << 32;
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int h = 0; h < W; ++h) slot[m * W + h] = tag | word_of(d[m], h);
}

template <class T, int NT>
__device__ __forceinline__ bool try_read(const u64* ring, int s, T (&d)[NT]) {
  constexpr int W = Words<T>::n;
  const volatile u64* slot = ring + static_cast<size_t>(s & (kRing - 1)) * NT * W;
  const unsigned tag = static_cast<unsigned>(s + 1);
  bool ok = true;
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    unsigned w[W];
#pragma unroll
    for (int h = 0; h < W; ++h) {
      const u64 x = slot[m * W + h];
      ok &= static_cast<unsigned>(x >> 32) == tag;
      w[h] = static_cast<unsigned>(x);
    }
    d[m] = value_of(w, static_cast<T*>(nullptr));
  }
  return ok;
}

// A wait's watchdog, every 1,024 polls: the time of the first call, a trap
// once kWaitNs have passed since. Out of line: it stays off the polls.
__device__ __noinline__ unsigned long long watchdog(unsigned long long t0) {
  const unsigned long long now = now_ns();
  if (t0 == 0) return now;
  if (now - t0 > kWaitNs) __trap();
  return t0;
}

// step s's d, polling until it is out (with a short sleep between polls
// when `sleep`: a warp whose adds wait for no run of its own)
template <class T, int NT>
__device__ __forceinline__ void read_d(const u64* ring, int s, T (&d)[NT], bool sleep) {
  unsigned long long t0 = 0;
  for (unsigned it = 1; !try_read<T, NT>(ring, s, d); ++it) {
    if (sleep) __nanosleep(32);
    if ((it & 1023) == 0) t0 = watchdog(t0);
  }
}

// Steps read at once: 8 for t 32-bit words a step up to 4, else 4, else 2.
template <class T, int NT>
__host__ __device__ constexpr int batch() {
  return NT * Words<T>::n <= 4 ? 8 : NT * Words<T>::n <= 8 ? 4 : 2;
}

// The d's of steps [s, s + cnt), cnt <= kB: wait until the last is out, then
// read them all, their tags checked together (one round trip for the batch,
// not one a step); if some word is not visible yet, step by step.
template <class T, int NT, int kB>
__device__ __forceinline__ void read_batch(const u64* ring, int s, int cnt, T (&d)[kB][NT],
                                           bool sleep) {
  read_d<T, NT>(ring, s + cnt - 1, d[0], sleep);
  bool ok = true;
#pragma unroll
  for (int q = 0; q < kB; ++q) ok &= try_read<T, NT>(ring, s + q, d[q]) || q >= cnt;
  if (!ok)
#pragma unroll
    for (int q = 0; q < kB; ++q)
      if (q < cnt) read_d<T, NT>(ring, s + q, d[q], sleep);
}

// rhs += d_s G[j_s][i] for the steps of run r, in order, the d's taken a
// batch at a time as they come; i >= b adds zeros. The Gram entries are
// loaded 16 steps at a time, all 16 before the first of their d's.
template <class T, int NT>
__device__ __forceinline__ void apply_run(const Args<T>& A, const T* gram, const u64* ring,
                                          const Run& r, int i, T (&rhs)[NT], bool sleep) {
  constexpr int kChunk = 16, kB = batch<T, NT>();
#pragma unroll 1
  for (int j0 = 0; j0 < r.n; j0 += kChunk) {
    T g[kChunk];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj)
      g[jj] = (j0 + jj < r.n && i < A.b)
                  ? gram[static_cast<size_t>(r.j0 + j0 + jj) * A.b + i] : T(0);
#pragma unroll
    for (int b0 = 0; b0 < kChunk; b0 += kB) {
      if (j0 + b0 >= r.n) break;
      const int cnt = min(kB, r.n - j0 - b0);
      T d[kB][NT];
      read_batch<T, NT, kB>(ring, r.s0 + j0 + b0, cnt, d, sleep);
#pragma unroll
      for (int q = 0; q < kB; ++q)
        if (q < cnt)
#pragma unroll
          for (int m = 0; m < NT; ++m) rhs[m] = add_rn(rhs[m], mul_rn(d[q][m], g[b0 + q]));
    }
  }
}

// apply_run on this thread's rows but `skip` (-1: none). One loop over the
// rows, not unrolled, so that apply_run is compiled once a call site.
template <class T, int NT, int R>
__device__ __forceinline__ void apply_rows(const Args<T>& A, const T* gram, const u64* ring,
                                           const Run& r, T (&rhs)[R][NT], int tid, int nt,
                                           int skip, bool sleep) {
#pragma unroll 1
  for (int q = 0; q < R; ++q) {
    if (q == skip) continue;
    T row[NT];
#pragma unroll
    for (int m = 0; m < NT; ++m) row[m] = rhs[0][m];
#pragma unroll
    for (int p = 1; p < R; ++p)
      if (p == q)
#pragma unroll
        for (int m = 0; m < NT; ++m) row[m] = rhs[p][m];
    apply_run<T, NT>(A, gram, ring, r, tid + q * nt, row, sleep);
#pragma unroll
    for (int p = 0; p < R; ++p)
      if (p == q)
#pragma unroll
        for (int m = 0; m < NT; ++m) rhs[p][m] = row[m];
  }
}

// The pre-pass: a thread a marker of every block writes the marker's P, Q
// and S to the scratch, as the plain version's mt_c0l_constants computes
// them. A kernel of its own, instantiated a trait count, not a row count.
template <class T, int NT>
__global__ void c0l_consts(Args<T> A) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(A.nblocks) * A.b) return;
  const T x = A.xpx[i], gm = A.gamma[i], v = A.valid[i];
  T lhs[NT][NT], e[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int m = 0; m < NT; ++m)
      lhs[k][m] = add_rn(mul_rn(x, A.Rinv[k * NT + m]), div_rn(A.Ginv[k * NT + m], gm));
#pragma unroll
  for (int k = 0; k < NT; ++k) e[k] = mul_rn(lhs[k][k], sqrt_rn(div_rn(T(1), lhs[k][k])));
  T* out = A.scratch + i * (3 * NT * NT);
  // T X = B for B = Rinv (P), xpx Rinv - U (Q: -Ginv / gamma above the
  // diagonal) and diag(e) (S), row by row
#pragma unroll 1
  for (int which = 0; which < 3; ++which) {
    T X[NT][NT];
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        T acc = which == 0   ? A.Rinv[k * NT + m]
                : which == 1 ? (m > k ? -div_rn(A.Ginv[k * NT + m], gm)
                                      : mul_rn(x, A.Rinv[k * NT + m]))
                             : (m == k ? e[k] : T(0));
#pragma unroll
        for (int q = 0; q < k; ++q) acc = sub_rn(acc, mul_rn(lhs[k][q], X[q][m]));
        X[k][m] = div_rn(acc, lhs[k][k]);
      }
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int m = 0; m < NT; ++m) out[which * NT * NT + k * NT + m] = mul_rn(X[k][m], v);
  }
}

// Stage run r (index u) into its buffer: lane l's P by cp.async, its c and
// a_old, and the run's Gram block by cp.async (waited for at the run's
// start).
template <class T, int NT>
__device__ void stage(const Args<T>& A, int k, size_t kb, const Run& r, const Run& prev,
                      Stage<T, NT>* st, int lane) {
  const T* gram = A.grams + kb * A.b;
  if (lane < r.n) {
    const int i = r.j0 + lane;
    const T* c = A.scratch + (kb + i) * (3 * NT * NT);
#pragma unroll
    for (int e = 0; e < NT * NT; ++e) __pipeline_memcpy_async(&st->P[lane][e], c + e, sizeof(T));
#pragma unroll 4
    for (int jj = 0; jj < r.n; ++jj)
      __pipeline_memcpy_async(&st->g[jj][lane],
                              gram + static_cast<size_t>(r.j0 + jj) * A.b + i, sizeof(T));
#pragma unroll 4
    for (int jj = 0; jj < prev.n; ++jj)
      __pipeline_memcpy_async(&st->gp[jj][lane],
                              gram + static_cast<size_t>(prev.j0 + jj) * A.b + i, sizeof(T));
    __pipeline_commit();
    T a[NT], z[NT];
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      a[m] = A.alpha[kb * NT + static_cast<size_t>(m) * A.b + i];
      z[m] = A.zs[(static_cast<size_t>(r.s0 + lane) * NT + m) * A.nblocks + k];
    }
    const T* Q = c + NT * NT;
    const T* S = c + 2 * NT * NT;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      T qa = mul_rn(Q[q * NT], a[0]);
      T sz = mul_rn(S[q * NT], z[0]);
#pragma unroll
      for (int m = 1; m < NT; ++m) {
        qa = add_rn(qa, mul_rn(Q[q * NT + m], a[m]));
        sz = add_rn(sz, mul_rn(S[q * NT + m], z[m]));
      }
      st->c[lane][q] = add_rn(qa, sz);
      st->a[lane][q] = a[q];
    }
  }
}

template <class T, int NT, int R>
__global__ void __launch_bounds__(kThreads, 1) c0l_chain(Args<T> A, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* ring = reinterpret_cast<u64*>(smem_raw);
  int* done = reinterpret_cast<int*>(smem_raw + ring_bytes<T, NT>());
  Stage<T, NT>* stages =
      reinterpret_cast<Stage<T, NT>*>(smem_raw + ring_bytes<T, NT>() + done_bytes());

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int b = A.b;
  const size_t kb = static_cast<size_t>(k) * b;
  const T* gram = A.grams + kb * b;
  const int nruns = (b + kRun - 1) / kRun;
  const int total = A.nreps * nruns;

  for (int q = tid; q < kRing * NT * Words<T>::n; q += nt) ring[q] = 0;
  if (tid < nwarps) done[tid] = 0;
  // the rhs of the markers this thread owns
  T rhs[R][NT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * nt;
#pragma unroll
    for (int m = 0; m < NT; ++m)
      rhs[r][m] = i < b ? A.rhs[kb * NT + static_cast<size_t>(m) * b + i] : T(0);
  }
  __syncthreads();

  // this warp's next own run (total when none is left)
  auto next_own = [&](int u) {
    for (++u; u < total; ++u)
      if (((u % nruns) % nwarps) == w) return u;
    return total;
  };
  int nxt = next_own(-1);
  int staged = -1;      // the last run this warp staged
  int applied = 0;      // steps that every row of this warp has taken
  int pending = -1;     // a run taken by the next run's row only
  auto prefetch = [&](int last) {
    if (nxt < total && staged < nxt && nxt - nbuf <= last) {
      stage<T, NT>(A, k, kb, run_of(nxt, nruns, nwarps, b),
                   run_of(nxt > 0 ? nxt - 1 : 0, nruns, nwarps, b), stages + nxt % nbuf, lane);
      staged = nxt;
    }
  };
  prefetch(-1);

  for (int v = 0; v < total; ++v) {
    Run r = run_of(v, nruns, nwarps, b);
    const bool next_is_own = r.warp != w && nxt == v + 1 && nxt < total;
    if (r.warp != w && !next_is_own) {
      // ---- another warp's run: its d's as they come, sleeping between polls
      apply_rows<T, NT, R>(A, gram, ring, r, rhs, tid, nt, -1, true);
      applied = r.s0 + r.n;
      if (lane == 0) reinterpret_cast<volatile int*>(done)[w] = applied;
      prefetch(v);
      continue;
    }
    // ---- this warp's run u: everything that does not wait for the last d
    // first, then (when run v is another warp's) run v's steps on u's row
    // as they come, then u's chain
    const int u = next_is_own ? nxt : v;
    const Run ru = next_is_own ? run_of(u, nruns, nwarps, b) : r;
    if (staged < u) {     // not staged ahead: runs up to u - 2 are over, nbuf >= 2
      stage<T, NT>(A, k, kb, ru, run_of(u > 0 ? u - 1 : 0, nruns, nwarps, b),
                   stages + u % nbuf, lane);
      staged = u;
    }
    // every warp has taken the steps whose slots this run overwrites
    {
      const int need = ru.s0 + ru.n - kRing;
      unsigned long long t0 = 0;
      for (unsigned it = 1;; ++it) {
        const int got = lane < nwarps ? reinterpret_cast<volatile int*>(done)[lane] : need;
        if (__all_sync(kFullWarp, got >= need)) break;
        __nanosleep(64);
        if ((it & 63) == 0) t0 = watchdog(t0);
      }
    }
    __pipeline_wait_prior(0);
    __syncwarp();
    const Stage<T, NT>* st = stages + u % nbuf;
    T P[NT * NT], c[NT], a_old[NT], cur[NT];
#pragma unroll
    for (int e = 0; e < NT * NT; ++e) P[e] = st->P[lane][e];
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      c[m] = st->c[lane][m];
      a_old[m] = st->a[lane][m];
      cur[m] = rhs[0][m];
    }
#pragma unroll
    for (int q = 1; q < R; ++q)
      if (q == ru.row)
#pragma unroll
        for (int m = 0; m < NT; ++m) cur[m] = rhs[q][m];
    T g_next = st->g[0][lane];
    if (next_is_own) {
      // run v's steps on u's row, a batch at a time as they come; their
      // Gram entries staged
      constexpr int kB = batch<T, NT>();
#pragma unroll 1
      for (int b0 = 0; b0 < r.n; b0 += kB) {
        const int cnt = min(kB, r.n - b0);
        T d[kB][NT];
        read_batch<T, NT, kB>(ring, r.s0 + b0, cnt, d, false);
#pragma unroll
        for (int q = 0; q < kB; ++q)
          if (q < cnt) {
            const T g = st->gp[b0 + q][lane];
#pragma unroll
            for (int m = 0; m < NT; ++m) cur[m] = add_rn(cur[m], mul_rn(d[q][m], g));
          }
      }
      if (R == 1) {
        applied = r.s0 + r.n;
        if (lane == 0) reinterpret_cast<volatile int*>(done)[w] = applied;
      } else {
        pending = v;      // the other rows take it after u
      }
      v = u;
      r = ru;
    }
    T mine[NT];       // this lane's a_new, kept from its own step
#pragma unroll
    for (int m = 0; m < NT; ++m) mine[m] = T(0);
#pragma unroll 4
    for (int l = 0; l < r.n; ++l) {
      const T g = g_next;
      if (l + 1 < kRun) g_next = st->g[l + 1][lane];
      T d[NT];
      const bool own = lane == l;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        T acc = mul_rn(P[q * NT], cur[0]);
#pragma unroll
        for (int m = 1; m < NT; ++m) acc = add_rn(acc, mul_rn(P[q * NT + m], cur[m]));
        const T an = add_rn(acc, c[q]);
        d[q] = __shfl_sync(kFullWarp, sub_rn(a_old[q], an), l);
        mine[q] = own ? an : mine[q];
      }
      publish<T, NT>(ring, r.s0 + l, d);
#pragma unroll
      for (int m = 0; m < NT; ++m) cur[m] = add_rn(cur[m], mul_rn(d[m], g));
    }
    if (lane < r.n)
#pragma unroll
      for (int m = 0; m < NT; ++m)
        A.alpha[kb * NT + static_cast<size_t>(m) * b + r.j0 + lane] = mine[m];
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (q == r.row)
#pragma unroll
        for (int m = 0; m < NT; ++m) rhs[q][m] = cur[m];
    // the other rows take the pending run's steps, then this run's
    if (R > 1) {
      if (pending >= 0)
        apply_rows<T, NT, R>(A, gram, ring, run_of(pending, nruns, nwarps, b), rhs, tid, nt,
                             r.row, false);
      apply_rows<T, NT, R>(A, gram, ring, r, rhs, tid, nt, r.row, false);
    }
    pending = -1;
    applied = r.s0 + r.n;
    if (lane == 0) reinterpret_cast<volatile int*>(done)[w] = applied;
    nxt = next_own(v);
    prefetch(v);
  }
  // the rhs back
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * nt;
    if (i >= b) continue;
#pragma unroll
    for (int m = 0; m < NT; ++m) A.rhs[kb * NT + static_cast<size_t>(m) * b + i] = rhs[r][m];
  }
}

template <class T, int NT, int R>
int launch_rows(const Args<T>& A, int threads, cudaStream_t stream) {
  int dev = 0, optin = 0;
  int err = cudaGetDevice(&dev);
  if (err == 0) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != 0) return err;
  const size_t head = ring_bytes<T, NT>() + done_bytes();
  const int nwarps = threads / 32;
  // at least two buffers: a warp stages its run before the run ahead of
  // it, in the buffer of the run before that, is over
  int nbuf = static_cast<int>((static_cast<size_t>(optin) - head) / sizeof(Stage<T, NT>));
  if (nbuf > nwarps) nbuf = nwarps > 2 ? nwarps : 2;
  if (nbuf < 2) return cudaErrorInvalidConfiguration;
  const size_t smem = head + static_cast<size_t>(nbuf) * sizeof(Stage<T, NT>);
  auto kern = c0l_chain<T, NT, R>;
  static bool ready[jt::kMaxDevices];
  if (!(dev < jt::kMaxDevices && ready[dev])) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != 0) return err;
    if (dev < jt::kMaxDevices) ready[dev] = true;
  }
  kern<<<A.nblocks, threads, smem, stream>>>(A, nbuf);
  return cudaGetLastError();
}

template <class T, int NT>
int launch_t(const Args<T>& A, cudaStream_t stream) {
  const int rounded = (A.b + 31) / 32 * 32;
  const int threads = rounded < kThreads ? rounded : kThreads;
  int rows = 1;
  while (rows * threads < A.b) rows *= 2;
  if (rows > kMaxRows) return cudaErrorInvalidValue;
  const size_t markers = static_cast<size_t>(A.nblocks) * A.b;
  c0l_consts<T, NT><<<static_cast<unsigned>((markers + 127) / 128), 128, 0, stream>>>(A);
  const int err = cudaGetLastError();
  if (err != 0) return err;
  switch (rows) {
    case 1: return launch_rows<T, NT, 1>(A, threads, stream);
    case 2: return launch_rows<T, NT, 2>(A, threads, stream);
    case 4: return launch_rows<T, NT, 4>(A, threads, stream);
    default: return launch_rows<T, NT, 8>(A, threads, stream);
  }
}

template <typename T>
int launch(int t, const Args<T>& A, void* stream) {
  if (A.b < 1 || A.nblocks < 1 || A.nreps < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 2: return launch_t<T, 2>(A, st);
    case 3: return launch_t<T, 3>(A, st);
    case 4: return launch_t<T, 4>(A, st);
    case 5: return launch_t<T, 5>(A, st);
    case 6: return launch_t<T, 6>(A, st);
    case 7: return launch_t<T, 7>(A, st);
    case 8: return launch_t<T, 8>(A, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define JT_C0L_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const T* grams, const T* xpx, const T* valid, T* alpha,        \
                      T* rhs, const T* Rinv, const T* Ginv, const T* gamma,          \
                      const T* zs, T* scratch, int t, int b, int nblocks, int nreps, \
                      void* stream) {                                                \
    return launch<T>(t, Args<T>{grams, xpx, valid, alpha, rhs, Rinv, Ginv, gamma,    \
                                zs, scratch, b, nblocks, nreps}, stream);            \
  }

JT_C0L_ENTRY(jt_mt_c0l_inner_rounds, float)
JT_C0L_ENTRY(jt_mt_c0l_inner_rounds_f64, double)
