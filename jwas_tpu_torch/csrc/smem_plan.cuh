// Launch geometry shared by the inner-rounds kernels (abc_inner_rounds.cu,
// bayesr_inner_rounds.cu): one CTA per marker block, one thread per row up
// to 1024, and a dynamic shared-memory plan of per-marker state, an
// optional resident b x b Gram tile, and a chunk of reps of draws.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace jt {

inline int max_threads(int b) {
  int t = ((b + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

// Returns the bytes to launch with (0 if even one rep of draws does not
// fit) and sets *resident (Gram tile in shared memory) and *reps_per_chunk.
// state: bytes of per-marker state; rep_bytes: bytes of draws per rep.
// The Gram tile is resident when it fits beside the state and one rep.
inline size_t smem_plan(int b, int nreps, size_t state, size_t rep_bytes,
                        int* resident, int* reps_per_chunk, int* err) {
  int dev = 0, optin = 0;
  *err = cudaGetDevice(&dev);
  if (*err == 0)
    *err = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err != 0) return 0;
  const size_t gram = static_cast<size_t>(b) * b * 4;
  *resident = state + gram + rep_bytes <= static_cast<size_t>(optin);
  const size_t fixed = state + (*resident ? gram : 0);
  if (fixed + rep_bytes > static_cast<size_t>(optin)) return 0;
  size_t r = (optin - fixed) / rep_bytes;
  if (r > static_cast<size_t>(nreps)) r = nreps;
  *reps_per_chunk = static_cast<int>(r);
  return fixed + r * rep_bytes;
}

}  // namespace jt
