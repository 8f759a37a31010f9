// Pedigree inbreeding, host C++ for the port's pedigree module.
//
// Meuwissen & Luo (1992) inbreeding coefficients of a topologically coded
// pedigree (parents precede offspring), the same algorithm as the JAX
// package's native/pedigree.cpp and as the port's plain Python copy
// (jwas_tpu_torch/io/pedigree.py::_inbreeding_meuwissen_luo_py, its test
// oracle): the per-animal ancestor walk is a scalar pointer chase, ~30x
// faster here than in Python.
//
// Parallelism: animal i's walk reads only F of its ancestors. An animal's
// level is 0 without known parents, else one more than its parents'
// highest, so every ancestor of an animal lies on a lower level and the
// animals of one level are independent: the levels are walked in order,
// the unique (sire, dam) families of a level in parallel (OpenMP) with
// thread-local scratch, then sibling F values are filled. (Contiguous
// blocks of codes, the first design, serialise a pedigree whose parents
// may be the animal just before, as when parents are drawn from the two
// generations before.) Each F is the same walk whatever the schedule.
//
// Built by jwas_tpu_torch/_build.py::host_library with
// g++ -O3 -std=c++17 -shared -fPIC [-fopenmp] into jwas_tpu_torch/_build/
// (without -fopenmp it runs on one thread, with identical results).

#include <cstddef>
#include <cstdint>
#include <queue>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// One Meuwissen-Luo ancestor walk for animal i (known parents). L: caller
// scratch of size n, zeroed on entry and left zeroed on exit. eps > 0
// truncates traversal below path coefficient eps (the truncated node's own
// contribution is still added). Ancestors are taken in decreasing code
// order, from a max-heap while they are few against the codes below the
// next one, then by a scan of those codes (when the walk reaches most of
// them, as in an old, deep pedigree): the same order, the same sums.
inline void visit(const int64_t* sire, const int64_t* dam, const double* F,
                  int64_t j, double eps, std::vector<double>& L, double& f,
                  std::priority_queue<int64_t>* heap) {
    double Lj = L[j];
    L[j] = 0.0;
    int64_t sj = sire[j], dj = dam[j];
    double fs = sj >= 0 ? F[sj] : -1.0;
    double fd = dj >= 0 ? F[dj] : -1.0;
    f += Lj * Lj * (0.5 - 0.25 * (fs + fd));
    if (Lj < eps) return;     // truncate: contribution kept,
                              // parents not traversed
    // parents have smaller codes, so they are taken after j; accumulate
    // contributions before their single visit
    if (sj >= 0) {
        if (heap != nullptr && L[sj] == 0.0) heap->push(sj);
        L[sj] += 0.5 * Lj;
    }
    if (dj >= 0) {
        if (heap != nullptr && L[dj] == 0.0) heap->push(dj);
        L[dj] += 0.5 * Lj;
    }
}

double walk_f(const int64_t* sire, const int64_t* dam, const double* F,
              int64_t i, double eps, std::vector<double>& L,
              std::priority_queue<int64_t>& heap) {
    constexpr int64_t kScanRatio = 32;    // scan once the heap holds more
                                          // than 1/32 of the codes below
    L[i] = 1.0;
    heap.push(i);
    double f = -1.0;
    while (!heap.empty()) {
        int64_t j = heap.top();
        if (static_cast<int64_t>(heap.size()) * kScanRatio > j) {
            while (!heap.empty()) heap.pop();
            for (int64_t k = j; k >= 0; --k) {
                if (L[k] != 0.0) visit(sire, dam, F, k, eps, L, f, nullptr);
            }
            break;
        }
        heap.pop();
        if (L[j] == 0.0) continue;  // duplicate heap entry already drained
        visit(sire, dam, F, j, eps, L, f, &heap);
    }
    return f;
}

}  // namespace

extern "C" {

// sire/dam: 0-based parent codes, -1 = unknown; topological order
// (parent code < child code). F: output inbreeding coefficients.
// eps: ancestor-walk truncation (0 = exact; ~1e-8 bounds the per-animal
// error far below practical significance while capping walk depth).
void jt_inbreeding_ml(const int64_t* sire, const int64_t* dam, int64_t n,
                      double eps, double* F) {
    // --- levels: 0 without known parents, else 1 + the parents' highest;
    // `order` holds the animals level by level, ascending codes within one
    std::vector<int64_t> level(static_cast<size_t>(n), 0);
    int64_t top = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t lv = 0;
        if (sire[i] >= 0) lv = level[sire[i]] + 1;
        if (dam[i] >= 0 && level[dam[i]] + 1 > lv) lv = level[dam[i]] + 1;
        level[i] = lv;
        if (lv > top) top = lv;
    }
    std::vector<int64_t> starts(static_cast<size_t>(top) + 2, 0);
    for (int64_t i = 0; i < n; ++i) ++starts[level[i] + 1];
    for (int64_t l = 0; l <= top; ++l) starts[l + 1] += starts[l];
    std::vector<int64_t> order(static_cast<size_t>(n));
    {
        std::vector<int64_t> fill(starts.begin(), starts.end() - 1);
        for (int64_t i = 0; i < n; ++i) order[fill[level[i]]++] = i;
    }

    std::unordered_map<uint64_t, double> fam;
    std::vector<uint64_t> keys;
    std::vector<int64_t> reps;                 // representative animal
    for (size_t b = 0; b + 1 < starts.size(); ++b) {
        int64_t lo = starts[b], hi = starts[b + 1];
        keys.clear();
        reps.clear();
        for (int64_t o = lo; o < hi; ++o) {
            int64_t i = order[o];
            int64_t s = sire[i], d = dam[i];
            if (s < 0 || d < 0) {
                F[i] = 0.0;
                continue;
            }
            uint64_t key = (static_cast<uint64_t>(s + 1) << 32)
                           | static_cast<uint64_t>(d + 1);
            if (fam.find(key) != fam.end()) continue;  // already scheduled
            fam.emplace(key, -2.0);            // placeholder slot
            keys.push_back(key);
            reps.push_back(i);
        }
        const int64_t nu = static_cast<int64_t>(reps.size());
        // persistent per-thread scratch: walk_f leaves L zeroed, so reuse
        // across blocks is safe; reallocating (and re-zeroing) an O(n)
        // buffer per block is quadratic when blocks degenerate to O(1)
        // animals (overlapping-generation pedigrees)
        static thread_local std::vector<double> tl_L;
        static thread_local std::priority_queue<int64_t> tl_heap;
        if (nu <= 64) {
            if (tl_L.size() < static_cast<size_t>(n))
                tl_L.assign(static_cast<size_t>(n), 0.0);
            for (int64_t k = 0; k < nu; ++k) {
                fam.find(keys[k])->second =
                    walk_f(sire, dam, F, reps[k], eps, tl_L, tl_heap);
            }
        } else {
#ifdef _OPENMP
#pragma omp parallel
#endif
            {
                if (tl_L.size() < static_cast<size_t>(n))
                    tl_L.assign(static_cast<size_t>(n), 0.0);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
                for (int64_t k = 0; k < nu; ++k) {
                    double f = walk_f(sire, dam, F, reps[k], eps, tl_L,
                                      tl_heap);
                    // distinct pre-inserted keys: value writes do not
                    // touch the map structure, safe concurrently
                    fam.find(keys[k])->second = f;
                }
            }
        }
        for (int64_t o = lo; o < hi; ++o) {
            int64_t i = order[o];
            int64_t s = sire[i], d = dam[i];
            if (s < 0 || d < 0) continue;
            uint64_t key = (static_cast<uint64_t>(s + 1) << 32)
                           | static_cast<uint64_t>(d + 1);
            F[i] = fam.find(key)->second;
        }
    }
}

}  // extern "C"
