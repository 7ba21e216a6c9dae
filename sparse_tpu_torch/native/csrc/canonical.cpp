// Host-side canonicalization kernels for sparse_tpu_torch's CPU tensors
// (the port's copy of sparse_tpu's canonical.cpp: the same algorithms and
// summation orders, its C symbols prefixed stt_ and its pool namespace
// sttpool, so a process that loads both libraries keeps them apart).
//
// The reference's hot construction loop is an argsort of linearized
// coordinates JIT-compiled through Numba (`_coo/core.py:1294 _sort_indices`,
// `_compressed/compressed.py:25 _from_coo`). Here the same role is played by
// a multi-threaded LSD radix sort over int64 keys returning the permutation,
// exposed to Python through a plain C ABI loaded with ctypes
// (no pybind11 dependency in the image).
//
// Build: sparse_tpu_torch/native/__init__.py (g++ -O3 -std=c++17 -shared -fPIC
// -pthread -ffp-contract=off, with eager.cpp into one library).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

#include "pool.h"

namespace {

constexpr int kRadixBits = 8;
constexpr int kBuckets = 1 << kRadixBits;

int n_threads_for(int64_t n) {
  int hw = sttpool::ThreadPool::max_threads();
  // pool dispatch is ~µs; fan out once each slot has a few hundred k ops
  int64_t per_thread = 1 << 16;
  int64_t want = (n + per_thread - 1) / per_thread;
  if (want < 1) want = 1;
  if (want > hw) want = hw;
  return (int)want;
}

// One LSD radix pass: stable scatter of (key, idx) pairs by byte `shift`.
void radix_pass(const uint64_t* keys_in, const int64_t* idx_in, uint64_t* keys_out,
                int64_t* idx_out, int64_t n, int shift, int n_threads) {
  std::vector<std::vector<int64_t>> hist(n_threads, std::vector<int64_t>(kBuckets, 0));
  int64_t chunk = (n + n_threads - 1) / n_threads;

  sttpool::parallel_for_slots(n_threads, [&](int t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    auto& h = hist[t];
    for (int64_t i = lo; i < hi; ++i) h[(keys_in[i] >> shift) & (kBuckets - 1)]++;
  });

  // exclusive prefix over (bucket, thread)
  int64_t total = 0;
  for (int b = 0; b < kBuckets; ++b) {
    for (int t = 0; t < n_threads; ++t) {
      int64_t c = hist[t][b];
      hist[t][b] = total;
      total += c;
    }
  }

  sttpool::parallel_for_slots(n_threads, [&](int t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    auto& h = hist[t];
    for (int64_t i = lo; i < hi; ++i) {
      int b = (keys_in[i] >> shift) & (kBuckets - 1);
      int64_t pos = h[b]++;
      keys_out[pos] = keys_in[i];
      idx_out[pos] = idx_in[i];
    }
  });
}

}  // namespace

extern "C" {

// argsort of non-negative int64 keys (stable). Writes the permutation into
// `perm` (length n). Returns 0 on success.
int stt_argsort_i64(const int64_t* keys, int64_t n, int64_t* perm) {
  if (n <= 0) return 0;
  uint64_t max_key = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = (uint64_t)keys[i];
    if (k > max_key) max_key = k;
  }
  int passes = 1;
  while (passes < 8 && (max_key >> (uint64_t)(passes * kRadixBits)) != 0) ++passes;

  std::vector<uint64_t> ka(n), kb(n);
  std::vector<int64_t> ia(n), ib(n);
  std::memcpy(ka.data(), keys, n * sizeof(uint64_t));
  for (int64_t i = 0; i < n; ++i) ia[i] = i;

  int n_threads = n_threads_for(n);
  uint64_t* kin = ka.data();
  uint64_t* kout = kb.data();
  int64_t* iin = ia.data();
  int64_t* iout = ib.data();
  for (int p = 0; p < passes; ++p) {
    radix_pass(kin, iin, kout, iout, n, p * kRadixBits, n_threads);
    std::swap(kin, kout);
    std::swap(iin, iout);
  }
  std::memcpy(perm, iin, n * sizeof(int64_t));
  return 0;
}

// Single-pass dedup over SORTED keys: for runs of equal keys, sum the
// corresponding values. Returns the number of unique keys. unique_pos
// receives, for each unique key, the index of its first occurrence in the
// sorted stream (for gathering coordinates); vals_out the per-run sums.
int64_t stt_dedup_sum_sorted_f64(const int64_t* sorted_keys, const double* vals, int64_t n,
                                double* vals_out, int64_t* unique_pos) {
  if (n <= 0) return 0;
  int64_t u = 0;
  unique_pos[0] = 0;
  vals_out[0] = vals[0];
  for (int64_t i = 1; i < n; ++i) {
    if (sorted_keys[i] != sorted_keys[i - 1]) {
      ++u;
      unique_pos[u] = i;
      vals_out[u] = vals[i];
    } else {
      vals_out[u] += vals[i];
    }
  }
  return u + 1;
}

// Fused canonicalization: sort (keys, values) by key, sum duplicate keys.
// Returns the number of unique keys; unique sorted keys land in keys_out,
// summed values in vals_out, and for each unique key the index (into the
// sorted order) of its first occurrence in first_idx (useful to gather
// coordinate columns).
int64_t stt_sort_sum_dedup_f64(const int64_t* keys, const double* vals, int64_t n,
                              int64_t* keys_out, double* vals_out, int64_t* first_idx,
                              int64_t* perm_scratch) {
  if (n <= 0) return 0;
  stt_argsort_i64(keys, n, perm_scratch);
  int64_t u = -1;
  int64_t prev_key = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = perm_scratch[i];
    int64_t k = keys[p];
    if (k != prev_key) {
      ++u;
      keys_out[u] = k;
      vals_out[u] = vals[p];
      first_idx[u] = p;
      prev_key = k;
    } else {
      vals_out[u] += vals[p];
    }
  }
  return u + 1;
}

// CSR compression: given sorted row ids (length nnz) produce indptr
// (length n_rows+1).
int stt_build_indptr(const int64_t* rows, int64_t nnz, int64_t n_rows, int64_t* indptr) {
  std::memset(indptr, 0, (n_rows + 1) * sizeof(int64_t));
  for (int64_t i = 0; i < nnz; ++i) indptr[rows[i] + 1]++;
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] += indptr[r];
  return 0;
}

}  // extern "C"
