// Host-side eager-path kernels for sparse_tpu_torch's CPU tensors (the
// port's copy of sparse_tpu's eager.cpp: the same algorithms and summation
// orders, its C symbols prefixed stt_ and its pool namespace sttpool). Built
// with -ffp-contract=off, so every product and sum rounds on its own, in
// the order written here, on every x86-64 host.
//
// The reference's eager element-wise and SpGEMM paths are Numba-JIT kernels
// (`_umath.py:53 _match_arrays` two-pointer join; `_common.py:543-717`
// Gustavson SpGEMM borrowed from scipy's csr.h). Here the same roles are
// C++ single-pass kernels over the canonical sorted-COO / CSR buffers,
// exposed through a plain C ABI for ctypes (no pybind11 in the image).
//
// All key arrays are int64 linearized coordinates, SORTED UNIQUE (the
// package's canonical invariant). Value kernels are emitted for f64/f32
// via macro; other dtypes stay on the caller's torch ops.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "pool.h"

namespace {

inline bool is_pos_zero64(double v) {
  uint64_t b;
  std::memcpy(&b, &v, sizeof(b));
  return b == 0;
}
inline bool is_pos_zero32(float v) {
  uint32_t b;
  std::memcpy(&b, &v, sizeof(b));
  return b == 0;
}

}  // namespace

extern "C" {

// Union join of two sorted unique int64 key streams. For each union key,
// writes the source position in a (else -1) and in b (else -1).
// Returns the union size. Output buffers must hold na+nb entries.
int64_t stt_union_join_i64(const int64_t* ka, int64_t na, const int64_t* kb, int64_t nb,
                          int64_t* k_out, int64_t* ia_out, int64_t* ib_out) {
  int64_t i = 0, j = 0, u = 0;
  while (i < na && j < nb) {
    int64_t a = ka[i], b = kb[j];
    if (a < b) {
      k_out[u] = a;
      ia_out[u] = i++;
      ib_out[u] = -1;
    } else if (b < a) {
      k_out[u] = b;
      ia_out[u] = -1;
      ib_out[u] = j++;
    } else {
      k_out[u] = a;
      ia_out[u] = i++;
      ib_out[u] = j++;
    }
    ++u;
  }
  while (i < na) {
    k_out[u] = ka[i];
    ia_out[u] = i++;
    ib_out[u] = -1;
    ++u;
  }
  while (j < nb) {
    k_out[u] = kb[j];
    ia_out[u] = -1;
    ib_out[u] = j++;
    ++u;
  }
  return u;
}

// Union join that also materializes both operands' value streams at the
// union coordinates (stored value or the operand's fill) in the same pass —
// feeds the generic eager elemwise path for arbitrary ufuncs.
#define UNION_JOIN_VALS(NAME, T)                                                            \
  int64_t NAME(const int64_t* ka, const T* va, int64_t na, T fa, const int64_t* kb,        \
               const T* vb, int64_t nb, T fb, int64_t* k_out, T* va_out, T* vb_out) {      \
    int64_t i = 0, j = 0, u = 0;                                                           \
    while (i < na && j < nb) {                                                             \
      int64_t a = ka[i], b = kb[j];                                                        \
      if (a < b) {                                                                         \
        k_out[u] = a;                                                                      \
        va_out[u] = va[i++];                                                               \
        vb_out[u] = fb;                                                                    \
      } else if (b < a) {                                                                  \
        k_out[u] = b;                                                                      \
        va_out[u] = fa;                                                                    \
        vb_out[u] = vb[j++];                                                               \
      } else {                                                                             \
        k_out[u] = a;                                                                      \
        va_out[u] = va[i++];                                                               \
        vb_out[u] = vb[j++];                                                               \
      }                                                                                    \
      ++u;                                                                                 \
    }                                                                                      \
    for (; i < na; ++i, ++u) {                                                             \
      k_out[u] = ka[i];                                                                    \
      va_out[u] = va[i];                                                                   \
      vb_out[u] = fb;                                                                      \
    }                                                                                      \
    for (; j < nb; ++j, ++u) {                                                             \
      k_out[u] = kb[j];                                                                    \
      va_out[u] = fa;                                                                      \
      vb_out[u] = vb[j];                                                                   \
    }                                                                                      \
    return u;                                                                              \
  }

UNION_JOIN_VALS(stt_union_join_vals_f64, double)
UNION_JOIN_VALS(stt_union_join_vals_f32, float)

// Fused union merges for {add, sub, mul} with both fill values bitwise +0.
// Values are computed with the exact IEEE semantics of evaluating the ufunc
// at the union (e.g. a-only multiply is va*0.0 -> NaN survives for va=inf),
// and results bitwise-equal to +0.0 are pruned (the package's `equivalent`
// rule: -0.0 is kept, NaN is kept).
#define FUSED_MERGE(NAME, T, ISZERO, COMBINE, A_ONLY, B_ONLY)                              \
  int64_t NAME(const int64_t* ka, const T* va, int64_t na, const int64_t* kb, const T* vb, \
               int64_t nb, int64_t* k_out, T* v_out) {                                     \
    int64_t i = 0, j = 0, u = 0;                                                           \
    while (i < na && j < nb) {                                                             \
      int64_t a = ka[i], b = kb[j];                                                        \
      T v;                                                                                 \
      int64_t k;                                                                           \
      if (a < b) {                                                                         \
        v = A_ONLY(va[i]);                                                                 \
        k = a;                                                                             \
        ++i;                                                                               \
      } else if (b < a) {                                                                  \
        v = B_ONLY(vb[j]);                                                                 \
        k = b;                                                                             \
        ++j;                                                                               \
      } else {                                                                             \
        v = COMBINE(va[i], vb[j]);                                                         \
        k = a;                                                                             \
        ++i;                                                                               \
        ++j;                                                                               \
      }                                                                                    \
      if (!ISZERO(v)) {                                                                    \
        k_out[u] = k;                                                                      \
        v_out[u] = v;                                                                      \
        ++u;                                                                               \
      }                                                                                    \
    }                                                                                      \
    for (; i < na; ++i) {                                                                  \
      T v = A_ONLY(va[i]);                                                                 \
      if (!ISZERO(v)) {                                                                    \
        k_out[u] = ka[i];                                                                  \
        v_out[u] = v;                                                                      \
        ++u;                                                                               \
      }                                                                                    \
    }                                                                                      \
    for (; j < nb; ++j) {                                                                  \
      T v = B_ONLY(vb[j]);                                                                 \
      if (!ISZERO(v)) {                                                                    \
        k_out[u] = kb[j];                                                                  \
        v_out[u] = v;                                                                      \
        ++u;                                                                               \
      }                                                                                    \
    }                                                                                      \
    return u;                                                                              \
  }

#define ADD_C(x, y) ((x) + (y))
#define ADD_A(x) ((x) + 0.0)
#define ADD_B(y) (0.0 + (y))
#define SUB_C(x, y) ((x) - (y))
#define SUB_A(x) ((x) - 0.0)
#define SUB_B(y) (0.0 - (y))
#define MUL_C(x, y) ((x) * (y))
#define MUL_A(x) ((x) * 0.0)
#define MUL_B(y) (0.0 * (y))

FUSED_MERGE(stt_add_join_f64, double, is_pos_zero64, ADD_C, ADD_A, ADD_B)
FUSED_MERGE(stt_sub_join_f64, double, is_pos_zero64, SUB_C, SUB_A, SUB_B)
FUSED_MERGE(stt_mul_join_f64, double, is_pos_zero64, MUL_C, MUL_A, MUL_B)

#define ADD_Cf(x, y) ((x) + (y))
#define ADD_Af(x) ((x) + 0.0f)
#define ADD_Bf(y) (0.0f + (y))
#define SUB_Cf(x, y) ((x) - (y))
#define SUB_Af(x) ((x) - 0.0f)
#define SUB_Bf(y) (0.0f - (y))
#define MUL_Cf(x, y) ((x) * (y))
#define MUL_Af(x) ((x) * 0.0f)
#define MUL_Bf(y) (0.0f * (y))

FUSED_MERGE(stt_add_join_f32, float, is_pos_zero32, ADD_Cf, ADD_Af, ADD_Bf)
FUSED_MERGE(stt_sub_join_f32, float, is_pos_zero32, SUB_Cf, SUB_Af, SUB_Bf)
FUSED_MERGE(stt_mul_join_f32, float, is_pos_zero32, MUL_Cf, MUL_Af, MUL_Bf)

// Fused weighted bincount: sums[key] += w and counts[key] += 1 in one pass
// (role of the two np.bincount calls in the add-reduction fast path).
#define BINCOUNT_SUM(NAME, T)                                                                \
  int NAME(const int64_t* keys, const T* w, int64_t n, int64_t n_bins, T* sums,              \
           int64_t* counts) {                                                                \
    for (int64_t b = 0; b < n_bins; ++b) {                                                   \
      sums[b] = T(0);                                                                        \
      counts[b] = 0;                                                                         \
    }                                                                                        \
    for (int64_t i = 0; i < n; ++i) {                                                        \
      sums[keys[i]] += w[i];                                                                 \
      ++counts[keys[i]];                                                                     \
    }                                                                                        \
    return 0;                                                                                \
  }

BINCOUNT_SUM(stt_bincount_sum_f64, double)
BINCOUNT_SUM(stt_bincount_sum_f32, float)

// Sums-only weighted bincount fused with nonzero compaction — the add-
// reduction with zero fill needs neither counts nor a separate prune pass:
// rows whose sum is (+/-)0 are exactly the rows the pruned COO result drops.
// Emits (bin index, sum) pairs for nonzero sums; returns the pair count.
#define BINCOUNT_SUM_COMPACT(NAME, T, KT)                                                    \
  int64_t NAME(const KT* keys, const T* w, int64_t n, int64_t n_bins, T* sums,              \
               int64_t* out_idx, T* out_vals) {                                              \
    int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), n >> 17);              \
    if (t >= 2 && n_bins <= (int64_t)1 << 22) {                                              \
      /* per-slot private bins, merged serially (bins are small).         */                 \
      /* Allocated on the CALLING thread: an exception escaping a pool    */                 \
      /* worker's std::function would std::terminate the process.        */                  \
      std::vector<std::unique_ptr<T[]>> priv(t - 1);                                         \
      for (int i = 0; i < t - 1; ++i) priv[i].reset(new T[n_bins]);                          \
      int64_t chunk = (n + t - 1) / t;                                                       \
      sttpool::parallel_for_slots(t, [&](int i) {                                             \
        T* bins = (i == 0) ? sums : priv[i - 1].get();                                       \
        for (int64_t b = 0; b < n_bins; ++b) bins[b] = T(0);                                 \
        int64_t lo = i * chunk, hi = std::min<int64_t>(n, lo + chunk);                       \
        for (int64_t p = lo; p < hi; ++p) bins[keys[p]] += w[p];                             \
      });                                                                                    \
      for (int i = 1; i < t; ++i) {                                                          \
        const T* b2 = priv[i - 1].get();                                                     \
        for (int64_t b = 0; b < n_bins; ++b) sums[b] += b2[b];                               \
      }                                                                                      \
    } else {                                                                                 \
      for (int64_t b = 0; b < n_bins; ++b) sums[b] = T(0);                                   \
      for (int64_t i = 0; i < n; ++i) sums[keys[i]] += w[i];                                 \
    }                                                                                        \
    int64_t m = 0;                                                                           \
    for (int64_t b = 0; b < n_bins; ++b) {                                                   \
      T v = sums[b];                                                                         \
      if (v != T(0)) {                                                                       \
        out_idx[m] = b;                                                                      \
        out_vals[m] = v;                                                                     \
        ++m;                                                                                 \
      }                                                                                      \
    }                                                                                        \
    return m;                                                                                \
  }

BINCOUNT_SUM_COMPACT(stt_bincount_sum_compact_f64, double, int64_t)
BINCOUNT_SUM_COMPACT(stt_bincount_sum_compact_f32, float, int64_t)
BINCOUNT_SUM_COMPACT(stt_bincount_sum_compact_f64_i32, double, int32_t)
BINCOUNT_SUM_COMPACT(stt_bincount_sum_compact_f32_i32, float, int32_t)

// Compact add-reduce over SORTED keys.  bincount_sum_compact on sorted
// keys is FP-add-LATENCY-bound (consecutive entries hit the same bin, so
// every add store-forwards into the next: ~5 cyc/entry); here each run is
// summed with 4 accumulators (the csr_spmv trick) and there is no n_bins
// array to zero or compaction scan — one pass, ~3x at 400k entries.
// Keeps bincount_sum_compact's prune rule (drop sums == 0).
}  // extern "C"

namespace {

template <typename T, typename KT>
int64_t sorted_reduce_range(const KT* keys, const T* w, int64_t i, int64_t n, int64_t* out_idx,
                            T* out_vals) {
  int64_t m = 0;
  while (i < n) {
    KT k = keys[i];
    int64_t j = i + 1;
    while (j < n && keys[j] == k) ++j;
    T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
    int64_t p = i;
    for (; p + 4 <= j; p += 4) {
      a0 += w[p];
      a1 += w[p + 1];
      a2 += w[p + 2];
      a3 += w[p + 3];
    }
    for (; p < j; ++p) a0 += w[p];
    T v = (a0 + a1) + (a2 + a3);
    if (v != T(0)) {
      out_idx[m] = (int64_t)k;
      out_vals[m] = v;
      ++m;
    }
    i = j;
  }
  return m;
}

}  // namespace

extern "C" {

// Threaded over run-boundary-aligned chunks: each slot reduces into its
// own scratch region, then the (small) outputs are compacted serially.
#define SORTED_REDUCE_COMPACT(NAME, T, KT)                                                   \
  int64_t NAME(const KT* keys, const T* w, int64_t n, int64_t* out_idx, T* out_vals) {       \
    int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), n >> 17);              \
    if (t < 2) return sorted_reduce_range<T, KT>(keys, w, 0, n, out_idx, out_vals);          \
    std::vector<int64_t> s(t + 1, 0);                                                        \
    for (int i = 1; i < t; ++i) {                                                            \
      int64_t p = n * i / t;                                                                 \
      while (p < n && p > 0 && keys[p] == keys[p - 1]) ++p; /* advance to a run boundary */  \
      s[i] = std::max(p, s[i - 1]);                                                          \
    }                                                                                        \
    s[t] = n;                                                                                \
    std::vector<std::unique_ptr<int64_t[]>> idx_buf(t);                                      \
    std::vector<std::unique_ptr<T[]>> val_buf(t);                                            \
    std::vector<int64_t> cnt(t, 0);                                                          \
    /* scratch allocated on the CALLING thread: an exception escaping a  */                  \
    /* pool worker's std::function would std::terminate the process     */                   \
    for (int i = 0; i < t; ++i) {                                                            \
      int64_t len = s[i + 1] - s[i];                                                         \
      if (len <= 0) continue;                                                                \
      idx_buf[i].reset(new int64_t[len]); /* uninitialized POD */                            \
      val_buf[i].reset(new T[len]);                                                          \
    }                                                                                        \
    sttpool::parallel_for_slots(t, [&](int i) {                                               \
      int64_t len = s[i + 1] - s[i];                                                         \
      if (len <= 0) return;                                                                  \
      cnt[i] = sorted_reduce_range<T, KT>(keys, w, s[i], s[i + 1], idx_buf[i].get(),         \
                                          val_buf[i].get());                                 \
    });                                                                                      \
    int64_t m = 0;                                                                           \
    for (int i = 0; i < t; ++i) {                                                            \
      if (cnt[i]) {                                                                          \
        std::memcpy(out_idx + m, idx_buf[i].get(), cnt[i] * sizeof(int64_t));                \
        std::memcpy(out_vals + m, val_buf[i].get(), cnt[i] * sizeof(T));                     \
        m += cnt[i];                                                                         \
      }                                                                                      \
    }                                                                                        \
    return m;                                                                                \
  }

SORTED_REDUCE_COMPACT(stt_sorted_reduce_compact_f64, double, int64_t)
SORTED_REDUCE_COMPACT(stt_sorted_reduce_compact_f32, float, int64_t)
SORTED_REDUCE_COMPACT(stt_sorted_reduce_compact_f64_i32, double, int32_t)
SORTED_REDUCE_COMPACT(stt_sorted_reduce_compact_f32_i32, float, int32_t)

// One-pass grouped add-reduce over SORTED keys (the canonical leading-axis
// case): emits each group's key, sum, and size. Replaces the
// flatnonzero(diff) + reduceat + gather trio with a single stream.
// Returns the number of groups.
#define ROW_REDUCE_SORTED(NAME, T)                                                           \
  int64_t NAME(const int64_t* keys, const T* w, int64_t n, int64_t* keys_out, T* sums,       \
               int64_t* counts) {                                                            \
    if (!n) return 0;                                                                        \
    int64_t g = 0;                                                                           \
    int64_t k = keys[0];                                                                     \
    T acc = w[0];                                                                            \
    int64_t cnt = 1;                                                                         \
    for (int64_t i = 1; i < n; ++i) {                                                        \
      if (keys[i] == k) {                                                                    \
        acc += w[i];                                                                         \
        ++cnt;                                                                               \
      } else {                                                                               \
        keys_out[g] = k;                                                                     \
        sums[g] = acc;                                                                       \
        counts[g] = cnt;                                                                     \
        ++g;                                                                                 \
        k = keys[i];                                                                         \
        acc = w[i];                                                                          \
        cnt = 1;                                                                             \
      }                                                                                      \
    }                                                                                        \
    keys_out[g] = k;                                                                         \
    sums[g] = acc;                                                                           \
    counts[g] = cnt;                                                                         \
    return g + 1;                                                                            \
  }

ROW_REDUCE_SORTED(stt_row_reduce_sorted_f64, double)
ROW_REDUCE_SORTED(stt_row_reduce_sorted_f32, float)

// Unravel linearized row-major keys into an (ndim, n) coordinate matrix,
// threaded over entries (role of np.unravel_index in the eager paths).
int stt_unravel_i64(const int64_t* keys, int64_t n, const int64_t* shape, int64_t ndim,
                   int64_t* coords_out) {
  // pool dispatch costs a few µs; only fan out when each slot gets real work
  int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), n >> 16);
  if (t < 2) t = 1;
  auto work = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      int64_t k = keys[i];
      for (int64_t d = ndim - 1; d > 0; --d) {
        int64_t s = shape[d];
        coords_out[d * n + i] = k % s;
        k /= s;
      }
      coords_out[i] = k;
    }
  };
  if (t <= 1) {
    work(0, n);
    return 0;
  }
  int64_t chunk = (n + t - 1) / t;
  sttpool::parallel_for_slots(t, [&](int i) {
    work(i * chunk, std::min<int64_t>(n, (i + 1) * chunk));
  });
  return 0;
}

}  // extern "C"

extern "C" {

// 2-D variants of the fused merges: consume (row, col) coordinate pairs
// directly (keys formed on the fly) and emit output coordinates in the same
// pass — no separate linearize/unravel passes.
#define FUSED_MERGE_2D(NAME, T, I, ISZERO, COMBINE, A_ONLY, B_ONLY)                         \
  int64_t NAME(const I* ra, const I* ca, const T* va, int64_t na, const I* rb, const I* cb, \
               const T* vb, int64_t nb, int64_t k_cols, I* r_out, I* c_out, T* v_out) {     \
    int64_t i = 0, j = 0, u = 0;                                                            \
    int64_t ka = (i < na) ? (int64_t)ra[0] * k_cols + ca[0] : 0;                            \
    int64_t kb = (j < nb) ? (int64_t)rb[0] * k_cols + cb[0] : 0;                            \
    while (i < na && j < nb) {                                                              \
      T v;                                                                                  \
      I ro, co;                                                                             \
      if (ka < kb) {                                                                        \
        v = A_ONLY(va[i]);                                                                  \
        ro = ra[i];                                                                         \
        co = ca[i];                                                                         \
        ++i;                                                                                \
        if (i < na) ka = (int64_t)ra[i] * k_cols + ca[i];                                   \
      } else if (kb < ka) {                                                                 \
        v = B_ONLY(vb[j]);                                                                  \
        ro = rb[j];                                                                         \
        co = cb[j];                                                                         \
        ++j;                                                                                \
        if (j < nb) kb = (int64_t)rb[j] * k_cols + cb[j];                                   \
      } else {                                                                              \
        v = COMBINE(va[i], vb[j]);                                                          \
        ro = ra[i];                                                                         \
        co = ca[i];                                                                         \
        ++i;                                                                                \
        ++j;                                                                                \
        if (i < na) ka = (int64_t)ra[i] * k_cols + ca[i];                                   \
        if (j < nb) kb = (int64_t)rb[j] * k_cols + cb[j];                                   \
      }                                                                                     \
      if (!ISZERO(v)) {                                                                     \
        r_out[u] = ro;                                                                      \
        c_out[u] = co;                                                                      \
        v_out[u] = v;                                                                       \
        ++u;                                                                                \
      }                                                                                     \
    }                                                                                       \
    for (; i < na; ++i) {                                                                   \
      T v = A_ONLY(va[i]);                                                                  \
      if (!ISZERO(v)) {                                                                     \
        r_out[u] = ra[i];                                                                   \
        c_out[u] = ca[i];                                                                   \
        v_out[u] = v;                                                                       \
        ++u;                                                                                \
      }                                                                                     \
    }                                                                                       \
    for (; j < nb; ++j) {                                                                   \
      T v = B_ONLY(vb[j]);                                                                  \
      if (!ISZERO(v)) {                                                                     \
        r_out[u] = rb[j];                                                                   \
        c_out[u] = cb[j];                                                                   \
        v_out[u] = v;                                                                       \
        ++u;                                                                                \
      }                                                                                     \
    }                                                                                       \
    return u;                                                                               \
  }

FUSED_MERGE_2D(stt_add_join2d_f64_i32, double, int32_t, is_pos_zero64, ADD_C, ADD_A, ADD_B)
FUSED_MERGE_2D(stt_sub_join2d_f64_i32, double, int32_t, is_pos_zero64, SUB_C, SUB_A, SUB_B)
FUSED_MERGE_2D(stt_mul_join2d_f64_i32, double, int32_t, is_pos_zero64, MUL_C, MUL_A, MUL_B)
FUSED_MERGE_2D(stt_add_join2d_f64_i64, double, int64_t, is_pos_zero64, ADD_C, ADD_A, ADD_B)
FUSED_MERGE_2D(stt_sub_join2d_f64_i64, double, int64_t, is_pos_zero64, SUB_C, SUB_A, SUB_B)
FUSED_MERGE_2D(stt_mul_join2d_f64_i64, double, int64_t, is_pos_zero64, MUL_C, MUL_A, MUL_B)
FUSED_MERGE_2D(stt_add_join2d_f32_i32, float, int32_t, is_pos_zero32, ADD_Cf, ADD_Af, ADD_Bf)
FUSED_MERGE_2D(stt_sub_join2d_f32_i32, float, int32_t, is_pos_zero32, SUB_Cf, SUB_Af, SUB_Bf)
FUSED_MERGE_2D(stt_mul_join2d_f32_i32, float, int32_t, is_pos_zero32, MUL_Cf, MUL_Af, MUL_Bf)
FUSED_MERGE_2D(stt_add_join2d_f32_i64, float, int64_t, is_pos_zero32, ADD_Cf, ADD_Af, ADD_Bf)
FUSED_MERGE_2D(stt_sub_join2d_f32_i64, float, int64_t, is_pos_zero32, SUB_Cf, SUB_Af, SUB_Bf)
FUSED_MERGE_2D(stt_mul_join2d_f32_i64, float, int64_t, is_pos_zero32, MUL_Cf, MUL_Af, MUL_Bf)

// integer data (exact; prune is plain == 0; identities stay integral)
#define IS_ZERO_INT(v) ((v) == 0)
#define IDENT(x) (x)
#define NEG(y) (-(y))
#define ZERO_OF(x) ((x) * 0)
FUSED_MERGE_2D(stt_add_join2d_s64_i32, int64_t, int32_t, IS_ZERO_INT, ADD_C, IDENT, IDENT)
FUSED_MERGE_2D(stt_sub_join2d_s64_i32, int64_t, int32_t, IS_ZERO_INT, SUB_C, IDENT, NEG)
FUSED_MERGE_2D(stt_mul_join2d_s64_i32, int64_t, int32_t, IS_ZERO_INT, MUL_C, ZERO_OF, ZERO_OF)
FUSED_MERGE_2D(stt_add_join2d_s64_i64, int64_t, int64_t, IS_ZERO_INT, ADD_C, IDENT, IDENT)
FUSED_MERGE_2D(stt_sub_join2d_s64_i64, int64_t, int64_t, IS_ZERO_INT, SUB_C, IDENT, NEG)
FUSED_MERGE_2D(stt_mul_join2d_s64_i64, int64_t, int64_t, IS_ZERO_INT, MUL_C, ZERO_OF, ZERO_OF)

}  // extern "C"

// ---------------------------------------------------------------------------
// SpGEMM: CSR x CSR (Gustavson, two-phase like scipy csr.h / reference
// `_csr_csr_count_nnz` + `_dot_csr_csr_type`), rows parallelized.
// ---------------------------------------------------------------------------

namespace {

void spgemm_symbolic_range(const int64_t* pa, const int64_t* ja, const int64_t* pb,
                           const int64_t* jb, int64_t n_cols, int64_t r0, int64_t r1,
                           int64_t* row_nnz) {
  std::vector<int64_t> mark(n_cols, -1);
  for (int64_t r = r0; r < r1; ++r) {
    int64_t cnt = 0;
    for (int64_t p = pa[r]; p < pa[r + 1]; ++p) {
      int64_t k = ja[p];
      for (int64_t q = pb[k]; q < pb[k + 1]; ++q) {
        int64_t c = jb[q];
        if (mark[c] != r) {
          mark[c] = r;
          ++cnt;
        }
      }
    }
    row_nnz[r] = cnt;
  }
}

template <typename T>
void spgemm_numeric_range(const int64_t* pa, const int64_t* ja, const T* va, const int64_t* pb,
                          const int64_t* jb, const T* vb, int64_t n_cols, int64_t r0, int64_t r1,
                          const int64_t* pc, int64_t* jc, T* vc) {
  std::vector<T> sums(n_cols, T(0));
  std::vector<int64_t> mark(n_cols, -1);
  std::vector<int64_t> touched;
  touched.reserve(256);
  for (int64_t r = r0; r < r1; ++r) {
    touched.clear();
    for (int64_t p = pa[r]; p < pa[r + 1]; ++p) {
      int64_t k = ja[p];
      T av = va[p];
      for (int64_t q = pb[k]; q < pb[k + 1]; ++q) {
        int64_t c = jb[q];
        if (mark[c] != r) {
          mark[c] = r;
          sums[c] = av * vb[q];
          touched.push_back(c);
        } else {
          sums[c] += av * vb[q];
        }
      }
    }
    std::sort(touched.begin(), touched.end());
    int64_t out = pc[r];
    for (int64_t c : touched) {
      jc[out] = c;
      vc[out] = sums[c];
      ++out;
    }
  }
}

int spgemm_threads(int64_t n_rows, int64_t nnz_a) {
  int hw = sttpool::ThreadPool::max_threads();
  if (nnz_a < (1 << 14) || n_rows < 2) return 1;
  return (int)std::min<int64_t>(hw, n_rows);
}

// nnz-balanced row split points by indptr_a
std::vector<int64_t> row_splits(const int64_t* pa, int64_t n_rows, int t) {
  std::vector<int64_t> s(t + 1, 0);
  int64_t total = pa[n_rows];
  for (int i = 1; i < t; ++i) {
    int64_t target = total * i / t;
    s[i] = std::upper_bound(pa, pa + n_rows + 1, target) - pa - 1;
    if (s[i] < s[i - 1]) s[i] = s[i - 1];
  }
  s[t] = n_rows;
  return s;
}

}  // namespace

extern "C" {

// Phase 1: per-row output nnz into row_nnz (length n_rows); caller does the
// prefix sum. Returns 0.
int stt_spgemm_symbolic(const int64_t* pa, const int64_t* ja, int64_t n_rows, const int64_t* pb,
                       const int64_t* jb, int64_t n_cols, int64_t* row_nnz) {
  int t = spgemm_threads(n_rows, pa[n_rows]);
  if (t <= 1) {
    spgemm_symbolic_range(pa, ja, pb, jb, n_cols, 0, n_rows, row_nnz);
    return 0;
  }
  auto s = row_splits(pa, n_rows, t);
  sttpool::parallel_for_slots(t, [&](int i) {
    spgemm_symbolic_range(pa, ja, pb, jb, n_cols, s[i], s[i + 1], row_nnz);
  });
  return 0;
}

#define SPGEMM_NUMERIC(NAME, T)                                                               \
  int NAME(const int64_t* pa, const int64_t* ja, const T* va, int64_t n_rows,                 \
           const int64_t* pb, const int64_t* jb, const T* vb, int64_t n_cols,                 \
           const int64_t* pc, int64_t* jc, T* vc) {                                           \
    int t = spgemm_threads(n_rows, pa[n_rows]);                                               \
    if (t <= 1) {                                                                             \
      spgemm_numeric_range<T>(pa, ja, va, pb, jb, vb, n_cols, 0, n_rows, pc, jc, vc);         \
      return 0;                                                                               \
    }                                                                                         \
    auto s = row_splits(pa, n_rows, t);                                                       \
    sttpool::parallel_for_slots(t, [&](int i) {                                                \
      spgemm_numeric_range<T>(pa, ja, va, pb, jb, vb, n_cols, s[i], s[i + 1], pc, jc, vc);    \
    });                                                                                       \
    return 0;                                                                                 \
  }

SPGEMM_NUMERIC(stt_spgemm_numeric_f64, double)
SPGEMM_NUMERIC(stt_spgemm_numeric_f32, float)

// Per-row PRODUCT-count offsets (the ESC upper bound on output nnz):
// pc_ub[r+1]-pc_ub[r] = sum over A row r's entries of B's row population.
// O(nnz_a); lets small workloads skip the symbolic phase entirely.
int stt_spgemm_ubcount(const int64_t* pa, const int64_t* ja, int64_t n_rows, const int64_t* pb,
                      int64_t* pc_ub) {
  pc_ub[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t ub = 0;
    for (int64_t p = pa[r]; p < pa[r + 1]; ++p) {
      int64_t k = ja[p];
      ub += pb[k + 1] - pb[k];
    }
    pc_ub[r + 1] = pc_ub[r] + ub;
  }
  return 0;
}

// indptr -> row ids (np.repeat(arange, diff(indptr))), threaded over rows
// (role of reference `_compressed/convert.py:82 uncompress_dimension`).
int stt_uncompress_indptr(const int64_t* pc, int64_t n_rows, int64_t* ic) {
  int64_t nnz = pc[n_rows];
  int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), nnz >> 17);
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r)
      for (int64_t p = pc[r]; p < pc[r + 1]; ++p) ic[p] = r;
  };
  if (t < 2) {
    work(0, n_rows);
    return 0;
  }
  std::vector<int64_t> s(t + 1, 0);
  for (int i = 1; i < t; ++i) {
    int64_t target = nnz * i / t;
    s[i] = std::upper_bound(pc, pc + n_rows + 1, target) - pc - 1;
    if (s[i] < s[i - 1]) s[i] = s[i - 1];
  }
  s[t] = n_rows;
  sttpool::parallel_for_slots(t, [&](int i) { work(s[i], s[i + 1]); });
  return 0;
}

// One-phase Gustavson: rows write into product-bound slots (pc_ub), then a
// sequential copy-down compacts jc/vc in place and emits the exact indptr.
// Wins when the product bound is close to nnz (skips one full pass over
// both operands); the wrapper falls back to two-phase when the bound blows
// up (dense-ish rows).
#define SPGEMM_ONEPHASE(NAME, T)                                                              \
  int NAME(const int64_t* pa, const int64_t* ja, const T* va, int64_t n_rows,                 \
           const int64_t* pb, const int64_t* jb, const T* vb, int64_t n_cols,                 \
           const int64_t* pc_ub, int64_t* pc_out, int64_t* jc, T* vc) {                       \
    std::vector<int64_t> row_nnz(n_rows, 0);                                                  \
    int t = spgemm_threads(n_rows, pa[n_rows]);                                               \
    auto work = [&](int64_t r0, int64_t r1) {                                                 \
      /* interleaved mark+sum: one cache line per column touch, not two */   \
      struct Slot {                                                                           \
        int64_t mark;                                                                         \
        T sum;                                                                                \
      };                                                                                      \
      std::vector<Slot> acc(n_cols, Slot{-1, T(0)});                                          \
      std::vector<int64_t> touched;                                                           \
      touched.reserve(256);                                                                   \
      for (int64_t r = r0; r < r1; ++r) {                                                     \
        touched.clear();                                                                      \
        for (int64_t p = pa[r]; p < pa[r + 1]; ++p) {                                         \
          int64_t k = ja[p];                                                                  \
          T av = va[p];                                                                       \
          for (int64_t q = pb[k]; q < pb[k + 1]; ++q) {                                       \
            int64_t c = jb[q];                                                                \
            Slot& s = acc[c];                                                                 \
            if (s.mark != r) {                                                                \
              s.mark = r;                                                                     \
              s.sum = av * vb[q];                                                             \
              touched.push_back(c);                                                           \
            } else {                                                                          \
              s.sum += av * vb[q];                                                            \
            }                                                                                 \
          }                                                                                   \
        }                                                                                     \
        std::sort(touched.begin(), touched.end());                                           \
        int64_t out = pc_ub[r];                                                               \
        for (int64_t c : touched) {                                                           \
          jc[out] = c;                                                                        \
          vc[out] = acc[c].sum;                                                               \
          ++out;                                                                              \
        }                                                                                     \
        row_nnz[r] = out - pc_ub[r];                                                          \
      }                                                                                       \
    };                                                                                        \
    if (t <= 1) {                                                                             \
      work(0, n_rows);                                                                        \
    } else {                                                                                  \
      auto s = row_splits(pa, n_rows, t);                                                     \
      sttpool::parallel_for_slots(t, [&](int i) { work(s[i], s[i + 1]); });                    \
    }                                                                                         \
    int64_t dst = 0;                                                                          \
    pc_out[0] = 0;                                                                            \
    for (int64_t r = 0; r < n_rows; ++r) {                                                    \
      int64_t src = pc_ub[r], cnt = row_nnz[r];                                               \
      if (dst != src && cnt) {                                                                \
        std::memmove(jc + dst, jc + src, cnt * sizeof(int64_t));                              \
        std::memmove(vc + dst, vc + src, cnt * sizeof(T));                                    \
      }                                                                                       \
      dst += cnt;                                                                             \
      pc_out[r + 1] = dst;                                                                    \
    }                                                                                         \
    return 0;                                                                                 \
  }

SPGEMM_ONEPHASE(stt_spgemm_onephase_f64, double)
SPGEMM_ONEPHASE(stt_spgemm_onephase_f32, float)

// ---------------------------------------------------------------------------
// Sparse x dense (SpMV / SpMM) — the role of the reference's
// `_dot_csr_ndarray_type` / `_dot_csc_ndarray_type` Numba kernels
// (`_common.py:720-905`). CSR kernels thread over nnz-balanced row ranges;
// CSC kernels are a single scatter pass (output-race-free only serially).
// Dense operands are row-major contiguous.
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {

// generic row-threaded runner over an [r0, r1) range function, splits
// nnz-balanced by indptr
template <typename P, typename F>
void run_rows(const P* pa, int64_t n_rows, int64_t min_per_thread_shift, int64_t work_scale,
              F&& body) {
  // pool dispatch is ~µs (persistent workers), so the fan-out threshold is
  // ~4x lower than the old per-call std::thread spawn allowed
  int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(),
                                 ((int64_t)pa[n_rows] * work_scale) >> (min_per_thread_shift - 2));
  if (t < 2 || n_rows < 2) {
    body(0, n_rows);
    return;
  }
  std::vector<int64_t> s(t + 1, 0);
  int64_t total = pa[n_rows];
  for (int i = 1; i < t; ++i) {
    int64_t target = total * i / t;
    s[i] = std::upper_bound(pa, pa + n_rows + 1, (P)target) - pa - 1;
    if (s[i] < s[i - 1]) s[i] = s[i - 1];
  }
  s[t] = n_rows;
  sttpool::parallel_for_slots(t, [&](int i) { body(s[i], s[i + 1]); });
}

template <typename T, typename I>
void csr_spmv(const I* pa, const I* ja, const T* va, int64_t n_rows, const T* x, T* out) {
  // 4 accumulators break the FP-add dependency chain: with x resident in
  // cache the plain  acc += v*x[j]  loop is add-LATENCY-bound (~4 cyc per
  // nnz), not bandwidth-bound — measured 0.55 -> ~0.2 ms at 400k nnz.
  // This reassociates each row's sum, so low-order bits differ from a
  // sequential (scipy-order) accumulation: parity checks use tolerances.
  run_rows(pa, n_rows, 17, 1, [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      int64_t p = pa[r], e = pa[r + 1];
      T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
      for (; p + 4 <= e; p += 4) {
        a0 += va[p] * x[ja[p]];
        a1 += va[p + 1] * x[ja[p + 1]];
        a2 += va[p + 2] * x[ja[p + 2]];
        a3 += va[p + 3] * x[ja[p + 3]];
      }
      for (; p < e; ++p) a0 += va[p] * x[ja[p]];
      out[r] = (a0 + a1) + (a2 + a3);
    }
  });
}

template <typename T, typename I>
void csr_spmm(const I* pa, const I* ja, const T* va, int64_t n_rows, const T* b,
              int64_t n_cols_out, T* out) {
  run_rows(pa, n_rows, 19, n_cols_out, [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      T* orow = out + r * n_cols_out;
      for (int64_t c = 0; c < n_cols_out; ++c) orow[c] = T(0);
      for (int64_t p = pa[r]; p < pa[r + 1]; ++p) {
        T v = va[p];
        const T* brow = b + (int64_t)ja[p] * n_cols_out;
        for (int64_t c = 0; c < n_cols_out; ++c) orow[c] += v * brow[c];
      }
    }
  });
}

template <typename T, typename I>
void csc_spmv(const I* pc, const I* ia, const T* va, int64_t n_cols, int64_t n_rows, const T* x,
              T* out) {
  std::memset(out, 0, n_rows * sizeof(T));  // +0.0 is all-zero bits
  for (int64_t j = 0; j < n_cols; ++j) {
    I p = pc[j], e = pc[j + 1];
    if (p == e) continue;
    T xv = x[j];
    for (; p < e; ++p) out[ia[p]] += va[p] * xv;
  }
}

// Scatter into a CALLER-zeroed output (np.zeros = calloc: untouched pages
// stay on the shared zero page, where an in-kernel memset would
// materialize and write every page — measured ~0.05 ms of the spmv_add
// example's 0.29 ms matvec).
template <typename T, typename I>
void csc_spmv_acc(const I* pc, const I* ia, const T* va, int64_t n_cols, const T* x, T* out) {
  for (int64_t j = 0; j < n_cols; ++j) {
    I p = pc[j], e = pc[j + 1];
    if (p == e) continue;
    T xv = x[j];
    for (; p < e; ++p) out[ia[p]] += va[p] * xv;
  }
}

// Entry-loop matvec for the sparse-row regime (nnz << n_rows): the
// CSR/CSC forms iterate every row/column (99,990 iterations for 10k
// entries at the spmv_add example shape — loop-overhead-bound at
// ~0.24-0.30 ms), where a scatter over the ENTRIES alone is ~10k
// iterations.  Caller pre-initializes out (np.zeros, or y for the fused
// A@x+y).  Serial: this regime's entry counts don't amortize threads.
template <typename T, typename I>
void coo_spmv_acc(const I* ri, const I* ci, const T* va, int64_t nnz, const T* x, T* out) {
  for (int64_t p = 0; p < nnz; ++p) out[ri[p]] += va[p] * x[ci[p]];
}

// Fused A@x + y (the reference's headline spmv_add example,
// examples/spmv_add_example.py:11-66): seed the output with y instead of
// zeros, turning matvec+add (memset + scatter + full read/add/write pass
// = ~4 output-size passes) into memcpy + scatter (~2 passes).
template <typename T, typename I>
void csr_spmv_add(const I* pa, const I* ja, const T* va, int64_t n_rows, const T* x, const T* y0,
                  T* out) {
  run_rows(pa, n_rows, 17, 1, [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      int64_t p = pa[r], e = pa[r + 1];
      T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
      for (; p + 4 <= e; p += 4) {
        a0 += va[p] * x[ja[p]];
        a1 += va[p + 1] * x[ja[p + 1]];
        a2 += va[p + 2] * x[ja[p + 2]];
        a3 += va[p + 3] * x[ja[p + 3]];
      }
      for (; p < e; ++p) a0 += va[p] * x[ja[p]];
      out[r] = y0[r] + (a0 + a1) + (a2 + a3);
    }
  });
}

template <typename T, typename I>
void csc_spmv_add(const I* pc, const I* ia, const T* va, int64_t n_cols, int64_t n_rows,
                  const T* x, const T* y0, T* out) {
  std::memcpy(out, y0, n_rows * sizeof(T));
  for (int64_t j = 0; j < n_cols; ++j) {
    I p = pc[j], e = pc[j + 1];
    if (p == e) continue;
    T xv = x[j];
    for (; p < e; ++p) out[ia[p]] += va[p] * xv;
  }
}

template <typename T, typename I>
void csc_spmm(const I* pc, const I* ia, const T* va, int64_t n_cols, int64_t n_rows, const T* b,
              int64_t n_cols_out, T* out) {
  // scatter into out rows: races only across the sparse loop, so thread
  // over disjoint slices of the dense columns instead
  auto work = [&](int64_t c0, int64_t c1) {
    for (int64_t i = 0; i < n_rows; ++i)
      for (int64_t c = c0; c < c1; ++c) out[i * n_cols_out + c] = T(0);
    for (int64_t j = 0; j < n_cols; ++j) {
      const T* brow = b + j * n_cols_out;
      for (int64_t p = pc[j]; p < pc[j + 1]; ++p) {
        T v = va[p];
        T* orow = out + (int64_t)ia[p] * n_cols_out;
        for (int64_t c = c0; c < c1; ++c) orow[c] += v * brow[c];
      }
    }
  };
  int64_t nnz = pc[n_cols];
  // chunks span whole 64-byte cache lines of the output rows, else threads
  // false-share every accumulation
  int64_t min_chunk = 64 / (int64_t)sizeof(T);
  int t = (int)std::min<int64_t>(
      std::min<int64_t>(sttpool::ThreadPool::max_threads(), n_cols_out / min_chunk),
      (nnz * n_cols_out) >> 17);
  if (t < 2) {
    work(0, n_cols_out);
    return;
  }
  int64_t chunk = ((n_cols_out + t - 1) / t + min_chunk - 1) / min_chunk * min_chunk;
  sttpool::parallel_for_slots(t, [&](int i) {
    work(i * chunk, std::min<int64_t>(n_cols_out, (i + 1) * chunk));
  });
}

}  // namespace

extern "C" {

// Sparse x dense (SpMV / SpMM) — the role of the reference's
// `_dot_csr_ndarray_type` / `_dot_csc_ndarray_type` Numba kernels
// (`_common.py:720-905`). CSR kernels thread over nnz-balanced row ranges;
// CSC kernels are one scatter pass. Index buffers may be int32 or int64
// (GCXS minimizes its index dtype); dense operands row-major contiguous.

#define CSR_DENSE_ABI(TS, T, IS, I)                                                            \
  int stt_csr_spmv_##TS##_##IS(const I* pa, const I* ja, const T* va, int64_t n_rows,           \
                              const T* x, T* out) {                                            \
    csr_spmv<T, I>(pa, ja, va, n_rows, x, out);                                                \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_csr_spmm_##TS##_##IS(const I* pa, const I* ja, const T* va, int64_t n_rows,           \
                              const T* b, int64_t n_cols_out, T* out) {                        \
    csr_spmm<T, I>(pa, ja, va, n_rows, b, n_cols_out, out);                                    \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_csc_spmv_##TS##_##IS(const I* pc, const I* ia, const T* va, int64_t n_cols,           \
                              int64_t n_rows, const T* x, T* out) {                            \
    csc_spmv<T, I>(pc, ia, va, n_cols, n_rows, x, out);                                        \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_csc_spmm_##TS##_##IS(const I* pc, const I* ia, const T* va, int64_t n_cols,           \
                              int64_t n_rows, const T* b, int64_t n_cols_out, T* out) {        \
    csc_spmm<T, I>(pc, ia, va, n_cols, n_rows, b, n_cols_out, out);                            \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_csc_spmv_acc_##TS##_##IS(const I* pc, const I* ia, const T* va, int64_t n_cols,       \
                                  const T* x, T* out) {                                        \
    csc_spmv_acc<T, I>(pc, ia, va, n_cols, x, out);                                            \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_coo_spmv_acc_##TS##_##IS(const I* ri, const I* ci, const T* va, int64_t nnz,          \
                                  const T* x, T* out) {                                        \
    coo_spmv_acc<T, I>(ri, ci, va, nnz, x, out);                                               \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_coo_spmv_add_##TS##_##IS(const I* ri, const I* ci, const T* va, int64_t nnz,          \
                                  int64_t n_rows, const T* x, const T* y0, T* out) {           \
    std::memcpy(out, y0, n_rows * sizeof(T));                                                  \
    coo_spmv_acc<T, I>(ri, ci, va, nnz, x, out);                                               \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_csr_spmv_add_##TS##_##IS(const I* pa, const I* ja, const T* va, int64_t n_rows,       \
                                  const T* x, const T* y0, T* out) {                           \
    csr_spmv_add<T, I>(pa, ja, va, n_rows, x, y0, out);                                        \
    return 0;                                                                                  \
  }                                                                                            \
  int stt_csc_spmv_add_##TS##_##IS(const I* pc, const I* ia, const T* va, int64_t n_cols,       \
                                  int64_t n_rows, const T* x, const T* y0, T* out) {           \
    csc_spmv_add<T, I>(pc, ia, va, n_cols, n_rows, x, y0, out);                                \
    return 0;                                                                                  \
  }

CSR_DENSE_ABI(f64, double, i64, int64_t)
CSR_DENSE_ABI(f64, double, i32, int32_t)
CSR_DENSE_ABI(f32, float, i64, int64_t)
CSR_DENSE_ABI(f32, float, i32, int32_t)

}  // extern "C"

// ---------------------------------------------------------------------------
// 2-D COO canonicalization: counting-sort by row, per-row stable sort by
// column, duplicate summation — the scipy coo->csr strategy, beating a
// global O(n log n) sort of 64-bit linear keys (role of reference
// `_sort_indices` + `_sum_duplicates`, `_coo/core.py:1294-1353`).
// ---------------------------------------------------------------------------

namespace {

template <typename T, typename I>
int64_t canonicalize2d(const I* rows, const I* cols, const T* vals, int64_t n, int64_t n_rows,
                       I* rows_out, I* cols_out, T* vals_out) {
  std::vector<int64_t> starts(n_rows + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++starts[rows[i] + 1];
  for (int64_t r = 0; r < n_rows; ++r) starts[r + 1] += starts[r];

  // bucket scatter preserving input order within each row (stable)
  std::vector<I> cols_tmp(n);
  std::vector<T> vals_tmp(n);
  {
    std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      int64_t p = cursor[rows[i]]++;
      cols_tmp[p] = cols[i];
      vals_tmp[p] = vals[i];
    }
  }

  // per-row stable sort + in-place duplicate summation
  std::vector<int64_t> row_nnz(n_rows, 0);
  auto work = [&](int64_t r0, int64_t r1) {
    std::vector<int64_t> perm;
    std::vector<I> csc;
    std::vector<T> vsc;
    for (int64_t r = r0; r < r1; ++r) {
      int64_t lo = starts[r], hi = starts[r + 1];
      int64_t len = hi - lo;
      if (!len) continue;
      perm.resize(len);
      for (int64_t i = 0; i < len; ++i) perm[i] = i;
      const I* c = cols_tmp.data() + lo;
      bool sorted_already = true;
      for (int64_t i = 1; i < len; ++i)
        if (c[i - 1] >= c[i]) { sorted_already = false; break; }
      int64_t out = lo;
      if (sorted_already) {
        row_nnz[r] = len;
        continue;
      }
      std::stable_sort(perm.begin(), perm.end(),
                       [&](int64_t x, int64_t y) { return c[x] < c[y]; });
      csc.resize(len);
      vsc.resize(len);
      for (int64_t i = 0; i < len; ++i) {
        csc[i] = c[perm[i]];
        vsc[i] = vals_tmp[lo + perm[i]];
      }
      for (int64_t i = 0; i < len; ++i) {
        if (out > lo && csc[i] == cols_tmp[out - 1]) {
          vals_tmp[out - 1] += vsc[i];
        } else {
          cols_tmp[out] = csc[i];
          vals_tmp[out] = vsc[i];
          ++out;
        }
      }
      row_nnz[r] = out - lo;
    }
  };
  int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), n >> 16);
  if (t < 2) {
    work(0, n_rows);
  } else {
    std::vector<int64_t> s(t + 1, 0);
    for (int i = 1; i < t; ++i) {
      int64_t target = n * i / t;
      s[i] = std::upper_bound(starts.begin(), starts.end(), target) - starts.begin() - 1;
      if (s[i] < s[i - 1]) s[i] = s[i - 1];
    }
    s[t] = n_rows;
    sttpool::parallel_for_slots(t, [&](int i) { work(s[i], s[i + 1]); });
  }

  // compaction
  int64_t out = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t lo = starts[r];
    for (int64_t i = 0; i < row_nnz[r]; ++i, ++out) {
      rows_out[out] = (I)r;
      cols_out[out] = cols_tmp[lo + i];
      vals_out[out] = vals_tmp[lo + i];
    }
  }
  return out;
}

}  // namespace

extern "C" {

#define CANON2D_ABI(TS, T, IS, I)                                                             \
  int64_t stt_canonicalize2d_##TS##_##IS(const I* rows, const I* cols, const T* vals,          \
                                        int64_t n, int64_t n_rows, I* rows_out, I* cols_out,  \
                                        T* vals_out) {                                        \
    return canonicalize2d<T, I>(rows, cols, vals, n, n_rows, rows_out, cols_out, vals_out);   \
  }

CANON2D_ABI(f64, double, i64, int64_t)
CANON2D_ABI(f64, double, i32, int32_t)
CANON2D_ABI(f32, float, i64, int64_t)
CANON2D_ABI(f32, float, i32, int32_t)

}  // extern "C"

// ---------------------------------------------------------------------------
// Canonical-COO transpose / CSC build: a CANONICAL (row-major sorted, unique)
// triplet is already ordered by (col, row) *within each column bucket*, so
// the transpose is one STABLE counting scatter by column — no sort, no dedup
// (scipy's csr<->csc conversion strategy; role of the reference's
// `_coo/core.py` transpose + re-canonicalize). The emitted (indptr, cols_out,
// vals_out) triple doubles as the CSC of the input / CSR of its transpose.
// ---------------------------------------------------------------------------

namespace {

template <typename T, typename I>
void transpose2d(const I* rows, const I* cols, const T* vals, int64_t n, int64_t n_cols,
                 int64_t* indptr_out, I* rows_out, I* cols_out, T* vals_out) {
  for (int64_t c = 0; c <= n_cols; ++c) indptr_out[c] = 0;

  int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), n >> 15);
  if (t >= 2 && n_cols <= (int64_t)1 << 21) {
    // two-pass parallel counting sort: per-thread histograms keep the
    // scatter stable (chunk i's entries land before chunk i+1's per column)
    int64_t chunk = (n + t - 1) / t;
    std::vector<std::vector<int64_t>> hist(t);
    sttpool::parallel_for_slots(t, [&](int ti) {
      auto& h = hist[ti];
      h.assign(n_cols, 0);
      int64_t i0 = ti * chunk, i1 = std::min<int64_t>(n, i0 + chunk);
      for (int64_t i = i0; i < i1; ++i) ++h[cols[i]];
    });
    for (int64_t c = 0; c < n_cols; ++c) {
      int64_t s = 0;
      for (int ti = 0; ti < t; ++ti) {
        int64_t h = hist[ti][c];
        hist[ti][c] = s;  // becomes this thread's within-column offset
        s += h;
      }
      indptr_out[c + 1] = indptr_out[c] + s;
    }
    sttpool::parallel_for_slots(t, [&](int ti) {
      auto& cur = hist[ti];
      int64_t i0 = ti * chunk, i1 = std::min<int64_t>(n, i0 + chunk);
      for (int64_t i = i0; i < i1; ++i) {
        I c = cols[i];
        int64_t p = indptr_out[c] + cur[c]++;
        if (rows_out) rows_out[p] = c;
        cols_out[p] = rows[i];
        vals_out[p] = vals[i];
      }
    });
    return;
  }

  for (int64_t i = 0; i < n; ++i) ++indptr_out[cols[i] + 1];
  for (int64_t c = 0; c < n_cols; ++c) indptr_out[c + 1] += indptr_out[c];
  std::vector<int64_t> cursor(indptr_out, indptr_out + n_cols);
  for (int64_t i = 0; i < n; ++i) {
    I c = cols[i];
    int64_t p = cursor[c]++;
    if (rows_out) rows_out[p] = c;
    cols_out[p] = rows[i];
    vals_out[p] = vals[i];
  }
}

// blocked, threaded out-of-place dense transpose: (R, C) row-major -> (C, R)
template <typename T>
void blocked_transpose(const T* src, int64_t R, int64_t C, T* dst) {
  constexpr int64_t B = 32;
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t rb = r0; rb < r1; rb += B)
      for (int64_t cb = 0; cb < C; cb += B) {
        int64_t re = std::min<int64_t>(rb + B, r1), ce = std::min<int64_t>(cb + B, C);
        for (int64_t r = rb; r < re; ++r)
          for (int64_t c = cb; c < ce; ++c) dst[c * R + r] = src[r * C + c];
      }
  };
  int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), (R * C) >> 18);
  if (t < 2) {
    work(0, R);
    return;
  }
  int64_t chunk = ((R + t - 1) / t + B - 1) / B * B;
  sttpool::parallel_for_slots(t, [&](int i) {
    work(i * chunk, std::min<int64_t>(R, (i + 1) * chunk));
  });
}

// dense (M, K) x sparse (K, N) via the CSR of the sparse TRANSPOSE
// (= the CSC scatter buffers above): out^T[n, :] = sum_p v[p] * X^T[k[p], :].
// Both dense transposes are fused here (blocked + threaded) so the Python
// layer passes X and receives out in natural row-major (M, K)/(M, N) layout.
template <typename T>
T* scratch_buffer(int which, size_t n) {
  // persistent per-thread scratch: freshly mmap'd large buffers cost a page
  // fault per 4 KiB every call otherwise (~1 ms on the multi-MB operands)
  static thread_local std::vector<T> bufs[2];
  auto& b = bufs[which];
  if (b.size() < n) b.resize(n);
  return b.data();
}

template <typename T, typename I>
void dense_spmm_csrt(const int64_t* pn, const I* kids, const T* vals, int64_t N, const T* X,
                     int64_t M, int64_t K, T* out) {
  T* xt = scratch_buffer<T>(0, (size_t)K * M);
  blocked_transpose(X, M, K, xt);
  T* out_t = scratch_buffer<T>(1, (size_t)N * M);
  run_rows(pn, N, 19, M, [&](int64_t n0, int64_t n1) {
    int64_t p_end = pn[n1];
    for (int64_t r = n0; r < n1; ++r) {
      T* orow = out_t + r * M;
      for (int64_t m = 0; m < M; ++m) orow[m] = T(0);
      for (int64_t p = pn[r]; p < pn[r + 1]; ++p) {
        // the gathered X^T rows are the only random access — hide their
        // latency by prefetching a few entries ahead
        if (p + 8 < p_end) __builtin_prefetch(xt + (int64_t)kids[p + 8] * M);
        T v = vals[p];
        const T* xrow = xt + (int64_t)kids[p] * M;
        for (int64_t m = 0; m < M; ++m) orow[m] += v * xrow[m];
      }
    }
  });
  blocked_transpose(out_t, N, M, out);
}

}  // namespace

extern "C" {

#define TRANSPOSE2D_ABI(TS, T, IS, I)                                                         \
  int stt_transpose2d_##TS##_##IS(const I* rows, const I* cols, const T* vals, int64_t n,      \
                                 int64_t n_cols, int64_t* indptr_out, I* rows_out,            \
                                 I* cols_out, T* vals_out) {                                  \
    transpose2d<T, I>(rows, cols, vals, n, n_cols, indptr_out, rows_out, cols_out, vals_out); \
    return 0;                                                                                 \
  }                                                                                           \
  int stt_dense_spmm_csrt_##TS##_##IS(const int64_t* pn, const I* kids, const T* vals,         \
                                     int64_t N, const T* X, int64_t M, int64_t K, T* out) {   \
    dense_spmm_csrt<T, I>(pn, kids, vals, N, X, M, K, out);                                   \
    return 0;                                                                                 \
  }

TRANSPOSE2D_ABI(f64, double, i64, int64_t)
TRANSPOSE2D_ABI(f64, double, i32, int32_t)
TRANSPOSE2D_ABI(f32, float, i64, int64_t)
TRANSPOSE2D_ABI(f32, float, i32, int32_t)

}  // extern "C"

namespace {

// dtype-agnostic scatter (values moved as opaque bytes) — covers the long
// tail of dtypes (ints, bool, f16, complex) with the same no-sort strategy
template <typename I, int SZ>
void transpose2d_sz(const I* rows, const I* cols, const char* vals, int64_t n, int64_t n_cols,
                    int64_t* indptr_out, I* rows_out, I* cols_out, char* vals_out) {
  for (int64_t c = 0; c <= n_cols; ++c) indptr_out[c] = 0;
  for (int64_t i = 0; i < n; ++i) ++indptr_out[cols[i] + 1];
  for (int64_t c = 0; c < n_cols; ++c) indptr_out[c + 1] += indptr_out[c];
  std::vector<int64_t> cursor(indptr_out, indptr_out + n_cols);
  for (int64_t i = 0; i < n; ++i) {
    I c = cols[i];
    int64_t p = cursor[c]++;
    if (rows_out) rows_out[p] = c;
    cols_out[p] = rows[i];
    std::memcpy(vals_out + p * SZ, vals + i * SZ, SZ);
  }
}

template <typename I>
bool transpose2d_bytes(const I* rows, const I* cols, const char* vals, int64_t n,
                       int64_t n_cols, int64_t itemsize, int64_t* indptr_out, I* rows_out,
                       I* cols_out, char* vals_out) {
  switch (itemsize) {
    case 1: transpose2d_sz<I, 1>(rows, cols, vals, n, n_cols, indptr_out, rows_out, cols_out, vals_out); return true;
    case 2: transpose2d_sz<I, 2>(rows, cols, vals, n, n_cols, indptr_out, rows_out, cols_out, vals_out); return true;
    case 4: transpose2d_sz<I, 4>(rows, cols, vals, n, n_cols, indptr_out, rows_out, cols_out, vals_out); return true;
    case 8: transpose2d_sz<I, 8>(rows, cols, vals, n, n_cols, indptr_out, rows_out, cols_out, vals_out); return true;
    case 16: transpose2d_sz<I, 16>(rows, cols, vals, n, n_cols, indptr_out, rows_out, cols_out, vals_out); return true;
  }
  return false;
}

}  // namespace

extern "C" {

int stt_transpose2d_bytes_i64(const int64_t* rows, const int64_t* cols, const char* vals,
                             int64_t n, int64_t n_cols, int64_t itemsize, int64_t* indptr_out,
                             int64_t* rows_out, int64_t* cols_out, char* vals_out) {
  return transpose2d_bytes<int64_t>(rows, cols, vals, n, n_cols, itemsize, indptr_out, rows_out,
                                    cols_out, vals_out)
             ? 0
             : 1;
}

int stt_transpose2d_bytes_i32(const int32_t* rows, const int32_t* cols, const char* vals,
                             int64_t n, int64_t n_cols, int64_t itemsize, int64_t* indptr_out,
                             int32_t* rows_out, int32_t* cols_out, char* vals_out) {
  return transpose2d_bytes<int32_t>(rows, cols, vals, n, n_cols, itemsize, indptr_out, rows_out,
                                    cols_out, vals_out)
             ? 0
             : 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Mixed-radix relinearization for GCXS restructuring (change_compressed_axes /
// N-D reshape / N-D transpose): per stored entry with compressed-row id r
// (expanded from indptr in-loop) and stored index j, compute
//     key = sum_k ((src_k / div_k) % mod_k) * mul_k
// for the target row and column keys, where src_k selects r (0), j (1) or an
// optional intermediate C-order linear index (2) assembled from its own term
// list (needed by reshape).  mod_k == 0 means "no modulo" (top digit).
// Threaded over the indptr row ranges (same balanced split as
// stt_uncompress_indptr).  Replaces the reference's uncompress/relinearize
// Numba kernels (sparse/numba_backend/_compressed/convert.py:210-273 role).
// ---------------------------------------------------------------------------

namespace {

struct RelinTerms {
  int n;
  const int8_t* src;
  const int64_t* div;
  const int64_t* mod;
  const int64_t* mul;
};

// preprocessed term: power-of-two divisors/moduli become shifts/masks
// (runtime int64 division is ~25 cycles; the bench shapes are all pow2)
struct PreTerm {
  int8_t src;
  int8_t dshift;  // -1: real divide
  int8_t mshift;  // -1: real modulo, -2: no modulo
  int64_t div, mod, mul;
};

inline int8_t pow2_shift(int64_t v) {
  if (v > 0 && (v & (v - 1)) == 0) {
    int8_t s = 0;
    while ((int64_t(1) << s) != v) ++s;
    return s;
  }
  return -1;
}

inline std::vector<PreTerm> relin_pre(const RelinTerms& t) {
  std::vector<PreTerm> out(t.n);
  for (int k = 0; k < t.n; ++k) {
    PreTerm p;
    p.src = t.src[k];
    p.div = t.div[k];
    p.mod = t.mod[k];
    p.mul = t.mul[k];
    p.dshift = p.div == 1 ? 0 : pow2_shift(p.div);
    p.mshift = p.mod == 0 ? -2 : pow2_shift(p.mod);
    out[k] = p;
  }
  return out;
}

inline int64_t relin_eval(const std::vector<PreTerm>& terms, int64_t r, int64_t j, int64_t lin) {
  int64_t key = 0;
  for (const PreTerm& t : terms) {
    int64_t s = t.src == 0 ? r : (t.src == 1 ? j : lin);
    int64_t d = t.dshift >= 0 ? (s >> t.dshift) : (s / t.div);
    if (t.mshift >= 0)
      d &= (int64_t(1) << t.mshift) - 1;
    else if (t.mshift == -1)
      d %= t.mod;
    key += d * t.mul;
  }
  return key;
}

template <typename I>
void relinearize_impl(const int64_t* pc, int64_t n_rows, const I* idxs, const RelinTerms& lt,
                      const RelinTerms& rt, const RelinTerms& ct, int64_t* out_row,
                      int64_t* out_col) {
  int64_t nnz = pc[n_rows];
  std::vector<PreTerm> lp = relin_pre(lt), rp = relin_pre(rt), cp = relin_pre(ct);
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      for (int64_t p = pc[r]; p < pc[r + 1]; ++p) {
        int64_t j = (int64_t)idxs[p];
        int64_t lin = lp.empty() ? 0 : relin_eval(lp, r, j, 0);
        out_row[p] = relin_eval(rp, r, j, lin);
        out_col[p] = relin_eval(cp, r, j, lin);
      }
    }
  };
  int t = (int)std::min<int64_t>(sttpool::ThreadPool::max_threads(), nnz >> 16);
  if (t < 2) {
    work(0, n_rows);
    return;
  }
  std::vector<int64_t> s(t + 1, 0);
  for (int i = 1; i < t; ++i) {
    int64_t target = nnz * i / t;
    s[i] = std::upper_bound(pc, pc + n_rows + 1, target) - pc - 1;
    if (s[i] < s[i - 1]) s[i] = s[i - 1];
  }
  s[t] = n_rows;
  sttpool::parallel_for_slots(t, [&](int i) { work(s[i], s[i + 1]); });
}

}  // namespace

extern "C" {

#define RELIN_ARGS                                                                        \
  const int64_t *pc, int64_t n_rows, int nl, const int8_t *lsrc, const int64_t *ldiv,     \
      const int64_t *lmod, const int64_t *lmul, int nr, const int8_t *rsrc,               \
      const int64_t *rdiv, const int64_t *rmod, const int64_t *rmul, int nc,              \
      const int8_t *csrc, const int64_t *cdiv, const int64_t *cmod, const int64_t *cmul,  \
      int64_t *out_row, int64_t *out_col

int stt_relinearize_i64(RELIN_ARGS, const int64_t* idxs) {
  relinearize_impl<int64_t>(pc, n_rows, idxs, {nl, lsrc, ldiv, lmod, lmul},
                            {nr, rsrc, rdiv, rmod, rmul}, {nc, csrc, cdiv, cmod, cmul}, out_row,
                            out_col);
  return 0;
}

int stt_relinearize_i32(RELIN_ARGS, const int32_t* idxs) {
  relinearize_impl<int32_t>(pc, n_rows, idxs, {nl, lsrc, ldiv, lmod, lmul},
                            {nr, rsrc, rdiv, rmod, rmul}, {nc, csrc, cdiv, cmod, cmul}, out_row,
                            out_col);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CSR fancy-row splice: pack rows picks[0..n_picks) of a CSR into a fresh
// compact CSR (indices + values copied segment-wise, rel_indptr built in the
// same pass).  One call replaces the repeat/cumsum/arange/gather numpy
// pipeline in GCXS._getitem_fast (reference _compressed/indexing.py role).
// Generic over index/value widths (byte copies).
// ---------------------------------------------------------------------------

extern "C" {

int64_t stt_csr_row_splice_bytes(const int64_t* pa, const char* ind, int64_t ind_isz,
                                const char* dat, int64_t dat_isz, const int64_t* picks,
                                int64_t n_picks, int64_t* rel_indptr, char* ind_out,
                                char* dat_out) {
  int64_t off = 0;
  rel_indptr[0] = 0;
  for (int64_t i = 0; i < n_picks; ++i) {
    int64_t lo = pa[picks[i]], hi = pa[picks[i] + 1];
    int64_t cnt = hi - lo;
    std::memcpy(ind_out + off * ind_isz, ind + lo * ind_isz, (size_t)(cnt * ind_isz));
    std::memcpy(dat_out + off * dat_isz, dat + lo * dat_isz, (size_t)(cnt * dat_isz));
    off += cnt;
    rel_indptr[i + 1] = off;
  }
  return off;
}

}  // extern "C"
