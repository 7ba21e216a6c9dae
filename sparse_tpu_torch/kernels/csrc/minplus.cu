// Min-plus relaxation over the per-destination ELL (K7) for Hopper (sm_90a),
// plain C interface for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Replaces the XLA relaxation round of sparse_tpu/csgraph.py:
// _bellman_ford_device_ell (:228) and _bellman_ford_device_ell_tail (:255),
// which gather the distance table's rows by the layout's sources into an
// (n, L0, k) block, add the weights and take the minimum over the slots.
// The layout is sparse_tpu_torch/kernels/minplus.py:build_dest_ell's: e_src
// and e_w are (n, L0) row-major (int64 sources, +inf weight in padding), the
// tail (t_src, t_w) is (d, Lt) and covers destinations n - d .. n - 1; deg
// (n,) and t_deg (d,), int32, count each row's filled slots, which are its
// prefix.
//
// One round: for every destination v and source column s of the transposed
// table dist (n, k), row-major,
//   out[v, s] = min(dist[v, s], min_l dist[e_src[v, l], s] + e_w[v, l])
// (the tail's slots join the inner minimum), and *stamp = round where
// out[v, s] < dist[v, s]. The minimum propagates NaN as jnp.min and
// torch.amin do (fmin would drop it), and every candidate is one rounded
// add, so a round gives the plain version's bits whatever order the slots
// and columns are taken in. out must not be dist: each round reads only the
// previous round's table.
//
// Bound on this card: bytes. The function reads each edge's source and
// weight and the table once and writes the table once; the kernel reads a
// table row segment for every filled slot, which L2 serves while the table,
// or the column slice being read, fits in it. Design:
// - padding skipped: a row takes its first deg[v] slots only. Every padding
//   slot's candidate is dist[0, s] + inf, +inf unless dist[0, s] is NaN or
//   -inf, where it is NaN; a row with padding folds that one candidate into
//   its minimum once, so the bits stay the plain version's (which takes
//   every slot). Without deg (null) every slot is taken.
// - 16-byte row segments: a lane owns Q = MINPLUS_LANE_BYTES / sizeof(T)
//   consecutive columns (one vector load where rows are 16-byte aligned), a
//   group of L lanes (a power of two, at most 32) a destination's columns
//   (a warp of 32 lanes takes a chunk of 32 Q columns, chunks of one
//   destination in consecutive warps). The group's lanes load a round of
//   at least 16 slot sources and weights at once, spread over its lanes,
//   and pass them on with shuffles; each lane keeps up to 4 slot gathers
//   in flight (loads_for: fewer in wide groups, which won there).
// - the sliced route: a table past the L2 budget (kernels/_cuda.py:
//   minplus_route) is read in column slices of `slice` values (64: 512
//   bytes of a float64 row, a warp's chunk; 256 of a float32 row) with one
//   grid numbered slice-major, so the
//   rows a slice reads stay in L2 while the destinations gather from them
//   and device memory reads the table about once. The gather route is the
//   same grid with one slice of k.
// - the flag's reset fused: the kernel writes the round's number into the
//   solve's stamp, zeroed once a solve; the host compares it with the round
//   it launched, so a round is one launch and no fill.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The constants, from chip_minplus_ablation.py on an H100 (PERF.md):
#ifndef MINPLUS_LANE_BYTES
#define MINPLUS_LANE_BYTES 16  // bytes of a row segment a lane (8: the ablation's base)
#endif
#ifndef MINPLUS_LOADS
#define MINPLUS_LOADS 4  // slot gathers in flight a lane, at most ...
#endif
#ifndef MINPLUS_WARP_SLOTS
#define MINPLUS_WARP_SLOTS 32  // ... and at most this over L: 4 at L <= 8, 2 at L = 16, 1 at L = 32
#endif
#ifndef MINPLUS_SLOT_BATCH
#define MINPLUS_SLOT_BATCH 16  // slots whose sources and weights a group loads at once, at least
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// slot gathers in flight a lane for groups of L lanes: at L = 32 one (all
// sources took 3.17 ms a round, 3.48 with 4: the loads' registers cost CTAs
// an SM), at L = 16 two (float32 at 128 sources 0.139 ms, 0.157 with 4),
// else four; batches of 16 slot sources took 0.0289 ms at 8 sources, batches
// of 4 0.0312 (chip_minplus_ablation.py, PERF.md)
__host__ __device__ constexpr int loads_for(int L) {
  const int cap = MINPLUS_WARP_SLOTS / L;
  return MINPLUS_LOADS < cap ? MINPLUS_LOADS : cap > 1 ? cap : 1;
}

// The smaller of a and b, NaN when either is NaN.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// N consecutive values as one load or store
template <typename T, int N>
struct Pack;
template <>
struct Pack<double, 2> {
  using type = double2;
  static __device__ __forceinline__ void split(type p, double (&x)[2]) { x[0] = p.x, x[1] = p.y; }
  static __device__ __forceinline__ type join(const double (&x)[2]) { return make_double2(x[0], x[1]); }
};
template <>
struct Pack<float, 4> {
  using type = float4;
  static __device__ __forceinline__ void split(type p, float (&x)[4]) { x[0] = p.x, x[1] = p.y, x[2] = p.z, x[3] = p.w; }
  static __device__ __forceinline__ type join(const float (&x)[4]) { return make_float4(x[0], x[1], x[2], x[3]); }
};
template <>
struct Pack<float, 2> {
  using type = float2;
  static __device__ __forceinline__ void split(type p, float (&x)[2]) { x[0] = p.x, x[1] = p.y; }
  static __device__ __forceinline__ type join(const float (&x)[2]) { return make_float2(x[0], x[1]); }
};
template <typename T>
struct Pack<T, 1> {
  using type = T;
  static __device__ __forceinline__ void split(type p, T (&x)[1]) { x[0] = p; }
  static __device__ __forceinline__ type join(const T (&x)[1]) { return x[0]; }
};

// columns col .. col + Q - 1 of row j (those below k), one vector load where vec
template <typename T, int Q>
__device__ __forceinline__ void load_seg(const T* __restrict__ dist, long long j, long long k, long long col,
                                         bool active, bool vec, T (&x)[Q]) {
  const T* p = dist + j * k + col;
  if (active && vec) {
    Pack<T, Q>::split(*reinterpret_cast<const typename Pack<T, Q>::type*>(p), x);
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) x[q] = active && col + q < k ? p[q] : T(0);
  }
}

// The minimum over the slots [0, cnt) of one ELL row (src_row, w_row) into
// best, for this lane's columns. The group's L lanes hold a round of B slots,
// B / L a lane, and shuffle each slot's source and weight to the group;
// n_max, the warp's largest cnt, bounds the warp-uniform loop.
template <typename T, int L, int Q>
__device__ __forceinline__ void relax_row(const T* __restrict__ dist, long long k, long long col, bool active,
                                          bool vec, const long long* __restrict__ src_row,
                                          const T* __restrict__ w_row, int cnt, int n_max, int gl, T (&best)[Q]) {
  constexpr int kLoads = loads_for(L);
  constexpr int B0 = MINPLUS_SLOT_BATCH > kLoads ? MINPLUS_SLOT_BATCH : kLoads;
  constexpr int B = L > B0 ? L : B0;  // slots a round
  constexpr int J = B / L;            // of them a lane
  for (int s0 = 0; s0 < n_max; s0 += B) {
    int sj[J];
    T wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int slot = s0 + j * L + gl;
      const bool has = slot < cnt;
      sj[j] = has ? (int)src_row[slot] : 0;
      wj[j] = has ? w_row[slot] : T(0);
    }
#pragma unroll
    for (int t0 = 0; t0 < B; t0 += kLoads) {
      if (s0 + t0 >= n_max) break;  // warp-uniform
      T x[kLoads][Q];
      T wt[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int t = t0 + u;
        int j;
        if constexpr (L == 1) {
          j = sj[t];
          wt[u] = wj[t];
        } else {
          j = __shfl_sync(kFull, sj[t / L], t % L, L);
          wt[u] = __shfl_sync(kFull, wj[t / L], t % L, L);
        }
        load_seg<T, Q>(dist, j, k, col, active && s0 + t < cnt, vec, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (s0 + t0 + u < cnt) {
#pragma unroll
          for (int q = 0; q < Q; ++q) best[q] = nan_min(best[q], x[u][q] + wt[u]);
        }
      }
    }
  }
}

// Warp w of the grid: slice w / (n_groups * chunks), then destination group,
// then chunk (fastest). A group of L lanes takes one destination; a chunk is
// 32 Q columns of a slice (more than one only where L == 32).
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    minplus_relax_kernel(const T* __restrict__ dist, T* __restrict__ out, const long long* __restrict__ e_src,
                         const T* __restrict__ e_w, const int* __restrict__ deg, long long n, long long width,
                         long long k, const long long* __restrict__ t_src, const T* __restrict__ t_w,
                         const int* __restrict__ t_deg, long long d, long long t_width, long long slice,
                         long long n_groups, long long chunks, bool vec, int* __restrict__ stamp, int round) {
  constexpr int Q = MINPLUS_LANE_BYTES / sizeof(T);
  const long long wid = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long per_slice = n_groups * chunks;
  const long long sl = wid / per_slice;
  if (sl * slice >= k) return;  // the grid's last CTA: whole warps past the end
  const long long rem = wid - sl * per_slice;
  const long long group = rem / chunks;
  const long long chunk = rem - group * chunks;
  const int gl = lane % L;
  const long long v = group * (32 / L) + lane / L;
  const long long off = chunk * (32 * Q) + gl * Q;  // the lane's first column within the slice
  const long long col = sl * slice + off;
  const bool row_ok = v < n;
  const bool active = row_ok && off < slice && col < k;

  int cnt = 0, t_cnt = 0;
  long long r = 0;
  bool pad = false;  // the row leaves padding slots out: their one candidate is folded in
  if (row_ok) {
    cnt = deg != nullptr ? deg[v] : (int)width;
    pad = cnt < width;
    if (v >= n - d) {
      r = v - (n - d);
      t_cnt = t_deg != nullptr ? t_deg[r] : (int)t_width;
      pad |= t_cnt < t_width;
    }
  }
  T best[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) best[q] = T(INFINITY);
  const int n_max = __reduce_max_sync(kFull, cnt);
  relax_row<T, L, Q>(dist, k, col, active, vec, e_src + (row_ok ? v : 0) * width, e_w + (row_ok ? v : 0) * width,
                     cnt, n_max, gl, best);
  if (d > 0) {
    const int t_max = __reduce_max_sync(kFull, t_cnt);
    if (t_max > 0) {
      relax_row<T, L, Q>(dist, k, col, active, vec, t_src + r * t_width, t_w + r * t_width, t_cnt, t_max, gl, best);
    }
  }
  if (pad) {
    T x[Q];
    load_seg<T, Q>(dist, 0, k, col, active, vec, x);
#pragma unroll
    for (int q = 0; q < Q; ++q) best[q] = nan_min(best[q], x[q] + T(INFINITY));
  }
  bool fell = false;
  if (active) {
    T old[Q], next[Q];
    load_seg<T, Q>(dist, v, k, col, true, vec, old);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      next[q] = nan_min(old[q], best[q]);
      fell |= col + q < k && next[q] < old[q];
    }
    T* p = out + v * k + col;
    if (vec) {
      *reinterpret_cast<typename Pack<T, Q>::type*>(p) = Pack<T, Q>::join(next);
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (col + q < k) p[q] = next[q];
      }
    }
  }
  if (__any_sync(kFull, fell) && lane == 0) *stamp = round;
}

template <typename T, int L>
int launch_l(long long blocks, cudaStream_t stream, const T* dist, T* out, const long long* e_src, const T* e_w,
             const int* deg, long long n, long long width, long long k, const long long* t_src, const T* t_w,
             const int* t_deg, long long d, long long t_width, long long slice, long long n_groups, long long chunks,
             bool vec, int* stamp, int round) {
  minplus_relax_kernel<T, L><<<(unsigned)blocks, kThreads, 0, stream>>>(
      dist, out, e_src, e_w, deg, n, width, k, t_src, t_w, t_deg, d, t_width, slice, n_groups, chunks, vec, stamp,
      round);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* dist, T* out, const long long* e_src, const T* e_w, const int* deg, long long n,
           long long width, long long k, const long long* t_src, const T* t_w, const int* t_deg, long long d,
           long long t_width, long long slice_cols, int* stamp, long long round, cudaStream_t stream) {
  constexpr long long Q = MINPLUS_LANE_BYTES / sizeof(T);
  if (n <= 0 || k <= 0) return 0;
  if (slice_cols < 0 || slice_cols % Q != 0 || n > 0x7fffffffLL || round <= 0 || round > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long slice = slice_cols > 0 && slice_cols < k ? slice_cols : k;  // the gather route: one slice
  const long long lanes = (slice + Q - 1) / Q;
  int L = 1;
  while (L < lanes && L < 32) L <<= 1;
  const long long chunks = (slice + 32 * Q - 1) / (32 * Q);
  const long long n_groups = (n + 32 / L - 1) / (32 / L);
  const long long warps = (k + slice - 1) / slice * n_groups * chunks;
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = k % Q == 0 && (uintptr_t)dist % (Q * sizeof(T)) == 0 && (uintptr_t)out % (Q * sizeof(T)) == 0;
#define MINPLUS_LAUNCH(LANES)                                                                                     \
  case LANES:                                                                                                     \
    return launch_l<T, LANES>(blocks, stream, dist, out, e_src, e_w, deg, n, width, k, t_src, t_w, t_deg, d,     \
                              t_width, slice, n_groups, chunks, vec, stamp, (int)round);
  switch (L) {
    MINPLUS_LAUNCH(1)
    MINPLUS_LAUNCH(2)
    MINPLUS_LAUNCH(4)
    MINPLUS_LAUNCH(8)
    MINPLUS_LAUNCH(16)
    MINPLUS_LAUNCH(32)
  }
#undef MINPLUS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// slice_cols: 0 for the gather route, else the sliced route's columns a
// slice (a multiple of MINPLUS_LANE_BYTES / sizeof(T)); deg and t_deg may be
// null (every slot taken); stamp: one int32, set to round where a value fell
#define ST_MINPLUS_RELAX(SUFFIX, T)                                                                              \
  extern "C" int st_minplus_relax_##SUFFIX(const T* dist, T* out, const long long* e_src, const T* e_w,          \
                                           const int* deg, long long n, long long width, long long k,            \
                                           const long long* t_src, const T* t_w, const int* t_deg, long long d,  \
                                           long long t_width, long long slice_cols, int* stamp, long long round, \
                                           void* stream) {                                                       \
    return launch<T>(dist, out, e_src, e_w, deg, n, width, k, t_src, t_w, t_deg, d, t_width, slice_cols, stamp,  \
                     round, (cudaStream_t)stream);                                                               \
  }

ST_MINPLUS_RELAX(f32, float)
ST_MINPLUS_RELAX(f64, double)
