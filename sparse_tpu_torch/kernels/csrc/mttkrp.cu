// MTTKRP of a 3-D sparse tensor for Hopper (sm_90a), plain C interface for
// ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
//   out[i, :] = sum over the entries e of row i of  v[e] * (C[j[e], :] * D[k[e], :])
//
// One kernel serves both forms of the port:
// - the block-ELL form (sparse_tpu_torch/kernels/ell.py:ell_mttkrp): the
//   slots of the (n_blocks, cap) layout, pad slots included, ordered by
//   global row through the host-built int32 `order` (a stable sort of
//   block * block_rows + local row), with the int64 `row_ptr` giving each
//   row's run in that order. Pad slots (v = 0, local row 0, j = k = 0) are
//   computed like any entry, so 0 * C[0] * D[0] lands in local row 0 of each
//   block as in sparse_tpu.
// - the sorted-COO form (sparse_tpu_torch/kernels/dot.py:mttkrp): entries
//   sorted by i, `order` null, `row_ptr` from torch.searchsorted on the
//   device.
//
// Replaces experiments/mttkrp_onehot.py:products_call (Pallas: both factor
// rows picked by one-hot MXU products from transposed hi|lo bf16 tables,
// the (r, n_slots) products stream written to memory, then an XLA one-hot
// einsum scatters it into rows), and with it the XLA gather + one-hot
// einsum of sparse_tpu/kernels/ell.py:ell_mttkrp and the XLA segment_sum of
// sparse_tpu/kernels/dot.py:mttkrp. The one-hot picks and the hi|lo or
// int16-split tables work around the TPU's gather rate and lane padding;
// here each factor row is read directly, so "exact" is exact f32 (or f64)
// and the products never leave registers.
//
// Design. The unit of work is a piece: at most `piece` slots of one row's
// run, counted from the run's first slot. One warp takes one (piece,
// 32-column chunk of r); lane l owns column chunk * 32 + l (masked past r,
// so r = 25 or 64 work as well as 32). The warp walks its slots 32 at a
// time: each lane loads one slot's (j, k, v), coalesced in the sorted-COO
// form, then the warp broadcasts them with shuffles and every lane gathers
// its column of C[j] and D[k] (one 128-byte row segment per warp at f32,
// r = 32) and accumulates with FMA in registers.
// - A row of at most `piece` slots is one piece: its warp sums the run in
//   slot order and stores the row once, as the first form of this kernel
//   did.
// - A longer run is split. `pieces` (int64, n_rows + 1) counts the pieces
//   of the split rows before each row (0 for an unsplit row); the wrapper
//   derives it from row_ptr (kernels/_cuda.py:run_pieces): on the host with
//   the block-ELL layout, on the device for sorted COO. Each piece's warp
//   writes its partial row to `partial` and takes a ticket; the warp that
//   takes the row's last ticket adds the partials in piece order, stores
//   the row and sets the ticket back to 0, so one zeroed `tickets` buffer
//   serves every launch on a stream.
// The grid is sized from sizes alone, so nothing is read back: the first
// min(n_front, 2048) warps (n_front bounds the pieces of split rows, see
// kernels/_cuda.py:front_bound) stride over those pieces, placed first so
// the long runs start early; warp front + i takes row i unless its run is
// longer than a piece (it reads only row_ptr, as the first form did). Results are deterministic and nothing uses atomics
// on data: a row's sum is ((0 + p0) + p1) + ..., in piece order, whichever
// warp finishes it. Every output row is written exactly once (an empty row
// stores zeros: no memset). Offsets are 64-bit.
//
// The two forms and both run sorts (host or device) stay equal bit for bit:
// pieces are counted from the run's start, and a block-ELL run differs from
// its sorted-COO run only by pad slots after the row's entries, whose
// products add exact zeros (also when they fill whole pieces).
//
// Precision: T = float or double accumulates in T; the "bf16" strategy reads
// bf16 tables (TT = __nv_bfloat16), multiplies the two factors in float
// (exact: two 8-bit mantissas), converts to T and multiplies by v in T, as
// sparse_tpu's `e_data * g.astype(e_data.dtype)`.
//
// Bound on this card at the BASELINE scale (100k x 2k x 2k, 10M entries,
// r = 32): the HBM bytes give 0.053 ms (each slot's j, k, v and order read
// once, 16 bytes, plus the tables and the output), but what bounds this
// design is L2: C and D (256 KB each) stay in L2 and every slot gathers two
// 128-byte factor rows from it, about 2.6 GB per call, about 0.37 ms at the
// 7 TB/s that whole-row L2 gathers reach on this card (PERF.md). The first
// form lost 0.93 ms of its 1.44 ms to one warp walking the 10,065-slot run
// where the ragged last block's pad slots land; the pieces take that off
// the critical path. The next redesign needs fewer L2 bytes: rows of C and
// D reused from shared memory, or a row's slots sorted by j.
//
// K5, the SDDMM's gradient (kernels/dot.py:_SampledRowSum), is the same
// kernel with one factor:
//
//   out[i, :] = sum over the entries e of segment i of  w[e] * table[idx[e], :]
//
// with the entries (idx, w) in segment order (the wrapper gathers them into
// it: reading them through an order took 0.2545 ms against 0.1948 + 0.0207
// for the gather at the benchmark shape on an H100, PERF.md), summed in that
// order, pieces and tickets as above. It replaces the XLA transpose of
// sparse_tpu/kernels/dot.py:sddmm's two gathers (a segment sum), which the
// port first ran as gathered (nnz, K) blocks and index_add: atomics on the
// card, so other bits on every run. The table is read in place through a
// row stride with unit stride along K. Bound: bytes (the table rows touched
// once, the entries' index and weight, the output once). K5 has three
// routes, all with one FMA chain an output element over its segment's
// entries in entry order from 0, pieces cut at `piece` from the segment's
// start and a split segment's piece sums added from 0 in piece order, so
// all three give the same bits (kernels/_cuda.py:row_sum_route picks one):
// - the gather route (RowSum<T, false>): a lane owns 16 / sizeof(T)
//   consecutive columns (16-byte loads where the rows are 16-byte aligned),
//   4 entries' loads in flight, every entry's row read from L2 or HBM.
//   With a block flag (the union route's layout) it takes only the rows of
//   the flagged blocks and the pieces of their split segments.
// - the sliced route (RowSum<T, true>): a table past the L2 budget is
//   read in column slices of `width` values (at most 32) that each fit L2;
//   one grid is numbered slice-major, so one slice's rows stay in L2 while
//   every entry reads them (it beat a launch a slice). A row warp takes
//   32 / L unsplit rows, L = width / (16 / sizeof(T)) lanes a row and 16
//   bytes a lane (4 rows of 128-byte slices: 512 bytes a load, as the
//   gather route's), the rows in lockstep. The front warps take the split
//   rows' pieces as above (a lane a column), tickets a slice. A warp a
//   row, lanes over one 128-byte segment, ran at 2.0-2.5 TB/s even from
//   L2: four dependent round trips a row of about 15 entries, 128 bytes a
//   load; the entries read with a streaming hint lost 8 %
//   (chip_row_sum_ablation.py, PERF.md).
// - the union route (row_sum_union_kernel): a block of `block` consecutive
//   segments whose table rows repeat (a local pattern: a window of
//   attention) stages the distinct rows its entries name (its union, built
//   on the device once a pattern: kernels/dot.py:row_sum_union_layout), a
//   32-column chunk at a time, into shared memory with cp.async; each group
//   of 8 lanes (float32; 16 in float64) then sums one whole segment from
//   there, 16 bytes a lane, pieces one after another inside the group (no
//   partials, no tickets). A lane a column with two shuffles an entry
//   (the first form) was bound by the shuffles and shared loads, three an
//   entry a warp; the groups take four entries a load and two shuffles.
//   A persistent grid (at least a CTA an SM) walks the blocks the layout
//   does not flag; flagged blocks (a union past shared memory, or too
//   little reuse) take the gather route with the flag, launched after it
//   on a second stream (kernels/dot.py:row_sum_union_route).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// K5's loads in flight and registers, as chip_k4_ablation.py varies them
#ifndef ROW_SUM_LOADS
#define ROW_SUM_LOADS 4
#endif
#ifndef ROW_SUM_MIN_BLOCKS
#define ROW_SUM_MIN_BLOCKS 4
#endif
// the sliced route's
#ifndef ROW_SUM_SLICE_LOADS
#define ROW_SUM_SLICE_LOADS 8
#endif
#ifndef ROW_SUM_SLICE_MIN_BLOCKS
#define ROW_SUM_SLICE_MIN_BLOCKS 4
#endif
// the union route's threads a CTA and shared-memory picks in flight a warp
#ifndef ROW_SUM_UNION_THREADS
#define ROW_SUM_UNION_THREADS 512
#endif
#ifndef ROW_SUM_UNION_LOADS
#define ROW_SUM_UNION_LOADS 4
#endif

namespace {

constexpr int kThreads = 256;  // 8 warps, one (piece or row, chunk) each
constexpr int kWarps = kThreads / 32;
constexpr long long kFrontWarps = 2048;  // per chunk: 256 CTAs, resident at once
constexpr unsigned kFull = 0xffffffffu;

template <typename TT, typename T>
struct Product {
  static __device__ __forceinline__ T of(TT c, TT d) { return c * d; }
};

template <typename T>
struct Product<__nv_bfloat16, T> {
  static __device__ __forceinline__ T of(__nv_bfloat16 c, __nv_bfloat16 d) {
    return T(__bfloat162float(c) * __bfloat162float(d));
  }
};

// The MTTKRP's sum: a lane owns one column (W = 1) of v[s] * C[j[s]] * D[k[s]].
template <typename TT, typename T>
struct MttkrpSum {
  static constexpr int W = 1;
  static constexpr int kMinBlocks = 8;  // CTAs an SM: at most 32 registers (see run_sum_kernel)
  static constexpr bool kSliced = false;
  const int* __restrict__ order;
  const int* __restrict__ cj;
  const int* __restrict__ ck;
  const T* __restrict__ v;
  const TT* __restrict__ C;
  const TT* __restrict__ D;
  long long r;

  // the sum over slots [begin, end) of one run, in slot order, from 0
  __device__ __forceinline__ void run(long long begin, long long end, long long col, bool active, int lane,
                                      T (&out)[W]) const {
    T acc = T(0);
    for (long long s0 = begin; s0 < end; s0 += 32) {
      const int n = end - s0 < 32 ? (int)(end - s0) : 32;
      int j = 0, k = 0;
      T val = T(0);
      if (lane < n) {
        const long long slot = order != nullptr ? (long long)order[s0 + lane] : s0 + lane;
        j = cj[slot];
        k = ck[slot];
        val = v[slot];
      }
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const long long jt = __shfl_sync(kFull, j, t);
        const long long kt = __shfl_sync(kFull, k, t);
        const T vt = __shfl_sync(kFull, val, t);
        if (active) acc += vt * Product<TT, T>::of(C[jt * r + col], D[kt * r + col]);
      }
    }
    out[0] = acc;
  }

  __device__ __forceinline__ bool skips(long long) const { return false; }
};

// V values of T as one aligned load or store
template <typename T, int V>
struct Pack;
template <>
struct Pack<float, 4> {
  using type = float4;
  static __device__ __forceinline__ void split(float4 x, float (&y)[4]) {
    y[0] = x.x, y[1] = x.y, y[2] = x.z, y[3] = x.w;
  }
  static __device__ __forceinline__ float4 join(const float (&y)[4]) { return make_float4(y[0], y[1], y[2], y[3]); }
};
template <>
struct Pack<float, 2> {
  using type = float2;
  static __device__ __forceinline__ void split(float2 x, float (&y)[2]) { y[0] = x.x, y[1] = x.y; }
  static __device__ __forceinline__ float2 join(const float (&y)[2]) { return make_float2(y[0], y[1]); }
};
template <>
struct Pack<double, 2> {
  using type = double2;
  static __device__ __forceinline__ void split(double2 x, double (&y)[2]) { y[0] = x.x, y[1] = x.y; }
  static __device__ __forceinline__ double2 join(const double (&y)[2]) { return make_double2(y[0], y[1]); }
};
template <typename T>
struct Pack<T, 1> {
  using type = T;
  static __device__ __forceinline__ void split(T x, T (&y)[1]) { y[0] = x; }
  static __device__ __forceinline__ T join(const T (&y)[1]) { return y[0]; }
};

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// the W values a lane owns into dst (a row of r values), those inside it
template <int W, typename T>
__device__ __forceinline__ void store(T* dst, long long col, long long r, const T (&x)[W]) {
  if constexpr (W > 1) {
    if (r % W == 0) {
      *reinterpret_cast<typename Pack<T, W>::type*>(dst + col) = Pack<T, W>::join(x);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < W; ++q) {
    if (col + q < r) dst[col + q] = x[q];
  }
}

// K5's sum: a lane owns W consecutive columns of w[s] * table[idx[s]], 16 /
// sizeof(T) on the gather route (16-byte loads), one in the sliced route's
// front warps.
template <typename T, bool Sliced>
struct RowSum {
  static constexpr int W = Sliced ? 1 : 16 / sizeof(T);
  static constexpr bool kSliced = Sliced;
  static constexpr int kLoads = Sliced ? ROW_SUM_SLICE_LOADS : ROW_SUM_LOADS;  // entries' table rows in flight
  // CTAs an SM; the gather route at most 64 registers: the loads in flight need them
  static constexpr int kMinBlocks = Sliced ? ROW_SUM_SLICE_MIN_BLOCKS : ROW_SUM_MIN_BLOCKS;
  const int* __restrict__ idx;
  const T* __restrict__ w;
  const T* __restrict__ table;
  long long ld;   // elements from a table row to the next
  long long vec;  // 16-byte aligned rows and r % (16 / sizeof(T)) == 0: vector loads
  long long r;
  const bool* __restrict__ flag;     // the gather route on a union layout: the blocks whose rows it takes; else null
  long long block;                   // segments a block of that layout
  long long width;                   // the sliced route: columns a slice

  __device__ __forceinline__ bool skips(long long row) const { return flag != nullptr && !flag[row / block]; }

  template <int N>
  __device__ __forceinline__ void load(long long j, long long col, bool active, T (&x)[N]) const {
    const T* row = table + j * ld + col;
    if (active && vec) {
      Pack<T, N>::split(*reinterpret_cast<const typename Pack<T, N>::type*>(row), x);
    } else {
#pragma unroll
      for (int q = 0; q < N; ++q) x[q] = active && col + q < r ? row[q] : T(0);
    }
  }

  // the sliced route's unsplit rows: rows first_row + g of the slice `chunk`,
  // a row for each group g of L = width / Q lanes, a lane Q = 16 / sizeof(T)
  // columns (one 16-byte load an entry), the groups in lockstep over rounds
  // of L entries to the longest of their rows. A split row is the front
  // warps'.
  __device__ __forceinline__ void run_rows(const long long* __restrict__ row_ptr, long long first_row, long long n_rows,
                                           long long piece, long long chunk, int lane, T* __restrict__ out) const {
    constexpr int Q = 16 / sizeof(T);
    const int L = (int)(width / Q);
    const int gl = lane % L;
    const long long row = first_row + lane / L;
    long long begin = 0, len = 0;
    if (row < n_rows) {
      begin = row_ptr[row];
      len = row_ptr[row + 1] - begin;
    }
    const bool mine = row < n_rows && len <= piece;
    if (!mine) len = 0;
    const long long col = chunk * width + gl * Q;
    const bool active = mine && col < r;
    const int n_max = (int)__reduce_max_sync(kFull, (unsigned)len);
    T acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = T(0);
    for (int s0 = 0; s0 < n_max; s0 += L) {
      const int cnt = (int)len - s0;
      int j = 0;
      T val = T(0);
      if (gl < cnt) {
        j = idx[begin + s0 + gl];
        val = w[begin + s0 + gl];
      }
      for (int t = 0; t < L; t += kLoads) {
        T x[kLoads][Q];
        T vt[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const long long jt = __shfl_sync(kFull, j, t + u, L);
          vt[u] = __shfl_sync(kFull, val, t + u, L);
          load<Q>(jt, col, active && t + u < cnt, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (t + u < L && t + u < cnt) {
#pragma unroll
            for (int q = 0; q < Q; ++q) acc[q] = fma_(vt[u], x[u][q], acc[q]);
          }
        }
      }
    }
    if (active) store<Q>(out + row * r, col, r, acc);
  }

  // the sum over entries [begin, end) of one segment, in entry order, from 0
  __device__ __forceinline__ void run(long long begin, long long end, long long col, bool active, int lane,
                                      T (&acc)[W]) const {
#pragma unroll
    for (int q = 0; q < W; ++q) acc[q] = T(0);
    for (long long s0 = begin; s0 < end; s0 += 32) {
      const int n = end - s0 < 32 ? (int)(end - s0) : 32;
      int j = 0;
      T val = T(0);
      if (lane < n) {
        j = idx[s0 + lane];
        val = w[s0 + lane];
      }
      for (int t = 0; t < n; t += kLoads) {
        T x[kLoads][W];
        T vt[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const long long jt = __shfl_sync(kFull, j, (t + u) & 31);
          vt[u] = __shfl_sync(kFull, val, (t + u) & 31);
          load<W>(jt, col, active && t + u < n, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (t + u < n) {
#pragma unroll
            for (int q = 0; q < W; ++q) acc[q] = fma_(vt[u], x[u][q], acc[q]);
          }
        }
      }
    }
  }
};

// The MTTKRP runs 8 CTAs of 256 threads on an SM: at most 32 registers,
// full occupancy. The gathers need every warp in flight; left free, the
// front path's registers (the piece search and the finish) cost the row
// path 10-20 % at the BASELINE scale (PERF.md), and capped, they spill about
// 100 bytes there. A warp owns a chunk of 32 * W columns of one piece or row
// (the chunk varies fastest), or on K5's sliced route a slice of `width`
// columns (the slice varies slowest: a slice's warps run before the next's).
template <typename S, typename T>
__global__ void __launch_bounds__(kThreads, S::kMinBlocks)
    run_sum_kernel(const long long* __restrict__ row_ptr, const long long* __restrict__ pieces, long long n_rows,
                   long long n_front, long long piece, const S sum, T* __restrict__ out, T* __restrict__ partial,
                   int* __restrict__ tickets) {
  constexpr int W = S::W;
  const long long r = sum.r;
  const long long wid = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  long long n_chunks, chunk, unit, col;
  bool active;
  if constexpr (S::kSliced) {
    // the front warps, then the row warps of G = 32 / L rows each
    const long long group = 32 / (sum.width / (16 / (long long)sizeof(T)));
    const long long units = n_front + (n_rows + group - 1) / group;
    n_chunks = (r + sum.width - 1) / sum.width;
    chunk = wid / units;
    unit = wid % units;
    if (chunk >= n_chunks) return;
    if (unit >= n_front) {
      sum.run_rows(row_ptr, (unit - n_front) * group, n_rows, piece, chunk, lane, out);
      return;
    }
    col = chunk * sum.width + lane * W;
    active = lane * W < sum.width && col < r;
  } else {
    n_chunks = (r + 32 * W - 1) / (32 * W);
    chunk = wid % n_chunks;  // the chunk varies fastest: a unit's chunks start together
    unit = wid / n_chunks;
    col = (chunk * 32 + lane) * W;
    active = col < r;
  }

  if (unit >= n_front) {  // an unsplit row (warp-uniform branches throughout)
    const long long row = unit - n_front;
    if (row >= n_rows) return;
    const long long begin = row_ptr[row], end = row_ptr[row + 1];
    // a row of the union route (its block's flag read beside the bounds, not
    // before them: 3 % of the flagged gather on short rows), or split: its
    // pieces belong to the front warps
    if (sum.skips(row) | (end - begin > piece)) return;
    T acc[W];
    sum.run(begin, end, col, active, lane, acc);
    if (active) store<W>(out + row * r, col, r, acc);
    return;
  }
  // front warp `unit` takes the pieces unit, unit + n_front, ... of the split rows
  const long long n_split = pieces[n_rows];
  for (long long u = unit; u < n_split; u += n_front) {
    // the split row holding piece u: pieces[row] <= u < pieces[row + 1]
    long long lo = 0, hi = n_rows;
    while (hi - lo > 1) {
      const long long mid = (lo + hi) / 2;
      if (pieces[mid] <= u) lo = mid;
      else hi = mid;
    }
    const long long row = lo;
    const long long first = pieces[row];
    const long long n_pieces = pieces[row + 1] - first;
    const long long run_end = row_ptr[row + 1];
    const long long begin = row_ptr[row] + (u - first) * piece;
    const long long end = run_end - begin < piece ? run_end : begin + piece;
    T acc[W];
    sum.run(begin, end, col, active, lane, acc);
    if (active) store<W>(partial + u * r, col, r, acc);
    __threadfence();  // the partial is visible before this warp's ticket
    __syncwarp();
    int* ticket = &tickets[first * n_chunks + chunk];
    int last = 0;
    if (lane == 0) last = atomicAdd(ticket, 1) == n_pieces - 1;
    last = __shfl_sync(kFull, last, 0);
    if (!last) continue;
    __threadfence();
    T total[W];
#pragma unroll
    for (int q = 0; q < W; ++q) total[q] = T(0);
    for (long long p = 0; p < n_pieces; ++p) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        if (active && col + q < r) total[q] += __ldcg(&partial[(first + p) * r + col + q]);
      }
    }
    if (active) store<W>(out + row * r, col, r, total);
    if (lane == 0) *ticket = 0;
  }
}

template <typename S, typename T>
int launch(const void* row_ptr, const void* pieces, long long n_rows, long long n_front, long long piece,
           const S& sum, void* out, void* partial, void* tickets, void* stream) {
  if (n_rows == 0 || sum.r == 0) return 0;
  if (piece <= 0 || n_front < 0) return (int)cudaErrorInvalidValue;
  // the front warps stride over the pieces: a fixed set, all resident in the first wave
  const long long front = n_front < kFrontWarps ? n_front : kFrontWarps;
  long long warps;
  if constexpr (S::kSliced) {
    const long long group = 32 / (sum.width / (16 / (long long)sizeof(T)));
    warps = (front + (n_rows + group - 1) / group) * ((sum.r + sum.width - 1) / sum.width);
  } else {
    warps = (front + n_rows) * ((sum.r + 32 * S::W - 1) / (32 * S::W));
  }
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  run_sum_kernel<S, T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)row_ptr, (const long long*)pieces, n_rows, front, piece, sum, (T*)out, (T*)partial,
      (int*)tickets);
  return (int)cudaGetLastError();
}

template <typename TT, typename T>
int launch_mttkrp(const void* row_ptr, const void* pieces, const void* order, long long n_rows, long long n_front,
                  long long piece, const void* cj, const void* ck, const void* v, const void* C, const void* D,
                  long long r, void* out, void* partial, void* tickets, void* stream) {
  const MttkrpSum<TT, T> sum{(const int*)order, (const int*)cj, (const int*)ck, (const T*)v,
                             (const TT*)C,      (const TT*)D,   r};
  return launch<MttkrpSum<TT, T>, T>(row_ptr, pieces, n_rows, n_front, piece, sum, out, partial, tickets, stream);
}

// the gather route; with `flag`, only the rows of the blocks it marks
template <typename T>
int launch_row_sum(const void* row_ptr, const void* pieces, long long n_rows, long long n_front, long long piece,
                   const void* idx, const void* w, const void* table, long long ld, long long vec, long long r,
                   void* out, void* partial, void* tickets, const void* flag, long long block, void* stream) {
  if (flag != nullptr && block <= 0) return (int)cudaErrorInvalidValue;
  const RowSum<T, false> sum{(const int*)idx, (const T*)w, (const T*)table, ld, vec, r, (const bool*)flag, block, 0};
  return launch<RowSum<T, false>, T>(row_ptr, pieces, n_rows, n_front, piece, sum, out, partial, tickets, stream);
}

// the sliced route: one grid numbered slice-major
template <typename T>
int launch_row_sum_sliced(const void* row_ptr, const void* pieces, long long n_rows, long long n_front,
                          long long piece, const void* idx, const void* w, const void* table, long long ld,
                          long long vec, long long r, void* out, void* partial, void* tickets, long long width,
                          void* stream) {
  // the front warps: a lane a column; the row warps: L = width / Q lanes a row, 32 % L == 0
  constexpr long long Q = 16 / sizeof(T);
  if (width <= 0 || width > 32 || width % Q != 0 || 32 % (width / Q) != 0) return (int)cudaErrorInvalidValue;
  const RowSum<T, true> sum{(const int*)idx, (const T*)w, (const T*)table, ld, vec, r, nullptr, 1, width};
  return launch<RowSum<T, true>, T>(row_ptr, pieces, n_rows, n_front, piece, sum, out, partial, tickets, stream);
}

// ---- the union route ----

constexpr int kUnionMaxThreads = ROW_SUM_UNION_THREADS;  // a CTA's threads at most: 16 warps of 4 segments
constexpr int kUnionCols = 32;                            // columns a chunk of a block's union rows

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One segment of a block for each group of L = 32 / (16 / sizeof(T)) lanes of
// the warp (4 segments a warp in float32, 2 in float64), a lane 16 bytes of
// the chunk's 32 columns: one 16-byte shared-memory load an entry a lane and
// two shuffles an entry a group. The groups walk their segments in lockstep
// (rounds of L entries to the longest of them, the next round's entries
// loaded before this round's sums: 6 % at the attention shape); each
// element is one FMA chain a piece in entry order, a split segment's pieces
// added from 0 in piece order.
template <typename T>
__device__ __forceinline__ void union_rows(const T* rows_s, const short* __restrict__ local, const T* __restrict__ w,
                                           const long long* __restrict__ ptr, long long row, bool valid,
                                           long long piece, long long c0, long long r, int lane,
                                           T* __restrict__ out) {
  constexpr int Q = 16 / sizeof(T);
  constexpr int L = kUnionCols / Q;
  constexpr int kLoads = ROW_SUM_UNION_LOADS;
  const int gl = lane % L;
  const long long begin = valid ? ptr[row] : 0;
  const long long len = valid ? ptr[row + 1] - begin : 0;
  const bool split = len > piece;
  const long long col = c0 + gl * Q;
  const bool active = valid && col < r;
  const long long n_max = (long long)__reduce_max_sync(kFull, (unsigned)len);
  T acc[Q], total[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = total[q] = T(0);
  long long pend = len < piece ? len : piece;  // where the current piece ends
  int l_next = 0;
  T val_next = T(0);
  if (gl < len) {
    l_next = local[begin + gl];
    val_next = w[begin + gl];
  }
  for (long long s0 = 0; s0 < n_max; s0 += L) {
    const long long cnt = len - s0;
    const int l = l_next;
    const T val = val_next;
    // the next round's entries in flight during this round's sums
    l_next = 0;
    val_next = T(0);
    if (gl + L < cnt) {
      l_next = local[begin + s0 + L + gl];
      val_next = w[begin + s0 + L + gl];
    }
    for (int t = 0; t < L; t += kLoads) {
      T x[kLoads][Q];
      T vt[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int lt = __shfl_sync(kFull, l, t + u, L);
        vt[u] = __shfl_sync(kFull, val, t + u, L);
        Pack<T, Q>::split(*reinterpret_cast<const typename Pack<T, Q>::type*>(rows_s + lt * kUnionCols + gl * Q),
                          x[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const long long e = s0 + t + u;
        if (t + u < L && e < len) {
#pragma unroll
          for (int q = 0; q < Q; ++q) acc[q] = fma_(vt[u], x[u][q], acc[q]);
          if (split && e + 1 == pend) {  // a piece ends: the gather route's finish, ((0 + p0) + p1) + ...
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              total[q] += acc[q];
              acc[q] = T(0);
            }
            pend = len - pend < piece ? len : pend + piece;
          }
        }
      }
    }
  }
  if (active && split) store<Q>(out + row * r, col, r, total);
  if (active && !split) store<Q>(out + row * r, col, r, acc);
}

// A persistent grid over the items (unflagged block, 32-column chunk): the
// block's union rows' chunk copied into shared memory (16 bytes a copy where
// the rows allow it), then each group of lanes sums one segment of the block
// from there and stores it.
template <typename T>
__global__ void __launch_bounds__(kUnionMaxThreads, 2)
    row_sum_union_kernel(const long long* __restrict__ ptr, const short* __restrict__ local, const T* __restrict__ w,
                         const T* __restrict__ table, long long ld, long long vec, long long r,
                         const int* __restrict__ keys, const int* __restrict__ n_union, long long u_cap,
                         const int* __restrict__ work, const int* __restrict__ n_work, long long block,
                         long long n_rows, long long piece, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows_s = reinterpret_cast<T*>(smem_raw);  // u_cap rows of kUnionCols values
  constexpr int kVec = 16 / sizeof(T);          // values a 16-byte copy
  constexpr int kParts = kUnionCols / kVec;     // 16-byte copies a row's chunk
  constexpr int G = 32 / kParts;                // segments a warp
  const long long n_chunks = (r + kUnionCols - 1) / kUnionCols;
  const long long items = (long long)*n_work * n_chunks;
  const int lane = threadIdx.x & 31;
  const long long warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long b = work[item / n_chunks];
    const long long c0 = (item % n_chunks) * kUnionCols;
    const long long nu = n_union[b] < u_cap ? n_union[b] : u_cap;
    const int* __restrict__ kb = keys + b * u_cap;
    if (vec) {
      for (long long p = threadIdx.x; p < nu * kParts; p += blockDim.x) {
        const long long u = p / kParts, c = c0 + (p % kParts) * kVec;
        if (c < r) cp_async<16>(rows_s + u * kUnionCols + (c - c0), table + (long long)kb[u] * ld + c);
      }
    } else {
      for (long long p = threadIdx.x; p < nu * kUnionCols; p += blockDim.x) {
        const long long u = p / kUnionCols, c = c0 + p % kUnionCols;
        if (c < r) cp_async<sizeof(T)>(rows_s + u * kUnionCols + (c - c0), table + (long long)kb[u] * ld + c);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const long long seg_end = (b + 1) * block < n_rows ? (b + 1) * block : n_rows;
    for (long long s = b * block + warp * G; s < seg_end; s += n_warps * G) {
      const long long row = s + lane / kParts;
      union_rows<T>(rows_s, local, w, ptr, row, row < seg_end, piece, c0, r, lane, out);
    }
    __syncthreads();  // every warp is done with these rows before the next item's copies
  }
}

template <typename T>
int launch_row_sum_union(const void* ptr, const void* local, const void* w, const void* table, long long ld,
                         long long vec, long long r, const void* keys, const void* n_union, long long u_cap,
                         const void* work, const void* n_work, long long n_blocks, long long block, long long n_rows,
                         long long piece, long long sms, void* out, void* stream) {
  if (n_rows == 0 || r == 0 || n_blocks == 0) return 0;
  if (piece <= 0 || block <= 0 || u_cap <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const long long smem = u_cap * kUnionCols * (long long)sizeof(T);
  // a warp a G segments of the block, at most kUnionMaxThreads
  constexpr long long G = 32 / (kUnionCols / (16 / sizeof(T)));
  long long threads = (block + G - 1) / G * 32;
  if (threads > kUnionMaxThreads) threads = kUnionMaxThreads;
  if (smem > (48 << 10)) {
    const cudaError_t e =
        cudaFuncSetAttribute(row_sum_union_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // the CTAs an SM that these threads and this shared memory leave, asked once a shape
  static long long cached_smem = -1, cached_threads = -1;
  static int cached_per_sm = 0;
  if (smem != cached_smem || threads != cached_threads) {
    int per_sm = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_sum_union_kernel<T>, (int)threads, (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    cached_per_sm = per_sm;
    cached_smem = smem;
    cached_threads = threads;
  }
  if (cached_per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long items = n_blocks * ((r + kUnionCols - 1) / kUnionCols);
  // at most every CTA the SMs hold and at least one an SM, whatever the
  // items: the flagged blocks' gather launched beside it then finds every SM
  // alike (left without a union CTA, a few SMs took more of its front CTAs,
  // whose pieces are dealt out in a fixed stride: 0.2133 against the gather
  // route's 0.1888 ms where every block is flagged, 0.1803 with the SMs
  // alike; chip_row_sum_ablation.py, PERF.md)
  long long grid = items < sms * cached_per_sm ? items : sms * cached_per_sm;
  if (grid < sms) grid = sms;
  row_sum_union_kernel<T><<<(unsigned)grid, (unsigned)threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const long long*)ptr, (const short*)local, (const T*)w, (const T*)table, ld, vec, r, (const int*)keys,
      (const int*)n_union, u_cap, (const int*)work, (const int*)n_work, block, n_rows, piece, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define ST_MTTKRP(NAME, TT, T)                                                                                     \
  int NAME(const void* row_ptr, const void* pieces, const void* order, long long n_rows, long long n_front,        \
           long long piece, const void* cj, const void* ck, const void* v, const void* C, const void* D,           \
           long long r, void* out, void* partial, void* tickets, void* stream) {                                   \
    return launch_mttkrp<TT, T>(row_ptr, pieces, order, n_rows, n_front, piece, cj, ck, v, C, D, r, out, partial,  \
                                tickets, stream);                                                                  \
  }

ST_MTTKRP(st_mttkrp_f32, float, float)
ST_MTTKRP(st_mttkrp_f64, double, double)
ST_MTTKRP(st_mttkrp_bf16_f32, __nv_bfloat16, float)
ST_MTTKRP(st_mttkrp_bf16_f64, __nv_bfloat16, double)

// the gather route (flag null: every row; else the rows of the blocks it marks), the sliced route, the union route
#define ST_ROW_SUM(SUFFIX, T)                                                                                      \
  int st_row_sum_##SUFFIX(const void* row_ptr, const void* pieces, long long n_rows, long long n_front,            \
                          long long piece, const void* idx, const void* w, const void* table, long long ld,         \
                          long long vec, long long r, void* out, void* partial, void* tickets, const void* flag,    \
                          long long block, void* stream) {                                                          \
    return launch_row_sum<T>(row_ptr, pieces, n_rows, n_front, piece, idx, w, table, ld, vec, r, out, partial,     \
                             tickets, flag, block, stream);                                                        \
  }                                                                                                                \
  int st_row_sum_sliced_##SUFFIX(const void* row_ptr, const void* pieces, long long n_rows, long long n_front,     \
                                 long long piece, const void* idx, const void* w, const void* table, long long ld,  \
                                 long long vec, long long r, void* out, void* partial, void* tickets,               \
                                 long long width, void* stream) {                                                   \
    return launch_row_sum_sliced<T>(row_ptr, pieces, n_rows, n_front, piece, idx, w, table, ld, vec, r, out,      \
                                    partial, tickets, width, stream);                                              \
  }                                                                                                                \
  int st_row_sum_union_##SUFFIX(const void* ptr, const void* local, const void* w, const void* table, long long ld, \
                                long long vec, long long r, const void* keys, const void* n_union, long long u_cap, \
                                const void* work, const void* n_work, long long n_blocks, long long block,          \
                                long long n_rows, long long piece, long long sms, void* out, void* stream) {        \
    return launch_row_sum_union<T>(ptr, local, w, table, ld, vec, r, keys, n_union, u_cap, work, n_work, n_blocks, \
                                   block, n_rows, piece, sms, out, stream);                                        \
  }

ST_ROW_SUM(f32, float)
ST_ROW_SUM(f64, double)

}  // extern "C"
