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
// row stride with unit stride along K; a lane owns V consecutive columns (4
// floats, 2 doubles: 16-byte loads where the rows are 16-byte aligned) and
// keeps 4 entries' loads in flight. Bound: bytes (the table rows touched
// once, the entries' index and weight, the output once); this design reads
// every entry's table row from L2, its floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// K5's loads in flight and registers, as chip_k4_ablation.py varies them
#ifndef ROW_SUM_LOADS
#define ROW_SUM_LOADS 4
#endif
#ifndef ROW_SUM_MIN_BLOCKS
#define ROW_SUM_MIN_BLOCKS 4
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
};

template <typename T>
struct Wide;
template <>
struct Wide<float> {
  using type = float4;
  static __device__ __forceinline__ void split(float4 x, float (&y)[4]) {
    y[0] = x.x, y[1] = x.y, y[2] = x.z, y[3] = x.w;
  }
  static __device__ __forceinline__ float4 join(const float (&y)[4]) { return make_float4(y[0], y[1], y[2], y[3]); }
};
template <>
struct Wide<double> {
  using type = double2;
  static __device__ __forceinline__ void split(double2 x, double (&y)[2]) { y[0] = x.x, y[1] = x.y; }
  static __device__ __forceinline__ double2 join(const double (&y)[2]) { return make_double2(y[0], y[1]); }
};

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// K5's sum: a lane owns W = 16 / sizeof(T) consecutive columns of w[s] * table[idx[s]].
template <typename T>
struct RowSum {
  static constexpr int W = 16 / sizeof(T);
  static constexpr int kLoads = ROW_SUM_LOADS;           // entries' table rows in flight
  static constexpr int kMinBlocks = ROW_SUM_MIN_BLOCKS;  // at most 64 registers: the loads in flight need them
  const int* __restrict__ idx;
  const T* __restrict__ w;
  const T* __restrict__ table;
  long long ld;   // elements from a table row to the next
  long long vec;  // 16-byte aligned rows and r % W == 0: 16-byte loads
  long long r;

  __device__ __forceinline__ void load(long long j, long long col, bool active, T (&x)[W]) const {
    const T* row = table + j * ld + col;
    if (active && vec) {
      Wide<T>::split(*reinterpret_cast<const typename Wide<T>::type*>(row), x);
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q) x[q] = active && col + q < r ? row[q] : T(0);
    }
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
          load(jt, col, active && t + u < n, x[u]);
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

// the W values a lane owns into dst (a row of r values), those inside it
template <int W, typename T>
__device__ __forceinline__ void store(T* dst, long long col, long long r, const T (&x)[W]) {
  if constexpr (W > 1) {
    if (r % W == 0) {
      *reinterpret_cast<typename Wide<T>::type*>(dst + col) = Wide<T>::join(x);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < W; ++q) {
    if (col + q < r) dst[col + q] = x[q];
  }
}

// The MTTKRP runs 8 CTAs of 256 threads on an SM: at most 32 registers,
// full occupancy. The gathers need every warp in flight; left free, the
// front path's registers (the piece search and the finish) cost the row
// path 10-20 % at the BASELINE scale (PERF.md), and capped, they spill about
// 100 bytes there. A warp owns a chunk of 32 * W columns of one piece or row.
template <typename S, typename T>
__global__ void __launch_bounds__(kThreads, S::kMinBlocks)
    run_sum_kernel(const long long* __restrict__ row_ptr, const long long* __restrict__ pieces, long long n_rows,
                   long long n_front, long long piece, const S sum, T* __restrict__ out, T* __restrict__ partial,
                   int* __restrict__ tickets) {
  constexpr int W = S::W;
  const long long r = sum.r;
  const long long n_chunks = (r + 32 * W - 1) / (32 * W);
  const long long wid = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long chunk = wid % n_chunks;  // the chunk varies fastest: a unit's chunks start together
  const long long unit = wid / n_chunks;
  const int lane = threadIdx.x & 31;
  const long long col = (chunk * 32 + lane) * W;
  const bool active = col < r;

  if (unit >= n_front) {  // an unsplit row (warp-uniform branches throughout)
    const long long row = unit - n_front;
    if (row >= n_rows) return;
    const long long begin = row_ptr[row], end = row_ptr[row + 1];
    if (end - begin > piece) return;  // split: its pieces belong to the front warps
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
  const long long warps = (front + n_rows) * ((sum.r + 32 * S::W - 1) / (32 * S::W));
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

template <typename T>
int launch_row_sum(const void* row_ptr, const void* pieces, long long n_rows, long long n_front, long long piece,
                   const void* idx, const void* w, const void* table, long long ld, long long vec, long long r,
                   void* out, void* partial, void* tickets, void* stream) {
  const RowSum<T> sum{(const int*)idx, (const T*)w, (const T*)table, ld, vec, r};
  return launch<RowSum<T>, T>(row_ptr, pieces, n_rows, n_front, piece, sum, out, partial, tickets, stream);
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

#define ST_ROW_SUM(NAME, T)                                                                                        \
  int NAME(const void* row_ptr, const void* pieces, long long n_rows, long long n_front, long long piece,          \
           const void* idx, const void* w, const void* table, long long ld, long long vec, long long r, void* out, \
           void* partial, void* tickets, void* stream) {                                                           \
    return launch_row_sum<T>(row_ptr, pieces, n_rows, n_front, piece, idx, w, table, ld, vec, r, out, partial,     \
                             tickets, stream);                                                                     \
  }

ST_ROW_SUM(st_row_sum_f32, float)
ST_ROW_SUM(st_row_sum_f64, double)

}  // extern "C"
