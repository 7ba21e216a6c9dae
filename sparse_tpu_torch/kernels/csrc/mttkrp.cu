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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one (piece or row, chunk) each
constexpr int kWarps = kThreads / 32;
constexpr long long kFrontWarps = 2048;  // per 32-column chunk: 256 CTAs, resident at once

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

// The sum over slots [begin, end) of one run, in slot order, from 0.
template <typename TT, typename T>
__device__ __forceinline__ T run_sum(long long begin, long long end, const int* __restrict__ order,
                                     const int* __restrict__ cj, const int* __restrict__ ck,
                                     const T* __restrict__ v, const TT* __restrict__ C, const TT* __restrict__ D,
                                     long long r, long long col, bool active, int lane) {
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
      const long long jt = __shfl_sync(0xffffffffu, j, t);
      const long long kt = __shfl_sync(0xffffffffu, k, t);
      const T vt = __shfl_sync(0xffffffffu, val, t);
      if (active) acc += vt * Product<TT, T>::of(C[jt * r + col], D[kt * r + col]);
    }
  }
  return acc;
}

// 8 CTAs of 256 threads on an SM: at most 32 registers, full occupancy. The
// gathers need every warp in flight; left free, the front path's registers
// (the piece search and the finish) cost the row path 10-20 % at the
// BASELINE scale (PERF.md), and capped, they spill about 100 bytes there.
template <typename TT, typename T>
__global__ void __launch_bounds__(kThreads, 8)
    mttkrp_kernel(const long long* __restrict__ row_ptr, const long long* __restrict__ pieces,
                  const int* __restrict__ order, long long n_rows, long long n_front, long long piece,
                  const int* __restrict__ cj, const int* __restrict__ ck, const T* __restrict__ v,
                  const TT* __restrict__ C, const TT* __restrict__ D, long long r, T* __restrict__ out,
                  T* __restrict__ partial, int* __restrict__ tickets) {
  const long long n_chunks = (r + 31) / 32;
  const long long wid = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long chunk = wid % n_chunks;  // the chunk varies fastest: a unit's chunks start together
  const long long unit = wid / n_chunks;
  const int lane = threadIdx.x & 31;
  const long long col = chunk * 32 + lane;
  const bool active = col < r;

  if (unit >= n_front) {  // an unsplit row (warp-uniform branches throughout)
    const long long row = unit - n_front;
    if (row >= n_rows) return;
    const long long begin = row_ptr[row], end = row_ptr[row + 1];
    if (end - begin > piece) return;  // split: its pieces belong to the front warps
    const T acc = run_sum<TT, T>(begin, end, order, cj, ck, v, C, D, r, col, active, lane);
    if (active) out[row * r + col] = acc;
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
    const T acc = run_sum<TT, T>(begin, end, order, cj, ck, v, C, D, r, col, active, lane);
    if (active) partial[u * r + col] = acc;
    __threadfence();  // the partial is visible before this warp's ticket
    __syncwarp();
    int* ticket = &tickets[first * n_chunks + chunk];
    int last = 0;
    if (lane == 0) last = atomicAdd(ticket, 1) == n_pieces - 1;
    last = __shfl_sync(0xffffffffu, last, 0);
    if (!last) continue;
    __threadfence();
    T sum = T(0);
    for (long long q = 0; q < n_pieces; ++q) {
      if (active) sum += __ldcg(&partial[(first + q) * r + col]);
    }
    if (active) out[row * r + col] = sum;
    if (lane == 0) *ticket = 0;
  }
}

template <typename TT, typename T>
int launch(const void* row_ptr, const void* pieces, const void* order, long long n_rows, long long n_front,
           long long piece, const void* cj, const void* ck, const void* v, const void* C, const void* D, long long r,
           void* out, void* partial, void* tickets, void* stream) {
  if (n_rows == 0 || r == 0) return 0;
  if (piece <= 0 || n_front < 0) return (int)cudaErrorInvalidValue;
  // the front warps stride over the pieces: a fixed set, all resident in the first wave
  const long long front = n_front < kFrontWarps ? n_front : kFrontWarps;
  const long long warps = (front + n_rows) * ((r + 31) / 32);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mttkrp_kernel<TT, T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)row_ptr, (const long long*)pieces, (const int*)order, n_rows, front, piece,
      (const int*)cj, (const int*)ck, (const T*)v, (const TT*)C, (const TT*)D, r, (T*)out, (T*)partial,
      (int*)tickets);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int st_mttkrp_f32(const void* row_ptr, const void* pieces, const void* order, long long n_rows, long long n_front,
                  long long piece, const void* cj, const void* ck, const void* v, const void* C, const void* D,
                  long long r, void* out, void* partial, void* tickets, void* stream) {
  return launch<float, float>(row_ptr, pieces, order, n_rows, n_front, piece, cj, ck, v, C, D, r, out, partial, tickets,
                              stream);
}

int st_mttkrp_f64(const void* row_ptr, const void* pieces, const void* order, long long n_rows, long long n_front,
                  long long piece, const void* cj, const void* ck, const void* v, const void* C, const void* D,
                  long long r, void* out, void* partial, void* tickets, void* stream) {
  return launch<double, double>(row_ptr, pieces, order, n_rows, n_front, piece, cj, ck, v, C, D, r, out, partial, tickets,
                                stream);
}

int st_mttkrp_bf16_f32(const void* row_ptr, const void* pieces, const void* order, long long n_rows, long long n_front,
                       long long piece, const void* cj, const void* ck, const void* v, const void* C, const void* D,
                       long long r, void* out, void* partial, void* tickets, void* stream) {
  return launch<__nv_bfloat16, float>(row_ptr, pieces, order, n_rows, n_front, piece, cj, ck, v, C, D, r, out, partial, tickets,
                                      stream);
}

int st_mttkrp_bf16_f64(const void* row_ptr, const void* pieces, const void* order, long long n_rows, long long n_front,
                       long long piece, const void* cj, const void* ck, const void* v, const void* C, const void* D,
                       long long r, void* out, void* partial, void* tickets, void* stream) {
  return launch<__nv_bfloat16, double>(row_ptr, pieces, order, n_rows, n_front, piece, cj, ck, v, C, D, r, out, partial, tickets,
                                       stream);
}


}  // extern "C"
