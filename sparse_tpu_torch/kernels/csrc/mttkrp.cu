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
// Design: one warp per (output row, 32-column chunk of r); lane l owns column
// chunk * 32 + l (masked past r, so r = 25 or 64 work as well as 32). The
// warp walks its row's run 32 slots at a time: each lane loads one slot's
// (j, k, v), coalesced in the sorted-COO form, then the warp broadcasts them
// with shuffles and every lane gathers its column of C[j] and D[k] (one
// 128-byte row segment per warp at f32, r = 32) and accumulates with FMA in
// registers. The run is summed in order by one warp and stored once, so the
// result is deterministic, every output row is written exactly once (an
// empty row stores zeros: no memset) and nothing uses atomics. Offsets are
// 64-bit.
//
// Precision: T = float or double accumulates in T; the "bf16" strategy reads
// bf16 tables (TT = __nv_bfloat16), multiplies the two factors in float
// (exact: two 8-bit mantissas), converts to T and multiplies by v in T, as
// sparse_tpu's `e_data * g.astype(e_data.dtype)`.
//
// Bound on this card at the BASELINE scale (100k x 2k x 2k, 10M entries,
// r = 32): bytes. Each slot is read once (j, k, v, order: 16 bytes) and
// does 3 * r flops; C and D (256 KB each) stay in L2, but every slot
// gathers two 128-byte factor rows from it, 2.6 GB per call. That L2
// gather traffic, not HBM, is what this simple form lives on; tiling rows
// of C and D in shared memory or sorting a row's slots by j would cut it;
// that is work for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one output row each

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

template <typename TT, typename T>
__global__ void __launch_bounds__(kThreads) mttkrp_kernel(const long long* __restrict__ row_ptr,
                                                          const int* __restrict__ order, long long n_rows,
                                                          const int* __restrict__ cj, const int* __restrict__ ck,
                                                          const T* __restrict__ v, const TT* __restrict__ C,
                                                          const TT* __restrict__ D, long long r,
                                                          T* __restrict__ out) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long col = (long long)blockIdx.y * 32 + lane;
  const bool active = col < r;
  const long long begin = row_ptr[row];
  const long long end = row_ptr[row + 1];
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
  if (active) out[row * r + col] = acc;
}

template <typename TT, typename T>
int launch(const void* row_ptr, const void* order, long long n_rows, const void* cj, const void* ck, const void* v,
           const void* C, const void* D, long long r, void* out, void* stream) {
  if (n_rows == 0 || r == 0) return 0;
  const long long blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long chunks = (r + 31) / 32;
  if (blocks > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  mttkrp_kernel<TT, T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)row_ptr, (const int*)order, n_rows, (const int*)cj, (const int*)ck, (const T*)v,
      (const TT*)C, (const TT*)D, r, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int st_mttkrp_f32(const void* row_ptr, const void* order, long long n_rows, const void* cj, const void* ck,
                  const void* v, const void* C, const void* D, long long r, void* out, void* stream) {
  return launch<float, float>(row_ptr, order, n_rows, cj, ck, v, C, D, r, out, stream);
}

int st_mttkrp_f64(const void* row_ptr, const void* order, long long n_rows, const void* cj, const void* ck,
                  const void* v, const void* C, const void* D, long long r, void* out, void* stream) {
  return launch<double, double>(row_ptr, order, n_rows, cj, ck, v, C, D, r, out, stream);
}

int st_mttkrp_bf16_f32(const void* row_ptr, const void* order, long long n_rows, const void* cj, const void* ck,
                       const void* v, const void* C, const void* D, long long r, void* out, void* stream) {
  return launch<__nv_bfloat16, float>(row_ptr, order, n_rows, cj, ck, v, C, D, r, out, stream);
}

int st_mttkrp_bf16_f64(const void* row_ptr, const void* order, long long n_rows, const void* cj, const void* ck,
                       const void* v, const void* C, const void* D, long long r, void* out, void* stream) {
  return launch<__nv_bfloat16, double>(row_ptr, order, n_rows, cj, ck, v, C, D, r, out, stream);
}

}  // extern "C"
