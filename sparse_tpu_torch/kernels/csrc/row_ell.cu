// Row-ELL SpMV (K1) and SpMM (K2) for Hopper (sm_90a), plain C interface
// for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Layout (sparse_tpu_torch/kernels/row_ell.py:build_row_ell): rows are
// relabelled by descending degree into "padded positions" and cut into
// tiers. Tier t holds positions [pos0, pos0 + rows) and stores its entries
// at flat offset `offset` either grouped, shape (rows/G, width, G), or
// legacy, shape (rows, width), which is the grouped form with G = 1. So the
// j-th entry of position p sits at
//     offset + ((p - pos0) / G) * width * G + (p - pos0) % G + j * G.
// The tier table is int64 (n_tiers, 4): pos0, width, G, offset. Its last
// tier is the block of rows without entries (width 0). row_of_pos maps a
// position to its original row, or -1 for group padding, so the unpermute
// is fused into the store and every output row is written exactly once:
// outputs need no memset.
//
// Both kernels accumulate in the data type (f32 for f32, f64 for f64).

#include <cuda_runtime.h>

namespace {

struct Tier {
  long long pos0, width, group, offset;
};

// The tier holding position p: the last one whose first position is <= p.
// At most a few dozen tiers, so a binary search over the table (L1-resident).
__device__ __forceinline__ Tier find_tier(const long long* __restrict__ table, int n_tiers, long long p) {
  int lo = 0, hi = n_tiers - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[4 * mid] <= p) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* t = table + 4 * lo;
  return Tier{t[0], t[1], t[2], t[3]};
}

__device__ __forceinline__ long long first_entry(const Tier& t, long long p) {
  const long long q = p - t.pos0;
  return t.offset + (q / t.group) * t.width * t.group + (q % t.group);
}

// K1: out[row(p)] = (y ? y[row(p)] : 0) + sum_j data[p, j] * x[cols[p, j]].
//
// Replaces sparse_tpu/kernels/row_ell.py:_onehot_products_call (the Pallas
// one-hot MXU pick of x from a bf16 hi|lo table in VMEM, behind
// _spmv_onehot) and the exact XLA _spmv with its lane-select unpermute. The
// one-hot pick and the hi|lo split work around the TPU's gather rate; here
// each thread reads x[cols[e]] directly, through L1/L2 (x is K * 4 bytes,
// L2-resident at any K the layout allows), so the product is exact.
//
// Bound on this card: bytes. Each entry moves 4 (col) + sizeof(T) (value)
// bytes plus a sizeof(T) gather of x, with two flops per entry. Design: one
// thread per padded position; the 16 threads of a group read 16 consecutive
// cols/data words for each j, so the index and value streams coalesce as
// stored. All tiers run in one launch (the tier is found per thread), and
// the optional y makes A @ x + y one pass.
template <typename T>
__global__ void __launch_bounds__(256) row_ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ data,
                                                           const T* __restrict__ x, const T* __restrict__ y,
                                                           T* __restrict__ out, const long long* __restrict__ table,
                                                           int n_tiers, const int* __restrict__ row_of_pos,
                                                           long long n_pos) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pos) return;
  const int row = row_of_pos[p];
  if (row < 0) return;  // group padding: no output row
  const Tier t = find_tier(table, n_tiers, p);
  const long long base = first_entry(t, p);
  T acc = T(0);
#pragma unroll 4
  for (long long j = 0; j < t.width; ++j) {
    const long long e = base + j * t.group;
    acc += data[e] * x[cols[e]];
  }
  out[row] = (y != nullptr ? y[row] : T(0)) + acc;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// K2: out[row(p), c] = sum_j data[p, j] * B[cols[p, j], c].
//
// Replaces the XLA gather-multiply-reduce _spmm of
// sparse_tpu/kernels/row_ell.py (no Pallas kernel there). In eager PyTorch
// that form would write the whole gathered (r/G, w, G, N) block to memory;
// here it never leaves registers. The TPU's w-split (SPMM_WSPLIT) is not
// carried over: it only changed the rounding order of the sum over j.
//
// Bound on this card: bytes (B read, out written, cols/data streamed; two
// flops per entry and column is far under the f32 rate). B fits in the 50 MB
// L2 at the main path's shape, so gathers after the first touch of a row hit
// L2. Design: one warp per (position, column tile); each lane holds VEC
// consecutive values (float4 / double2, 16 bytes), so each gathered row
// segment of B is one coalesced 512-byte read, the sum stays in registers
// and the unpermuted output row is stored once. The col/data words are warp
// broadcasts. Offsets into B and out are 64-bit. VEC = 1 serves a ragged N
// or a B not 16-byte aligned.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) row_ell_spmm_kernel(const int* __restrict__ cols, const T* __restrict__ data,
                                                           const T* __restrict__ B, long long ldb, T* __restrict__ out,
                                                           long long n, const long long* __restrict__ table,
                                                           int n_tiers, const int* __restrict__ row_of_pos,
                                                           long long n_pos) {
  const long long p = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= n_pos) return;
  const int row = row_of_pos[p];
  if (row < 0) return;
  const long long c0 = ((long long)blockIdx.y * 32 + (threadIdx.x & 31)) * VEC;
  if (c0 >= n) return;  // ragged last column tile (VEC > 1 only with n % VEC == 0)
  const Tier t = find_tier(table, n_tiers, p);
  const long long base = first_entry(t, p);
  T acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
#pragma unroll 4
  for (long long j = 0; j < t.width; ++j) {
    const long long e = base + j * t.group;
    const T d = data[e];
    const Pack<T, VEC> b = *reinterpret_cast<const Pack<T, VEC>*>(B + (long long)cols[e] * ldb + c0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += d * b.v[v];
  }
  Pack<T, VEC> o;
#pragma unroll
  for (int v = 0; v < VEC; ++v) o.v[v] = acc[v];
  *reinterpret_cast<Pack<T, VEC>*>(out + (long long)row * n + c0) = o;
}

constexpr int kThreads = 256;

template <typename T>
int launch_spmv(const void* cols, const void* data, const void* x, const void* y, void* out, const void* table,
                long long n_tiers, const void* row_of_pos, long long n_pos, void* stream) {
  const long long blocks = (n_pos + kThreads - 1) / kThreads;
  row_ell_spmv_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)data, (const T*)x, (const T*)y, (T*)out, (const long long*)table, (int)n_tiers,
      (const int*)row_of_pos, n_pos);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_spmm_vec(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                    const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, void* stream) {
  const long long warps_per_block = kThreads / 32;
  const dim3 grid((unsigned)((n_pos + warps_per_block - 1) / warps_per_block),
                  (unsigned)((n + 32 * VEC - 1) / (32 * VEC)));
  row_ell_spmm_kernel<T, VEC><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)data, (const T*)B, ldb, (T*)out, n, (const long long*)table, (int)n_tiers,
      (const int*)row_of_pos, n_pos);
  return (int)cudaGetLastError();
}

template <typename T, int WIDE>
int launch_spmm(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long vec,
                void* stream) {
  if (vec == WIDE) {
    return launch_spmm_vec<T, WIDE>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, stream);
  }
  if (vec == 1) {
    return launch_spmm_vec<T, 1>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int st_row_ell_spmv_f32(const void* cols, const void* data, const void* x, const void* y, void* out,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos,
                        void* stream) {
  return launch_spmv<float>(cols, data, x, y, out, table, n_tiers, row_of_pos, n_pos, stream);
}

int st_row_ell_spmv_f64(const void* cols, const void* data, const void* x, const void* y, void* out,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos,
                        void* stream) {
  return launch_spmv<double>(cols, data, x, y, out, table, n_tiers, row_of_pos, n_pos, stream);
}

int st_row_ell_spmm_f32(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long vec,
                        void* stream) {
  return launch_spmm<float, 4>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, vec, stream);
}

int st_row_ell_spmm_f64(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long vec,
                        void* stream) {
  return launch_spmm<double, 2>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, vec, stream);
}

}  // extern "C"
