// Sampled dense-dense matmul (SDDMM) for Hopper (sm_90a), plain C interface
// for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
//   out[e] = s[e] * sum_k lhs[rows[e], k] * rhs_t[cols[e], k]
//
// K4. Replaces sparse_tpu/kernels/dot.py:sddmm, which is XLA code, not
// Pallas: it gathers lhs[rows] and rhs.T[cols] as two (nnz, K) blocks,
// multiplies and sums them, and above 131,072 entries runs a lax.scan over
// chunks of 32,768 to keep the two blocks out of HBM. Eager PyTorch cannot
// do that: at the benchmark shape (2,096,628 entries, K = 128, float32) it
// writes two gathered blocks of 1.07 GB each and their product, so the
// port computes the function here, with nothing but the output written.
//
// Bound: bytes. Each entry reads one row of lhs and one row of rhs_t (K
// values each) and writes one value. The distinct rows come from HBM once;
// the 2 * nnz * K gathered values come from L2 at the card's whole-row rate
// (about 7 TB/s on an H100), which is the floor of this design.
//
// Design (the first port: right and simple). The operands arrive as rows
// with unit stride along K and a row stride (`ldl`, `ldr`, in elements);
// the wrapper copies an operand that has no such layout. One warp works on
// a group of at most 32 entries (`epw`, picked by the wrapper so the grid
// fills the card): lane l loads entry l's row, column and sample value,
// coalesced, then the warp takes the group's entries kUnroll at a time, the
// row and column broadcast by shuffles. The lanes stride over K: with rows
// 16-byte aligned (V = 4 floats or 2 doubles a load) lane l reads vectors
// l, l + 32, ... of both rows, then the scalar tail; each lane accumulates
// its products by FMA in the value type, in order. A butterfly of xor
// shuffles (16, 8, 4, 2, 1) then gives every lane the same sum, so two
// launches give the same bits. The lane that loaded the entry multiplies
// by s and stores it. Indices are int32 or int64; offsets are 64-bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps a CTA
constexpr int kUnroll = 4;     // entries whose loads a warp keeps in flight together
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
};

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ float fma_vec(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ double fma_vec(double2 a, double2 b, double acc) {
  acc = fma(a.x, b.x, acc);
  return fma(a.y, b.y, acc);
}

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(kThreads) sddmm_kernel(const I* __restrict__ rows, const I* __restrict__ cols,
                                                         const T* __restrict__ s, const T* __restrict__ lhs,
                                                         long long ldl, const T* __restrict__ rhs_t, long long ldr,
                                                         long long nnz, long long k_dim, int epw,
                                                         T* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  constexpr int V = VEC ? Vec<T>::width : 1;
  const long long n_vec = VEC ? k_dim / V : 0;
  for (long long base = warp * epw; base < nnz; base += n_warps * epw) {
    const int cnt = static_cast<int>(min(static_cast<long long>(epw), nnz - base));
    long long my_row = 0, my_col = 0;
    T my_s = T(0);
    if (lane < cnt) {
      my_row = static_cast<long long>(rows[base + lane]);
      my_col = static_cast<long long>(cols[base + lane]);
      my_s = s[base + lane];
    }
    for (int t = 0; t < cnt; t += kUnroll) {
      const T* a[kUnroll];
      const T* b[kUnroll];
      T acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = __shfl_sync(kFull, my_row, t + u);
        const long long c = __shfl_sync(kFull, my_col, t + u);
        a[u] = lhs + r * ldl;
        b[u] = rhs_t + c * ldr;
        acc[u] = T(0);
      }
      if constexpr (VEC) {
        using VT = typename Vec<T>::type;
        for (long long v = lane; v < n_vec; v += kWarp) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (t + u < cnt) {
              const VT x = reinterpret_cast<const VT*>(a[u])[v];
              const VT y = reinterpret_cast<const VT*>(b[u])[v];
              acc[u] = fma_vec(x, y, acc[u]);
            }
          }
        }
      }
      for (long long k = n_vec * V + lane; k < k_dim; k += kWarp) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < cnt) acc[u] = fma_(a[u][k], b[u][k], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2) acc[u] += __shfl_xor_sync(kFull, acc[u], off);
      }
      T mine = T(0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (lane == t + u) mine = acc[u];
      }
      if (lane >= t && lane < t + kUnroll && lane < cnt) out[base + lane] = my_s * mine;
    }
  }
}

template <typename T, typename I>
int launch(const void* rows, const void* cols, const void* s, const void* lhs, long long ldl, const void* rhs_t,
           long long ldr, long long nnz, long long k_dim, long long epw, long long vec, long long max_blocks,
           void* out, void* stream) {
  if (nnz <= 0) return 0;
  if (epw < 1 || epw > kWarp || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (nnz + epw - 1) / epw;
  const long long wanted = (groups + kThreads / kWarp - 1) / (kThreads / kWarp);
  const long long blocks = wanted < max_blocks ? wanted : max_blocks;
  auto st = static_cast<cudaStream_t>(stream);
  const I* r = static_cast<const I*>(rows);
  const I* c = static_cast<const I*>(cols);
  const T* sv = static_cast<const T*>(s);
  const T* l = static_cast<const T*>(lhs);
  const T* rt = static_cast<const T*>(rhs_t);
  T* o = static_cast<T*>(out);
  if (vec) {
    sddmm_kernel<T, I, true><<<blocks, kThreads, 0, st>>>(r, c, sv, l, ldl, rt, ldr, nnz, k_dim, (int)epw, o);
  } else {
    sddmm_kernel<T, I, false><<<blocks, kThreads, 0, st>>>(r, c, sv, l, ldl, rt, ldr, nnz, k_dim, (int)epw, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ST_SDDMM(NAME, T, I)                                                                                       \
  int NAME(const void* rows, const void* cols, const void* s, const void* lhs, long long ldl, const void* rhs_t,   \
           long long ldr, long long nnz, long long k_dim, long long epw, long long vec, long long max_blocks,       \
           void* out, void* stream) {                                                                              \
    return launch<T, I>(rows, cols, s, lhs, ldl, rhs_t, ldr, nnz, k_dim, epw, vec, max_blocks, out, stream);       \
  }

ST_SDDMM(st_sddmm_f32_i32, float, int32_t)
ST_SDDMM(st_sddmm_f32_i64, float, int64_t)
ST_SDDMM(st_sddmm_f64_i32, double, int32_t)
ST_SDDMM(st_sddmm_f64_i64, double, int64_t)

}  // extern "C"
