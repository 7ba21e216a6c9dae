// The DIA (banded) matvec and SpMM (D1) for Hopper (sm_90a), plain C
// interface for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Replaces the XLA shifted multiply-adds of sparse_tpu/kernels/dia.py:
// dia_spmv (:67) and dia_spmm (:147), and the per-rank sum of
// dia_spmv_sharded (:123): for the banded layout bands[i, r] == A[r, r + o_i]
// (sparse_tpu_torch/kernels/dia.py:build_dia),
//   y[r, c] = sum_i bands[i, r] * x[r + o_i + shift, c]
// over the diagonals whose x row r + o_i + shift lies in x's x_len rows
// (the rows the diagonal reaches), with shift 0 for the matvec and the
// halo's width for a rank's segment of the sharded form, where every row
// is reached; from zeros, or from y itself to go on with the next kMaxBands
// diagonals of a longer list. The torch ops this replaces start from zeros and add one
// rounded product a diagonal, in offset order; each thread does the same
// with __fmul_rn/__fadd_rn (or __dmul_rn/__dadd_rn), which nvcc does not
// contract into an FMA, so the sums have their bits (and so sparse_tpu's).
//
// Bound on this card: bytes. The function reads the k bands, x and writes y
// once; the x rows the diagonals share come from L1/L2. Design: one thread
// a row (the matvec) or a (row, column) of y (the SpMM), neighbouring
// threads on neighbouring columns, so every band, x and y access of a warp
// is contiguous where x's column stride is 1; the offsets (at most
// kMaxBands a launch, the layout's own default limit) travel in the
// kernel's arguments; one launch, no scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBands = 64;  // sparse_tpu_torch/kernels/dia.py:_MAX_BANDS
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

struct Offsets {
  long long o[kMaxBands];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// y (n_rows, m) row-major; bands[i, r] at bands[i * band_stride + r]; x[j, c]
// at x[j * sx0 + c * sx1], j in [0, x_len)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_shifted_sum_kernel(const T* __restrict__ bands, long long band_stride, int k, Offsets offs,
                           const T* __restrict__ x, long long x_len, long long sx0, long long sx1, long long shift,
                           long long n_rows, long long m, int accumulate, T* __restrict__ y) {
  const long long total = n_rows * m;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    long long r = idx, c = 0;
    if (m != 1) {
      r = idx / m;
      c = idx - r * m;
    }
    T acc = accumulate ? y[idx] : T(0);
    for (int i = 0; i < k; ++i) {
      const long long j = r + offs.o[i] + shift;
      if (j >= 0 && j < x_len) acc = add_rn(acc, mul_rn(bands[i * band_stride + r], x[j * sx0 + c * sx1]));
    }
    y[idx] = acc;
  }
}

template <typename T>
int launch(const T* bands, long long band_stride, long long k, const long long* offsets, const T* x, long long x_len,
           long long sx0, long long sx1, long long shift, long long n_rows, long long m, int accumulate, T* y,
           cudaStream_t stream) {
  if (k < 0 || k > kMaxBands) return (int)cudaErrorInvalidValue;
  const long long total = n_rows * m;
  if (total <= 0) return (int)cudaSuccess;
  Offsets offs = {};
  for (long long i = 0; i < k; ++i) offs.o[i] = offsets[i];
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dia_shifted_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(bands, band_stride, (int)k, offs, x, x_len,
                                                                          sx0, sx1, shift, n_rows, m, accumulate, y);
  return (int)cudaGetLastError();
}

}  // namespace

// offsets: a host array of k offsets (copied into the kernel's arguments);
// accumulate: 0 to start from zeros, 1 to add to y
#define ST_DIA_SHIFTED_SUM(SUFFIX, T)                                                                            \
  extern "C" int st_dia_shifted_sum_##SUFFIX(const T* bands, long long band_stride, long long k,                \
                                             const long long* offsets, const T* x, long long x_len,            \
                                             long long sx0, long long sx1, long long shift, long long n_rows,  \
                                             long long m, long long accumulate, T* y, void* stream) {          \
    return launch<T>(bands, band_stride, k, offsets, x, x_len, sx0, sx1, shift, n_rows, m, (int)accumulate, y,  \
                     (cudaStream_t)stream);                                                                     \
  }

ST_DIA_SHIFTED_SUM(f32, float)
ST_DIA_SHIFTED_SUM(f64, double)
