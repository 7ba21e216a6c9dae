// Block-sparse (BSR) SpMM and block-sampled SDDMM for Hopper (sm_90a), plain
// C interface for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Layout (sparse_tpu_torch/kernels/bsr.py:build_bsr): stored blocks
// (n_blocks, bm, bn) with int32 block_rows / block_cols; each block-row's
// blocks form one contiguous run, found through the host-built int64
// row_ptr (n_block_rows + 1). A run is not sorted by column and may repeat a
// (row, col) pair: pad blocks (zeros, block_col 0) sit at its end. The
// kernels assume nothing else.
//
// Both kernels are one tiled product on the CUDA cores. A CTA of 256 threads
// owns a TM x TN = 64 x 64 output tile, each thread a 4 x 4 sub-tile held in
// registers. The contraction runs in chunks of BK = 16: each step the CTA
// stages a TM x BK chunk of the left operand and a BK x TN chunk of the
// right one in shared memory, while the next step's chunks are already on
// their way into registers. Every operand is read through its strides, so a
// transposed view (x.T on the layer's forward, the gradient of out_t.T, the
// gathered blocks_t.transpose(1, 2) of dgrad) is read in place with no
// copy; consecutive threads walk whichever dimension has stride 1. Edges
// (rows past n_rows or M, dense rows past K, columns past N, a ragged
// block shape or contraction) are masked with zeros on load and on store,
// so no operand is padded and only the true output is written, by exactly
// one thread: outputs need no memset, and nothing uses atomics, so results
// are deterministic. Offsets are 64-bit.
//
// Precision: float32 is IEEE FP32 FMA (the reference's Precision.HIGHEST;
// never TF32), float64 accumulates in float64, bfloat16 reads bf16, sums in
// float32 and rounds once to bf16 on store (the reference's DEFAULT with an
// f32 accumulator).
//
// Bound on this card at the layer's full width (8192 x 8192, 25 % of the
// 128 x 128 blocks, 1,042 stored blocks, batch 512): operations. Each
// product does 2 * 1042 * 128 * 128 * 512 = 17.48 GFLOP on about 103 MB.
// The same work as 3xTF32 on the tensor cores takes 0.106 ms, which is the
// bound these kernels are held to; the FFMA tiling here reaches about a
// quarter of the f32 rate: register accumulation, 16-byte shared-memory
// fragment reads (three shared-memory wavefronts per 16 FMAs a warp), and
// register prefetch of the next chunk. The float32 and bfloat16 SpMM and
// SDDMM run on the tensor cores (csrc/bsr_tc.cu); here the SpMM keeps
// float64 and the two-block form, the SDDMM float64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;         // output tile rows per CTA
constexpr int TN = 64;         // output tile columns per CTA
constexpr int BK = 16;         // contraction chunk per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // shared-memory row padding; keeps 16-byte alignment

template <typename T>
struct Acc {
  using type = T;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// four consecutive values from 16-byte aligned shared memory
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// One thread's share of an R x C chunk of a strided matrix: element (r, c)
// at p[r * s0 + c * s1], zero outside r < r_valid, c < c_valid. With
// c_fast, consecutive threads take consecutive c, else consecutive r.
template <typename T, int R, int C>
struct Chunk {
  static constexpr int kPer = R * C / kThreads;
  typename Acc<T>::type v[kPer];

  __device__ __forceinline__ static void coords(int q, bool c_fast, int& r, int& c) {
    const int e = threadIdx.x + q * kThreads;
    r = c_fast ? e / C : e % R;
    c = c_fast ? e % C : e / R;
  }

  __device__ __forceinline__ void load(const T* __restrict__ p, long long s0, long long s1, long long r_valid,
                                       long long c_valid, bool c_fast) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      int r, c;
      coords(q, c_fast, r, c);
      v[q] = (r < r_valid && c < c_valid) ? to_acc(p[r * s0 + c * s1]) : typename Acc<T>::type(0);
    }
  }
};

// The shared chunks of one step: PAIRS left chunks stored [k][i] and PAIRS
// right chunks stored [k][n], rows padded by kPad.
template <typename A, int PAIRS>
struct Stage {
  __align__(16) A a[PAIRS][BK][TM + kPad];
  __align__(16) A b[PAIRS][BK][TN + kPad];
};

template <typename T, int PAIRS>
struct Tile {
  using A = typename Acc<T>::type;
  Chunk<T, TM, BK> a[PAIRS];  // rows i, columns k
  Chunk<T, BK, TN> b[PAIRS];  // rows k, columns n
  bool a_kfast, b_nfast;
  A acc[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = A(0);
  }

  __device__ __forceinline__ void to_shared(Stage<A, PAIRS>& s) const {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
#pragma unroll
      for (int q = 0; q < Chunk<T, TM, BK>::kPer; ++q) {
        int r, c;
        Chunk<T, TM, BK>::coords(q, a_kfast, r, c);
        s.a[p][c][r] = a[p].v[q];
      }
#pragma unroll
      for (int q = 0; q < Chunk<T, BK, TN>::kPer; ++q) {
        int r, c;
        Chunk<T, BK, TN>::coords(q, b_nfast, r, c);
        s.b[p][r][c] = b[p].v[q];
      }
    }
  }

  __device__ __forceinline__ void mma(const Stage<A, PAIRS>& s) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        A av[4], bv[4];
        load4(&s.a[p][k][ty * 4], av);
        load4(&s.b[p][k][tx * 4], bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma_rn(av[i], bv[j], acc[i][j]);
      }
    }
  }
};

// out[r-block, n-tile] = sum over block-row r's run of blocks[j] @ dense[cols[j]-block, n-tile].
//
// Replaces sparse_tpu/kernels/bsr.py:_spmm_kernel (P2, behind
// bsr_spmm_pallas) with PAIRS = 1 for float64 (csrc/bsr_tc.cu takes float32
// and bfloat16), and _spmm_kernel2 (P3, behind bsr_spmm_pallas2) with PAIRS = 2: two stored blocks per step, on layouts
// whose every run has even length (the wrapper checks). The TPU kernels walk
// a sequential grid over all stored blocks and carry each block-row's sum in
// VMEM scratch from one step to the next; here one CTA per (block-row,
// 64-row slice of the block, 64-column tile of dense) loops over its own run
// from row_ptr and keeps the sum in registers, so CTAs are independent and
// run in any order. Empty runs store zeros.
//
// blocks: element (j, i, k) at blocks[j * bs0 + i * bs1 + k * bs2];
// dense: element (k, n) at dense[k * d0 + n * d1]; out (n_rows, N) contiguous.
template <typename T, int PAIRS>
__global__ void __launch_bounds__(kThreads)
    bsr_spmm_kernel(const T* __restrict__ blocks, long long bs0, long long bs1, long long bs2,
                    const int* __restrict__ block_cols, const long long* __restrict__ row_ptr, long long bm,
                    long long bn, const T* __restrict__ dense, long long K, long long N, long long d0, long long d1,
                    T* __restrict__ out, long long n_rows, int m_tiles) {
  using A = typename Acc<T>::type;
  __shared__ Stage<A, PAIRS> stage;
  Tile<T, PAIRS> t;
  t.a_kfast = bs2 == 1;
  t.b_nfast = d1 == 1;
  t.zero();

  const long long r = blockIdx.x / m_tiles;
  const long long i0 = (long long)(blockIdx.x % m_tiles) * TM;  // first row of the tile inside the block
  const long long n0 = (long long)blockIdx.y * TN;
  const long long j0 = row_ptr[r];
  const long long nk = (bn + BK - 1) / BK;
  const long long steps = (row_ptr[r + 1] - j0) / PAIRS * nk;
  const long long m_valid = bm - i0 < TM ? bm - i0 : TM;
  const long long n_valid = N - n0 < TN ? N - n0 : TN;

  auto fetch = [&](long long s) {
    const long long j = j0 + (s / nk) * PAIRS;
    const long long k0 = (s % nk) * BK;
    const long long k_in_block = bn - k0 < BK ? bn - k0 : BK;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const long long col = block_cols[j + p];
      const long long krow = col * bn + k0;  // first dense row of the chunk
      long long k_valid = K - krow < k_in_block ? K - krow : k_in_block;
      if (col < 0) k_valid = 0;
      t.a[p].load(blocks + (j + p) * bs0 + i0 * bs1 + k0 * bs2, bs1, bs2, m_valid, k_in_block, t.a_kfast);
      t.b[p].load(dense + (k_valid > 0 ? krow * d0 : 0) + n0 * d1, d0, d1, k_valid, n_valid, t.b_nfast);
    }
  };

  if (steps > 0) fetch(0);
  for (long long s = 0; s < steps; ++s) {
    t.to_shared(stage);
    __syncthreads();
    if (s + 1 < steps) fetch(s + 1);
    t.mma(stage);
    __syncthreads();
  }

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row_in_block = i0 + ty * 4 + i;
    const long long row = r * bm + row_in_block;
    if (row_in_block >= bm || row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx * 4 + j;
      if (n < N) store_out(out + row * N + n, t.acc[i][j]);
    }
  }
}

// out[j] = lhs[rows[j]-block, :] @ rhs[:, cols[j]-block] for every stored block j.
//
// Replaces sparse_tpu/kernels/bsr.py:_sddmm_kernel (P4, behind
// bsr_sddmm_pallas), the weight gradient of the trainable BSR SpMM, in
// float64 (csrc/bsr_tc.cu takes float32 and bfloat16). The TPU kernel pads both operands to whole tiles and carries the sum over the
// contraction's grid axis in VMEM scratch; here one CTA per (stored block,
// 64 x 64 sub-tile of it) loops over the contraction B itself in chunks of
// BK, masking rows past M, columns past K and the ragged end of B. Every
// stored block is computed, pad blocks included, and written whole (zeros
// where the block overhangs M or K).
//
// lhs: element (i, k) at lhs[i * l0 + k * l1]; rhs: element (k, c) at
// rhs[k * r0 + c * r1]; out (n_blocks, bm, bn) contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bsr_sddmm_kernel(const int* __restrict__ block_rows, const int* __restrict__ block_cols, long long bm,
                     long long bn, const T* __restrict__ lhs, long long M, long long B, long long l0, long long l1,
                     const T* __restrict__ rhs, long long K, long long r0, long long r1, T* __restrict__ out,
                     int m_tiles, int n_tiles) {
  using A = typename Acc<T>::type;
  __shared__ Stage<A, 1> stage;
  Tile<T, 1> t;
  t.a_kfast = l1 == 1;
  t.b_nfast = r1 == 1;
  t.zero();

  const long long per_block = (long long)m_tiles * n_tiles;
  const long long j = blockIdx.x / per_block;
  const long long sub = blockIdx.x % per_block;
  const long long i0 = (sub / n_tiles) * TM;  // sub-tile origin inside the block
  const long long c0 = (sub % n_tiles) * TN;
  const long long row0 = (long long)block_rows[j] * bm + i0;  // first lhs row of the tile
  const long long col0 = (long long)block_cols[j] * bn + c0;  // first rhs column of the tile
  const long long m_tile = bm - i0 < TM ? bm - i0 : TM;
  const long long n_tile = bn - c0 < TN ? bn - c0 : TN;
  long long m_valid = M - row0 < m_tile ? M - row0 : m_tile;
  long long n_valid = K - col0 < n_tile ? K - col0 : n_tile;
  if (block_rows[j] < 0) m_valid = 0;
  if (block_cols[j] < 0) n_valid = 0;
  const long long steps = (B + BK - 1) / BK;

  auto fetch = [&](long long s) {
    const long long k0 = s * BK;
    const long long k_valid = B - k0 < BK ? B - k0 : BK;
    t.a[0].load(lhs + (m_valid > 0 ? row0 * l0 : 0) + k0 * l1, l0, l1, m_valid, k_valid, t.a_kfast);
    t.b[0].load(rhs + k0 * r0 + (n_valid > 0 ? col0 * r1 : 0), r0, r1, k_valid, n_valid, t.b_nfast);
  };

  if (steps > 0) fetch(0);
  for (long long s = 0; s < steps; ++s) {
    t.to_shared(stage);
    __syncthreads();
    if (s + 1 < steps) fetch(s + 1);
    t.mma(stage);
    __syncthreads();
  }

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  T* o = out + j * bm * bn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long ii = ty * 4 + i;
    if (ii >= m_tile) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long c = tx * 4 + jj;
      if (c < n_tile) store_out(o + (i0 + ii) * bn + c0 + c, t.acc[i][jj]);
    }
  }
}

template <typename T, int PAIRS>
int launch_spmm(const void* blocks, long long bs0, long long bs1, long long bs2, const void* block_cols,
                const void* row_ptr, long long n_block_rows, long long bm, long long bn, const void* dense,
                long long k, long long n, long long d0, long long d1, void* out, long long n_rows, void* stream) {
  const long long m_tiles = (bm + TM - 1) / TM;
  const long long n_tiles = (n + TN - 1) / TN;
  if (n_block_rows * m_tiles == 0 || n_tiles == 0) return 0;
  if (n_block_rows * m_tiles > 0x7fffffffLL || n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(n_block_rows * m_tiles), (unsigned)n_tiles);
  bsr_spmm_kernel<T, PAIRS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)blocks, bs0, bs1, bs2, (const int*)block_cols, (const long long*)row_ptr, bm, bn, (const T*)dense, k,
      n, d0, d1, (T*)out, n_rows, (int)m_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int spmm(const void* blocks, long long bs0, long long bs1, long long bs2, const void* block_cols, const void* row_ptr,
         long long n_block_rows, long long bm, long long bn, const void* dense, long long k, long long n, long long d0,
         long long d1, void* out, long long n_rows, long long pairs, void* stream) {
  if (pairs == 1) {
    return launch_spmm<T, 1>(blocks, bs0, bs1, bs2, block_cols, row_ptr, n_block_rows, bm, bn, dense, k, n, d0, d1,
                             out, n_rows, stream);
  }
  if (pairs == 2) {
    return launch_spmm<T, 2>(blocks, bs0, bs1, bs2, block_cols, row_ptr, n_block_rows, bm, bn, dense, k, n, d0, d1,
                             out, n_rows, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int sddmm(const void* block_rows, const void* block_cols, long long n_blocks, long long bm, long long bn,
          const void* lhs, long long m, long long b, long long l0, long long l1, const void* rhs, long long k,
          long long r0, long long r1, void* out, void* stream) {
  const long long m_tiles = (bm + TM - 1) / TM;
  const long long n_tiles = (bn + TN - 1) / TN;
  const long long ctas = n_blocks * m_tiles * n_tiles;
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bsr_sddmm_kernel<T><<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)block_rows, (const int*)block_cols, bm, bn, (const T*)lhs, m, b, l0, l1, (const T*)rhs, k, r0, r1,
      (T*)out, (int)m_tiles, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define ST_BSR_SPMM_ENTRY_POINT(SUFFIX, T)                                                                         \
  int st_bsr_spmm_##SUFFIX(const void* blocks, long long bs0, long long bs1, long long bs2, const void* block_cols, \
                           const void* row_ptr, long long n_block_rows, long long bm, long long bn,              \
                           const void* dense, long long k, long long n, long long d0, long long d1, void* out,    \
                           long long n_rows, long long pairs, void* stream) {                                     \
    return spmm<T>(blocks, bs0, bs1, bs2, block_cols, row_ptr, n_block_rows, bm, bn, dense, k, n, d0, d1, out,    \
                   n_rows, pairs, stream);                                                                        \
  }

ST_BSR_SPMM_ENTRY_POINT(f32, float)
ST_BSR_SPMM_ENTRY_POINT(f64, double)
ST_BSR_SPMM_ENTRY_POINT(bf16, __nv_bfloat16)

#undef ST_BSR_SPMM_ENTRY_POINT

// the SDDMM in float64 only: float32 and bfloat16 run on the tensor cores (csrc/bsr_tc.cu)
int st_bsr_sddmm_f64(const void* block_rows, const void* block_cols, long long n_blocks, long long bm, long long bn,
                     const void* lhs, long long m, long long b, long long l0, long long l1, const void* rhs,
                     long long k, long long r0, long long r1, void* out, void* stream) {
  return sddmm<double>(block_rows, block_cols, n_blocks, bm, bn, lhs, m, b, l0, l1, rhs, k, r0, r1, out, stream);
}

}  // extern "C"
