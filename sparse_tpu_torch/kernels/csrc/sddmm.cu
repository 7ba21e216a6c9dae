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
// the gathered values come from L2 at the card's whole-row rate (about
// 7 TB/s on an H100), which is the floor of this design.
//
// Operands. Each of lhs (M, K) and rhs_t (N, K) is read in place through
// two strides (`ld_row`, `ld_k`, in elements): K-major (ld_k = 1) or
// MN-major (ld_row = 1, ld_k the leading dimension: every value its own
// 32-byte sector). The wrapper copies an MN-major operand when the copy
// moves fewer bytes than the strided reads would (kernels/_cuda.py:
// sddmm_reads_in_place), and an operand with unit stride on neither axis
// always. VEC kernels take both operands K-major with 16-byte aligned rows
// and read them by 16-byte loads; the others read V values at stride ld_k.
//
// The sum order, the same in both routes and every layout. With V values
// in 16 bytes (4 floats, 2 doubles), lane l takes the vectors l, l + 32,
// ... of K (vector v holds elements v*V .. v*V + V - 1) and then the tail
// element (K / V) * V + l when it exists, adding each product by FMA to
// its sum in that order; the lanes' sums are added by the pairs of a
// butterfly of xor shuffles (16, 8, 4, 2, 1), a round's entries at once
// (reduce_entries). The loads differ by layout (one 16-byte
// load, or V scalar loads), the values and their order do not, so every
// layout and both routes give the same bits, and two launches give the
// same bits. The lane that loaded the entry multiplies by s and stores it.
// Indices are int32 or int64; offsets are 64-bit.
//
// Both routes take groups of at most 32 consecutive entries (`epw`, picked
// by the wrapper so that the groups fill the card); lane l loads entry l's
// row, column and sample value, coalesced. Rows are gathered from L2 in
// rounds, each a round trip; the bytes in flight on an SM (rows a round
// times the warps its registers let it hold) set the time.
// - kept row (VEC, K * item <= 2 KB and a multiple of 16 bytes: NV = 1, 2
//   or 4 vectors a lane): a ballot marks the entries whose row differs from
//   the entry before; the warp keeps lhs[rows[e]] in registers across the
//   others, so sorted entries read each lhs row once a group and gather
//   only rhs_t[cols[e]] (unsorted input stays right, only slower). A round
//   takes U = 4 / NV entries (at least 1): their rhs rows and the first new
//   lhs row among them are loaded together, issued before the previous
//   round's sums; a second new row in the same round is loaded when it is
//   reached. NV = 1 is held to 64 registers: four CTAs an SM (at 72, three
//   fit, and the benchmark shape took 0.214 ms instead of 0.173).
// - per entry (the rest): 4 entries a round, both rows streamed over K for
//   each, all 8 loads of a round issued before its products (interleaved
//   with them, 0.388 ms at the benchmark shape against 0.200; one entry and
//   four vectors a round, for groups of fewer than 4 entries, 0.259 ms at
//   the example's shape against 0.205: chip_k4_ablation.py, code deleted).
// At the benchmark shape (32.0 entries a row, K = 128, float32) the kept
// row halves the gathered bytes; the lhs rows it no longer reads came
// mostly from L1, so the time falls less: 0.2514 ms (the first port) to
// 0.17-0.18 against an L2 floor of 0.156, and 4 rows a round beat 2 and 8
// (chip_k4_ablation.py; PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The depth of a round and the registers, as chip_k4_ablation.py varies them
#ifndef SDDMM_ENTRY_ROUND
#define SDDMM_ENTRY_ROUND 4  // per entry: entries a round
#endif
#ifndef SDDMM_KEPT_ROWS
#define SDDMM_KEPT_ROWS 4  // kept row: rhs row vectors a lane loads a round (U = this / NV entries)
#endif
#ifndef SDDMM_ENTRY_MIN_BLOCKS
#define SDDMM_ENTRY_MIN_BLOCKS 1
#endif
#ifndef SDDMM_KEPT_MIN_BLOCKS
#define SDDMM_KEPT_MIN_BLOCKS 4  // kept row, NV = 1: 64 registers, four CTAs an SM
#endif

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps a CTA
constexpr int kUnroll = SDDMM_ENTRY_ROUND;
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

// one dense operand, (rows, K), read through its two strides
template <typename T>
struct Operand {
  const T* p;
  long long ld_row;  // elements from a row to the next
  long long ld_k;    // elements from a k to the next: 1 when K-major
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

__device__ __forceinline__ float4 strided_vec(const float* x, long long ld) {
  return make_float4(x[0], x[ld], x[2 * ld], x[3 * ld]);
}
__device__ __forceinline__ double2 strided_vec(const double* x, long long ld) { return make_double2(x[0], x[ld]); }

// vector v (elements v*V .. v*V + V - 1) of row i
template <typename T, bool VEC>
__device__ __forceinline__ typename Vec<T>::type load_vec(const Operand<T>& op, int i, long long v) {
  using VT = typename Vec<T>::type;
  const T* row = op.p + static_cast<long long>(i) * op.ld_row;
  if constexpr (VEC) return reinterpret_cast<const VT*>(row)[v];
  else return strided_vec(row + v * Vec<T>::width * op.ld_k, op.ld_k);
}

template <typename T>
__device__ __forceinline__ T load_one(const Operand<T>& op, int i, long long k) {
  return op.p[static_cast<long long>(i) * op.ld_row + k * op.ld_k];
}

// The sums over the 32 lanes of U entries' partials (U a power of two), by
// the pairs of lanes a butterfly adds (xor 16, 8, 4, 2, 1), each lane adding
// its partner's value to its own: the same bits as a butterfly of each
// entry. While more than one entry is left, each pair halves them (the lane
// with the offset's bit set keeps the upper half), so the U entries take
// U - 1 + 5 - log2(U) shuffles instead of 5 U, and one more hands entry e's
// total from lane e * 32 / U to lane t + e, which stores it.
template <typename T, int U>
__device__ __forceinline__ T reduce_entries(T (&acc)[U], int t, int lane) {
#pragma unroll
  for (int off = kWarp / 2, n = U; off > 0; off /= 2) {
    if (n > 1) {
      const bool upper = lane & off;
#pragma unroll
      for (int j = 0; j < n / 2; ++j) {
        const T keep = upper ? acc[j + n / 2] : acc[j];
        const T send = upper ? acc[j] : acc[j + n / 2];
        acc[j] = keep + __shfl_xor_sync(kFull, send, off);
      }
      n /= 2;
    } else {
      acc[0] += __shfl_xor_sync(kFull, acc[0], off);
    }
  }
  return __shfl_sync(kFull, acc[0], ((lane - t) & (U - 1)) * (kWarp / U));
}

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(kThreads, SDDMM_ENTRY_MIN_BLOCKS)
    sddmm_entry_kernel(const I* __restrict__ rows, const I* __restrict__ cols, const T* __restrict__ s,
                       const Operand<T> lhs, const Operand<T> rhs, long long nnz, long long k_dim, int epw,
                       T* __restrict__ out) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::width;
  const int lane = threadIdx.x % kWarp;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  const long long n_vec = k_dim / V;
  const long long kt = n_vec * V + lane;  // this lane's tail element, where it exists
  for (long long base = warp * epw; base < nnz; base += n_warps * epw) {
    const int cnt = static_cast<int>(min(static_cast<long long>(epw), nnz - base));
    int my_row = 0, my_col = 0;  // the wrapper keeps M and N below 2^31
    T my_s = T(0);
    if (lane < cnt) {
      my_row = static_cast<int>(rows[base + lane]);
      my_col = static_cast<int>(cols[base + lane]);
      my_s = s[base + lane];
    }
    for (int t = 0; t < cnt; t += kUnroll) {
      int r[kUnroll], c[kUnroll];
      T acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = __shfl_sync(kFull, my_row, (t + u) & (kWarp - 1));
        c[u] = __shfl_sync(kFull, my_col, (t + u) & (kWarp - 1));
        acc[u] = T(0);
      }
      for (long long v = lane; v < n_vec; v += kWarp) {
        VT x[kUnroll], y[kUnroll];  // every load of the round issued before the first product
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < cnt) {
            x[u] = load_vec<T, VEC>(lhs, r[u], v);
            y[u] = load_vec<T, VEC>(rhs, c[u], v);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < cnt) acc[u] = fma_vec(x[u], y[u], acc[u]);
        }
      }
      if (kt < k_dim) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < cnt) acc[u] = fma_(load_one(lhs, r[u], kt), load_one(rhs, c[u], kt), acc[u]);
        }
      }
      const T mine = reduce_entries<T, kUnroll>(acc, t, lane);
      if (lane >= t && lane < t + kUnroll && lane < cnt) out[base + lane] = my_s * mine;
    }
  }
}

// lane's vectors lane + 32 q (q < NV) of row i, where they exist
template <typename T, int NV>
__device__ __forceinline__ void load_part(const Operand<T>& op, int i, int lane, long long n_vec,
                                          typename Vec<T>::type (&x)[NV]) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    if (lane + q * kWarp < n_vec) x[q] = load_vec<T, true>(op, i, lane + q * kWarp);
  }
}

template <typename T, typename I, int NV>
__global__ void __launch_bounds__(kThreads, NV == 1 ? SDDMM_KEPT_MIN_BLOCKS : 1)
    sddmm_row_kernel(const I* __restrict__ rows, const I* __restrict__ cols, const T* __restrict__ s,
                     const Operand<T> lhs, const Operand<T> rhs, long long nnz, long long k_dim, int epw,
                     T* __restrict__ out) {
  using VT = typename Vec<T>::type;
  constexpr int U = SDDMM_KEPT_ROWS / NV > 0 ? SDDMM_KEPT_ROWS / NV : 1;  // entries a round
  const int lane = threadIdx.x % kWarp;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  const long long n_vec = k_dim / Vec<T>::width;  // K is a multiple of V here
  for (long long base = warp * epw; base < nnz; base += n_warps * epw) {
    const int cnt = static_cast<int>(min(static_cast<long long>(epw), nnz - base));
    int my_row = 0, my_col = 0;  // the wrapper keeps M and N below 2^31
    T my_s = T(0);
    if (lane < cnt) {
      my_row = static_cast<int>(rows[base + lane]);
      my_col = static_cast<int>(cols[base + lane]);
      my_s = s[base + lane];
    }
    // the entries whose lhs row differs from the entry's before (the group's first always)
    const int before = __shfl_up_sync(kFull, my_row, 1);
    const unsigned fresh = __ballot_sync(kFull, lane < cnt && (lane == 0 || my_row != before));
    VT a[NV], a_n[NV], b[U][NV];
    // the loads of the round from entry t: its rhs rows and its first new lhs row
    auto issue = [&](int t) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = __shfl_sync(kFull, my_col, (t + u) & (kWarp - 1));
        if (t + u < cnt) load_part<T, NV>(rhs, c, lane, n_vec, b[u]);
      }
      const unsigned news = (fresh >> t) & ((1u << U) - 1);
      if (news) {  // warp-uniform
        const int row = __shfl_sync(kFull, my_row, (t + __ffs(news) - 1) & (kWarp - 1));
        load_part<T, NV>(lhs, row, lane, n_vec, a_n);
      }
    };
    issue(0);
    for (int t = 0; t < cnt; t += U) {
      const unsigned news = (fresh >> t) & ((1u << U) - 1);
      const int first = news ? __ffs(news) - 1 : U;
      T acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[u] = T(0);
        if (t + u >= cnt) continue;
        if ((news >> u) & 1u) {
          if (u == first) {
#pragma unroll
            for (int q = 0; q < NV; ++q) a[q] = a_n[q];
          } else {
            load_part<T, NV>(lhs, __shfl_sync(kFull, my_row, (t + u) & (kWarp - 1)), lane, n_vec, a);
          }
        }
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          if (lane + q * kWarp < n_vec) acc[u] = fma_vec(a[q], b[u][q], acc[u]);
        }
      }
      if (t + U < cnt) issue(t + U);  // b and a_n are free: the next round's loads fly during the sums
      const T mine = reduce_entries<T, U>(acc, t, lane);
      if (lane >= t && lane < t + U && lane < cnt) out[base + lane] = my_s * mine;
    }
  }
}

template <typename T, typename I>
int launch(const void* rows, const void* cols, const void* s, const void* lhs, long long ldl_row, long long ldl_k,
           const void* rhs_t, long long ldr_row, long long ldr_k, long long nnz, long long k_dim, long long epw,
           long long vec, long long nv, long long max_blocks, void* out, void* stream) {
  if (nnz <= 0) return 0;
  if (epw < 1 || epw > kWarp || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nv != 0 && (!vec || k_dim % Vec<T>::width != 0 || k_dim > nv * kWarp * Vec<T>::width))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (nnz + epw - 1) / epw;
  const long long wanted = (groups + kThreads / kWarp - 1) / (kThreads / kWarp);
  const long long blocks = wanted < max_blocks ? wanted : max_blocks;
  auto st = static_cast<cudaStream_t>(stream);
  const I* r = static_cast<const I*>(rows);
  const I* c = static_cast<const I*>(cols);
  const T* sv = static_cast<const T*>(s);
  const Operand<T> l{static_cast<const T*>(lhs), ldl_row, ldl_k};
  const Operand<T> rt{static_cast<const T*>(rhs_t), ldr_row, ldr_k};
  T* o = static_cast<T*>(out);
  const int e = static_cast<int>(epw);
  if (nv == 1) {
    sddmm_row_kernel<T, I, 1><<<blocks, kThreads, 0, st>>>(r, c, sv, l, rt, nnz, k_dim, e, o);
  } else if (nv == 2) {
    sddmm_row_kernel<T, I, 2><<<blocks, kThreads, 0, st>>>(r, c, sv, l, rt, nnz, k_dim, e, o);
  } else if (nv == 4) {
    sddmm_row_kernel<T, I, 4><<<blocks, kThreads, 0, st>>>(r, c, sv, l, rt, nnz, k_dim, e, o);
  } else if (nv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (vec) {
    sddmm_entry_kernel<T, I, true><<<blocks, kThreads, 0, st>>>(r, c, sv, l, rt, nnz, k_dim, e, o);
  } else {
    sddmm_entry_kernel<T, I, false><<<blocks, kThreads, 0, st>>>(r, c, sv, l, rt, nnz, k_dim, e, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ST_SDDMM(NAME, T, I)                                                                                         \
  int NAME(const void* rows, const void* cols, const void* s, const void* lhs, long long ldl_row, long long ldl_k,   \
           const void* rhs_t, long long ldr_row, long long ldr_k, long long nnz, long long k_dim, long long epw,      \
           long long vec, long long nv, long long max_blocks, void* out, void* stream) {                             \
    return launch<T, I>(rows, cols, s, lhs, ldl_row, ldl_k, rhs_t, ldr_row, ldr_k, nnz, k_dim, epw, vec, nv,         \
                        max_blocks, out, stream);                                                                    \
  }

ST_SDDMM(st_sddmm_f32_i32, float, int32_t)
ST_SDDMM(st_sddmm_f32_i64, float, int64_t)
ST_SDDMM(st_sddmm_f64_i32, double, int32_t)
ST_SDDMM(st_sddmm_f64_i64, double, int64_t)

}  // extern "C"
