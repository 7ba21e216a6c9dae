// Row-ELL sparse attention forward (K6) for Hopper (sm_90a), plain C interface
// for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// For each query row i and each slot j < cap of its padded key list:
//   s_j   = sum_c (scale * q[i, c]) * k[e_cols[i, j], c]   (-inf where valid is false)
//   m     = max_j s_j, taken as 0 where it is not finite
//   e_j   = exp(s_j - m)  (0 where valid is false)
//   denom = sum_j e_j, taken as 1 where it is 0
//   out_i = sum_j (e_j / denom) * v[e_cols[i, j], :]   over every slot, in slot order
//
// K6. Replaces sparse_tpu/nn.py:sparse_attention_ell, which is XLA code, not
// Pallas: it packs [k | v] into one (Lk, d + dv) table, gathers it as an
// (L, cap, d + dv) block, multiplies it by q zero-padded over the v lanes,
// takes a masked softmax over the slots and sums the block again weighted by
// it. Eager PyTorch writes that block and two products of its size: at
// Longformer-base's width (L = 4,096, 513 slots a row, d = dv = 64, float32)
// 1.07 GB each, for every head. This kernel writes nothing but the output.
//
// Bound: bytes. From HBM, q, e_cols, valid and out once, and the k and v
// tables once (the distinct rows); the L * cap gathered k rows and v rows
// come from L2, at the card's whole-row rate (about 7.3 TB/s on an H100,
// PERF.md), which is the floor of this design: 2 * L * cap * 256 bytes at
// Longformer-base's width, 1.08 GB a head, 0.147 ms.
//
// Design: one warp a query row, a persistent grid walking the rows.
// - Pass 1 reads each slot's k row once and writes its score to a strip of
//   `cap` values: the warp's slice of shared memory when 8 strips fit in
//   48 KB (cap <= 1,536 float32 or 768 float64), else the warp's row of a
//   global scratch the wrapper sizes. As in K4 (csrc/sddmm.cu), lane l takes
//   the 16-byte vectors l, l + 32, ... of d and then the tail element
//   (d / V) * V + l, by FMA in that order; a round's 4 slots are reduced
//   together by the pairs of an xor butterfly (16, 8, 4, 2, 1). All 8 loads
//   of a round are issued before its products. q is scaled once, as
//   scale * q rounded, the reference's qs.
// - The softmax runs over the strip: lanes over slots, the maximum and the
//   sum by xor butterflies (every lane gets the same bits), the weights
//   e_j / denom written back.
// - Pass 2 reads each slot's v row once: a lane owns one 16-byte vector of
//   dv (then one tail element) and adds p_j * v_j by FMA in slot order, 4
//   slots' loads in flight.
// No atomics and one order, so two launches give the same bits.
//
// The reference's non-finite rules, kept exactly. Its scores run over the
// packed [k | v] row with q zero-padded, so a non-finite v value in a valid
// slot makes that score NaN (0 * inf), hence m and every weight NaN: the row
// comes out all NaN (pass 2 flags it). Its output sums over every slot,
// padding included, so a non-finite v value in an invalid slot makes NaN of
// that lane (0 * inf): pass 2 adds invalid slots with weight 0. jnp.take
// reads an index below 0 from the end (c + Lk) and fills one outside [-Lk,
// Lk) with NaN: such an index makes the row all NaN, and is never read.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps a CTA, a query row each
constexpr int kWarps = kThreads / kWarp;
constexpr int kRound = 4;  // slots a round, their loads issued together
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
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

__device__ __forceinline__ float dot_vec(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ double dot_vec(double2 a, double2 b, double acc) {
  acc = fma(a.x, b.x, acc);
  return fma(a.y, b.y, acc);
}

__device__ __forceinline__ float4 scale_vec(float4 a, float s) { return make_float4(a.x * s, a.y * s, a.z * s, a.w * s); }
__device__ __forceinline__ double2 scale_vec(double2 a, double s) { return make_double2(a.x * s, a.y * s); }

__device__ __forceinline__ float4 axpy_vec(float p, float4 x, float4 acc) {
  return make_float4(fmaf(p, x.x, acc.x), fmaf(p, x.y, acc.y), fmaf(p, x.z, acc.z), fmaf(p, x.w, acc.w));
}
__device__ __forceinline__ double2 axpy_vec(double p, double2 x, double2 acc) {
  return make_double2(fma(p, x.x, acc.x), fma(p, x.y, acc.y));
}

__device__ __forceinline__ bool finite_vec(float4 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z) && isfinite(a.w);
}
__device__ __forceinline__ bool finite_vec(double2 a) { return isfinite(a.x) && isfinite(a.y); }

template <typename T>
__device__ __forceinline__ typename Vec<T>::type splat(T x) {
  if constexpr (Vec<T>::width == 4) return make_float4(x, x, x, x);
  else return make_double2(x, x);
}

// vector vi (elements vi*V .. vi*V + V - 1) of a row: one 16-byte load, or V scalar loads
template <typename T, bool VEC>
__device__ __forceinline__ typename Vec<T>::type load_vec(const T* row, long long vi) {
  using VT = typename Vec<T>::type;
  if constexpr (VEC) {
    return reinterpret_cast<const VT*>(row)[vi];
  } else {
    const T* x = row + vi * Vec<T>::width;
    if constexpr (Vec<T>::width == 4) return make_float4(x[0], x[1], x[2], x[3]);
    else return make_double2(x[0], x[1]);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_vec(T* row, long long vi, typename Vec<T>::type x) {
  using VT = typename Vec<T>::type;
  if constexpr (VEC) {
    reinterpret_cast<VT*>(row)[vi] = x;
  } else {
    T* y = row + vi * Vec<T>::width;
    if constexpr (Vec<T>::width == 4) {
      y[0] = x.x, y[1] = x.y, y[2] = x.z, y[3] = x.w;
    } else {
      y[0] = x.x, y[1] = x.y;
    }
  }
}

// the NaN-propagating maximum (jnp.max's): NaN if either is NaN
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// The sums over the 32 lanes of U slots' partials, as K4's reduce_entries
// (csrc/sddmm.cu): the pairs of lanes of a butterfly (xor 16, 8, 4, 2, 1),
// each lane adding its partner's value to its own; slot e's total ends on
// lane t + e.
template <typename T, int U>
__device__ __forceinline__ T reduce_slots(T (&acc)[U], int t, int lane) {
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

// slot `slot`'s key row, read as jnp.take reads it: negative from the end,
// -1 outside [-n_keys, n_keys)
template <typename I>
__device__ __forceinline__ int key_row(const I* cols, long long slot, long long n_keys) {
  long long c = static_cast<long long>(cols[slot]);
  if (c < 0) c += n_keys;
  return (c >= 0 && c < n_keys) ? static_cast<int>(c) : -1;
}

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(kThreads)
    ell_attention_kernel(const T* __restrict__ q, long long ldq, const T* __restrict__ k, long long ldk,
                         const T* __restrict__ v, long long ldv, const I* __restrict__ cols,
                         const unsigned char* __restrict__ valid, long long n_rows, long long n_keys, long long cap,
                         long long d, long long dv, T scale, T* __restrict__ scratch, T* __restrict__ out) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::width;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int wib = threadIdx.x / kWarp;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + wib;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  // this warp's strip of cap scores, then weights
  T* w = scratch != nullptr ? scratch + warp * cap : reinterpret_cast<T*>(smem_raw) + wib * cap;
  const long long nq = d / V, kt = nq * V + lane;  // d's vectors; this lane's tail element of d, where it exists
  const long long nv = dv / V, vt = nv * V + lane;  // the same of dv
  const T neg_inf = -INFINITY;

  for (long long row = warp; row < n_rows; row += n_warps) {
    const T* qr = q + row * ldq;
    const I* cr = cols + row * cap;
    const unsigned char* okr = valid + row * cap;
    bool nan_row = false;  // this lane saw an index outside the table, or a non-finite v value in a valid slot

    // pass 1: the scores
    for (long long base = 0; base < cap; base += kWarp) {
      const int cnt = static_cast<int>(min(static_cast<long long>(kWarp), cap - base));
      int my_col = 0;
      bool my_ok = false;
      if (lane < cnt) {
        const int c = key_row(cr, base + lane, n_keys);
        nan_row |= c < 0;
        my_ok = okr[base + lane] != 0 && c >= 0;
        my_col = c < 0 ? 0 : c;
      }
      for (int t = 0; t < cnt; t += kRound) {
        int c[kRound];
        bool ok[kRound];
        T acc[kRound];
#pragma unroll
        for (int u = 0; u < kRound; ++u) {
          c[u] = __shfl_sync(kFull, my_col, (t + u) & (kWarp - 1));
          ok[u] = __shfl_sync(kFull, static_cast<int>(my_ok), (t + u) & (kWarp - 1)) && t + u < cnt;
          acc[u] = T(0);
        }
        for (long long vi = lane; vi < nq; vi += kWarp) {
          const VT qv = scale_vec(load_vec<T, VEC>(qr, vi), scale);
          VT kv[kRound];
#pragma unroll
          for (int u = 0; u < kRound; ++u) {
            if (ok[u]) kv[u] = load_vec<T, VEC>(k + static_cast<long long>(c[u]) * ldk, vi);
          }
#pragma unroll
          for (int u = 0; u < kRound; ++u) {
            if (ok[u]) acc[u] = dot_vec(qv, kv[u], acc[u]);
          }
        }
        if (kt < d) {
          const T qt = qr[kt] * scale;
#pragma unroll
          for (int u = 0; u < kRound; ++u) {
            if (ok[u]) acc[u] = fma_(qt, k[static_cast<long long>(c[u]) * ldk + kt], acc[u]);
          }
        }
        const T mine = reduce_slots<T, kRound>(acc, t, lane);
        if (lane >= t && lane < t + kRound && lane < cnt) w[base + lane] = my_ok ? mine : neg_inf;
      }
    }
    __syncwarp();

    // the softmax over the strip
    T m = neg_inf;
    for (long long j = lane; j < cap; j += kWarp) m = nan_max(m, w[j]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) m = nan_max(m, __shfl_xor_sync(kFull, m, off));
    if (!isfinite(m)) m = T(0);
    T denom = T(0);
    for (long long j = lane; j < cap; j += kWarp) {
      const T e = exp_(w[j] - m);  // an invalid slot holds -inf: 0
      w[j] = e;
      denom += e;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) denom += __shfl_xor_sync(kFull, denom, off);
    if (denom == T(0)) denom = T(1);
    for (long long j = lane; j < cap; j += kWarp) w[j] = w[j] / denom;
    __syncwarp();

    // pass 2: out_i = sum_j p_j * v_j, a lane a 16-byte vector of dv, then the tail elements
    T* orow = out + row * dv;
    const long long n_rounds = (nv + kWarp - 1) / kWarp + (nv * V < dv ? 1 : 0);
    for (long long r = 0; r < n_rounds; ++r) {
      const bool tail = r * kWarp >= nv;  // warp-uniform: the round of the tail elements
      const long long vi = r * kWarp + lane;
      const bool mine = tail ? vt < dv : vi < nv;
      VT acc = splat<T>(T(0));
      for (long long base = 0; base < cap; base += kWarp) {
        const int cnt = static_cast<int>(min(static_cast<long long>(kWarp), cap - base));
        int my_col = 0;
        bool my_ok = false;
        if (lane < cnt) {
          const int c = key_row(cr, base + lane, n_keys);
          my_ok = okr[base + lane] != 0;
          my_col = c < 0 ? 0 : c;  // such a row comes out NaN: read row 0 instead
        }
        for (int t = 0; t < cnt; t += kRound) {
          int c[kRound];
          bool ok[kRound];
          T p[kRound];
          VT x[kRound];
#pragma unroll
          for (int u = 0; u < kRound; ++u) {
            c[u] = __shfl_sync(kFull, my_col, (t + u) & (kWarp - 1));
            ok[u] = __shfl_sync(kFull, static_cast<int>(my_ok), (t + u) & (kWarp - 1));
            p[u] = t + u < cnt ? w[base + t + u] : T(0);
          }
          if (mine) {
#pragma unroll
            for (int u = 0; u < kRound; ++u) {
              if (t + u >= cnt) continue;
              const T* vrow = v + static_cast<long long>(c[u]) * ldv;
              if (tail) x[u] = splat<T>(vrow[vt]);
              else x[u] = load_vec<T, VEC>(vrow, vi);
            }
#pragma unroll
            for (int u = 0; u < kRound; ++u) {
              if (t + u >= cnt) continue;
              acc = axpy_vec(p[u], x[u], acc);
              if (ok[u] && !finite_vec(x[u])) nan_row = true;
            }
          }
        }
      }
      if (mine) {
        if (tail) orow[vt] = acc.x;
        else store_vec<T, VEC>(orow, vi, acc);
      }
    }

    // the reference's NaN rows: each lane rewrites what it wrote
    if (__any_sync(kFull, nan_row)) {
      const VT nan = splat<T>(T(NAN));
      for (long long vi = lane; vi < nv; vi += kWarp) store_vec<T, VEC>(orow, vi, nan);
      if (vt < dv) orow[vt] = T(NAN);
    }
    __syncwarp();  // the strip is free for the next row
  }
}

template <typename T, typename I>
int launch(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv, const void* cols,
           const void* valid, long long n_rows, long long n_keys, long long cap, long long d, long long dv, double scale,
           long long vec, long long max_blocks, void* scratch, void* out, void* stream) {
  if (n_rows <= 0 || dv <= 0) return 0;
  if (cap < 1 || n_keys < 1 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long wanted = (n_rows + kWarps - 1) / kWarps;
  const long long blocks = wanted < max_blocks ? wanted : max_blocks;
  const size_t smem = scratch != nullptr ? 0 : static_cast<size_t>(kWarps) * cap * sizeof(T);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const I* cp = static_cast<const I*>(cols);
  const unsigned char* okp = static_cast<const unsigned char*>(valid);
  T* sp = static_cast<T*>(scratch);
  T* op = static_cast<T*>(out);
  const T s = static_cast<T>(scale);
  if (vec) {
    ell_attention_kernel<T, I, true><<<blocks, kThreads, smem, st>>>(qp, ldq, kp, ldk, vp, ldv, cp, okp, n_rows, n_keys,
                                                                      cap, d, dv, s, sp, op);
  } else {
    ell_attention_kernel<T, I, false><<<blocks, kThreads, smem, st>>>(qp, ldq, kp, ldk, vp, ldv, cp, okp, n_rows,
                                                                       n_keys, cap, d, dv, s, sp, op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ST_ELL_ATTENTION(NAME, T, I)                                                                              \
  int NAME(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,             \
           const void* cols, const void* valid, long long n_rows, long long n_keys, long long cap, long long d,  \
           long long dv, double scale, long long vec, long long max_blocks, void* scratch, void* out,            \
           void* stream) {                                                                                        \
    return launch<T, I>(q, ldq, k, ldk, v, ldv, cols, valid, n_rows, n_keys, cap, d, dv, scale, vec, max_blocks, \
                        scratch, out, stream);                                                                    \
  }

ST_ELL_ATTENTION(st_ell_attention_f32_i32, float, int32_t)
ST_ELL_ATTENTION(st_ell_attention_f32_i64, float, int64_t)
ST_ELL_ATTENTION(st_ell_attention_f64_i32, double, int32_t)
ST_ELL_ATTENTION(st_ell_attention_f64_i64, double, int64_t)

}  // extern "C"
