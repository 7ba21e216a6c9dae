// Row-ELL sparse attention (K6) for Hopper (sm_90a), its forward and its backward, plain C interface
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
// 1.07 GB each, for every head. K6 writes nothing but the output. It has two
// kernels: the row kernel just below, for every input, and the tile route
// further down (float32, widths multiples of 8), which takes a block of query
// rows against the union of their keys on the tensor cores and leaves to the
// row kernel the blocks it cannot take. Its backward has the same two: a row
// backward kernel, and a tile route on the same block layout (float32, widths
// multiples of 8 up to 128) that leaves it the same kind of blocks.
//
// The row kernel. Bound: bytes. From HBM, q, e_cols, valid and out once, and
// the k and v tables once (the distinct rows); the L * cap gathered k rows and
// v rows come from L2, at the card's whole-row rate (about 7.3 TB/s on an
// H100, PERF.md), which is the floor of this design: 2 * L * cap * 256 bytes
// at Longformer-base's width, 1.08 GB a head, 0.147 ms.
//
// Design: one warp a query row, a persistent grid walking the rows (with a
// block_route, only the rows of the blocks the tile route marked).
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
                         long long d, long long dv, T scale, const int* __restrict__ block_route, long long block_rows,
                         T* __restrict__ scratch, T* __restrict__ out) {
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
    if (block_route != nullptr && block_route[row / block_rows] == 0) continue;  // the tile route wrote it
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
           long long vec, long long max_blocks, const void* block_route, long long block_rows, void* scratch, void* out,
           void* stream) {
  if (n_rows <= 0 || dv <= 0) return 0;
  if (cap < 1 || n_keys < 1 || max_blocks < 1 || (block_route != nullptr && block_rows < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const int* rp = static_cast<const int*>(block_route);
  T* sp = static_cast<T*>(scratch);
  T* op = static_cast<T*>(out);
  const T s = static_cast<T>(scale);
  if (vec) {
    ell_attention_kernel<T, I, true><<<blocks, kThreads, smem, st>>>(qp, ldq, kp, ldk, vp, ldv, cp, okp, n_rows, n_keys,
                                                                      cap, d, dv, s, rp, block_rows, sp, op);
  } else {
    ell_attention_kernel<T, I, false><<<blocks, kThreads, smem, st>>>(qp, ldq, kp, ldk, vp, ldv, cp, okp, n_rows,
                                                                       n_keys, cap, d, dv, s, rp, block_rows, sp, op);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K6's backward: the row kernel's gradient, a warp a query row.
//
// Replaces the gradient of sparse_tpu/nn.py:sparse_attention_ell (XLA code:
// jax.grad through the packed gather, the masked softmax and the weighted
// sum). Eager PyTorch, autograd on a recompute, writes three (L, cap, d + dv)
// blocks of 1.07 GB each a head at Longformer-base's width (L = 4,096, 513
// slots a row, d = dv = 64, float32), 17.2 GB each at L = 65,536. This kernel
// writes dq and two (L, cap) strips; dk and dv are K5's (csrc/mttkrp.cu),
// summed by key over the pattern's slots in a fixed order.
//
// For query row i, its slots j and g = the output's gradient row:
//   s_j, p_j  the forward's scores and masked softmax, recomputed
//   dP_j      = g · v[c_j]  (+ NaN where k[c_j] holds a non-finite value or
//               c_j lies outside the table: the reference's 0 · k and fill row)
//   δ         = sum_j p_j dP_j over every slot
//   dS_j      = p_j (dP_j - δ) on the valid slots, 0 on the others
//   dq        = scale * sum_j dS_j k[c_j] over every slot in the table, by
//               FMA in slot order (NaN where a slot lies outside the table)
// and writes ds_j = dS_j where p_j is finite, else NaN (dk sums dS qs + p 0),
// and p_j where dS_j is finite, else NaN (dv sums dS 0 + p g). A row with a
// valid slot outside the table or a non-finite v value in a valid slot has
// p all NaN, as the reference's scores over the packed row make it.
//
// Design: the row kernel's persistent grid and warp a row (with a
// block_route, only the rows of the blocks the backward's tile route marked,
// as the forward's row kernel filters). Each row's two
// output rows of p and ds are its strips (no shared memory, no scratch, at
// any cap): pass 1 reads each slot's k row (padding slots too, for their
// finiteness) and writes the scores to p in K6's lane order and butterfly,
// so p carries the forward's bits, and each slot's 0 or NaN to ds; pass 2
// reads each slot's v row once against g held in registers, the same
// butterfly giving dP, added to ds; then the softmax over p, δ by lanes over
// slots and an xor butterfly, dS; pass 3 reads each slot's k row again, a
// lane a 16-byte vector of d, and adds dS_j k_j in slot order. No atomics and
// one order: two launches give the same bits.
//
// Bound: bytes. From HBM, q, g, dq and the two strips once, the pattern
// once, the distinct k and v rows once; the 3 L cap gathered rows (k twice,
// v once) come from L2, at the card's whole-row rate, the floor of this
// design: 3 * L * cap * 256 bytes at Longformer-base's width, 1.6 GB a head.
// K6's backward's CTAs an SM (the second bound of __launch_bounds__) and
// slots a round, as chip_attention_ablation.py varies them
#ifndef ATTENTION_BWD_MIN_BLOCKS
#define ATTENTION_BWD_MIN_BLOCKS 1
#endif
#ifndef ATTENTION_BWD_ROUND
#define ATTENTION_BWD_ROUND 4
#endif
constexpr int kBwdRound = ATTENTION_BWD_ROUND;

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(kThreads, ATTENTION_BWD_MIN_BLOCKS)
    ell_attention_backward_kernel(const T* __restrict__ q, long long ldq, const T* __restrict__ k, long long ldk,
                                  const T* __restrict__ v, long long ldv, const T* __restrict__ g, long long ldg,
                                  const I* __restrict__ cols, const unsigned char* __restrict__ valid,
                                  long long n_rows, long long n_keys, long long cap, long long d, long long dv,
                                  T scale, const int* __restrict__ block_route, long long block_rows,
                                  T* __restrict__ dq, T* __restrict__ ds, T* __restrict__ p) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::width;
  const int lane = threadIdx.x % kWarp;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long nq = d / V, kt = nq * V + lane;  // d's vectors; this lane's tail element of d, where it exists
  const long long nv = dv / V, vt = nv * V + lane;  // the same of dv
  const T neg_inf = -INFINITY;
  const T nan = T(NAN);

  for (long long row = warp; row < n_rows; row += n_warps) {
    if (block_route != nullptr && block_route[row / block_rows] == 0) continue;  // the tile route wrote it
    const T* qr = q + row * ldq;
    const T* gr = g + row * ldg;
    const I* cr = cols + row * cap;
    const unsigned char* okr = valid + row * cap;
    T* pr = p + row * cap;
    T* sr = ds + row * cap;
    bool nan_row = false;  // a valid slot outside the table, or a non-finite v value in a valid slot
    bool outside = false;  // a slot outside the table: dq's row NaN

    // pass 1: the scores (K6's order) into p; 0, or NaN for a non-finite k value or a slot outside the table, into ds
    for (long long base = 0; base < cap; base += kWarp) {
      const int cnt = static_cast<int>(min(static_cast<long long>(kWarp), cap - base));
      int my_col = 0;
      bool my_in = false, my_ok = false;
      if (lane < cnt) {
        const int c = key_row(cr, base + lane, n_keys);
        my_in = c >= 0;
        my_ok = okr[base + lane] != 0 && my_in;
        outside |= !my_in;
        nan_row |= okr[base + lane] != 0 && !my_in;
        my_col = my_in ? c : 0;
      }
      for (int t = 0; t < cnt; t += kBwdRound) {
        int c[kBwdRound];
        bool in[kBwdRound];
        T acc[kBwdRound];
#pragma unroll
        for (int u = 0; u < kBwdRound; ++u) {
          c[u] = __shfl_sync(kFull, my_col, (t + u) & (kWarp - 1));
          in[u] = __shfl_sync(kFull, static_cast<int>(my_in), (t + u) & (kWarp - 1)) && t + u < cnt;
          acc[u] = T(0);
        }
        unsigned bad = 0;  // bit u: a non-finite value in slot t + u's k row
        for (long long vi = lane; vi < nq; vi += kWarp) {
          const VT qv = scale_vec(load_vec<T, VEC>(qr, vi), scale);
          VT kv[kBwdRound];
#pragma unroll
          for (int u = 0; u < kBwdRound; ++u) {
            if (in[u]) kv[u] = load_vec<T, VEC>(k + static_cast<long long>(c[u]) * ldk, vi);
          }
#pragma unroll
          for (int u = 0; u < kBwdRound; ++u) {
            if (in[u]) {
              acc[u] = dot_vec(qv, kv[u], acc[u]);
              if (!finite_vec(kv[u])) bad |= 1u << u;
            }
          }
        }
        if (kt < d) {
          const T qt = qr[kt] * scale;
#pragma unroll
          for (int u = 0; u < kBwdRound; ++u) {
            if (in[u]) {
              const T x = k[static_cast<long long>(c[u]) * ldk + kt];
              acc[u] = fma_(qt, x, acc[u]);
              if (!isfinite(x)) bad |= 1u << u;
            }
          }
        }
        const T mine = reduce_slots<T, kBwdRound>(acc, t, lane);
        bad = __reduce_or_sync(kFull, bad);
        if (lane >= t && lane < t + kBwdRound && lane < cnt) {
          pr[base + lane] = my_ok ? mine : neg_inf;
          sr[base + lane] = (!my_in || ((bad >> (lane - t)) & 1u)) ? nan : T(0);
        }
      }
    }
    __syncwarp();

    // pass 2: dP_j = g · v_j added to ds, by the same lanes and butterfly
    for (long long base = 0; base < cap; base += kWarp) {
      const int cnt = static_cast<int>(min(static_cast<long long>(kWarp), cap - base));
      int my_col = 0;
      bool my_in = false, my_valid = false;
      if (lane < cnt) {
        const int c = key_row(cr, base + lane, n_keys);
        my_in = c >= 0;
        my_valid = okr[base + lane] != 0;
        my_col = my_in ? c : 0;
      }
      for (int t = 0; t < cnt; t += kBwdRound) {
        int c[kBwdRound];
        bool in[kBwdRound];
        T acc[kBwdRound];
#pragma unroll
        for (int u = 0; u < kBwdRound; ++u) {
          c[u] = __shfl_sync(kFull, my_col, (t + u) & (kWarp - 1));
          in[u] = __shfl_sync(kFull, static_cast<int>(my_in), (t + u) & (kWarp - 1)) && t + u < cnt;
          acc[u] = T(0);
        }
        unsigned bad = 0;  // bit u: a non-finite value in slot t + u's v row
        for (long long vi = lane; vi < nv; vi += kWarp) {
          const VT gv = load_vec<T, VEC>(gr, vi);
          VT xv[kBwdRound];
#pragma unroll
          for (int u = 0; u < kBwdRound; ++u) {
            if (in[u]) xv[u] = load_vec<T, VEC>(v + static_cast<long long>(c[u]) * ldv, vi);
          }
#pragma unroll
          for (int u = 0; u < kBwdRound; ++u) {
            if (in[u]) {
              acc[u] = dot_vec(gv, xv[u], acc[u]);
              if (!finite_vec(xv[u])) bad |= 1u << u;
            }
          }
        }
        if (vt < dv) {
          const T gt = gr[vt];
#pragma unroll
          for (int u = 0; u < kBwdRound; ++u) {
            if (in[u]) {
              const T x = v[static_cast<long long>(c[u]) * ldv + vt];
              acc[u] = fma_(gt, x, acc[u]);
              if (!isfinite(x)) bad |= 1u << u;
            }
          }
        }
        const T mine = reduce_slots<T, kBwdRound>(acc, t, lane);
        bad = __reduce_or_sync(kFull, bad);
        if (lane >= t && lane < t + kBwdRound && lane < cnt) {
          sr[base + lane] += mine;
          nan_row |= my_valid && ((bad >> (lane - t)) & 1u);
        }
      }
    }
    __syncwarp();
    nan_row = __any_sync(kFull, nan_row);

    // the softmax over p, as K6's; a NaN row's weights all NaN
    T m = neg_inf;
    for (long long j = lane; j < cap; j += kWarp) m = nan_max(m, pr[j]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) m = nan_max(m, __shfl_xor_sync(kFull, m, off));
    if (!isfinite(m)) m = T(0);
    T denom = T(0);
    for (long long j = lane; j < cap; j += kWarp) {
      const T e = exp_(pr[j] - m);  // an invalid slot holds -inf: 0
      pr[j] = e;
      denom += e;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) denom += __shfl_xor_sync(kFull, denom, off);
    if (denom == T(0)) denom = T(1);
    // δ = sum_j p_j dP_j: lanes over slots in order, then an xor butterfly (every lane the same bits)
    T delta = T(0);
    for (long long j = lane; j < cap; j += kWarp) {
      const T pj = nan_row ? nan : pr[j] / denom;
      pr[j] = pj;
      delta = fma_(pj, sr[j], delta);
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) delta += __shfl_xor_sync(kFull, delta, off);
    // dS, and the two strips' weights
    for (long long j = lane; j < cap; j += kWarp) {
      const T pj = pr[j];
      const T dsj = okr[j] != 0 ? pj * (sr[j] - delta) : T(0);
      sr[j] = isfinite(pj) ? dsj : nan;
      pr[j] = isfinite(dsj) ? pj : nan;
    }
    __syncwarp();

    // pass 3: dq = scale * sum_j dS_j k_j, a lane a 16-byte vector of d, then the tail elements
    T* dqr = dq + row * d;
    const long long n_rounds = (nq + kWarp - 1) / kWarp + (nq * V < d ? 1 : 0);
    for (long long r = 0; r < n_rounds; ++r) {
      const bool tail = r * kWarp >= nq;  // warp-uniform: the round of the tail elements
      const long long vi = r * kWarp + lane;
      const bool mine = tail ? kt < d : vi < nq;
      VT acc = splat<T>(T(0));
      for (long long base = 0; base < cap; base += kWarp) {
        const int cnt = static_cast<int>(min(static_cast<long long>(kWarp), cap - base));
        int my_col = 0;
        bool my_in = false;
        T my_ds = T(0);
        if (lane < cnt) {
          const int c = key_row(cr, base + lane, n_keys);
          my_in = c >= 0;
          my_col = my_in ? c : 0;
          my_ds = okr[base + lane] != 0 ? sr[base + lane] : T(0);  // dS itself: 0 on an invalid slot
        }
        for (int t = 0; t < cnt; t += kBwdRound) {
          int c[kBwdRound];
          bool in[kBwdRound];
          T w[kBwdRound];
          VT x[kBwdRound];
#pragma unroll
          for (int u = 0; u < kBwdRound; ++u) {
            c[u] = __shfl_sync(kFull, my_col, (t + u) & (kWarp - 1));
            in[u] = __shfl_sync(kFull, static_cast<int>(my_in), (t + u) & (kWarp - 1)) && t + u < cnt;
            w[u] = __shfl_sync(kFull, my_ds, (t + u) & (kWarp - 1));
          }
          if (mine) {
#pragma unroll
            for (int u = 0; u < kBwdRound; ++u) {
              if (!in[u]) continue;
              const T* krow = k + static_cast<long long>(c[u]) * ldk;
              if (tail) x[u] = splat<T>(krow[kt]);
              else x[u] = load_vec<T, VEC>(krow, vi);
            }
#pragma unroll
            for (int u = 0; u < kBwdRound; ++u) {
              if (in[u]) acc = axpy_vec(w[u], x[u], acc);
            }
          }
        }
      }
      if (mine) {
        acc = scale_vec(acc, scale);
        if (tail) dqr[kt] = acc.x;
        else store_vec<T, VEC>(dqr, vi, acc);
      }
    }

    // a slot outside the table: the reference's dq row NaN (its fill row times dS)
    if (__any_sync(kFull, outside)) {
      const VT nanv = splat<T>(nan);
      for (long long vi = lane; vi < nq; vi += kWarp) store_vec<T, VEC>(dqr, vi, nanv);
      if (kt < d) dqr[kt] = nan;
    }
    __syncwarp();  // the strips are written before the next row's
  }
}

template <typename T, typename I>
int launch_backward(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,
                    const void* g, long long ldg, const void* cols, const void* valid, long long n_rows,
                    long long n_keys, long long cap, long long d, long long dv, double scale, long long vec,
                    long long max_blocks, const void* block_route, long long block_rows, void* dq, void* ds, void* p,
                    void* stream) {
  if (n_rows <= 0) return 0;
  if (cap < 1 || n_keys < 1 || max_blocks < 1 || d < 0 || dv < 0 || (block_route != nullptr && block_rows < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long wanted = (n_rows + kWarps - 1) / kWarps;
  const long long blocks = wanted < max_blocks ? wanted : max_blocks;
  auto st = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const I* cp = static_cast<const I*>(cols);
  const unsigned char* okp = static_cast<const unsigned char*>(valid);
  T* dqp = static_cast<T*>(dq);
  T* dsp = static_cast<T*>(ds);
  T* pp = static_cast<T*>(p);
  const int* rp = static_cast<const int*>(block_route);
  const T s = static_cast<T>(scale);
  if (vec) {
    ell_attention_backward_kernel<T, I, true><<<blocks, kThreads, 0, st>>>(
        qp, ldq, kp, ldk, vp, ldv, gp, ldg, cp, okp, n_rows, n_keys, cap, d, dv, s, rp, block_rows, dqp, dsp, pp);
  } else {
    ell_attention_backward_kernel<T, I, false><<<blocks, kThreads, 0, st>>>(
        qp, ldq, kp, ldk, vp, ldv, gp, ldg, cp, okp, n_rows, n_keys, cap, d, dv, s, rp, block_rows, dqp, dsp, pp);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The tile route (float32): a block of BQ consecutive query rows against the
// union of the keys its slots name, on the tensor cores in 3xTF32.
//
// The layout (kernels/attention.py:build_attention_blocks, built once a
// pattern): for block b, `keys[b, :n_union[b]]` its union, the sorted
// distinct key rows its slots name (padding slots too, so that the check
// below sees them); `count[b, u, r]` the valid slots of row r naming key
// keys[b, u] (a duplicate slot counts twice, as the reference sums it twice);
// `flag[b]` an index outside the table, a union past the layout's capacity
// (the route rule) or a count past 255.
//
// A CTA (or a cluster of CL CTAs, CTA `rank` taking the stages rank, rank +
// CL, ...) takes one block. Its warps are BQ / 16 row groups times KS key
// slices: warp (rg, ks) owns rows 16 rg .. 16 rg + 15 and keys ks * CH / KS
// .. of each stage of CH union keys. Per stage:
// - the stage's k rows, v rows and counts come to shared memory by cp.async,
//   16 bytes a thread, double-buffered (TMA has no row gather);
// - the CTA splits each k and v value once into hi = x rounded to tf32 and
//   lo = (x - hi) rounded, written in the mma fragments' order (a lane's four
//   values of an 8 x 8 tile in one 16-byte word, so a warp reads a tile in
//   one conflict-free load), and checks it for a non-finite value;
// - S = qs · Kᵀ by mma.sync.m16n8k8 TF32 as hi·lo + lo·hi + hi·hi
//   (3xTF32); qs = scale * q rounded (the reference's qs), split once into
//   shared memory in fragment order;
// - a score counts where its count is not 0: the row's running maximum m
//   (an empty one counts as 0 in the shift), p = count * exp(s - m), the
//   running sum l and output O rescaled by exp(m_old - m_new);
// - O += P · V on the tensor cores, 3xTF32. P goes from the accumulator to
//   the A operand without a shuffle: the k index t of an 8-key step stands
//   for key 2t and t + 4 for key 2t + 1, and V's fragments are laid out in
//   that order.
// At the end the partials of a row (KS warps, CL CTAs) are merged in one
// order, rank then key slice, on the first CTA (the others store theirs into
// its shared memory), and O is divided by l once, at the store (a sum of 0
// counts as 1). No atomics on values, one order: two launches give the same
// bits.
//
// The reference's non-finite and index rules are not reproduced here: a
// block with a flag, a non-finite value in its q rows or in any k or v row
// of its union writes nothing and is marked in `route` (1 flag, 2 non-finite
// values); the row kernel above then runs on the marked blocks' rows (a
// second launch, filtered by `route` on the card, nothing read back).
// `route_blocks[0..2]` count the blocks each way (one atomic a block).
//
// Bound: bytes and operations. From HBM, q and out once and the union rows
// of k and v once a block (at Longformer-base's width 64 blocks of 576 keys,
// 18.9 MB a head, against K6's row route's 1.06 GB gathered from L2); the
// products are 2 * BQ * |U| * (d + dv) a block, three passes each.
namespace tiles {

constexpr int kPad = 4;  // floats after each staged row: the split's reads hit 32 banks
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  long long raw;          // offset of the two stages (q's fragments lie before them)
  long long kbytes;       // a stage's k rows
  long long vbytes;       // its v rows
  long long stage_bytes;  // k rows, v rows, counts
  long long frag;         // offset of the split stage: k's fragments, then v's
  long long total;        // bytes in all, the CTAs' flag words last
};

__host__ __device__ inline Smem smem_plan(int bq, int ks, int cl, int ch, long long d, long long dv) {
  Smem s;
  s.raw = static_cast<long long>(bq) * d * 2 * 4;  // hi and lo of qs
  s.kbytes = static_cast<long long>(ch) * (d + kPad) * 4;
  s.vbytes = static_cast<long long>(ch) * (dv + kPad) * 4;
  s.stage_bytes = s.kbytes + s.vbytes + static_cast<long long>(ch) * bq;
  s.frag = s.raw + 2 * s.stage_bytes;
  const long long loop = 2 * s.stage_bytes + static_cast<long long>(ch) * (d + dv) * 2 * 4;
  const long long merge = static_cast<long long>(cl) * bq * ks * (dv + 2) * 4;  // every warp's O, m and l, a slot a CTA
  s.total = s.raw + (loop > merge ? loop : merge) + 16;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool copy) {
  // 16 bytes, or 16 zero bytes where `copy` is false (src-size 0); nothing
  // reads the destination before cp_wait and a barrier, which order it
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(copy ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address in CTA `rank`'s shared memory of what lies at `p` in this CTA's
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  return addr;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, int x) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}
// a value (or pair) at `p`, in this CTA's shared memory for the first CTA
// of the cluster, in the first CTA's at the same place for the others
template <int CL>
__device__ __forceinline__ void put(float* p, uint32_t rank, float x) {
  if (CL == 1 || rank == 0) *p = x;
  else st_cluster(map_rank(p, 0), x);
}
template <int CL>
__device__ __forceinline__ void put(float* p, uint32_t rank, float x, float y) {
  if (CL == 1 || rank == 0) *reinterpret_cast<float2*>(p) = make_float2(x, y);
  else st_cluster(map_rank(p, 0), x, y);
}

// x rounded to tf32 (nearest, ties away from zero, as cvt.rna.tf32.f32), as in csrc/bsr_tc.cu
__device__ __forceinline__ uint32_t tf32_bits(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }
// the 3xTF32 split of a finite value
__device__ __forceinline__ void split(float x, uint32_t& h, uint32_t& l) {
  h = tf32_bits(x);
  l = tf32_bits(x - __uint_as_float(h));
}
// the hi and lo of two values as one fragment word: (hi x, hi y, lo x, lo y)
__device__ __forceinline__ float4 split2(float x, float y) {
  uint32_t hx, lx, hy, ly;
  split(x, hx, lx);
  split(y, hy, ly);
  return make_float4(__uint_as_float(hx), __uint_as_float(hy), __uint_as_float(lx), __uint_as_float(ly));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// c += a · b in 3xTF32 (b a fragment word): the two cross terms first, then hi · hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma(c, al[0], al[1], al[2], al[3], bh0, bh1);
  mma(c, ah[0], ah[1], ah[2], ah[3], __float_as_uint(b.z), __float_as_uint(b.w));
  mma(c, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

template <int BQ, int KS, int CL, int DVT, int CH>
__global__ void __launch_bounds__(BQ / 16 * KS * 32)
    ell_attention_tiles_kernel(const float* __restrict__ q, long long ldq, const float* __restrict__ k, long long ldk,
                               const float* __restrict__ v, long long ldv, const int* __restrict__ keys,
                               const int* __restrict__ n_union, const unsigned char* __restrict__ count,
                               const unsigned char* __restrict__ flag, long long n_rows, long long u_cap, int d,
                               int dv, float scale, int* __restrict__ route,
                               unsigned long long* __restrict__ route_blocks, float* __restrict__ out) {
  constexpr int kGroups = BQ / 16;  // row groups
  constexpr int kWarps = kGroups * KS;
  constexpr int kThreads = kWarps * 32;
  constexpr int kKeysW = CH / KS;  // a warp's keys of a stage
  constexpr int kNT = kKeysW / 8;  // its 8-key tiles
  constexpr int kNV = DVT / 8;     // 8-column tiles of the output, at most
  static_assert(BQ % 16 == 0 && CH % (8 * KS) == 0 && (CL == 1 || CL == 2) && kThreads % BQ == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rg = wid % kGroups, ks = wid / kGroups;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  const long long b = blockIdx.x / CL;
  const Smem plan = smem_plan(BQ, KS, CL, CH, d, dv);
  float* qf = reinterpret_cast<float*>(smem);
  float4* kf = reinterpret_cast<float4*>(smem + plan.frag);  // [key tile][d / 8][lane]
  float4* vf = kf + CH / 8 * (d / 8) * 32;                   // [key tile][dv / 8][lane]
  int* bad_word = reinterpret_cast<int*>(smem + plan.total - 16);

  if (flag[b]) {  // the row route takes the block: every CTA of the cluster leaves here
    if (rank == 0 && tid == 0) {
      route[b] = 1;
      atomicAdd(route_blocks + 1, 1ull);
    }
    return;
  }
  const long long n_u = n_union[b];
  const long long row0 = b * BQ;
  const int nd8 = d / 8, nv8 = dv / 8, dq4 = d / 4, dv4 = dv / 4;
  const int sk_ld = d + kPad, sv_ld = dv + kPad;

  const int* kb = keys + b * u_cap;
  const unsigned char* cb = count + b * u_cap * BQ;
  const long long n_chunks = (n_u + CH - 1) / CH;
  const long long mine = n_chunks > rank ? (n_chunks - rank + CL - 1) / CL : 0;
  auto stage = [&](long long i) { return smem + plan.raw + (i & 1) * plan.stage_bytes; };
  // each thread's first piece of a stage and its step, without a division in the loops:
  // a k row is dq4 16-byte pieces, a v row dv4; the fragments are tiles of 32 lanes
  const int kj0 = tid / dq4, ke0 = tid - kj0 * dq4, kjs = kThreads / dq4, kes = kThreads - kjs * dq4;
  const int vj0 = tid / dv4, ve0 = tid - vj0 * dv4, vjs = kThreads / dv4, ves = kThreads - vjs * dv4;
  auto issue = [&](long long i) {
    const long long c0 = (rank + i * CL) * CH;
    unsigned char* st = stage(i);
    float* sk = reinterpret_cast<float*>(st);
    float* sv = reinterpret_cast<float*>(st + plan.kbytes);
    unsigned char* sc = st + plan.kbytes + plan.vbytes;
#pragma unroll 4
    for (int j = kj0, e = ke0; j < CH;) {
      const bool live = c0 + j < n_u;
      cp16(sk + j * sk_ld + e * 4, live ? k + kb[c0 + j] * ldk + e * 4 : k, live);
      j += kjs, e += kes;
      if (e >= dq4) e -= dq4, ++j;
    }
#pragma unroll 4
    for (int j = vj0, e = ve0; j < CH;) {
      const bool live = c0 + j < n_u;
      cp16(sv + j * sv_ld + e * 4, live ? v + kb[c0 + j] * ldv + e * 4 : v, live);
      j += vjs, e += ves;
      if (e >= dv4) e -= dv4, ++j;
    }
    for (int pc = tid; pc < CH * BQ / 16; pc += kThreads) {
      const bool live = c0 + pc * 16 / BQ < n_u;
      cp16(sc + pc * 16, live ? cb + c0 * BQ + pc * 16 : cb, live);
    }
    cp_commit();
  };
  // stage i split into the fragments; true where every value is finite.
  // k's tile (key group jg, k-step k8), lane (g, t): k[8 jg + g][8 k8 + t]
  // and [.. + t + 4]; v's tile (key group jg, column tile n), lane (g, t):
  // v[8 jg + 2t][8 n + g] and v[8 jg + 2t + 1][8 n + g]. A warp takes whole
  // tiles: wid, wid + kWarps, ...
  const int kg0 = wid / nd8, kk0 = wid - kg0 * nd8, kgs = kWarps / nd8, kks = kWarps - kgs * nd8;
  const int vg0 = wid / nv8, vn0 = wid - vg0 * nv8, vgs = kWarps / nv8, vns = kWarps - vgs * nv8;
  auto split_stage = [&](long long i) {
    const unsigned char* st = stage(i);
    const float* sk = reinterpret_cast<const float*>(st) + g * sk_ld + t;
    const float* sv = reinterpret_cast<const float*>(st + plan.kbytes) + 2 * t * sv_ld + g;
    bool ok = true;
#pragma unroll 4
    for (int jg = kg0, k8 = kk0; jg < CH / 8;) {
      const float* r = sk + jg * 8 * sk_ld + k8 * 8;
      const float x = r[0], y = r[4];
      ok = ok && isfinite(x) && isfinite(y);
      kf[(jg * nd8 + k8) * 32 + lane] = split2(x, y);
      jg += kgs, k8 += kks;
      if (k8 >= nd8) k8 -= nd8, ++jg;
    }
#pragma unroll 4
    for (int jg = vg0, n = vn0; jg < CH / 8;) {
      const float* r = sv + jg * 8 * sv_ld + n * 8;
      const float x = r[0], y = r[sv_ld];
      ok = ok && isfinite(x) && isfinite(y);
      vf[(jg * nv8 + n) * 32 + lane] = split2(x, y);
      jg += vgs, n += vns;
      if (n >= nv8) n -= nv8, ++jg;
    }
    return ok;
  };

  if (mine > 0) issue(0);  // its rows come while q is laid out

  // qs, checked, split and stored in the A fragments' order: tile (row
  // group, k-step k8), lane (g, t) holds hi of a0..a3 then lo of a0..a3,
  // a0 = qs[16 rg + g][8 k8 + t], a1 row + 8, a2 column + 4, a3 both. A warp
  // takes whole tiles (wid, wid + kWarps, ...), its lanes' loads in flight
  // together, each lane's word stored in one piece
  int bad = 0;
  constexpr int kQTiles = 2;  // tiles a warp loads at once
  for (int tile0 = wid; tile0 < kGroups * nd8; tile0 += kQTiles * kWarps) {
    float a[kQTiles][4];
#pragma unroll
    for (int u = 0; u < kQTiles; ++u) {
      const int tile = tile0 + u * kWarps, gr = tile / nd8, k8 = tile - gr * nd8;
      const long long r = row0 + gr * 16 + g;
      const float* qr = q + r * ldq + k8 * 8 + t;
      const bool in = tile < kGroups * nd8;
      a[u][0] = in && r < n_rows ? qr[0] : 0.0f;
      a[u][1] = in && r + 8 < n_rows ? qr[8 * ldq] : 0.0f;
      a[u][2] = in && r < n_rows ? qr[4] : 0.0f;
      a[u][3] = in && r + 8 < n_rows ? qr[8 * ldq + 4] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kQTiles; ++u) {
      const int tile = tile0 + u * kWarps;
      if (tile >= kGroups * nd8) break;
      uint32_t h[4], l[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = a[u][c] * scale;
        bad |= !isfinite(x);
        split(x, h[c], l[c]);
      }
      float4* dst = reinterpret_cast<float4*>(qf + (static_cast<long long>(tile) * 32 + lane) * 8);
      dst[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
      dst[1] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
  }

  float o[kNV][4];
#pragma unroll
  for (int n = 0; n < kNV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};  // rows g and g + 8 of the group
  const int kt0 = ks * kNT;                                            // this warp's first key tile of a stage
  const float* qw = qf + static_cast<long long>(rg) * nd8 * 32 * 8 + lane * 8;

  for (long long i = 0; i < mine; ++i) {
    if (i + 1 < mine) {
      issue(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // stage i landed; the fragments are free
    bad |= !split_stage(i);
    // this warp's counts, taken before the barrier below: after it, issue(i + 2) may refill the stage
    const unsigned char* sc = stage(i) + plan.kbytes + plan.vbytes;
    unsigned cn[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cn[nt][e] = sc[((kt0 + nt) * 8 + 2 * t + (e & 1)) * BQ + rg * 16 + g + (e >> 1) * 8];
    }
    if (__syncthreads_or(bad)) {
      bad = 1;
      break;
    }

    // S = qs · Kᵀ over this warp's keys
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll 2
    for (int k8 = 0; k8 < nd8; ++k8) {
      const float4 h4 = *reinterpret_cast<const float4*>(qw + k8 * 32 * 8);
      const float4 l4 = *reinterpret_cast<const float4*>(qw + k8 * 32 * 8 + 4);
      const uint32_t ah[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y), __float_as_uint(h4.z),
                              __float_as_uint(h4.w)};
      const uint32_t al[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y), __float_as_uint(l4.z),
                              __float_as_uint(l4.w)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma3(s[nt], ah, al, kf[((kt0 + nt) * nd8 + k8) * 32 + lane]);
    }

    // the rows' maxima over the positions they name
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (cn[nt][e] != 0) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      const float alpha = m_run[h] == -INFINITY ? 0.0f : expf(m_run[h] - m_new);
      m_run[h] = m_new;
      mu[h] = m_new == -INFINITY ? 0.0f : m_new;  // an empty row so far: the shift counts as 0
      l_run[h] *= alpha;
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    // P, and O += P · V: A's k index t is key 2t, t + 4 key 2t + 1
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = cn[j][e] != 0 ? static_cast<float>(cn[j][e]) * expf(s[j][e] - mu[e >> 1]) : 0.0f;
        l_run[e >> 1] += p[e];
      }
      uint32_t ah[4], al[4];
      split(p[0], ah[0], al[0]);
      split(p[2], ah[1], al[1]);
      split(p[1], ah[2], al[2]);
      split(p[3], ah[3], al[3]);
      const float4* vw = vf + (kt0 + j) * nv8 * 32 + lane;
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
        if (n < nv8) mma3(o[n], ah, al, vw[n * 32]);
      }
    }
  }
  cp_wait<0>();
  bad = __syncthreads_or(bad);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's sum over the quad's columns
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 2);
  }

  const long long r_lo = row0 + rg * 16 + g;  // the thread's rows r_lo and r_lo + 8
  if constexpr (KS * CL == 1) {
    if (!bad) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r_lo + 8 * h >= n_rows) continue;
        const float inv = l_run[h] == 0.0f ? 1.0f : l_run[h];
        float* orow = out + (r_lo + 8 * h) * dv + 2 * t;
#pragma unroll
        for (int n = 0; n < kNV; ++n) {
          if (n < nv8) *reinterpret_cast<float2*>(orow + n * 8) = make_float2(o[n][2 * h] / inv, o[n][2 * h + 1] / inv);
        }
      }
    }
    if (tid == 0) {
      route[b] = bad ? 2 : 0;
      atomicAdd(route_blocks + (bad ? 2 : 0), 1ull);
    }
  } else {
    // every warp's partial, O (16 rows of dv) then m and l of its 16 rows, in
    // slot `rank` of the first CTA's merge area
    const long long slot = static_cast<long long>(kWarps) * 16 * (dv + 2);
    float* part = reinterpret_cast<float*>(smem + plan.raw);
    float* mine_o = part + rank * slot;
    float* mine_m = mine_o + static_cast<long long>(kWarps) * 16 * dv;
    float* mine_l = mine_m + kWarps * 16;
    if constexpr (CL > 1) cluster_sync();  // the first CTA is done with its stages
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* prow = mine_o + static_cast<long long>(wid * 16 + g + 8 * h) * dv + 2 * t;
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
        if (n < nv8) put<CL>(prow + n * 8, rank, o[n][2 * h], o[n][2 * h + 1]);
      }
      if (t == 0) {
        put<CL>(mine_m + wid * 16 + g + 8 * h, rank, m_run[h]);
        put<CL>(mine_l + wid * 16 + g + 8 * h, rank, l_run[h]);
      }
    }
    int* bad_slot = bad_word + rank;
    if (tid == 0) {
      if (CL == 1 || rank == 0) *bad_slot = bad;
      else st_cluster(map_rank(bad_slot, 0), bad);
    }
    if constexpr (CL > 1) {
      cluster_sync();  // every slot in place
    } else {
      __syncthreads();
    }
    if (rank == 0) {
      int any_bad = 0;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk) any_bad |= bad_word[rk];
      if (!any_bad) {
        // kThreads / BQ threads a row: the row's factors once, then its columns
        constexpr int kPerRow = kThreads / BQ;
        const int r = tid / kPerRow;
        if (row0 + r < n_rows) {
          const int gr = r >> 4, rr = r & 15;
          float f[CL * KS], m_all = -INFINITY, sum = 0.0f;
#pragma unroll
          for (int rk = 0; rk < CL; ++rk) {
            const float* pm = part + rk * slot + static_cast<long long>(kWarps) * 16 * dv;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              f[rk * KS + kk] = pm[(kk * kGroups + gr) * 16 + rr];
              m_all = fmaxf(m_all, f[rk * KS + kk]);
            }
          }
#pragma unroll
          for (int rk = 0; rk < CL; ++rk) {
            const float* pl = part + rk * slot + static_cast<long long>(kWarps) * 16 * (dv + 1);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              const float m = f[rk * KS + kk];
              f[rk * KS + kk] = m == -INFINITY ? 0.0f : expf(m - m_all);
              sum += f[rk * KS + kk] * pl[(kk * kGroups + gr) * 16 + rr];
            }
          }
          const float inv = sum == 0.0f ? 1.0f : sum;
          for (int c = tid - r * kPerRow; c < dv; c += kPerRow) {
            float acc = 0.0f;
#pragma unroll
            for (int rk = 0; rk < CL; ++rk) {
#pragma unroll
              for (int kk = 0; kk < KS; ++kk) {
                acc += f[rk * KS + kk] * part[rk * slot + static_cast<long long>((kk * kGroups + gr) * 16 + rr) * dv + c];
              }
            }
            out[(row0 + r) * dv + c] = acc / inv;
          }
        }
      }
      if (tid == 0) {
        route[b] = any_bad ? 2 : 0;
        atomicAdd(route_blocks + (any_bad ? 2 : 0), 1ull);
      }
    }
  }
}

template <int BQ, int KS, int CL, int DVT, int CH>
int launch_tiles(const float* q, long long ldq, const float* k, long long ldk, const float* v, long long ldv,
                 const int* keys, const int* n_union, const unsigned char* count, const unsigned char* flag,
                 long long n_rows, long long n_blocks, long long u_cap, int d, int dv, float scale, int* route,
                 unsigned long long* route_blocks, float* out, cudaStream_t st) {
  auto kernel = ell_attention_tiles_kernel<BQ, KS, CL, DVT, CH>;
  const Smem plan = smem_plan(BQ, KS, CL, CH, d, dv);
  if (plan.total > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_blocks * CL));
  cfg.blockDim = dim3(BQ / 16 * KS * 32);
  cfg.dynamicSmemBytes = static_cast<size_t>(plan.total);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, q, ldq, k, ldk, v, ldv, keys, n_union, count, flag, n_rows, u_cap, d, dv,
                           scale, route, route_blocks, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K6's backward, the tile route (float32): a block of BQ consecutive query
// rows against the union of its keys, on the layout of the forward's tile
// route, the products on the tensor cores in 3xTF32. It writes what the row
// backward kernel writes, dq (L, d) and the strips ds and p (L, cap) in slot
// order, for the blocks it takes; dk and dv stay K5's over the slot pattern.
//
// For block b (its union U, counts c[u, r] as in the forward), per row r:
//   prologue  qs = scale * q rounded and the g rows, split once into hi/lo
//             fragments in shared memory; δ_r = g_r · out_r over dv by a
//             warp (lanes in order, an xor butterfly), out the forward's
//             output (FlashAttention-2's δ, Σ_j p_j dP_j up to rounding);
//   pass 1    the union's k rows (and v rows, for the finiteness check)
//             and counts staged by cp.async, double-buffered; S = qs · Kᵀ;
//             where a count is not 0, the running maximum m (an empty row's
//             shift 0) and l = Σ c · exp(s − m); the key slices' and the
//             cluster's (m, l) merged in one order, rank then key slice,
//             every CTA the same bits; l = 0 counts as 1;
//   pass 2    k rows, v rows and counts again; S again, p̂ = exp(S − m) / l
//             where c is not 0 (else 0), dP = g · Vᵀ (V in the place K
//             takes in S), dŝ = p̂ (dP − δ), dQ += (c ⊙ dŝ) · K (K the B
//             operand over keys as V is in the forward's P · V, the
//             accumulator the A operand by the same key order);
//   strips    each stage's p̂ and dŝ go to a tile in shared memory; each
//             slot of the block whose union place falls in the stage gets
//             them, each slot with none (an invalid slot) 0 and 0, written
//             once by the first stage of the first CTA. The layout keeps
//             each block's slots sorted by group of 8 union places, then
//             row (`order`, `begin`), so a stage's slots are one run of it,
//             read once, a row's slots of a group stored side by side;
//   epilogue  the key slices' and CTAs' dQ partials summed in one order
//             (rank then key slice) on the first CTA; dq = scale * dQ.
// No atomics on values, one order: two launches give the same bits.
//
// A block the layout flags, or with a non-finite value in its q, g or out
// rows or in its union's k or v rows (found in pass 1, before anything is
// written), writes nothing and is marked in `route` (1, 2), as the
// forward's tile route marks it; the row backward kernel then takes its rows
// (a second launch, filtered by `route` on the card). `route_blocks[0..2]`
// count the blocks each way (one atomic a block).
//
// Bound: bytes. From HBM q, g, out and dq once, the union rows of k and v
// once a block (twice from L2: one stream a pass), the counts, the layout's
// order and the two strips; the products are 2 BQ |U| (3d + dv) a block (S
// in both passes, dP, dQ), three passes of the tensor cores each.
#ifndef ATTENTION_BWD_PASS1_ONLY
#define ATTENTION_BWD_PASS1_ONLY 0  // chip_attention_ablation.py's build: pass 1 timed alone
#endif

constexpr int kPlaceGroup = 8;  // union places a group of the strip order (kernels/attention.py: PLACE_GROUP)

struct BwdSmem {
  long long kbytes;       // a stage's k rows
  long long vbytes;       // its v rows
  long long stage_bytes;  // k rows, v rows, counts
  long long raw;          // offset of the two stages (qs's and g's fragments lie before them)
  long long frag;         // offset of the split stage: K for S, K for dQ, V for dP
  long long tile;         // offset of the stage's p̂ and dŝ, BQ rows of CH + 8 each
  long long rows;         // offset of the rows' δ, shift and sum, the stage's run offsets
  long long part;         // offset of every warp's (m, l)
  long long total;        // bytes in all, the CTAs' flag words last
};

__host__ __device__ inline BwdSmem bwd_smem_plan(int bq, int ks, int cl, int ch, long long d, long long dv) {
  BwdSmem s;
  s.kbytes = static_cast<long long>(ch) * (d + kPad) * 4;
  s.vbytes = static_cast<long long>(ch) * (dv + kPad) * 4;
  s.stage_bytes = s.kbytes + s.vbytes + static_cast<long long>(ch) * bq;
  s.raw = static_cast<long long>(bq) * (d + dv) * 8;
  s.frag = s.raw + 2 * s.stage_bytes;
  s.tile = s.frag + static_cast<long long>(ch) * (2 * d + dv) * 8;
  const long long loop_end = s.tile + 2LL * bq * (ch + 8) * 4;
  const long long merge = static_cast<long long>(cl) * ks * bq * d * 4;  // every warp's dQ, a slot a CTA, over all before
  s.rows = loop_end > merge ? loop_end : merge;
  s.part = s.rows + static_cast<long long>(bq) * 3 * 4 + static_cast<long long>(ch + 4) * 4;
  s.total = s.part + static_cast<long long>(cl) * ks * bq * 2 * 4 + 16;
  return s;
}

template <int BQ, int KS, int CL, int DT, int CH>
__global__ void __launch_bounds__(BQ / 16 * KS * 32)
    ell_attention_backward_tiles_kernel(const float* __restrict__ q, long long ldq, const float* __restrict__ k,
                                        long long ldk, const float* __restrict__ v, long long ldv,
                                        const float* __restrict__ gq, long long ldg, const float* __restrict__ o,
                                        long long ldo, const int* __restrict__ keys, const int* __restrict__ n_union,
                                        const unsigned char* __restrict__ count, const unsigned char* __restrict__ flag,
                                        const int* __restrict__ order, const int* __restrict__ begin,
                                        long long n_rows, long long u_cap, long long cap, int d,
                                        int dv, float scale, float* __restrict__ dq, float* __restrict__ ds,
                                        float* __restrict__ p, int* __restrict__ route,
                                        unsigned long long* __restrict__ route_blocks) {
  constexpr int kGroups = BQ / 16;  // row groups
  constexpr int kWarps = kGroups * KS;
  constexpr int kThreads = kWarps * 32;
  constexpr int kKeysW = CH / KS;  // a warp's keys of a stage
  constexpr int kNT = kKeysW / 8;  // its 8-key tiles
  constexpr int kND = DT / 8;      // 8-column tiles of dQ, at most
  constexpr int kTL = CH + 8;      // the strip tile's row stride: a half warp's float2 stores hit 32 banks
  constexpr int kStageGroups = CH / kPlaceGroup;  // groups of places of the strip order a stage
  static_assert(BQ % 16 == 0 && CH % (8 * KS) == 0 && (CL == 1 || CL == 2) && kThreads % BQ == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rg = wid % kGroups, ks = wid / kGroups;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  const long long b = blockIdx.x / CL;
  const BwdSmem plan = bwd_smem_plan(BQ, KS, CL, CH, d, dv);
  float* qf = reinterpret_cast<float*>(smem);                // qs's A fragments: [tile (row group, k8)][lane][hi 4, lo 4]
  float* gf = qf + static_cast<long long>(BQ) * d * 2;       // g's, over dv
  float4* kf = reinterpret_cast<float4*>(smem + plan.frag);  // K for S: [key tile][d / 8][lane]
  float4* kn = kf + CH / 8 * (d / 8) * 32;                   // K for dQ: [key tile][d / 8][lane]
  float4* vk = kn + CH / 8 * (d / 8) * 32;                   // V for dP: [key tile][dv / 8][lane]
  float* tp = reinterpret_cast<float*>(smem + plan.tile);    // the stage's p̂: [row][kTL]
  float* td = tp + BQ * kTL;                                 // its dŝ
  float* row_delta = reinterpret_cast<float*>(smem + plan.rows);
  float* row_shift = row_delta + BQ;
  float* row_sum = row_shift + BQ;
  int* stage_runs = reinterpret_cast<int*>(row_sum + BQ);   // where the stage's groups' runs begin, and its end
  float* part_m = reinterpret_cast<float*>(smem + plan.part);  // [rank][warp][16 rows]
  float* part_l = part_m + CL * kWarps * 16;
  int* bad_word = reinterpret_cast<int*>(smem + plan.total - 16);

  if (flag[b]) {  // the row kernel takes the block: every CTA of the cluster leaves here
    if (rank == 0 && tid == 0) {
      route[b] = 1;
      atomicAdd(route_blocks + 1, 1ull);
    }
    return;
  }
  const long long n_u = n_union[b];
  const long long row0 = b * BQ;
  const long long n_groups = (u_cap + kPlaceGroup - 1) / kPlaceGroup;  // of the strip order
  const int nd8 = d / 8, nv8 = dv / 8, dq4 = d / 4, dv4 = dv / 4;
  const int sk_ld = d + kPad, sv_ld = dv + kPad;
  const int* kb = keys + b * u_cap;
  const unsigned char* cb = count + b * u_cap * BQ;
  const long long n_chunks = (n_u + CH - 1) / CH;
  const long long mine = n_chunks > rank ? (n_chunks - rank + CL - 1) / CL : 0;
  auto stage = [&](long long i) { return smem + plan.raw + (i & 1) * plan.stage_bytes; };
  const int kj0 = tid / dq4, ke0 = tid - kj0 * dq4, kjs = kThreads / dq4, kes = kThreads - kjs * dq4;
  const int vj0 = tid / dv4, ve0 = tid - vj0 * dv4, vjs = kThreads / dv4, ves = kThreads - vjs * dv4;
  auto issue = [&](long long i) {  // stage i's k rows, v rows and counts, as the forward stages them
    const long long c0 = (rank + i * CL) * CH;
    unsigned char* st = stage(i);
    float* sk = reinterpret_cast<float*>(st);
    float* sv = reinterpret_cast<float*>(st + plan.kbytes);
    unsigned char* sc = st + plan.kbytes + plan.vbytes;
#pragma unroll 4
    for (int j = kj0, e = ke0; j < CH;) {
      const bool live = c0 + j < n_u;
      cp16(sk + j * sk_ld + e * 4, live ? k + kb[c0 + j] * ldk + e * 4 : k, live);
      j += kjs, e += kes;
      if (e >= dq4) e -= dq4, ++j;
    }
#pragma unroll 4
    for (int j = vj0, e = ve0; j < CH;) {
      const bool live = c0 + j < n_u;
      cp16(sv + j * sv_ld + e * 4, live ? v + kb[c0 + j] * ldv + e * 4 : v, live);
      j += vjs, e += ves;
      if (e >= dv4) e -= dv4, ++j;
    }
    for (int pc = tid; pc < CH * BQ / 16; pc += kThreads) {
      const bool live = c0 + pc * 16 / BQ < n_u;
      cp16(sc + pc * 16, live ? cb + c0 * BQ + pc * 16 : cb, live);
    }
    cp_commit();
  };
  // stage i split into fragments; true where every value is finite. Pass 1
  // (full false): K for S, and the v rows checked. Pass 2: K for S (tile
  // (jg, k8), lane (g, t): k[8 jg + g][8 k8 + t] and [.. + 4]), K for dQ
  // (tile (jg, n): k[8 jg + 2t][8 n + g] and k[8 jg + 2t + 1][8 n + g]) and
  // V for dP (tile (jg, k8) over dv: v[8 jg + g][8 k8 + t] and [.. + 4]).
  // A warp takes whole tiles: wid, wid + kWarps, ...
  auto split_stage = [&](long long i, bool full) {
    const unsigned char* st = stage(i);
    const float* skr = reinterpret_cast<const float*>(st);
    const float* svr = reinterpret_cast<const float*>(st + plan.kbytes);
    bool ok = true;
    {
      const float* sk = skr + g * sk_ld + t;
      for (int w = wid; w < CH / 8 * nd8; w += kWarps) {
        const int jg = w / nd8, k8 = w - jg * nd8;
        const float* r = sk + jg * 8 * sk_ld + k8 * 8;
        const float x = r[0], y = r[4];
        ok = ok && isfinite(x) && isfinite(y);
        kf[w * 32 + lane] = split2(x, y);
      }
    }
    if (full) {
      const float* sk = skr + 2 * t * sk_ld + g;
      for (int w = wid; w < CH / 8 * nd8; w += kWarps) {
        const int jg = w / nd8, n = w - jg * nd8;
        const float* r = sk + jg * 8 * sk_ld + n * 8;
        kn[w * 32 + lane] = split2(r[0], r[sk_ld]);
      }
      const float* sv = svr + g * sv_ld + t;
      for (int w = wid; w < CH / 8 * nv8; w += kWarps) {
        const int jg = w / nv8, k8 = w - jg * nv8;
        const float* r = sv + jg * 8 * sv_ld + k8 * 8;
        vk[w * 32 + lane] = split2(r[0], r[4]);
      }
    } else {
      for (int w = tid; w < CH * dv4; w += kThreads) {
        const int j = w / dv4, e = w - j * dv4;
        ok = ok && finite_vec(*reinterpret_cast<const float4*>(svr + j * sv_ld + e * 4));
      }
    }
    return ok;
  };

  if (mine > 0) issue(0);  // its rows come while q and g are laid out

  // qs and g, checked, split and stored in the A fragments' order, as the
  // forward lays out qs: tile (row group, k-step k8), lane (g, t) holds hi
  // of a0..a3 then lo, a0 = x[16 rg + g][8 k8 + t], a1 row + 8, a2 column
  // + 4, a3 both
  int bad = 0;
  auto lay_out = [&](const float* src, long long ld, int n8, float s, float* dst) {
    for (int tile = wid; tile < kGroups * n8; tile += kWarps) {
      const int gr = tile / n8, k8 = tile - gr * n8;
      const long long r = row0 + gr * 16 + g;
      const float* xr = src + r * ld + k8 * 8 + t;
      const float a[4] = {r < n_rows ? xr[0] : 0.0f, r + 8 < n_rows ? xr[8 * ld] : 0.0f, r < n_rows ? xr[4] : 0.0f,
                          r + 8 < n_rows ? xr[8 * ld + 4] : 0.0f};
      uint32_t h[4], l[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = a[c] * s;
        bad |= !isfinite(x);
        split(x, h[c], l[c]);
      }
      float4* w = reinterpret_cast<float4*>(dst + (static_cast<long long>(tile) * 32 + lane) * 8);
      w[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
      w[1] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
  };
  lay_out(q, ldq, nd8, scale, qf);
  lay_out(gq, ldg, nv8, 1.0f, gf);
  // δ_r = g_r · out_r: a warp a row, lanes over dv in order, then an xor butterfly
  for (int r = wid; r < BQ; r += kWarps) {
    const long long row = row0 + r;
    float acc = 0.0f;
    if (row < n_rows) {
      for (int c = lane; c < dv; c += 32) {
        const float x = gq[row * ldg + c], y = o[row * ldo + c];
        bad |= !(isfinite(x) && isfinite(y));
        acc = fmaf(x, y, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) row_delta[r] = acc;
  }

  const int kt0 = ks * kNT;  // this warp's first key tile of a stage
  const float* qw = qf + static_cast<long long>(rg) * nd8 * 32 * 8 + lane * 8;
  const float* gw = gf + static_cast<long long>(rg) * nv8 * 32 * 8 + lane * 8;
  // S = qs · Kᵀ over this warp's keys of the split stage
  auto scores = [&](float (&s)[kNT][4]) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll 2
    for (int k8 = 0; k8 < nd8; ++k8) {
      const float4 h4 = *reinterpret_cast<const float4*>(qw + k8 * 32 * 8);
      const float4 l4 = *reinterpret_cast<const float4*>(qw + k8 * 32 * 8 + 4);
      const uint32_t ah[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y), __float_as_uint(h4.z), __float_as_uint(h4.w)};
      const uint32_t al[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y), __float_as_uint(l4.z), __float_as_uint(l4.w)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma3(s[nt], ah, al, kf[((kt0 + nt) * nd8 + k8) * 32 + lane]);
    }
  };
  // this warp's counts of stage i, taken before a barrier (after it, issue(i + 2) may refill the stage)
  auto counts = [&](long long i, unsigned (&cn)[kNT][4]) {
    const unsigned char* sc = stage(i) + plan.kbytes + plan.vbytes;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cn[nt][e] = sc[((kt0 + nt) * 8 + 2 * t + (e & 1)) * BQ + rg * 16 + g + (e >> 1) * 8];
    }
  };

  // pass 1: the rows' maxima and count-weighted sums, as the forward keeps them
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};  // rows g and g + 8 of the group
  for (long long i = 0; i < mine; ++i) {
    if (i + 1 < mine) {
      issue(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // stage i landed; the fragments are free
    bad |= !split_stage(i, false);
    unsigned cn[kNT][4];
    counts(i, cn);
    if (__syncthreads_or(bad)) {
      bad = 1;
      break;
    }
    float s[kNT][4];
    scores(s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (cn[nt][e] != 0) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      const float alpha = m_run[h] == -INFINITY ? 0.0f : expf(m_run[h] - m_new);
      m_run[h] = m_new;
      mu[h] = m_new == -INFINITY ? 0.0f : m_new;  // an empty row so far: the shift counts as 0
      l_run[h] *= alpha;
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (cn[nt][e] != 0) l_run[e >> 1] += static_cast<float>(cn[nt][e]) * expf(s[nt][e] - mu[e >> 1]);
      }
    }
  }
  cp_wait<0>();
  bad = __syncthreads_or(bad);  // the stages are free
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's sum over the quad's columns
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 2);
  }
  // every warp's (m, l) and every CTA's flag, into slot `rank` of every CTA of the cluster
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (static_cast<int>(rank) * kWarps + wid) * 16 + g + 8 * h;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk) {
        if (CL == 1 || rk == static_cast<int>(rank)) {
          part_m[at] = m_run[h];
          part_l[at] = l_run[h];
        } else {
          st_cluster(map_rank(part_m + at, rk), m_run[h]);
          st_cluster(map_rank(part_l + at, rk), l_run[h]);
        }
      }
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int rk = 0; rk < CL; ++rk) {
      if (CL == 1 || rk == static_cast<int>(rank)) bad_word[rank] = bad;
      else st_cluster(map_rank(bad_word + rank, rk), bad);
    }
  }
  if constexpr (CL > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  int any_bad = 0;
#pragma unroll
  for (int rk = 0; rk < CL; ++rk) any_bad |= bad_word[rk];
  if (any_bad) {  // the row kernel takes the block; nothing was written
    if (rank == 0 && tid == 0) {
      route[b] = 2;
      atomicAdd(route_blocks + 2, 1ull);
    }
    return;
  }
  if (mine > 0 && !ATTENTION_BWD_PASS1_ONLY) issue(0);  // pass 2's first stage comes while (m, l) are merged
  // the rows' shifts and sums, merged in one order (rank, then key slice): every CTA the same bits
  if (tid < BQ) {
    const int gr = tid >> 4, rr = tid & 15;
    float m_all = -INFINITY, sum = 0.0f;
#pragma unroll
    for (int rk = 0; rk < CL; ++rk) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) m_all = fmaxf(m_all, part_m[(rk * kWarps + kk * kGroups + gr) * 16 + rr]);
    }
#pragma unroll
    for (int rk = 0; rk < CL; ++rk) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = (rk * kWarps + kk * kGroups + gr) * 16 + rr;
        const float f = part_m[at] == -INFINITY ? 0.0f : expf(part_m[at] - m_all);
        sum += f * part_l[at];
      }
    }
    row_shift[tid] = m_all == -INFINITY ? 0.0f : m_all;
    row_sum[tid] = sum == 0.0f ? 1.0f : sum;
  }
  if (ATTENTION_BWD_PASS1_ONLY) {  // chip_attention_ablation.py's build: pass 1 timed alone
    if (rank == 0 && tid == 0) {
      route[b] = 0;
      atomicAdd(route_blocks, 1ull);
    }
    if constexpr (CL > 1) cluster_sync();
    return;
  }
  __syncthreads();
  float mu[2], lsum[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rg * 16 + g + 8 * h;
    mu[h] = row_shift[r];
    lsum[h] = row_sum[r];
    delta[h] = row_delta[r];
  }

  // the strips of the stage: each slot of the block's rows whose union
  // place lies in the stage gets the tile's p̂ and dŝ; with `zero`, each
  // slot with none gets 0 and 0
  const int capi = static_cast<int>(cap);
  const long long base = row0 * cap;
  auto strips = [&](bool zero) {
    // the stage's counted slots, one run of the layout's order: group t's
    // (places 8t .. 8t + 7 of the stage) from stage_runs[t] on, a row's side
    // by side; an entry is 8 · (its slot in the block) + its place % 8
    constexpr int kU = 4;  // entries a thread loads before it writes
    const int* ob = order + base;
    const int hi = stage_runs[kStageGroups];
    for (int i0 = stage_runs[0] + tid; i0 < hi; i0 += kU * kThreads) {
      int e[kU];
#pragma unroll
      for (int uu = 0; uu < kU; ++uu) e[uu] = i0 + uu * kThreads < hi ? ob[i0 + uu * kThreads] : 0;
#pragma unroll
      for (int uu = 0; uu < kU; ++uu) {
        const int i = i0 + uu * kThreads;
        if (i >= hi) break;
        int a = 0;  // its group: the last whose run begins at or before i
#pragma unroll
        for (int t = 1; t < kStageGroups; ++t) a += stage_runs[t] <= i;
        const int f = e[uu] / kPlaceGroup;
        const int at = (f / capi) * kTL + a * kPlaceGroup + e[uu] % kPlaceGroup;
        p[base + f] = tp[at];
        ds[base + f] = td[at];
      }
    }
    if (zero) {  // the slots the layout does not count: 0 and 0
      const int* bb = begin + b * (n_groups + 2);
      for (int i = bb[n_groups] + tid; i < bb[n_groups + 1]; i += kThreads) {
        p[base + ob[i] / kPlaceGroup] = 0.0f;
        ds[base + ob[i] / kPlaceGroup] = 0.0f;
      }
    }
  };

  // pass 2: p̂, dP, dŝ and dQ a stage, the strips of each stage
  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (long long i = 0; i < mine; ++i) {
    if (i + 1 < mine) {
      issue(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // stage i landed; the fragments and the strip tile are free
    split_stage(i, true);
    const long long c0 = (rank + i * CL) * CH;
    if (tid <= kStageGroups) {
      const long long group = c0 / kPlaceGroup + tid;
      stage_runs[tid] = begin[b * (n_groups + 2) + (group < n_groups ? group : n_groups)];
    }
    unsigned cn[kNT][4];
    counts(i, cn);
    __syncthreads();  // the fragments in place
    float s[kNT][4], dp[kNT][4];
    scores(s);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.0f;
#pragma unroll 2
    for (int k8 = 0; k8 < nv8; ++k8) {  // dP = g · Vᵀ
      const float4 h4 = *reinterpret_cast<const float4*>(gw + k8 * 32 * 8);
      const float4 l4 = *reinterpret_cast<const float4*>(gw + k8 * 32 * 8 + 4);
      const uint32_t ah[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y), __float_as_uint(h4.z), __float_as_uint(h4.w)};
      const uint32_t al[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y), __float_as_uint(l4.z), __float_as_uint(l4.w)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma3(dp[nt], ah, al, vk[((kt0 + nt) * nv8 + k8) * 32 + lane]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float pv[4], sv[4], a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        pv[e] = cn[nt][e] != 0 ? expf(s[nt][e] - mu[h]) / lsum[h] : 0.0f;
        sv[e] = pv[e] * (dp[nt][e] - delta[h]);
        a[e] = static_cast<float>(cn[nt][e]) * sv[e];
      }
      const int col = (kt0 + nt) * 8 + 2 * t, r_lo = rg * 16 + g;
      *reinterpret_cast<float2*>(tp + r_lo * kTL + col) = make_float2(pv[0], pv[1]);
      *reinterpret_cast<float2*>(tp + (r_lo + 8) * kTL + col) = make_float2(pv[2], pv[3]);
      *reinterpret_cast<float2*>(td + r_lo * kTL + col) = make_float2(sv[0], sv[1]);
      *reinterpret_cast<float2*>(td + (r_lo + 8) * kTL + col) = make_float2(sv[2], sv[3]);
      // dQ += (c ⊙ dŝ) · K: A's k index t is key 2t, t + 4 key 2t + 1, as K's fragments for dQ are laid out
      uint32_t ah[4], al[4];
      split(a[0], ah[0], al[0]);
      split(a[2], ah[1], al[1]);
      split(a[1], ah[2], al[2]);
      split(a[3], ah[3], al[3]);
      const float4* kw = kn + (kt0 + nt) * nd8 * 32 + lane;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        if (n < nd8) mma3(acc[n], ah, al, kw[n * 32]);
      }
    }
    __syncthreads();  // the strip tile in place
    strips(rank == 0 && i == 0);
  }

  // dq = scale * dQ: the key slices' and CTAs' partials summed in one order on the first CTA
  const long long r_lo = row0 + rg * 16 + g;  // the thread's rows r_lo and r_lo + 8
  if constexpr (KS * CL == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r_lo + 8 * h >= n_rows) continue;
      float* drow = dq + (r_lo + 8 * h) * d + 2 * t;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        if (n < nd8) *reinterpret_cast<float2*>(drow + n * 8) = make_float2(scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
      }
    }
  } else {
    float* part = reinterpret_cast<float*>(smem);  // [rank][warp][16 rows][d], over the fragments and stages
    if constexpr (CL > 1) {
      cluster_sync();  // every CTA is done with its stages and strips
    } else {
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* prow = part + ((static_cast<long long>(rank) * kWarps + wid) * 16 + g + 8 * h) * d + 2 * t;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        if (n < nd8) put<CL>(prow + n * 8, rank, acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
    if constexpr (CL > 1) {
      cluster_sync();  // every partial in place
    } else {
      __syncthreads();
    }
    if (rank == 0) {
      constexpr int kPerRow = kThreads / BQ;
      const int r = tid / kPerRow;
      if (row0 + r < n_rows) {
        const int gr = r >> 4, rr = r & 15;
        for (int c = tid - r * kPerRow; c < d; c += kPerRow) {
          float sum = 0.0f;
#pragma unroll
          for (int rk = 0; rk < CL; ++rk) {
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) sum += part[((static_cast<long long>(rk) * kWarps + kk * kGroups + gr) * 16 + rr) * d + c];
          }
          dq[(row0 + r) * d + c] = scale * sum;
        }
      }
    }
  }
  if (rank == 0 && tid == 0) {
    route[b] = 0;
    atomicAdd(route_blocks, 1ull);
  }
}

template <int BQ, int KS, int CL, int DT, int CH>
int launch_bwd_tiles(const float* q, long long ldq, const float* k, long long ldk, const float* v, long long ldv,
                     const float* g, long long ldg, const float* o, long long ldo, const int* keys,
                     const int* n_union, const unsigned char* count, const unsigned char* flag, const int* order,
                     const int* begin, long long n_rows, long long n_blocks, long long u_cap, long long cap, int d, int dv, float scale, float* dq, float* ds, float* p,
                     int* route, unsigned long long* route_blocks, cudaStream_t st) {
  auto kernel = ell_attention_backward_tiles_kernel<BQ, KS, CL, DT, CH>;
  if (d > DT) return static_cast<int>(cudaErrorInvalidValue);
  const BwdSmem plan = bwd_smem_plan(BQ, KS, CL, CH, d, dv);
  if (plan.total > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_blocks * CL));
  cfg.blockDim = dim3(BQ / 16 * KS * 32);
  cfg.dynamicSmemBytes = static_cast<size_t>(plan.total);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, q, ldq, k, ldk, v, ldv, g, ldg, o, ldo, keys, n_union, count, flag, order, begin,
                           n_rows, u_cap, cap, d, dv, scale, dq, ds, p, route, route_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tiles

// the tile route's shapes, by `config` (kernels/_cuda.py: ATTENTION_TILE_CONFIGS):
// rows a block, key slices (warps a row group), CTAs a block (a cluster), keys a stage
template <int DVT>
int launch_tiles_config(long long config, const float* q, long long ldq, const float* k, long long ldk,
                        const float* v, long long ldv, const int* keys, const int* n_union,
                        const unsigned char* count, const unsigned char* flag, long long n_rows, long long n_blocks,
                        long long u_cap, int d, int dv, float scale, int* route, unsigned long long* route_blocks,
                        float* out, cudaStream_t st) {
#define ST_TILES(BQ, KS, CL, CH)                                                                                    \
  tiles::launch_tiles<BQ, KS, CL, DVT, CH>(q, ldq, k, ldk, v, ldv, keys, n_union, count, flag, n_rows, n_blocks, \
                                            u_cap, d, dv, scale, route, route_blocks, out, st)
  switch (config) {
    case 0: return ST_TILES(64, 2, 1, 32);
    case 1: return ST_TILES(64, 2, 2, 32);
    case 2: return ST_TILES(64, 4, 2, 64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ST_TILES
}

int launch_tiles_f32(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,
                     const void* keys, const void* n_union, const void* count, const void* flag, long long n_rows,
                     long long n_blocks, long long u_cap, long long d, long long dv, double scale, long long config,
                     void* route, void* route_blocks, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  if (d < 8 || d % 8 != 0 || dv < 8 || dv % 8 != 0 || dv > 128 || d > 1024 || u_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* kk = static_cast<const int*>(keys);
  const auto* nu = static_cast<const int*>(n_union);
  const auto* cn = static_cast<const unsigned char*>(count);
  const auto* fl = static_cast<const unsigned char*>(flag);
  auto* rt = static_cast<int*>(route);
  auto* rb = static_cast<unsigned long long*>(route_blocks);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<float>(scale);
  if (dv <= 64) {
    return launch_tiles_config<64>(config, qp, ldq, kp, ldk, vp, ldv, kk, nu, cn, fl, n_rows, n_blocks, u_cap,
                                   static_cast<int>(d), static_cast<int>(dv), s, rt, rb, op, st);
  }
  return launch_tiles_config<128>(config, qp, ldq, kp, ldk, vp, ldv, kk, nu, cn, fl, n_rows, n_blocks, u_cap,
                                  static_cast<int>(d), static_cast<int>(dv), s, rt, rb, op, st);
}

// K6's backward tile route's shapes, by `config` (kernels/_cuda.py:
// ATTENTION_BWD_TILE_CONFIGS): rows a block, key slices (warps a row group),
// CTAs a block (a cluster), keys a stage
template <int DT>
int launch_bwd_tiles_config(long long config, const float* q, long long ldq, const float* k, long long ldk,
                            const float* v, long long ldv, const float* g, long long ldg, const float* o, long long ldo,
                            const int* keys, const int* n_union, const unsigned char* count, const unsigned char* flag,
                            const int* order, const int* begin, long long n_rows, long long n_blocks, long long u_cap,
                            long long cap, int d, int dv, float scale, float* dq, float* ds, float* p, int* route,
                            unsigned long long* route_blocks, cudaStream_t st) {
#define ST_BWD_TILES(BQ, KS, CL, CH)                                                                               \
  tiles::launch_bwd_tiles<BQ, KS, CL, DT, CH>(q, ldq, k, ldk, v, ldv, g, ldg, o, ldo, keys, n_union, count, flag, \
                                               order, begin, n_rows, n_blocks, u_cap, cap, d, dv, scale, dq, ds, p, \
                                               route, route_blocks, st)
  switch (config) {
    case 0: return ST_BWD_TILES(64, 4, 1, 32);
    case 1: return ST_BWD_TILES(64, 2, 2, 32);
    case 2: return ST_BWD_TILES(64, 2, 2, 16);
    case 3: return ST_BWD_TILES(64, 4, 2, 32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ST_BWD_TILES
}

// the strips by the layout's strip order, `order` and `begin` (int32)
int launch_bwd_tiles_f32(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,
                         const void* g, long long ldg, const void* o, long long ldo, const void* keys,
                         const void* n_union, const void* count, const void* flag, const void* order,
                         const void* begin, long long n_rows, long long n_blocks, long long u_cap, long long cap,
                         long long d, long long dv, double scale, long long config, void* dq, void* ds, void* p,
                         void* route, void* route_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  if (d < 8 || d % 8 != 0 || d > 128 || dv < 8 || dv % 8 != 0 || dv > 128 || u_cap < 1 || cap < 1 ||
      cap > (1LL << 31) / (64 * tiles::kPlaceGroup) || order == nullptr || begin == nullptr) {  // order's entries: 32 bits
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* gp = static_cast<const float*>(g);
  const auto* op = static_cast<const float*>(o);
  const auto* kk = static_cast<const int*>(keys);
  const auto* nu = static_cast<const int*>(n_union);
  const auto* cn = static_cast<const unsigned char*>(count);
  const auto* fl = static_cast<const unsigned char*>(flag);
  const auto* od = static_cast<const int*>(order);
  const auto* bg = static_cast<const int*>(begin);
  auto* dqp = static_cast<float*>(dq);
  auto* dsp = static_cast<float*>(ds);
  auto* pp = static_cast<float*>(p);
  auto* rt = static_cast<int*>(route);
  auto* rb = static_cast<unsigned long long*>(route_blocks);
  const auto s = static_cast<float>(scale);
  const int di = static_cast<int>(d), dvi = static_cast<int>(dv);
  if (d <= 64) {
    return launch_bwd_tiles_config<64>(config, qp, ldq, kp, ldk, vp, ldv, gp, ldg, op, ldo, kk, nu, cn, fl, od, bg,
                                       n_rows, n_blocks, u_cap, cap, di, dvi, s, dqp, dsp, pp, rt, rb, st);
  }
  return launch_bwd_tiles_config<128>(config, qp, ldq, kp, ldk, vp, ldv, gp, ldg, op, ldo, kk, nu, cn, fl, od, bg,
                                      n_rows, n_blocks, u_cap, cap, di, dvi, s, dqp, dsp, pp, rt, rb, st);
}

}  // namespace

extern "C" {

#define ST_ELL_ATTENTION(NAME, T, I)                                                                              \
  int NAME(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,             \
           const void* cols, const void* valid, long long n_rows, long long n_keys, long long cap, long long d,  \
           long long dv, double scale, long long vec, long long max_blocks, const void* block_route,             \
           long long block_rows, void* scratch, void* out, void* stream) {                                       \
    return launch<T, I>(q, ldq, k, ldk, v, ldv, cols, valid, n_rows, n_keys, cap, d, dv, scale, vec, max_blocks, \
                        block_route, block_rows, scratch, out, stream);                                          \
  }

ST_ELL_ATTENTION(st_ell_attention_f32_i32, float, int32_t)
ST_ELL_ATTENTION(st_ell_attention_f32_i64, float, int64_t)
ST_ELL_ATTENTION(st_ell_attention_f64_i32, double, int32_t)
ST_ELL_ATTENTION(st_ell_attention_f64_i64, double, int64_t)

#define ST_ELL_ATTENTION_BACKWARD(NAME, T, I)                                                                      \
  int NAME(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv, const void* g, \
           long long ldg, const void* cols, const void* valid, long long n_rows, long long n_keys, long long cap,   \
           long long d, long long dv, double scale, long long vec, long long max_blocks, const void* block_route,  \
           long long block_rows, void* dq, void* ds, void* p, void* stream) {                                      \
    return launch_backward<T, I>(q, ldq, k, ldk, v, ldv, g, ldg, cols, valid, n_rows, n_keys, cap, d, dv, scale,  \
                                 vec, max_blocks, block_route, block_rows, dq, ds, p, stream);                     \
  }

ST_ELL_ATTENTION_BACKWARD(st_ell_attention_backward_f32_i32, float, int32_t)
ST_ELL_ATTENTION_BACKWARD(st_ell_attention_backward_f32_i64, float, int64_t)
ST_ELL_ATTENTION_BACKWARD(st_ell_attention_backward_f64_i32, double, int32_t)
ST_ELL_ATTENTION_BACKWARD(st_ell_attention_backward_f64_i64, double, int64_t)

int st_ell_attention_tiles_f32(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,
                               const void* keys, const void* n_union, const void* count, const void* flag,
                               long long n_rows, long long n_blocks, long long u_cap, long long d, long long dv,
                               double scale, long long config, void* route, void* route_blocks, void* out,
                               void* stream) {
  return launch_tiles_f32(q, ldq, k, ldk, v, ldv, keys, n_union, count, flag, n_rows, n_blocks, u_cap, d, dv, scale,
                          config, route, route_blocks, out, stream);
}

int st_ell_attention_backward_tiles_f32(const void* q, long long ldq, const void* k, long long ldk, const void* v,
                                        long long ldv, const void* g, long long ldg, const void* o, long long ldo,
                                        const void* keys, const void* n_union, const void* count, const void* flag,
                                        const void* order, const void* begin, long long n_rows, long long n_blocks,
                                        long long u_cap, long long cap, long long d, long long dv, double scale,
                                        long long config, void* dq, void* ds, void* p, void* route, void* route_blocks,
                                        void* stream) {
  return launch_bwd_tiles_f32(q, ldq, k, ldk, v, ldv, g, ldg, o, ldo, keys, n_union, count, flag, order, begin, n_rows,
                              n_blocks, u_cap, cap, d, dv, scale, config, dq, ds, p, route, route_blocks, stream);
}

}  // extern "C"
