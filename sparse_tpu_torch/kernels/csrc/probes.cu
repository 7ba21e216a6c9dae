// The one-hot SpMV prototype and the VMEM gather probes for Hopper (sm_90a),
// plain C interface for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Four kernels serve the eight Pallas functions they replace:
// 1. spmv_products_kernel<HILO>      experiments/pallas_spmv_onehot.py:products_kernel (E1)
// 2. lane_gather_kernel<BLOCKSUM>    experiments/pallas_vmem.py:p1 (E3), pallas_vmem2.py:g1 (E7)
// 3. row_gather_kernel<ROUND, WEIGHTED>
//                                    pallas_vmem.py:p2 (E4), p3 (E5), pallas_vmem2.py:g2 (E8), g3 (E9)
// 4. scalar_gather_sum_kernel        pallas_vmem.py:p4 (E6)
//
// On the TPU each function keeps its table resident in VMEM (the 512 x 128
// f32 table and E1's 512 x 256 bf16 hi|lo table are 256 KB, the 8192 x 128
// strip 4 MB) and picks from it with a one-hot MXU product, Mosaic's sublane
// gather or scalar loads. A block of this card has at most 227 KB of shared
// memory, so these kernels read the table from global memory, where it stays
// in the 50 MB L2 between picks: what they measure is the card's L2 gather
// rate. A one-hot pick is exact (one 1 in the row, the rest adds zeros), so
// every pick here is a direct load, and E1 and p3 give the TPU function's
// values bit for bit.
//
// Bound on this card: bytes. Each function reads its indices (and values)
// once and writes its output once; the table's bytes come from L2 many times
// over (p2, g2 and g3 read 512-byte rows: 67 MB, 1.2 GB and 74 MB a call).
// That L2 traffic is the rate these probes exist to measure.
//
// No sum uses atomics. A long segment is cut over the warps of one CTA (row
// gather) or over CTAs whose partial sums the last CTA of the block adds in
// order (lane gather block sum), so every result is deterministic.
//
// Every table is (rows, 128) f32, the TPU's lane width, except E1's bf16
// table. The launchers in _cuda.py check shapes, dtypes, contiguity and the
// 16-byte alignment of the float4/int4 operands; the callers guarantee every
// index in range (E1 alone defines an index outside its table: it picks 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;     // the width of every probe table
constexpr int kSplitRows = 64;  // rows of a block summed by one CTA of lane_gather_kernel<true>
constexpr long long kMaxGrid = 132LL * 32;  // grid-stride kernels: 32 CTAs per SM

long long grid_for(long long n) {
  const long long g = (n + kThreads - 1) / kThreads;
  return g < kMaxGrid ? g : kMaxGrid;
}

// E1: out[e] = (f32(x2[q, m]) + f32(x2[q, 128 + m])) * data[e] with the hi|lo
// table (512, 256), or f32(x2[q, m]) * data[e] with the bf16 table (512, 128),
// where q, m = divmod(cols[e], 128). The Pallas kernel picks row q with a
// one-hot MXU product, folds hi + lo in f32, selects lane m with a mask and
// multiplies; each step is exact but the fold and the product, which round
// here in the same order (__fadd_rn, __fmul_rn: no contraction). A q outside
// the table matches no one-hot row and picks 0. One thread per entry:
// coalesced cols/data/out, one 2- or 4-byte gather from the L2-resident table.
template <bool HILO>
__global__ void __launch_bounds__(kThreads)
    spmv_products_kernel(const __nv_bfloat16* __restrict__ x2, long long n_tab_rows, const int* __restrict__ cols,
                         const float* __restrict__ data, long long n, float* __restrict__ out) {
  constexpr int width = HILO ? 2 * kLanes : kLanes;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += (long long)gridDim.x * kThreads) {
    const int c = cols[e];
    const int q = c >> 7;  // floor(c / 128), as c // 128
    const int m = c & (kLanes - 1);
    float v = 0.0f;
    if (q >= 0 && q < n_tab_rows) {
      const __nv_bfloat16* row = x2 + (long long)q * width;
      v = __bfloat162float(row[m]);
      if (HILO) v = __fadd_rn(v, __bfloat162float(row[kLanes + m]));
    }
    out[e] = __fmul_rn(v, data[e]);
  }
}

// p1 (BLOCKSUM = false): out[i, l] = table[idx[i, l], l], the sublane gather
// of take_along_axis. Each thread reads four lanes' indices as one int4,
// gathers four values from four rows and stores one float4.
//
// g1 (BLOCKSUM = true): out[8b + c, l] = sum over t < T of
// table[idx[b T + t, l], l] for c < 8 (the block's column sum stored in 8
// identical rows, as the Pallas kernel's (8, 128) output tile). CTA (s, b)
// sums rows [64 s, 64 s + 64) of block b, lane l on threads l and 128 + l
// (even and odd rows), writes its partial row to `partial` (n_blocks,
// n_splits, 128), and the CTA that takes the block's last ticket adds the
// partials in split order and stores the 8 rows. That CTA sets the ticket
// back to 0, so one zeroed `tickets` buffer serves every launch on a stream.
template <bool BLOCKSUM>
__global__ void __launch_bounds__(kThreads)
    lane_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx, long long n_rows,
                       long long rows_per_block, float* __restrict__ out, float* __restrict__ partial,
                       int* __restrict__ tickets) {
  if (!BLOCKSUM) {
    const long long n4 = n_rows * (kLanes / 4);
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += (long long)gridDim.x * kThreads) {
      const int4 r = reinterpret_cast<const int4*>(idx)[i];
      const int l = (int)(i & (kLanes / 4 - 1)) * 4;
      float4 v;
      v.x = table[(long long)r.x * kLanes + l];
      v.y = table[(long long)r.y * kLanes + l + 1];
      v.z = table[(long long)r.z * kLanes + l + 2];
      v.w = table[(long long)r.w * kLanes + l + 3];
      reinterpret_cast<float4*>(out)[i] = v;
    }
    return;
  }
  __shared__ float odd[kLanes];
  __shared__ bool last;
  const int lane = threadIdx.x & (kLanes - 1);
  const int phase = threadIdx.x / kLanes;  // 0: even rows, 1: odd rows
  const long long b = blockIdx.y;
  const int s = blockIdx.x;
  const int n_splits = gridDim.x;
  const long long r0 = (long long)s * kSplitRows;
  const long long r1 = r0 + kSplitRows < rows_per_block ? r0 + kSplitRows : rows_per_block;
  const int* ib = idx + b * rows_per_block * kLanes + lane;
  float acc = 0.0f;
#pragma unroll 8
  for (long long t = r0 + phase; t < r1; t += 2) acc += table[(long long)ib[t * kLanes] * kLanes + lane];
  if (phase == 1) odd[lane] = acc;
  __syncthreads();
  if (phase == 0) {
    partial[(b * n_splits + s) * kLanes + lane] = acc + odd[lane];
    __threadfence();  // the partial is visible to the block's last CTA before this CTA's ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[b], 1) == n_splits - 1;
  __syncthreads();
  if (!last || phase != 0) return;
  float sum = 0.0f;
  for (int k = 0; k < n_splits; ++k) sum += __ldcg(&partial[(b * n_splits + k) * kLanes + lane]);
  float* o = out + b * 8 * kLanes + lane;
#pragma unroll
  for (int c = 0; c < 8; ++c) o[c * kLanes] = sum;
  if (lane == 0) tickets[b] = 0;
}

// Segment s of the row gather: its group g = s / seg_per_group and place
// r = s % seg_per_group; its elements j = g * group_stride + r * r_stride +
// (k / n_w) * g_stride + k % n_w for k < n_g * n_w. The sum of its picked
// rows is stored, in `copies` identical rows, at output row
// (g * keep + r) * copies when r < keep.
//   p2: segments of per_step consecutive indices         (seg_per_group 1, n_g per_step, keep 1, copies 1)
//   p3: one index per segment, the table rounded to bf16 (n_g 1)
//   g2: segments of T consecutive indices, 8 copies      (n_g T, copies 8)
//   g3: cell i, place r < 8: the picks t = 128 g' + r, w < W of the cell's
//       (T, W) weighted layout, which acc.reshape(64, 128, 128).sum(0)[:8]
//       adds into kept row r                    (seg_per_group 8, n_g 64, n_w W, keep 8)
//       Only the 8 kept places of each cell are computed: the Pallas kernel
//       computed its whole (T, 128) accumulator because that was its tile,
//       but the other 120 places of the fold feed no output.
struct Segments {
  long long n_seg, seg_per_group, group_stride, r_stride, n_g, g_stride, n_w, keep, copies;
};

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)), __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)), __bfloat162float(__float2bfloat16_rn(v.w)));
}

// A warp picks whole 512-byte rows: lane l holds columns 4l..4l+3 as one
// float4, so each pick is one coalesced row read from L2. `wps` warps share a
// segment (8 for segments of 1024 elements or more and for every weighted
// segment, else 1: g3 keeps 8 rows a cell, 568 segments of 256 picks at its
// defaults, which one warp each would spread over 71 CTAs); each walks every
// wps-th element, 32 at a time: every lane loads one element's index (and
// weight), then the warp broadcasts them with shuffles, so up to 32 row reads
// are in flight without a dependent index load before each. The wps partial
// rows are added in warp order through shared memory.
template <bool ROUND, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx, const float* __restrict__ weights,
                      Segments sg, int wps, float* __restrict__ out) {
  __shared__ float4 part[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long seg = (long long)blockIdx.x * (kWarps / wps) + warp / wps;
  const int sub = warp % wps;
  const bool live = seg < sg.n_seg;
  const long long group = seg / sg.seg_per_group;
  const long long r = seg - group * sg.seg_per_group;
  const long long base = group * sg.group_stride + r * sg.r_stride;
  const long long n_elem = sg.n_g * sg.n_w;
  const float4* tab = reinterpret_cast<const float4*>(table);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    for (long long k0 = sub; k0 < n_elem; k0 += 32LL * wps) {
      const long long k = k0 + (long long)lane * wps;
      int row = 0;
      float wt = 0.0f;
      if (k < n_elem) {
        const long long j = base + (k / sg.n_w) * sg.g_stride + k % sg.n_w;
        row = idx[j];
        if (WEIGHTED) wt = weights[j];
      }
      const long long left = (n_elem - k0 + wps - 1) / wps;
      const int n = left < 32 ? (int)left : 32;
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const long long rt = __shfl_sync(0xffffffffu, row, t);
        float4 v = __ldg(&tab[rt * (kLanes / 4) + lane]);
        if (ROUND) v = round_bf16(v);
        if (WEIGHTED) {
          const float st = __shfl_sync(0xffffffffu, wt, t);
          acc.x = fmaf(st, v.x, acc.x);
          acc.y = fmaf(st, v.y, acc.y);
          acc.z = fmaf(st, v.z, acc.z);
          acc.w = fmaf(st, v.w, acc.w);
        } else {
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
    }
  }
  if (wps > 1) {
    part[warp][lane] = acc;
    __syncthreads();
    if (sub != 0) return;
    for (int k = 1; k < wps; ++k) {
      const float4 p = part[warp + k][lane];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
  }
  if (!live || r >= sg.keep) return;
  float4* o = reinterpret_cast<float4*>(out) + (group * sg.keep + r) * sg.copies * (kLanes / 4) + lane;
  for (long long c = 0; c < sg.copies; ++c) o[c * (kLanes / 4)] = acc;
}

// p4: out[s] = sum over w < seg_len of x[qi[s L + w], qj[s L + w]], L =
// seg_len. The Pallas kernel walks each segment with scalar SMEM-indexed
// loads in one sequential loop; here one CTA takes a segment, each thread
// sums every 256th load, and the CTA adds the threads' sums by shuffles and
// then across warps in a fixed order.
__global__ void __launch_bounds__(kThreads)
    scalar_gather_sum_kernel(const float* __restrict__ x, long long n_x_cols, const int* __restrict__ qi,
                             const int* __restrict__ qj, long long seg_len, float* __restrict__ out) {
  __shared__ float warp_sums[kWarps];
  const long long s = blockIdx.x;
  const int* ri = qi + s * seg_len;
  const int* rj = qj + s * seg_len;
  float acc = 0.0f;
#pragma unroll 4
  for (long long w = threadIdx.x; w < seg_len; w += kThreads) acc += x[(long long)ri[w] * n_x_cols + rj[w]];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += warp_sums[k];
    out[s] = sum;
  }
}

template <bool HILO>
int launch_spmv_products(const void* x2, long long n_tab_rows, const void* cols, const void* data, long long n,
                         void* out, void* stream) {
  if (n == 0) return 0;
  spmv_products_kernel<HILO><<<(unsigned)grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x2, n_tab_rows, (const int*)cols, (const float*)data, n, (float*)out);
  return (int)cudaGetLastError();
}

template <bool ROUND, bool WEIGHTED>
int launch_row_gather(const void* table, const void* idx, const void* weights, const Segments& sg, void* out,
                      void* stream) {
  const int wps = (WEIGHTED || sg.n_g * sg.n_w >= 1024) ? kWarps : 1;
  const long long per_cta = kWarps / wps;
  const long long blocks = (sg.n_seg + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<ROUND, WEIGHTED><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (const float*)weights, sg, wps, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int st_spmv_products_hilo(const void* x2, long long n_tab_rows, const void* cols, const void* data, long long n,
                          void* out, void* stream) {
  return launch_spmv_products<true>(x2, n_tab_rows, cols, data, n, out, stream);
}

int st_spmv_products_bf16(const void* x2, long long n_tab_rows, const void* cols, const void* data, long long n,
                          void* out, void* stream) {
  return launch_spmv_products<false>(x2, n_tab_rows, cols, data, n, out, stream);
}

int st_lane_gather(const void* table, const void* idx, long long n_rows, void* out, void* stream) {
  if (n_rows == 0) return 0;
  lane_gather_kernel<false><<<(unsigned)grid_for(n_rows * (kLanes / 4)), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, n_rows, 0, (float*)out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int st_lane_gather_blocksum(const void* table, const void* idx, long long n_blocks, long long rows_per_block,
                            void* out, void* partial, void* tickets, void* stream) {
  if (n_blocks == 0) return 0;
  const long long n_splits = (rows_per_block + kSplitRows - 1) / kSplitRows;
  if (n_splits == 0 || n_splits > 0x7fffffffLL || n_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_splits, (unsigned)n_blocks);
  lane_gather_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, n_blocks * rows_per_block, rows_per_block, (float*)out, (float*)partial,
      (int*)tickets);
  return (int)cudaGetLastError();
}

int st_row_gather(const void* table, const void* idx, const void* weights, long long n_seg, long long seg_per_group,
                  long long group_stride, long long r_stride, long long n_g, long long g_stride, long long n_w,
                  long long keep, long long copies, long long round_bf16, void* out, void* stream) {
  if (n_seg == 0) return 0;
  const Segments sg{n_seg, seg_per_group, group_stride, r_stride, n_g, g_stride, n_w, keep, copies};
  if (weights != nullptr) {
    return round_bf16 ? launch_row_gather<true, true>(table, idx, weights, sg, out, stream)
                      : launch_row_gather<false, true>(table, idx, weights, sg, out, stream);
  }
  return round_bf16 ? launch_row_gather<true, false>(table, idx, weights, sg, out, stream)
                    : launch_row_gather<false, false>(table, idx, weights, sg, out, stream);
}

int st_scalar_gather_sum(const void* x, long long n_x_cols, const void* qi, const void* qj, long long n_seg,
                         long long seg_len, void* out, void* stream) {
  if (n_seg == 0) return 0;
  if (n_seg > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scalar_gather_sum_kernel<<<(unsigned)n_seg, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n_x_cols, (const int*)qi, (const int*)qj, seg_len, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
