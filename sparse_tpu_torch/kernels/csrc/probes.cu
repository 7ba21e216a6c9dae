// The one-hot SpMV prototype and the VMEM gather probes for Hopper (sm_90a),
// plain C interface for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Nine kernels serve the eight Pallas functions they replace:
// 1. spmv_products_smem_kernel<HILO> experiments/pallas_spmv_onehot.py:products_kernel (E1);
//    spmv_products_kernel<HILO>      its route for a table too tall for shared memory
// 2. lane_slice_kernel<BLOCKSUM>     experiments/pallas_vmem.py:p1 (E3), pallas_vmem2.py:g1 (E7)
//    lane_gather_kernel<BLOCKSUM>    their route for a table too tall for shared memory
// 3. row_gather_sum_kernel           pallas_vmem.py:p2 (E4)
// 4. row_gather_kernel<WEIGHTED>     pallas_vmem2.py:g3 (E9); g2's first route
// 5. scalar_gather_sum_kernel        pallas_vmem.py:p4 (E6)
// 6. row_pick_bf16_kernel<RESIDENT>  pallas_vmem.py:p3 (E5)
// 7. row_pick_counts_kernel<ALIGNED> pallas_vmem2.py:g2 (E8)
//
// On the TPU each function keeps its table resident in VMEM (the 512 x 128
// f32 table and E1's 512 x 256 bf16 hi|lo table are 256 KB, the 8192 x 128
// strip 4 MB) and picks from it with a one-hot MXU product, Mosaic's sublane
// gather or scalar loads. A block of this card has at most 227 KB of shared
// memory. The kernels of p2, p4 and g3 read the table from global memory,
// where it stays in the 50 MB L2 between picks: what they measure is the
// card's L2 gather rate. The others hold the table, or the part of it a CTA
// reads, in shared memory: E1's bf16 table whole and its hi|lo table half a
// CTA, p3's strip rounded to bf16 (128 KB) whole, p1's and g1's table in
// 32-lane column slices, g2's in row slices. A one-hot pick is exact (one
// 1 in the row, the rest adds zeros), so every pick here is a direct load,
// and E1 and p3 give the TPU function's values bit for bit.
//
// Bound on this card: bytes. Each function reads its indices (and values)
// once and writes its output once; the table's bytes come from L2 (or
// shared memory) many times over (p2, g2 and g3 read 512-byte rows: 67 MB,
// 1.2 GB and 74 MB a call). That traffic is the rate these probes measure.
//
// No sum uses atomics. A long segment is cut over the warps of one CTA (row
// gathers, g1's slices) or over CTAs or warps whose partial sums the one
// that takes the block's last ticket adds in order (g1's L2 route, g2's
// count form), so every result is deterministic.
//
// Every table is (rows, 128) f32, the TPU's lane width, except E1's bf16
// table. The launchers in _cuda.py check shapes, dtypes, contiguity and the
// 16-byte alignment of the vector and bulk-copy operands; the callers
// guarantee every index in range (E1 alone defines an index outside its
// table: it picks 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------
// Shared memory, mbarriers and bulk copies (E1, E5).

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread's arrival, expecting `bytes` more of bulk copies before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// global -> this CTA's shared memory, the barrier told of the bytes;
// 16-byte aligned, bytes a multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
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

// E1 with the table in shared memory (a table of at most 904 rows:
// _cuda.spmv_products_resident). The kernel above gathers through L1/L2 and
// stops at the card's scattered-load rate (97 G slots/s on an H100, two
// 2-byte loads a slot with the hi|lo table); HBM would stream cols, data and
// out three times faster. Here a pick is a 2-byte load from shared memory:
// - bf16 table (rows x 256 bytes: 128 KB at 512 rows): every CTA holds all
//   of it, copied in by cp.async.bulk.
// - hi|lo table (rows x 512 bytes, more than a CTA holds): CTAs in pairs,
//   CTA 2p + h holding rows [h H, h H + H), H = ceil(rows / 2), by the same
//   bulk copy. Both CTAs of a pair walk the same chunks of slots (the
//   partner's cols and data come from L2); each computes and writes only
//   the slots whose q is in its half, CTA 0 also the zeros of a q outside
//   the table. No CTA reads another's shared memory.
// A persistent grid (one CTA an SM) walks chunks of kE1Chunk slots (chunk c
// by CTA or pair c mod walkers); each thread loads its kE1Per slots of the
// next chunk while it computes this one's, and its first chunk's while the
// table lands. The arithmetic is the kernel above's, so the bits are too.
// On an H100 (chip_probes_ablation.py e1; PERF.md) 1,024 threads beat 512
// by 12-15 %; 8 slots a thread bought nothing; hi and lo interleaved into
// one word by the threads (one shared load a pick) lost 7 %, the bf16
// table multicast over clusters of 2 lost 29 %.
#ifndef E1_THREADS
#define E1_THREADS 1024
#endif
constexpr int kE1Threads = E1_THREADS;
constexpr int kE1Per = 4;  // slots a thread takes a chunk, kE1Threads apart
constexpr long long kE1Chunk = (long long)kE1Threads * kE1Per;

__device__ __forceinline__ float bf16_bits(uint32_t b) { return __uint_as_float(b << 16); }

template <bool HILO>
__global__ void __launch_bounds__(kE1Threads, 1)
    spmv_products_smem_kernel(const __nv_bfloat16* __restrict__ x2, int n_tab_rows, const int* __restrict__ cols,
                              const float* __restrict__ data, long long n, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  constexpr int kTabRowBytes = HILO ? 4 * kLanes : 2 * kLanes;
  const int half = HILO ? (int)(blockIdx.x & 1) : 0;
  const int held = HILO ? (n_tab_rows + 1) >> 1 : n_tab_rows;
  const int lo = half * held;                                         // this CTA's rows [lo, lo + rows)
  const int rows = n_tab_rows - lo < held ? n_tab_rows - lo : held;  // (0 for the second half of one row)
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_expect_tx(&bar, (uint32_t)rows * kTabRowBytes);
    constexpr int kPieceRows = 16384 / kTabRowBytes;  // 16 KB a copy
    for (int r = 0; r < rows; r += kPieceRows) {
      const int nr = rows - r < kPieceRows ? rows - r : kPieceRows;
      bulk_load(smem + (size_t)r * kTabRowBytes, reinterpret_cast<const unsigned char*>(x2) + ((size_t)lo + r) * kTabRowBytes,
                (uint32_t)nr * kTabRowBytes, &bar);
    }
  }

  const long long walker = HILO ? blockIdx.x >> 1 : blockIdx.x;
  const long long walkers = HILO ? gridDim.x >> 1 : gridDim.x;
  const long long n_chunks = (n + kE1Chunk - 1) / kE1Chunk;
  int c_next[kE1Per];
  float d_next[kE1Per];
  auto fetch = [&](long long ch) {
#pragma unroll
    for (int k = 0; k < kE1Per; ++k) {
      const long long e = ch * kE1Chunk + k * kE1Threads + threadIdx.x;
      const bool live = ch < n_chunks && e < n;
      c_next[k] = live ? __ldg(cols + e) : 0;
      d_next[k] = live ? __ldg(data + e) : 0.0f;
    }
  };
  fetch(walker);
  __syncthreads();  // the barrier is initialised
  mbar_wait(&bar, 0);
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  for (long long ch = walker; ch < n_chunks; ch += walkers) {
    int c[kE1Per];
    float d[kE1Per];
#pragma unroll
    for (int k = 0; k < kE1Per; ++k) {
      c[k] = c_next[k];
      d[k] = d_next[k];
    }
    fetch(ch + walkers);
#pragma unroll
    for (int k = 0; k < kE1Per; ++k) {
      const long long e = ch * kE1Chunk + k * kE1Threads + threadIdx.x;
      const int q = c[k] >> 7;  // floor(c / 128), as c // 128
      const int m = c[k] & (kLanes - 1);
      const int r = q - lo;
      const bool mine = (unsigned)r < (unsigned)rows;
      const bool own = !HILO || mine || (half == 0 && (unsigned)q >= (unsigned)n_tab_rows);
      if (e < n && own) {
        float v = 0.0f;
        if (mine) {
          v = HILO ? __fadd_rn(bf16_bits(tab[r * 2 * kLanes + m]), bf16_bits(tab[r * 2 * kLanes + kLanes + m]))
                   : bf16_bits(tab[r * kLanes + m]);
        }
        out[e] = __fmul_rn(v, d[k]);
      }
    }
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

// p1 and g1 from column slices in shared memory (lane_slice_kernel<false>:
// a table of at most 1,808 rows, _cuda.lane_gather_design;
// lane_slice_kernel<true>: at most 1,792 rows beside the warps' sums,
// _cuda.lane_slice_resident; taller tables take lane_gather_kernel, the L2
// route). The L2 route's picks are 4-byte loads of table[idx * 128 + l]
// through L1/L2, at the card's lane-gather rate (141-150 G/s on an H100),
// while the bound is the idx stream (and p1's output). But lane l only ever
// reads column l, and the lanes [32 s, 32 s + 32) of an output row or a
// block's sums depend on nothing else: a CTA serving lane slice s needs only
// that slice of the table, rows x 128 bytes (64 KB at 512 rows), stored with
// a row stride of 32 words. A warp then reads its 32 lanes of one idx row
// (one 128-byte line) and picks slice[idx * 32 + lane]: lane j from bank j,
// whatever the indices, so no pick waits on a bank conflict.
// - A persistent grid: CTA i serves lane slice i mod 4. It loads its slice
//   once with plain 16-byte loads, while each warp's first idx rows are
//   already in flight.
// - g1 (BLOCKSUM, two CTAs an SM, kBatch idx lines in flight a warp): CTA
//   i takes the blocks i / 4, i / 4 + G / 4, ... (G CTAs). Warp w sums the
//   block's rows [w T / 16, (w + 1) T / 16) in row order; warp 0 adds the
//   16 warps' sums in warp order and stores the 8 rows of its 32 lanes. One
//   fixed order: the same bits every launch, and no partials, tickets or
//   fences between CTAs.
// - p1 (no BLOCKSUM, one CTA an SM, kGatherBatch idx lines in flight a
//   warp): the n idx rows are one block, split evenly over the grid's warps
//   of each slice (warp w of CTA i: part (i / 4) * 16 + w of 16 G / 4). A
//   warp stores each pick at once: one 128-byte output line a row. Every
//   pick is a load, so the output is the L2 route's bit for bit.
// On an H100 (chip_probes_ablation.py g1, p1; PERF.md) g1's partial rows of
// 16-64 rows a warp, added by the block's last warp through tickets, took
// 1.2-2.9x as long (a fence, a ticket and the partials' loads on every
// block's path); the slice copied in by cp.async.bulk, a row a copy, lost
// 5-8 % to plain loads, and clusters of 2 or 4 CTAs sharing it by multicast
// 20-26 %. p1 (34-35 rows a warp) takes 0.0058-0.0059 ms with 24 lines;
// 32 lines 0.0066 (a second round of 2-3 rows costs a whole L2 latency),
// 48 lines 0.0063-0.0065 (one round: no idx read overlaps the stores), two
// or three CTAs an SM 0.0064-0.0070; 12 or 20 lines, or a second idx buffer
// (the next round in flight during this one's stores), gained nothing.
constexpr int kSliceLanes = 32;
constexpr int kLaneSlices = kLanes / kSliceLanes;
constexpr int kSliceThreads = 512;
constexpr int kSliceWarps = kSliceThreads / 32;
constexpr int kBatch = 32;  // idx lines in flight a warp
#ifndef LANE_CTAS_PER_SM
#define LANE_CTAS_PER_SM 2
#endif
#ifndef LANE_GATHER_CTAS_PER_SM
#define LANE_GATHER_CTAS_PER_SM 1
#endif
#ifndef LANE_GATHER_BATCH
#define LANE_GATHER_BATCH 24
#endif
constexpr int kGatherBatch = LANE_GATHER_BATCH;  // p1's idx lines in flight a warp
constexpr long long kGatherMinRows = kSliceWarps * 8;  // idx rows a CTA at least: its slice load costs a few rows' time

template <bool BLOCKSUM>
__global__ void __launch_bounds__(kSliceThreads, BLOCKSUM ? LANE_CTAS_PER_SM : LANE_GATHER_CTAS_PER_SM)
    lane_slice_kernel(const float* __restrict__ table, int n_tab_rows, const int* __restrict__ idx, long long T,
                      long long n_blocks, float* __restrict__ out) {
  constexpr int kB = BLOCKSUM ? kBatch : kGatherBatch;
  extern __shared__ __align__(128) float slice[];  // row t, lane 32 s + j at t * 32 + j; then the warps' sums
  float(*sums)[kSliceLanes] = reinterpret_cast<float(*)[kSliceLanes]>(slice + (size_t)n_tab_rows * kSliceLanes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = (int)(blockIdx.x % kLaneSlices);
  const long long stride = gridDim.x / kLaneSlices;  // the grid is a multiple of 4
  // this warp's rows of a block: one of 16 parts (g1), one of the slice's 16 G / 4 parts of the one block (p1)
  const long long parts = BLOCKSUM ? kSliceWarps : kSliceWarps * stride;
  const long long part = BLOCKSUM ? warp : blockIdx.x / kLaneSlices * kSliceWarps + warp;
  const long long t0 = T * part / parts, t1 = T * (part + 1) / parts;

  int v[kB];
  auto fetch = [&](long long b, long long t) {  // the idx lines of rows [t, t + kB) of block b, up to t1
    const int* ib = idx + (b * T + t) * kLanes + s * kSliceLanes + lane;
#pragma unroll
    for (int i = 0; i < kB; ++i) v[i] = t + i < t1 ? __ldg(ib + (long long)i * kLanes) : 0;
  };
  long long b = BLOCKSUM ? blockIdx.x / kLaneSlices : 0;
  if (b < n_blocks) fetch(b, t0);

  const float4* src = reinterpret_cast<const float4*>(table) + s * (kSliceLanes / 4);
  float4* dst = reinterpret_cast<float4*>(slice);
#pragma unroll 8
  for (int i = threadIdx.x; i < n_tab_rows * (kSliceLanes / 4); i += kSliceThreads)
    dst[i] = __ldg(src + (long long)(i / (kSliceLanes / 4)) * (kLanes / 4) + i % (kSliceLanes / 4));
  __syncthreads();

  for (; b < n_blocks; b += stride) {
    float acc = 0.0f;
    for (long long t = t0; t < t1; t += kB) {
      if (t > t0) fetch(b, t);
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        if (t + i < t1) {
          const float p = slice[v[i] * kSliceLanes + lane];
          if (BLOCKSUM)
            acc += p;
          else
            out[(t + i) * kLanes + s * kSliceLanes + lane] = p;
        }
      }
    }
    if (!BLOCKSUM) return;
    sums[warp][lane] = acc;
    __syncthreads();
    if (b + stride < n_blocks) fetch(b + stride, t0);  // the next block's first rows in flight
    if (warp == 0) {
      float tot = sums[0][lane];
#pragma unroll
      for (int w = 1; w < kSliceWarps; ++w) tot += sums[w][lane];
      float* o = out + b * 8 * kLanes + s * kSliceLanes + lane;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c * kLanes] = tot;
    }
    __syncthreads();  // sums is read before the next block writes it
  }
}

// Segment s of the row gather: its group g = s / seg_per_group and place
// r = s % seg_per_group; its elements j = g * group_stride + r * r_stride +
// (k / n_w) * g_stride + k % n_w for k < n_g * n_w. The sum of its picked
// rows is stored, in `copies` identical rows, at output row
// (g * keep + r) * copies when r < keep.
//   p2: segments of per_step consecutive indices         (seg_per_group 1, n_g per_step, keep 1, copies 1;
//       p2's first port, launched now only by chip_probes_ablation.py p2)
//   g2: segments of T consecutive indices, 8 copies      (n_g T, copies 8; its first
//       route, kept to measure the whole-row L2 rate beside the slices)
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

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
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
template <bool WEIGHTED>
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
        const float4 v = __ldg(&tab[rt * (kLanes / 4) + lane]);
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

// p2 (E4): out[g] = sum over w < L of strip[idx[g L + w], :], with the
// launch plan _cuda.row_gather_sum_plan (warps a segment, segments a CTA).
// Bound: bytes of HBM (the strip, idx and out once: 0.0014 ms at p2's
// size), but every pick reads a 512-byte row from L2: 67.1 MB at p2's size,
// 0.0092 ms at the card's whole-row L2 rate (7.3 TB/s). row_gather_kernel
// gave a segment of 1,024 picks 8 warps, one CTA an SM, each warp a
// dependent index load and then about 8 row reads in flight: 3.49 TB/s,
// bound by the reads in flight an SM, not by L2. Here:
// - A warp for each 32 picks of a segment, at most 32 (one CTA of 1,024
//   threads for a segment of 1,024 picks or more: 4x the warps an SM).
//   Warp w takes the contiguous picks [w c, (w + 1) c), c = ceil(L / wps),
//   32 at a time: one coalesced index line, broadcast by shuffles, then the
//   rows in batches of kRowSumDepth float4 loads in flight a lane.
// - Short segments get fewer warps and share a CTA (at most 8 warps, and
//   only once there are more segments than SMs).
// - The sum order is fixed by (L, plan): picks in order within a warp, then
//   the segment's first warp adds the others' rows in warp order through
//   shared memory. The same bits every launch.
// On an H100 (chip_probes_ablation.py p2; PERF.md) p2 takes 0.0110 ms, 6.1
// TB/s of rows on 128 of the 132 SMs (the first kernel 0.0191); 4 or 6
// reads in flight 0.0115 / 0.0113; 12 or 16 spill at 64 registers, 0.0148 /
// 0.0203; clusters of 2 or 4 CTAs a segment (16 or 8 warps each), rank 0
// adding the ranks' rows through distributed shared memory, 0.0119 /
// 0.0162.
#ifndef ROW_SUM_DEPTH
#define ROW_SUM_DEPTH 8
#endif
constexpr int kRowSumThreads = 1024;
constexpr int kRowSumDepth = ROW_SUM_DEPTH;  // row reads in flight a lane

__global__ void __launch_bounds__(kRowSumThreads)
    row_gather_sum_kernel(const float* __restrict__ table, const int* __restrict__ idx, long long n_seg, long long L,
                          int wps, float* __restrict__ out) {
  __shared__ float4 part[kRowSumThreads / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int spc = (int)(blockDim.x >> 5) / wps;
  const long long seg = (long long)blockIdx.x * spc + warp / wps;
  const int sub = warp % wps;
  const long long per = (L + wps - 1) / wps;
  const long long k0 = sub * per < L ? sub * per : L, k1 = k0 + per < L ? k0 + per : L;
  const float4* tab = reinterpret_cast<const float4*>(table);
  const int* ix = idx + seg * L;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long k = k0; seg < n_seg && k < k1; k += 32) {
    const int row = k + lane < k1 ? __ldg(ix + k + lane) : 0;  // one index line, broadcast below
    const int n = k1 - k < 32 ? (int)(k1 - k) : 32;
    for (int t0 = 0; t0 < n; t0 += kRowSumDepth) {
      float4 v[kRowSumDepth];
#pragma unroll
      for (int i = 0; i < kRowSumDepth; ++i) {
        const long long r = __shfl_sync(0xffffffffu, row, (t0 + i) & 31);
        if (t0 + i < n) v[i] = __ldg(&tab[r * (kLanes / 4) + lane]);
      }
#pragma unroll
      for (int i = 0; i < kRowSumDepth; ++i) {
        if (t0 + i < n) add4(acc, v[i]);
      }
    }
  }
  if (wps > 1) {
    part[warp][lane] = acc;
    __syncthreads();
    if (sub != 0) return;
    for (int k = 1; k < wps; ++k) add4(acc, part[warp + k][lane]);
  }
  if (seg < n_seg) reinterpret_cast<float4*>(out)[seg * (kLanes / 4) + lane] = acc;
}

// p4: out[s] = sum over w < seg_len of x[qi[s L + w], qj[s L + w]], L =
// seg_len. The Pallas kernel walks each segment with scalar SMEM-indexed
// loads in one sequential loop; here one CTA takes a segment, each thread
// sums every 256th load, and the CTA adds the threads' sums by shuffles and
// then across warps in a fixed order, so every launch gives the same bits.
// At L = 1,024 that is one round of index loads and one of table loads.
// Its time on the card is a chain, not bytes (0.24 µs of them): the launch
// (about 45 % of it on an H100), the coalesced index round, the table round
// and the CTA's sum. Wider CTAs, int2/int4 index loads and a segment split
// over a cluster were all slower (PERF.md §6). STAGE cuts the kernel for
// timing its parts: the launch alone, or the index loads and sums without
// the table reads.
constexpr int kE6Full = 0, kE6LaunchOnly = 1, kE6IndicesOnly = 2;

template <int STAGE>
__global__ void __launch_bounds__(kThreads)
    scalar_gather_sum_kernel(const float* __restrict__ x, long long n_x_cols, const int* __restrict__ qi,
                             const int* __restrict__ qj, long long seg_len, float* __restrict__ out) {
  if constexpr (STAGE == kE6LaunchOnly) return;
  __shared__ float warp_sums[kWarps];
  const long long s = blockIdx.x;
  const int* ri = qi + s * seg_len;
  const int* rj = qj + s * seg_len;
  float acc = 0.0f;
#pragma unroll 4
  for (long long w = threadIdx.x; w < seg_len; w += kThreads) {
    if constexpr (STAGE == kE6IndicesOnly) acc += (float)(ri[w] + rj[w]);
    else acc += x[(long long)ri[w] * n_x_cols + rj[w]];
  }
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

// ---------------------------------------------------------------------------
// Bulk stores from shared memory (E5).

// this thread's generic-proxy writes to shared memory, ordered before the
// async proxy's reads of them (a bulk store issued after a barrier)
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// at most N of this thread's bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// E5 (p3): out[e, :] = f32(bf16(strip))[idx[e], :].
//
// Bound: bytes, nearly all of them the output (2^21 picks x 512 bytes =
// 1.07 GB written at the probe's size, against 8 MB of indices). The first
// port (the row gather, one pick a warp, 262,144 short-lived CTAs) wrote
// 512-byte pieces with little in flight and reached 1.40 TB/s. Here:
// - A persistent grid (the CTAs the card holds at once: one an SM when the
//   strip is resident) walks chunks of kPickTile consecutive picks, chunk c
//   = blockIdx.x + k * gridDim.x.
// - RESIDENT: each CTA rounds the strip to bf16 once and holds it in shared
//   memory (rows x 256 bytes: 128 KB at 512 rows), 4 bf16 a lane; a pick
//   widens them back to float32 (exact: a 16-bit shift). Otherwise (a strip
//   too tall for shared memory beside the ring) each pick reads its float32
//   row from global memory (L2) and rounds it, on the same write path.
// - Each warp takes kPickTile / 8 picks of a chunk: its lanes 0-7 load the
//   indices one chunk ahead, a shuffle hands each to the warp, whose 32
//   lanes write the row's 512 bytes into the chunk's tile in shared memory.
// - One thread stores the whole tile (kPickTile x 512 bytes: 32 KB) with one
//   cp.async.bulk store, out of a ring of kPickStages tiles. Before the
//   barrier that ends a chunk it waits (wait_group.read) until the store that
//   last used the next tile has read it, so while the warps fill a tile up
//   to kPickStages - 1 whole, contiguous tile stores are in flight.
// On an H100 this writes at 1.12 x the time of out.zero_() on the same
// output; the strip through L2 costs 1.5 %, direct st.global.cs stores from
// registers 4.6 %, 32-pick tiles 9 %, a ring of 2 nothing
// (chip_probes_ablation.py builds the PICK_* macros; PERF.md).

#ifndef PICK_TILE
#define PICK_TILE 64
#endif
#ifndef PICK_STAGES
#define PICK_STAGES 3
#endif

constexpr int kPickTile = PICK_TILE;  // picks a chunk
constexpr int kPickStages = PICK_STAGES;
constexpr int kPickPerWarp = kPickTile / kWarps;
constexpr int kRowBytes = kLanes * 4;
static_assert(kPickTile % kWarps == 0 && kPickPerWarp <= 32, "a warp's picks are held by its lanes");
static_assert(kPickStages >= 2, "the ring needs two tiles");

// four float32 values rounded to bf16 (to nearest even), two a word
__device__ __forceinline__ uint2 pack_bf16(float4 v) {
  const __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(v.x, v.y));
  const __nv_bfloat162 hi = __float22bfloat162_rn(make_float2(v.z, v.w));
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ float4 unpack_bf16(uint2 p) {
  return make_float4(__uint_as_float(p.x << 16), __uint_as_float(p.x & 0xffff0000u), __uint_as_float(p.y << 16),
                     __uint_as_float(p.y & 0xffff0000u));
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
    row_pick_bf16_kernel(const float* __restrict__ strip, long long n_tab_rows, const int* __restrict__ idx,
                         long long n, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint2* table = reinterpret_cast<uint2*>(smem);  // RESIDENT: row r, lane l at r * 32 + l
  float4* ring = reinterpret_cast<float4*>(smem + (RESIDENT ? n_tab_rows * (kRowBytes / 2) : 0));
  const float4* strip4 = reinterpret_cast<const float4*>(strip);
  float4* out4 = reinterpret_cast<float4*>(out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (RESIDENT) {
    for (long long i = threadIdx.x; i < n_tab_rows * 32; i += kThreads) table[i] = pack_bf16(__ldg(&strip4[i]));
    __syncthreads();
  }
  const long long n_chunks = (n + kPickTile - 1) / kPickTile;
  auto chunk_indices = [&](long long c) {  // lanes 0 .. kPickPerWarp - 1: this warp's picks of chunk c
    const long long e = c * kPickTile + warp * kPickPerWarp + lane;
    return (c < n_chunks && lane < kPickPerWarp && e < n) ? __ldg(&idx[e]) : 0;
  };
  int next = chunk_indices(blockIdx.x);
  int it = 0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
    const int mine = next;
    next = chunk_indices(c + gridDim.x);
    const long long e0 = c * kPickTile;
    const int picks = n - e0 < kPickTile ? (int)(n - e0) : kPickTile;
    float4* tile = ring + (it % kPickStages) * (kPickTile * 32);
#pragma unroll
    for (int i = 0; i < kPickPerWarp; ++i) {
      const int p = warp * kPickPerWarp + i;
      const long long r = __shfl_sync(0xffffffffu, mine, i);
      if (p < picks) {
        const float4 v = RESIDENT ? unpack_bf16(table[r * 32 + lane]) : round_bf16(__ldg(&strip4[r * 32 + lane]));
        tile[p * 32 + lane] = v;
      }
    }
    fence_async_shared();
    if (threadIdx.x == 0) bulk_wait_read<kPickStages - 2>();  // the tile the next chunk fills is read out
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(out4 + e0 * 32, tile, (uint32_t)picks * kRowBytes);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// E8 (g2): out[8b + c, :] = sum over t < T of table[cols[b T + t], :], c < 8.
//
// Bound: bytes (the table, the indices and the output once: 13.7 MB at the
// probe's size). The first port (the row gather) picked every row through
// L2: 1.2 GB a call at the card's whole-row rate, about 7 TB/s. Within a
// block each row is picked about once, so a block reuses nothing; across
// blocks each row is picked 285 times. So the table is cut into n_slices
// slices of `height` rows that fit one CTA's shared memory beside the
// counts below (_cuda.row_pick_count_plan: 391 rows, 196 KB, 21 slices at
// T = 8192), and the rows are read from there:
// - Units (slice s, group g of kCountWarps blocks), u = s * n_groups + g
//   (slice-major). A persistent grid (one CTA an SM) gives CTA i the units
//   [i U / G, (i + 1) U / G), so it loads one or two slices.
// - In a unit, warp w takes block g * kCountWarps + w alone. It streams the
//   block's indices into registers (an int4 a lane, four scalar loads where
//   T is no multiple of 4), kCountDepth steps ahead across units, and counts
//   how often each row of the slice is picked: a histogram in shared memory
//   (integer atomics, so exact in any order). Then it forms sum over rows r
//   of count[r] * slice[r] in row order, a hand-written float32 product of
//   the counts with the slice (a lane holds 4 columns), and stores it as
//   partial[b, s]. The warp that takes block b's last ticket adds the
//   n_slices partials in slice order, stores the 8 copies and sets the
//   ticket back to 0. One launch, the same bits every launch; the warps
//   share nothing but the slice and meet only where the CTA changes slices.
// L2 carries n_slices x the indices (196 MB at the probe's size) and each
// CTA's slices once, instead of 1.2 GB of rows. A first form (the same
// slices; per index that hit the slice, a shuffle, then the whole warp's
// row load and add) ran 1.5 x slower on an H100: each such pick was a chain
// of latencies that no loop could overlap (PERF.md).

#ifndef COUNT_DEPTH
#define COUNT_DEPTH 4
#endif
constexpr int kCountWarps = 16;  // blocks a unit: one a warp
constexpr int kCountThreads = kCountWarps * 32;
constexpr int kCountDepth = COUNT_DEPTH;  // index steps in flight a warp
constexpr int kScanStep = 128;            // indices a warp takes a step: an int4 a lane

template <bool ALIGNED>
__global__ void __launch_bounds__(kCountThreads, 1)
    row_pick_counts_kernel(const float* __restrict__ table, long long n_tab_rows, const int* __restrict__ cols,
                           long long T, long long n_blocks, int height, int n_slices, float* __restrict__ out,
                           float* __restrict__ partial, int* __restrict__ tickets) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = (height + 3) & ~3;  // counts a warp, 16-byte rows
  float4* slice = reinterpret_cast<float4*>(smem);
  unsigned* counts = reinterpret_cast<unsigned*>(smem + (size_t)height * kRowBytes) + warp * stride;
  const long long n_groups = (n_blocks + kCountWarps - 1) / kCountWarps;
  const long long n_units = (long long)n_slices * n_groups;
  const long long u0 = n_units * blockIdx.x / gridDim.x, u1 = n_units * (blockIdx.x + 1) / gridDim.x;
  const int Ti = (int)T;
  const int steps = (Ti + kScanStep - 1) / kScanStep;  // a warp's steps a unit
  long long fg = u0 % n_groups, f_left = (u1 - u0) * steps;  // the fetch cursor, kCountDepth steps ahead
  int fk = 0;
  auto fetch = [&]() {
    int4 c4 = make_int4(0, 0, 0, 0);
    if (f_left > 0) {
      const long long b = fg * kCountWarps + warp;
      const int i = fk * kScanStep + 4 * lane;
      if (b < n_blocks) {
        const int* src = cols + b * T + i;
        if (ALIGNED) {
          if (i < Ti) c4 = __ldg(reinterpret_cast<const int4*>(src));
        } else {
          if (i < Ti) c4.x = __ldg(src);
          if (i + 1 < Ti) c4.y = __ldg(src + 1);
          if (i + 2 < Ti) c4.z = __ldg(src + 2);
          if (i + 3 < Ti) c4.w = __ldg(src + 3);
        }
      }
      --f_left;
      if (++fk == steps) {
        fk = 0;
        if (++fg == n_groups) fg = 0;
      }
    }
    return c4;
  };
  int4 ring[kCountDepth];
#pragma unroll
  for (int d = 0; d < kCountDepth; ++d) ring[d] = fetch();
  const float4* table4 = reinterpret_cast<const float4*>(table);
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  float4* out4 = reinterpret_cast<float4*>(out);
  long long s = u0 / n_groups, g = u0 - s * n_groups, held = -1;  // the unit's slice and group; the slice held
  int lo = 0, h = 0;
  for (long long j = 0; u0 + j < u1; ++j) {
    if (s != held) {
      __syncthreads();  // every warp is done with the old slice
      lo = (int)(s * height);
      h = n_tab_rows - lo < height ? (int)(n_tab_rows - lo) : height;
      const float4* src = table4 + (long long)lo * 32;
#pragma unroll 8
      for (int q = threadIdx.x; q < h * 32; q += kCountThreads) slice[q] = __ldg(&src[q]);
      __syncthreads();
      held = s;
    }
    const long long b = g * kCountWarps + warp;
    const bool live = b < n_blocks;  // alike in the warp
    for (int q = lane; q < stride; q += 32) counts[q] = 0;
    __syncwarp();
    for (int k = 0; k < steps; ++k) {
      const int4 c4 = ring[0];
#pragma unroll
      for (int d = 0; d + 1 < kCountDepth; ++d) ring[d] = ring[d + 1];
      ring[kCountDepth - 1] = fetch();
      const int i = k * kScanStep + 4 * lane;
      const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned rel = (unsigned)(cs[q] - lo);
        if (live && i + q < Ti && rel < (unsigned)h) atomicAdd(&counts[rel], 1u);
      }
    }
    __syncwarp();
    if (live) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r0 = 0; r0 < h; r0 += 4) {
        const uint4 c4 = *reinterpret_cast<const uint4*>(counts + r0);  // rows past h count 0
        const unsigned cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (cs[q]) {  // alike in the warp
            const float c = (float)cs[q];
            const float4 v = slice[(r0 + q) * 32 + lane];
            acc.x = fmaf(c, v.x, acc.x);
            acc.y = fmaf(c, v.y, acc.y);
            acc.z = fmaf(c, v.z, acc.z);
            acc.w = fmaf(c, v.w, acc.w);
          }
        }
      }
      reinterpret_cast<float4*>(partial)[(b * n_slices + s) * 32 + lane] = acc;
      __threadfence();  // the partial is visible to the block's last warp before this one's ticket
      __syncwarp();
      int last = 0;
      if (lane == 0) last = atomicAdd(&tickets[b], 1) == n_slices - 1;
      if (__shfl_sync(0xffffffffu, last, 0)) {
        __threadfence();
        const float4* pb = p4 + b * n_slices * 32 + lane;
        float4 tot = __ldcg(pb);
        int k = 1;
        for (; k + 4 <= n_slices; k += 4) {  // four loads in flight, added in slice order
          const float4 a = __ldcg(pb + k * 32), c = __ldcg(pb + (k + 1) * 32), d = __ldcg(pb + (k + 2) * 32),
                       e = __ldcg(pb + (k + 3) * 32);
          add4(tot, a);
          add4(tot, c);
          add4(tot, d);
          add4(tot, e);
        }
        for (; k < n_slices; ++k) add4(tot, __ldcg(pb + k * 32));
#pragma unroll
        for (int c = 0; c < 8; ++c) out4[(b * 8 + c) * 32 + lane] = tot;
        if (lane == 0) tickets[b] = 0;
      }
    }
    if (++g == n_groups) {
      g = 0;
      ++s;
    }
  }
}

template <bool WEIGHTED>
int launch_row_gather(const void* table, const void* idx, const void* weights, const Segments& sg, void* out,
                      void* stream) {
  const int wps = (WEIGHTED || sg.n_g * sg.n_w >= 1024) ? kWarps : 1;
  const long long per_cta = kWarps / wps;
  const long long blocks = (sg.n_seg + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<WEIGHTED><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (const float*)weights, sg, wps, (float*)out);
  return (int)cudaGetLastError();
}

// A persistent grid of `kernel`: the CTAs the card holds at once with
// `threads` threads and `smem` bytes of dynamic shared memory, at most `want`.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long want, long long* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  *grid = want < cap ? want : cap;
  return cudaSuccess;
}

// Launch `kernel` on a persistent grid: as many CTAs as the card holds at
// once, at most max_per_sm an SM, rounded down to a multiple of `multiple`,
// at most `want` (rounded up to a multiple of `multiple`).
template <typename... KArgs, typename... Args>
int launch_persistent(void (*kernel)(KArgs...), int threads, size_t smem, int max_per_sm, long long want,
                      long long multiple, void* stream, Args&&... args) {
  long long grid = 0;
  cudaError_t err = persistent_grid(kernel, threads, smem, 1LL << 62, &grid);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  grid = grid < (long long)sms * max_per_sm ? grid : (long long)sms * max_per_sm;
  grid -= grid % multiple;
  want = (want + multiple - 1) / multiple * multiple;
  if (grid < multiple) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)(want < grid ? want : grid), threads, smem, (cudaStream_t)stream>>>(static_cast<Args&&>(args)...);
  return (int)cudaGetLastError();
}

// E1: the table in shared memory (resident != 0; the launcher's plan,
// _cuda.spmv_products_resident) or read through L2 (spmv_products_kernel)
constexpr int kE1MaxRows = 904;  // 904 x 256 bytes, 452 x 512: at most 232,448 - 1,024

template <bool HILO>
int launch_spmv_products(const void* x2, long long n_tab_rows, const void* cols, const void* data, long long n,
                         long long resident, void* out, void* stream) {
  if (n == 0) return 0;
  if (!resident) {
    spmv_products_kernel<HILO><<<(unsigned)grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x2, n_tab_rows, (const int*)cols, (const float*)data, n, (float*)out);
    return (int)cudaGetLastError();
  }
  if (n_tab_rows < 1 || n_tab_rows > kE1MaxRows || (reinterpret_cast<uintptr_t>(x2) & 15))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + kE1Chunk - 1) / kE1Chunk;
  const int rows = (int)n_tab_rows;
  const size_t smem = HILO ? (size_t)((rows + 1) / 2) * 4 * kLanes : (size_t)rows * 2 * kLanes;
  return launch_persistent(spmv_products_smem_kernel<HILO>, kE1Threads, smem, 1, HILO ? 2 * n_chunks : n_chunks,
                           HILO ? 2 : 1, stream, (const __nv_bfloat16*)x2, rows, (const int*)cols, (const float*)data, n,
                           (float*)out);
}

}  // namespace

extern "C" {

int st_spmv_products_hilo(const void* x2, long long n_tab_rows, const void* cols, const void* data, long long n,
                          long long resident, void* out, void* stream) {
  return launch_spmv_products<true>(x2, n_tab_rows, cols, data, n, resident, out, stream);
}

int st_spmv_products_bf16(const void* x2, long long n_tab_rows, const void* cols, const void* data, long long n,
                          long long resident, void* out, void* stream) {
  return launch_spmv_products<false>(x2, n_tab_rows, cols, data, n, resident, out, stream);
}

// E3: resident != 0, the slice route (_cuda.lane_gather_design), else the
// L2 route (lane_gather_kernel<false>)
int st_lane_gather(const void* table, long long n_tab_rows, const void* idx, long long n_rows, long long resident,
                   void* out, void* stream) {
  if (n_rows == 0) return 0;
  if (!resident) {
    lane_gather_kernel<false><<<(unsigned)grid_for(n_rows * (kLanes / 4)), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)idx, n_rows, 0, (float*)out, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)n_tab_rows * kSliceLanes * 4;
  if (n_tab_rows < 1 || smem > 232448 - 1024 || (reinterpret_cast<uintptr_t>(table) & 15))
    return (int)cudaErrorInvalidValue;
  const long long want = kLaneSlices * ((n_rows + kGatherMinRows - 1) / kGatherMinRows);
  return launch_persistent(lane_slice_kernel<false>, kSliceThreads, smem, LANE_GATHER_CTAS_PER_SM, want, kLaneSlices,
                           stream, (const float*)table, (int)n_tab_rows, (const int*)idx, n_rows, 1LL, (float*)out);
}

// E7: resident != 0, the slice route (_cuda.lane_slice_resident; partial
// and tickets unused), else the L2 route (lane_gather_kernel<true>: partial
// (n_blocks, ceil(T / 64), 128), tickets (n_blocks,) zero before and after).
int st_lane_gather_blocksum(const void* table, long long n_tab_rows, const void* idx, long long n_blocks,
                            long long rows_per_block, long long resident, void* out, void* partial, void* tickets,
                            void* stream) {
  if (n_blocks == 0) return 0;
  const long long T = rows_per_block;
  if (!resident) {
    const long long n_splits = (T + kSplitRows - 1) / kSplitRows;
    if (n_splits == 0 || n_splits > 0x7fffffffLL || n_blocks > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_splits, (unsigned)n_blocks);
    lane_gather_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)idx, n_blocks * T, T, (float*)out, (float*)partial, (int*)tickets);
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)n_tab_rows + kSliceWarps) * kSliceLanes * 4;
  if (T < 1 || n_tab_rows < 1 || smem > 232448 - 1024 || (reinterpret_cast<uintptr_t>(table) & 15))
    return (int)cudaErrorInvalidValue;
  return launch_persistent(lane_slice_kernel<true>, kSliceThreads, smem, LANE_CTAS_PER_SM, n_blocks * kLaneSlices,
                           kLaneSlices, stream, (const float*)table, (int)n_tab_rows, (const int*)idx, T, n_blocks,
                           (float*)out);
}

int st_row_gather(const void* table, const void* idx, const void* weights, long long n_seg, long long seg_per_group,
                  long long group_stride, long long r_stride, long long n_g, long long g_stride, long long n_w,
                  long long keep, long long copies, void* out, void* stream) {
  if (n_seg == 0) return 0;
  const Segments sg{n_seg, seg_per_group, group_stride, r_stride, n_g, g_stride, n_w, keep, copies};
  return weights != nullptr ? launch_row_gather<true>(table, idx, weights, sg, out, stream)
                            : launch_row_gather<false>(table, idx, weights, sg, out, stream);
}

// E4: segments of L consecutive indices, wps warps a segment and
// segments_per_cta of them a CTA (_cuda.row_gather_sum_plan)
int st_row_gather_sum(const void* table, const void* idx, long long n_seg, long long L, long long wps,
                      long long segments_per_cta, void* out, void* stream) {
  if (n_seg == 0) return 0;
  if (L < 1 || wps < 1 || segments_per_cta < 1 || wps * segments_per_cta * 32 > kRowSumThreads)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (n_seg + segments_per_cta - 1) / segments_per_cta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  row_gather_sum_kernel<<<(unsigned)ctas, (unsigned)(wps * segments_per_cta * 32), 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, n_seg, L, (int)wps, (float*)out);
  return (int)cudaGetLastError();
}

// E6 cut to `stage`: 0 the whole sum, 1 the launch alone, 2 the index loads
// and sums
int st_scalar_gather_sum(const void* x, long long n_x_cols, const void* qi, const void* qj, long long n_seg,
                         long long seg_len, long long stage, void* out, void* stream) {
  if (n_seg == 0) return 0;
  if (n_seg > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, long long, const int*, const int*, long long, float*);
  switch (stage) {
    case kE6Full: kernel = scalar_gather_sum_kernel<kE6Full>; break;
    case kE6LaunchOnly: kernel = scalar_gather_sum_kernel<kE6LaunchOnly>; break;
    case kE6IndicesOnly: kernel = scalar_gather_sum_kernel<kE6IndicesOnly>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<(unsigned)n_seg, kThreads, 0, (cudaStream_t)stream>>>((const float*)x, n_x_cols, (const int*)qi,
                                                                 (const int*)qj, seg_len, (float*)out);
  return (int)cudaGetLastError();
}

// E5: the strip held in shared memory (resident != 0; the launcher's plan,
// _cuda.row_pick_bf16_resident) or read from L2.
int st_row_pick_bf16(const void* strip, long long n_tab_rows, const void* idx, long long n, long long resident,
                     void* out, void* stream) {
  if (n == 0) return 0;
  const size_t ring = (size_t)kPickStages * kPickTile * kRowBytes;
  const size_t smem = ring + (resident ? (size_t)n_tab_rows * (kRowBytes / 2) : 0);
  auto kernel = resident ? row_pick_bf16_kernel<true> : row_pick_bf16_kernel<false>;
  long long grid = 0;
  cudaError_t err = persistent_grid(kernel, kThreads, smem, (n + kPickTile - 1) / kPickTile, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>((const float*)strip, n_tab_rows, (const int*)idx,
                                                                   n, (float*)out);
  return (int)cudaGetLastError();
}

// E8: slices of `height` rows (the last may be shorter), n_slices of them
// (_cuda.row_pick_count_plan); partial (n_blocks, n_slices, 128) scratch,
// tickets (n_blocks,) zero before and after.
int st_row_pick_counts(const void* table, long long n_tab_rows, const void* cols, long long T, long long n_blocks,
                       long long height, long long n_slices, void* out, void* partial, void* tickets, void* stream) {
  if (n_blocks == 0) return 0;
  if (height <= 0 || n_slices <= 0 || T <= 0 || (n_slices - 1) * height >= n_tab_rows ||
      n_slices * height < n_tab_rows || n_tab_rows > 0x7fffffffLL || T > 0x7fffffffLL - kScanStep)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)height * kRowBytes + (size_t)kCountWarps * ((height + 3) & ~3LL) * 4;
  const bool aligned = T % 4 == 0 && (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  auto kernel = aligned ? row_pick_counts_kernel<true> : row_pick_counts_kernel<false>;
  const long long n_units = n_slices * ((n_blocks + kCountWarps - 1) / kCountWarps);
  long long grid = 0;
  cudaError_t err = persistent_grid(kernel, kCountThreads, smem, n_units, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kCountThreads, smem, (cudaStream_t)stream>>>(
      (const float*)table, n_tab_rows, (const int*)cols, T, n_blocks, (int)height, (int)n_slices, (float*)out,
      (float*)partial, (int*)tickets);
  return (int)cudaGetLastError();
}

}  // extern "C"
