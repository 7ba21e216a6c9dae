// Block-sparse (BSR) products on Hopper's tensor cores (sm_90a), float32 as
// 3xTF32 and bfloat16, plain C interface for ctypes: the SpMM (P2, the
// layer's forward and dgrad) and the block-sampled SDDMM (P4, its wgrad).
// Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// The TMA tensor maps are encoded by cuTensorMapEncodeTiled, looked up
// through the CUDA runtime (cudaGetDriverEntryPoint), so the build needs no
// -lcuda.
//
// Bound on this card at the layer's full width (8192 x 8192, 25 % of the
// 128 x 128 blocks, 1,042 stored blocks, batch 512): operations. Each
// product does 2 * 1042 * 128 * 128 * 512 = 17.48 GFLOP on about 100 MB. In
// float32 the reference's Precision.HIGHEST rules out one TF32 pass, so each
// product is three tensor-core passes, 3 * 17.48 GFLOP / 495 TFLOP/s =
// 0.106 ms (the bytes give about 0.031 ms); bfloat16 is one pass at 989
// TFLOP/s.
//
// ---- the SpMM ----
//
//   out[r-block, :] = sum over block-row r's run of blocks[j] @ dense[cols[j]-block, :]
//
// Replaces sparse_tpu/kernels/bsr.py:_spmm_kernel (P2, behind
// bsr_spmm_pallas) for float32 and bfloat16; it replaces csrc/bsr.cu's
// bsr_spmm_kernel<T, 1> (FFMA tiling on the CUDA cores), which keeps float64
// and the two-block form (P3).
//
// Design (one CTA per (piece of a block-row's run, 128-row slice of the
// block, 128-column tile of dense); 384 threads in three warpgroups):
// - warp 0 issues TMA loads into a ring of shared-memory stages (3 for
//   float32, 4 for bfloat16), each stage one 128-byte k-slice of the
//   current stored block (128 rows) and the same k-slice of dense (128
//   columns), 128-byte swizzled, through "full" mbarriers; tiles past the
//   operands' ends (a ragged block shape, rows past K, columns past N) are
//   filled with zeros by the TMA unit;
// - float32 only: warps 1-3 split every landed stage in place into tf32
//   hi and lo parts (hi = x rounded to tf32, lo = (x - hi) rounded to
//   tf32, both by integer ops with their low 13 bits zero, so the tensor
//   core reads them exactly), then release it through "ready" mbarriers;
// - warpgroups 1 and 2 each own 64 output rows and issue wgmma.mma_async
//   (m64n128, k = 32 bytes: 8 tf32 or 16 bf16 values) from shared memory
//   into float32 registers: lo*hi + hi*lo + hi*hi for float32 (3xTF32,
//   about 2^-21 relative error per product), one pass for bfloat16; each
//   stored block's sum is then added into a second set of registers with
//   IEEE float32 adds, since the tensor core's own sums lose bits over
//   long runs; each
//   stage goes back to the producer through "empty" mbarriers as soon as
//   its products are done, so loads and splits run two or three stages
//   ahead of the tensor cores.
// The tensor core takes tf32 operands K-major only, so both operands are
// K-major: `blocks` (k contiguous in a block row) and dense (element (k, n)
// at dense[k + n * ld], e.g. x.T of a row-major x); the wrapper copies
// anything else into that layout.
//
// Load balance: a run longer than `piece` blocks is cut into pieces of
// `piece` blocks counted from the run's start. `pieces` (int64,
// n_block_rows + 1) counts the pieces of the split rows before each
// block-row. CTAs [0, n_front) take those pieces (first, so that the long
// runs start early), CTAs n_front + r take block-row r unless it is split.
// A piece writes its float32 partial tile to `partial` and takes a ticket;
// the CTA that takes the tile's last ticket adds the partials in piece
// order, stores the tile and sets the ticket back to 0. No atomics on data:
// results are deterministic. Every output element is written exactly once
// (an empty run stores zeros), so the output needs no memset.
//
// ---- the SDDMM ----
//
//   out[j] = lhs[rows[j]-block, :] @ rhs[:, cols[j]-block]   for every stored block j
//
// Replaces sparse_tpu/kernels/bsr.py:_sddmm_kernel (P4, behind
// bsr_sddmm_pallas) for float32 and bfloat16; it replaces csrc/bsr.cu's
// bsr_sddmm_kernel<T> (FFMA tiling on the CUDA cores), which keeps float64.
// The contraction runs over the batch B, and in the layer both operands
// reach the kernel with the batch strided (lhs = the gradient of out_t,
// grad_y.T; rhs = x): MN-major, where the tensor core takes tf32 operands
// K-major only.
//
// Design (a persistent grid of one CTA per SM at most; 384 threads in three
// warpgroups, as the SpMM): a unit is one 128 x 128 tile of one stored
// block (one unit per block at 128 x 128 blocks), a contraction over B in
// stages of 128 bytes of k. Every unit has the same length, so CTA b takes
// units b, b + grid, ... in order, and its rings run on from one unit into
// the next: the pipeline fills once per CTA, and the consumers' store of a
// tile overlaps the next tile's loads.
// - thread 0 issues TMA loads of both operands' k-slices into a "raw"
//   ring; rows past M, columns past K and k past B are zero-filled by the
//   TMA unit. A K-major operand lands as the SpMM's tiles do (128 rows of
//   128 bytes of k, 128-byte swizzled), an MN-major one as k-rows of its
//   128 MN values.
// - float32: all four warps of the first warpgroup are converters (thread 0
//   issues each stage's loads two stages ahead of the one it converts).
//   Each converter reads its share of a raw stage into registers, frees
//   the raw slot, splits every value into tf32 hi and lo as the SpMM does,
//   and writes both K-major into the 128-byte swizzled layout of a "conv"
//   ring that the wgmma descriptors read. An MN-major operand is
//   transposed on the way in 4 x 4 blocks: one 16-byte load from each of
//   four k-rows, a transpose in registers, four 16-byte stores of a row's
//   chunk of k; the blocks are dealt so that every quarter warp reads 8
//   distinct bank groups and writes 8 distinct swizzled positions. A
//   K-major one is split in place order. The converters bound the kernel
//   (PERF.md, chip_sddmm_ablation.py): hence four warps, 16-byte loads
//   and a raw slot freed before its values are split.
// - bfloat16: no converters; the consumers read the raw ring, an MN-major
//   operand through the wgmma transpose bit (its k-slices land as two
//   halves of 64 MN values, 128-byte swizzled).
// - warpgroups 1 and 2 each own 64 rows of the tile: 3xTF32 (lo*hi + hi*lo
//   + hi*hi) or one bf16 pass into float32 registers, added into a second
//   set with IEEE adds every 128 values of k (the tensor core's own sums
//   lose bits over long contractions), then each stores its rows (the
//   bf16 output rounded once).
// A block with a negative index, or that starts past M or K, is a zero
// tile; pad blocks are computed like any other. Every output element is
// written exactly once, with no atomics: no memset, deterministic results.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per CTA (two consumer warpgroups of 64)
constexpr int BN = 128;          // output columns per CTA
constexpr int kRowBytes = 128;   // one k-slice row of a stage: the 128-byte swizzle span
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConverters = 96;  // warps 1-3 of the producer warpgroup

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kStages = 3;
  static constexpr bool kSplit = true;  // 3xTF32
  static constexpr int kStep = 8;       // k per wgmma (32 bytes)
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kStages = 4;
  static constexpr bool kSplit = false;
  static constexpr int kStep = 16;
};

template <typename T>
struct Layout {
  static constexpr int kBke = kRowBytes / (int)sizeof(T);    // k values per stage
  static constexpr int kTile = BM * kRowBytes;               // bytes of one operand tile (BM == BN)
  static constexpr int kBufs = Cfg<T>::kSplit ? 4 : 2;       // A, B (+ A lo, B lo)
  static constexpr int kStageBytes = kBufs * kTile;
  static constexpr int kBarBytes = 3 * Cfg<T>::kStages * 8;  // full, ready, empty
  static constexpr int kSmem = 1024 + Cfg<T>::kStages * kStageBytes + kBarBytes + 16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_of(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ST_WGMMA_ACC                                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),   \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),    \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),   \
      "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),   \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),   \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),   \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define ST_WGMMA_REGS                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (64 x 128, f32, accumulated) += A (64 x k) * B (k x 128) from shared
// memory, K-major, or MN-major where kTA / kTB (the transpose bits; bf16 only) are 1
template <typename T, int kTA = 0, int kTB = 0>
struct Mma;
template <>
struct Mma<float, 0, 0> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ST_WGMMA_REGS "%64, %65, p, 1, 1;\n"
        "}\n"
        : ST_WGMMA_ACC
        : "l"(a), "l"(b), "r"(1));
  }
};
template <int kTA, int kTB>
struct Mma<__nv_bfloat16, kTA, kTB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ST_WGMMA_REGS "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : ST_WGMMA_ACC
        : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
  }
};

// x rounded to tf32 (nearest, ties away from zero, as cvt.rna.tf32.f32) by
// integer ops: half a tf32 ulp added to the magnitude, the 13 low bits dropped
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// the 3xTF32 split of four values: h = x rounded to tf32, l = (x - h)
// rounded to tf32; an infinite h keeps l = 0 (x - h would be NaN)
__device__ __forceinline__ void split4(const float4 x, float4& h, float4& l) {
  h.x = tf32_round(x.x);
  h.y = tf32_round(x.y);
  h.z = tf32_round(x.z);
  h.w = tf32_round(x.w);
  l.x = fabsf(h.x) < INFINITY ? tf32_round(x.x - h.x) : 0.0f;
  l.y = fabsf(h.y) < INFINITY ? tf32_round(x.y - h.y) : 0.0f;
  l.z = fabsf(h.z) < INFINITY ? tf32_round(x.z - h.z) : 0.0f;
  l.w = fabsf(h.w) < INFINITY ? tf32_round(x.w - h.w) : 0.0f;
}

// one stage split in place: the 2 * BM rows of A and B become hi, and their
// lo parts go to the two buffers after them
__device__ __forceinline__ void split_stage(unsigned char* stage, int tid) {
  constexpr int kVec = 2 * BM * kRowBytes / 16;  // float4s of A and B
  float4* hi = reinterpret_cast<float4*>(stage);
  float4* lo = reinterpret_cast<float4*>(stage + 2 * BM * kRowBytes);
  for (int e = tid; e < kVec; e += kConverters) {
    float4 h, l;
    split4(hi[e], h, l);
    hi[e] = h;
    lo[e] = l;
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    bsr_spmm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                       const int* __restrict__ block_cols, const long long* __restrict__ row_ptr,
                       const long long* __restrict__ pieces, long long n_block_rows, long long n_front,
                       long long piece, long long bm, long long bn, long long N, T* __restrict__ out,
                       long long n_rows, float* __restrict__ partial, int* __restrict__ tickets, int m_tiles,
                       int n_tiles) {
  using L = Layout<T>;
  constexpr int S = Cfg<T>::kStages;
  constexpr bool kSplit = Cfg<T>::kSplit;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * L::kStageBytes);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  int* last_flag = reinterpret_cast<int*>(empty + S);

  // which work unit: tiles vary fastest, so a piece's tiles start together
  const int tile = blockIdx.x % (m_tiles * n_tiles);
  const int mt = tile / n_tiles, nt = tile % n_tiles;
  const long long unit = blockIdx.x / (m_tiles * n_tiles);
  long long row, begin, end, first = 0, n_pieces = 1;
  if (unit >= n_front) {  // an unsplit block-row
    row = unit - n_front;
    if (row >= n_block_rows || pieces[row + 1] != pieces[row]) return;
    begin = row_ptr[row];
    end = row_ptr[row + 1];
  } else {
    if (unit >= pieces[n_block_rows]) return;
    long long lo = 0, hi = n_block_rows;  // pieces[lo] <= unit < pieces[hi]
    while (hi - lo > 1) {
      const long long mid = (lo + hi) / 2;
      if (pieces[mid] <= unit) lo = mid;
      else hi = mid;
    }
    row = lo;
    first = pieces[row];
    n_pieces = pieces[row + 1] - first;
    begin = row_ptr[row] + (unit - first) * piece;
    end = row_ptr[row + 1] - begin < piece ? row_ptr[row + 1] : begin + piece;
  }
  const int k_tiles = (int)(bn / L::kBke);
  const long long n_iter = (end - begin) * k_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kConverters);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x == 0) {  // producer: TMA loads
      for (long long it = 0; it < n_iter; ++it) {
        const int s = (int)(it % S);
        const uint32_t round = (uint32_t)(it / S);
        mbar_wait(&empty[s], (round & 1) ^ 1);
        const long long j = begin + it / k_tiles;
        const int k0 = (int)(it % k_tiles) * L::kBke;
        const long long col = block_cols[j];
        unsigned char* st = smem + s * L::kStageBytes;
        mbar_expect_tx(&full[s], 2 * L::kTile);
        tma_load_3d(st, &map_a, &full[s], k0, mt * BM, (int)j);
        tma_load_2d(st + L::kTile, &map_b, &full[s], (int)(col * bn) + k0, nt * BN);
      }
    } else if (kSplit && threadIdx.x >= 32) {  // converters: the 3xTF32 split
      const int tid = threadIdx.x - 32;
      for (long long it = 0; it < n_iter; ++it) {
        const int s = (int)(it % S);
        mbar_wait(&full[s], (uint32_t)(it / S) & 1);
        split_stage(smem + s * L::kStageBytes, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  // consumers: warpgroup c = wg - 1 owns rows [64 c, 64 c + 64) of the tile.
  // The tensor core sums a block's products into d; its own float32 sums
  // round less carefully than IEEE adds (a run of 16 blocks summed there
  // reads 1.6e-5 normalised against float64), so each block's d is added
  // into acc with IEEE adds and d starts again from 0.
  const int c = wg - 1;
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = acc[i] = 0.0f;
  fence_acc(d);
  for (long long it = 0; it < n_iter; ++it) {
    const int s = (int)(it % S);
    mbar_wait(kSplit ? &ready[s] : &full[s], (uint32_t)(it / S) & 1);
    unsigned char* a = smem + s * L::kStageBytes + c * 64 * kRowBytes;
    unsigned char* b = smem + s * L::kStageBytes + L::kTile;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < L::kBke / Cfg<T>::kStep; ++k) {
      const int off = k * 32;  // bytes of one wgmma k-step
      if constexpr (kSplit) {
        Mma<T>::run(d, desc_of(a + 2 * L::kTile + off), desc_of(b + off));  // lo * hi
        Mma<T>::run(d, desc_of(a + off), desc_of(b + 2 * L::kTile + off));  // hi * lo
      }
      Mma<T>::run(d, desc_of(a + off), desc_of(b + off));  // hi * hi
    }
    wgmma_commit();
    wgmma_wait<0>();  // release the stage as soon as its products are done: the
                      // producer and converters then run S - 1 stages ahead
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
    if ((it + 1) % k_tiles == 0) {  // the block is done: promote its sum
      fence_acc(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[i] += d[i];
        d[i] = 0.0f;
      }
      fence_acc(d);
    }
  }

  // the accumulator layout of wgmma m64nN: register 4 q + e holds row
  // 16 w + lane / 4 + 8 (e / 2), column 8 q + 2 (lane % 4) + e % 2
  const int t = threadIdx.x - 128 - c * 128;
  const int w = t / 32, lane = t % 32;
  const long long row0 = (long long)mt * BM + c * 64 + w * 16 + lane / 4;  // inside the block
  const long long col0 = (long long)nt * BN + 2 * (lane % 4);
  auto for_each = [&](auto&& fn) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) fn(q * 4 + e, row0 + 8 * (e / 2), col0 + 8 * q + (e % 2));
  };
  auto store = [&](int i, long long rb, long long n, float v) {
    const long long r_out = row * bm + rb;
    if (rb < bm && r_out < n_rows && n < N) store_out(out + r_out * N + n, v);
  };
  if (n_pieces == 1) {
    for_each([&](int i, long long rb, long long n) { store(i, rb, n, acc[i]); });
    return;
  }
  // a piece of a split run: partial tile, ticket, and the last piece's sum in piece order
  const long long tile_elems = (long long)BM * BN;
  const long long tiles = (long long)m_tiles * n_tiles;
  auto at = [&](long long u, long long rb, long long n) {
    return ((u * tiles + tile) * tile_elems) + (rb - (long long)mt * BM) * BN + (n - (long long)nt * BN);
  };
  for_each([&](int i, long long rb, long long n) { partial[at(unit, rb, n)] = acc[i]; });
  __threadfence();
  consumer_sync();
  int* ticket = &tickets[first * tiles + tile];
  if (t == 0 && c == 0) *last_flag = atomicAdd(ticket, 1) == n_pieces - 1;
  consumer_sync();
  if (!*last_flag) return;
  __threadfence();
  for_each([&](int i, long long rb, long long n) {
    float sum = 0.0f;
    for (long long q = 0; q < n_pieces; ++q) sum += __ldcg(&partial[at(first + q, rb, n)]);
    store(i, rb, n, sum);
  });
  if (t == 0 && c == 0) *ticket = 0;
}

// ---- the SDDMM ----

template <typename T>
struct SdCfg;
template <>
struct SdCfg<float> {
  static constexpr int kRaw = 3;   // TMA stages
  static constexpr int kConv = 2;  // split stages: hi and lo of both operands
  static constexpr int kStep = 8;  // k per wgmma (32 bytes)
};
template <>
struct SdCfg<__nv_bfloat16> {
  static constexpr int kRaw = 6;
  static constexpr int kConv = 0;
  static constexpr int kStep = 16;
};

template <typename T>
struct SdLayout {
  static constexpr int kBke = kRowBytes / (int)sizeof(T);  // k values per stage
  static constexpr int kTile = BM * kRowBytes;             // one operand's k-slice (BM == BN)
  static constexpr int kRawBytes = 2 * kTile;              // lhs, rhs
  static constexpr int kConvBytes = 4 * kTile;             // lhs hi, rhs hi, lhs lo, rhs lo
  static constexpr int kPromote = 128 / kBke;              // stages per IEEE add of the tensor-core sums
  static constexpr int kBarBytes = 2 * (SdCfg<T>::kRaw + SdCfg<T>::kConv) * 8;
  static constexpr int kSmem = 1024 + SdCfg<T>::kRaw * kRawBytes + SdCfg<T>::kConv * kConvBytes + kBarBytes;
};
static_assert(SdLayout<float>::kSmem <= 232448 && SdLayout<__nv_bfloat16>::kSmem <= 232448,
              "more shared memory than a CTA can have");

// wgmma shared-memory descriptor of an MN-major bf16 tile (read with the
// transpose bit): k-rows of 64 MN values (128 bytes), 128-byte swizzle;
// 8-k-row groups 1024 bytes apart (SBO), 64-value halves of MN 8 KB apart (LBO)
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(SdLayout<__nv_bfloat16>::kTile / 2 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the k-slice [k0, k0 + kBke) of MN values [r0, r0 + 128) of one operand
template <typename T, bool kMn>
__device__ __forceinline__ void sddmm_load(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int r0, int k0) {
  if constexpr (!kMn) {
    tma_load_2d(dst, map, bar, k0, r0);
  } else if constexpr (sizeof(T) == 4) {
    tma_load_2d(dst, map, bar, r0, k0);
  } else {  // two halves of 64 MN values
    tma_load_2d(dst, map, bar, r0, k0);
    tma_load_2d(dst + SdLayout<T>::kTile / 2, map, bar, r0 + 64, k0);
  }
}

// the float32 converters of the SDDMM: all four warps of the producer
// warpgroup (thread 0 also issues the TMA loads)
constexpr int kSdConverters = 128;

// A converter's share of one float32 stage. Each operand's k-slice is 256
// jobs of four 16-byte chunks: for an MN-major operand (k-row i of 128 floats
// at 512 i) the 4 x 4 block of rows 4a..4a+3 and k-values 4c..4c+3, read as
// one float4 from each of four k-rows and transposed in registers; for a
// K-major one (already in the swizzled layout) the chunks e + 256 j. A
// quarter warp (8 jobs: t = e % 8, a = t + 8 ((e / 8) % 4), c = t ^ (e / 32))
// reads 8 distinct bank groups and writes 8 distinct swizzled positions.
constexpr int kJobs = 256;
constexpr int kJobsPer = kJobs / kSdConverters;
static_assert(kJobs % kSdConverters == 0, "whole jobs per converter");

__device__ __forceinline__ void sddmm_job(int e, int& a, int& c) {
  const int t = e & 7;
  a = t + 8 * ((e >> 3) & 3);
  c = t ^ (e >> 5);
}

// the converter's jobs of a raw stage into registers
template <bool kAmn, bool kBmn>
__device__ __forceinline__ void sddmm_read_stage(const unsigned char* raw, float4 (&v)[2][kJobsPer][4], int tid) {
  constexpr int kTile = SdLayout<float>::kTile;
#pragma unroll
  for (int op = 0; op < 2; ++op) {
    const float4* src = reinterpret_cast<const float4*>(raw + op * kTile);
#pragma unroll
    for (int i = 0; i < kJobsPer; ++i) {
      const int e = tid + i * kSdConverters;
      int a, c;
      sddmm_job(e, a, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[op][i][j] = (op == 0 ? kAmn : kBmn) ? src[(4 * c + j) * (BM / 4) + a] : src[e + j * kJobs];
    }
  }
}

// the 3xTF32 split of the converter's jobs, hi and lo written K-major and
// 128-byte swizzled (16-byte chunk c of row r at r * 128 + 16 (c ^ r % 8))
// into a conv stage: lhs hi, rhs hi, lhs lo, rhs lo
template <bool kAmn, bool kBmn>
__device__ __forceinline__ void sddmm_write_stage(const float4 (&v)[2][kJobsPer][4], unsigned char* conv, int tid) {
  constexpr int kTile = SdLayout<float>::kTile;
#pragma unroll
  for (int op = 0; op < 2; ++op) {
    float4* hi = reinterpret_cast<float4*>(conv + op * kTile);
    float4* lo = reinterpret_cast<float4*>(conv + (2 + op) * kTile);
#pragma unroll
    for (int i = 0; i < kJobsPer; ++i) {
      const int e = tid + i * kSdConverters;
      const float4(&w)[4] = v[op][i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 x = w[j];
        int q = e + j * kJobs;
        if (op == 0 ? kAmn : kBmn) {  // row 4a + j of the block: element j of each k-row's float4
          int a, c;
          sddmm_job(e, a, c);
          x = j == 0   ? make_float4(w[0].x, w[1].x, w[2].x, w[3].x)
              : j == 1 ? make_float4(w[0].y, w[1].y, w[2].y, w[3].y)
              : j == 2 ? make_float4(w[0].z, w[1].z, w[2].z, w[3].z)
                       : make_float4(w[0].w, w[1].w, w[2].w, w[3].w);
          const int r = 4 * a + j;
          q = r * (kRowBytes / 16) + (c ^ (r & 7));
        }
        float4 h, l;
        split4(x, h, l);
        hi[q] = h;
        lo[q] = l;
      }
    }
  }
}

// lhs element (m, k) and rhs element (k, n) as the TMA maps give them: kAmn /
// kBmn for an MN-major operand, else K-major
template <typename T, bool kAmn, bool kBmn>
__global__ void __launch_bounds__(kThreads, 1)
    bsr_sddmm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                        const int* __restrict__ block_rows, const int* __restrict__ block_cols, long long n_units,
                        int m_tiles, int n_tiles, long long bm, long long bn, long long M, long long K, int n_k,
                        T* __restrict__ out) {
  using L = SdLayout<T>;
  constexpr int SR = SdCfg<T>::kRaw, SC = SdCfg<T>::kConv;
  constexpr bool kSplit = SC > 0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* raw = smem;
  unsigned char* conv = smem + SR * L::kRawBytes;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(conv + SC * L::kConvBytes);
  uint64_t* raw_empty = raw_full + SR;
  uint64_t* conv_full = raw_empty + SR;
  uint64_t* conv_empty = conv_full + SC;

  // unit u is tile u % tiles (n-tiles fastest) of stored block u / tiles;
  // false for a zero tile
  const int tiles = m_tiles * n_tiles;
  long long j, row0, col0;
  int mt, nt;
  auto unit = [&](long long u) {
    j = u / tiles;
    mt = (int)(u % tiles) / n_tiles;
    nt = (int)(u % tiles) % n_tiles;
    const long long r = block_rows[j], c = block_cols[j];
    row0 = r * bm + (long long)mt * BM;
    col0 = c * bn + (long long)nt * BN;
    return r >= 0 && c >= 0 && row0 < M && col0 < K;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < SR; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], kSplit ? kSdConverters : 8);  // converters, or lane 0 of each consumer warp
    }
    for (int s = 0; s < SC; ++s) {
      mbar_init(&conv_full[s], kSdConverters);
      mbar_init(&conv_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  uint32_t it = 0;  // stages so far, over all of this CTA's units
  if (wg == 0) {
    // the TMA loads, through a cursor over this CTA's stages: stage `issued`
    // goes into raw slot issued % SR once that slot's last stage is free
    uint32_t issued = 0;
    long long pu = blockIdx.x;
    int pks = 0, pr0 = 0, pc0 = 0;
    bool pending = false;
    auto seek = [&](long long from) {
      for (pu = from; pu < n_units; pu += gridDim.x)
        if (unit(pu)) {
          pr0 = (int)row0;
          pc0 = (int)col0;
          return true;
        }
      return false;
    };
    auto issue = [&]() {
      const int s = (int)(issued % SR);
      mbar_wait(&raw_empty[s], ((issued / SR) & 1) ^ 1);
      unsigned char* st = raw + s * L::kRawBytes;
      mbar_expect_tx(&raw_full[s], L::kRawBytes);
      sddmm_load<T, kAmn>(st, &map_a, &raw_full[s], pr0, pks * L::kBke);
      sddmm_load<T, kBmn>(st + L::kTile, &map_b, &raw_full[s], pc0, pks * L::kBke);
      ++issued;
      if (++pks == n_k) {
        pks = 0;
        pending = seek(pu + gridDim.x);
      }
    };
    if (threadIdx.x == 0) pending = seek(blockIdx.x);
    if constexpr (!kSplit) {
      if (threadIdx.x == 0)
        while (pending) issue();
    } else {
      // float32: all four warps transpose and split; thread 0 issues each
      // stage's loads SR - 1 stages ahead of the one it converts
      if (threadIdx.x == 0)
        for (int i = 0; i < SR - 1 && pending; ++i) issue();
      for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
        if (!unit(u)) continue;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          if (threadIdx.x == 0 && pending) issue();
          const int sr = (int)(it % SR), sc = (int)(it % SC);
          float4 v[2][kJobsPer][4];
          mbar_wait(&raw_full[sr], (it / SR) & 1);
          sddmm_read_stage<kAmn, kBmn>(raw + sr * L::kRawBytes, v, threadIdx.x);
          // the reads are done before the next TMA load overwrites the slot
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(&raw_empty[sr]);
          mbar_wait(&conv_empty[sc], ((it / SC) & 1) ^ 1);
          sddmm_write_stage<kAmn, kBmn>(v, conv + sc * L::kConvBytes, threadIdx.x);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
          mbar_arrive(&conv_full[sc]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c = wg - 1 owns rows [64 c, 64 c + 64) of the tile
  const int c = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int w = t / 32, lane = t % 32;
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  fence_acc(d);
  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const bool live = unit(u);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int ks = 0; live && ks < n_k; ++ks, ++it) {
      unsigned char* a;  // this stage's lhs tile (hi for float32); rhs follows it
      uint64_t* release;
      if constexpr (kSplit) {
        const int s = (int)(it % SC);
        mbar_wait(&conv_full[s], (it / SC) & 1);
        a = conv + s * L::kConvBytes;
        release = &conv_empty[s];
      } else {
        const int s = (int)(it % SR);
        mbar_wait(&raw_full[s], (it / SR) & 1);
        a = raw + s * L::kRawBytes;
        release = &raw_empty[s];
      }
      unsigned char* b = a + L::kTile;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < L::kBke / SdCfg<T>::kStep; ++k) {
        if constexpr (kSplit) {
          unsigned char* ac = a + c * 64 * kRowBytes + k * 32;
          Mma<float>::run(d, desc_of(ac + 2 * L::kTile), desc_of(b + k * 32));  // lo * hi
          Mma<float>::run(d, desc_of(ac), desc_of(b + 2 * L::kTile + k * 32));  // hi * lo
          Mma<float>::run(d, desc_of(ac), desc_of(b + k * 32));                 // hi * hi
        } else {
          // an MN-major k-step of 16 is two 8-k-row groups: 2048 bytes
          const uint64_t da = kAmn ? desc_mn(a + c * (L::kTile / 2) + k * 2048) : desc_of(a + c * 64 * kRowBytes + k * 32);
          const uint64_t db = kBmn ? desc_mn(b + k * 2048) : desc_of(b + k * 32);
          Mma<T, kAmn, kBmn>::run(d, da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();  // release the stage as soon as its products are done
      if (lane == 0) mbar_arrive(release);
      if ((ks + 1) % L::kPromote == 0 || ks + 1 == n_k) {  // IEEE-add the tensor core's sum
        fence_acc(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          acc[i] += d[i];
          d[i] = 0.0f;
        }
        fence_acc(d);
      }
    }
    // the accumulator layout of wgmma m64nN: register 4 q + e holds row
    // 16 w + lane / 4 + 8 (e / 2), column 8 q + 2 (lane % 4) + e % 2
    const long long rb0 = (long long)mt * BM + c * 64 + w * 16 + lane / 4;
    const long long cb0 = (long long)nt * BN + 2 * (lane % 4);
    T* o = out + j * bm * bn;
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long rb = rb0 + 8 * (e / 2), cb = cb0 + 8 * q + (e % 2);
        if (rb < bm && cb < bn) store_out(o + rb * bn + cb, acc[q * 4 + e]);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status) !=
        cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) != cudaSuccess)
      return nullptr;
#endif
    if (status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType map_dtype() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// error codes of the C entry points beyond CUDA's own
constexpr int kErrNoEncoder = 100001;
constexpr int kErrEncode = 100002;

template <typename T>
int launch(const void* blocks, long long n_blocks, long long bs0, long long bs1, const void* block_cols,
           const void* row_ptr, const void* pieces, long long n_block_rows, long long n_front, long long piece,
           long long bm, long long bn, const void* dense, long long K, long long N, long long ld, void* out,
           long long n_rows, void* partial, void* tickets, void* stream) {
  using L = Layout<T>;
  const long long m_tiles = (bm + BM - 1) / BM;
  const long long n_tiles = (N + BN - 1) / BN;
  if (n_block_rows == 0 || n_rows == 0 || N == 0) return 0;
  const long long ctas = (n_front + n_block_rows) * m_tiles * n_tiles;
  if (n_blocks <= 0 || K <= 0 || bn % L::kBke != 0 || piece <= 0 || ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t esz = sizeof(T);
  CUtensorMap map_a, map_b;
  {  // blocks as (n_blocks, bm, bn), k fastest
    const cuuint64_t dims[3] = {(cuuint64_t)bn, (cuuint64_t)bm, (cuuint64_t)n_blocks};
    const cuuint64_t strides[2] = {(cuuint64_t)bs1 * esz, (cuuint64_t)bs0 * esz};
    const cuuint32_t box[3] = {(cuuint32_t)L::kBke, (cuuint32_t)BM, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (encode(&map_a, map_dtype<T>(), 3, const_cast<void*>(blocks), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrEncode;
  }
  {  // dense as (N, K), k fastest
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * esz};
    const cuuint32_t box[2] = {(cuuint32_t)L::kBke, (cuuint32_t)BN};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&map_b, map_dtype<T>(), 2, const_cast<void*>(dense), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrEncode;
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(bsr_spmm_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  bsr_spmm_tc_kernel<T><<<(unsigned)ctas, kThreads, L::kSmem, (cudaStream_t)stream>>>(
      map_a, map_b, (const int*)block_cols, (const long long*)row_ptr, (const long long*)pieces, n_block_rows,
      n_front, piece, bm, bn, N, (T*)out, n_rows, (float*)partial, (int*)tickets, (int)m_tiles, (int)n_tiles);
  return (int)cudaGetLastError();
}

// the TMA map of one SDDMM operand of `rows` MN values and `depth` k
// values: K-major (element (r, k) at p[k + r * ld]) in boxes of kBke k x 128
// rows, 128-byte swizzled; MN-major (element (r, k) at p[r + k * ld]) in
// boxes of 128 rows x kBke k, unswizzled for float32 (the converters
// transpose it), of 64 rows x kBke k, 128-byte swizzled for bfloat16 (the
// layout the wgmma transpose bit reads)
template <typename T>
int sddmm_map(CUtensorMap* map, EncodeTiled encode, const void* p, long long rows, long long depth, long long ld,
              bool mn) {
  using L = SdLayout<T>;
  const bool swizzle = !mn || sizeof(T) == 2;
  const cuuint64_t dims[2] = {(cuuint64_t)(mn ? rows : depth), (cuuint64_t)(mn ? depth : rows)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(!mn ? L::kBke : sizeof(T) == 4 ? BM : BM / 2),
                             (cuuint32_t)(!mn ? BM : L::kBke)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, map_dtype<T>(), 2, const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : kErrEncode;
}

template <typename T, bool kAmn, bool kBmn>
int launch_sddmm(const CUtensorMap& map_a, const CUtensorMap& map_b, const void* block_rows, const void* block_cols,
                 long long n_units, int m_tiles, int n_tiles, long long bm, long long bn, long long M, long long K,
                 int n_k, void* out, int ctas, void* stream) {
  using L = SdLayout<T>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(bsr_sddmm_tc_kernel<T, kAmn, kBmn>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  bsr_sddmm_tc_kernel<T, kAmn, kBmn><<<ctas, kThreads, L::kSmem, (cudaStream_t)stream>>>(
      map_a, map_b, (const int*)block_rows, (const int*)block_cols, n_units, m_tiles, n_tiles, bm, bn, M, K, n_k,
      (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int sddmm(const void* block_rows, const void* block_cols, long long n_blocks, long long bm, long long bn,
          const void* lhs, long long M, long long B, long long lda, long long a_mn, const void* rhs, long long K,
          long long ldb, long long b_mn, void* out, long long n_sms, void* stream) {
  using L = SdLayout<T>;
  if (n_blocks == 0 || bm == 0 || bn == 0) return 0;
  const long long m_tiles = (bm + BM - 1) / BM, n_tiles = (bn + BN - 1) / BN;
  const long long kMaxCoord = 0x7fffffffLL - 2 * BM;  // TMA coordinates are int32
  if (n_blocks < 0 || bm < 0 || bn < 0 || M <= 0 || K <= 0 || B <= 0 || n_sms <= 0 || M > kMaxCoord ||
      K > kMaxCoord || B > kMaxCoord || m_tiles * n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap map_a, map_b;
  if (sddmm_map<T>(&map_a, encode, lhs, M, B, lda, a_mn != 0) || sddmm_map<T>(&map_b, encode, rhs, K, B, ldb, b_mn != 0))
    return kErrEncode;
  const long long n_units = n_blocks * m_tiles * n_tiles;
  const int ctas = (int)(n_units < n_sms ? n_units : n_sms);
  const int n_k = (int)((B + L::kBke - 1) / L::kBke);
  const auto go = [&](auto launcher) {
    return launcher(map_a, map_b, block_rows, block_cols, n_units, (int)m_tiles, (int)n_tiles, bm, bn, M, K, n_k, out,
                    ctas, stream);
  };
  if (a_mn && b_mn) return go(launch_sddmm<T, true, true>);
  if (a_mn) return go(launch_sddmm<T, true, false>);
  if (b_mn) return go(launch_sddmm<T, false, true>);
  return go(launch_sddmm<T, false, false>);
}

}  // namespace

extern "C" {

#define ST_BSR_TC_ENTRY_POINT(SUFFIX, T)                                                                         \
  int st_bsr_spmm_tc_##SUFFIX(const void* blocks, long long n_blocks, long long bs0, long long bs1,              \
                              const void* block_cols, const void* row_ptr, const void* pieces,                   \
                              long long n_block_rows, long long n_front, long long piece, long long bm,           \
                              long long bn, const void* dense, long long k, long long n, long long ld, void* out, \
                              long long n_rows, void* partial, void* tickets, void* stream) {                     \
    return launch<T>(blocks, n_blocks, bs0, bs1, block_cols, row_ptr, pieces, n_block_rows, n_front, piece, bm,  \
                     bn, dense, k, n, ld, out, n_rows, partial, tickets, stream);                                \
  }

#define ST_BSR_SDDMM_TC_ENTRY_POINT(SUFFIX, T)                                                                  \
  int st_bsr_sddmm_tc_##SUFFIX(const void* block_rows, const void* block_cols, long long n_blocks, long long bm,   \
                               long long bn, const void* lhs, long long m, long long b, long long lda,             \
                               long long a_mn, const void* rhs, long long k, long long ldb, long long b_mn,         \
                               void* out, long long n_sms, void* stream) {                                         \
    return sddmm<T>(block_rows, block_cols, n_blocks, bm, bn, lhs, m, b, lda, a_mn, rhs, k, ldb, b_mn, out, n_sms, \
                    stream);                                                                                       \
  }

ST_BSR_TC_ENTRY_POINT(f32, float)
ST_BSR_TC_ENTRY_POINT(bf16, __nv_bfloat16)
ST_BSR_SDDMM_TC_ENTRY_POINT(f32, float)
ST_BSR_SDDMM_TC_ENTRY_POINT(bf16, __nv_bfloat16)

#undef ST_BSR_TC_ENTRY_POINT
#undef ST_BSR_SDDMM_TC_ENTRY_POINT

}  // extern "C"
