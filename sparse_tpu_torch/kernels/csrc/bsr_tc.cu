// Block-sparse (BSR) SpMM on Hopper's tensor cores (sm_90a), float32 as
// 3xTF32 and bfloat16, plain C interface for ctypes. Built by
// sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// The TMA tensor maps are encoded by cuTensorMapEncodeTiled, looked up
// through the CUDA runtime (cudaGetDriverEntryPoint), so the build needs no
// -lcuda.
//
//   out[r-block, :] = sum over block-row r's run of blocks[j] @ dense[cols[j]-block, :]
//
// Replaces sparse_tpu/kernels/bsr.py:_spmm_kernel (P2, behind
// bsr_spmm_pallas) for float32 and bfloat16; it replaces csrc/bsr.cu's
// bsr_spmm_kernel<T, 1> (FFMA tiling on the CUDA cores), which keeps float64
// and the two-block form (P3). The layer's forward and dgrad run here.
//
// Bound on this card at the layer's full width (8192 x 8192, 25 % of the
// 128 x 128 blocks, 1,042 stored blocks, batch 512): operations. Each
// product does 2 * 1042 * 128 * 128 * 512 = 17.48 GFLOP on about 103 MB. In
// float32 the reference's Precision.HIGHEST rules out one TF32 pass, so each
// product is three tensor-core passes, 3 * 17.48 GFLOP / 495 TFLOP/s =
// 0.106 ms (the bytes give 0.031 ms); bfloat16 is one pass at 989 TFLOP/s.
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

// d (64 x 128, f32, accumulated) += A (64 x k) * B (k x 128), both K-major in shared memory
template <typename T>
struct Mma;
template <>
struct Mma<float> {
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
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ST_WGMMA_REGS "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : ST_WGMMA_ACC
        : "l"(a), "l"(b), "r"(1));
  }
};

// x rounded to tf32 (nearest, ties away from zero, as cvt.rna.tf32.f32) by
// integer ops: half a tf32 ulp added to the magnitude, the 13 low bits dropped
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// one stage split in place: the 2 * BM rows of A and B become hi, and their
// lo parts go to the two buffers after them
__device__ __forceinline__ void split_stage(unsigned char* stage, int tid) {
  constexpr int kVec = 2 * BM * kRowBytes / 16;  // float4s of A and B
  float4* hi = reinterpret_cast<float4*>(stage);
  float4* lo = reinterpret_cast<float4*>(stage + 2 * BM * kRowBytes);
  for (int e = tid; e < kVec; e += kConverters) {
    const float4 x = hi[e];
    float4 h, l;
    h.x = tf32_round(x.x);
    h.y = tf32_round(x.y);
    h.z = tf32_round(x.z);
    h.w = tf32_round(x.w);
    // an infinite hi keeps lo = 0 (x - hi would be NaN)
    l.x = fabsf(h.x) < INFINITY ? tf32_round(x.x - h.x) : 0.0f;
    l.y = fabsf(h.y) < INFINITY ? tf32_round(x.y - h.y) : 0.0f;
    l.z = fabsf(h.z) < INFINITY ? tf32_round(x.z - h.z) : 0.0f;
    l.w = fabsf(h.w) < INFINITY ? tf32_round(x.w - h.w) : 0.0f;
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

ST_BSR_TC_ENTRY_POINT(f32, float)
ST_BSR_TC_ENTRY_POINT(bf16, __nv_bfloat16)

#undef ST_BSR_TC_ENTRY_POINT

}  // extern "C"
