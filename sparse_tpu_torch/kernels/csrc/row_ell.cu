// Row-ELL SpMV (K1) and SpMM (K2) for Hopper (sm_90a), plain C interface
// for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Layout (sparse_tpu_torch/kernels/row_ell.py:build_row_ell): rows are
// relabelled by descending degree into "padded positions" and cut into
// tiers. Tier t holds positions [pos0, pos0 + rows) and stores its entries
// at flat offset `offset` either grouped, shape (rows/G, width, G), or
// legacy, shape (rows, width), which is the grouped form with G = 1. So the
// j-th entry of position p sits at
//     offset + ((p - pos0) / G) * width * G + (p - pos0) % G + j * G.
// The tier table is int64 (n_tiers, 4): pos0, width, G, offset. Its last
// tier is the block of rows without entries (width 0). row_of_pos maps a
// position to its original row, or -1 for group padding, so the unpermute
// is fused into the store and every output row is written exactly once:
// outputs need no memset.
//
// K1 has two kernels (one thread per position; x in a thread-block
// cluster's shared memory), K2 two (one warp per position; staged indices).
// Every kernel accumulates in the data type (f32 for f32, f64 for f64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Tier {
  long long pos0, width, group, offset;
};

// The tier holding position p: the last one whose first position is <= p.
// At most a few dozen tiers, so a binary search over the table (L1-resident).
__device__ __forceinline__ Tier find_tier(const long long* __restrict__ table, int n_tiers, long long p) {
  int lo = 0, hi = n_tiers - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[4 * mid] <= p) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* t = table + 4 * lo;
  return Tier{t[0], t[1], t[2], t[3]};
}

__device__ __forceinline__ long long first_entry(const Tier& t, long long p) {
  const long long q = p - t.pos0;
  return t.offset + (q / t.group) * t.width * t.group + (q % t.group);
}

// K1: out[row(p)] = (y ? y[row(p)] : 0) + sum_j data[p, j] * x[cols[p, j]].
//
// Replaces sparse_tpu/kernels/row_ell.py:_onehot_products_call (the Pallas
// one-hot MXU pick of x from a bf16 hi|lo table in VMEM, behind
// _spmv_onehot) and the exact XLA _spmv with its lane-select unpermute. The
// one-hot pick and the hi|lo split work around the TPU's gather rate; here
// each thread reads x[cols[e]] directly, through L1/L2 (x is K * 4 bytes,
// L2-resident at any K the layout allows), so the product is exact.
//
// Bound on this card: bytes. Each entry moves 4 (col) + sizeof(T) (value)
// bytes plus a sizeof(T) gather of x, with two flops per entry. Design: one
// thread per padded position; the 16 threads of a group read 16 consecutive
// cols/data words for each j, so the index and value streams coalesce as
// stored. All tiers run in one launch (the tier is found per thread), and
// the optional y makes A @ x + y one pass. The gathers of x go through L1
// and L2 one 4- or 8-byte request each, which bounds this kernel at the
// benchmark shape (the cluster form below takes them into shared memory).
template <typename T>
__global__ void __launch_bounds__(256) row_ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ data,
                                                           const T* __restrict__ x, const T* __restrict__ y,
                                                           T* __restrict__ out, const long long* __restrict__ table,
                                                           int n_tiers, const int* __restrict__ row_of_pos,
                                                           long long n_pos) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pos) return;
  const int row = row_of_pos[p];
  if (row < 0) return;  // group padding: no output row
  const Tier t = find_tier(table, n_tiers, p);
  const long long base = first_entry(t, p);
  T acc = T(0);
#pragma unroll 4
  for (long long j = 0; j < t.width; ++j) {
    const long long e = base + j * t.group;
    acc += data[e] * x[cols[e]];
  }
  out[row] = (y != nullptr ? y[row] : T(0)) + acc;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// K2: out[row(p), c] = sum_j data[p, j] * B[cols[p, j], c].
//
// Replaces the XLA gather-multiply-reduce _spmm of
// sparse_tpu/kernels/row_ell.py (no Pallas kernel there). In eager PyTorch
// that form would write the whole gathered (r/G, w, G, N) block to memory;
// here it never leaves registers. The TPU's w-split (SPMM_WSPLIT) is not
// carried over: it only changed the rounding order of the sum over j.
//
// Bound on this card: bytes (B read, out written, cols/data streamed; two
// flops per entry and column is far under the f32 rate). B fits in the 50 MB
// L2 at the main path's shape, so gathers after the first touch of a row hit
// L2. Design: one warp per (position, column tile); each lane holds VEC
// consecutive values (float4 / double2, 16 bytes), so each gathered row
// segment of B is one coalesced 512-byte read, the sum stays in registers
// and the unpermuted output row is stored once. The col/data words are warp
// broadcasts. Offsets into B and out are 64-bit. VEC = 1 serves a ragged N
// or a B not 16-byte aligned.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) row_ell_spmm_kernel(const int* __restrict__ cols, const T* __restrict__ data,
                                                           const T* __restrict__ B, long long ldb, T* __restrict__ out,
                                                           long long n, const long long* __restrict__ table,
                                                           int n_tiers, const int* __restrict__ row_of_pos,
                                                           long long n_pos) {
  const long long p = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= n_pos) return;
  const int row = row_of_pos[p];
  if (row < 0) return;
  const long long c0 = ((long long)blockIdx.y * 32 + (threadIdx.x & 31)) * VEC;
  if (c0 >= n) return;  // ragged last column tile (VEC > 1 only with n % VEC == 0)
  const Tier t = find_tier(table, n_tiers, p);
  const long long base = first_entry(t, p);
  T acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
#pragma unroll 4
  for (long long j = 0; j < t.width; ++j) {
    const long long e = base + j * t.group;
    const T d = data[e];
    const Pack<T, VEC> b = *reinterpret_cast<const Pack<T, VEC>*>(B + (long long)cols[e] * ldb + c0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += d * b.v[v];
  }
  Pack<T, VEC> o;
#pragma unroll
  for (int v = 0; v < VEC; ++v) o.v[v] = acc[v];
  *reinterpret_cast<Pack<T, VEC>*>(out + (long long)row * n + c0) = o;
}

// ---------------------------------------------------------------------------
// K2, staged form, for grouped layouts with G = 16 (build_row_ell's default,
// the main path's layout). The kernel above stays for legacy (G = 1) and
// other group sizes, for B rows read one value a lane, and as the reference
// the tests and the ablation hold this one against.
//
// Bound: bytes, as above; but at the benchmark shape it must pull 1.07 GB
// of B rows from L2 into the SMs, which at the card's whole-row L2 rate
// takes about six times the HBM bound. What held the kernel above back: each warp first searched the tier table,
// then every j needed its cols word before its B row (two dependent loads,
// at most four rows in flight), the launch ran in about eight ragged waves,
// and output and index lines could evict B's lines from L2. Design:
// - Work unit: one group of kGroup positions x one column tile of 32 * VEC
//   columns; a CTA has kGroup warps, one per position. The grid is
//   persistent (resident CTAs on every SM) and deals the units in position
//   order, u = blockIdx.x + k * gridDim.x: the layout is degree-sorted, so
//   the widest units start first and the narrowest finish the tail.
// - One thread decodes a unit's tier from the tier table in shared memory
//   (a cursor that only moves forward) and stages the unit's index block,
//   contiguous within its tier (w * G words of cols, w * G values of data,
//   and the G entries of row_of_pos), with asynchronous bulk copies into a
//   ring of kStages stages, counted on an mbarrier (complete_tx). Rows wider
//   than kStageJ entries take one stage per chunk of kStageJ. So the next
//   chunk's indices land while this one gathers. The thread that stages a
//   chunk is the last warp to finish the chunk that used the stage before
//   (a shared counter): no warp waits to free a stage.
// - Each warp reads its position's (col, value) pairs from the stage (all
//   lanes read one word: a broadcast) and issues kDepth B-row loads (16
//   bytes a lane) back to back before their FMAs, which it adds in j order
//   exactly as the kernel above does: the outputs are equal bit for bit.
//   kDepth = 4 measured best of 2-16 on an H100: with two CTAs an SM that
//   is 64 KB in flight, and 8 only costs registers.
// - L2 priority (kHints, off): B gathers under an evict_last policy
//   (fraction ROW_ELL_B_FRACTION of the lines), index copies evict_first,
//   the output row stored streaming (st.global.cs). On an H100 at the
//   benchmark shape this gained nothing in float32 and cost 4 % in float64,
//   whose 67 MB of B overflow L2, so the entry points launch it without.
// - Group padding (row < 0) gathers nothing; the positions of rows without
//   entries (the last tier, width 0) are stored as zeros by a strided loop;
//   every output row is written exactly once, without atomics.
// kStage and kHints exist for the ablation (chip_row_ell_ablation.py builds
// other values of the ROW_ELL_* macros, also of the depth and of the CTAs
// each SM must hold); the entry points launch one form.

#ifndef ROW_ELL_STAGE
#define ROW_ELL_STAGE 1
#endif
#ifndef ROW_ELL_HINTS
#define ROW_ELL_HINTS 0
#endif
#ifndef ROW_ELL_B_FRACTION
#define ROW_ELL_B_FRACTION 1.0f
#endif
#ifndef ROW_ELL_DEPTH
#define ROW_ELL_DEPTH 4
#endif
#ifndef ROW_ELL_MIN_BLOCKS
#define ROW_ELL_MIN_BLOCKS 2
#endif

constexpr int kGroup = 16;   // positions per unit: warps per CTA
constexpr int kStageJ = 64;  // entries of a position per stage
constexpr int kStages = 2;
constexpr int kDepth = ROW_ELL_DEPTH;  // B-row loads in flight per warp

template <typename T>
struct Stage {
  static constexpr int kCols = kStageJ * kGroup * 4;
  static constexpr int kData = kStageJ * kGroup * (int)sizeof(T);
  static constexpr int kRows = kGroup * 4;
  static constexpr int kBytes = kCols + kData + kRows;  // a multiple of 16
};

struct GTier {
  long long g0, width, offset;  // first group, width, flat offset
};

struct Chunk {
  long long block;  // flat offset of entry (j0, position 0) of the unit's group
  int p0;           // first position of the group
  int ct;           // column tile
  int width;        // the unit's width; 0: no chunk is left
  int j0, jn;       // the chunk's entries [j0, j0 + jn)
};

struct Producer {
  long long u;  // next unit
  int j0;       // its next chunk's first entry
  int tier;     // cursor into the tier table
  unsigned c;   // chunks staged so far
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

template <bool kHints>
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar, uint64_t policy) {
  if constexpr (kHints) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::
            "r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
        : "memory");
  } else {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(bytes), "r"(smem_u32(bar))
                 : "memory");
  }
}

__device__ __forceinline__ uint64_t policy_evict_last(float fraction) {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, %1;\n" : "=l"(p) : "f"(fraction));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, %1;\n" : "=l"(p) : "f"(1.0f));
  return p;
}

// 16-byte (or one-value) loads of B under an L2 policy, and streaming stores
template <typename T, int VEC>
struct Io;
template <>
struct Io<float, 4> {
  static __device__ __forceinline__ Pack<float, 4> load(const float* p, uint64_t pol) {
    Pack<float, 4> r;
    asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
                 : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
                 : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ void store(float* p, const Pack<float, 4>& o) {
    asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(o.v[0]), "f"(o.v[1]), "f"(o.v[2]),
                 "f"(o.v[3])
                 : "memory");
  }
};
template <>
struct Io<float, 1> {
  static __device__ __forceinline__ Pack<float, 1> load(const float* p, uint64_t pol) {
    Pack<float, 1> r;
    asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n" : "=f"(r.v[0]) : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ void store(float* p, const Pack<float, 1>& o) {
    asm volatile("st.global.cs.f32 [%0], %1;\n" ::"l"(p), "f"(o.v[0]) : "memory");
  }
};
template <>
struct Io<double, 2> {
  static __device__ __forceinline__ Pack<double, 2> load(const double* p, uint64_t pol) {
    Pack<double, 2> r;
    asm volatile("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;\n"
                 : "=d"(r.v[0]), "=d"(r.v[1])
                 : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ void store(double* p, const Pack<double, 2>& o) {
    asm volatile("st.global.cs.v2.f64 [%0], {%1, %2};\n" ::"l"(p), "d"(o.v[0]), "d"(o.v[1]) : "memory");
  }
};
template <>
struct Io<double, 1> {
  static __device__ __forceinline__ Pack<double, 1> load(const double* p, uint64_t pol) {
    Pack<double, 1> r;
    asm volatile("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;\n" : "=d"(r.v[0]) : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ void store(double* p, const Pack<double, 1>& o) {
    asm volatile("st.global.cs.f64 [%0], %1;\n" ::"l"(p), "d"(o.v[0]) : "memory");
  }
};

// Stage the CTA's next chunk (one thread): decode its unit, write its Chunk,
// and start its copies (kStage) or only publish it. Past the last unit it
// publishes a chunk of width 0, which ends every warp's loop.
template <typename T, bool kStage, bool kHints>
__device__ void stage_next(Producer& pr, Chunk* chunks, uint64_t* full, unsigned char* ring, const GTier* tiers,
                           int n_grouped, const int* cols, const T* data, const int* row_of_pos, long long n_units,
                           int n_ct, uint64_t policy) {
  const int s = (int)(pr.c % kStages);
  ++pr.c;
  Chunk& ch = chunks[s];
  if (pr.u >= n_units) {
    ch.width = 0;
    mbar_arrive(&full[s]);
    return;
  }
  const long long g = pr.u / n_ct;
  while (pr.tier + 1 < n_grouped && tiers[pr.tier + 1].g0 <= g) ++pr.tier;
  const GTier t = tiers[pr.tier];
  const int w = (int)t.width;
  const int jn = min(kStageJ, w - pr.j0);
  const long long block = t.offset + (g - t.g0) * t.width * kGroup + (long long)pr.j0 * kGroup;
  ch.block = block;
  ch.p0 = (int)(g * kGroup);
  ch.ct = (int)(pr.u % n_ct);
  ch.width = w;
  ch.j0 = pr.j0;
  ch.jn = jn;
  if constexpr (kStage) {
    unsigned char* st = ring + s * Stage<T>::kBytes;
    const uint32_t cb = (uint32_t)jn * kGroup * 4, db = (uint32_t)jn * kGroup * (uint32_t)sizeof(T);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the warps' reads of this stage came first
    mbar_expect_tx(&full[s], cb + db + Stage<T>::kRows);
    bulk_load<kHints>(st, cols + block, cb, &full[s], policy);
    bulk_load<kHints>(st + Stage<T>::kCols, data + block, db, &full[s], policy);
    bulk_load<kHints>(st + Stage<T>::kCols + Stage<T>::kData, row_of_pos + g * kGroup, Stage<T>::kRows, &full[s],
                      policy);
  } else {
    mbar_arrive(&full[s]);
  }
  pr.j0 += jn;
  if (pr.j0 >= w) {
    pr.j0 = 0;
    pr.u += gridDim.x;
  }
}

template <typename T, int VEC, bool kStage, bool kHints>
__global__ void __launch_bounds__(kGroup * 32, ROW_ELL_MIN_BLOCKS)
    row_ell_spmm_staged_kernel(const int* __restrict__ cols, const T* __restrict__ data, const T* __restrict__ B,
                               long long ldb, T* __restrict__ out, long long n, const long long* __restrict__ table,
                               int n_tiers, const int* __restrict__ row_of_pos, long long n_pos, long long n_groups,
                               int n_ct) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ Chunk chunks[kStages];
  __shared__ int finished[kStages];
  __shared__ Producer pr;
  unsigned char* ring = smem;
  GTier* tiers = reinterpret_cast<GTier*>(smem + (kStage ? kStages * Stage<T>::kBytes : 0));
  const int n_grouped = n_tiers - 1;  // the last tier holds the rows without entries
  const long long n_units = n_groups * n_ct;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int t = threadIdx.x; t < n_grouped; t += blockDim.x) {
    tiers[t] = GTier{table[4 * t] / kGroup, table[4 * t + 1], table[4 * t + 3]};
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      finished[s] = 0;
    }
    pr = Producer{(long long)blockIdx.x, 0, 0, 0u};
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint64_t pol_b = 0, pol_idx = 0;
  if constexpr (kHints) {
    pol_b = policy_evict_last(ROW_ELL_B_FRACTION);
    pol_idx = policy_evict_first();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      stage_next<T, kStage, kHints>(pr, chunks, full, ring, tiers, n_grouped, cols, data, row_of_pos, n_units, n_ct,
                                    pol_idx);
    }
  }

  // the rows without entries: zeros, one warp per (position, column tile)
  const long long zero0 = n_groups * kGroup;
  const long long n_zero = (n_pos - zero0) * n_ct;
  for (long long task = (long long)blockIdx.x * kGroup + warp; task < n_zero; task += (long long)gridDim.x * kGroup) {
    const int row = row_of_pos[zero0 + task / n_ct];
    const long long c0 = ((task % n_ct) * 32 + lane) * VEC;
    if (row >= 0 && c0 < n) {
      Pack<T, VEC> o;
#pragma unroll
      for (int v = 0; v < VEC; ++v) o.v[v] = T(0);
      *reinterpret_cast<Pack<T, VEC>*>(out + (long long)row * n + c0) = o;
    }
  }

  T acc[VEC];
  int row = -1;
  long long c0 = 0;
  bool active = false;
  for (uint32_t c = 0;; ++c) {
    const int s = (int)(c % kStages);
    mbar_wait(&full[s], (c / kStages) & 1);
    const Chunk ch = chunks[s];
    if (ch.width == 0) break;
    const unsigned char* st = ring + s * Stage<T>::kBytes;
    const int* cs;
    const T* ds;
    if constexpr (kStage) {
      cs = reinterpret_cast<const int*>(st) + warp;
      ds = reinterpret_cast<const T*>(st + Stage<T>::kCols) + warp;
    } else {
      cs = cols + ch.block + warp;
      ds = data + ch.block + warp;
    }
    if (ch.j0 == 0) {
      if constexpr (kStage) {
        row = reinterpret_cast<const int*>(st + Stage<T>::kCols + Stage<T>::kData)[warp];
      } else {
        row = row_of_pos[ch.p0 + warp];
      }
      c0 = ((long long)ch.ct * 32 + lane) * VEC;
      active = row >= 0 && c0 < n;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = T(0);
    }
    if (active) {
      for (int j = 0; j < ch.jn; j += kDepth) {
        const int left = ch.jn - j;
        Pack<T, VEC> b[kDepth];
#pragma unroll
        for (int i = 0; i < kDepth; ++i) {
          if (i < left) {
            const T* src = B + (long long)cs[(j + i) * kGroup] * ldb + c0;
            if constexpr (kHints) {
              b[i] = Io<T, VEC>::load(src, pol_b);
            } else {
              b[i] = *reinterpret_cast<const Pack<T, VEC>*>(src);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kDepth; ++i) {
          if (i < left) {
            const T d = ds[(j + i) * kGroup];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] += d * b[i].v[v];
          }
        }
      }
      if (ch.j0 + ch.jn == ch.width) {
        Pack<T, VEC> o;
#pragma unroll
        for (int v = 0; v < VEC; ++v) o.v[v] = acc[v];
        T* dst = out + (long long)row * n + c0;
        if constexpr (kHints) {
          Io<T, VEC>::store(dst, o);
        } else {
          *reinterpret_cast<Pack<T, VEC>*>(dst) = o;
        }
      }
    }
    __syncwarp();
    if (lane == 0) {  // this warp is done with stage s; the last one stages chunk c + kStages into it
      __threadfence_block();
      if (atomicAdd(&finished[s], 1) == kGroup - 1) {
        finished[s] = 0;
        __threadfence_block();
        stage_next<T, kStage, kHints>(pr, chunks, full, ring, tiers, n_grouped, cols, data, row_of_pos, n_units, n_ct,
                                      pol_idx);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K1, cluster form: out[row(p)] = (y ? y[row(p)] : 0) + sum_j data[p, j] *
// x[cols[p, j]], x held in the distributed shared memory of a thread-block
// cluster.
//
// Bound: bytes (the index and value streams, 8 or 12 bytes an entry, from
// HBM). The thread kernel's 4-byte gathers of x through L1/L2 run at the
// card's lane-gather rate (112-150 G/s on an H100), not at HBM's; x (256 KB
// in float32 at 65,536 columns) does not fit one CTA's 227 KB, but it fits a
// cluster's. Design:
// - A cluster of C CTAs (C from the launch, at most the portable 8) holds x
//   in slices of S = 2^slice_log2 values: rank k copies x[kS, (k+1)S) into
//   its dynamic shared memory with one cp.async.bulk on an mbarrier (a
//   ragged head before the first 16-byte boundary of x and the tail after the
//   last are plain loads; the slice is stored shifted by x's offset within 16
//   bytes, so the bulk copy's two ends are both aligned). A gather of x[c]
//   reads rank c >> slice_log2 at offset c & (S - 1): mapa and
//   ld.shared::cluster, local or on the neighbour SM.
// - A cluster barrier comes after the fill, before the first remote read,
//   and another before any CTA exits, so no CTA leaves while another still
//   reads its slice. A CTA without work fills its slice and meets both.
// - The grid is persistent (the clusters the card holds at once, or fewer)
//   and deals tiles of `tile` consecutive positions (at most kK1Threads), one
//   a thread, in position order: the layout is degree-sorted, so the widest
//   rows start first. The launcher sizes the tiles so that one wave of the
//   resident CTAs covers every position (a row's sum is one thread's chain,
//   so the positions are all the parallelism there is).
// - Each thread finds its tier as the thread kernel does and reads its
//   cols/values from global memory (any layout), kK1Depth entries at a time:
//   the index and value loads of a batch, then its gathers, are all in
//   flight before its sums. Indices staged by bulk copy, as K2's staged
//   kernel stages them, measured slower on an H100.
// Each position sums data * x in j order with the same fused multiply-adds
// as the thread kernel and adds y[row] at the store: the two kernels give the
// same bits. Group padding writes nothing; every output row is written once.
// Measured on an H100 (chip_row_ell_ablation.py): slower than the thread
// kernel at every size, because random 4- and 8-byte reads of another SM's
// shared memory run below the thread kernel's gather rate through L2, and
// every launch first fills 128 KB a CTA. The entry points launch it only
// when asked (kernel="cluster").
constexpr int kK1Threads = 512;  // the most positions a tile, one CTA an SM
constexpr int kK1Depth = 4;      // entries of a position in flight

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
template <typename T>
__device__ __forceinline__ T ld_cluster(uint32_t addr);
template <>
__device__ __forceinline__ float ld_cluster<float>(uint32_t addr) {
  float v;
  asm("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
template <>
__device__ __forceinline__ double ld_cluster<double>(uint32_t addr) {
  double v;
  asm("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(addr));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kK1Threads, 1)
    row_ell_spmv_cluster_kernel(const int* __restrict__ cols, const T* __restrict__ data, const T* __restrict__ x,
                                long long n_cols, const T* __restrict__ y, T* __restrict__ out,
                                const long long* __restrict__ table, int n_tiers, const int* __restrict__ row_of_pos,
                                long long n_pos, int slice_log2, long long n_tiles, int tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t xbar;

  // this rank's slice [lo, lo + n_k) of x, value i at xs[i]
  const int shift = (int)((reinterpret_cast<uintptr_t>(x) & 15) / sizeof(T));
  T* xs = reinterpret_cast<T*>(smem) + shift;
  const long long lo = (long long)cluster_rank() << slice_log2;
  long long n_k = n_cols - lo;
  n_k = n_k < 0 ? 0 : (n_k > (1LL << slice_log2) ? (1LL << slice_log2) : n_k);
  long long head = shift ? 16 / (long long)sizeof(T) - shift : 0;
  head = head < n_k ? head : n_k;
  const long long body = ((n_k - head) * (long long)sizeof(T) / 16) * 16 / (long long)sizeof(T);

  if (threadIdx.x == 0) {
    mbar_init(&xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (body > 0) {
      mbar_expect_tx(&xbar, (uint32_t)(body * (long long)sizeof(T)));
      bulk_load<false>(xs + head, x + lo + head, (uint32_t)(body * (long long)sizeof(T)), &xbar, 0);
    } else {
      mbar_arrive(&xbar);
    }
  }
  for (long long i = threadIdx.x; i < n_k - body; i += blockDim.x) {  // the ragged head and tail
    const long long v = i < head ? i : i + body;
    xs[v] = x[lo + v];
  }
  mbar_wait(&xbar, 0);
  cluster_sync();  // every slice of the cluster is in place
  const uint32_t xs_addr = smem_u32(xs);
  const uint32_t off_mask = (1u << slice_log2) - 1u;

  for (long long u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    const long long p = u * tile + threadIdx.x;
    if ((int)threadIdx.x < tile && p < n_pos) {
      const int row = row_of_pos[p];
      if (row >= 0) {
        const Tier t = find_tier(table, n_tiers, p);
        const long long base = first_entry(t, p);
        T acc = T(0);
        for (long long j0 = 0; j0 < t.width; j0 += kK1Depth) {
          // kK1Depth index and value loads, then as many gathers, in flight before the sums
          int c[kK1Depth];
          T d[kK1Depth], v[kK1Depth];
#pragma unroll
          for (int i = 0; i < kK1Depth; ++i) {
            if (j0 + i < t.width) {
              const long long e = base + (j0 + i) * t.group;
              c[i] = cols[e];
              d[i] = data[e];
            }
          }
#pragma unroll
          for (int i = 0; i < kK1Depth; ++i) {
            if (j0 + i < t.width) {
              const uint32_t off = (uint32_t)c[i] & off_mask;
              v[i] = ld_cluster<T>(map_rank(xs_addr + off * (uint32_t)sizeof(T), (uint32_t)c[i] >> slice_log2));
            }
          }
#pragma unroll
          for (int i = 0; i < kK1Depth; ++i) {
            if (j0 + i < t.width) acc += d[i] * v[i];
          }
        }
        out[row] = (y != nullptr ? y[row] : T(0)) + acc;
      }
    }
  }
  cluster_sync();  // no CTA leaves while another may still read its slice
}

constexpr int kThreads = 256;

template <typename T>
int launch_spmv_thread(const void* cols, const void* data, const void* x, const void* y, void* out, const void* table,
                       long long n_tiers, const void* row_of_pos, long long n_pos, void* stream) {
  const long long blocks = (n_pos + kThreads - 1) / kThreads;
  row_ell_spmv_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)data, (const T*)x, (const T*)y, (T*)out, (const long long*)table, (int)n_tiers,
      (const int*)row_of_pos, n_pos);
  return (int)cudaGetLastError();
}

// the cluster form on a persistent grid of clusters of `cluster` CTAs, each
// holding 2^slice_log2 values of x, over tiles that one wave covers
template <typename T>
int launch_spmv_cluster(const void* cols, const void* data, const void* x, long long n_cols, const void* y, void* out,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos,
                        long long cluster, long long slice_log2, void* stream) {
  auto kernel = row_ell_spmv_cluster_kernel<T>;
  if (cluster < 1 || cluster > 8 || slice_log2 < 4 || slice_log2 > 24 || (cluster << slice_log2) < n_cols ||
      n_tiers < 1 || (reinterpret_cast<uintptr_t>(x) % sizeof(T)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = (((1LL << slice_log2) + 16 / (long long)sizeof(T)) * (long long)sizeof(T) + 127) / 128 * 128;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kK1Threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg)) != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  // one wave of the resident CTAs over every position, tiles of whole warps
  const long long ctas = (long long)resident * cluster;
  int tile = (int)(((n_pos + ctas - 1) / ctas + 31) / 32 * 32);
  tile = tile < 32 ? 32 : (tile > kK1Threads ? kK1Threads : tile);
  const long long n_tiles = (n_pos + tile - 1) / tile;
  const long long want = n_tiles > cluster ? (n_tiles + cluster - 1) / cluster : 1;
  const long long clusters = want < resident ? want : resident;
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, (const int*)cols, (const T*)data, (const T*)x, n_cols, (const T*)y, (T*)out,
                           (const long long*)table, (int)n_tiers, (const int*)row_of_pos, n_pos, (int)slice_log2,
                           n_tiles, tile);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// kernel 0: the thread kernel; 1: the cluster form (cluster and slice_log2
// serve it only). Both take any layout.
template <typename T>
int launch_spmv(const void* cols, const void* data, const void* x, long long n_cols, const void* y, void* out,
                const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long kernel,
                long long cluster, long long slice_log2, void* stream) {
  switch (kernel) {
    case 0:
      return launch_spmv_thread<T>(cols, data, x, y, out, table, n_tiers, row_of_pos, n_pos, stream);
    case 1:
      return launch_spmv_cluster<T>(cols, data, x, n_cols, y, out, table, n_tiers, row_of_pos, n_pos, cluster,
                                    slice_log2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
int launch_spmm_vec(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                    const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, void* stream) {
  const long long warps_per_block = kThreads / 32;
  const dim3 grid((unsigned)((n_pos + warps_per_block - 1) / warps_per_block),
                  (unsigned)((n + 32 * VEC - 1) / (32 * VEC)));
  row_ell_spmm_kernel<T, VEC><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)data, (const T*)B, ldb, (T*)out, n, (const long long*)table, (int)n_tiers,
      (const int*)row_of_pos, n_pos);
  return (int)cudaGetLastError();
}

// the staged kernel on a persistent grid: every CTA the card holds at once,
// or fewer when there is less work
template <typename T, int VEC>
int launch_spmm_staged(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                       const void* table, long long n_tiers, const void* row_of_pos, long long n_pos,
                       long long n_groups, void* stream) {
  constexpr bool kStage = ROW_ELL_STAGE != 0, kHints = ROW_ELL_HINTS != 0;
  auto kernel = row_ell_spmm_staged_kernel<T, VEC, kStage, kHints>;
  const long long n_ct = (n + 32 * VEC - 1) / (32 * VEC);
  if (n_tiers < 2 || n_ct > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = (kStage ? kStages * Stage<T>::kBytes : 0) + (size_t)(n_tiers - 1) * sizeof(GTier);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGroup * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long work = n_groups * n_ct > 0 ? n_groups * n_ct : 1;
  const long long zero_ctas = ((n_pos - n_groups * kGroup) * n_ct + kGroup - 1) / kGroup;
  const long long want = work > zero_ctas ? work : zero_ctas;
  const long long grid = want < (long long)sms * per_sm ? want : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, kGroup * 32, smem, (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)data, (const T*)B, ldb, (T*)out, n, (const long long*)table, (int)n_tiers,
      (const int*)row_of_pos, n_pos, n_groups, (int)n_ct);
  return (int)cudaGetLastError();
}

// kernel 0: one warp per position (any layout); 1: the staged kernel (grouped
// layouts with G = 16, n_groups groups in the tiers of width > 0)
template <typename T, int WIDE>
int launch_spmm(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long vec,
                long long kernel, long long n_groups, void* stream) {
  if (kernel == 1) {
    if (vec == WIDE) {
      return launch_spmm_staged<T, WIDE>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, n_groups,
                                         stream);
    }
    if (vec == 1) {
      return launch_spmm_staged<T, 1>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, n_groups, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  if (vec == WIDE) {
    return launch_spmm_vec<T, WIDE>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, stream);
  }
  if (vec == 1) {
    return launch_spmm_vec<T, 1>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int st_row_ell_spmv_f32(const void* cols, const void* data, const void* x, long long n_cols, const void* y, void* out,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long kernel,
                        long long cluster, long long slice_log2, void* stream) {
  return launch_spmv<float>(cols, data, x, n_cols, y, out, table, n_tiers, row_of_pos, n_pos, kernel, cluster,
                            slice_log2, stream);
}

int st_row_ell_spmv_f64(const void* cols, const void* data, const void* x, long long n_cols, const void* y, void* out,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long kernel,
                        long long cluster, long long slice_log2, void* stream) {
  return launch_spmv<double>(cols, data, x, n_cols, y, out, table, n_tiers, row_of_pos, n_pos, kernel, cluster,
                             slice_log2, stream);
}

int st_row_ell_spmm_f32(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long vec,
                        long long kernel, long long n_groups, void* stream) {
  return launch_spmm<float, 4>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, vec, kernel, n_groups,
                               stream);
}

int st_row_ell_spmm_f64(const void* cols, const void* data, const void* B, long long ldb, void* out, long long n,
                        const void* table, long long n_tiers, const void* row_of_pos, long long n_pos, long long vec,
                        long long kernel, long long n_groups, void* stream) {
  return launch_spmm<double, 2>(cols, data, B, ldb, out, n, table, n_tiers, row_of_pos, n_pos, vec, kernel, n_groups,
                                stream);
}

}  // extern "C"
