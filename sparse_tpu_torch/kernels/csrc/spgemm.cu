// Sparse x sparse products (SpGEMM, S1) for Hopper (sm_90a), plain C
// interface for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Replaces sparse_tpu/kernels/spgemm.py:esc_spgemm (:124, XLA: expand, sort,
// segmented sum) and the eager sparse_tpu/ops/dot.py:_spgemm (:738, NumPy and
// the host C++ Gustavson loop) on the port's eager product
// (sparse_tpu_torch/kernels/spgemm.py:spgemm_coords) for float32 and float64:
// C = A (m, k) @ B (k, n) of two CSR operands (int64 row pointers, int32 or
// int64 column ids sorted within each row, no duplicates) into C's canonical
// COO, rows and columns int32 or int64.
//
// The bits are fixed: those of the host loop the port already runs on the
// CPU (sparse_tpu_torch/native/csrc/eager.cpp:spgemm_numeric_range) and of
// the plain torch ops (kernels/spgemm.py:spgemm). Every output entry starts
// from its first product, not from zero (so a -0.0 product survives), and
// adds the later ones in ascending k; each product is rounded before its add
// (__fmul_rn then __fadd_rn, which nvcc does not contract); no atomics touch
// values. Sums equal to zero (either sign) are counted into *zeros and the
// wrapper drops them.
//
// Bound on this card: bytes (both operands read once, C written once); the
// products' additions are few beside them. The torch ops it replaces expand
// every product and sort int64 keys (at the bench shape 6.7e7 products, 19.6
// ms, a 3.6 GB peak). Design: Gustavson by row, two passes, one CTA of
// kThreads a row at a time, rows taken from a counter in the order the
// wrapper gives (largest product count first). A row's columns are taken in
// chunks of `span` columns (one chunk when n fits: the wrapper's plan):
//   1. every product's column sets its bit in a bitmap in shared memory
//      (atomicOr, any order; warps over the row's A entries, lanes over B's
//      row);
//   2. the symbolic pass counts the bits: the row's distinct columns. The
//      numeric pass scans the words' popcounts, each warp a quarter of the
//      words: each column's rank, its slot in C's row, in ascending column
//      order with no sort;
//   3. the numeric pass walks the row's A entries in ascending k, the lanes
//      of a warp over B's row k, whose columns are distinct; kWalkers warps
//      walk, each owning the columns of its share of the words, so a slot is
//      only ever written by one warp, and __syncwarp orders its steps. A
//      walker loads the B row ranges and A values of 32 A entries at once (a
//      step table in its lanes, handed out by shuffles) and keeps the next
//      B row's first 32 * kWidth entries in flight.
//      A second bitmap ("seen") tells the first product of a column, which
//      is stored, from the later ones, which are added. The sums live in
//      shared memory when the chunk's columns fit `vcap`, else in C's own
//      values (a CTA owns its row's segment);
//   4. the chunk's columns (written by their first product), sums and row
//      ids go straight into C's coordinates and values; the bitmaps are
//      cleared for the next chunk.
// More than one chunk: each A entry's B row is cut to the chunk by two
// binary searches, and the next chunk starts at the least column left.
// The constants below were chosen by an ablation on an H100 at the bench
// shape (PERF.md §6 gives the variants' times). SPGEMM_PROFILE=1 builds
// the numeric pass with its cycles counted by step (chip_spgemm_ablation.py):
// the ordered walk takes about two thirds of them.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SPGEMM_PROFILE
#define SPGEMM_PROFILE 0  // 1: thread 0 of each CTA of the numeric pass adds each step's cycles to g_phase
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // a CTA's threads
constexpr int kWarps = kThreads / 32;
constexpr int kWalkers = 2;  // step 3: the warps that walk the row, each owning its share of the words
constexpr int kAhead = 2;    // step 3: the step table's B rows a warp holds: this step's and the next
constexpr int kWidth = 2;    // step 3: the entries of each a lane holds (32 lanes apart)
constexpr long long kNone = 0x7fffffffffffffffLL;

typedef unsigned int Word;  // a bitmap word
constexpr int kShift = 5;
constexpr int kBitMask = (1 << kShift) - 1;
__device__ __forceinline__ int popc(Word x) { return __popc(x); }

#if SPGEMM_PROFILE
// the numeric pass's cycles by step, summed over its CTAs: waiting for a
// row, step 1, step 2, step 3, step 4; then the chunks taken
__device__ unsigned long long g_phase[6];
#define PHASE(i, t)                                                         \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      const long long now = clock64();                                      \
      atomicAdd(&g_phase[i], (unsigned long long)(now - (t)));              \
      (t) = now;                                                            \
    }                                                                       \
  } while (0)
#else
#define PHASE(i, t) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the sum (min) over the CTA; red holds kWarps values; every thread gets it
__device__ long long block_sum(long long v, long long* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

__device__ long long block_min(long long v, long long* red) {
  v = warp_min(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = kNone;
  for (int i = 0; i < kWarps; ++i) t = min(t, red[i]);
  return t;
}

// the next position of the wrapper's row order for this CTA
__device__ long long next_row(unsigned long long* counter, long long* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = (long long)atomicAdd(counter, 1ull);
  __syncthreads();
  return *slot;
}

template <typename II>
__device__ long long lower_bound(const II* __restrict__ cols, long long lo, long long hi, long long v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)cols[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// B's row kk cut to the chunk [lo, hi): [q0, q1), and the row's first column
// at or past hi (kNone if none); the whole row when `whole`
template <typename II>
__device__ __forceinline__ void chunk_range(const long long* __restrict__ b_ptr, const II* __restrict__ b_cols,
                                            long long kk, long long lo, long long hi, bool whole, long long& q0,
                                            long long& q1, long long& next) {
  q0 = b_ptr[kk];
  q1 = b_ptr[kk + 1];
  next = kNone;
  if (!whole) {
    const long long end = q1;
    q0 = lower_bound(b_cols, q0, end, lo);
    q1 = lower_bound(b_cols, q0, end, hi);
    if (q1 < end) next = (long long)b_cols[q1];
  }
}

// the least column of the row's products (kNone if it has none)
template <typename II>
__device__ long long first_column(const long long* __restrict__ b_ptr, const II* __restrict__ a_cols,
                                  const II* __restrict__ b_cols, long long a0, long long len, long long* red) {
  long long v = kNone;
  for (long long s = threadIdx.x; s < len; s += kThreads) {
    const long long kk = (long long)a_cols[a0 + s];
    const long long q = b_ptr[kk];
    if (q < b_ptr[kk + 1]) v = min(v, (long long)b_cols[q]);
  }
  return block_min(v, red);
}

// step 1: the chunk's columns into `bits`; returns this thread's least
// column past the chunk
template <typename II>
__device__ long long mark(const long long* __restrict__ b_ptr, const II* __restrict__ a_cols,
                          const II* __restrict__ b_cols, long long a0, long long len, long long lo, long long hi,
                          bool whole, Word* bits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long next_min = kNone;
  for (long long s = warp; s < len; s += kWarps) {
    long long q0, q1, next;
    chunk_range(b_ptr, b_cols, (long long)a_cols[a0 + s], lo, hi, whole, q0, q1, next);
    next_min = min(next_min, next);
    for (long long q = q0 + lane; q < q1; q += 32) {
      const int c = (int)((long long)b_cols[q] - lo);
      atomicOr(&bits[c >> kShift], Word(1) << (c & kBitMask));
    }
  }
  return next_min;
}

struct Plan {
  long long m, n;
  int words;  // bitmap words a chunk: chunks of span = words << kShift columns
};

template <typename II>
__global__ void __launch_bounds__(kThreads)
    spgemm_symbolic_kernel(const long long* __restrict__ a_ptr, const II* __restrict__ a_cols,
                           const long long* __restrict__ b_ptr, const II* __restrict__ b_cols,
                           const long long* __restrict__ order, const long long* __restrict__ products, Plan plan,
                           unsigned long long* counter, long long* __restrict__ row_count) {
  extern __shared__ unsigned long long smem[];
  Word* bits = (Word*)smem;
  long long* red = (long long*)(smem + ((long long)plan.words * sizeof(Word) + 7) / 8);
  long long* slot = red + kWarps;
  const long long span = (long long)plan.words << kShift;
  const bool whole = span >= plan.n;
  for (int w = threadIdx.x; w < plan.words; w += kThreads) bits[w] = 0;
  for (;;) {
    const long long i = next_row(counter, slot);
    if (i >= plan.m || products[i] == 0) break;  // the rest have no products
    const long long row = order[i];
    const long long a0 = a_ptr[row], len = a_ptr[row + 1] - a0;
    long long total = 0;
    long long lo = whole ? 0 : first_column(b_ptr, a_cols, b_cols, a0, len, red);
    while (lo < plan.n) {
      const long long next = mark(b_ptr, a_cols, b_cols, a0, len, lo, lo + span, whole, bits);
      __syncthreads();
      long long cnt = 0;
      for (int w = threadIdx.x; w < plan.words; w += kThreads) {
        cnt += popc(bits[w]);
        bits[w] = 0;
      }
      total += block_sum(cnt, red);
      lo = whole ? plan.n : block_min(next, red);
    }
    if (threadIdx.x == 0) row_count[row] = total;
  }
}

template <typename T, typename II, typename OI>
__global__ void __launch_bounds__(kThreads)
    spgemm_numeric_kernel(const long long* __restrict__ a_ptr, const II* __restrict__ a_cols,
                          const T* __restrict__ a_vals, const long long* __restrict__ b_ptr,
                          const II* __restrict__ b_cols, const T* __restrict__ b_vals,
                          const long long* __restrict__ order, const long long* __restrict__ products, Plan plan,
                          int vcap, const long long* __restrict__ row_ptr, OI* __restrict__ out_rows,
                          OI* __restrict__ out_cols, T* out_vals, unsigned long long* counter,
                          unsigned long long* zeros) {
  extern __shared__ unsigned long long smem[];
  Word* bits = (Word*)smem;
  Word* seen = bits + plan.words;
  long long* red = (long long*)(smem + (2LL * plan.words * sizeof(Word) + 7) / 8);  // reductions, the slot
  long long* slot = red + kWarps;
  T* cache = (T*)(slot + 1);
  int* prefix = (int*)(cache + vcap);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long span = (long long)plan.words << kShift;
  const bool whole = span >= plan.n;
  const int per_warp = (plan.words + kWarps - 1) / kWarps;  // words a warp scans
  const int ws = min(plan.words, warp * per_warp), we = min(plan.words, ws + per_warp);
  const bool walker = warp < kWalkers;
  const int per_walker = (plan.words + kWalkers - 1) / kWalkers;  // words whose columns a walker owns
  const int own_lo = min(plan.words, warp * per_walker), own_hi = min(plan.words, own_lo + per_walker);
  for (int w = threadIdx.x; w < plan.words; w += kThreads) bits[w] = seen[w] = 0;
  long long tp = SPGEMM_PROFILE ? clock64() : 0;
  for (;;) {
    const long long i = next_row(counter, slot);
    PHASE(0, tp);
    if (i >= plan.m || products[i] == 0) break;
    const long long row = order[i];
    const long long a0 = a_ptr[row], len = a_ptr[row + 1] - a0;
    long long out = row_ptr[row];  // the chunk's first slot in C
    long long lo = whole ? 0 : first_column(b_ptr, a_cols, b_cols, a0, len, red);
    while (lo < plan.n) {
      const long long next = mark(b_ptr, a_cols, b_cols, a0, len, lo, lo + span, whole, bits);
      __syncthreads();
      PHASE(1, tp);
      // step 2: each warp scans its words' popcounts, 32 at a time
      int run = 0;
      for (int t0 = ws; t0 < we; t0 += 32) {
        const int w = t0 + lane;
        const int c = w < we ? popc(bits[w]) : 0;
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        if (w < we) prefix[w] = run + incl - c;
        run += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) red[warp] = run;
      __syncthreads();
      long long count = 0, before = 0;  // the chunk's columns, and those of the words before this warp's
      for (int j = 0; j < kWarps; ++j) {
        before += j < warp ? red[j] : 0;
        count += red[j];
      }
      for (int w = ws + lane; w < we; w += 32) prefix[w] += (int)before;  // each word's first rank in the chunk
      __syncthreads();
      const bool cached = count <= vcap;
      T* acc = cached ? cache : out_vals + out;
      PHASE(2, tp);
      // step 3: the products in ascending k, each walker on the slots it owns
      // one product of A's value av and B's value bv at the chunk's column c,
      // where this warp owns the column's slot
      auto add_product = [&](int c, T bv, T av) {
        const int w = c >> kShift;
        if (w < own_lo || w >= own_hi) return;
        const Word bit = Word(1) << (c & kBitMask);
        const long long pos = prefix[w] + popc(bits[w] & (bit - 1));
        const T p = mul_rn(av, bv);
        if (atomicOr(&seen[w], bit) & bit) {
          acc[pos] = add_rn(acc[pos], p);
        } else {
          acc[pos] = p;
          out_cols[out + pos] = (OI)(c + lo);
        }
      };
      // the step table: lane t holds the B row range and A value of entry s0 + t,
      // and each lane keeps its kWidth entries of the next row's first
      // 32 * kWidth in flight
      for (long long s0 = 0; s0 < (walker ? len : 0); s0 += 32) {
        long long my_q0 = 0, my_q1 = 0, unused;
        T my_av = T(0);
        if (s0 + lane < len) {
          chunk_range(b_ptr, b_cols, (long long)a_cols[a0 + s0 + lane], lo, lo + span, whole, my_q0, my_q1, unused);
          my_av = a_vals[a0 + s0 + lane];
        }
        const int steps = (int)min(32LL, len - s0);
        int ahead_c[kAhead][kWidth];
        T ahead_v[kAhead][kWidth];
        auto load_ahead = [&](int d, int u) {  // slot d takes B row u of the table
          const long long q0 = __shfl_sync(kFull, my_q0, u & 31), q1 = __shfl_sync(kFull, my_q1, u & 31);
#pragma unroll
          for (int e = 0; e < kWidth; ++e) {
            const long long q = q0 + 32 * e + lane;
            const bool in = u < steps && q < q1;
            ahead_c[d][e] = in ? (int)((long long)b_cols[q] - lo) : -1;
            ahead_v[d][e] = in ? b_vals[q] : T(0);
          }
        };
#pragma unroll
        for (int d = 0; d < kAhead - 1; ++d) load_ahead(d, d);
        for (int t = 0; t < steps; ++t) {
          load_ahead(kAhead - 1, t + kAhead - 1);
          const long long q0 = __shfl_sync(kFull, my_q0, t), q1 = __shfl_sync(kFull, my_q1, t);
          const T av = __shfl_sync(kFull, my_av, t);
#pragma unroll
          for (int e = 0; e < kWidth; ++e)
            if (ahead_c[0][e] >= 0) add_product(ahead_c[0][e], ahead_v[0][e], av);
          for (long long q = q0 + 32 * kWidth + lane; q < q1; q += 32)
            add_product((int)((long long)b_cols[q] - lo), b_vals[q], av);
          __syncwarp();
#pragma unroll
          for (int d = 0; d + 1 < kAhead; ++d) {
#pragma unroll
            for (int e = 0; e < kWidth; ++e) {
              ahead_c[d][e] = ahead_c[d + 1][e];
              ahead_v[d][e] = ahead_v[d + 1][e];
            }
          }
        }
      }
      __syncthreads();
      PHASE(3, tp);
      // step 4: the sums and row ids into C; the bitmaps cleared
      long long z = 0;
      for (long long j = threadIdx.x; j < count; j += kThreads) {
        const T v = acc[j];
        if (cached) out_vals[out + j] = v;
        z += v == T(0);
        out_rows[out + j] = (OI)row;
      }
      if (z) atomicAdd(zeros, (unsigned long long)z);
      for (int w = threadIdx.x; w < plan.words; w += kThreads) bits[w] = seen[w] = 0;
      out += count;
      PHASE(4, tp);
#if SPGEMM_PROFILE
      if (threadIdx.x == 0) atomicAdd(&g_phase[5], 1ull);
#endif
      lo = whole ? plan.n : block_min(next, red);
    }
  }
}

int grid_for(const void* kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// the chunk's words for `span` columns (a multiple of 64), and the shared
// memory of a CTA of each pass
long long words_of(long long span) { return span >> kShift; }

long long symbolic_smem(long long words) { return (words * (long long)sizeof(Word) + 7) / 8 * 8 + (kWarps + 1) * 8LL; }

long long numeric_smem(long long words, long long vcap, long long item) {
  return (2 * words * (long long)sizeof(Word) + 7) / 8 * 8 + (kWarps + 1) * 8LL + vcap * item + words * 4;
}

int launch_ready(const void* kernel, long long smem) {
  if (smem > 48 * 1024) return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)cudaSuccess;
}

template <typename II>
int symbolic(const long long* a_ptr, const II* a_cols, const long long* b_ptr, const II* b_cols,
             const long long* order, const long long* products, long long m, long long n, long long span,
             unsigned long long* counter, long long* row_count, cudaStream_t stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (span <= 0 || span % 64) return (int)cudaErrorInvalidValue;
  const Plan plan{m, n, (int)words_of(span)};
  const long long smem = symbolic_smem(plan.words);
  const void* kernel = (const void*)spgemm_symbolic_kernel<II>;
  const int err = launch_ready(kernel, smem);
  if (err) return err;
  long long grid = grid_for(kernel, (int)smem);
  if (grid > m) grid = m;
  spgemm_symbolic_kernel<II><<<(unsigned)grid, kThreads, (int)smem, stream>>>(a_ptr, a_cols, b_ptr, b_cols, order,
                                                                               products, plan, counter, row_count);
  return (int)cudaGetLastError();
}

template <typename T, typename II, typename OI>
int numeric(const long long* a_ptr, const II* a_cols, const T* a_vals, const long long* b_ptr, const II* b_cols,
            const T* b_vals, const long long* order, const long long* products, long long m, long long n,
            long long span, long long vcap, const long long* row_ptr, OI* out_rows, OI* out_cols, T* out_vals,
            unsigned long long* counter, unsigned long long* zeros, cudaStream_t stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (span <= 0 || span % 64) return (int)cudaErrorInvalidValue;
  const Plan plan{m, n, (int)words_of(span)};
  const long long smem = numeric_smem(plan.words, vcap, sizeof(T));
  const void* kernel = (const void*)spgemm_numeric_kernel<T, II, OI>;
  const int err = launch_ready(kernel, smem);
  if (err) return err;
  long long grid = grid_for(kernel, (int)smem);
  if (grid > m) grid = m;
  spgemm_numeric_kernel<T, II, OI><<<(unsigned)grid, kThreads, (int)smem, stream>>>(
      a_ptr, a_cols, a_vals, b_ptr, b_cols, b_vals, order, products, plan, (int)vcap, row_ptr, out_rows, out_cols,
      out_vals, counter, zeros);
  return (int)cudaGetLastError();
}

}  // namespace

// the symbolic pass: row_count[r] = the distinct columns of C's row r, for
// every row of `order` with products (the others keep their zero); span:
// the columns of a chunk, a multiple of 64
#define ST_SPGEMM_SYMBOLIC(NAME, II)                                                                             \
  extern "C" int NAME(const long long* a_ptr, const II* a_cols, const long long* b_ptr, const II* b_cols,       \
                      const long long* order, const long long* products, long long m, long long n,             \
                      long long span, void* counter, long long* row_count, void* stream) {                     \
    return symbolic<II>(a_ptr, a_cols, b_ptr, b_cols, order, products, m, n, span,                               \
                        (unsigned long long*)counter, row_count, (cudaStream_t)stream);                         \
  }

// the numeric pass: C's rows, columns and sums at row_ptr's offsets; the
// number of sums equal to zero added to *zeros
#define ST_SPGEMM_NUMERIC(NAME, T, II, OI)                                                                      \
  extern "C" int NAME(const long long* a_ptr, const II* a_cols, const T* a_vals, const long long* b_ptr,        \
                      const II* b_cols, const T* b_vals, const long long* order, const long long* products,    \
                      long long m, long long n, long long span, long long vcap, const long long* row_ptr,      \
                      OI* out_rows, OI* out_cols, T* out_vals, void* counter, void* zeros, void* stream) {     \
    return numeric<T, II, OI>(a_ptr, a_cols, a_vals, b_ptr, b_cols, b_vals, order, products, m, n, span, vcap,  \
                              row_ptr, out_rows, out_cols, out_vals, (unsigned long long*)counter,             \
                              (unsigned long long*)zeros, (cudaStream_t)stream);                              \
  }

#if SPGEMM_PROFILE
// the numeric pass's cycles by step (6 values) into `out` on the host, then zeroed
extern "C" int st_spgemm_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[6] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
#endif

ST_SPGEMM_SYMBOLIC(st_spgemm_symbolic_i32, int)
ST_SPGEMM_SYMBOLIC(st_spgemm_symbolic_i64, long long)

ST_SPGEMM_NUMERIC(st_spgemm_numeric_f32_i32_o32, float, int, int)
ST_SPGEMM_NUMERIC(st_spgemm_numeric_f32_i32_o64, float, int, long long)
ST_SPGEMM_NUMERIC(st_spgemm_numeric_f32_i64_o32, float, long long, int)
ST_SPGEMM_NUMERIC(st_spgemm_numeric_f32_i64_o64, float, long long, long long)
ST_SPGEMM_NUMERIC(st_spgemm_numeric_f64_i32_o32, double, int, int)
ST_SPGEMM_NUMERIC(st_spgemm_numeric_f64_i32_o64, double, int, long long)
ST_SPGEMM_NUMERIC(st_spgemm_numeric_f64_i64_o32, double, long long, int)
ST_SPGEMM_NUMERIC(st_spgemm_numeric_f64_i64_o64, double, long long, long long)
