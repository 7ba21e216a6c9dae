// Min-plus relaxation over the per-destination ELL (K7) for Hopper (sm_90a),
// plain C interface for ctypes. Built by sparse_tpu_torch/kernels/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//
// Replaces the XLA relaxation round of sparse_tpu/csgraph.py:
// _bellman_ford_device_ell (:228) and _bellman_ford_device_ell_tail (:255),
// which gather the distance table's rows by the layout's sources into an
// (n, L0, k) block, add the weights and take the minimum over the slots.
// The layout is sparse_tpu_torch/kernels/minplus.py:build_dest_ell's: e_src
// and e_w are (n, L0) row-major (int64 sources, +inf weight in padding), the
// tail (t_src, t_w) is (d, Lt) and covers destinations n - d .. n - 1.
//
// One round: for every destination v and source column s of the transposed
// table dist (n, k), row-major,
//   out[v, s] = min(dist[v, s], min_l dist[e_src[v, l], s] + e_w[v, l])
// (the tail's slots join the inner minimum), and *changed = 1 where
// out[v, s] < dist[v, s]. The minimum propagates NaN as jnp.min and
// torch.amin do (fmin would drop it), and every candidate is one rounded
// add, so a round gives the plain version's bits whatever order the slots
// are taken in. out must not be dist: each round reads only the previous
// round's table.
//
// Bound on this card: bytes. The function reads the layout (16 bytes a slot)
// and the table once and writes the table once; the kernel reads a table row
// segment for every slot, n * L0 * k gathers, which L2 serves while the table
// fits in it. Design (simple first): one thread per (v, s) with s the fastest
// index, so a warp's gathers of dist[u, s..s+31] coalesce when k >= 32 and the
// warp's threads of one v read each slot's source and weight once (a
// broadcast); a grid over n * k threads, one launch a round.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The smaller of a and b, NaN when either is NaN.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T slots_min(const T* __restrict__ dist, const long long* __restrict__ src,
                                       const T* __restrict__ w, long long width, long long k, long long s) {
  T best = (T)INFINITY;
  for (long long l = 0; l < width; ++l) best = nan_min(best, dist[src[l] * k + s] + w[l]);
  return best;
}

template <typename T>
__global__ void __launch_bounds__(256) minplus_relax_kernel(const T* __restrict__ dist, T* __restrict__ out,
                                                            const long long* __restrict__ e_src,
                                                            const T* __restrict__ e_w, long long n, long long width,
                                                            long long k, const long long* __restrict__ t_src,
                                                            const T* __restrict__ t_w, long long d, long long t_width,
                                                            unsigned char* __restrict__ changed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * k) return;
  const long long v = i / k;
  const long long s = i - v * k;
  T best = slots_min(dist, e_src + v * width, e_w + v * width, width, k, s);
  if (v >= n - d) {
    const long long r = v - (n - d);
    best = nan_min(best, slots_min(dist, t_src + r * t_width, t_w + r * t_width, t_width, k, s));
  }
  const T old = dist[i];
  const T next = nan_min(old, best);
  out[i] = next;
  if (next < old) *changed = 1;
}

template <typename T>
int launch(const T* dist, T* out, const long long* e_src, const T* e_w, long long n, long long width, long long k,
           const long long* t_src, const T* t_w, long long d, long long t_width, unsigned char* changed,
           cudaStream_t stream) {
  const long long total = n * k;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  minplus_relax_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(dist, out, e_src, e_w, n, width, k, t_src, t_w,
                                                                      d, t_width, changed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int st_minplus_relax_f64(const double* dist, double* out, const long long* e_src, const double* e_w,
                                    long long n, long long width, long long k, const long long* t_src,
                                    const double* t_w, long long d, long long t_width, unsigned char* changed,
                                    void* stream) {
  return launch<double>(dist, out, e_src, e_w, n, width, k, t_src, t_w, d, t_width, changed, (cudaStream_t)stream);
}

extern "C" int st_minplus_relax_f32(const float* dist, float* out, const long long* e_src, const float* e_w,
                                    long long n, long long width, long long k, const long long* t_src,
                                    const float* t_w, long long d, long long t_width, unsigned char* changed,
                                    void* stream) {
  return launch<float>(dist, out, e_src, e_w, n, width, k, t_src, t_w, d, t_width, changed, (cudaStream_t)stream);
}
