// Hand-written Hopper (sm_90a) kernels of the coordinate-wise GARs: the
// port's counterpart of `byzantinemomentum_tpu/ops/pallas_sort.py`.
//
// Built by `byzantinemomentum_tpu_torch/ops/sort_kernels.py`, one shared
// library per (kernel, row count n) that a run meets, each at its first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DBMT_SORT_KERNEL=<K> -DBMT_N=<n> \
//        -o <build>/lib...so sort_kernels.cu
// K = 1 lower_median, 2 trimmed_mean, 3 closest_mean; 1 <= n <= kMaxRows.
// The sorting network is unrolled for n, and its compile time grows
// steeply with n (140 compare-exchanges at n = 25, 543 at n = 64), so
// only the pairs in use are built. Each library exports `bmt_sort_n`,
// `bmt_sort_kernel` and its one entry, which launches on the stream it is
// given, allocates nothing and returns cudaGetLastError(). f32 only: the
// JAX kernels also take bf16/f16, which the port's GAR space never holds.
//
// ---------------------------------------------------------------------------
// lower_median: replaces `pallas_sort.py::lower_median` (`_median_kernel`),
// `sorted[(n - 1) // 2]` of each column, NaN last.
// trimmed_mean: replaces `pallas_sort.py::trimmed_mean` (`_trmean_kernel`),
// the mean of sorted ranks [f, n - f): summed in ascending rank order from
// rank f, then divided by n - 2f, as the JAX kernel does.
// closest_mean: replaces `pallas_sort.py::closest_mean` (`_closest_kernel`),
// the mean of the m values of each column closest to c[j]
// (`bmt::closest_mean_values`).
//   Bound: bytes. Each reads g once and writes one (d,) row (closest_mean
//   also reads c): 136.3 MB (141.6 MB) at f32[25, 1,310,922]. The work per
//   coordinate is one sorting network (of the values, or of closest_mean's
//   deviations) plus O(n) adds, far below the f32 peak.
//   Design: the TPU kernels sort (n, tile) column blocks in VMEM. Here
//   thread j owns column j: it issues all n loads of its column before
//   the first use (consecutive threads read consecutive addresses, so
//   each row's loads are coalesced and n of them are in flight), sorts in
//   registers with the template-unrolled Batcher network of `batcher.cuh`
//   and writes one f32. The rank bounds f and m are run-time arguments:
//   the loops over ranks are unrolled with a predicate, so the values
//   never leave registers. closest_mean recomputes each deviation where it
//   is read rather than keeping a second array of n (`batcher.cuh`).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>

#include "batcher.cuh"

#ifndef BMT_SORT_KERNEL
#define BMT_SORT_KERNEL 1
#endif
#ifndef BMT_N
#define BMT_N 1
#endif

namespace {

constexpr int kMaxRows = 64;  // MAX_ROWS of the JAX package
constexpr int kSortThreads = 256;
static_assert(1 <= BMT_N && BMT_N <= kMaxRows, "BMT_N outside 1..kMaxRows");
static_assert(1 <= BMT_SORT_KERNEL && BMT_SORT_KERNEL <= 3,
              "BMT_SORT_KERNEL outside 1..3");

// Column j of g (f32[N, d], row-major): every load issued before any use
template <int N>
__device__ __forceinline__ void load_column(const float* __restrict__ g,
                                            long long d, long long j,
                                            float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = g[i * d + j];
}

template <int N>
__global__ void __launch_bounds__(kSortThreads)
lower_median_kernel(const float* __restrict__ g, float* __restrict__ out,
                    long long d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[N];
    load_column<N>(g, d, j, v);
    bmt::batcher_sort<N>(v);
    out[j] = v[(N - 1) / 2];
  }
}

template <int N>
__global__ void __launch_bounds__(kSortThreads)
trimmed_mean_kernel(const float* __restrict__ g, float* __restrict__ out,
                    long long d, int f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[N];
    load_column<N>(g, d, j, v);
    bmt::batcher_sort<N>(v);
    // -0 + x == x for every x, so starting from -0 the first add is the
    // JAX kernel's `acc = rows[f]` exactly
    float acc = -0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i >= f && i < N - f) acc += v[i];
    }
    out[j] = acc / (float)(N - 2 * f);
  }
}

template <int N>
__global__ void __launch_bounds__(kSortThreads)
closest_mean_kernel(const float* __restrict__ g, const float* __restrict__ c,
                    float* __restrict__ out, long long d, int m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[N], srt[N];
    load_column<N>(g, d, j, v);
    out[j] = bmt::closest_mean_values<N>(v, c[j], m, srt);
  }
}

unsigned grid_for(long long d) {
  long long blocks = (d + kSortThreads - 1) / kSortThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  return (unsigned)blocks;
}

}  // namespace

extern "C" {

int bmt_sort_n() { return BMT_N; }

int bmt_sort_kernel() { return BMT_SORT_KERNEL; }

#if BMT_SORT_KERNEL == 1
// g f32[BMT_N, d] -> out f32[d]
int bmt_lower_median(const float* g, float* out, long long d, void* stream) {
  lower_median_kernel<BMT_N>
      <<<grid_for(d), kSortThreads, 0, (cudaStream_t)stream>>>(g, out, d);
  return (int)cudaGetLastError();
}
#elif BMT_SORT_KERNEL == 2
// g f32[BMT_N, d] -> out f32[d]; 0 <= f, 2f < BMT_N
int bmt_trimmed_mean(const float* g, float* out, long long d, int f,
                     void* stream) {
  trimmed_mean_kernel<BMT_N>
      <<<grid_for(d), kSortThreads, 0, (cudaStream_t)stream>>>(g, out, d, f);
  return (int)cudaGetLastError();
}
#else
// g f32[BMT_N, d], c f32[d] -> out f32[d]; 1 <= m <= BMT_N
int bmt_closest_mean(const float* g, const float* c, float* out, long long d,
                     int m, void* stream) {
  closest_mean_kernel<BMT_N>
      <<<grid_for(d), kSortThreads, 0, (cudaStream_t)stream>>>(g, c, out, d,
                                                               m);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
