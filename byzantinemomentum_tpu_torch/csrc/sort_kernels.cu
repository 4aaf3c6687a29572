// Hand-written Hopper (sm_90a) kernels of the coordinate-wise GARs: the
// port's counterpart of `byzantinemomentum_tpu/ops/pallas_sort.py`.
//
// Built by `byzantinemomentum_tpu_torch/ops/sort_kernels.py`, one shared
// library per (kernel, row count n, element type) that a run meets, each
// at its first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DBMT_SORT_KERNEL=<K> -DBMT_N=<n> -DBMT_DTYPE=<T> \
//        -o <build>/lib...so sort_kernels.cu
// K = 1 lower_median, 2 trimmed_mean, 3 closest_mean, 4 colsort;
// 1 <= n <= kMaxRows; T = 1 f32, 2 bf16, 3 f16 (the JAX kernels' dtypes).
// The sorting network is unrolled for n, and its compile time grows
// steeply with n (140 compare-exchanges at n = 25, 543 at n = 64), so
// only the libraries in use are built. Each library exports
// `bmt_sort_n`, `bmt_sort_kernel`, `bmt_sort_dtype` and its one entry,
// which launches on the stream it is given, allocates nothing and returns
// cudaGetLastError(). Operands and outputs are T arrays; the entries take
// them as untyped pointers, since the element type is the library's.
//
// Arithmetic (`batcher.cuh`, `Elem<T>`): values are converted to float as
// they are loaded, compared as floats, and every add, subtract and divide
// is rounded to T, so a bf16 or f16 result is the one the JAX kernel's
// storage-type arithmetic gives. Outputs are T.
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
// colsort: replaces `pallas_sort.py::colsort` (`_colsort_kernel`), every
// column sorted, NaN last: the lower_median network, writing all n rows.
//   Bound: bytes. lower_median, trimmed_mean and closest_mean read g once
//   and write one (d,) row (closest_mean also reads c): 136.3 MB
//   (141.6 MB) at f32[25, 1,310,922], half that in bf16 or f16. colsort
//   reads and writes the whole matrix: 262.2 MB in f32. The work per
//   coordinate is one sorting network (of the values, or of closest_mean's
//   deviations) plus O(n) adds, far below the f32 peak; it does not shrink
//   with the element type, so the half forms sit further above their
//   (halved) bound.
//   Design: the TPU kernels sort (n, tile) column blocks in VMEM. Here
//   thread j owns column j: it issues all n loads of its column before
//   the first use (consecutive threads read consecutive addresses, so
//   each row's loads are coalesced and n of them are in flight), sorts in
//   registers with the template-unrolled Batcher network of `batcher.cuh`
//   and writes one T (colsort: n, each row's stores coalesced). The rank
//   bounds f and m are run-time arguments: the loops over ranks are
//   unrolled with a predicate, so the values never leave registers.
//   closest_mean recomputes each deviation where it is read rather than
//   keeping a second array of n (`batcher.cuh`).
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
#ifndef BMT_DTYPE
#define BMT_DTYPE 1
#endif

namespace {

constexpr int kMaxRows = 64;  // MAX_ROWS of the JAX package
constexpr int kSortThreads = 256;
static_assert(1 <= BMT_N && BMT_N <= kMaxRows, "BMT_N outside 1..kMaxRows");
static_assert(1 <= BMT_SORT_KERNEL && BMT_SORT_KERNEL <= 4,
              "BMT_SORT_KERNEL outside 1..4");

#if BMT_DTYPE == 1
using T = float;
#elif BMT_DTYPE == 2
using T = __nv_bfloat16;
#elif BMT_DTYPE == 3
using T = __half;
#else
#error "BMT_DTYPE outside 1..3"
#endif
using E = bmt::Elem<T>;

// Column j of g (T[N, d], row-major) as floats: every load issued before
// any use
template <int N>
__device__ __forceinline__ void load_column(const T* __restrict__ g,
                                            long long d, long long j,
                                            float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = E::load(g[i * d + j]);
}

template <int N>
__global__ void __launch_bounds__(kSortThreads)
lower_median_kernel(const T* __restrict__ g, T* __restrict__ out,
                    long long d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[N];
    load_column<N>(g, d, j, v);
    bmt::batcher_sort<N>(v);
    out[j] = E::store(v[(N - 1) / 2]);
  }
}

template <int N>
__global__ void __launch_bounds__(kSortThreads)
trimmed_mean_kernel(const T* __restrict__ g, T* __restrict__ out,
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
      if (i >= f && i < N - f) acc = E::round(acc + v[i]);
    }
    out[j] = E::store(acc / (float)(N - 2 * f));
  }
}

template <int N>
__global__ void __launch_bounds__(kSortThreads)
closest_mean_kernel(const T* __restrict__ g, const T* __restrict__ c,
                    T* __restrict__ out, long long d, int m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[N], srt[N];
    load_column<N>(g, d, j, v);
    out[j] = E::store(
        bmt::closest_mean_values<N, T>(v, E::load(c[j]), m, srt));
  }
}

template <int N>
__global__ void __launch_bounds__(kSortThreads)
colsort_kernel(const T* __restrict__ g, T* __restrict__ out, long long d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[N];
    load_column<N>(g, d, j, v);
    bmt::batcher_sort<N>(v);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i * d + j] = E::store(v[i]);
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

int bmt_sort_dtype() { return BMT_DTYPE; }

#if BMT_SORT_KERNEL == 1
// g T[BMT_N, d] -> out T[d]
int bmt_lower_median(const void* g, void* out, long long d, void* stream) {
  lower_median_kernel<BMT_N><<<grid_for(d), kSortThreads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)g, (T*)out, d);
  return (int)cudaGetLastError();
}
#elif BMT_SORT_KERNEL == 2
// g T[BMT_N, d] -> out T[d]; 0 <= f, 2f < BMT_N
int bmt_trimmed_mean(const void* g, void* out, long long d, int f,
                     void* stream) {
  trimmed_mean_kernel<BMT_N><<<grid_for(d), kSortThreads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)g, (T*)out, d, f);
  return (int)cudaGetLastError();
}
#elif BMT_SORT_KERNEL == 3
// g T[BMT_N, d], c T[d] -> out T[d]; 1 <= m <= BMT_N
int bmt_closest_mean(const void* g, const void* c, void* out, long long d,
                     int m, void* stream) {
  closest_mean_kernel<BMT_N><<<grid_for(d), kSortThreads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)g, (const T*)c, (T*)out, d, m);
  return (int)cudaGetLastError();
}
#else
// g T[BMT_N, d] -> out T[BMT_N, d]
int bmt_colsort(const void* g, void* out, long long d, void* stream) {
  colsort_kernel<BMT_N><<<grid_for(d), kSortThreads, 0,
                          (cudaStream_t)stream>>>((const T*)g, (T*)out, d);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
