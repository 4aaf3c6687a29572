// Hand-written Hopper (sm_90a) kernels of the coordinate-wise GARs: the
// port's counterpart of `byzantinemomentum_tpu/ops/pallas_sort.py`.
//
// Built by `byzantinemomentum_tpu_torch/ops/sort_kernels.py`, one shared
// library per (kernel, row count n, element type) that a run meets, each
// at its first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DBMT_SORT_KERNEL=<K> -DBMT_N=<n> -DBMT_DTYPE=<T> \
//        [-DBMT_M=<m>] -o <build>/lib...so sort_kernels.cu
// K = 1 lower_median, 2 trimmed_mean, 3 closest_mean, 4 colsort;
// 1 <= n <= kMaxRows; T = 1 f32, 2 bf16, 3 f16 (the JAX kernels' dtypes);
// closest_mean also takes its 1 <= m <= n, for which its network is
// pruned (a caller meets a few: n - f from Phocas and MeaMed, Bulyan's m2
// on a half stack).
// The sorting network is unrolled for n, and its compile time grows
// steeply with n (140 compare-exchanges at n = 25, 543 at n = 64), so
// only the libraries in use are built. Each library exports
// `bmt_sort_n`, `bmt_sort_kernel`, `bmt_sort_dtype`, `bmt_sort_m` and its
// one entry,
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
// closest_mean: replaces `pallas_sort.py::closest_mean` (`_closest_kernel`,
// with `closest_mean_values`), the mean of the m values of each column
// closest to c[j] (`bmt::closest_mean_keyed`).
// colsort: replaces `pallas_sort.py::colsort` (`_colsort_kernel`), every
// column sorted, NaN last: the lower_median network, writing all n rows.
//   Bound: bytes. lower_median, trimmed_mean and closest_mean read g once
//   and write one (d,) row (closest_mean also reads c): 136.3 MB
//   (141.6 MB) at f32[25, 1,310,922], half that in bf16 or f16. colsort
//   reads and writes the whole matrix: 262.2 MB in f32. The work per
//   coordinate is one sorting network (of the values, or of closest_mean's
//   deviations) plus O(n) adds; it does not shrink with the element type,
//   so the half forms sit further above their (halved) bound.
//   Design: the TPU kernels sort (n, tile) column blocks in VMEM. Here
//   thread j owns column j: it issues all n loads of its column before
//   the first use (consecutive threads read consecutive addresses, so
//   each row's loads are coalesced and n of them are in flight), sorts in
//   registers with the template-unrolled Batcher network of `batcher.cuh`
//   and writes one T (colsort: n, each row's stores coalesced). The rank
//   bound f is a run-time argument: the loops over ranks are unrolled
//   with a predicate, so the values never leave registers.
//   closest_mean was bound by instruction issue, not bytes: its half
//   forms, half the bytes, took the time of the f32 form, since each
//   column ran the whole NaN-tested float network and computed each
//   deviation three times (each a float -> T -> float round trip in a
//   half form). It now computes each deviation once, as a key (kept in
//   registers for n <= 32, recomputed where read above that, where a
//   second array of n would spill), selects the threshold with the keyed
//   network pruned to rank m - 1 (m is a template parameter: 204 min/max
//   instructions at n = 25, m = 14, against about 840 for the float
//   network), and counts and sums by comparing keys. A thread owns V = 2
//   adjacent columns (one 8-byte f32 or 4-byte half load a row) where d
//   and the addresses allow it and n <= 32, else V = 1
//   (`ops/sort_kernels.py::closest_mean_width`).
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
#ifndef BMT_M
#define BMT_M 0
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
#if BMT_SORT_KERNEL == 3
static_assert(1 <= BMT_M && BMT_M <= BMT_N, "BMT_M outside 1..BMT_N");
#endif

// Pairs of T for the two-column loads and stores
template <typename U>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct Pair<__half> {
  using type = __half2;
};

// V consecutive T at p (aligned to V * sizeof(T)) as floats
template <int V>
__device__ __forceinline__ void load_elems(const T* p, float (&x)[V]) {
  if constexpr (V == 2) {
    const typename Pair<T>::type t =
        *reinterpret_cast<const typename Pair<T>::type*>(p);
    x[0] = E::load(t.x);
    x[1] = E::load(t.y);
  } else {
    x[0] = E::load(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_elems(T* p, const float (&x)[V]) {
  if constexpr (V == 2) {
    typename Pair<T>::type t;
    t.x = E::store(x[0]);
    t.y = E::store(x[1]);
    *reinterpret_cast<typename Pair<T>::type*>(p) = t;
  } else {
    *p = E::store(x[0]);
  }
}

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

// Columns j, j + 1, ..., j + V - 1 of each row a thread (V divides d); the
// V columns' selections run one after the other
template <int N, int M, int V>
__global__ void __launch_bounds__(kSortThreads)
closest_mean_kernel(const T* __restrict__ g, const T* __restrict__ c,
                    T* __restrict__ out, long long d) {
  const long long groups = d / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long grp = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       grp < groups; grp += stride) {
    const long long j = grp * V;
    float x[N][V], cv[V], y[V];
#pragma unroll
    for (int i = 0; i < N; ++i) load_elems<V>(g + i * d + j, x[i]);
    load_elems<V>(c + j, cv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float col[N];
#pragma unroll
      for (int i = 0; i < N; ++i) col[i] = x[i][v];
      y[v] = bmt::closest_mean_keyed<N, M, T>(col, cv[v]);
    }
    store_elems<V>(out + j, y);
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

#if BMT_SORT_KERNEL == 3
// Two columns a thread up to this many rows; past it, one (registers)
constexpr int kPairRows = bmt::kKeepDeviations;

// A template, so that the V = 2 form is not instantiated past kPairRows
template <int V>
int launch_closest_mean(const void* g, const void* c, void* out, long long d,
                        cudaStream_t stream) {
  if constexpr (V == 2 && BMT_N > kPairRows) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (d % V != 0) return (int)cudaErrorInvalidValue;
    closest_mean_kernel<BMT_N, BMT_M, V>
        <<<grid_for(d / V), kSortThreads, 0, stream>>>(
            (const T*)g, (const T*)c, (T*)out, d);
    return (int)cudaGetLastError();
  }
}

#endif

}  // namespace

extern "C" {

int bmt_sort_n() { return BMT_N; }

int bmt_sort_kernel() { return BMT_SORT_KERNEL; }

int bmt_sort_dtype() { return BMT_DTYPE; }

int bmt_sort_m() { return BMT_M; }

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
// g T[BMT_N, d], c T[d] -> out T[d], m = BMT_M; width (1, or 2 up to
// kPairRows rows) divides d, and g's and c's addresses are aligned to
// width * sizeof(T) bytes (`ops/sort_kernels.py::closest_mean_width`)
int bmt_closest_mean(const void* g, const void* c, void* out, long long d,
                     int width, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return width == 1   ? launch_closest_mean<1>(g, c, out, d, s)
         : width == 2 ? launch_closest_mean<2>(g, c, out, d, s)
                      : (int)cudaErrorInvalidValue;
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
