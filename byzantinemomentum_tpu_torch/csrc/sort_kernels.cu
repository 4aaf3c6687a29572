// Hand-written Hopper (sm_90a) kernels of the coordinate-wise GARs: the
// port's counterpart of `byzantinemomentum_tpu/ops/pallas_sort.py`.
//
// Built by `byzantinemomentum_tpu_torch/ops/sort_kernels.py`, one shared
// library per (kernel, row count n, element type) that a run meets, each
// at its first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DBMT_SORT_KERNEL=<K> -DBMT_N=<n> -DBMT_DTYPE=<T> \
//        [-DBMT_M=<m> | -DBMT_F=<f>] -o <build>/lib...so sort_kernels.cu
// K = 1 lower_median, 2 trimmed_mean, 3 closest_mean, 4 colsort;
// 1 <= n <= kMaxRows; T = 1 f32, 2 bf16, 3 f16 (the JAX kernels' dtypes);
// closest_mean also takes its 1 <= m <= n, for which its network is
// pruned (a caller meets a few: n - f from Phocas and MeaMed, Bulyan's m2
// on a half stack), and trimmed_mean its trim 0 <= f < n / 2, for which
// its network is pruned to the ranks [f, n - f) (Trimmed mean and Phocas
// meet the f of their run).
// The sorting network is unrolled for n, and its compile time grows
// steeply with n (140 compare-exchanges at n = 25, 543 at n = 64), so
// only the libraries in use are built. Each library exports
// `bmt_sort_n`, `bmt_sort_kernel`, `bmt_sort_dtype`, `bmt_sort_m`,
// `bmt_sort_f` and its one entry, which launches on the stream it is
// given, allocates nothing and returns cudaGetLastError(). Operands and
// outputs are T arrays; the entries take them as untyped pointers, since
// the element type is the library's.
//
// Arithmetic (`batcher.cuh`, `Elem<T>`): values are converted to float as
// they are loaded, compared as floats or order keys, and every add,
// subtract and divide is rounded to T, so a bf16 or f16 result is the one
// the JAX kernel's storage-type arithmetic gives. Outputs are T.
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
// column sorted, NaN last, on the whole keyed network
// (`bmt::key_select<N, -1>`: every comparator two-sided, 280 min/max at
// n = 25).
//   Bound: bytes. lower_median, trimmed_mean and closest_mean read g once
//   and write one (d,) row (closest_mean also reads c): 136.3 MB
//   (141.6 MB) at f32[25, 1,310,922], half that in bf16 or f16. colsort
//   reads and writes the whole matrix: 262.2 MB in f32. The work per
//   coordinate is one sorting network (of the values, or of closest_mean's
//   deviations) plus O(n) adds; it does not shrink with the element type,
//   so the half forms sit further above their (halved) bound.
//   Design: the TPU kernels sort (n, tile) column blocks in VMEM. Here a
//   thread owns V adjacent columns: it issues all n loads of its columns
//   before the first use (consecutive threads read consecutive addresses,
//   so each row's loads are coalesced and n of them are in flight),
//   selects in registers and writes V T (colsort: n rows, stored row by
//   row, each row's stores coalesced). V = 2 (one 8-byte f32 or 4-byte
//   half load a row) where d and the addresses (colsort's output's too)
//   allow it and n <= kPairRows, else V = 1
//   (`ops/sort_kernels.py::column_width`). colsort moves every value, and
//   its network hides behind its bytes: on the card its time followed the
//   bytes a thread moves a row, not its instructions (`PERF.md`). Its two-
//   column form therefore moves its rows through shared memory in 16-byte
//   chunks aligned to the rows' 32-byte sectors (`colsort_tile_kernel`),
//   which made its half forms 5-9% faster than 4- and 8-byte loads and
//   stores straight from each thread, and left f32 where it was.
//   The four kernels were bound by instruction issue, not bytes, on the
//   NaN-tested float network: their half forms, half the bytes, took the
//   time of the f32 forms (about 840 instructions a column at n = 25, six
//   a compare-exchange). They now key every value once (`bmt::value_key`:
//   no arithmetic touches a value, so a rank decodes to the value itself,
//   bit for bit, a NaN to a NaN) and run the keyed network, whole for
//   colsort (280 min/max at n = 25), pruned to what they read for the
//   others: lower_median to rank (n - 1) / 2 (202 min/max instructions
//   at n = 25); trimmed_mean to the window [f, n - f)
//   (f a template parameter: 212 at f = 11, 258 at f = 5, 280 at f = 0),
//   whose ranks it decodes and sums in rank order, rounding each add to T,
//   exactly as the JAX kernel and the plain version do; closest_mean
//   computes each deviation once, as a key (kept in registers for
//   n <= 32, recomputed where read above that, where a second array of n
//   would spill), selects the threshold with the network pruned to rank
//   m - 1 (204 min/max at n = 25, m = 14) and counts and sums by comparing
//   keys. Keys order -0 below +0, so a median or a zero sum may come back
//   as the other signed zero (`batcher.cuh`), an equal value.
//   On the keyed network the half forms were still held by integer issue
//   (Hopper runs 32-bit integer min/max and logic at half the f32 rate):
//   at two columns a thread, lower_median and trimmed_mean in bf16 and f16
//   key both columns of a row in one word (`bmt::PairKey`: one 4-byte
//   load, about 7 key instructions and one `VIMNMX.U16x2` a comparator for
//   both columns), which cut their time by a sixth to a fifth on the card
//   (`PERF.md`); so does colsort. The median, and each rank colsort
//   stores, is the pair's bits, decoded, stored as they are. A thread owning two columns was no slower than one
//   in every form measured, and faster in the packed half forms.
//   colsort's output is every value, so its keys' two divergences from the
//   float network show in it: a column holding -0 and +0 comes back with
//   every -0 first, and a NaN comes back as a NaN of another sign or
//   payload (`batcher.cuh`). Values and NaN positions are exact.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>

#include <stdint.h>

#include <type_traits>

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
#ifndef BMT_F
#define BMT_F 0
#endif

namespace {

constexpr int kMaxRows = 64;  // MAX_ROWS of the JAX package
constexpr int kSortThreads = 256;
// Two columns a thread up to this many rows; past it, one (registers;
// `ops/sort_kernels.py::PAIR_ROWS`)
constexpr int kPairRows = 32;
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
#if BMT_SORT_KERNEL == 2
static_assert(0 <= BMT_F && 2 * BMT_F < BMT_N, "BMT_F outside 0 <= f < n/2");
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

// Columns j..j + V - 1 of g (T[N, d], row-major) as floats x[row][column]:
// every load issued before any use
template <int N, int V>
__device__ __forceinline__ void load_columns(const T* __restrict__ g,
                                             long long d, long long j,
                                             float (&x)[N][V]) {
#pragma unroll
  for (int i = 0; i < N; ++i) load_elems<V>(g + i * d + j, x[i]);
}

// The order keys of column v of x
template <int N, int V>
__device__ __forceinline__ void column_keys(const float (&x)[N][V], int v,
                                            uint32_t (&k)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = bmt::value_key(x[i][v]);
}

// The half forms at two columns a thread key both columns of a row in one
// word (`bmt::PairKey`): one load, one key and one min/max a row for both
template <int V>
inline constexpr bool kPairKeys = V == 2 && sizeof(T) == 2;

template <int N>
__device__ __forceinline__ void load_pair_keys(const T* __restrict__ g,
                                               long long d, long long j,
                                               bmt::PairKey (&k)[N]) {
  uint32_t bits[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bits[i] = *reinterpret_cast<const uint32_t*>(g + i * d + j);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = bmt::pair_key<T>(bits[i]);
}

// Lane `lane` (0: the first column) of a pair of T's bits, as a float (a
// template, so that it exists for the 16-bit T only)
template <typename U = T>
__device__ __forceinline__ float pair_lane(uint32_t bits, int lane) {
  return bmt::Elem<U>::from_bits((unsigned short)(bits >> (16 * lane)));
}

// Columns j, j + 1, ..., j + V - 1 a thread (V divides d); the V columns'
// networks are independent, so the unrolled code interleaves them
template <int N, int V>
__global__ void __launch_bounds__(kSortThreads)
lower_median_kernel(const T* __restrict__ g, T* __restrict__ out,
                    long long d) {
  constexpr int kMid = (N - 1) / 2;
  const long long groups = d / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long grp = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       grp < groups; grp += stride) {
    const long long j = grp * V;
    if constexpr (kPairKeys<V>) {
      bmt::PairKey k[N];
      load_pair_keys<N>(g, d, j, k);
      bmt::key_select<N, kMid>(k);
      *reinterpret_cast<uint32_t*>(out + j) = bmt::pair_bits(k[kMid]);
    } else {
      float x[N][V], y[V];
      load_columns<N, V>(g, d, j, x);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint32_t k[N];
        column_keys<N, V>(x, v, k);
        bmt::key_select<N, kMid>(k);
        y[v] = bmt::key_value(k[kMid]);
      }
      store_elems<V>(out + j, y);
    }
  }
}

template <int N, int F, int V>
__global__ void __launch_bounds__(kSortThreads)
trimmed_mean_kernel(const T* __restrict__ g, T* __restrict__ out,
                    long long d) {
  const long long groups = d / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long grp = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       grp < groups; grp += stride) {
    const long long j = grp * V;
    // -0 + x == x for every x, so starting from -0 the first add is the
    // JAX kernel's `acc = rows[f]` exactly
    float acc[V], y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = -0.0f;
    if constexpr (kPairKeys<V>) {
      bmt::PairKey k[N];
      load_pair_keys<N>(g, d, j, k);
      bmt::key_select_window<N, F, N - F>(k);
#pragma unroll
      for (int i = F; i < N - F; ++i) {
        const uint32_t bits = bmt::pair_bits(k[i]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[v] = E::round(acc[v] + pair_lane(bits, v));
        }
      }
    } else {
      float x[N][V];
      load_columns<N, V>(g, d, j, x);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint32_t k[N];
        column_keys<N, V>(x, v, k);
        bmt::key_select_window<N, F, N - F>(k);
#pragma unroll
        for (int i = F; i < N - F; ++i) {
          acc[v] = E::round(acc[v] + bmt::key_value(k[i]));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) y[v] = acc[v] / (float)(N - 2 * F);
    store_elems<V>(out + j, y);
  }
}

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
    load_columns<N, V>(g, d, j, x);
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

// colsort, one column a thread: every rank stored row by row (each row's
// stores coalesced across the warp)
template <int N>
__global__ void __launch_bounds__(kSortThreads)
colsort_kernel(const T* __restrict__ g, T* __restrict__ out, long long d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float x[N][1];
    load_columns<N, 1>(g, d, j, x);
    uint32_t k[N];
    column_keys<N, 1>(x, 0, k);
    bmt::key_select<N>(k);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i * d + j] = E::store(bmt::key_value(k[i]));
  }
}

// colsort, two columns a thread, through shared memory: a block sorts a
// tile of 2 * kTileThreads columns. Each row of the tile comes in and
// goes out as 16-byte chunks that start at the row's first 32-byte
// sector, shared out over the block (a warp moves 512 contiguous bytes an
// instruction, and no sector is cut); a thread takes its two columns of
// every row from shared memory, sorts them on the keyed network (the
// half forms as one pair key) and puts them back in the output's layout. On the way in a
// chunk is cut to the operand's bytes (the first row's first chunks, the
// last row's last); on the way out the chunks at a tile's two ends are
// written word by word, the words of the tile only.
constexpr int kTileThreads = 128;

// Asynchronous copies to shared memory: 16 bytes of which the first
// `bytes` are read (the rest zero-filled), or one 4-byte word
__device__ __forceinline__ void stage_chunk(void* dst, const void* src,
                                            int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void stage_word(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Byte offset of `row` within its 32-byte sector
__device__ __forceinline__ int sector_offset(const T* row) {
  return (int)(reinterpret_cast<uintptr_t>(row) & 31u);
}

template <int N>
__global__ void __launch_bounds__(kTileThreads)
colsort_tile_kernel(const T* __restrict__ g, T* __restrict__ out,
                    long long d) {
  constexpr int kCols = 2 * kTileThreads;
  // A row's chunks: its bytes and up to 31 before them
  constexpr int kChunks = kCols * (int)sizeof(T) / 16 + 2;
  __shared__ uint4 stage[N][kChunks];
  const uintptr_t g_lo = reinterpret_cast<uintptr_t>(g);
  const uintptr_t g_hi = reinterpret_cast<uintptr_t>(g + N * d);
  const long long tiles = (d + kCols - 1) / kCols;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long j0 = tile * kCols;
    const int bytes = (int)min((long long)kCols, d - j0) * (int)sizeof(T);
    for (int c = threadIdx.x; c < N * kChunks; c += kTileThreads) {
      const int i = c / kChunks, k = c % kChunks;
      const uintptr_t first = reinterpret_cast<uintptr_t>(g + i * d + j0);
      const uintptr_t at = (first & ~(uintptr_t)31) + 16 * k;
      if (at >= first + bytes) continue;
      if (at >= g_lo) {
        stage_chunk(&stage[i][k], reinterpret_cast<const void*>(at),
                    (int)min((uintptr_t)16, g_hi - at));
      } else {
#pragma unroll
        for (int w = 0; w < 16; w += 4) {
          if (at + w >= g_lo) {
            stage_word(reinterpret_cast<char*>(&stage[i][k]) + w,
                       reinterpret_cast<const void*>(at + w));
          }
        }
      }
    }
    stage_wait();
    __syncthreads();
    // This thread's two columns of row i lie at byte `in_at(i)` of the
    // row's chunks, and go out at `out_at(i)`
    auto in_at = [&](int i) {
      return reinterpret_cast<char*>(stage[i]) + sector_offset(g + i * d + j0) +
             2 * sizeof(T) * threadIdx.x;
    };
    auto out_at = [&](int i) {
      return reinterpret_cast<char*>(stage[i]) +
             sector_offset(out + i * d + j0) + 2 * sizeof(T) * threadIdx.x;
    };
    if constexpr (sizeof(T) == 4) {
      uint32_t k[2][N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const uint2 w = *reinterpret_cast<const uint2*>(in_at(i));
        k[0][i] = bmt::value_key(__uint_as_float(w.x));
        k[1][i] = bmt::value_key(__uint_as_float(w.y));
      }
      bmt::key_select<N>(k[0]);
      bmt::key_select<N>(k[1]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < N; ++i) {
        *reinterpret_cast<uint2*>(out_at(i)) =
            make_uint2(__float_as_uint(bmt::key_value(k[0][i])),
                       __float_as_uint(bmt::key_value(k[1][i])));
      }
    } else {
      bmt::PairKey k[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        k[i] = bmt::pair_key<T>(*reinterpret_cast<const uint32_t*>(in_at(i)));
      }
      bmt::key_select<N>(k);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < N; ++i) {
        *reinterpret_cast<uint32_t*>(out_at(i)) = bmt::pair_bits(k[i]);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < N * kChunks; c += kTileThreads) {
      const int i = c / kChunks, k = c % kChunks;
      const uintptr_t first = reinterpret_cast<uintptr_t>(out + i * d + j0);
      const uintptr_t at = (first & ~(uintptr_t)31) + 16 * k;
      const uintptr_t end = first + bytes;
      if (at >= end) continue;
      const uint4 v = stage[i][k];
      if (at >= first && at + 16 <= end) {
        *reinterpret_cast<uint4*>(at) = v;
      } else {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (at + 4 * q >= first && at + 4 * q < end) {
            *reinterpret_cast<uint32_t*>(at + 4 * q) = w[q];
          }
        }
      }
    }
    __syncthreads();  // the chunks are refilled for the next tile
  }
}

unsigned grid_for(long long d) {
  long long blocks = (d + kSortThreads - 1) / kSortThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  return (unsigned)blocks;
}

// Launch the V-column form of a kernel: `launch(std::integral_constant<int,
// V>, grid)` enqueues it. A template, so that the V = 2 form is not
// instantiated past kPairRows
template <int V, typename Launch>
int launch_form(long long d, Launch launch) {
  if constexpr (V == 2 && BMT_N > kPairRows) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (d % V != 0) return (int)cudaErrorInvalidValue;
    launch(std::integral_constant<int, V>{}, grid_for(d / V));
    return (int)cudaGetLastError();
  }
}

// The form of `width` columns a thread: 1, or 2 up to kPairRows rows; width
// divides d, and the operands' addresses are aligned to width * sizeof(T)
// bytes (`ops/sort_kernels.py::column_width`)
template <typename Launch>
int launch_width(int width, long long d, Launch launch) {
  return width == 1   ? launch_form<1>(d, launch)
         : width == 2 ? launch_form<2>(d, launch)
                      : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int bmt_sort_n() { return BMT_N; }

int bmt_sort_kernel() { return BMT_SORT_KERNEL; }

int bmt_sort_dtype() { return BMT_DTYPE; }

int bmt_sort_m() { return BMT_M; }

int bmt_sort_f() { return BMT_F; }

#if BMT_SORT_KERNEL == 1
// g T[BMT_N, d] -> out T[d], `width` columns a thread
int bmt_lower_median(const void* g, void* out, long long d, int width,
                     void* stream) {
  return launch_width(width, d, [&](auto v, unsigned grid) {
    lower_median_kernel<BMT_N, decltype(v)::value>
        <<<grid, kSortThreads, 0, (cudaStream_t)stream>>>((const T*)g,
                                                          (T*)out, d);
  });
}
#elif BMT_SORT_KERNEL == 2
// g T[BMT_N, d] -> out T[d], f = BMT_F, `width` columns a thread
int bmt_trimmed_mean(const void* g, void* out, long long d, int width,
                     void* stream) {
  return launch_width(width, d, [&](auto v, unsigned grid) {
    trimmed_mean_kernel<BMT_N, BMT_F, decltype(v)::value>
        <<<grid, kSortThreads, 0, (cudaStream_t)stream>>>((const T*)g,
                                                          (T*)out, d);
  });
}
#elif BMT_SORT_KERNEL == 3
// g T[BMT_N, d], c T[d] -> out T[d], m = BMT_M, `width` columns a thread
int bmt_closest_mean(const void* g, const void* c, void* out, long long d,
                     int width, void* stream) {
  return launch_width(width, d, [&](auto v, unsigned grid) {
    closest_mean_kernel<BMT_N, BMT_M, decltype(v)::value>
        <<<grid, kSortThreads, 0, (cudaStream_t)stream>>>(
            (const T*)g, (const T*)c, (T*)out, d);
  });
}
#else
// g T[BMT_N, d] -> out T[BMT_N, d], `width` columns a thread (out's
// address aligned as g's)
int bmt_colsort(const void* g, void* out, long long d, int width,
                void* stream) {
  return launch_width(width, d, [&](auto v, unsigned grid) {
    if constexpr (decltype(v)::value == 1) {
      colsort_kernel<BMT_N><<<grid, kSortThreads, 0, (cudaStream_t)stream>>>(
          (const T*)g, (T*)out, d);
    } else {
      const long long tiles = (d + 2 * kTileThreads - 1) / (2 * kTileThreads);
      colsort_tile_kernel<BMT_N>
          <<<(unsigned)(tiles < 65535LL * 32 ? tiles : 65535LL * 32),
             kTileThreads, 0, (cudaStream_t)stream>>>((const T*)g, (T*)out, d);
    }
  });
}
#endif

}  // extern "C"
