// The NaN-last sorting network and the closest-mean selection over a
// register array, shared by gar_kernels.cu and sort_kernels.cu (the
// port's counterpart of `byzantinemomentum_tpu/ops/pallas_sort.py`'s
// `_batcher_pairs`, `sort_values` and `closest_mean_values`).
//
// Register arrays need compile-time indices, so every function here is a
// template on the array length and every loop is unrolled: the network by
// a fold over a schedule computed at compile time, the selection by
// `#pragma unroll` over a constant trip count.
//
// One network, on keys. Each value becomes a uint32 key whose unsigned
// order is the NaN-last float order (`value_key`, `deviation_key`), so a
// compare-exchange is one `umin` and one `umax`, where the JAX package's
// float network tests NaN in every one (two compares, an `isnan` pair and
// two selects: about 840 instructions a column at n = 25). The schedule
// is Batcher's, pruned to the comparators on which the wanted output
// ranks depend (`selection_schedule`, for one rank or a window of
// consecutive ranks): at n = 25, rank 12 keeps 202 min/max instructions,
// rank 13 204, the ranks [11, 14) 212 and [5, 20) 258, and the whole
// network, colsort's full sort, 280. The kernels are bound by bytes on
// paper but were bound by instruction issue in practice (their half
// forms, half the bytes, took the same time on the float network), which
// is what the keys and the pruning cut. The half forms of lower_median,
// trimmed_mean and colsort go one step further: two columns' 16-bit keys
// in one word (`PairKey`), one packed min/max a comparator for both.
//
// Signed zero: keys order -0 below +0, where the JAX package's float
// network leaves equal values as they come. A rank read off the keyed
// network may therefore be -0 where the float network gives +0, or the
// reverse; the value is equal. A column sorted on keys holds every -0
// before every +0. Deviations hold no -0 (|x - c| >= +0), so a deviation
// key equals another exactly when the two floats are equal.
//
// NaN: `value_key` maps every NaN to one key above +inf's, and `pair_key`
// clears a half NaN's sign (its key then lies above +inf's), so a NaN may
// decode to a NaN of another sign or payload than the one loaded; every
// NaN still ranks after every other value. Every other key decodes to the
// value's bits.
//
// Element types. The JAX sorting kernels take f32, bf16 and f16 and do
// their arithmetic in the storage type. Here every value is converted to
// float when it is loaded (exact), compared as a float or a key (exact),
// and the result of every add, subtract and divide is rounded back to the
// storage type (`Elem<T>::round`). f32 carries at least 2p + 2 significand
// bits for bf16 (p = 8) and f16 (p = 11), so one f32 operation followed by
// one rounding gives the native operation's result.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace bmt {

// Loads (`load`), stores (`store`, round to nearest even) and the rounding
// of a float result to the storage type T (`round`); for the 16-bit types
// also the value of a bit pattern (`from_bits`) and +inf's bits
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return load(store(x));
  }
  static __device__ __forceinline__ float from_bits(unsigned short h) {
    return load(__ushort_as_bfloat16(h));
  }
  static constexpr uint32_t kInfBits = 0x7f80u;
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half store(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return load(store(x));
  }
  static __device__ __forceinline__ float from_bits(unsigned short h) {
    return load(__ushort_as_half(h));
  }
  static constexpr uint32_t kInfBits = 0x7c00u;
};

// ---------------------------------------------------------------------------
// The keyed selection network

// The key of a value of either sign: the usual sign flip (negative values
// all bits, the others the sign bit), after every NaN is mapped to one key
// above +inf's. Unsigned order is then the NaN-last float order, with -0
// one key below +0. `key_value` inverts it (the NaN key gives a NaN).
__device__ __forceinline__ uint32_t value_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return isnan(x) ? 0xffffffffu
                  : b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// Two 16-bit keys in one word, one a lane, for two adjacent columns of a
// bf16 or f16 matrix: one `__vminu2` or `__vmaxu2` (a `VIMNMX.U16x2` on
// sm_90a, the instruction of the 32-bit min/max) orders both lanes, where
// the f32 keys of two columns take two instructions. `pair_key<T>` keys
// the bits of a pair of T (the low lane the first): every NaN's sign is
// cleared (a lane is a NaN where its magnitude plus 0x7fff - inf's bits
// reaches bit 15, with no carry out of the lane), so every NaN keys above
// +inf, then the sign flip of `value_key` lane by lane (negative lanes all
// 16 bits, the others the sign bit: (sign * 0x7fff + 0x8000) a lane, with
// no carry). `pair_bits` inverts it (a NaN comes back as a NaN).
struct PairKey {
  uint32_t v;
};

template <typename T>
__device__ __forceinline__ PairKey pair_key(uint32_t b) {
  constexpr uint32_t kNanBias = (0x7fffu - Elem<T>::kInfBits) * 0x10001u;
  b &= ~(((b & 0x7fff7fffu) + kNanBias) & 0x80008000u);
  return {b ^ (((b >> 15) & 0x10001u) * 0x7fffu + 0x80008000u)};
}

__device__ __forceinline__ uint32_t pair_bits(PairKey k) {
  return k.v ^ ((((k.v >> 15) & 0x10001u) ^ 0x10001u) * 0x7fffu + 0x80008000u);
}

__device__ __forceinline__ uint32_t key_min(uint32_t a, uint32_t b) {
  return min(a, b);
}
__device__ __forceinline__ uint32_t key_max(uint32_t a, uint32_t b) {
  return max(a, b);
}
__device__ __forceinline__ PairKey key_min(PairKey a, PairKey b) {
  return {__vminu2(a.v, b.v)};
}
__device__ __forceinline__ PairKey key_max(PairKey a, PairKey b) {
  return {__vmaxu2(a.v, b.v)};
}

// The key of a deviation |x - c|: its bits. A deviation is +0 or more, or
// a NaN, so 0 <= finite < +inf (kInfKey) < every NaN in unsigned order
constexpr uint32_t kInfKey = 0x7f800000u;

__device__ __forceinline__ uint32_t deviation_key(float dev) {
  return __float_as_uint(dev);
}

// Batcher's schedule pruned to the comparators on which the output ranks
// [lo, hi) depend (`ops/sort_kernels.py::selection_pairs` computes the
// same). Working backwards from the output wires, a comparator that
// touches a live wire is kept and makes both its wires live; one whose
// two outputs are live exchanges (kBoth), one with only its low output
// live computes the min alone (kMin), only its high output the max alone
// (kMax). One rank r is the window [r, r + 1); [0, n) keeps every
// comparator: a full sort. Each comparator is coded as
// lo | hi << 8 | kind << 16, in network order.
constexpr int kMaxNetworkRows = 64;
constexpr int kMaxComparators = 543;  // Batcher's network of 64 rows
enum : int { kBoth = 0, kMin = 1, kMax = 2 };

struct Schedule {
  int count;
  int code[kMaxComparators];
};

constexpr Schedule selection_schedule(int n, int lo, int hi) {
  Schedule all{}, out{};
  for (int p = 1; p < n; p *= 2) {
    for (int k = p; k >= 1; k /= 2) {
      for (int j = k % p; j < n - k; j += 2 * k) {
        for (int i = 0; i < k && i < n - j - k; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            all.code[all.count++] = (i + j) | (i + j + k) << 8;
          }
        }
      }
    }
  }
  bool live[kMaxNetworkRows] = {};
  for (int w = 0; w < n; ++w) live[w] = lo <= w && w < hi;
  int kind[kMaxComparators] = {};
  for (int t = all.count - 1; t >= 0; --t) {
    const int lo = all.code[t] & 0xff, hi = all.code[t] >> 8;
    kind[t] = live[lo] && live[hi] ? kBoth : live[lo] ? kMin
              : live[hi]           ? kMax : -1;
    if (kind[t] >= 0) live[lo] = live[hi] = true;
  }
  for (int t = 0; t < all.count; ++t) {
    if (kind[t] >= 0) out.code[out.count++] = all.code[t] | kind[t] << 16;
  }
  return out;
}

template <int N, int Lo, int Hi>
struct Selection {
  static_assert(1 <= N && N <= kMaxNetworkRows && 0 <= Lo && Lo < Hi &&
                    Hi <= N,
                "selection outside the network");
  static constexpr Schedule schedule = selection_schedule(N, Lo, Hi);
};

// Scalar constants, so that device code reads no array of the host's
template <int N, int Lo, int Hi>
inline constexpr int kComparators = Selection<N, Lo, Hi>::schedule.count;
template <int N, int Lo, int Hi, int T>
inline constexpr int kComparator = Selection<N, Lo, Hi>::schedule.code[T];

// K is uint32_t (one key) or PairKey (two, lane by lane)
template <int Code, int N, typename K>
__device__ __forceinline__ void key_exchange(K (&v)[N]) {
  constexpr int lo = Code & 0xff, hi = (Code >> 8) & 0xff, kind = Code >> 16;
  if constexpr (kind == kBoth) {
    const K a = v[lo], b = v[hi];
    v[lo] = key_min(a, b);
    v[hi] = key_max(a, b);
  } else if constexpr (kind == kMin) {
    v[lo] = key_min(v[lo], v[hi]);
  } else {
    v[hi] = key_max(v[lo], v[hi]);
  }
}

template <int N, int Lo, int Hi, typename K, int... T>
__device__ __forceinline__ void key_network(K (&v)[N],
                                            std::integer_sequence<int, T...>) {
  (key_exchange<kComparator<N, Lo, Hi, T>>(v), ...);
}

// v[Lo], ..., v[Hi - 1] become the keys of ranks Lo..Hi - 1 of v (the
// other wires are left partly ordered)
template <int N, int Lo, int Hi, typename K>
__device__ __forceinline__ void key_select_window(K (&v)[N]) {
  key_network<N, Lo, Hi>(
      v, std::make_integer_sequence<int, kComparators<N, Lo, Hi>>{});
}

// v[Rank] becomes the key of rank Rank of v; with Rank = -1, v is sorted
template <int N, int Rank = -1, typename K>
__device__ __forceinline__ void key_select(K (&v)[N]) {
  if constexpr (Rank < 0) {
    key_select_window<N, 0, N>(v);
  } else {
    key_select_window<N, Rank, Rank + 1>(v);
  }
}

// Deviation keys kept in registers up to this many rows; above it a
// second array of n would spill, and each deviation is recomputed where
// it is read
constexpr int kKeepDeviations = 32;

// Deviation r: kept (Keep), or recomputed from the values
template <bool Keep, typename T, int N>
__device__ __forceinline__ uint32_t deviation_at(
    const uint32_t (&kept)[Keep ? N : 1], const float (&rows)[N], float c,
    int r) {
  if constexpr (Keep) {
    return kept[r];
  } else {
    return deviation_key(Elem<T>::round(fabsf(rows[r] - c)));
  }
}

// `pallas_sort.closest_mean_values` for a compile-time M (1 <= M <= N):
// the mean of the M values of `rows` closest to `c`. The M-th smallest
// deviation is the threshold (the keyed network pruned to rank M - 1);
// everything strictly below it is taken, then the ties at it in index
// order (stable-argsort selection); NaN where the threshold is NaN (fewer
// than M finite deviations). The sum runs over the taken rows in index
// order from +0, as the JAX kernel's add of 0 for the others does (a sum
// from +0 is never -0, so adding +0 changes no bit of it). Each deviation
// is computed once, as a key, for N <= kKeepDeviations. The values and
// `c` are those of a T array; each deviation, partial sum and the mean are
// rounded to T (the counts are small integers, exact in every T).
template <int N, int M, typename T>
__device__ __forceinline__ float closest_mean_keyed(const float (&rows)[N],
                                                    float c) {
  static_assert(1 <= M && M <= N, "M outside 1..N");
  using E = Elem<T>;
  constexpr bool kKeep = N <= kKeepDeviations;
  uint32_t srt[N];
  uint32_t kept[kKeep ? N : 1];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    srt[r] = deviation_key(E::round(fabsf(rows[r] - c)));
    if constexpr (kKeep) kept[r] = srt[r];
  }
  key_select<N, M - 1>(srt);
  const uint32_t thresh = srt[M - 1];
  int below = 0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const uint32_t dev = deviation_at<kKeep, T>(kept, rows, c, r);
    below += dev < thresh ? 1 : 0;
  }
  const int need = M - below;
  float sum = 0.0f;
  int cum = 0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const uint32_t dev = deviation_at<kKeep, T>(kept, rows, c, r);
    const bool eq = dev == thresh;
    cum += eq ? 1 : 0;
    if (dev < thresh || (eq && cum <= need)) sum = E::round(sum + rows[r]);
  }
  return thresh > kInfKey ? nanf("") : E::round(sum / (float)M);
}

}  // namespace bmt
