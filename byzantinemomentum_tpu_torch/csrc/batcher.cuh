// The NaN-last sorting network and the closest-mean selection over a
// register array, shared by gar_kernels.cu and sort_kernels.cu (the
// port's counterpart of `byzantinemomentum_tpu/ops/pallas_sort.py`'s
// `_batcher_pairs`, `sort_values` and `closest_mean_values`).
//
// Register arrays need compile-time indices, so every function here is a
// template on the array length and every loop is unrolled: the network by
// template recursion, the selection by `#pragma unroll` over a constant
// trip count.
//
// Element types. The JAX sorting kernels take f32, bf16 and f16 and do
// their arithmetic in the storage type. Here every value is converted to
// float when it is loaded (exact), compared as a float (exact), and the
// result of every add, subtract and divide is rounded back to the storage
// type (`Elem<T>::round`). f32 carries at least 2p + 2 significand bits
// for bf16 (p = 8) and f16 (p = 11), so one f32 operation followed by one
// rounding gives the native operation's result.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace bmt {

// Loads (`load`), stores (`store`, round to nearest even) and the rounding
// of a float result to the storage type T (`round`)
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
};

// NaN-last compare-exchange (`pallas_sort.sort_values`):
// swap = (b < a) | (isnan(a) & !isnan(b))
__device__ __forceinline__ void cmp_swap(float& a, float& b) {
  const bool swap = (b < a) || (isnan(a) && !isnan(b));
  const float lo = swap ? b : a;
  const float hi = swap ? a : b;
  a = lo;
  b = hi;
}

// Batcher odd-even mergesort, the exact schedule of
// `pallas_sort._batcher_pairs(R)`:
//   for p = 1, 2, 4, ... < R:
//     for k = p, p/2, ..., 1:
//       for j = k % p; j < R - k; j += 2k:
//         for i = 0; i < min(k, R - j - k); ++i:
//           if (i + j) / 2p == (i + j + k) / 2p: cmp_swap(v[i + j], v[i + j + k])
// Each loop is a compile-time recursion, so every index is a constant and
// `v` stays in registers (`#pragma unroll` over the same nest leaves some
// R partly rolled, which puts `v` in local memory)
template <int R, int P, int K, int J, int I>
__device__ __forceinline__ void batcher_i(float (&v)[R]) {
  if constexpr (I < K && I < R - J - K) {
    if constexpr ((I + J) / (2 * P) == (I + J + K) / (2 * P)) {
      cmp_swap(v[I + J], v[I + J + K]);
    }
    batcher_i<R, P, K, J, I + 1>(v);
  }
}

template <int R, int P, int K, int J>
__device__ __forceinline__ void batcher_j(float (&v)[R]) {
  if constexpr (J < R - K) {
    batcher_i<R, P, K, J, 0>(v);
    batcher_j<R, P, K, J + 2 * K>(v);
  }
}

template <int R, int P, int K>
__device__ __forceinline__ void batcher_k(float (&v)[R]) {
  if constexpr (K >= 1) {
    batcher_j<R, P, K, K % P>(v);
    batcher_k<R, P, K / 2>(v);
  }
}

template <int R, int P>
__device__ __forceinline__ void batcher_p(float (&v)[R]) {
  if constexpr (P < R) {
    batcher_k<R, P, P>(v);
    batcher_p<R, 2 * P>(v);
  }
}

template <int R>
__device__ __forceinline__ void batcher_sort(float (&v)[R]) {
  batcher_p<R, 1>(v);
}

// `pallas_sort.closest_mean_values`: the mean of the m (1 <= m <= R)
// values of `rows` closest to `c`. The m-th smallest deviation is the
// threshold; everything strictly below it is taken, then the ties at it in
// index order (stable-argsort selection); NaN where the threshold is NaN
// (fewer than m finite deviations). The sum runs in index order, adding 0
// for the rows not taken, as the JAX kernel does. `srt` is scratch.
// Deviations are recomputed where they are read rather than kept: at 62
// or 64 values a third register array would spill. The values and `c`
// are those of a T array; each deviation, partial sum and the mean are
// rounded to T (the counts are small integers, exact in every T).
template <int R, typename T = float>
__device__ __forceinline__ float closest_mean_values(const float (&rows)[R],
                                                     float c, int m,
                                                     float (&srt)[R]) {
  using E = Elem<T>;
#pragma unroll
  for (int r = 0; r < R; ++r) srt[r] = E::round(fabsf(rows[r] - c));
  batcher_sort<R>(srt);
  float thresh = srt[0];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if (r == m - 1) thresh = srt[r];
  }
  float need = (float)m;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    need -= E::round(fabsf(rows[r] - c)) < thresh ? 1.0f : 0.0f;
  }
  float sum = 0.0f, cum = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float dev = E::round(fabsf(rows[r] - c));
    const bool eq = dev == thresh;
    cum += eq ? 1.0f : 0.0f;
    const bool take = dev < thresh || (eq && cum <= need);
    sum = E::round(sum + (take ? rows[r] : 0.0f));
  }
  return isnan(thresh) ? nanf("") : E::round(sum / (float)m);
}

}  // namespace bmt
