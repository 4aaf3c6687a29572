// Hand-written Hopper (sm_90a) kernels of the Bulyan training path.
//
// Built by `byzantinemomentum_tpu_torch/ops/gar_kernels.py`, one shared
// library per compilation, each at its first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DBMT_ROUNDS=<R> -o <build>/lib...so gar_kernels.cu
// R = 0 gives the library of sq_gram, weighted_rows_mean and
// masked_rows_mean; R in
// 1..kMaxRounds gives the
// selected_median_mean library for R stage-1 rounds (a caller builds only
// the round counts it meets: the compile time grows steeply with the
// count, whose network is unrolled into straight-line code). Each is bound through the plain C
// entries at the bottom of this file (ctypes). Every entry launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// Arithmetic is true f32 with FFMA: no TF32, no tensor-core dot. The
// distance orderings that drive Bulyan's selection and the NaN contracts
// of the averaging depend on it (the JAX package pins precision=HIGHEST
// for the same reason).
//
// ---------------------------------------------------------------------------
// sq_gram: replaces `byzantinemomentum_tpu/ops/pallas_gar.py::sq_gram`
// (`_gram_kernel`), the streamed g @ g.T behind
// `_common.pairwise_distances`.
//   Bound: bytes. At the headline shape f32[25, 1,310,922] it must read
//   131.1 MB once and writes 2.5 KB: 0.039 ms at 3.35 TB/s; its 426 M
//   multiply-adds take 0.013 ms at the f32 FFMA peak.
//   Design: the TPU kernel carries the (n, n) sum across a sequential grid;
//   GPU blocks run in no order, so this takes two passes. Pass 1
//   (`gram_tiled_kernel`): a persistent grid (as many blocks as fit on the
//   card) walks the (n, tile)-column slabs of g. Each block double-buffers
//   its slabs in shared memory (a ring of kGramStages = 2), filled by
//   `cp.async` copies of 4, 8 or 16 bytes (the widest that the row pitch
//   d * 4 and g's address allow), so the next slab is in flight while one
//   is consumed; the ragged last slab is zero-filled past d by the copy
//   itself. The Gram is register-tiled: the rows form ceil(n / B) blocks
//   of B (rows past n are zero and never written), and each group of 8
//   threads owns one pair (I, J) of row blocks of the upper triangle, over
//   a slice of the slab's columns: a thread reads B + B float4s of shared
//   memory per 4 columns and does 4 B^2 FMAs into B^2 registers. Each
//   8-thread group reads 128 consecutive bytes of one row, one
//   conflict-free phase of a 16-byte shared load. B weighs the FMAs
//   against the shared reads (`ops/gar_kernels.py::gram_geometry`): B = 5
//   at n = 25 (15 block pairs, no padding, 150 floats read and 375 FMAs a
//   column), B = 8 at n = 64. At the end each pair's 8 lanes are summed
//   by a fixed shuffle tree and the column slices in index order; the
//   block writes its partial triangle to an f32[blocks, pairs] scratch.
//   Shared memory past 48 KB (2 slabs of 64 rows at n = 64) is admitted
//   once per plan by the occupancy query (`resident_blocks`). Pass 2
//   (`gram_reduce_kernel`): one warp per pair sums the partials in a
//   fixed order (strided lanes, then a fixed shuffle tree) and mirrors
//   the triangle. No atomics, so repeated runs give identical distances
//   and identical selections.
//   Why not TMA: a tensor map needs a row pitch that is a multiple of
//   16 bytes, and the headline's d * 4 = 5,243,688 B is not; its odd rows
//   start 8 bytes off 16-byte alignment, which rules out
//   `cp.async.bulk` too. Per-thread `cp.async` takes any 4-byte-aligned
//   row.
//
// selected_median_mean: replaces
// `byzantinemomentum_tpu/ops/pallas_gar.py::selected_median_mean`
// (`_bulyan_tail_kernel`, with `_select_rows`, `pallas_sort.sort_values` and
// `pallas_sort.closest_mean_values` inlined).
//   Bound: bytes. It reads g once and writes one (d,) row: 136.3 MB at
//   the headline shape f32[25, 1,310,922], 0.0407 ms at 3.35 TB/s. The
//   work per coordinate is rounds * n multiply-adds plus the selection
//   over `rounds` values. The first form of this kernel ran at 3x that
//   bound on instruction issue: 16 padded rounds of FMAs, two NaN-tested
//   float networks over the stack and each deviation computed three
//   times were more instructions a column than the card issues in the
//   bytes' time.
//   Design (`selected_median_mean_kernel`): stage 1 is
//   `rows_mean_kernel`'s machinery, a persistent grid (blocks from the
//   occupancy query) staging W and the selection masks once a block, V = 2
//   consecutive columns a thread (float2; V = 1 where d or g's address
//   rule it out, or past kMedianPairRounds rounds, where the registers
//   would not hold two stacks), chunks of rows with the next in flight,
//   and FMAs for the R rounds only (W is padded to a multiple of 4 in
//   shared memory, for 16-byte reads, not in the FMAs). Stage 2
//   (`median_closest_mean`) sorts the stack once with the keyed network
//   of `batcher.cuh` (one umin and one umax a comparator, no NaN test),
//   reads the median off it, and finds the closest-mean threshold by a
//   walk of m2 - 1 steps out from the median over the sorted stack,
//   instead of a second network; a column whose median is +-inf takes
//   the keyed network over its deviations instead (the walk's argument
//   fails there). The (rounds,) stack, its non-finite flags (one bit
//   each) and the keys stay in registers: the (rounds, d) stack never
//   reaches device memory. Register arrays need compile-time indices, so
//   the kernel is a template on ROUNDS, built for any of 1..kMaxRounds
//   (62, every count n <= 64 rows can give). With m2 == 1 the result is
//   the median, which may be -0 where the JAX kernel gives +0 or the
//   reverse (keys order -0 below +0): an equal value.
//
// weighted_rows_mean: replaces
// `byzantinemomentum_tpu/ops/pallas_gar.py::weighted_rows_mean`
// (`_wmean_kernel`), Krum's selected-row average `w @ g` under
// `_select_rows`' non-finite contract.
//   Bound: bytes. At the headline shape it reads g once (131.1 MB) and
//   writes r rows of d (5.2 MB for Krum's one row): 0.041 ms; r * n
//   multiply-adds a coordinate.
//   Design (`rows_mean_kernel`): a persistent grid (as many blocks as fit
//   on the card), each block staging W and the selection masks in shared
//   memory once and then walking many column groups. A thread owns V
//   consecutive columns (V = 4, 2 or 1: the widest vector that d and g's
//   address allow; the headline's d = 2 mod 4 takes float2), loads a
//   chunk of kChunkFloats / V rows before it uses any, and issues the
//   next chunk's loads before it sums the current one. Small chunks keep
//   the registers low and the SMs full of warps, which is what carries
//   the bytes: loading all 25 rows of a group at once held one block per
//   SM and was slower (PERF.md). A block computes RB rows of W
//   (1 for Krum's w f32[n], else 64), so g is read once for any r <= 64;
//   rows past r weigh 0 and are not written. Each
//   column's sum is Bulyan's stage 1 (`pallas_gar._select_rows`): `fmaf`
//   over rows 0..n-1 in index order from +0, non-finite values excluded,
//   NaN where a row of W selects one.
//
// masked_rows_mean: replaces
// `byzantinemomentum_tpu/ops/pallas_gar.py::masked_rows_mean`
// (`_masked_mean_kernel`), Brute's subset mean
// `sum(where(mask, g, 0)) / k` under Brute's non-finite contract, not
// `_select_rows`': a selected +inf stays +inf, a selected NaN or
// inf - inf gives NaN, an excluded row is never read.
//   Bound: bytes. It must read the k selected rows of g once and write one
//   (d,) row: 78.6 MB for Brute's 14 of 25 rows at the headline shape;
//   k adds a coordinate.
//   Design: the TPU kernel reads the whole (n, tile) block and zeroes the
//   excluded rows. Here each block first lists the selected rows in shared
//   memory (n <= 64, one thread), so the excluded rows cost no bytes; then
//   thread j owns column j and loads 8 selected rows ahead of their use
//   (each row's loads coalesced). The sum runs over the selected rows in
//   index order from +0: skipping an excluded row is the JAX kernel's add
//   of +0, which changes no sum that starts at +0.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "batcher.cuh"

#ifndef BMT_ROUNDS
#define BMT_ROUNDS 0
#endif

namespace {

constexpr int kMaxRows = 64;              // MAX_ROWS of the JAX package
constexpr int kRowChunk = 8;  // masked_rows_mean: rows loaded ahead a thread
constexpr int kMaxRounds = kMaxRows - 2;  // n - 2f - 2 with f >= 0
constexpr int kMeanThreads = 256;
// sq_gram (`ops/gar_kernels.py` holds the same numbers and checks them)
constexpr int kGramStages = 2;        // slabs in the cp.async ring
constexpr int kGramMaxBlock = 8;      // largest row block B
constexpr int kGramMaxThreads = 288;  // 36 block pairs of 8 threads
// weighted_rows_mean: floats of g a thread loads per chunk of rows
constexpr int kChunkFloats = 8;
static_assert(0 <= BMT_ROUNDS && BMT_ROUNDS <= kMaxRounds,
              "BMT_ROUNDS outside 0..kMaxRounds");

#if BMT_ROUNDS == 0

__device__ __forceinline__ void pair_of(int p, int n, int* i, int* j) {
  // Row-major upper triangle (i <= j): row i holds n - i pairs
  int row = 0;
  while (p >= n - row) {
    p -= n - row;
    ++row;
  }
  *i = row;
  *j = row + p;
}

// Asynchronous copy of CW bytes from device to shared memory; the bytes
// past `src_bytes` (0..CW) are zero-filled and not read
template <int CW>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CW == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(CW), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed copy groups of this thread are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns [c0, c0 + tile) of rows 0..n-1 of g into the slab at dst (row
// pitch `tile`), zero past d: this thread's copies, chunks q0, q0 +
// per_row, ... of rows r0, r0 + row_step, ...
template <int CW>
__device__ __forceinline__ void issue_slab(const float* __restrict__ g,
                                           float* dst, int n, long long d,
                                           long long c0, int chunks, int q0,
                                           int per_row, int r0, int row_step,
                                           int tile) {
  constexpr int kCopyFloats = CW / 4;
  for (int q = q0; q < chunks; q += per_row) {
    const long long c = c0 + (long long)q * kCopyFloats;
    const long long left = d - c;
    const int valid = left <= 0 ? 0 : left < kCopyFloats ? (int)left
                                                         : kCopyFloats;
    const float* src = valid ? g + c : g;
    const long long src_step = valid ? d : 0;
    for (int row = r0; row < n; row += row_step) {
      copy_async<CW>(dst + row * tile + q * kCopyFloats, src + row * src_step,
                     valid * 4);
    }
  }
}

// Pass 1 of sq_gram. Shared memory: kGramStages slabs of (nb * B, tile)
// floats, row pitch `tile`; rows n..nb * B - 1 stay 0. Thread t is lane
// t % 8 of unit t / 8; unit u < pairs * slices owns block pair u / slices
// over column slice u % slices, i.e. the float4s s * 8 + lane + k *
// slices * 8 of each slab row. `tile` is a multiple of 32 * slices.
// (An explicit minimum of one block an SM: with the bound alone, ptxas
// held some forms to fewer registers than they need and spilled.)
template <int B, int CW>
__global__ void __launch_bounds__(kGramMaxThreads, 1)
gram_tiled_kernel(const float* __restrict__ g, float* __restrict__ partial,
                  int n, long long d, int slices, int tile) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCopyFloats = CW / 4;
  const int nb = (n + B - 1) / B;
  const int pairs = nb * (nb + 1) / 2;
  const int stage_floats = nb * B * tile;
  const int tid = threadIdx.x;
  const int unit = tid >> 3, lane = tid & 7;
  const bool active = unit < pairs * slices;
  const int p = active ? unit / slices : 0;
  const int s = unit - p * slices;
  int bi, bj;
  pair_of(p, nb, &bi, &bj);

  const int pad_floats = (nb * B - n) * tile;
  for (int e = tid; e < kGramStages * pad_floats; e += blockDim.x) {
    const int st = e / pad_floats;
    smem[st * stage_floats + n * tile + (e - st * pad_floats)] = 0.0f;
  }

  const long long tiles = (d + tile - 1) / tile;
  // Copies: `per_row` threads share a slab row (chunks q0, q0 + per_row,
  // ...), `row_step` rows are copied side by side (rows r0, r0 +
  // row_step, ...); the divisions are done once here
  const int chunks = tile / kCopyFloats;  // copies per slab row
  const int per_row = chunks < (int)blockDim.x ? chunks : (int)blockDim.x;
  const int row_step = blockDim.x / per_row;
  const int q0 = tid % per_row;
  const int r0 = tid < row_step * per_row ? tid / per_row : n;  // n: idle

  // Every iteration commits one group (empty past the last slab), so the
  // slab consumed at iteration k is always kGramStages - 1 groups back
  for (int st = 0; st < kGramStages - 1; ++st) {
    const long long t = blockIdx.x + (long long)st * gridDim.x;
    if (t < tiles) {
      issue_slab<CW>(g, smem + st * stage_floats, n, d, t * tile, chunks,
                     q0, per_row, r0, row_step, tile);
    }
    copy_commit();
  }
  float acc[B][B];
#pragma unroll
  for (int u = 0; u < B; ++u) {
#pragma unroll
    for (int v = 0; v < B; ++v) acc[u][v] = 0.0f;
  }
  const int t4 = tile / 4;
  int k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    // The stage refilled here was consumed at iteration k - 1, which
    // ended with a barrier
    const long long ahead = t + (long long)(kGramStages - 1) * gridDim.x;
    if (ahead < tiles) {
      issue_slab<CW>(g, smem + ((k + kGramStages - 1) % kGramStages) * stage_floats,
                     n, d, ahead * tile, chunks, q0, per_row, r0, row_step,
                     tile);
    }
    copy_commit();
    copy_wait<kGramStages - 1>();
    __syncthreads();
    if (active) {
      const float* X = smem + (k % kGramStages) * stage_floats;
      const float4* rows_i = reinterpret_cast<const float4*>(X + bi * B * tile);
      const float4* rows_j = reinterpret_cast<const float4*>(X + bj * B * tile);
      for (int q = s * 8 + lane; q < t4; q += slices * 8) {
        float4 a[B];
#pragma unroll
        for (int u = 0; u < B; ++u) a[u] = rows_i[u * t4 + q];
#pragma unroll
        for (int v = 0; v < B; ++v) {
          const float4 y = rows_j[v * t4 + q];
#pragma unroll
          for (int u = 0; u < B; ++u) {
            float z = acc[u][v];
            z = fmaf(a[u].x, y.x, z);
            z = fmaf(a[u].y, y.y, z);
            z = fmaf(a[u].z, y.z, z);
            z = fmaf(a[u].w, y.w, z);
            acc[u][v] = z;
          }
        }
      }
    }
    __syncthreads();
  }

  // The unit's 8 lanes by a fixed shuffle tree (every lane ends with the
  // same sum), then the column slices in index order through shared
  // memory: red[(slice * pairs + pair) * B * B + u * B + v]
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int u = 0; u < B; ++u) {
#pragma unroll
    for (int v = 0; v < B; ++v) {
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        acc[u][v] += __shfl_xor_sync(0xffffffffu, acc[u][v], off);
      }
    }
  }
  float* red = smem;
  if (active && lane == 0) {
#pragma unroll
    for (int u = 0; u < B; ++u) {
#pragma unroll
      for (int v = 0; v < B; ++v) {
        red[(s * pairs + p) * B * B + u * B + v] = acc[u][v];
      }
    }
  }
  __syncthreads();
  const int out_pairs = n * (n + 1) / 2;
  float* out = partial + (long long)blockIdx.x * out_pairs;
  for (int e = tid; e < out_pairs; e += blockDim.x) {
    int i, j;
    pair_of(e, n, &i, &j);
    const int I = i / B, J = j / B;
    const int bp = I * nb - I * (I - 1) / 2 + (J - I);
    const int uv = (i - I * B) * B + (j - J * B);
    float sum = 0.0f;
    for (int q = 0; q < slices; ++q) sum += red[(q * pairs + bp) * B * B + uv];
    out[e] = sum;
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int n,
                                   int blocks) {
  const int pairs = n * (n + 1) / 2;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= pairs) return;
  float sum = 0.0f;
  for (int b = lane; b < blocks; b += 32) {
    sum += partial[(long long)b * pairs + warp];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    int i, j;
    pair_of(warp, n, &i, &j);
    out[i * n + j] = sum;
    out[j * n + i] = sum;
  }
}
#endif  // BMT_ROUNDS == 0

// Stage 1 of Bulyan (`pallas_gar._select_rows`), shared by
// `rows_mean_kernel` and `selected_median_mean_kernel`.
//
// stage_weights: W (f32[r, n], row-major) goes to shared memory transposed
// and padded to P floats a row of g, wt[i * P + k] = W[k, i] (0 past row
// r), so row i's weights are P consecutive floats (with P a multiple of 4,
// one 16-byte broadcast read serves four rows of W); bit k of sel[i] is
// set when row k selects row i of g (weight > 0). Every thread of the
// block must call it.
template <int P>
__device__ __forceinline__ void stage_weights(const float* __restrict__ W,
                                              int r, int n, float* wt,
                                              unsigned long long* sel) {
  static_assert(P <= 64, "one bit per row of W in a 64-bit mask");
  for (int e = threadIdx.x; e < n * P; e += blockDim.x) {
    const int i = e / P;
    const int k = e - i * P;
    wt[e] = k < r ? W[k * n + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned long long mask = 0;
    for (int k = 0; k < r; ++k) {
      if (W[k * n + i] > 0.0f) mask |= 1ull << k;
    }
    sel[i] = mask;
  }
  __syncthreads();
}

// V consecutive floats at p (aligned to 4 V bytes)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// Rows [i0, i0 + C) of the V columns at `col` (0 past row n)
template <int V, int C>
__device__ __forceinline__ void load_rows(const float* col, long long d,
                                          int i0, int n,
                                          float (&x)[C][V]) {
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (i0 + u < n) {
      load_vec<V>(col + (long long)(i0 + u) * d, x[u]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[u][v] = 0.0f;
    }
  }
}

#if BMT_ROUNDS == 0
// weighted_rows_mean: `W @ g` (f32[r, n] x f32[n, d] -> f32[r, d], r <= RB)
// under `_select_rows`' contract; thread-owned groups of V columns
// (V divides d), walked by a persistent grid
template <int V, int RB>
__global__ void __launch_bounds__(kMeanThreads)
rows_mean_kernel(const float* __restrict__ W, const float* __restrict__ g,
                 float* __restrict__ out, int r, int n, long long d) {
  constexpr int C = kChunkFloats / V;  // rows a chunk
  __shared__ float wt[kMaxRows * RB];  // wt[i * RB + k] = W[k, i], 0 past r
  __shared__ unsigned long long sel[kMaxRows];  // bit k: W[k, i] > 0
  stage_weights<RB>(W, r, n, wt, sel);

  const long long groups = d / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long grp = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       grp < groups; grp += stride) {
    const float* col = g + grp * V;
    float acc[RB][V];
    unsigned long long bad[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bad[v] = 0;
#pragma unroll
      for (int k = 0; k < RB; ++k) acc[k][v] = 0.0f;
    }
    float x[C][V], next[C][V];
    load_rows<V, C>(col, d, 0, n, x);
    for (int i0 = 0; i0 < n; i0 += C) {
      // The next chunk is in flight while this one is summed
      if (i0 + C < n) load_rows<V, C>(col, d, i0 + C, n, next);
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int i = i0 + u;
        if (i < n) {
          bool fin[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            fin[v] = isfinite(x[u][v]);
            if (!fin[v]) bad[v] |= sel[i];  // poisons the rows selecting it
          }
#pragma unroll
          for (int k = 0; k < RB; ++k) {
            const float w = wt[i * RB + k];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              if (fin[v]) acc[k][v] = fmaf(w, x[u][v], acc[k][v]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < C; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) x[u][v] = next[u][v];
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      if (k < r) {
        float y[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          y[v] = (bad[v] >> k) & 1ull ? nanf("") : acc[k][v];
        }
        store_vec<V>(out + k * d + grp * V, y);
      }
    }
  }
}

// The (V, RB) forms the wrapper picks (`ops/gar_kernels.py::
// rows_mean_geometry`), nullptr for any other
typedef void (*RowsMeanKernel)(const float*, const float*, float*, int, int,
                               long long);
RowsMeanKernel rows_mean_kernel_for(int width, int rb) {
  if (rb == 1) {
    switch (width) {
      case 1: return rows_mean_kernel<1, 1>;
      case 2: return rows_mean_kernel<2, 1>;
      case 4: return rows_mean_kernel<4, 1>;
    }
  } else if (width == 1 && rb == kMaxRows) {
    return rows_mean_kernel<1, kMaxRows>;
  }
  return nullptr;
}

// The (B, CW) forms of `gram_tiled_kernel`, nullptr for any other
typedef void (*GramKernel)(const float*, float*, int, long long, int, int);
template <int CW>
GramKernel gram_kernel_of_width(int b) {
  switch (b) {
    case 1: return gram_tiled_kernel<1, CW>;
    case 2: return gram_tiled_kernel<2, CW>;
    case 3: return gram_tiled_kernel<3, CW>;
    case 4: return gram_tiled_kernel<4, CW>;
    case 5: return gram_tiled_kernel<5, CW>;
    case 6: return gram_tiled_kernel<6, CW>;
    case 7: return gram_tiled_kernel<7, CW>;
    case 8: return gram_tiled_kernel<8, CW>;
  }
  return nullptr;
}
static_assert(kGramMaxBlock == 8, "gram_kernel_of_width lists B = 1..8");

GramKernel gram_kernel_for(int b, int copy) {
  switch (copy) {
    case 4: return gram_kernel_of_width<4>(b);
    case 8: return gram_kernel_of_width<8>(b);
    case 16: return gram_kernel_of_width<16>(b);
  }
  return nullptr;
}

// masked_rows_mean: sum of the rows i of g (f32[n, d]) with mask[i] != 0,
// in index order, divided by k; thread j owns column j
__global__ void __launch_bounds__(kMeanThreads)
masked_rows_mean_kernel(const unsigned char* __restrict__ mask,
                        const float* __restrict__ g, float* __restrict__ out,
                        int n, long long d, int k) {
  __shared__ int rows[kMaxRows];
  __shared__ int kept;
  if (threadIdx.x == 0) {
    int count = 0;
    for (int i = 0; i < n; ++i) {
      if (mask[i]) rows[count++] = i;
    }
    kept = count;
  }
  __syncthreads();
  const int count = kept;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.0f;
    for (int i0 = 0; i0 < count; i0 += kRowChunk) {
      // A chunk of selected rows is loaded before any is used, so the
      // loads' latencies overlap
      float x[kRowChunk];
#pragma unroll
      for (int u = 0; u < kRowChunk; ++u) {
        x[u] = i0 + u < count ? g[rows[i0 + u] * d + j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kRowChunk; ++u) {
        if (i0 + u < count) acc += x[u];
      }
    }
    out[j] = acc / (float)k;
  }
}
#endif  // BMT_ROUNDS == 0

// Blocks of `kernel` that fit on one SM with `smem` bytes of dynamic
// shared memory, or -1. It also lets the kernel launch with `smem` bytes
// on the current device (the default limit is 48 KB): the limit is only
// raised, so every plan queried before still launches, and a launch needs
// no attribute call of its own.
int resident_blocks(const void* kernel, int threads, int smem) {
  if (kernel == nullptr) return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  if (smem > attr.maxDynamicSharedSizeBytes &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess) {
    return -1;
  }
  int count = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, threads,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return count;
}

#if BMT_ROUNDS > 0
// Stage 2 of Bulyan for one column (`pallas_gar._bulyan_tail_kernel`,
// with `pallas_sort.sort_values` and `closest_mean_values`): the mean of
// the m2 values of the (R,) stack `rows` closest to its NaN-last lower
// median. The stack is sorted once as keys (`bmt::value_key`). Around a
// finite median the deviations fall going towards it in sorted order and
// rise going away (rounding is monotone; NaNs sort last, with deviations
// above every other), so the m2 closest values form a window of the
// sorted stack around the median, and the m2-th smallest deviation, the
// threshold, is the last one a walk of m2 - 1 steps takes: each step takes
// the smaller of the next deviation on the left and on the right. Around
// a median of +-inf the argument fails (the values equal
// to it have a NaN deviation, inf - inf): such a column sorts its
// deviation keys with the same network and reads rank m2 - 1, a rare
// branch of this kernel. The need count and the index-order sum are the
// JAX kernel's. With m2 == 1 the median is returned (`averaged_median`'s
// shortcut); it may be -0 where the float network gives +0 or the reverse
// (`batcher.cuh`), an equal value.
// The deviation key of the value of key k from a finite median
__device__ __forceinline__ uint32_t head_deviation(uint32_t k, float med) {
  return bmt::deviation_key(fabsf(bmt::key_value(k) - med));
}

template <int R>
__device__ __forceinline__ float median_closest_mean(const float (&rows)[R],
                                                     int m2) {
  constexpr int kMid = (R - 1) / 2;
  constexpr uint32_t kNone = 0xffffffffu;  // past the end of a run
  uint32_t srt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) srt[r] = bmt::value_key(rows[r]);
  bmt::key_select<R>(srt);
  const float med = bmt::key_value(srt[kMid]);
  if (m2 == 1 || isnan(med)) return med;  // a NaN median: NaN deviations
  uint32_t thresh = 0;  // the median's own deviation, the smallest
  if (isfinite(med)) {
    // The left run is srt[kMid - 1], srt[kMid - 2], ..., srt[0]; the right
    // run srt[kMid + 1], ..., srt[R - 1]. After s steps, tl + tr = s values
    // are taken, so each head is one of s + 1 wires: it is picked by a
    // chain of selects over those (the walk is unrolled), and only the two
    // heads' deviations are computed a step.
    int tl = 0, tr = 0;
#pragma unroll
    for (int s = 0; s < R - 1; ++s) {
      if (s >= m2 - 1) break;
      uint32_t ka = 0, kb = 0;
#pragma unroll
      for (int t = 0; t <= s; ++t) {
        // (the guarded indices keep the unused ones inside the array)
        if (kMid - 1 - t >= 0 && t == tl) {
          ka = srt[kMid - 1 - t >= 0 ? kMid - 1 - t : 0];
        }
        if (kMid + 1 + t < R && t == tr) {
          kb = srt[kMid + 1 + t < R ? kMid + 1 + t : 0];
        }
      }
      const uint32_t a = tl < kMid ? head_deviation(ka, med) : kNone;
      const uint32_t b = tr < R - 1 - kMid ? head_deviation(kb, med) : kNone;
      const bool left = a <= b;
      thresh = left ? a : b;
      tl += left ? 1 : 0;
      tr += left ? 0 : 1;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      srt[r] = bmt::deviation_key(fabsf(rows[r] - med));
    }
    bmt::key_select<R>(srt);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r == m2 - 1) thresh = srt[r];
    }
  }
  int below = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    srt[r] = bmt::deviation_key(fabsf(rows[r] - med));
    below += srt[r] < thresh ? 1 : 0;
  }
  const int need = m2 - below;
  float sum = 0.0f;
  int cum = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool eq = srt[r] == thresh;
    cum += eq ? 1 : 0;
    if (srt[r] < thresh || (eq && cum <= need)) sum += rows[r];
  }
  return thresh > bmt::kInfKey ? nanf("") : sum / (float)m2;
}

// Rows [i0, i0 + C) of stage 1 (those below n), whose V columns are in x:
// `fmaf` into the R rounds' sums, non-finite values excluded from every
// sum and poisoning the rounds that select them. W's rows are read as
// float4s of the staged, padded W; no FMA is done past round R.
template <int R, int C, int V>
__device__ __forceinline__ void stage_one_chunk(
    const float4* wt, const unsigned long long* sel, const float (&x)[C][V],
    int i0, int n, float (&acc)[R][V], unsigned long long (&bad)[V]) {
  constexpr int R4 = (R + 3) / 4;
#pragma unroll
  for (int u = 0; u < C; ++u) {
    const int i = i0 + u;
    if (i < n) {
      bool fin[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        fin[v] = isfinite(x[u][v]);
        if (!fin[v]) bad[v] |= sel[i];  // poisons the rounds selecting it
      }
#pragma unroll
      for (int q = 0; q < R4; ++q) {
        const float4 wq = wt[i * R4 + q];
        const float w[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * q + e < R) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              if (fin[v]) {
                acc[4 * q + e][v] = fmaf(w[e], x[u][v], acc[4 * q + e][v]);
              }
            }
          }
        }
      }
    }
  }
}

// selected_median_mean: Bulyan's stages 1 and 2 over thread-owned groups
// of V consecutive columns (V divides d), walked by a persistent grid.
// Stage 1 is `rows_mean_kernel`'s: W and the selection masks staged once a
// block, chunks of rows with the next in flight, `fmaf` over rows 0..n-1
// in index order from +0, non-finite values excluded, NaN where a round
// selects one. W's rows are padded to a multiple of 4 in shared memory
// only, for 16-byte reads: no FMA is done past round R.
template <int R, int V>
__global__ void __launch_bounds__(kMeanThreads)
selected_median_mean_kernel(const float* __restrict__ W,
                            const float* __restrict__ g,
                            float* __restrict__ out, int n, long long d,
                            int m2) {
  constexpr int R4 = (R + 3) / 4;
  constexpr int C = kChunkFloats / V;  // rows a chunk
  __shared__ float4 wt[kMaxRows * R4];
  __shared__ unsigned long long sel[kMaxRows];
  stage_weights<R4 * 4>(W, R, n, reinterpret_cast<float*>(wt), sel);

  const long long groups = d / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long grp = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       grp < groups; grp += stride) {
    const float* col = g + grp * V;
    float acc[R][V];
    unsigned long long bad[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bad[v] = 0;
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k][v] = 0.0f;
    }
    // Two chunks in turn, so that each is summed while the other is in
    // flight and no registers are copied between them
    float xa[C][V], xb[C][V];
    load_rows<V, C>(col, d, 0, n, xa);
    for (int i0 = 0; i0 < n; i0 += 2 * C) {
      if (i0 + C < n) load_rows<V, C>(col, d, i0 + C, n, xb);
      stage_one_chunk<R>(wt, sel, xa, i0, n, acc, bad);
      if (i0 + C >= n) break;
      if (i0 + 2 * C < n) load_rows<V, C>(col, d, i0 + 2 * C, n, xa);
      stage_one_chunk<R>(wt, sel, xb, i0 + C, n, acc, bad);
    }
    float y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float rows[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        rows[k] = (bad[v] >> k) & 1ull ? nanf("") : acc[k][v];
      }
      y[v] = median_closest_mean<R>(rows, m2);
    }
    store_vec<V>(out + grp * V, y);
  }
}

// Two columns a thread up to this many rounds; past it, one (registers)
constexpr int kMedianPairRounds = 32;

// The form of `selected_median_mean_kernel` for V columns a thread, nullptr
// for one that is not built (a template, so that the V = 2 form is not
// instantiated past kMedianPairRounds)
typedef void (*MedianMeanKernel)(const float*, const float*, float*, int,
                                 long long, int);
template <int V>
MedianMeanKernel median_mean_form() {
  if constexpr (V == 1 || BMT_ROUNDS <= kMedianPairRounds) {
    return selected_median_mean_kernel<BMT_ROUNDS, V>;
  } else {
    return nullptr;
  }
}

MedianMeanKernel median_mean_kernel_for(int width) {
  return width == 1 ? median_mean_form<1>()
         : width == 2 ? median_mean_form<2>() : nullptr;
}
#endif  // BMT_ROUNDS > 0

}  // namespace

extern "C" {

#if BMT_ROUNDS == 0
int bmt_max_rounds() { return kMaxRounds; }

int bmt_gram_stages() { return kGramStages; }

int bmt_gram_max_block() { return kGramMaxBlock; }

int bmt_gram_max_threads() { return kGramMaxThreads; }

// Blocks of pass 1 of sq_gram (row block b, copies of `copy` bytes) that
// fit on one SM with `threads` threads and `smem` bytes of shared memory;
// -1 for a form that does not exist or a failed query
int bmt_sq_gram_resident(int b, int copy, int threads, int smem) {
  return resident_blocks((const void*)gram_kernel_for(b, copy), threads, smem);
}

// g f32[n, d] (row-major) -> out f32[n, n]; partial is f32[blocks, pairs]
// scratch with pairs = n (n + 1) / 2. The geometry (b, copy, threads,
// slices, tile, smem) is `ops/gar_kernels.py::gram_geometry`'s, and
// `bmt_sq_gram_resident` has been asked about it on this device (which
// admits its shared memory)
int bmt_sq_gram(const float* g, float* partial, float* out, int n,
                long long d, int b, int copy, int blocks, int threads,
                int slices, int tile, int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const GramKernel kernel = gram_kernel_for(b, copy);
  if (kernel == nullptr || threads > kGramMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  kernel<<<blocks, threads, smem, s>>>(g, partial, n, d, slices, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pairs = n * (n + 1) / 2;
  const int reduce_threads = 256;  // 8 warps, one pair each
  const int grid = (pairs * 32 + reduce_threads - 1) / reduce_threads;
  gram_reduce_kernel<<<grid, reduce_threads, 0, s>>>(partial, out, n, blocks);
  return (int)cudaGetLastError();
}

// Blocks of weighted_rows_mean's (width, rb) form that fit on one SM, or -1
int bmt_rows_mean_resident(int width, int rb) {
  return resident_blocks((const void*)rows_mean_kernel_for(width, rb),
                         kMeanThreads, 0);
}

// W f32[r, n] (1 <= r <= rb), g f32[n, d] -> out f32[r, d]; width divides
// d and g's address is aligned to 4 * width bytes
// (`ops/gar_kernels.py::rows_mean_geometry`)
int bmt_weighted_rows_mean(const float* W, const float* g, float* out, int r,
                           int n, long long d, int width, int rb, int blocks,
                           void* stream) {
  const RowsMeanKernel kernel = rows_mean_kernel_for(width, rb);
  if (kernel == nullptr || r > rb) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kMeanThreads, 0, (cudaStream_t)stream>>>(W, g, out, r, n,
                                                             d);
  return (int)cudaGetLastError();
}

// mask bool[n] (one byte each), g f32[n, d] (1 <= n <= kMaxRows) -> out
// f32[d]; k >= 1
int bmt_masked_rows_mean(const unsigned char* mask, const float* g,
                         float* out, int n, long long d, int k,
                         void* stream) {
  long long blocks = (d + kMeanThreads - 1) / kMeanThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  masked_rows_mean_kernel<<<(unsigned)blocks, kMeanThreads, 0,
                            (cudaStream_t)stream>>>(mask, g, out, n, d, k);
  return (int)cudaGetLastError();
}
#else
int bmt_rounds() { return BMT_ROUNDS; }

int bmt_median_pair_rounds() { return kMedianPairRounds; }

// Blocks of selected_median_mean's `width` form that fit on one SM, or -1
int bmt_median_mean_resident(int width) {
  return resident_blocks((const void*)median_mean_kernel_for(width),
                         kMeanThreads, 0);
}

// W f32[BMT_ROUNDS, n], g f32[n, d] -> out f32[d]; width (1, or 2 up to
// kMedianPairRounds rounds) divides d and g's address is aligned to
// 4 * width bytes (`ops/gar_kernels.py::median_mean_geometry`)
int bmt_selected_median_mean(const float* W, const float* g, float* out,
                             int n, long long d, int m2, int width,
                             int blocks, void* stream) {
  const MedianMeanKernel kernel = median_mean_kernel_for(width);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kMeanThreads, 0, (cudaStream_t)stream>>>(W, g, out, n, d,
                                                             m2);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
