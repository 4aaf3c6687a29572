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
//   131.1 MB once and writes 2.5 KB; the 426 M multiply-adds are far below
//   the f32 FFMA peak.
//   Design: the TPU kernel carries the (n, n) sum across a sequential grid;
//   GPU blocks run in no order, so this takes two passes. Pass 1: each
//   block walks its own strided set of 128-column tiles, stages the (n, 128)
//   slab in shared memory (the ragged last tile is masked to 0 and never
//   read past d; each thread issues all its loads of a slab before it
//   stores any, so their latencies overlap), and every thread accumulates
//   up to 9 upper-triangle pairs in registers; the block writes its
//   partial triangle to an
//   f32[blocks, pairs] scratch. Pass 2: one warp per pair sums the partials
//   in a fixed order (strided lanes, then a fixed shuffle tree) and mirrors
//   the triangle. No atomics, so repeated runs give identical distances and
//   identical selections.
//
// selected_median_mean: replaces
// `byzantinemomentum_tpu/ops/pallas_gar.py::selected_median_mean`
// (`_bulyan_tail_kernel`, with `_select_rows`, `pallas_sort.sort_values` and
// `pallas_sort.closest_mean_values` inlined).
//   Bound: bytes. It reads g once (131.1 MB at the headline shape) and
//   writes one (d,) row (5.2 MB); the work per coordinate is
//   rounds * n multiply-adds plus two sorting networks over `rounds`
//   values.
//   Design: thread j owns coordinate j, so a warp's loads of g[i, j0:j0+32]
//   are coalesced, and it loads 8 rows ahead of their use to keep enough
//   bytes in flight; W (rounds x n) sits in shared memory, beside one
//   64-bit mask per row of the rounds that select it. The (rounds,)
//   stage-1 stack, its non-finite flags (one bit each), the Batcher
//   network and the closest-mean selection stay in registers: the
//   (rounds, d) stack never reaches device memory. Register arrays need
//   compile-time indices, so the kernel is a template on ROUNDS, built for
//   any of 1..kMaxRounds (62, every count n <= 64 rows can give), and the
//   Batcher network is unrolled by template recursion (`batcher.cuh`).
//
// weighted_rows_mean: replaces
// `byzantinemomentum_tpu/ops/pallas_gar.py::weighted_rows_mean`
// (`_wmean_kernel`), Krum's selected-row average `w @ g` under
// `_select_rows`' non-finite contract.
//   Bound: bytes. At the headline shape it reads g once (131.1 MB) and
//   writes r rows of d (5.2 MB for Krum's one row); r * n multiply-adds a
//   coordinate.
//   Design: stage 1 of selected_median_mean, shared with it
//   (`stage_weights`, `select_rows_column`): thread j owns column j, with
//   coalesced loads 8 rows ahead, the weights transposed in shared memory,
//   one 64-bit mask per row of g for the rows of W that select it.
//   Accumulators need compile-time indices, so a block computes a fixed
//   group of 1 (Krum's w f32[n]) or 8 rows of W and gridDim.y walks the
//   groups; rows past r weigh 0 and are not written.
//
// masked_rows_mean: replaces
// `byzantinemomentum_tpu/ops/pallas_gar.py::masked_rows_mean`
// (`_masked_mean_kernel`), Brute's subset mean
// `sum(where(mask, g, 0)) / k` under Brute's non-finite contract, not
// `select_rows_column`'s: a selected +inf stays +inf, a selected NaN or
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
constexpr int kTile = 128;                // columns per staged slab
// Padded row stride: a multiple of 4 floats keeps every row 16-byte
// aligned for float4 reads, and 132 = 4 (mod 32) puts the rows that 8
// neighbouring threads read in 8 distinct bank groups
constexpr int kLd = kTile + 4;
constexpr int kGramThreads = 256;
constexpr int kMaxPairs = kMaxRows * (kMaxRows + 1) / 2;           // 2080
constexpr int kPairsPerThread =
    (kMaxPairs + kGramThreads - 1) / kGramThreads;                 // 9
constexpr int kLoadsPerThread = kMaxRows * kTile / kGramThreads;   // 32
constexpr int kRowChunk = 8;              // g rows loaded ahead per thread
constexpr int kMaxRounds = kMaxRows - 2;  // n - 2f - 2 with f >= 0
constexpr int kMeanThreads = 256;
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

__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const float* __restrict__ g, float* __restrict__ partial,
                    int n, long long d) {
  __shared__ __align__(16) float slab[kMaxRows * kLd];
  const int pairs = n * (n + 1) / 2;
  const int tid = threadIdx.x;
  // Register slots in use: pairs spread over the block's threads
  const int used = (pairs + kGramThreads - 1) / kGramThreads;

  // Slab offsets of each pair's two rows (pairs past the end read row 0
  // and are never written out)
  int oi[kPairsPerThread], oj[kPairsPerThread];
  float acc[kPairsPerThread];
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int p = tid + k * kGramThreads;
    int i = 0, j = 0;
    if (p < pairs) pair_of(p, n, &i, &j);
    oi[k] = i * kLd;
    oj[k] = j * kLd;
    acc[k] = 0.0f;
  }

  const long long tiles = (d + kTile - 1) / kTile;
  const int elems = n * kTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long c0 = t * kTile;
    // All of this thread's loads of the slab are issued before the first
    // is used, so their latencies overlap
    float staged[kLoadsPerThread];
#pragma unroll
    for (int q = 0; q < kLoadsPerThread; ++q) {
      const int e = tid + q * kGramThreads;
      const int row = e / kTile;
      const long long c = c0 + (e - row * kTile);
      staged[q] = (e < elems && c < d) ? g[row * d + c] : 0.0f;
    }
    __syncthreads();  // the previous slab is fully consumed
#pragma unroll
    for (int q = 0; q < kLoadsPerThread; ++q) {
      const int e = tid + q * kGramThreads;
      const int row = e / kTile;
      if (e < elems) slab[row * kLd + (e - row * kTile)] = staged[q];
    }
    __syncthreads();
    // The slot test sits outside the column loop: slots past `used` cost
    // no instructions (predicated shared-memory reads inside the loop
    // would still take issue slots)
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      if (k < used) {  // uniform over the block: no divergence
        const float4* a = reinterpret_cast<const float4*>(slab + oi[k]);
        const float4* b = reinterpret_cast<const float4*>(slab + oj[k]);
        float s = acc[k];
#pragma unroll 8
        for (int c = 0; c < kTile / 4; ++c) {
          const float4 x = a[c], y = b[c];
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
          s = fmaf(x.z, y.z, s);
          s = fmaf(x.w, y.w, s);
        }
        acc[k] = s;
      }
    }
  }

  float* out = partial + (long long)blockIdx.x * pairs;
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int p = tid + k * kGramThreads;
    if (p < pairs) out[p] = acc[k];
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

// Stage 1 of Bulyan and the whole of `weighted_rows_mean`
// (`pallas_gar._select_rows`), shared by both kernels below.
//
// stage_weights: rows [r0, r0 + R) of W (f32[r, n], row-major) go to
// shared memory transposed and padded to whole float4s,
// wt[i * R4 + q] = W[r0 + 4q .. r0 + 4q + 3, i] (0 past row r), so one
// 16-byte (broadcast) read serves four rows; bit k of sel[i] is set when
// row r0 + k selects row i of g (weight > 0). Every thread of the block
// must call it.
template <int R>
__device__ __forceinline__ void stage_weights(const float* __restrict__ W,
                                              int r, int r0, int n,
                                              float4* wt,
                                              unsigned long long* sel) {
  static_assert(R <= 64, "one bit per row in a 64-bit mask");
  constexpr int R4 = (R + 3) / 4;
  float* wts = reinterpret_cast<float*>(wt);
  for (int e = threadIdx.x; e < n * R4 * 4; e += blockDim.x) {
    const int i = e / (R4 * 4);
    const int k = e - i * R4 * 4;
    wts[e] = k < R && r0 + k < r ? W[(r0 + k) * n + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned long long mask = 0;
    for (int k = 0; k < R && r0 + k < r; ++k) {
      if (W[(r0 + k) * n + i] > 0.0f) mask |= 1ull << k;
    }
    sel[i] = mask;
  }
  __syncthreads();
}

// select_rows_column: column j of the staged rows' `W @ g`, with
// unselected non-finite values excluded from every sum; returns the mask
// of the rows that select a non-finite value of the column (their entry
// is NaN under the contract)
template <int R4>
__device__ __forceinline__ unsigned long long select_rows_column(
    const float4* wt, const unsigned long long* sel,
    const float* __restrict__ g, int n, long long d, long long j,
    float (&acc)[R4 * 4]) {
  unsigned long long bad = 0;
#pragma unroll
  for (int k = 0; k < R4 * 4; ++k) acc[k] = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kRowChunk) {
    // A chunk of rows is loaded before any is used, so the loads'
    // latencies overlap
    float x[kRowChunk];
#pragma unroll
    for (int u = 0; u < kRowChunk; ++u) {
      x[u] = i0 + u < n ? g[(i0 + u) * d + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRowChunk; ++u) {
      const int i = i0 + u;
      if (i >= n) break;
      const float4* wi = wt + i * R4;
      if (isfinite(x[u])) {
#pragma unroll
        for (int q = 0; q < R4; ++q) {
          const float4 wq = wi[q];
          acc[4 * q] = fmaf(wq.x, x[u], acc[4 * q]);
          acc[4 * q + 1] = fmaf(wq.y, x[u], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(wq.z, x[u], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(wq.w, x[u], acc[4 * q + 3]);
        }
      } else {  // excluded from every sum; poisons the rows selecting it
        bad |= sel[i];
      }
    }
  }
  return bad;
}

#if BMT_ROUNDS == 0
// weighted_rows_mean: rows [RB * blockIdx.y, RB * blockIdx.y + RB) of
// `W @ g` (f32[r, n] x f32[n, d] -> f32[r, d]); thread j owns column j
template <int RB>
__global__ void __launch_bounds__(kMeanThreads)
weighted_rows_mean_kernel(const float* __restrict__ W,
                          const float* __restrict__ g,
                          float* __restrict__ out, int r, int n,
                          long long d) {
  constexpr int R4 = (RB + 3) / 4;
  __shared__ float4 wt[kMaxRows * R4];
  __shared__ unsigned long long sel[kMaxRows];
  const int r0 = blockIdx.y * RB;
  stage_weights<RB>(W, r, r0, n, wt, sel);
  const int rows = r - r0 < RB ? r - r0 : RB;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc[R4 * 4];
    const unsigned long long bad =
        select_rows_column<R4>(wt, sel, g, n, d, j, acc);
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      if (k < rows) {
        out[(r0 + k) * d + j] = (bad >> k) & 1ull ? nanf("") : acc[k];
      }
    }
  }
}

template <int RB>
cudaError_t launch_rows_mean(const float* W, const float* g, float* out,
                             int r, int n, long long d, cudaStream_t stream) {
  long long blocks = (d + kMeanThreads - 1) / kMeanThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  const dim3 grid((unsigned)blocks, (unsigned)((r + RB - 1) / RB));
  weighted_rows_mean_kernel<RB>
      <<<grid, kMeanThreads, 0, stream>>>(W, g, out, r, n, d);
  return cudaGetLastError();
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

template <int R>
__global__ void __launch_bounds__(kMeanThreads)
selected_median_mean_kernel(const float* __restrict__ W,
                            const float* __restrict__ g,
                            float* __restrict__ out, int n, long long d,
                            int m2) {
  constexpr int R4 = (R + 3) / 4;
  __shared__ float4 wt[kMaxRows * R4];
  __shared__ unsigned long long sel[kMaxRows];
  stage_weights<R>(W, R, 0, n, wt, sel);

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    // Stage 1: the (R,) stack of column j; bit r of `bad`: round r
    // selected a non-finite value
    float acc[R4 * 4];
    const unsigned long long bad =
        select_rows_column<R4>(wt, sel, g, n, d, j, acc);
    float rows[R], srt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rows[r] = (bad >> r) & 1ull ? nanf("") : acc[r];
      srt[r] = rows[r];
    }
    // Stage 2: NaN-last lower median over the stack, then the mean of
    // the m2 stack values closest to it
    bmt::batcher_sort<R>(srt);
    const float med = srt[(R - 1) / 2];
    // `_common.averaged_median`'s m == 1 shortcut
    out[j] = m2 == 1 ? med : bmt::closest_mean_values<R>(rows, med, m2, srt);
  }
}

template <int R>
cudaError_t launch_mean(const float* W, const float* g, float* out, int n,
                        long long d, int m2, cudaStream_t stream) {
  long long blocks = (d + kMeanThreads - 1) / kMeanThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  selected_median_mean_kernel<R>
      <<<(unsigned)blocks, kMeanThreads, 0, stream>>>(W, g, out, n, d, m2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#if BMT_ROUNDS == 0
int bmt_max_rounds() { return kMaxRounds; }

int bmt_gram_tile() { return kTile; }

// g f32[n, d] (row-major) -> out f32[n, n]; partial is f32[blocks, pairs]
// scratch with pairs = n (n + 1) / 2
int bmt_sq_gram(const float* g, float* partial, float* out, int n,
                long long d, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  gram_partial_kernel<<<blocks, kGramThreads, 0, s>>>(g, partial, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pairs = n * (n + 1) / 2;
  const int threads = 256;  // 8 warps, one pair each
  const int grid = (pairs * 32 + threads - 1) / threads;
  gram_reduce_kernel<<<grid, threads, 0, s>>>(partial, out, n, blocks);
  return (int)cudaGetLastError();
}

// W f32[r, n] (1 <= r <= kMaxRows), g f32[n, d] -> out f32[r, d]
int bmt_weighted_rows_mean(const float* W, const float* g, float* out, int r,
                           int n, long long d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(r == 1 ? launch_rows_mean<1>(W, g, out, r, n, d, s)
                      : launch_rows_mean<8>(W, g, out, r, n, d, s));
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

// W f32[BMT_ROUNDS, n], g f32[n, d] -> out f32[d]
int bmt_selected_median_mean(const float* W, const float* g, float* out,
                             int n, long long d, int m2, void* stream) {
  return (int)launch_mean<BMT_ROUNDS>(W, g, out, n, d, m2,
                                      (cudaStream_t)stream);
}
#endif

}  // extern "C"
