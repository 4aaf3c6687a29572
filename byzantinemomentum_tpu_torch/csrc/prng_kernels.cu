// Hand-written Hopper (sm_90a) kernels of the port's key tree: the
// threefry-2x32 hash (20 rounds) that `jax.random` computes, fused into
// the draws a training step makes on the device.
//
// Built by `byzantinemomentum_tpu_torch/ops/prng_kernels.py` at its first
// use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o <build>/lib...so prng_kernels.cu
// and bound through the plain C entries at the bottom of this file
// (ctypes). Every entry launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().
//
// These replace no `pl.pallas_call`: in the JAX package XLA generates the
// threefry hash itself. The plain PyTorch form (`prng.py`) runs the hash
// as some 170 eager int64 tensor operations; at the headline's masks
// (24.7 M elements a step) that is ~80 GB of device-memory traffic, which
// would double the step. Here the hash runs in 32-bit registers.
//
// ---------------------------------------------------------------------------
// dropout_mask_kernel: the keep-masks of S workers' j-th dropout layer,
// `byzantinemomentum_tpu/models/core.py::_dropout_mask` with an 8-bit
// keep threshold, under worker s's key `split(wkeys[s], n)[j]` (for any
// n > j: key j of a split hashes the counter j alone).
//   Element (b, h, w, c) of the JAX (NHWC) mask hashes the counter
//   ((b H + h) W + w) C + c and keeps the element iff the low byte of the
//   xor of the two output words is below the threshold
//   (`jax.random.bits(key, shape, uint8) < threshold`). The kernel writes
//   the port's NCHW layout `bool[S, B, C, H, W]` directly: a thread takes
//   consecutive output bytes, so a warp's stores are 32 consecutive bytes.
//   Bound: integer issue. Each element costs the 20 rounds (an add, a
//   funnel-shift rotation and an xor each) and 12 key additions, 72
//   32-bit operations, then an xor and a compare; it writes one byte.
//   At the headline (S = 20, B = 50: 24.7 M elements a step) that is
//   1.8 G operations against 24.7 MB of stores.
//   The Bernoulli form (`kTopBits`) is `jax.random.bernoulli(key, p,
//   shape)` for a keep rate that is no 8-bit threshold (WRN-28-10's 0.7):
//   JAX draws the float32 uniform u = bitcast((w >> 9) | 0x3F800000) - 1,
//   which is exactly (w >> 9) * 2^-23, and keeps the element iff
//   u < float32(p), that is iff (w >> 9) < T with T = ceil(float32(p) *
//   2^23), an integer the host works out once. Same hash, same walk; a
//   shift takes the place of the mask. A WRN-28-10 step at S = 9, B = 20
//   draws 12 such masks, 206.4 M elements: 15.3 G operations.
//   A layer may also draw from the worker's key itself (`derive` false:
//   MobileNetV2's classifier dropout draws `bernoulli(wkey, 0.8, shape)`
//   from the worker key, `byzantinemomentum_tpu/models/mobilenet.py:147`).
//   Design: blockIdx.y is the worker; one thread of each block derives
//   the worker's layer key once into shared memory (or copies the
//   worker's key there). Each thread then
//   hashes kItems elements a block stride apart (consecutive threads on
//   consecutive bytes). The output index is split into (b, c, h, w) by
//   two 32-bit divisions by the plane size and the channel count.
//
// split_kernel: `jax.random.split` of K keys into n each: key (k, i) is
//   the two output words of the hash of the counter i under key k
//   (JAX's `_threefry_split_foldlike`). One thread a new key. A step
//   splits its key into S + 2 (`engine/step.py::phase_honest`): one
//   launch in place of ~170 eager int64 operations.
// ---------------------------------------------------------------------------

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block, both kernels
constexpr int kItems = 8;      // mask elements a thread
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four threefry rounds with rotations R0..R3
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// threefry-2x32, 20 rounds, of the counter words (x0, x1) under the key
// words (k0, k1): `prng.py::threefry2x32`
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// wkeys: int64[S, 2] (uint32 words); out: bool[S, count] with count =
// B * c * hw, the NCHW mask of each worker. The compared value of a word
// w is its low byte, or with kTopBits its top 23 bits (w >> 9)
template <bool kTopBits>
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(const long long* __restrict__ wkeys,
                    unsigned char* __restrict__ out, uint32_t j,
                    uint32_t count, uint32_t hw, uint32_t c,
                    uint32_t threshold, bool derive) {
  __shared__ uint2 layer_key;
  const uint32_t s = blockIdx.y;
  if (threadIdx.x == 0) {
    const uint32_t k0 = (uint32_t)wkeys[2 * s], k1 = (uint32_t)wkeys[2 * s + 1];
    layer_key = derive ? threefry2x32(k0, k1, 0u, j) : make_uint2(k0, k1);
  }
  __syncthreads();
  const uint2 key = layer_key;
  unsigned char* dst = out + (size_t)s * count;
  const uint32_t base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t e = base + i * kThreads;
    if (e < count) {
      const uint32_t plane = e / hw;         // b * c + channel
      const uint32_t p = e - plane * hw;     // h * W + w
      const uint32_t b = plane / c;
      const uint32_t ch = plane - b * c;
      const unsigned long long counter =
          ((unsigned long long)b * hw + p) * c + ch;
      const uint2 r = threefry2x32(key.x, key.y, (uint32_t)(counter >> 32),
                                   (uint32_t)counter);
      const uint32_t w = r.x ^ r.y;
      dst[e] = (kTopBits ? (w >> 9) : (w & 0xFFu)) < threshold;
    }
  }
}

// keys: int64[K, 2]; out: int64[K, n, 2]
__global__ void __launch_bounds__(kThreads)
split_kernel(const long long* __restrict__ keys, long long* __restrict__ out,
             int k_count, int n) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= k_count * n) {
    return;
  }
  const int k = t / n;
  const uint2 r = threefry2x32((uint32_t)keys[2 * k], (uint32_t)keys[2 * k + 1],
                               0u, (uint32_t)(t - k * n));
  out[2 * t] = r.x;
  out[2 * t + 1] = r.y;
}

template <bool kTopBits>
int launch_masks(const long long* wkeys, unsigned char* out, int S,
                 long long j, long long count, int hw, int c,
                 long long threshold, void* stream) {
  const long long per_block = (long long)kThreads * kItems;
  const dim3 grid((unsigned)((count + per_block - 1) / per_block),
                  (unsigned)S);
  dropout_mask_kernel<kTopBits><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      wkeys, out, (uint32_t)(j < 0 ? 0 : j), (uint32_t)count, (uint32_t)hw,
      (uint32_t)c, (uint32_t)threshold, j >= 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bmt_prng_threads() { return kThreads; }

int bmt_prng_items() { return kItems; }

// The masks of S >= 1 workers, count = B * c * hw >= 1 elements each
// (count < 2^31), 0 < threshold < 256; layer j of each worker's key, or
// the worker's key itself where j < 0
int bmt_dropout_masks(const long long* wkeys, unsigned char* out, int S,
                      long long j, long long count, int hw, int c,
                      int threshold, void* stream) {
  return launch_masks<false>(wkeys, out, S, j, count, hw, c, threshold,
                             stream);
}

// The Bernoulli masks, the same layout, 0 <= threshold <= 2^23
int bmt_bernoulli_masks(const long long* wkeys, unsigned char* out, int S,
                        long long j, long long count, int hw, int c,
                        long long threshold, void* stream) {
  return launch_masks<true>(wkeys, out, S, j, count, hw, c, threshold,
                            stream);
}

// K >= 1 keys into n >= 1 each (K * n < 2^31)
int bmt_split_keys(const long long* keys, long long* out, int k_count, int n,
                   void* stream) {
  const int blocks = (k_count * n + kThreads - 1) / kThreads;
  split_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(keys, out,
                                                              k_count, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
