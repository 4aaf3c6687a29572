// Hand-written Hopper (sm_90a) kernels of the `--gars-per-call` mixture
// draw: the content hash of a defense call's operand, and the draw of the
// mixture member from it, so that the member is chosen on the device and
// the host never reads the operand.
//
// Built by `byzantinemomentum_tpu_torch/ops/mixture_kernels.py` at its
// first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o <build>/lib...so mixture_kernels.cu
// and bound through the plain C entries at the bottom of this file
// (ctypes). Every entry launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().
//
// They replace no `pl.pallas_call`: in the JAX package XLA compiles the
// hash and the draw (`byzantinemomentum_tpu/engine/step.py::
// _per_call_uniform`, `engine/program.py::mixture_index`):
//
//   operand_hash_kernel: the u32 wraparound sum over the flat operand G
//     (n x d, f32, bf16 or f16, widened to f32 as XLA's `astype` does) of
//     bits(G[i]) * ((i * 2654435761) | 1). Every bit counts: a NaN keeps
//     its payload (an f16 NaN widens with its quiet bit set and its
//     payload shifted, as x86's conversion does; a bf16 NaN is its 16
//     bits shifted up, signalling or not) and -0 hashes apart from +0.
//     A grid-stride loop of 16-byte loads where the operand allows
//     (scalar loads otherwise), a warp then a block reduction, and one
//     atomicAdd a block into the zeroed low word of the int64 result:
//     integer sums modulo 2^32 do not depend on their order, so the
//     result is the same from run to run.
//   mixture_draw_kernel: one thread. fold_in(key, h) (threefry-2x32 of
//     the counter (0, h)), the f32 uniform of the folded key (the hash of
//     the counter (0, 0), its two words xored, the top 23 bits under the
//     exponent of 1.0, minus 1), then the member: the count of cumulative
//     frequencies <= u * cum[K - 1] (f32 product), clipped to K - 1
//     (`searchsorted(..., side="right")`), as an int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kKnuth = 2654435761u;

__device__ __forceinline__ uint32_t weight(uint32_t i) {
  return (i * kKnuth) | 1u;
}

// f16 bits -> the f32 bits XLA's CPU conversion gives: exact for every
// finite value (subnormals included), a NaN quietened with its payload
// shifted up by 13
__device__ __forceinline__ uint32_t widen_f16(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  const uint32_t e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  if (e == 0x1Fu) {
    return sign | (m ? (0x7FC00000u | (m << 13)) : 0x7F800000u);
  }
  if (e != 0) {
    return sign | ((e + 112u) << 23) | (m << 13);
  }
  if (m == 0) {
    return sign;
  }
  // Subnormal: m * 2^-24, normalised
  const int shift = __clz(m) - 21;  // leading zeros within the 10 bits, + 1
  const uint32_t mant = (m << shift) & 0x3FFu;
  return sign | ((113u - shift) << 23) | (mant << 13);
}

__device__ __forceinline__ uint32_t widen_bf16(uint32_t h) { return h << 16; }

template <int kDtype>
__device__ __forceinline__ uint32_t widen(uint32_t h) {
  return kDtype == 1 ? widen_bf16(h) : widen_f16(h);
}

__device__ __forceinline__ void block_add(uint32_t acc, uint32_t* out) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, offset);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sums[warp] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, offset);
    }
    if (lane == 0) {
      atomicAdd(out, acc);
    }
  }
}

// f32 operand: float4 loads where `vec` (the element count a multiple of
// 4 and the address 16-byte aligned), else one word a thread a step
__global__ void __launch_bounds__(kThreads)
operand_hash_f32_kernel(const uint32_t* __restrict__ g, long long count,
                        int vec, uint32_t* __restrict__ out) {
  uint32_t acc = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  if (vec) {
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    const long long quads = count / 4;
#pragma unroll 4
    for (long long q = start; q < quads; q += stride) {
      const uint4 v = __ldg(g4 + q);
      const uint32_t i = static_cast<uint32_t>(q) * 4u;
      acc += v.x * weight(i) + v.y * weight(i + 1u) + v.z * weight(i + 2u)
             + v.w * weight(i + 3u);
    }
  } else {
    for (long long i = start; i < count; i += stride) {
      acc += __ldg(g + i) * weight(static_cast<uint32_t>(i));
    }
  }
  block_add(acc, out);
}

// 16-bit operands: four elements (8 bytes) a load where `vec`
template <int kDtype>
__global__ void __launch_bounds__(kThreads)
operand_hash_half_kernel(const uint16_t* __restrict__ g, long long count,
                         int vec, uint32_t* __restrict__ out) {
  uint32_t acc = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  if (vec) {
    const uint2* g4 = reinterpret_cast<const uint2*>(g);
    const long long quads = count / 4;
#pragma unroll 4
    for (long long q = start; q < quads; q += stride) {
      const uint2 v = __ldg(g4 + q);
      const uint32_t i = static_cast<uint32_t>(q) * 4u;
      acc += widen<kDtype>(v.x & 0xFFFFu) * weight(i)
             + widen<kDtype>(v.x >> 16) * weight(i + 1u)
             + widen<kDtype>(v.y & 0xFFFFu) * weight(i + 2u)
             + widen<kDtype>(v.y >> 16) * weight(i + 3u);
    }
  } else {
    for (long long i = start; i < count; i += stride) {
      acc += widen<kDtype>(__ldg(g + i)) * weight(static_cast<uint32_t>(i));
    }
  }
  block_add(acc, out);
}

// ---- threefry-2x32, 20 rounds (`prng.py::threefry2x32`) ---------------- //

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ void threefry(uint32_t k1, uint32_t k2, uint32_t x1, uint32_t x2,
                         uint32_t* o1, uint32_t* o2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = x1 ^ rotl(x2, rot[i % 2][j]);
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  *o1 = x1;
  *o2 = x2;
}

__global__ void mixture_draw_kernel(const long long* __restrict__ key,
                                    const long long* __restrict__ h,
                                    const float* __restrict__ cum, int K,
                                    int* __restrict__ out) {
  uint32_t f1, f2, b1, b2;
  threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]), 0u,
           static_cast<uint32_t>(h[0]), &f1, &f2);
  threefry(f1, f2, 0u, 0u, &b1, &b2);
  const float u = __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
  const float v = __fmul_rn(u, cum[K - 1]);
  int idx = 0;
  for (int k = 0; k < K; ++k) {
    idx += cum[k] <= v ? 1 : 0;
  }
  *out = idx < K - 1 ? idx : K - 1;
}

}  // namespace

extern "C" {

int bmt_mixture_threads() { return kThreads; }

// dtype: 0 f32, 1 bf16, 2 f16. `out` is an int64 whose low word takes the
// hash (zeroed here first).
int bmt_operand_hash(const void* g, int dtype, long long count, int blocks,
                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(long long), s);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const uintptr_t address = reinterpret_cast<uintptr_t>(g);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (dtype == 0) {
    const int vec = count % 4 == 0 && address % 16 == 0;
    operand_hash_f32_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(g), count, vec, o);
  } else {
    const int vec = count % 4 == 0 && address % 8 == 0;
    if (dtype == 1) {
      operand_hash_half_kernel<1><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(g), count, vec, o);
    } else {
      operand_hash_half_kernel<2><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(g), count, vec, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int bmt_mixture_draw(const void* key, const void* h, const void* cum, int K,
                     void* out, void* stream) {
  mixture_draw_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<const long long*>(h),
      static_cast<const float*>(cum), K, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
