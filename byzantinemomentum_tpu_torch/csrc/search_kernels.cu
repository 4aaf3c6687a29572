// Hand-written Hopper (sm_90a) kernel of the adaptive attacks' line
// search: one probe's update of the search state, on the device, so that
// a search of `evals` probes queues `evals - 1` launches and never waits
// for the host.
//
// Built by `byzantinemomentum_tpu_torch/ops/search_kernels.py` at its
// first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o <build>/lib...so search_kernels.cu
// and bound through the plain C entries at the bottom of this file
// (ctypes). Every entry launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().
//
// It replaces no `pl.pallas_call`: in the JAX package the search is one
// `lax.while_loop` (`byzantinemomentum_tpu/ops/linesearch.py`), whose body
// XLA compiles. This is that body, but for the objective's evaluation:
//
//   linesearch_step_kernel: the state (best_x, prop_x, delta) in f32,
//   best_y in the objective's type (f32, or f64 in a float64 run) and
//   (phase, evals) in i32, and the value y of the probe at prop_x, give
//   the next state:
//     better = y > best_y (a NaN y never improves);
//     expansion (phase 0) and better: delta *= 2, stay expanding;
//     otherwise: contraction (phase 1), delta *= 0.8;
//     the next probe: best_x + delta while expanding, else prop_x + delta
//     where prop_x < best_x, else prop_x - delta halved toward prop_x
//     while it is negative (the negative-x guard; at prop_x = 0 it runs
//     down to -0).
//   Every step of x rounds to f32 once: the `__f*_rn` intrinsics (and a
//   product exact in f64, rounded once) are never contracted into a
//   fused multiply-add, which nvcc would otherwise do by default, and
//   XLA's probes are separate f32 steps.
//   Subnormals as XLA has them on its CPU (and the TPU): an arithmetic
//   operation or a comparison reads a subnormal operand as a zero of its
//   sign and writes a subnormal result as one (denormals-are-zero and
//   flush-to-zero, in f32 and f64), while a selection moves a value as
//   it is. `flush` does both explicitly, whatever nvcc's -ftz.
//   One thread: the work is a few scalar operations (the guard at most
//   kGuardSteps halvings), so a launch is bound by its own latency.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr float kRatio = 0.8f;  // the contraction ratio, float32(0.8)
// The guard's halvings, at most: from |x| < 2^128 the distance to prop_x
// halves each step, below the smallest normal 2^-126 within 254 steps
// (`ops/search_kernels.py::GUARD_STEPS` derives it); a finite state never
// reaches it, and an infinite one cannot hang the card
constexpr int kGuardSteps = 280;

// A subnormal as a zero of its sign (NaN and infinities as they are)
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}
__device__ __forceinline__ double flush(double v) {
  return fabs(v) < DBL_MIN ? copysign(0.0, v) : v;
}
// The sum of two normal f32 values is exact wherever it is below 2^-125
// (a multiple of 2^-149), so flushing the rounded sum is exact; a product
// and a halving flush where the exact result is below 2^-126, before
// rounding, as x86 detects it (2^-126 (1 - 2^-24) rounds up to 2^-126 but
// flushes): the f32 product is exact in f64
__device__ __forceinline__ float add(float a, float b) {
  return flush(__fadd_rn(flush(a), flush(b)));
}
__device__ __forceinline__ float sub(float a, float b) {
  return flush(__fsub_rn(flush(a), flush(b)));
}
__device__ __forceinline__ float mul(float a, float b) {
  const double exact = static_cast<double>(flush(a)) * static_cast<double>(b);
  return fabs(exact) < FLT_MIN ? static_cast<float>(copysign(0.0, exact))
                               : __double2float_rn(exact);
}
__device__ __forceinline__ float half(float a) {
  const float v = flush(a);
  return fabsf(v) < 2.0f * FLT_MIN ? copysignf(0.0f, v) : __fdiv_rn(v, 2.0f);
}

template <typename Y>
__global__ void linesearch_step_kernel(const float* __restrict__ xs,
                                       const Y* __restrict__ best_y,
                                       const int* __restrict__ ints,
                                       const Y* __restrict__ prop_y,
                                       float* __restrict__ out_xs,
                                       Y* __restrict__ out_best_y,
                                       int* __restrict__ out_ints) {
  float best_x = xs[0];
  const float prop_x = xs[1];
  float delta = xs[2];
  int phase = ints[0];
  Y by = *best_y;
  const Y py = *prop_y;
  const bool better = flush(py) > flush(by);
  if (better) {
    best_x = prop_x;
    by = py;
  }
  if (phase == 0 && better) {
    delta = mul(delta, 2.0f);
  } else {
    phase = 1;
    delta = mul(delta, kRatio);
  }
  float next;
  if (phase == 0) {
    next = add(best_x, delta);
  } else if (flush(prop_x) < flush(best_x)) {
    next = add(prop_x, delta);
  } else {
    next = sub(prop_x, delta);
    for (int i = 0; i < kGuardSteps && next < 0.0f; ++i)
      next = half(add(next, prop_x));
  }
  out_xs[0] = best_x;
  out_xs[1] = next;
  out_xs[2] = delta;
  *out_best_y = by;
  out_ints[0] = phase;
  out_ints[1] = ints[1] - 1;
}

template <typename Y>
int launch_step(const float* xs, const Y* best_y, const int* ints,
                const Y* prop_y, float* out_xs, Y* out_best_y, int* out_ints,
                void* stream) {
  linesearch_step_kernel<Y><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, best_y, ints, prop_y, out_xs, out_best_y, out_ints);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bmt_search_guard_steps() { return kGuardSteps; }

// One probe's update: xs f32[3], ints i32[2], the y's f32 0-d
int bmt_linesearch_step_f32(const float* xs, const float* best_y,
                            const int* ints, const float* prop_y,
                            float* out_xs, float* out_best_y, int* out_ints,
                            void* stream) {
  return launch_step<float>(xs, best_y, ints, prop_y, out_xs, out_best_y,
                            out_ints, stream);
}

// The same with f64 y's (a float64 run's objective)
int bmt_linesearch_step_f64(const float* xs, const double* best_y,
                            const int* ints, const double* prop_y,
                            float* out_xs, double* out_best_y, int* out_ints,
                            void* stream) {
  return launch_step<double>(xs, best_y, ints, prop_y, out_xs, out_best_y,
                             out_ints, stream);
}

}  // extern "C"
