"""The line search's state update on the device: the hand-written CUDA
kernel `linesearch_step` and its plain PyTorch version.

`ops/linesearch.py` keeps the search's state, the JAX `lax.while_loop`
carry of `byzantinemomentum_tpu/ops/linesearch.py`, in three tensors on
the objective's device: `xs: f32[3]` (best_x, prop_x, delta), `best_y`
(0-d, the objective's dtype: f32, or f64 in a float64 run) and `ints:
i32[2]` (phase, evals left). `linesearch_step(xs, best_y, ints, y)` takes
the value `y` of the probe at prop_x and returns the next state, whose
prop_x is the next probe: one step of the JAX loop's body around its
objective call. The host never reads the state, so a search of `evals`
probes is `evals - 1` launches queued behind the objective's work.

The kernel (`csrc/search_kernels.cu`, CUDA C++ for `sm_90a`, one library,
built and bound as `ops/_cuda.py` describes) runs the body on one thread
with every x step rounded to f32 once. The plain version is the same
state machine in torch operations: both branches of each choice computed
and picked with `torch.where`, and the negative-x guard unrolled a fixed
number of times, so that it reads nothing on the host either.

Subnormals, as XLA has them on its CPU and on the TPU: an arithmetic
operation or a comparison reads a subnormal operand as a zero of its sign
and writes a subnormal result as one (denormals-are-zero and
flush-to-zero, in f32 and in f64), while a selection (`jnp.where`) moves
a value as it is. A product or a halving flushes where its exact result
is below 2^-126, before rounding, as x86 detects it (a sum near 2^-126
is exact). Both versions do this explicitly (`flush`), so a search whose
probes come near 2^-126 gives the JAX package's probes.

The guard halves the distance from x = prop_x - delta to p = prop_x >= 0
until x >= 0: x <- (x + p) / 2. Its length comes from f32's range: delta
< 2^128, so from |x| < 2^128 at most 127 halvings bring the distance below
1 and 126 more below the smallest normal 2^-126, where x flushes to -0 if
it is still negative (254 at p = 0 from the largest f32; the kernel stops
at `GUARD_STEPS` = 280, so an infinite delta, on which the JAX loop would
spin, stops there too). The plain version takes the same values in fewer
operations, from the significand's width: where p = 0 (either sign) a
finite negative x halves exactly down to -0; where p > 0 and |x| >=
2^(P + 27) (p < 2^(P + 1)), p is below a quarter of x's ulp, so x + p
rounds to x and the step is an exact halving: the first j = max(0, E - P
- 26) steps (|x| in [2^E, 2^(E + 1))) are x * 2^-j, one multiply in f64,
normal throughout; from |x| < 2^(P + 27) the distance halves down to p
within 27 + 1 steps (or flushes to -0 sooner), unrolled `GUARD_TAIL` = 32
times (27 at most in `tests/test_torch_linesearch.py`'s sweep of 200,000
states).

Dispatch, as every kernel of the port: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. The wrapper counts
its launches (`linesearch_step.launches`, per dtype of y in
`launches_by_dtype`); `_cuda.reset_launches()` zeroes them.
"""

import ctypes
import functools

import numpy as np
import torch

from byzantinemomentum_tpu_torch.ops import _cuda

__all__ = ["build", "linesearch_step", "linesearch_step_plain",
           "GUARD_STEPS", "GUARD_TAIL", "RATIO", "Y_DTYPES", "flush",
           "guard"]

GUARD_STEPS = 280  # kGuardSteps in csrc/search_kernels.cu
GUARD_TAIL = 32    # the plain guard's steps after its exact halvings
RATIO = 0.8        # the contraction ratio, applied as float32(0.8)
Y_DTYPES = (torch.float32, torch.float64)
_TINY = float(torch.finfo(torch.float32).tiny)  # 2^-126, the smallest normal
_RATIO32 = float(np.float32(RATIO))  # RATIO as f32 holds it


def build():
    """Compile `csrc/search_kernels.cu` if its library does not exist yet;
    returns `(library path, nvcc's output)`."""
    return _cuda.compile_library("search_kernels.cu", "search", {})


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    ptr = ctypes.c_void_p
    lib.bmt_search_guard_steps.argtypes = []
    lib.bmt_search_guard_steps.restype = ctypes.c_int
    for name in ("bmt_linesearch_step_f32", "bmt_linesearch_step_f64"):
        getattr(lib, name).argtypes = [ptr] * 8
        getattr(lib, name).restype = ctypes.c_int
    if lib.bmt_search_guard_steps() != GUARD_STEPS:
        raise RuntimeError("csrc/search_kernels.cu and ops/search_kernels.py "
                           "disagree on GUARD_STEPS")
    return lib


def flush(t):
    """A subnormal as a zero of its sign (XLA's denormals-are-zero and
    flush-to-zero); NaN and infinities as they are."""
    return torch.where(t.abs() < torch.finfo(t.dtype).tiny, t * 0, t)


def _mul(a, c):
    """`flush(a) * c` for an f32 tensor and a normal constant `c` that f32
    holds exactly, flushed where the exact product (f64) is below the
    smallest normal, before rounding, as x86 detects it; rounded to f32
    once."""
    exact = flush(a).double() * c
    return torch.where(exact.abs() < _TINY, exact * 0, exact).float()


def _half(a):
    """`flush(a) / 2`, flushed where the exact half is below the smallest
    normal."""
    a = flush(a)
    return torch.where(a.abs() < 2 * _TINY, a * 0, a / 2)


def guard(prop_x, delta):
    """The negative-x guard's probe from `prop_x - delta` (f32 0-d
    tensors), as the kernel's loop gives it (see the module docstring):
    -0 at p = 0, else the exact halvings in one step, then `GUARD_TAIL`
    steps; a non-negative (or NaN) start as it is, -inf stays -inf."""
    p = flush(prop_x)
    x0 = flush(p - flush(delta))
    _, ex = torch.frexp(x0)
    _, ep = torch.frexp(p)
    j = torch.clamp(ex - ep - 26, min=0).to(torch.int64)
    # 2^-j as an f64 built from its exponent bits: exact for j <= 1022
    scale = ((1023 - j) << 52).view(torch.float64)
    x = (x0.double() * scale).float()
    for _ in range(GUARD_TAIL):
        x = torch.where(x < 0, _half(flush(x + p)), x)
    at_zero = torch.where(torch.isfinite(x0), -0.0, x0)
    return torch.where(x0 < 0, torch.where(p == 0, at_zero, x), x0)


def linesearch_step_plain(xs, best_y, ints, y):
    """`linesearch_step` in torch operations (no host read)."""
    best_x, prop_x, delta = xs[0], xs[1], xs[2]
    phase = ints[0]
    better = flush(y) > flush(best_y)  # a NaN never improves
    best_x = torch.where(better, prop_x, best_x)
    best_y = torch.where(better, y, best_y)
    grow = (phase == 0) & better
    delta = torch.where(grow, _mul(delta, 2.0), _mul(delta, _RATIO32))
    phase = torch.where(grow, 0, 1).to(torch.int32)
    nxt = torch.where(phase == 0, flush(flush(best_x) + delta),
                      torch.where(flush(prop_x) < flush(best_x),
                                  flush(flush(prop_x) + delta),
                                  guard(prop_x, delta)))
    return (torch.stack([best_x, nxt, delta]), best_y,
            torch.stack([phase, ints[1] - 1]))


def _check(xs, best_y, ints, y):
    if not (xs.dtype == torch.float32 and tuple(xs.shape) == (3,)
            and ints.dtype == torch.int32 and tuple(ints.shape) == (2,)):
        raise ValueError(f"linesearch_step: expected xs f32[3] and ints "
                         f"i32[2], got {xs.dtype}{tuple(xs.shape)} and "
                         f"{ints.dtype}{tuple(ints.shape)}")
    if y.dtype not in Y_DTYPES or y.dtype != best_y.dtype or y.dim() \
            or best_y.dim():
        raise ValueError(f"linesearch_step: expected 0-d f32 or f64 values of "
                         f"one dtype, got {best_y.dtype}{tuple(best_y.shape)} "
                         f"and {y.dtype}{tuple(y.shape)}")
    devices = {t.device for t in (xs, best_y, ints, y)}
    if len(devices) != 1:
        raise ValueError(f"linesearch_step: operands on {sorted(map(str, devices))}")


@_cuda.counted
def linesearch_step(xs, best_y, ints, y):
    """The next search state `(xs, best_y, ints)` after the probe at
    `xs[1]` gave `y`; kernel on CUDA tensors, the plain version on CPU
    ones. Writes new tensors and none of its operands."""
    _check(xs, best_y, ints, y)
    if xs.device.type == "cpu":
        return linesearch_step_plain(xs, best_y, ints, y)
    xs, best_y, ints, y = (t.contiguous() for t in (xs, best_y, ints, y))
    out_xs, out_y, out_ints = (torch.empty_like(t) for t in (xs, best_y, ints))
    entry = ("bmt_linesearch_step_f32" if y.dtype == torch.float32
             else "bmt_linesearch_step_f64")
    _cuda.raise_on("linesearch_step", getattr(_library(), entry)(
        xs.data_ptr(), best_y.data_ptr(), ints.data_ptr(), y.data_ptr(),
        out_xs.data_ptr(), out_y.data_ptr(), out_ints.data_ptr(),
        _cuda.stream(xs)))
    _cuda.launched(linesearch_step, y.dtype)
    return out_xs, out_y, out_ints
