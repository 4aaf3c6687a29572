"""The hand-written CUDA kernels of the coordinate-wise GARs and their
plain PyTorch versions — the port's counterpart of
`byzantinemomentum_tpu/ops/pallas_sort.py` (`lower_median`,
`trimmed_mean`, `closest_mean`, and the Batcher schedule `_batcher_pairs`
/ `sort_values` that the CUDA kernels unroll).

Kernels live in `csrc/sort_kernels.cu` (CUDA C++ for `sm_90a`), built and
bound as `ops/_cuda.py` describes: one library per (kernel, row count n)
that a run meets, since each sorting network is unrolled for its n. They
launch on `torch.cuda.current_stream()`.

Dispatch, as in `ops/gar_kernels.py`: a wrapper given a CPU tensor runs
the plain version; given a CUDA tensor it checks it (f32, 2-D,
contiguous, 1 <= n <= MAX_ROWS, the rank bound in range) and launches the
kernel or raises. Callers (`ops/_common.py`, `ops/trmean.py`) route
operands outside `supported()` to the plain version, as the JAX package
routes operands outside `pallas_sort.supported` to its jnp path. The JAX
kernels also take bf16/f16; these are built for f32 only, the engine's
GAR space, so a half-precision operand takes the plain path.

Semantics are the JAX package's: NaN sorts last (`torch.sort` agrees),
the median is the lower one, and `torch.median`/`torch.quantile`, which
propagate NaN, are never used.
"""

import ctypes
import functools

import torch

from byzantinemomentum_tpu_torch.ops import _cuda
from byzantinemomentum_tpu_torch.ops._cuda import (
    MAX_ROWS, reset_launches, supported)

__all__ = ["MAX_ROWS", "KERNELS", "supported", "build", "batcher_pairs",
           "sort_values", "lower_median", "lower_median_plain",
           "trimmed_mean", "trimmed_mean_plain", "closest_mean",
           "closest_mean_plain", "reset_launches"]

# The kernels of csrc/sort_kernels.cu, in BMT_SORT_KERNEL order (1, 2, 3)
KERNELS = ("lower_median", "trimmed_mean", "closest_mean")


# --------------------------------------------------------------------------- #
# Build and binding

def build(kernel, n):
    """Compile the library of `csrc/sort_kernels.cu` that holds `kernel`
    for `n` rows, if it does not exist yet; returns `(library path,
    nvcc's output)`."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown sort kernel {kernel!r}, expected one of {KERNELS}")
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"n = {n} rows outside 1..{MAX_ROWS}")
    return _cuda.compile_library(
        "sort_kernels.cu", f"{kernel}-n{n}",
        {"BMT_SORT_KERNEL": KERNELS.index(kernel) + 1, "BMT_N": n})


@functools.cache
def _entry(kernel, n):
    """The typed C entry `bmt_<kernel>` of the loaded `build(kernel, n)`."""
    lib = ctypes.CDLL(str(build(kernel, n)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("bmt_sort_n", "bmt_sort_kernel"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if (lib.bmt_sort_n(), lib.bmt_sort_kernel()) != (n, KERNELS.index(kernel) + 1):
        raise RuntimeError(f"library {lib._name} is not built for {kernel} "
                           f"at n = {n}")
    entry = getattr(lib, f"bmt_{kernel}")
    entry.argtypes = {"lower_median": [ptr, ptr, i64, ptr],
                      "trimmed_mean": [ptr, ptr, i64, i32, ptr],
                      "closest_mean": [ptr, ptr, ptr, i64, i32, ptr]}[kernel]
    entry.restype = i32
    return entry


def _output(g):
    return torch.empty((g.shape[1],), dtype=torch.float32, device=g.device)


# --------------------------------------------------------------------------- #
# The Batcher network the kernels unroll

def batcher_pairs(n):
    """Batcher odd-even mergesort compare-exchange schedule for n rows
    (the schedule of `pallas_sort._batcher_pairs`, which `batcher_sort` in
    `csrc/batcher.cuh` unrolls)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def sort_values(rows):
    """Run the Batcher network over a list of equal-shape rows, NaN last;
    returns the sorted list (the network of the CUDA kernels, step for
    step)."""
    rows = list(rows)
    for i, j in batcher_pairs(len(rows)):
        a, b = rows[i], rows[j]
        swap = (b < a) | (torch.isnan(a) & ~torch.isnan(b))
        rows[i] = torch.where(swap, b, a)
        rows[j] = torch.where(swap, a, b)
    return rows


# --------------------------------------------------------------------------- #
# Plain versions

def lower_median_plain(g):
    """Coordinate-wise lower median `sorted[(n - 1) // 2]`, NaN last."""
    n = g.shape[0]
    return torch.sort(g, dim=0).values[(n - 1) // 2]


def trimmed_mean_plain(g, f):
    """Coordinate-wise mean of sorted ranks [f, n - f), NaN last."""
    n = g.shape[0]
    return torch.sort(g, dim=0).values[f:n - f].sum(dim=0) / (n - 2 * f)


def closest_mean_plain(g, c, m):
    """Coordinate-wise mean of the `m` values closest to center `c`:
    everything strictly below the m-th smallest deviation, then the ties
    at it in index order (the stable-argsort selection). NaN deviations
    sort last; fewer than m finite values gives NaN."""
    dev = torch.abs(g - c[None, :])
    thresh = torch.sort(dev, dim=0).values[m - 1]
    lt = dev < thresh
    eq = dev == thresh
    need = m - lt.sum(dim=0)
    take = lt | (eq & (torch.cumsum(eq.int(), dim=0) <= need))
    out = torch.where(take, g, 0.0).sum(dim=0) / m
    return torch.where(torch.isnan(thresh), torch.nan, out)


# --------------------------------------------------------------------------- #
# Kernel wrappers

@_cuda.counted
def lower_median(g):
    """`lower_median_plain(g)` in one read of `g` and one f32[d] write
    (kernel on a CUDA tensor, the plain version on a CPU one)."""
    if g.device.type == "cpu":
        return lower_median_plain(g)
    _cuda.check_matrix("lower_median", g)
    out = _output(g)
    _cuda.raise_on("lower_median", _entry("lower_median", g.shape[0])(
        g.data_ptr(), out.data_ptr(), g.shape[1], _cuda.stream(g)))
    lower_median.launches += 1
    return out


@_cuda.counted
def trimmed_mean(g, f):
    """`trimmed_mean_plain(g, f)` in one read of `g` (0 <= f, 2f < n);
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return trimmed_mean_plain(g, f)
    _cuda.check_matrix("trimmed_mean", g)
    n = g.shape[0]
    if not (isinstance(f, int) and 0 <= f and 2 * f < n):
        raise ValueError(f"trimmed_mean: f = {f!r} outside 0 <= f < {n}/2")
    out = _output(g)
    _cuda.raise_on("trimmed_mean", _entry("trimmed_mean", n)(
        g.data_ptr(), out.data_ptr(), g.shape[1], f, _cuda.stream(g)))
    trimmed_mean.launches += 1
    return out


@_cuda.counted
def closest_mean(g, c, m):
    """`closest_mean_plain(g, c, m)` in one read of `g` and `c`
    (1 <= m <= n); kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if g.device.type == "cpu":
        return closest_mean_plain(g, c, m)
    _cuda.check_matrix("closest_mean", g)
    n, d = g.shape
    if (c.device != g.device or c.dtype != torch.float32 or c.dim() != 1
            or c.shape[0] != d or not c.is_contiguous()):
        raise ValueError(f"closest_mean: c must be a contiguous f32[{d}] on "
                         f"{g.device}, got {c.dtype}{tuple(c.shape)} on "
                         f"{c.device}")
    if not (isinstance(m, int) and 1 <= m <= n):
        raise ValueError(f"closest_mean: m = {m!r} outside 1..{n}")
    out = _output(g)
    _cuda.raise_on("closest_mean", _entry("closest_mean", n)(
        g.data_ptr(), c.data_ptr(), out.data_ptr(), d, m, _cuda.stream(g)))
    closest_mean.launches += 1
    return out
