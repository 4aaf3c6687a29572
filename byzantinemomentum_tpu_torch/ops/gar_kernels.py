"""The hand-written CUDA kernels of the distance- and selection-based
GARs and their plain PyTorch versions — the port's counterpart of
`byzantinemomentum_tpu/ops/pallas_gar.py` (`sq_gram`, `weighted_rows_mean`,
`masked_rows_mean`, `selected_median_mean`).

Kernels live in `csrc/gar_kernels.cu` (CUDA C++ for `sm_90a`), built and
bound as `ops/_cuda.py` describes: one library for `sq_gram`,
`weighted_rows_mean` and `masked_rows_mean`, and one for each stage-1
round count that
`selected_median_mean` is called with (its sorting network is unrolled
for that count, and a large count takes long to compile). They launch on
`torch.cuda.current_stream()`.

Dispatch. A wrapper given a CPU tensor runs the plain version. Given a
CUDA tensor it checks it (f32, 2-D, contiguous, 1 <= n <= MAX_ROWS) and
launches the kernel or raises: there is no fallback on a failed build or
launch. Callers (`ops/_common.py`, `ops/bulyan.py`) route operands
outside `supported()` to their plain torch path, exactly where the JAX
package routes operands outside `pallas_gar.supported` to its jnp path.

`selected_median_mean` takes 1 <= rounds <= MAX_ROUNDS (62), every
stage-1 round count that MAX_ROWS rows can give; `weighted_rows_mean`
takes 1 <= r <= MAX_ROWS rows of weights; `masked_rows_mean` a bool[n]
mask and a divisor k >= 1.

The kernels take f32 only, as the JAX package's `pallas_gar` does: a
half-precision stack takes the plain path in the callers.

Each wrapper counts its kernel launches in `<wrapper>.launches` (and
per dtype, `ops/_cuda.py`); `reset_launches()` zeroes every wrapper's
counts, `sort_kernels`' too.
"""

import ctypes
import functools

import torch

from byzantinemomentum_tpu_torch.ops import _cuda, sort_kernels
from byzantinemomentum_tpu_torch.ops._cuda import (
    MAX_ROWS, reset_launches, supported)

__all__ = ["MAX_ROWS", "MAX_ROUNDS", "supported", "build", "sq_gram",
           "sq_gram_plain", "weighted_rows_mean", "select_rows",
           "masked_rows_mean", "masked_rows_mean_plain",
           "selected_median_mean", "selected_median_mean_plain",
           "reset_launches"]

MAX_ROUNDS = 62   # kMaxRounds in csrc/gar_kernels.cu
GRAM_TILE = 128   # kTile in csrc/gar_kernels.cu: columns per staged slab
GRAM_BLOCKS = 528  # pass-1 blocks of sq_gram, 4 per SM of a 132-SM H100


# --------------------------------------------------------------------------- #
# Build and binding

def build(rounds=0):
    """Compile the library of `csrc/gar_kernels.cu` that holds `sq_gram`,
    `weighted_rows_mean` and `masked_rows_mean` (`rounds=0`) or
    `selected_median_mean` for
    `rounds` stage-1 rounds, if it does not exist yet; returns
    `(library path, nvcc's output)`."""
    if not 0 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"rounds = {rounds} outside 0..{MAX_ROUNDS}")
    return _cuda.compile_library("gar_kernels.cu", f"r{rounds}",
                                 {"BMT_ROUNDS": rounds})


@functools.cache
def _library(rounds=0):
    """The loaded library of `build(rounds)`, its entries typed."""
    lib = ctypes.CDLL(str(build(rounds)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if rounds == 0:
        for name in ("bmt_max_rounds", "bmt_gram_tile"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.bmt_sq_gram.argtypes = [ptr, ptr, ptr, i32, i64, i32, ptr]
        lib.bmt_sq_gram.restype = i32
        lib.bmt_weighted_rows_mean.argtypes = [ptr, ptr, ptr, i32, i32, i64,
                                               ptr]
        lib.bmt_weighted_rows_mean.restype = i32
        lib.bmt_masked_rows_mean.argtypes = [ptr, ptr, ptr, i32, i64, i32,
                                             ptr]
        lib.bmt_masked_rows_mean.restype = i32
        if (lib.bmt_max_rounds(), lib.bmt_gram_tile()) != (MAX_ROUNDS,
                                                           GRAM_TILE):
            raise RuntimeError("csrc/gar_kernels.cu and ops/gar_kernels.py "
                               "disagree on MAX_ROUNDS or GRAM_TILE")
    else:
        lib.bmt_rounds.argtypes = []
        lib.bmt_rounds.restype = i32
        lib.bmt_selected_median_mean.argtypes = [ptr, ptr, ptr, i32, i64,
                                                 i32, ptr]
        lib.bmt_selected_median_mean.restype = i32
        if lib.bmt_rounds() != rounds:
            raise RuntimeError(f"library {lib._name} is not built for "
                               f"{rounds} rounds")
    return lib


# --------------------------------------------------------------------------- #
# sq_gram

def sq_gram_plain(g):
    """`g @ g.T` (f32[n, d] -> f32[n, n]); non-finite rows poison their
    entries, which `_common.distances_from_sq_gram` maps to +inf."""
    return g @ g.T


@_cuda.counted
def sq_gram(g):
    """`g @ g.T` in one streamed read of `g` (kernel on a CUDA tensor, the
    plain version on a CPU one). Deterministic: the cross-block sum runs
    in a fixed order, with no atomics."""
    if g.device.type == "cpu":
        return sq_gram_plain(g)
    _cuda.check_matrix("sq_gram", g)
    lib = _library()
    n, d = g.shape
    blocks = min(-(-d // GRAM_TILE), GRAM_BLOCKS)
    partial = torch.empty((blocks, n * (n + 1) // 2), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((n, n), dtype=torch.float32, device=g.device)
    _cuda.raise_on("sq_gram", lib.bmt_sq_gram(
        g.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d, blocks,
        _cuda.stream(g)))
    _cuda.launched(sq_gram, g.dtype)
    return out


# --------------------------------------------------------------------------- #
# weighted_rows_mean

def select_rows(W, g):
    """`W @ g` (`W: f32[n] | f32[r, n]`) with the non-finite contract of
    the selection averages: unselected non-finite rows are excluded, and a
    non-finite entry in a selected (w > 0) row gives NaN at exactly its
    coordinate. The plain version of `weighted_rows_mean`."""
    finite = torch.isfinite(g)
    out = W @ torch.where(finite, g, 0.0)
    bad = ((W > 0).float() @ (~finite).float()) > 0
    return torch.where(bad, torch.nan, out)


@_cuda.counted
def weighted_rows_mean(w, g):
    """`select_rows(w, g)` in one streamed read of `g` (Krum's selected-row
    average; `w: f32[n]` or `f32[r, n]`, 1 <= r <= MAX_ROWS). Kernel on a
    CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return select_rows(w, g)
    _cuda.check_matrix("weighted_rows_mean", g)
    n, d = g.shape
    W = w[None, :] if w.dim() == 1 else w
    if (W.device != g.device or W.dtype != torch.float32 or W.dim() != 2
            or W.shape[1] != n):
        raise ValueError(f"weighted_rows_mean: w must be f32[{n}] or "
                         f"f32[r, {n}] on {g.device}, got {w.dtype}"
                         f"{tuple(w.shape)} on {w.device}")
    r = W.shape[0]
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"weighted_rows_mean: r = {r} rows of weights "
                         f"outside 1..{MAX_ROWS}")
    W = W.contiguous()
    out = torch.empty((r, d), dtype=torch.float32, device=g.device)
    _cuda.raise_on("weighted_rows_mean", _library().bmt_weighted_rows_mean(
        W.data_ptr(), g.data_ptr(), out.data_ptr(), r, n, d,
        _cuda.stream(g)))
    _cuda.launched(weighted_rows_mean, g.dtype)
    return out[0] if w.dim() == 1 else out


# --------------------------------------------------------------------------- #
# masked_rows_mean

def masked_rows_mean_plain(mask, g, k):
    """Brute's subset mean `sum(where(mask, g, 0)) / k` (`mask: bool[n]`):
    excluded rows count as 0, a selected non-finite value propagates
    through the sum (a +inf stays +inf, NaN or inf - inf gives NaN)."""
    return torch.where(mask[:, None], g, 0.0).sum(dim=0) / k


@_cuda.counted
def masked_rows_mean(mask, g, k):
    """`masked_rows_mean_plain(mask, g, k)` reading only the selected rows
    of `g` once (k >= 1). Kernel on a CUDA tensor, the plain version on a
    CPU one."""
    if g.device.type == "cpu":
        return masked_rows_mean_plain(mask, g, k)
    _cuda.check_matrix("masked_rows_mean", g)
    n, d = g.shape
    if (mask.device != g.device or mask.dtype != torch.bool
            or mask.shape != (n,) or not mask.is_contiguous()):
        raise ValueError(f"masked_rows_mean: mask must be a contiguous "
                         f"bool[{n}] on {g.device}, got {mask.dtype}"
                         f"{tuple(mask.shape)} on {mask.device}")
    if not (isinstance(k, int) and k >= 1):
        raise ValueError(f"masked_rows_mean: k = {k!r} must be an int >= 1")
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    _cuda.raise_on("masked_rows_mean", _library().bmt_masked_rows_mean(
        mask.data_ptr(), g.data_ptr(), out.data_ptr(), n, d, k,
        _cuda.stream(g)))
    _cuda.launched(masked_rows_mean, g.dtype)
    return out


# --------------------------------------------------------------------------- #
# selected_median_mean

def selected_median_mean_plain(W, g, m2):
    """Bulyan stages 1 and 2: the (rounds, d) stack `select_rows(W, g)`,
    its NaN-last lower median, then the mean of the m2 stack values
    closest to it (m2 == 1 returns the median)."""
    stack = select_rows(W, g)
    med = sort_kernels.lower_median_plain(stack)
    if m2 == 1:
        return med
    return sort_kernels.closest_mean_plain(stack, med, m2)


@_cuda.counted
def selected_median_mean(W, g, m2):
    """Bulyan over Multi-Krum's d-space tail in one streamed read of `g`
    (`W: f32[rounds, n]` from `ops/bulyan.py::selection_weights`), without
    materializing the (rounds, d) stack. Kernel on a CUDA tensor,
    the plain version on a CPU one."""
    if g.device.type == "cpu":
        return selected_median_mean_plain(W, g, m2)
    _cuda.check_matrix("selected_median_mean", g)
    rounds, n = W.shape
    if W.device != g.device or W.dtype != torch.float32 or n != g.shape[0]:
        raise ValueError(f"selected_median_mean: W must be f32[rounds, "
                         f"{g.shape[0]}] on {g.device}, got {W.dtype}"
                         f"{tuple(W.shape)} on {W.device}")
    if not 1 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"selected_median_mean: rounds = {rounds} outside "
                         f"1..{MAX_ROUNDS}")
    if not 1 <= m2 <= rounds:
        raise ValueError(f"selected_median_mean: m2 = {m2} outside 1..{rounds}")
    W = W.contiguous()
    out = torch.empty((g.shape[1],), dtype=torch.float32, device=g.device)
    _cuda.raise_on("selected_median_mean",
                   _library(rounds).bmt_selected_median_mean(
                       W.data_ptr(), g.data_ptr(), out.data_ptr(), n,
                       g.shape[1], m2, _cuda.stream(g)))
    _cuda.launched(selected_median_mean, g.dtype)
    return out
