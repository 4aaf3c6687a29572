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

Launch geometry. `sq_gram`, `weighted_rows_mean` and
`selected_median_mean` run a persistent grid: as many blocks as fit on
the card's SMs at once (the library's occupancy query), capped by the
work. Their per-call shape is chosen here, in plain Python that the CPU
tests hold (`gram_geometry`, `rows_mean_geometry`, `median_mean_width`):
the width of each copy or load from `d` and the operand's address (a
contiguous row slice may start off alignment), the Gram's row block from
`n`.

Each wrapper counts its kernel launches in `<wrapper>.launches` (and
per dtype, `ops/_cuda.py`); `reset_launches()` zeroes every wrapper's
counts, `sort_kernels`' too.
"""

import collections
import ctypes
import functools

import torch

from byzantinemomentum_tpu_torch.ops import _cuda, sort_kernels
from byzantinemomentum_tpu_torch.ops._cuda import (
    MAX_ROWS, reset_launches, supported)

__all__ = ["MAX_ROWS", "MAX_ROUNDS", "supported", "build", "sq_gram",
           "sq_gram_plain", "gram_geometry", "rows_mean_geometry",
           "median_mean_width",
           "weighted_rows_mean", "select_rows",
           "masked_rows_mean", "masked_rows_mean_plain",
           "selected_median_mean", "selected_median_mean_plain",
           "reset_launches"]

MAX_ROUNDS = 62   # kMaxRounds in csrc/gar_kernels.cu
# sq_gram, as csrc/gar_kernels.cu has them (checked when the library loads)
GRAM_STAGES = 2         # kGramStages: slabs in the cp.async ring
GRAM_MAX_BLOCK = 8      # kGramMaxBlock: largest row block (B^2 registers)
GRAM_MAX_THREADS = 288  # kGramMaxThreads
GRAM_MIN_TILE = 128     # columns of a slab, at least
SMEM_LIMIT = 232_448    # shared memory one block may use on an H100
MEAN_THREADS = 256      # kMeanThreads
MEDIAN_PAIR_ROUNDS = 32  # kMedianPairRounds: selected_median_mean's V = 2 forms


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
    """The loaded library of `build(rounds)`, its entries typed; raises if
    it disagrees with this module's constants."""
    lib = ctypes.CDLL(str(build(rounds)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if rounds == 0:
        limits = ("bmt_max_rounds", "bmt_gram_stages", "bmt_gram_max_block",
                  "bmt_gram_max_threads")
        for name in limits:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.bmt_sq_gram_resident.argtypes = [i32, i32, i32, i32]
        lib.bmt_sq_gram_resident.restype = i32
        lib.bmt_sq_gram.argtypes = [ptr, ptr, ptr, i32, i64, i32, i32, i32,
                                    i32, i32, i32, i32, ptr]
        lib.bmt_sq_gram.restype = i32
        lib.bmt_rows_mean_resident.argtypes = [i32, i32]
        lib.bmt_rows_mean_resident.restype = i32
        lib.bmt_weighted_rows_mean.argtypes = [ptr, ptr, ptr, i32, i32, i64,
                                               i32, i32, i32, ptr]
        lib.bmt_weighted_rows_mean.restype = i32
        lib.bmt_masked_rows_mean.argtypes = [ptr, ptr, ptr, i32, i64, i32,
                                             ptr]
        lib.bmt_masked_rows_mean.restype = i32
        if tuple(getattr(lib, name)() for name in limits) != (
                MAX_ROUNDS, GRAM_STAGES, GRAM_MAX_BLOCK, GRAM_MAX_THREADS):
            raise RuntimeError("csrc/gar_kernels.cu and ops/gar_kernels.py "
                               "disagree on MAX_ROUNDS or the GRAM_ limits")
    else:
        for name in ("bmt_rounds", "bmt_median_pair_rounds"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.bmt_median_mean_resident.argtypes = [i32]
        lib.bmt_median_mean_resident.restype = i32
        lib.bmt_selected_median_mean.argtypes = [ptr, ptr, ptr, i32, i64,
                                                 i32, i32, i32, ptr]
        lib.bmt_selected_median_mean.restype = i32
        if (lib.bmt_rounds(), lib.bmt_median_pair_rounds()) != (
                rounds, MEDIAN_PAIR_ROUNDS):
            raise RuntimeError(f"library {lib._name} is not built for "
                               f"{rounds} rounds with two columns a thread "
                               f"up to {MEDIAN_PAIR_ROUNDS}")
    return lib


# --------------------------------------------------------------------------- #
# sq_gram

def sq_gram_plain(g):
    """`g @ g.T` (f32[n, d] -> f32[n, n]); non-finite rows poison their
    entries, which `_common.distances_from_sq_gram` maps to +inf."""
    return g @ g.T


def vector_bytes(d, address):
    """The widest access of 16, 8 or 4 bytes that every row of an f32
    (n, d) matrix at `address` can take at column multiples of its
    width: it must divide the row pitch d * 4 and the address."""
    for width in (16, 8):
        if (4 * d) % width == 0 and address % width == 0:
            return width
    return 4


GramGeometry = collections.namedtuple(
    "GramGeometry", "block pairs slices threads tile copy smem")


def gram_geometry(n, d, address):
    """The shape of `sq_gram`'s pass 1 for an f32[n, d] operand at
    `address`.

    block: the row block B. The rows form ceil(n / B) blocks, and a group
      of 8 threads owns one of the `pairs` pairs of the upper triangle of
      blocks, doing B^2 FMAs per 2B floats it reads from shared memory a
      column. B minimizes pairs * (B^2 + 8 B), the FMAs plus the shared
      reads counted at the SM's rate ratio (32 floats against 128 FMAs a
      clock), among the B whose groups fit GRAM_MAX_THREADS: B = 5 at
      n = 25 (no padding), B = 8 at n = 64. (At n = 25, B = 7 reads 7%
      fewer floats of shared memory a column but does 31% more FMAs.)
    slices: column slices per pair, the largest power of two that keeps
      pairs * slices <= 32 groups (256 threads).
    threads: 8 per group, rounded up to whole warps.
    tile: columns of a slab, a multiple of 32 * slices (each lane reads
      whole float4s).
    copy: bytes of each `cp.async` (`vector_bytes`).
    smem: bytes of shared memory, the GRAM_STAGES slabs of the padded rows
      or the cross-slice reduction, whichever is larger.
    """
    def count(b):
        blocks = -(-n // b)
        return blocks * (blocks + 1) // 2

    block = min((b for b in range(1, GRAM_MAX_BLOCK + 1)
                 if 8 * count(b) <= GRAM_MAX_THREADS),
                key=lambda b: (count(b) * (b * b + 8 * b), b))
    pairs = count(block)
    slices = 1
    while pairs * slices * 2 <= 32:
        slices *= 2
    threads = -(-8 * pairs * slices // 32) * 32
    tile = max(GRAM_MIN_TILE, 32 * slices)
    rows = -(-n // block) * block
    smem = 4 * max(GRAM_STAGES * rows * tile, slices * pairs * block * block)
    return GramGeometry(block, pairs, slices, threads, tile,
                        vector_bytes(d, address), smem)


def rows_mean_geometry(r, d, address):
    """`(width, row_block)` of `weighted_rows_mean` for r rows of weights
    over an f32[n, d] operand at `address`: with one row (Krum's w) each
    thread owns `width` = 4, 2 or 1 consecutive columns, the widest
    vector load `vector_bytes` allows; with more, width 1 and a row block
    of MAX_ROWS, so `g` is read once."""
    if r == 1:
        return vector_bytes(d, address) // 4, 1
    return 1, MAX_ROWS


def median_mean_width(rounds, d, address):
    """Columns a thread of `selected_median_mean` owns for `rounds` stage-1
    rounds over an f32[n, d] operand at `address`: 2 (float2 loads) where
    `vector_bytes` allows 8 bytes and rounds <= MEDIAN_PAIR_ROUNDS (two
    stacks of registers), else 1."""
    if rounds <= MEDIAN_PAIR_ROUNDS and vector_bytes(d, address) >= 8:
        return 2
    return 1


def persistent_blocks(work, resident, sms):
    """Blocks of a persistent grid: all that fit on the card at once
    (`resident` a SM), but no more than the `work` items it walks."""
    if resident < 1:
        raise RuntimeError(f"kernel cannot be resident on an SM (query "
                           f"returned {resident})")
    return max(1, min(work, resident * sms))


@functools.cache
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _gram_plan(device_index, n, d, alignment):
    """`(geometry, blocks)` of `sq_gram` on f32[n, d] at an address of
    this alignment (mod 16) on this device. The library's occupancy query
    also admits the plan's shared memory on the device, once."""
    geo = gram_geometry(n, d, alignment)
    with torch.cuda.device(device_index):
        resident = _library().bmt_sq_gram_resident(geo.block, geo.copy,
                                                   geo.threads, geo.smem)
    return geo, persistent_blocks(-(-d // geo.tile), resident,
                                  _sm_count(device_index))


@functools.lru_cache(maxsize=256)
def _rows_mean_plan(device_index, r, d, alignment):
    """`(width, row_block, blocks)` of `weighted_rows_mean`, as
    `_gram_plan`."""
    width, row_block = rows_mean_geometry(r, d, alignment)
    with torch.cuda.device(device_index):
        resident = _library().bmt_rows_mean_resident(width, row_block)
    return width, row_block, persistent_blocks(
        -(-d // (width * MEAN_THREADS)), resident, _sm_count(device_index))


@functools.lru_cache(maxsize=256)
def _median_mean_plan(device_index, rounds, d, alignment):
    """`(width, blocks)` of `selected_median_mean`, as `_gram_plan`."""
    width = median_mean_width(rounds, d, alignment)
    with torch.cuda.device(device_index):
        resident = _library(rounds).bmt_median_mean_resident(width)
    return width, persistent_blocks(-(-d // (width * MEAN_THREADS)), resident,
                                    _sm_count(device_index))


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
    geo, blocks = _gram_plan(g.device.index, n, d, g.data_ptr() % 16)
    # One allocation: the (n, n) result, then the f32[blocks, pairs] partials
    buf = torch.empty(n * n + blocks * n * (n + 1) // 2, dtype=torch.float32,
                      device=g.device)
    out = buf[:n * n].view(n, n)
    _cuda.raise_on("sq_gram", lib.bmt_sq_gram(
        g.data_ptr(), buf.data_ptr() + 4 * n * n, out.data_ptr(), n, d, geo.block,
        geo.copy, blocks, geo.threads, geo.slices, geo.tile, geo.smem,
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
    # A contiguous f32[n] is the one row of an f32[1, n]
    shape = w.shape
    if (w.device != g.device or w.dtype != torch.float32
            or len(shape) not in (1, 2) or shape[-1] != n):
        raise ValueError(f"weighted_rows_mean: w must be f32[{n}] or "
                         f"f32[r, {n}] on {g.device}, got {w.dtype}"
                         f"{tuple(shape)} on {w.device}")
    r = shape[0] if len(shape) == 2 else 1
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"weighted_rows_mean: r = {r} rows of weights "
                         f"outside 1..{MAX_ROWS}")
    w = w.contiguous()
    out = torch.empty((r, d) if len(shape) == 2 else (d,), dtype=torch.float32,
                      device=g.device)
    width, row_block, blocks = _rows_mean_plan(g.device.index, r, d,
                                               g.data_ptr() % 16)
    _cuda.raise_on("weighted_rows_mean", _library().bmt_weighted_rows_mean(
        w.data_ptr(), g.data_ptr(), out.data_ptr(), r, n, d, width,
        row_block, blocks, _cuda.stream(g)))
    _cuda.launched(weighted_rows_mean, g.dtype)
    return out


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
    d = g.shape[1]
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    width, blocks = _median_mean_plan(g.device.index, rounds, d,
                                      g.data_ptr() % 16)
    _cuda.raise_on("selected_median_mean",
                   _library(rounds).bmt_selected_median_mean(
                       W.data_ptr(), g.data_ptr(), out.data_ptr(), n, d, m2,
                       width, blocks, _cuda.stream(g)))
    _cuda.launched(selected_median_mean, g.dtype)
    return out
