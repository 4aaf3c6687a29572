"""The hand-written CUDA kernels of the coordinate-wise GARs and their
plain PyTorch versions — the port's counterpart of
`byzantinemomentum_tpu/ops/pallas_sort.py` (`lower_median`,
`trimmed_mean`, `closest_mean`, `colsort`, and the Batcher schedule
`_batcher_pairs`), with the keyed selection network of `csrc/batcher.cuh`
that the CUDA kernels unroll modelled step for step (`selection_pairs`,
`select_keys`, `value_keys`, `half_keys`, `deviation_keys`).

Kernels live in `csrc/sort_kernels.cu` (CUDA C++ for `sm_90a`), built and
bound as `ops/_cuda.py` describes: one library per (kernel, row count n,
element type) that a run meets, since each sorting network is unrolled
for its n; for `closest_mean` per m too, since its keyed network is
pruned to rank m - 1, and for `trimmed_mean` per f, since its keyed
network is pruned to the ranks [f, n - f) (`selection_pairs`); `colsort`
runs the whole network. They launch on `torch.cuda.current_stream()`,
with two columns a thread where the operands allow it (`column_width`).

Dtypes: f32, bf16 and f16, the JAX kernels' (`pallas_sort.supported`).
Arithmetic is the storage type's, as in the JAX kernels: every add,
subtract and divide rounds to `g.dtype`, and outputs have `g.dtype`. The
plain versions repeat that arithmetic step for step (torch rounds each
elementwise op on a half tensor to its dtype), and sum in the kernels'
order; float64 stays outside the domain.

Dispatch, as in `ops/gar_kernels.py`: a wrapper given a CPU tensor runs
the plain version; given a CUDA tensor it checks it (one of `DTYPES`,
2-D, contiguous, 1 <= n <= MAX_ROWS, the rank bound in range) and
launches the kernel or raises. Callers (`ops/_common.py`, `ops/trmean.py`)
route operands outside `supported()` to the plain version, as the JAX
package routes operands outside `pallas_sort.supported` to its jnp path.

Semantics are the JAX package's: NaN sorts last, the median is the
lower one, and `torch.median`/`torch.quantile`, which propagate NaN, are
never used. The plain versions sort through `sort_nan_last`, which hands
`torch.sort` no NaN: on the card (torch 2.11, CUDA 12.8, H100) it placed
a NaN first in some columns of a bf16 [64, 20011] operand.
"""

import ctypes
import functools

import torch

from byzantinemomentum_tpu_torch.ops import _cuda
from byzantinemomentum_tpu_torch.ops._cuda import MAX_ROWS, reset_launches

__all__ = ["MAX_ROWS", "KERNELS", "DTYPES", "supported", "build",
           "batcher_pairs", "selection_pairs", "selection_operations",
           "select_keys", "value_keys", "key_values", "deviation_keys",
           "half_keys", "half_key_values",
           "column_width",
           "sort_nan_last", "lower_median",
           "lower_median_plain", "trimmed_mean", "trimmed_mean_plain",
           "closest_mean", "closest_mean_plain", "colsort", "colsort_plain",
           "reset_launches"]

# The kernels of csrc/sort_kernels.cu, in BMT_SORT_KERNEL order (1..4)
KERNELS = ("lower_median", "trimmed_mean", "closest_mean", "colsort")
# Element types, in BMT_DTYPE order (1..3)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def supported(g):
    """Whether the sorting kernels apply to this operand: a CUDA f32, bf16
    or f16 matrix with 1 <= n <= MAX_ROWS rows."""
    return _cuda.supported(g, DTYPES)


# --------------------------------------------------------------------------- #
# Build and binding

def build(kernel, n, dtype=torch.float32, m=None, f=None):
    """Compile the library of `csrc/sort_kernels.cu` that holds `kernel`
    for `n` rows of `dtype` (and, for `closest_mean` only, `m` closest
    values, for which its network is pruned to rank m - 1; for
    `trimmed_mean` only, the trim `f`, for which it is pruned to the ranks
    [f, n - f)), if it does not exist yet; returns `(library path, nvcc's
    output)`."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown sort kernel {kernel!r}, expected one of {KERNELS}")
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"n = {n} rows outside 1..{MAX_ROWS}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} outside {DTYPES}")
    if (kernel == "closest_mean") != (m is not None):
        raise ValueError(f"m = {m!r}: closest_mean takes one, the other "
                         f"kernels none")
    if (kernel == "trimmed_mean") != (f is not None):
        raise ValueError(f"f = {f!r}: trimmed_mean takes one, the other "
                         f"kernels none")
    defines = {"BMT_SORT_KERNEL": KERNELS.index(kernel) + 1, "BMT_N": n,
               "BMT_DTYPE": DTYPES.index(dtype) + 1}
    tag = f"{kernel}-n{n}-{_cuda.DTYPE_NAMES[dtype]}"
    if m is not None:
        if not 1 <= m <= n:
            raise ValueError(f"m = {m} outside 1..{n}")
        defines["BMT_M"] = m
        tag += f"-m{m}"
    if f is not None:
        if not 0 <= 2 * f < n:
            raise ValueError(f"f = {f} outside 0 <= f < {n}/2")
        defines["BMT_F"] = f
        tag += f"-f{f}"
    return _cuda.compile_library("sort_kernels.cu", tag, defines)


@functools.cache
def _entry(kernel, n, dtype, m=None, f=None):
    """The typed C entry `bmt_<kernel>` of the loaded `build(kernel, n,
    dtype, m, f)`."""
    lib = ctypes.CDLL(str(build(kernel, n, dtype, m, f)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("bmt_sort_n", "bmt_sort_kernel", "bmt_sort_dtype",
                 "bmt_sort_m", "bmt_sort_f"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if ((lib.bmt_sort_n(), lib.bmt_sort_kernel(), lib.bmt_sort_dtype(),
         lib.bmt_sort_m(), lib.bmt_sort_f())
            != (n, KERNELS.index(kernel) + 1, DTYPES.index(dtype) + 1,
                m or 0, f or 0)):
        raise RuntimeError(f"library {lib._name} is not built for {kernel} "
                           f"at n = {n}, m = {m}, f = {f} in {dtype}")
    entry = getattr(lib, f"bmt_{kernel}")
    entry.argtypes = {"lower_median": [ptr, ptr, i64, i32, ptr],
                      "trimmed_mean": [ptr, ptr, i64, i32, ptr],
                      "closest_mean": [ptr, ptr, ptr, i64, i32, ptr],
                      "colsort": [ptr, ptr, i64, i32, ptr]}[kernel]
    entry.restype = i32
    return entry


def _launch(wrapper, g, *args, m=None, f=None):
    """Launch the entry of `wrapper`'s kernel for the row count and dtype
    of the checked operand `g` (and `m` or `f`) on `args` (pointers and
    ints), raise on a CUDA error, and count the launch."""
    kernel = wrapper.__name__
    _cuda.raise_on(kernel, _entry(kernel, g.shape[0], g.dtype, m, f)(
        *args, _cuda.stream(g)))
    _cuda.launched(wrapper, g.dtype)


# Rows up to which a thread of a sorting kernel may own two columns
# (kPairRows in csrc/sort_kernels.cu)
PAIR_ROWS = 32


def column_width(n, d, element_size, *addresses):
    """Columns a thread of a sorting kernel owns on a [n, d] operand whose
    inputs (and, for `colsort`, output) start at `addresses`: 2 (two
    adjacent elements a row, moved as one word) where n <= PAIR_ROWS, d is
    even and every address is aligned to two elements, else 1."""
    pair = 2 * element_size
    if n <= PAIR_ROWS and d % 2 == 0 and all(a % pair == 0 for a in addresses):
        return 2
    return 1


# --------------------------------------------------------------------------- #
# The Batcher network the kernels unroll

def batcher_pairs(n):
    """Batcher odd-even mergesort compare-exchange schedule for n rows
    (the schedule of `pallas_sort._batcher_pairs`, which
    `selection_schedule` in `csrc/batcher.cuh` computes and prunes)."""
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


def _window(n, ranks):
    """`ranks` (None: every rank; an int r: range(r, r + 1); a range of
    step 1) as a non-empty `range` inside 0..n - 1."""
    if ranks is None:
        return range(n)
    if isinstance(ranks, int):
        ranks = range(ranks, ranks + 1)
    if (not isinstance(ranks, range) or ranks.step != 1 or not ranks
            or ranks.start < 0 or ranks.stop > n):
        raise ValueError(f"ranks {ranks!r} outside 0..{n - 1}, or not a "
                         f"non-empty window of consecutive ranks")
    return ranks


def selection_pairs(n, ranks=None):
    """The Batcher schedule pruned to the comparators on which the output
    ranks `ranks` depend: one rank (an int), a window of consecutive ranks
    (a `range`), or every rank (None, a full sort). It is the schedule
    that `key_select` / `key_select_window` in `csrc/batcher.cuh` unroll
    for `lower_median`, `trimmed_mean` (the window [f, n - f)),
    `closest_mean`, `selected_median_mean` and `colsort` (every rank).
    Working backwards from the output wires, a comparator touching a live
    wire is kept and makes both its wires live. Returns `(i, j, side)` triples in network order:
    `side` is "both" (min to i, max to j), "min" (only wire i is read
    later: i = min) or "max" (only j: j = max)."""
    window = _window(n, ranks)
    live = [wire in window for wire in range(n)]
    kept = []
    for i, j in reversed(batcher_pairs(n)):
        if live[i] or live[j]:
            kept.append((i, j, "both" if live[i] and live[j]
                         else "min" if live[i] else "max"))
            live[i] = live[j] = True
    return tuple(reversed(kept))


def selection_operations(n, ranks=None):
    """Min/max instructions of `selection_pairs(n, ranks)`: two for a
    two-sided comparator, one for a one-sided one."""
    return sum(2 if side == "both" else 1
               for _, _, side in selection_pairs(n, ranks))


def select_keys(keys, ranks=None):
    """Run `selection_pairs(len(keys), ranks)` over a list of equal-shape
    integer key rows (the kernels' keyed network, step for step); returns
    the list, whose entries at `ranks` are then the keys of those ranks
    (sorted for `ranks=None`)."""
    keys = list(keys)
    for i, j, side in selection_pairs(len(keys), ranks):
        a, b = keys[i], keys[j]
        if side != "max":
            keys[i] = torch.minimum(a, b)
        if side != "min":
            keys[j] = torch.maximum(a, b)
    return keys


NAN_KEY = 0xFFFFFFFF
INF_KEY = 0x7F800000


def value_keys(x):
    """`bmt::value_key` of every entry of `x` (any float dtype; a half
    value is widened to f32 exactly) as int64: the uint32 whose unsigned
    order is the NaN-last float order, -0 one key below +0, every NaN
    NAN_KEY."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    keys = torch.where(bits >> 31 == 1, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)
    return torch.where(torch.isnan(x), NAN_KEY, keys)


def key_values(keys):
    """The f32 values of `value_keys` (the NaN key gives a NaN)."""
    bits = torch.where(keys >> 31 == 1, keys ^ 0x80000000, keys ^ 0xFFFFFFFF)
    return (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)


# +inf's bits in each 16-bit dtype (Elem<T>::kInfBits)
HALF_INF_BITS = {torch.bfloat16: 0x7F80, torch.float16: 0x7C00}


def half_keys(x):
    """`bmt::pair_key`, one lane per entry of a bf16 or f16 tensor, as
    int64: the 16-bit key of the half forms of `lower_median`,
    `trimmed_mean` and `colsort` at two columns a thread. Every NaN's sign
    is cleared (a NaN is a magnitude whose sum with 0x7fff - inf's bits
    reaches bit 15), so every NaN keys above +inf; then the negative values
    flip all 16 bits, the others the sign bit. Unsigned order is the NaN-last
    order, -0 one key below +0."""
    bits = x.view(torch.int16).to(torch.int64) & 0xFFFF
    nan = ((bits & 0x7FFF) + 0x7FFF - HALF_INF_BITS[x.dtype]) & 0x8000
    bits = bits & ~nan
    return torch.where(bits >> 15 == 1, bits ^ 0xFFFF, bits ^ 0x8000)


def half_key_values(keys, dtype):
    """The `dtype` values of `half_keys` (`bmt::pair_bits`; a NaN's key
    gives a NaN)."""
    bits = torch.where(keys >> 15 == 1, keys ^ 0x8000, keys ^ 0xFFFF)
    return (bits - ((bits >> 15) << 16)).to(torch.int16).view(dtype)


def deviation_keys(dev):
    """`bmt::deviation_key` of non-negative or NaN deviations: their f32
    bits as int64 (0 <= finite < INF_KEY < every NaN)."""
    return dev.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Plain versions

def sort_nan_last(g):
    """The columns of `g` sorted ascending, NaN last. NaN is sorted as +inf
    and written back over each column's last places, so `torch.sort`
    never compares a NaN."""
    nan = torch.isnan(g)
    srt = torch.sort(torch.where(nan, torch.inf, g), dim=0).values
    rank = torch.arange(g.shape[0], device=g.device)[:, None]
    return torch.where(rank >= g.shape[0] - nan.sum(dim=0), torch.nan, srt)


def colsort_plain(g):
    """Every column sorted ascending, NaN last."""
    return sort_nan_last(g)


def lower_median_plain(g):
    """Coordinate-wise lower median `sorted[(n - 1) // 2]`, NaN last."""
    n = g.shape[0]
    return sort_nan_last(g)[(n - 1) // 2]


def _sum_rows(rows, start):
    """`start + rows[0] + rows[1] + ...`, one rounded add at a time in
    the dtype of the rows (the kernels' order)."""
    acc = start
    for row in rows:
        acc = acc + row
    return acc


def trimmed_mean_plain(g, f):
    """Coordinate-wise mean of sorted ranks [f, n - f), NaN last: summed
    in ascending rank order from rank f, then divided by n - 2f."""
    n = g.shape[0]
    ranks = sort_nan_last(g)[f:n - f]
    # A divisor on g's device: torch on CUDA turns a division by a Python
    # number into a product with its reciprocal, which may round the
    # quotient one ulp away from the kernels' division
    count = torch.full((), n - 2 * f, dtype=g.dtype, device=g.device)
    return _sum_rows(ranks[1:], ranks[0]) / count


def closest_mean_plain(g, c, m):
    """Coordinate-wise mean of the `m` values closest to center `c`:
    everything strictly below the m-th smallest deviation, then the ties
    at it in index order (the stable-argsort selection), summed in index
    order from 0. NaN deviations sort last; fewer than m finite values
    gives NaN."""
    dev = torch.abs(g - c[None, :])
    thresh = sort_nan_last(dev)[m - 1]
    lt = dev < thresh
    eq = dev == thresh
    need = m - lt.sum(dim=0)
    take = lt | (eq & (torch.cumsum(eq.int(), dim=0) <= need))
    kept = torch.where(take, g, 0.0)
    out = _sum_rows(kept, torch.zeros_like(kept[0])) / m
    return torch.where(torch.isnan(thresh), torch.nan, out)


# --------------------------------------------------------------------------- #
# Kernel wrappers

def _output(g, rows=None):
    shape = (g.shape[1],) if rows is None else (rows, g.shape[1])
    return torch.empty(shape, dtype=g.dtype, device=g.device)


@_cuda.counted
def colsort(g):
    """`colsort_plain(g)` in one read and one write of `g` (kernel on a
    CUDA tensor, the plain version on a CPU one). Values and NaN positions
    are the plain version's; the kernel sorts on keys, so every -0 of a
    column comes before its +0, and a NaN may come back with another sign
    or payload (the plain version writes `torch.nan`)."""
    if g.device.type == "cpu":
        return colsort_plain(g)
    _cuda.check_matrix("colsort", g, DTYPES)
    n, d = g.shape
    out = _output(g, n)
    # A fresh allocation is aligned in practice; a thread of two columns
    # moves them as one word, so out's address is checked as g's
    width = column_width(n, d, g.element_size(), g.data_ptr(), out.data_ptr())
    _launch(colsort, g, g.data_ptr(), out.data_ptr(), d, width)
    return out


@_cuda.counted
def lower_median(g):
    """`lower_median_plain(g)` in one read of `g` and one (d,) write
    (kernel on a CUDA tensor, the plain version on a CPU one)."""
    if g.device.type == "cpu":
        return lower_median_plain(g)
    _cuda.check_matrix("lower_median", g, DTYPES)
    n, d = g.shape
    out = _output(g)
    width = column_width(n, d, g.element_size(), g.data_ptr())
    _launch(lower_median, g, g.data_ptr(), out.data_ptr(), d, width)
    return out


@_cuda.counted
def trimmed_mean(g, f):
    """`trimmed_mean_plain(g, f)` in one read of `g` (0 <= f, 2f < n);
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return trimmed_mean_plain(g, f)
    _cuda.check_matrix("trimmed_mean", g, DTYPES)
    n, d = g.shape
    if not (isinstance(f, int) and 0 <= f and 2 * f < n):
        raise ValueError(f"trimmed_mean: f = {f!r} outside 0 <= f < {n}/2")
    out = _output(g)
    width = column_width(n, d, g.element_size(), g.data_ptr())
    _launch(trimmed_mean, g, g.data_ptr(), out.data_ptr(), d, width, f=f)
    return out


@_cuda.counted
def closest_mean(g, c, m):
    """`closest_mean_plain(g, c, m)` in one read of `g` and `c` (1 <= m <=
    n, `c` of `g`'s dtype); kernel on a CUDA tensor, the plain version on
    a CPU one."""
    if g.device.type == "cpu":
        return closest_mean_plain(g, c, m)
    _cuda.check_matrix("closest_mean", g, DTYPES)
    n, d = g.shape
    if (c.device != g.device or c.dtype != g.dtype or c.dim() != 1
            or c.shape[0] != d or not c.is_contiguous()):
        raise ValueError(f"closest_mean: c must be a contiguous "
                         f"{g.dtype}[{d}] on {g.device}, got "
                         f"{c.dtype}{tuple(c.shape)} on {c.device}")
    if not (isinstance(m, int) and 1 <= m <= n):
        raise ValueError(f"closest_mean: m = {m!r} outside 1..{n}")
    out = _output(g)
    width = column_width(n, d, g.element_size(), g.data_ptr(), c.data_ptr())
    _launch(closest_mean, g, g.data_ptr(), c.data_ptr(), out.data_ptr(),
            d, width, m=m)
    return out
