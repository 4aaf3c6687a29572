"""The hand-written CUDA kernels of the port's key tree and their plain
PyTorch versions: the workers' dropout keep-masks (`dropout_masks` for a
keep rate that is an 8-bit threshold, `bernoulli_masks` for any other)
and the split of a step's key (`split_keys`), on the threefry-2x32 hash
that `prng.py` computes and `jax.random` draws from.

They replace no Pallas kernel: in the JAX package XLA generates the hash
(`byzantinemomentum_tpu/models/core.py::_dropout_mask`, the step's
`jax.random.split`). The plain versions run the hash as eager int64
tensor operations (`prng.split`, `prng.bits8`), some 170 of them a draw:
at the headline's 24.7 M mask elements a step that traffic would double
the step, and a split of the step's key would cost as many launches as
the step's convolutions; WRN-28-10's keep 0.7 (`prng.bernoulli`, an
int64 hash and a float32 uniform) draws 206 M elements a step at S = 9,
B = 20. The kernels (`csrc/prng_kernels.cu`, CUDA C++
for `sm_90a`, built and bound as `ops/_cuda.py` describes, one library)
hash in 32-bit registers.

Dispatch, as every kernel of the port: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches (`<wrapper>.launches`, per operand dtype in
`launches_by_dtype`: both masks under `torch.bool`, the split under
`torch.int64`); `_cuda.reset_launches()` zeroes them.
"""

import ctypes
import functools
import math

import numpy as np
import torch

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.ops import _cuda

__all__ = ["build", "dropout_masks", "dropout_masks_plain",
           "bernoulli_masks", "bernoulli_masks_plain", "bernoulli_threshold",
           "split_keys", "split_keys_plain", "mask_layout", "hash_operations",
           "THREADS", "ITEMS"]

THREADS = 256  # kThreads in csrc/prng_kernels.cu
ITEMS = 8      # kItems: mask elements a thread


def build():
    """Compile `csrc/prng_kernels.cu` if its library does not exist yet;
    returns `(library path, nvcc's output)`."""
    return _cuda.compile_library("prng_kernels.cu", "prng", {})


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("bmt_prng_threads", "bmt_prng_items"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.bmt_dropout_masks.argtypes = [ptr, ptr, i32, i64, i64, i32, i32, i32,
                                      ptr]
    lib.bmt_dropout_masks.restype = i32
    lib.bmt_bernoulli_masks.argtypes = [ptr, ptr, i32, i64, i64, i32, i32,
                                        i64, ptr]
    lib.bmt_bernoulli_masks.restype = i32
    lib.bmt_split_keys.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.bmt_split_keys.restype = i32
    if (lib.bmt_prng_threads(), lib.bmt_prng_items()) != (THREADS, ITEMS):
        raise RuntimeError("csrc/prng_kernels.cu and ops/prng_kernels.py "
                           "disagree on THREADS or ITEMS")
    return lib


def _check_keys(name, keys):
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2 \
            or not keys.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int64[K, 2] keys, got "
                         f"{keys.dtype}{tuple(keys.shape)}")


# --------------------------------------------------------------------------- #
# split_keys

def split_keys_plain(keys, n):
    """`prng.split(keys, n)`: `[n, 2]` for a key `[2]`, `[K, n, 2]` for
    keys `[K, 2]`."""
    return prng.split(keys, n)


@_cuda.counted
def split_keys(keys, n):
    """`split_keys_plain(keys, n)`; kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if keys.device.type == "cpu":
        return split_keys_plain(keys, n)
    flat = keys.reshape(-1, 2) if keys.dim() == 1 else keys
    _check_keys("split_keys", flat)
    if not (isinstance(n, int) and n >= 1 and flat.shape[0] * n < 2**31):
        raise ValueError(f"split_keys: n = {n!r} must be an int >= 1")
    out = torch.empty((*keys.shape[:-1], n, 2), dtype=torch.int64,
                      device=keys.device)
    if flat.shape[0] == 0:
        return out
    _cuda.raise_on("split_keys", _library().bmt_split_keys(
        flat.data_ptr(), out.data_ptr(), flat.shape[0], n,
        _cuda.stream(keys)))
    _cuda.launched(split_keys, torch.int64)
    return out


# --------------------------------------------------------------------------- #
# dropout_masks

def mask_layout(shape):
    """`(B, H, W, C)` of a JAX mask shape: `(B, H, W, C)` (NHWC) as it is,
    `(B, F)` as `(B, 1, 1, F)`."""
    if len(shape) == 4:
        return tuple(shape)
    if len(shape) == 2:
        return (shape[0], 1, 1, shape[1])
    raise ValueError(f"dropout_masks: expected a (B, H, W, C) or (B, F) "
                     f"shape, got {tuple(shape)}")


def _port_shape(S, shape):
    """The port's layout of S workers' masks of JAX shape `shape`:
    `(S, B, C, H, W)` or `(S, B, F)`."""
    if len(shape) == 4:
        B, H, W, C = shape
        return (S, B, C, H, W)
    return (S, *shape)


def _layer_keys(wkeys, j):
    """Key j of `split(wkeys[s], j + 1)` for each worker s, or the
    workers' keys themselves for `j` None."""
    return wkeys if j is None else prng.split(wkeys, j + 1)[:, j]


def dropout_masks_plain(wkeys, j, shape, threshold):
    """Worker s's keep-mask `prng.bits8(split(wkeys[s], j + 1)[j], shape)
    < threshold` for each s of `wkeys: int64[S, 2]` (`shape` the JAX
    per-worker shape, `(B, H, W, C)` or `(B, F)`), in the port's layout
    `bool[S, B, C, H, W]` or `bool[S, B, F]`; `j` None draws from
    `wkeys[s]` itself."""
    keys = _layer_keys(wkeys, j)
    mask = prng.bits8(keys, tuple(shape)) < threshold
    if len(shape) == 4:
        mask = mask.permute(0, 1, 4, 2, 3)
    return mask.contiguous()


@_cuda.counted
def dropout_masks(wkeys, j, shape, threshold):
    """`dropout_masks_plain(wkeys, j, shape, threshold)` (0 <= j < 2^32
    or None, 0 < threshold < 256); kernel on a CUDA tensor, the plain version on a
    CPU one."""
    if wkeys.device.type == "cpu":
        return dropout_masks_plain(wkeys, j, shape, threshold)
    if not (isinstance(threshold, int) and 0 < threshold < 256):
        raise ValueError(f"dropout_masks: threshold {threshold!r} must be an "
                         f"int in 1..255")
    return _launch_masks(dropout_masks, "bmt_dropout_masks", wkeys, j, shape,
                         threshold)


def bernoulli_threshold(p):
    """T with `uniform < float32(p)` iff `bits >> 9 < T` for the 23-bit
    significand `bits >> 9` of a `prng.uniform` draw u = (bits >> 9) *
    2^-23: T = ceil(float32(p) * 2^23) (exact in float64), clamped to
    [0, 2^23]; 0 for a NaN p, which no draw is below."""
    p32 = float(np.float32(p))
    if math.isnan(p32):
        return 0
    return min(max(math.ceil(p32 * 2.0**23), 0), 2**23)


def bernoulli_masks_plain(wkeys, j, shape, p):
    """Worker s's keep-mask `prng.bernoulli(split(wkeys[s], j + 1)[j], p,
    shape)` for each s of `wkeys: int64[S, 2]`, in the port's layout
    (`dropout_masks_plain`'s); `j` None draws from `wkeys[s]` itself."""
    keys = _layer_keys(wkeys, j)
    mask = prng.bernoulli(keys, p, tuple(shape))
    if len(shape) == 4:
        mask = mask.permute(0, 1, 4, 2, 3)
    return mask.contiguous()


@_cuda.counted
def bernoulli_masks(wkeys, j, shape, p):
    """`bernoulli_masks_plain(wkeys, j, shape, p)` (0 <= j < 2^32 or
    None, p a Python float); kernel on a CUDA tensor, comparing the hash's top 23
    bits with `bernoulli_threshold(p)`, the plain version on a CPU one."""
    if wkeys.device.type == "cpu":
        return bernoulli_masks_plain(wkeys, j, shape, p)
    if not isinstance(p, (int, float)):
        raise ValueError(f"bernoulli_masks: p = {p!r} must be a Python number")
    return _launch_masks(bernoulli_masks, "bmt_bernoulli_masks", wkeys, j,
                         shape, bernoulli_threshold(p))


def _launch_masks(wrapper, entry, wkeys, j, shape, threshold):
    """One launch of a mask kernel (`entry` of the library) for S workers'
    layer j (their keys themselves for `j` None; -1 to the kernel) of
    JAX shape `shape`, counted on `wrapper`."""
    name = wrapper.__name__
    _check_keys(name, wkeys)
    B, H, W, C = mask_layout(shape)
    count = B * H * W * C
    if not ((j is None or isinstance(j, int) and 0 <= j < 2**32)
            and count < 2**31):
        raise ValueError(f"{name}: j = {j!r} or a mask of {count} elements "
                         f"out of range")
    S = wkeys.shape[0]
    out = torch.empty(_port_shape(S, tuple(shape)), dtype=torch.bool,
                      device=wkeys.device)
    if S == 0 or count == 0:
        return out
    _cuda.raise_on(name, getattr(_library(), entry)(
        wkeys.data_ptr(), out.data_ptr(), S, -1 if j is None else j, count,
        H * W, C, threshold,
        _cuda.stream(wkeys)))
    _cuda.launched(wrapper, torch.bool)
    return out


def hash_operations(elements):
    """32-bit operations the mask kernels' arithmetic needs for
    `elements` mask elements: the 20 threefry rounds (an add, a rotation
    and an xor each) and 12 key additions, then the xor of the words and
    the compare (the mask or shift of the word rides in the compare)."""
    return elements * (20 * 3 + 12 + 2)

