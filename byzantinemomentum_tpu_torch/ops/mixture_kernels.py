"""The hand-written CUDA kernels of the `--gars-per-call` mixture draw and
their plain PyTorch versions: `operand_hash`, the content hash of a
defense call's operand, and `mixture_draw`, the mixture member drawn from
it (`byzantinemomentum_tpu/engine/step.py::_per_call_uniform`,
`engine/program.py::mixture_index`).

    h = sum(bitcast_u32(G.astype(f32)) * ((i * 2654435761) | 1)) mod 2^32

over the flat index i of G (n x d, f32, bf16 or f16), then
`uniform(fold_in(key, h))` and the member `searchsorted(cum, u * cum[-1],
side="right")` clipped to K - 1, for the K cumulative frequencies `cum`
(f32). The hash sees every bit: NaN payloads and signed zeros pass
through as the widening gives them (an f16 NaN quietened with its payload
shifted up, as XLA's CPU conversion does; a bf16 NaN as its bits shifted
up), nothing is canonicalised.

They replace no Pallas kernel: XLA compiles the hash in the JAX package.
torch has no uint32 multiply that wraps, so the plain version runs the
hash on int64 words (`prng.mul32`, `prng.wrapping_sum32`), several
passes and 8-byte temporaries of n x d; `operand_hash_int64` is the same
sum with one int64 multiply a word (its product wraps modulo 2^64, whose
low 32 bits are the uint32 product), the yardstick a library call would
be. The kernels (`csrc/mixture_kernels.cu`, CUDA C++ for `sm_90a`, one
library, built and bound as `ops/_cuda.py` describes) read G once.

Dispatch, as every kernel of the port: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches (`<wrapper>.launches`, per operand dtype in
`launches_by_dtype`: the hash under G's dtype, the draw under int64);
`_cuda.reset_launches()` zeroes them.
"""

import ctypes
import functools

import torch

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.ops import _cuda

__all__ = ["build", "operand_hash", "operand_hash_plain",
           "operand_hash_int64", "mixture_draw", "mixture_draw_plain",
           "inverse_cdf", "widened_bits", "DTYPES", "KNUTH", "THREADS"]

THREADS = 256  # kThreads in csrc/mixture_kernels.cu
KNUTH = 2654435761
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASK32 = prng.MASK32


def build():
    """Compile `csrc/mixture_kernels.cu` if its library does not exist
    yet; returns `(library path, nvcc's output)`."""
    return _cuda.compile_library("mixture_kernels.cu", "mixture", {})


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bmt_mixture_threads.argtypes = []
    lib.bmt_mixture_threads.restype = i32
    lib.bmt_operand_hash.argtypes = [ptr, i32, i64, i32, ptr, ptr]
    lib.bmt_operand_hash.restype = i32
    lib.bmt_mixture_draw.argtypes = [ptr, ptr, ptr, i32, ptr, ptr]
    lib.bmt_mixture_draw.restype = i32
    if lib.bmt_mixture_threads() != THREADS:
        raise RuntimeError("csrc/mixture_kernels.cu and "
                           "ops/mixture_kernels.py disagree on THREADS")
    return lib


@functools.cache
def _blocks(device_index):
    """The hash's grid: eight blocks a multiprocessor (the loop strides
    over the rest)."""
    return 8 * torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_operand(name, G):
    if G.dtype not in DTYPES:
        raise ValueError(f"{name}: expected f32, bf16 or f16, got {G.dtype}")
    if G.numel() >= 2**32:
        raise ValueError(f"{name}: {G.numel()} elements exceed the 32-bit "
                         f"flat index")


# --------------------------------------------------------------------------- #
# operand_hash

def widened_bits(G):
    """The uint32 words (int64) of `G.astype(f32)`, flat: f32 as it is,
    bf16 shifted up, f16 through the exact float conversion with every NaN
    quietened and its payload shifted up by 13 (x86's conversion, which
    XLA's CPU takes; the card's may canonicalise a NaN)."""
    flat = G.reshape(-1)
    if flat.dtype == torch.float32:
        return flat.view(torch.int32).to(torch.int64) & _MASK32
    half = flat.view(torch.int16).to(torch.int64) & 0xFFFF
    if flat.dtype == torch.bfloat16:
        return half << 16
    finite = flat.float().view(torch.int32).to(torch.int64) & _MASK32
    nan = ((half & 0x8000) << 16) | 0x7FC00000 | ((half & 0x3FF) << 13)
    return torch.where(torch.isnan(flat), nan, finite)


def _weights(count, device):
    """`(i * 2654435761) | 1` mod 2^32 of the flat indices, int64."""
    index = torch.arange(count, dtype=torch.int64, device=device)
    return prng.mul32(index, KNUTH) | 1


def operand_hash_plain(G):
    """The hash of G as an int64 0-d tensor on G's device, on int64 words
    (`prng.mul32`, `prng.wrapping_sum32`)."""
    _check_operand("operand_hash", G)
    bits = widened_bits(G)
    return prng.wrapping_sum32(prng.mul32(bits, _weights(bits.numel(), G.device)))


def operand_hash_int64(G):
    """The hash with one int64 multiply a word: the product wraps modulo
    2^64, whose low 32 bits are the uint32 product (the yardstick of the
    plain version's passes)."""
    bits = widened_bits(G)
    index = torch.arange(bits.numel(), dtype=torch.int64, device=G.device)
    weights = ((index * KNUTH) & _MASK32) | 1
    return torch.sum((bits * weights) & _MASK32) & _MASK32


@_cuda.counted
def operand_hash(G):
    """`operand_hash_plain(G)`; kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if G.device.type == "cpu":
        return operand_hash_plain(G)
    _check_operand("operand_hash", G)
    G = G.contiguous()
    out = torch.empty((), dtype=torch.int64, device=G.device)
    count = G.numel()
    blocks = max(1, min(_blocks(G.device.index), -(-count // (4 * THREADS))))
    _cuda.raise_on("operand_hash", _library().bmt_operand_hash(
        G.data_ptr(), DTYPES[G.dtype], count, blocks, out.data_ptr(),
        _cuda.stream(G)))
    _cuda.launched(operand_hash, G.dtype)
    return out


# --------------------------------------------------------------------------- #
# mixture_draw

def inverse_cdf(u, cum):
    """The member that the 0-d f32 uniform `u` draws over the cumulative
    frequencies `cum: f32[K]` on its device, an int32 0-d tensor:
    `searchsorted(cum, u * cum[-1], side="right")` clipped to the last
    member (`engine/program.py::mixture_index` on the host)."""
    index = torch.searchsorted(cum, (u * cum[-1]).reshape(1), right=True)
    return index.clamp(max=cum.shape[0] - 1).to(torch.int32).reshape(())


def mixture_draw_plain(key, h, cum):
    """The member drawn from `uniform(fold_in(key, h))` over the
    cumulative frequencies `cum: f32[K]`, an int32 0-d tensor (`key`
    int64[2], `h` an int64 0-d tensor, all on one device)."""
    return inverse_cdf(prng.uniform(prng.fold_in(key, h), ()), cum)


@_cuda.counted
def mixture_draw(key, h, cum):
    """`mixture_draw_plain(key, h, cum)`; kernel on CUDA tensors, the
    plain version on CPU ones."""
    if key.device.type == "cpu":
        return mixture_draw_plain(key, h, cum)
    if not (key.dtype == torch.int64 and tuple(key.shape) == (2,)
            and h.dtype == torch.int64 and h.dim() == 0
            and cum.dtype == torch.float32 and cum.dim() == 1
            and cum.shape[0] >= 1):
        raise ValueError(f"mixture_draw: expected int64[2], int64[] and "
                         f"f32[K], got {key.dtype}{tuple(key.shape)}, "
                         f"{h.dtype}{tuple(h.shape)} and "
                         f"{cum.dtype}{tuple(cum.shape)}")
    key, h, cum = key.contiguous(), h.contiguous(), cum.contiguous()
    out = torch.empty((), dtype=torch.int32, device=key.device)
    _cuda.raise_on("mixture_draw", _library().bmt_mixture_draw(
        key.data_ptr(), h.data_ptr(), cum.data_ptr(), cum.shape[0],
        out.data_ptr(), _cuda.stream(key)))
    _cuda.launched(mixture_draw, torch.int64)
    return out
