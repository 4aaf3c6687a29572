"""Build, binding and launch bookkeeping shared by the port's CUDA kernel
modules (`ops/gar_kernels.py`, `ops/sort_kernels.py`,
`ops/prng_kernels.py`).

A kernel source of `csrc/` is compiled by `nvcc` for `sm_90a` at first
use into a shared library with a plain C interface under `build/kernels/`
at the root of the checkout, and loaded with ctypes. One source gives
several libraries, one per set of `-D` values (a round count, a row
count, an element type): a sorting network unrolled for a large count takes long to
compile, so a run builds only what it meets. A library's name holds a
digest of its source, of the shared headers (`csrc/*.cuh`) and of the
flags, so an edited source is rebuilt.

Every kernel wrapper counts its launches in `<wrapper>.launches`, and
per operand dtype in `<wrapper>.launches_by_dtype` (`counted`,
`launched`); `reset_launches()` zeroes all of them.

Domains: the kernels of `gar_kernels` take f32 only (the JAX package's
`pallas_gar.supported`), those of `sort_kernels` f32, bf16 and f16
(`pallas_sort.supported`), so `supported` and `check_matrix` take the
dtypes a caller admits.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

__all__ = ["MAX_ROWS", "F32", "DTYPE_NAMES", "supported", "compile_library",
           "check_matrix", "raise_on", "stream", "counted", "launched",
           "reset_launches"]

MAX_ROWS = 64
F32 = (torch.float32,)
# Spelling of each operand type a kernel is built for or counted under
# (`prng_kernels` counts its masks under bool, its split under int64)
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.bool: "bool", torch.int64: "i64"}

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_counted = []


def supported(g, dtypes=F32):
    """Whether the CUDA kernels apply to this operand: a CUDA matrix of
    one of `dtypes` with 1 <= n <= MAX_ROWS rows (the JAX package's
    `pallas_gar.supported` / `pallas_sort.supported` domains, on the
    card)."""
    return (g.is_cuda and g.dtype in dtypes and g.dim() == 2
            and 1 <= g.shape[0] <= MAX_ROWS and g.shape[1] >= 1)


def compile_library(source, tag, defines):
    """Compile `csrc/<source>` with `-D<name>=<value>` for each item of
    `defines` into `build/kernels/lib<stem>-<digest>-<tag>.so`, unless it
    exists; returns `(library path, nvcc's output)` (`-Xptxas -v` prints
    each kernel's registers, shared memory and spills)."""
    src = CSRC / source
    headers = b"".join(path.read_bytes() for path in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}-{digest}-{tag}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, log.read_text() if log.is_file() else ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{tag}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, *(f"-D{name}={value}"
                              for name, value in defines.items()),
         "-o", str(tmp), str(src)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({tag}):\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process never sees a torn file
    return lib, proc.stdout + proc.stderr


def check_matrix(name, g, dtypes=F32):
    """Raise ValueError unless `g` is what the kernel takes: a CUDA
    contiguous (n, d) matrix of one of `dtypes` with 1 <= n <= MAX_ROWS
    and d >= 1."""
    if not g.is_cuda:
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {g.device}")
    if g.dtype not in dtypes:
        raise ValueError(f"{name}: expected "
                         f"{' or '.join(str(dtype) for dtype in dtypes)}, "
                         f"got {g.dtype}")
    if g.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D (n, d) matrix, got {tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous matrix")
    if not (1 <= g.shape[0] <= MAX_ROWS and g.shape[1] >= 1):
        raise ValueError(f"{name}: expected 1 <= n <= {MAX_ROWS} rows and "
                         f"d >= 1 columns, got {tuple(g.shape)}")


def raise_on(name, err):
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream(t):
    """The current CUDA stream of `t`'s device, as a ctypes pointer (the
    raw handle, without building a `torch.cuda.Stream`: a kernel call's
    host time is part of a step's)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


def counted(wrapper):
    """Give a kernel wrapper its `launches` count and its
    `launches_by_dtype` counts (the wrapper calls `launched` where it
    launches its kernel)."""
    wrapper.launches = 0
    wrapper.launches_by_dtype = {}
    _counted.append(wrapper)
    return wrapper


def launched(wrapper, dtype):
    """Count one launch of `wrapper`'s kernel on a `dtype` operand."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[dtype] = wrapper.launches_by_dtype.get(dtype, 0) + 1


def reset_launches():
    """Zero the launch counts of every kernel wrapper."""
    for wrapper in _counted:
        wrapper.launches = 0
        wrapper.launches_by_dtype = {}
