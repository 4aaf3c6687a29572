"""Build, binding and launch bookkeeping shared by the port's CUDA kernel
modules (`ops/gar_kernels.py`, `ops/sort_kernels.py`).

A kernel source of `csrc/` is compiled by `nvcc` for `sm_90a` at first
use into a shared library with a plain C interface under `build/kernels/`
at the root of the checkout, and loaded with ctypes. One source gives
several libraries, one per set of `-D` values (a round count, a row
count): a sorting network unrolled for a large count takes long to
compile, so a run builds only what it meets. A library's name holds a
digest of its source, of the shared headers (`csrc/*.cuh`) and of the
flags, so an edited source is rebuilt.

Every kernel wrapper counts its launches in `<wrapper>.launches`
(`counted`); `reset_launches()` zeroes all of them.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

__all__ = ["MAX_ROWS", "supported", "compile_library", "check_matrix",
           "raise_on", "stream", "counted", "reset_launches"]

MAX_ROWS = 64

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_counted = []


def supported(g):
    """Whether the CUDA kernels apply to this operand: a CUDA f32 matrix
    with 1 <= n <= MAX_ROWS rows (the JAX package's `pallas_gar.supported`
    domain, on the card; `pallas_sort.supported` also admits bf16/f16,
    for which the port's sorting kernels are not built yet)."""
    return (g.is_cuda and g.dtype == torch.float32 and g.dim() == 2
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


def check_matrix(name, g):
    """Raise ValueError unless `g` is what every kernel takes: a CUDA f32
    contiguous (n, d) matrix with 1 <= n <= MAX_ROWS and d >= 1."""
    if not g.is_cuda:
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {g.device}")
    if g.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {g.dtype}")
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
    """The current CUDA stream of `t`'s device, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def counted(wrapper):
    """Give a kernel wrapper its `launches` count (the wrapper adds one
    where it launches its kernel)."""
    wrapper.launches = 0
    _counted.append(wrapper)
    return wrapper


def reset_launches():
    """Zero the launch count of every kernel wrapper."""
    for wrapper in _counted:
        wrapper.launches = 0
