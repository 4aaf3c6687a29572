"""Phase and op-class bucketing of a trace's device events
(`byzantinemomentum_tpu/obs/attrib/phases.py`).

Phase identity comes from the `torch.profiler.record_function` ranges
the engine wraps its phases in (`engine/program.py::scope`), named as the
JAX package's `jax.named_scope`s: an event issued inside `attack`, then
inside the line search's `gar`, carries the scope path `attack/gar`
(`kineto.py` builds it from the ranges open on the host when the event
was issued).

Attribution precedence is outermost-first: an adaptive attack's inner
line-search defense calls nest `attack/.../gar` and belong to the attack;
the server's own aggregation carries `gar` (or its `gar_masked` /
`gar_diag` variants) without an enclosing `attack`.

Op classes answer the bandwidth-floor questions independently of phase:
`"mxu"` keeps the JAX package's name for the matrix-unit class, which on
the card means the cuBLAS, cuDNN and CUTLASS GEMM and convolution kernels
(and on the CPU the `aten::mm`/`aten::convolution` family); `"relayout"`
is pure data movement (copies, `Memcpy`, transposes, reshapes);
`"memory"` is everything else (elementwise and reduction kernels, the
port's own CUDA kernels, RNG).

The JAX module's `scope_map_from_hlo` (the instruction-to-scope join its
CPU traces need, out of a compiled module's text) is JAX-only: a torch
trace carries its own ranges, and the port compiles no step program.
"""

import re

__all__ = ["PHASES", "OP_CLASSES", "phase_of", "op_class_of"]

# The engine's phase ranges, most specific first; the order only matters
# for documentation: matching is per path segment
PHASES = ("honest", "attack", "gar_masked", "gar_diag", "gar", "update",
          "metrics")

OP_CLASSES = ("mxu", "relayout", "memory")

_PHASE_SET = frozenset(PHASES)

# Substrings of the matrix-unit kernels and ops: the JAX package's
# (`convolution`, `conv`, `dot`, `cudnn`, `gemm`), the card's GEMM
# families (cuBLAS's `xmma`/`cublas` kernels, CUTLASS, cuDNN's
# `fprop`/`dgrad`/`wgrad` convolutions) and the CPU's autograd nodes of
# the matrix products (`MmBackward0`, `AddmmBackward0`, `BmmBackward0`)
_MXU_NEEDLES = ("convolution", "conv", "dot", "cudnn", "gemm", "xmma",
                "cutlass", "cublas", "fprop", "dgrad", "wgrad", "mmbackward")
# Stems of pure data movement: the JAX package's, and the card's copies
_RELAYOUT_STEMS = ("copy", "reshape", "transpose", "bitcast", "memcpy")
# Substrings of the card's data-movement kernels (`direct_copy_kernel`,
# `CatArrayBatchedCopy`, the transpose kernels)
_RELAYOUT_NEEDLES = ("copy", "transpose")
# aten ops (CPU traces): the matrix-unit family and the relayouts
_MXU_ATEN = ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear", "mv",
             "addmv", "dot", "vdot", "einsum", "conv", "_conv", "cudnn_conv",
             "mkldnn_conv", "convolution")
_RELAYOUT_ATEN = frozenset(("copy_", "reshape", "transpose", "contiguous",
                            "clone", "t", "permute", "view", "_reshape_alias"))


def phase_of(scope):
    """The phase of one scope path (None when no engine phase appears in
    it). Outermost match wins (see module docstring)."""
    if not scope:
        return None
    for segment in scope.split("/"):
        if segment in _PHASE_SET:
            return segment
    return None


def _stem(op_name):
    """`broadcast_add_fusion` -> itself; `dot.7`/`copy.3` -> the opcode."""
    return re.split(r"[.\d]", op_name, maxsplit=1)[0].lower()


def op_class_of(op_name):
    """Coarse hardware class of one event name: "mxu" for GEMMs and
    convolutions, "relayout" for pure data movement, "memory" otherwise.
    Takes CUDA kernel names (`sm90_xmma_gemm_...`, `Memcpy HtoD ...`,
    `void at::native::...direct_copy_kernel_cuda...`), aten op names
    (`aten::mm`, `aten::copy_`) and the JAX package's HLO names alike."""
    name = op_name.lower()
    if name.startswith("aten::"):
        op = name[len("aten::"):]
        if op in _RELAYOUT_ATEN:
            return "relayout"
        if op.startswith(_MXU_ATEN):
            return "mxu"
        return "memory"
    if _stem(name).startswith(_RELAYOUT_STEMS):
        return "relayout"
    if any(needle in name for needle in _MXU_NEEDLES):
        return "mxu"
    if any(needle in name for needle in _RELAYOUT_NEEDLES):
        return "relayout"
    return "memory"
