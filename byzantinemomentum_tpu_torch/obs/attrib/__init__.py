"""Phase-attributed device profiling (`byzantinemomentum_tpu/obs/attrib/`).

* **kineto** (`kineto.py`), the counterpart of the JAX package's
  `xplane.py`: a `torch.profiler` trace's device events (the card's
  kernels, copies and sets, or the CPU's outermost aten ops) with the
  phase ranges open when each was issued, joined by time across threads
  (the autograd engine's device thread runs the backward on the card),
  and a size cap (`BMT_XPLANE_MAX_MB`), so a mis-captured window
  degrades to a warning instead of stalling a live run.
* **phases** (`phases.py`): scope path -> engine phase (the
  `record_function` ranges of `engine/program.py::scope`: `honest`,
  `attack`, `gar`/`gar_masked`/`gar_diag`, `update`, `metrics`) and the
  matrix-unit / relayout / memory op-class bucketer.
* **attribution** (`attribution.py`): the per-run `attribution.json`:
  per-phase ms/step, MFU and distance to the floor (`obs/perf.py`'s
  logical FLOPs), relayout ms and the host-gap fraction.

Driver surface: `cli/attack.py --attribution` traces one deterministic
chunk (the first whose step count has run once) and attributes it; the
SIGUSR1 live window auto-attributes too. Nothing here imports torch.
"""

from byzantinemomentum_tpu_torch.obs.attrib.attribution import (  # noqa: F401
    ATTRIBUTION_NAME,
    attribute_events,
    attribute_trace,
    load_attribution,
    write_attribution,
)
from byzantinemomentum_tpu_torch.obs.attrib.phases import (  # noqa: F401
    OP_CLASSES,
    PHASES,
    op_class_of,
    phase_of,
)
from byzantinemomentum_tpu_torch.obs.attrib import kineto  # noqa: F401

__all__ = [
    "ATTRIBUTION_NAME", "attribute_events", "attribute_trace",
    "load_attribution", "write_attribution", "OP_CLASSES", "PHASES",
    "op_class_of", "phase_of", "kineto",
]
