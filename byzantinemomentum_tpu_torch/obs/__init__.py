"""Run observation (`byzantinemomentum_tpu/obs/`), the part ported so far:
the host-side suspicion tracker over the GAR diagnostics stream
(`forensics.py`, `--gar-diagnostics`). The JAX package's recorder,
heartbeat, perf, attribution, trace, health and metrics modules are not
ported yet, so the tracker keeps its suspect edges without emitting
events."""

from byzantinemomentum_tpu_torch.obs.forensics import (  # noqa: F401
    COLLUSION_FRAC,
    Z_CLIP,
    SuspicionTracker,
    collusion_partners,
)

__all__ = ["SuspicionTracker", "Z_CLIP", "COLLUSION_FRAC",
           "collusion_partners"]
