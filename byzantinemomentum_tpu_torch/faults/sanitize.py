"""NaN-quarantine (`byzantinemomentum_tpu/faults/sanitize.py`): detect
numerically corrupt rows and take them out of the active set.

The GARs are NaN-resilient (non-finite values sort last, non-finite
distances are +inf) but still count corrupt rows toward `n`. Quarantine
removes the rows that `attacks/nan.py::detect` flags (any non-finite
coordinate) from the active set, so the dynamic quorum
(`faults/quorum.py`) aggregates the healthy rows with a matching
effective `(n, f)`.
"""

import torch

from byzantinemomentum_tpu_torch.attacks.nan import detect as corrupt_rows

__all__ = ["corrupt_rows", "quarantine"]


def quarantine(gradients, active):
    """`(gradients [n, d], active bool[n]) -> (bool[n], i32[])`: the shrunk
    active mask and the number of rows newly quarantined (an inactive
    corrupt row is not counted twice)."""
    bad = corrupt_rows(gradients)
    return active & ~bad, (active & bad).sum(dtype=torch.int32)
