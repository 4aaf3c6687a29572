"""Aksel GAR (`byzantinemomentum_tpu/ops/aksel.py`).

Coordinate-wise median center (the `lower_median` kernel on the card),
rank workers by squared L2 distance to it, average the c closest —
c = (n+1)//2 in 'mid' mode, n-f in 'n-f' mode.
"""

import torch

from byzantinemomentum_tpu_torch.ops import register
from byzantinemomentum_tpu_torch.ops._common import (
    lower_median, sanitize_inf, selection_influence)

__all__ = ["aggregate", "selection"]


def _count(n, f, mode):
    if mode == "mid":
        return (n + 1) // 2
    if mode == "n-f":
        return n - f
    raise NotImplementedError(f"Unknown aksel mode {mode!r}")


def selection(gradients, f, mode="mid", **kwargs):
    """Indices of the c gradients closest (squared L2) to the median, in
    stable-sort order; non-finite distances rank last."""
    n = gradients.shape[0]
    med = lower_median(gradients)
    sqd = sanitize_inf(torch.sum((gradients - med[None, :]) ** 2, dim=1))
    return torch.argsort(sqd, stable=True)[:_count(n, f, mode)]


def aggregate(gradients, f, mode="mid", **kwargs):
    """Aksel: the mean of the selected rows, gathered in score order."""
    return gradients[selection(gradients, f, mode)].mean(dim=0)


def check(gradients, f, mode="mid", **kwargs):
    n = gradients.shape[0]
    if n < 1:
        return f"Expected at least one gradient to aggregate, got {n}"
    if not isinstance(f, int) or f < 1 or n < 2 * f + 1:
        return f"Invalid number of Byzantine gradients to tolerate, got f = {f!r}, expected 1 <= f <= {(n - 1) // 2}"
    if mode not in ("mid", "n-f"):
        return f"Invalid operation mode {mode!r}"


# Fraction of selected gradients that are Byzantine (reference
# `aggregators/aksel.py:83-105`)
influence = selection_influence(selection)


register("aksel", aggregate, check, influence=influence)
