"""Aksel GAR (`byzantinemomentum_tpu/ops/aksel.py`).

Coordinate-wise median center (the `lower_median` kernel on the card),
rank workers by squared L2 distance to it, average the c closest —
c = (n+1)//2 in 'mid' mode, n-f in 'n-f' mode. `diagnose` takes its
scores from the same median distances (one `lower_median` launch) and
computes the distances, which the rule itself never needs.
`aggregate_masked` is the dynamic quorum's aksel (`faults/quorum.py`).
"""

import torch

from byzantinemomentum_tpu_torch.ops import diag, register
from byzantinemomentum_tpu_torch.ops._common import (
    lower_median, masked_lower_median, masked_rank_mean, pairwise_distances,
    row_sum_stable, sanitize_inf, selection_influence)

__all__ = ["aggregate", "aggregate_masked", "diagnose", "selection"]


def _count(n, f, mode):
    if mode == "mid":
        return (n + 1) // 2
    if mode == "n-f":
        return n - f
    raise NotImplementedError(f"Unknown aksel mode {mode!r}")


def _median_sq_distances(gradients):
    """Each row's squared L2 distance to the coordinate-wise median,
    non-finite -> +inf."""
    med = lower_median(gradients)
    return sanitize_inf(torch.sum((gradients - med[None, :]) ** 2, dim=1))


def _select(sqd, n, f, mode):
    return torch.argsort(sqd, stable=True)[:_count(n, f, mode)]


def selection(gradients, f, mode="mid", **kwargs):
    """Indices of the c gradients closest (squared L2) to the median, in
    stable-sort order; non-finite distances rank last."""
    return _select(_median_sq_distances(gradients), gradients.shape[0], f,
                   mode)


def aggregate(gradients, f, mode="mid", **kwargs):
    """Aksel: the mean of the selected rows, gathered in score order."""
    return gradients[selection(gradients, f, mode)].mean(dim=0)


def aggregate_masked(gradients, active, n_eff, f_eff, mode="mid", **kwargs):
    """Aksel over the active rows, the counts 0-d int device tensors: the
    masked median center, squared distances to it, and the `c` closest
    active rows averaged in index order (`_common.masked_rank_mean`),
    `c = (n_eff + 1) // 2` ('mid') or `n_eff - f_eff` ('n-f')."""
    n = gradients.shape[0]
    med = masked_lower_median(gradients, active, n_eff)
    sqd = sanitize_inf(row_sum_stable((gradients - med[None, :]) ** 2))
    if mode == "mid":
        c = (n_eff + 1) // 2
    elif mode == "n-f":
        c = n_eff - f_eff
    else:
        raise NotImplementedError(f"Unknown aksel mode {mode!r}")
    return masked_rank_mean(gradients, sqd, active, torch.clamp(c, 1, n))


def diagnose(gradients, f, mode="mid", **kwargs):
    """The aggregate and its aux: the squared median distances as scores,
    the selected rows' 0/1 mask and the distances."""
    n = gradients.shape[0]
    sqd = _median_sq_distances(gradients)
    sel = _select(sqd, n, f, mode)
    return gradients[sel].mean(dim=0), diag.make_aux(
        n, scores=sqd, selection=diag.selection_from_indices(n, sel),
        dist=pairwise_distances(gradients))


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


register("aksel", aggregate, check, influence=influence, diagnose=diagnose)
