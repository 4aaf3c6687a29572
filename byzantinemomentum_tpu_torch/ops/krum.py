"""Multi-Krum GAR (`byzantinemomentum_tpu/ops/krum.py`).

Score of worker i = sum of its n-f-1 smallest distances to the other
workers (plain Euclidean norms, non-finite -> +inf); the aggregate is the
average of the m lowest-score gradients, default m = n-f-2, ties in
stable-sort (index) order.

The distance matrix comes from one Gram pass (`_common.pairwise_distances`,
the `sq_gram` kernel on the card; `method="diff"` reduces the differences
instead, as in the JAX package) and the selected-row average is a
weight-vector product (`_common.weighted_rows_mean`, the
`weighted_rows_mean` kernel on the card), so the rule reads the (n, d)
matrix twice. `diagnose` runs the same two kernels and reads its aux
off the distances and the weight vector. `selection_weights_masked` is
the dynamic quorum's selection (`faults/quorum.py`), on device counts.
"""

import math

import torch

from byzantinemomentum_tpu_torch.ops import diag, register
from byzantinemomentum_tpu_torch.ops._common import (
    pairwise_distances, row_sum_stable, selection_influence,
    weighted_rows_mean)

__all__ = ["aggregate", "diagnose", "scores", "scores_from_dist",
           "selection", "selection_weights", "selection_weights_masked"]


def scores_from_dist(dist, f):
    """Multi-Krum scores from the (n, n) distance matrix (+inf diagonal):
    per row, the sum of the n-f-1 smallest distances (the diagonal sorts
    last)."""
    n = dist.shape[0]
    return torch.sort(dist, dim=1).values[:, :n - f - 1].sum(dim=1)


def scores(gradients, f, *, method="dot"):
    """Multi-Krum scores, `f32[n, d] -> f32[n]`."""
    return scores_from_dist(pairwise_distances(gradients, method=method), f)


def selection_weights(dist, f, m=None):
    """Averaging weights `f32[n]` from the (n, n) distance matrix: 1/m on
    the m lowest-score rows (stable-tie order), 0 elsewhere."""
    n = dist.shape[0]
    if m is None:
        m = n - f - 2
    order = torch.argsort(scores_from_dist(dist, f), stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=dist.device))
    return torch.where(ranks < m, 1.0 / m, 0.0)


def selection_weights_masked(dist, active, n_eff, f_eff, m=None):
    """Multi-Krum over the active rows only, with the counts `n_eff`,
    `f_eff` 0-d int tensors: inactive rows get +inf distances and scores,
    so they are never selected; each active row's score sums its
    `n_eff - f_eff - 1` smallest active-neighbour distances, and the
    `m` (default `n_eff - f_eff - 2`) lowest scores get weight 1/m.
    Equals `selection_weights(dist[active][:, active], f_eff, m)` put
    back on the full row set; f32[n]."""
    n = dist.shape[0]
    positions = torch.arange(n, device=dist.device)
    pair = active[:, None] & active[None, :]
    dist = torch.where(pair, dist, torch.inf)
    # Beyond the quorum (n_eff too small for Krum) keep at least one
    # neighbour and one selected row
    keep = torch.clamp(n_eff - f_eff - 1, 1, n)
    srt = torch.sort(dist, dim=1).values
    scores = row_sum_stable(torch.where(positions[None, :] < keep, srt,
                                        srt.new_zeros(())))
    scores = torch.where(active, scores, torch.inf)
    m_max = n_eff - f_eff - 2
    m = torch.clamp(m_max if m is None else torch.clamp(m_max, max=m), 1, n)
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(order).scatter_(0, order, positions)
    one = torch.ones((), dtype=torch.float32, device=dist.device)
    return torch.where((ranks < m) & active, one / m.to(torch.float32), 0.0)


def selection(gradients, f, m=None, *, method="dot", **kwargs):
    """Indices of the m selected (lowest-score) gradients, in stable-sort
    order."""
    if m is None:
        m = gradients.shape[0] - f - 2
    return torch.argsort(scores(gradients, f, method=method), stable=True)[:m]


def aggregate(gradients, f, m=None, *, method="dot", **kwargs):
    """Multi-Krum: the mean of the m selected rows, as a weight-vector
    product with `_common.weighted_rows_mean`'s non-finite contract."""
    w = selection_weights(pairwise_distances(gradients, method=method), f, m)
    return weighted_rows_mean(w.to(gradients.dtype), gradients)


def diagnose(gradients, f, m=None, *, method="dot", **kwargs):
    """The aggregate and its aux: the Krum scores, the selection mass
    `w * m` (1 on each selected row) and the distances."""
    n = gradients.shape[0]
    if m is None:
        m = n - f - 2
    dist = pairwise_distances(gradients, method=method)
    w = selection_weights(dist, f, m)
    agg = weighted_rows_mean(w.to(gradients.dtype), gradients)
    return agg, diag.make_aux(n, scores=scores_from_dist(dist, f),
                              selection=w * m, dist=dist)


def check(gradients, f, m=None, **kwargs):
    n = gradients.shape[0]
    if n < 1:
        return f"Expected at least one gradient to aggregate, got {n}"
    if not isinstance(f, int) or f < 1 or n < 2 * f + 3:
        return f"Invalid number of Byzantine gradients to tolerate, got f = {f!r}, expected 1 <= f <= {(n - 3) // 2}"
    if m is not None and (not isinstance(m, int) or m < 1 or m > n - f - 2):
        return f"Invalid number of selected gradients, got m = {m!r}, expected 1 <= m <= {n - f - 2}"


def upper_bound(n, f, d):
    """Variance-norm ratio bound (reference `aggregators/krum.py:115-124`)."""
    return 1 / math.sqrt(2 * (n - f + f * (n + f * (n - f - 2) - 2) / (n - 2 * f - 2)))


# Fraction of selected gradients that are Byzantine (reference
# `aggregators/krum.py:126-150`)
influence = selection_influence(selection)


register("krum", aggregate, check, upper_bound=upper_bound,
         influence=influence, diagnose=diagnose)
