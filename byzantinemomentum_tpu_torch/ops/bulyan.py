"""Bulyan over Multi-Krum (`byzantinemomentum_tpu/ops/bulyan.py`).

Two stages:
1. Iteratively select n-2f-2 Multi-Krum averages: at each round, average
   the gradients with the m lowest scores (m shrinking as min(m, n-f-2-i)),
   then prune the current minimum-score gradient.
2. Coordinate-wise "averaged median" over the selected stack with
   m2 = |selected| - 2f.

Pruning keeps the reference's effective behaviour, as the JAX package
does: prune = set the minimum score to +inf and update no other score
(the reference's post-prune score update is unreachable dead code).

Bulyan scores are the sum of the m smallest neighbour distances
(m = n-f-2 by default).

`diagnose` runs the aggregate's own kernels (the Gram, then the fused
stage 1 and 2) and reads its aux off the (n, n) distances and the
stage-1 weights it already has.

`aggregate_masked` is the dynamic quorum's Bulyan (`faults/quorum.py`):
the counts are 0-d int device tensors, stage 1 a Python loop of a fixed
n - 2 rounds whose rounds past `n_eff - 2 f_eff - 2` are inert (the JAX
`lax.scan`), the stack the `weighted_rows_mean` kernel's over the active
rows, and stage 2 the masked median and closest mean, whose column sorts
are the colsort kernel's (`_common.sort_columns`).
"""

import math

import torch

from byzantinemomentum_tpu_torch.ops import diag, gar_kernels, register
from byzantinemomentum_tpu_torch.ops._common import (
    averaged_median, masked_closest_mean, masked_lower_median,
    pairwise_distances, row_sum_stable, weighted_rows_mean)

__all__ = ["aggregate", "aggregate_masked", "diagnose", "selection_weights",
           "selection_weights_masked"]


def selection_weights(dist, f, m=None):
    """Stage-1 averaging weights `f32[rounds, n]` from the `(n, n)`
    distance matrix (+inf diagonal). The sequential selection runs on the
    (n,) score vector only; ties order by stable argsort."""
    n = dist.shape[0]
    m_max = n - f - 2
    if m is None:
        m = m_max
    scores = torch.sort(dist, dim=1).values[:, :m].sum(dim=1)
    one = torch.ones((), dtype=torch.float32, device=dist.device)
    positions = torch.arange(n, device=dist.device)
    rows = []
    for i in range(n - 2 * f - 2):
        m_i = min(m, m_max - i)
        order = torch.argsort(scores, stable=True)
        ranks = torch.empty_like(order).scatter_(0, order, positions)
        rows.append(torch.where(ranks < m_i, one / m_i, 0.0))
        scores = scores.index_fill(0, order[:1], torch.inf)
    return torch.stack(rows)


def selection_weights_masked(dist, active, n_eff, f_eff, m=None):
    """Stage-1 weights over the active rows only, with the counts
    `n_eff`, `f_eff` 0-d int tensors: `(W f32[n - 2, n], round_active
    bool[n - 2])`. The loop runs n - 2 rounds, the most any active subset
    needs; a round past `n_eff - 2 f_eff - 2` is inert (a zero weight
    row, the scores carried unchanged). Inactive rows get +inf distances
    and scores and are left out of every round's average."""
    n = dist.shape[0]
    device = dist.device
    positions = torch.arange(n, device=device)
    pair = active[:, None] & active[None, :]
    dist = torch.where(pair, dist, torch.inf)
    m_max = torch.clamp(n_eff - f_eff - 2, 1, n)
    m_sel = m_max if m is None else torch.clamp(
        torch.clamp(m_max, max=m), 1, n)
    srt = torch.sort(dist, dim=1).values
    scores = row_sum_stable(torch.where(positions[None, :] < m_sel, srt,
                                        srt.new_zeros(())))
    scores = torch.where(active, scores, torch.inf)
    rounds_max = max(n - 2, 1)
    rounds_eff = torch.clamp(n_eff - 2 * f_eff - 2, 1, rounds_max)
    i = torch.arange(rounds_max, dtype=torch.int32, device=device)
    m_is = torch.clamp(torch.minimum(m_sel, m_max - i), 1, n)
    round_active = i < rounds_eff
    one = torch.ones((), dtype=torch.float32, device=device)
    rows = []
    for r in range(rounds_max):
        m_i, act_i = m_is[r], round_active[r]
        order = torch.argsort(scores, stable=True)
        ranks = torch.empty_like(order).scatter_(0, order, positions)
        rows.append(torch.where((ranks < m_i) & active & act_i,
                                one / m_i.to(torch.float32), 0.0))
        scores = torch.where(act_i, scores.index_fill(0, order[:1], torch.inf),
                             scores)
    return torch.stack(rows), round_active


def aggregate_masked(gradients, active, n_eff, f_eff, m=None, *,
                     method="dot", **kwargs):
    """Bulyan over the active rows: the masked stage-1 selection, its
    stack `weighted_rows_mean` (every inactive row has weight 0, and an
    unselected row's non-finite entries are left out), then the averaged
    median over the real rounds only (`masked_lower_median`,
    `masked_closest_mean` with the device round count; m2 = 1 takes the
    median, as the static rule). Equals `aggregate(gradients[active], f_eff)` for finite
    active rows, up to the order of the sums."""
    dist = pairwise_distances(gradients, method=method)
    W, round_active = selection_weights_masked(dist, active, n_eff, f_eff, m)
    stack = weighted_rows_mean(W.to(gradients.dtype), gradients)
    rounds_eff = round_active.sum(dtype=torch.int32)
    med = masked_lower_median(stack, round_active, rounds_eff)
    m2 = torch.clamp(rounds_eff - 2 * f_eff, 1, stack.shape[0])
    closest = masked_closest_mean(stack, round_active, med, m2)
    return torch.where(m2 == 1, med, closest)


def _bulyan(gradients, f, m, method):
    """`(aggregate, dist, W)`: the distances, the stage-1 weights and the
    aggregate they give."""
    dist = pairwise_distances(gradients, method=method)
    # The weights take the stack's dtype, as in the JAX package, so a
    # half-precision stack is averaged and sorted in its own dtype
    W = selection_weights(dist, f, m).to(gradients.dtype)
    m2 = W.shape[0] - 2 * f
    if gar_kernels.supported(gradients):
        return gar_kernels.selected_median_mean(W, gradients, m2), dist, W
    return averaged_median(weighted_rows_mean(W, gradients), m2), dist, W


def aggregate(gradients, f, m=None, *, method="dot", **kwargs):
    """Bulyan over Multi-Krum. A CUDA operand in `gar_kernels.supported`
    goes through the fused `selected_median_mean` kernel (one more read of
    the matrix after the Gram's); any other operand takes the plain
    `weighted_rows_mean` + `averaged_median`."""
    return _bulyan(gradients, f, m, method)[0]


def diagnose(gradients, f, m=None, *, method="dot", **kwargs):
    """The aggregate and its aux: the Bulyan scores before any pruning
    (each row's m smallest distances summed) and each worker's share of
    the n - 2f - 2 rounds' averages (1.0 = in every round)."""
    n = gradients.shape[0]
    agg, dist, W = _bulyan(gradients, f, m, method)
    m_scores = n - f - 2 if m is None else m
    scores = torch.sort(dist, dim=1).values[:, :m_scores].sum(dim=1)
    # A divisor on the device: torch on CUDA turns a division by a Python
    # number into a product with its reciprocal
    rounds = torch.full((), W.shape[0], dtype=torch.float32, device=W.device)
    mass = (W > 0).to(torch.float32).sum(dim=0) / rounds
    return agg, diag.make_aux(n, scores=scores, selection=mass, dist=dist)


def check(gradients, f, m=None, **kwargs):
    n = gradients.shape[0]
    if n < 1:
        return f"Expected at least one gradient to aggregate, got {n}"
    if not isinstance(f, int) or f < 1 or n < 4 * f + 3:
        return f"Invalid number of Byzantine gradients to tolerate, got f = {f!r}, expected 1 <= f <= {(n - 3) // 4}"
    if m is not None and (not isinstance(m, int) or m < 1 or m > n - f - 2):
        return f"Invalid number of selected gradients, got m = {m!r}, expected 1 <= m <= {n - f - 2}"


def upper_bound(n, f, d):
    """Variance-norm ratio bound (reference `aggregators/bulyan.py:119-128`)."""
    return 1 / math.sqrt(2 * (n - f + f * (n + f * (n - f - 2) - 2) / (n - 2 * f - 2)))


register("bulyan", aggregate, check, upper_bound=upper_bound,
         diagnose=diagnose)
