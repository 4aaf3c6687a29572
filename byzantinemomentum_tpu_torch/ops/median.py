"""NaN-resilient coordinate-wise median GAR
(`byzantinemomentum_tpu/ops/median.py`).

The lower median with NaN-last ordering, `sorted[(n-1)//2]` per
coordinate (the `lower_median` kernel on the card). `torch.median`
propagates NaN, which would make the rule meaningless under the `nan`
attack, so it is not used.
"""

import math

import torch

from byzantinemomentum_tpu_torch.ops import diag, register
from byzantinemomentum_tpu_torch.ops._common import (
    lower_median, pairwise_distances, sanitize_inf)

__all__ = ["aggregate", "diagnose"]


def aggregate(gradients, **kwargs):
    """NaN-resilient coordinate-wise lower median."""
    return lower_median(gradients)


def diagnose(gradients, **kwargs):
    """The median and its aux: each worker's L2 deviation from the median
    as its score, a selection of all ones, and as `trim_frac` the
    fraction of each worker's coordinates that are not the median (`==`,
    so -0 and +0 are equal)."""
    n = gradients.shape[0]
    agg = lower_median(gradients)
    dev = gradients - agg[None, :]
    scores = sanitize_inf(torch.sqrt(torch.sum(dev * dev, dim=1)))
    was_median = (gradients == agg[None, :]).to(torch.float32)
    return agg, diag.make_aux(
        n, scores=scores, dist=pairwise_distances(gradients),
        selection=torch.ones((n,), dtype=torch.float32,
                             device=gradients.device),
        trim_frac=1.0 - diag.mean_f32(was_median, dim=1))


def check(gradients, **kwargs):
    if gradients.shape[0] < 1:
        return f"Expected at least one gradient to aggregate, got {gradients.shape[0]}"


def upper_bound(n, f, d):
    """Variance-norm ratio bound (reference `aggregators/median.py:62-71`)."""
    return 1 / math.sqrt(n - f)


register("median", aggregate, check, upper_bound=upper_bound,
         diagnose=diagnose)
