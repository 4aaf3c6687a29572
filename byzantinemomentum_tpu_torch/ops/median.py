"""NaN-resilient coordinate-wise median GAR
(`byzantinemomentum_tpu/ops/median.py`).

The lower median with NaN-last ordering, `sorted[(n-1)//2]` per
coordinate (the `lower_median` kernel on the card). `torch.median`
propagates NaN, which would make the rule meaningless under the `nan`
attack, so it is not used.
"""

import math

from byzantinemomentum_tpu_torch.ops import register
from byzantinemomentum_tpu_torch.ops._common import lower_median

__all__ = ["aggregate"]


def aggregate(gradients, **kwargs):
    """NaN-resilient coordinate-wise lower median."""
    return lower_median(gradients)


def check(gradients, **kwargs):
    if gradients.shape[0] < 1:
        return f"Expected at least one gradient to aggregate, got {gradients.shape[0]}"


def upper_bound(n, f, d):
    """Variance-norm ratio bound (reference `aggregators/median.py:62-71`)."""
    return 1 / math.sqrt(n - f)


register("median", aggregate, check, upper_bound=upper_bound)
