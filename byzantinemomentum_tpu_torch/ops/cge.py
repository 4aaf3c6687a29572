"""Comparative Gradient Elimination (CGE) GAR
(`byzantinemomentum_tpu/ops/cge.py`; Liu, Gupta, Vaidya 2021).

Sort the workers by gradient norm (non-finite norms as +inf) and average
the n-f smallest-norm gradients, gathered in norm order. It has no
kernel of its own: the norms and the mean are stock torch reductions, as
they are XLA work in the JAX package.
"""

import torch

from byzantinemomentum_tpu_torch.ops import register
from byzantinemomentum_tpu_torch.ops._common import (
    sanitize_inf, selection_influence)

__all__ = ["aggregate", "norms", "selection"]


def norms(gradients):
    """Per-worker L2 norms, non-finite mapped to +inf."""
    return sanitize_inf(torch.sqrt(torch.sum(gradients * gradients, dim=1)))


def selection(gradients, f, **kwargs):
    """Indices of the n-f smallest-norm gradients, in stable-sort order."""
    n = gradients.shape[0]
    return torch.argsort(norms(gradients), stable=True)[:n - f]


def aggregate(gradients, f, **kwargs):
    """CGE rule: the mean of the selected rows, gathered in norm order."""
    return gradients[selection(gradients, f)].mean(dim=0)


def check(gradients, f=None, m=None, **kwargs):
    if gradients.shape[0] < 1:
        return f"Expected at least one gradient to aggregate, got {gradients.shape[0]}"


# Fraction of selected gradients that are Byzantine (reference
# `aggregators/cge.py:72-93`)
influence = selection_influence(selection)


register("cge", aggregate, check, influence=influence)
