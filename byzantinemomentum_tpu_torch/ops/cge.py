"""Comparative Gradient Elimination (CGE) GAR
(`byzantinemomentum_tpu/ops/cge.py`; Liu, Gupta, Vaidya 2021).

Sort the workers by gradient norm (non-finite norms as +inf) and average
the n-f smallest-norm gradients, gathered in norm order. It has no
kernel of its own: the norms and the mean are stock torch reductions, as
they are XLA work in the JAX package. `diagnose` adds the distances
(the `sq_gram` kernel on the card) to the norms and the selection.
`aggregate_masked` is the dynamic quorum's CGE (`faults/quorum.py`).
"""

import torch

from byzantinemomentum_tpu_torch.ops import diag, register
from byzantinemomentum_tpu_torch.ops._common import (
    masked_rank_mean, pairwise_distances, row_sum_stable, sanitize_inf,
    selection_influence)

__all__ = ["aggregate", "aggregate_masked", "diagnose", "norms", "selection"]


def norms(gradients):
    """Per-worker L2 norms, non-finite mapped to +inf."""
    return sanitize_inf(torch.sqrt(torch.sum(gradients * gradients, dim=1)))


def _select(nrm, f):
    return torch.argsort(nrm, stable=True)[:nrm.shape[0] - f]


def selection(gradients, f, **kwargs):
    """Indices of the n-f smallest-norm gradients, in stable-sort order."""
    return _select(norms(gradients), f)


def aggregate(gradients, f, **kwargs):
    """CGE rule: the mean of the selected rows, gathered in norm order."""
    return gradients[selection(gradients, f)].mean(dim=0)


def aggregate_masked(gradients, active, n_eff, f_eff, **kwargs):
    """CGE over the active rows: inactive rows take +inf norms, and the
    `n_eff - f_eff` smallest-norm active rows average in index order
    (`_common.masked_rank_mean`)."""
    n = gradients.shape[0]
    nrm = sanitize_inf(torch.sqrt(row_sum_stable(gradients * gradients)))
    return masked_rank_mean(gradients, nrm, active,
                            torch.clamp(n_eff - f_eff, 1, n))


def diagnose(gradients, f, **kwargs):
    """The aggregate and its aux: the norms as scores, the selected rows'
    0/1 mask and the distances."""
    n = gradients.shape[0]
    nrm = norms(gradients)
    sel = _select(nrm, f)
    return gradients[sel].mean(dim=0), diag.make_aux(
        n, scores=nrm, selection=diag.selection_from_indices(n, sel),
        dist=pairwise_distances(gradients))


def check(gradients, f=None, m=None, **kwargs):
    if gradients.shape[0] < 1:
        return f"Expected at least one gradient to aggregate, got {gradients.shape[0]}"


# Fraction of selected gradients that are Byzantine (reference
# `aggregators/cge.py:72-93`)
influence = selection_influence(selection)


register("cge", aggregate, check, influence=influence, diagnose=diagnose)
