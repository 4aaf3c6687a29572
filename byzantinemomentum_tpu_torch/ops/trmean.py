"""Trimmed mean, Phocas and MeaMed GARs
(`byzantinemomentum_tpu/ops/trmean.py`).

All three are coordinate-wise rules over the stacked `(n, d)` matrix:
* trmean — sort each coordinate, average ranks [f, n-f) (the
  `trimmed_mean` kernel on the card);
* phocas — trmean center, then the mean of the n-f coordinate-wise
  closest values (`closest_mean` kernel);
* meamed — median center (`lower_median` kernel), then the mean of the
  n-f closest.
The kernels take f32, bf16 and f16 stacks (`sort_kernels.supported`).

The diagnose forms run the aggregate's kernels, then the rank trim of
`diag.rank_kept_fraction` (the colsort kernel): over the values for
trmean, over the deviations `|g - center|` for phocas and meamed.

`masked_phocas` and `masked_meamed` are the dynamic quorum's forms
(`faults/quorum.py`): the masked center, then the masked closest mean
keeping `n_eff - f_eff` values a coordinate, their sorts the colsort
kernel's.
"""

import torch

from byzantinemomentum_tpu_torch.ops import diag, register, sort_kernels
from byzantinemomentum_tpu_torch.ops._common import (
    closest_mean, lower_median, masked_closest_mean, masked_lower_median,
    masked_trmean, pairwise_distances, sanitize_inf)

__all__ = ["trmean", "aggregate_trmean", "aggregate_phocas",
           "aggregate_meamed", "diagnose_trmean", "diagnose_phocas",
           "diagnose_meamed", "masked_phocas", "masked_meamed"]


def trmean(g, f):
    """Coordinate-wise mean of sorted ranks [f, n-f). NaN sorts last, so
    up to f NaN rows are trimmed away."""
    if sort_kernels.supported(g):
        return sort_kernels.trimmed_mean(g, f)
    return sort_kernels.trimmed_mean_plain(g, f)


def aggregate_trmean(gradients, f, **kwargs):
    return trmean(gradients, f)


def aggregate_phocas(gradients, f, **kwargs):
    g = gradients
    return closest_mean(g, trmean(g, f), g.shape[0] - f)


def aggregate_meamed(gradients, f, **kwargs):
    g = gradients
    return closest_mean(g, lower_median(g), g.shape[0] - f)


def masked_phocas(gradients, active, n_eff, f_eff, **kwargs):
    """Phocas over the active rows: the masked trimmed-mean center, then
    the `n_eff - f_eff` active values closest to it."""
    center = masked_trmean(gradients, active, f_eff, n_eff)
    m = torch.clamp(n_eff - f_eff, 1, gradients.shape[0])
    return masked_closest_mean(gradients, active, center, m)


def masked_meamed(gradients, active, n_eff, f_eff, **kwargs):
    """MeaMed over the active rows: the masked median center, then the
    `n_eff - f_eff` active values closest to it."""
    center = masked_lower_median(gradients, active, n_eff)
    m = torch.clamp(n_eff - f_eff, 1, gradients.shape[0])
    return masked_closest_mean(gradients, active, center, m)


def _coordinate_aux(g, agg, trim_frac):
    """The coordinate-wise rules' aux: each worker's L2 deviation from the
    aggregate as its score, a selection of all ones, the distances and
    the rule's trim fraction."""
    n = g.shape[0]
    dev = g - agg[None, :]
    scores = sanitize_inf(torch.sqrt(torch.sum(dev * dev, dim=1)))
    return diag.make_aux(
        n, scores=scores, dist=pairwise_distances(g), trim_frac=trim_frac,
        selection=torch.ones((n,), dtype=torch.float32, device=g.device))


def diagnose_trmean(gradients, f, **kwargs):
    """The trimmed mean and its aux; `trim_frac[i]` is the fraction of
    worker i's coordinates outside the kept ranks [f, n - f)."""
    agg = trmean(gradients, f)
    kept = diag.rank_kept_fraction(gradients, f)
    return agg, _coordinate_aux(gradients, agg, 1.0 - kept)


def _diagnose_closest(g, f, center):
    """The closest mean around `center` and its aux: the trim of the n - f
    values nearest the center, by deviation threshold."""
    n = g.shape[0]
    agg = closest_mean(g, center, n - f)
    dev = torch.abs(g - center[None, :])
    kept = diag.rank_kept_fraction(dev, f, n_low=0, n_high=n - f)
    return agg, _coordinate_aux(g, agg, 1.0 - kept)


def diagnose_phocas(gradients, f, **kwargs):
    return _diagnose_closest(gradients, f, trmean(gradients, f))


def diagnose_meamed(gradients, f, **kwargs):
    return _diagnose_closest(gradients, f, lower_median(gradients))


def check(gradients, f, **kwargs):
    n = gradients.shape[0]
    if n < 1:
        return f"Expected at least one gradient to aggregate, got {n}"
    if not isinstance(f, int) or f < 1 or n < 2 * f + 1:
        return f"Invalid number of Byzantine gradients to tolerate, got f = {f!r}, expected 1 <= f <= {(n - 1) // 2}"


register("trmean", aggregate_trmean, check, diagnose=diagnose_trmean)
register("phocas", aggregate_phocas, check, diagnose=diagnose_phocas)
register("meamed", aggregate_meamed, check, diagnose=diagnose_meamed)
