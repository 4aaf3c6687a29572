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
"""

from byzantinemomentum_tpu_torch.ops import register, sort_kernels
from byzantinemomentum_tpu_torch.ops._common import closest_mean, lower_median

__all__ = ["trmean", "aggregate_trmean", "aggregate_phocas",
           "aggregate_meamed"]


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


def check(gradients, f, **kwargs):
    n = gradients.shape[0]
    if n < 1:
        return f"Expected at least one gradient to aggregate, got {n}"
    if not isinstance(f, int) or f < 1 or n < 2 * f + 1:
        return f"Invalid number of Byzantine gradients to tolerate, got f = {f!r}, expected 1 <= f <= {(n - 1) // 2}"


register("trmean", aggregate_trmean, check)
register("phocas", aggregate_phocas, check)
register("meamed", aggregate_meamed, check)
