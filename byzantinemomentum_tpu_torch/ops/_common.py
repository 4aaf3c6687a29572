"""Shared primitives of the GARs (`byzantinemomentum_tpu/ops/_common.py`).

Semantics are those of the JAX package:

* Sorting places NaN last; "median" is the lower median
  `sorted[(n - 1) // 2]`. `torch.median`/`torch.quantile` propagate NaN
  instead, so they are never used here.
* Pairwise distances treat any non-finite value as +inf, with a +inf
  diagonal.
* Selection ties resolve by stable sort order.

Dispatch is the JAX package's (`byzantinemomentum_tpu/ops/_common.py`):
the Gram behind `pairwise_distances` and `weighted_rows_mean` take the
CUDA kernels of `gar_kernels` for a CUDA operand in
`gar_kernels.supported` (f32), `lower_median` and `closest_mean` those of
`sort_kernels` for one in `sort_kernels.supported` (f32, bf16, f16);
every other operand takes the plain version. So a half-precision Bulyan
or Krum stack takes the plain Gram and row averages, and its median and
closest mean the half sorting kernels, as in the JAX package.
"""

import torch

from byzantinemomentum_tpu_torch.ops import gar_kernels, sort_kernels

__all__ = ["sanitize_inf", "distances_from_sq_gram", "pairwise_distances",
           "all_finite_from_dist", "weighted_rows_mean",
           "selection_influence", "lower_median", "closest_mean",
           "averaged_median"]


def sanitize_inf(x):
    """Replace non-finite entries by +inf (Byzantine-distance convention)."""
    return torch.where(torch.isfinite(x), x, torch.inf)


def distances_from_sq_gram(gram, *, squared=False):
    """Row norms read off the Gram diagonal,
    ||x-y||^2 = ||x||^2 + ||y||^2 - 2 x.y clamped at 0, non-finite -> +inf
    and a +inf diagonal."""
    n = gram.shape[0]
    sq = torch.diagonal(gram)
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    d2 = sanitize_inf(torch.clamp(d2, min=0.0))
    eye = torch.eye(n, dtype=torch.bool, device=gram.device)
    d2 = torch.where(eye, torch.inf, d2)
    if squared:
        return d2
    return sanitize_inf(torch.sqrt(d2))


def pairwise_distances(g, *, squared=False, method="dot"):
    """All-pairs Euclidean distances over the rows of `g: [n, d]`, in
    `g`'s dtype, non-finite -> +inf, +inf on the diagonal.

    `method` is the JAX package's: "dot" reads the distances off the Gram
    matrix (the `sq_gram` kernel on the card); "diff" reduces the
    differences directly, one row of the (n, n) matrix at a time, so the
    (n, n, d) differences are never built."""
    if method == "dot":
        gram = (gar_kernels.sq_gram(g) if gar_kernels.supported(g)
                else gar_kernels.sq_gram_plain(g))
        return distances_from_sq_gram(gram, squared=squared)
    if method != "diff":
        raise ValueError(f"Unknown pairwise distance method {method!r}")
    n = g.shape[0]
    d2 = torch.stack([torch.sum((g - g[i]) ** 2, dim=1) for i in range(n)])
    d2 = sanitize_inf(d2)
    eye = torch.eye(n, dtype=torch.bool, device=g.device)
    d2 = torch.where(eye, torch.inf, d2)
    if squared:
        return d2
    return sanitize_inf(torch.sqrt(d2))


def all_finite_from_dist(dist):
    """Whether every row behind a `pairwise_distances` matrix is finite,
    read off its off-diagonal (conservative: an overflowing finite row may
    report False)."""
    n = dist.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    return torch.isfinite(torch.where(eye, 0.0, dist)).all()


def weighted_rows_mean(w, gradients):
    """`w @ gradients` (`w: f32[n] | f32[r, n]`) with the row-selection
    non-finite semantics: unselected non-finite rows are excluded, a
    non-finite entry in a selected row gives NaN at exactly its
    coordinate. When every value is finite this is the plain product."""
    if gar_kernels.supported(gradients):
        return gar_kernels.weighted_rows_mean(w, gradients)
    return gar_kernels.select_rows(w, gradients)


def selection_influence(selection_fn):
    """The 'fraction of selected gradients that are Byzantine' influence
    of a selection-based GAR: on the stacked matrix, a selected index at
    or past `len(honests)` is a Byzantine row.
    `selection_fn(gradients, f, **kwargs) -> i64[m]`."""
    def influence(honests, byzantines, f, **kwargs):
        gradients = torch.cat([honests, byzantines])
        sel = selection_fn(gradients, f, **kwargs)
        return torch.mean((sel >= honests.shape[0]).float())
    return influence


def lower_median(g):
    """Coordinate-wise lower median over axis 0, NaN last."""
    if sort_kernels.supported(g):
        return sort_kernels.lower_median(g)
    return sort_kernels.lower_median_plain(g)


def closest_mean(g, c, m):
    """Coordinate-wise mean of the `m` values closest to center `c`
    (`sort_kernels.closest_mean_plain`'s rule)."""
    if sort_kernels.supported(g) and c.dim() == 1 and c.dtype == g.dtype:
        return sort_kernels.closest_mean(g, c, m)
    return sort_kernels.closest_mean_plain(g, c, m)


def averaged_median(g, m):
    """Bulyan's stage 2: the mean of the `m` values closest to the
    coordinate-wise lower median; for m == 1 that is the median itself."""
    med = lower_median(g)
    if m == 1:
        return med
    return closest_mean(g, med, m)
