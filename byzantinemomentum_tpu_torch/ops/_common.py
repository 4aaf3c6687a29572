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

The masked forms (`masked_*`, the dynamic quorum of `faults/quorum.py`)
aggregate the rows of an `active` mask with counts that are 0-d int32
device tensors (`n_eff`, `f_eff`, ...): nothing is read on the host. A
count becomes a rank predicate or a row read at a device index
(`_row_at`, `index_select`). Inactive rows ride the conventions of
non-finite values (NaN values sort last, +inf distances and scores).
Their column sorts go through `sort_columns`: the colsort kernel on a
supported card operand (the JAX package sorts with `jnp.sort`, NaN
last), its plain version elsewhere, never a bare `torch.sort` on values
that may hold NaN. The sums over rows are torch reductions, in another
order than the JAX package's einsum (`row_sum_stable`) and `jnp.sum`, so
the masked values agree with the JAX forms within the GAR tests'
tolerance and the selections exactly.
"""

import torch

from byzantinemomentum_tpu_torch.ops import gar_kernels, sort_kernels

__all__ = ["sanitize_inf", "distances_from_sq_gram", "pairwise_distances",
           "all_finite_from_dist", "weighted_rows_mean",
           "selection_influence", "lower_median", "closest_mean",
           "averaged_median", "row_sum_stable", "sort_columns",
           "masked_mean", "masked_lower_median", "masked_trmean",
           "masked_closest_mean", "masked_rank_mean"]


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


# --------------------------------------------------------------------------- #
# Masked forms (the dynamic quorum, `faults/quorum.py`)

def row_sum_stable(x):
    """Row sums over the minor axis, `[n, k] -> [n]`: where the JAX
    package sums through a sequential einsum (its serve buckets need
    appended zero columns to be exact identities), the port sums with
    `torch.sum`, which may differ from it in the last ulp."""
    return torch.sum(x, dim=1)


def sort_columns(g):
    """Every column of `g` sorted ascending, NaN last: the colsort kernel
    for a CUDA operand in `sort_kernels.supported`, its plain version
    (`sort_nan_last`) elsewhere."""
    if sort_kernels.supported(g):
        return sort_kernels.colsort(g)
    return sort_kernels.colsort_plain(g)


def _row_at(x, index):
    """`x[index]` for a 0-d integer device tensor, with no read of it."""
    return x.index_select(0, index.reshape(1))[0]


def _count(mask):
    """The number of True entries of `mask` as a 0-d int32 tensor."""
    return mask.sum(dtype=torch.int32)


def _nan_rows(g, active):
    """`g` with its inactive rows set to NaN."""
    return torch.where(active[:, None], g, g.new_full((), torch.nan))


def masked_mean(g, active, n_eff=None):
    """The mean of the active rows of `g: [n, d]` (NaN for none)."""
    if n_eff is None:
        n_eff = _count(active)
    kept = torch.where(active[:, None], g, g.new_zeros(()))
    return kept.sum(dim=0) / n_eff.to(g.dtype)


def masked_lower_median(g, active, n_eff=None):
    """The coordinate-wise lower median of the active rows: inactive rows
    go to NaN, which sorts last, and the median is read at the rank
    `(n_eff - 1) // 2`. Equals `lower_median(g[active])` for finite
    active rows."""
    if n_eff is None:
        n_eff = _count(active)
    index = torch.clamp(n_eff - 1, min=0) // 2
    return _row_at(sort_columns(_nan_rows(g, active)), index)


def masked_trmean(g, active, f, n_eff=None):
    """The coordinate-wise mean of the active rows' sorted ranks
    `[f, n_eff - f)`, with traced `f` and count (callers guarantee
    `n_eff > 2 f`)."""
    if n_eff is None:
        n_eff = _count(active)
    srt = sort_columns(_nan_rows(g, active))
    ranks = torch.arange(g.shape[0], device=g.device)[:, None]
    take = (ranks >= f) & (ranks < n_eff - f)
    kept = torch.where(take, srt, srt.new_zeros(()))
    return kept.sum(dim=0) / (n_eff - 2 * f).to(g.dtype)


def masked_closest_mean(g, active, c, m):
    """The coordinate-wise mean of the `m` active values closest to the
    center `c: [d]`, `m` a 0-d int tensor: inactive rows take NaN
    deviations (sorting last), the m-th smallest deviation is read at a
    device rank, and the ties at it fill in index order. Fewer than m
    finite active values in a column give NaN, as the static rule."""
    n = g.shape[0]
    m = torch.clamp(m, 1, n)
    dev = _nan_rows(torch.abs(g - c[None, :]), active)
    thresh = _row_at(sort_columns(dev), m - 1)
    lt = dev < thresh
    eq = dev == thresh
    need = m - _count_rows(lt)
    take = lt | (eq & (torch.cumsum(eq.to(torch.int32), dim=0) <= need))
    out = torch.where(take, g, g.new_zeros(())).sum(dim=0) / m.to(g.dtype)
    return torch.where(torch.isnan(thresh), thresh.new_full((), torch.nan),
                       out)


def _count_rows(mask):
    """Per column, the number of True entries of `mask: bool[n, d]`."""
    return mask.sum(dim=0, dtype=torch.int32)


def masked_rank_mean(g, scores, active, count):
    """The mean of the `count` lowest-score active rows (stable-argsort
    ranks, index-order ties; inactive rows score +inf and are excluded),
    summed in index order, `count` a 0-d int tensor. Aksel and CGE's
    static forms gather in score order, so their values agree with this
    up to the order of the sum."""
    n = g.shape[0]
    count = torch.clamp(count, 1, n)
    scores = torch.where(active, scores, torch.inf)
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=g.device))
    sel = (ranks < count) & active
    kept = torch.where(sel[:, None], g, g.new_zeros(()))
    return kept.sum(dim=0) / count.to(g.dtype)
