"""The GAR diagnostics' shared helpers (`byzantinemomentum_tpu/ops/diag.py`).

`GAR.diagnosed(G, **kwargs)` (`ops/__init__.py`) returns `(aggregate,
aux)`, where `aux` has ONE schema across all rules, so a `--gars`
mixture picks any member's aux key by key (`engine/program.py::select`)
and the engine's forensic metrics need no per-rule case:

  scores     f32[n]    per-worker score in the rule's own metric (lower
                       is more central);
  selection  f32[n]    each worker's share of the aggregate, 1.0 for a
                       fully selected worker (the kept-rank fraction for
                       the coordinate-wise rules: all ones);
  dist       f32[n, n] the pairwise distances (+inf diagonal, non-finite
                       -> +inf), computed by every rule's diagnose form;
  trim_frac  f32[n]    the coordinate-wise rules' fraction of each
                       worker's coordinates trimmed; zeros elsewhere.

Everything stays on the device, and nothing here reads a value on the
host. Only the diagnostics path calls this module: a GAR's plain call
(`GAR.checked`, `GAR.unchecked`) never does.

The rank trim of `rank_kept_mask` sorts the columns NaN last through
`sort_kernels.colsort` (the colsort kernel on a CUDA operand it supports,
its plain version elsewhere), the order of `jnp.sort`. A mean of 0/1
counts is `sum * f32(1 / count)` (`mean_f32`), as XLA computes
`jnp.mean`, so the fractions are those of the JAX functions bit for bit.

`masked_generic_aux` and `worker_mean_distance` of the JAX module serve
the aggregation service and the masked forms, which the port does not
have yet.
"""

import math

import numpy as np
import torch

from byzantinemomentum_tpu_torch.ops import sort_kernels

__all__ = ["AUX_KEYS", "make_aux", "distance_summary", "var_norm_ratio",
           "selection_from_indices", "rank_kept_fraction", "rank_kept_mask",
           "mean_f32"]

# The uniform aux schema (dict keys, all always present)
AUX_KEYS = ("scores", "selection", "dist", "trim_frac")


def make_aux(n, *, scores=None, selection=None, dist=None, trim_frac=None):
    """The uniform aux dict in f32, zeros for what a rule has no notion of.
    The zeros go on the device of the values given (every rule gives
    `dist`)."""
    given = {"scores": scores, "selection": selection, "dist": dist,
             "trim_frac": trim_frac}
    device = next(value.device for value in given.values()
                  if value is not None)
    shapes = {"scores": (n,), "selection": (n,), "dist": (n, n),
              "trim_frac": (n,)}
    return {key: (torch.zeros(shapes[key], dtype=torch.float32, device=device)
                  if value is None else value.to(torch.float32))
            for key, value in given.items()}


def mean_f32(x, dim=-1):
    """The f32 mean of `x` along `dim` as XLA computes `jnp.mean`: the sum
    times the f32 reciprocal of the count."""
    count = x.shape[dim]
    return x.sum(dim=dim) * float(np.float32(1.0) / np.float32(count))


def selection_from_indices(n, indices):
    """`i64[m] -> f32[n]`: the 0/1 selection mask of the selected indices
    (the index-returning rules: aksel, cge)."""
    mask = torch.zeros((n,), dtype=torch.float32, device=indices.device)
    return mask.index_fill(0, indices, 1.0)


def distance_summary(dist, rows=None):
    """(min, lower median, max) over the finite off-diagonal distances of
    `dist[:rows]`, the honest-vs-all summary when `rows` is the honest
    count. +inf entries (the diagonal, non-finite rows) sort last; max
    falls back to +inf on a slice with no finite entry. The values hold
    no NaN, so `torch.sort` sorts them."""
    n = dist.shape[0]
    sub = dist if rows is None else dist[:rows]
    offdiag = ~torch.eye(n, dtype=torch.bool, device=dist.device)[:sub.shape[0]]
    vals = torch.where(offdiag, sub, torch.inf).reshape(-1)
    srt = torch.sort(vals).values
    count = sub.shape[0] * (n - 1)  # the off-diagonal entries
    finite = torch.isfinite(srt)
    dmax = torch.max(torch.where(finite, srt, -torch.inf))
    dmax = torch.where(finite.any(), dmax, torch.inf)
    return srt[0], srt[(count - 1) // 2], dmax


def var_norm_ratio(G):
    """The paper's (deviation / norm)^2 of a submission stack `[m, d]`:
    the sample variance of the rows' deviations over the squared norm of
    their average, in G's dtype (the study pipeline's `avg_dev_max`
    steps), returned in f32. NaN for m < 2."""
    m = G.shape[0]
    if m < 2:
        return torch.full((), math.nan, dtype=torch.float32, device=G.device)
    avg = G.mean(dim=0)
    norm2 = torch.sum(avg * avg)
    dev = G - avg
    dev2 = torch.sum(dev * dev) / (m - 1)
    return (dev2 / norm2).to(torch.float32)


def rank_kept_mask(g, f, n_low=None, n_high=None):
    """`bool[n, d]`: whether each value lies within its column's sorted
    ranks `[n_low, n_high)` (defaults: trmean's `[f, n - f)`), decided by
    the value thresholds `sorted[n_low]` and `sorted[n_high - 1]`, so
    every value tied at a boundary counts as kept. A NaN is never kept,
    and a column whose threshold is NaN keeps nothing (a comparison with
    NaN is false). The columns sort through the colsort kernel."""
    n = g.shape[0]
    if n_low is None:
        n_low = f
    if n_high is None:
        n_high = n - f
    srt = (sort_kernels.colsort(g) if sort_kernels.supported(g)
           else sort_kernels.colsort_plain(g))
    return (g >= srt[n_low]) & (g <= srt[n_high - 1])


def rank_kept_fraction(g, f, n_low=None, n_high=None):
    """Each worker's fraction of coordinates that survive the rank trim
    (`rank_kept_mask` averaged over the coordinates, `mean_f32`)."""
    kept = rank_kept_mask(g, f, n_low=n_low, n_high=n_high)
    return mean_f32(kept.to(torch.float32), dim=1)
