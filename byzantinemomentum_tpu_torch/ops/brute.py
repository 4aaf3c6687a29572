"""Brute-force minimum-diameter GAR (`byzantinemomentum_tpu/ops/brute.py`).

Enumerate every size-(n-f) subset, compute its diameter (the largest
pairwise distance inside it), select the subset of smallest diameter and
average it. Non-finite distances are +inf, so a subset holding a
non-finite row has an infinite diameter.

Subsets are enumerated by rank in the combinatorial number system and
unranked chunk by chunk (`_unrank_masks`, a walk over the n elements with
a host binomial table), so memory is O(CHUNK * n^2) whatever C(n, n-f)
is: at the paper's n=25, f=11 cell that is C(25, 14) = 4,457,400 subsets
in 137 chunks. Lexicographic rank order is `itertools.combinations`
order, and the winner is the first minimum in it: `torch.argmin` takes
the lowest rank inside a chunk, and a strict `<` keeps the earliest
chunk's winner across chunks. The running best stays on the device, and
the binomial table goes up in one asynchronous copy, so the enumeration
never waits for the host.

The enumeration is stock torch ops, as it is XLA work in the JAX package;
the subset mean of a `gar_kernels.supported` operand is the
`masked_rows_mean` CUDA kernel. `diagnose` runs the same enumeration and
kernels, and reads its aux off the distances and the winning mask.

`aggregate_masked` is the dynamic quorum's brute (`faults/quorum.py`):
the minimum-diameter size-(n_eff - f_eff) subset of the active rows,
the counts 0-d int device tensors. Its enumeration is sized for the
static worst case `masked_rank_space(n, f_decl)`, and refused beyond
`MASKED_MAX_SUBSETS` (the quorum layer then takes its NaN-routing
fallback through the static rule); its mean divides by the device count
with torch (no kernel).
"""

import functools
import math

import numpy as np
import torch

from byzantinemomentum_tpu_torch.data.device import to_device
from byzantinemomentum_tpu_torch.ops import diag, gar_kernels, register
from byzantinemomentum_tpu_torch.ops._common import (
    pairwise_distances, selection_influence)

__all__ = ["aggregate", "aggregate_masked", "diagnose", "selection",
           "best_subset_mask_from_dist", "best_subset_mask_masked",
           "masked_rank_space", "CHUNK", "MASKED_MAX_SUBSETS"]

# Subsets evaluated per chunk of the enumeration: O(CHUNK * n^2) memory,
# about 80 MB of f32 at n = 25 (the JAX package's chunk)
CHUNK = 32768


@functools.cache
def _binom_table(n, k):
    """(n+1, k+1) read-only int64 table of C(m, j) (host side)."""
    tbl = np.zeros((n + 1, k + 1), dtype=np.int64)
    tbl[:, 0] = 1
    for m in range(1, n + 1):
        for j in range(1, min(m, k) + 1):
            tbl[m, j] = tbl[m - 1, j - 1] + tbl[m - 1, j]
    tbl.flags.writeable = False
    return tbl


def _unrank_masks(ranks, n, k, tbl):
    """Lexicographic unranking of a chunk of ranks: `i64[c] -> bool[c, n]`
    membership masks of size-k subsets of range(n).

    Walk the elements 0..n-1; at element e with `need` slots left there
    are C(n-e-1, need-1) subsets that include e: include e iff the
    remaining rank is below that count, else skip e and subtract it.
    `tbl` is `_binom_table(n, k)` as a tensor on the ranks' device."""
    r = ranks
    need = torch.full_like(ranks, k)
    masks = []
    for e in range(n):
        count = tbl[n - e - 1][torch.clamp(need - 1, min=0)]
        count = torch.where(need > 0, count, 0)
        take = (need > 0) & (r < count)
        r = torch.where(take, r, r - count)
        need = need - take.long()
        masks.append(take)
    return torch.stack(masks, dim=1)


def best_subset_mask_from_dist(dist, f):
    """bool[n] mask of the minimum-diameter size-(n-f) subset, from the
    (n, n) distance matrix (+inf diagonal); the first minimum in
    `itertools.combinations` order."""
    n = dist.shape[0]
    k = n - f
    tbl_np = _binom_table(n, k)
    total = int(tbl_np[n, k])
    if total > np.iinfo(np.int32).max:
        raise ValueError(
            f"brute cannot enumerate C({n}, {k}) = {total} subsets (exceeds "
            f"int32 rank space; the reference's Python loop is equally "
            f"infeasible at this scale)")
    device = dist.device
    tbl = to_device(np.array(tbl_np), device)  # a writable copy
    # The diagonal is +inf by convention (for per-row sorts); the diameter
    # wants it excluded instead
    offdiag = ~torch.eye(n, dtype=torch.bool, device=device)
    chunk = min(CHUNK, total)
    lanes = torch.arange(chunk, dtype=torch.int64, device=device)
    best_diam = torch.full((), torch.inf, dtype=dist.dtype, device=device)
    best_rank = torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, total, chunk):
        # Clamping the tail padding to the last rank only duplicates it:
        # same diameter, same rank, the tie rule unaffected
        ranks = torch.clamp(start + lanes, max=total - 1)
        masks = _unrank_masks(ranks, n, k, tbl)
        pair = masks[:, :, None] & masks[:, None, :] & offdiag
        diam = torch.where(pair, dist, -torch.inf).amax(dim=(1, 2))
        # The first minimum within the chunk (taken with `index_select`:
        # indexing with a 0-d tensor would read it on the host)
        i = torch.argmin(diam).view(1)
        low = diam.index_select(0, i)[0]
        better = low < best_diam  # strict: earlier chunks win ties
        best_diam = torch.where(better, low, best_diam)
        best_rank = torch.where(better, ranks.index_select(0, i)[0], best_rank)
    return _unrank_masks(best_rank[None], n, k, tbl)[0]


# The largest static rank space a masked brute enumerates: it cannot know
# n_eff and f_eff when it sizes its chunk loop, so it provisions
# C(n, min(f_decl, (n - 1) // 2)); beyond this many subsets the masked
# form is refused (`masked_rank_space` gives None). The JAX package's cap
MASKED_MAX_SUBSETS = 2_000_000


def masked_rank_space(n, f_decl):
    """`C(n, min(f_decl, (n - 1) // 2))`, the most subsets any `(n_eff <=
    n, f_eff <= f_decl)` gives, or None beyond `MASKED_MAX_SUBSETS`."""
    k = min(int(f_decl), max((n - 1) // 2, 0))
    total = math.comb(n, k)
    return total if total <= MASKED_MAX_SUBSETS else None


def _unrank_masks_masked(ranks, active, after, need0, n, tbl):
    """Lexicographic unranking over the active rows: `i64[c] -> bool[c,
    n]` masks of the rank-th size-`need0` combination of the active
    indices (the static order restricted to them). An inactive element
    takes no rank and fills no slot; at an active one with `need` slots
    left there are `C(after[e], need - 1)` completions that include it,
    `after[e]` the active rows past e (device tensors, read with
    `index_select`)."""
    r = ranks
    need = torch.zeros_like(ranks) + need0
    masks = []
    for e in range(n):
        row = tbl.index_select(0, after[e:e + 1])[0]
        count = torch.where(need > 0, row[torch.clamp(need - 1, min=0)], 0)
        take = active[e] & (need > 0) & (r < count)
        r = torch.where(take | ~active[e], r, r - count)
        need = need - take.long()
        masks.append(take)
    return torch.stack(masks, dim=1)


def best_subset_mask_masked(dist, active, n_eff, f_eff, total_max):
    """bool[n] mask of the minimum-diameter size-(n_eff - f_eff) subset
    of the active rows: a chunk loop sized for the static `total_max`
    (`masked_rank_space`), the surplus lanes clamped to the last real
    subset, so the first minimum in lexicographic order wins, as in the
    static form. Inactive pairs get +inf distances."""
    n = dist.shape[0]
    device = dist.device
    pair = active[:, None] & active[None, :]
    dist = torch.where(pair, dist, torch.inf)
    k_eff = torch.clamp(n_eff - f_eff, 1, n)
    # C(m, j) for every m, j <= n (int64 holds them all for n <= 66)
    tbl = to_device(np.array(_binom_table(n, n)), device)
    after = (active.sum() - torch.cumsum(active.long(), dim=0))
    total_eff = torch.clamp(
        tbl.index_select(0, n_eff.reshape(1))[0]
        .index_select(0, k_eff.reshape(1))[0], min=1)
    offdiag = ~torch.eye(n, dtype=torch.bool, device=device)
    chunk = min(CHUNK, total_max)
    lanes = torch.arange(chunk, dtype=torch.int64, device=device)
    best_diam = torch.full((), torch.inf, dtype=dist.dtype, device=device)
    best_rank = torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, total_max, chunk):
        ranks = torch.minimum(start + lanes, total_eff - 1)
        masks = _unrank_masks_masked(ranks, active, after, k_eff, n, tbl)
        pairm = masks[:, :, None] & masks[:, None, :] & offdiag
        diam = torch.where(pairm, dist, -torch.inf).amax(dim=(1, 2))
        i = torch.argmin(diam).view(1)
        low = diam.index_select(0, i)[0]
        better = low < best_diam  # strict: earlier chunks win ties
        best_diam = torch.where(better, low, best_diam)
        best_rank = torch.where(better, ranks.index_select(0, i)[0], best_rank)
    return _unrank_masks_masked(best_rank[None], active, after, k_eff, n,
                                tbl)[0]


def aggregate_masked(gradients, active, n_eff, f_eff, f_decl, *,
                     method="dot", **kwargs):
    """Brute over the active rows: the mean of their minimum-diameter
    subset, divided by the device count `n_eff - f_eff`. `f_decl` sizes
    the enumeration; raises beyond `MASKED_MAX_SUBSETS`."""
    n = gradients.shape[0]
    total_max = masked_rank_space(n, f_decl)
    if total_max is None:
        raise ValueError(
            f"brute masked kernel over {n} rows at f_decl={f_decl} "
            f"exceeds MASKED_MAX_SUBSETS; callers must route around it "
            f"(masked_rank_space)")
    dist = pairwise_distances(gradients, method=method)
    mask = best_subset_mask_masked(dist, active, n_eff, f_eff, total_max)
    k_eff = torch.clamp(n_eff - f_eff, 1, n)
    kept = torch.where((mask & active)[:, None], gradients,
                       gradients.new_zeros(()))
    return kept.sum(dim=0) / k_eff.to(gradients.dtype)


def _best_subset_mask(gradients, f, *, method="dot"):
    return best_subset_mask_from_dist(
        pairwise_distances(gradients, method=method), f)


def selection(gradients, f, *, method="dot", **kwargs):
    """Indices (i64[n-f], ascending) of the minimum-diameter subset."""
    n = gradients.shape[0]
    mask = _best_subset_mask(gradients, f, method=method)
    # The members in index order, without a host round trip
    return torch.argsort((~mask).to(torch.uint8), stable=True)[:n - f]


def _subset_mean(mask, gradients, f):
    n = gradients.shape[0]
    if gar_kernels.supported(gradients):
        return gar_kernels.masked_rows_mean(mask, gradients, n - f)
    # where (not mask @ G): excluded rows may be all-NaN and 0*NaN = NaN
    return gar_kernels.masked_rows_mean_plain(mask, gradients, n - f)


def aggregate(gradients, f, *, method="dot", **kwargs):
    """Brute rule: the mean of the minimum-diameter subset."""
    return _subset_mean(_best_subset_mask(gradients, f, method=method),
                        gradients, f)


def diagnose(gradients, f, *, method="dot", **kwargs):
    """The aggregate and its aux: the subset's 0/1 membership as the
    selection, and as each worker's score its largest distance to the
    winning subset (-inf where there is none)."""
    n = gradients.shape[0]
    dist = pairwise_distances(gradients, method=method)
    mask = best_subset_mask_from_dist(dist, f)
    agg = _subset_mean(mask, gradients, f)
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    scores = torch.where(mask[None, :] & ~eye, dist, -torch.inf).amax(dim=1)
    return agg, diag.make_aux(n, scores=scores, selection=mask, dist=dist)


def check(gradients, f, **kwargs):
    n = gradients.shape[0]
    if n < 1:
        return f"Expected at least one gradient to aggregate, got {n}"
    if not isinstance(f, int) or f < 1 or n < 2 * f + 1:
        return f"Invalid number of Byzantine gradients to tolerate, got f = {f!r}, expected 1 <= f <= {(n - 1) // 2}"


def upper_bound(n, f, d):
    """Variance-norm ratio bound (reference `aggregators/brute.py:107-116`)."""
    return (n - f) / (math.sqrt(8) * f)


# Fraction of selected gradients that are Byzantine (reference
# `aggregators/brute.py:118-140`)
influence = selection_influence(selection)


register("brute", aggregate, check, upper_bound=upper_bound,
         influence=influence, diagnose=diagnose)
