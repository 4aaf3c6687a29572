"""The dynamic quorum (`byzantinemomentum_tpu/faults/quorum.py`): the
degradation policy that keeps a GAR's guarantee meaningful when workers
are absent.

When the fault layer drops workers or quarantines corrupt rows, the
effective row count `n_eff = sum(active)` is device data (a 0-d int32
tensor). `effective_f` clamps the declared `f` to the rule's breakdown
ceiling at `n_eff`, and `masked_aggregate` runs the rule's masked form
(`ops/_common.py`, `ops/krum.py`, `ops/bulyan.py`, `ops/brute.py`,
`ops/aksel.py`, `ops/cge.py`, `ops/trmean.py`) over the active rows with
those counts, with nothing read on the host. On the card, masked Krum
takes its distances from the `sq_gram` kernel and its average from the
`weighted_rows_mean` kernel; masked Bulyan and Brute their distances
from `sq_gram`; the masked median, trimmed mean and closest mean sort
their columns with the `colsort` kernel.

Brute beyond its masked rank space (`ops/brute.py::masked_rank_space`,
e.g. the paper's n = 25, f = 11) and a rule without a masked form keep
the JAX package's fallback: inactive rows become NaN, which every rule
treats as worst case (sort last, +inf distances), and the static
declared `f` absorbs them while `absent + byzantine <= f`.
"""

import torch

from byzantinemomentum_tpu_torch.ops import (
    _common, aksel as aksel_mod, brute as brute_mod, bulyan as bulyan_mod,
    cge as cge_mod, krum as krum_mod, trmean as trmean_mod)

__all__ = ["effective_f", "masked_aggregate"]

# Breakdown ceilings: the largest f each rule tolerates at n rows (the
# rules' own `check` contracts: krum n >= 2f+3, bulyan n >= 4f+3, the
# trimmed family n >= 2f+1); the default is the minority bound
_F_CEILING = {
    "krum": lambda n: (n - 3) // 2,
    "bulyan": lambda n: (n - 3) // 4,
    "brute": lambda n: (n - 1) // 2,
    "trmean": lambda n: (n - 1) // 2,
    "phocas": lambda n: (n - 1) // 2,
    "meamed": lambda n: (n - 1) // 2,
}


def effective_f(gar_name, n_eff, f_decl):
    """The effective Byzantine tolerance, a 0-d int32 tensor: the declared
    `f` (an int or a 0-d tensor) clamped to the rule's ceiling at the
    device count `n_eff`, and at 0."""
    ceiling = _F_CEILING.get(gar_name, lambda n: (n - 1) // 2)(n_eff)
    f = (torch.minimum(ceiling, f_decl) if isinstance(f_decl, torch.Tensor)
         else torch.clamp(ceiling, max=f_decl))
    return torch.clamp(f, min=0).to(torch.int32)


def _as_count(f, like):
    """An int or a 0-d int tensor as a 0-d int32 tensor on `like`'s
    device (a fill, not a copy from the host)."""
    if isinstance(f, torch.Tensor):
        return f.to(torch.int32)
    return torch.full((), f, dtype=torch.int32, device=like.device)


def masked_aggregate(gar, gradients, active, *, f_decl, dynamic=True,
                     f_evicted=None, **kwargs):
    """Aggregate the active rows of `gradients` with `gar`.

    Args:
      gar: a registered `GAR`.
      gradients: `[n, d]` stacked submissions.
      active: bool[n], the rows present this step.
      f_decl: the declared Byzantine count (an int).
      dynamic: recompute the effective quorum (False keeps the declared
        `f` and only leaves the absent rows out).
      f_evicted: optional 0-d int tensor, Byzantine rows the caller has
        already excluded from `active`; they are subtracted from the
        declared tolerance before the clamp (the static `f_decl` still
        sizes brute's rank space).
      kwargs: the GAR's arguments.

    Returns `(aggregate [d], f_eff i32[])`, the latter the `Quorum f`
    column.
    """
    name = gar.name
    n_eff = active.sum(dtype=torch.int32)
    f_claim = (torch.clamp(f_decl - _as_count(f_evicted, n_eff), min=0)
               if f_evicted is not None else f_decl)
    f_eff = (effective_f(name, n_eff, f_claim) if dynamic
             else _as_count(f_claim, n_eff))

    if name == "average":
        return _common.masked_mean(gradients, active, n_eff), f_eff
    if name == "median":
        return _common.masked_lower_median(gradients, active, n_eff), f_eff
    if name == "trmean":
        return _common.masked_trmean(gradients, active, f_eff, n_eff), f_eff
    if name == "krum":
        dist = _common.pairwise_distances(
            gradients, method=kwargs.get("method", "dot"))
        w = krum_mod.selection_weights_masked(
            dist, active, n_eff, f_eff, kwargs.get("m")).to(gradients.dtype)
        # Every inactive row has weight 0, and `weighted_rows_mean` leaves
        # an unselected row's non-finite entries out: a dropped worker's
        # payload (a NaN row) cannot reach the product
        return _common.weighted_rows_mean(w, gradients), f_eff
    if name == "bulyan":
        return bulyan_mod.aggregate_masked(
            gradients, active, n_eff, f_eff, kwargs.get("m"),
            method=kwargs.get("method", "dot")), f_eff
    if name == "phocas":
        return trmean_mod.masked_phocas(gradients, active, n_eff,
                                        f_eff), f_eff
    if name == "meamed":
        return trmean_mod.masked_meamed(gradients, active, n_eff,
                                        f_eff), f_eff
    if name == "aksel":
        return aksel_mod.aggregate_masked(
            gradients, active, n_eff, f_eff,
            mode=kwargs.get("mode", "mid")), f_eff
    if name == "cge":
        return cge_mod.aggregate_masked(gradients, active, n_eff,
                                        f_eff), f_eff
    if (name == "brute" and brute_mod.masked_rank_space(
            gradients.shape[0], f_decl) is not None):
        return brute_mod.aggregate_masked(
            gradients, active, n_eff, f_eff, f_decl,
            method=kwargs.get("method", "dot")), f_eff

    # The fallback: inactive rows become NaN and the static rule runs at
    # the declared f
    routed = torch.where(active[:, None], gradients,
                         gradients.new_full((), torch.nan))
    return gar.unchecked(routed, f=f_decl, **kwargs), _as_count(f_decl, n_eff)
