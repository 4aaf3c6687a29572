"""Fault injection (`byzantinemomentum_tpu/faults/inject.py`): the last
step of the honest phase, between the momentum placement and the defense.

Everything is shape-static `torch.where` masking over the stacked
`(h, d)` honest submissions, on the step's fault rows
(`faults/schedule.py::StepFaults`, device tensors), with one row-indexed
`index_select` for duplications: nothing is read on the host.

Application order per worker, the JAX package's (how the faults compose
physically):

  1. duplication: the worker ships a copy of another worker's fresh
     gradient;
  2. staleness: a straggler submits its buffered pre-window gradient,
     overriding this step's fresh or duplicated row; the buffer is
     refreshed from the clean rows only;
  3. corruption: scale, then zero, then NaN mangle what was submitted;
  4. absence: dropped and lost rows are reported in the active mask over
     all n rows (their content no longer matters).
"""

import typing

import torch

__all__ = ["FaultContext", "inject"]


class FaultContext(typing.NamedTuple):
    """A step's injected-fault context, from the honest phase to the
    defense."""

    active: torch.Tensor    # bool[n]: rows present this step
    injected: torch.Tensor  # i32[]: fault conditions live this step


def inject(rows, has_stale, G_honest, fault_buffer):
    """Apply a step's faults to the honest submissions.

    Args:
      rows: the step's `StepFaults` on G_honest's device.
      has_stale: whether the plan has stragglers (the schedule's
        `has_stale`; without them the buffer is `(0, d)` and passes
        through).
      G_honest: `[h, d]` honest rows about to feed the defense.
      fault_buffer: `[h, d]` each worker's last fresh submission (or
        `(0, d)`).

    Returns `(G_faulted, new_buffer, FaultContext)`.
    """
    h = G_honest.shape[0]
    dup_on = rows.dup >= 0
    src = torch.clamp(rows.dup, 0, h - 1)
    G = torch.where(dup_on[:, None], G_honest.index_select(0, src), G_honest)
    if has_stale:
        stale = rows.stale[:, None]
        G = torch.where(stale, fault_buffer, G)
        new_buffer = torch.where(stale, fault_buffer, G_honest)
    else:
        new_buffer = fault_buffer
    G = G * rows.scale[:, None].to(G.dtype)
    G = torch.where(rows.zero[:, None], G.new_zeros(()), G)
    G = torch.where(rows.nan[:, None], G.new_full((), torch.nan), G)
    return G, new_buffer, FaultContext(active=~rows.drop,
                                       injected=rows.injected)
