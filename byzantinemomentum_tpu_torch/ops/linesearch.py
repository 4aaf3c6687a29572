"""Budgeted 1-D arg-maximization on the non-negative reals, the engine of
the adaptive attacks (`byzantinemomentum_tpu/ops/linesearch.py`).

The schedule is the JAX package's: an expansion phase (double the step
while the objective strictly improves), then a contraction phase (probe
shrinking steps around the incumbent), under a fixed evaluation budget,
with the negative-x guard (halve toward the previous probe while the
probe is negative). Its arithmetic on x is float32, as XLA's
`lax.while_loop` carries it: every step, product and halving rounds to
float32, with subnormals flushed to zero as XLA's CPU flushes them
(`ops/search_kernels.py`), so the probes are the JAX package's probes bit
for bit wherever the objective's values are. The objective's values are compared at their
own precision (f32, or f64 in a float64 run).

The search's state lives on the objective's device, as the JAX loop's
carry does (`ops/search_kernels.py`): each probe is the objective's work
on a 0-d f32 tensor x, then one launch of `linesearch_step` (on the card;
its plain version on the CPU) that updates the state and writes the next
probe. The budget is fixed, as the JAX loop always spends it, so the host
queues the whole search and reads nothing.
"""

import torch

from byzantinemomentum_tpu_torch.ops import search_kernels

__all__ = ["line_maximize"]


def line_maximize(scape, evals, device=None):
    """Best-effort arg-maximize `scape: R+ -> R` under an evaluation budget.

    Args:
      scape: the objective; called with an f32 0-d tensor x on `device`,
        returns a 0-d f32 or f64 tensor on the same device.
      evals: positive int, total evaluation budget.
      device: where the search runs (the objective's operands' device).
    Returns:
      The best x found, an f32 0-d tensor on `device`.
    """
    # The JAX schedule: start at 0 with a step of 1, so the first probe
    # after the start is 0 + 1
    xs = torch.arange(3, dtype=torch.float32, device=device).clamp_(max=1.0)
    # (phase 0, evals - 1 left), made on the device: assigning a Python
    # number to an element would copy it from the host and wait
    ints = torch.arange(2, dtype=torch.int32, device=device) * (evals - 1)
    best_y = scape(xs[0])
    for _ in range(evals - 1):
        xs, best_y, ints = search_kernels.linesearch_step(
            xs, best_y, ints, scape(xs[1]))
    return xs[0]
