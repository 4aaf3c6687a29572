"""Budgeted 1-D arg-maximization on the non-negative reals, the engine of
the adaptive attacks (`byzantinemomentum_tpu/ops/linesearch.py`).

The schedule is the JAX package's: an expansion phase (double the step
while the objective strictly improves), then a contraction phase (probe
shrinking steps around the incumbent), under a fixed evaluation budget,
with the negative-x guard (halve toward the previous probe while the
probe is negative). Its arithmetic on x is float32, as XLA's
`lax.while_loop` carries it: every step, product and halving rounds to
float32 (`numpy.float32` on the host), so the probes are the JAX
package's probes bit for bit wherever the objective's values are. The
objective's values are compared at their own precision (a Python float
holds an f32 or f64 value exactly).

The search runs on the host and reads one scalar a probe (the
objective's value, a 0-d tensor on the operand's device, through
`float()`); each probe's work stays on the objective's device.
"""

import numpy as np

__all__ = ["line_maximize"]


# The JAX package's schedule: the search starts at 0 with a step of 1,
# and a failed probe shrinks the step by 0.8
START, DELTA, RATIO = np.float32(0.0), np.float32(1.0), np.float32(0.8)


def line_maximize(scape, evals):
    """Best-effort arg-maximize `scape: R+ -> R` under an evaluation budget.

    Args:
      scape: the objective; called with a `numpy.float32` x, returns a
        value that `float()` reads (a 0-d tensor or a number).
      evals: positive int, total evaluation budget.
    Returns:
      The best x found, a `numpy.float32`.
    """
    two = np.float32(2.0)
    best_x = prop_x = START
    delta = DELTA
    best_y = float(scape(best_x))
    evals -= 1
    expanding = True
    while evals > 0:
        if expanding:
            prop_x = best_x + delta
        elif prop_x < best_x:
            prop_x = prop_x + delta
        else:
            x = prop_x - delta
            while x < 0:
                x = (x + prop_x) / two
            prop_x = x
        prop_y = float(scape(prop_x))
        evals -= 1
        better = prop_y > best_y
        if better:
            best_x, best_y = prop_x, prop_y
        if expanding and better:
            delta = delta * two
        else:
            expanding = False
            delta = delta * RATIO
    return best_x
