"""A time-coupled attack on a defense's warm-up window, the stateful
attack (`byzantinemomentum_tpu/attacks/warmup.py`, `alie-warmup`).

For the first `window` steps the rows burst at `-burst * mean` (the Fall
of Empires direction); from then on they hide inside the honest variance
envelope, as ALIE rows at a small `z`. The state is the step counter,
an i32 0-d tensor as in the JAX package (the engine moves it to its
device), and the rows are `torch.where(step < window, burst, hidden)`
with both computed, as JAX computes them, so the schedule reads nothing
on the host; a call with no Byzantine row returns the state unchanged,
as the JAX package does.
"""

import torch

from byzantinemomentum_tpu_torch.attacks import alie, empty_byzantine, register

__all__ = ["attack", "state_init"]


def state_init(f_real, d):
    """The step counter (the only history the schedule needs), on the
    CPU: `Engine.init` moves it to the engine's device."""
    return torch.zeros((), dtype=torch.int32)


def attack(grad_honests, f_decl, f_real, defense, state=None, window=12,
           burst=20.0, z=0.3, jitter=0.0, **kwargs):
    """Burst for `window` steps, then hide at `mean + z * std`; returns
    `(rows, step + 1)`."""
    if f_real == 0:
        return empty_byzantine(grad_honests), state
    step = (torch.zeros((), dtype=torch.int32, device=grad_honests.device)
            if state is None else state)
    hot = -float(burst) * torch.mean(grad_honests, dim=0)
    hidden = alie.attack(grad_honests, f_decl, f_real, defense, z=float(z),
                         jitter=jitter)
    rows = torch.where(step < window, hot[None, :].expand(f_real, -1), hidden)
    return rows.to(grad_honests.dtype), step + 1


def check(grad_honests, f_real, defense, window=12, burst=20.0, z=0.3,
          jitter=0.0, **kwargs):
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return (f"Expected a non-negative number of Byzantine gradients to "
                f"generate, got {f_real!r}")
    if not isinstance(window, int) or window < 0:
        return f"Expected a non-negative warm-up window, got {window!r}"
    if not isinstance(burst, (int, float)):
        return f"Expected a number for the burst amplitude, got {burst!r}"
    if not isinstance(z, (int, float)):
        return f"Expected a number for the hidden z-margin, got {z!r}"


register("alie-warmup", attack, check, state_init=state_init)
