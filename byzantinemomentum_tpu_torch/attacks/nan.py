"""The all-NaN gradient attack (`byzantinemomentum_tpu/attacks/nan.py`),
the driver's default attack.

It is also the framework's numerical fault injection: every GAR must
keep NaN rows out of its aggregate. `detect` is its detection
counterpart, the non-finite-row predicate.
"""

import torch

from byzantinemomentum_tpu_torch.attacks import empty_byzantine, register

__all__ = ["attack", "check", "detect"]


def attack(grad_honests, f_real, **kwargs):
    """f_real all-NaN gradients of the honest rows' width and dtype."""
    if f_real == 0:
        return empty_byzantine(grad_honests)
    return grad_honests.new_full((f_real, grad_honests.shape[1]), torch.nan)


def detect(gradients):
    """Rows holding any non-finite coordinate (NaN or +-inf):
    `[n, d] -> bool[n]`."""
    return ~torch.all(torch.isfinite(gradients), dim=1)


def check(grad_honests, f_real, **kwargs):
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return f"Expected a non-negative number of Byzantine gradients to generate, got {f_real!r}"


register("nan", attack, check)
