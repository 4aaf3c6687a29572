"""Identical-gradient attack family: `empire`, `little`, `bulyan`
(`byzantinemomentum_tpu/attacks/identical.py`).

Each attack submits f_real copies of `avg + factor * direction`, with an
attack-specific direction. A positive `factor` is fixed; a negative one
line-searches the live defense's output displacement
`||GAR(honest + byz) - avg||^2` with `ceil(-factor)` evaluations
(`ops/linesearch.py`), each probe a call of the configured GAR, so its
kernels. The searched factor is a float32 0-d tensor on the rows' device
(`avg + x * att` is one f32 multiply and one add, as with the scalar),
as the JAX package's is a float32 scalar:
under a half dtype the probes and the returned rows are float32 (the
engine casts the rows back). A fixed factor is a weak-typed Python scalar
there: it is rounded to the rows' dtype first (`utils.weak_scalar`).
"""

import math

import torch

from byzantinemomentum_tpu_torch.attacks import (
    displacement, empty_byzantine, register, search_dtype)
from byzantinemomentum_tpu_torch.ops.linesearch import line_maximize
from byzantinemomentum_tpu_torch.utils import weak_scalar

__all__ = ["make_attack"]


def make_attack(compute_direction):
    """Build the attack for a direction function
    `(grad_stack, grad_avg, **kwargs) -> f32[d]`."""

    def attack(grad_honests, f_decl, f_real, defense, factor=-16,
               negative=False, **kwargs):
        if f_real == 0:
            return empty_byzantine(grad_honests)
        grad_avg = torch.mean(grad_honests, dim=0)
        grad_att = compute_direction(grad_honests, grad_avg, **kwargs)
        if factor < 0:
            dtype = search_dtype(grad_honests)
            honests, avg, att = (x.to(dtype) for x in (grad_honests, grad_avg, grad_att))
            objective = displacement(defense, honests, f_decl, f_real, avg)

            def eval_factor(x):
                return objective(avg + (-x if negative else x) * att)

            factor_eff = line_maximize(eval_factor, evals=math.ceil(-factor),
                                       device=avg.device)
            factor_eff = -factor_eff if negative else factor_eff
            byz_grad = avg + factor_eff * att
        else:
            # The fixed factor rounded to the rows' dtype, as JAX applies it
            factor_eff = weak_scalar(-factor if negative else factor,
                                     grad_avg.dtype)
            byz_grad = grad_avg + factor_eff * grad_att
        return byz_grad[None, :].expand(f_real, -1).clone()

    return attack


def check(grad_honests, f_real, defense, factor=-16, negative=False, **kwargs):
    """Parameter validity (the JAX package's rules)."""
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return f"Expected a non-negative number of Byzantine gradients to generate, got {f_real!r}"
    if not callable(defense):
        return f"Expected a callable for the aggregation rule, got {defense!r}"
    if not ((isinstance(factor, float) and factor > 0) or (isinstance(factor, int) and factor != 0)):
        return f"Expected a positive number or a negative integer for the attack factor, got {factor!r}"
    if not isinstance(negative, bool):
        return f"Expected a boolean for optional parameter 'negative', got {negative!r}"


def direction_bulyan(grad_stack, grad_avg, target_idx=-1, **kwargs):
    """Single-coordinate (or all-ones) direction, "The Hidden
    Vulnerability"."""
    if target_idx == "all":
        return torch.ones_like(grad_avg)
    if not isinstance(target_idx, int):
        raise ValueError(f'Expected an integer or "all" for target_idx, got {target_idx!r}')
    out = torch.zeros_like(grad_avg)
    out[target_idx] = 1.0
    return out


def direction_empire(grad_stack, grad_avg, **kwargs):
    """Negated honest average, "Fall of Empires"."""
    return -grad_avg


def direction_little(grad_stack, grad_avg, **kwargs):
    """Coordinate-wise sample standard deviation, "A Little is Enough"."""
    return torch.sqrt(torch.var(grad_stack, dim=0, correction=1))


for _name, _direction in (("bulyan", direction_bulyan), ("empire", direction_empire),
                          ("little", direction_little)):
    register(_name, make_attack(_direction), check)
