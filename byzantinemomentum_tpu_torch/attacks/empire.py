"""Strict "Fall of Empires" attack: byz = -epsilon * honest_average
(`byzantinemomentum_tpu/attacks/empire.py`; Xie, Koyejo, Gupta, UAI
2019).

A negative `epsilon` line-searches the live defense with
`ceil(-epsilon)` evaluations, as `attacks/identical.py` does (float32
probes and rows under a half dtype).
"""

import math

import torch

from byzantinemomentum_tpu_torch.attacks import (
    displacement, empty_byzantine, register, search_dtype)
from byzantinemomentum_tpu_torch.ops.linesearch import line_maximize
from byzantinemomentum_tpu_torch.utils import weak_scalar

__all__ = ["attack"]


def attack(grad_honests, f_decl, f_real, defense, epsilon=1, **kwargs):
    """f_real copies of `-epsilon * mean(grad_honests)`."""
    if f_real == 0:
        return empty_byzantine(grad_honests)
    grad_avg = torch.mean(grad_honests, dim=0)
    if epsilon < 0:
        dtype = search_dtype(grad_honests)
        honests, avg = grad_honests.to(dtype), grad_avg.to(dtype)
        objective = displacement(defense, honests, f_decl, f_real, avg)

        def eval_epsilon(x):
            return objective(avg * -x)

        epsilon_eff = line_maximize(eval_epsilon, evals=math.ceil(-epsilon),
                                    device=avg.device)
        byz_grad = avg * -epsilon_eff
    else:
        byz_grad = grad_avg * weak_scalar(-epsilon, grad_avg.dtype)
    return byz_grad[None, :].expand(f_real, -1).clone()


def check(grad_honests, f_real, defense, epsilon=1, **kwargs):
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return f"Expected a non-negative number of Byzantine gradients to generate, got {f_real!r}"
    if not callable(defense):
        return f"Expected a callable for the aggregation rule, got {defense!r}"
    if not isinstance(epsilon, int) or epsilon == 0:
        return f"Expected a non-zero attack epsilon, got {epsilon!r}"


register("empire-strict", attack, check)
