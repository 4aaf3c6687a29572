"""Loss and criterion registries (`byzantinemomentum_tpu/losses.py`, the
subset of the training path: the `nll` loss, the `l1` and `l2` parameter
regularizers, and the `top-k` criterion).

A loss maps `(output, target, theta) -> scalar` and composes:
`Loss("nll") + 1e-2 * Loss("l2")` is the driver's `--l2-regularize 1e-2`.
A criterion maps `(output, target) -> f32[2] = [#correct, batch]`.
"""

import torch

from byzantinemomentum_tpu_torch import utils

__all__ = ["losses", "criteria", "Loss", "Criterion"]

losses = {}
criteria = {}


class Loss:
    """A named loss `(output, target, theta) -> scalar`, or a callable
    one; composed with `+` and with a factor by `*`."""

    def __init__(self, name_build, **kwargs):
        if callable(name_build):
            self._fn = name_build
            self.name = getattr(name_build, "__name__", "custom")
        else:
            if name_build not in losses:
                utils.fatal_unavailable(losses, name_build, what="loss name")
            self._fn = losses[name_build](**kwargs)
            self.name = name_build

    def __call__(self, output, target, theta):
        return self._fn(output, target, theta)

    def __add__(self, other):
        if not isinstance(other, Loss):
            return NotImplemented
        a, b = self._fn, other._fn
        out = Loss(lambda o, t, p: a(o, t, p) + b(o, t, p))
        out.name = f"{self.name}+{other.name}"
        return out

    def __mul__(self, factor):
        fn = self._fn
        out = Loss(lambda o, t, p: fn(o, t, p) * factor)
        out.name = f"{factor}*{self.name}"
        return out

    __rmul__ = __mul__


class Criterion:
    """A named evaluation metric returning `[#correct, batch]`."""

    def __init__(self, name, **kwargs):
        if name not in criteria:
            utils.fatal_unavailable(criteria, name, what="criterion name")
        self._fn = criteria[name](**kwargs)
        self.name = name

    def __call__(self, output, target):
        return self._fn(output, target)


def _nll(**kw):
    """Negative log-likelihood over log-probability outputs, mean
    reduction (torch `NLLLoss`)."""
    def loss(output, target, theta):
        picked = torch.gather(output, 1, target.reshape(-1, 1).long())
        return -torch.mean(picked)
    return loss


def _l1(**kw):
    """Parameter-norm L1 regularizer `sum |theta|`."""
    def loss(output, target, theta):
        return torch.sum(torch.abs(theta))
    return loss


def _l2(**kw):
    """Parameter-norm L2 regularizer `sqrt(sum theta^2)`: the norm, not its
    square."""
    def loss(output, target, theta):
        return torch.sqrt(torch.sum(theta * theta))
    return loss


def _topk(k=1, **kw):
    """`top-k` criterion: a sample is correct when its target is among the
    k highest outputs."""
    def criterion(output, target):
        k_eff = min(k, output.shape[1])
        idx = torch.topk(output, k_eff, dim=1).indices
        correct = (idx == target.reshape(-1, 1)).any(dim=1)
        return torch.stack([correct.sum().float(),
                            torch.tensor(float(output.shape[0]),
                                         device=output.device)])
    return criterion


losses["nll"] = _nll
losses["l1"] = _l1
losses["l2"] = _l2
criteria["top-k"] = _topk
