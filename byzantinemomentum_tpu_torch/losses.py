"""Loss and criterion registries (`byzantinemomentum_tpu/losses.py`).

A loss maps `(output, target, theta) -> scalar` and composes:
`Loss("nll") + 1e-2 * Loss("l2")` is the driver's `--l2-regularize 1e-2`.
The losses are the JAX package's, name for name: the torch losses of the
reference's registry (`crossentropy`, `mse`, `l1loss`, `bce`, ...; mean
reduction) written as plain tensor functions, and the parameter-norm
regularizers `l1` and `l2`. The multi-input losses (`cosineembedding`,
`marginranking`, `tripletmargin`, `tripletmarginwithdistance`,
`gaussiannll`) take their inputs as a tuple in `output`.
A criterion maps `(output, target) -> f32[2] = [#correct, batch]`:
`top-k` and `sigmoid`.
"""

import math

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

        def scaled(o, t, p):
            # The factor rounded to the loss's dtype, as JAX applies it
            value = fn(o, t, p)
            return value * utils.weak_scalar(factor, value.dtype)

        out = Loss(scaled)
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


def _crossentropy(**kw):
    """Cross-entropy over raw logits (torch `CrossEntropyLoss`)."""
    def loss(output, target, theta):
        logp = output - torch.amax(output, dim=1, keepdim=True)
        logp = logp - torch.log(torch.sum(torch.exp(logp), dim=1, keepdim=True))
        picked = torch.gather(logp, 1, target.reshape(-1, 1).long())
        return -torch.mean(picked)
    return loss


def _mse(**kw):
    def loss(output, target, theta):
        return torch.mean((output - target.reshape(output.shape)) ** 2)
    return loss


def _l1loss(**kw):
    """Torch `L1Loss` (mean absolute error); `l1` is the parameter norm."""
    def loss(output, target, theta):
        return torch.mean(torch.abs(output - target.reshape(output.shape)))
    return loss


def _bce(**kw):
    """Torch `BCELoss` over probabilities in [0, 1]."""
    eps = 1e-12

    def loss(output, target, theta):
        target = target.reshape(output.shape)
        return -torch.mean(target * torch.log(output + eps)
                           + (1.0 - target) * torch.log(1.0 - output + eps))
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


def _smoothl1(beta=1.0, **kw):
    """Torch `SmoothL1Loss` (Huber with delta = beta)."""
    def loss(output, target, theta):
        diff = torch.abs(output - target.reshape(output.shape))
        return torch.mean(torch.where(diff < beta, 0.5 * diff * diff / beta,
                                      diff - 0.5 * beta))
    return loss


def _kldiv(**kw):
    """Torch `KLDivLoss` (batchmean): log-probability outputs, probability
    targets."""
    eps = 1e-12

    def loss(output, target, theta):
        target = target.reshape(output.shape)
        return (torch.sum(target * (torch.log(target + eps) - output))
                / output.shape[0])
    return loss


def _hingeembedding(margin=1.0, **kw):
    """Torch `HingeEmbeddingLoss`: targets in {1, -1}."""
    def loss(output, target, theta):
        target = target.reshape(output.shape)
        return torch.mean(torch.where(target > 0, output,
                                      torch.clamp(margin - output, min=0.0)))
    return loss


def _bcewithlogits(**kw):
    """Torch `BCEWithLogitsLoss`, in its stable form."""
    def loss(output, target, theta):
        t = target.reshape(output.shape)
        return torch.mean(torch.clamp(output, min=0.0) - output * t
                          + torch.log1p(torch.exp(-torch.abs(output))))
    return loss


def _poissonnll(log_input=True, full=False, eps=1e-8, **kw):
    """Torch `PoissonNLLLoss`, with the Stirling term where `full`."""
    def loss(output, target, theta):
        t = target.reshape(output.shape)
        if log_input:
            out = torch.exp(output) - t * output
        else:
            out = output - t * torch.log(output + eps)
        if full:
            t1 = torch.clamp(t, min=1.0)
            stirling = t * torch.log(t1) - t + 0.5 * torch.log(2.0 * math.pi * t1)
            out = out + torch.where(t > 1.0, stirling, 0.0)
        return torch.mean(out)
    return loss


def _softmargin(**kw):
    """Torch `SoftMarginLoss`: targets in {1, -1}."""
    def loss(output, target, theta):
        t = target.reshape(output.shape)
        return torch.mean(torch.log1p(torch.exp(-t * output)))
    return loss


def _multimargin(p=1, margin=1.0, **kw):
    """Torch `MultiMarginLoss`: multi-class hinge over (N, C) outputs."""
    def loss(output, target, theta):
        c = output.shape[1]
        t = target.long().reshape(-1, 1)
        m = torch.clamp(margin - torch.gather(output, 1, t) + output, min=0.0)
        if p != 1:
            m = m ** p
        m = m.scatter(1, t, 0.0)
        return torch.mean(torch.sum(m, dim=1) / c)
    return loss


def _multilabelmargin(**kw):
    """Torch `MultiLabelMarginLoss`: target rows hold class indices ended
    by -1."""
    def loss(output, target, theta):
        n, c = output.shape
        t = target.long().reshape(n, -1)
        valid = torch.cumprod((t >= 0).long(), dim=1).bool()
        tc = torch.clamp(t, min=0)
        is_target = torch.zeros((n, c), dtype=torch.long, device=output.device)
        is_target = is_target.scatter_reduce(1, tc, valid.long(), "amax").bool()
        x_t = torch.gather(output, 1, tc)
        hinge = torch.clamp(1.0 - x_t[:, :, None] + output[:, None, :], min=0.0)
        mask = valid[:, :, None] & ~is_target[:, None, :]
        return torch.mean(torch.sum(torch.where(mask, hinge, 0.0),
                                    dim=(1, 2)) / c)
    return loss


def _multilabelsoftmargin(**kw):
    """Torch `MultiLabelSoftMarginLoss`: per-class BCE over {0, 1}
    targets."""
    def loss(output, target, theta):
        t = target.reshape(output.shape)
        per = (t * torch.nn.functional.logsigmoid(output)
               + (1.0 - t) * torch.nn.functional.logsigmoid(-output))
        return torch.mean(-torch.mean(per, dim=1))
    return loss


def _cosineembedding(margin=0.0, **kw):
    """Torch `CosineEmbeddingLoss`; `output` is the pair (x1, x2)."""
    eps = 1e-8

    def loss(output, target, theta):
        x1, x2 = output
        norms = (torch.linalg.vector_norm(x1, dim=-1)
                 * torch.linalg.vector_norm(x2, dim=-1))
        cos = torch.sum(x1 * x2, dim=-1) / torch.clamp(norms, min=eps)
        t = target.reshape(cos.shape)
        return torch.mean(torch.where(t > 0, 1.0 - cos,
                                      torch.clamp(cos - margin, min=0.0)))
    return loss


def _marginranking(margin=0.0, **kw):
    """Torch `MarginRankingLoss`; `output` is the pair (x1, x2)."""
    def loss(output, target, theta):
        x1, x2 = output
        t = target.reshape(x1.shape)
        return torch.mean(torch.clamp(-t * (x1 - x2) + margin, min=0.0))
    return loss


def _tripletmargin(margin=1.0, p=2, eps=1e-6, swap=False, **kw):
    """Torch `TripletMarginLoss`; `output` is the triple (anchor, positive,
    negative)."""
    def pdist(a, b):
        return torch.sum(torch.abs(a - b + eps) ** p, dim=-1) ** (1.0 / p)

    def loss(output, target, theta):
        a, pos, neg = output
        dp, dn = pdist(a, pos), pdist(a, neg)
        if swap:
            dn = torch.minimum(dn, pdist(pos, neg))
        return torch.mean(torch.clamp(dp - dn + margin, min=0.0))
    return loss


def _tripletmarginwithdistance(distance_function=None, margin=1.0,
                               swap=False, **kw):
    """Torch `TripletMarginWithDistanceLoss`; `output` is the triple
    (anchor, positive, negative), the distance the pairwise L2 norm by
    default."""
    if distance_function is None:
        def distance_function(a, b):
            return torch.linalg.vector_norm(a - b, dim=-1)

    def loss(output, target, theta):
        a, pos, neg = output
        dp, dn = distance_function(a, pos), distance_function(a, neg)
        if swap:
            dn = torch.minimum(dn, distance_function(pos, neg))
        return torch.mean(torch.clamp(dp - dn + margin, min=0.0))
    return loss


def _gaussiannll(full=False, eps=1e-6, **kw):
    """Torch `GaussianNLLLoss`; `output` is the pair (mean, variance)."""
    def loss(output, target, theta):
        mu, var = output
        t = target.reshape(mu.shape)
        var = torch.clamp(var, min=eps)
        out = 0.5 * (torch.log(var) + (t - mu) ** 2 / var)
        if full:
            out = out + 0.5 * math.log(2.0 * math.pi)
        return torch.mean(out)
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


def _sigmoid(**kw):
    """`sigmoid` criterion for binary outputs in [0, 1]: a value is correct
    when it lies within 0.5 of its target."""
    def criterion(output, target):
        correct = torch.abs(target.reshape(output.shape) - output) < 0.5
        return torch.stack([correct.sum().float(),
                            torch.tensor(float(correct.numel()),
                                         device=output.device)])
    return criterion


losses.update({
    "nll": _nll, "crossentropy": _crossentropy, "mse": _mse,
    "l1loss": _l1loss, "bce": _bce, "smoothl1": _smoothl1,
    "huber": _smoothl1, "kldiv": _kldiv, "hingeembedding": _hingeembedding,
    "bcewithlogits": _bcewithlogits, "poissonnll": _poissonnll,
    "softmargin": _softmargin, "multimargin": _multimargin,
    "multilabelmargin": _multilabelmargin,
    "multilabelsoftmargin": _multilabelsoftmargin,
    "cosineembedding": _cosineembedding, "marginranking": _marginranking,
    "tripletmargin": _tripletmargin,
    "tripletmarginwithdistance": _tripletmarginwithdistance,
    "gaussiannll": _gaussiannll, "l1": _l1, "l2": _l2})
criteria.update({"top-k": _topk, "sigmoid": _sigmoid})
