"""Layer primitives of the model zoo (`byzantinemomentum_tpu/models/core.py`,
the subset `empire-cnn` needs).

Parameters keep the JAX package's layouts — HWIO convolution kernels and
(din, dout) dense weights — so the flat parameter vector of the port and
of the JAX package compare coordinate for coordinate. Activations are
PyTorch's NCHW; `conv_apply` views the HWIO kernel as OIHW.

Initialization is torch's default for Linear/Conv2d, U(+-1/sqrt(fan_in))
for weights and biases, drawn from an explicit `torch.Generator`.

BatchNorm has torch's train-mode semantics: batch statistics in train
mode, running statistics in eval mode, and the running update
r <- (1-m) r + m s with momentum 0.1, eps 1e-5 and the unbiased batch
variance. Functions return the new running state instead of writing it,
so the honest phase can batch them over workers (`engine/step.py` folds
the per-worker states sequentially).

Dtypes, as in the JAX package: layers are built in the parameter dtype
(`dtype=`); BatchNorm accumulates its statistics at
`promote_types(x.dtype, float32)` and casts its output back to `x.dtype`
and its running state back to the state's dtype; dropout and pooling
stay in `x.dtype`.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BN_MOMENTUM", "BN_EPS", "Conv", "Dense", "BatchNorm",
           "dropout_mask", "dropout_apply", "max_pool", "log_softmax"]

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _uniform(generator, shape, bound, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return (2.0 * u - 1.0) * bound


class Conv(nn.Module):
    """3x3 'SAME' convolution with an HWIO kernel `w` and bias `b`."""

    def __init__(self, cin, cout, k=3, device=None, dtype=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty((k, k, cin, cout), device=device,
                                          dtype=dtype))
        self.b = nn.Parameter(torch.empty((cout,), device=device, dtype=dtype))

    @torch.no_grad()
    def reset(self, generator):
        """torch-default Conv2d init: U(+-1/sqrt(cin*kh*kw))."""
        kh, kw, cin, _ = self.w.shape
        bound = 1.0 / math.sqrt(cin * kh * kw)
        self.w.copy_(_uniform(generator, self.w.shape, bound, self.w.device))
        self.b.copy_(_uniform(generator, self.b.shape, bound, self.b.device))

    def forward(self, x):
        return F.conv2d(x, self.w.permute(3, 2, 0, 1), self.b, padding="same")


class Dense(nn.Module):
    """`x @ w + b` with a (din, dout) weight."""

    def __init__(self, din, dout, device=None, dtype=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty((din, dout), device=device,
                                          dtype=dtype))
        self.b = nn.Parameter(torch.empty((dout,), device=device, dtype=dtype))

    @torch.no_grad()
    def reset(self, generator):
        """torch-default Linear init: W, b ~ U(+-1/sqrt(din))."""
        bound = 1.0 / math.sqrt(self.w.shape[0])
        self.w.copy_(_uniform(generator, self.w.shape, bound, self.w.device))
        self.b.copy_(_uniform(generator, self.b.shape, bound, self.b.device))

    def forward(self, x):
        return x @ self.w + self.b


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis 1 of an NCHW activation; parameters
    `gamma`, `beta`, running-stat buffers `mean`, `var`."""

    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.gamma = nn.Parameter(torch.ones((c,), **like))
        self.beta = nn.Parameter(torch.zeros((c,), **like))
        self.register_buffer("mean", torch.zeros((c,), **like))
        self.register_buffer("var", torch.ones((c,), **like))

    @torch.no_grad()
    def reset(self, generator=None):
        self.gamma.fill_(1.0)
        self.beta.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, train):
        """Returns `(out, new_state)` with `new_state = {"mean", "var"}`
        folded from this batch in train mode, unchanged in eval mode.
        `out` has `x.dtype`, `new_state` the state's dtype."""
        shape = (1, -1, 1, 1)
        if not train:
            # With f32 running stats under a half compute dtype the
            # arithmetic promotes; the activation comes back in x.dtype
            inv = torch.rsqrt(self.var + BN_EPS)
            out = (x - self.mean.view(shape)) * (inv * self.gamma).view(shape)
            out = out + self.beta.view(shape)
            return out.to(x.dtype), {"mean": self.mean, "var": self.var}
        dims = (0, 2, 3)
        count = x.numel() // x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=dims)
        var = xf.var(dim=dims, correction=0)
        inv = torch.rsqrt(var + BN_EPS)
        out = (x - mean.view(shape)) * (inv * self.gamma).view(shape)
        out = (out + self.beta.view(shape)).to(x.dtype)
        # The running stats are aux state: no gradient flows into them
        mean, var = mean.detach(), var.detach()
        unbiased = var * (count / max(count - 1, 1))
        sdt = self.mean.dtype
        new_state = {
            "mean": ((1 - BN_MOMENTUM) * self.mean
                     + BN_MOMENTUM * mean).to(sdt),
            "var": ((1 - BN_MOMENTUM) * self.var
                    + BN_MOMENTUM * unbiased).to(sdt),
        }
        return out, new_state


def dropout_mask(generator, keep, shape, device):
    """Bernoulli(keep) keep-mask drawn from an explicit generator."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout_apply(mask, x, rate):
    """Inverted dropout with a given keep-mask (torch semantics: scale by
    1/(1-p) at train time); `mask=None` is the eval-mode identity."""
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, 0.0)


def max_pool(x, window=2):
    return F.max_pool2d(x, window)


def log_softmax(x):
    return F.log_softmax(x, dim=-1)
