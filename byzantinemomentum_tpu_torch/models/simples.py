"""The simple models: `simples-full`, `simples-conv`, `simples-logit`,
`simples-linear` (`byzantinemomentum_tpu/models/simples.py`).

* full   — the MNIST 784-100-10 MLP, relu, log_softmax (d = 79,510).
* conv   — the MNIST LeNet: conv5x5(1,20) relu maxpool2, conv5x5(20,50)
           relu maxpool2, fc(800,500) relu, fc(500,10), log_softmax, both
           convolutions 'VALID' (d = 431,080; the driver's default model).
* logit  — sigmoid(linear(din -> dout)), din 68, dout 1 (d = 69, the
           `phishing` model).
* linear — linear(din -> dout).

Inputs arrive NHWC, as the datasets give them; `simples-conv` permutes to
NCHW for its convolutions and back to (h, w, c) rows before `f1`, so `f1`
reads the rows of the JAX model's NHWC flatten. No model has dropout or
BatchNorm: `forward` returns `(output, {})`, and the keep-mask shapes are
empty. `forward_grouped` (the JAX models' `apply_grouped`, which every
simple model has, so the engine takes the grouped honest phase for them)
runs all S workers' forwards as one program on the grouped layers of
`models/core.py`; it is the same function as S calls of `forward`.
"""

import torch
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import (
    Conv, Dense, grouped_conv, grouped_dense, log_softmax, max_pool)

__all__ = ["SimplesFull", "SimplesConv", "SimplesLogit", "SimplesLinear"]


class _Simple(nn.Module):
    """What the simple models share: the JAX init, no dropout masks."""

    def init(self, key):
        """The JAX model's `init(key)`: its layers in order from
        `prng.split(key, #layers)` (`split(key)` for two); a single
        layer takes `key` itself (`simples-logit`, `-linear`)."""
        layers = list(self.children())
        keys = prng.split(key, len(layers)) if len(layers) > 1 else (key,)
        for layer, layer_key in zip(layers, keys):
            layer.init(layer_key)

    def mask_shapes(self, batch):
        return ()

    def draw_masks(self, wkeys, batch):
        return ()


class SimplesFull(_Simple):
    input_shape = (28, 28, 1)

    def __init__(self, device=None, dtype=None, **unused):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.f1 = Dense(28 * 28, 100, **like)
        self.f2 = Dense(100, 10, **like)

    def forward(self, x, train=False, masks=None):
        """`x: [B, 28, 28, 1]` -> `(log-probabilities [B, 10], {})`."""
        x = torch.relu(self.f1(x.reshape(x.shape[0], -1)))
        return log_softmax(self.f2(x)), {}

    def forward_grouped(self, params_s, state, xs, train=False, masks=None,
                        shared=False):
        """`xs: [S, B, 28, 28, 1]` and the `(S, ...)` parameter stacks ->
        `(log-probabilities [S, B, 10], {})`."""
        p = params_s
        x = xs.reshape(*xs.shape[:2], -1)
        x = torch.relu(grouped_dense(x, p["f1.w"], p["f1.b"], shared))
        return log_softmax(grouped_dense(x, p["f2.w"], p["f2.b"], shared)), {}


class SimplesConv(_Simple):
    input_shape = (28, 28, 1)

    def __init__(self, device=None, dtype=None, **unused):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.c1 = Conv(1, 20, 5, padding="valid", **like)
        self.c2 = Conv(20, 50, 5, padding="valid", **like)
        self.f1 = Dense(800, 500, **like)
        self.f2 = Dense(500, 10, **like)

    def forward(self, x, train=False, masks=None):
        """`x: [B, 28, 28, 1]` (NHWC) -> `(log-probabilities [B, 10], {})`."""
        x = x.permute(0, 3, 1, 2)
        x = max_pool(torch.relu(self.c1(x)))
        x = max_pool(torch.relu(self.c2(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) rows
        x = torch.relu(self.f1(x))
        return log_softmax(self.f2(x)), {}

    def forward_grouped(self, params_s, state, xs, train=False, masks=None,
                        shared=False):
        """`xs: [S, B, 28, 28, 1]` (NHWC) -> `(log-probabilities
        [S, B, 10], {})`."""
        S, B = xs.shape[:2]
        p = params_s

        def conv(x, name):
            return torch.relu(grouped_conv(x, p[f"{name}.w"], p[f"{name}.b"],
                                           shared, padding="valid"))

        x = xs.flatten(0, 1).permute(0, 3, 1, 2)  # (S*B, 1, 28, 28)
        x = max_pool(conv(max_pool(conv(x, "c1")), "c2"))
        x = x.permute(0, 2, 3, 1).reshape(S, B, -1)  # (h, w, c) rows
        x = torch.relu(grouped_dense(x, p["f1.w"], p["f1.b"], shared))
        return log_softmax(grouped_dense(x, p["f2.w"], p["f2.b"], shared)), {}


class SimplesLinear(_Simple):
    """`linear(din -> dout)`, without an activation."""

    def __init__(self, din=68, dout=1, device=None, dtype=None, **unused):
        super().__init__()
        self.input_shape = (din,)
        self.linear = Dense(din, dout, device=device, dtype=dtype)

    def activation(self, x):
        return x

    def forward(self, x, train=False, masks=None):
        """`x: [B, din]` -> `(outputs [B, dout], {})`."""
        x = x.reshape(x.shape[0], self.linear.w.shape[0])
        return self.activation(self.linear(x)), {}

    def forward_grouped(self, params_s, state, xs, train=False, masks=None,
                        shared=False):
        """`xs: [S, B, din]` -> `(outputs [S, B, dout], {})`."""
        x = xs.reshape(*xs.shape[:2], self.linear.w.shape[0])
        return self.activation(grouped_dense(
            x, params_s["linear.w"], params_s["linear.b"], shared)), {}


class SimplesLogit(SimplesLinear):
    """`sigmoid(linear(din -> dout))`."""

    def activation(self, x):
        return torch.sigmoid(x)


register("simples-full", SimplesFull)
register("simples-conv", SimplesConv)
register("simples-logit", SimplesLogit)
register("simples-linear", SimplesLinear)
