"""The "Fall of Empires" CIFAR CNN: `empire-cnn`
(`byzantinemomentum_tpu/models/empire.py`).

Architecture (note the unusual conv -> relu -> BN order, kept for parity):
  conv3x3(3,64) relu bn, conv3x3(64,64) relu bn, maxpool2, dropout .25,
  conv3x3(64,128) relu bn, conv3x3(128,128) relu bn,
  maxpool2, dropout .25, flatten(8192),
  fc(8192,128) relu dropout .25 fc(128,10), log_softmax
  (CIFAR-100 variant: fc(8192,256), fc(256,100)).

Inputs arrive NHWC, as the JAX package's datasets give them, and are
permuted to NCHW here. The flatten permutes back to (h, w, c) order before
the reshape, so `f1` reads the rows the JAX model's NHWC flatten gives it.

`forward_grouped` (the JAX model's `apply_grouped`) runs all S workers'
forwards as one merged program on the `models/core.py` grouped layers;
it is the same function as S calls of `forward`.
"""

import torch
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import (
    BatchNorm, Conv, Dense, dropout_apply, grouped_batchnorm, grouped_conv,
    grouped_dense, log_softmax, max_pool, worker_dropout_masks)

__all__ = ["EmpireCNN"]

_RATE = 0.25


class EmpireCNN(nn.Module):
    input_shape = (32, 32, 3)

    def __init__(self, cifar100=False, device=None, dtype=None):
        super().__init__()
        fc1_out = 256 if cifar100 else 128
        like = {"device": device, "dtype": dtype}
        self.c1 = Conv(3, 64, **like)
        self.b1 = BatchNorm(64, **like)
        self.c2 = Conv(64, 64, **like)
        self.b2 = BatchNorm(64, **like)
        self.c3 = Conv(64, 128, **like)
        self.b3 = BatchNorm(128, **like)
        self.c4 = Conv(128, 128, **like)
        self.b4 = BatchNorm(128, **like)
        self.f1 = Dense(8192, fc1_out, **like)
        self.f2 = Dense(fc1_out, 100 if cifar100 else 10, **like)

    def init(self, key):
        """The JAX model's `init(key)`: the six weight layers from
        `prng.split(key, 6)` in the order c1, c2, c3, c4, f1, f2; fresh
        BatchNorm parameters and state."""
        keys = prng.split(key, 6)
        for layer, layer_key in zip((self.c1, self.c2, self.c3, self.c4,
                                     self.f1, self.f2), keys):
            layer.init(layer_key)
        for bn in (self.b1, self.b2, self.b3, self.b4):
            bn.init()

    def mask_shapes(self, batch):
        """Shapes of the three dropout keep-masks of one forward (NCHW)."""
        return ((batch, 64, 16, 16), (batch, 128, 8, 8),
                (batch, self.f1.w.shape[1]))

    def jax_mask_shapes(self, batch):
        """The same masks' shapes in the JAX model (NHWC), the order in
        which their elements hash their counters."""
        return ((batch, 16, 16, 64), (batch, 8, 8, 128),
                (batch, self.f1.w.shape[1]))

    def draw_masks(self, wkeys, batch):
        """The three keep-mask stacks `(S, B, ...)` (NCHW) of S workers'
        train-mode forwards over `batch` inputs, as the JAX model draws
        them: mask j of worker s from key j of `split(wkeys[s], 3)`; the
        same masks for the grouped and the vmapped honest phase."""
        return tuple(worker_dropout_masks(wkeys, j, 1.0 - _RATE, shape)
                     for j, shape in enumerate(self.jax_mask_shapes(batch)))

    def forward(self, x, train=False, masks=None):
        """`x: [B, 32, 32, 3]` (NHWC) -> `(log-probabilities, new BN
        state {"b1": {"mean", "var"}, ...})`. Train mode needs the three
        dropout keep-masks (`draw_masks`)."""
        if train and masks is None:
            raise ValueError("empire-cnn needs dropout masks in train mode")
        masks = masks if train else (None, None, None)
        new_state = {}
        x = x.permute(0, 3, 1, 2)
        x, new_state["b1"] = self.b1(torch.relu(self.c1(x)), train)
        x, new_state["b2"] = self.b2(torch.relu(self.c2(x)), train)
        x = dropout_apply(masks[0], max_pool(x), _RATE)
        x, new_state["b3"] = self.b3(torch.relu(self.c3(x)), train)
        x, new_state["b4"] = self.b4(torch.relu(self.c4(x)), train)
        x = dropout_apply(masks[1], max_pool(x), _RATE)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) rows
        x = dropout_apply(masks[2], torch.relu(self.f1(x)), _RATE)
        return log_softmax(self.f2(x)), new_state

    def forward_grouped(self, params_s, state, xs, train=False, masks=None,
                        shared=False):
        """All S workers' forwards at once. `params_s` maps each parameter
        name to its `(S, ...)` stack, `state` each buffer name to the
        shared running stat, `xs: [S, B, 32, 32, 3]` (NHWC), `masks` the
        `(S, B, ...)` keep-mask stacks of `draw_masks`; `shared`
        says that every worker's parameters equal worker 0's ->
        `(log-probabilities [S, B, classes], new BN state {"b1.mean":
        (S, 64), ...})`; in eval mode the state comes back as given."""
        if train and masks is None:
            raise ValueError("empire-cnn needs dropout masks in train mode")
        S, B = xs.shape[:2]
        p = params_s
        new_state = {}

        def conv_relu_bn(x, conv, bn):
            x = torch.relu(grouped_conv(x, p[f"{conv}.w"], p[f"{conv}.b"],
                                        shared))
            x, stats = grouped_batchnorm(
                x, p[f"{bn}.gamma"], p[f"{bn}.beta"], state[f"{bn}.mean"],
                state[f"{bn}.var"], train)
            new_state[f"{bn}.mean"], new_state[f"{bn}.var"] = (
                stats["mean"], stats["var"])
            return x

        keep = (tuple(m.flatten(0, 1) for m in masks[:2]) + (masks[2],)
                if train else (None, None, None))
        x = xs.flatten(0, 1).permute(0, 3, 1, 2)  # (S*B, 3, 32, 32)
        x = conv_relu_bn(conv_relu_bn(x, "c1", "b1"), "c2", "b2")
        x = dropout_apply(keep[0], max_pool(x), _RATE)
        x = conv_relu_bn(conv_relu_bn(x, "c3", "b3"), "c4", "b4")
        x = dropout_apply(keep[1], max_pool(x), _RATE)
        x = x.permute(0, 2, 3, 1).reshape(S, B, -1)  # (h, w, c) rows
        x = torch.relu(grouped_dense(x, p["f1.w"], p["f1.b"], shared))
        x = dropout_apply(keep[2], x, _RATE)
        return (log_softmax(grouped_dense(x, p["f2.w"], p["f2.b"], shared)),
                new_state)


register("empire-cnn", EmpireCNN)
