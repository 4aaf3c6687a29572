"""`vgg11/vgg13/vgg16/vgg19`: torchvision's VGG, configs A/B/D/E
(`byzantinemomentum_tpu/models/vgg.py`).

Architecture: stacks of 3x3 pad-1 convolutions with bias and ReLU
(`conv0`, `conv1`, ...), the 2x2 stride-2 max pool between stages, the
adaptive average pool to 7x7 (`adaptive_avg_pool`: on the 1x1 features a
32x32 input leaves, each of the 49 windows is that one pixel), then the
classifier `fc0` (25088 -> 4096) ReLU dropout `fc1` (4096 -> 4096) ReLU
dropout `fc2`. The flatten before `fc0` is NHWC's, as the JAX model's:
`fc0.w`'s 25,088 rows are in `(h, w, c)` order, so the NCHW activation
is permuted back to NHWC before the reshape (torchvision's NCHW flatten
would give a model of the same size and another function). The model
returns raw logits, as the JAX model does: pair it with `--loss
crossentropy`.

Dropout: the classifier's two keep-masks (keep 0.5, the 8-bit threshold
128) come from keys 0 and 1 of `split(wkeys[s], 2)`, the JAX model's
`split(rng, 2)`.

Init: kaiming-normal fan_out kernels (std sqrt(2 / (9 cout))) with zero
biases, the classifier's weights 0.01 normal with zero biases. Keys:
`split(key, convs + 3)`, key k for `conv{k}`, then `fc0`, `fc1`, `fc2`,
each drawn from its key itself. No BatchNorm, no grouped forward: the
engine takes the vmapped honest phase.
"""

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import (
    Dense, PaddedConv, dropout_apply, max_pool, worker_dropout_masks)
from byzantinemomentum_tpu_torch.utils import weak_scalar

__all__ = ["VGG", "adaptive_avg_pool"]

# torchvision `cfgs`: channels per convolution, "M" the max pool
_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"),
}
_DROPOUT = 0.5
_POOLED = 7
_HIDDEN = 4096


def adaptive_avg_pool(x, out_hw):
    """torch `AdaptiveAvgPool2d` of an NCHW activation (the JAX
    `adaptive_avg_pool` on NHWC): output pixel (i, j) averages the input
    window [floor(i H / out), ceil((i + 1) H / out)) x [...]; a 1x1 input
    is replicated."""
    return F.adaptive_avg_pool2d(x, out_hw)


class VGG(nn.Module):
    input_shape = (32, 32, 3)

    def __init__(self, arch="vgg16", num_classes=10, device=None, dtype=None,
                 **unused):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.cfg = _CFGS[arch]
        self.convs = []
        cin = 3
        for c in self.cfg:
            if c == "M":
                continue
            conv = PaddedConv(cin, c, 3, pad=1, bias=True, **like)
            self.add_module(f"conv{len(self.convs)}", conv)
            self.convs.append(conv)
            cin = c
        self.fc0 = Dense(cin * _POOLED * _POOLED, _HIDDEN, **like)
        self.fc1 = Dense(_HIDDEN, _HIDDEN, **like)
        self.fc2 = Dense(_HIDDEN, num_classes, **like)

    @torch.no_grad()
    def init(self, key):
        """The JAX model's `init(key)` (the module docstring's keys)."""
        n = len(self.convs)
        keys = prng.split(key, n + 3)
        for conv, conv_key in zip(self.convs, keys):
            conv.init_normal(conv_key, math.sqrt(2.0 / (9 * conv.w.shape[-1])))
        for fc, fc_key in zip((self.fc0, self.fc1, self.fc2), keys[n:]):
            fc.w.copy_(weak_scalar(0.01, torch.float32) * prng.normal(
                fc_key.to(fc.w.device), fc.w.shape))
            fc.b.zero_()

    def draw_masks(self, wkeys, batch):
        """The classifier's two keep-mask stacks `(S, B, 4096)` of S
        workers: key j of `split(wkeys[s], 2)`, `bits8 < 128`."""
        return tuple(worker_dropout_masks(wkeys, j, 1.0 - _DROPOUT,
                                          (batch, _HIDDEN))
                     for j in range(2))

    def forward(self, x, train=False, masks=None):
        """`x: [B, 32, 32, 3]` (NHWC) -> `(logits [B, classes], {})`.
        Train mode needs the two keep-masks (`draw_masks`)."""
        if train and masks is None:
            raise ValueError("vgg needs dropout masks in train mode")
        masks = masks if train else (None, None)
        x = x.permute(0, 3, 1, 2)
        convs = iter(self.convs)
        for c in self.cfg:
            x = max_pool(x) if c == "M" else torch.relu(next(convs)(x))
        x = adaptive_avg_pool(x, (_POOLED, _POOLED))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = dropout_apply(masks[0], torch.relu(self.fc0(x)), _DROPOUT)
        x = dropout_apply(masks[1], torch.relu(self.fc1(x)), _DROPOUT)
        return self.fc2(x), {}


for _arch in _CFGS:
    register(_arch, functools.partial(VGG, _arch))
