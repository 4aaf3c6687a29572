"""`mobilenet_v2`: torchvision's MobileNetV2 at width 1.0
(`byzantinemomentum_tpu/models/mobilenet.py`).

Architecture: conv3x3(3, 32, stride 2, pad 1, no bias) `bn0` ReLU6, then
the inverted residual blocks `b0` .. `b16` (expansion t, out channels c,
repeats n, first stride s: (1,16,1,1) (6,24,2,2) (6,32,3,2) (6,64,4,2)
(6,96,3,1) (6,160,3,2) (6,320,1,1)), each [1x1 `expand` `bn_e` ReLU6
(not at t = 1)], the 3x3 depthwise `dw` at the block's stride `bn_d`
ReLU6, the 1x1 `project` `bn_p` (linear), plus the input where the
stride is 1 and the width is kept; then the 1x1 `head` (320 -> 1280)
`bn1` ReLU6, the global average pool, dropout 0.2 and `fc`. The model
returns raw logits, as the JAX model does: pair it with `--loss
crossentropy`.

The depthwise kernel keeps the JAX layout `(3, 3, 1, h)` (HWIO with
`feature_group_count=h`) in the flat vector and runs as torch's `(h, 1, 3,
3)` with `groups=h`. ReLU6 is `models/core.py::relu6`, whose gradient at
exactly 0 and 6 is JAX's clip's 0.5.

Dropout: the classifier's keep-mask (keep 0.8, no 8-bit threshold: the
Bernoulli path) is drawn from the worker's key itself, as the JAX model
gives `dropout_apply` its `rng` unsplit: `bernoulli(wkeys[s], 0.8, (B,
1280))` (`worker_dropout_masks` with `j` None).

Init: kaiming-normal fan_out bias-free kernels (std sqrt(2 / (kh kw
cout)); the depthwise kernel's fan_out counts one output a group, std
sqrt(2 / 9)); fresh BatchNorm; `fc.w` = 0.01 normal from key 0 of the
classifier key's split, `fc.b` 0. Keys: `split(key, 20)`: key 0 the stem,
1 + i block i, 18 the head, 19 the classifier; a block splits its key
into 3 (expand, dw, project; the expand key drawn at t = 1 too). No
grouped forward: the engine takes the vmapped honest phase.
"""

import math

import torch
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import (
    BatchNorm, Dense, PaddedConv, dropout_apply, global_avg_pool, relu6,
    worker_dropout_masks)
from byzantinemomentum_tpu_torch.models.resnet import kaiming_fan_out_std
from byzantinemomentum_tpu_torch.utils import weak_scalar

__all__ = ["MobileNetV2"]

# (expansion, out channels, repeats, first stride)
_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
_DROPOUT = 0.2
_HEAD = 1280


class _Block(nn.Module):
    """One inverted residual block."""

    def __init__(self, cin, cout, t, stride, like):
        super().__init__()
        h = cin * t
        self.residual = stride == 1 and cin == cout
        if t != 1:
            self.expand = PaddedConv(cin, h, 1, **like)
            self.bn_e = BatchNorm(h, **like)
        else:
            self.expand = self.bn_e = None
        self.dw = PaddedConv(h, h, 3, stride, 1, groups=h, **like)
        self.bn_d = BatchNorm(h, **like)
        self.project = PaddedConv(h, cout, 1, **like)
        self.bn_p = BatchNorm(cout, **like)

    def init(self, key):
        keys = prng.split(key, 3)
        if self.expand is not None:
            self.expand.init_normal(keys[0], kaiming_fan_out_std(self.expand))
            self.bn_e.init()
        self.dw.init_normal(keys[1], math.sqrt(2.0 / 9.0))
        self.bn_d.init()
        self.project.init_normal(keys[2], kaiming_fan_out_std(self.project))
        self.bn_p.init()

    def forward(self, x, train, name, new_state):
        out = x
        if self.expand is not None:
            out, new_state[f"{name}.bn_e"] = self.bn_e(self.expand(out), train)
            out = relu6(out)
        out, new_state[f"{name}.bn_d"] = self.bn_d(self.dw(out), train)
        out, new_state[f"{name}.bn_p"] = self.bn_p(self.project(relu6(out)),
                                                   train)
        return out + x if self.residual else out


class MobileNetV2(nn.Module):
    input_shape = (32, 32, 3)

    def __init__(self, num_classes=10, device=None, dtype=None, **unused):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.stem = PaddedConv(3, 32, 3, 2, 1, **like)
        self.bn0 = BatchNorm(32, **like)
        self.blocks = []
        cin = 32
        for t, c, n, s in _CFG:
            for i in range(n):
                name = f"b{len(self.blocks)}"
                block = _Block(cin, c, t, s if i == 0 else 1, like)
                self.add_module(name, block)
                self.blocks.append((name, block))
                cin = c
        self.head = PaddedConv(cin, _HEAD, 1, **like)
        self.bn1 = BatchNorm(_HEAD, **like)
        self.fc = Dense(_HEAD, num_classes, **like)

    @torch.no_grad()
    def init(self, key):
        """The JAX model's `init(key)` (the module docstring's keys)."""
        n = len(self.blocks)
        keys = prng.split(key, n + 3)
        self.stem.init_normal(keys[0], kaiming_fan_out_std(self.stem))
        self.bn0.init()
        for i, (_, block) in enumerate(self.blocks):
            block.init(keys[1 + i])
        self.head.init_normal(keys[n + 1], kaiming_fan_out_std(self.head))
        self.bn1.init()
        w_key = prng.split(keys[n + 2])[0]
        self.fc.w.copy_(weak_scalar(0.01, torch.float32) * prng.normal(
            w_key.to(self.fc.w.device), self.fc.w.shape))
        self.fc.b.zero_()

    def draw_masks(self, wkeys, batch):
        """The classifier's keep-mask stack `(S, B, 1280)` of S workers,
        `bernoulli(wkeys[s], 0.8, (B, 1280))` from each worker's key
        itself."""
        return (worker_dropout_masks(wkeys, None, 1.0 - _DROPOUT,
                                     (batch, _HEAD)),)

    def forward(self, x, train=False, masks=None):
        """`x: [B, 32, 32, 3]` (NHWC) -> `(logits [B, classes], new BN
        state)`. Train mode needs the keep-mask (`draw_masks`)."""
        if train and masks is None:
            raise ValueError("mobilenet_v2 needs a dropout mask in train mode")
        new_state = {}
        x, new_state["bn0"] = self.bn0(self.stem(x.permute(0, 3, 1, 2)), train)
        x = relu6(x)
        for name, block in self.blocks:
            x = block(x, train, name, new_state)
        x, new_state["bn1"] = self.bn1(self.head(x), train)
        x = global_avg_pool(relu6(x))
        x = dropout_apply(masks[0] if train else None, x, _DROPOUT)
        return self.fc(x), new_state


register("mobilenet_v2", MobileNetV2)
