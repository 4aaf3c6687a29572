"""`densenet121/169/201`: torchvision's DenseNet
(`byzantinemomentum_tpu/models/densenet.py`; growth 32, bottleneck 4 x
32, 64 initial features).

Architecture: conv7x7(3, 64, stride 2, pad 3, no bias) `bn0` relu, the
3x3 stride-2 pad-1 max pool; dense blocks of layers `b{b}l{i}` [bn1 relu
conv1x1(c, 128) bn2 relu conv3x3(128, 32, pad 1)], each layer's 32 output
channels concatenated after the running feature map (`[x, out]` on the
channel axis, dim 1 in NCHW, in the JAX order); transitions `t{b}` [bn
relu conv1x1(c, c // 2), then the 2x2 stride-2 window sum over 4.0]
between blocks; `bn5` relu, the global average pool, `fc`. Blocks:
121 = (6, 12, 24, 16), 169 = (6, 12, 32, 32), 201 = (6, 12, 48, 32).
The model returns raw logits, as the JAX model does: pair it with `--loss
crossentropy`.

Init: kaiming-normal fan_in (relu gain) bias-free kernels, std = sqrt(2 /
(kh kw cin)); fresh BatchNorm; the classifier weight U(+-1/sqrt(din))
drawn from its key itself and a zero bias. Keys: `split(key, layers +
blocks + 2)` in build order (the stem, then each layer and each
transition), the classifier's last; a layer splits its key into two
(conv1, conv2). No grouped forward: the engine takes the vmapped honest
phase.
"""

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import (
    BatchNorm, Dense, PaddedConv, global_avg_pool, max_pool_3x3s2p1)

__all__ = ["DenseNet", "transition_pool"]

_GROWTH = 32
_BN_SIZE = 4
_BLOCKS = {"densenet121": (6, 12, 24, 16),
           "densenet169": (6, 12, 32, 32),
           "densenet201": (6, 12, 48, 32)}


def _init_fan_in(conv, key):
    kh, kw, cin, _ = conv.w.shape
    conv.init_normal(key, math.sqrt(2.0 / (kh * kw * cin)))


def transition_pool(x):
    """The transition's 2x2 stride-2 window sum over 4.0 (the JAX
    `reduce_window(add) / 4.0`)."""
    return F.avg_pool2d(x, 2, divisor_override=1) / 4.0


class _Layer(nn.Module):
    """bn1 relu conv1x1(cin, 128) bn2 relu conv3x3(128, 32)."""

    def __init__(self, cin, like):
        super().__init__()
        self.bn1 = BatchNorm(cin, **like)
        self.conv1 = PaddedConv(cin, _BN_SIZE * _GROWTH, 1, **like)
        self.bn2 = BatchNorm(_BN_SIZE * _GROWTH, **like)
        self.conv2 = PaddedConv(_BN_SIZE * _GROWTH, _GROWTH, 3, pad=1, **like)

    def init(self, key):
        k1, k2 = prng.split(key)
        _init_fan_in(self.conv1, k1)
        _init_fan_in(self.conv2, k2)
        self.bn1.init()
        self.bn2.init()

    def forward(self, x, train, name, new_state):
        out, new_state[f"{name}.bn1"] = self.bn1(x, train)
        out, new_state[f"{name}.bn2"] = self.bn2(
            self.conv1(torch.relu(out)), train)
        return self.conv2(torch.relu(out))


class _Transition(nn.Module):
    """bn relu conv1x1(c, c // 2), the 2x2 window mean."""

    def __init__(self, c, like):
        super().__init__()
        self.bn = BatchNorm(c, **like)
        self.conv = PaddedConv(c, c // 2, 1, **like)

    def init(self, key):
        self.bn.init()
        _init_fan_in(self.conv, key)

    def forward(self, x, train, name, new_state):
        x, new_state[f"{name}.bn"] = self.bn(x, train)
        return transition_pool(self.conv(torch.relu(x)))


class DenseNet(nn.Module):
    input_shape = (32, 32, 3)

    def __init__(self, arch="densenet121", num_classes=10, device=None,
                 dtype=None, **unused):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.stem = PaddedConv(3, 64, 7, 2, 3, **like)
        self.bn0 = BatchNorm(64, **like)
        self.stages = []  # (name, module) in build (and key) order
        blocks = _BLOCKS[arch]
        c = 64
        for b, n_layers in enumerate(blocks):
            for i in range(n_layers):
                self._add(f"b{b}l{i}", _Layer(c, like))
                c += _GROWTH
            if b < len(blocks) - 1:
                self._add(f"t{b}", _Transition(c, like))
                c //= 2
        self.bn5 = BatchNorm(c, **like)
        self.fc = Dense(c, num_classes, **like)

    def _add(self, name, module):
        self.add_module(name, module)
        self.stages.append((name, module))

    @torch.no_grad()
    def init(self, key):
        """The JAX model's `init(key)`: `split(key, layers + blocks + 2)`
        (one key more than it uses), key 0 the stem, then one key a layer
        or transition in build order, the next the classifier's weight,
        U(+-1/sqrt(din)) from that key itself; its bias 0; fresh
        BatchNorm."""
        keys = prng.split(key, len(self.stages) + 3)
        _init_fan_in(self.stem, keys[0])
        self.bn0.init()
        for stage_key, (_, stage) in zip(keys[1:], self.stages):
            stage.init(stage_key)
        self.bn5.init()
        bound = 1.0 / math.sqrt(self.fc.w.shape[0])
        self.fc.w.copy_(prng.uniform(keys[len(self.stages) + 1].to(self.fc.w.device),
                                     self.fc.w.shape, torch.float32, -bound,
                                     bound))
        self.fc.b.zero_()

    def draw_masks(self, wkeys, batch):
        return ()

    def forward(self, x, train=False, masks=None):
        """`x: [B, 32, 32, 3]` (NHWC) -> `(logits [B, classes], new BN
        state)`."""
        new_state = {}
        x, new_state["bn0"] = self.bn0(self.stem(x.permute(0, 3, 1, 2)), train)
        x = max_pool_3x3s2p1(torch.relu(x))
        for name, stage in self.stages:
            if isinstance(stage, _Layer):
                x = torch.cat([x, stage(x, train, name, new_state)], dim=1)
            else:
                x = stage(x, train, name, new_state)
        x, new_state["bn5"] = self.bn5(x, train)
        return self.fc(global_avg_pool(torch.relu(x))), new_state


for _arch in _BLOCKS:
    register(_arch, functools.partial(DenseNet, _arch))
