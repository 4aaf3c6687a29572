"""`resnet18/34/50/101/152`: torchvision's ResNets
(`byzantinemomentum_tpu/models/resnet.py`; the reference resolves every
`torchvision.models` name through its driver, `experiments/model.py:40-90`).

Architecture: conv7x7(3, 64, stride 2, pad 3, no bias) bn relu, the 3x3
stride-2 pad-1 max pool, four stages of blocks at base widths 64, 128,
256, 512 (the first block of stages 2-4 at stride 2, with a 1x1
projection `down` and its BatchNorm `dbn` wherever the stride or the
width changes), the global average pool and `fc`. BasicBlock (resnet18
[2, 2, 2, 2], resnet34 [3, 4, 6, 3]): conv3x3 bn relu conv3x3 bn, plus the
shortcut, relu. Bottleneck, torchvision v1.5 with the stride on the 3x3
(resnet50 [3, 4, 6, 3], resnet101 [3, 4, 23, 3], resnet152 [3, 8, 36, 3]):
conv1x1 bn relu conv3x3 bn relu conv1x1 (4 x the width) bn, plus the
shortcut, relu. Every convolution pads symmetrically (torch's `padding`,
as the JAX module pads), so no XLA SAME arithmetic enters here.

The model returns raw logits, as the JAX model does (no log-softmax):
pair it with `--loss crossentropy`.

Init: kaiming-normal (fan_out, relu gain) bias-free kernels,
`std * normal(key)` with std = sqrt(2 / (kh kw cout)); fresh BatchNorm;
`fc` as `dense_init`. Keys: `split(key, n_blocks + 2)`, key 0 the stem,
key 1 + i block i, the last `fc`; a block splits its key into 3 (basic:
conv1, conv2, down) or 4 (bottleneck: conv1, conv2, conv3, down).

Module names are the JAX model's keys (`stem`, `bn`, `s{s}b{b}.{conv1,
bn1, ..., down, dbn}`, `fc`), so `FlatParams` gives `ravel_pytree`'s
order. Inputs arrive NHWC and are permuted to NCHW. The model has no
grouped forward (the JAX model has no `apply_grouped`), so the engine
takes the vmapped honest phase.
"""

import functools
import math

import torch
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import (
    BatchNorm, Dense, PaddedConv, global_avg_pool, max_pool_3x3s2p1)

__all__ = ["ResNet", "kaiming_fan_out_std"]

_STAGES = (64, 128, 256, 512)
_LAYOUTS = {"resnet18": ((2, 2, 2, 2), False),
            "resnet34": ((3, 4, 6, 3), False),
            "resnet50": ((3, 4, 6, 3), True),
            "resnet101": ((3, 4, 23, 3), True),
            "resnet152": ((3, 8, 36, 3), True)}


def kaiming_fan_out_std(conv):
    """sqrt(2 / fan_out) of a `PaddedConv`, fan_out = kh kw cout."""
    kh, kw, _, cout = conv.w.shape
    return math.sqrt(2.0 / (kh * kw * cout))


class _Block(nn.Module):
    """A BasicBlock (`bottleneck` False: convs 3x3, 3x3) or a v1.5
    Bottleneck (1x1, 3x3 at the stride, 1x1 to 4 x `width`), with the
    projection `down`/`dbn` where `downsample`."""

    def __init__(self, cin, width, stride, downsample, bottleneck, like):
        super().__init__()
        self.bottleneck = bottleneck
        if bottleneck:
            cout = 4 * width
            self.conv1 = PaddedConv(cin, width, 1, **like)
            self.conv2 = PaddedConv(width, width, 3, stride, 1, **like)
            self.conv3 = PaddedConv(width, cout, 1, **like)
            self.bn3 = BatchNorm(cout, **like)
        else:
            cout = width
            self.conv1 = PaddedConv(cin, width, 3, stride, 1, **like)
            self.conv2 = PaddedConv(width, width, 3, 1, 1, **like)
        self.bn1 = BatchNorm(width, **like)
        self.bn2 = BatchNorm(width, **like)
        if downsample:
            self.down = PaddedConv(cin, cout, 1, stride, **like)
            self.dbn = BatchNorm(cout, **like)
        else:
            self.down = self.dbn = None

    def convs(self):
        """The convolutions in the order of their keys."""
        convs = [self.conv1, self.conv2]
        if self.bottleneck:
            convs.append(self.conv3)
        return convs

    def init(self, key):
        """`_block_init` / `_bottleneck_init`: the convolutions from
        `split(key, 3 or 4)`, the projection from the last key."""
        convs = self.convs()
        keys = prng.split(key, len(convs) + 1)
        for conv, conv_key in zip(convs, keys):
            conv.init_normal(conv_key, kaiming_fan_out_std(conv))
        if self.down is not None:
            self.down.init_normal(keys[-1], kaiming_fan_out_std(self.down))
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.init()

    def forward(self, x, train, name, new_state):
        out = x
        bns = [("bn1", self.bn1), ("bn2", self.bn2)]
        if self.bottleneck:
            bns.append(("bn3", self.bn3))
        for i, (conv, (bn_name, bn)) in enumerate(zip(self.convs(), bns)):
            out, new_state[f"{name}.{bn_name}"] = bn(conv(out), train)
            if i < len(bns) - 1:
                out = torch.relu(out)
        if self.down is not None:
            x, new_state[f"{name}.dbn"] = self.dbn(self.down(x), train)
        return torch.relu(out + x)


class ResNet(nn.Module):
    input_shape = (32, 32, 3)

    def __init__(self, arch="resnet18", num_classes=10, device=None,
                 dtype=None, **unused):
        super().__init__()
        blocks, bottleneck = _LAYOUTS[arch]
        like = {"device": device, "dtype": dtype}
        expansion = 4 if bottleneck else 1
        self.stem = PaddedConv(3, 64, 7, 2, 3, **like)
        self.bn = BatchNorm(64, **like)
        self.blocks = []
        cin = 64
        for s, width in enumerate(_STAGES):
            cout = width * expansion
            for b in range(blocks[s]):
                stride = 2 if (s > 0 and b == 0) else 1
                downsample = b == 0 and (s > 0 or cin != cout)
                name = f"s{s}b{b}"
                block = _Block(cin, width, stride, downsample, bottleneck,
                               like)
                self.add_module(name, block)
                self.blocks.append((name, block))
                cin = cout
        self.fc = Dense(512 * expansion, num_classes, **like)

    def init(self, key):
        """The JAX model's `init(key)`: `split(key, n_blocks + 2)`, key 0
        the stem, key 1 + i block i, the last `fc`; fresh BatchNorm."""
        keys = prng.split(key, len(self.blocks) + 2)
        self.stem.init_normal(keys[0], kaiming_fan_out_std(self.stem))
        self.bn.init()
        for i, (_, block) in enumerate(self.blocks):
            block.init(keys[1 + i])
        self.fc.init(keys[len(self.blocks) + 1])

    def draw_masks(self, wkeys, batch):
        return ()

    def forward(self, x, train=False, masks=None):
        """`x: [B, 32, 32, 3]` (NHWC) -> `(logits [B, classes], new BN
        state {"bn": {"mean", "var"}, "s0b0.bn1": ..., ...})`."""
        new_state = {}
        x, new_state["bn"] = self.bn(self.stem(x.permute(0, 3, 1, 2)), train)
        x = max_pool_3x3s2p1(torch.relu(x))
        for name, block in self.blocks:
            x = block(x, train, name, new_state)
        return self.fc(global_avg_pool(x)), new_state


for _arch in _LAYOUTS:
    register(_arch, functools.partial(ResNet, _arch))
