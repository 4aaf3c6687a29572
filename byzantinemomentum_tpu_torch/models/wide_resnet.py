"""Wide ResNet: `wide_resnet-Wide_ResNet`, also `wide-resnet`
(`byzantinemomentum_tpu/models/wide_resnet.py`), as the paper's appendix
grid builds it: `Wide_ResNet(depth, widen_factor, dropout_rate,
num_classes)`, WRN-28-10 at depth 28, widen 10, dropout 0.3.

Pre-activation wide basic blocks: bn1-relu, then the shortcut (identity,
or a 1x1 VALID convolution of the activated input where the stride or the
width changes), conv3x3 (at the block's stride), dropout, bn2-relu,
conv3x3, and the sum; groups of width 16k/32k/64k at strides 1/2/2 after
a 3x3 stem of 16; a final bn-relu, the global average pool and the fc
layer. A strided 3x3 convolution pads as XLA's SAME does
(`models/core.py::same_pads`: 0 before, 1 after on 32 pixels).

Module names are the JAX model's keys (`conv0`, `g{gi}b{bi}.{bn1, bn2,
conv1, conv2, shortcut}`, `bn_out`, `fc`), so `FlatParams` gives
`ravel_pytree`'s order and a gradient row, a GAR input and a checkpoint
compare coordinate for coordinate. Inputs arrive NHWC and are permuted to
NCHW here.

Dropout: one keep-mask after each block's first convolution, 3 *
n_blocks masks a forward (12 at depth 28), mask j of worker s from key j
of `split(wkeys[s], 3 * n_blocks)`, in the JAX shapes `(B, H, W, C)` with
C = 16k/32k/64k at 32/16/8 pixels. The keep rate 0.7 is no 8-bit
threshold, so the masks go through `prng_kernels.bernoulli_masks`.

`forward_grouped` (the JAX model's `apply_grouped`) runs all S workers'
forwards as one merged program on the `models/core.py` grouped layers,
with the workers' weights shared (one convolution over S*B inputs) or
per worker (`groups=S`, the per-worker lookahead of `--momentum-at
worker --momentum-nesterov`); it is the same function as S calls of
`forward`.
"""

import torch
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import (
    BatchNorm, Conv, Dense, dropout_apply, global_avg_pool, grouped_batchnorm,
    grouped_conv, grouped_dense, log_softmax, worker_dropout_masks)

__all__ = ["WideResNet"]

_STRIDES = (1, 2, 2)


class _Block(nn.Module):
    """One pre-activation wide basic block."""

    def __init__(self, cin, cout, stride, like):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(cin, **like)
        self.conv1 = Conv(cin, cout, stride=stride, **like)
        self.bn2 = BatchNorm(cout, **like)
        self.conv2 = Conv(cout, cout, **like)
        self.shortcut = (Conv(cin, cout, k=1, padding="valid", stride=stride,
                              **like)
                         if stride != 1 or cin != cout else None)

    def init(self, key):
        """`_block_init`: conv1, conv2 and the shortcut from
        `prng.split(key, 3)` (the shortcut's key drawn where there is no
        shortcut too); fresh BatchNorm."""
        keys = prng.split(key, 3)
        self.conv1.init(keys[0])
        self.conv2.init(keys[1])
        if self.shortcut is not None:
            self.shortcut.init(keys[2])
        self.bn1.init()
        self.bn2.init()

    def forward(self, x, train, mask, rate, name, new_state):
        out, new_state[f"{name}.bn1"] = self.bn1(x, train)
        out = torch.relu(out)
        shortcut = x if self.shortcut is None else self.shortcut(out)
        out = dropout_apply(mask, self.conv1(out), rate)
        out, new_state[f"{name}.bn2"] = self.bn2(out, train)
        return self.conv2(torch.relu(out)) + shortcut


class WideResNet(nn.Module):
    input_shape = (32, 32, 3)

    def __init__(self, depth=28, widen_factor=10, dropout_rate=0.3,
                 num_classes=10, device=None, dtype=None):
        super().__init__()
        if (depth - 4) % 6 != 0:
            raise ValueError("Wide-ResNet depth must be 6n+4")
        self.n_blocks = (depth - 4) // 6
        self.rate = dropout_rate
        self.widths = (16, 16 * widen_factor, 32 * widen_factor,
                       64 * widen_factor)
        like = {"device": device, "dtype": dtype}
        self.conv0 = Conv(3, self.widths[0], **like)
        cin = self.widths[0]
        self.blocks = []
        for gi, bi, stride in self._layout():
            name = f"g{gi}b{bi}"
            block = _Block(cin, self.widths[gi + 1], stride, like)
            self.add_module(name, block)
            self.blocks.append((name, block))
            cin = self.widths[gi + 1]
        self.bn_out = BatchNorm(self.widths[3], **like)
        self.fc = Dense(self.widths[3], num_classes, **like)

    def _layout(self):
        """`(group, block, stride)` of each block, in forward order."""
        return [(gi, bi, _STRIDES[gi] if bi == 0 else 1)
                for gi in range(3) for bi in range(self.n_blocks)]

    def init(self, key):
        """The JAX model's `init(key)`: `prng.split(key, 3 * n_blocks +
        3)`, key 0 for conv0, key 1 + i for block i, key 3 * n_blocks + 1
        for fc; fresh BatchNorm."""
        keys = prng.split(key, 3 * self.n_blocks + 3)
        self.conv0.init(keys[0])
        for i, (_, block) in enumerate(self.blocks):
            block.init(keys[1 + i])
        self.bn_out.init()
        self.fc.init(keys[3 * self.n_blocks + 1])

    def jax_mask_shapes(self, batch):
        """The dropout keep-masks' shapes in the JAX model (NHWC), one a
        block, in the order their keys are split."""
        shapes, size = [], 32
        for gi, _, stride in self._layout():
            size //= stride
            shapes.append((batch, size, size, self.widths[gi + 1]))
        return tuple(shapes)

    def draw_masks(self, wkeys, batch):
        """The keep-mask stacks `(S, B, C, H, W)` of S workers' train-mode
        forwards over `batch` inputs, as the JAX model draws them: mask j
        of worker s from key j of `split(wkeys[s], 3 * n_blocks)` (at rate
        0 every element is kept, and dropout is the identity, as JAX
        skips it)."""
        return tuple(worker_dropout_masks(wkeys, j, 1.0 - self.rate, shape)
                     for j, shape in enumerate(self.jax_mask_shapes(batch)))

    def forward(self, x, train=False, masks=None):
        """`x: [B, 32, 32, 3]` (NHWC) -> `(log-probabilities, new BN state
        {"g0b0.bn1": {"mean", "var"}, ..., "bn_out": ...})`. Train mode
        needs the keep-masks (`draw_masks`)."""
        if train and masks is None:
            raise ValueError("wide_resnet needs dropout masks in train mode")
        masks = masks if train else (None,) * len(self.blocks)
        new_state = {}
        x = self.conv0(x.permute(0, 3, 1, 2))
        for (name, block), mask in zip(self.blocks, masks):
            x = block(x, train, mask, self.rate, name, new_state)
        x, new_state["bn_out"] = self.bn_out(x, train)
        x = global_avg_pool(torch.relu(x))
        return log_softmax(self.fc(x)), new_state

    def forward_grouped(self, params_s, state, xs, train=False, masks=None,
                        shared=False):
        """All S workers' forwards at once. `params_s` maps each parameter
        name to its `(S, ...)` stack, `state` each buffer name to the
        shared running stat, `xs: [S, B, 32, 32, 3]` (NHWC), `masks` the
        `(S, B, C, H, W)` keep-mask stacks of `draw_masks`; `shared` says
        that every worker's parameters equal worker 0's ->
        `(log-probabilities [S, B, classes], new BN state
        {"g0b0.bn1.mean": (S, C), ...})`; in eval mode the state comes
        back as given."""
        if train and masks is None:
            raise ValueError("wide_resnet needs dropout masks in train mode")
        S, B = xs.shape[:2]
        p = params_s
        new_state = {}

        def conv(x, name, stride=1, padding="same"):
            return grouped_conv(x, p[f"{name}.w"], p[f"{name}.b"], shared,
                                padding, stride)

        def bn_relu(x, name):
            x, stats = grouped_batchnorm(
                x, p[f"{name}.gamma"], p[f"{name}.beta"], state[f"{name}.mean"],
                state[f"{name}.var"], train)
            new_state[f"{name}.mean"], new_state[f"{name}.var"] = (
                stats["mean"], stats["var"])
            return torch.relu(x)

        keep = ([m.flatten(0, 1) for m in masks] if train
                else [None] * len(self.blocks))
        x = conv(xs.flatten(0, 1).permute(0, 3, 1, 2), "conv0")
        for (name, block), mask in zip(self.blocks, keep):
            out = bn_relu(x, f"{name}.bn1")
            shortcut = (x if block.shortcut is None
                        else conv(out, f"{name}.shortcut", block.stride, "valid"))
            out = dropout_apply(mask, conv(out, f"{name}.conv1", block.stride),
                                self.rate)
            out = bn_relu(out, f"{name}.bn2")
            x = conv(out, f"{name}.conv2") + shortcut
        x = global_avg_pool(bn_relu(x, "bn_out")).view(S, B, -1)
        return (log_softmax(grouped_dense(x, p["fc.w"], p["fc.b"], shared)),
                new_state)


register("wide_resnet-Wide_ResNet", WideResNet)
register("wide-resnet", WideResNet)
