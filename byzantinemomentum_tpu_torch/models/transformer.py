"""The transformer classifier: `transformer-classifier`, also `transformer`
(`byzantinemomentum_tpu/models/transformer.py`), with `attn_impl="dense"`.

Images tokenize as rows, `(B, H, W, C) -> (B, L = H, W C)` (MNIST: 28
tokens of 28); then the embedding plus the positional table `pos`, a
pre-LN encoder of `depth` blocks (`ln1`, `qkv`, dense softmax attention
over `heads` heads, `proj`, residual; `ln2`, `fc1`, the tanh GELU,
`fc2`, residual), `ln_f`, the mean over the tokens, `head` and the
log-softmax (so `nll` applies).

LayerNorm is written out as the JAX `_ln_apply`: the mean of the squared
deviation, then `rsqrt(var + eps)`; `jax.nn.gelu` is the tanh
approximation. The attention is `parallel/ring.py::dense_attention`.
`attn_impl="ring"` and `"ulysses"` shard the sequence over a mesh's
`seq_axis`, which the port does not have: they raise.

Parameters: `blocks` is a list in the JAX model (`"blocks": [...]`), an
`nn.ModuleList` here, so a block's names carry its index (`blocks.10.qkv.w`)
and `models.flat_key` orders them as `ravel_pytree` orders the list.
Init: `split(key, 2 + 4 depth + 1)`: key 0 `embed`, key 1 `pos` (0.02
normal), keys 2 + 4 i .. 5 + 4 i block i's `qkv`, `proj`, `fc1`, `fc2`
(`dense_init`), the last `head`; LayerNorms g = 1, b = 0. No BatchNorm,
no dropout, no grouped forward (the engine takes the vmapped honest
phase).
"""

import torch
import torch.nn.functional as F
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.models import register
from byzantinemomentum_tpu_torch.models.core import Dense, log_softmax
from byzantinemomentum_tpu_torch.parallel.ring import dense_attention
from byzantinemomentum_tpu_torch.utils import weak_scalar

__all__ = ["Transformer", "LayerNorm"]


class LayerNorm(nn.Module):
    """The JAX `_ln_apply` over the last axis: gain `g`, bias `b`."""

    def __init__(self, dim, device=None, dtype=None):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.g = nn.Parameter(torch.ones((dim,), **like))
        self.b = nn.Parameter(torch.zeros((dim,), **like))

    @torch.no_grad()
    def init(self):
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x, eps=1e-5):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * self.g + self.b


class _Block(nn.Module):
    def __init__(self, dim, hidden, like):
        super().__init__()
        self.ln1 = LayerNorm(dim, **like)
        self.ln2 = LayerNorm(dim, **like)
        self.qkv = Dense(dim, 3 * dim, **like)
        self.proj = Dense(dim, dim, **like)
        self.fc1 = Dense(dim, hidden, **like)
        self.fc2 = Dense(hidden, dim, **like)

    def init(self, keys):
        for dense, key in zip((self.qkv, self.proj, self.fc1, self.fc2), keys):
            dense.init(key)
        self.ln1.init()
        self.ln2.init()

    def forward(self, x, heads, causal):
        b, lc, dim = x.shape
        q, k, v = (t.reshape(b, lc, heads, dim // heads).transpose(1, 2)
                   for t in self.qkv(self.ln1(x)).chunk(3, dim=-1))
        y = dense_attention(q, k, v, causal=causal).transpose(1, 2)
        x = x + self.proj(y.reshape(b, lc, dim))
        y = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(y)


class Transformer(nn.Module):
    def __init__(self, depth=2, dim=64, heads=4, mlp_ratio=4, num_classes=10,
                 input_shape=(28, 28, 1), causal=False, attn_impl="dense",
                 seq_axis="seq", device=None, dtype=None, **unused):
        super().__init__()
        if attn_impl not in ("dense", "ring", "ulysses"):
            raise ValueError(f"Unknown attention implementation {attn_impl!r}")
        if attn_impl != "dense":
            raise ValueError(
                f"attn_impl={attn_impl!r} shards the sequence over the mesh "
                f"axis {seq_axis!r}; the port has no mesh yet (only "
                f"attn_impl='dense' runs)")
        if dim % heads != 0:
            raise ValueError(f"dim={dim} not divisible by heads={heads}")
        like = {"device": device, "dtype": dtype}
        h_img, w_img, c_img = input_shape
        self.input_shape = tuple(input_shape)
        self.heads, self.causal = heads, causal
        self.embed = Dense(w_img * c_img, dim, **like)
        self.pos = nn.Parameter(torch.empty((h_img, dim), **like))
        self.blocks = nn.ModuleList(_Block(dim, mlp_ratio * dim, like)
                                    for _ in range(depth))
        self.ln_f = LayerNorm(dim, **like)
        self.head = Dense(dim, num_classes, **like)

    @torch.no_grad()
    def init(self, key):
        """The JAX model's `init(key)` (the module docstring's keys)."""
        keys = prng.split(key, 2 + 4 * len(self.blocks) + 1)
        self.embed.init(keys[0])
        self.pos.copy_(weak_scalar(0.02, torch.float32) * prng.normal(
            keys[1].to(self.pos.device), self.pos.shape))
        self.head.init(keys[-1])
        self.ln_f.init()
        for i, block in enumerate(self.blocks):
            block.init(keys[2 + 4 * i: 6 + 4 * i])

    def draw_masks(self, wkeys, batch):
        return ()

    def forward(self, x, train=False, masks=None):
        """`x: [B, H, W, C]` -> `(log-probabilities [B, classes], {})`."""
        b, lc = x.shape[0], x.shape[1]
        x = self.embed(x.reshape(b, lc, -1)) + self.pos[:lc][None]
        for block in self.blocks:
            x = block(x, self.heads, self.causal)
        # The mean over the tokens as JAX takes it: a sum, then / lc
        pooled = self.ln_f(x).sum(dim=1) / lc
        return log_softmax(self.head(pooled)), {}


register("transformer-classifier", Transformer)
register("transformer", Transformer)
