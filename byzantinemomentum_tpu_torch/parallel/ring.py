"""Attention (`byzantinemomentum_tpu/parallel/ring.py`): `dense_attention`,
the single-device softmax attention of the transformer's
`attn_impl="dense"`. `ring_attention` and `ulysses_attention` run over a
mesh's sequence axis, which the port does not have yet.
"""

import torch

__all__ = ["dense_attention"]

_NEG = -1e30  # the large negative a masked score takes (no -inf NaN)


def dense_attention(q, k, v, *, causal=True, key_mask=None):
    """Softmax attention of `[B, H, L, Dh]` queries, keys and values, as
    the JAX `dense_attention`: the scores `einsum(q, k) / sqrt(float32(dh))`
    (a division, promoting a half q to float32), query i masked from key
    j > i where `causal`, keys where `key_mask` (bool[Lk]) is False
    masked; the softmax in float32 (or q's wider dtype); the output cast
    back to q's dtype."""
    wide = torch.promote_types(q.dtype, torch.float32)
    dh = torch.tensor(q.shape[-1], dtype=torch.float32, device=q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(wide) / torch.sqrt(dh)
    if causal:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, _NEG)
    if key_mask is not None:
        scores = torch.where(key_mask[None, None, None, :], scores, _NEG)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v.to(wide)).to(q.dtype)
