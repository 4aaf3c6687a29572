"""Conversion from the JAX package's parameter and BatchNorm-state pytrees
(given as nested dicts of numpy arrays) to the port's flat parameter
vector and buffer dict, so both packages can be run on the same weights.

Leaf layouts are shared (HWIO kernels, (din, dout) dense weights), so the
conversion only orders the leaves as `ravel_pytree` does: nested dict keys
sorted at every level, list items (the transformer's `blocks`) in index
order, named by their index (`blocks.10.qkv.w`, `models.flat_key`).
"""

import numpy as np
import torch

__all__ = ["params_from_jax", "flat_items"]


def flat_items(tree, prefix=""):
    """`(dotted name, leaf)` pairs of nested dicts and lists in
    `ravel_pytree`'s order: a dict's keys sorted, a list's items in index
    order."""
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else ((key, tree[key]) for key in sorted(tree)))
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            yield from flat_items(value, name + ".")
        else:
            yield name, value


def params_from_jax(params_np, net_state_np, device="cpu",
                    dtype=torch.float32):
    """Returns `(theta [d], state {"b1.mean": [C], ...})` on `device` in
    `dtype`: theta in `ravel_pytree` order, state keyed by the port's
    buffer names. Leaves of any float dtype (f32, bf16, f16, f64) are
    carried across through float64, which holds each of them exactly,
    and rounded once to `dtype`."""
    theta = np.concatenate([np.asarray(leaf, np.float64).reshape(-1)
                            for _, leaf in flat_items(params_np)])
    state = {name: torch.tensor(np.asarray(leaf, np.float64),
                                device=device).to(dtype)
             for name, leaf in flat_items(net_state_np)}
    return torch.tensor(theta, device=device).to(dtype), state
