"""Model registry and the flat parameter space
(`byzantinemomentum_tpu/models/__init__.py`).

A model is an `nn.Module` whose parameters keep the JAX package's layouts,
whose `init(key)` draws the JAX model's `init(key)` parameters bit for
bit (`models/core.py`), whose `draw_masks(wkeys, batch)` gives S workers'
dropout keep-masks from their keys, and whose
`forward(x, train=..., masks=...)` returns `(outputs, new BatchNorm
state)` without writing its buffers: the outputs are what the JAX model's
`apply` returns, log-probabilities (`simples-*`, `empire-cnn`,
`wide_resnet`, the transformer) or raw logits (the torchvision families
`resnet*`, `vgg*`, `densenet*`, `mobilenet_v2`, which pair with `--loss
crossentropy`).
The engine runs it through `torch.func.functional_call` on views of ONE
flat parameter vector, as the JAX package runs `apply` on
`ravel_pytree(params)`.

The flat order is `jax.flatten_util.ravel_pytree`'s: names compared
component by component (`b1.beta < b1.gamma < ... < c1.b < c1.w < f1.b`;
`flat_key`), dict keys as strings and the index of a list leaf (an
`nn.ModuleList`, the transformer's `blocks.10`) as an integer, each leaf
flattened row-major — so a gradient row of the port and of the JAX
package compare coordinate for coordinate.

A model may also have a merged-batch forward over S workers
(`forward_grouped`, the JAX package's `ModelDef.apply_grouped`);
`grouped_forward` tells the engine which do.
"""

import pathlib

import torch

from byzantinemomentum_tpu_torch import utils

__all__ = ["models", "register", "build", "grouped_forward", "flat_key",
           "FlatParams"]

models = {}


def register(name, builder):
    """Register a model builder `(device=..., dtype=..., **model_args) ->
    nn.Module`."""
    if name in models:
        utils.warning(f"Model {name!r} registered twice; keeping the last")
    models[name] = builder
    return builder


def build(name, device, dtype=None, **model_args):
    """Instantiate a model by registry name on `device`, its parameters
    and buffers in `dtype` (torch's default dtype if None)."""
    if name not in models:
        utils.fatal_unavailable(models, name, what="model name")
    return models[name](device=device, dtype=dtype, **model_args)


def grouped_forward(module):
    """The model's merged-batch forward over S workers
    (`forward_grouped(params_s, state, xs, train, masks, shared)`), or
    None where it has none."""
    return getattr(module, "forward_grouped", None)


def flat_key(name):
    """The sort key of a dotted parameter name in `ravel_pytree`'s order:
    a component of digits (a list index) compares as an integer, any
    other (a dict key) as a string, so `blocks.2 < blocks.10` as JAX
    orders a list and `s0b10 < s0b2` as it orders dict keys."""
    return tuple((0, int(part), "") if part.isdigit() else (1, 0, part)
                 for part in name.split("."))


class FlatParams:
    """The flat parameter space of a module: `flatten` concatenates its
    parameters in `ravel_pytree` order, `unflatten` gives back the named
    views `functional_call` takes."""

    def __init__(self, module):
        named = dict(module.named_parameters())
        self.names = sorted(named, key=flat_key)
        self.shapes = [tuple(named[name].shape) for name in self.names]
        self.sizes = [named[name].numel() for name in self.names]
        self.d = sum(self.sizes)

    def flatten(self, params):
        """`{name: tensor}` (or a module's parameters) -> [d]."""
        return torch.cat([params[name].reshape(-1) for name in self.names])

    def unflatten(self, theta):
        """[d] -> `{name: view}` (in theta's dtype)."""
        chunks = torch.split(theta, self.sizes)
        return {name: chunk.view(shape) for name, chunk, shape
                in zip(self.names, chunks, self.shapes)}

    def unflatten_stacked(self, theta_s):
        """[S, d] -> `{name: (S, ...) view}` (no copies)."""
        S = theta_s.shape[0]
        chunks = torch.split(theta_s, self.sizes, dim=1)
        return {name: chunk.view(S, *shape) for name, chunk, shape
                in zip(self.names, chunks, self.shapes)}


utils.import_directory(__name__, pathlib.Path(__file__).parent)
