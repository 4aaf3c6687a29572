"""Gradient aggregation rules (GARs) over the stacked gradient matrix.

Every GAR is a function over `G: [n, d]` (one row per worker, in the
parameter dtype) with a Byzantine tolerance `f`, returning the aggregate
`[d]` — the contract of `byzantinemomentum_tpu/ops/__init__.py`. Each registered GAR exposes
`.checked`, `.unchecked`, `.check`, `.upper_bound` (the variance-norm
ratio bound the study reads) and `.influence` (attack acceptation ratio,
None where the rule has none). Modules in this directory self-register.
"""

import pathlib

import torch

from byzantinemomentum_tpu_torch import utils

__all__ = ["gars", "register", "GAR", "as_matrix"]

gars = {}


def as_matrix(gradients):
    """Coerce a list of flat gradients or an (n, d) tensor into an (n, d)
    matrix."""
    if isinstance(gradients, (list, tuple)):
        return torch.stack(gradients)
    if gradients.dim() != 2:
        raise utils.UserException(
            f"Expected an (n, d) gradient matrix or a list of flat "
            f"gradients, got shape {tuple(gradients.shape)}")
    return gradients


class GAR:
    """A registered gradient aggregation rule; calling it runs the checked
    path."""

    def __init__(self, name, unchecked, check, upper_bound=None,
                 influence=None):
        self.name = name
        self.unchecked = unchecked
        self.check = check
        self.upper_bound = upper_bound
        self.influence = influence

    def checked(self, gradients, **kwargs):
        gradients = as_matrix(gradients)
        message = self.check(gradients=gradients, **kwargs)
        if message is not None:
            raise utils.UserException(
                f"Aggregation rule {self.name!r} cannot be used: {message}")
        result = self.unchecked(gradients, **kwargs)
        if result.shape != gradients.shape[1:]:
            raise utils.UserException(
                f"Aggregation rule {self.name!r} returned shape "
                f"{tuple(result.shape)}, expected {tuple(gradients.shape[1:])}")
        return result

    def __call__(self, gradients, **kwargs):
        return self.checked(gradients, **kwargs)

    def __repr__(self):
        return f"GAR({self.name!r})"


def register(name, unchecked, check, upper_bound=None, influence=None):
    """Register a GAR under `name`; returns the GAR object."""
    if name in gars:
        utils.warning(f"Aggregation rule {name!r} registered twice; keeping the last")
    gar = GAR(name, unchecked, check, upper_bound=upper_bound,
              influence=influence)
    gars[name] = gar
    return gar


utils.import_directory(__name__, pathlib.Path(__file__).parent)
