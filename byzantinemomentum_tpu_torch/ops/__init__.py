"""Gradient aggregation rules (GARs) over the stacked gradient matrix.

Every GAR is a function over `G: [n, d]` (one row per worker, in the
parameter dtype) with a Byzantine tolerance `f`, returning the aggregate
`[d]` — the contract of `byzantinemomentum_tpu/ops/__init__.py`. Each registered GAR exposes
`.checked`, `.unchecked`, `.check`, `.upper_bound` (the variance-norm
ratio bound the study reads) and `.influence` (attack acceptation ratio,
None where the rule has none). Modules in this directory self-register.

`gar.diagnosed(G, **kwargs)` returns `(aggregate, aux)`, the aux in the
one schema of `ops/diag.py`: the rule's own `diagnose` form, or for a
rule without one (`average`) `_generic_diagnose`. Every diagnose form
computes its aggregate with the plain form's kernels and operands, so
the aggregate is the plain one bit for bit. `gar.checked(G,
diagnostics=True)` checks and returns that pair; the default call runs
`.unchecked` alone and never reaches `ops/diag.py`.
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
                 influence=None, diagnose=None):
        self.name = name
        self.unchecked = unchecked
        self.check = check
        self.upper_bound = upper_bound
        self.influence = influence
        self.diagnose = diagnose

    def checked(self, gradients, *, diagnostics=False, **kwargs):
        gradients = as_matrix(gradients)
        message = self.check(gradients=gradients, **kwargs)
        if message is not None:
            raise utils.UserException(
                f"Aggregation rule {self.name!r} cannot be used: {message}")
        if diagnostics:
            result, aux = self.diagnosed(gradients, **kwargs)
        else:
            result = self.unchecked(gradients, **kwargs)
        if result.shape != gradients.shape[1:]:
            raise utils.UserException(
                f"Aggregation rule {self.name!r} returned shape "
                f"{tuple(result.shape)}, expected {tuple(gradients.shape[1:])}")
        return (result, aux) if diagnostics else result

    def diagnosed(self, gradients, **kwargs):
        """`(G, **kwargs) -> (aggregate, aux)`: the rule's diagnose form,
        or `_generic_diagnose` around `.unchecked`."""
        if self.diagnose is not None:
            return self.diagnose(gradients, **kwargs)
        return _generic_diagnose(self.unchecked, gradients, **kwargs)

    def __call__(self, gradients, **kwargs):
        return self.checked(gradients, **kwargs)

    def __repr__(self):
        return f"GAR({self.name!r})"


def _generic_diagnose(unchecked, gradients, **kwargs):
    """The diagnostics of a rule without a diagnose form: its aggregate,
    the distance geometry, each worker's distance to the aggregate as its
    score, and a selection of all ones."""
    from byzantinemomentum_tpu_torch.ops import _common, diag

    n = gradients.shape[0]
    result = unchecked(gradients, **kwargs)
    dist = _common.pairwise_distances(gradients)
    dev = gradients - result[None, :]
    scores = _common.sanitize_inf(torch.sqrt(torch.sum(dev * dev, dim=1)))
    return result, diag.make_aux(
        n, scores=scores, dist=dist,
        selection=torch.ones((n,), dtype=torch.float32,
                             device=gradients.device))


def register(name, unchecked, check, upper_bound=None, influence=None,
             diagnose=None):
    """Register a GAR under `name` (`diagnose`: its `(G, **kwargs) ->
    (aggregate, aux)` form, if it has one); returns the GAR object."""
    if name in gars:
        utils.warning(f"Aggregation rule {name!r} registered twice; keeping the last")
    gar = GAR(name, unchecked, check, upper_bound=upper_bound,
              influence=influence, diagnose=diagnose)
    gars[name] = gar
    return gar


utils.import_directory(__name__, pathlib.Path(__file__).parent)
