"""CGE-targeted attack (`byzantinemomentum_tpu/attacks/anticge.py`).

Exploits CGE's norm sort. When f_real <= f_decl, every Byzantine row is
the negated sum of the would-be-selected honest gradients, scaled to sit
just under the (h - f_decl)-th smallest honest norm, so that CGE selects
it; when f_real > f_decl, a Byzantine row is necessarily selected, so
every row is NaN.

The reference's quirk stays: the sum starts from a copy of the
smallest-norm gradient and then adds it again, so the direction is
`2 g(0) + g(1) + ... + g(h - f_decl - 1)` in norm order (a stable sort of
the norms, non-finite norms as +inf). The target norm is the next float
toward 0, taken in float32 (float64 for a float64 gradient), as the JAX
package's `nextafter(norm, float32(0))` promotes it: under a half dtype
the rows are float32 and the engine casts them back.
"""

import torch

from byzantinemomentum_tpu_torch.attacks import (
    empty_byzantine, register, search_dtype)
from byzantinemomentum_tpu_torch.ops._common import sanitize_inf

__all__ = ["attack"]


def attack(grad_honests, f_decl, f_real, **kwargs):
    """The f_real Byzantine rows (NaN where f_real > f_decl)."""
    if f_real == 0:
        return empty_byzantine(grad_honests)
    d = grad_honests.shape[1]
    if f_real > f_decl:
        return grad_honests.new_full((f_real, d), torch.nan)
    h = grad_honests.shape[0]
    norms = sanitize_inf(torch.sqrt(torch.sum(grad_honests * grad_honests, dim=1)))
    order = torch.argsort(norms, stable=True)
    maxpos = h - f_decl
    dtype = search_dtype(grad_honests)
    # Rows picked with `index_select`: indexing with a 0-d tensor would
    # read it on the host
    target = norms.index_select(0, order[maxpos:maxpos + 1])[0].to(dtype)
    maxnorm = torch.nextafter(target, torch.zeros_like(target))
    vec = (grad_honests.index_select(0, order[:1])[0]
           + torch.sum(grad_honests[order[:maxpos]], dim=0))
    attnorm = torch.sqrt(torch.sum(vec * vec))
    scale = torch.where(attnorm > 0, -maxnorm / attnorm.to(dtype), 1.0)
    byz_grad = vec.to(dtype) * scale
    return byz_grad[None, :].expand(f_real, -1).clone()


def check(grad_honests, f_real, f_decl, **kwargs):
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return f"Expected a non-negative number of Byzantine gradients to generate, got {f_real!r}"


register("anticge", attack, check)
