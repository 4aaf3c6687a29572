"""ALIE, "A Little Is Enough" with an explicit z-margin
(`byzantinemomentum_tpu/attacks/alie.py`; Baruch, Baruch, Goldberg,
NeurIPS 2019).

The Byzantine rows sit at `mean + z * std` of the honest rows,
coordinate-wise, inside the honest variance envelope. The margin is the
paper's closed form (`zmax`), host math on (n, f), so the attack calls
the defense no time; `z` overrides it. `jitter` adds per-row noise, a
fraction of the honest std, drawn from a key that hashes the honest rows'
content (`row_key`), as the JAX package draws it (`prng.py`).
"""

import statistics

import torch

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.attacks import empty_byzantine, register

__all__ = ["attack", "zmax", "row_key", "honest_std", "jittered"]

# The hash's multiplier (Knuth's) and the noise's base key
_HASH_MULT = 2654435761
_JITTER_SEED = 0xA11E


def zmax(n, f):
    """The paper's margin for n workers, f of them Byzantine:
    `Phi^-1((n - f - s) / (n - f))` with `s = n // 2 + 1 - f` honest
    supporters needed, clamped to [0.5, 1 - 1e-6] before the inverse;
    0 where the attackers are the majority (s <= 0)."""
    s = n // 2 + 1 - f
    if s <= 0:
        return 0.0
    denom = max(n - f, 1)
    q = min(max((n - f - s) / denom, 0.5), 1.0 - 1e-6)
    return statistics.NormalDist().inv_cdf(q)


def row_key(grad_honests):
    """The noise key of the JAX package's `_row_key`: every element's
    float32 bits times `(i * 2654435761) | 1` (i its flat index), summed,
    all modulo 2^32, folded into `PRNGKey(0xA11E)`; on the rows' device."""
    bits = grad_honests.to(torch.float32).view(torch.int32).to(torch.int64) & prng.MASK32
    index = torch.arange(bits.numel(), dtype=torch.int64,
                         device=bits.device).view(bits.shape)
    mult = prng.mul32(index & prng.MASK32, _HASH_MULT) | 1
    digest = prng.wrapping_sum32(prng.mul32(bits, mult))
    return prng.fold_in(prng.PRNGKey(_JITTER_SEED, device=bits.device), digest)


def honest_std(grad_honests):
    """Coordinate-wise sample std (ddof 1); zeros for a single row."""
    if grad_honests.shape[0] > 1:
        return torch.sqrt(torch.var(grad_honests, dim=0, correction=1))
    return torch.zeros_like(grad_honests[0])


def jittered(rows, grad_honests, sigma, jitter):
    """`rows + jitter * sigma * noise`, the noise standard normal from
    `row_key(grad_honests)` in the rows' dtype; the rows unchanged without
    jitter."""
    if not jitter:
        return rows
    noise = prng.normal(row_key(grad_honests), tuple(rows.shape), rows.dtype)
    return rows + float(jitter) * sigma[None, :] * noise


def attack(grad_honests, f_decl, f_real, defense, z=None, jitter=0.0,
           **kwargs):
    """f_real rows at `mean + z * std` (z = `zmax(h + f_real, f_decl)` by
    default), jittered."""
    if f_real == 0:
        return empty_byzantine(grad_honests)
    h = grad_honests.shape[0]
    mu = torch.mean(grad_honests, dim=0)
    sigma = honest_std(grad_honests)
    z_eff = zmax(h + f_real, f_decl) if z is None else float(z)
    rows = (mu + z_eff * sigma)[None, :].expand(f_real, -1).clone()
    return jittered(rows, grad_honests, sigma, jitter)


def check(grad_honests, f_real, defense, z=None, jitter=0.0, **kwargs):
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return (f"Expected a non-negative number of Byzantine gradients to "
                f"generate, got {f_real!r}")
    if z is not None and not isinstance(z, (int, float)):
        return f"Expected a number for the z-margin, got {z!r}"
    if not isinstance(jitter, (int, float)) or jitter < 0:
        return f"Expected a non-negative jitter fraction, got {jitter!r}"


register("alie", attack, check)
