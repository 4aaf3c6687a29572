"""Mimicry attack (`byzantinemomentum_tpu/attacks/mimic.py`): every
Byzantine row copies honest worker `victim`'s row, so no GAR can reject
it on geometry; `jitter` (a fraction of the honest std, as in `alie`)
blurs the copies.
"""

from byzantinemomentum_tpu_torch.attacks import alie, empty_byzantine, register

__all__ = ["attack"]


def attack(grad_honests, f_decl, f_real, defense, victim=0, jitter=0.0,
           **kwargs):
    """f_real copies of honest row `victim` (optionally jittered)."""
    if f_real == 0:
        return empty_byzantine(grad_honests)
    rows = grad_honests[victim][None, :].expand(f_real, -1).clone()
    if not jitter:
        return rows
    return alie.jittered(rows, grad_honests, alie.honest_std(grad_honests),
                         jitter)


def check(grad_honests, f_real, defense, victim=0, jitter=0.0, **kwargs):
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return (f"Expected a non-negative number of Byzantine gradients "
                f"to generate, got {f_real!r}")
    if not isinstance(victim, int) or not (
            0 <= victim < grad_honests.shape[0]):
        return (f"Expected a victim index within the "
                f"{grad_honests.shape[0]} honest rows, got {victim!r}")
    if not isinstance(jitter, (int, float)) or jitter < 0:
        return f"Expected a non-negative jitter fraction, got {jitter!r}"


register("mimic", attack, check)
