"""Framing attack (`byzantinemomentum_tpu/attacks/framing.py`): the rows
try to make an honest `victim` look like the outlier.

They sit in a tight cluster at the mean of the honest rows without the
victim, pushed `push` further away from the victim's row; `jitter` (a
fraction of the honest std, as in `alie`) blurs the cluster.
"""

from byzantinemomentum_tpu_torch.attacks import alie, empty_byzantine, register

__all__ = ["attack"]


def attack(grad_honests, f_decl, f_real, defense, victim=0, push=1.0,
           jitter=0.0, **kwargs):
    """f_real rows at mean(honests \\ victim) + push * (that mean -
    victim's row)."""
    if f_real == 0:
        return empty_byzantine(grad_honests)
    h = grad_honests.shape[0]
    g_victim = grad_honests[victim]
    others = (grad_honests.sum(dim=0) - g_victim) / max(h - 1, 1)
    byz = others + float(push) * (others - g_victim)
    rows = byz[None, :].expand(f_real, -1).clone()
    if not jitter:
        return rows
    return alie.jittered(rows, grad_honests, alie.honest_std(grad_honests),
                         jitter)


def check(grad_honests, f_real, defense, victim=0, push=1.0, jitter=0.0,
          **kwargs):
    if grad_honests.shape[0] == 0:
        return "Expected a non-empty list of honest gradients"
    if not isinstance(f_real, int) or f_real < 0:
        return (f"Expected a non-negative number of Byzantine gradients to "
                f"generate, got {f_real!r}")
    if not isinstance(victim, int) or not (
            0 <= victim < grad_honests.shape[0]):
        return (f"Expected a victim index within the {grad_honests.shape[0]} "
                f"honest rows, got {victim!r}")
    if not isinstance(push, (int, float)) or push < 0:
        return f"Expected a non-negative push factor, got {push!r}"


register("framing", attack, check)
