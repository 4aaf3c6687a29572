"""The placement axis of the step program
(`byzantinemomentum_tpu/engine/program.py::build_step`,
`device_gar_step`).

`build_step(engine, gar_device=..., multi=...)` returns what the driver
dispatches: the engine's single step (`Engine.train_step`), its fused
M-step entry (`Engine.train_multi`), or the `--device-gar` hop step
(`device_gar_step`), a drop-in for `Engine.train_step`. The JAX module's
other axes wait for their flags: the `--mesh` placement (`mesh=` raises
here) and the `--gars` mixture (`defense_program`, `mixture_index`) with
its kernel variants (`defense_kernel`); `ROADMAP.md` says what each
needs.
"""

import torch

__all__ = ["build_step", "device_gar_step", "tree_to"]


def tree_to(tree, device):
    """Tensors (and tuples of them) on `device`; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(leaf, device) for leaf in tree)
    return tree


def device_gar_step(engine, gar_device):
    """The reference's `--device-gar` placement (the JAX package's
    `device_gar_step`): the honest phase runs on the engine's device, the
    whole defense phase (the attack, its line search included, the GAR
    and the influence) on `gar_device`, and the update back on the
    engine's device. The honest rows and the attack's state hop to
    `gar_device`, the Byzantine rows, the aggregate, the acceptation
    ratio and the attack's next state hop back, every step. On the CPU
    the defense takes the plain versions of the kernels (a wrapper given
    a CPU tensor takes its plain version), as the JAX package runs the
    GAR device's programs without the Mosaic kernels.

    Returns `step(state, xs, ys, lr, masks=None) -> (state, metrics)`, a
    drop-in for `engine.train_step`; each call counts one
    `device_gar_steps` in `engine.counts`.
    """
    device = torch.device(gar_device)

    def step(state, xs, ys, lr, masks=None):
        engine.counts["device_gar_steps"] += 1
        rng, _, wkeys = engine.step_keys(state.rng)
        batch = engine._batch_of(xs)
        if masks is None:
            masks = engine.draw_masks(wkeys, batch)
        G_sampled, loss_avg, net_state, new_mw, G_honest = engine.phase_honest(
            state, xs, ys, lr, masks)
        main = G_honest.device
        # --- the hop (reference `attack.py:811-815`) --- #
        out = engine.phase_defense(tree_to(G_honest, device),
                                   tree_to(state.attack_state, device))
        G_attack, grad_defense, accept_ratio, attack_state = tree_to(out, main)
        return engine.phase_update(
            state, G_sampled, loss_avg, net_state, new_mw, G_honest,
            G_attack, grad_defense, accept_ratio, attack_state, lr, batch,
            rng=rng)

    return step


def build_step(engine, *, mesh=None, gar_device=None, multi=False):
    """The placement axis, as one entry point.

    Args:
      engine: a built `Engine`.
      mesh: the multi-card sharded placement: not ported yet (raises).
      gar_device: a torch device name, the `--device-gar` placement
        (`device_gar_step`).
      multi: the fused M-steps-per-dispatch entry (`Engine.train_multi`)
        instead of the single step.

    Returns `step(state, xs, ys, lr[s]) -> (state, metrics)`.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh placement is not ported yet (the multi-card mesh, "
            "ROADMAP.md section 1 item 7)")
    if gar_device is not None:
        if multi:
            raise ValueError(
                "device-GAR placement has no fused multi-step program "
                "(the per-step hop is the point of the placement)")
        return device_gar_step(engine, gar_device)
    return engine.train_multi if multi else engine.train_step
