"""The step program's axes (`byzantinemomentum_tpu/engine/program.py`):
the kernel axis (`defense_kernel`), the mixture axis (`defense_program`,
`mixture_index`) and the placement axis (`build_step`,
`device_gar_step`).

`defense_program(defenses, "plain", f=...)` is the defense the engine
runs over a list of `(gar, cumulative frequency, kwargs)`: one defense
inlines its kernel; a `--gars` mixture runs the member the draw gives.
The JAX program `lax.switch`es on a traced index; here the member is
either a host int, which the host knows without reading the device (the
per-step draw, from the host's mirror of the key chain,
`Engine.mirror_keys`), so only that member runs, or a 0-d int32 device
tensor (the per-call draw, which hashes the operand on the device,
`ops/mixture_kernels.py`), so every member runs and the index picks one
result with `torch.where` (`select`), nothing read on the host. The
"plain" variant returns the aggregate; the "diag" variant (the engine's
outer aggregation under `--gar-diagnostics`) returns `(aggregate, aux)`
from `gar.diagnosed`, and `select` picks the aggregate and each aux key.
The "masked" variant waits for the fault plans and raises until then.

`build_step(engine, gar_device=..., multi=...)` returns what the driver
dispatches: the engine's single step (`Engine.train_step`), its fused
M-step entry (`Engine.train_multi`), or the `--device-gar` hop step
(`device_gar_step`), a drop-in for `Engine.train_step`. The `--mesh`
placement (`mesh=`) raises here; `ROADMAP.md` says what it needs.

Phase ranges (`scope`): the engine's phases run inside
`torch.profiler.record_function` ranges named as the JAX package's
`jax.named_scope`s (`honest`, `attack`, `gar`/`gar_diag`/`gar_masked`,
`update`, `metrics`), nested as they nest there, so a profiler trace of
the port attributes to the same phases (`obs/attrib/`). The names are
constants, as the JAX package's (its jaxlint BMT-E08). A range is opened
only while a profiler runs: without one the step issues exactly what it
issues without them.
"""

import contextlib

import numpy as np
import torch

__all__ = ["VARIANTS", "SCOPES", "scope", "defense_kernel", "defense_program",
           "mixture_index", "cumulative", "select", "build_step",
           "device_gar_step", "tree_to"]

# The kernel-family axis of the JAX package
VARIANTS = ("plain", "diag", "masked")

# The phase range each variant's defense runs under (the JAX package's
# `engine/program.py::SCOPES`)
SCOPES = {"plain": "gar", "diag": "gar_diag", "masked": "gar_masked"}


def scope(name):
    """The profiler range of the engine phase `name` (a constant): a
    `torch.profiler.record_function` while a profiler runs, else a
    context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def defense_kernel(gar, variant, *, f, kwargs=None, dynamic=True):
    """The program of one (GAR, variant) cell: `G -> aggregate` ("plain"),
    `G -> (aggregate, aux)` ("diag") or `(G, active) -> (aggregate,
    f_eff)` ("masked", with the dynamic quorum unless `dynamic` is
    False)."""
    kwargs = {} if kwargs is None else kwargs
    if variant == "plain":
        return lambda G: gar.unchecked(G, f=f, **kwargs)
    if variant == "diag":
        return lambda G: gar.diagnosed(G, f=f, **kwargs)
    if variant == "masked":
        from byzantinemomentum_tpu_torch.faults import quorum

        return lambda G, active: quorum.masked_aggregate(
            gar, G, active, f_decl=f, dynamic=dynamic, **kwargs)
    raise ValueError(
        f"Unknown lattice variant {variant!r}; expected one of {VARIANTS}")


def cumulative(defenses, device=None):
    """The mixture's cumulative frequencies as f32: a numpy array, or a
    tensor on `device`."""
    cum = np.asarray([freq for _, freq, _ in defenses], np.float32)
    return cum if device is None else torch.from_numpy(cum).to(device)


def mixture_index(defenses, mix_u):
    """The member drawn by the host float `mix_u`: the inverse CDF over
    the cumulative frequencies, `searchsorted(cum, mix_u * cum[-1],
    side="right")` in f32, clipped to the last member (its device form is
    `ops/mixture_kernels.py::inverse_cdf`)."""
    cum = cumulative(defenses)
    return min(int(np.searchsorted(cum, np.float32(mix_u) * cum[-1],
                                   side="right")), len(defenses) - 1)


def select(outputs, index):
    """`outputs[index]` for a 0-d integer device tensor, with no read of
    the index: each later output replaces the first where the index names
    it (a NaN of an unpicked output never leaks). Outputs that are tuples
    or dicts of tensors (the "diag" variant's `(aggregate, aux)`) are
    picked leaf by leaf."""
    first = outputs[0]
    if isinstance(first, dict):
        return {key: select([out[key] for out in outputs], index)
                for key in first}
    if isinstance(first, tuple):
        return tuple(select([out[k] for out in outputs], index)
                     for k in range(len(first)))
    out = first
    for k, other in enumerate(outputs[1:], 1):
        out = torch.where(index == k, other, out)
    return out


def defense_program(defenses, variant, *, f, dynamic=True):
    """The mixture axis over `defense_kernel`: `program(G, member,
    *extra)`, `extra` the active mask `(active,)` of the "masked"
    variant. One defense runs its kernel whatever `member`; a mixture
    runs member `member` (a host int), or, for a 0-d device index, every
    member, and picks one result (`select`)."""
    kernels = [defense_kernel(gar, variant, f=f, kwargs=kwargs,
                              dynamic=dynamic)
               for gar, _, kwargs in defenses]

    def program(G, member=None, *extra):
        with scope(SCOPES[variant]):
            if len(kernels) == 1:
                return kernels[0](G, *extra)
            if isinstance(member, torch.Tensor):
                return select([kernel(G, *extra) for kernel in kernels],
                              member)
            return kernels[member](G, *extra)

    return program


def tree_to(tree, device):
    """Tensors (and tuples, named tuples, lists and dicts of them) on
    `device`; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(leaf, device) for leaf in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(leaf, device) for leaf in tree)
    if isinstance(tree, dict):
        return {key: tree_to(leaf, device) for key, leaf in tree.items()}
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
    GAR device's programs without the Mosaic kernels. With a fault
    schedule, the step's fault context (the active mask and the injected
    count) hops with the rows, and the fault metrics hop back, as in the
    JAX package.

    Returns `step(state, xs, ys, lr, masks=None, faults=None) -> (state,
    metrics)`, a drop-in for `engine.train_step`; each call counts one
    `device_gar_steps` in `engine.counts`.
    """
    device = torch.device(gar_device)

    def step(state, xs, ys, lr, masks=None, faults=None):
        engine.counts["device_gar_steps"] += 1
        rng_host, member = engine.mirror_keys(state)
        batch = engine._batch_of(xs)
        rng, mix_key, masks = engine.step_inputs(state, batch, masks)
        G_sampled, loss_avg, net_state, new_mw, G_honest = engine.phase_honest(
            state, xs, ys, lr, masks)
        G_honest, new_fb, fault = engine.phase_faults(state, G_honest, faults)
        main = G_honest.device
        # --- the hop (reference `attack.py:811-815`) --- #
        out = engine.phase_defense(tree_to(G_honest, device),
                                   tree_to(state.attack_state, device),
                                   mix_key=tree_to(mix_key, device),
                                   member=member,
                                   fault=tree_to(fault, device))
        out = tree_to(out, main)
        return engine.phase_update(
            state, G_sampled, loss_avg, net_state, new_mw, G_honest,
            *out[:4], lr, batch, rng=rng, rng_host=rng_host,
            **engine.defense_extras(out), fault_buffer=new_fb)

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
