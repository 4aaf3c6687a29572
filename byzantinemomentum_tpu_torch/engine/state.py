"""Training state (`byzantinemomentum_tpu/engine/state.py`).

Parameters live as ONE flat `[d]` vector in the parameter dtype
(`cfg.dtype`); every other tensor of the state takes theta's dtype, so
the momentum algebra, the GARs and the study stay in it, as in the JAX
package. All of them work on flat vectors. `past_count`, the number of valid
past-gradient slots, is an i32 0-d tensor on theta's device, as in the
JAX package: the study metrics weight the slots by it instead of
slicing, so no step reads it on the host. `steps` and `datapoints` are
host integers that advance by the step's own arithmetic (the driver
keeps its own copies, as the JAX driver does), so they need no read
either.
`rng` is the step's PRNG key, the JAX `TrainState.rng`: an int64 `[2]`
tensor of two uint32 words on the device (`prng.py`), split once a step.
`rng_host` is the host's mirror of `rng` as two Python ints, or None
where no mirror is kept: a `--gars` mixture drawn once a step picks its
member from it (`Engine.mirror_keys`) without reading the device.
`attack_state` is a stateful attack's history (`attacks/__init__.py`,
tensors on theta's device), `()` for a static attack.
A step returns a new `TrainState` and writes none of the old one's
tensors.
"""

import dataclasses
import typing

import torch

__all__ = ["TrainState", "init_state"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    theta: torch.Tensor             # [d] flat parameters
    net_state: dict                 # BatchNorm running stats, by buffer name
    opt_state: typing.Any           # optimizer state (empty for plain SGD)
    momentum_server: torch.Tensor   # [d]
    momentum_workers: torch.Tensor  # [h, d] (shape (0, d) unless 'worker')
    origin: torch.Tensor            # [d] initial params (empty if no study)
    past_grads: torch.Tensor        # [P, d] ring of past sampled averages
    past_norms: torch.Tensor        # [P] their norms ('appendleft' order)
    past_count: torch.Tensor        # i32 0-d: valid past entries
    steps: int                      # step counter
    datapoints: int                 # training point counter
    rng: torch.Tensor = None        # int64 [2] PRNG key on the device
    attack_state: typing.Any = ()   # the stateful attack's history
    rng_host: tuple = None          # the host's mirror of rng (two ints)


def init_state(cfg, theta, net_state, rng=None, opt_state=(),
               attack_state=(), rng_host=None):
    """Fresh-run state; `rng` the step key (`Engine.init` gives
    `fold_in(root key, 1)`; None only for states that never draw, as in
    tests that hand the masks in), `attack_state` from the attack's
    `state_init`, `rng_host` the host's mirror of `rng`."""
    d = theta.shape[0]
    h = cfg.nb_honests
    past = cfg.nb_for_study_past if cfg.study else 0
    zeros = theta.new_zeros
    return TrainState(
        theta=theta,
        net_state=net_state,
        opt_state=opt_state,
        momentum_server=zeros((d,)),
        momentum_workers=zeros((h if cfg.momentum_at == "worker" else 0, d)),
        origin=theta.clone() if cfg.study else zeros((0,)),
        past_grads=zeros((past, d)),
        past_norms=zeros((past,)),
        past_count=torch.zeros((), dtype=torch.int32, device=theta.device),
        steps=0,
        datapoints=0,
        rng=rng,
        attack_state=attack_state,
        rng_host=rng_host,
    )
