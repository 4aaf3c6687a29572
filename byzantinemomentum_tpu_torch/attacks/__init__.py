"""Byzantine gradient synthesis — the attack registry
(`byzantinemomentum_tpu/attacks/__init__.py`).

An attack is a function

    attack(grad_honests: f32[h, d], f_decl: int, f_real: int,
           defense: callable, **kwargs) -> f32[f_real, d]

where `defense(gradients=f32[n, d], f=int) -> f32[d]` is the live
aggregation rule (the adaptive attacks line-search against it,
`ops/linesearch.py`). The result is a stacked (f_real, d) matrix.
Registry: `attacks: name -> Attack`, each with `.checked`, `.unchecked`,
`.check`.

Stateful attacks: an attack registered with a `state_init` hook threads
history across steps. `state_init(f_real, d)` builds the initial state;
the attack receives it as `state=` and returns `(rows, new_state)`
instead of the bare rows. The engine carries it in
`TrainState.attack_state` (`()` for a static attack, which takes no
`state` and returns the bare rows). A state is a tensor on the rows'
device (`attacks/warmup.py`'s step counter is an i32 0-d tensor), so a
step reads nothing on the host; the engine moves `state_init`'s to its
device.
"""

import pathlib

import torch

from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.ops import as_matrix

__all__ = ["attacks", "register", "Attack", "empty_byzantine",
           "search_dtype", "displacement"]

attacks = {}


class Attack:
    """A registered attack; calling it runs the checked path."""

    def __init__(self, name, unchecked, check, state_init=None):
        self.name = name
        self.unchecked = unchecked
        self.check = check
        self.state_init = state_init

    @property
    def stateful(self):
        """Whether the attack threads history (see the module docstring):
        it takes `state=` and returns `(rows, new_state)`."""
        return self.state_init is not None

    def checked(self, grad_honests, f_decl, f_real, defense=None, state=None,
                **kwargs):
        """The checked call; a stateful attack returns `(rows, state)`
        (from `state_init` where `state` is None)."""
        grad_honests = as_matrix(grad_honests)
        message = self.check(grad_honests=grad_honests, f_decl=f_decl,
                             f_real=f_real, defense=defense, **kwargs)
        if message is not None:
            raise utils.UserException(f"Attack {self.name!r} cannot be used: {message}")
        if self.stateful:
            if state is None:
                state = self.state_init(f_real=f_real, d=grad_honests.shape[1])
            result, state = self.unchecked(
                grad_honests, f_decl=f_decl, f_real=f_real, defense=defense,
                state=state, **kwargs)
        else:
            result = self.unchecked(grad_honests, f_decl=f_decl,
                                    f_real=f_real, defense=defense, **kwargs)
        expected = (f_real, grad_honests.shape[1])
        if tuple(result.shape) != expected:
            raise utils.UserException(
                f"Attack {self.name!r} returned shape {tuple(result.shape)}, expected {expected}")
        return (result, state) if self.stateful else result

    def __call__(self, grad_honests, f_decl, f_real, defense=None, **kwargs):
        return self.checked(grad_honests, f_decl, f_real, defense=defense, **kwargs)

    def __repr__(self):
        return f"Attack({self.name!r})"


def register(name, unchecked, check, state_init=None):
    """Register an attack under `name`; `state_init(f_real, d)` marks it
    stateful (see the module docstring)."""
    if name in attacks:
        utils.warning(f"Attack {name!r} registered twice; keeping the last")
    atk = Attack(name, unchecked, check, state_init=state_init)
    attacks[name] = atk
    return atk


def empty_byzantine(grad_honests):
    """The (0, d) result for f_real == 0."""
    return grad_honests.new_zeros((0, grad_honests.shape[1]))


def search_dtype(grad_honests):
    """The dtype of an adaptive attack's probes and rows: the JAX package's
    searched factor is a float32 scalar (strongly typed), so a half
    gradient meets it at float32, and a float64 one stays float64."""
    return torch.promote_types(grad_honests.dtype, torch.float32)


def displacement(defense, honests, f_decl, f_real, grad_avg):
    """The line search's objective: `byz -> ||defense(honests + f_real
    copies of byz) - grad_avg||^2`, a 0-d tensor on the operands' device.
    The stacked matrix is written once, and each call rewrites only its
    f_real Byzantine rows (the defense reads the stack and writes none
    of it, so every call sees the matrix a concatenation would build)."""
    h = honests.shape[0]
    stacked = torch.cat([honests, honests.new_empty((f_real, honests.shape[1]))])

    def objective(byz):
        stacked[h:] = byz
        aggregated = defense(gradients=stacked, f=f_decl) - grad_avg
        return torch.dot(aggregated, aggregated)

    return objective


utils.import_directory(__name__, pathlib.Path(__file__).parent)
