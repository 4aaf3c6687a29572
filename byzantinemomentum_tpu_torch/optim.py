"""Optimizer registry (`byzantinemomentum_tpu/optim.py`, the plain `sgd`).

An optimizer is a pair of functions over the flat parameter vector,
`init(theta) -> opt_state` and `update(grad, opt_state, theta, lr) ->
(new_theta, new_opt_state)`. `sgd` is torch.optim.SGD with momentum 0
(the Byzantine-momentum algebra lives in `engine/step.py`):
theta <- theta - lr * (grad + weight_decay * theta), in theta's dtype
(the engine hands over a learning rate rounded to it; the weight decay is
rounded to it as JAX applies the Python scalar, `utils.weak_scalar`).
"""

from byzantinemomentum_tpu_torch import utils

__all__ = ["optimizers", "Optimizer", "build"]

optimizers = {}


class Optimizer:
    """A named (init, update) pair."""

    def __init__(self, name, init, update):
        self.name = name
        self.init = init
        self.update = update


def build(name, weight_decay=0.0, **kwargs):
    """Instantiate an optimizer by registry name."""
    if name not in optimizers:
        utils.fatal_unavailable(optimizers, name, what="optimizer name")
    return optimizers[name](weight_decay=weight_decay, **kwargs)


def _plain_sgd(weight_decay=0.0, **kw):
    def init(theta):
        return ()

    def update(grad, opt_state, theta, lr):
        wd = utils.weak_scalar(weight_decay, theta.dtype)
        return theta - lr * (grad + wd * theta), opt_state

    return Optimizer("sgd", init, update)


optimizers["sgd"] = _plain_sgd
