"""Optimizer registry (`byzantinemomentum_tpu/optim.py`).

An optimizer is a pair of functions over the flat parameter vector,
`init(theta) -> opt_state` and `update(grad, opt_state, theta, lr) ->
(new_theta, new_opt_state)`. `sgd` is torch.optim.SGD with momentum 0
(the Byzantine-momentum algebra lives in `engine/step.py`):
theta <- theta - lr * (grad + weight_decay * theta), in theta's dtype
(the engine hands over a learning rate rounded to it; the weight decay is
rounded to it as JAX applies the Python scalar, `utils.weak_scalar`).

The others are the JAX package's optax chains with optax's semantics:
`g = grad + weight_decay * theta` first, then the chain (`scale_by_*`,
`add_decayed_weights` for `adamw`, `scale(-1)`), then `theta + lr *
delta`. Their state is the chain's state, a tuple with one entry a
transformation: optax's NamedTuples as dicts of their fields (`count`
an int32 0-d tensor, the moments in theta's dtype on theta's device), an
empty transformation state as `()`, so that `checkpoint.py` writes the
JAX file's `{"0": {"count": ..., "mu": ..., "nu": ...}, "1": {}}`. A
step reads nothing on the host: the bias corrections take `decay **
count` on the device (float32, then cast to the moments' dtype, as
optax's `bias_correction`), and RAdam's rectification chooses with
`torch.where`. Python scalars apply as JAX's weak scalars
(`utils.weak_scalar`): `1 - decay` rounded once to theta's dtype. These
are elementwise passes over the flat vector, which XLA fuses in the JAX
package: no Pallas kernel stands behind them.
"""

import torch

from byzantinemomentum_tpu_torch import utils

__all__ = ["optimizers", "register", "Optimizer", "build"]

optimizers = {}


class Optimizer:
    """A named (init, update) pair."""

    def __init__(self, name, init, update):
        self.name = name
        self.init = init
        self.update = update

    def __repr__(self):
        return f"Optimizer({self.name!r})"


def register(name, builder):
    if name in optimizers:
        utils.warning(f"Optimizer {name!r} registered twice; keeping the last")
    optimizers[name] = builder
    return builder


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


# --------------------------------------------------------------------------- #
# optax's transformations on one flat leaf

def _weak(x, like):
    return utils.weak_scalar(x, like.dtype)


def _count0(theta):
    return torch.zeros((), dtype=torch.int32, device=theta.device)


def _increment(count):
    """`numerics.safe_increment`: count + 1, held at int32's largest."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def _moment(g, m, decay, order):
    """`update_moment(_per_elem_norm)`: (1 - decay) g^order + decay m."""
    power = g if order == 1 else g * g
    return _weak(1 - decay, g) * power + _weak(decay, g) * m


def _decay_power(decay, count):
    """`decay ** count` in float32 (a weak float to an int32 power)."""
    return torch.pow(torch.full((), decay, dtype=torch.float32,
                                device=count.device), count.to(torch.float32))


def _bias_correction(moment, decay, count):
    """`bias_correction`: moment / (1 - decay^count), the correction taken
    in float32 and cast to the moment's dtype."""
    return moment / (1 - _decay_power(decay, count)).to(moment.dtype)


def _f32(x):
    """A Python scalar as JAX applies it to a float32 operand."""
    return utils.weak_scalar(x, torch.float32)


def _adam_state(theta, names=("count", "mu", "nu")):
    zeros = torch.zeros_like(theta)
    return {name: _count0(theta) if name == "count" else zeros.clone()
            for name in names}


def _scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    def init(theta):
        return _adam_state(theta)

    def update(g, state):
        mu = _moment(g, state["mu"], b1, 1)
        nu = _moment(g, state["nu"], b2, 2)
        count = _increment(state["count"])
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        delta = mu_hat / (torch.sqrt(nu_hat + _weak(0.0, g)) + _weak(eps, g))
        return delta, {"count": count, "mu": mu, "nu": nu}

    return init, update


def _scale_by_amsgrad(b1=0.9, b2=0.999, eps=1e-8):
    def init(theta):
        return _adam_state(theta, ("count", "mu", "nu", "nu_max"))

    def update(g, state):
        mu = _moment(g, state["mu"], b1, 1)
        nu = _moment(g, state["nu"], b2, 2)
        count = _increment(state["count"])
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        nu_max = torch.maximum(state["nu_max"], nu_hat)
        delta = mu_hat / (torch.sqrt(nu_max + _weak(0.0, g)) + _weak(eps, g))
        return delta, {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max}

    return init, update


def _scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8):
    def init(theta):
        return _adam_state(theta)

    def update(g, state):
        count = _increment(state["count"])
        mu = _moment(g, state["mu"], b1, 1)
        # `update_infinity_moment`: max(|g| + eps, decay * nu)
        nu = torch.maximum(torch.abs(g) + _weak(eps, g),
                           _weak(b2, g) * state["nu"])
        delta = _bias_correction(mu, b1, count) / nu
        return delta, {"count": count, "mu": mu, "nu": nu}

    return init, update


def _scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, threshold=5.0):
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(theta):
        return _adam_state(theta)

    def update(g, state):
        mu = _moment(g, state["mu"], b1, 1)
        nu = _moment(g, state["nu"], b2, 2)
        count = _increment(state["count"])
        # In float32 on the device, as optax's weak floats over the int32
        # count: b2t = b2^t, ro = ro_inf - 2 t b2t / (1 - b2t)
        b2t = _decay_power(b2, count)
        ro = _f32(ro_inf) - (2 * count).to(torch.float32) * b2t / (1 - b2t)
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        r = torch.sqrt((ro - _f32(4.0)) * (ro - _f32(2.0)) * _f32(ro_inf)
                       / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        rectified = r.to(g.dtype) * mu_hat / (torch.sqrt(nu_hat + _weak(0.0, g))
                                              + _weak(eps, g))
        delta = torch.where(ro >= _f32(threshold), rectified, mu_hat)
        return delta, {"count": count, "mu": mu, "nu": nu}

    return init, update


def _scale_by_rms(decay=0.99, eps=1e-8):
    def init(theta):
        return {"nu": torch.zeros_like(theta)}

    def update(g, state):
        nu = _moment(g, state["nu"], decay, 2)
        return torch.rsqrt(nu + _weak(eps, g)) * g, {"nu": nu}

    return init, update


def _scale_by_rss(eps=1e-10):
    def init(theta):
        return {"sum_of_squares": torch.zeros_like(theta)}

    def update(g, state):
        total = g * g + state["sum_of_squares"]
        scale = torch.where(total > 0, torch.rsqrt(total + _weak(eps, g)),
                            _weak(0.0, g))
        return scale * g, {"sum_of_squares": total}

    return init, update


def _scale_by_adadelta(rho=0.9, eps=1e-6):
    def init(theta):
        return {"e_g": torch.zeros_like(theta), "e_x": torch.zeros_like(theta)}

    def update(g, state):
        e_g = _moment(g, state["e_g"], rho, 2)
        eps_w = _weak(eps, g)
        delta = (torch.sqrt(state["e_x"] + eps_w)
                 / torch.sqrt(e_g + eps_w)) * g
        e_x = _moment(delta, state["e_x"], rho, 2)
        return delta, {"e_g": e_g, "e_x": e_x}

    return init, update


def _chain(name, scale_by, decayed_weights=None):
    """The optimizer of the chain `scale_by` (, `add_decayed_weights(wd)`),
    `scale(-1)`, whose state is `(scale_by's, (), ())` (or two entries
    without the decayed weights)."""
    def builder(weight_decay=0.0, **kwargs):
        wd = kwargs.pop("wd", 1e-2) if decayed_weights else None
        init_by, update_by = scale_by(**{key: value for key, value
                                         in kwargs.items()
                                         if key in _PARAMETERS[scale_by]})

        def init(theta):
            return (init_by(theta),) + ((),) * (2 if decayed_weights else 1)

        def update(grad, opt_state, theta, lr):
            g = grad + _weak(weight_decay, theta) * theta
            delta, by_state = update_by(g, opt_state[0])
            if decayed_weights:
                delta = delta + _weak(wd, theta) * theta
            delta = _weak(-1.0, theta) * delta
            return theta + lr * delta, (by_state,) + opt_state[1:]

        return Optimizer(name, init, update)

    return builder


# The keyword arguments each transformation takes (others are ignored, as
# the JAX builders' `**kw` ignore them)
_PARAMETERS = {
    _scale_by_adam: ("b1", "b2", "eps"),
    _scale_by_amsgrad: ("b1", "b2", "eps"),
    _scale_by_adamax: ("b1", "b2", "eps"),
    _scale_by_radam: ("b1", "b2", "eps"),
    _scale_by_rms: ("decay", "eps"),
    _scale_by_rss: ("eps",),
    _scale_by_adadelta: ("rho", "eps"),
}

register("sgd", _plain_sgd)
register("adam", _chain("adam", _scale_by_adam))
register("adamw", _chain("adamw", _scale_by_adam, decayed_weights=True))
register("rmsprop", _chain("rmsprop", _scale_by_rms))
register("adagrad", _chain("adagrad", _scale_by_rss))
register("adamax", _chain("adamax", _scale_by_adamax))
register("adadelta", _chain("adadelta", _scale_by_adadelta))
register("radam", _chain("radam", _scale_by_radam))
register("amsgrad", _chain("amsgrad", _scale_by_amsgrad))
