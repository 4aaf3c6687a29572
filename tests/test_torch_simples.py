"""Parity of the PyTorch port's simple models (`models/simples.py`) with
the JAX package's.

* The flat parameter order is `ravel_pytree`'s and the widths are the
  JAX models': `simples-full` d = 79,510, `simples-conv` d = 431,080,
  `simples-logit` and `simples-linear` d = 69.
* Forward and flat gradient of each model from the JAX `init` weights
  (`convert.params_from_jax`), batch 4, against the JAX `apply`: nll on
  the log-probabilities of `simples-full`/`simples-conv`, bce on the
  probabilities of `simples-logit`, mse on the outputs of
  `simples-linear`; rtol 1e-4, atol 1e-5.
* `forward_grouped` (S = 3 workers, each with its own weights) against
  the JAX `apply_grouped`: outputs and the gradient rows of the summed
  per-worker losses, rtol 1e-4, atol 1e-5.
* `forward_grouped` against S calls of the port's own `forward`, in
  float64, with `shared` false (every worker its own weights) and true
  (every worker on worker 0's): outputs and gradient rows within rtol
  1e-9, atol 1e-12 — the 5x5 'VALID' grouped convolution and its
  backward included.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu_torch import convert, models, prng
from byzantinemomentum_tpu_torch.losses import Loss
from byzantinemomentum_tpu_torch.models import FlatParams

from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, S = 4, 3
# name -> (d, input shape, loss)
MODELS = {"simples-full": (79510, (28, 28, 1), "nll"),
          "simples-conv": (431080, (28, 28, 1), "nll"),
          "simples-logit": (69, (68,), "bce"),
          "simples-linear": (69, (68,), "mse")}


def _batch(name, rng, lead=(B,)):
    """Inputs and targets of the model's loss: class indices for nll,
    {0, 1} floats (B, 1) for bce and mse."""
    _, shape, loss = MODELS[name]
    x = rng.standard_normal((*lead, *shape)).astype(np.float32)
    if loss == "nll":
        y = rng.integers(0, 10, size=lead).astype(np.int32)
    else:
        y = rng.integers(0, 2, size=(*lead, 1)).astype(np.float32)
    return x, y


def _jax_params(name, seed):
    params, state = jax_models.build(name).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params), state


@pytest.mark.parametrize("name", MODELS)
def test_flat_order_and_widths_match_jax(name):
    params, state = _jax_params(name, 0)
    module = models.build(name, device="cpu")
    flat = FlatParams(module)
    theta, bn = convert.params_from_jax(params, state)
    theta_jax, _ = jax.flatten_util.ravel_pytree(params)
    assert flat.d == jax_models.build(name).param_count() == MODELS[name][0]
    assert flat.names == [n for n, _ in convert.flat_items(params)]
    assert bn == {} and module.mask_shapes(B) == ()
    assert module.draw_masks(prng.split(prng.PRNGKey(0), 3), B) == ()
    np.testing.assert_array_equal(theta.numpy(), np.asarray(theta_jax))


@pytest.mark.parametrize("name", MODELS)
def test_forward_and_gradient_match_jax(name):
    params, state = _jax_params(name, 1)
    mdef = jax_models.build(name)
    x, y = _batch(name, np.random.default_rng(1))
    loss_j = jax_losses.Loss(MODELS[name][2])
    theta_j, unravel = jax.flatten_util.ravel_pytree(params)

    def jloss(theta):
        out, _ = mdef.apply(unravel(theta), state, jnp.asarray(x), train=True)
        return loss_j(out, jnp.asarray(y), theta), out

    (jvalue, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(theta_j)

    model = models.build(name, device="cpu")
    flat = FlatParams(model)
    theta = convert.params_from_jax(params, state)[0].requires_grad_()
    out, new_state = functional_call(model, flat.unflatten(theta),
                                     (torch.from_numpy(x),), {"train": True})
    value = Loss(MODELS[name][2])(out, torch.from_numpy(y), theta)
    (grad,) = torch.autograd.grad(value, theta)
    assert new_state == {}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(value.detach()), float(jvalue), rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=ATOL)


def _stacked(name, dtype=torch.float32):
    """S workers' JAX parameters, stacked, and the port's `[S, d]` rows."""
    inits = [jax_models.build(name).init(k)
             for k in jax.random.split(jax.random.PRNGKey(2), S)]
    params = [jax.tree.map(np.asarray, p) for p, _ in inits]
    theta_s = torch.stack([convert.params_from_jax(p, {}, dtype=dtype)[0]
                           for p in params])
    return params, theta_s


def _grouped_rows(model, theta_s, xs, ys, loss, shared=False):
    flat = FlatParams(model)
    th_s = theta_s.clone().requires_grad_()
    out, state = model.forward_grouped(flat.unflatten_stacked(th_s), {},
                                       xs, True, (), shared)
    losses = torch.func.vmap(loss)(out, ys, th_s)
    (rows,) = torch.autograd.grad(losses.sum(), th_s)
    assert state == {}
    return out.detach(), rows


@pytest.mark.parametrize("name", MODELS)
def test_forward_grouped_matches_apply_grouped(name):
    mdef = jax_models.build(name)
    params, theta_s = _stacked(name)
    params_s = jax.tree.map(lambda *leaves: jnp.stack(leaves), *params)
    xs, ys = _batch(name, np.random.default_rng(2), lead=(S, B))
    loss_j = jax_losses.Loss(MODELS[name][2])

    def jloss(params_s):
        out, _ = mdef.apply_grouped(params_s, {}, jnp.asarray(xs), train=True)
        per = jax.vmap(lambda o, y: loss_j(o, y, None))(out, jnp.asarray(ys))
        return jnp.sum(per), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params_s)
    jrows = np.stack([np.asarray(jax.flatten_util.ravel_pytree(
        jax.tree.map(lambda leaf, s=s: leaf[s], jgrads))[0]) for s in range(S)])
    model = models.build(name, device="cpu")
    out, rows = _grouped_rows(model, theta_s, torch.from_numpy(xs),
                              torch.from_numpy(ys), Loss(MODELS[name][2]))
    assert out.shape == jout.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(rows.numpy(), jrows, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shared", (False, True))
@pytest.mark.parametrize("name", MODELS)
def test_forward_grouped_equals_forward_in_float64(name, shared):
    model = models.build(name, device="cpu", dtype=torch.float64)
    flat = FlatParams(model)
    _, theta_s = _stacked(name, torch.float64)
    if shared:
        theta_s = theta_s[:1].expand(S, -1)
    xs, ys = _batch(name, np.random.default_rng(3), lead=(S, B))
    xs = torch.from_numpy(xs).double()
    ys = torch.from_numpy(ys)
    if ys.is_floating_point():
        ys = ys.double()
    loss = Loss(MODELS[name][2])
    out, rows = _grouped_rows(model, theta_s, xs, ys, loss, shared)
    for s in range(S):
        theta = theta_s[s].clone().requires_grad_()
        want, _ = functional_call(model, flat.unflatten(theta), (xs[s],),
                                  {"train": True})
        (grad,) = torch.autograd.grad(loss(want, ys[s], theta), theta)
        np.testing.assert_allclose(out[s].numpy(), want.detach().numpy(),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(rows[s].numpy(), grad.numpy(),
                                   rtol=1e-9, atol=1e-12)
