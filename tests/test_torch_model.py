"""Parity of the PyTorch port's `empire-cnn` with the JAX package's.

Parameters come from the JAX `init` through `convert.params_from_jax`, and
the port is fed the JAX dropout masks (drawn with
`models.core._dropout_mask` on the JAX keys), so both packages compute
the same function. Train-mode output, new BatchNorm state and the flat
gradient are compared with rtol 1e-4, atol 1e-5: convolutions and
BatchNorm statistics sum in another order, and the JAX BatchNorm takes
its variance in one pass.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.losses import Criterion as JaxCriterion
from byzantinemomentum_tpu.losses import Loss as JaxLoss
from byzantinemomentum_tpu.models.core import _dropout_mask
from byzantinemomentum_tpu_torch import convert, models, prng
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.models import FlatParams

from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B = 4


def jax_masks(key, batch):
    """The three keep-masks the JAX model draws from `key`, as numpy in
    the port's NCHW layout."""
    k = jax.random.split(key, 3)
    shapes = ((batch, 16, 16, 64), (batch, 8, 8, 128), (batch, 128))
    masks = [np.array(_dropout_mask(ki, 0.75, s)) for ki, s in zip(k, shapes)]
    return (np.ascontiguousarray(masks[0].transpose(0, 3, 1, 2)),
            np.ascontiguousarray(masks[1].transpose(0, 3, 1, 2)), masks[2])


def setup(seed=0):
    mdef = jax_models.build("empire-cnn")
    params, state = mdef.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=B).astype(np.int32)
    return mdef, params, state, x, y


def test_flat_order_and_param_count_match_jax():
    mdef, params, state, _, _ = setup()
    module = models.build("empire-cnn", device="cpu")
    flat = FlatParams(module)
    theta_jax, _ = jax.flatten_util.ravel_pytree(params)
    theta, bn = convert.params_from_jax(params, state)
    assert flat.d == mdef.param_count() == 1310922 == theta.shape[0]
    np.testing.assert_array_equal(theta.numpy(), np.asarray(theta_jax))
    assert flat.names == [name for name, _ in convert.flat_items(params)]
    assert sorted(bn) == sorted(name for name, _ in module.named_buffers())
    unrav = flat.unflatten(theta)
    np.testing.assert_array_equal(unrav["c2.w"].numpy(), params["c2"]["w"])
    np.testing.assert_array_equal(unrav["f1.w"].numpy(), params["f1"]["w"])


def test_init_bounds_are_torch_default():
    module = models.build("empire-cnn", device="cpu")
    module.init(prng.PRNGKey(3))
    for name, bound in (("c1", 1 / np.sqrt(27)), ("c4", 1 / np.sqrt(1152)),
                        ("f1", 1 / np.sqrt(8192))):
        layer = getattr(module, name)
        for leaf in (layer.w.detach(), layer.b.detach()):
            assert float(leaf.abs().max()) <= bound
            assert float(leaf.abs().max()) > 0.9 * bound
    assert float(module.b1.gamma.min()) == 1.0 and float(module.b1.var.min()) == 1.0


@pytest.mark.parametrize("train", (True, False))
def test_forward_state_and_gradient_match_jax(train):
    mdef, params, state, x, y = setup(seed=1)
    key = jax.random.PRNGKey(7)
    jax_loss = JaxLoss("nll")
    _, unravel = jax.flatten_util.ravel_pytree(params)
    theta_j, _ = jax.flatten_util.ravel_pytree(params)

    def loss_j(th):
        out, new_state = mdef.apply(unravel(th), state, jnp.asarray(x),
                                    train=train, rng=key)
        return jax_loss(out, jnp.asarray(y), th), (out, new_state)

    (_, (out_j, state_j)), grad_j = jax.value_and_grad(loss_j, has_aux=True)(theta_j)

    module = models.build("empire-cnn", device="cpu")
    flat = FlatParams(module)
    theta, bn = convert.params_from_jax(params, state)
    theta.requires_grad_(True)
    masks = tuple(torch.from_numpy(m) for m in jax_masks(key, B)) if train else None
    out, new_state = torch.func.functional_call(
        module, {**flat.unflatten(theta), **bn}, (torch.from_numpy(x),),
        {"train": train, "masks": masks})
    loss = Loss("nll")(out, torch.from_numpy(y), theta)
    (grad,) = torch.autograd.grad(loss, theta)

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    for layer, stats in new_state.items():
        for stat, value in stats.items():
            np.testing.assert_allclose(value.numpy(), np.asarray(state_j[layer][stat]),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=RTOL, atol=ATOL)
    want = np.asarray(JaxCriterion("top-k")(out_j, jnp.asarray(y)))
    np.testing.assert_array_equal(Criterion("top-k")(out.detach(), torch.from_numpy(y)).numpy(), want)
