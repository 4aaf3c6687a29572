"""The PyTorch port's `mobilenet_v2` against the JAX package's
(`byzantinemomentum_tpu/models/mobilenet.py`), on the CPU.

* The JAX model's parameter names, shapes and count (2,236,682 at 10
  classes; torchvision's 3,504,872 at 1000).
* `init(PRNGKey(seed))` gives the JAX init bit for bit, the port's own
  `prng.normal` drawing every leaf.
* The inverted residual block at narrow widths against `_block_apply`, in
  f32: t = 6 at stride 1 with the residual, t = 6 at stride 2, t = 1 (no
  expansion), in train mode (with the new running state) and eval mode:
  outputs and BatchNorm state within rtol 1e-5, atol 1e-6, the gradient
  within 1e-5 relative L2. The depthwise kernel keeps the JAX layout (3,
  3, 1, h) in the flat vector.
* ReLU6 takes JAX's clip's gradient: 0.5 at exactly 0 and exactly 6, 1
  inside and 0 outside, on f32 and on bf16.
* The classifier's keep-masks are the JAX model's draws from each worker's
  key itself (`_dropout_mask(wkey, 0.8, (B, 1280))`, the Bernoulli path),
  bit for bit, for S workers at once; the plain mask functions with
  `j` None draw from the keys as given.
* The whole model at full width, batch 2, train mode, on the JAX init
  carried across, with the JAX model's own mask: in float64 in both
  packages (`tests/test_torch_resnet.py` says why), outputs within 1e-6
  relative, BatchNorm state within 1e-6 absolute, the gradient within
  1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.models import mobilenet as jax_mobilenet
from byzantinemomentum_tpu.models.core import _dropout_mask
from byzantinemomentum_tpu_torch import convert, models, prng
from byzantinemomentum_tpu_torch.models import FlatParams, mobilenet
from byzantinemomentum_tpu_torch.models.core import relu6
from byzantinemomentum_tpu_torch.ops import prng_kernels

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_zoo import (block_call, jax_run, model_call, port_run, rel,
                             to_numpy, torch_key)

NAME = "mobilenet_v2"
RTOL, ATOL = 1e-5, 1e-6
LIKE = {"device": "cpu", "dtype": torch.float32}


def test_names_shapes_and_counts_are_the_jax_models():
    for classes, count in ((10, 2_236_682), (1000, 3_504_872)):
        mdef = jax_models.build(NAME, num_classes=classes)
        params, state = jax.eval_shape(mdef.init, jax.random.PRNGKey(0))
        module = models.build(NAME, device="meta", num_classes=classes)
        flat = FlatParams(module)
        items = list(convert.flat_items(params))
        assert flat.names == [name for name, _ in items]
        assert flat.shapes == [tuple(leaf.shape) for _, leaf in items]
        assert flat.d == mdef.param_count() == count
        buffers = {name: tuple(b.shape) for name, b in module.named_buffers()}
        assert buffers == {name: tuple(leaf.shape)
                           for name, leaf in convert.flat_items(state)}
    assert module.b1.dw.w.shape == (3, 3, 1, 96)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model's init from `PRNGKey(6)`, op by op as the JAX driver
    runs it (its compiles are most of this file's time: one for both
    tests)."""
    return to_numpy(jax_models.build(NAME).init(jax.random.PRNGKey(6)))


def test_init_is_the_jax_init(jax_init):
    module = models.build(NAME, device="cpu")
    module.init(prng.PRNGKey(6))
    params, state = jax_init
    theta, bn = convert.params_from_jax(params, state)
    got = FlatParams(module).flatten(dict(module.named_parameters())).detach()
    assert torch.equal(got.view(torch.int32), theta.view(torch.int32))
    buffers = dict(module.named_buffers())
    assert sorted(buffers) == sorted(bn)
    assert all(torch.equal(buffers[name], value) for name, value in bn.items())


@pytest.mark.parametrize("t,cin,cout,stride", ((6, 8, 8, 1), (6, 8, 12, 2),
                                               (1, 8, 4, 1)))
@pytest.mark.parametrize("train", (True, False))
def test_block_matches_jax(t, cin, cout, stride, train):
    seed = t + cin + cout + stride
    params, state = jax_mobilenet._block_init(jax.random.PRNGKey(seed), cin,
                                              cout, t)
    rng = np.random.default_rng(seed)
    state = {name: {"mean": rng.standard_normal(s["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)}
             for name, s in state.items()}
    module = mobilenet._Block(cin, cout, t, stride, LIKE)
    assert module.residual == (stride == 1 and cin == cout)
    assert (module.expand is None) == (t == 1)
    x = rng.standard_normal((4, 8, 8, cin)).astype(np.float32)
    R = rng.standard_normal((4, 8 // stride, 8 // stride, cout)).astype(np.float32)
    params = to_numpy(params)
    jout, jstate, jgrad = jax_run(
        lambda p, s, x: jax_mobilenet._block_apply(p, s, x, stride=stride,
                                                   train=train),
        params, state, x, R)
    out, new_state, grad = port_run(module, block_call(train), params, state,
                                    x, R)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    assert rel(grad, jgrad) < 1e-5
    assert sorted(new_state) == sorted(jstate)
    for name, value in jstate.items():
        np.testing.assert_allclose(new_state[name], value, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_relu6_ties_take_the_jax_gradient(dtype):
    values = [-1.0, 0.0, 0.5, 6.0, 7.0, 3.0]
    jgrad = jax.grad(lambda x: jnp.sum(jax_mobilenet._relu6(x)))(
        jnp.asarray(values, dtype))
    x = torch.tensor(values, dtype=getattr(torch, dtype), requires_grad=True)
    out = relu6(x)
    out.sum().backward()
    assert out.dtype == x.dtype
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(jgrad, np.float32))
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  [0.0, 0.5, 1.0, 0.5, 0.0, 1.0])
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  [0.0, 0.0, 0.5, 6.0, 6.0, 3.0])


def test_masks_are_the_jax_draws_from_the_worker_keys():
    S, B = 3, 4
    wkeys = jax.random.split(jax.random.PRNGKey(13), S)
    tkeys = torch_key(wkeys)
    (got,) = models.build(NAME, device="meta").draw_masks(tkeys, B)
    want = np.stack([np.asarray(_dropout_mask(k, 0.8, (B, 1280))) for k in wkeys])
    assert got.shape == (S, B, 1280) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # The plain versions with `j` None draw from the keys as given
    bits = prng_kernels.dropout_masks_plain(tkeys, None, (B, 64), 128)
    np.testing.assert_array_equal(bits.numpy(), np.stack([np.asarray(
        _dropout_mask(k, 0.5, (B, 64))) for k in wkeys]))
    layer = prng_kernels.bernoulli_masks(tkeys, 2, (B, 64), 0.8)
    np.testing.assert_array_equal(layer.numpy(), np.stack([np.asarray(
        _dropout_mask(jax.random.split(k, 3)[2], 0.8, (B, 64))) for k in wkeys]))


def test_whole_model_matches_jax_in_f64(jax_init):
    mdef = jax_models.build(NAME)
    params, state = jax_init
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, 32, 3))
    R = rng.standard_normal((2, 10))
    wkey = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        # The mask the JAX model draws under x64 (a float64 uniform)
        mask = np.asarray(_dropout_mask(wkey, 0.8, (2, 1280)))
    jout, jstate, jgrad = jax_run(
        lambda p, s, x: mdef.apply(p, s, x, train=True, rng=wkey), params,
        state, x, R, jnp.float64)
    module = models.build(NAME, device="cpu", dtype=torch.float64)
    out, new_state, grad = port_run(
        module, model_call(True, (torch.from_numpy(mask.copy()),)), params,
        state, x,
        R, torch.float64)
    assert rel(out, jout) < 1e-6
    assert rel(grad, jgrad) < 1e-4
    assert sorted(new_state) == sorted(jstate)
    for name, value in jstate.items():
        np.testing.assert_allclose(new_state[name], value, rtol=0, atol=1e-6)
