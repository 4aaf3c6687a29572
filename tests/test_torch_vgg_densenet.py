"""The PyTorch port's `vgg11/13/16/19` and `densenet121/169/201` against the
JAX package's (`byzantinemomentum_tpu/models/vgg.py`, `densenet.py`), on
the CPU.

* Every name builds with the JAX model's parameter names, shapes and
  count, at 10 classes and at torchvision's 1000.
* VGG: `adaptive_avg_pool` against the JAX function on an NCHW
  activation of 1x1 (replicated to 7x7), 2x2, 9x9 and 14x14 pixels,
  forward and gradient within rtol 1e-6, atol 1e-7 (the forward exactly
  at 1x1 and 14x14, and the gradient at 14x14: one window a pixel); the classifier's two keep-masks are the JAX model's draws,
  keys 0 and 1 of `split(wkey, 2)` at keep 0.5 (`bits8 < 128`), bit for
  bit for S workers; vgg16's init at full width follows the JAX init's
  keys, shapes and scales bit for bit (`tests/torch_zoo.py::
  assert_init_is_jax`), and a conv's and a classifier layer's own draws
  are `_conv_init`'s and `_fc_init`'s bit for bit at narrow widths; vgg16
  whole at full width, batch 2, train mode with the masks of the worker
  key, on numpy weights from a seed carried across, in f32:
  outputs within rtol 1e-4, atol 1e-5, the gradient within 1e-4 relative
  L2 (the NHWC flatten before `fc0` included: an NCHW one would move the
  outputs by their whole size).
* DenseNet: a dense layer (`_layer_apply`) and a transition (BatchNorm,
  ReLU, the 1x1 convolution, the 2x2 window sum over 4.0, written here
  from the JAX module's own pieces) at narrow widths, train and eval
  mode, in f32: outputs and BatchNorm state within rtol 1e-5, atol 1e-5
  (the 3x3 convolution sums 1,152 terms a value, in another order),
  the gradient within 1e-5 relative L2; densenet121's init at full width
  as vgg16's, and a dense layer's own draws `_layer_init`'s bit for bit;
  densenet121 whole at full width, batch 2, train mode, in
  float64 in both packages (`tests/test_torch_resnet.py` says why):
  outputs within 1e-6 relative, BatchNorm state within 1e-6 absolute,
  the gradient within 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.models import densenet as jax_densenet
from byzantinemomentum_tpu.models import vgg as jax_vgg
from byzantinemomentum_tpu.models.core import (
    _dropout_mask, batchnorm_apply, batchnorm_init)
from byzantinemomentum_tpu_torch import convert, models, prng
from byzantinemomentum_tpu_torch.models import FlatParams, densenet
from byzantinemomentum_tpu_torch.models.core import Dense, PaddedConv
from byzantinemomentum_tpu_torch.models.vgg import adaptive_avg_pool
from byzantinemomentum_tpu_torch.utils import weak_scalar

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_zoo import (assert_init_is_jax, block_call, jax_run,
                             model_call, nchw, nhwc, numpy_params, port_run,
                             rel, to_numpy, torch_key)

RTOL = 1e-5
# torchvision's counts at 1000 classes (`tests/test_vgg_densenet.py`)
TORCHVISION = {"vgg11": 132_863_336, "vgg13": 133_047_848,
               "vgg16": 138_357_544, "vgg19": 143_667_240,
               "densenet121": 7_978_856, "densenet169": 14_149_480,
               "densenet201": 20_013_928}
LIKE = {"device": "cpu", "dtype": torch.float32}


@pytest.mark.parametrize("name", sorted(TORCHVISION))
def test_names_shapes_and_counts_are_the_jax_models(name):
    for classes in (10, 1000):
        mdef = jax_models.build(name, num_classes=classes)
        params, state = jax.eval_shape(mdef.init, jax.random.PRNGKey(0))
        module = models.build(name, device="meta", num_classes=classes)
        flat = FlatParams(module)
        items = list(convert.flat_items(params))
        assert flat.names == [leaf_name for leaf_name, _ in items]
        assert flat.shapes == [tuple(leaf.shape) for _, leaf in items]
        assert flat.d == mdef.param_count()
        buffers = {b: tuple(v.shape) for b, v in module.named_buffers()}
        assert buffers == {b: tuple(leaf.shape)
                           for b, leaf in convert.flat_items(state)}
    assert flat.d == TORCHVISION[name]


@pytest.mark.parametrize("size", (1, 2, 9, 14))
def test_adaptive_avg_pool_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    jout, vjp = jax.vjp(lambda x: jax_vgg.adaptive_avg_pool(x, (7, 7)),
                        jnp.asarray(x))
    R = rng.standard_normal(jout.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(R))
    xt = torch.from_numpy(nchw(x)).requires_grad_()
    out = adaptive_avg_pool(xt, (7, 7))
    (out * torch.from_numpy(nchw(R))).sum().backward()
    exact, close = {"rtol": 0, "atol": 0}, {"rtol": 1e-6, "atol": 1e-7}
    np.testing.assert_allclose(nhwc(out.detach().numpy()), jout,
                               **(exact if size in (1, 14) else close))
    # At 1x1 a pixel's gradient sums its 49 copies, in another order
    np.testing.assert_allclose(nhwc(xt.grad.numpy()), jgrad,
                               **(exact if size == 14 else close))


def test_vgg_masks_are_the_jax_draws():
    S, B = 3, 2
    wkeys = jax.random.split(jax.random.PRNGKey(17), S)
    got = models.build("vgg16", device="meta").draw_masks(torch_key(wkeys), B)
    assert len(got) == 2
    for j, mask in enumerate(got):
        want = np.stack([np.asarray(_dropout_mask(
            jax.random.split(k, 2)[j], 0.5, (B, 4096))) for k in wkeys])
        assert mask.shape == (S, B, 4096) and mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), want)


@pytest.mark.parametrize("name", ("vgg16", "densenet121"))
def test_init_is_the_jax_init(monkeypatch, name):
    assert_init_is_jax(monkeypatch, jax_models.build(name),
                       models.build(name, device="cpu"), seed=4)


@pytest.mark.parametrize("part", ("conv", "fc", "layer"))
def test_init_helpers_are_the_jax_draws(part):
    """A layer's own draws at a narrow width, bit for bit: VGG's conv
    (kaiming fan_out, zero bias) and classifier (0.01 normal, zero bias)
    and DenseNet's layer (two fan_in convs from `split(key)`)."""
    key = jax.random.PRNGKey(29)
    if part == "conv":
        want = jax_vgg._conv_init(key, 6, 8)
        module = PaddedConv(6, 8, 3, pad=1, bias=True, **LIKE)
        module.init_normal(torch_key(key), np.sqrt(2.0 / (9 * 8)))
    elif part == "fc":
        want = jax_vgg._fc_init(key, 12, 7)
        module = Dense(12, 7, **LIKE)
        with torch.no_grad():
            module.w.copy_(weak_scalar(0.01, torch.float32) * prng.normal(
                torch_key(key), (12, 7)))
            module.b.zero_()
    else:
        want, _ = jax_densenet._layer_init(key, 10)
        module = densenet._Layer(10, LIKE)
        module.init(torch_key(key))
    theta, _ = convert.params_from_jax(to_numpy(want), {})
    got = FlatParams(module).flatten(dict(module.named_parameters())).detach()
    assert torch.equal(got.view(torch.int32), theta.view(torch.int32))


def test_vgg16_matches_jax():
    mdef = jax_models.build("vgg16")
    params, state = numpy_params(mdef, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    R = rng.standard_normal((2, 10)).astype(np.float32)
    wkey = jax.random.PRNGKey(19)
    module = models.build("vgg16", device="cpu")
    masks = tuple(m[0] for m in module.draw_masks(torch_key(wkey)[None], 2))
    jout, _, jgrad = jax_run(
        lambda p, s, x: mdef.apply(p, s, x, train=True, rng=wkey), params,
        state, x, R)
    out, new_state, grad = port_run(module, model_call(True, masks), params,
                                    state, x, R)
    assert new_state == {}
    np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-5)
    assert rel(grad, jgrad) < 1e-4


def _transition_apply(params, state, x, *, train):
    """The JAX model's transition, from its own pieces."""
    x, bn = batchnorm_apply(params["bn"], state["bn"], x, train=train)
    x = jax_densenet._conv(params["conv"], jax.nn.relu(x))
    x = lax.reduce_window(x, 0.0, lax.add, window_dimensions=(1, 2, 2, 1),
                          window_strides=(1, 2, 2, 1), padding="VALID") / 4.0
    return x, {"bn": bn}


@pytest.mark.parametrize("part", ("layer", "transition"))
@pytest.mark.parametrize("train", (True, False))
def test_densenet_layer_and_transition_match_jax(part, train):
    cin = 12
    key = jax.random.PRNGKey(23)
    rng = np.random.default_rng(23)
    if part == "layer":
        params, state = jax_densenet._layer_init(key, cin)
        apply, module = jax_densenet._layer_apply, densenet._Layer(cin, LIKE)
        cout, size = 32, 6
    else:
        params, state = {}, {}
        params["bn"], state["bn"] = batchnorm_init(cin)
        params["conv"] = jax_densenet._conv_init(key, 1, 1, cin, cin // 2)
        apply, module = _transition_apply, densenet._Transition(cin, LIKE)
        cout, size = cin // 2, 3
    state = {name: {"mean": rng.standard_normal(s["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)}
             for name, s in state.items()}
    params = to_numpy(params)
    x = rng.standard_normal((4, 6, 6, cin)).astype(np.float32)
    R = rng.standard_normal((4, size, size, cout)).astype(np.float32)
    jout, jstate, jgrad = jax_run(
        lambda p, s, x: apply(p, s, x, train=train), params, state, x, R)
    out, new_state, grad = port_run(module, block_call(train), params, state,
                                    x, R)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=1e-5)
    assert rel(grad, jgrad) < 1e-5
    assert sorted(new_state) == sorted(jstate)
    for name, value in jstate.items():
        np.testing.assert_allclose(new_state[name], value, rtol=RTOL, atol=1e-5)


def test_densenet121_matches_jax_in_f64():
    mdef = jax_models.build("densenet121")
    params, state = numpy_params(mdef, 4)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 3))
    R = rng.standard_normal((2, 10))
    jout, jstate, jgrad = jax_run(
        lambda p, s, x: mdef.apply(p, s, x, train=True), params, state, x, R,
        jnp.float64)
    module = models.build("densenet121", device="cpu", dtype=torch.float64)
    out, new_state, grad = port_run(module, model_call(True), params, state,
                                    x, R, torch.float64)
    assert rel(out, jout) < 1e-6
    assert rel(grad, jgrad) < 1e-4
    assert sorted(new_state) == sorted(jstate)
    for name, value in jstate.items():
        np.testing.assert_allclose(new_state[name], value, rtol=0, atol=1e-6)
