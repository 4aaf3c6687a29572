"""The PyTorch port's `resnet18/34/50/101/152` against the JAX package's
(`byzantinemomentum_tpu/models/resnet.py`), on the CPU.

* Every name builds with the JAX model's parameter names, shapes and
  count, at 10 classes and at torchvision's 1000; `--model-args`'
  `num_classes` reaches the model through `models.build`.
* The blocks at narrow widths against the JAX private functions, in f32:
  `_block_apply` with a projection at stride 2 and without one,
  `_bottleneck_apply` with a projection at stride 2 and without one, in
  train mode (BatchNorm on the batch, its new running state) and in eval
  mode: outputs and BatchNorm state within rtol 1e-5, atol 1e-6, the
  gradient within 1e-5 relative L2. The stem pool (3x3, stride 2, pad
  1, -inf padding) against `_max_pool_3x3s2p1`, forward and gradient,
  exactly, on an even and an odd width.
* The init of resnet18 and resnet50 at full width follows the JAX
  init's keys, shapes and standard deviations bit for bit
  (`tests/torch_zoo.py::assert_init_is_jax`: each normal draw a constant
  that names its key, in both packages); a BasicBlock's and a
  Bottleneck's init with their projections are `_block_init`'s and
  `_bottleneck_init`'s bit for bit, with the port's own draws.
* resnet18 whole at full width, batch 2, train mode, on numpy weights
  from a seed carried across (the Bottleneck is held on its block above, and whole
  on the card against this CPU, `chip_smoke.py`): in float64 in both
  packages, outputs within 1e-6 relative, BatchNorm state within 1e-6
  absolute and the gradient within 1e-4 relative L2. At batch 2 the last
  stage's BatchNorm normalizes two values a channel (1x1 pixels), and
  dividing by their half-difference magnifies every rounding: in f32 the
  JAX package's one-pass variance gives outputs 0.5% away from the port's
  two-pass one (`ROADMAP.md` §3), so the whole model is held in f64,
  where both take the centered form (measured: 6e-12 relative on the
  outputs, 2e-10 on the gradient); f32 is held on the blocks, whose
  batches are larger.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.models import resnet as jax_resnet
from byzantinemomentum_tpu_torch import convert, models, prng
from byzantinemomentum_tpu_torch.models import FlatParams
from byzantinemomentum_tpu_torch.models import resnet
from byzantinemomentum_tpu_torch.models.core import max_pool_3x3s2p1

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_zoo import (assert_init_is_jax, block_call, jax_run,
                             model_call, nchw, nhwc, numpy_params, port_run,
                             rel, to_numpy)

RTOL, ATOL = 1e-5, 1e-6
# torchvision's counts at 1000 classes (`tests/test_resnet.py`)
TORCHVISION = {"resnet18": 11_689_512, "resnet34": 21_797_672,
               "resnet50": 25_557_032, "resnet101": 44_549_160,
               "resnet152": 60_192_808}
LIKE = {"device": "cpu", "dtype": torch.float32}


@pytest.mark.parametrize("name", sorted(TORCHVISION))
def test_names_shapes_and_counts_are_the_jax_models(name):
    for classes in (10, 1000):
        mdef = jax_models.build(name, num_classes=classes)
        module = models.build(name, device="meta", num_classes=classes)
        flat = FlatParams(module)
        assert flat.d == mdef.param_count()
        assert module.fc.w.shape == (module.fc.w.shape[0], classes)
    assert flat.d == TORCHVISION[name]
    assert not hasattr(module, "forward_grouped")


def _block_case(bottleneck, downsample, seed):
    """(JAX init and apply, the port's block, input) at narrow widths."""
    cin, width, stride = (8, 4, 2) if downsample else (16, 4, 1)
    if not bottleneck:
        cin, width = (4, 8) if downsample else (8, 8)
    key = jax.random.PRNGKey(seed)
    if bottleneck:
        params, state = jax_resnet._bottleneck_init(key, cin, width, downsample)
        apply = jax_resnet._bottleneck_apply
    else:
        params, state = jax_resnet._block_init(key, cin, width, downsample)
        apply = jax_resnet._block_apply
    # Running statistics away from the fresh (0, 1), so eval mode tests them
    rng = np.random.default_rng(seed)
    state = {name: {"mean": rng.standard_normal(s["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)}
             for name, s in state.items()}
    module = resnet._Block(cin, width, stride, downsample, bottleneck, LIKE)
    x = rng.standard_normal((4, 8, 8, cin)).astype(np.float32)
    return to_numpy(params), state, apply, stride, module, x, rng


@pytest.mark.parametrize("bottleneck", (False, True))
@pytest.mark.parametrize("downsample", (True, False))
@pytest.mark.parametrize("train", (True, False))
def test_block_matches_jax(bottleneck, downsample, train):
    params, state, apply, stride, module, x, rng = _block_case(
        bottleneck, downsample, 3 + 2 * bottleneck + downsample)
    assert (module.down is None) != downsample
    cout = params["bn2" if not bottleneck else "bn3"]["gamma"].shape[0]
    R = rng.standard_normal((4, 8 // stride, 8 // stride, cout)).astype(np.float32)
    jout, jstate, jgrad = jax_run(
        lambda p, s, x: apply(p, s, x, stride=stride, train=train),
        params, state, x, R)
    out, new_state, grad = port_run(module, block_call(train), params, state,
                                    x, R)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    assert rel(grad, jgrad) < 1e-5
    assert sorted(new_state) == sorted(jstate)
    for name, value in jstate.items():
        np.testing.assert_allclose(new_state[name], value, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", (8, 7))
def test_stem_pool_matches_jax(size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    jout, vjp = jax.vjp(jax_resnet._max_pool_3x3s2p1, jnp.asarray(x))
    R = np.random.default_rng(size + 1).standard_normal(jout.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(R))
    xt = torch.from_numpy(nchw(x)).requires_grad_()
    out = max_pool_3x3s2p1(xt)
    (out * torch.from_numpy(nchw(R))).sum().backward()
    np.testing.assert_array_equal(nhwc(out.detach().numpy()), np.asarray(jout))
    np.testing.assert_array_equal(nhwc(xt.grad.numpy()), np.asarray(jgrad))


@pytest.mark.parametrize("name", ("resnet18", "resnet50"))
def test_init_is_the_jax_init(monkeypatch, name):
    assert_init_is_jax(monkeypatch, jax_models.build(name),
                       models.build(name, device="cpu"), seed=4)


@pytest.mark.parametrize("bottleneck", (False, True))
def test_block_init_is_the_jax_init(bottleneck):
    """A block with a projection draws its convolutions from the JAX
    block's keys, the projection from the last (key 2 of 3, 3 of 4)."""
    params, state, _, stride, module, _, _ = _block_case(bottleneck, True, 9)
    module.init(prng.PRNGKey(9))
    theta, _ = convert.params_from_jax(params, state)
    got = FlatParams(module).flatten(dict(module.named_parameters())).detach()
    assert torch.equal(got.view(torch.int32), theta.view(torch.int32))


@pytest.mark.parametrize("name", ("resnet18",))
def test_whole_model_matches_jax_in_f64(name):
    mdef = jax_models.build(name)
    params, state = numpy_params(mdef, 3)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 32, 3))
    R = rng.standard_normal((2, 10))
    jout, jstate, jgrad = jax_run(
        lambda p, s, x: mdef.apply(p, s, x, train=True), params, state, x, R,
        jnp.float64)
    module = models.build(name, device="cpu", dtype=torch.float64)
    out, new_state, grad = port_run(module, model_call(True), params, state,
                                    x, R, torch.float64)
    assert rel(out, jout) < 1e-6
    assert rel(grad, jgrad) < 1e-4
    assert sorted(new_state) == sorted(jstate)
    for name_, value in jstate.items():
        np.testing.assert_allclose(new_state[name_], value, rtol=0, atol=1e-6)
