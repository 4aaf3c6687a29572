"""The PyTorch port's `wide_resnet-Wide_ResNet` against the JAX package's,
on the CPU, at depth 10 (one block a group) and widen 1 or 2.

* `init(key)` gives the JAX init bit for bit (the flat vector in
  `ravel_pytree`'s order and the BatchNorm state) at depth 10, widen 1
  and 2, and at depth 16; at depth 28, widen 10 the names and shapes
  alone (`jax.eval_shape`): d = 36,489,290 and 17,952 BatchNorm state
  values.
* The keep-masks of `draw_masks` equal the JAX model's draws
  (`_dropout_mask` on key j of `split(wkey, 3 * n_blocks)`, keep 0.7
  through `jax.random.bernoulli`) bit for bit, for S workers at once;
  `prng_kernels.bernoulli_threshold` is what the card's kernel compares:
  `bits >> 9 < T` equals the float32 uniform below float32(p) for a
  sweep of rates.
* One worker's train-mode forward, loss and flat gradient against the
  JAX model's on the same weights, inputs and keys: f32 outputs and
  BatchNorm state within rtol 1e-4, atol 1e-5 and the gradient row within
  1e-4 relative L2 (no max-pool, so no near tie; the convolutions sum in
  another order); eval mode the same. In bf16 compute (f32 parameters,
  the engine's mixed precision) the port's row is no farther from the
  JAX f32 row than 1.5x the JAX bf16 row's distance, and within 2x that
  distance of the JAX bf16 row (`tests/test_torch_dtype.py`'s bound),
  outputs within 5e-2.
* `forward_grouped` against S calls of `forward` and against the JAX
  `apply_grouped`, with shared and with per-worker weights: outputs,
  BatchNorm states (S, C) and the gradient rows at the f32 bounds above.
* The strided SAME padding: a stride-2 3x3 SAME convolution and a 1x1
  VALID stride-2 one, on an even (8) and an odd (7) width, against
  `lax.conv_general_dilated` (XLA pads 0 before and 1 after on the even
  width): `Conv` and `grouped_conv` (shared and per worker) forwards and
  the input, kernel and bias gradients within rtol 1e-5, atol 1e-6.
* `dropout_apply` under bf16 divides by bf16(0.7) = 0.69921875, as JAX
  applies the weak Python scalar: bit-equal to the JAX `dropout_apply`.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.losses import Loss as JaxLoss
from byzantinemomentum_tpu.models.core import _dropout_mask
from byzantinemomentum_tpu.models.core import dropout_apply as jax_dropout_apply
from byzantinemomentum_tpu_torch import convert, models, prng
from byzantinemomentum_tpu_torch.losses import Loss
from byzantinemomentum_tpu_torch.models import FlatParams
from byzantinemomentum_tpu_torch.models.core import (
    Conv, dropout_apply, grouped_conv, same_pads)
from byzantinemomentum_tpu_torch.ops import prng_kernels

from tests.torch_threads import one_torch_thread  # noqa: F401

NAME = "wide_resnet-Wide_ResNet"
RTOL, ATOL = 1e-4, 1e-5
B = 2


def _args(depth=10, widen_factor=1):
    return {"depth": depth, "widen_factor": widen_factor, "dropout_rate": 0.3,
            "num_classes": 10}


def _models(seed=0, **kwargs):
    """The JAX model's (params, state) from `PRNGKey(seed)` as numpy, and
    the port's model from the same key."""
    mdef = jax_models.build(NAME, **_args(**kwargs))
    params, state = mdef.init(jax.random.PRNGKey(seed))
    module = models.build(NAME, device="cpu", **_args(**kwargs))
    module.init(prng.PRNGKey(seed))
    return (mdef, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), module)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("depth,widen", ((10, 1), (10, 2), (16, 1)))
def test_init_is_the_jax_init(depth, widen):
    _, params, state, module = _models(3, depth=depth, widen_factor=widen)
    flat = FlatParams(module)
    theta, bn = convert.params_from_jax(params, state)
    assert flat.names == [name for name, _ in convert.flat_items(params)]
    got = flat.flatten(dict(module.named_parameters())).detach()
    assert torch.equal(got.view(torch.int32), theta.view(torch.int32))
    buffers = dict(module.named_buffers())
    assert sorted(buffers) == sorted(bn)
    for name, value in bn.items():
        assert torch.equal(buffers[name], value)


def test_wrn_28_10_names_and_shapes_are_the_jax_models():
    mdef = jax_models.build(NAME, **_args(28, 10))
    params, state = jax.eval_shape(mdef.init, jax.random.PRNGKey(0))
    module = models.build(NAME, device="meta", **_args(28, 10))
    flat = FlatParams(module)
    items = list(convert.flat_items(params))
    assert flat.names == [name for name, _ in items]
    assert flat.shapes == [tuple(leaf.shape) for _, leaf in items]
    assert flat.d == 36_489_290
    buffers = {name: tuple(b.shape) for name, b in module.named_buffers()}
    assert buffers == {name: tuple(leaf.shape)
                       for name, leaf in convert.flat_items(state)}
    assert sum(np.prod(shape) for shape in buffers.values()) == 17_952
    assert module.jax_mask_shapes(20) == tuple(
        (20, size, size, width) for size, width in
        ((32, 160),) * 4 + ((16, 320),) * 4 + ((8, 640),) * 4)


@pytest.mark.parametrize("widen", (1, 2))
def test_masks_are_the_jax_draws(widen):
    S = 3
    module = models.build(NAME, device="cpu", **_args(widen_factor=widen))
    wkeys = jax.random.split(jax.random.PRNGKey(11), S)
    got = module.draw_masks(torch.from_numpy(np.asarray(wkeys).astype(np.int64)), B)
    shapes = module.jax_mask_shapes(B)
    assert len(got) == 3
    for j, shape in enumerate(shapes):
        want = np.stack([np.asarray(_dropout_mask(
            jax.random.split(k, len(shapes))[j], 0.7, shape)) for k in wkeys])
        assert got[j].shape == (S, B, shape[3], shape[1], shape[2])
        np.testing.assert_array_equal(got[j].numpy(), want.transpose(0, 1, 4, 2, 3))


@pytest.mark.parametrize("p", (0.7, 0.3, 0.5, 0.9, 1e-7, 2.0**-23, 0.999999,
                               1.0, 0.0, 1.5, -0.5))
def test_bernoulli_threshold_is_the_uniform_compare(p):
    """`bits >> 9 < T` is `uniform < float32(p)` on every draw of a key,
    and at the significands next to T."""
    key = prng.PRNGKey(int(abs(p) * 1e6) + 1)
    T = prng_kernels.bernoulli_threshold(p)
    bits = prng.random_bits(key, (50_000,))
    want = prng.bernoulli(key, p, (50_000,))
    assert torch.equal((bits >> 9) < T, want)
    p32 = torch.tensor(p, dtype=torch.float32)
    for m in (T - 1, T, T + 1):
        if 0 <= m < 2**23:
            u = torch.tensor(m * 2.0**-23, dtype=torch.float32)
            assert bool(u < p32) == (m < T)


def _jax_worker(mdef, params, state, x, y, key, cdtype, train=True):
    """One worker's (loss, log-probabilities, new state, flat gradient) in
    the JAX package, parameters and inputs cast to `cdtype` as its
    engine casts them."""
    theta, unravel = jax.flatten_util.ravel_pytree(params)
    loss_fn = JaxLoss("nll")

    def scalar_loss(th):
        p = jax.tree.map(lambda leaf: leaf.astype(cdtype), unravel(th))
        out, new_state = mdef.apply(p, state, jnp.asarray(x).astype(cdtype),
                                    train=train, rng=key if train else None)
        return loss_fn(out, jnp.asarray(y), th), (out, new_state)

    (loss, (out, new_state)), grad = jax.jit(jax.value_and_grad(
        scalar_loss, has_aux=True))(theta)
    return (np.asarray(loss, np.float32), np.asarray(out.astype(jnp.float32)),
            jax.tree.map(np.asarray, new_state), np.asarray(grad))


def _port_worker(module, params, state, x, y, key, cdtype, train=True):
    flat = FlatParams(module)
    theta, bn = convert.params_from_jax(params, state)
    th = theta.clone().requires_grad_()
    masks = (tuple(m[0] for m in module.draw_masks(key[None], B))
             if train else None)
    out, new_state = torch.func.functional_call(
        module, {**flat.unflatten(th.to(cdtype)), **bn},
        (torch.from_numpy(x).to(cdtype),), {"train": train, "masks": masks})
    loss = Loss("nll")(out, torch.from_numpy(y), th)
    (grad,) = torch.autograd.grad(loss, th)
    new_state = {f"{layer}.{stat}": value.detach().numpy()
                 for layer, stats in new_state.items()
                 for stat, value in stats.items()}
    return (float(loss.detach().float()), out.detach().float().numpy(), new_state,
            grad.numpy())


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=B).astype(np.int32))


@pytest.mark.parametrize("widen", (1, 2))
@pytest.mark.parametrize("train", (True, False))
def test_forward_loss_and_gradient_match_jax(widen, train):
    mdef, params, state, module = _models(5, widen_factor=widen)
    x, y = _inputs(widen)
    key = jax.random.PRNGKey(21)
    jloss, jout, jstate, jgrad = _jax_worker(mdef, params, state, x, y, key,
                                             jnp.float32, train)
    loss, out, new_state, grad = _port_worker(
        module, params, state, x, y, torch.from_numpy(np.asarray(key).astype(np.int64)),
        torch.float32, train)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    assert _rel(grad, jgrad) < 1e-4
    for name, value in convert.flat_items(jstate):
        np.testing.assert_allclose(new_state[name], value, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("widen", (1, 2))
def test_bf16_forward_and_gradient_track_jax(widen):
    mdef, params, state, module = _models(6, widen_factor=widen)
    x, y = _inputs(10 + widen)
    key = jax.random.PRNGKey(22)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    *_, jgrad32 = _jax_worker(mdef, params, state, x, y, key, jnp.float32)
    _, jout, _, jgrad = _jax_worker(mdef, params, state, x, y, key, jnp.bfloat16)
    _, out, _, grad = _port_worker(module, params, state, x, y, tkey,
                                   torch.bfloat16)
    *_, grad32 = _port_worker(module, params, state, x, y, tkey, torch.float32)
    err = _rel(jgrad, jgrad32)
    assert 0 < err < 0.3  # bf16 engaged, not garbage
    assert _rel(grad, grad32) <= 1.5 * err
    assert _rel(grad, jgrad) <= 2.0 * err
    np.testing.assert_allclose(out, jout, rtol=5e-2, atol=5e-2)


def _stack_params(params_list):
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *params_list)


@pytest.mark.parametrize("shared", (True, False))
def test_forward_grouped_matches_forward_and_apply_grouped(shared):
    S = 3
    mdef = jax_models.build(NAME, **_args())
    keys = jax.random.split(jax.random.PRNGKey(8), S)
    inits = [mdef.init(keys[0 if shared else s]) for s in range(S)]
    params = [jax.tree.map(np.asarray, p) for p, _ in inits]
    rng = np.random.default_rng(9)
    state = jax.tree.map(lambda leaf: rng.uniform(0.5, 1.5, leaf.shape).astype(
        np.float32), inits[0][1])
    xs = rng.standard_normal((S, B, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, B)).astype(np.int32)
    wkeys = jax.random.split(jax.random.PRNGKey(10), S)
    nll = JaxLoss("nll")

    def loss_j(params_s):
        out, new_state = mdef.apply_grouped(params_s, state, jnp.asarray(xs),
                                            train=True, rng=wkeys)
        losses = jax.vmap(lambda o, y: nll(o, y, None))(out, jnp.asarray(ys))
        return jnp.sum(losses), (out, new_state)

    (_, (jout, jstate)), jgrads = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(_stack_params(params))
    jrows = np.stack([np.asarray(jax.flatten_util.ravel_pytree(
        jax.tree.map(lambda leaf, s=s: leaf[s], jgrads))[0]) for s in range(S)])

    module = models.build(NAME, device="cpu", **_args())
    flat = FlatParams(module)
    theta_s = torch.stack([convert.params_from_jax(p, state)[0] for p in params])
    bn = convert.params_from_jax(params[0], state)[1]
    masks = module.draw_masks(torch.from_numpy(np.asarray(wkeys).astype(np.int64)), B)
    th_s = theta_s.clone().requires_grad_()
    out, new_state = module.forward_grouped(
        flat.unflatten_stacked(th_s), bn, torch.from_numpy(xs), True, masks,
        shared=shared)
    losses = torch.func.vmap(Loss("nll"))(out, torch.from_numpy(ys), th_s)
    (rows,) = torch.autograd.grad(losses.sum(), th_s)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    for s in range(S):
        assert _rel(rows[s], jrows[s]) < 1e-4
    for name, value in convert.flat_items(jax.tree.map(np.asarray, jstate)):
        np.testing.assert_allclose(new_state[name].numpy(), value, rtol=RTOL,
                                   atol=ATOL)

    # S calls of the port's own forward give the same function
    for s in range(S):
        th = theta_s[s].clone().requires_grad_()
        out_s, state_s = torch.func.functional_call(
            module, {**flat.unflatten(th), **bn}, (torch.from_numpy(xs[s]),),
            {"train": True, "masks": tuple(m[s] for m in masks)})
        (row,) = torch.autograd.grad(
            Loss("nll")(out_s, torch.from_numpy(ys[s]), th), th)
        np.testing.assert_allclose(out[s].detach().numpy(), out_s.detach().numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert _rel(rows[s], row) < 1e-4
        for layer, stats in state_s.items():
            for stat, value in stats.items():
                np.testing.assert_allclose(new_state[f"{layer}.{stat}"][s].numpy(),
                                           value.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", (8, 7))
@pytest.mark.parametrize("k,padding", ((3, "SAME"), (1, "VALID")))
def test_strided_convolutions_pad_as_xla(size, k, padding):
    S, Bc, cin, cout, stride = 3, 2, 4, 5, 2
    rng = np.random.default_rng(size * k)
    x = rng.standard_normal((S, Bc, size, size, cin)).astype(np.float32)
    w = rng.standard_normal((S, k, k, cin, cout)).astype(np.float32)
    b = rng.standard_normal((S, cout)).astype(np.float32)
    gy = rng.standard_normal((S, Bc, -(-size // stride), -(-size // stride),
                              cout)).astype(np.float32)
    if padding == "SAME":
        assert same_pads(8, 3, 2) == (0, 1) and same_pads(7, 3, 2) == (1, 1)

    def conv_j(x, w, b):
        return lax.conv_general_dilated(
            x, w, (stride, stride), padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    def loss_j(x, w, b):
        out = jax.vmap(conv_j)(x, w, b)
        return jnp.sum(out * gy), out

    (_, jout), jgrads = jax.value_and_grad(loss_j, argnums=(0, 1, 2),
                                           has_aux=True)(x, w, b)
    jout = np.asarray(jout).transpose(0, 1, 4, 2, 3)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    # One worker's `Conv`
    conv = Conv(cin, cout, k, padding.lower(), stride)
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w[0]))
        conv.b.copy_(torch.from_numpy(b[0]))
    close(conv(torch.from_numpy(x[0]).permute(0, 3, 1, 2)).detach().numpy(),
          jout[0])
    # The grouped layers, per worker and shared (worker 0's weights)
    for shared in (False, True):
        ws = np.broadcast_to(w[:1], w.shape).copy() if shared else w
        bs = np.broadcast_to(b[:1], b.shape).copy() if shared else b
        if shared:
            (_, jout_s), jgrads_s = jax.value_and_grad(
                loss_j, argnums=(0, 1, 2), has_aux=True)(x, ws, bs)
            want_out = np.asarray(jout_s).transpose(0, 1, 4, 2, 3)
        else:
            want_out, jgrads_s = jout, jgrads
        xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3).flatten(0, 1)
        xt = xt.contiguous().requires_grad_()
        wt = torch.from_numpy(ws).requires_grad_()
        bt = torch.from_numpy(bs).requires_grad_()
        out = grouped_conv(xt, wt, bt, shared, padding.lower(), stride)
        close(out.detach().view(want_out.shape).numpy(), want_out)
        gyt = torch.from_numpy(gy).permute(0, 1, 4, 2, 3).flatten(0, 1)
        out.backward(gyt)
        close(xt.grad.view(S, Bc, cin, size, size).numpy(),
              np.asarray(jgrads_s[0]).transpose(0, 1, 4, 2, 3))
        close(wt.grad.numpy(), np.asarray(jgrads_s[1]))
        close(bt.grad.numpy(), np.asarray(jgrads_s[2]))


def test_dropout_divides_by_the_keep_rate_in_the_activation_dtype():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    mask = rng.random((4, 64)) < 0.7
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jnp.where(jnp.asarray(mask), xj / 0.7, 0.0)
    # JAX's own dropout_apply: the same where on its mask
    key = jax.random.PRNGKey(2)
    jmask = np.array(_dropout_mask(key, 0.7, (4, 64)))
    jdrop = jax_dropout_apply(key, xj, 0.3, train=True)
    got = dropout_apply(torch.from_numpy(mask),
                        torch.from_numpy(x).to(torch.bfloat16), 0.3)
    got_j = dropout_apply(torch.from_numpy(jmask),
                          torch.from_numpy(x).to(torch.bfloat16), 0.3)
    for port, jax_out in ((got, want), (got_j, jdrop)):
        assert port.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            port.view(torch.int16).numpy(),
            np.asarray(jax_out).view(np.int16))
