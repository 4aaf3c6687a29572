"""Shared helpers of the port's model-zoo tests (`tests/test_torch_resnet.py`,
`test_torch_vgg_densenet.py`, `test_torch_mobilenet.py`,
`test_torch_transformer.py`): one function or module run in both packages
on the same numpy weights and inputs.

The objective is `sum(outputs * R)` for a fixed numpy `R` (the outputs'
shape, NHWC for an activation), so its gradient reaches every parameter
whatever the model returns (raw logits or log-probabilities). Activations
are NHWC in the JAX package and NCHW in the port: `port_run` permutes the
input, `R` and the output.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import torch

from byzantinemomentum_tpu_torch import convert, prng
from byzantinemomentum_tpu_torch.models import FlatParams


def rel(got, want):
    """The relative L2 distance of `got` from `want`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_run(apply, params, state, x, R, dtype=jnp.float32):
    """`apply(params, state, x) -> (out, new_state)` of the JAX package on
    the numpy `params`, `state` and `x` cast to `dtype` (under x64 for
    float64); returns numpy `(out, flat new state {"bn1.mean": ...},
    flat gradient of sum(out * R) in ravel_pytree order)`."""
    def run():
        p, s = jax.tree.map(lambda a: jnp.asarray(a, dtype), (params, state))
        theta, unravel = jax.flatten_util.ravel_pytree(p)

        def objective(th):
            out, new_state = apply(unravel(th), s, jnp.asarray(x, dtype))
            return jnp.sum(out * jnp.asarray(R, dtype)), (out, new_state)

        # LLVM's backend passes at their cheapest: most of a full-width
        # model's time here is XLA's compile
        (_, (out, new_state)), grad = jax.jit(jax.value_and_grad(
            objective, has_aux=True)).lower(theta).compile(
                compiler_options={"xla_backend_optimization_level": 0,
                                  "xla_llvm_disable_expensive_passes": True})(
                    theta)
        return (np.asarray(out.astype(jnp.float64 if dtype == jnp.float64
                                      else jnp.float32)),
                dict(convert.flat_items(to_numpy(new_state))),
                np.asarray(grad.astype(jnp.float32) if dtype == jnp.bfloat16
                           else grad))

    if dtype == jnp.float64:
        with jax.enable_x64(True):
            return run()
    return run()


def nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def nhwc(a):
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def port_run(module, call, params, state, x, R, dtype=torch.float32):
    """`call(module, named params and buffers, x) -> (out, new_state)`
    of the port on the same numpy weights (carried across by
    `convert.params_from_jax`) and inputs, in `dtype`; returns numpy
    `(out NHWC, flat new state, flat gradient)` as `jax_run`."""
    flat = FlatParams(module)
    theta, bn = convert.params_from_jax(params, state, dtype=dtype)
    assert flat.names == [name for name, _ in convert.flat_items(params)]
    theta.requires_grad_()
    out, new_state = call(module, {**flat.unflatten(theta), **bn},
                          torch.from_numpy(nchw(x)).to(dtype))
    (out * torch.from_numpy(nchw(R)).to(dtype)).sum().backward()
    new_state = {f"{layer}.{stat}": value.detach().double().numpy()
                 for layer, stats in new_state.items()
                 for stat, value in stats.items()}
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    return (nhwc(out.detach().to(wide).numpy()), new_state,
            theta.grad.to(wide).numpy())


def block_call(train):
    """`port_run`'s call for a block module `forward(x, train, name,
    new_state)`: its new state keyed as the JAX block's (`bn1`, ...)."""
    def call(module, named, x):
        new_state = {}
        out = torch.func.functional_call(module, named,
                                         (x, train, "block", new_state))
        return out, {name.removeprefix("block."): stats
                     for name, stats in new_state.items()}
    return call


def model_call(train, masks=None):
    """`port_run`'s call for a whole model on NHWC inputs (`port_run`
    hands it NCHW: permuted back here)."""
    def call(module, named, x):
        x = x.permute(0, 2, 3, 1) if x.dim() == 4 else x
        return torch.func.functional_call(module, named, (x,),
                                          {"train": train, "masks": masks})
    return call


def torch_key(key):
    """A JAX key as the port's int64[2] words."""
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _fingerprint(words):
    """A float32 value in [0.5, 1.5) that names a key's two words."""
    k0, k1 = (int(w) & 0xFFFFFFFF for w in words)
    return float(np.float32(((k0 * 40503 + k1) % 65536) / 65536.0 + 0.5))


def assert_init_is_jax(monkeypatch, mdef, module, seed):
    """`module.init(PRNGKey(seed))` follows the JAX `mdef.init`'s key
    indices, shapes and scales bit for bit: in both packages every normal
    draw is replaced by a constant leaf that names its key
    (`_fingerprint`), so a leaf drawn from another key, in another shape
    or at another scale differs, while a full-width model inits in
    seconds (`prng.normal` itself is held to `jax.random.normal` in
    `tests/test_torch_prng.py`, and each family's own draws on a block,
    and on the card against this CPU in `chip_smoke.py`). Uniform draws
    (the dense layers' `dense_init`) stay real. The JAX init runs op by
    op, as the JAX driver runs it."""
    def port_normal(key, shape, dtype=torch.float32):
        return torch.full(tuple(shape), _fingerprint(key.tolist()),
                          dtype=torch.float32, device=key.device)

    def jax_normal(key, shape=(), dtype=jnp.float32):
        return jnp.full(shape, _fingerprint(np.asarray(key)), dtype)

    monkeypatch.setattr(prng, "normal", port_normal)
    monkeypatch.setattr(jax.random, "normal", jax_normal)
    module.init(prng.PRNGKey(seed))
    params, state = to_numpy(mdef.init(jax.random.PRNGKey(seed)))
    monkeypatch.undo()
    theta, bn = convert.params_from_jax(params, state)
    flat = FlatParams(module)
    got = flat.flatten(dict(module.named_parameters())).detach()
    assert flat.d == theta.numel()
    assert torch.equal(got.view(torch.int32), theta.view(torch.int32))
    buffers = dict(module.named_buffers())
    assert sorted(buffers) == sorted(bn)
    for name, value in bn.items():
        assert torch.equal(buffers[name], value)


def numpy_params(mdef, seed):
    """Numpy weights from `seed` in the JAX model's pytree (its
    `eval_shape`): kernels and dense weights normal over sqrt(fan_in / 2),
    BatchNorm and LayerNorm gains 1 + 0.1 normal, every other vector 0.1
    normal; fresh BatchNorm state (mean 0, var 1)."""
    rng = np.random.default_rng(seed)
    shapes, state = jax.eval_shape(mdef.init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            return z * np.float32(np.sqrt(2.0 / np.prod(leaf.shape[:-1])))
        gain = "gamma" in name or name.endswith("['g']")
        return np.float32(0.1) * z + np.float32(gain)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    state = jax.tree.map(
        lambda leaf: np.zeros(leaf.shape, np.float32), state)
    state = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf + np.float32(
            jax.tree_util.keystr(path).endswith("['var']")), state)
    return params, state
