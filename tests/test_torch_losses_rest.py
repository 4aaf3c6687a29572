"""The rest of the PyTorch port's `losses.py`, its `sigmoid` criterion and
the `nan` attack against the JAX package's.

* Every registered loss but `nll`, `l1` and `l2` (`tests/test_torch_losses.py`
  holds those), with its options, on numpy inputs from a seed: the value
  and the gradient with respect to each output (and to theta for the
  regularizers) within rtol 1e-5, atol 1e-6. The multi-input losses
  take their inputs as a tuple; `cosineembedding` given one output
  array raises, as in the JAX package.
* Both registries hold the same names.
* The `sigmoid` criterion counts as the JAX one does.
* `nan`: the same rows (all NaN, the honest rows' dtype; none for
  f_real = 0), the same `check` messages, and `detect` flags the same
  rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu.attacks import nan as jax_nan
from byzantinemomentum_tpu_torch import losses
from byzantinemomentum_tpu_torch.attacks import attacks, nan

from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
B, C = 6, 5


def _inputs(name, rng):
    """`(outputs tuple, target)` for a loss, as numpy."""
    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def sign(*shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)

    def classes():
        return rng.integers(0, C, B).astype(np.int32)

    def bits(*shape):
        return rng.integers(0, 2, shape).astype(np.float32)

    if name in ("crossentropy", "multimargin"):
        return (normal(B, C),), classes()
    if name in ("mse", "l1loss", "smoothl1", "huber"):
        return (normal(B, C),), normal(B, C)
    if name == "bce":
        return (rng.uniform(0.05, 0.95, (B, 1)).astype(np.float32),), bits(B, 1)
    if name == "kldiv":
        logits = normal(B, C)
        logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
        target = rng.dirichlet(np.ones(C), B).astype(np.float32)
        return (logp.astype(np.float32),), target
    if name in ("hingeembedding", "softmargin"):
        return (normal(B, C),), sign(B, C)
    if name in ("bcewithlogits", "multilabelsoftmargin"):
        return (normal(B, C),), bits(B, C)
    if name == "poissonnll":
        return (rng.uniform(0.2, 3.0, (B, C)).astype(np.float32),), \
            rng.integers(0, 6, (B, C)).astype(np.float32)
    if name == "multilabelmargin":
        target = np.full((B, C), -1, np.int32)
        for row in target:
            k = rng.integers(0, C)
            row[:k] = rng.permutation(C)[:k]
            if k + 1 < C:  # labels after the -1 are ignored
                row[k + 1] = rng.integers(0, C)
        return (normal(B, C),), target
    if name in ("cosineembedding", "marginranking"):
        shape = (B, C) if name == "cosineembedding" else (B,)
        return (normal(*shape), normal(*shape)), sign(B)
    if name in ("tripletmargin", "tripletmarginwithdistance"):
        return (normal(B, C), normal(B, C), normal(B, C)), np.zeros(B, np.float32)
    if name == "gaussiannll":
        return (normal(B, C), rng.uniform(0.1, 2.0, (B, C)).astype(np.float32)), \
            normal(B, C)
    raise KeyError(name)


CASES = [
    ("crossentropy", {}), ("mse", {}), ("l1loss", {}), ("bce", {}),
    ("smoothl1", {}), ("smoothl1", {"beta": 0.5}), ("huber", {"beta": 2.0}),
    ("kldiv", {}), ("hingeembedding", {}), ("hingeembedding", {"margin": 0.3}),
    ("bcewithlogits", {}), ("poissonnll", {}),
    ("poissonnll", {"log_input": False, "full": True}),
    ("poissonnll", {"full": True}), ("softmargin", {}), ("multimargin", {}),
    ("multimargin", {"p": 2, "margin": 0.5}), ("multilabelmargin", {}),
    ("multilabelsoftmargin", {}), ("cosineembedding", {}),
    ("cosineembedding", {"margin": 0.2}), ("marginranking", {}),
    ("marginranking", {"margin": 0.4}), ("tripletmargin", {}),
    ("tripletmargin", {"p": 1, "swap": True, "margin": 2.0}),
    ("tripletmarginwithdistance", {}),
    ("tripletmarginwithdistance", {"swap": True, "margin": 0.5}),
    ("gaussiannll", {}), ("gaussiannll", {"full": True, "eps": 0.5}),
]


def test_registries_hold_the_same_names():
    assert set(losses.losses) == set(jax_losses.losses)
    assert set(losses.criteria) == set(jax_losses.criteria)


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_loss_value_and_gradient_match_jax(name, kwargs):
    outputs, target = _inputs(name, np.random.default_rng(len(name)))
    jloss = jax_losses.Loss(name, **kwargs)
    loss = losses.Loss(name, **kwargs)
    single = len(outputs) == 1

    def jfn(*outs):
        return jloss(outs[0] if single else outs, jnp.asarray(target), None)

    jvalue, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(outputs))))(
        *map(jnp.asarray, outputs))
    outs = [torch.from_numpy(o).requires_grad_() for o in outputs]
    value = loss(outs[0] if single else tuple(outs), torch.from_numpy(target),
                 None)
    grads = torch.autograd.grad(value, outs)
    np.testing.assert_allclose(float(value.detach()), float(jvalue), rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_regularizers_and_cosineembedding_on_one_output():
    rng = np.random.default_rng(0)
    theta = rng.standard_normal(37).astype(np.float32)
    for name in ("l1", "l2"):
        jvalue, jgrad = jax.value_and_grad(
            lambda p, name=name: jax_losses.Loss(name)(None, None, p))(
                jnp.asarray(theta))
        p = torch.from_numpy(theta).requires_grad_()
        value = losses.Loss(name)(None, None, p)
        (grad,) = torch.autograd.grad(value, p)
        np.testing.assert_allclose(float(value.detach()), float(jvalue), rtol=RTOL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=RTOL,
                                   atol=ATOL)
    out = rng.standard_normal((B, C)).astype(np.float32)
    target = np.ones(B, np.float32)
    with pytest.raises(ValueError):
        jax_losses.Loss("cosineembedding")(jnp.asarray(out), jnp.asarray(target), None)
    with pytest.raises(ValueError):
        losses.Loss("cosineembedding")(torch.from_numpy(out),
                                       torch.from_numpy(target), None)


def test_sigmoid_criterion_matches_jax():
    rng = np.random.default_rng(1)
    out = rng.random((B * 3, 1)).astype(np.float32)
    out[0, 0] = 0.5  # |1 - 0.5| is not below 0.5
    target = rng.integers(0, 2, (B * 3, 1)).astype(np.float32)
    target[0, 0] = 1.0
    got = losses.Criterion("sigmoid")(torch.from_numpy(out), torch.from_numpy(target))
    want = jax_losses.Criterion("sigmoid")(jnp.asarray(out), jnp.asarray(target))
    assert got.dtype == torch.float32
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist()[1] == B * 3


@pytest.mark.parametrize("dtype", (np.float32, np.float16))
def test_nan_attack_matches_jax(dtype):
    rng = np.random.default_rng(2)
    honest = rng.standard_normal((7, 33)).astype(dtype)
    atk = attacks["nan"]
    for f_real in (0, 1, 4):
        got = atk(torch.from_numpy(honest), f_decl=4, f_real=f_real)
        want = jax_nan.attack(jnp.asarray(honest), f_real)
        assert got.shape == want.shape == (f_real, 33)
        assert got.numpy().dtype == np.asarray(want).dtype == dtype
        assert bool(got.isnan().all()) and bool(jnp.isnan(want).all())
    for args in ((honest[:0], 2), (honest, -1), (honest, 1.5), (honest, 3)):
        assert (nan.check(torch.from_numpy(args[0]), args[1])
                == jax_nan.check(jnp.asarray(args[0]), args[1]))
    rows = rng.standard_normal((6, 9)).astype(np.float32)
    rows[1, 3], rows[3, 0], rows[4, 8] = np.nan, np.inf, -np.inf
    np.testing.assert_array_equal(nan.detect(torch.from_numpy(rows)).numpy(),
                                  np.asarray(jax_nan.detect(jnp.asarray(rows))))
    assert nan.detect(torch.from_numpy(rows)).tolist() == [
        False, True, False, True, True, False]
