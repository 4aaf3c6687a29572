"""The PyTorch port's `transformer-classifier` (and `transformer`) and
`parallel/ring.py::dense_attention` against the JAX package's
(`byzantinemomentum_tpu/models/transformer.py`, `parallel/ring.py`), on
the CPU.

* Both names build with the JAX model's parameter names, shapes and
  count (104,394 at the default width); `attn_impl="ring"` and
  `"ulysses"` raise, naming the mesh; an unknown one raises too.
* `dense_attention` against the JAX function with and without `causal`
  and with a `key_mask`: f32 outputs and the
  gradients of q, k and v within rtol 1e-5, atol 1e-6; in bf16 the scores
  and softmax run in f32 and the output comes back bf16, equal to JAX's
  within one bf16 ulp (rtol 2^-7).
* `init(PRNGKey(seed))` gives the JAX init bit for bit (the list
  `blocks` included), and at depth 11 (tiny widths) the flat vector is in
  `ravel_pytree`'s order: `blocks.10` after `blocks.9`, not after
  `blocks.1` (`models.flat_key`, `convert.flat_items` on lists).
* The whole model at its default width (depth 2, dim 64, heads 4) on
  batch 2, in f32: log-probabilities within rtol 1e-5, atol 1e-6 and the
  gradient within 1e-5 relative L2; with `causal` too. In bf16 (the
  parameters and inputs in bf16, as `--dtype bfloat16` runs it): the
  port's gradient no farther from the JAX f32 one than 1.5x the JAX bf16
  gradient's distance, within 2x that distance of the JAX bf16 gradient,
  outputs within 5e-2 (`tests/test_torch_wide_resnet.py`'s bounds).
* The JAX driver test's line (`tests/test_driver.py:148`: MNIST, depth 1,
  dim 32, heads 2, Median against `little factor:1.5` with 2 real
  Byzantine workers, 3 steps, seed 11) through both drivers from the seed
  alone: the study CSVs within rtol 1e-4, atol 1e-6, the eval rows equal.
"""

import os

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu.parallel.ring import dense_attention as jax_attention
from byzantinemomentum_tpu_torch import convert, models, prng
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.models import FlatParams
from byzantinemomentum_tpu_torch.parallel.ring import dense_attention

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_zoo import jax_run, model_call, port_run, rel, to_numpy

NAME = "transformer-classifier"
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("name", ("transformer-classifier", "transformer"))
def test_names_shapes_and_count_are_the_jax_models(name):
    mdef = jax_models.build(name)
    params, state = jax.eval_shape(mdef.init, jax.random.PRNGKey(0))
    module = models.build(name, device="meta")
    flat = FlatParams(module)
    items = list(convert.flat_items(params))
    assert flat.names == [leaf_name for leaf_name, _ in items]
    assert flat.shapes == [tuple(leaf.shape) for _, leaf in items]
    assert flat.d == mdef.param_count() == 104_394
    assert state == {} and dict(module.named_buffers()) == {}


@pytest.mark.parametrize("impl", ("ring", "ulysses"))
def test_sharded_attention_raises(impl):
    with pytest.raises(ValueError, match="mesh"):
        models.build(NAME, device="meta", attn_impl=impl)
    with pytest.raises(ValueError, match="Unknown attention"):
        models.build(NAME, device="meta", attn_impl="flash")


def _qkv(seed, shape=(2, 3, 7, 4)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("case", ("plain", "causal", "key_mask"))
def test_dense_attention_matches_jax(case):
    q, k, v = _qkv(len(case))
    kwargs = {"causal": case == "causal"}
    mask = np.array([True, False, True, True, False, True, True])
    R = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jax_fn(q, k, v):
        out = jax_attention(q, k, v, key_mask=jnp.asarray(mask)
                            if case == "key_mask" else None, **kwargs)
        return jnp.sum(out * R), out

    (_, jout), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = dense_attention(tq, tk, tv, key_mask=torch.from_numpy(mask)
                          if case == "key_mask" else None, **kwargs)
    (out * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=RTOL, atol=ATOL)
    for got, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_dense_attention_in_bf16():
    q, k, v = _qkv(9)
    jout = jax_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         causal=True)
    out = dense_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          causal=True)
    assert jout.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32),
                               rtol=2.0**-7, atol=1e-6)


def test_init_is_the_jax_init():
    module = models.build(NAME, device="cpu")
    module.init(prng.PRNGKey(2))
    params, _ = jax_models.build(NAME).init(jax.random.PRNGKey(2))
    want, _ = jax.flatten_util.ravel_pytree(params)
    got = FlatParams(module).flatten(dict(module.named_parameters())).detach()
    assert torch.equal(got.view(torch.int32),
                       torch.from_numpy(np.asarray(want)).view(torch.int32))


def test_flat_order_of_a_list_at_depth_11():
    args = {"depth": 11, "dim": 4, "heads": 2, "mlp_ratio": 1,
            "input_shape": (3, 2, 1)}
    module = models.build(NAME, device="cpu", **args)
    module.init(prng.PRNGKey(5))
    params, _ = jax_models.build(NAME, **args).init(jax.random.PRNGKey(5))
    flat = FlatParams(module)
    names = [name for name, _ in convert.flat_items(to_numpy(params))]
    assert flat.names == names
    assert names.index("blocks.10.fc1.b") == names.index("blocks.9.qkv.w") + 1
    assert sorted(flat.names, key=lambda n: tuple(n.split("."))) != names
    want, _ = jax.flatten_util.ravel_pytree(params)
    got = flat.flatten(dict(module.named_parameters())).detach()
    assert torch.equal(got.view(torch.int32),
                       torch.from_numpy(np.asarray(want)).view(torch.int32))
    theta, state = convert.params_from_jax(to_numpy(params), {})
    assert torch.equal(theta, got) and state == {}


def _model_case(seed, **args):
    mdef = jax_models.build(NAME, **args)
    params, state = to_numpy(mdef.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
    R = rng.standard_normal((2, 10)).astype(np.float32)
    return mdef, params, state, x, R


def _run_both(mdef, params, state, x, R, jdtype, tdtype, **args):
    jout, _, jgrad = jax_run(lambda p, s, x: mdef.apply(p, s, x), params,
                             state, x, R, jdtype)
    module = models.build(NAME, device="cpu", **args)
    out, _, grad = port_run(module, model_call(False), params, state, x, R,
                            tdtype)
    return jout, jgrad, out, grad


@pytest.mark.parametrize("causal", (False, True))
def test_whole_model_matches_jax(causal):
    mdef, params, state, x, R = _model_case(3, causal=causal)
    jout, jgrad, out, grad = _run_both(mdef, params, state, x, R, jnp.float32,
                                       torch.float32, causal=causal)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    assert rel(grad, jgrad) < 1e-5


def test_whole_model_in_bf16_tracks_jax():
    mdef, params, state, x, R = _model_case(4)
    jout32, jgrad32, _, grad32 = _run_both(mdef, params, state, x, R,
                                           jnp.float32, torch.float32)
    jout, jgrad, out, grad = _run_both(mdef, params, state, x, R, jnp.bfloat16,
                                       torch.bfloat16)
    err = rel(jgrad, jgrad32)
    assert 0 < err < 0.3  # bf16 engaged, not garbage
    assert rel(grad, grad32) <= 1.5 * err
    assert rel(grad, jgrad) <= 2.0 * err
    np.testing.assert_allclose(out, jout, rtol=5e-2, atol=5e-2)


# `tests/test_driver.py::test_transformer_model_via_cli`'s line
DRIVER_LINE = ["--nb-steps", "3", "--batch-size", "8", "--batch-size-test",
               "32", "--batch-size-test-reps", "2", "--evaluation-delta", "2",
               "--model", "simples-full", "--seed", "11",
               "--model", "transformer-classifier",
               "--model-args", "depth:1", "dim:32", "heads:2",
               "--gar", "median", "--nb-real-byz", "2",
               "--attack", "little", "--attack-args", "factor:1.5",
               "--nb-for-study", "11", "--nb-for-study-past", "2"]


def _rows(resdir, name):
    lines = (resdir / name).read_text().split(os.linesep)
    return [line.split("\t") for line in lines[1:] if line]


def test_driver_tracks_the_jax_driver(monkeypatch, tmp_path):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "512")
    monkeypatch.setenv("BMT_SYNTH_TEST", "128")
    assert jax_main(["--device", "cpu", *DRIVER_LINE, "--result-directory",
                     str(tmp_path / "jax")]) == 0
    summary = driver.run(["--device", "cpu", *DRIVER_LINE,
                          "--result-directory", str(tmp_path / "port")])
    assert summary["steps"] == 3
    assert summary["counts"]["vmapped_phases"] == 3
    want, got = _rows(tmp_path / "jax", "study"), _rows(tmp_path / "port", "study")
    assert len(got) == 3 and [row[:2] for row in got] == [row[:2] for row in want]
    want = np.array([[float(v) for v in row[2:]] for row in want])
    got = np.array([[float(v) for v in row[2:]] for row in got])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-6)
    assert _rows(tmp_path / "port", "eval") == _rows(tmp_path / "jax", "eval")
