"""The named inits of the PyTorch port (`--init-multi`, `--init-mono`)
against the JAX package's `models/core.py::inits`, on the CPU.

* Each of the 14 inits (and its `_` spelling) at HWIO, dense and 1-D
  shapes from the same key bit for bit, those drawn from `prng.normal`
  and `prng.truncated_normal` (normal, trunc_normal, xavier_normal,
  kaiming_normal, sparse) included; `orthogonal`'s normal matrix bit for
  bit, and its result within atol 1e-6 of JAX's (the QR of that matrix
  through another LAPACK call).
* `apply_named_init` on `empire-cnn`: one key a parameter from
  `split(fold_in(key, 2), count)` in `jax.tree.flatten`'s order (the
  names sorted component by component), so the whole flat vector equals
  JAX's bit for bit under uniform inits.
* The driver: `--init-multi kaiming_uniform --init-multi-args a:0.1
  --init-mono uniform --init-mono-args a:-0.5 b:0.5` gives the JAX
  driver's initial parameters bit for bit, and runs.
"""

import math

import jax
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.models import core as jax_core
from byzantinemomentum_tpu.models import flatten_params
from byzantinemomentum_tpu_torch import models, prng
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.models import FlatParams
from byzantinemomentum_tpu_torch.models import core

from tests.torch_threads import one_torch_thread  # noqa: F401

ARGS = {"uniform": {"a": -0.3, "b": 0.7}, "normal": {"mean": 0.1, "std": 0.3},
        "trunc_normal": {"std": 0.5, "a": -0.4}, "constant": {"val": 0.3},
        "ones": {}, "zeros": {}, "eye": {}, "dirac": {"groups": 2},
        "xavier_uniform": {"gain": 1.3}, "xavier_normal": {},
        "kaiming_uniform": {"a": 0.1},
        "kaiming_normal": {"nonlinearity": "relu", "mode": "fan_out"},
        "orthogonal": {"gain": 2.0}, "sparse": {"sparsity": 0.3}}
SHAPES = ((3, 3, 4, 6), (20, 7), (7, 20), (13,))


def _applies(name, shape):
    if name in ("eye", "sparse"):
        return len(shape) == 2
    if name == "dirac":
        return len(shape) in (3, 4, 5)
    if name == "orthogonal":
        return len(shape) >= 2
    return True


def test_registry_has_the_jax_names():
    assert sorted(core.inits) == sorted(jax_core.inits)
    for name in ARGS:
        assert core.inits[name + "_"] is core.inits[name]


@pytest.mark.parametrize("name", sorted(ARGS))
def test_init_matches_jax(name):
    for seed, shape in enumerate(SHAPES):
        if not _applies(name, shape):
            continue
        want = np.asarray(jax_core.inits[name](
            jax.random.PRNGKey(seed), shape, **ARGS[name]))
        got = core.inits[name](prng.PRNGKey(seed), shape, **ARGS[name])
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        got = got.numpy()
        if name == "orthogonal":
            cols = shape[-1]
            rows = math.prod(shape) // cols
            square = (max(rows, cols), min(rows, cols))
            np.testing.assert_array_equal(
                prng.normal(prng.PRNGKey(seed), square).numpy().view(np.int32),
                np.asarray(jax.random.normal(jax.random.PRNGKey(seed), square)
                           ).view(np.int32))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def test_apply_named_init_follows_the_jax_leaf_order():
    """empire-cnn's leaves in `jax.tree.flatten` order: every weight
    re-drawn by xavier_uniform and every bias and BatchNorm vector by
    uniform, bit for bit."""
    key = jax.random.PRNGKey(5)
    mdef = jax_models.build("empire-cnn")
    params, _ = mdef.init(key)
    kwargs = dict(init_multi="xavier_uniform", init_mono="uniform",
                  init_mono_args={"a": -0.5, "b": 0.5})
    want, _ = flatten_params(jax_core.apply_named_init(
        params, jax.random.fold_in(key, 2), **kwargs))
    model = models.build("empire-cnn", device="cpu")
    model.init(prng.PRNGKey(5))
    before = FlatParams(model).flatten(dict(model.named_parameters())).clone()
    core.apply_named_init(model, prng.fold_in(prng.PRNGKey(5), 2), **kwargs)
    got = FlatParams(model).flatten(dict(model.named_parameters())).detach()
    assert not torch.equal(got, before)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


ARGV = ["--device", "cpu", "--seed", "4", "--model", "simples-full",
        "--dataset", "mnist", "--nb-workers", "5", "--nb-decl-byz", "1",
        "--batch-size", "8", "--batch-size-test", "16",
        "--batch-size-test-reps", "2", "--evaluation-delta", "2",
        "--init-multi", "kaiming_uniform", "--init-multi-args", "a:0.1",
        "--init-mono", "uniform", "--init-mono-args", "a:-0.5", "b:0.5"]


def test_driver_named_init_is_the_jax_drivers(tmp_path, monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "200")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")
    args = driver._postprocess(driver.process_commandline(
        [*ARGV, "--nb-steps", "2", "--result-directory", str(tmp_path / "a")]))
    _, _, state = driver._setup(args)
    root = jax.random.PRNGKey(4)
    params, _ = jax_models.build("simples-full").init(root)
    want, _ = flatten_params(jax_core.apply_named_init(
        params, jax.random.fold_in(root, 2), init_multi="kaiming_uniform",
        init_multi_args={"a": 0.1}, init_mono="uniform",
        init_mono_args={"a": -0.5, "b": 0.5}))
    np.testing.assert_array_equal(state.theta.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    summary = driver.run([*ARGV, "--nb-steps", "2", "--result-directory",
                          str(tmp_path / "b")])
    assert summary["steps"] == 2
    with pytest.raises(driver.utils.UserException, match="initialization"):
        driver.run([*ARGV[:-5], "--init-mono", "nope", "--nb-steps", "1"])
