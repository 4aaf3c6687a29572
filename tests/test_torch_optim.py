"""The optimizer registry of the PyTorch port against the JAX package's
optax chains, on the CPU.

* Each of the nine optimizers in f32 and bf16, 5 steps from the same
  parameters and gradients (weight decay 1e-2, a learning rate rounded to
  the parameter dtype): the parameters and every state leaf within rtol
  2e-6, atol 2e-6 in f32 (XLA fuses the JAX chain into multiply-adds,
  the port rounds each operation: a few ulps, 5e-7 at most seen) and
  within two bf16 ulps in bf16 (rtol 2^-6, atol 2e-6; the parameters,
  of magnitude about 1, atol 2^-12, two ulps of a term where the update
  cancels most of a parameter: XLA runs the fused bf16 chain at f32 and
  rounds its outputs, the port rounds each operation to bf16; one ulp at
  most seen), the step counts equal.
* `--optimizer adam` and `adamw` through both drivers (`simples-full`,
  n = 7, 4 steps): the study CSVs track (`test_torch_checkpoint.py`'s
  tolerances); the `checkpoint-0` files are the same bytes; the JAX
  `checkpoint-2` read by the port and written again gives the JAX file's
  bytes, optimizer state included; and each package resumes the other's
  `checkpoint-2` to the uninterrupted run's rows.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import optim as jax_optim
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu_torch import checkpoint, optim
from byzantinemomentum_tpu_torch.cli import attack as driver

from tests.test_torch_checkpoint import BASE, MNIST, _assert_tracks
from tests.torch_threads import one_torch_thread  # noqa: F401

NAMES = ("sgd", "adam", "adamw", "rmsprop", "adagrad", "adamax", "adadelta",
         "radam", "amsgrad")
# (numpy dtype, torch dtype, rtol, the parameters' atol)
DTYPES = {"float32": (np.float32, torch.float32, 2e-6, 2e-6),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2.0 ** -6,
                       2.0 ** -12)}


def _leaves(state):
    """The leaves of an optimizer state in the JAX tree's order (fields
    of a NamedTuple, keys of the port's dict, in declaration order)."""
    if isinstance(state, dict):
        return [leaf for value in state.values() for leaf in _leaves(value)]
    if isinstance(state, (tuple, list)):
        return [leaf for value in state for leaf in _leaves(value)]
    return [state]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_tracks_optax(name, dtype):
    jdt, tdt, rtol, atol = DTYPES[dtype]
    rng = np.random.default_rng(NAMES.index(name))
    d = 301
    theta = rng.standard_normal(d).astype(np.float32)
    jopt = jax_optim.build(name, weight_decay=1e-2)
    popt = optim.build(name, weight_decay=1e-2)
    jt = jnp.asarray(theta).astype(jdt)
    pt = torch.from_numpy(theta).to(tdt)
    js, ps = jopt.init(jt), popt.init(pt)
    update = jax.jit(jopt.update)
    for step in range(5):
        grad = (rng.standard_normal(d) * 10.0 ** (step - 2)).astype(np.float32)
        lr = 0.05 / (step + 1)
        jt, js = update(jnp.asarray(grad).astype(jdt), js, jt,
                        jnp.asarray(lr, jnp.float32).astype(jdt))
        pt, ps = popt.update(torch.from_numpy(grad).to(tdt), ps, pt,
                             torch.tensor(lr, dtype=torch.float32).to(tdt))
    assert pt.dtype == tdt
    np.testing.assert_allclose(_np(pt), _np(jt), rtol=rtol, atol=atol)
    jleaves, pleaves = _leaves(js), _leaves(ps)
    assert len(jleaves) == len(pleaves)
    for jleaf, pleaf in zip(jleaves, pleaves):
        if pleaf.dtype == torch.int32:
            assert int(pleaf) == int(jleaf) == 5
            continue
        assert pleaf.dtype == tdt
        np.testing.assert_allclose(_np(pleaf), _np(jleaf), rtol=rtol,
                                   atol=2e-6)


RUN = [*BASE, *MNIST]


@pytest.fixture(autouse=True)
def small_sets(monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "300")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers, 4 steps of each optimizer with checkpoints at 0 and
    2: `{optimizer: (jax directory, port directory)}`."""
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BMT_SYNTH_TRAIN", "300")
        patch.setenv("BMT_SYNTH_TEST", "64")
        for name in ("adam", "adamw"):
            root = tmp_path_factory.mktemp(name)
            argv = ["--device", "cpu", *RUN, "--optimizer", name,
                    "--nb-steps", "4"]
            assert jax_main([*argv, "--result-directory", str(root / "jax")]) == 0
            driver.run([*argv, "--result-directory", str(root / "port")])
            out[name] = root / "jax", root / "port"
    return out


@pytest.mark.parametrize("name", ("adam", "adamw"))
def test_driver_optimizer_tracks_the_jax_driver(runs, name):
    jdir, pdir = runs[name]
    _assert_tracks(pdir, jdir, 0)


@pytest.mark.parametrize("name", ("adam", "adamw"))
def test_optimizer_checkpoint_is_the_jax_file(tmp_path, runs, name):
    jdir, pdir = runs[name]
    assert (pdir / "checkpoint-0").read_bytes() == (
        jdir / "checkpoint-0").read_bytes()
    # The JAX state after two steps, read by the port and written again
    argv = ["--device", "cpu", *RUN, "--optimizer", name, "--nb-steps", "4",
            "--result-directory", str(tmp_path / "setup")]
    _, _, fresh = driver._setup(driver._postprocess(
        driver.process_commandline(argv)))
    state, data_state = checkpoint.load(jdir / "checkpoint-2", fresh,
                                        return_data=True)
    assert int(state.opt_state[0]["count"]) == 2
    checkpoint.save(tmp_path / "again", state, data_state=data_state)
    assert (tmp_path / "again").read_bytes() == (
        jdir / "checkpoint-2").read_bytes()


@pytest.mark.parametrize("writer", ("jax", "port"))
@pytest.mark.parametrize("name", ("adam", "adamw"))
def test_each_package_resumes_the_others_optimizer_state(tmp_path, runs, name,
                                                         writer):
    jdir, pdir = runs[name]
    source = (jdir if writer == "jax" else pdir) / "checkpoint-2"
    resumed = tmp_path / "resumed"
    argv = ["--device", "cpu", *RUN, "--optimizer", name, "--nb-steps", "2",
            "--load-checkpoint", str(source), "--result-directory",
            str(resumed)]
    if writer == "jax":
        assert driver.run(argv)["steps"] == 4
    else:
        assert jax_main(argv) == 0
    _assert_tracks(resumed, jdir if writer == "jax" else pdir, 2)
