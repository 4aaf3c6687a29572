"""The port's driver against the JAX driver on the adaptive and stateful
attacks, in process on the CPU (small synthetic MNIST).

Both drivers run the same command line from the same initial weights
(the JAX model's `init(PRNGKey(seed))`, loaded into the port's model
before its first step; the batches are the same by construction,
`data/device.py`) on `simples-full` (no dropout), n = 11, f = 4 real
Byzantine workers:

* `--attack empire` with no `--attack-args` (the JAX default
  `factor:-16`: a line search of 16 Median evaluations a step);
* `--attack alie-warmup --attack-args window:2` against Krum, across its
  window (two burst steps, then the hidden ALIE rows; the step counter
  lives in the engine's state).

The study CSVs must have the same rows, the same non-finite entries and
values within rtol 1e-4, atol 1e-6 (the trajectories drift apart in the
last bits over the steps: 2.2e-5 relative at most, seen), and the `eval`
accuracies must be equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu_torch import convert
from byzantinemomentum_tpu_torch.cli import attack as driver

SEED = 2
COMMON = ["--seed", str(SEED), "--nb-steps", "4", "--model", "simples-full",
          "--dataset", "mnist", "--nb-workers", "11", "--nb-decl-byz", "4",
          "--nb-real-byz", "4", "--batch-size", "8", "--batch-size-test",
          "16", "--batch-size-test-reps", "2", "--evaluation-delta", "2",
          "--learning-rate", "0.1", "--nb-for-study", "1",
          "--nb-for-study-past", "2"]
RUNS = {"empire-default": ["--gar", "median", "--attack", "empire"],
        "alie-warmup": ["--gar", "krum", "--attack", "alie-warmup",
                        "--attack-args", "window:2"]}


@pytest.fixture(autouse=True)
def small_sets(monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "300")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")


def _rows(resdir, name):
    lines = (resdir / name).read_text().split(os.linesep)
    return [line.split("\t") for line in lines[1:] if line]


def _port_run(monkeypatch, resdir, argv):
    """The port's driver, its model starting from the JAX weights."""
    params, _ = jax_models.build("simples-full").init(jax.random.PRNGKey(SEED))
    theta, _ = convert.params_from_jax(jax.tree.map(np.asarray, params), {})
    setup = driver._setup

    def setup_from_jax(args):
        device, engine = setup(args)
        with torch.no_grad():
            for name, value in engine.flat.unflatten(theta).items():
                engine.model.get_parameter(name).copy_(value)
        return device, engine

    monkeypatch.setattr(driver, "_setup", setup_from_jax)
    return driver.run(["--device", "cpu", *argv, "--result-directory",
                       str(resdir)])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_adaptive_attacks_track_the_jax_driver(monkeypatch, tmp_path, run):
    argv = [*COMMON, *RUNS[run]]
    assert jax_main(["--device", "cpu", *argv, "--result-directory",
                     str(tmp_path / "jax")]) == 0
    summary = _port_run(monkeypatch, tmp_path / "port", argv)
    assert summary["steps"] == 4
    want, got = _rows(tmp_path / "jax", "study"), _rows(tmp_path / "port", "study")
    assert [row[:2] for row in got] == [row[:2] for row in want]
    want = np.array([[float(v) for v in row[2:]] for row in want])
    got = np.array([[float(v) for v in row[2:]] for row in got])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-6)
    assert _rows(tmp_path / "port", "eval") == _rows(tmp_path / "jax", "eval")
