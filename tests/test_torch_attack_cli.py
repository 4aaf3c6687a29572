"""The port's driver against the JAX driver on the adaptive and stateful
attacks, in process on the CPU (small synthetic MNIST).

Both drivers run the same command line from `--seed` alone: the port's
model draws the JAX model's `init(PRNGKey(seed))` weights itself
(`models/core.py`), and the batches are the same by construction
(`data/device.py`); `simples-full`, n = 11, f = 4 real Byzantine
workers:

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

import numpy as np
import pytest

from byzantinemomentum_tpu.cli.attack import main as jax_main
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


def _port_run(resdir, argv):
    """The port's driver from the command line alone."""
    return driver.run(["--device", "cpu", *argv, "--result-directory",
                       str(resdir)])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_adaptive_attacks_track_the_jax_driver(tmp_path, run):
    argv = [*COMMON, *RUNS[run]]
    assert jax_main(["--device", "cpu", *argv, "--result-directory",
                     str(tmp_path / "jax")]) == 0
    summary = _port_run(tmp_path / "port", argv)
    assert summary["steps"] == 4
    want, got = _rows(tmp_path / "jax", "study"), _rows(tmp_path / "port", "study")
    assert [row[:2] for row in got] == [row[:2] for row in want]
    want = np.array([[float(v) for v in row[2:]] for row in want])
    got = np.array([[float(v) for v in row[2:]] for row in got])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-6)
    assert _rows(tmp_path / "port", "eval") == _rows(tmp_path / "jax", "eval")
