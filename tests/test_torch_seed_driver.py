"""Same `--seed`, same run, end to end: the port's driver from `--seed`
alone (no injected weights) against the JAX driver, on the CPU. The
study and eval CSVs track the JAX driver's, on `simples-full` within
rtol 1e-4, atol 1e-6 (`tests/test_torch_attack_cli.py`'s bounds) and on
`empire-cnn` with dropout for 3 steps within `tests/test_torch_engine.py`'s
(rtol 1e-4, atol 1e-5; the cosine and curvature columns rtol 2e-3: the
JAX CPU dot over 1.3M terms sums sequentially in f32); the eval rows are
equal. The key tree's parts are held in `tests/test_torch_seed.py`.
"""

import os

import numpy as np
import pytest

from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu_torch.cli import attack as driver

COMMON = ["--seed", "4", "--nb-steps", "3", "--nb-workers", "11",
          "--nb-decl-byz", "2", "--nb-real-byz", "2", "--batch-size-test",
          "16", "--batch-size-test-reps", "2", "--evaluation-delta", "3",
          "--nb-for-study", "1", "--nb-for-study-past", "2"]
RUNS = {
    "simples-full": ["--model", "simples-full", "--dataset", "mnist",
                     "--batch-size", "8", "--gar", "median", "--attack",
                     "empire", "--attack-args", "factor:1.1",
                     "--learning-rate", "0.1"],
    "empire-cnn": ["--model", "empire-cnn", "--dataset", "cifar10",
                   "--batch-size", "4", "--gar", "bulyan", "--attack",
                   "empire", "--attack-args", "factor:1.1", "--momentum",
                   "0.99", "--gradient-clip", "5"],
}


def _rows(resdir, name):
    lines = (resdir / name).read_text().split(os.linesep)
    return [line.split("\t") for line in lines[1:] if line]


@pytest.fixture
def small_sets(monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "256")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_driver_from_the_seed_tracks_the_jax_driver(small_sets, tmp_path, run):
    argv = [*COMMON, *RUNS[run]]
    assert jax_main(["--device", "cpu", *argv, "--result-directory",
                     str(tmp_path / "jax")]) == 0
    summary = driver.run(["--device", "cpu", *argv, "--result-directory",
                          str(tmp_path / "port")])
    assert summary["steps"] == 3
    want, got = _rows(tmp_path / "jax", "study"), _rows(tmp_path / "port", "study")
    assert [row[:2] for row in got] == [row[:2] for row in want]
    columns = driver.STUDY_COLUMNS[2:]
    want = np.array([[float(v) for v in row[2:]] for row in want])
    got = np.array([[float(v) for v in row[2:]] for row in got])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    for i, column in enumerate(columns):
        finite = np.isfinite(want[:, i])
        if run == "simples-full":
            rtol, atol = 1e-4, 1e-6
        else:
            loose = "cosine" in column or "curvature" in column
            rtol, atol = (2e-3 if loose else 1e-4), 1e-5
        np.testing.assert_allclose(got[finite, i], want[finite, i], rtol=rtol,
                                   atol=atol, err_msg=column)
    assert _rows(tmp_path / "port", "eval") == _rows(tmp_path / "jax", "eval")
