"""The port's driver with `--fault-plan` against the JAX driver, and the
straggler buffer in checkpoints, on the CPU.

* The JAX `test_cli_fault_plan_smoke` line (simples-full, n = 11, Krum
  at f = 4, DEMO_PLAN, 4 steps) through both drivers: the header is
  `STUDY_COLUMNS + FAULT_COLUMNS`, the rows' three integers are JAX's
  ([0, 0, 3, 3], [11, 11, 8, 8], [4, 4, 2, 2]), every float column
  within rtol 1e-4, atol 1e-6 (the seed-driver tests' bounds on
  simples-full), `config.json`'s `fault_plan` the plan's path.
* A plan with no events writes the fault-free run's study and eval files
  byte for byte, with the JAX info line.
* A plan that does not fit the run (a worker out of range, an attack row
  mutated, a system-scope kind), a missing file or an unknown field is
  refused with the JAX driver's message.
* The headline's plan (`HEADLINE_PLAN` of `chip_smoke.py`: a device loss,
  a NaN window, an attack row dropped, a straggler across the chunk
  boundary at step 8, a duplicate, a scaled window) at the headline's
  n = 25, f = 5 (Bulyan against `empire(1.1)`, 16 steps, on simples-full
  so that the CPU runs it): the three fault columns are the JAX driver's
  and read `Workers active` 25, 25, then 18 at steps 2-5 (worker 9's NaN
  row makes the five empire rows NaN too, and all six are quarantined),
  23, then 24, and `Quorum f` 5 but 3 at steps 2-5;
  `--steps-per-program` 1 and 8 write the same bytes.
* The straggler buffer: both drivers' `checkpoint-0` under a plan with a
  straggler are the same bytes (an [h, d] buffer); each package resumes
  the other's checkpoint taken inside a straggler window and writes the
  uninterrupted run's rows; a checkpoint without the field loads with
  the template's zeros (the JAX
  `test_checkpoint_without_fault_buffer_loads_with_cold_buffer`); a run
  killed inside the window and `--auto-resume`d writes the
  uninterrupted run's CSVs byte for byte but for `Restarts`.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import faults as jax_faults
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu.engine import FAULT_COLUMNS as JAX_FAULT_COLUMNS
from byzantinemomentum_tpu.utils import UserException as JaxUserException
from byzantinemomentum_tpu_torch import checkpoint, faults, utils
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import (
    FAULT_COLUMNS, RECOVERY_COLUMNS, STUDY_COLUMNS)

from tests.test_faults import CLI_BASE, DEMO_PLAN
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _env(monkeypatch, train="512", test="128"):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", train)
    monkeypatch.setenv("BMT_SYNTH_TEST", test)


def _study(resdir):
    lines = (resdir / "study").read_text().split(os.linesep)
    return lines[0], [line.split("\t") for line in lines[1:] if line]


def _floats_close(got, want, columns):
    got = np.array([[float(row[i]) for i in columns] for row in got])
    want = np.array([[float(row[i]) for i in columns] for row in want])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4,
                               atol=1e-6)


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    plan_path = DEMO_PLAN.save(tmp / "plan.json")
    with pytest.MonkeyPatch.context() as patch:
        _env(patch)
        argv = ["--device", "cpu", *CLI_BASE, "--gar", "krum", "--fault-plan",
                str(plan_path)]
        assert jax_main([*argv, "--result-directory", str(tmp / "jax")]) == 0
        driver.run([*argv, "--result-directory", str(tmp / "port")])
    return tmp, plan_path


def test_demo_line_matches_jax(demo_runs):
    tmp, plan_path = demo_runs
    jheader, want = _study(tmp / "jax")
    header, got = _study(tmp / "port")
    assert FAULT_COLUMNS == JAX_FAULT_COLUMNS
    assert header == jheader == "# " + "\t".join(STUDY_COLUMNS + FAULT_COLUMNS)
    width = len(STUDY_COLUMNS)
    ints = [[int(v) for v in row[width:]] for row in got]
    assert ints == [[int(v) for v in row[width:]] for row in want]
    assert [row[0] for row in ints] == [0, 0, 3, 3]
    assert [row[1] for row in ints] == [11, 11, 8, 8]
    assert [row[2] for row in ints] == [4, 4, 2, 2]
    assert [row[:2] for row in got] == [row[:2] for row in want]
    _floats_close(got, want, range(2, width))
    for resdir in (tmp / "port", tmp / "jax"):
        config = json.loads((resdir / "config.json").read_text())
        assert config["fault_plan"] == str(plan_path)


def test_empty_plan_writes_the_fault_free_csvs(tmp_path, monkeypatch, capsys):
    _env(monkeypatch)
    empty = faults.FaultPlan().save(tmp_path / "empty.json")
    argv = ["--device", "cpu", *CLI_BASE, "--gar", "krum", "--evaluation-delta",
            "2"]
    driver.run([*argv, "--result-directory", str(tmp_path / "plain")])
    driver.run([*argv, "--fault-plan", str(empty), "--result-directory",
                str(tmp_path / "empty")])
    assert ("Fault plan has no events; the fault machinery stays out of the "
            "compiled step entirely") in capsys.readouterr().out
    for name in ("study", "eval"):
        assert ((tmp_path / "empty" / name).read_bytes()
                == (tmp_path / "plain" / name).read_bytes())


REFUSED = {
    "worker": faults.FaultPlan(events=(faults.drop_worker(11, step=0),)),
    "attack-row": faults.FaultPlan(events=(faults.corrupt_gradient(10, 1),)),
    "system-kind": faults.FaultPlan(events=(faults.straggle(1, 0, 2.0),)),
}


@pytest.mark.parametrize("case", (*sorted(REFUSED), "missing", "field"))
def test_refusals_are_jax_messages(tmp_path, monkeypatch, case):
    _env(monkeypatch)
    path = tmp_path / "plan.json"
    if case in REFUSED:
        REFUSED[case].save(path)
    elif case == "field":
        path.write_text(json.dumps({"events": [], "step": 3}))
    argv = ["--device", "cpu", *CLI_BASE, "--nb-real-byz", "2", "--attack",
            "empire", "--attack-args", "factor:1.1", "--fault-plan",
            str(path)]
    with pytest.raises(JaxUserException) as jerr:
        jax_main(argv)
    with pytest.raises(utils.UserException) as err:
        driver.run(argv)
    assert str(err.value) == str(jerr.value)
    assert str(err.value).startswith(("Fault plan", "Unable to load fault "))


# The headline's plan (`chip_smoke.py`'s HEADLINE_PLAN)
HEADLINE_PLAN = faults.FaultPlan(events=(
    faults.device_loss(3, 2),
    faults.corrupt_gradient(9, 2, mode="nan", duration=4),
    faults.drop_worker(22, 4, duration=3),
    faults.straggler(1, 6, delay_steps=4),
    faults.duplicate_submission(12, 10, source=13, duration=2),
    faults.corrupt_gradient(14, 12, mode="scale", scale=10.0, duration=2),
))
HEADLINE_LINE = ["--device", "cpu", "--seed", "1", "--nb-steps", "16",
                 "--batch-size", "8", "--batch-size-test", "32",
                 "--batch-size-test-reps", "1", "--evaluation-delta", "16",
                 "--model", "simples-full", "--nb-workers", "25",
                 "--nb-decl-byz", "5", "--nb-real-byz", "5", "--gar",
                 "bulyan", "--attack", "empire", "--attack-args",
                 "factor:1.1", "--momentum", "0.99", "--gradient-clip", "5",
                 "--nb-for-study", "1", "--nb-for-study-past", "1"]


@pytest.fixture(scope="module")
def headline_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("headline")
    plan_path = HEADLINE_PLAN.save(tmp / "plan.json")
    argv = [*HEADLINE_LINE, "--fault-plan", str(plan_path)]
    with pytest.MonkeyPatch.context() as patch:
        _env(patch)
        assert jax_main([*argv, "--result-directory", str(tmp / "jax")]) == 0
        for M in (1, 8):
            driver.run([*argv, "--steps-per-program", str(M),
                        "--result-directory", str(tmp / f"port{M}")])
    return tmp


def test_headline_plan_fault_columns_match_jax(headline_runs):
    jheader, want = _study(headline_runs / "jax")
    header, got = _study(headline_runs / "port8")
    assert header == jheader
    width = len(STUDY_COLUMNS)
    ints = [[int(v) for v in row[width:]] for row in got]
    assert ints == [[int(v) for v in row[width:]] for row in want]
    # Steps 2-5: worker 3 lost, worker 9's NaN row quarantined, and with
    # it the five empire rows, which it turns to NaN (row 22 among them)
    assert [row[1] for row in ints] == [25, 25] + [18] * 4 + [23] + [24] * 9
    assert [row[2] for row in ints] == [5, 5] + [3] * 4 + [5] * 10
    assert [row[0] for row in ints] == [0, 0, 2, 2, 3, 3, 3, 2, 2, 2, 2, 2,
                                        2, 2, 1, 1]
    loss = STUDY_COLUMNS.index("Average loss")
    _floats_close(got, want, [loss])
    assert all(np.isfinite(float(row[loss])) for row in got)


def test_headline_plan_chunks_write_the_same_bytes(headline_runs):
    """M = 1 and M = 8 (the straggler window crosses the chunk boundary
    at step 8) write the same study and eval bytes."""
    for name in ("study", "eval"):
        assert ((headline_runs / "port1" / name).read_bytes()
                == (headline_runs / "port8" / name).read_bytes())


# --------------------------------------------------------------------------- #
# The straggler buffer in checkpoints

BASE = ["--device", "cpu", "--seed", "6", "--nb-workers", "7",
        "--nb-decl-byz", "1", "--nb-real-byz", "1", "--batch-size-test", "16",
        "--batch-size-test-reps", "2", "--evaluation-delta", "2",
        "--nb-for-study", "1", "--nb-for-study-past", "2",
        "--checkpoint-delta", "2", "--model", "simples-full", "--dataset",
        "mnist", "--batch-size", "8", "--gar", "median", "--attack", "empire",
        "--attack-args", "factor:1.1", "--learning-rate", "0.1"]
# Worker 1 straggles over steps 1-4: the step-2 and step-4 checkpoints
# hold its step-0 row in the buffer
STRAGGLER_PLAN = faults.FaultPlan(events=(
    faults.straggler(1, 1, delay_steps=4),
    faults.drop_worker(6, 3),
    faults.corrupt_gradient(2, 4, mode="scale", scale=3.0),
))


@pytest.fixture(scope="module")
def straggler_runs(tmp_path_factory):
    """Both drivers, 6 steps with checkpoints at 0, 2, 4 and 6."""
    tmp = tmp_path_factory.mktemp("straggler")
    plan_path = STRAGGLER_PLAN.save(tmp / "plan.json")
    argv = [*BASE, "--fault-plan", str(plan_path), "--nb-steps", "6"]
    with pytest.MonkeyPatch.context() as patch:
        _env(patch, "256", "64")
        assert jax_main([*argv, "--result-directory", str(tmp / "jax")]) == 0
        driver.run([*argv, "--result-directory", str(tmp / "port")])
    return tmp, plan_path


def _tracks(got_dir, want_dir, start):
    """Study rows of `got_dir` against `want_dir`'s from `start` (the fault
    integers exactly, the floats within rtol 1e-4, atol 1e-6), eval rows
    equal."""
    _, got = _study(got_dir)
    _, want = _study(want_dir)
    want = [row for row in want if int(row[0]) >= start]
    width = len(STUDY_COLUMNS)
    assert [row[:2] + row[width:] for row in got] == [
        row[:2] + row[width:] for row in want]
    _floats_close(got, want, range(2, width))

    def evals(resdir):
        lines = (resdir / "eval").read_text().split(os.linesep)[1:]
        return [line for line in lines if line and int(line.split("\t")[0]) >= start]

    assert evals(got_dir) == evals(want_dir)


def test_checkpoints_carry_the_straggler_buffer(straggler_runs):
    tmp, _ = straggler_runs
    assert ((tmp / "port" / "checkpoint-0").read_bytes()
            == (tmp / "jax" / "checkpoint-0").read_bytes())
    _tracks(tmp / "port", tmp / "jax", 0)
    raw = checkpoint.unpackb(checkpoint._unseal(
        tmp / "port" / "checkpoint-2",
        (tmp / "port" / "checkpoint-2").read_bytes()))
    buffer = np.asarray(raw["state"]["fault_buffer"])
    assert buffer.shape[0] == 6 and np.any(buffer[1] != 0)


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_each_package_resumes_the_other_inside_a_straggler_window(
        tmp_path, monkeypatch, straggler_runs, writer):
    """The other package resumes the step-2 checkpoint (worker 1's stale
    row in the buffer, two more steps of its window to go) and writes the
    uninterrupted run's rows 2-5 and evaluations 2-6."""
    _env(monkeypatch, "256", "64")
    tmp, plan_path = straggler_runs
    source = tmp / writer / "checkpoint-2"
    argv = [*BASE, "--fault-plan", str(plan_path), "--nb-steps", "4",
            "--load-checkpoint", str(source), "--result-directory",
            str(tmp_path / "resumed")]
    if writer == "jax":
        assert driver.run(argv)["steps"] == 6
    else:
        assert jax_main(argv) == 0
    _tracks(tmp_path / "resumed", tmp / writer, 2)


def test_checkpoint_without_fault_buffer_loads_with_cold_buffer(
        tmp_path, monkeypatch):
    _env(monkeypatch, "256", "64")
    plan_path = STRAGGLER_PLAN.save(tmp_path / "plan.json")
    args = driver._postprocess(driver.process_commandline(
        [*BASE, "--fault-plan", str(plan_path), "--result-directory",
         str(tmp_path / "run")]))
    _, engine, state = driver._setup(args)
    assert state.fault_buffer.shape == (6, engine.d)
    state = type(state)(**{**state.__dict__,
                           "fault_buffer": torch.ones_like(state.fault_buffer)})
    path = checkpoint.save(tmp_path / "ckpt", state)
    back = checkpoint.load(path, state)
    assert torch.equal(back.fault_buffer, state.fault_buffer)
    raw = checkpoint.unpackb(checkpoint._unseal(path, path.read_bytes()))
    del raw["state"]["fault_buffer"]  # what an old checkpoint looks like
    path.write_bytes(checkpoint.packb(raw))  # footer-less too
    fresh = type(state)(**{**state.__dict__, "fault_buffer":
                           torch.zeros_like(state.fault_buffer)})
    loaded = checkpoint.load(path, fresh)
    assert torch.equal(loaded.theta, state.theta)
    assert loaded.fault_buffer.shape == state.fault_buffer.shape
    assert not bool(loaded.fault_buffer.any())


def _spawn(resdir, plan_path, **env):
    env = {**os.environ, "BMT_SYNTH_TRAIN": "256", "BMT_SYNTH_TEST": "64",
           "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           **{key: str(value) for key, value in env.items()}}
    return subprocess.run(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch", *BASE,
         "--fault-plan", str(plan_path), "--nb-steps", "6", "--auto-resume",
         "--result-directory", str(resdir)],
        cwd=str(resdir.parent), env=env, capture_output=True, text=True,
        timeout=600, check=False)


def test_killed_inside_the_window_resumes_to_the_uninterrupted_csvs(
        tmp_path):
    plan_path = STRAGGLER_PLAN.save(tmp_path / "plan.json")
    full, part = tmp_path / "full", tmp_path / "part"
    assert _spawn(full, plan_path).returncode == 0
    proc = _spawn(part, plan_path, BMT_CHAOS_KILL_AT_STEP=3)
    assert proc.returncode == -9
    assert checkpoint.find_latest_valid(part).name == "checkpoint-2"
    proc = _spawn(part, plan_path)
    assert proc.returncode == 0, proc.stderr
    assert "from checkpoint-2" in proc.stdout
    assert (part / "eval").read_bytes() == (full / "eval").read_bytes()
    header, rows = _study(part)
    fheader, frows = _study(full)
    assert header == fheader == "# " + "\t".join(
        STUDY_COLUMNS + FAULT_COLUMNS + RECOVERY_COLUMNS)
    assert [row[:-1] for row in rows] == [row[:-1] for row in frows]
    assert [row[-1] for row in rows] == ["0", "0"] + ["1"] * 4
    assert ((part / "checkpoint-6").read_bytes()
            == (full / "checkpoint-6").read_bytes())
