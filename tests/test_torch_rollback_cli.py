"""The port's divergence rollback and health monitor through its driver,
against the JAX driver on the JAX tests' command lines.

* `tests/test_chaos.py`'s rollback lines (simples-full, Median, 6 steps,
  checkpoints every 2, `BMT_CHAOS_NAN_AT_STEP=3`): with `--rollback-budget
  2` both drivers exit 0 and write `STUDY_COLUMNS + RECOVERY_COLUMNS`,
  steps 0-5 once each, `Rollbacks` 0 0 1 1 1 1, every step and
  `Rollbacks` value equal to JAX's and every float within rtol 1e-4,
  atol 1e-6 (the seed-driver tests' bounds on simples-full); with
  `--rollback-tighten-quorum` f goes from 4 to 5 (both log it) and the
  rows again match; with `BMT_CHAOS_NAN_REPEAT=1` at step 1 and a budget
  of 1 both exit 1; a budget without checkpoints is warned and dropped.
* `tests/test_health.py`'s lines (simples-full, Krum at n = 11 against
  `empire(1.1)`, momentum at the workers, 48 single-step chunks,
  checkpoints every 5, `BMT_CHAOS_BLOWUP_AT_STEP=36` with factor 1e6):
  under `--health --rollback-budget 1` both exit 1, the anomaly edges
  are JAX's (channel, rule, step) and lead the non-finite flag by at
  least 2 steps, the flag and rollback steps are JAX's, the blackbox's
  reason is `divergence_giveup` and its ring and edges are JAX's in
  length and steps; under `--rollback-on-anomaly` every flag and the
  rollback are `anomaly`, the run gives up with exit 1 and the
  heartbeat's `health` block counts the anomalies; both study files hold
  the same steps, `Rollbacks`, histograms and non-finite counts, and
  floats within the tolerance above. The clean Median run with
  `--health` (40 steps, chunks of 2) has the `HEALTH_COLUMNS`, no
  anomaly, a `run_end` blackbox of 40 and a heartbeat with the EWMA.
* Flag validation: `--health` without the study and
  `--rollback-on-anomaly` without a budget print the JAX warnings.
* Port only: a `--gars` mixture run (drawn once a step from the host's
  mirror of the key chain) rolls back and finishes, so the re-seeded
  mirror keeps pace with the device's key.
"""

import os

import numpy as np
import pytest

from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu.engine import HEALTH_COLUMNS as JAX_HEALTH_COLUMNS
from byzantinemomentum_tpu_torch import obs, utils
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import (
    HEALTH_COLUMNS, RECOVERY_COLUMNS, STUDY_COLUMNS)

from tests.test_chaos import ROLL_BASE
from tests.test_health import DRIVER_BASE as HEALTH_BASE
from tests.test_health import _ew_args
from tests.torch_threads import one_torch_thread  # noqa: F401

WIDTH = len(STUDY_COLUMNS)


def _port_main(argv):
    return driver.main(["--device", "cpu", *argv])


DRIVERS = {"jax": jax_main, "port": _port_main}


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


def _same_study(port_dir, jax_dir):
    """Headers equal; steps, points and the integer columns exact; the
    floats within the tolerance; returns the port's rows."""
    header, got = _study(port_dir)
    jheader, want = _study(jax_dir)
    assert header == jheader
    columns = header[2:].split("\t")
    assert [row[:2] for row in got] == [row[:2] for row in want]
    floats = [i for i, name in enumerate(columns)
              if 1 < i < WIDTH or name in HEALTH_COLUMNS[:4]]
    exact = [i for i in range(WIDTH, len(columns)) if i not in floats]
    assert ([[row[i] for i in exact] for row in got]
            == [[row[i] for i in exact] for row in want])
    _floats_close(got, want, floats)
    return columns, got


def _events(resdir, name):
    return [r.get("data") or {} for r in obs.load_records(resdir)
            if r["name"] == name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every line of this file through both drivers: `{(line, driver):
    (exit code, result directory)}`."""
    tmp = tmp_path_factory.mktemp("rollback")
    lines = {
        "roll": (ROLL_BASE + ["--rollback-budget", "2"],
                 {"BMT_CHAOS_NAN_AT_STEP": "3"}),
        "tight": (ROLL_BASE + ["--rollback-budget", "2",
                               "--rollback-tighten-quorum"],
                  {"BMT_CHAOS_NAN_AT_STEP": "3"}),
        "doom": (ROLL_BASE + ["--rollback-budget", "1"],
                 {"BMT_CHAOS_NAN_AT_STEP": "1", "BMT_CHAOS_NAN_REPEAT": "1"}),
        "lead": (None, {"BMT_CHAOS_BLOWUP_AT_STEP": "36",
                        "BMT_CHAOS_BLOWUP_FACTOR": "1e6"}),
        "anomaly": (None, {"BMT_CHAOS_BLOWUP_AT_STEP": "36",
                           "BMT_CHAOS_BLOWUP_FACTOR": "1e6"}),
        "clean": (HEALTH_BASE + ["--gar", "median", "--nb-steps", "40",
                                 "--steps-per-program", "2", "--health"], {}),
    }
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BMT_SYNTH_TRAIN", "512")
        patch.setenv("BMT_SYNTH_TEST", "128")
        for line, (argv, env) in lines.items():
            for name, run in DRIVERS.items():
                resdir = tmp / f"{line}-{name}"
                if line == "lead":
                    argv = _ew_args(resdir, ["--health"])
                elif line == "anomaly":
                    argv = _ew_args(resdir, ["--rollback-on-anomaly"])
                else:
                    argv = lines[line][0] + ["--result-directory",
                                             str(resdir)]
                for key, value in env.items():
                    patch.setenv(key, value)
                out[line, name] = (run(argv), resdir)
                for key in env:
                    patch.delenv(key)
    return out


# --------------------------------------------------------------------------- #
# tests/test_chaos.py's lines

def test_rollback_recovers_as_jax(runs):
    for name in DRIVERS:
        assert runs["roll", name][0] == 0
    header, rows = _study(runs["roll", "port"][1])
    assert header == "# " + "\t".join(STUDY_COLUMNS + RECOVERY_COLUMNS)
    assert [row[0] for row in rows] == [str(i) for i in range(6)]
    assert all(np.isfinite(float(row[2])) for row in rows)
    assert [row[-2] for row in rows] == ["0", "0", "1", "1", "1", "1"]
    _same_study(runs["roll", "port"][1], runs["roll", "jax"][1])
    # The eval file: step 2 once, after the rollback
    for name in DRIVERS:
        evals = (runs["roll", name][1] / "eval").read_text().split(os.linesep)
        assert [row.split("\t")[0] for row in evals[1:]] == ["0", "2", "4",
                                                             "6"]
    assert ((runs["roll", "port"][1] / "eval").read_text()
            == (runs["roll", "jax"][1] / "eval").read_text())


def test_rollback_tightens_the_quorum_as_jax(runs):
    for name in DRIVERS:
        assert runs["tight", name][0] == 0
    _, rows = _same_study(runs["tight", "port"][1], runs["tight", "jax"][1])
    assert [row[0] for row in rows] == [str(i) for i in range(6)]
    assert all(np.isfinite(float(row[2])) for row in rows)


def test_spent_budget_exits_1_as_jax(runs):
    assert runs["doom", "jax"][0] == runs["doom", "port"][0] == 1
    port, jax = (_events(runs["doom", name][1], "divergence_giveup")
                 for name in ("port", "jax"))
    assert port == jax and port
    end = _events(runs["doom", "port"][1], "run_end")
    assert end[-1]["status"] == "diverged"


def test_rollback_budget_requires_checkpoints(capfd):
    args = driver._postprocess(driver.process_commandline(
        ["--device", "cpu", "--rollback-budget", "2", "--nb-steps", "1"]))
    assert args.rollback_budget == 0
    assert ("'--rollback-budget' needs periodic checkpoints "
            "('--checkpoint-delta' with '--result-directory'); rollback "
            "disabled") in capfd.readouterr().err
    with pytest.raises(utils.UserException, match="negative rollback budget"):
        driver._postprocess(driver.process_commandline(
            ["--rollback-budget", "-1"]))


# --------------------------------------------------------------------------- #
# tests/test_health.py's lines

def _edges(resdir):
    return [(e["channel"], e.get("rule"), e["step"])
            for e in _events(resdir, "health_anomaly")]


def test_anomaly_leads_the_flag_as_jax(runs):
    for name in DRIVERS:
        assert runs["lead", name][0] == 1
    port_dir, jax_dir = runs["lead", "port"][1], runs["lead", "jax"][1]
    assert _edges(port_dir) == _edges(jax_dir)
    flags = [e["step"] for e in _events(port_dir, "health_flag")
             if e["trigger"] == "non-finite"]
    anomalies = [step for _, _, step in _edges(port_dir)]
    assert flags and anomalies and min(flags) - min(anomalies) >= 2
    for name in ("health_flag", "rollback", "divergence_giveup"):
        assert _events(port_dir, name) == _events(jax_dir, name), name
    box, jbox = obs.load_blackbox(port_dir), obs.load_blackbox(jax_dir)
    assert box["reason"] == jbox["reason"] == "divergence_giveup"
    assert len(box["ring"]) == len(jbox["ring"])
    assert [e["step"] for e in box["ring"]] == [e["step"] for e in jbox["ring"]]
    assert ([(e["kind"], e["channel"], e["step"]) for e in box["edges"]]
            == [(e["kind"], e["channel"], e["step"]) for e in jbox["edges"]])
    _same_study(port_dir, jax_dir)


def test_rollback_on_anomaly_triggers_on_anomaly_only_as_jax(runs):
    for name in DRIVERS:
        assert runs["anomaly", name][0] == 1
    port_dir, jax_dir = runs["anomaly", "port"][1], runs["anomaly", "jax"][1]
    rollbacks = _events(port_dir, "rollback")
    assert rollbacks and rollbacks[0]["trigger"] == "anomaly"
    flags = [e["trigger"] for e in _events(port_dir, "health_flag")]
    assert flags and all(trigger == "anomaly" for trigger in flags)
    for name in ("health_flag", "rollback", "divergence_giveup"):
        assert _events(port_dir, name) == _events(jax_dir, name), name
    assert _edges(port_dir) == _edges(jax_dir)
    heartbeat = obs.read_heartbeat(port_dir)
    assert heartbeat["status"] == "diverged"
    assert heartbeat["health"]["anomalies_total"] >= 1
    assert (heartbeat["health"]["anomalies_total"]
            == obs.read_heartbeat(jax_dir)["health"]["anomalies_total"])
    assert obs.load_blackbox(port_dir)["reason"] == "divergence_giveup"
    _same_study(port_dir, jax_dir)


def test_clean_run_health_columns_as_jax(runs):
    for name in DRIVERS:
        assert runs["clean", name][0] == 0
    port_dir = runs["clean", "port"][1]
    columns, rows = _same_study(port_dir, runs["clean", "jax"][1])
    assert HEALTH_COLUMNS == JAX_HEALTH_COLUMNS
    assert tuple(columns) == STUDY_COLUMNS + HEALTH_COLUMNS
    hist = columns.index("Norm hist")
    assert all(sum(int(c) for c in row[hist].split(";")) == 11
               for row in rows)
    assert not _events(port_dir, "health_anomaly")
    summary = _events(port_dir, "health_summary")
    assert summary and summary[-1]["anomalies_total"] == 0
    box = obs.load_blackbox(port_dir)
    assert box["reason"] == "run_end" and len(box["ring"]) == 40
    assert obs.read_heartbeat(port_dir)["health"]["var_ratio_ewma"] is not None


# --------------------------------------------------------------------------- #
# Flag validation, and the port's mixture

def test_flag_validation_warns_as_jax(tmp_path, monkeypatch, capfd):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "512")
    monkeypatch.setenv("BMT_SYNTH_TEST", "128")
    lines = ((HEALTH_BASE + ["--nb-steps", "0", "--health"],
              "'--health' needs the study pipeline ('--nb-for-study' with "
              "'--result-directory'); health columns disabled"),
             (HEALTH_BASE + ["--nb-steps", "2", "--rollback-on-anomaly"],
              "'--rollback-on-anomaly' needs '--rollback-budget' (there is "
              "no rollback machinery to trigger); anomaly trigger disabled"))
    for k, (argv, warning) in enumerate(lines):
        for name, run in DRIVERS.items():
            extra = (["--result-directory", str(tmp_path / f"{k}-{name}")]
                     if k else [])
            assert run(argv + extra) == 0
            assert warning in capfd.readouterr().err, name
    # --health stays on (implied) where only the trigger was dropped
    assert "Var ratio" in (tmp_path / "1-port" / "study").read_text()


def test_mixture_rolls_back_and_finishes(tmp_path, monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "512")
    monkeypatch.setenv("BMT_SYNTH_TEST", "128")
    monkeypatch.setenv("BMT_CHAOS_NAN_AT_STEP", "3")
    summary = driver.run(["--device", "cpu", *ROLL_BASE, "--nb-real-byz", "2",
                          "--attack", "empire", "--attack-args", "factor:1.1",
                          "--gars", "median,1;krum,1;average,1",
                          "--rollback-budget", "2", "--result-directory",
                          str(tmp_path / "mix")])
    assert summary["rollbacks"] == 1 and not summary["diverged"]
    assert summary["steps"] == 6 and summary["steps_run"] == 8
    _, rows = _study(tmp_path / "mix")
    assert [row[0] for row in rows] == [str(i) for i in range(6)]
    assert all(np.isfinite(float(row[2])) for row in rows)
