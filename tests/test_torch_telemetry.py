"""The port's run telemetry against the JAX package's: the recorder, the
heartbeat, the perf helpers, the report and the driver's timeline.

* `Telemetry`: a file written by either package reads the same records
  through the other's `load_records` (events, nested spans, counters,
  gauges; numpy and torch scalars in the data); a torn last line is
  skipped by both; the module-level active recorder does nothing while
  none is active.
* The heartbeat: a port heartbeat reads through JAX's `read_heartbeat`
  with the same payload, and the reverse; no `.tmp` is left behind.
* `SlidingRate` gives JAX's rates on the same feed; `StepTimer` on the
  CPU times between its marks.
* The report: JAX's `render_report` and the port's give the same text on
  a port run directory (with health, a rollback and the forensics), the
  clock pinned; `python -m byzantinemomentum_tpu_torch.obs <dir>`
  prints it.
* The driver: the JAX `tests/test_obs.py` line (simples-full, Median,
  6 steps, evaluations and checkpoints every 2, `--telemetry-interval
  2`), its `--auto-resume` pass, and its rollback line
  (`BMT_CHAOS_NAN_AT_STEP=3`, `--rollback-budget 2`) through both
  drivers: the records' kinds, names and steps equal the JAX driver's in
  order, less the JAX-only `compile` events and `recompiles` counter
  (the port compiles no step program); the `eval`, `checkpoint_save`
  and `checkpoint_load` spans, `restart` at step 6, the `rollback` event
  and counter, `run_end` and the final heartbeat as the JAX tests
  require them. `--no-telemetry` writes neither file.
* The layers without a handle: the suspicion tracker's
  `suspect_worker`/`suspect_cleared` events and the checkpoints'
  `checkpoint_mirrored`/`checkpoint_invalid` events equal the JAX
  package's.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import obs as jax_obs
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu.obs.report import render_report as jax_report
from byzantinemomentum_tpu_torch import checkpoint, obs, utils
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.obs.report import render_report

from tests.test_obs import DRIVER_BASE
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX package's compile telemetry, which the port has no counterpart
# of (it compiles no step program)
JAX_ONLY = {("event", "compile"), ("counter", "recompiles")}


def _timeline(directory):
    """(kind, name, step) of each record, the JAX-only ones left out."""
    return [(r["kind"], r["name"], (r.get("data") or {}).get("step"))
            for r in obs.load_records(directory)
            if (r["kind"], r["name"]) not in JAX_ONLY]


def _strip_times(records):
    return [{k: v for k, v in r.items() if k not in ("t", "dur")}
            for r in records]


# --------------------------------------------------------------------------- #
# The recorder and the heartbeat

def _write(module, directory):
    telemetry = module.Telemetry(directory, interval=5)
    module.activate(telemetry)
    try:
        telemetry.event("run_start", argv=["x"], seed=np.int64(3))
        with telemetry.span("outer"):
            with telemetry.span("inner", step=1, value=torch.tensor(2.5)):
                pass
        assert telemetry.counter("rollbacks") == 1
        assert telemetry.counter("rollbacks", 2) == 3
        telemetry.gauge("steps_per_sec", np.float32(12.5), step=5)
        module.emit("rollback", step=5, restored="checkpoint-4")
        with module.span("module_span"):
            pass
        telemetry.heartbeat(step=5, status="running", rss_mb=1.5)
    finally:
        module.deactivate()
        telemetry.close()


def test_records_read_across_packages(tmp_path):
    for name, module in (("port", obs), ("jax", jax_obs)):
        (tmp_path / name).mkdir()
        _write(module, tmp_path / name)
    port, jax = obs.load_records(tmp_path / "port"), jax_obs.load_records(
        tmp_path / "jax")
    assert _strip_times(jax_obs.load_records(tmp_path / "port")) == \
        _strip_times(port)
    assert _strip_times(obs.load_records(tmp_path / "jax")) == \
        _strip_times(jax)
    assert _strip_times(port) == _strip_times(jax)
    spans = {r["name"]: r for r in port if r["kind"] == "span"}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["inner"]["data"] == {"step": 1, "value": 2.5}
    # A torn last line is skipped by both readers
    with (tmp_path / "port" / obs.TELEMETRY_NAME).open("a") as fd:
        fd.write('{"t": 1, "kind": "ev')
    assert len(jax_obs.load_records(tmp_path / "port")) == len(port)
    assert len(obs.load_records(tmp_path / "port")) == len(port)
    assert obs.load_records(tmp_path / "missing") == []


def test_heartbeat_reads_across_packages(tmp_path):
    for name, module in (("port", obs), ("jax", jax_obs)):
        (tmp_path / name).mkdir()
        _write(module, tmp_path / name)
    port = jax_obs.read_heartbeat(tmp_path / "port")
    jax = obs.read_heartbeat(tmp_path / "jax")
    assert port == obs.read_heartbeat(tmp_path / "port")
    for beat in (port, jax):
        for key in ("updated", "pid"):
            beat.pop(key)
        beat["last_event"].pop("t")
    assert port == jax
    assert port["counters"] == {"rollbacks": 3}
    assert port["last_event"] == {"name": "rollback"}
    assert not (tmp_path / "port" / (obs.HEARTBEAT_NAME + ".tmp")).exists()
    assert obs.read_heartbeat(tmp_path / "missing") is None


def test_inactive_recorder_does_nothing():
    obs.deactivate()
    assert obs.active() is None
    obs.emit("nothing", step=1)
    assert obs.counter("nothing") is None
    with obs.span("nothing"):
        pass


def test_sliding_rate_and_step_timer():
    port, jax = obs.SlidingRate(window_s=10.0), jax_obs.SlidingRate(
        window_s=10.0)
    rng = np.random.default_rng(0)
    now, steps = 0.0, 0
    for _ in range(50):
        now += float(rng.uniform(0.1, 2.0))
        steps += int(rng.integers(1, 9))
        port.update(steps, now=now)
        jax.update(steps, now=now)
        assert port.rate() == jax.rate()
    timer = obs.StepTimer(torch.device("cpu"))
    begin = timer.mark()
    time.sleep(0.01)
    seconds = timer.seconds(begin, timer.mark())
    assert seconds >= 0.01 and timer.total == seconds
    assert obs.host_rss_mb() > 0


# --------------------------------------------------------------------------- #
# The driver's timeline

@pytest.fixture(scope="module")
def timelines(tmp_path_factory):
    """Both drivers on the JAX telemetry test's line, its --auto-resume
    pass, and its rollback line."""
    tmp = tmp_path_factory.mktemp("timelines")
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("BMT_SYNTH_TRAIN", "512")
        patch.setenv("BMT_SYNTH_TEST", "128")
        for name, run in (("jax", jax_main),
                          ("port", lambda a: driver.main(["--device", "cpu",
                                                          *a]))):
            argv = DRIVER_BASE + ["--result-directory", str(tmp / name)]
            assert run(argv) == 0
            first = _timeline(tmp / name)
            assert run(argv + ["--auto-resume"]) == 0
            patch.setenv("BMT_CHAOS_NAN_AT_STEP", "3")
            roll = DRIVER_BASE + ["--rollback-budget", "2", "--health",
                                  "--result-directory",
                                  str(tmp / f"{name}-roll")]
            assert run(roll) == 0
            patch.delenv("BMT_CHAOS_NAN_AT_STEP")
            first_roll = _timeline(tmp / f"{name}-roll")
            (tmp / f"{name}.json").write_text(json.dumps(
                [first, first_roll]))
    return tmp


def test_driver_timeline_matches_jax(timelines):
    port_first, port_roll = json.loads((timelines / "port.json").read_text())
    jax_first, jax_roll = json.loads((timelines / "jax.json").read_text())
    assert port_first == jax_first
    assert port_roll == jax_roll
    # With the resume pass appended
    assert _timeline(timelines / "port") == _timeline(timelines / "jax")
    names = {(kind, name) for kind, name, _ in port_first}
    assert {("event", "run_start"), ("event", "data_setup"),
            ("event", "run_end"), ("span", "eval"),
            ("span", "checkpoint_save"),
            ("gauge", "device_step_ms")} <= names
    port_all = obs.load_records(timelines / "port")
    assert not [r for r in port_all if (r["kind"], r["name"]) in JAX_ONLY]
    restarts = [r for r in port_all if r["name"] == "restart"]
    assert restarts and restarts[-1]["data"]["step"] == 6
    assert any(r["name"] == "checkpoint_load" for r in port_all)
    end = [r for r in port_all if r["name"] == "run_end"]
    assert end[0]["data"] == {"step": 6, "status": "completed",
                              "rollbacks": 0, "restarts": 0}
    heartbeat = obs.read_heartbeat(timelines / "port")
    assert heartbeat["step"] == 6 and heartbeat["status"] == "completed"


def test_driver_rollback_timeline_matches_jax(timelines):
    records = obs.load_records(timelines / "port-roll")
    rollback = [r for r in records if r["name"] == "rollback"]
    assert rollback[-1]["data"] == {"step": 2, "restored": "checkpoint-2",
                                    "trigger": "non-finite",
                                    "budget_left": 1}
    counters = [r for r in records if r["name"] == "rollbacks"]
    assert counters and counters[-1]["value"] == 1
    end = [r for r in records if r["name"] == "run_end"][-1]
    assert end["data"]["rollbacks"] == 1
    jrecords = jax_obs.load_records(timelines / "jax-roll")
    for name in ("health_flag", "rollback", "health_blackbox", "run_end"):
        assert ([r.get("data", {}).get("step") for r in records
                 if r["name"] == name]
                == [r.get("data", {}).get("step") for r in jrecords
                    if r["name"] == name]), name
    summary = [r["data"] for r in records if r["name"] == "health_summary"]
    jsummary = [r["data"] for r in jrecords if r["name"] == "health_summary"]
    assert summary[0]["steps"] == jsummary[0]["steps"]
    assert summary[0]["anomalies_total"] == jsummary[0]["anomalies_total"]
    heartbeat = obs.read_heartbeat(timelines / "port-roll")
    assert heartbeat["health"]["steps"] == summary[0]["steps"]


def test_report_equals_jax_on_a_port_run(timelines, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 2e9)
    for name in ("port", "port-roll"):
        text = render_report(timelines / name)
        assert text == jax_report(timelines / name)
    assert "rollbacks=1" in text and "health: " in text
    assert "blackbox [run_end]" in text


def test_obs_entry_point_prints_the_report(timelines):
    proc = subprocess.run(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch.obs",
         str(timelines / "port-roll")], capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"== Run report: {timelines / 'port-roll'}")
    assert "rollbacks=1" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch.obs",
         str(timelines / "missing")], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1 and "is not a directory" in proc.stdout


def test_no_telemetry_writes_no_timeline(tmp_path, monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "512")
    monkeypatch.setenv("BMT_SYNTH_TEST", "128")
    argv = ["--device", "cpu", *DRIVER_BASE, "--nb-steps", "2",
            "--no-telemetry", "--result-directory", str(tmp_path / "off")]
    assert driver.main(argv) == 0
    assert not (tmp_path / "off" / obs.TELEMETRY_NAME).exists()
    assert not (tmp_path / "off" / obs.HEARTBEAT_NAME).exists()
    assert obs.active() is None
    with pytest.raises(utils.UserException, match="mutually exclusive"):
        driver.run(argv + ["--telemetry"])
    with pytest.raises(utils.UserException,
                       match="non-positive telemetry interval"):
        driver.run(argv + ["--telemetry-interval", "0"])


# --------------------------------------------------------------------------- #
# Layers without a handle

def _recorded(tmp_path, name, fn):
    """The events `fn(module)` records through each package's active
    recorder."""
    out = []
    for package, module in (("port", obs), ("jax", jax_obs)):
        directory = tmp_path / f"{package}-{name}"
        directory.mkdir()
        telemetry = module.Telemetry(directory)
        module.activate(telemetry)
        try:
            fn(package)
        finally:
            module.deactivate()
            telemetry.close()
        out.append([(r["name"], r.get("data")) for r in
                    obs.load_records(directory) if r["kind"] == "event"])
    return out


def test_suspicion_edges_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    n, steps = 7, 60
    selections = (rng.uniform(size=(steps, n)) < 0.7).astype(np.float64)
    selections[:30, 6] = 0.0
    distances = rng.uniform(1.0, 2.0, (steps, n))
    distances[:30, 6] = 9.0

    def feed(package):
        tracker = (obs.SuspicionTracker(n) if package == "port"
                   else jax_obs.SuspicionTracker(n))
        for step in range(steps):
            tracker.update(step, selections[step], distances=distances[step])

    port, jax = _recorded(tmp_path, "suspicion", feed)
    assert port == jax
    assert ("suspect_worker" in [name for name, _ in port]
            and "suspect_cleared" in [name for name, _ in port])


def test_checkpoint_events_match_jax(tmp_path, monkeypatch):
    from byzantinemomentum_tpu import checkpoint as jax_checkpoint

    monkeypatch.setenv("BMT_SYNTH_TRAIN", "512")
    monkeypatch.setenv("BMT_SYNTH_TEST", "128")
    argv = ["--nb-steps", "0", "--model", "simples-full", "--seed", "1",
            "--batch-size-test-reps", "1", "--evaluation-delta", "0"]
    for name, run in (("jax", jax_main),
                      ("port", lambda a: driver.main(["--device", "cpu", *a]))):
        assert run(argv + ["--checkpoint-delta", "1", "--result-directory",
                           str(tmp_path / name)]) == 0
    state_path = tmp_path / "port" / "checkpoint-0"

    def save_and_scan(package):
        mod = checkpoint if package == "port" else jax_checkpoint
        directory = tmp_path / f"{package}-ckpt"
        directory.mkdir()
        data = state_path.read_bytes()
        (directory / "checkpoint-3").write_bytes(data[:len(data) // 2])
        (directory / "checkpoint-1").write_bytes(data)
        assert mod.find_latest_valid(directory).name == "checkpoint-1"

    port, jax = _recorded(tmp_path, "scan", save_and_scan)
    assert port == jax == [("checkpoint_invalid", {"file": "checkpoint-3"})]

    template = driver._setup(driver._postprocess(driver.process_commandline(
        ["--device", "cpu", *argv])))[2]

    def mirrored(package):
        if package == "port":
            checkpoint.save(tmp_path / "m-port" / "checkpoint-0", template,
                            mirror=tmp_path / "mirror-port")
            checkpoint.load(tmp_path / "m-port" / "checkpoint-0", template)

    (tmp_path / "m-port").mkdir()
    port, _ = _recorded(tmp_path, "mirror", mirrored)
    assert [name for name, _ in port] == ["checkpoint_mirrored"]
    assert port[0][1] == {"file": "checkpoint-0", "step": 0}
    records = obs.load_records(tmp_path / "port-mirror")
    assert [r["name"] for r in records if r["kind"] == "span"] == [
        "checkpoint_save", "checkpoint_load"]
