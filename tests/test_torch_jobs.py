"""The port's grid runner (`utils/jobs.py`), the driver's SIGINT/SIGTERM
latch and `python -m byzantinemomentum_tpu_torch.reproduce`, against the
JAX package's.

* Every scenario of `tests/test_jobs.py` (retry until success, give-up,
  adoption of a `.failed` and of a stale `.pending` holding a valid
  checkpoint, the rotation of one without, the watchdog killing a stalled
  run, sparing an advancing study CSV, preferring `heartbeat.json`,
  killing a stale heartbeat, the poll floor, the rotation's versions and
  the seedless service job) runs through both packages' `Jobs`, with the
  same outcomes. The checkpoints are written by the JAX package's
  `checkpoint.save`: the port reads the JAX file format.
* `tests/test_chaos.py`'s killed-and-resumed run through the port's
  `Jobs` and driver on `--device cpu`: the first attempt is SIGKILLed at
  step 5, the retry resumes with `--auto-resume` from checkpoint-4, and
  the rows equal an uninterrupted run's (less the recovery columns).
* The latch: SIGTERM ends an unbounded run with exit 0 and a bounded one
  with 130, `run_end` and the heartbeat say `interrupted`, and the rows
  written are an uninterrupted run's to the stop step byte for byte;
  `run` with the latch already set stops at its first loop top.
* `reproduce.py`: every (name, argv) that the port's scheduler submits
  (smoke, faults, MNIST, CIFAR, the appendix) equals what the root
  `reproduce.py` and `reproduce-appendix.py` submit, less the launcher
  prefix (a recording fake `jobs`); the fault plans are byte-equal.
"""

import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from byzantinemomentum_tpu import checkpoint as jax_checkpoint
from byzantinemomentum_tpu.engine import RECOVERY_COLUMNS
from byzantinemomentum_tpu.utils import jobs as jax_jobs
from byzantinemomentum_tpu_torch import obs
from byzantinemomentum_tpu_torch import reproduce as port_reproduce
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.utils import jobs as port_jobs

from tests.test_chaos import BASE as CHAOS_BASE
from tests.test_checkpoint import tiny_state
from tests.test_jobs import _COUNTING
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"BMT_SYNTH_TRAIN": "512", "BMT_SYNTH_TEST": "128",
       "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
PACKAGES = {"jax": jax_jobs.Jobs, "port": port_jobs.Jobs}


@pytest.fixture(params=sorted(PACKAGES))
def Jobs(request):
    return PACKAGES[request.param]


# --------------------------------------------------------------------------- #
# tests/test_jobs.py's scenarios, through both packages

def test_retry_until_success(Jobs, tmp_path):
    script = _COUNTING + (
        "if n == 0:\n"
        "    sys.exit(7)\n"
        "(d / 'out.txt').write_text('done')\n")
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=2, retry_backoff=0)
    jobs.submit("flaky", [sys.executable, "-c", script])
    jobs.wait()
    assert (tmp_path / "flaky-1" / "out.txt").read_text() == "done"
    assert (tmp_path / "attempts.txt").read_text() == "2"
    assert not (tmp_path / "flaky-1.failed").exists()


def test_gives_up_after_max_retries(Jobs, tmp_path):
    script = _COUNTING + "sys.exit(3)\n"
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=1, retry_backoff=0)
    jobs.submit("doomed", [sys.executable, "-c", script])
    jobs.wait()
    assert (tmp_path / "doomed-1.failed" / "stderr.log").exists()
    assert (tmp_path / "attempts.txt").read_text() == "2"


def test_adopts_failed_attempt_with_checkpoint(Jobs, tmp_path):
    failed = tmp_path / "run-1.failed"
    failed.mkdir(parents=True)
    jax_checkpoint.save(failed / "checkpoint-3", tiny_state(steps=3))
    script = (
        "import sys, pathlib\n"
        "assert '--auto-resume' in sys.argv\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "assert (d / 'checkpoint-3').is_file()\n"
        "(d / 'out.txt').write_text('resumed')\n")
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=0, retry_backoff=0)
    jobs.submit("run", [sys.executable, "-c", script])
    jobs.wait()
    assert (tmp_path / "run-1" / "out.txt").read_text() == "resumed"
    assert (tmp_path / "run-1" / "checkpoint-3").is_file()
    assert not failed.exists()


def test_adopts_stale_pending_with_checkpoint(Jobs, tmp_path):
    pending = tmp_path / "run-1.pending"
    pending.mkdir(parents=True)
    jax_checkpoint.save(pending / "checkpoint-5", tiny_state(steps=5))
    script = (
        "import sys, pathlib\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "assert (d / 'checkpoint-5').is_file()\n"
        "(d / 'out.txt').write_text('adopted')\n")
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=0, retry_backoff=0)
    jobs.submit("run", [sys.executable, "-c", script])
    jobs.wait()
    assert (tmp_path / "run-1" / "out.txt").read_text() == "adopted"
    assert not list(tmp_path.glob("run-1.pending*"))


def test_stale_pending_without_checkpoint_is_rotated(Jobs, tmp_path):
    pending = tmp_path / "run-1.pending"
    pending.mkdir(parents=True)
    (pending / "junk.txt").write_text("stale")
    script = (
        "import sys, pathlib\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "assert not (d / 'junk.txt').exists()\n"
        "(d / 'out.txt').write_text('fresh')\n")
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=0, retry_backoff=0)
    jobs.submit("run", [sys.executable, "-c", script])
    jobs.wait()
    assert (tmp_path / "run-1" / "out.txt").read_text() == "fresh"
    assert (tmp_path / "run-1.pending.0" / "junk.txt").read_text() == "stale"


def test_heartbeat_watchdog_kills_stalled_run(Jobs, tmp_path):
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=0, retry_backoff=0,
                heartbeat_timeout=0.5)
    jobs.submit("hung", [sys.executable, "-c", "import time; time.sleep(60)"])
    start = time.monotonic()
    jobs.wait()
    assert time.monotonic() - start < 30
    assert (tmp_path / "hung-1.failed").is_dir()


def test_heartbeat_watchdog_spares_advancing_run(Jobs, tmp_path):
    script = (
        "import sys, time, pathlib\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "study = d / 'study'\n"
        "for i in range(8):\n"
        "    study.open('a').write(f'row {i}\\n')\n"
        "    time.sleep(0.25)\n"
        "(d / 'out.txt').write_text('done')\n")
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=0, retry_backoff=0,
                heartbeat_timeout=1.0)
    jobs.submit("steady", [sys.executable, "-c", script])
    jobs.wait()
    assert (tmp_path / "steady-1" / "out.txt").read_text() == "done"


def test_heartbeat_watchdog_prefers_heartbeat_json(Jobs, tmp_path):
    script = (
        "import sys, time, json, os, pathlib\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "for i in range(8):\n"
        "    tmp = d / 'heartbeat.json.tmp'\n"
        "    tmp.write_text(json.dumps({'step': i, 'updated': time.time()}))\n"
        "    os.replace(tmp, d / 'heartbeat.json')\n"
        "    time.sleep(0.25)\n"
        "(d / 'out.txt').write_text('done')\n")
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=0, retry_backoff=0,
                heartbeat_timeout=1.0)
    jobs.submit("beating", [sys.executable, "-c", script])
    jobs.wait()
    assert (tmp_path / "beating-1" / "out.txt").read_text() == "done"


def test_heartbeat_watchdog_kills_stale_heartbeat(Jobs, tmp_path):
    script = (
        "import sys, time, json, pathlib\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "(d / 'heartbeat.json').write_text("
        "json.dumps({'step': 0, 'updated': time.time()}))\n"
        "time.sleep(60)\n")
    jobs = Jobs(tmp_path, seeds=(1,), max_retries=0, retry_backoff=0,
                heartbeat_timeout=0.5)
    jobs.submit("stale", [sys.executable, "-c", script])
    start = time.monotonic()
    jobs.wait()
    assert time.monotonic() - start < 30
    assert (tmp_path / "stale-1.failed").is_dir()


def test_watchdog_poll_floor(Jobs, tmp_path):
    def poll(timeout):
        return Jobs(tmp_path, seeds=(1,),
                    heartbeat_timeout=timeout)._poll_interval()
    assert poll(0.01) == 0.05
    assert poll(0.1) == 0.05
    assert poll(1.0) == 0.25
    assert poll(100.0) == 0.5
    with pytest.raises(ValueError, match="heartbeat timeout"):
        Jobs(tmp_path, seeds=(1,), heartbeat_timeout=0)


def test_rotation_skips_existing_versions(Jobs, tmp_path):
    jobs = Jobs(tmp_path, seeds=(1,))
    target = tmp_path / "run-1.failed"
    for name in ("run-1.failed", "run-1.failed.0", "run-1.failed.1"):
        d = tmp_path / name
        d.mkdir()
        (d / "keep.txt").write_text(name)
    rotated = jobs._rotate_away(target)
    assert rotated.name == "run-1.failed.2"
    assert (rotated / "keep.txt").read_text() == "run-1.failed"
    for name in ("run-1.failed.0", "run-1.failed.1"):
        assert (tmp_path / name / "keep.txt").read_text() == name


def test_seedless_service_job(Jobs, tmp_path):
    script = (
        "import sys, pathlib, json\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "(d / 'argv.json').write_text(json.dumps(sys.argv))\n")
    jobs = Jobs(tmp_path, seeds=(None,), max_retries=0, retry_backoff=0)
    jobs.submit("server", [sys.executable, "-c", script])
    jobs.wait()
    argv = json.loads((tmp_path / "server" / "argv.json").read_text())
    assert "--seed" not in argv
    assert "--result-directory" in argv and "--device" in argv
    assert not (tmp_path / "server-None").exists()


def test_port_jobs_default_to_the_card(tmp_path):
    """The one difference from the JAX package: the slots name `cuda`
    (JAX's `auto` is no torch device), and `--device` reaches the driver
    with the slot's device, exported as BMT_JOB_DEVICE too."""
    assert jax_jobs.Jobs(tmp_path)._devices == ("auto",)
    assert port_jobs.Jobs(tmp_path)._devices == ("cuda",)
    assert port_jobs.Jobs(tmp_path, devices=("cuda:0", "cuda:1"),
                          supercharge=2)._devices == (
        "cuda:0", "cuda:1", "cuda:0", "cuda:1")
    assert port_jobs.DEFAULT_SEEDS == jax_jobs.DEFAULT_SEEDS
    script = (
        "import sys, os, json, pathlib\n"
        "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])\n"
        "(d / 'device.json').write_text(json.dumps([sys.argv[sys.argv.index"
        "('--device') + 1], os.environ['BMT_JOB_DEVICE']]))\n")
    jobs = port_jobs.Jobs(tmp_path, devices=("cuda:3",), seeds=(2,),
                          max_retries=0)
    jobs.submit("dev", [sys.executable, "-c", script])
    jobs.wait()
    assert json.loads((tmp_path / "dev-2" / "device.json").read_text()) == [
        "cuda:3", "cuda:3"]
    options = {"nb-steps": 3, "momentum-nesterov": True, "health": False,
               "attack-args": ("factor:1.5", "negative:True"), "gar": None}
    assert port_jobs.dict_to_cmdlist(options) == jax_jobs.dict_to_cmdlist(
        options)


# --------------------------------------------------------------------------- #
# tests/test_chaos.py's killed-and-resumed run, through the port

def _rows(path):
    return [line for line in path.read_text().split(os.linesep)[1:] if line]


def _strip_recovery(rows):
    return [row.rsplit("\t", len(RECOVERY_COLUMNS))[0] for row in rows]


def test_jobs_resume_a_killed_port_run(tmp_path, monkeypatch):
    """The port's `Jobs` runs the port's driver; the first attempt is
    SIGKILLed at step 5 (armed by a fuse file, so only once), the retry
    resumes from the pending directory's checkpoint-4, and the final
    directory holds the uninterrupted run's rows."""
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    full = tmp_path / "full"
    assert driver.main(["--device", "cpu"] + CHAOS_BASE
                       + ["--result-directory", str(full)]) == 0
    script = (
        "import os, pathlib, runpy, sys\n"
        "fuse = pathlib.Path(sys.argv[sys.argv.index("
        "'--result-directory') + 1]).parent / 'fuse'\n"
        "if not fuse.exists():\n"
        "    fuse.write_text('blown')\n"
        "    os.environ['BMT_CHAOS_KILL_AT_STEP'] = '5'\n"
        "sys.argv = ['byzantinemomentum_tpu_torch'] + sys.argv[1:]\n"
        "runpy.run_module('byzantinemomentum_tpu_torch', "
        "run_name='__main__', alter_sys=True)\n")
    command = [sys.executable, "-c", script] + CHAOS_BASE[:-1]
    assert "--auto-resume" not in command  # the runner appends it
    grid = tmp_path / "grid"
    jobs = port_jobs.Jobs(grid, devices=("cpu",), seeds=(11,),
                          max_retries=1, retry_backoff=0)
    jobs.submit("cell", command)
    jobs.wait()
    done = grid / "cell-11"
    assert done.is_dir(), list(grid.iterdir())
    assert (grid / "fuse").exists()  # the first attempt really was killed
    assert "Auto-resume: restart #1 from checkpoint-4" in (
        done / "stdout.log").read_text()
    assert _rows(done / "eval") == _rows(full / "eval")
    assert (_strip_recovery(_rows(done / "study"))
            == _strip_recovery(_rows(full / "study")))


# --------------------------------------------------------------------------- #
# The driver's SIGINT/SIGTERM latch

LATCH_BASE = ["--device", "cpu", "--batch-size", "8", "--batch-size-test",
              "32", "--batch-size-test-reps", "2", "--evaluation-delta", "8",
              "--model", "simples-full", "--seed", "11", "--gar", "median",
              "--nb-for-study", "11", "--nb-for-study-past", "2",
              "--telemetry-interval", "4", "--steps-per-program", "4"]


@pytest.mark.parametrize("nb_steps, code", [(100000, 130), (-1, 0)])
def test_sigterm_latch_ends_the_run(nb_steps, code, tmp_path, monkeypatch):
    """SIGTERM on a live run: the loop stops at its next loop top, writes
    the pending chunk's rows and ends as a finished run does; a bounded
    run cut short exits 130, an unbounded one 0. Its rows are the
    uninterrupted run's to the stop step."""
    resdir = tmp_path / "live"
    proc = subprocess.Popen(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch", *LATCH_BASE,
         "--nb-steps", str(nb_steps), "--result-directory", str(resdir)],
        cwd=ROOT, env={**os.environ, **ENV}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 240.0
        while time.monotonic() < deadline and proc.poll() is None:
            study = resdir / "study"
            if study.is_file() and len(_rows(study)) >= 12:
                break
            time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[0]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == code, out
    end = [r for r in obs.load_records(resdir)
           if r["kind"] == "event" and r["name"] == "run_end"][-1]["data"]
    assert end["status"] == "interrupted"
    assert obs.read_heartbeat(resdir)["status"] == "interrupted"
    stop = end["step"]
    rows = _rows(resdir / "study")
    assert len(rows) == stop and int(rows[-1].split("\t")[0]) == stop - 1
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    full = tmp_path / "full"
    assert driver.main(LATCH_BASE + ["--nb-steps", str(stop),
                                     "--result-directory", str(full)]) == 0
    assert rows == _rows(full / "study")
    assert _rows(resdir / "eval") == _rows(full / "eval")


@pytest.mark.parametrize("nb_steps, cut_short", [(8, True), (-1, False)])
def test_latched_run_stops_at_its_first_loop_top(nb_steps, cut_short,
                                                 tmp_path, monkeypatch):
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    signals = driver.Signals()
    signals.exit_trigger()
    summary = driver.run(LATCH_BASE + ["--nb-steps", str(nb_steps),
                                       "--result-directory",
                                       str(tmp_path / "run")],
                         signals=signals)
    assert summary["steps"] == 0 and summary["status"] == "interrupted"
    assert summary["cut_short"] is cut_short


# --------------------------------------------------------------------------- #
# reproduce.py: the root scripts' command lines on the port's driver

class RecordingJobs:
    def __init__(self):
        self.submitted = []

    def submit(self, name, command):
        self.submitted.append((name, list(command)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def root_scripts():
    return (_load("_root_reproduce", ROOT / "reproduce.py"),
            _load("_root_reproduce_appendix", ROOT / "reproduce-appendix.py"))


@pytest.mark.parametrize("grid", ["smoke", "faults", "mnist", "cifar",
                                  "appendix"])
def test_reproduce_submits_the_root_scripts_lines(grid, root_scripts,
                                                  tmp_path):
    root, appendix = root_scripts
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    want, got = RecordingJobs(), RecordingJobs()
    if grid == "faults":
        root.submit_faults(want, jax_dir)
        port_reproduce.submit_faults(got, port_dir)
    elif grid == "appendix":
        appendix.submit(want)
        port_reproduce.submit_appendix(got)
    else:
        getattr(root, f"submit_{grid}")(want)
        getattr(port_reproduce, f"submit_{grid}")(got)
    assert got.submitted and len(got.submitted) == len(want.submitted)
    for (name, command), (want_name, want_command) in zip(got.submitted,
                                                          want.submitted):
        assert name == want_name
        assert command[:3] == [sys.executable, "-m",
                               "byzantinemomentum_tpu_torch"]
        assert want_command[1].endswith("attack.py")
        want_args = [arg.replace(str(jax_dir), str(port_dir))
                     for arg in want_command[2:]]
        assert command[3:] == want_args
    if grid == "faults":
        plans = sorted(p.name for p in (jax_dir / "fault-plans").iterdir())
        assert plans == sorted(
            p.name for p in (port_dir / "fault-plans").iterdir())
        for plan in plans:
            assert ((port_dir / "fault-plans" / plan).read_bytes()
                    == (jax_dir / "fault-plans" / plan).read_bytes())


def test_reproduce_grid_sizes_and_parser(root_scripts):
    """The paper's grid: 368 names a seed in the MNIST half, 368 in the
    CIFAR half, 22 in the appendix; the port's lists are the root
    scripts'."""
    root, appendix = root_scripts
    counts = {}
    for grid in ("mnist", "cifar", "appendix"):
        jobs = RecordingJobs()
        getattr(port_reproduce, f"submit_{grid}")(jobs)
        counts[grid] = len(jobs.submitted)
    assert counts == {"mnist": 368, "cifar": 368, "appendix": 22}
    assert port_reproduce.GARS == root.GARS
    assert port_reproduce.ATTACKS == root.ATTACKS == appendix.ATTACKS
    assert port_reproduce.APPENDIX_GARS == appendix.GARS
    assert port_reproduce.FAULT_RATES == root.FAULT_RATES
