"""The grid runner (`byzantinemomentum_tpu/utils/jobs.py`): a thread pool
dispatching driver subprocesses over devices, for preemptible machines.

As in the JAX package:

* one worker thread per (device x supercharge) slot;
* jobs are (name, seed, command) triples run as subprocesses, their
  stdout and stderr appended to `stdout.log`/`stderr.log` next to the
  results; `submit` expands a name into one run per seed (default seeds
  1-5), each with `--seed <s>`, or, with a seed of None, one seedless run
  under the bare name (the service-job form);
* a run whose final result directory exists is skipped, so an
  interrupted grid resumes for free;
* a failed attempt is retried up to `max_retries` times with exponential
  backoff, in the same `<name>.pending` directory, with `--auto-resume`
  appended to every command (`resume_flag`), so the driver continues
  from the attempt's newest valid checkpoint instead of cold-starting; a
  run out of attempts is parked as `<name>.failed`;
* a stale `.pending` (a killed scheduler) or a previous `.failed` holding
  a valid checkpoint (`checkpoint.py::find_latest_valid`) is adopted and
  resumed instead of rotated away;
* with `heartbeat_timeout`, a run whose progress signal stops advancing
  for that long is SIGKILLed and retried: the driver's atomic
  `heartbeat.json` (`obs/heartbeat.py`), else the study CSV's size and
  mtime for a run without one yet;
* the `.pending`/`.failed` version rotation is race-free across worker
  threads (the rename is the existence test, under a named lock);
* `wait(exit_is_requested)` returns once every run ended, or at once
  when the latch is set.

One difference from the JAX package: its slots pass `--device auto`,
which `torch.device` rejects. The port's default devices are
`("cuda",)`; `cuda:<i>` names one card, and `cpu` runs only where it is
named: there is no fallback. Each slot passes its device to the driver's
`--device` and exports it as `BMT_JOB_DEVICE`.
"""

import os
import pathlib
import queue
import subprocess
import threading
import time

from byzantinemomentum_tpu_torch import utils as _log
from byzantinemomentum_tpu_torch.obs.heartbeat import \
    read_heartbeat as _read_heartbeat
from byzantinemomentum_tpu_torch.utils import NamedLock

__all__ = ["Jobs", "dict_to_cmdlist", "DEFAULT_SEEDS"]

DEFAULT_SEEDS = (1, 2, 3, 4, 5)


def dict_to_cmdlist(options):
    """Flatten `{flag: value}` into a command-line fragment: None and
    False skip the flag, True emits the bare flag, lists and tuples emit
    one flag with several values."""
    cmd = []
    for key, value in options.items():
        if value is None or value is False:
            continue
        cmd.append(f"--{key.replace('_', '-')}")
        if value is True:
            continue
        if isinstance(value, (list, tuple)):
            cmd.extend(str(v) for v in value)
        else:
            cmd.append(str(value))
    return cmd


class Jobs:
    """Thread-pool supervisor of driver subprocesses."""

    def __init__(self, results_dir, devices=("cuda",), supercharge=1,
                 seeds=DEFAULT_SEEDS, max_retries=1, retry_backoff=1.0,
                 heartbeat_timeout=None, resume_flag="--auto-resume"):
        """One worker per device repeated `supercharge` times.

        Supervisor knobs:
          max_retries: extra attempts a failing run gets (0: one attempt);
            attempt k waits `retry_backoff * 2**(k-1)` seconds first.
          heartbeat_timeout: seconds without the run's progress signal
            advancing before the subprocess is killed and the attempt
            counted failed (None disables the watchdog).
          resume_flag: appended to every dispatched command so retried or
            adopted runs continue from their newest valid checkpoint;
            None disables both the flag and the adoption of stale
            directories.
        """
        if supercharge < 1:
            raise ValueError(f"Expected a positive supercharge, got {supercharge}")
        if max_retries < 0:
            raise ValueError(f"Expected a non-negative retry count, got {max_retries}")
        if heartbeat_timeout is not None and heartbeat_timeout <= 0:
            raise ValueError(f"Expected a positive heartbeat timeout, got "
                             f"{heartbeat_timeout}")
        self.results_dir = pathlib.Path(results_dir)
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.seeds = tuple(seeds)
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.heartbeat_timeout = heartbeat_timeout
        self.resume_flag = resume_flag
        self._queue = queue.Queue()
        self._threads = []
        self._started = False
        self._rotate_lock = NamedLock("jobs.rotate")
        self._devices = tuple(devices) * supercharge

    def submit(self, name, command):
        """Queue one experiment under `name`: one run per seed, each
        appending `--seed <s> --result-directory <dir>`; a seed of None
        queues one seedless run under the bare `name` (no `--seed`)."""
        for seed in self.seeds:
            run_name = name if seed is None else f"{name}-{seed}"
            self._queue.put((run_name, seed, list(command)))

    # ------------------------------------------------------------------ #
    # Crash recovery

    @staticmethod
    def _has_valid_checkpoint(directory):
        """Whether `directory` holds a checkpoint a retry can resume from
        (never raises: the supervisor must not die on a mangled
        directory)."""
        try:
            from byzantinemomentum_tpu_torch import checkpoint
            return checkpoint.find_latest_valid(directory) is not None
        except Exception:  # a mangled run directory: no checkpoint, a cold retry
            return False

    def _rotate_away(self, path):
        """Version-rotate `path` out of the way (`<name>.0`, `<name>.1`,
        ...) race-free under concurrent workers: renaming onto a non-empty
        directory fails, so the rename itself is the existence test, and
        the scan-and-rename runs under the per-results-dir lock."""
        with self._rotate_lock:
            version = 0
            while True:
                target = path.with_name(f"{path.name}.{version}")
                try:
                    path.rename(target)
                    return target
                except OSError:
                    if not target.exists():
                        raise
                    version += 1

    def _prepare_pending(self, run_name):
        """The pending directory one run's attempts all share, adopting a
        resumable previous attempt (a stale `.pending` or a `.failed`)
        where there is one."""
        pending = self.results_dir / f"{run_name}.pending"
        failed = self.results_dir / f"{run_name}.failed"
        if pending.exists():
            if self.resume_flag and self._has_valid_checkpoint(pending):
                _log.info(f"{run_name}: adopting stale pending directory "
                          f"(valid checkpoint found; resuming)")
                return pending
            self._rotate_away(pending)
        elif (failed.exists() and self.resume_flag
                and self._has_valid_checkpoint(failed)):
            failed.rename(pending)
            _log.info(f"{run_name}: adopting previous failed attempt "
                      f"(valid checkpoint found; resuming)")
            return pending
        pending.mkdir(parents=True)
        return pending

    # ------------------------------------------------------------------ #
    # One run: up to 1 + max_retries attempts over one pending directory

    def _run_one(self, slot_device, run_name, seed, command):
        final_dir = self.results_dir / run_name
        if final_dir.exists():
            _log.trace(f"{run_name}: already done, skipping")
            return
        pending = self._prepare_pending(run_name)
        cmd = command + (["--seed", str(seed)] if seed is not None else [])
        cmd += ["--device", slot_device,
                "--result-directory", str(pending)]
        if self.resume_flag and self.resume_flag not in cmd:
            # On a fresh directory the flag is a cold start
            cmd = cmd + [self.resume_flag]
        _log.info(f"{run_name}: starting on {slot_device!r}")
        for attempt in range(self.max_retries + 1):
            if attempt:
                delay = self.retry_backoff * (2 ** (attempt - 1))
                resumes = self._has_valid_checkpoint(pending)
                _log.info(f"{run_name}: retry {attempt}/{self.max_retries} "
                          f"in {delay:.1f}s"
                          + (" (resuming from checkpoint)" if resumes
                             else " (cold start)"))
                time.sleep(delay)
            returncode = self._spawn(run_name, pending, cmd, slot_device)
            if returncode == 0:
                pending.rename(final_dir)
                _log.info(f"{run_name}: done")
                return
            _log.error(f"{run_name}: attempt {attempt + 1} failed with "
                       f"code {returncode}")
        failed = self.results_dir / f"{run_name}.failed"
        if failed.exists():
            self._rotate_away(failed)
        pending.rename(failed)
        _log.error(f"{run_name}: failed after {self.max_retries + 1} "
                   f"attempt(s) (logs kept in {run_name}.failed)")

    def _spawn(self, run_name, pending, cmd, slot_device):
        """Launch one attempt; with a heartbeat timeout, watch the run's
        progress signal and SIGKILL the subprocess when it stalls. The
        logs are appended to, so every attempt's output is kept."""
        with (pending / "stdout.log").open("ab") as out, \
                (pending / "stderr.log").open("ab") as err:
            proc = subprocess.Popen(cmd, stdout=out, stderr=err,
                                    env=self._env(slot_device))
            if self.heartbeat_timeout is None:
                return proc.wait()
            poll = self._poll_interval()
            last_beat = time.monotonic()
            last_source = None
            last_sig = self._progress_signature(pending)
            while True:
                try:
                    return proc.wait(timeout=poll)
                except subprocess.TimeoutExpired:
                    pass
                sig = self._progress_signature(pending)
                source = sig[0] if sig is not None else None
                if source is not None and source != last_source:
                    _log.info(f"{run_name}: watchdog tracking "
                              + ("heartbeat.json" if source == "heartbeat"
                                 else "study-CSV mtime (no heartbeat yet)"))
                    last_source = source
                now = time.monotonic()
                if sig != last_sig:
                    last_sig, last_beat = sig, now
                elif now - last_beat > self.heartbeat_timeout:
                    signal_name = ("heartbeat.json" if source == "heartbeat"
                                   else "study CSV")
                    _log.error(f"{run_name}: heartbeat lost ({signal_name} "
                               f"stalled > {self.heartbeat_timeout}s); "
                               f"killing the subprocess")
                    proc.kill()
                    return proc.wait()

    def _poll_interval(self):
        """Seconds between watchdog polls: a quarter of the timeout,
        clamped to [0.05, 0.5] (the floor last, so a tiny timeout polls at
        20 Hz instead of busy-spinning)."""
        return max(0.05, min(0.5, self.heartbeat_timeout / 4.0))

    @staticmethod
    def _progress_signature(pending):
        """The attempt's progress signature, tagged with its source:
        `("heartbeat", step, updated)` from the run's `heartbeat.json`
        where there is one, else `("study", size, mtime)` from the study
        CSV, else None (the process start is then the last beat)."""
        heartbeat = _read_heartbeat(pending)
        if heartbeat is not None:
            return ("heartbeat", heartbeat.get("step"),
                    heartbeat.get("updated"))
        try:
            stat = (pending / "study").stat()
            return ("study", stat.st_size, stat.st_mtime_ns)
        except OSError:
            return None

    @staticmethod
    def _env(device):
        env = dict(os.environ)
        env["BMT_JOB_DEVICE"] = device
        return env

    def _worker(self, slot_device):
        while True:
            try:
                run_name, seed, command = self._queue.get_nowait()
            except queue.Empty:
                return
            try:
                self._run_one(slot_device, run_name, seed, command)
            except Exception as err:  # one run's fault must not end the worker draining the queue
                _log.error(f"{run_name}: scheduler error: {err}")
            finally:
                self._queue.task_done()

    def start(self):
        if self._started:
            return
        self._started = True
        for i, device in enumerate(self._devices):
            t = threading.Thread(target=self._worker, args=(device,),
                                 name=f"jobs-{device}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def wait(self, exit_is_requested=None):
        """Run all queued jobs to completion; `exit_is_requested()` polls
        an abort latch."""
        self.start()
        for t in self._threads:
            while t.is_alive():
                t.join(timeout=0.5)
                if exit_is_requested is not None and exit_is_requested():
                    return
