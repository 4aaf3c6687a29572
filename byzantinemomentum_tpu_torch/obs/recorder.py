"""Span/event/counter/gauge recorder writing an append-only
`telemetry.jsonl` per run (`byzantinemomentum_tpu/obs/recorder.py`, the
same record schema, so either package reads the other's files).

One JSON object per line; every record carries

  t     float   wall-clock unix seconds the record was written
  kind  str     "span" | "event" | "counter" | "gauge"
  name  str     what the record describes (snake_case)

plus per kind:

  span     id (int), parent (int | None), dur (float seconds); written
           at the span's exit, so `t - dur` is its start, and nesting
           is rebuilt through `parent`
  event    data (dict, optional): JSON-safe facts
  counter  value (int, the running total), inc (int)
  gauge    value (float), and optional data (e.g. the step sampled at)

Each record is flushed as it is written: a SIGKILL loses at most the
line being written, and `load_records` skips a torn last line.

`heartbeat` snapshots the counters and the last event on the calling
thread and hands the atomic write (`heartbeat.py`: tmp, fsync,
`os.replace`) to one writer thread, in order, so a telemetry sample
does not hold the training loop for an fsync; `close` waits for the
writes queued before it.

The module-level *active recorder* (`activate`/`deactivate` and the free
functions `emit`/`span`/`counter`) is how layers without a handle
(`checkpoint.py`, the health monitor, the suspicion tracker) reach the
run's timeline; each free function does nothing while no recorder is
active.

The JAX module's `install_compile_listener` counts XLA compiles through
`jax.monitoring` into a `recompiles` counter and `compile` events; the
port compiles no step program, so it has no counterpart, and the port's
timelines hold no `recompiles` counter and no `compile` event.
"""

import contextlib
import itertools
import json
import os
import pathlib
import time
from concurrent.futures import ThreadPoolExecutor

from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.obs.heartbeat import write_heartbeat

__all__ = ["TELEMETRY_NAME", "Telemetry", "activate", "deactivate", "active",
           "emit", "span", "counter", "load_records"]

TELEMETRY_NAME = "telemetry.jsonl"


def _jsonable(value):
    """A record field as something `json.dumps` takes (numpy and 0-d
    torch scalars through `.item()`, anything else as its `str`)."""
    if isinstance(value, (str, int, float, bool, type(None))):
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass  # not a scalar: its str below
    return str(value)


class Telemetry:
    """One run's recorder (thread-safe)."""

    def __init__(self, directory, interval=50, filename=TELEMETRY_NAME):
        self.directory = pathlib.Path(directory)
        self.interval = max(1, int(interval))
        self.path = self.directory / filename
        self._fd = self.path.open("a", encoding="utf-8")
        self._lock = utils.NamedLock("telemetry.file")
        self._ids = itertools.count(1)
        self._stack = []           # open span ids, innermost last
        self._counters = {}
        self._last_event = None    # {"name": ..., "t": ...}
        self._beats = None         # the heartbeat's writer thread
        self._writes = []          # its writes not yet seen to end

    # -------------------------------------------------------------- #
    # Record writers

    def _write(self, record):
        with self._lock:
            if self._fd is None:
                return  # a closed recorder drops the record
            self._fd.write(json.dumps(record, ensure_ascii=False,
                                      separators=(",", ":")) + "\n")
            self._fd.flush()

    def event(self, name, **data):
        """A point-in-time fact; `data` goes under the record's `data`."""
        record = {"t": time.time(), "kind": "event", "name": str(name)}
        if data:
            record["data"] = _jsonable(data)
        self._last_event = {"name": str(name), "t": record["t"]}
        self._write(record)

    @contextlib.contextmanager
    def span(self, name, **data):
        """A timed scope, nested through parent span ids; its record is
        written at its exit."""
        span_id = next(self._ids)
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            self._stack.append(span_id)
        start = time.monotonic()
        try:
            yield span_id
        finally:
            dur = time.monotonic() - start
            with self._lock:
                if span_id in self._stack:
                    self._stack.remove(span_id)
            record = {"t": time.time(), "kind": "span", "name": str(name),
                      "id": span_id, "parent": parent, "dur": dur}
            if data:
                record["data"] = _jsonable(data)
            self._write(record)

    def counter(self, name, inc=1):
        """A monotonic counter; returns the new running total."""
        inc = int(inc)
        if inc < 0:
            raise ValueError(f"Counter increments must be >= 0, got {inc}")
        with self._lock:
            total = self._counters.get(name, 0) + inc
            self._counters[name] = total
        self._write({"t": time.time(), "kind": "counter", "name": str(name),
                     "value": total, "inc": inc})
        return total

    def gauge(self, name, value, **data):
        """A sampled measurement (steps/s, device step ms, RSS)."""
        record = {"t": time.time(), "kind": "gauge", "name": str(name),
                  "value": float(value)}
        if data:
            record["data"] = _jsonable(data)
        self._write(record)

    # -------------------------------------------------------------- #
    # What the heartbeat snapshots

    @property
    def counters(self):
        with self._lock:
            return dict(self._counters)

    @property
    def last_event(self):
        return self._last_event

    def heartbeat(self, step, **gauges):
        """Atomically (re)write the run's `heartbeat.json` with the step,
        the counter totals, the last event and `gauges` (`heartbeat.py`),
        on the writer thread."""
        payload = {"step": int(step), "counters": self.counters,
                   "last_event": self._last_event}
        payload.update({k: _jsonable(v) for k, v in gauges.items()})
        if self._beats is None:
            self._beats = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="heartbeat")
        self._settle(wait=False)
        self._writes.append(self._beats.submit(self._write_heartbeat,
                                               payload))

    def _settle(self, wait):
        """Read the results of the ended heartbeat writes (all of them
        with `wait`), so that one that raised raises here."""
        pending = []
        for write in self._writes:
            if wait or write.done():
                write.result()
            else:
                pending.append(write)
        self._writes = pending

    def _write_heartbeat(self, payload):
        try:
            write_heartbeat(self.directory, payload)
        except OSError as err:
            # A full disk must not end the run: the next beat tries again
            utils.warning(f"Heartbeat write failed: {err}")

    def close(self):
        """Wait for the queued heartbeats, then close the file."""
        if self._beats is not None:
            self._beats.shutdown(wait=True)
            self._beats = None
            self._settle(wait=True)
        with self._lock:
            if self._fd is not None:
                self._fd.close()
                self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ------------------------------------------------------------------------- #
# The module-level active recorder

_ACTIVE = None


def activate(telemetry):
    """Make `telemetry` the process's active recorder (returns it)."""
    global _ACTIVE
    _ACTIVE = telemetry
    return telemetry


def deactivate():
    """Clear the active recorder (without closing it)."""
    global _ACTIVE
    _ACTIVE = None


def active():
    return _ACTIVE


def emit(name, **data):
    """An event on the active recorder, if any."""
    if _ACTIVE is not None:
        _ACTIVE.event(name, **data)


def counter(name, inc=1):
    """Bump a counter on the active recorder, if any (its new total, or
    None)."""
    if _ACTIVE is not None:
        return _ACTIVE.counter(name, inc)
    return None


def span(name, **data):
    """A span on the active recorder; a scope that records nothing while
    none is active."""
    if _ACTIVE is not None:
        return _ACTIVE.span(name, **data)
    return contextlib.nullcontext()


# ------------------------------------------------------------------------- #
# Reader

def load_records(path):
    """The records of a `telemetry.jsonl` (a file or a run directory) as
    dicts, skipping lines that do not parse (a SIGKILL can tear the
    last); [] for a missing file."""
    path = pathlib.Path(path)
    if path.is_dir():
        path = path / TELEMETRY_NAME
    records = []
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return records
    for line in text.split(os.linesep if os.linesep in text else "\n"):
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(record, dict):
            records.append(record)
    return records
