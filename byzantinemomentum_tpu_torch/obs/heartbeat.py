"""The run's `heartbeat.json` (`byzantinemomentum_tpu/obs/heartbeat.py`):
one small file, atomically replaced, that a supervisor reads for
liveness.

The write is `checkpoint.py`'s: the payload to a `.tmp` beside it,
fsync, `os.replace` onto the final name, so a reader never sees a torn
file and a SIGKILL leaves the previous heartbeat or the new one. The
payload always has

  version   int    the schema version (1)
  pid       int    the writer's process id
  updated   float  wall-clock unix seconds of the write
  step      int    the training step as of the write

and whatever the writer knows: `steps_per_sec`, `device_step_ms`,
`rss_mb`, `status`, the recorder's counter totals under `counters`, its
`last_event`, and under `--health` the monitor's `health` block.

The JAX module's per-host heartbeats (`hosts/host-<i>.heartbeat.json`)
belong to its multi-host cluster, which the port does not have yet
(`ROADMAP.md` section 1 item 8).
"""

import json
import os
import pathlib
import time

__all__ = ["HEARTBEAT_NAME", "write_heartbeat", "read_heartbeat"]

HEARTBEAT_NAME = "heartbeat.json"
VERSION = 1


def write_heartbeat(directory, payload, name=HEARTBEAT_NAME):
    """Atomically write `name` under `directory`: `version`, `pid` and
    `updated` stamped here, then `payload`."""
    directory = pathlib.Path(directory)
    record = {"version": VERSION, "pid": os.getpid(), "updated": time.time()}
    record.update(payload)
    path = directory / name
    tmp = path.with_name(path.name + ".tmp")
    with tmp.open("w", encoding="utf-8") as fd:
        fd.write(json.dumps(record, ensure_ascii=False, indent="\t"))
        fd.flush()
        os.fsync(fd.fileno())
    os.replace(tmp, path)
    return path


def read_heartbeat(directory, name=HEARTBEAT_NAME):
    """The parsed heartbeat of a run directory, or None where it is
    absent or does not parse (never raises)."""
    path = pathlib.Path(directory) / name
    try:
        record = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    return record if isinstance(record, dict) else None
