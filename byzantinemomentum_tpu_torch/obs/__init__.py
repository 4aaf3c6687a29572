"""Run observation (`byzantinemomentum_tpu/obs/`), the part ported so far.

* **recorder** (`recorder.py`): `Telemetry`, an append-only
  `telemetry.jsonl` per run of spans, events, counters and gauges, and
  the module-level active recorder (`activate`, `emit`, `span`,
  `counter`) through which `checkpoint.py`, the health monitor and the
  suspicion tracker reach the run's timeline.
* **heartbeat** (`heartbeat.py`): the atomically replaced
  `heartbeat.json`.
* **perf** (`perf.py`): sliding-window steps/s, a chunk's device time
  (CUDA events), host RSS.
* **report** (`report.py`, `python -m byzantinemomentum_tpu_torch.obs
  <run_dir>`): the one-page text summary of a run directory.
* **health** (`health/`): `HealthMonitor`, the online SPC over the
  `--health` vectors, its anomaly edges, the `--rollback-on-anomaly`
  trigger and the `health_blackbox.json` ring.
* **forensics** (`forensics.py`): the suspicion tracker over the GAR
  diagnostics stream (`--gar-diagnostics`), emitting `suspect_worker`
  and `suspect_cleared`.

Not ported yet: the profiler side (`attrib/`, `--trace-dir`,
`--attribution`, `--telemetry-mfu`'s FLOP counting, the SIGUSR1 window,
`--selfcheck`; `ROADMAP.md` section 1 item 4), and `trace/`, `metrics/`
and the per-host heartbeats of the cluster (item 8).
"""

from byzantinemomentum_tpu_torch.obs.recorder import (  # noqa: F401
    TELEMETRY_NAME,
    Telemetry,
    activate,
    active,
    counter,
    deactivate,
    emit,
    load_records,
    span,
)
from byzantinemomentum_tpu_torch.obs.heartbeat import (  # noqa: F401
    HEARTBEAT_NAME,
    read_heartbeat,
    write_heartbeat,
)
from byzantinemomentum_tpu_torch.obs.perf import (  # noqa: F401
    SlidingRate,
    StepTimer,
    host_rss_mb,
)
from byzantinemomentum_tpu_torch.obs.forensics import (  # noqa: F401
    COLLUSION_FRAC,
    Z_CLIP,
    SuspicionTracker,
    collusion_partners,
)
from byzantinemomentum_tpu_torch.obs import health  # noqa: F401
from byzantinemomentum_tpu_torch.obs.health import (  # noqa: F401
    HealthMonitor,
    load_blackbox,
)

__all__ = ["TELEMETRY_NAME", "Telemetry", "activate", "active", "counter",
           "deactivate", "emit", "load_records", "span", "HEARTBEAT_NAME",
           "read_heartbeat", "write_heartbeat", "SlidingRate", "StepTimer",
           "host_rss_mb", "SuspicionTracker", "Z_CLIP", "COLLUSION_FRAC",
           "collusion_partners", "health", "HealthMonitor", "load_blackbox"]
