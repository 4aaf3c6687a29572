"""Build one run's `attribution.json` out of a profiler trace window
(`byzantinemomentum_tpu/obs/attrib/attribution.py`).

The artifact answers, per step, where the device time goes by engine
phase (`honest`/`attack`/`gar*`/`update`/`metrics`, from the
`record_function` ranges of `engine/program.py::scope`), how much of it is
relayout data movement, how long the device sat idle on the host inside
the window, and how far the step is from its matrix-unit floor.

Schema (all times ms/step, every field present, `null` when unknown),
the JAX package's:

    {"kind": "attribution", "backend": ..., "device_kind": ...,
     "steps": N, "phases": {phase: {"ms": float, "ops": int}},
     "op_classes": {"mxu"|"relayout"|"memory": float},
     "device_ms": float,        # union of device-event intervals
     "host_gap_ms": float,      # window span - device busy
     "host_gap_fraction": float,
     "total_ms": float,         # device_ms + host_gap_ms == span/steps
     "unattributed_ms": float,  # device events with no phase identity
     "flops_per_step": float|null, "peak_flops": float|null,
     "mfu": float|null, "mxu_floor_ms": float|null,
     "distance_to_floor": float|null}   # total_ms / mxu_floor_ms

The phase dict always carries every engine phase plus `"other"` (device
events outside any phase range) and `"host"` (the gap), so
`sum(p["ms"]) == total_ms`. The arithmetic (`attribute_events`) takes a
list of `kineto.OpEvent`s, so the same events can go through the JAX
function and this one. The JAX module's fallback join by HLO base name
has no counterpart: every event carries its own scope.
"""

import json
import pathlib

from byzantinemomentum_tpu_torch.obs.attrib import kineto
from byzantinemomentum_tpu_torch.obs.attrib import phases as phases_mod

__all__ = ["ATTRIBUTION_NAME", "attribute_events", "attribute_trace",
           "write_attribution", "load_attribution"]

ATTRIBUTION_NAME = "attribution.json"


def attribute_trace(trace_dir, steps, *, flops_per_step=None,
                    peak_flops=None, backend=None, device_kind=None):
    """Attribute one captured trace window to phases and op classes.

    Args:
      trace_dir: the directory `tensorboard_trace_handler` wrote into (or
        a trace file, or a parsed trace).
      steps: training steps the traced window executed (divides totals).
      flops_per_step / peak_flops: `obs/perf.py`'s logical FLOPs and the
        card's peak; both optional (MFU and floor fields go null).
    """
    trace = (trace_dir if isinstance(trace_dir, dict)
             else kineto.load_trace(trace_dir))
    return attribute_events(kineto.op_events(trace), steps,
                            flops_per_step=flops_per_step,
                            peak_flops=peak_flops, backend=backend,
                            device_kind=device_kind)


def attribute_events(events, steps, *, flops_per_step=None, peak_flops=None,
                     backend=None, device_kind=None):
    """The attribution of a list of `OpEvent`s over `steps` steps (the
    JAX `attribute_trace`'s arithmetic)."""
    steps = max(1, int(steps))
    phase_ms = {name: 0.0 for name in phases_mod.PHASES}
    phase_ms["other"] = 0.0
    phase_ops = {name: 0 for name in phase_ms}
    class_ms = {name: 0.0 for name in phases_mod.OP_CLASSES}
    unattributed = 0.0
    for event in events:
        phase = phases_mod.phase_of(event.scope)
        if phase is None:
            phase = "other"
            unattributed += event.dur_ms
        phase_ms[phase] += event.dur_ms
        phase_ops[phase] += 1
        class_ms[phases_mod.op_class_of(event.name)] += event.dur_ms

    busy_ms, span_ms = kineto.window_span(events)
    host_gap_ms = max(0.0, span_ms - busy_ms)
    # The union of intervals (busy) is what the device actually worked;
    # overlapping kernels can make the naive duration sum exceed it:
    # scale the buckets so they tile the busy time and sum(phases) ==
    # total holds exactly
    raw_total = sum(phase_ms.values())
    scale = (busy_ms / raw_total) if raw_total > 0 else 0.0
    phase_ms = {k: v * scale for k, v in phase_ms.items()}
    class_ms = {k: v * scale for k, v in class_ms.items()}
    unattributed *= scale

    def per_step(ms):
        return ms / steps

    phases_out = {
        name: {"ms": per_step(ms), "ops": phase_ops[name]}
        for name, ms in phase_ms.items()
    }
    phases_out["host"] = {"ms": per_step(host_gap_ms), "ops": 0}
    device_ms = per_step(busy_ms)
    total_ms = per_step(busy_ms + host_gap_ms)

    mfu = None
    mxu_floor_ms = None
    distance = None
    if flops_per_step and peak_flops:
        mxu_floor_ms = float(flops_per_step) / float(peak_flops) * 1e3
        if total_ms > 0:
            mfu = mxu_floor_ms / total_ms
            distance = total_ms / mxu_floor_ms
    return {
        "kind": "attribution",
        "backend": backend,
        "device_kind": device_kind,
        "steps": steps,
        "phases": phases_out,
        "op_classes": {k: per_step(v) for k, v in class_ms.items()},
        "device_ms": device_ms,
        "host_gap_ms": per_step(host_gap_ms),
        "host_gap_fraction": (host_gap_ms / (busy_ms + host_gap_ms)
                              if busy_ms + host_gap_ms > 0 else 0.0),
        "total_ms": total_ms,
        "unattributed_ms": per_step(unattributed),
        "flops_per_step": flops_per_step,
        "peak_flops": peak_flops,
        "mfu": mfu,
        "mxu_floor_ms": mxu_floor_ms,
        "distance_to_floor": distance,
    }


def write_attribution(directory, attribution, name=ATTRIBUTION_NAME):
    """Write the artifact (stable key order for diffable artifacts)."""
    path = pathlib.Path(directory) / name
    path.write_text(json.dumps(attribution, indent=2, sort_keys=True)
                    + "\n")
    return path


def load_attribution(directory, name=ATTRIBUTION_NAME):
    """The run's attribution artifact, or None when absent or torn."""
    path = pathlib.Path(directory)
    if path.is_dir():
        path = path / name
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None
