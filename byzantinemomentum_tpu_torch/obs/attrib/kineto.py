"""`torch.profiler` trace parsing: the port's counterpart of the JAX
package's `obs/attrib/xplane.py`.

`torch.profiler.tensorboard_trace_handler(directory)` writes one
`<worker>.<time>.pt.trace.json` per capture: Kineto's Chrome-trace JSON,
whose `traceEvents` hold complete events (`"ph": "X"`, `ts` and `dur` in
microseconds) by category. Two layouts matter here:

* **On the card**: the device's work is the events of categories
  `kernel`, `gpu_memcpy` and `gpu_memset`, each with the `correlation`
  id of the host call that issued it (a `cuda_runtime` or
  `cuda_driver` event, `cudaLaunchKernel` and the like).
* **On the CPU**: the device is the host, and its work is the outermost
  `cpu_op` events of each thread (an aten op and the ops it calls count
  once).

Each event's scope is the `/`-joined stack of the engine's phase ranges
(`user_annotation` events named as `phases.PHASES`) that were open on the
host when it was issued. On the card that moment is the launch's time.
The join is by time, whatever thread launched the kernel: the autograd
engine runs the backward of CUDA tensors on a device thread of its own,
outside every range of that thread, so a backward kernel takes the range
of the dispatching thread (the one that opened the phases) that holds
its launch. A kernel whose launch the trace lacks takes the scope of the
kernel before it on its stream.
"""

import bisect
import json
import os
import pathlib

from byzantinemomentum_tpu_torch.obs.attrib.phases import PHASES

__all__ = ["OpEvent", "find_trace", "load_trace", "op_events",
           "aggregate_ops", "window_span"]

# The device's work on the card; the host's on the CPU
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CPU_CATEGORY = "cpu_op"
# The host calls that issue the device's work
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
_RANGE_CATEGORY = "user_annotation"
_PHASE_SET = frozenset(PHASES)


class OpEvent:
    """One device event: name, duration (ms), optional scope path and
    module (here the trace category), plus the raw [start, end) ps
    timestamps for span math (the JAX `xplane.OpEvent`)."""

    __slots__ = ("name", "dur_ms", "scope", "module", "start_ps", "end_ps")

    def __init__(self, name, dur_ms, scope=None, module=None,
                 start_ps=0, end_ps=0):
        self.name = name
        self.dur_ms = dur_ms
        self.scope = scope
        self.module = module
        self.start_ps = start_ps
        self.end_ps = end_ps

    def __repr__(self):
        return (f"OpEvent({self.name!r}, {self.dur_ms:.4f}ms, "
                f"scope={self.scope!r})")


def find_trace(trace_dir):
    """Newest `*.pt.trace.json` that `tensorboard_trace_handler` wrote
    under `trace_dir` (None when no capture completed)."""
    paths = sorted(pathlib.Path(trace_dir).glob("**/*.pt.trace.json"),
                   key=lambda path: (path.stat().st_mtime_ns, path.name))
    return paths[-1] if paths else None


# Refuse to parse captures above this size (override: BMT_XPLANE_MAX_MB,
# the JAX package's knob). An oversized window would stall a live run for
# minutes and gigabytes; it degrades to a warning instead
_MAX_TRACE_MB = 128.0


def load_trace(trace_dir):
    """The parsed trace of `trace_dir`'s newest capture (or of a trace
    file given directly).

    Raises FileNotFoundError when no capture exists and ValueError for a
    capture past the size cap or one that does not parse: conditions the
    caller decides how to degrade on."""
    path = pathlib.Path(trace_dir)
    if not path.is_file():
        found = find_trace(path)
        if found is None:
            raise FileNotFoundError(
                f"no *.pt.trace.json under {str(path)!r}; did the profiler "
                f"stop?")
        path = found
    size_mb = path.stat().st_size / 2**20
    cap_mb = float(os.environ.get("BMT_XPLANE_MAX_MB", _MAX_TRACE_MB))
    if size_mb > cap_mb:
        raise ValueError(
            f"{str(path)!r} is {size_mb:.0f} MB (cap {cap_mb:.0f} MB, "
            f"BMT_XPLANE_MAX_MB overrides); a window this size traced "
            f"more than one chunk")
    try:
        trace = json.loads(path.read_text())
    except ValueError as err:
        raise ValueError(f"cannot parse {str(path)!r} ({err})") from err
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError(f"{str(path)!r} is not a Chrome trace")
    return trace


def _ps(us):
    return int(round(float(us) * 1e6))


class _Ranges:
    """The phase ranges of one thread, by start: the stack open at a
    time."""

    def __init__(self, ranges):
        self._ranges = sorted(ranges)
        self._starts = [start for start, _, _ in self._ranges]

    def scope(self, t):
        """The `/`-joined names of the ranges holding `t`, outermost
        first (None where none does)."""
        names = [name for start, end, name
                 in self._ranges[:bisect.bisect_right(self._starts, t)]
                 if end > t]
        return "/".join(names) or None


def _complete(trace):
    return [event for event in trace.get("traceEvents", ())
            if event.get("ph") == "X" and "ts" in event]


def op_events(trace):
    """Every device event of a parsed trace (`load_trace`), as
    `OpEvent`s with their scope paths: the card's kernels, copies and
    sets where the trace has them, else the outermost `cpu_op`s."""
    events = _complete(trace)
    by_thread = {}
    for event in events:
        if (event.get("cat") == _RANGE_CATEGORY
                and event.get("name") in _PHASE_SET):
            start = _ps(event["ts"])
            by_thread.setdefault(event.get("tid"), []).append(
                (start, start + _ps(event.get("dur", 0)), event["name"]))
    ranges = {tid: _Ranges(spans) for tid, spans in by_thread.items()}

    def scope(tid, t):
        """The scope at host time `t` on thread `tid`, else on the
        dispatching thread(s) (those that opened phase ranges)."""
        own = ranges.get(tid)
        found = own.scope(t) if own is not None else None
        if found is None:
            for other_tid, other in ranges.items():
                if other_tid != tid:
                    found = other.scope(t)
                    if found is not None:
                        break
        return found

    device = [event for event in events
              if event.get("cat") in _DEVICE_CATEGORIES]
    out = []
    if device:
        launches = {}
        for event in events:
            if event.get("cat") in _LAUNCH_CATEGORIES:
                correlation = (event.get("args") or {}).get("correlation")
                if correlation is not None:
                    launches[correlation] = event
        last_scope = {}  # the scope of the last joined event of a stream
        for event in sorted(device, key=lambda e: e["ts"]):
            stream = (event.get("pid"), event.get("tid"))
            launch = launches.get((event.get("args") or {}).get("correlation"))
            if launch is not None:
                found = scope(launch.get("tid"), _ps(launch["ts"]))
                last_scope[stream] = found
            else:
                found = last_scope.get(stream)
            start = _ps(event["ts"])
            dur = _ps(event.get("dur", 0))
            out.append(OpEvent(event.get("name", ""), dur / 1e9, scope=found,
                               module=event.get("cat"), start_ps=start,
                               end_ps=start + dur))
        return out
    ops = sorted((event for event in events
                  if event.get("cat") == _CPU_CATEGORY),
                 key=lambda e: (e.get("tid"), e["ts"], -e.get("dur", 0)))
    reach = {}  # the end of the last outermost op of a thread
    for event in ops:
        tid = event.get("tid")
        start = _ps(event["ts"])
        dur = _ps(event.get("dur", 0))
        if start < reach.get(tid, -1):
            continue  # inside an outermost op of its thread
        reach[tid] = start + dur
        out.append(OpEvent(event.get("name", ""), dur / 1e9,
                           scope=scope(tid, start), module=_CPU_CATEGORY,
                           start_ps=start, end_ps=start + dur))
    return out


def aggregate_ops(trace_or_dir):
    """Per-op totals `{name: (total_ms, count)}` of a trace directory, a
    trace file or a parsed trace."""
    trace = (trace_or_dir if isinstance(trace_or_dir, dict)
             else load_trace(trace_or_dir))
    totals = {}
    for event in op_events(trace):
        ms, count = totals.get(event.name, (0.0, 0))
        totals[event.name] = (ms + event.dur_ms, count + 1)
    return totals


def window_span(events):
    """(busy_ms, span_ms) of a list of `OpEvent`s: busy is the union of
    the event intervals (overlapping kernels do not double-count), span is
    last-end minus first-start; their difference is the time the device
    sat idle waiting on the host inside the traced window."""
    if not events:
        return 0.0, 0.0
    intervals = sorted((e.start_ps, e.end_ps) for e in events)
    busy_ps = 0
    cur_start, cur_end = intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy_ps += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_ps += cur_end - cur_start
    span_ps = max(e.end_ps for e in events) - intervals[0][0]
    return busy_ps / 1e9, span_ps / 1e9
