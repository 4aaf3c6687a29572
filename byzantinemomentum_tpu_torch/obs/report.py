"""One-page text summary of a run directory's telemetry
(`byzantinemomentum_tpu/obs/report.py`).

`render_report(run_dir)` digests `telemetry.jsonl`, `heartbeat.json`,
`config.json`, `health_blackbox.json` and `attribution.json` where they
exist into what an operator asks of a run: is it alive, how fast is it
going, what did checkpoints and evaluations cost, and did anything
happen on its timeline (a fault, a rollback, a restart, an anomaly).
Stdlib only, usable on any run directory, live or dead.

The JAX report also renders a cluster run's fleet timeline and incident
bundles (`obs/trace/`) and replays a `metrics.jsonl` through the SLO
evaluator (`obs/metrics/`); those read files of the cluster and the
metrics plane, which the port does not have yet (`ROADMAP.md` section 1
item 8) and which a port run directory never holds, so on a port run
directory the JAX report and this one give the same text. The port does
not write `attribution.json` yet either (`--attribution`, item 4); its
section renders one where it is found.

Entry point: `python -m byzantinemomentum_tpu_torch.obs <run_dir>`.
"""

import argparse
import json
import pathlib
import time

from byzantinemomentum_tpu_torch.obs.heartbeat import read_heartbeat
from byzantinemomentum_tpu_torch.obs.recorder import load_records

__all__ = ["render_report", "main"]

# Events worth listing individually on the one-pager (the resilience +
# forensics timeline); everything else is summarized by count.
_TIMELINE_EVENTS = ("restart", "rollback", "divergence_giveup", "retry",
                    "checkpoint_invalid", "profiler_window", "attribution",
                    "run_start", "run_end", "suspect_worker",
                    "suspect_cleared", "serve_trace_snapshot",
                    "health_anomaly", "health_cleared", "health_flag",
                    "health_blackbox", "slo_burn", "slo_ok")


def _fmt_seconds(seconds):
    if seconds is None:
        return "?"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.1f}ms"
    if seconds < 120.0:
        return f"{seconds:.2f}s"
    return f"{seconds / 60.0:.1f}min"


def _stats(values):
    values = [float(v) for v in values]
    return (min(values), sum(values) / len(values), max(values))


def _load_attribution(run_dir):
    """The run's `attribution.json` (or None) — duplicated tiny reader so
    the report stays importable without the obs.attrib package loaded."""
    try:
        data = json.loads((pathlib.Path(run_dir)
                           / "attribution.json").read_text())
    except (OSError, ValueError):
        return None
    return data if (isinstance(data, dict)
                    and data.get("kind") == "attribution") else None


def _attribution_lines(att):
    """Render the "perf attribution" section: per-phase ms/step ranked by
    cost, the op-class split, and the floor distance when known."""
    lines = ["perf attribution: "
             f"{att.get('total_ms', 0.0):.3f} ms/step over "
             f"{att.get('steps', '?')} traced steps "
             f"(backend {att.get('backend', '?')})"]
    phases = att.get("phases") or {}
    ranked = sorted(phases.items(),
                    key=lambda kv: -float(kv[1].get("ms", 0.0)))
    for name, entry in ranked:
        ms = float(entry.get("ms", 0.0))
        if ms <= 0.0:
            continue
        total = float(att.get("total_ms") or 0.0)
        share = f" ({ms / total * 100.0:.1f}%)" if total > 0 else ""
        lines.append(f"  {name:<12} {ms:9.4f} ms/step{share}"
                     f"  x{entry.get('ops', 0)}")
    classes = att.get("op_classes") or {}
    if classes:
        lines.append("  op classes: " + ", ".join(
            f"{k}={float(v):.4f}ms" for k, v in sorted(classes.items())))
    extras = []
    if att.get("host_gap_fraction") is not None:
        extras.append(f"host gap {float(att['host_gap_fraction']) * 100:.1f}%")
    if att.get("mfu") is not None:
        extras.append(f"MFU {float(att['mfu']):.3f}")
    if att.get("distance_to_floor") is not None:
        extras.append(f"{float(att['distance_to_floor']):.1f}x off the "
                      f"MXU floor")
    if extras:
        lines.append("  " + ", ".join(extras))
    return lines


def render_report(run_dir):
    """The report as one string (trailing newline included)."""
    run_dir = pathlib.Path(run_dir)
    records = load_records(run_dir)
    heartbeat = read_heartbeat(run_dir)
    lines = [f"== Run report: {run_dir} =="]

    config = None
    try:
        config = json.loads((run_dir / "config.json").read_text())
    except (OSError, ValueError):
        pass  # absent or torn config.json: report without the summary line
    if config:
        keys = ("model", "dataset", "gar", "attack", "nb_workers",
                "nb_decl_byz", "nb_real_byz", "nb_steps")
        summary = ", ".join(f"{k}={config[k]}" for k in keys if k in config)
        lines.append(f"config: {summary}")

    if heartbeat is None:
        lines.append("heartbeat: (none)")
    else:
        age = time.time() - float(heartbeat.get("updated", 0.0))
        fields = [f"step {heartbeat.get('step', '?')}",
                  f"age {_fmt_seconds(age)}",
                  f"pid {heartbeat.get('pid', '?')}"]
        for key, unit in (("steps_per_sec", " steps/s"),
                          ("device_step_ms", " ms/step (device)"),
                          ("rss_mb", " MiB RSS"), ("mfu", " MFU")):
            value = heartbeat.get(key)
            if isinstance(value, (int, float)):
                fields.append(f"{value:.3g}{unit}")
        if heartbeat.get("status"):
            fields.append(f"status={heartbeat['status']}")
        lines.append("heartbeat: " + ", ".join(fields))

    # Perf attribution (obs/attrib): the per-phase view of the traced
    # chunk, read from the run's attribution.json artifact (rendered even
    # for telemetry-less directories — the artifact stands on its own)
    attribution = _load_attribution(run_dir)
    if attribution is not None:
        lines.extend(_attribution_lines(attribution))

    if not records:
        # A telemetry-less directory can still hold a flight recording
        # (e.g. a --no-telemetry run's blackbox): render it standalone
        from byzantinemomentum_tpu_torch.obs.health import load_blackbox
        blackbox = load_blackbox(run_dir)
        if blackbox is not None:
            lines.append(f"health: blackbox [{blackbox.get('reason')}] "
                         f"ring x{len(blackbox.get('ring') or [])}")
        lines.append("telemetry: (no telemetry.jsonl)")
        return "\n".join(lines) + "\n"
    lines.append(f"telemetry: {len(records)} records")

    counters = {}
    for record in records:
        if record.get("kind") == "counter":
            counters[record.get("name")] = record.get("value")
    if counters:
        lines.append("counters: " + ", ".join(
            f"{name}={value}" for name, value in sorted(counters.items())))

    spans = {}
    for record in records:
        if record.get("kind") == "span" and "dur" in record:
            spans.setdefault(record.get("name"), []).append(record["dur"])
    if spans:
        lines.append("spans:")
        for name, durs in sorted(spans.items(),
                                 key=lambda kv: -sum(kv[1])):
            lo, mean, hi = _stats(durs)
            lines.append(f"  {name:<20} x{len(durs):<4} "
                         f"total {_fmt_seconds(sum(durs)):<8} "
                         f"mean {_fmt_seconds(mean):<8} "
                         f"max {_fmt_seconds(hi)}")

    gauges = {}
    for record in records:
        if record.get("kind") == "gauge" and "value" in record:
            gauges.setdefault(record.get("name"), []).append(record["value"])
    if gauges:
        lines.append("gauges:")
        for name, values in sorted(gauges.items()):
            lo, mean, hi = _stats(values)
            lines.append(f"  {name:<20} x{len(values):<4} "
                         f"min {lo:.4g}  mean {mean:.4g}  max {hi:.4g}")

    # Aggregation forensics (obs/forensics.py): the run's standing
    # suspects and suspicion scores, read from the final summary event,
    # plus the flag/clear edge counts
    summary = None
    edges = {"suspect_worker": 0, "suspect_cleared": 0}
    for record in records:
        if record.get("kind") != "event":
            continue
        if record.get("name") == "forensics_summary":
            summary = record.get("data") or {}
        elif record.get("name") in edges:
            edges[record["name"]] += 1
    if summary is not None or any(edges.values()):
        suspects = (summary or {}).get("suspects") or []
        parts = [f"suspects={suspects if suspects else 'none'}",
                 f"flagged x{edges['suspect_worker']}",
                 f"cleared x{edges['suspect_cleared']}"]
        scores = (summary or {}).get("suspicion")
        if scores:
            worst = max(range(len(scores)), key=lambda w: scores[w])
            parts.append(f"max suspicion {scores[worst]:.3g} "
                         f"(worker {worst})")
        lines.append("forensics: " + ", ".join(parts))

    # Numerics flight recorder (obs/health): the run's anomaly story from
    # the health_summary event + edge counts, and the blackbox dump's
    # coordinates when one was written
    health = None
    health_edges = {"health_anomaly": 0, "health_cleared": 0}
    for record in records:
        if record.get("kind") != "event":
            continue
        if record.get("name") == "health_summary":
            health = record.get("data") or {}
        elif record.get("name") in health_edges:
            health_edges[record["name"]] += 1
    from byzantinemomentum_tpu_torch.obs.health import load_blackbox
    blackbox = load_blackbox(run_dir)
    if health is not None or any(health_edges.values()) \
            or blackbox is not None:
        parts = [f"anomalies x{health_edges['health_anomaly']}",
                 f"cleared x{health_edges['health_cleared']}"]
        source = health or (blackbox or {}).get("summary") or {}
        if source.get("var_ratio_ewma") is not None:
            parts.append(f"var/norm EWMA {source['var_ratio_ewma']:.3g}")
        last = source.get("last_anomaly")
        if last:
            parts.append(f"last anomaly {last.get('channel')}"
                         f"@{last.get('step')} ({last.get('rule')})")
        if blackbox is not None:
            parts.append(f"blackbox [{blackbox.get('reason')}] "
                         f"ring x{len(blackbox.get('ring') or [])}")
        lines.append("health: " + ", ".join(parts))

    timeline = [r for r in records if r.get("kind") == "event"
                and r.get("name") in _TIMELINE_EVENTS]
    if timeline:
        t0 = records[0].get("t", 0.0)
        lines.append("timeline:")
        for record in timeline[-20:]:
            offset = _fmt_seconds(max(0.0, record.get("t", t0) - t0))
            data = record.get("data") or {}
            extra = " ".join(f"{k}={v}" for k, v in sorted(data.items()))
            lines.append(f"  +{offset:<9} {record.get('name')}"
                         + (f"  {extra}" if extra else ""))

    other = {}
    for record in records:
        if (record.get("kind") == "event"
                and record.get("name") not in _TIMELINE_EVENTS):
            other[record.get("name")] = other.get(record.get("name"), 0) + 1
    if other:
        lines.append("other events: " + ", ".join(
            f"{name} x{count}" for name, count in sorted(other.items())))
    return "\n".join(lines) + "\n"


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="obs_report",
        description="Render a one-page text summary of a run directory's "
                    "telemetry (telemetry.jsonl + heartbeat.json)")
    parser.add_argument("run_dir", help="result directory of one run")
    args = parser.parse_args(argv)
    run_dir = pathlib.Path(args.run_dir)
    if not run_dir.is_dir():
        print(f"obs_report: {run_dir} is not a directory")
        return 1
    print(render_report(run_dir), end="")
    return 0
