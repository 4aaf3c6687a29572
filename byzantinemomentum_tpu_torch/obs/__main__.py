"""`python -m byzantinemomentum_tpu_torch.obs`: the telemetry tooling's
entry point (`byzantinemomentum_tpu/obs/__main__.py`).

Two modes:

* `--selfcheck [--device cpu]`: exercise the recorder, heartbeat, report
  and forensics in a temporary directory, then the health monitor's
  detection contract (`health_selfcheck`) and the attribution pipeline
  (`attribution_selfcheck`: a tiny program whose ranges are named like
  the engine's phases, traced with `torch.profiler` on the card, or on
  the CPU with `--device cpu`, and attributed), and exit 0 iff every
  invariant holds. It prints one `health: {...}` and one
  `attribution: {...}` JSON line. The JAX module's closed-loop and
  metrics self-checks wait for the arena and the metrics plane
  (`ROADMAP.md` section 1 item 8).
* `<run_dir>`: render the one-page report (`obs/report.py`).
"""

import argparse
import json
import pathlib
import sys
import tempfile


def selfcheck(device="cuda"):
    """End-to-end smoke of the obs stack; returns 0 on success, raising
    AssertionError (non-zero exit) on a broken invariant. The attribution
    part runs on `device`."""
    from byzantinemomentum_tpu_torch import obs

    with tempfile.TemporaryDirectory(prefix="bmt-obs-selfcheck-") as tmp:
        tmp = pathlib.Path(tmp)
        telemetry = obs.Telemetry(tmp, interval=5)
        obs.activate(telemetry)
        try:
            telemetry.event("run_start", argv=["selfcheck"])
            with telemetry.span("outer"):
                with telemetry.span("inner", step=1):
                    pass
            assert telemetry.counter("recompiles") == 1
            assert telemetry.counter("recompiles", 2) == 3
            telemetry.gauge("steps_per_sec", 123.0, step=5)
            obs.emit("rollback", step=5)       # module-level path
            with obs.span("module_span"):
                pass
            # Forensics: a synthetic run with one planted Byzantine worker
            # (index 4: never selected, far from the cloud) must flag
            # exactly that worker through the active recorder
            tracker = obs.SuspicionTracker(5, min_steps=5)
            selection = [1.0, 1.0, 1.0, 1.0, 0.0]
            distances = [1.0, 1.1, 0.9, 1.0, 9.0]
            for step in range(40):
                tracker.update(step, selection, distances=distances)
            assert tracker.suspects == [4], tracker.suspects
            assert tracker.max() == tracker.suspicion[4]
            telemetry.event("forensics_summary", **tracker.summary())
            telemetry.event("run_end", status="completed")
            telemetry.heartbeat(step=5, steps_per_sec=123.0,
                                rss_mb=obs.host_rss_mb())
        finally:
            obs.deactivate()
            telemetry.close()

        records = obs.load_records(tmp)
        kinds = {r["kind"] for r in records}
        assert kinds == {"event", "span", "counter", "gauge"}, kinds
        flagged = [r["data"]["worker"] for r in records
                   if r["kind"] == "event" and r["name"] == "suspect_worker"]
        assert flagged == [4], flagged
        spans = {r["name"]: r for r in records if r["kind"] == "span"}
        assert spans["inner"]["parent"] == spans["outer"]["id"]
        assert spans["outer"]["parent"] is None
        counters = [r["value"] for r in records if r["kind"] == "counter"]
        assert counters == sorted(counters), "counter went backwards"
        heartbeat = obs.read_heartbeat(tmp)
        assert heartbeat is not None and heartbeat["step"] == 5
        assert heartbeat["counters"]["recompiles"] == 3
        assert heartbeat["last_event"]["name"] == "run_end"
        assert not (tmp / (obs.HEARTBEAT_NAME + ".tmp")).exists()

        from byzantinemomentum_tpu_torch.obs.report import render_report
        report = render_report(tmp)
        assert "recompiles=3" in report and "run_end" in report
        assert "forensics:" in report and "suspects=[4]" in report

    health_selfcheck()
    attribution_selfcheck(device)
    print("obs selfcheck: OK")
    return 0


def health_selfcheck():
    """The numerics flight recorder holds its detection contract: (a) a
    planted mid-run NaN burst is flagged on the burst step; (b) an
    ALIE-style variance collapse is flagged within 5 steps; (c) a clean
    stream with multiplicative noise and slow drift gives no false
    positive over 300 steps; (d) the blackbox ring stays bounded and
    dumps a parseable post-mortem. Host code only. Prints one
    `health: {...}` JSON line."""
    import math
    import random

    from byzantinemomentum_tpu_torch.obs.health import (HealthMonitor,
                                                        load_blackbox)

    rng = random.Random(0xF11687)

    def vector(var, upd, weight, nonfinite=0):
        return {"var_ratio": var, "update_ratio": upd,
                "weight_norm": weight, "nonfinite": nonfinite,
                "norm_hist": [0.0] * 16}

    def noise(sigma=0.05):
        return math.exp(rng.gauss(0.0, sigma))

    clean = HealthMonitor()
    for step in range(300):
        clean.update(step, vector(0.5 * noise(), 1e-3 * noise(),
                                  6.0 * (1.0 + 0.002 * step) * noise()))
    assert clean.anomalies_total == 0, clean.summary()

    burst = HealthMonitor()
    nan_flagged = None
    for step in range(60):
        nonfinite = 3 if 40 <= step < 43 else 0
        burst.update(step, vector(0.5 * noise(), 1e-3 * noise(), 6.0,
                                  nonfinite=nonfinite))
        if burst.anomaly and nan_flagged is None:
            nan_flagged = step
    assert nan_flagged == 40, nan_flagged

    alie = HealthMonitor()
    collapse_at, collapse_flagged = 60, None
    for step in range(90):
        var = (0.5 if step < collapse_at else 0.005) * noise()
        alie.update(step, vector(var, 1e-3 * noise(), 6.0 * noise()))
        if alie.anomaly and collapse_flagged is None:
            collapse_flagged = step
    assert collapse_flagged is not None \
        and collapse_flagged - collapse_at <= 5, collapse_flagged
    assert alie.last_anomaly["channel"] == "var_ratio", alie.last_anomaly

    ring = HealthMonitor(ring=32)
    for step in range(100):
        ring.update(step, vector(0.5, 1e-3, 6.0))
    box = ring.blackbox("selfcheck")
    assert len(box["ring"]) == 32, len(box["ring"])
    with tempfile.TemporaryDirectory(prefix="bmt-health-selfcheck-") as tmp:
        assert ring.dump_blackbox(tmp, "selfcheck") is not None
        loaded = load_blackbox(pathlib.Path(tmp))
        assert loaded is not None and loaded["reason"] == "selfcheck"

    print("health: " + json.dumps({
        "clean_steps": 300,
        "clean_false_positives": clean.anomalies_total,
        "nan_burst_lag": nan_flagged - 40,
        "collapse_lag": collapse_flagged - collapse_at,
        "collapse_rule": alie.last_anomaly.get("rule"),
        "ring_bound": len(box["ring"]),
    }, sort_keys=True))


def attribution_selfcheck(device="cuda"):
    """The attribution pipeline end to end on `device` (the card unless
    'cpu' is named; with no card this raises): trace a tiny program whose
    ranges are named like the engine's phases with `torch.profiler`,
    parse the trace, attribute it, and hold the artifact's invariants
    (the engine's phases found, the phases tiling the window). Prints one
    `attribution: {...}` JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler import tensorboard_trace_handler

    from byzantinemomentum_tpu_torch import obs, utils

    device = utils.resolve_device(device)
    on_card = device.type == "cuda"

    def step(x):
        with record_function("honest"):
            y = x @ x
        with record_function("gar"):
            z = torch.sort(y, dim=0).values
        with record_function("update"):
            w = z * 2.0 + 1.0
        return w.sum()

    x = torch.ones((192, 192), dtype=torch.float32, device=device)
    step(x)  # first calls (library loads) outside the window
    if on_card:
        torch.cuda.synchronize(device)
        kind = torch.cuda.get_device_name(device)
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    else:
        kind = "cpu"
        activities = [ProfilerActivity.CPU]
    steps = 4
    with tempfile.TemporaryDirectory(prefix="bmt-attrib-selfcheck-") as tmp:
        tmp = pathlib.Path(tmp)
        trace_dir = tmp / "trace"
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
            for _ in range(steps):
                step(x)
            if on_card:
                torch.cuda.synchronize(device)

        att = obs.attrib.attribute_trace(trace_dir, steps,
                                         backend=device.type,
                                         device_kind=kind)
        phases = att["phases"]
        assert att["total_ms"] > 0.0, att
        for name in ("honest", "gar", "update"):
            assert phases[name]["ms"] > 0.0, (name, phases)
        # The artifact's invariant: the phase buckets (other and host
        # included) tile the traced window
        total = sum(p["ms"] for p in phases.values())
        assert abs(total - att["total_ms"]) < 1e-6 * max(1.0, total), att
        obs.attrib.write_attribution(tmp, att)
        assert obs.attrib.load_attribution(tmp)["steps"] == steps
        from byzantinemomentum_tpu_torch.obs.report import render_report
        report = render_report(tmp)
        assert "perf attribution" in report and "honest" in report, report
        print("attribution: " + json.dumps({
            "backend": att["backend"],
            "device_kind": kind,
            "steps": steps,
            "total_ms": round(att["total_ms"], 4),
            "phases_ms": {k: round(v["ms"], 4)
                          for k, v in sorted(phases.items())
                          if v["ms"] > 0.0},
            "op_classes_ms": {k: round(v, 4)
                              for k, v in sorted(att["op_classes"].items())},
            "host_gap_fraction": round(att["host_gap_fraction"], 4),
        }, sort_keys=True))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--selfcheck" in argv:
        parser = argparse.ArgumentParser(
            prog="python -m byzantinemomentum_tpu_torch.obs")
        parser.add_argument("--selfcheck", action="store_true")
        parser.add_argument("--device", default="cuda",
                            help="Device of the attribution self-check: "
                                 "'cuda' (default), 'cuda:<index>' or "
                                 "'cpu'")
        args = parser.parse_args(argv)
        from byzantinemomentum_tpu_torch import utils
        try:
            return selfcheck(args.device)
        except utils.UserException as err:
            utils.error(f"Error: {err}")
            return 1
    from byzantinemomentum_tpu_torch.obs.report import main as report_main
    return report_main(argv)


if __name__ == "__main__":
    sys.exit(main())
