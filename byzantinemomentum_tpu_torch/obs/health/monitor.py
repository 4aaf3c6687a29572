"""Host-side statistical process control over the health stream
(`byzantinemomentum_tpu/obs/health/monitor.py`, the same float64
arithmetic, rules, messages and blackbox schema, stdlib only).

The device half (`engine/health.py`) gives one health vector a step;
this monitor decides online, with bounded state, whether the training
dynamics have left their own envelope. Per channel it keeps an EWMA of
the location and an EWMA of the absolute deviation (a MAD-style scale;
sigma ~= 1.2533 * MAD for a normal stream), both in the log10 domain,
and scores each observation as a signed z. Its rules:

  spike      one observation with |z| >= `z_spike` (default 6)
  run 2/3    2 of the last 3 with z >= `z_run2` (3.5), same side
  run 4/5    4 of the last 5 with z >= `z_run4` (2.5), same side
  nonfinite  any NaN/Inf count > 0: immediate, warm-up exempt

While a channel is anomalous its baseline freezes, and it clears after
`clear_after` consecutive in-control observations (|z| < `z_clear`),
emitting `health_cleared`; `warmup` keeps the first observations from
firing the statistical rules. The blackbox is a bounded ring of the last
`ring` vectors (with their z) and the last anomaly edges, dumped as
`health_blackbox.json`.

The edges land on the run's timeline through the active recorder
(`obs/recorder.py`). The `metrics=` registry of the JAX monitor (its
`health_anomaly_edges`/`health_cleared_edges` counters) belongs to the
metrics plane, which the port does not have yet (`ROADMAP.md` section 1
item 8): the argument stays, and a registry given there is used as the
JAX monitor uses it.
"""

import collections
import json
import math
import pathlib

from byzantinemomentum_tpu_torch.obs import recorder

__all__ = ["BLACKBOX_NAME", "CHANNELS", "HealthMonitor", "load_blackbox"]

BLACKBOX_NAME = "health_blackbox.json"

# Channels scored by the SPC rules, in log10 domain: the paper's
# variance-to-norm ratio (ALIE-style collapse reads as a sustained
# negative run, divergence as a positive one), the update-to-weight
# ratio (the classical step-size health signal) and the global weight
# norm (blow-up reads here first). The non-finite counts are a hard
# rule, not a channel.
CHANNELS = ("var_ratio", "update_ratio", "weight_norm")

# sigma ~= _MAD_SIGMA * E|x - mean| for a normal stream
_MAD_SIGMA = 1.2533

# Log-domain floor: channels can legitimately be 0 (e.g. a zero update
# under lr 0); log10 of the floor keeps them finite without inventing
# structure
_TINY = 1e-30


def _log10(value):
    value = abs(float(value))
    return math.log10(value if value > _TINY else _TINY)


class _Channel:
    """One monitored channel's EWMA/MAD baseline + recent-z window."""

    __slots__ = ("mean", "mad", "seen", "window", "anomalous", "clean_run")

    def __init__(self):
        self.mean = None
        self.mad = 0.0
        self.seen = 0
        self.window = collections.deque(maxlen=5)
        self.anomalous = False
        self.clean_run = 0


class HealthMonitor:
    """Online SPC over the per-step health vectors.

    Args:
      alpha: EWMA smoothing factor (weight of the newest observation).
      warmup: observations before the statistical rules may fire (the
        non-finite rule is exempt).
      z_spike / z_run2 / z_run4: the rule thresholds (see module doc).
      z_clear: |z| below which an observation counts as in-control.
      clear_after: consecutive in-control observations before an
        anomalous channel clears (`health_cleared`).
      ring: bounded blackbox depth (last K full health vectors).
      metrics: optional `MetricsRegistry` (obs/metrics) — anomaly and
        clear EDGES bump `health_anomaly_edges` / `health_cleared_edges`
        counters so the metrics plane carries the same signal the
        telemetry stream does (scrapeable without tailing telemetry).
    """

    def __init__(self, *, alpha=0.05, warmup=30, z_spike=6.0, z_run2=3.5,
                 z_run4=2.5, z_clear=2.0, clear_after=10, ring=256,
                 metrics=None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EWMA alpha must be in (0, 1], got {alpha}")
        if warmup < 1:
            raise ValueError(f"Expected warmup >= 1, got {warmup}")
        if ring < 1:
            raise ValueError(f"Expected ring >= 1, got {ring}")
        if not z_clear <= z_run4 <= z_run2 <= z_spike:
            raise ValueError(
                f"Expected z_clear <= z_run4 <= z_run2 <= z_spike, got "
                f"{z_clear}/{z_run4}/{z_run2}/{z_spike}")
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.z_spike = float(z_spike)
        self.z_run2 = float(z_run2)
        self.z_run4 = float(z_run4)
        self.z_clear = float(z_clear)
        self.clear_after = int(clear_after)
        self.steps = 0
        self.anomalies_total = 0
        self.last_anomaly = None      # the newest rising edge's payload
        self.last_step = None
        self.var_ratio_ewma = None    # linear-domain EWMA (heartbeat)
        self._channels = {name: _Channel() for name in CHANNELS}
        self._nonfinite_active = False
        self._rollback_pending = False
        self._ring = collections.deque(maxlen=int(ring))
        self._edges = collections.deque(maxlen=64)
        if metrics is not None and getattr(metrics, "enabled", False):
            self._m_anomalies = metrics.counter("health_anomaly_edges")
            self._m_cleared = metrics.counter("health_cleared_edges")
        else:
            self._m_anomalies = self._m_cleared = None

    # -------------------------------------------------------------- #

    def _z(self, channel, x):
        """Signed z of log-domain observation `x` against the channel's
        frozen-or-live baseline (0.0 before any baseline exists)."""
        if channel.mean is None:
            return 0.0
        # Scale floor: a perfectly flat warm-up stream has MAD 0; a
        # relative floor keeps its z at 0 instead of +inf, and an
        # absolute floor keeps near-zero log-means sane
        floor = max(abs(channel.mean) * 1e-3, 1e-6)
        sigma = max(_MAD_SIGMA * channel.mad, floor)
        return (x - channel.mean) / sigma

    def _fold(self, channel, x):
        if channel.mean is None:
            channel.mean = x
            channel.mad = 0.0
            channel.seen += 1
            return
        # Warm-up uses the running average (alpha 1/seen) so the baseline
        # converges as fast as the data allows — a fixed small alpha
        # would leave the mean lagging an early-training ramp (weight
        # norm leaving the origin, the momentum warm-up shrinking the
        # variance ratio) and fire the run rules on the transient
        alpha = max(self.alpha, 1.0 / (channel.seen + 1))
        channel.mad = ((1.0 - alpha) * channel.mad
                       + alpha * abs(x - channel.mean))
        channel.mean = (1.0 - alpha) * channel.mean + alpha * x
        channel.seen += 1

    def _rule(self, channel):
        """The first Western-Electric rule the recent window violates
        (None when in control). Run rules require same-side excursions."""
        window = list(channel.window)
        z = window[-1]
        if abs(z) >= self.z_spike:
            return "spike", z
        for depth, need, thresh, name in ((3, 2, self.z_run2, "run2of3"),
                                          (5, 4, self.z_run4, "run4of5")):
            recent = window[-depth:]
            if len(recent) < need:
                continue
            for side in (1.0, -1.0):
                if sum(1 for v in recent if v * side >= thresh) >= need:
                    return name, z
        return None

    # -------------------------------------------------------------- #

    def update(self, step, vector):
        """Fold one step's health vector into the monitor.

        Args:
          step: the step number (stamped on emitted events).
          vector: a dict with `var_ratio`, `update_ratio`, `weight_norm`
            (floats), `nonfinite` (total NaN/Inf count across phases) and
            optionally `norm_hist` (list of bucket counts) plus any extra
            keys — the full vector lands in the blackbox ring verbatim.
        Returns:
          True while any anomaly (statistical or non-finite) is active.
        """
        self.steps += 1
        self.last_step = int(step)
        zs = {}
        for name in CHANNELS:
            channel = self._channels[name]
            raw = vector.get(name)
            if raw is None or not math.isfinite(float(raw)):
                # A non-finite channel value is covered by the hard rule
                # below; never fold it into the baseline
                continue
            x = _log10(raw)
            z = self._z(channel, x)
            channel.window.append(z)
            zs[name] = round(z, 3)
            rule = None
            if self.steps > self.warmup:
                rule = self._rule(channel)
            if rule is not None and not channel.anomalous:
                channel.anomalous = True
                channel.clean_run = 0
                self._edge(True, name, rule[0], rule[1], step, raw)
            elif channel.anomalous:
                if abs(z) < self.z_clear and rule is None:
                    channel.clean_run += 1
                    if channel.clean_run >= self.clear_after:
                        channel.anomalous = False
                        channel.clean_run = 0
                        self._edge(False, name, None, z, step, raw)
                else:
                    channel.clean_run = 0
            if not channel.anomalous:
                # Freeze the baseline while anomalous: the envelope must
                # not adapt to the failure it is flagging
                self._fold(channel, x)

        raw_var = vector.get("var_ratio")
        if raw_var is not None and math.isfinite(float(raw_var)):
            self.var_ratio_ewma = (
                float(raw_var) if self.var_ratio_ewma is None
                else (1.0 - self.alpha) * self.var_ratio_ewma
                + self.alpha * float(raw_var))

        nonfinite = float(vector.get("nonfinite") or 0.0)
        if nonfinite > 0 and not self._nonfinite_active:
            self._nonfinite_active = True
            self._edge(True, "nonfinite", "nonfinite", None, step, nonfinite)
        elif nonfinite == 0 and self._nonfinite_active:
            self._nonfinite_active = False
            self._edge(False, "nonfinite", None, None, step, nonfinite)

        entry = {"step": int(step), "z": zs}
        entry.update({k: self._jsonable(v) for k, v in vector.items()})
        self._ring.append(entry)
        return self.anomaly

    @staticmethod
    def _jsonable(value):
        if isinstance(value, (list, tuple)):
            return [float(v) for v in value]
        try:
            value = float(value)
        except (TypeError, ValueError):
            return str(value)
        # JSON has no Inf/NaN; the blackbox must stay parseable
        return value if math.isfinite(value) else repr(value)

    def _edge(self, rising, channel, rule, z, step, value):
        name = "health_anomaly" if rising else "health_cleared"
        payload = {"channel": channel, "step": int(step),
                   "value": self._jsonable(value)}
        if rising:
            payload["rule"] = rule
            if z is not None:
                payload["z"] = round(float(z), 3)
            self.anomalies_total += 1
            self.last_anomaly = dict(payload)
            self._rollback_pending = True
            if self._m_anomalies is not None:
                self._m_anomalies.inc()
        elif self._m_cleared is not None:
            self._m_cleared.inc()
        recorder.emit(name, **payload)
        self._edges.append({"kind": name, **payload})

    # -------------------------------------------------------------- #

    @property
    def anomaly(self):
        """True while any channel (or the non-finite rule) is active."""
        return (self._nonfinite_active
                or any(c.anomalous for c in self._channels.values()))

    def rollback_pending(self):
        """Consume-once early-warning trigger: True exactly once per
        anomaly rising edge (the driver's `--rollback-on-anomaly` poll —
        one rollback per episode, not one per loop iteration)."""
        pending = self._rollback_pending
        self._rollback_pending = False
        return pending

    def note_rollback(self):
        """The driver rolled the trajectory back: clear the active
        anomalies and recent windows (the post-restore stream is a
        different trajectory) while keeping the learned baselines."""
        self._rollback_pending = False
        self._nonfinite_active = False
        for channel in self._channels.values():
            channel.anomalous = False
            channel.clean_run = 0
            channel.window.clear()

    # -------------------------------------------------------------- #

    def summary(self):
        """JSON-safe snapshot — the heartbeat's `health` block and the
        run-end `health_summary` event payload."""
        return {
            "steps": self.steps,
            "anomaly": self.anomaly,
            "anomalies_total": self.anomalies_total,
            "last_anomaly": self.last_anomaly,
            "var_ratio_ewma": (round(self.var_ratio_ewma, 10)
                               if self.var_ratio_ewma is not None else None),
            "channels": {
                name: {"anomalous": c.anomalous,
                       "mean_log10": (round(c.mean, 4)
                                      if c.mean is not None else None),
                       "mad_log10": round(c.mad, 4)}
                for name, c in self._channels.items()},
        }

    def blackbox(self, reason):
        """The flight recording as one JSON-safe dict."""
        return {
            "kind": "health_blackbox",
            "reason": str(reason),
            "last_step": self.last_step,
            "summary": self.summary(),
            "edges": list(self._edges),
            "ring": list(self._ring),
        }

    def dump_blackbox(self, directory, reason):
        """Write `health_blackbox.json` under `directory` (latest dump
        wins — the newest post-mortem is the one that matters) and emit a
        `health_blackbox` event. Returns the path, or None when the
        write fails (a full disk must not kill the run on its way to a
        rollback)."""
        path = pathlib.Path(directory) / BLACKBOX_NAME
        try:
            path.write_text(json.dumps(self.blackbox(reason),
                                       ensure_ascii=False, indent="\t"))
        except OSError:
            return None
        recorder.emit("health_blackbox", path=str(path), reason=str(reason),
                      ring=len(self._ring))
        return path


def load_blackbox(directory):
    """The parsed `health_blackbox.json` of a run directory, or None when
    absent/torn (report tooling must not die on a mangled dump)."""
    path = pathlib.Path(directory) / BLACKBOX_NAME
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return data if (isinstance(data, dict)
                    and data.get("kind") == "health_blackbox") else None
