"""The numerics flight recorder's host half
(`byzantinemomentum_tpu/obs/health/`): `HealthMonitor`, online SPC over
the per-step health vectors of `engine/health.py` (`--health`), with the
`health_anomaly`/`health_cleared` events, the early-warning rollback
trigger of `--rollback-on-anomaly` and the `health_blackbox.json`
post-mortem ring. Stdlib only."""

from byzantinemomentum_tpu_torch.obs.health.monitor import (  # noqa: F401
    BLACKBOX_NAME,
    CHANNELS,
    HealthMonitor,
    load_blackbox,
)

__all__ = ["BLACKBOX_NAME", "CHANNELS", "HealthMonitor", "load_blackbox"]
