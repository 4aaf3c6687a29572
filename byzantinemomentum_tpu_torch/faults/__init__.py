"""Fault injection and resilience (`byzantinemomentum_tpu/faults/`):
system faults as testable behaviour.

Three layers, as in the JAX package:

* declaration (`plan.py`): `FaultPlan`, per-step, per-worker fault
  events and a degradation `FaultPolicy`, JSON round-trippable and
  deterministic (seeded generation);
* injection (`schedule.py`, `inject.py`): the plan compiles to dense
  per-step rows that the training step applies to the stacked honest
  rows on the device before the aggregation; an empty plan compiles to
  None, and the engine then runs the fault-free step;
* degradation policy (`quorum.py`, `sanitize.py`): the dynamic quorum
  (the GAR runs with the effective `(n, f)` of the rows present) and
  NaN-quarantine (corrupt rows detected by `attacks/nan.py::detect` and
  masked out).

The JAX package's `retry.py` (`with_backoff`, the data-download retry)
is not ported, on purpose: the port downloads nothing. `FaultPolicy`
keeps its `fetch_*` fields for validation and the JSON round trip.

Driver surface: `--fault-plan plan.json`; the study CSV gains the
`Faults injected` / `Workers active` / `Quorum f` columns. This module
imports the host-only half (plan authoring and JSON); `build_schedule`
imports the schedule.
"""

from byzantinemomentum_tpu_torch.faults.plan import (
    KINDS, MODES, SYSTEM_KINDS, FaultEvent, FaultPlan, FaultPolicy,
    corrupt_gradient, device_loss, drop_worker, duplicate_submission,
    straggle, straggler)

__all__ = ["FaultEvent", "FaultPlan", "FaultPolicy", "KINDS", "MODES",
           "SYSTEM_KINDS", "build_schedule", "corrupt_gradient",
           "device_loss", "drop_worker", "duplicate_submission", "straggle",
           "straggler"]


def build_schedule(plan, *, nb_workers, nb_honests):
    """Compile a `FaultPlan` for an (n, h) run, None for an empty plan
    (`faults/schedule.py::build_schedule`)."""
    from byzantinemomentum_tpu_torch.faults import schedule
    return schedule.build_schedule(plan, nb_workers=nb_workers,
                                   nb_honests=nb_honests)
