"""Compilation of a `FaultPlan` into dense per-step rows
(`byzantinemomentum_tpu/faults/schedule.py`).

`build_schedule` lowers the plan's events into small host numpy arrays of
shape `(horizon + 1, rows)`, the JAX package's: row `horizon` is
all-neutral and every step past the horizon reads it (the horizon
clamp); permanent `device_loss` events live in a separate `(n,)`
first-lost-step vector, so they persist past the horizon.

The port's step counter is a host int (`TrainState.steps`), so a step's
rows are picked on the host: `host_rows(start, count)` packs the rows of
steps `[start, start + count)` into one int32 array, and `upload` sends
it to the device in one copy (`data/device.py::to_device`; a fused chunk
of M steps ships its M rows beside its batches) and returns a
`StepFaults` of `[count, ...]` device tensors; `StepFaults.at(i)` is step
i's, views with no read. Nothing is read back from the device. The
injected-fault count of each step (the `Faults injected` column) is
counted on the host from the same rows, as the JAX `inject` counts them
in the graph.
"""

import typing

import numpy as np
import torch

from byzantinemomentum_tpu_torch.data.device import to_device

__all__ = ["FaultSchedule", "StepFaults", "build_schedule", "NEVER"]

# "Never lost" sentinel of the device-loss vector: any real step compares
# strictly below it (int32, the JAX step counter's dtype)
NEVER = np.iinfo(np.int32).max


class StepFaults(typing.NamedTuple):
    """A step's fault rows as device tensors (`[count, ...]` as `upload`
    returns them, one step's with `at(i)`)."""

    stale: torch.Tensor     # bool[h]: submit the buffered stale gradient
    nan: torch.Tensor       # bool[h]: submission replaced by NaN
    zero: torch.Tensor      # bool[h]: submission replaced by zeros
    scale: torch.Tensor     # f32[h]: submission multiplier (1 = clean)
    dup: torch.Tensor       # i32[h]: source row to copy, -1 = own
    drop: torch.Tensor      # bool[n]: absent this step (device loss incl.)
    injected: torch.Tensor  # i32[]: fault conditions live this step

    def at(self, i):
        """Step `i`'s rows of a `[count, ...]` `StepFaults`."""
        return StepFaults(*(field[i] for field in self))


class FaultSchedule:
    """Host-side compiled form of a `FaultPlan` (see module docstring)."""

    def __init__(self, plan, nb_workers, nb_honests):
        message = plan.validate(nb_workers, nb_honests)
        if message is not None:
            raise ValueError(f"Invalid fault plan: {message}")
        n, h = nb_workers, nb_honests
        T = plan.horizon
        self.plan = plan
        self.nb_workers = n
        self.nb_honests = h
        self.horizon = T
        self.stale = np.zeros((T + 1, h), bool)
        self.nan = np.zeros((T + 1, h), bool)
        self.zero = np.zeros((T + 1, h), bool)
        self.scale = np.ones((T + 1, h), np.float32)
        self.dup = np.full((T + 1, h), -1, np.int32)
        self.drop = np.zeros((T + 1, n), bool)
        self.lost_from = np.full((n,), NEVER, np.int32)
        for e in plan.events:
            steps = slice(e.step, e.end)  # rows T.. stay neutral by clamp
            if e.kind == "straggler":
                self.stale[steps, e.worker] = True
            elif e.kind == "drop_worker":
                self.drop[steps, e.worker] = True
            elif e.kind == "corrupt_gradient":
                if e.mode == "nan":
                    self.nan[steps, e.worker] = True
                elif e.mode == "zero":
                    self.zero[steps, e.worker] = True
                else:
                    self.scale[steps, e.worker] *= e.scale
            elif e.kind == "duplicate_submission":
                self.dup[steps, e.worker] = e.source
            else:  # device_loss
                self.lost_from[e.worker] = min(
                    int(self.lost_from[e.worker]), e.step)

    @property
    def has_stale(self):
        """Whether the engine carries the per-worker stale-gradient buffer
        in `TrainState` (only when a straggler exists)."""
        return bool(self.stale.any())

    def step_rows(self, step):
        """Step `step`'s rows as host arrays: `(stale, nan, zero, scale,
        dup, drop, injected)`. Past the horizon the neutral row, with
        device loss folded into `drop` by the first-lost vector."""
        t = min(step, self.horizon)
        stale, nan, zero = self.stale[t], self.nan[t], self.zero[t]
        scale, dup = self.scale[t], self.dup[t]
        drop = self.drop[t] | (step >= self.lost_from)
        injected = (stale.sum() + drop.sum() + nan.sum() + zero.sum()
                    + (scale != 1.0).sum() + (dup >= 0).sum())
        return stale, nan, zero, scale, dup, drop, int(injected)

    def host_rows(self, start, count):
        """The rows of steps `[start, start + count)` packed into one
        int32 array `[count, 5h + n + 1]`: stale, nan, zero, dup, the
        f32 bits of scale, drop, injected."""
        h, n = self.nb_honests, self.nb_workers
        out = np.empty((count, 5 * h + n + 1), np.int32)
        for i in range(count):
            stale, nan, zero, scale, dup, drop, injected = self.step_rows(
                start + i)
            out[i, :h] = stale
            out[i, h:2 * h] = nan
            out[i, 2 * h:3 * h] = zero
            out[i, 3 * h:4 * h] = dup
            out[i, 4 * h:5 * h] = scale.view(np.int32)
            out[i, 5 * h:5 * h + n] = drop
            out[i, -1] = injected
        return out

    def upload(self, start, count, device):
        """The rows of steps `[start, start + count)` on `device` in one
        copy, as a `StepFaults` of `[count, ...]` tensors."""
        h, n = self.nb_honests, self.nb_workers
        rows = to_device(self.host_rows(start, count), device)
        return StepFaults(
            stale=rows[:, :h] != 0, nan=rows[:, h:2 * h] != 0,
            zero=rows[:, 2 * h:3 * h] != 0,
            scale=rows[:, 4 * h:5 * h].view(torch.float32),
            dup=rows[:, 3 * h:4 * h], drop=rows[:, 5 * h:5 * h + n] != 0,
            injected=rows[:, -1])


def build_schedule(plan, *, nb_workers, nb_honests):
    """Compile `plan`, or None for a plan with no events: the engine then
    runs the fault-free step, with no fault code at all."""
    if plan is None or not plan.events:
        return None
    return FaultSchedule(plan, nb_workers, nb_honests)
