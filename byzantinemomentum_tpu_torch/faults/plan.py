"""Declarative fault plans (`byzantinemomentum_tpu/faults/plan.py`, the
port's own copy): system faults as serializable data.

The `attacks/` package models adversarial workers; this module models
the faults real deployments see: stragglers, dropped workers, corrupted
or NaN gradient shards, duplicated submissions, devices lost mid-run. A
`FaultPlan` declares them per step and per worker, round-trips through
JSON, and compiles (`faults/schedule.py`) into dense per-step rows that
the training step applies on the device (`faults/inject.py`).

Determinism: a plan is data, not a process. The same plan injects the
same faults at the same steps into the same workers, and
`FaultPlan.generate` derives the events from per-kind rates and a seed
(numpy `RandomState`, in the JAX package's iteration order), so a plan
generated here is byte-identical JSON to the JAX package's from the same
`(rates, seed)`.

Worker indexing: faults address workers by their row in the stacked
submission matrix: honest workers are rows `0..h-1`, the Byzantine rows
of an `--attack` follow. Submission-mutating faults (straggler,
corruption, duplication) only make sense on honest rows; `drop_worker`
and `device_loss` may target any row.

The validation messages are the JAX package's word for word (the
`validate_system` ones included, though the port runs no system-scope
chaos).
"""

import dataclasses
import json
import pathlib

__all__ = ["FaultEvent", "FaultPolicy", "FaultPlan", "KINDS", "MODES",
           "SYSTEM_KINDS", "straggler", "drop_worker", "corrupt_gradient",
           "duplicate_submission", "device_loss", "straggle"]

# Fault taxonomy. `device_loss` is the permanent form of `drop_worker`:
# from its step on, the worker never submits again (no duration).
KINDS = ("straggler", "drop_worker", "corrupt_gradient",
         "duplicate_submission", "device_loss")

# corrupt_gradient modes: all-NaN shard, all-zero shard, or a scaled
# (exploding/vanishing) shard.
MODES = ("nan", "zero", "scale")

# Kinds a plan may carry at SYSTEM scope (`cluster/chaos.py`): there,
# `worker` indexes a HOST process of a multi-controller fleet,
# `device_loss` means SIGKILL — real lost hardware, not a masked row —
# and `straggle` means SIGSTOP now / SIGCONT after `window_s` wall-clock
# seconds: a host that is alive-but-not-stepping, the failure mode the
# launcher's straggler policy (`cluster/straggler.py`) must distinguish
# from a corpse. The in-step kinds (straggler/corruption/duplication)
# have no system analogue; `validate_system` refuses them — and
# `validate` refuses the system kinds in-step — so a plan cannot
# silently mean two different things.
SYSTEM_KINDS = ("device_loss", "straggle")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault: `kind` hits `worker` for steps `[step, step + duration)`.

    Field use per kind:
      straggler            — `duration` is the delay window: the worker keeps
                             resubmitting its last pre-window gradient, so
                             staleness grows with the window length.
      drop_worker          — absent for `duration` steps; the degradation
                             policy shrinks the effective quorum.
      corrupt_gradient     — submission mangled per `mode` (`scale` uses
                             `scale`).
      duplicate_submission — submits a byte-copy of worker `source`'s fresh
                             gradient instead of its own.
      device_loss          — permanently gone from `step` on (`duration`
                             ignored).
      straggle             — SYSTEM scope only: the host is SIGSTOP'd when
                             the fleet reaches `step` and SIGCONT'd
                             `window_s` wall-clock seconds later (steps are
                             meaningless to a stopped process, so the
                             window is time, not `duration`).
    """

    kind: str
    worker: int
    step: int
    duration: int = 1
    mode: str = "nan"
    scale: float = 10.0
    source: int = 0
    window_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS and self.kind not in SYSTEM_KINDS:
            raise ValueError(
                f"Unknown fault kind {self.kind!r}; expected one of "
                f"{KINDS + tuple(k for k in SYSTEM_KINDS if k not in KINDS)}")
        if self.kind == "straggle" and self.window_s <= 0:
            raise ValueError(
                f"straggle needs a positive wall-clock window_s, got "
                f"{self.window_s}")
        if self.worker < 0:
            raise ValueError(f"Negative worker index {self.worker}")
        if self.step < 0:
            raise ValueError(f"Negative fault step {self.step}")
        if self.duration < 1:
            raise ValueError(f"Non-positive fault duration {self.duration}")
        if self.kind == "corrupt_gradient" and self.mode not in MODES:
            raise ValueError(
                f"Unknown corruption mode {self.mode!r}; expected one of "
                f"{MODES}")
        if self.kind == "duplicate_submission" and self.source < 0:
            raise ValueError(f"Negative source worker {self.source}")

    @property
    def end(self):
        """First step no longer affected (device_loss never ends)."""
        return self.step + (1 if self.kind == "device_loss"
                            else self.duration)


# Constructor helpers — the declarative surface mirroring the fault
# taxonomy names (`plan = FaultPlan(events=(drop_worker(3, step=10), ...))`).

def straggler(worker, step, delay_steps=1):
    """Worker resubmits its pre-`step` gradient for `delay_steps` steps."""
    return FaultEvent("straggler", worker, step, duration=delay_steps)


def drop_worker(worker, step, duration=1):
    """Worker is absent (no submission) for `duration` steps."""
    return FaultEvent("drop_worker", worker, step, duration=duration)


def corrupt_gradient(worker, step, mode="nan", scale=10.0, duration=1):
    """Worker's submission is corrupted (`nan`, `zero`, or `scale`)."""
    return FaultEvent("corrupt_gradient", worker, step, duration=duration,
                      mode=mode, scale=scale)


def duplicate_submission(worker, step, source, duration=1):
    """Worker submits a copy of `source`'s fresh gradient."""
    return FaultEvent("duplicate_submission", worker, step,
                      duration=duration, source=source)


def device_loss(worker, step):
    """Worker is permanently lost from `step` on."""
    return FaultEvent("device_loss", worker, step)


def straggle(host, step, window_s):
    """SYSTEM scope: host SIGSTOP'd at `step`, SIGCONT'd `window_s`
    seconds later."""
    return FaultEvent("straggle", host, step, window_s=float(window_s))


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How the engine degrades when faults (or fault-like inputs) appear.

    `nan_quarantine` and `dynamic_quorum` become
    `EngineConfig.fault_quarantine` / `.fault_dynamic_quorum`. The
    `fetch_*` fields parameterize the JAX package's data-download
    retry/backoff path; the port keeps them for validation and the JSON
    round trip only: it downloads nothing, sets no `BMT_FETCH_*`
    variable, and no code of the port reads one.
    """

    nan_quarantine: bool = True   # mask non-finite submission rows out of
    #                               the aggregation (and out of the quorum)
    dynamic_quorum: bool = True   # recompute the effective (n, f) the GAR
    #                               runs with when workers are absent
    fetch_attempts: int = 3       # data-download attempts before degrading
    fetch_backoff: float = 1.0    # base backoff seconds (doubles per retry)
    fetch_timeout: float = 60.0   # per-connection stall timeout seconds

    def __post_init__(self):
        if self.fetch_attempts < 1:
            raise ValueError(
                f"Non-positive fetch attempts {self.fetch_attempts}")
        if self.fetch_backoff < 0 or self.fetch_timeout <= 0:
            raise ValueError(
                f"Invalid fetch backoff/timeout "
                f"({self.fetch_backoff}, {self.fetch_timeout})")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A complete fault scenario: events + degradation policy + seed."""

    events: tuple = ()
    policy: FaultPolicy = dataclasses.field(default_factory=FaultPolicy)
    seed: int = 0

    def __post_init__(self):
        # Normalize: accept lists/dicts from JSON land, store tuples of
        # FaultEvent (hashable, so a plan can key caches)
        events = tuple(
            e if isinstance(e, FaultEvent) else FaultEvent(**e)
            for e in self.events)
        object.__setattr__(self, "events", events)
        if not isinstance(self.policy, FaultPolicy):
            object.__setattr__(self, "policy", FaultPolicy(**self.policy))

    @property
    def horizon(self):
        """First step with no scheduled (non-permanent) fault activity."""
        return max((e.end for e in self.events), default=0)

    def validate(self, nb_workers, nb_honests):
        """None if the plan fits an (n = nb_workers, h = nb_honests) run,
        else a human-readable refusal (CLI contract, like `GAR.check`)."""
        for e in self.events:
            if e.kind not in KINDS:
                return (f"fault {e.kind!r} only exists at SYSTEM scope "
                        f"(a jitted step cannot SIGSTOP a host); in-step "
                        f"plans may only use {'/'.join(KINDS)}")
            if e.worker >= nb_workers:
                return (f"fault {e.kind!r} targets worker {e.worker} but the "
                        f"run has only {nb_workers} workers")
            mutating = e.kind in ("straggler", "corrupt_gradient",
                                  "duplicate_submission")
            if mutating and e.worker >= nb_honests:
                return (f"fault {e.kind!r} mutates worker {e.worker}'s "
                        f"submission, but rows >= {nb_honests} are "
                        f"attack-synthesized (only drop_worker/device_loss "
                        f"may target them)")
            if e.kind == "duplicate_submission":
                if e.source >= nb_honests:
                    return (f"duplicate_submission copies worker {e.source}, "
                            f"but only rows < {nb_honests} hold honest "
                            f"submissions")
                if e.source == e.worker:
                    return (f"duplicate_submission on worker {e.worker} "
                            f"copies itself (a no-op; refusing a plan that "
                            f"cannot mean what it says)")
        return None

    def validate_system(self, nb_hosts):
        """None if the plan can drive HOST-scope chaos on an
        `nb_hosts`-process fleet (`cluster/chaos.py::SystemFaultDriver`),
        else a human-readable refusal. At system scope `worker` indexes a
        host and only `SYSTEM_KINDS` are meaningful (a SIGKILL has no
        'corrupted submission' analogue)."""
        for e in self.events:
            if e.kind not in SYSTEM_KINDS:
                return (f"fault {e.kind!r} has no system-scope meaning; a "
                        f"host-level plan may only use "
                        f"{'/'.join(SYSTEM_KINDS)}")
            if e.worker >= nb_hosts:
                return (f"system fault targets host {e.worker} but the "
                        f"fleet has only {nb_hosts} hosts")
            if e.worker == 0 and nb_hosts > 1:
                # Host 0 runs the distributed coordinator: killing it
                # wedges the survivors' collectives rather than failing
                # them, so the plan must name a non-coordinator host (or
                # a 1-host fleet)
                return ("system fault targets host 0 (the distributed "
                        "coordinator); target a non-coordinator host so "
                        "the survivors' failure mode is peer loss, not "
                        "coordinator loss")
        return None

    # ------------------------------------------------------------------ #
    # JSON round-trip

    def to_dict(self):
        return {
            "events": [dataclasses.asdict(e) for e in self.events],
            "policy": dataclasses.asdict(self.policy),
            "seed": self.seed,
        }

    @classmethod
    def from_dict(cls, data):
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"Unknown fault-plan fields {sorted(unknown)}; expected a "
                f"subset of {sorted(known)}")
        return cls(**data)

    def to_json(self, **kwargs):
        kwargs.setdefault("indent", "\t")
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, text):
        return cls.from_dict(json.loads(text))

    def save(self, path):
        path = pathlib.Path(path)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path):
        return cls.from_json(pathlib.Path(path).read_text())

    # ------------------------------------------------------------------ #
    # Seeded generation (reproducible chaos)

    @classmethod
    def generate(cls, *, nb_workers, nb_steps, rates, seed=0,
                 policy=None, nb_honests=None, max_scale=100.0):
        """Expand per-kind fault `rates` into a concrete, deterministic plan.

        `rates`: dict kind -> per-worker-per-step probability. Every draw
        comes from `numpy.random.RandomState(seed)` in a fixed iteration
        order (kind-major, then step, then worker), so `(rates, seed)`
        fully determines the plan — rerunning yields byte-identical JSON.
        Submission-mutating kinds only target rows < `nb_honests`
        (default: all of `nb_workers`).
        """
        import numpy as np

        h = nb_workers if nb_honests is None else nb_honests
        rng = np.random.RandomState(seed)
        events = []
        for kind in KINDS:
            rate = rates.get(kind, 0.0)
            if not rate:
                continue
            rows = nb_workers if kind in ("drop_worker", "device_loss") else h
            hits = rng.random_sample((nb_steps, rows)) < rate
            for step, worker in zip(*np.nonzero(hits)):
                step, worker = int(step), int(worker)
                if kind == "straggler":
                    events.append(straggler(
                        worker, step, delay_steps=int(rng.randint(1, 4))))
                elif kind == "drop_worker":
                    events.append(drop_worker(worker, step))
                elif kind == "corrupt_gradient":
                    mode = MODES[int(rng.randint(len(MODES)))]
                    events.append(corrupt_gradient(
                        worker, step, mode=mode,
                        scale=float(rng.uniform(0.0, max_scale))))
                elif kind == "duplicate_submission":
                    if h < 2:
                        continue
                    source = int(rng.randint(h - 1))
                    events.append(duplicate_submission(
                        worker, step, source=source + (source >= worker)))
                else:  # device_loss: first hit wins, later ones are moot
                    events.append(device_loss(worker, step))
        return cls(events=tuple(events), policy=policy or FaultPolicy(),
                   seed=seed)
