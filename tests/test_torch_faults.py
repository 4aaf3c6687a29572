"""The port's fault layer (`faults/plan.py`, `schedule.py`, `inject.py`,
`sanitize.py`) and the engine's fault steps against the JAX package's,
on the CPU.

* Plans: the JAX tests' `sample_plan()` and `DEMO_PLAN` built with the
  port's constructors give the JAX JSON byte for byte and round-trip;
  the validation messages (`FaultEvent`, `from_dict`, `validate`,
  `validate_system`) are the JAX ones word for word; `generate` gives
  byte-identical JSON to JAX's for four `(rates, seed)` pairs
  (`reproduce.py::submit_faults`'s three and one with every kind at
  h < n).
* Schedules: the host arrays equal the JAX `FaultSchedule`'s, each
  step's rows (`step_rows`, and `upload(...).at(i)`) equal JAX's
  `step_faults` (the neutral row past the horizon, device loss
  persisting past it), the injected count equals the JAX `inject`'s.
* Injection: `inject` equals JAX's bit for bit (the rows, the straggler
  buffer, the active mask and the count) on f32[6, 33] with every kind,
  over a straggler window of 10 steps, longer than a chunk of 8.
* The engine: six steps on `simples-full` (n = 9, 2 real Byzantine
  workers against `empire(1.1)`, clip 5) with a plan of every kind,
  through both engines from one key and the same batches: Krum, Median,
  a per-step `--gars` mixture, Krum under `--gar-diagnostics` (its
  `Active mask`) and the `--device-gar cpu` hop: `Faults injected`,
  `Workers active` and `Quorum f` exactly, the 24 study columns within
  rtol 1e-5, atol 1e-6, the cosines rtol 1e-4 (the JAX step is one `jit`
  program, three under `--device-gar`, which XLA rounds in its own
  order; a cosine at -1 + 1e-5 keeps only that many digits), theta and
  the straggler buffer within rtol
  1e-4, atol 1e-5 (the bounds `tests/test_torch_forensics.py` holds the
  diagnostics step to). A per-call mixture draws from the operand's
  bits, so it is held on the defense phase from the same honest rows and
  fault context. An empty plan gives the fault-free engine (no schedule,
  a `(0, d)` buffer, the same trajectory bit for bit); a plan without a
  straggler carries no buffer either.
* The JAX slow acceptance demo's claims, at its size (n = 11, DEMO_PLAN,
  4 steps) through the port's driver: Krum and Median keep a finite
  loss, 8 workers active and f_eff 2 and 3; Average without quarantine
  diverges to NaN with 9 workers active.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import attacks as jax_attacks
from byzantinemomentum_tpu import faults as jax_faults
from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu.engine import program as jax_program
from byzantinemomentum_tpu.engine.step import _FaultCtx
from byzantinemomentum_tpu.faults import inject as jax_inject
from byzantinemomentum_tpu_torch import faults, models, optim, prng
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import (
    FAULT_COLUMNS, STUDY_COLUMNS, Engine, EngineConfig, program)
from byzantinemomentum_tpu_torch.faults import inject, schedule
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.ops import gars

from tests.test_faults import DEMO_PLAN, sample_plan
from tests.torch_threads import one_torch_thread  # noqa: F401


def port_plan(jax_plan):
    """The port's plan of a JAX plan, built with the port's constructors."""
    make = {"straggler": lambda e: faults.straggler(
                e.worker, e.step, delay_steps=e.duration),
            "drop_worker": lambda e: faults.drop_worker(
                e.worker, e.step, duration=e.duration),
            "corrupt_gradient": lambda e: faults.corrupt_gradient(
                e.worker, e.step, mode=e.mode, scale=e.scale,
                duration=e.duration),
            "duplicate_submission": lambda e: faults.duplicate_submission(
                e.worker, e.step, source=e.source, duration=e.duration),
            "device_loss": lambda e: faults.device_loss(e.worker, e.step)}
    return faults.FaultPlan(
        events=tuple(make[e.kind](e) for e in jax_plan.events),
        policy=faults.FaultPolicy(**dataclasses.asdict(jax_plan.policy)),
        seed=jax_plan.seed)


# --------------------------------------------------------------------------- #
# Plans

@pytest.mark.parametrize("name", ("sample_plan", "DEMO_PLAN"))
def test_plan_json_is_the_jax_json(tmp_path, name):
    jplan = sample_plan() if name == "sample_plan" else DEMO_PLAN
    plan = port_plan(jplan)
    assert plan.to_json() == jplan.to_json()
    assert faults.FaultPlan.from_json(jplan.to_json()) == plan
    path = plan.save(tmp_path / "plan.json")
    assert path.read_bytes() == jplan.save(tmp_path / "jax.json").read_bytes()
    assert faults.FaultPlan.load(path) == plan
    assert plan.horizon == jplan.horizon
    raw = json.loads(path.read_text())
    assert raw["policy"] == dataclasses.asdict(jplan.policy)


def _error(make):
    try:
        make()
    except ValueError as err:
        return str(err)
    raise AssertionError("no ValueError")


# Constructions each package refuses, as (module) -> callable
BAD_EVENTS = (
    lambda m: m.FaultEvent("meteor_strike", 0, 0),
    lambda m: m.drop_worker(0, step=0, duration=0),
    lambda m: m.drop_worker(-1, step=0),
    lambda m: m.drop_worker(0, step=-2),
    lambda m: m.corrupt_gradient(0, step=0, mode="flip"),
    lambda m: m.duplicate_submission(0, step=0, source=-1),
    lambda m: m.FaultEvent("straggle", 1, 0),
    lambda m: m.FaultPlan.from_dict({"event": []}),
    lambda m: m.FaultPolicy(fetch_attempts=0),
    lambda m: m.FaultPolicy(fetch_timeout=0.0),
)


@pytest.mark.parametrize("index", range(len(BAD_EVENTS)))
def test_construction_messages_are_jax_messages(index):
    make = BAD_EVENTS[index]
    assert _error(lambda: make(faults)) == _error(lambda: make(jax_faults))


# (events, nb_workers, nb_honests) that `validate` refuses or accepts
VALIDATE = (
    ((("drop_worker", 10, 0),), 11, 11),
    ((("drop_worker", 10, 0),), 8, 8),
    ((("corrupt_gradient", 9, 0),), 11, 8),
    ((("straggler", 8, 0),), 11, 8),
    ((("duplicate_submission", 1, 0, {"source": 1}),), 4, 4),
    ((("duplicate_submission", 1, 0, {"source": 5}),), 8, 5),
    ((("device_loss", 10, 3),), 11, 4),
    ((("straggle", 1, 0, {"window_s": 2.0}),), 4, 4),
)


@pytest.mark.parametrize("index", range(len(VALIDATE)))
def test_validation_messages_are_jax_messages(index):
    events, n, h = VALIDATE[index]

    def plan(module):
        return module.FaultPlan(events=tuple(
            module.FaultEvent(kind, worker, step, **(extra[0] if extra else {}))
            for kind, worker, step, *extra in events))

    assert plan(faults).validate(n, h) == plan(jax_faults).validate(n, h)
    for hosts in (1, 2, 4):
        assert (plan(faults).validate_system(hosts)
                == plan(jax_faults).validate_system(hosts))


# reproduce.py::submit_faults's three rates and seeds, and every kind
GENERATE = tuple(
    (dict(nb_workers=9, nb_steps=30,
          rates={"straggler": rate, "drop_worker": rate,
                 "corrupt_gradient": rate / 2}), int(rate * 10000))
    for rate in (0.005, 0.01, 0.02)) + (
    (dict(nb_workers=11, nb_honests=8, nb_steps=40,
          rates={kind: 0.03 for kind in jax_faults.plan.KINDS}), 7),)


@pytest.mark.parametrize("index", range(len(GENERATE)))
def test_generate_is_the_jax_json(index):
    kwargs, seed = GENERATE[index]
    plan = faults.FaultPlan.generate(seed=seed, **kwargs)
    jplan = jax_faults.FaultPlan.generate(seed=seed, **kwargs)
    assert plan.to_json() == jplan.to_json()
    assert len(plan.events) > 0
    assert plan.validate(kwargs["nb_workers"],
                         kwargs.get("nb_honests", kwargs["nb_workers"])) is None


# --------------------------------------------------------------------------- #
# Schedules

SCHEDULE_FIELDS = ("stale", "nan", "zero", "scale", "dup", "drop")


@pytest.mark.parametrize("name", ("sample_plan", "DEMO_PLAN", "generated"))
def test_schedule_rows_equal_jax(name):
    if name == "generated":
        kwargs, seed = GENERATE[-1]
        jplan = jax_faults.FaultPlan.generate(seed=seed, **kwargs)
        n, h = 11, 8
    else:
        jplan = sample_plan() if name == "sample_plan" else DEMO_PLAN
        n, h = (8, 8) if name == "sample_plan" else (11, 11)
    jsched = jax_faults.build_schedule(jplan, nb_workers=n, nb_honests=h)
    sched = faults.build_schedule(port_plan(jplan), nb_workers=n,
                                  nb_honests=h)
    for field in (*SCHEDULE_FIELDS, "lost_from"):
        np.testing.assert_array_equal(getattr(sched, field),
                                      getattr(jsched, field))
    assert sched.has_stale == jsched.has_stale
    assert sched.horizon == jsched.horizon
    steps = [*range(sched.horizon + 3), 1000]
    uploaded = sched.upload(0, len(steps) - 1, "cpu")
    for i, step in enumerate(steps):
        rows = sched.step_rows(step)
        jrows = jsched.step_faults(jnp.int32(step))
        for field, got in zip(SCHEDULE_FIELDS, rows):
            np.testing.assert_array_equal(got, np.asarray(getattr(jrows, field)))
        _, _, _, injected = jax_inject.inject(
            jsched, jnp.int32(step), jnp.zeros((h, 3)),
            jnp.zeros((h if jsched.has_stale else 0, 3)))
        assert rows[-1] == int(injected)
        if step != 1000:
            got = uploaded.at(i)
            for field, want in zip(SCHEDULE_FIELDS, rows):
                np.testing.assert_array_equal(getattr(got, field).numpy(),
                                              want)
            assert int(got.injected) == rows[-1]
    # Past the horizon only the permanent losses remain
    stale, nan, zero, scale, dup, drop, _ = sched.step_rows(1000)
    assert not (stale.any() or nan.any() or zero.any() or (dup >= 0).any())
    assert (scale == 1.0).all()
    np.testing.assert_array_equal(drop, sched.lost_from <= 1000)


def test_empty_plan_compiles_to_none():
    assert faults.build_schedule(faults.FaultPlan(), nb_workers=4,
                                 nb_honests=4) is None
    assert faults.build_schedule(None, nb_workers=4, nb_honests=4) is None
    with pytest.raises(ValueError, match="Invalid fault plan: fault "
                       "'drop_worker' targets worker 9"):
        schedule.FaultSchedule(faults.FaultPlan(
            events=(faults.drop_worker(9, 0),)), 4, 4)


# --------------------------------------------------------------------------- #
# Injection

INJECT_PLAN = (
    ("straggler", 0, 1, {"delay_steps": 10}),
    ("straggler", 3, 4, {"delay_steps": 2}),
    ("duplicate_submission", 1, 2, {"source": 4, "duration": 3}),
    ("duplicate_submission", 0, 3, {"source": 5}),
    ("corrupt_gradient", 2, 1, {"mode": "scale", "scale": 0.25,
                                "duration": 4}),
    ("corrupt_gradient", 2, 3, {"mode": "scale", "scale": -3.0}),
    ("corrupt_gradient", 4, 5, {"mode": "zero", "duration": 2}),
    ("corrupt_gradient", 5, 6, {"mode": "nan", "duration": 3}),
    ("corrupt_gradient", 0, 7, {"mode": "nan"}),
    ("drop_worker", 7, 2, {"duration": 5}),
    ("drop_worker", 1, 9, {}),
    ("device_loss", 8, 6, {}),
)


def _build(module, spec):
    return module.FaultPlan(events=tuple(
        getattr(module, kind)(worker, step, **kwargs)
        for kind, worker, step, kwargs in spec))


def _bits(x):
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def test_inject_is_jax_bit_for_bit():
    n, h, d, steps = 9, 6, 33, 14
    jsched = jax_faults.build_schedule(_build(jax_faults, INJECT_PLAN),
                                       nb_workers=n, nb_honests=h)
    sched = faults.build_schedule(_build(faults, INJECT_PLAN), nb_workers=n,
                                  nb_honests=h)
    assert sched.has_stale
    rng = np.random.default_rng(0)
    buffer = np.zeros((h, d), np.float32)
    jbuffer = jnp.asarray(buffer)
    tbuffer = torch.from_numpy(buffer)
    # Two chunks of 8 steps' rows, as the engine uploads them
    chunks = [sched.upload(0, 8, "cpu"), sched.upload(8, steps - 8, "cpu")]
    for step in range(steps):
        G = rng.standard_normal((h, d)).astype(np.float32)
        G[1, 3] = -0.0
        jG, jbuffer, jactive, jinjected = jax_inject.inject(
            jsched, jnp.int32(step), jnp.asarray(G), jbuffer)
        rows = chunks[step // 8].at(step % 8)
        tG, tbuffer, ctx = inject.inject(rows, sched.has_stale,
                                         torch.from_numpy(G), tbuffer)
        np.testing.assert_array_equal(_bits(tG), _bits(jG))
        np.testing.assert_array_equal(_bits(tbuffer), _bits(jbuffer))
        np.testing.assert_array_equal(ctx.active.numpy(), np.asarray(jactive))
        assert ctx.injected.dtype == torch.int32
        assert int(ctx.injected) == int(jinjected)
    # The straggler window outlasted a chunk: worker 0 replayed its step-0
    # row through step 10


# --------------------------------------------------------------------------- #
# The engine

N, F, F_REAL, S, B, STEPS = 9, 2, 2, 9, 4, 6
ENGINE_PLAN = (
    ("straggler", 0, 1, {"delay_steps": 3}),
    ("corrupt_gradient", 2, 2, {"mode": "nan", "duration": 2}),
    ("corrupt_gradient", 3, 1, {"mode": "scale", "scale": 0.5}),
    ("corrupt_gradient", 4, 3, {"mode": "zero"}),
    ("duplicate_submission", 5, 2, {"source": 6}),
    ("drop_worker", 8, 2, {"duration": 2}),
    ("device_loss", 1, 4, {}),
)
ENGINE_CASES = {
    "krum": ([("krum", 1.0)], False, None),
    "median": ([("median", 1.0)], False, None),
    "mixture": ([("krum", 1.0), ("median", 1.0)], False, None),
    "krum-diag": ([("krum", 1.0)], True, None),
    "device-gar": ([("krum", 1.0)], False, "cpu"),
}


def _engines(members, diagnostics=False, plan=ENGINE_PLAN, per_call=False,
             attack="empire", **extra):
    """The JAX engine and the port's over `members` on `simples-full` with
    `plan` (a spec of `_build`, or None), both from `PRNGKey(7)`."""
    common = dict(nb_workers=N, nb_decl_byz=F, nb_real_byz=F_REAL,
                  nb_for_study=S, nb_for_study_past=2, momentum=0.9,
                  gradient_clip=5.0, gar_diagnostics=diagnostics,
                  gars_per_call=per_call, **extra)
    cum, jdefenses, defenses = 0.0, [], []
    for name, freq in members:
        cum += freq
        jdefenses.append((jax_ops.gars[name], cum, {}))
        defenses.append((gars[name], cum, {}))
    h = N - F_REAL
    jsched = sched = None
    if plan is not None:
        jsched = jax_faults.build_schedule(_build(jax_faults, plan),
                                           nb_workers=N, nb_honests=h)
        sched = faults.build_schedule(_build(faults, plan), nb_workers=N,
                                      nb_honests=h)
    kwargs = {"factor": 1.1} if attack == "empire" else {}
    jengine = build_engine(
        cfg=JaxConfig(**common), model_def=jax_models.build("simples-full"),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=jdefenses, attack=jax_attacks.attacks[attack],
        attack_kwargs=kwargs, faults=jsched)
    model = models.build("simples-full", device="cpu")
    model.init(prng.PRNGKey(7))
    engine = Engine(EngineConfig(**common), model, Loss("nll"),
                    Criterion("top-k"), defenses, attacks[attack], kwargs,
                    optim.build("sgd"), faults=sched)
    return (jengine, jengine.init(jax.random.PRNGKey(7)), engine,
            engine.init(prng.PRNGKey(7)))


def _batches(seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((S, B, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, (S, B)).astype(np.int32)
    return xs, ys


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_fault_steps_match_jax(case):
    members, diagnostics, gar_device = ENGINE_CASES[case]
    jengine, jstate, engine, state = _engines(members, diagnostics)
    assert state.fault_buffer.shape == jstate.fault_buffer.shape == (
        N - F_REAL, engine.d)
    if gar_device is None:
        jstep, step = jengine.train_step, engine.train_step
    else:
        jstep = jax_program.build_step(jengine, gar_device=gar_device)
        step = program.build_step(engine, gar_device=gar_device)
    columns = []
    for seed in range(STEPS):
        xs, ys = _batches(seed)
        jstate, jmetrics = jstep(jstate, jnp.asarray(xs), jnp.asarray(ys),
                                 jnp.float32(0.1))
        state, metrics = step(state, torch.from_numpy(xs),
                              torch.from_numpy(ys), 0.1)
        want_keys = set(STUDY_COLUMNS[2:]) | set(FAULT_COLUMNS)
        assert set(metrics) - want_keys == (
            {"Sel mask", "Worker dist", "Dist honest med", "Var/norm ratio",
             "Clip frac", "Active mask"} if diagnostics else set())
        for column in FAULT_COLUMNS:
            assert metrics[column].dtype == torch.int32
            assert int(metrics[column]) == int(jmetrics[column]), column
        columns.append([int(metrics[column]) for column in FAULT_COLUMNS])
        for column in STUDY_COLUMNS[2:]:
            _close(metrics[column], jmetrics[column],
                   rtol=1e-4 if "cosine" in column else 1e-5)
        if diagnostics:
            np.testing.assert_array_equal(metrics["Active mask"].numpy(),
                                          np.asarray(jmetrics["Active mask"]))
            np.testing.assert_array_equal(metrics["Sel mask"].numpy() > 0,
                                          np.asarray(jmetrics["Sel mask"]) > 0)
        _close(state.theta, jstate.theta, rtol=1e-4, atol=1e-5)
        _close(state.fault_buffer, jstate.fault_buffer, rtol=1e-4, atol=1e-5)
    # At steps 2-3 worker 2's NaN row and the empire row 7 it poisons are
    # quarantined and the attack row 8 is dropped; from step 4 worker 1
    # is lost
    assert [row[1] for row in columns] == [9, 9, 6, 6, 8, 8]
    if gar_device is not None:
        assert engine.counts["device_gar_steps"] == STEPS


def test_per_call_masked_defense_matches_jax():
    """A per-call mixture (average, median, krum against `nan`): every
    member's masked form runs and the drawn one is picked; held on the
    defense phase from the same honest rows and fault context."""
    jengine, _, engine, _ = _engines(
        [("average", 1.0), ("median", 1.0), ("krum", 1.0)], per_call=True,
        attack="nan")
    rng = np.random.default_rng(6)
    drawn = set()
    for seed in range(12):
        G = rng.standard_normal((N - F_REAL, engine.d)).astype(np.float32)
        active = np.ones(N, bool)
        active[[seed % N, (3 * seed + 1) % N]] = False
        key = 100 * seed + 3
        jout = jengine._phase_defense(
            jnp.asarray(G), jax.random.PRNGKey(key),
            _FaultCtx(active=jnp.asarray(active), injected=jnp.int32(2)))
        out = engine.phase_defense(
            torch.from_numpy(G), (), mix_key=prng.PRNGKey(key),
            fault=inject.FaultContext(active=torch.from_numpy(active),
                                      injected=torch.tensor(2,
                                                            dtype=torch.int32)))
        G_all = torch.cat([torch.from_numpy(G), out[0]])
        drawn.add(int(engine.per_call_member(prng.PRNGKey(key), G_all)))
        _close(out[1], jout[1])
        fault_metrics, jfault = out[4], jout[3]
        for column in FAULT_COLUMNS:
            assert int(fault_metrics[column]) == int(jfault[column])
    assert drawn == {0, 1, 2}


def test_empty_plan_is_the_fault_free_engine():
    """An empty plan compiles to no schedule: the engine is the plain one,
    with a (0, d) buffer, and walks the fault-free trajectory bit for
    bit; a plan without a straggler carries no buffer either."""
    thetas = []
    for plan in (None, ()):
        _, _, engine, state = _engines([("krum", 1.0)], plan=plan or None)
        assert engine.faults is None and engine.defense_masked is None
        assert state.fault_buffer.shape == (0, engine.d)
        for seed in range(3):
            xs, ys = _batches(seed)
            state, metrics = engine.train_step(
                state, torch.from_numpy(xs), torch.from_numpy(ys), 0.1)
            assert not set(FAULT_COLUMNS) & set(metrics)
        thetas.append(state.theta)
    assert torch.equal(thetas[0], thetas[1])
    assert faults.build_schedule(faults.FaultPlan(), nb_workers=N,
                                 nb_honests=N - F_REAL) is None
    _, _, engine, state = _engines([("krum", 1.0)],
                                   plan=(("drop_worker", 3, 50, {}),))
    assert engine.faults is not None and not engine.faults.has_stale
    assert state.fault_buffer.shape == (0, engine.d)


def test_fault_free_step_of_a_plan_takes_the_masked_program(monkeypatch):
    """Every step of a run with a non-empty plan takes the masked defense,
    also before the plan's first fault, and returns the fault columns."""
    from byzantinemomentum_tpu_torch.faults import quorum

    calls = []
    real = quorum.masked_aggregate

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(quorum, "masked_aggregate", counted)
    _, _, engine, state = _engines([("median", 1.0)],
                                   plan=(("drop_worker", 3, 50, {}),))
    xs, ys = _batches(0)
    _, metrics = engine.train_step(state, torch.from_numpy(xs),
                                   torch.from_numpy(ys), 0.1)
    assert calls and [int(metrics[c]) for c in FAULT_COLUMNS] == [0, N, F]


# The JAX slow acceptance demo's command line (tests/test_faults.py)
DEMO_LINE = ["--device", "cpu", "--nb-steps", "4", "--batch-size", "8",
             "--batch-size-test", "32", "--batch-size-test-reps", "1",
             "--evaluation-delta", "0", "--model", "simples-full", "--seed",
             "11", "--nb-workers", "11", "--nb-decl-byz", "4",
             "--nb-for-study", "11", "--nb-for-study-past", "2"]


def _demo_rows(resdir):
    lines = (resdir / "study").read_text().split(os.linesep)
    assert lines[0] == "# " + "\t".join(STUDY_COLUMNS + FAULT_COLUMNS)
    return [{"loss": float(f[2]), "active": int(f[-2]), "quorum_f": int(f[-1])}
            for f in (line.split("\t") for line in lines[1:] if line)]


def test_acceptance_demo_claims(tmp_path, monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "512")
    monkeypatch.setenv("BMT_SYNTH_TEST", "128")
    plan_path = port_plan(DEMO_PLAN).save(tmp_path / "plan.json")
    bare = dataclasses.replace(port_plan(DEMO_PLAN),
                               policy=faults.FaultPolicy(nan_quarantine=False))
    bare_path = bare.save(tmp_path / "plan_bare.json")
    for gar, path, f_eff in (("krum", plan_path, 2), ("median", plan_path, 3)):
        resdir = tmp_path / f"run_{gar}"
        driver.run([*DEMO_LINE, "--gar", gar, "--fault-plan", str(path),
                    "--result-directory", str(resdir)])
        rows = _demo_rows(resdir)
        assert all(np.isfinite(r["loss"]) for r in rows), gar
        assert rows[-1]["active"] == 8 and rows[-1]["quorum_f"] == f_eff
    resdir = tmp_path / "run_average"
    driver.run([*DEMO_LINE, "--gar", "average", "--fault-plan",
                str(bare_path), "--result-directory", str(resdir)])
    rows = _demo_rows(resdir)
    assert np.isfinite(rows[1]["loss"])
    assert np.isnan(rows[-1]["loss"])
    assert rows[-1]["active"] == 9
