"""The port's health vector and SPC monitor against the JAX package's.

* `norm_histogram` on crafted norms (0, the smallest subnormal, the bin
  edges 2**(HIST_LO + 2k) with the floats one ulp either side, +-inf,
  NaN, numbers beyond either end): the same bins, bin for bin.
* `health_metrics` on seeded f32 stacks with NaN and inf rows, with
  one honest row (`Var ratio` NaN), with no attack row and in bf16: the
  non-finite counts and the histogram exactly, the scalars within rtol
  1e-5, atol 1e-6 (JAX's op-by-op function, XLA's CPU reductions). The
  study's reused sums (`sums`) give the same bits as a recomputation.
* The engine step with `health=True` (simples-full, n = 9, Krum against
  `empire(1.1)` and against `nan`, a Bulyan step, the `--device-gar cpu`
  hop) against the JAX engine's jitted step from the same key and
  batches: the histogram and counts exactly, the scalars at the same
  tolerance; the other 24 columns and the new state are the flag-off
  step's, bit for bit; a chunk stacks the vector to `[M]` and `Norm
  hist` to `[M, 16]`; with the flag off the step calls nothing of
  `engine/health.py`.
* `HealthMonitor` of both packages fed the same numpy-seeded streams
  (warm-up, a spike, both run rules, hysteresis, a frozen baseline,
  non-finite counts and channel values, `rollback_pending`,
  `note_rollback`, NaN and inf in the ring): the return values,
  `summary()`, `blackbox()` and the events each emits through its
  package's active recorder are equal (both are the same stdlib float64
  arithmetic); a blackbox dumped by either package loads in the other;
  the validation errors carry the JAX messages.
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import attacks as jax_attacks
from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu import obs as jax_obs
from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import HEALTH_COLUMNS as JAX_HEALTH_COLUMNS
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu.engine import health as jax_health
from byzantinemomentum_tpu.engine import program as jax_program
from byzantinemomentum_tpu.obs.health import HealthMonitor as JaxMonitor
from byzantinemomentum_tpu.obs.health import load_blackbox as jax_load
from byzantinemomentum_tpu_torch import models, obs, optim, prng
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.engine import (
    HEALTH_COLUMNS, STUDY_COLUMNS, Engine, EngineConfig, program)
from byzantinemomentum_tpu_torch.engine import health, metrics
from byzantinemomentum_tpu_torch.engine import step as step_mod
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.obs.health import HealthMonitor
from byzantinemomentum_tpu_torch.ops import gars

from tests.torch_threads import one_torch_thread  # noqa: F401

FLOATS = ("Var ratio", "Weight norm", "Update norm", "Update/weight")
COUNTS = ("Nonfinite submitted", "Nonfinite aggregate", "Nonfinite state")


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------- #
# The histogram and the health vector

def _edge_norms():
    """0, the smallest subnormal, every bin edge and the floats one ulp
    either side of it, numbers beyond either end, +-inf and NaN."""
    edges = [2.0 ** (health.HIST_LO + health.HIST_WIDTH * k)
             for k in range(-2, health.HIST_BINS + 2)]
    values = [0.0, np.float32(1e-45), np.inf, -np.inf, np.nan, 3e38, 1e-30]
    for edge in np.asarray(edges, np.float32):
        values += [np.nextafter(edge, np.float32(0)), edge,
                   np.nextafter(edge, np.float32(np.inf))]
    return np.asarray(values, np.float32)


def test_constants_match_jax():
    assert (health.HIST_BINS, health.HIST_LO, health.HIST_WIDTH) == (
        jax_health.HIST_BINS, jax_health.HIST_LO, jax_health.HIST_WIDTH)
    assert HEALTH_COLUMNS == JAX_HEALTH_COLUMNS


@pytest.mark.parametrize("case", ("edges", "seeded"))
def test_norm_histogram_matches_jax_bin_for_bin(case):
    if case == "edges":
        norms = _edge_norms()
    else:
        rng = np.random.default_rng(3)
        norms = (10.0 ** rng.uniform(-5, 12, 4000)).astype(np.float32)
    got = health.norm_histogram(torch.from_numpy(norms))
    want = np.asarray(jax_health.norm_histogram(jnp.asarray(norms)))
    assert got.dtype == torch.float32 and got.shape == (health.HIST_BINS,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == len(norms)
    # Each norm alone lands where JAX puts it
    if case == "edges":
        for norm in norms:
            one = np.asarray([norm], np.float32)
            np.testing.assert_array_equal(
                health.norm_histogram(torch.from_numpy(one)).numpy(),
                np.asarray(jax_health.norm_histogram(jnp.asarray(one))),
                err_msg=repr(norm))


def _stack(h, f, d, seed, nan_rows=(), inf_rows=()):
    rng = np.random.default_rng(seed)
    G = (rng.standard_normal((h + f, d))
         * 10.0 ** rng.uniform(-3, 3, (h + f, 1))).astype(np.float32)
    G[list(nan_rows), 3] = np.nan
    G[list(inf_rows), 5] = np.inf
    gd = rng.standard_normal(d).astype(np.float32)
    t0 = rng.standard_normal(d).astype(np.float32)
    t1 = (t0 - 0.05 * gd).astype(np.float32)
    return G[:h], G[h:], gd, t0, t1


VECTOR_CASES = {
    "clean": dict(h=7, f=2, d=300),
    "nan-attack": dict(h=7, f=2, d=300, nan_rows=(7, 8)),
    "nan-honest-inf": dict(h=7, f=2, d=300, nan_rows=(1,), inf_rows=(8,)),
    "one-honest": dict(h=1, f=3, d=64),
    "no-attack": dict(h=5, f=0, d=64),
    "overflow": dict(h=4, f=1, d=64),
}


@pytest.mark.parametrize("case", sorted(VECTOR_CASES))
def test_health_metrics_match_jax(case):
    kwargs = dict(VECTOR_CASES[case])
    Gh, Ga, gd, t0, t1 = _stack(seed=len(case), **kwargs)
    if case == "overflow":
        # A finite row whose sum of squares overflows f32, a NaN
        # aggregate and a state that overflows
        Gh[2] = 3e19
        gd[0] = np.nan
        t1[4] = 2e19
    got = health.health_metrics(*map(torch.from_numpy, (Gh, Ga, gd, t0, t1)))
    want = jax_health.health_metrics(*map(jnp.asarray, (Gh, Ga, gd, t0, t1)))
    assert list(got) == list(want) == list(HEALTH_COLUMNS)
    for key in COUNTS:
        assert got[key].dtype == torch.float32 and got[key].shape == ()
        assert float(got[key]) == float(want[key]), key
    np.testing.assert_array_equal(got["Norm hist"].numpy(),
                                  np.asarray(want["Norm hist"]))
    for key in FLOATS:
        _close(_np(got[key]), want[key])
    if case == "one-honest":
        assert math.isnan(float(got["Var ratio"]))
    if case == "overflow":
        assert [float(got[key]) for key in COUNTS] == [1.0, 1.0, 1.0]


def test_health_metrics_bf16_take_f32_and_match_jax():
    Gh, Ga, gd, t0, t1 = _stack(6, 2, 128, seed=9, nan_rows=(7,))
    tensors = [torch.from_numpy(x).to(torch.bfloat16)
               for x in (Gh, Ga, gd, t0, t1)]
    got = health.health_metrics(*tensors)
    want = jax_health.health_metrics(
        *(jnp.asarray(x, jnp.bfloat16) for x in (Gh, Ga, gd, t0, t1)))
    for key in COUNTS:
        assert float(got[key]) == float(want[key]), key
    np.testing.assert_array_equal(got["Norm hist"].numpy(),
                                  np.asarray(want["Norm hist"]))
    for key in FLOATS:
        assert got[key].dtype == torch.float32
        _close(_np(got[key]), want[key])


def test_study_sums_reused_give_the_recomputed_bits():
    Gh, Ga, gd, t0, t1 = map(torch.from_numpy,
                             _stack(7, 2, 300, seed=4, nan_rows=(8,)))
    sums = {}
    metrics.study_metrics(
        loss_avg=torch.tensor(1.0), l2_origin=torch.tensor(0.0),
        G_sampled=Gh, G_honest=Gh, G_attack=Ga, grad_defense=gd,
        accept_ratio=torch.tensor(0.5), past_grads=torch.zeros(0, 300),
        past_norms=torch.zeros(0), past_count=torch.zeros((), dtype=torch.int32),
        momentum=0.9, sums=sums)
    assert sorted(sums) == ["agg2", "dev2", "navg2"]
    reused = health.health_metrics(Gh, Ga, gd, t0, t1, sums=sums)
    fresh = health.health_metrics(Gh, Ga, gd, t0, t1)
    for key in HEALTH_COLUMNS:
        assert torch.equal(reused[key].nan_to_num(), fresh[key].nan_to_num())


# --------------------------------------------------------------------------- #
# The engine step

N, F, S, B = 9, 2, 9, 4
STEP_CASES = {
    "krum": ("krum", "empire", None),
    "krum-nan": ("krum", "nan", None),
    "bulyan": ("bulyan", "empire", None),
    "device-gar": ("krum", "empire", "cpu"),
}


def _engines(gar, attack, health_on):
    common = dict(nb_workers=N, nb_decl_byz=F, nb_real_byz=F,
                  nb_for_study=S, nb_for_study_past=2, momentum=0.9,
                  gradient_clip=5.0, health=health_on)
    kwargs = {"factor": 1.1} if attack == "empire" else {}
    jengine = build_engine(
        cfg=JaxConfig(**common), model_def=jax_models.build("simples-full"),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars[gar], 1.0, {})],
        attack=jax_attacks.attacks[attack], attack_kwargs=kwargs)
    model = models.build("simples-full", device="cpu")
    model.init(prng.PRNGKey(7))
    engine = Engine(EngineConfig(**common), model, Loss("nll"),
                    Criterion("top-k"), [(gars[gar], 1.0, {})],
                    attacks[attack], kwargs, optim.build("sgd"))
    return (jengine, jengine.init(jax.random.PRNGKey(7)), engine,
            engine.init(prng.PRNGKey(7)))


def _batches(seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((S, B, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, (S, B)).astype(np.int32)
    return xs, ys


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_health_matches_jax(case):
    gar, attack, gar_device = STEP_CASES[case]
    jengine, jstate, engine, state = _engines(gar, attack, True)
    if gar_device is None:
        jstep, step = jengine.train_step, engine.train_step
    else:
        jstep = jax_program.build_step(jengine, gar_device=gar_device)
        step = program.build_step(engine, gar_device=gar_device)
    for seed in range(4):
        xs, ys = _batches(seed)
        jstate, jmetrics = jstep(jstate, jnp.asarray(xs), jnp.asarray(ys),
                                 jnp.float32(0.1))
        state, got = step(state, torch.from_numpy(xs), torch.from_numpy(ys),
                          0.1)
        assert set(got) == set(STUDY_COLUMNS[2:]) | set(HEALTH_COLUMNS)
        assert got["Norm hist"].shape == (health.HIST_BINS,)
        np.testing.assert_array_equal(got["Norm hist"].numpy(),
                                      np.asarray(jmetrics["Norm hist"]))
        for key in COUNTS:
            assert float(got[key]) == float(jmetrics[key]), key
        for key in FLOATS:
            _close(_np(got[key]), jmetrics[key])
    if attack == "nan":
        assert float(got["Nonfinite submitted"]) == F
        assert float(got["Norm hist"][-1]) == F
    if gar_device is not None:
        assert engine.counts["device_gar_steps"] == 4


def test_step_with_health_keeps_the_plain_columns_and_state():
    xs, ys = (torch.from_numpy(a) for a in _batches(3))
    out = {}
    for health_on in (False, True):
        *_, engine, state = _engines("bulyan", "empire", health_on)
        out[health_on] = engine.train_step(state, xs, ys, 0.1)
    (off_state, off), (on_state, on) = out[False], out[True]
    assert torch.equal(off_state.theta, on_state.theta)
    assert torch.equal(off_state.momentum_server, on_state.momentum_server)
    assert set(on) - set(off) == set(HEALTH_COLUMNS)
    for column in STUDY_COLUMNS[2:]:
        assert torch.equal(torch.as_tensor(off[column]).nan_to_num(),
                           torch.as_tensor(on[column]).nan_to_num()), column


def test_chunk_stacks_the_health_vector():
    *_, engine, state = _engines("krum", "empire", True)
    xs, ys = _batches(5)
    xs = torch.from_numpy(np.stack([xs] * 3))
    ys = torch.from_numpy(np.stack([ys] * 3))
    _, stacked = engine.train_multi(state, xs, ys,
                                    np.full(3, 0.1, np.float32))
    assert stacked["Norm hist"].shape == (3, health.HIST_BINS)
    for key in FLOATS + COUNTS:
        assert stacked[key].shape == (3,), key
    assert torch.all(stacked["Norm hist"].sum(dim=1) == N)


def test_step_without_health_runs_no_health_code(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the step called engine/health.py")

    monkeypatch.setattr(step_mod.health_mod, "health_metrics", refuse)
    *_, engine, state = _engines("krum", "empire", False)
    xs, ys = _batches(4)
    _, got = engine.train_step(state, torch.from_numpy(xs),
                               torch.from_numpy(ys), 0.1)
    assert set(got) == set(STUDY_COLUMNS[2:])


# --------------------------------------------------------------------------- #
# The monitor

def _vector(rng, var=0.5, upd=1e-3, weight=6.0, nonfinite=0, noise=0.03):
    jitter = 10.0 ** rng.normal(0.0, noise, 3)
    return {"var_ratio": var * jitter[0], "update_ratio": upd * jitter[1],
            "weight_norm": weight * jitter[2], "update_norm": 0.1,
            "nonfinite": nonfinite,
            "norm_hist": [float(c) for c in rng.integers(0, 3, 16)]}


def _stream(name, seed=0):
    """`(step, vector)` pairs of a named scenario."""
    rng = np.random.default_rng(seed)
    base = [_vector(rng) for _ in range(40)]
    if name == "spike":
        tail = [_vector(rng, var=5e4)] + [_vector(rng) for _ in range(30)]
    elif name == "runs":
        # Two same-side excursions near 4.5 sigma in three steps, then 4
        # of 5 near 3 sigma on another channel
        tail = [_vector(rng, var=0.5 * 10 ** (k * 0.2), noise=0.0)
                for k in (1, 0, 1)] + [_vector(rng) for _ in range(12)]
        tail += [_vector(rng, upd=1e-3 * 10 ** (k * 0.14), noise=0.0)
                 for k in (1, 1, 0, 1, 1)] + [_vector(rng) for _ in range(15)]
    elif name == "collapse":
        tail = [_vector(rng, var=5e-4) for _ in range(50)]
    elif name == "nonfinite":
        base = [_vector(rng, nonfinite=2 if 3 <= k < 6 else 0)
                for k in range(40)]
        tail = [dict(_vector(rng), var_ratio=math.nan),
                dict(_vector(rng), weight_norm=math.inf, nonfinite=1)]
        tail += [_vector(rng) for _ in range(5)]
    else:
        tail = [_vector(rng, weight=6.0 * 1.3 ** k) for k in range(12)]
    return list(enumerate(base + tail))


@pytest.fixture
def both_recorders(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port, jrec = obs.Telemetry(tmp_path / "port"), jax_obs.Telemetry(
        tmp_path / "jax")
    obs.activate(port)
    jax_obs.activate(jrec)
    yield tmp_path
    obs.deactivate()
    jax_obs.deactivate()
    port.close()
    jrec.close()


def _events(directory):
    """The events of a recorder's file, a dump's path by its file name."""
    out = []
    for record in obs.load_records(directory):
        data = dict(record.get("data") or {})
        if "path" in data:
            data["path"] = pathlib.Path(data["path"]).name
        out.append((record["name"], data))
    return out


MONITOR_KWARGS = {
    "default": {},
    "fast": dict(warmup=10, clear_after=5, ring=16),
    "alpha": dict(alpha=0.2, warmup=5, z_spike=5.0, z_run2=3.0, z_run4=2.0,
                  z_clear=1.5, clear_after=3, ring=8),
}


@pytest.mark.parametrize("kwargs", sorted(MONITOR_KWARGS))
@pytest.mark.parametrize("name", ("spike", "runs", "collapse", "nonfinite",
                                  "drift"))
def test_monitor_matches_jax(both_recorders, name, kwargs):
    port = HealthMonitor(**MONITOR_KWARGS[kwargs])
    jmon = JaxMonitor(**MONITOR_KWARGS[kwargs])
    rules = set()
    for step, vector in _stream(name):
        assert port.update(step, dict(vector)) == jmon.update(step,
                                                              dict(vector))
        assert port.anomaly == jmon.anomaly
        if step % 7 == 0:
            assert port.rollback_pending() == jmon.rollback_pending()
        if step == 45:
            port.note_rollback()
            jmon.note_rollback()
        assert port.summary() == jmon.summary()
        rules |= {edge["rule"] for edge in port.blackbox("t")["edges"]
                  if "rule" in edge}
    assert port.blackbox(name) == jmon.blackbox(name)
    assert port.dump_blackbox(both_recorders / "port", name) is not None
    assert jmon.dump_blackbox(both_recorders / "jax", name) is not None
    assert (_events(both_recorders / "port")
            == _events(both_recorders / "jax"))
    want = {("spike", "default"): {"spike"}, ("runs", "default"): {"run2of3"},
            ("drift", "alpha"): {"run4of5"}, ("collapse", "fast"): {"spike"},
            ("nonfinite", "default"): {"nonfinite"}}.get((name, kwargs), set())
    assert want <= rules, rules
    if name == "collapse" and kwargs != "alpha":
        assert port.anomaly  # the frozen baseline never adapts to it


def test_monitor_hysteresis_and_consume_once_match_jax():
    rng = np.random.default_rng(1)
    stream = [_vector(rng) for _ in range(30)] + [_vector(rng, var=5e4)]
    stream += [_vector(rng) for _ in range(20)]
    monitors = [HealthMonitor(warmup=10, clear_after=5),
                JaxMonitor(warmup=10, clear_after=5)]
    trace = [[], []]
    for k, monitor in enumerate(monitors):
        for step, vector in enumerate(stream):
            trace[k].append((monitor.update(step, dict(vector)),
                             monitor.rollback_pending()))
    assert trace[0] == trace[1]
    pending = [step for step, (_, p) in enumerate(trace[0]) if p]
    assert pending == [30]  # once per rising edge
    cleared = next(step for step, (active, _) in enumerate(trace[0])
                   if step > 30 and not active)
    assert cleared - 30 >= 5
    assert monitors[0].blackbox("x") == monitors[1].blackbox("x")


def test_blackbox_loads_across_packages(tmp_path):
    rng = np.random.default_rng(2)
    port, jmon = HealthMonitor(ring=8), JaxMonitor(ring=8)
    for step in range(20):
        vector = _vector(rng, nonfinite=1 if step == 12 else 0)
        vector["weight_norm"] = math.inf if step == 12 else vector["weight_norm"]
        port.update(step, dict(vector))
        jmon.update(step, dict(vector))
    for name, monitor in (("a", port), ("b", jmon)):
        (tmp_path / name).mkdir()
        assert monitor.dump_blackbox(tmp_path / name, "test") is not None
    assert obs.load_blackbox(tmp_path / "b") == jax_load(tmp_path / "a")
    assert (tmp_path / "a" / "health_blackbox.json").read_text() == (
        tmp_path / "b" / "health_blackbox.json").read_text()
    assert obs.load_blackbox(tmp_path / "missing") is None
    (tmp_path / "a" / "health_blackbox.json").write_text("{torn")
    assert obs.load_blackbox(tmp_path / "a") is None


@pytest.mark.parametrize("kwargs", (dict(alpha=0.0), dict(alpha=1.5),
                                   dict(warmup=0), dict(ring=0),
                                   dict(z_clear=5.0, z_run4=2.0),
                                   dict(z_run2=7.0)))
def test_monitor_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as jerr:
        JaxMonitor(**kwargs)
    with pytest.raises(ValueError) as err:
        HealthMonitor(**kwargs)
    assert str(err.value) == str(jerr.value)
