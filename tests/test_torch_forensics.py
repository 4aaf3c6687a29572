"""The port's forensics path against the JAX package's: the suspicion
tracker (`obs/forensics.py`), the engine step with `gar_diagnostics`, and
the driver's `--gar-diagnostics` study columns.

* `SuspicionTracker`: one random stream of selections, worker distances
  (with +inf entries), active masks and distance matrices through the
  port's and the JAX tracker, with 3 and 4 weights and several alphas:
  `suspicion`, `suspects`, `max()` and `summary()` equal after every
  step (exact: both are the same float64 numpy arithmetic);
  `collusion_partners` equal; the JAX validation errors with the JAX
  messages.
* The engine: steps on `simples-full` (n = 9, 2 real Byzantine workers
  against `empire(1.1)`) through both engines from the same key and
  batches, with `gar_diagnostics`: Krum and Bulyan alone, a per-step
  `--gars` mixture (krum and median, the member drawn by both key
  chains) and the `--device-gar cpu` hop. `Sel mask` selects the same
  workers; its values, `Worker dist` and the three scalars are held
  within rtol 1e-5, atol 1e-6 (the JAX step is one `jit` program, which
  XLA may round in another order). A per-call mixture (average, median
  and krum against `nan`: every member's diagnose runs and the drawn one
  is picked) draws from the operand's bits, so it is held on the defense
  phase from the same honest rows, where both draw the same member. The
  24 study columns are the flag-off step's. With the flag off the step
  calls no function of `ops/diag.py` and has no forensic key.
* The driver: the JAX `tests/test_diag.py` line (simples-full, Krum at
  n = 9, f = 2, `empire(1.1)`, momentum at the workers, seed 11, 16
  steps) and a Trimmed-mean line (f = 2, 8 steps, where `Clip frac` is
  not 0) through both drivers: headers equal, `Sel workers` equal in
  every row, every float column within rtol 1e-4, atol 1e-6 (the bounds
  of the seed-driver tests on simples-full); from step 8 on Krum never
  selects the attackers 7 and 8; `study.worker_heatmap` and
  `study.suspicion_timeline` render from the port's result directory.
  Without `--result-directory` the flag is dropped with the JAX warning.
"""

import os

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
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import FORENSIC_COLUMNS as JAX_FORENSIC
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu.engine import program as jax_program
from byzantinemomentum_tpu_torch import models, obs, optim, prng
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import (
    FORENSIC_COLUMNS, STUDY_COLUMNS, Engine, EngineConfig, program)
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.ops import diag, gars

from tests.torch_threads import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------- #
# The suspicion tracker

def _stream(n, steps, seed):
    """A tracker's input stream: selections (0/1 and fractional masses),
    worker distances with +inf entries, active masks and distance
    matrices (with near-duplicate rows)."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        sel = (rng.random(n) < 0.7).astype(np.float32)
        if step % 3 == 0:
            sel = sel * rng.random(n).astype(np.float32)
        dist = rng.random(n).astype(np.float32) * 5
        dist[rng.random(n) < 0.1] = np.inf
        if step < steps // 2:
            # The last worker: never selected and far, then honest again
            sel[n - 1], dist[n - 1] = 0.0, 40.0
        if step % 7 == 0:
            dist[:] = 2.0  # a zero standard deviation
        active = None if step % 2 else (rng.random(n) < 0.9).astype(np.float32)
        pts = rng.standard_normal((n, 4))
        pts[n - 2] = pts[n - 1] + 1e-3 * rng.standard_normal(4)
        matrix = np.linalg.norm(pts[:, None] - pts[None], axis=2)
        np.fill_diagonal(matrix, np.inf)
        yield step, sel, dist, active, matrix.astype(np.float32)


@pytest.mark.parametrize("weights,alpha", (((0.5, 0.3, 0.2), 0.05),
                                           ((0.5, 0.3, 0.2), 0.4),
                                           ((0.4, 0.3, 0.1, 0.2), 0.05),
                                           ((1.0, 2.0, 1.0, 3.0), 0.3)))
def test_tracker_matches_jax(weights, alpha):
    n = 9
    kwargs = dict(alpha=alpha, weights=weights, min_steps=3)
    got = obs.SuspicionTracker(n, **kwargs)
    want = jax_obs.SuspicionTracker(n, **kwargs)
    seen = set()
    for step, sel, dist, active, matrix in _stream(n, 60, seed=len(weights)):
        a = got.update(step, sel, distances=dist, active=active,
                       dist_matrix=matrix)
        b = want.update(step, sel, distances=dist, active=active,
                        dist_matrix=matrix)
        np.testing.assert_array_equal(a, b)
        assert got.suspects == want.suspects
        assert got.max() == want.max()
        assert got.summary() == want.summary()
        seen.update(got.suspects)
    assert seen  # the stream makes suspects, and clears some
    np.testing.assert_array_equal(got.partners, want.partners)


def test_tracker_without_distances_matches_jax():
    n = 5
    got, want = obs.SuspicionTracker(n), jax_obs.SuspicionTracker(n)
    for step, sel, _, _, _ in _stream(n, 30, seed=9):
        np.testing.assert_array_equal(got.update(step, sel),
                                      want.update(step, sel))
    assert got.summary() == want.summary()


@pytest.mark.parametrize("frac", (0.2, 0.6))
def test_collusion_partners_matches_jax(frac):
    for _, _, _, _, matrix in _stream(7, 5, seed=3):
        matrix[0, :] = matrix[:, 0] = np.inf
        np.testing.assert_array_equal(
            obs.collusion_partners(matrix, frac),
            jax_obs.forensics.collusion_partners(matrix, frac))
    empty = np.full((3, 3), np.inf)
    assert not obs.collusion_partners(empty).any()
    assert obs.Z_CLIP == jax_obs.forensics.Z_CLIP
    assert obs.COLLUSION_FRAC == jax_obs.forensics.COLLUSION_FRAC


@pytest.mark.parametrize("kwargs", (dict(alpha=0.0), dict(alpha=1.5),
                                    dict(threshold=0.3, clear=0.5),
                                    dict(clear=-0.1),
                                    dict(weights=(1.0, 1.0))))
def test_tracker_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jax_obs.SuspicionTracker(4, **kwargs)
    with pytest.raises(ValueError, match=None) as got:
        obs.SuspicionTracker(4, **kwargs)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# The engine step

N, F, F_REAL, S, B, STEPS = 9, 2, 2, 9, 4, 6
ENGINE_CASES = {
    "krum": ([("krum", 1.0)], False, None),
    "bulyan": ([("bulyan", 1.0)], False, None),
    "mixture": ([("krum", 1.0), ("median", 1.0)], False, None),
    "device-gar": ([("krum", 1.0)], False, "cpu"),
}
FORENSIC_KEYS = ("Sel mask", "Worker dist", "Dist honest med",
                 "Var/norm ratio", "Clip frac")


def _engines(members, per_call, diagnostics, attack="empire"):
    """The JAX engine and the port's over `members` (name, frequency) on
    `simples-full`, both from `PRNGKey(7)`."""
    common = dict(nb_workers=N, nb_decl_byz=F, nb_real_byz=F_REAL,
                  nb_for_study=S, nb_for_study_past=2, momentum=0.9,
                  gradient_clip=5.0, gars_per_call=per_call,
                  gar_diagnostics=diagnostics)
    cum, jdefenses, defenses = 0.0, [], []
    for name, freq in members:
        cum += freq
        jdefenses.append((jax_ops.gars[name], cum, {}))
        defenses.append((gars[name], cum, {}))
    jengine = build_engine(
        cfg=JaxConfig(**common), model_def=jax_models.build("simples-full"),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=jdefenses, attack=jax_attacks.attacks[attack],
        attack_kwargs={"factor": 1.1} if attack == "empire" else {})
    model = models.build("simples-full", device="cpu")
    model.init(prng.PRNGKey(7))
    engine = Engine(EngineConfig(**common), model, Loss("nll"),
                    Criterion("top-k"), defenses, attacks[attack],
                    {"factor": 1.1} if attack == "empire" else {},
                    optim.build("sgd"))
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
def test_step_forensics_match_jax(case):
    members, per_call, gar_device = ENGINE_CASES[case]
    jengine, jstate, engine, state = _engines(members, per_call, True)
    if gar_device is None:
        jstep, step = jengine.train_step, engine.train_step
    else:
        jstep = jax_program.build_step(jengine, gar_device=gar_device)
        step = program.build_step(engine, gar_device=gar_device)
    drawn = set()
    for seed in range(STEPS):
        xs, ys = _batches(seed)
        if len(members) > 1 and not per_call:
            mix_key = jax.random.split(jstate.rng, S + 2)[1]
            drawn.add(int(jax_program.mixture_index(
                jengine.defenses, jax.random.uniform(mix_key))))
        jstate, jmetrics = jstep(jstate, jnp.asarray(xs), jnp.asarray(ys),
                                 jnp.float32(0.1))
        state, metrics = step(state, torch.from_numpy(xs),
                              torch.from_numpy(ys), 0.1)
        assert set(metrics) == set(STUDY_COLUMNS[2:]) | set(FORENSIC_KEYS)
        for key in ("Sel mask", "Worker dist"):
            assert metrics[key].shape == (N,)
            assert metrics[key].dtype == torch.float32
        np.testing.assert_array_equal(metrics["Sel mask"].numpy() > 0,
                                      np.asarray(jmetrics["Sel mask"]) > 0)
        for key in FORENSIC_KEYS:
            _close(metrics[key], jmetrics[key])
        _close(state.theta, jstate.theta, rtol=1e-4, atol=1e-5)
    if len(members) > 1:
        assert drawn == {0, 1}
    if gar_device is not None:
        assert engine.counts["device_gar_steps"] == STEPS


def test_per_call_defense_forensics_match_jax():
    jengine, _, engine, _ = _engines(
        [("average", 1.0), ("median", 1.0), ("krum", 1.0)], True, True,
        attack="nan")
    rng = np.random.default_rng(6)
    drawn = set()
    for seed in range(12):
        G = rng.standard_normal((N - F_REAL, engine.d)).astype(np.float32)
        key = jax.random.PRNGKey(100 * seed + 3)
        jG_attack, jdef, _, _, jmetrics, _ = jengine._phase_defense(
            jnp.asarray(G), key)
        G_attack, grad_def, _, _, metrics = engine.phase_defense(
            torch.from_numpy(G), (), mix_key=prng.PRNGKey(100 * seed + 3))
        G_all = torch.cat([torch.from_numpy(G), G_attack])
        drawn.add(int(engine.per_call_member(prng.PRNGKey(100 * seed + 3),
                                             G_all)))
        _close(grad_def, jdef)
        np.testing.assert_array_equal(metrics["Sel mask"].numpy() > 0,
                                      np.asarray(jmetrics["Sel mask"]) > 0)
        for key in FORENSIC_KEYS:
            _close(metrics[key], jmetrics[key])
    assert drawn == {0, 1, 2}


def test_step_with_diagnostics_keeps_the_plain_columns():
    """The 24 study columns and the new state are the flag-off step's,
    bit for bit (Bulyan: the diagnose form runs the plain kernels)."""
    xs, ys = (torch.from_numpy(a) for a in _batches(3))
    out = {}
    for diagnostics in (False, True):
        *_, engine, state = _engines([("bulyan", 1.0)], False, diagnostics)
        out[diagnostics] = engine.train_step(state, xs, ys, 0.1)
    (off_state, off), (on_state, on) = out[False], out[True]
    assert torch.equal(off_state.theta, on_state.theta)
    for column in STUDY_COLUMNS[2:]:
        assert torch.equal(torch.as_tensor(off[column]).nan_to_num(),
                           torch.as_tensor(on[column]).nan_to_num()), column


def test_step_without_diagnostics_runs_no_diag_code(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain step called ops/diag.py")

    for name in diag.__all__:
        if callable(getattr(diag, name)):
            monkeypatch.setattr(diag, name, refuse)
    for members, per_call in ((["bulyan"], False),
                              (["trmean", "median"], False),
                              (["average", "krum", "meamed"], True)):
        *_, engine, state = _engines([(m, 1.0) for m in members], per_call,
                                     False)
        assert engine.defense_diag is None
        xs, ys = _batches(4)
        _, metrics = engine.train_step(state, torch.from_numpy(xs),
                                       torch.from_numpy(ys), 0.1)
        assert set(metrics) == set(STUDY_COLUMNS[2:])


# --------------------------------------------------------------------------- #
# The driver

DRIVER_LINE = ["--nb-steps", "16", "--batch-size", "8", "--batch-size-test",
               "32", "--batch-size-test-reps", "2", "--evaluation-delta", "0",
               "--model", "simples-full", "--seed", "11", "--nb-workers", "9",
               "--nb-decl-byz", "2", "--nb-real-byz", "2", "--gar", "krum",
               "--attack", "empire", "--attack-args", "factor:1.1",
               "--momentum-at", "worker", "--nb-for-study", "7",
               "--nb-for-study-past", "2", "--gar-diagnostics"]
DRIVER_LINES = {
    "krum": DRIVER_LINE,
    "trmean": [*DRIVER_LINE[:DRIVER_LINE.index("--gar") + 1], "trmean",
               *DRIVER_LINE[DRIVER_LINE.index("--gar") + 2:]],
}
DRIVER_LINES["trmean"][1] = "8"


def _rows(resdir):
    lines = (resdir / "study").read_text().split(os.linesep)
    return lines[0], [line.split("\t") for line in lines[1:] if line]


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """Both drivers' result directories on each line (small synthetic
    MNIST)."""
    saved = {key: os.environ.get(key) for key in ("BMT_SYNTH_TRAIN",
                                                  "BMT_SYNTH_TEST")}
    os.environ.update(BMT_SYNTH_TRAIN="512", BMT_SYNTH_TEST="128")
    runs = {}
    try:
        for name, argv in DRIVER_LINES.items():
            root = tmp_path_factory.mktemp(name)
            assert jax_main(["--device", "cpu", *argv, "--result-directory",
                             str(root / "jax")]) == 0
            driver.run(["--device", "cpu", *argv, "--result-directory",
                        str(root / "port")])
            runs[name] = root
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return runs


@pytest.mark.parametrize("line", sorted(DRIVER_LINES))
def test_driver_forensic_columns_track_jax(driver_runs, line):
    jheader, want = _rows(driver_runs[line] / "jax")
    header, got = _rows(driver_runs[line] / "port")
    assert FORENSIC_COLUMNS == JAX_FORENSIC
    assert header == jheader == "# " + "\t".join(STUDY_COLUMNS
                                                 + FORENSIC_COLUMNS)
    assert len(got) == len(want) == int(DRIVER_LINES[line][1])
    sel = STUDY_COLUMNS.index("Attack acceptation ratio") + 1
    assert [row[:2] for row in got] == [row[:2] for row in want]
    assert [row[sel] for row in got] == [row[sel] for row in want]
    numbers = [i for i in range(2, len(got[0])) if i != sel]
    want_v = np.array([[float(row[i]) for i in numbers] for row in want])
    got_v = np.array([[float(row[i]) for i in numbers] for row in got])
    _close(got_v, want_v, rtol=1e-4, atol=1e-6)
    suspicion = got_v[:, -1]
    assert np.all((suspicion >= 0) & (suspicion <= 1))
    clip = got_v[:, -2]
    if line == "trmean":
        assert np.all(clip > 0)
        assert all(row[sel] == "0;1;2;3;4;5;6;7;8" for row in got)
    else:
        assert np.all(clip == 0)
        for row in got:
            if int(row[0]) >= 8:
                assert not {"7", "8"} & set(row[sel].split(";")), row[sel]
        ratio = got_v[:, numbers.index(sel + 2)]
        assert ratio[-1] < ratio[0]


def test_study_plots_render_from_the_port(driver_runs, tmp_path):
    import matplotlib
    matplotlib.use("Agg")

    import study

    session = study.Session(driver_runs["krum"] / "port")
    for name, plot in (("heatmap", study.worker_heatmap(session)),
                       ("suspicion", study.suspicion_timeline(session))):
        plot.save(tmp_path / f"{name}.png")
        plot.close()
        assert (tmp_path / f"{name}.png").stat().st_size > 0


def test_flag_without_result_directory_warns_and_runs(capsys, monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "128")
    monkeypatch.setenv("BMT_SYNTH_TEST", "32")
    argv = ["--device", "cpu", *DRIVER_LINE[2:], "--nb-steps", "2"]
    args = driver._postprocess(driver.process_commandline(argv))
    assert not args.gar_diagnostics
    out = capsys.readouterr()
    assert ("'--gar-diagnostics' needs the study pipeline ('--nb-for-study' "
            "with '--result-directory'); diagnostics disabled") in (
                out.out + out.err)
    summary = driver.run(argv)
    assert summary["steps"] == 2 and summary["result_directory"] is None
