"""Checkpoints of the port (`byzantinemomentum_tpu_torch/checkpoint.py`)
against the JAX package's, on the CPU.

* The msgpack coder writes what `flax.serialization.msgpack_serialize`
  writes, byte for byte, on mixed trees (f32, bf16, f16, int32, uint32
  and f64 arrays, empty arrays, 0-d arrays and numpy scalars, ints of
  every width, floats, strings, nested and empty maps, lists, None and
  booleans), and reads flax's bytes back.
* A port checkpoint is byte-equal to the JAX one of the same state: the
  two drivers' `checkpoint-0` from the same `--seed` (f32 and bf16,
  `empire-cnn` and `simples-full`, worker momentum, the `alie-warmup`
  state, the samplers' snapshots), and a JAX state after two steps
  carried across field by field.
* Each package resumes the other's checkpoint: the port's driver,
  `--load-checkpoint` on a JAX checkpoint, writes the JAX run's study
  rows (within `tests/test_torch_seed.py`'s bounds) and eval rows; the
  JAX driver resumes a port checkpoint the same way, also in the middle
  of `alie-warmup`'s window and of the past-gradient window (the port
  holds both counters as device tensors, written as the JAX int32 0-d
  arrays).
* A corrupt file is refused (CRC), `find_latest_valid` walks past a torn
  tail, `--keep-checkpoints` keeps the newest N and `--checkpoint-mirror`
  writes the same bytes twice, as in the JAX package; arrays beyond
  flax's chunk size are refused; the flag checks are the JAX driver's.
* Kill and resume: the port's driver on the CPU, killed in the middle of
  a checkpoint write (`BMT_CHAOS_TORN_CHECKPOINT_STEP`) or by SIGKILL at a
  step (`BMT_CHAOS_KILL_AT_STEP`, with the newest checkpoint then torn),
  and `--auto-resume`d with the same command line, writes the
  uninterrupted run's `eval` file byte for byte and its `study` rows
  byte for byte up to the `Restarts` column (0 before the resume, 1
  after, as in the JAX package's chaos tests).
* The samplers' `get_state`/`set_state` round-trip, equal the JAX
  sampler's snapshot, and a bad cursor is refused before anything
  changes.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from byzantinemomentum_tpu import checkpoint as jax_checkpoint
from byzantinemomentum_tpu import data as jax_data
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu_torch import checkpoint, convert, data, utils
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import RECOVERY_COLUMNS

from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SYNTH = {"BMT_SYNTH_TRAIN": "256", "BMT_SYNTH_TEST": "64"}


@pytest.fixture(autouse=True)
def small_sets(monkeypatch):
    for key, value in SYNTH.items():
        monkeypatch.setenv(key, value)


# --------------------------------------------------------------------------- #
# The coder

def _trees():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return [
        {"b": np.arange(5, dtype=np.int32), "a": {"z": np.float32(1.5),
                                                   "e": {}, "k": np.asarray(7, np.int32)}},
        {"theta": f32, "bf16": jnp.asarray(f32).astype(jnp.bfloat16),
         "f16": f32.astype(np.float16), "f64": rng.standard_normal(40),
         "u32": np.array([1, 2**32 - 1], np.uint32),
         "empty": np.zeros((0, 7), np.float32), "zero_d": np.asarray(2.5, np.float32)},
        {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
                  -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1],
         "floats": [0.0, -1.5, 1e300], "none": None, "flags": [True, False],
         "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "é"],
         "nested": {str(i): {"v": i} for i in range(20)}},
        {"big": rng.standard_normal(20_000).astype(np.float32),
         "scalars": {"i64": np.int64(-3), "f64": np.float64(0.25),
                     "u8": np.uint8(200)}},
    ]


def _to_port(tree):
    """A tree with its JAX arrays as torch tensors (bf16 through its bits)."""
    if isinstance(tree, dict):
        return {key: _to_port(value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [_to_port(value) for value in tree]
    if isinstance(tree, jax.Array):
        return torch.from_numpy(np.asarray(tree.astype(jnp.float32))).to(torch.bfloat16)
    return tree


@pytest.mark.parametrize("index", range(4))
def test_coder_writes_flax_bytes(index):
    tree = _trees()[index]
    want = serialization.msgpack_serialize(tree)
    assert checkpoint.packb(_to_port(tree)) == want
    back = checkpoint.unpackb(want)
    assert checkpoint.packb(back) == want


def test_coder_reads_flax_values():
    tree = _trees()[1]
    back = checkpoint.unpackb(serialization.msgpack_serialize(tree))
    assert back["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["bf16"].float().numpy(),
                                  np.asarray(tree["bf16"].astype(jnp.float32)))
    np.testing.assert_array_equal(back["u32"], tree["u32"])
    assert back["zero_d"].shape == () and back["empty"].shape == (0, 7)
    scalars = checkpoint.unpackb(serialization.msgpack_serialize(_trees()[3]))
    assert scalars["scalars"]["i64"] == -3
    assert isinstance(scalars["scalars"]["i64"], np.int64)


def test_coder_refuses_arrays_beyond_the_chunk_size(monkeypatch):
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)
    checkpoint.packb(np.zeros(16, np.float32))
    with pytest.raises(ValueError, match="chunk size"):
        checkpoint.packb(np.zeros(17, np.float32))


# --------------------------------------------------------------------------- #
# Byte equality with the JAX package

BASE = ["--seed", "6", "--nb-workers", "7", "--nb-decl-byz", "1",
        "--nb-real-byz", "1", "--batch-size-test", "16",
        "--batch-size-test-reps", "2", "--evaluation-delta", "2",
        "--nb-for-study", "1", "--nb-for-study-past", "2",
        "--checkpoint-delta", "2"]
MNIST = ["--model", "simples-full", "--dataset", "mnist", "--batch-size", "8",
         "--gar", "median", "--attack", "empire", "--attack-args", "factor:1.1",
         "--learning-rate", "0.1"]
CIFAR = ["--model", "empire-cnn", "--dataset", "cifar10", "--batch-size", "4",
         "--gar", "bulyan", "--nb-workers", "11", "--nb-decl-byz", "2",
         "--nb-real-byz", "2", "--attack", "empire", "--attack-args",
         "factor:1.1", "--momentum", "0.99", "--gradient-clip", "5"]
INITIAL = {
    "simples-full": MNIST,
    "simples-full-worker-alie-warmup": [
        *MNIST, "--momentum-at", "worker", "--gar", "krum", "--attack",
        "alie-warmup", "--attack-args", "window:2"],
    "empire-cnn": CIFAR,
    "empire-cnn-bf16": [*CIFAR, "--dtype", "bfloat16"],
}


def _both(tmp_path, argv, steps):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    argv = ["--device", "cpu", *BASE, *argv, "--nb-steps", str(steps)]
    assert jax_main([*argv, "--result-directory", str(jdir)]) == 0
    driver.run([*argv, "--result-directory", str(pdir)])
    return jdir, pdir


@pytest.mark.parametrize("run", sorted(INITIAL))
def test_initial_checkpoint_is_the_jax_file(tmp_path, run):
    """Both drivers' `checkpoint-0` from one `--seed`: the same bytes."""
    jdir, pdir = _both(tmp_path, INITIAL[run], 0)
    want = (jdir / "checkpoint-0").read_bytes()
    assert (pdir / "checkpoint-0").read_bytes() == want
    assert checkpoint.verify(pdir / "checkpoint-0")


def _port_state(jstate, like):
    """The port `TrainState` holding a JAX state's values (dtypes and
    layout from `like`)."""
    def t(x):
        return torch.from_numpy(np.array(np.asarray(x).astype(np.float32))).to(
            like.theta.dtype)
    fields = {name: t(getattr(jstate, name)) for name in (
        "theta", "momentum_server", "momentum_workers", "origin",
        "past_grads", "past_norms")}
    fields["net_state"] = {name: t(v) for name, v in convert.flat_items(
        jax.tree.map(np.asarray, jstate.net_state))}
    fields.update({name: int(getattr(jstate, name))
                   for name in ("steps", "datapoints")})
    # The port's device counters: i32 0-d tensors
    fields["past_count"] = torch.tensor(int(jstate.past_count),
                                        dtype=torch.int32)
    fields["rng"] = torch.from_numpy(np.asarray(jstate.rng).astype(np.int64))
    fields["attack_state"] = (() if isinstance(jstate.attack_state, tuple)
                              else torch.tensor(int(jstate.attack_state),
                                                dtype=torch.int32))
    return type(like)(**{**like.__dict__, **fields})


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_stepped_state_checkpoint_is_the_jax_file(tmp_path, dtype):
    """A JAX state after two steps of `alie-warmup` with worker momentum,
    carried across field by field: `save` writes the JAX file."""
    from byzantinemomentum_tpu.cli import attack as jax_driver
    argv = ["--device", "cpu", *BASE, *INITIAL["simples-full-worker-alie-warmup"],
            "--dtype", dtype, "--nb-steps", "2", "--result-directory",
            str(tmp_path / "jax")]
    assert jax_main(argv) == 0
    jstate = jax_checkpoint.load(tmp_path / "jax" / "checkpoint-2",
                                 _jax_template(jax_driver, argv))
    assert int(jstate.steps) == 2 and int(jstate.attack_state) == 2
    _, engine, fresh = driver._setup(driver._postprocess(
        driver.process_commandline([*argv[:-1], str(tmp_path / "port")])))
    state = _port_state(jstate, fresh)
    snapshot = {"train": engine.train_data.dataset.get_state(),
                "test": engine.test_data.dataset.get_state()}
    jax_checkpoint.save(tmp_path / "j", jstate, data_state=snapshot)
    checkpoint.save(tmp_path / "p", state, data_state=snapshot)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    # and the port reads it back as it was
    back, data_state = checkpoint.load(tmp_path / "j", fresh, return_data=True)
    assert data_state == snapshot
    for name in ("theta", "momentum_workers", "past_grads", "rng"):
        assert torch.equal(getattr(back, name), getattr(state, name))
    assert (back.steps, back.datapoints, back.past_count, back.attack_state) == (
        state.steps, state.datapoints, state.past_count, 2)


def _jax_template(jax_driver, argv):
    """A fresh JAX `TrainState` of a command line (the load template)."""
    from byzantinemomentum_tpu import models as jax_models
    from byzantinemomentum_tpu.engine import build_engine
    from byzantinemomentum_tpu import attacks as jax_attacks
    from byzantinemomentum_tpu import losses as jax_losses
    from byzantinemomentum_tpu import ops as jax_ops
    from byzantinemomentum_tpu.engine import EngineConfig
    args = jax_driver.process_commandline(argv)
    cfg = EngineConfig(
        nb_workers=args.nb_workers, nb_decl_byz=args.nb_decl_byz,
        nb_real_byz=args.nb_real_byz, nb_for_study=args.nb_for_study,
        nb_for_study_past=args.nb_for_study_past, momentum=args.momentum,
        momentum_at=args.momentum_at, dtype=args.dtype)
    engine = build_engine(
        cfg=cfg, model_def=jax_models.build(args.model),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars[args.gar], 1.0, {})],
        attack=jax_attacks.attacks[args.attack], attack_kwargs={"window": 2})
    return engine.init(jax.random.PRNGKey(args.seed))


def _rows(resdir, name):
    lines = (resdir / name).read_text().split(os.linesep)
    return [line for line in lines[1:] if line]


def _assert_tracks(got_dir, want_dir, start):
    """Study rows of `got_dir` against `want_dir`'s from step `start` on
    (rtol 1e-4, atol 1e-5; the cosine and curvature columns rtol 2e-3, as
    `tests/test_torch_seed.py` holds empire-cnn), eval rows equal."""
    got = [row.split("\t") for row in _rows(got_dir, "study")]
    want = [row.split("\t") for row in _rows(want_dir, "study")
            if int(row.split("\t")[0]) >= start]
    assert [row[:2] for row in got] == [row[:2] for row in want]
    columns = driver.STUDY_COLUMNS[2:]
    got = np.array([[float(v) for v in row[2:]] for row in got])
    want = np.array([[float(v) for v in row[2:]] for row in want])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    for i, column in enumerate(columns):
        finite = np.isfinite(want[:, i])
        loose = "cosine" in column or "curvature" in column
        np.testing.assert_allclose(got[finite, i], want[finite, i],
                                   rtol=2e-3 if loose else 1e-4, atol=1e-5,
                                   err_msg=column)
    assert _rows(got_dir, "eval") == [row for row in _rows(want_dir, "eval")
                                      if int(row.split("\t")[0]) >= start]


# Worker momentum and the stateful alie-warmup: every state field carries
RESUMED = INITIAL["simples-full-worker-alie-warmup"]


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_each_package_resumes_the_others_checkpoint(tmp_path, writer):
    """`simples-full` with worker momentum against `alie-warmup` (window
    2: its counter crosses the window after the resume): 4 steps with a
    checkpoint at step 2; the other package resumes it for 2 steps and
    writes the uninterrupted run's rows 2-3 and evaluations 2 and 4."""
    jdir, pdir = _both(tmp_path, RESUMED, 4)
    source = (jdir if writer == "jax" else pdir) / "checkpoint-2"
    resumed = tmp_path / "resumed"
    argv = ["--device", "cpu", *BASE, *RESUMED, "--nb-steps", "2",
            "--load-checkpoint", str(source), "--result-directory", str(resumed)]
    if writer == "jax":
        assert driver.run(argv)["steps"] == 4
    else:
        assert jax_main(argv) == 0
    _assert_tracks(resumed, jdir if writer == "jax" else pdir, 2)
    _assert_tracks(pdir, jdir, 0)


# Mid-window: `alie-warmup` at window 4 and a past-gradient window P = 3,
# both counters (device tensors in the port) part-way at the step-2
# checkpoint, over the first P + 2 = 5 steps
MID_WINDOW = [*MNIST, "--gar", "krum", "--attack", "alie-warmup",
              "--attack-args", "window:4", "--nb-for-study-past", "3"]


@pytest.fixture(scope="module")
def mid_window_runs(tmp_path_factory):
    """Both drivers, 5 steps of MID_WINDOW with checkpoints at 0, 2, 4."""
    tmp = tmp_path_factory.mktemp("mid")
    with pytest.MonkeyPatch.context() as patch:
        for key, value in SYNTH.items():
            patch.setenv(key, value)
        return _both(tmp, MID_WINDOW, 5)


def test_device_counters_track_jax_over_the_first_windows(tmp_path,
                                                          mid_window_runs):
    """`past_count` and the warm-up counter as device tensors: the study
    rows of the first P + 2 steps track the JAX driver's (the curvature's
    masked sum over P slots, the burst then the hidden rows), and a JAX
    checkpoint read into the port's state (tensor counters on the
    template's device) and saved again is the JAX file byte for byte."""
    jdir, pdir = mid_window_runs
    _assert_tracks(pdir, jdir, 0)
    curvature = driver.STUDY_COLUMNS.index("Sampled composite curvature")
    rows = [row.split("\t") for row in _rows(pdir, "study")]
    assert rows[0][curvature] == "nan" and "nan" not in [
        row[curvature] for row in rows[1:]]
    args = driver._postprocess(driver.process_commandline(
        ["--device", "cpu", *BASE, *MID_WINDOW, "--result-directory",
         str(tmp_path)]))
    _, _, fresh = driver._setup(args)
    assert fresh.past_count.dtype == torch.int32 and fresh.past_count.dim() == 0
    assert fresh.attack_state.dtype == torch.int32
    for step in (2, 4):
        state, data_state = checkpoint.load(jdir / f"checkpoint-{step}", fresh,
                                            return_data=True)
        assert isinstance(state.past_count, torch.Tensor)
        assert int(state.past_count) == min(step, 3)
        assert int(state.attack_state) == step
        checkpoint.save(pdir / f"again-{step}", state, data_state=data_state)
        assert (pdir / f"again-{step}").read_bytes() == (
            jdir / f"checkpoint-{step}").read_bytes()


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_each_package_resumes_the_other_mid_window(tmp_path, mid_window_runs,
                                                   writer):
    """The other package resumes the step-2 checkpoint (warm-up counter 2
    of 4, past count 2 of 3) and writes the uninterrupted run's rows 2-4
    and evaluations 2 and 4."""
    jdir, pdir = mid_window_runs
    source = (jdir if writer == "jax" else pdir) / "checkpoint-2"
    argv = ["--device", "cpu", *BASE, *MID_WINDOW, "--nb-steps", "3",
            "--load-checkpoint", str(source), "--result-directory",
            str(tmp_path / "resumed")]
    if writer == "jax":
        assert driver.run(argv)["steps"] == 5
    else:
        assert jax_main(argv) == 0
    _assert_tracks(tmp_path / "resumed", jdir if writer == "jax" else pdir, 2)


# --------------------------------------------------------------------------- #
# Integrity, scanning, retention, the mirror

def _saved_run(tmp_path, extra=()):
    resdir = tmp_path / "run"
    driver.run(["--device", "cpu", *BASE, *MNIST, "--nb-steps", "6",
                "--result-directory", str(resdir), *extra])
    return resdir


def test_corrupt_checkpoint_is_refused_and_torn_tail_skipped(tmp_path):
    resdir = _saved_run(tmp_path)
    assert checkpoint.find_latest_valid(resdir).name == "checkpoint-6"
    raw = (resdir / "checkpoint-6").read_bytes()
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0xFF
    (resdir / "checkpoint-6").write_bytes(bytes(flipped))
    assert not checkpoint.verify(resdir / "checkpoint-6")
    _, _, fresh = driver._setup(driver._postprocess(driver.process_commandline(
        ["--device", "cpu", *BASE, *MNIST])))
    with pytest.raises(utils.UserException, match="integrity footer mismatch"):
        checkpoint.load(resdir / "checkpoint-6", fresh)
    # A torn newest file (and a stale tmp) are walked past
    (resdir / "checkpoint-6").write_bytes(raw[:len(raw) // 2])
    (resdir / "checkpoint-8.tmp").write_bytes(raw[:10])
    assert checkpoint.find_latest_valid(resdir).name == "checkpoint-4"
    # The JAX package's scan agrees on the port's files
    assert jax_checkpoint.find_latest_valid(resdir).name == "checkpoint-4"


def test_load_refuses_a_bad_payload(tmp_path):
    resdir = _saved_run(tmp_path)
    _, _, fresh = driver._setup(driver._postprocess(driver.process_commandline(
        ["--device", "cpu", *BASE, *MNIST, "--result-directory", str(resdir)])))
    raw = checkpoint.unpackb(checkpoint._unseal(
        "x", (resdir / "checkpoint-2").read_bytes()))
    for change, match in (({"version": 1}, "expected version 2"),
                          ({"steps": np.asarray(-1, np.int32)}, "invalid steps"),
                          ({"theta": np.zeros(3, np.float32)}, "has shape")):
        bad = {**raw, "state": dict(raw["state"])}
        if "version" in change:
            bad.update(change)
        else:
            bad["state"].update(change)
        path = tmp_path / "bad"
        path.write_bytes(checkpoint.seal(checkpoint.packb(bad)))
        with pytest.raises(utils.UserException, match=match):
            checkpoint.load(path, fresh)
    del raw["state"]["rng"]
    (tmp_path / "bad").write_bytes(checkpoint.seal(checkpoint.packb(raw)))
    with pytest.raises(utils.UserException, match="missing field 'rng'"):
        checkpoint.load(tmp_path / "bad", fresh)


def test_retention_and_mirror(tmp_path):
    mirror = tmp_path / "mirror"
    resdir = _saved_run(tmp_path, ("--keep-checkpoints", "2",
                                   "--checkpoint-mirror", str(mirror)))
    names = sorted(p.name for p in resdir.glob("checkpoint-*"))
    assert names == ["checkpoint-4", "checkpoint-6"]
    assert sorted(p.name for p in mirror.glob("checkpoint-*")) == names
    for name in names:
        assert (mirror / name).read_bytes() == (resdir / name).read_bytes()
    manifest = checkpoint.read_manifest(resdir)
    assert [e["step"] for e in manifest["checkpoints"]] == [4, 6]
    assert manifest == jax_checkpoint.read_manifest(resdir)
    # The mirror wins when the primary lost its newest copy
    (resdir / "checkpoint-6").unlink()
    assert checkpoint.find_latest_valid_any((resdir, mirror)) == mirror / "checkpoint-6"


def test_checkpoint_flag_checks():
    with pytest.raises(utils.UserException, match="requires '--result-directory'"):
        driver.run(["--device", "cpu", "--auto-resume", "--nb-steps", "1"])
    with pytest.raises(utils.UserException, match="mutually exclusive"):
        driver.run(["--device", "cpu", "--auto-resume", "--load-checkpoint", "x",
                    "--result-directory", "r", "--nb-steps", "1"])
    with pytest.raises(utils.UserException, match="negative checkpoint retention"):
        driver.run(["--device", "cpu", "--keep-checkpoints", "-1",
                    "--nb-steps", "1"])


# --------------------------------------------------------------------------- #
# Kill and resume

# empire-cnn (dropout: a resume must restore the key tree) at n = 5, f = 1,
# single-threaded children (the test runs beside other test workers)
RESUME = ["--device", "cpu", *BASE, *CIFAR, "--nb-workers", "5",
          "--nb-decl-byz", "1", "--nb-real-byz", "1", "--gar", "median",
          "--nb-steps", "6", "--auto-resume"]


def _spawn(resdir, **env):
    env = {**os.environ, **SYNTH, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           **{key: str(value) for key, value in env.items()}}
    return subprocess.run(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch", *RESUME,
         "--result-directory", str(resdir)],
        cwd=str(resdir.parent), env=env, capture_output=True, text=True,
        timeout=600, check=False)


def _strip_recovery(rows):
    return [row.rsplit("\t", len(RECOVERY_COLUMNS))[0] for row in rows]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """One uninterrupted run of RESUME, shared by the kill cases."""
    full = tmp_path_factory.mktemp("resume") / "full"
    full.parent.mkdir(parents=True, exist_ok=True)
    with pytest.MonkeyPatch.context() as patch:
        for key, value in SYNTH.items():
            patch.setenv(key, value)
        proc = _spawn(full)
    assert proc.returncode == 0, proc.stderr
    return full


@pytest.mark.parametrize("kill", ("torn-write", "sigkill"))
def test_killed_run_resumes_to_the_uninterrupted_csvs(tmp_path, uninterrupted,
                                                      kill):
    full = uninterrupted
    part = tmp_path / "part"
    if kill == "torn-write":
        proc = _spawn(part, BMT_CHAOS_TORN_CHECKPOINT_STEP=4)
        assert proc.returncode == 137
        assert (part / "checkpoint-4.tmp").is_file()
        assert not (part / "checkpoint-4").exists()
    else:
        proc = _spawn(part, BMT_CHAOS_KILL_AT_STEP=5)
        assert proc.returncode == -9
        newest = checkpoint.find_latest_valid(part)
        assert newest.name == "checkpoint-4"
        raw = newest.read_bytes()
        newest.write_bytes(raw[:len(raw) // 2])
    survivor = "checkpoint-2"
    assert checkpoint.find_latest_valid(part).name == survivor
    proc = _spawn(part)
    assert proc.returncode == 0, proc.stderr
    assert f"from {survivor}" in proc.stdout
    assert (part / "eval").read_bytes() == (full / "eval").read_bytes()
    part_rows, full_rows = _rows(part, "study"), _rows(full, "study")
    assert _strip_recovery(part_rows) == _strip_recovery(full_rows)
    assert (part / "study").read_text().split(os.linesep)[0] == \
        (full / "study").read_text().split(os.linesep)[0]
    restarts = [row.split("\t")[-1] for row in part_rows]
    assert restarts == ["0"] * 2 + ["1"] * 4
    assert {row.split("\t")[-1] for row in full_rows} == {"0"}
    assert (part / "checkpoint-6").read_bytes() == (full / "checkpoint-6").read_bytes()


# --------------------------------------------------------------------------- #
# Sampler state

def test_sampler_state_round_trips_and_matches_jax():
    train, _ = data.make_datasets("cifar10", 100, 48, seed=5)
    jtrain, _ = jax_data.make_datasets("cifar10", 100, 48, seed=5)
    for _ in range(3):  # crosses the 256-image epoch boundary
        train.sample_indices(), train.sample_flips()
        jtrain.sample_indices(), jtrain.sample_flips()
    snapshot = train.get_state()
    assert snapshot == jtrain.get_state()
    want = [train.sample_indices() for _ in range(4)]
    train.set_state(snapshot)
    got = [train.sample_indices() for _ in range(4)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # A bad cursor or order is refused, and the sampler is left as it was
    before = train.get_state()
    for bad in ({**snapshot, "cursor": 256}, {**snapshot, "order": [0, 1]}):
        with pytest.raises(utils.UserException):
            train.set_state(bad)
        assert train.get_state() == before
