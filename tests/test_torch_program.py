"""Fused dispatch in the port (`--steps-per-program`, `engine/program.py`,
`--device-gar`), on the CPU at a small size (synthetic MNIST and
FashionMNIST, `simples-full`, n = 11 as in `tests/test_torch_attack_cli.py`).

* Chunking leaves the run unchanged: the port's driver at M = 1, 3 and 8
  writes byte-equal study and eval CSVs and checkpoints (evaluation
  delta 5, checkpoint delta 4, 11 steps: chunks end at the milestones).
* At the default M = 8 the port tracks the JAX driver on a flipped split
  (FashionMNIST, whose train transform flips) across an epoch boundary,
  within `tests/test_torch_seed_driver.py`'s `simples-full` bounds, and M
  = 1 and M = 8 write other rows there in both packages: a chunk draws
  every index row before any flip row, so where an epoch ends inside a
  chunk the flips come from another place of the shared generator.
* No host read inside a step: `Engine.train_multi_indexed` runs a chunk
  with `Tensor.item`, `__float__`, `__int__`, `__bool__`, `__index__`,
  `tolist` and `numpy` raising, on Bulyan under the `factor:-16` search,
  Krum under `little`, `alie-warmup`, Brute at n = 7, Median in bf16, k =
  2 local steps, the study metrics on; its columns come back stacked
  `[M]`.
* `--device-gar cpu` (with `--device cpu`): the hop step writes the fused
  path's CSVs byte for byte, forces M = 1 with the JAX driver's message
  and counts its hops.
* The learning rate as a 0-d tensor gives the update and the Nesterov
  lookahead the bits of the rounded Python float, in f32, bf16 and f16.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu_torch import optim
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import program
from byzantinemomentum_tpu_torch.utils import weak_scalar

COMMON = ["--device", "cpu", "--seed", "2", "--model", "simples-full",
          "--dataset", "mnist", "--nb-workers", "11", "--nb-decl-byz", "4",
          "--nb-real-byz", "4", "--batch-size", "8", "--batch-size-test",
          "16", "--batch-size-test-reps", "2", "--learning-rate", "0.1",
          "--nb-for-study", "1", "--nb-for-study-past", "2"]


@pytest.fixture(autouse=True)
def small_sets(monkeypatch):
    """Small synthetic splits, and one intra-op thread: these runs are
    many small operations, which a thread pool only slows where the
    other test workers hold the cores."""
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "256")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(resdir):
    return {path.name: path.read_bytes() for path in sorted(resdir.iterdir())
            if path.name in ("study", "eval") or path.name.startswith("checkpoint-")}


def _rows(resdir):
    lines = (resdir / "study").read_text().split(os.linesep)
    return [line.split("\t") for line in lines[1:] if line]


def test_chunking_leaves_the_run_unchanged(tmp_path):
    """Median under an `empire` search (`factor:-3`, 3 probes a step) with
    a learning-rate decay every step: M = 1, 3 and 8 write the same bytes;
    the engine's counts show the chunks the milestones cut, a chunk of
    one step counting no multi-step dispatch (M = 3: 0-3, 3-4, 4-5, 5-8,
    8-10, 10-11; M = 8: 0-4, 4-5, 5-8, 8-10, 10-11)."""
    argv = [*COMMON, "--gar", "median", "--attack", "empire",
            "--attack-args", "factor:-3", "--nb-steps", "11",
            "--evaluation-delta", "5", "--checkpoint-delta", "4",
            "--learning-rate-decay", "3"]
    files, counts = {}, {}
    for M in (1, 3, 8):
        summary = driver.run([*argv, "--steps-per-program", str(M),
                              "--result-directory", str(tmp_path / str(M))])
        files[M], counts[M] = _files(tmp_path / str(M)), summary["counts"]
        assert summary["steps"] == 11
    assert sorted(files[8]) == ["checkpoint-0", "checkpoint-4", "checkpoint-8",
                                "eval", "study"]
    assert files[1] == files[3] == files[8]
    assert len(_rows(tmp_path / "8")) == 11
    assert counts[1] == {"indexed_steps": 11, "grouped_phases": 11,
                         "indexed_evals": 3}
    assert counts[3] == {**counts[1], "multi_dispatches": 3}
    assert counts[8] == {**counts[1], "multi_dispatches": 3}


FLIPPED = ["--device", "cpu", "--seed", "4", "--nb-steps", "8", "--nb-workers",
           "11", "--nb-decl-byz", "2", "--nb-real-byz", "2",
           "--batch-size-test", "16", "--batch-size-test-reps", "2",
           "--evaluation-delta", "8", "--nb-for-study", "1",
           "--nb-for-study-past", "2", "--model", "simples-full", "--dataset",
           "fashionmnist", "--batch-size", "8", "--gar", "median", "--attack",
           "empire", "--attack-args", "factor:1.1", "--learning-rate", "0.1"]


def test_port_tracks_jax_at_the_default_chunk_on_flipped_data(tmp_path):
    """256 train images in batches of 8 are 32 batches an epoch, and a
    step draws S = 10: the first epoch ends inside the 8-step chunk."""
    rows = {}
    for name, run in (("jax", jax_main), ("port", driver.run)):
        for M in (1, 8):
            resdir = tmp_path / f"{name}{M}"
            extra = () if M == 8 else ("--steps-per-program", "1")
            out = run([*FLIPPED, *extra, "--result-directory", str(resdir)])
            assert out == 0 if name == "jax" else out["steps"] == 8
            rows[name, M] = _rows(resdir)
    for M in (1, 8):
        want, got = rows["jax", M], rows["port", M]
        assert [row[:2] for row in got] == [row[:2] for row in want]
        want = np.array([[float(v) for v in row[2:]] for row in want])
        got = np.array([[float(v) for v in row[2:]] for row in got])
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4,
                                   atol=1e-6)
    for name in ("jax", "port"):
        # The epoch's reshuffle draws between the index rows, so every
        # flip row of the chunk moves, the first step's too
        assert [row[2] for row in rows[name, 1]] != [
            row[2] for row in rows[name, 8]], name


# --------------------------------------------------------------------------- #
# No host read inside a step

READS = ("item", "__float__", "__int__", "__bool__", "__index__", "tolist",
         "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Every way a tensor's value reaches the host raises meanwhile."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"host read: Tensor.{name}")
        return read

    try:
        for name in READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


NO_READS = {
    "bulyan-search": ["--nb-decl-byz", "2", "--nb-real-byz", "2", "--gar",
                      "bulyan", "--attack", "empire"],
    "krum-little": ["--gar", "krum", "--attack", "little", "--attack-args",
                    "factor:1.5", "negative:true"],
    "alie-warmup": ["--gar", "krum", "--attack", "alie-warmup",
                    "--attack-args", "window:2"],
    "brute-n7": ["--nb-workers", "7", "--nb-decl-byz", "2", "--nb-real-byz",
                 "2", "--gar", "brute", "--attack", "empire", "--attack-args",
                 "factor:1.1"],
    "median-bf16": ["--gar", "median", "--attack", "little", "--attack-args",
                    "factor:-4", "negative:true", "--dtype", "bfloat16"],
    "local-steps-2": ["--gar", "median", "--attack", "empire",
                      "--attack-args", "factor:1.1", "--nb-local-steps", "2",
                      "--momentum-nesterov"],
}


@pytest.mark.parametrize("case", sorted(NO_READS))
def test_no_host_read_inside_a_step(tmp_path, case):
    args = driver._postprocess(driver.process_commandline(
        [*COMMON, *NO_READS[case], "--result-directory", str(tmp_path)]))
    _, engine, state = driver._setup(args)
    M = 3
    idx, flips = engine.sample_indices(M)
    lrs = np.full(M, 0.1, np.float32)
    with no_host_reads():
        state, metrics = engine.train_multi_indexed(state, idx, flips, lrs)
    assert set(metrics) == set(driver.STUDY_COLUMNS[2:])
    assert all(value.shape == (M,) for value in metrics.values())
    assert state.past_count.dtype == torch.int32 and int(state.past_count) == 2
    if case == "alie-warmup":
        assert int(state.attack_state) == M
    assert engine.counts["multi_dispatches"] == 1
    assert engine.counts["indexed_steps"] == M


def test_train_multi_is_m_single_steps(tmp_path):
    """`Engine.train_multi` on a chunk's gathered batches and per-step
    rates gives the state and the stacked columns of M `train_step`
    calls, bit for bit (Krum against the stateful `alie-warmup`)."""
    args = driver._postprocess(driver.process_commandline(
        [*COMMON, *NO_READS["alie-warmup"], "--result-directory",
         str(tmp_path)]))
    _, engine, state = driver._setup(args)
    idx, flips = engine.sample_indices(3)
    data = engine.train_data
    xs, ys = data.gather(*data.upload(idx, flips))
    lrs = np.asarray([0.1, 0.05, 0.025], np.float32)
    multi, stacked = engine.train_multi(state, xs, ys, lrs)
    single, rows = state, []
    for i in range(3):
        single, metrics = engine.train_step(single, xs[i], ys[i],
                                            torch.tensor(lrs[i]))
        rows.append(metrics)
    assert torch.equal(multi.theta, single.theta)
    assert torch.equal(multi.attack_state, single.attack_state)
    for column, values in stacked.items():
        want = torch.stack([torch.as_tensor(row[column], dtype=values.dtype)
                            for row in rows])
        assert torch.equal(values.isnan(), want.isnan()), column
        assert torch.equal(values.nan_to_num(), want.nan_to_num()), column
    assert engine.counts["multi_dispatches"] == 1


# --------------------------------------------------------------------------- #
# --device-gar

def test_device_gar_cpu_hop_writes_the_fused_csvs(tmp_path, capsys):
    """Krum against the stateful `alie-warmup` (the counter hops with the
    rows) and the default search of `empire` are exercised by the fused
    path's tests; here Krum under `little` with worker momentum."""
    argv = [*COMMON, "--gar", "krum", "--attack", "alie-warmup",
            "--attack-args", "window:2", "--momentum-at", "worker",
            "--nb-steps", "5", "--evaluation-delta", "4"]
    fused = driver.run([*argv, "--result-directory", str(tmp_path / "fused")])
    capsys.readouterr()
    hop = driver.run([*argv, "--device-gar", "cpu", "--result-directory",
                      str(tmp_path / "hop")])
    out = capsys.readouterr().out
    assert ("'--device-gar' hops devices every step; multi-step fusion "
            "disabled") in out
    assert _files(tmp_path / "hop") == _files(tmp_path / "fused")
    assert fused["counts"]["multi_dispatches"] == 1  # steps 0-4, then 4
    assert hop["counts"] == {"indexed_steps": 5, "grouped_phases": 5,
                             "device_gar_steps": 5, "indexed_evals": 2}
    with pytest.raises(ValueError):
        program.build_step(object(), gar_device="cpu", multi=True)
    with pytest.raises(NotImplementedError):
        program.build_step(object(), mesh=object())


def test_device_gar_tracks_jax_in_its_host_order_on_flipped_data(tmp_path):
    """Under `--device-gar cpu` both drivers draw each batch's indices,
    then its flips (the JAX driver through `Dataset.sample`): on
    `FLIPPED`, where the first epoch ends inside step 3 (batches 30-39),
    the port tracks the JAX driver at the seed-driver bounds, and its rows
    differ from its own single steps, which draw every index row first."""
    rows = {}
    for name, run, extra in (
            ("jax", jax_main, ("--device-gar", "cpu")),
            ("port", driver.run, ("--device-gar", "cpu")),
            ("port1", driver.run, ("--steps-per-program", "1"))):
        resdir = tmp_path / name
        out = run([*FLIPPED, *extra, "--result-directory", str(resdir)])
        assert out == 0 if name == "jax" else out["steps"] == 8
        rows[name] = _rows(resdir)
    want, got = rows["jax"], rows["port"]
    assert [row[:2] for row in got] == [row[:2] for row in want]
    want = np.array([[float(v) for v in row[2:]] for row in want])
    got = np.array([[float(v) for v in row[2:]] for row in got])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-6)
    column = [row[2] for row in rows["port"]]
    assert column[:3] == [row[2] for row in rows["port1"]][:3]
    assert column[3:] != [row[2] for row in rows["port1"]][3:]


def test_device_gar_checks():
    with pytest.raises(driver.utils.UserException, match="Invalid '--device-gar"):
        driver._setup(driver._postprocess(driver.process_commandline(
            [*COMMON, "--device-gar", "tpu"])))


# --------------------------------------------------------------------------- #
# The learning rate as a device tensor

@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
def test_tensor_lr_gives_the_float_lr_bits(dtype):
    """`optim.sgd`'s update and the Nesterov lookahead `mu * lr` with the
    learning rate as a 0-d tensor in the parameter dtype (the engine's
    `round_lr`) equal those with the same rounded value as a Python
    float (the previous form), over several rates and weight decays."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    theta = torch.randn(4096, generator=gen).to(dt)
    grad = torch.randn(4096, generator=gen).to(dt)
    for lr in (0.1, 0.01, 0.02, 0.004, 0.5 / 3.0, 1e-4):
        lr_f = weak_scalar(float(np.float32(lr)), dt)
        lr_t = torch.tensor(np.float32(lr)).to(dt)
        assert float(lr_t) == lr_f
        for wd in (0.0, 5e-4, 1e-2):
            update = optim.build("sgd", weight_decay=wd).update
            got, _ = update(grad, (), theta, lr_t)
            want, _ = update(grad, (), theta, lr_f)
            assert got.dtype == dt
            assert torch.equal(got.view(torch.int16 if dt != torch.float32
                                        else torch.int32),
                               want.view(torch.int16 if dt != torch.float32
                                         else torch.int32))
        mu = weak_scalar(0.99, dt)
        mu_lr = mu * lr_t
        assert float(mu_lr) == weak_scalar(mu * lr_f, dt)
        assert torch.equal(theta - mu_lr * grad,
                           theta - weak_scalar(mu * lr_f, dt) * grad)
