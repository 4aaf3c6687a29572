"""The paper's appendix grid (`reproduce-appendix.py::submit`, WRN-28-10 on
CIFAR-10) and `BASELINE.md` config 5 through the PyTorch port's driver, in
process on the CPU (small synthetic sets).

* Every command line that `reproduce-appendix.py::submit` writes parses in
  the port's driver with its flags unchanged (`wide_resnet-Wide_ResNet`
  with `depth:28 widen_factor:10 dropout_rate:0.3 num_classes:10`), and
  so does config 5 (`--gar aksel --nb-local-steps 2 --gradient-clip 5`).
* One line, `cifar10-empire-bulyan-f_2-lr_pow-at_update-nesterov`, at
  `depth:10 widen_factor:1` and cut to 2 steps with small test batches,
  runs in both drivers from `--seed 1` alone with `--nb-local-steps` 1
  and 2: the study CSVs carry the JAX header and track each other
  (`tests/test_torch_seed_driver.py`'s empire-cnn bounds: rtol 1e-4,
  atol 1e-5, the cosine and curvature columns rtol 2e-3), the eval rows
  are equal, the training-point column counts `batch * h * k` a step,
  and the port takes the grouped honest phase at one local step and the
  vmapped one at two.
* Checkpoints of that WRN round-trip in both directions: the two
  drivers' `checkpoint-0` are byte-equal, and each package loads the
  other's `checkpoint-2` into its own state: the same values, the nested
  block names (`g0b0.bn1.mean`, ...) included.
* Config 5 at `depth:10 widen_factor:1` runs in the port: Aksel at
  f = 2, two local steps, the vmapped honest phase.
* `chip_smoke.py`'s WRN cells are these lines as the grid writes them.
"""

import importlib.util
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import attacks as jax_attacks
from byzantinemomentum_tpu import checkpoint as jax_checkpoint
from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.cli import attack as jax_driver
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu_torch import checkpoint, convert
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import STUDY_COLUMNS

from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "cifar10-empire-bulyan-f_2-lr_pow-at_update-nesterov"
# The grid's runner adds the seed; the rest cuts the runs to size
SMALL = ["--seed", "1", "--batch-size-test", "16", "--batch-size-test-reps",
         "2", "--nb-steps", "2", "--checkpoint-delta", "2"]
FULL_WIDTH = ["depth:28", "widen_factor:10", "dropout_rate:0.3",
              "num_classes:10"]
CUT = ["depth:10", "widen_factor:1", "dropout_rate:0.3", "num_classes:10"]
# Every batch of the runs below within the first epoch, so the two
# drivers' batch orders agree whatever their dispatch groups
SYNTH = {"BMT_SYNTH_TRAIN": "1024", "BMT_SYNTH_TEST": "64"}


def _appendix_grid():
    """`{name: driver flags}` of every run `reproduce-appendix.py::submit`
    writes."""
    spec = importlib.util.spec_from_file_location(
        "reproduce_appendix", ROOT / "reproduce-appendix.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    class Jobs:
        def __init__(self):
            self.commands = {}

        def submit(self, name, command):
            self.commands[name] = command[2:]  # after python and attack.py

    jobs = Jobs()
    module.submit(jobs)
    return jobs.commands


def _cut(argv):
    """The flags with WRN-28-10 cut to depth 10, widen 1."""
    argv = list(argv)
    at = argv.index("--model-args")
    assert argv[at + 1:at + 5] == FULL_WIDTH
    argv[at + 1:at + 5] = CUT
    return argv


def _baseline5(argv):
    """`BASELINE.md` config 5 on an appendix line: Aksel, two local steps,
    clip 5."""
    return [*argv, "--gar", "aksel", "--nb-local-steps", "2",
            "--gradient-clip", "5"]


def test_every_appendix_line_parses():
    grid = _appendix_grid()
    # f = 4: average and 2 GARs, f = 2: average and 3 GARs; each GAR
    # against 2 attacks at 2 momentum placements
    assert len(grid) == (1 + 2 * 4) + (1 + 3 * 4)
    for name, argv in {**grid, "baseline5": _baseline5(grid[CELL])}.items():
        args = driver._postprocess(driver.process_commandline(argv))
        assert args.model == "wide_resnet-Wide_ResNet"
        assert args.model_args == {"depth": 28, "widen_factor": 10,
                                   "dropout_rate": 0.3, "num_classes": 10}
        assert (args.batch_size, args.loss, args.momentum) == (20, "crossentropy", 0.99)
        assert args.momentum_nesterov and args.l2_regularize == 5e-4
        assert args.nb_local_steps == (2 if name == "baseline5" else 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers on the cut cell at one and two local steps: `{k: (JAX
    result directory, port result directory, port summary)}`."""
    saved = {key: os.environ.get(key) for key in SYNTH}
    os.environ.update(SYNTH)
    try:
        out = {}
        for k in (1, 2):
            argv = ["--device", "cpu", *_cut(_appendix_grid()[CELL]), *SMALL,
                    "--nb-local-steps", str(k)]
            tmp = tmp_path_factory.mktemp(f"k{k}")
            assert jax_driver.main([*argv, "--result-directory",
                                    str(tmp / "jax")]) == 0
            summary = driver.run([*argv, "--result-directory", str(tmp / "port")])
            out[k] = (tmp / "jax", tmp / "port", summary, argv)
        yield out
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _rows(resdir, name):
    lines = (resdir / name).read_text().split(os.linesep)
    return lines[0], [line.split("\t") for line in lines[1:] if line]


@pytest.mark.parametrize("k", (1, 2))
def test_appendix_line_tracks_the_jax_driver(runs, k):
    jdir, pdir, summary, argv = runs[k]
    assert summary["steps"] == 2
    path = "grouped_phases" if k == 1 else "vmapped_phases"
    assert summary["counts"] == {"indexed_steps": 2, path: 2, "indexed_evals": 1,
                                 "multi_dispatches": 1}
    (jheader, want), (header, got) = _rows(jdir, "study"), _rows(pdir, "study")
    assert header == jheader == "# " + "\t".join(STUDY_COLUMNS)
    assert [row[:2] for row in got] == [row[:2] for row in want]
    args = driver.process_commandline(argv)
    honests = args.nb_workers - args.nb_real_byz
    assert [int(row[1]) for row in got] == [
        step * args.batch_size * honests * k for step in range(2)]
    want = np.array([[float(v) for v in row[2:]] for row in want])
    got = np.array([[float(v) for v in row[2:]] for row in got])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    for i, column in enumerate(STUDY_COLUMNS[2:]):
        finite = np.isfinite(want[:, i])
        loose = "cosine" in column or "curvature" in column
        np.testing.assert_allclose(got[finite, i], want[finite, i],
                                   rtol=2e-3 if loose else 1e-4, atol=1e-5,
                                   err_msg=column)
    assert _rows(pdir, "eval") == _rows(jdir, "eval")


def _jax_template(args):
    """A fresh JAX `TrainState` of the parsed port flags `args` (the load
    template: shapes and dtypes)."""
    cfg = JaxConfig(
        nb_workers=args.nb_workers, nb_decl_byz=args.nb_decl_byz,
        nb_real_byz=args.nb_real_byz, nb_for_study=args.nb_for_study,
        nb_for_study_past=args.nb_for_study_past, momentum=args.momentum,
        momentum_at=args.momentum_at, nesterov=args.momentum_nesterov)
    engine = build_engine(
        cfg=cfg, model_def=jax_models.build(args.model, **args.model_args),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars[args.gar], 1.0, {})],
        attack=jax_attacks.attacks[args.attack], attack_kwargs={"factor": 1.1})
    return engine.init(jax.random.PRNGKey(args.seed))


def test_wrn_checkpoints_round_trip_both_ways(runs):
    jdir, pdir, _, argv = runs[1]
    assert (pdir / "checkpoint-0").read_bytes() == (jdir / "checkpoint-0").read_bytes()
    # The JAX checkpoint into the port's state and the port's into JAX's
    args = driver._postprocess(driver.process_commandline(
        [*argv, "--result-directory", str(pdir)]))
    _, _, fresh = driver._setup(args)
    jtemplate = _jax_template(args)
    ours = checkpoint.load(jdir / "checkpoint-2", fresh)
    theirs = jax_checkpoint.load(pdir / "checkpoint-2", jtemplate)
    mine = checkpoint.load(pdir / "checkpoint-2", fresh)
    jax_own = jax_checkpoint.load(jdir / "checkpoint-2", jtemplate)
    assert ours.steps == int(theirs.steps) == 2
    for got, want in ((ours, jax_own), (mine, theirs)):
        assert torch.equal(got.theta, torch.from_numpy(np.asarray(want.theta)))
        assert torch.equal(got.rng, torch.from_numpy(
            np.asarray(want.rng).astype(np.int64)))
        names = dict(convert.flat_items(jax.tree.map(np.asarray, want.net_state)))
        assert sorted(names) == sorted(got.net_state)
        assert "g0b0.bn1.mean" in names and "g2b0.shortcut.w" not in names
        for name, value in names.items():
            assert torch.equal(got.net_state[name], torch.from_numpy(value))
    # The two runs' own checkpoints hold the tracked states
    np.testing.assert_allclose(mine.theta.numpy(), np.asarray(jax_own.theta),
                               rtol=1e-4, atol=1e-5)


def test_baseline_config_5_runs(tmp_path, monkeypatch):
    for key, value in SYNTH.items():
        monkeypatch.setenv(key, value)
    argv = ["--device", "cpu", *_baseline5(_cut(_appendix_grid()[CELL])),
            "--batch-size-test", "16", "--batch-size-test-reps", "2",
            "--nb-steps", "1", "--batch-size", "4", "--result-directory",
            str(tmp_path)]
    summary = driver.run(argv)
    assert summary["counts"] == {"indexed_steps": 1, "vmapped_phases": 1,
                                 "indexed_evals": 1}
    _, rows = _rows(tmp_path, "study")
    assert len(rows) == 1 and np.isfinite(
        float(rows[0][STUDY_COLUMNS.index("Defense gradient norm")]))


def test_chip_smoke_wrn_cells_are_the_appendix_lines():
    """`chip_smoke.py` drives the appendix grid's cells with the flags of
    `reproduce-appendix.py::submit`, unchanged; `wrn28x10_mixed` is the
    Bulyan line under `--dtype float32 --compute-dtype bfloat16` and
    `baseline_wrn_aksel` the same line with config 5's flags."""
    import chip_smoke
    grid = _appendix_grid()
    cells = {cell.name: cell for cell in chip_smoke.CELLS if cell.family == "wrn"}
    assert sorted(cells) == sorted([
        CELL, "wrn28x10_mixed", "baseline_wrn_aksel",
        "cifar10-little-median-f_4-lr_pow-at_worker-nesterov",
        "cifar10-empire-krum-f_4-lr_pow-at_update-nesterov"])
    for name, cell in cells.items():
        if name in grid:
            assert list(cell.argv) == grid[name], name
    assert list(cells["wrn28x10_mixed"].argv) == [
        *grid[CELL], "--dtype", "float32", "--compute-dtype", "bfloat16"]
    assert list(cells["baseline_wrn_aksel"].argv) == [
        *grid[CELL], "--gar", "aksel", "--nb-local-steps", "2"]
    assert cells["baseline_wrn_aksel"].per_step == {
        ("lower_median", torch.float32): 2, ("split_keys", torch.int64): 2,
        ("bernoulli_masks", torch.bool): 24}
