"""The PyTorch port's driver on its defaults, the paper's MNIST grid and the
phishing line, in process on the CPU (small synthetic sets).

* The driver's defaults (`mnist`, `simples-conv`, 11 workers, f = 4,
  `average`, the `nan` attack with no real Byzantine worker) run with
  only `--device cpu --nb-steps 3` and small batch flags: every step and
  evaluation on the device-resident batches, every honest phase grouped,
  and the `eval` and `study` headers byte-equal to the JAX driver's
  (`_ResultFiles`). Without `--device cpu` and without a card they
  raise.
* Every command line that `reproduce.py::submit_mnist` writes parses in
  the port's driver with its flags unchanged, and one of them
  (`mnist-little-bulyan-f_12-lr_0.5-at_worker-nesterov`, 51 workers)
  runs, cut to 3 steps with small test batches, as do a `nan` cell of
  the grid (Krum at f = 24) and the phishing line (`simples-logit`,
  `bce`, the `sigmoid` criterion, float (B, 1) labels).
* A flag of the JAX driver that the port still lacks is refused by
  name.
"""

import os

import numpy as np
import pytest

import reproduce
from byzantinemomentum_tpu.cli.attack import _ResultFiles as JaxResultFiles
from byzantinemomentum_tpu.engine import STUDY_COLUMNS as JAX_STUDY_COLUMNS
from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import STUDY_COLUMNS

from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = ["--batch-size-test", "16", "--batch-size-test-reps", "2"]


@pytest.fixture(autouse=True)
def small_sets(monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "300")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")


def _mnist_grid():
    """`{name: driver flags}` of every run `reproduce.py::submit_mnist`
    writes."""
    class Jobs:
        def __init__(self):
            self.commands = {}

        def submit(self, name, command):
            self.commands[name] = command[2:]  # after python and attack.py

    jobs = Jobs()
    reproduce.submit_mnist(jobs)
    return jobs.commands


def _run(tmp_path, argv):
    """Run the driver in process; check its headers against the JAX
    driver's and return (summary, study rows)."""
    resdir = tmp_path / "run"
    summary = driver.run(["--device", "cpu", "--seed", "1", *argv,
                          "--result-directory", str(resdir)])
    want = tmp_path / "want"
    want.mkdir()
    ref = JaxResultFiles(want)
    ref.make("eval", "Step number", "Cross-accuracy")
    ref.make("study", *JAX_STUDY_COLUMNS)
    ref.close()
    assert STUDY_COLUMNS == JAX_STUDY_COLUMNS
    for name in ("eval", "study"):
        header = (want / name).read_text()
        assert (resdir / name).read_text().split(os.linesep)[0] == header
    rows = [row.split("\t") for row in
            (resdir / "study").read_text().split(os.linesep)[1:]]
    assert [int(row[0]) for row in rows] == list(range(summary["steps"]))
    col = STUDY_COLUMNS.index("Defense gradient norm")
    assert np.all(np.isfinite([float(row[col]) for row in rows]))
    return summary, rows


def test_driver_defaults_on_cpu(tmp_path):
    summary, rows = _run(tmp_path, ["--nb-steps", "3", "--batch-size", "8",
                                    *SMALL])
    assert summary["counts"] == {"indexed_steps": 3, "grouped_phases": 3,
                                 "indexed_evals": 1, "multi_dispatches": 1}
    args = driver._postprocess(driver.process_commandline([]))
    assert (args.dataset, args.model, args.attack, args.gar, args.nb_workers,
            args.nb_decl_byz, args.nb_real_byz) == (
                "mnist", "simples-conv", "nan", "average", 11, 4, 0)
    # No real Byzantine worker: the attack columns are NaN
    col = STUDY_COLUMNS.index("Attack gradient norm")
    assert all(row[col] == "nan" for row in rows)
    with pytest.raises(utils.UserException, match="--device cpu"):
        driver.run(["--nb-steps", "1"])


def test_every_mnist_grid_line_parses():
    grid = _mnist_grid()
    # (dataset, lr, nesterov) x (average at f = 24 and 12, then 5 GARs at
    # f = 24 and 6 at f = 12, each against 2 attacks at 2 placements)
    assert len(grid) == 2 * 2 * 2 * (2 + (5 + 6) * 2 * 2)
    for name, argv in grid.items():
        args = driver._postprocess(driver.process_commandline(argv))
        assert args.model == "simples-full" and args.dataset in name


@pytest.mark.parametrize("name", (
    "mnist-little-bulyan-f_12-lr_0.5-at_worker-nesterov",
    "fashionmnist-nan-krum-f_24"))
def test_mnist_grid_cell_on_cpu(tmp_path, name):
    grid = _mnist_grid()
    if name.endswith("nan-krum-f_24"):
        # The grid's flags with the nan attack
        argv = [*grid["fashionmnist-empire-krum-f_24-lr_0.5-at_update"]]
        at = argv.index("--attack")
        assert argv[at:at + 4] == ["--attack", "empire", "--attack-args",
                                   "factor:1.1"]
        argv[at:at + 4] = ["--attack", "nan"]
    else:
        argv = grid[name]
    argv = [*argv, "--nb-steps", "3", *SMALL]
    summary, rows = _run(tmp_path, argv)
    args = driver.process_commandline(argv)
    assert (args.nb_workers, args.nb_steps, args.evaluation_delta) == (51, 3, 5)
    assert summary["counts"] == {"indexed_steps": 3, "grouped_phases": 3,
                                 "indexed_evals": 1, "multi_dispatches": 1}
    col = STUDY_COLUMNS.index("Attack gradient norm")
    assert all((row[col] == "nan") == (args.attack == "nan") for row in rows)


def test_phishing_line_on_cpu(tmp_path):
    argv = ["--dataset", "phishing", "--model", "simples-logit", "--loss",
            "bce", "--criterion", "sigmoid", "--gar", "krum", "--nb-workers",
            "11", "--nb-decl-byz", "4", "--nb-real-byz", "4", "--attack",
            "empire", "--attack-args", "factor:1.1", "--nb-steps", "3",
            "--evaluation-delta", "3", *SMALL]
    summary, rows = _run(tmp_path, argv)
    assert summary["counts"] == {"indexed_steps": 3, "grouped_phases": 3,
                                 "indexed_evals": 2, "multi_dispatches": 1}
    assert all(0.0 <= float(row[-1]) <= 1.0 for row in rows)
    evals = (tmp_path / "run" / "eval").read_text().split(os.linesep)[1:]
    assert [line.split("\t")[0] for line in evals] == ["0", "3"]
    assert all(0.0 <= float(line.split("\t")[1]) <= 1.0 for line in evals)


def test_dataset_args_reach_the_loader(tmp_path, capsys):
    summary, _ = _run(tmp_path, ["--dataset", "emnist", "--dataset-args",
                                 "split:digits", "--model", "simples-full",
                                 "--nb-steps", "2", "--batch-size", "8",
                                 *SMALL])
    assert summary["steps"] == 2
    with pytest.raises(utils.UserException, match="Unknown EMNIST split 'nope'"):
        driver.run(["--device", "cpu", "--dataset", "emnist", "--dataset-args",
                    "split:nope", "--nb-steps", "1"])
    with pytest.raises(SystemExit):
        driver.process_commandline(["--mesh", "2x1"])
    assert "unrecognized arguments: --mesh" in capsys.readouterr().err


def test_chip_smoke_grid_cells_are_the_reproduce_lines():
    """`chip_smoke.py` drives the MNIST grid's cells with the flags of
    `reproduce.py::submit_mnist`, unchanged; its `nan` cells are the
    grid's `empire` lines with `--attack nan` and no attack arguments
    (its other MNIST cells, on BASELINE.md's flags, are not grid
    lines)."""
    import chip_smoke
    grid = _mnist_grid()
    names = [cell.name for cell in chip_smoke.CELLS
             if cell.name in grid or "-nan-" in cell.name]
    assert len(names) == 13
    for cell in chip_smoke.CELLS:
        if cell.name not in names:
            continue
        if "-nan-" in cell.name:
            want = list(grid[cell.name.replace("-nan-", "-empire-")])
            at = want.index("--attack")
            want[at:at + 4] = ["--attack", "nan"]
        else:
            want = grid[cell.name]
        assert list(cell.argv) == want, cell.name
