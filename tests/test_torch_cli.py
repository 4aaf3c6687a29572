"""The PyTorch port's driver, data pipeline and package boundary.

* The driver runs the headline configuration (Bulyan against
  `empire(1.1)`, `empire-cnn`, momentum 0.99 at update, clip 5,
  nb-for-study 1) for 3 steps at n=11, f=2 on a small synthetic CIFAR-10
  with `--device cpu`; its `eval` and `study` files must carry the JAX
  driver's headers byte for byte (written here by the JAX driver's own
  `_ResultFiles`), finite rows, and be readable by `study.Session`. So do
  runs of Krum, Brute and CGE at f=4, and a `--dtype bfloat16` run, whose
  rows carry the JAX driver's "%.4e" format.
* Without `--device cpu` on a host with no card the driver must fail.
* The synthetic CIFAR-10 and the sampler's batches are bit-identical to
  the JAX package's for one seed.
* The port imports neither `jax`, `flax`, `msgpack` nor
  `byzantinemomentum_tpu`.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import study
from byzantinemomentum_tpu import data as jax_data
from byzantinemomentum_tpu.cli.attack import _ResultFiles as JaxResultFiles
from byzantinemomentum_tpu.data import sources as jax_sources
from byzantinemomentum_tpu.engine import STUDY_COLUMNS as JAX_STUDY_COLUMNS
from byzantinemomentum_tpu_torch import data
from byzantinemomentum_tpu_torch.data import sources
from byzantinemomentum_tpu_torch.engine import STUDY_COLUMNS

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "byzantinemomentum_tpu_torch"
SYNTH = {"BMT_SYNTH_TRAIN": "256", "BMT_SYNTH_TEST": "64"}
HEADLINE = ["--seed", "1", "--nb-steps", "3", "--nb-workers", "11",
            "--nb-decl-byz", "2", "--nb-real-byz", "2", "--gar", "bulyan",
            "--attack", "empire", "--attack-args", "factor:1.1",
            "--model", "empire-cnn", "--dataset", "cifar10",
            "--batch-size", "4", "--batch-size-test", "16",
            "--batch-size-test-reps", "2", "--evaluation-delta", "3",
            "--momentum", "0.99", "--momentum-at", "update",
            "--gradient-clip", "5", "--nb-for-study", "1",
            "--nb-for-study-past", "1"]


def _driver(*argv, cwd):
    env = {**os.environ, **SYNTH, "PYTHONPATH": str(ROOT)}
    return subprocess.run(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch", *argv],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600,
        check=False)


def _study_rows(tmp_path, argv):
    """Run the driver on the CPU; check its `eval` and `study` headers
    against the JAX driver's byte for byte and return the study rows."""
    resdir = tmp_path / "run"
    proc = _driver("--device", "cpu", *argv, "--result-directory",
                   str(resdir), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    want = tmp_path / "want"
    want.mkdir()
    ref = JaxResultFiles(want)
    ref.make("eval", "Step number", "Cross-accuracy")
    ref.make("study", *JAX_STUDY_COLUMNS)
    ref.close()
    assert STUDY_COLUMNS == JAX_STUDY_COLUMNS
    for name in ("eval", "study"):
        got = (resdir / name).read_text()
        header = (want / name).read_text()
        assert got.split(os.linesep)[0] == header
    rows = (resdir / "study").read_text().split(os.linesep)[1:]
    assert [int(row.split("\t")[0]) for row in rows] == [0, 1, 2]
    return resdir, rows


def test_driver_headline_cell_on_cpu(tmp_path):
    resdir, rows = _study_rows(tmp_path, HEADLINE)
    for row in rows:
        fields = row.split("\t")
        assert len(fields) == len(STUDY_COLUMNS)
        # The attack acceptation ratio is NaN (bulyan has no influence);
        # so are the past-gradient columns of step 0
        values = np.array([float(v) for v in fields[2:-3]])
        assert np.all(np.isfinite(values)), row
        assert fields[-1] == "nan"
    session = study.Session(resdir)
    assert list(session.data.index) == [0, 1, 2, 3]
    assert np.all(np.isfinite(session.data["Defense gradient norm"].dropna()))
    assert session.json["gar"] == "bulyan" and session.json["device"] == "cpu"


def test_driver_krum_on_cpu(tmp_path):
    argv = [*HEADLINE, "--nb-decl-byz", "4", "--nb-real-byz", "4",
            "--gar", "krum", "--gar-args", "m:5", "--attack", "little",
            "--attack-args", "factor:1.5", "negative:true"]
    resdir, rows = _study_rows(tmp_path, argv)
    for row in rows:
        fields = row.split("\t")
        assert len(fields) == len(STUDY_COLUMNS)
        values = np.array([float(v) for v in fields[2:-3] + fields[-1:]])
        assert np.all(np.isfinite(values)), row
        assert 0.0 <= float(fields[-1]) <= 1.0
    session = study.Session(resdir)
    assert session.json["gar"] == "krum" and session.json["gar_args"] == {"m": 5}


@pytest.mark.parametrize("gar,attack_args", (
    ("brute", ["--attack", "empire", "--attack-args", "factor:1.1"]),
    ("cge", ["--attack", "little", "--attack-args", "factor:1.5", "negative:true"])))
def test_driver_brute_and_cge_on_cpu(tmp_path, gar, attack_args):
    argv = [*HEADLINE, "--nb-decl-byz", "4", "--nb-real-byz", "4",
            "--gar", gar, *attack_args]
    resdir, rows = _study_rows(tmp_path, argv)
    for row in rows:
        fields = row.split("\t")
        assert len(fields) == len(STUDY_COLUMNS)
        values = np.array([float(v) for v in fields[2:-3] + fields[-1:]])
        assert np.all(np.isfinite(values)), row
        assert 0.0 <= float(fields[-1]) <= 1.0
    assert study.Session(resdir).json["gar"] == gar


def test_driver_bf16_on_cpu(tmp_path):
    """`--dtype bfloat16` (Median, f=2): the JAX driver's headers, every
    value but the counters and the ratio in "%.4e", finite."""
    argv = [*HEADLINE, "--gar", "median", "--dtype", "bfloat16"]
    resdir, rows = _study_rows(tmp_path, argv)
    for row in rows:
        fields = row.split("\t")
        assert len(fields) == len(STUDY_COLUMNS)
        for field in fields[2:-1]:
            assert re.fullmatch(r"-?\d\.\d{4}e[+-]\d\d|nan", field), field
        values = np.array([float(v) for v in fields[2:-3]])
        assert np.all(np.isfinite(values)), row
    session = study.Session(resdir)
    assert session.json["dtype"] == "bfloat16"
    assert session.json["compute_dtype"] is None
    proc = _driver("--device", "cpu", *HEADLINE, "--compute-dtype", "bf8",
                   cwd=tmp_path)
    assert proc.returncode != 0
    assert "Unknown dtype 'bf8', expected one of: 'bf16', 'bfloat16'" in proc.stderr


def test_driver_refuses_gars_it_lacks_or_cannot_use(tmp_path):
    proc = _driver("--device", "cpu", *HEADLINE, "--gar", "native-krum",
                   cwd=tmp_path)
    assert proc.returncode != 0
    assert "Unknown aggregation rule 'native-krum', expected one of:" in proc.stderr
    proc = _driver("--device", "cpu", *HEADLINE, "--gar", "aksel",
                   "--gar-args", "mode:bad", cwd=tmp_path)
    assert proc.returncode != 0
    assert "Invalid operation mode 'bad'" in proc.stderr


def test_driver_refuses_without_a_card_or_an_unported_flag(tmp_path):
    assert not torch.cuda.is_available()
    proc = _driver(*HEADLINE, cwd=tmp_path)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    proc = _driver("--device", "cpu", *HEADLINE, "--mesh", "4", cwd=tmp_path)
    assert proc.returncode != 0
    assert "unrecognized arguments: --mesh" in proc.stderr


def test_synthetic_cifar_and_sampler_match_jax(monkeypatch):
    for key, value in SYNTH.items():
        monkeypatch.setenv(key, value)
    kwargs = dict(shape=(32, 32, 3), classes=10, train=50000, test=10000)
    got = sources.synthetic_images("cifar10", **kwargs)
    want = jax_sources.synthetic_images("cifar10", **kwargs)
    for key in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(got[key], want[key])
    monkeypatch.setattr(data, "datasets", {"cifar10": lambda: got})
    monkeypatch.setitem(jax_data.datasets, "cifar10", lambda: want)
    train, test = data.make_datasets("cifar10", 100, 48, seed=5)
    jtrain, jtest = jax_data.make_datasets("cifar10", 100, 48, seed=5)
    for ours, theirs in ((train, jtrain), (test, jtest)):
        for _ in range(4):  # crosses the 256-image train epoch boundary
            (x, y), (jx, jy) = ours.sample(), theirs.sample()
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(
        "byzantinemomentum_tpu_torch."
        + ".".join(path.relative_to(PORT).with_suffix("").parts)
        for path in PORT.rglob("*.py") if path.name != "__init__.py")
    script = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'msgpack', 'byzantinemomentum_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|msgpack|byzantinemomentum_tpu)(\.|\s|$)",
        re.M)
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
