"""The PyTorch port's MNIST-family, SVHN and phishing data against the JAX
package's (`data/sources.py`, `data/svm.py`, `data/__init__.py`,
`data/device.py`).

* `_read_idx` on idx files written here (u8, i8, big-endian i16, i32,
  f32 and f64, plain and gzipped, QMNIST's idx2 int32 label records)
  gives the JAX arrays, values and dtypes; an unknown type code raises.
* `load_mnist` (MNIST/raw, bare top-level files for plain MNIST only,
  never a sibling's files), `load_emnist`, `load_qmnist`, `load_svhn`
  and `load_phishing` give the JAX arrays from files on disk and, with
  none, from the synthetic fallback (`letters` 1-based); an unknown
  EMNIST split raises. Each loader searches its own package's
  `data_dirs`, and the two lists are the same.
* The transform metadata (`flip`, `norm`) and the host sampler's
  batches equal the JAX ones across epoch boundaries for `mnist`,
  `fashionmnist`, `kmnist`, `qmnist`, `--no-transform` and `phishing`.
* `DeviceData`'s indices and flips equal the JAX `DeviceData`'s and its
  gather gives `jax.jit(DeviceData.gather)`'s bits, for the same
  datasets: normalized without flips (`mnist`), flipped without
  normalization (`fashionmnist`), neither (`qmnist`, `--no-transform`)
  and raw float inputs with float (B, 1) labels (`phishing`).
"""

import gzip
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from byzantinemomentum_tpu import data as jax_data
from byzantinemomentum_tpu.data import sources as jax_sources
from byzantinemomentum_tpu.data import svm as jax_svm
from byzantinemomentum_tpu.data.device import DeviceData as JaxDeviceData
from byzantinemomentum_tpu_torch import data, utils
from byzantinemomentum_tpu_torch.data import sources, svm
from byzantinemomentum_tpu_torch.data.device import DeviceData

from tests.torch_threads import one_torch_thread  # noqa: F401

TRAIN, TEST, BATCH, COUNT = 130, 40, 10, 4
CODES = {np.uint8: 0x08, np.int8: 0x09, ">i2": 0x0B, ">i4": 0x0C,
         ">f4": 0x0D, ">f8": 0x0E}


def _write_idx(path, arr, gz=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    dtype = np.dtype(arr.dtype)
    code = CODES[dtype.type if dtype.itemsize == 1 else dtype.str.replace("<", ">")]
    body = (struct.pack(">I", (code << 8) | arr.ndim)
            + struct.pack(f">{arr.ndim}I", *arr.shape) + arr.tobytes())
    if gz:
        path = path.with_name(path.name + ".gz")
        body = gzip.compress(body)
    path.write_bytes(body)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """An empty data dir, working dir and home; small synthetic sets."""
    root = tmp_path / "data"
    for sub in ("data", "cwd", "home"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("BMT_DATA_DIR", str(root))
    monkeypatch.chdir(tmp_path / "cwd")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("BMT_DOWNLOAD", raising=False)
    monkeypatch.setenv("BMT_SYNTH_TRAIN", str(TRAIN))
    monkeypatch.setenv("BMT_SYNTH_TEST", str(TEST))
    return root


@pytest.mark.parametrize("env", (False, True))
def test_data_dirs_match_jax(tmp_path, monkeypatch, env):
    """Both packages list the same candidate directories in the same
    order, the fixed directory after `BMT_DATA_DIR`, `./data` and the
    user's cache (every candidate taken as existing, so the lists are the
    whole search paths)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if env:
        monkeypatch.setenv("BMT_DATA_DIR", str(tmp_path / "env"))
    else:
        monkeypatch.delenv("BMT_DATA_DIR", raising=False)
    monkeypatch.setattr(pathlib.Path, "is_dir", lambda self: True)
    want = jax_sources.data_dirs()
    assert sources.data_dirs() == want
    assert len(want) == 3 + env


def _equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("gz", (False, True))
def test_read_idx_matches_jax(dirs, gz):
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 256, (5, 28, 28)).astype(np.uint8),
              rng.integers(-128, 128, 7).astype(np.int8),
              rng.integers(-3000, 3000, (4, 3)).astype(">i2"),
              rng.integers(-2**31, 2**31 - 1, (6, 8)).astype(">i4"),
              rng.standard_normal((3, 2, 2)).astype(">f4"),
              rng.standard_normal(9).astype(">f8")]
    for i, arr in enumerate(arrays):
        path = dirs / f"a{i}"
        _write_idx(path, arr, gz)
        if gz:
            path = path.with_name(path.name + ".gz")
        got, want = sources._read_idx(path), jax_sources._read_idx(path)
        assert got.dtype == want.dtype and got.dtype.isnative
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr)
    bad = dirs / "bad"
    bad.write_bytes(struct.pack(">II", 0x0A01, 1) + b"\0")
    with pytest.raises(utils.UserException, match="unknown type code 0x0A"):
        sources._read_idx(bad)


def _mnist_files(root, prefix, rng, gz=False, count=(12, 6)):
    for split, n in zip(("train", "t10k"), count):
        _write_idx(root / f"{prefix}{split}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)).astype(np.uint8), gz)
        _write_idx(root / f"{prefix}{split}-labels-idx1-ubyte",
                   rng.integers(0, 10, n).astype(np.uint8), gz)


def test_mnist_family_files_and_fallback_match_jax(dirs):
    for name in ("mnist", "fashionmnist", "kmnist"):
        _equal(sources.load_mnist(name), jax_sources.load_mnist(name))
    rng = np.random.default_rng(1)
    # Bare files at the top level count for plain MNIST only
    _mnist_files(dirs, "", rng, gz=True)
    out = sources.load_mnist("mnist")
    assert "synthetic" not in out and out["train_x"].shape == (12, 28, 28, 1)
    for name in ("mnist", "fashionmnist"):
        _equal(sources.load_mnist(name), jax_sources.load_mnist(name))
    assert sources.load_mnist("fashionmnist")["synthetic"]
    # A sibling's raw/ directory never serves another family member
    _mnist_files(dirs / "KMNIST" / "raw", "", rng, count=(9, 3))
    _mnist_files(dirs / "FashionMNIST" / "raw", "", rng, gz=True, count=(7, 5))
    for name in ("mnist", "fashionmnist", "kmnist"):
        got = sources.load_mnist(name)
        _equal(got, jax_sources.load_mnist(name))
    assert sources.load_mnist("kmnist")["train_x"].shape[0] == 9
    assert sources.load_mnist("fashionmnist")["train_x"].shape[0] == 7
    assert sources.load_mnist("mnist")["train_x"].shape[0] == 12


def test_emnist_and_qmnist_match_jax(dirs):
    for split in ("balanced", "letters"):
        got = sources.load_emnist(split)
        _equal(got, jax_sources.load_emnist(split))
    assert sources.load_emnist("letters")["train_y"].min() >= 1
    assert sources.load_emnist("letters")["train_y"].max() == 26
    _equal(sources.load_qmnist(), jax_sources.load_qmnist())
    with pytest.raises(utils.UserException, match="Unknown EMNIST split 'bogus'"):
        sources.load_emnist("bogus")
    rng = np.random.default_rng(2)
    raw = dirs / "EMNIST" / "raw"
    for role, n in (("train", 11), ("test", 4)):
        _write_idx(raw / f"emnist-letters-{role}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)).astype(np.uint8))
        _write_idx(raw / f"emnist-letters-{role}-labels-idx1-ubyte",
                   rng.integers(1, 27, n).astype(np.uint8), gz=True)
    raw = dirs / "QMNIST" / "raw"
    for role, n in (("train", 8), ("test", 5)):
        _write_idx(raw / f"qmnist-{role}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)).astype(np.uint8), gz=True)
        _write_idx(raw / f"qmnist-{role}-labels-idx2-int",
                   rng.integers(0, 10, (n, 8)).astype(">i4"))
    got = sources.load_emnist("letters")
    assert "synthetic" not in got and got["train_x"].shape == (11, 28, 28, 1)
    _equal(got, jax_sources.load_emnist("letters"))
    got = sources.load_qmnist()
    assert got["train_y"].shape == (8,) and got["train_y"].dtype == np.int32
    _equal(got, jax_sources.load_qmnist())


def test_svhn_matches_jax(dirs):
    _equal(sources.load_svhn(), jax_sources.load_svhn())
    rng = np.random.default_rng(3)
    for name, n in (("train", 6), ("test", 4)):
        x = rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8)
        y = rng.integers(1, 11, (n, 1)).astype(np.uint8)
        (dirs / "SVHN").mkdir(exist_ok=True)
        scipy.io.savemat(dirs / "SVHN" / f"{name}_32x32.mat", {"X": x, "y": y})
    got = sources.load_svhn()
    assert got["train_x"].shape == (6, 32, 32, 3)
    assert set(np.unique(got["train_y"])) <= set(range(10))
    _equal(got, jax_sources.load_svhn())


def test_phishing_matches_jax(dirs):
    _equal(svm.load_phishing(), jax_svm.load_phishing())
    got = svm.load_phishing()
    assert got["kind"] == "raw" and got["train_x"].shape == (TRAIN, 68)
    assert got["train_y"].shape == (TRAIN, 1) and got["train_y"].dtype == np.float32
    rng = np.random.default_rng(4)
    lines = []
    for _ in range(20):
        feats = sorted(rng.choice(68, 5, replace=False) + 1)
        lines.append(" ".join([str(rng.choice([-1, 1]))]
                              + [f"{i}:{rng.random():.6f}" for i in feats]))
    (dirs / "phishing").write_text("\n".join(lines) + "\n")
    got = svm.load_phishing()
    assert not got["synthetic"] and got["test_x"].shape == (1, 68)
    _equal(got, jax_svm.load_phishing())


CASES = (("mnist", False), ("fashionmnist", False), ("kmnist", False),
         ("qmnist", False), ("mnist", True), ("fashionmnist", True),
         ("phishing", False))


@pytest.mark.parametrize("name,no_transform", CASES)
def test_transform_and_sampler_match_jax(dirs, name, no_transform):
    ours = data.make_datasets(name, BATCH, 16, no_transform=no_transform, seed=7)
    theirs = jax_data.make_datasets(name, BATCH, 16, no_transform=no_transform,
                                    seed=7)
    for split, jsplit in zip(ours, theirs):
        if name == "phishing":
            assert split._transform is jsplit._transform is None
        else:
            assert ((split._transform.flip, split._transform.norm)
                    == (jsplit._transform.flip, jsplit._transform.norm))
        for _ in range(30):  # 2.3 epochs of the 130-image train split
            (x, y), (jx, jy) = split.sample(), jsplit.sample()
            assert x.dtype == jx.dtype and y.dtype == jy.dtype
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("name,no_transform", CASES)
def test_device_data_matches_jit_jax(dirs, name, no_transform):
    ours = data.make_datasets(name, BATCH, 16, no_transform=no_transform, seed=7)
    theirs = jax_data.make_datasets(name, BATCH, 16, no_transform=no_transform,
                                    seed=7)
    flips_seen = False
    for split, jsplit in zip(ours, theirs):
        dev, jdev = DeviceData(split, "cpu"), JaxDeviceData(jsplit)
        assert dev.flip == jdev.flip and (dev.norm is None) == (jdev.norm is None)
        gather = jax.jit(jdev.gather)
        for _ in range(8):
            idx, flips = dev.sample_indices(COUNT)
            jidx, jflips = jdev.sample_indices(COUNT)
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(flips, jflips)
            flips_seen |= bool(flips.any())
            x, y = dev.gather(*dev.upload(idx, flips))
            jx, jy = gather(jnp.asarray(idx), jnp.asarray(flips))
            assert x.dtype == torch.float32 and x.shape == jx.shape
            np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                          np.asarray(jx).view(np.uint32))
            assert y.shape == jy.shape and y.numpy().dtype == np.asarray(jy).dtype
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert flips_seen == (name == "fashionmnist" and not no_transform)
