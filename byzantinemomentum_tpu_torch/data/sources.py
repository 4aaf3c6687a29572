"""Raw dataset sources (`byzantinemomentum_tpu/data/sources.py`): pure
numpy parsers of the published file formats and the deterministic
synthetic fallback.

* MNIST family (MNIST, FashionMNIST, KMNIST, the EMNIST splits, QMNIST):
  idx files, optionally gzipped. The family shares filenames, so bare
  filenames (without the dataset's subdirectory) count only for plain
  MNIST, and only at the top level of a data directory.
* CIFAR-10/100: the python-pickle batch files, optionally inside the
  distribution's .tar.gz.
* SVHN: the published `.mat` files (`scipy.io`, imported when read).

Search order for raw data: `$BMT_DATA_DIR`, `./data`,
`~/.cache/byzantinemomentum_tpu`. Nothing is downloaded. When the files
are not found, a synthetic dataset with the same shapes and
cardinalities is generated, bit-identical to the JAX package's for the
same name, so both drivers see the same batches. `$BMT_SYNTH_TRAIN` /
`$BMT_SYNTH_TEST` shrink it; `$BMT_SYNTH_SIGNAL` / `$BMT_SYNTH_NOISE` set
its difficulty.
"""

import gzip
import os
import pathlib
import pickle
import struct
import tarfile
import zlib

import numpy as np

from byzantinemomentum_tpu_torch import utils

__all__ = ["data_dirs", "load_mnist", "load_emnist", "load_qmnist",
           "load_cifar", "load_svhn", "synthetic_images"]


def data_dirs():
    """Candidate directories holding raw dataset files, in the JAX
    package's order: `BMT_DATA_DIR`, `./data`, the user's cache and the
    JAX package's fixed data directory."""
    dirs = []
    env = os.environ.get("BMT_DATA_DIR")
    if env:
        dirs.append(pathlib.Path(env))
    dirs.append(pathlib.Path.cwd() / "data")
    dirs.append(pathlib.Path.home() / ".cache" / "byzantinemomentum_tpu")
    dirs.append(pathlib.Path("/root/data"))
    return [d for d in dirs if d.is_dir()]


def _find(*names):
    """The first existing file among `names` in the data dirs (also one
    and two levels of subdirectories)."""
    for base in data_dirs():
        for name in names:
            for cand in (base / name, *base.glob(f"*/{name}"),
                         *base.glob(f"*/*/{name}")):
                if cand.is_file():
                    return cand
    return None


def _find_top(*names):
    """Like `_find`, at the top level of the data dirs only: a bare idx
    filename must not glob into a sibling dataset's subdirectory."""
    for base in data_dirs():
        for name in names:
            cand = base / name
            if cand.is_file():
                return cand
    return None


# --------------------------------------------------------------------------- #
# idx (MNIST family)

# idx type codes (byte 3 of the magic), from the published format
_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
               0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"),
               0x0E: np.dtype(">f8")}


def _read_idx(path):
    """An idx file (gzipped if its name ends in .gz) as a numpy array in
    native byte order."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as fd:
        magic, = struct.unpack(">I", fd.read(4))
        code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", fd.read(4 * ndim))
        if code not in _IDX_DTYPES:
            raise utils.UserException(
                f"Invalid idx file {path}: unknown type code 0x{code:02X}")
        dtype = _IDX_DTYPES[code]
        data = np.frombuffer(fd.read(), dtype=dtype)
    return data.reshape(dims).astype(np.dtype(dtype).newbyteorder("="))


_MNIST_FILES = {
    "train_x": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_y": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_x": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_y": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def load_mnist(name, **unused):
    """MNIST, FashionMNIST or KMNIST (`name`) from disk, else synthesized:
    `train_x u8[N, 28, 28, 1]`, `train_y i32[N]`, `test_x`, `test_y`."""
    out = {}
    subdir = {"mnist": "MNIST", "fashionmnist": "FashionMNIST",
              "kmnist": "KMNIST"}[name]
    for key, names in _MNIST_FILES.items():
        cands = (tuple(f"{subdir}/raw/{n}" for n in names)
                 + tuple(f"{subdir}/raw/{n}.gz" for n in names))
        path = _find(*cands)
        if path is None and name == "mnist":
            path = _find_top(*names, *(n + ".gz" for n in names))
        if path is None:
            utils.trace(f"{name}: raw files not found on disk; using the "
                        "deterministic synthetic fallback")
            return synthetic_images(name, shape=(28, 28, 1), classes=10,
                                    train=60000, test=10000)
        out[key] = _read_idx(path)
    out["train_x"] = out["train_x"][..., None]
    out["test_x"] = out["test_x"][..., None]
    out["train_y"] = out["train_y"].astype(np.int32)
    out["test_y"] = out["test_y"].astype(np.int32)
    return out


# EMNIST splits: (classes, train size, test size); `letters` labels run
# 1..26 on disk, and are kept so
_EMNIST_SPLITS = {
    "byclass": (62, 697932, 116323),
    "bymerge": (47, 697932, 116323),
    "balanced": (47, 112800, 18800),
    "letters": (26, 124800, 20800),
    "digits": (10, 240000, 40000),
    "mnist": (10, 60000, 10000),
}


def _load_idx_family(name, files, fallback, label_select=None):
    """Find all four idx files (`files`: key -> candidate names, each also
    gzipped) before parsing any, else `fallback()`; add the channel axis
    and take the labels as int32 (`label_select` picks the class column
    from a parsed label array)."""
    paths = {}
    for key, names in files.items():
        paths[key] = _find(*(c for n in names for c in (n, n + ".gz")))
        if paths[key] is None:
            utils.trace(f"{name}: raw files not found on disk; using the "
                        "deterministic synthetic fallback")
            return fallback()
    out = {key: _read_idx(path) for key, path in paths.items()}
    out["train_x"] = out["train_x"][..., None]
    out["test_x"] = out["test_x"][..., None]
    for key in ("train_y", "test_y"):
        y = out[key]
        out[key] = (label_select(y) if label_select else y).astype(np.int32)
    return out


def load_emnist(split="balanced"):
    """An EMNIST split (`--dataset-args split:<name>`). The fallback of
    `letters` has the 1-based labels of the files on disk."""
    if split not in _EMNIST_SPLITS:
        raise utils.UserException(
            f"Unknown EMNIST split {split!r}; expected one of "
            f"{sorted(_EMNIST_SPLITS)}")
    classes, n_train, n_test = _EMNIST_SPLITS[split]

    def fallback():
        out = synthetic_images(f"emnist-{split}", shape=(28, 28, 1),
                               classes=classes, train=n_train, test=n_test)
        if split == "letters":
            out["train_y"] = out["train_y"] + 1
            out["test_y"] = out["test_y"] + 1
        return out

    files = {
        key: (f"EMNIST/raw/emnist-{split}-{role}-{part}",
              f"emnist-{split}-{role}-{part}")
        for key, role, part in (("train_x", "train", "images-idx3-ubyte"),
                                ("train_y", "train", "labels-idx1-ubyte"),
                                ("test_x", "test", "images-idx3-ubyte"),
                                ("test_y", "test", "labels-idx1-ubyte"))}
    return _load_idx_family(f"emnist-{split}", files, fallback)


def load_qmnist():
    """QMNIST: MNIST images, labels as idx2 int32 records (N, 8) whose
    column 0 is the class."""
    files = {
        key: (f"QMNIST/raw/{name}", name)
        for key, name in (("train_x", "qmnist-train-images-idx3-ubyte"),
                          ("train_y", "qmnist-train-labels-idx2-int"),
                          ("test_x", "qmnist-test-images-idx3-ubyte"),
                          ("test_y", "qmnist-test-labels-idx2-int"))}
    return _load_idx_family(
        "qmnist", files,
        lambda: synthetic_images("qmnist", shape=(28, 28, 1), classes=10,
                                 train=60000, test=60000),
        label_select=lambda y: y[:, 0])


# --------------------------------------------------------------------------- #
# CIFAR

def _cifar_from_pickles(files, label_key):
    # The batch files are the published CIFAR pickles, read from the data
    # directories the user points at
    xs, ys = [], []
    for fd in files:
        entry = pickle.load(fd, encoding="bytes")
        xs.append(np.asarray(entry[b"data"], np.uint8))
        ys.append(np.asarray(entry[label_key], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.concatenate(ys)


def load_cifar(classes, **unused):
    """Load CIFAR-10/100 from extracted batch files or the .tar.gz, else
    synthesize. Returns HWC uint8 images."""
    name = f"cifar{classes}"
    if classes == 10:
        train_names = [f"cifar-10-batches-py/data_batch_{i}" for i in range(1, 6)]
        test_names = ["cifar-10-batches-py/test_batch"]
        tar_name = "cifar-10-python.tar.gz"
        label_key = b"labels"
    else:
        train_names = ["cifar-100-python/train"]
        test_names = ["cifar-100-python/test"]
        tar_name = "cifar-100-python.tar.gz"
        label_key = b"fine_labels"

    paths = [_find(n, pathlib.PurePath(n).name) for n in train_names + test_names]
    if all(p is not None for p in paths):
        fds = [open(p, "rb") for p in paths]
        try:
            train = _cifar_from_pickles(fds[:len(train_names)], label_key)
            test = _cifar_from_pickles(fds[len(train_names):], label_key)
        finally:
            for fd in fds:
                fd.close()
        return {"train_x": train[0], "train_y": train[1],
                "test_x": test[0], "test_y": test[1]}

    tar_path = _find(tar_name)
    if tar_path is not None:
        with tarfile.open(tar_path, "r:gz") as tar:
            train = _cifar_from_pickles(
                [tar.extractfile(n) for n in train_names], label_key)
            test = _cifar_from_pickles(
                [tar.extractfile(n) for n in test_names], label_key)
        return {"train_x": train[0], "train_y": train[1],
                "test_x": test[0], "test_y": test[1]}

    utils.trace(f"{name}: raw files not found on disk; using the "
                "deterministic synthetic fallback")
    return synthetic_images(name, shape=(32, 32, 3), classes=classes,
                            train=50000, test=10000)


# --------------------------------------------------------------------------- #
# SVHN

def load_svhn(**unused):
    """SVHN from `train_32x32.mat`/`test_32x32.mat`, else synthesized.
    `X` arrives (32, 32, 3, N); label 10 (the digit 0) becomes 0."""
    train_p = _find("SVHN/train_32x32.mat", "train_32x32.mat")
    test_p = _find("SVHN/test_32x32.mat", "test_32x32.mat")
    if train_p is None or test_p is None:
        utils.trace("svhn: raw files not found on disk; using the "
                    "deterministic synthetic fallback")
        return synthetic_images("svhn", shape=(32, 32, 3), classes=10,
                                train=73257, test=26032)
    from scipy.io import loadmat  # read only when the files are there

    def split(path):
        mat = loadmat(str(path))
        x = np.ascontiguousarray(np.transpose(mat["X"], (3, 0, 1, 2)))
        y = mat["y"].reshape(-1).astype(np.int32)
        y[y == 10] = 0
        return x.astype(np.uint8), y

    train_x, train_y = split(train_p)
    test_x, test_y = split(test_p)
    return {"train_x": train_x, "train_y": train_y,
            "test_x": test_x, "test_y": test_y}


# --------------------------------------------------------------------------- #
# Synthetic fallback

def synthetic_images(name, *, shape, classes, train, test):
    """Deterministic synthetic image dataset: each class is a fixed random
    prototype image plus per-sample noise, seeded by the crc32 of `name`
    (bit-identical to the JAX package's generator)."""
    train = int(os.environ.get("BMT_SYNTH_TRAIN", train))
    test = int(os.environ.get("BMT_SYNTH_TEST", test))
    signal = float(os.environ.get("BMT_SYNTH_SIGNAL", 1.0))
    sigma = float(os.environ.get("BMT_SYNTH_NOISE", 48.0))
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    protos = rng.integers(0, 256, size=(classes, *shape)).astype(np.float32)
    protos = 127.5 + signal * (protos - 127.5)

    def make(count, seed_off):
        r = np.random.default_rng((zlib.crc32(name.encode()) + seed_off) % (2**32))
        labels = r.integers(0, classes, size=count).astype(np.int32)
        # f32 noise in chunks: full-size CIFAR in f64 would peak above 1 GB
        images = np.empty((count, *shape), np.uint8)
        for lo in range(0, count, 8192):
            hi = min(lo + 8192, count)
            noise = sigma * r.standard_normal((hi - lo, *shape), dtype=np.float32)
            np.clip(protos[labels[lo:hi]] + noise, 0, 255, out=noise)
            images[lo:hi] = noise.astype(np.uint8)
        return images, labels

    train_x, train_y = make(train, 1)
    test_x, test_y = make(test, 2)
    return {"train_x": train_x, "train_y": train_y,
            "test_x": test_x, "test_y": test_y, "synthetic": True}
