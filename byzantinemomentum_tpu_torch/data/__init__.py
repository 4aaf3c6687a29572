"""Dataset registry and host-side sampler (`byzantinemomentum_tpu/data/`).

A dataset is a pair of in-memory numpy splits plus a sampler that yields
fixed-shape `(B, ...)` batches forever. The train sampler shuffles per
epoch and completes the last batch of an epoch from the next shuffle; the
test sampler cycles in order. The image transform is the JAX package's:
uint8 HWC -> f32 in [0, 1], a random horizontal flip for the datasets of
`flip_train`, then the normalization of `normalizations` where the
dataset has one — applied to the test set too, as the reference does;
`--no-transform` keeps only the scaling. A dataset of kind "raw"
(`phishing`, `data/svm.py`) has no transform. The sampler's numpy RNG
consumes draws in the same order as the JAX package's, so both drivers
see the same batches for the same seed. `get_state`/`set_state` snapshot
and restore a sampler (cursor, epoch order, PCG64 state) in the JAX
package's checkpoint layout, so a resumed run replays the same batches.
"""

import numpy as np

from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.data import sources

__all__ = ["datasets", "register", "Dataset", "make_datasets",
           "normalizations", "flip_train"]

# name -> loader(**dataset_args) -> {"train_x", "train_y", "test_x",
# "test_y"[, "kind", "synthetic"]}
datasets = {}

# Per-channel (mean, std) applied after the scaling to [0, 1]
normalizations = {
    "mnist": ((0.1307,), (0.3081,)),
    "kmnist": ((0.1918,), (0.3483,)),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "cifar100": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
}

# Datasets whose transform flips at random (train and test splits)
flip_train = {"fashionmnist", "cifar10", "cifar100"}


def register(name, loader):
    """Register a dataset loader under `name`."""
    if name in datasets:
        utils.warning(f"Dataset {name!r} registered twice; keeping the last")
    datasets[name] = loader
    return loader


class Dataset:
    """An infinite, fixed-shape batch sampler over an in-memory split."""

    def __init__(self, inputs, labels, batch_size, *, train, transform,
                 seed=0, name="dataset"):
        if len(inputs) < 1 or len(inputs) != len(labels):
            raise utils.UserException(
                f"Invalid dataset {name!r}: {len(inputs)} inputs vs {len(labels)} labels")
        self.name = name
        self.synthetic = False
        self._inputs = inputs
        self._labels = labels
        self._batch = min(batch_size or len(inputs), len(inputs))
        self._train = train
        self._transform = transform
        self._rng = np.random.default_rng(seed)
        self._cursor = 0
        self._order = self._rng.permutation(len(inputs)) if train else None

    @property
    def batch_size(self):
        return self._batch

    def sample_indices(self):
        """Advance the sampler and return the next batch's indices."""
        n = len(self._inputs)
        end = self._cursor + self._batch
        if self._train:
            if end >= n:
                # Epoch boundary: complete the batch from a fresh shuffle
                select = self._order[self._cursor:]
                self._order = self._rng.permutation(n)
                extra = end - n
                if extra:
                    select = np.concatenate([select, self._order[:extra]])
            else:
                select = self._order[self._cursor:end]
        elif end > n:
            select = np.concatenate([np.arange(self._cursor, n),
                                     np.arange(end % n)])
        else:
            select = np.arange(self._cursor, end)
        self._cursor = end % n
        return select

    def sample_flips(self):
        """Random horizontal-flip mask `bool[B]` of the next batch; the RNG
        draws only where the transform flips (all-False otherwise)."""
        if self._transform is not None and self._transform.flip:
            return self._rng.random(self._batch) < 0.5
        return np.zeros(self._batch, bool)

    def get_state(self):
        """The sampler's mutable state (cursor, epoch order, RNG) as the
        JAX package snapshots it for a checkpoint: msgpack/JSON-ready,
        the PCG64 state's ints (wider than 64 bits) as strings."""
        rng_state = self._rng.bit_generator.state
        return {
            "cursor": int(self._cursor),
            "order": (None if self._order is None
                      else np.asarray(self._order).tolist()),
            "rng": {
                "bit_generator": rng_state["bit_generator"],
                "state": {k: str(v) for k, v in rng_state["state"].items()},
                "has_uint32": int(rng_state["has_uint32"]),
                "uinteger": int(rng_state["uinteger"]),
            },
        }

    def set_state(self, snapshot):
        """Restore a `get_state` snapshot. Everything is decoded and
        checked (the bit generator validates its own state) before the
        cursor and order are assigned, so a malformed snapshot raises and
        leaves the sampler as it was."""
        n = len(self._inputs)
        cursor = int(snapshot["cursor"])
        if not 0 <= cursor < n:
            raise utils.UserException(
                f"Sampler snapshot cursor {cursor} out of range for dataset "
                f"{self.name!r} of size {n}")
        order = snapshot["order"]
        order = None if order is None else np.asarray(order, np.int64)
        if order is not None and (len(order) != n or (order >= n).any()
                                  or (order < 0).any()):
            raise utils.UserException(
                f"Sampler snapshot order is inconsistent with dataset "
                f"{self.name!r} of size {n} (snapshot covers "
                f"{len(order)} samples)")
        rng = snapshot["rng"]
        self._rng.bit_generator.state = {
            "bit_generator": rng["bit_generator"],
            "state": {k: int(v) for k, v in rng["state"].items()},
            "has_uint32": int(rng["has_uint32"]),
            "uinteger": int(rng["uinteger"]),
        }
        self._cursor = cursor
        self._order = order

    def sample(self):
        """The next `(inputs, labels)` batch: `f32[B, ...]` inputs from the
        transform (as stored for a raw dataset)."""
        select = self.sample_indices()
        flips = self.sample_flips()
        x = self._inputs[select]
        if self._transform is not None:
            x = self._transform(x, flips)
        return x, self._labels[select]


def _image_transform(name, no_transform):
    """uint8 HWC -> f32 in [0, 1], then (unless `no_transform`) the given
    horizontal flips where `name` is in `flip_train` and the per-channel
    normalization where `name` has one."""
    norm = None if no_transform else normalizations.get(name)
    flip = name in flip_train and not no_transform

    def transform(batch, flips):
        x = batch.astype(np.float32) / 255.0
        if flip:
            x[flips] = x[flips, :, ::-1, :]
        if norm is not None:
            x = (x - np.asarray(norm[0], np.float32)) / np.asarray(norm[1], np.float32)
        return x

    # Metadata for the device-resident path (`data/device.py`)
    transform.flip = flip
    transform.norm = norm
    return transform


def make_datasets(dataset, train_batch=None, test_batch=None, *,
                  no_transform=False, seed=0, **custom_args):
    """The (trainset, testset) pair of a registered dataset name;
    `custom_args` go to its loader (`--dataset-args`)."""
    if dataset not in datasets:
        utils.fatal_unavailable(datasets, dataset, what="dataset name")
    raw = datasets[dataset](**custom_args)
    transform = (_image_transform(dataset, no_transform)
                 if raw.get("kind", "image") == "image" else None)
    trainset = Dataset(raw["train_x"], raw["train_y"], train_batch,
                       train=True, transform=transform, seed=seed,
                       name=dataset)
    testset = Dataset(raw["test_x"], raw["test_y"], test_batch,
                      train=False, transform=transform, seed=seed + 1,
                      name=dataset)
    trainset.synthetic = testset.synthetic = bool(raw.get("synthetic", False))
    return trainset, testset


register("mnist", lambda **kw: sources.load_mnist("mnist", **kw))
register("fashionmnist", lambda **kw: sources.load_mnist("fashionmnist", **kw))
register("kmnist", lambda **kw: sources.load_mnist("kmnist", **kw))
# No normalization and no flips for these (plain [0, 1] scaling)
register("emnist", sources.load_emnist)
register("qmnist", sources.load_qmnist)
register("svhn", sources.load_svhn)
register("cifar10", lambda **kw: sources.load_cifar(10, **kw))
register("cifar100", lambda **kw: sources.load_cifar(100, **kw))

from byzantinemomentum_tpu_torch.data import svm as _svm  # noqa: E402,F401  (registers "phishing")
