"""Dataset registry and host-side sampler (`byzantinemomentum_tpu/data/`,
the CIFAR subset).

A dataset is a pair of in-memory numpy splits plus a sampler that yields
fixed-shape `(B, ...)` batches forever. The train sampler shuffles per
epoch and completes the last batch of an epoch from the next shuffle; the
test sampler cycles in order. The transform is the JAX package's: uint8
HWC -> f32 in [0, 1], a random horizontal flip for CIFAR, then the CIFAR
normalization — applied to the test set too, as the reference does. The
sampler's numpy RNG consumes draws in the same order as the JAX package's,
so both drivers see the same batches for the same seed.
"""

import numpy as np

from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.data import sources

__all__ = ["datasets", "Dataset", "make_datasets", "normalizations"]

datasets = {
    "cifar10": lambda: sources.load_cifar(10),
    "cifar100": lambda: sources.load_cifar(100),
}

normalizations = {
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "cifar100": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
}


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
        """Random horizontal-flip mask `bool[B]` of the next batch
        (all-False when the transform has no flips)."""
        if self._transform.flip:
            return self._rng.random(self._batch) < 0.5
        return np.zeros(self._batch, bool)

    def sample(self):
        """The next `(inputs f32[B, ...], labels i32[B])` batch."""
        select = self.sample_indices()
        return self._transform(self._inputs[select], self.sample_flips()), \
            self._labels[select]


def _image_transform(name, no_transform):
    """uint8 HWC -> f32 in [0, 1], then (unless `no_transform`) the given
    horizontal flips and the per-channel normalization."""
    norm = normalizations[name]

    def transform(batch, flips):
        x = batch.astype(np.float32) / 255.0
        if not no_transform:
            x[flips] = x[flips, :, ::-1, :]
            x = (x - np.asarray(norm[0], np.float32)) / np.asarray(norm[1], np.float32)
        return x

    # Metadata for the device-resident path (`data/device.py`)
    transform.flip = not no_transform
    transform.norm = None if no_transform else norm
    return transform


def make_datasets(dataset, train_batch=None, test_batch=None, *,
                  no_transform=False, seed=0):
    """The (trainset, testset) pair of a registered dataset name."""
    if dataset not in datasets:
        utils.fatal_unavailable(datasets, dataset, what="dataset name")
    raw = datasets[dataset]()
    transform = _image_transform(dataset, no_transform)
    trainset = Dataset(raw["train_x"], raw["train_y"], train_batch,
                       train=True, transform=transform, seed=seed,
                       name=dataset)
    testset = Dataset(raw["test_x"], raw["test_y"], test_batch,
                      train=False, transform=transform, seed=seed + 1,
                      name=dataset)
    trainset.synthetic = testset.synthetic = bool(raw.get("synthetic", False))
    return trainset, testset
