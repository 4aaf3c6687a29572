"""Device-resident splits (`byzantinemomentum_tpu/data/device.py`).

The driver's default path, as in the JAX package: each split's uint8
inputs and labels go to the engine's device once (CIFAR-10's train split
is 150 MB), and a step ships only its `(S, B)` int32 indices and bool
flip mask (`(S, k, B)` at k local steps: `Engine.sample_indices`; a
chunk of M fused steps ships its `[M, ...]` arrays, one draw and one copy
each), one small tensor each; the gather, the flips, the conversion
and the normalization run on the device. The host `Dataset` keeps drawing
the indices and flips, in the JAX `DeviceData`'s order: all `count` index
rows of a call first, then all `count` flip rows. (`Dataset.sample`
interleaves them batch by batch, so the two paths see other batches once
a train epoch ends inside a call. Under `--device-gar` the JAX driver
samples on the host, in that order; `sample_batches` draws it, and the
gather stays on the device, so only the transform's last-bit rounding
differs from the JAX host transform there.)

Rounding, as XLA compiles the JAX gather: `x / 255` becomes a product
with the f32 reciprocal, `x * (1/255) - mean` one fused multiply-add, and
`/ std` a product with the f32 reciprocal of std. `gather` gives the same
bits: `x * c - mean` in float64 (exact: an 8-bit integer times a 24-bit
constant, minus a 24-bit mean), rounded once to f32, times f32(1/std);
without normalization, `x * c` in f32. The constants are computed once on
the host, so CPU and CUDA give the same bits. No tensor is divided by a
Python number: torch on CUDA turns that into a product with a reciprocal
of its own.

The transform run here is the image transform of `data/__init__.py`
(its `flip` and `norm`). A raw dataset (`phishing`) has none: its
inputs are converted to f32 as they are, and its labels keep their
trailing shape (float `(N, 1)`). Every dataset of the port has one of
the two, so the JAX `DeviceData.supports` check has no counterpart.
"""

import numpy as np
import torch

__all__ = ["DeviceData", "to_device"]


def to_device(array, device):
    """A host array as a tensor on `device`: one copy, from pinned memory
    and asynchronous on a card (the caching host allocator keeps a pinned
    block until its copy has run), so the host never waits on it."""
    array = np.asarray(array)
    tensor = torch.from_numpy(array if array.flags.c_contiguous
                              else array.copy(order="C"))
    device = torch.device(device)
    if device.type != "cuda":
        return tensor
    return tensor.pin_memory().to(device, non_blocking=True)


class DeviceData:
    """One split's inputs and labels on a device, and its transform."""

    def __init__(self, dataset, device):
        self._host = dataset
        self.device = torch.device(device)
        self.inputs = torch.from_numpy(dataset._inputs).to(self.device)
        self.labels = torch.from_numpy(dataset._labels).to(self.device)
        transform = dataset._transform
        self.is_image = transform is not None
        self.flip = self.is_image and transform.flip
        scale = np.float32(1.0) / np.float32(255.0)
        self._scale32 = torch.tensor(scale, device=self.device)
        self._scale64 = torch.tensor(float(scale), dtype=torch.float64,
                                     device=self.device)
        self.norm = None
        if self.is_image and transform.norm is not None:
            mean = np.asarray(transform.norm[0], np.float32)
            inv_std = np.float32(1.0) / np.asarray(transform.norm[1], np.float32)
            self.norm = (torch.from_numpy(mean.astype(np.float64)).to(self.device),
                         torch.from_numpy(inv_std).to(self.device))

    @classmethod
    def pair(cls, trainset, testset, device):
        return cls(trainset, device), cls(testset, device)

    @property
    def batch_size(self):
        return self._host.batch_size

    @property
    def dataset(self):
        """The host sampler (`data.Dataset`) the indices come from: its
        `get_state`/`set_state` snapshot and restore the batch order."""
        return self._host

    def sample_indices(self, count):
        """Host half: `(i32[count, B] indices, bool[count, B] flips)` of
        the next `count` batches, every index row drawn before any flip
        row."""
        idx = np.stack([self._host.sample_indices() for _ in range(count)])
        flips = np.stack([self._host.sample_flips() for _ in range(count)])
        return idx.astype(np.int32), flips

    def sample_batches(self, count):
        """`sample_indices` drawn batch by batch, each index row then its
        flip row: the order of `Dataset.sample`, the JAX driver's
        host-staged batches. It differs from `sample_indices` only on a
        flipped split where an epoch ends inside the draw."""
        rows = [(self._host.sample_indices(), self._host.sample_flips())
                for _ in range(count)]
        idx, flips = (np.stack(column) for column in zip(*rows))
        return idx.astype(np.int32), flips

    def upload(self, idx, flips):
        """The host half's arrays (a step's, or a chunk's `[M, ...]`) as
        tensors on the device: one copy each (`to_device`)."""
        return to_device(idx, self.device), to_device(flips, self.device)

    def gather(self, idx, flips):
        """`idx: int[..., B]`, `flips: bool[..., B]` on the device ->
        `(f32[..., B, H, W, C] inputs, labels[..., B])` (a raw dataset's
        inputs and labels keep their trailing shapes)."""
        x = self.inputs.index_select(0, idx.reshape(-1))
        x = x.view(idx.shape + self.inputs.shape[1:])
        y = self.labels.index_select(0, idx.reshape(-1))
        y = y.view(idx.shape + self.labels.shape[1:])
        if not self.is_image:
            return x.to(torch.float32), y
        if self.flip:  # the W axis of (..., H, W, C)
            x = torch.where(flips[..., None, None, None], x.flip(-2), x)
        if self.norm is None:
            return x.to(torch.float32) * self._scale32, y
        mean, inv_std = self.norm
        x = (x.to(torch.float64) * self._scale64 - mean).to(torch.float32)
        return x * inv_std, y
