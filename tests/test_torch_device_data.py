"""The PyTorch port's device-resident splits (`data/device.py`) and the
engine's indexed entry points against the JAX package's.

* `DeviceData.sample_indices` gives the JAX `DeviceData`'s indices and
  flips exactly, over several epoch boundaries, one of them inside a call
  (130 images, B = 10, 4 batches a call), and on the cycling test split.
* `DeviceData.gather` gives `jax.jit(DeviceData.gather)`'s batches bit
  for bit: with flips, under `--no-transform` (no flips, no
  normalization) and on the test split.
* One `Engine.train_step_indexed` against the JAX engine's
  `train_step_indexed` (n=11, f=2, Bulyan against `empire(1.1)`, the
  grouped honest phase in both), fed the JAX dropout masks, and one
  `eval_many_indexed` against the JAX one, from the same weights. The
  step is held at `tests/test_torch_engine.py`'s tolerances (rtol 1e-4,
  atol 1e-5; the two norms of the study at 1e-3, as that file's
  dot-product columns); the evaluation counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import attacks as jax_attacks
from byzantinemomentum_tpu import data as jax_data
from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.data.device import DeviceData as JaxDeviceData
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu_torch import convert, data, models, optim
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.data.device import DeviceData
from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig
from byzantinemomentum_tpu_torch.engine.state import init_state
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.ops import gars

from tests.test_torch_engine import CFG, LR, _close
from tests.test_torch_model import jax_masks

IMAGES, BATCH, COUNT = 130, 10, 4


def _splits(no_transform=False, seed=3, batch=BATCH):
    """The same uint8 images and labels as a port split pair and a JAX
    split pair (train, test) with the same seed."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (IMAGES, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, IMAGES).astype(np.int32)
    pairs = []
    for mod in (data, jax_data):
        transform = mod._image_transform("cifar10", no_transform)
        pairs.append(tuple(
            mod.Dataset(x, y, batch, train=train, transform=transform,
                        seed=seed + (not train), name="cifar10")
            for train in (True, False)))
    return pairs


def test_transform_metadata_matches_jax():
    for no_transform in (False, True):
        ours = data._image_transform("cifar10", no_transform)
        theirs = jax_data._image_transform("cifar10", no_transform)
        assert (ours.flip, ours.norm) == (theirs.flip, theirs.norm)
        dev = DeviceData(data.Dataset(
            np.zeros((2, 32, 32, 3), np.uint8), np.zeros(2, np.int32), 1,
            train=True, transform=ours), "cpu")
        assert dev.flip == ours.flip
        assert (dev.norm is None) == (ours.norm is None) == no_transform


@pytest.mark.parametrize("split", ("train", "test"))
def test_sample_indices_match_jax_across_epochs(split):
    (train, test), (jtrain, jtest) = _splits()
    which = 0 if split == "train" else 1
    ours = DeviceData((train, test)[which], "cpu")
    theirs = JaxDeviceData((jtrain, jtest)[which])
    assert ours.batch_size == theirs.batch_size == BATCH
    # 12 calls of 40 images: 3.7 epochs of 130, boundaries inside calls
    for _ in range(12):
        idx, flips = ours.sample_indices(COUNT)
        jidx, jflips = theirs.sample_indices(COUNT)
        assert idx.dtype == jidx.dtype == np.int32
        assert idx.shape == flips.shape == (COUNT, BATCH)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(flips, jflips)


def test_draw_order_is_not_the_host_samplers():
    """`Dataset.sample` draws each batch's flips right after its indices;
    the device path draws a call's index rows first. The second epoch
    ends on batch 25, the second of its call, so the third epoch's
    permutation is drawn after one flip row less: the batches from 26 on
    differ."""
    (train, _), _ = _splits()
    (host, _), _ = _splits()
    ours = DeviceData(train, "cpu")
    idx = np.concatenate([ours.sample_indices(COUNT)[0] for _ in range(8)])
    want = []
    for _ in range(len(idx)):
        want.append(host.sample_indices())
        host.sample_flips()
    np.testing.assert_array_equal(idx[:26], np.stack(want[:26]))
    assert not np.array_equal(idx[26:], np.stack(want[26:]))


@pytest.mark.parametrize("split,no_transform", (
    ("train", False), ("train", True), ("test", False)))
def test_gather_matches_jit_jax_bit_for_bit(split, no_transform):
    (train, test), (jtrain, jtest) = _splits(no_transform)
    which = 0 if split == "train" else 1
    ours = DeviceData((train, test)[which], "cpu")
    theirs = JaxDeviceData((jtrain, jtest)[which])
    gather = jax.jit(theirs.gather)
    for _ in range(4):
        idx, flips = ours.sample_indices(COUNT)
        assert flips.any() != no_transform
        x, y = ours.gather(*ours.upload(idx, flips))
        jx, jy = gather(jnp.asarray(idx), jnp.asarray(flips))
        assert x.dtype == torch.float32 and x.shape == (COUNT, BATCH, 32, 32, 3)
        np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                      np.asarray(jx).view(np.uint32))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        # The host transform divides: other bits, same values
        host = train._transform(train._inputs[idx[0]], flips[0])
        np.testing.assert_allclose(x[0].numpy(), host, rtol=1e-6, atol=1e-6)


def _engines():
    """The JAX and port engines (Bulyan against `empire(1.1)`) on the same
    weights, each with the same device-resident splits attached."""
    jcfg = JaxConfig(**CFG)
    mdef = jax_models.build("empire-cnn")
    jengine = build_engine(
        cfg=jcfg, model_def=mdef, loss=jax_losses.Loss("nll"),
        criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars["bulyan"], 1.0, {})],
        attack=jax_attacks.attacks["empire"], attack_kwargs={"factor": 1.1})
    key = jax.random.PRNGKey(3)
    params, net_state = mdef.init(key)
    jstate = jengine.init(key, params=params, net_state=net_state)
    cfg = EngineConfig(**CFG)
    engine = Engine(cfg, models.build("empire-cnn", device="cpu"),
                    Loss("nll"), Criterion("top-k"), (gars["bulyan"], {}),
                    attacks["empire"], {"factor": 1.1},
                    optim.build("sgd", weight_decay=cfg.weight_decay))
    theta, bn = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, net_state))
    (train, test), (jtrain, jtest) = _splits(batch=4)
    engine.attach_data(*DeviceData.pair(train, test, "cpu"))
    jengine.attach_data(*JaxDeviceData.pair(jtrain, jtest))
    rng = torch.from_numpy(np.asarray(jstate.rng).astype(np.int64))
    return jengine, jstate, engine, init_state(cfg, theta, bn, rng)


def test_train_step_and_eval_indexed_match_jax():
    jengine, jstate, engine, state = _engines()
    S = engine.cfg.nb_sampled
    _, _, *wkeys = jax.random.split(jstate.rng, S + 2)
    masks = [jax_masks(k, 4) for k in wkeys]
    masks = tuple(torch.from_numpy(np.stack(m)) for m in zip(*masks))
    idx, flips = engine.train_data.sample_indices(S)
    jidx, jflips = jengine._train_data.sample_indices(S)
    np.testing.assert_array_equal(idx, jidx)
    jnew, jmetrics = jengine.train_step_indexed(
        jstate, jnp.asarray(jidx), jnp.asarray(jflips), jnp.float32(LR))
    new, metrics = engine.train_step_indexed(state, idx, flips, LR, masks)
    assert engine.counts == {"indexed_steps": 1, "grouped_phases": 1}
    _close(new.momentum_server, jnew.momentum_server)
    _close(new.theta, jnew.theta)
    _close(metrics["Average loss"], jmetrics["Average loss"])
    for column in ("Sampled gradient norm", "Defense gradient norm"):
        _close(metrics[column], jmetrics[column], rtol=1e-3)
    assert (new.steps, new.datapoints) == (1, 4 * engine.cfg.nb_honests)

    idx, flips = engine.test_data.sample_indices(3)
    jidx, jflips = jengine._test_data.sample_indices(3)
    got = engine.eval_many_indexed(new.theta, new.net_state, idx, flips)
    want = jengine.eval_many_indexed(jnew.theta, jnew.net_state,
                                     jnp.asarray(jidx), jnp.asarray(jflips))
    assert engine.counts["indexed_evals"] == 1
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist()[1] == 12.0
