"""Multi-local-step SGD (`--nb-local-steps`) of the PyTorch port against
the JAX package's, on the CPU, on `wide_resnet-Wide_ResNet` at depth 10,
widen 1 (BatchNorm in every block, dropout 0.3).

* `compose_bn_updates` with local steps: each worker's chain of running
  states, all rooted at r0, folds to the worker-major sequential result
  over every local step's batch statistics (a float64 numpy fold, rtol
  1e-5, atol 1e-6, as `tests/test_bn.py` holds the JAX one) and equals
  the JAX `compose_bn_updates` on the same chains within 1 ulp-scale
  bound (rtol 1e-6, atol 1e-7).
* `Engine.phase_honest` at k = 2 (momentum at the update) and k = 3
  (Nesterov at the workers: the local steps start from each worker's
  lookahead) against the JAX engine's `_phase_honest`, which runs
  `_local_steps` (vmapped, as the port does at k > 1), from the same
  weights, momentum buffers, inputs and step key (the masks come from the
  key tree in both): gradient rows (the displacement over the learning
  rate) within 1e-4 relative L2 each, but a third of them within 1e-2
  (`_rows_close`: a ReLU input in a near tie), the mean loss (local step 0's)
  within rtol 1e-4 and the composed BatchNorm state within rtol 1e-4,
  atol 1e-5; the engine counts a vmapped phase.
* The device-resident batches at k = 2: `Engine.sample_indices` gives the
  JAX driver's `(S, k, B)` indices and flips (S * k batches drawn, every
  index row before any flip row) and the gather gives `jax.jit(gather)`'s
  bits (`tests/test_torch_device_data.py`); a whole
  indexed step then matches the JAX step (theta within rtol 1e-4, atol
  1e-5; the server momentum, the average of the rows, within 1e-3
  relative L2: one row of five in a ReLU near tie at 1.5e-3 moves it by
  3e-4) and counts `batch * h * k` training
  points.
* `--nb-local-steps 0` is refused by both drivers with the JAX message,
  and by `EngineConfig`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import attacks as jax_attacks
from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu import utils as jax_utils
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu.data.device import DeviceData as JaxDeviceData
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu.engine.step import (
    compose_bn_updates as jax_compose_bn_updates)
from byzantinemomentum_tpu_torch import convert, models, optim, utils
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.data.device import DeviceData
from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig
from byzantinemomentum_tpu_torch.engine.state import init_state
from byzantinemomentum_tpu_torch.engine.step import compose_bn_updates
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.models.core import BN_MOMENTUM
from byzantinemomentum_tpu_torch.ops import gars

from tests.test_torch_device_data import _splits

RTOL, ATOL = 1e-4, 1e-5
NAME = "wide_resnet-Wide_ResNet"
ARGS = {"depth": 10, "widen_factor": 1, "dropout_rate": 0.3, "num_classes": 10}
CFG = dict(nb_workers=7, nb_decl_byz=2, nb_real_byz=2, nb_for_study=0,
           momentum=0.99, gradient_clip=5.0)
LR = 0.02
B = 4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)


def _rows_close(got, want):
    """Gradient rows within 1e-4 relative L2 each, but for at most a third
    of them within 1e-2: a ReLU input within rounding of 0 flips one
    element's derivative, which moves a BatchNorm channel's gradient by
    about one part in B * H * W (1.5e-3 of a row seen at 16 x 16 x 4)."""
    rel = _rel(got, want)
    assert np.all(rel < 1e-2), rel
    assert np.sum(rel >= 1e-4) <= len(rel) // 3, rel


def _sequential_fold(r0, stats):
    r = r0.astype(np.float64)
    for s in stats:
        r = (1.0 - BN_MOMENTUM) * r + BN_MOMENTUM * s.astype(np.float64)
    return r


def test_compose_bn_updates_folds_every_local_step():
    rng = np.random.default_rng(1)
    C, S, K = 3, 4, 3
    m = BN_MOMENTUM
    r0 = rng.normal(size=(C,)).astype(np.float32)
    stats = rng.normal(size=(S, K, C)).astype(np.float32)
    chains = np.empty_like(stats)
    for w in range(S):
        prev = r0
        for j in range(K):
            prev = (1.0 - m) * prev + m * stats[w, j]
            chains[w, j] = prev
    got = compose_bn_updates({"r": torch.from_numpy(r0)},
                             {"r": torch.from_numpy(chains)}, S, K)["r"]
    np.testing.assert_allclose(got.numpy(), _sequential_fold(
        r0, stats.reshape(S * K, C)), rtol=1e-5, atol=1e-6)
    want = jax_compose_bn_updates({"r": jnp.asarray(r0)},
                                  {"r": jnp.asarray(chains)}, S, K)["r"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _engines(k, momentum_at="update", nesterov=False):
    """The JAX engine and the port's at k local steps (the average of the
    rows, which selects nothing: no near tie between two workers' values
    moves it) on the same WRN weights,
    momentum buffers and step key, each with the same device-resident
    splits attached."""
    jcfg = JaxConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov,
                     nb_local_steps=k)
    mdef = jax_models.build(NAME, **ARGS)
    jengine = build_engine(
        cfg=jcfg, model_def=mdef, loss=jax_losses.Loss("nll"),
        criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars["average"], 1.0, {})],
        attack=jax_attacks.attacks["empire"], attack_kwargs={"factor": 1.1})
    key = jax.random.PRNGKey(3)
    params, net_state = mdef.init(key)
    jstate = jengine.init(key, params=params, net_state=net_state)
    rng = np.random.default_rng(5)
    ms = (0.01 * rng.standard_normal(jengine.d)).astype(np.float32)
    mw = (0.01 * rng.standard_normal(
        (jcfg.nb_honests if momentum_at == "worker" else 0, jengine.d))
          ).astype(np.float32)
    jstate = jstate._replace(momentum_server=jnp.asarray(ms),
                             momentum_workers=jnp.asarray(mw))

    cfg = EngineConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov,
                       nb_local_steps=k)
    engine = Engine(cfg, models.build(NAME, device="cpu", **ARGS), Loss("nll"),
                    Criterion("top-k"), (gars["average"], {}), attacks["empire"],
                    {"factor": 1.1}, optim.build("sgd", weight_decay=0.0))
    theta, bn = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, net_state))
    state = dataclasses.replace(
        init_state(cfg, theta, bn,
                   torch.from_numpy(np.asarray(jstate.rng).astype(np.int64))),
        momentum_server=torch.from_numpy(ms),
        momentum_workers=torch.from_numpy(mw))
    (train, test), (jtrain, jtest) = _splits(batch=B)
    engine.attach_data(*DeviceData.pair(train, test, "cpu"))
    jengine.attach_data(*JaxDeviceData.pair(jtrain, jtest))
    return jengine, jstate, engine, state, rng


@pytest.mark.parametrize("k,momentum_at,nesterov",
                         ((2, "update", False), (3, "worker", True)))
def test_honest_phase_at_local_steps_matches_jax(k, momentum_at, nesterov):
    jengine, jstate, engine, state, rng = _engines(k, momentum_at, nesterov)
    S = engine.cfg.nb_sampled
    xs = rng.standard_normal((S, k, B, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, k, B)).astype(np.int32)
    jout = jax.jit(jengine._phase_honest)(jstate, jnp.asarray(xs),
                                          jnp.asarray(ys), jnp.float32(LR))
    G, loss, net_state, new_mw, _ = engine.phase_honest(
        state, torch.from_numpy(xs), torch.from_numpy(ys), LR)
    assert engine.counts == {"vmapped_phases": 1}
    _rows_close(G, jout[2])
    np.testing.assert_allclose(float(loss), float(jout[3]), rtol=RTOL)
    for name, value in convert.flat_items(jax.tree.map(np.asarray, jout[4])):
        np.testing.assert_allclose(net_state[name].numpy(), value, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    if momentum_at == "worker":
        _rows_close(new_mw, jout[5])


def test_indexed_step_at_two_local_steps_matches_jax():
    k = 2
    jengine, jstate, engine, state, _ = _engines(k)
    S = engine.cfg.nb_sampled
    idx, flips = engine.sample_indices()
    jidx, jflips = jengine._train_data.sample_indices(S * k)
    assert idx.shape == flips.shape == (S, k, B)
    np.testing.assert_array_equal(idx, jidx.reshape(S, k, B))
    np.testing.assert_array_equal(flips, jflips.reshape(S, k, B))
    xs, ys = engine.train_data.gather(*engine.train_data.upload(idx, flips))
    jxs, jys = jax.jit(jengine._train_data.gather)(jnp.asarray(idx),
                                                   jnp.asarray(flips))
    assert xs.shape == (S, k, B, 32, 32, 3)
    np.testing.assert_array_equal(xs.numpy().view(np.int32),
                                  np.asarray(jxs).view(np.int32))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    jnew, _ = jax.jit(jengine.train_step_indexed)(
        jstate, jnp.asarray(idx), jnp.asarray(flips), jnp.float32(LR))
    new, _ = engine.train_step_indexed(state, idx, flips, LR)
    assert engine.counts == {"indexed_steps": 1, "vmapped_phases": 1}
    np.testing.assert_allclose(new.theta.numpy(), np.asarray(jnew.theta),
                               rtol=RTOL, atol=ATOL)
    assert _rel(new.momentum_server, jnew.momentum_server) < 1e-3
    assert (new.steps, new.datapoints) == (1, B * engine.cfg.nb_honests * k)
    assert int(jnew.datapoints) == new.datapoints


def test_non_positive_local_steps_are_refused():
    argv = ["--device", "cpu", "--nb-steps", "1", "--nb-local-steps", "0"]
    message = "Invalid arguments: non-positive number of local steps 0"
    with pytest.raises(jax_utils.UserException, match=message):
        jax_main(argv)
    with pytest.raises(utils.UserException, match=message):
        driver.run(argv)
    with pytest.raises(ValueError, match="Non-positive number of local steps"):
        EngineConfig(nb_local_steps=0)
