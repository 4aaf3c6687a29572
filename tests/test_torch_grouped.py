"""The PyTorch port's grouped honest phase against the JAX package's and
against the port's vmapped one.

* `EmpireCNN.forward_grouped` (S = 3 workers, each with its own weights,
  batch 4) against the JAX `apply_grouped` and against S calls of the
  port's own `forward`, on the JAX dropout masks and shared running
  stats: log-probabilities, the per-worker BatchNorm states `(S, C)` and
  the gradient rows of the summed per-worker losses, in train and eval
  mode. Tolerance rtol 1e-4, atol 1e-5 (`tests/test_torch_model.py`'s),
  gradient rows with the max-pool near-tie allowance of
  `tests/test_torch_engine.py::_close_rows`.
* `Engine.phase_honest` (n=11, f=2, 11 sampled rows, clip 5), grouped
  and vmapped (`grouped_workers=False`), against the JAX engine's (grouped
  too), for momentum at the update, Nesterov at the server and Nesterov
  at the workers, on `tests/test_torch_engine.py`'s inputs and at its
  tolerances (rows with the near-tie allowance; losses, BatchNorm state
  and momentum buffers at rtol 1e-4, atol 1e-5). The share of rows in a
  near tie depends on the inputs: another draw put 4 of 11 rows of the
  grouped phase (and 2 of the vmapped one) in one, each within 3e-3
  relative L2 of the JAX row.
* The same three placements in float64, grouped against vmapped: no ReLU
  input lies within rounding of 0 there, so every value agrees within
  rtol 1e-9, atol 1e-12.
* bf16-mixed (`dtype="float32", compute_dtype="bfloat16"`, momentum at
  the update, `tests/test_torch_dtype.py`'s inputs): each program's rows
  are held to the JAX mixed rows as that file holds them
  (`_half_rows_close`: within 1.5x the JAX rows' distance from their f32
  rows, and within 2x that distance of the JAX rows). The grouped rows
  against the vmapped ones: each within 0.5x the vmapped row's distance
  from its f32 row (8-18%), and their mean distance from their own f32
  rows within 1.5x the vmapped rows' mean. (The two programs make the
  same convolution and matmul calls, so on the CPU they agree bit for
  bit; `tests/test_torch_gpu.py` holds them on the card, where a max-pool
  near tie between them is ruled out by pooling both from one argmax.)
  Losses and BatchNorm state within rtol 2e-2.
* `forward_grouped` with `shared=True` (every worker on worker 0's
  parameters: the forward and input gradients as one convolution or
  matmul over all workers' inputs) against `shared=False` on the same
  parameters, in float64 and f32: outputs, BatchNorm states and gradient
  rows at rtol 1e-9/1e-4, atol 1e-12/1e-5.
"""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import attacks as jax_attacks
from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu_torch import convert, models, optim, prng
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig
from byzantinemomentum_tpu_torch.engine.state import init_state
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.models import FlatParams
from byzantinemomentum_tpu_torch.ops import gars

from tests.test_torch_dtype import _engines as _dtype_engines
from tests.test_torch_dtype import _half_rows_close, _rel, _values_close
from tests.test_torch_engine import CFG, LR, _close, _close_rows
from tests.test_torch_model import jax_masks

RTOL, ATOL = 1e-4, 1e-5
MIXED = {"dtype": "float32", "compute_dtype": "bfloat16"}


def _mask_stacks(keys, batch):
    masks = [jax_masks(k, batch) for k in keys]
    return tuple(torch.from_numpy(np.stack(m)) for m in zip(*masks))


@pytest.mark.parametrize("train", (True, False))
def test_forward_grouped_matches_apply_grouped_and_forward(train):
    S, B = 3, 4
    mdef = jax_models.build("empire-cnn")
    inits = [mdef.init(k) for k in jax.random.split(jax.random.PRNGKey(1), S)]
    rng = np.random.default_rng(1)
    state = jax.tree.map(lambda leaf: rng.uniform(
        0.5, 1.5, leaf.shape).astype(np.float32), inits[0][1])
    params = [jax.tree.map(np.asarray, p) for p, _ in inits]
    params_s = jax.tree.map(lambda *leaves: jnp.stack(leaves), *params)
    xs = rng.standard_normal((S, B, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, B)).astype(np.int32)
    wkeys = jax.random.split(jax.random.PRNGKey(7), S)
    nll = jax_losses.Loss("nll")

    def loss_j(params_s):
        out, new_state = mdef.apply_grouped(
            params_s, state, jnp.asarray(xs), train=train,
            rng=wkeys if train else None)
        per_worker = jax.vmap(lambda o, y: nll(o, y, None))(out, jnp.asarray(ys))
        return jnp.sum(per_worker), (out, new_state)

    (_, (jout, jstate)), jgrads = jax.value_and_grad(
        loss_j, has_aux=True)(params_s)
    jrows = np.stack([np.asarray(jax.flatten_util.ravel_pytree(
        jax.tree.map(lambda leaf, s=s: leaf[s], jgrads))[0]) for s in range(S)])

    model = models.build("empire-cnn", device="cpu")
    flat = FlatParams(model)
    theta_s = torch.stack([convert.params_from_jax(p, state)[0] for p in params])
    bn = convert.params_from_jax(params[0], state)[1]
    masks = _mask_stacks(wkeys, B) if train else None
    th_s = theta_s.clone().requires_grad_()
    out, new_state = model.forward_grouped(
        flat.unflatten_stacked(th_s), bn, torch.from_numpy(xs), train, masks)
    losses = torch.func.vmap(Loss("nll"))(out, torch.from_numpy(ys), th_s)
    (rows,) = torch.autograd.grad(losses.sum(), th_s)
    assert out.shape == (S, B, 10)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    _close_rows(rows, jrows)
    for name, value in convert.flat_items(jax.tree.map(np.asarray, jstate)):
        assert new_state[name].shape == value.shape
        np.testing.assert_allclose(new_state[name].numpy(), value, rtol=RTOL,
                                   atol=ATOL)

    # S calls of the port's own forward give the same function
    for s in range(S):
        th = theta_s[s].clone().requires_grad_()
        out_s, state_s = torch.func.functional_call(
            model, {**flat.unflatten(th), **bn}, (torch.from_numpy(xs[s]),),
            {"train": train,
             "masks": tuple(m[s] for m in masks) if train else None})
        (row,) = torch.autograd.grad(
            Loss("nll")(out_s, torch.from_numpy(ys[s]), th), th)
        np.testing.assert_allclose(out[s].detach().numpy(),
                                   out_s.detach().numpy(), rtol=RTOL, atol=ATOL)
        _close_rows(rows[s:s + 1], row[None])
        for layer, stats in state_s.items():
            for stat, value in stats.items():
                got = new_state[f"{layer}.{stat}"]
                np.testing.assert_allclose((got[s] if train else got).numpy(),
                                           value.numpy(), rtol=RTOL, atol=ATOL)


def _setup(momentum_at, nesterov):
    """The JAX engine's honest phase (grouped) and the port's grouped and
    vmapped ones on the same weights, momentum buffers, inputs and JAX
    dropout masks: the draws of `tests/test_torch_engine.py`."""
    jcfg = JaxConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov)
    mdef = jax_models.build("empire-cnn")
    jengine = build_engine(
        cfg=jcfg, model_def=mdef, loss=jax_losses.Loss("nll"),
        criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars["bulyan"], 1.0, {})],
        attack=jax_attacks.attacks["empire"], attack_kwargs={"factor": 1.1})
    key = jax.random.PRNGKey(3)
    params, net_state = mdef.init(key)
    jstate = jengine.init(key, params=params, net_state=net_state)
    d, h, S = jengine.d, jcfg.nb_honests, jcfg.nb_sampled
    rng = np.random.default_rng(5)
    ms = (0.01 * rng.standard_normal(d)).astype(np.float32)
    mw = (0.01 * rng.standard_normal(
        (h if momentum_at == "worker" else 0, d))).astype(np.float32)
    rng.standard_normal((2, d))  # the engine test's past ring
    jstate = jstate._replace(momentum_server=jnp.asarray(ms),
                             momentum_workers=jnp.asarray(mw))
    xs = rng.standard_normal((S, 4, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, 4)).astype(np.int32)
    _, _, *wkeys = jax.random.split(jstate.rng, S + 2)
    jout = jengine._phase_honest(jstate, jnp.asarray(xs), jnp.asarray(ys), LR)
    grouped, vmapped = _port_phases(momentum_at, nesterov, params, net_state,
                                    ms, mw, xs, ys, _mask_stacks(wkeys, 4))
    # (G_sampled, loss, net_state, new_mw, G_honest) of each
    return (jout[2], jout[3], jout[4], jout[5], jout[6]), grouped, vmapped


def _port_phases(momentum_at, nesterov, params, net_state, ms, mw, xs, ys,
                 masks, **dtypes):
    """The port's grouped and vmapped honest phases of one configuration
    on the same inputs, in the parameter dtype."""
    cfg = EngineConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov,
                       **dtypes)
    pdt = cfg.torch_dtype
    theta, bn = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, net_state),
                                        dtype=pdt)
    state = dataclasses.replace(
        init_state(cfg, theta, bn),
        momentum_server=torch.from_numpy(ms).to(pdt),
        momentum_workers=torch.from_numpy(mw).to(pdt))
    outs = []
    for c, path in ((cfg, "grouped_phases"),
                    (dataclasses.replace(cfg, grouped_workers=False),
                     "vmapped_phases")):
        engine = Engine(c, models.build("empire-cnn", device="cpu", dtype=pdt),
                        Loss("nll"), Criterion("top-k"), (gars["bulyan"], {}),
                        attacks["empire"], {"factor": 1.1},
                        optim.build("sgd", weight_decay=c.weight_decay))
        outs.append(engine.phase_honest(state, torch.from_numpy(xs),
                                        torch.from_numpy(ys), LR, masks))
        assert engine.counts == {path: 1}
    return outs


PLACEMENTS = (("update", False), ("server", True), ("worker", True))


@pytest.mark.parametrize("momentum_at,nesterov", PLACEMENTS)
def test_grouped_and_vmapped_phases_match_jax(momentum_at, nesterov):
    jax_out, *ports = _setup(momentum_at, nesterov)
    jG, jloss, jnet, jmw, jG_honest = jax_out
    for G, loss, net, mw, G_honest in ports:
        _close_rows(G, jG)
        _close(loss, jloss)
        _close_rows(mw, jmw)
        _close_rows(G_honest, jG_honest)
        for name, value in convert.flat_items(jax.tree.map(np.asarray, jnet)):
            _close(net[name], value)


@pytest.mark.parametrize("momentum_at,nesterov", PLACEMENTS)
def test_grouped_phase_equals_vmapped_in_float64(momentum_at, nesterov):
    """In float64 no ReLU input lies within rounding of 0, so no max-pool
    near tie can split the two programs: every value within 1e-9."""
    mdef = jax_models.build("empire-cnn")
    params, net_state = mdef.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(6)
    d, S = mdef.param_count(), CFG["nb_workers"]
    h = S - CFG["nb_real_byz"]
    ms = 0.01 * rng.standard_normal(d)
    mw = 0.01 * rng.standard_normal((h if momentum_at == "worker" else 0, d))
    xs = rng.standard_normal((S, 4, 32, 32, 3))
    ys = rng.integers(0, 10, size=(S, 4))
    masks = tuple(torch.from_numpy(rng.random((S,) + shape) < 0.75) for shape in
                  models.build("empire-cnn", device="cpu").mask_shapes(4))
    grouped, vmapped = _port_phases(momentum_at, nesterov, params, net_state,
                                    ms, mw, xs, ys, masks, dtype="float64")
    assert grouped[0].dtype == torch.float64
    for got, want in zip(grouped, vmapped):
        if isinstance(got, dict):
            for name in want:
                torch.testing.assert_close(got[name], want[name], rtol=1e-9,
                                           atol=1e-12)
        else:
            torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


def test_mixed_grouped_and_vmapped_phases_match_jax():
    """bf16-mixed, momentum at the update, on `tests/test_torch_dtype.py`'s
    inputs (the mixed step's own test)."""
    jengine, jstate, engine, state, xs, ys, masks = _dtype_engines(
        "bulyan", **MIXED)
    jengine32, jstate32, engine32, state32, _, _, _ = _dtype_engines("bulyan")
    jout = jengine._phase_honest(jstate, jnp.asarray(xs), jnp.asarray(ys), LR)
    jG32 = jengine32._phase_honest(jstate32, jnp.asarray(xs), jnp.asarray(ys),
                                   LR)[2]
    params = jax.tree.map(np.asarray, jengine.unravel(jstate.theta))
    net_state = jax.tree.map(np.asarray, jstate.net_state)
    empty = np.zeros((0, jengine.d), np.float32)
    ms = np.zeros(jengine.d, np.float32)
    args = (params, net_state, ms, empty, xs, ys, masks)
    grouped, vmapped = _port_phases("update", False, *args, **MIXED)
    grouped32, vmapped32 = _port_phases("update", False, *args)
    assert grouped[0].dtype == vmapped[0].dtype == torch.float32
    assert grouped[1].dtype == vmapped[1].dtype == torch.bfloat16
    _half_rows_close(vmapped[0], jout[2], vmapped32[0], jG32)
    _half_rows_close(grouped[0], jout[2], grouped32[0], jG32)
    err = _rel(vmapped[0], vmapped32[0])
    assert np.all(_rel(grouped[0], vmapped[0]) <= 0.5 * err)
    assert _rel(grouped[0], grouped32[0]).mean() <= 1.5 * err.mean()
    for got in (grouped, vmapped):
        _values_close(got[1], jout[3], 2e-2)
        for name, value in convert.flat_items(jout[4]):
            assert got[2][name].dtype == torch.float32
            _values_close(got[2][name], value, 2e-2)


@pytest.mark.parametrize("dtype,rtol,atol", ((torch.float64, 1e-9, 1e-12),
                                             (torch.float32, RTOL, ATOL)))
@pytest.mark.parametrize("train", (True, False))
def test_forward_grouped_shared_equals_per_worker(dtype, rtol, atol, train):
    S, B = 3, 4
    model = models.build("empire-cnn", device="cpu", dtype=dtype)
    model.init(prng.PRNGKey(3))
    flat = FlatParams(model)
    theta = flat.flatten(dict(model.named_parameters())).detach()
    bn = {name: buf.detach() for name, buf in model.named_buffers()}
    rng = np.random.default_rng(8)
    xs = torch.from_numpy(rng.standard_normal((S, B, 32, 32, 3))).to(dtype)
    ys = torch.from_numpy(rng.integers(0, 10, size=(S, B)))
    masks = tuple(torch.from_numpy(rng.random((S,) + shape) < 0.75)
                  for shape in model.mask_shapes(B)) if train else None
    results = []
    for shared in (True, False):
        th_s = theta.expand(S, -1).clone().requires_grad_()
        out, state = model.forward_grouped(flat.unflatten_stacked(th_s), bn,
                                           xs, train, masks, shared=shared)
        losses = torch.func.vmap(Loss("nll"))(out, ys, th_s)
        (rows,) = torch.autograd.grad(losses.sum(), th_s)
        results.append((out.detach(), state, rows))
    (out, state, rows), (want_out, want_state, want_rows) = results
    assert out.dtype == rows.dtype == dtype
    torch.testing.assert_close(out, want_out, rtol=rtol, atol=atol)
    torch.testing.assert_close(rows, want_rows, rtol=rtol, atol=atol)
    for name in want_state:
        torch.testing.assert_close(state[name], want_state[name], rtol=rtol,
                                   atol=atol)
