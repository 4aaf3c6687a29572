"""Parity of the PyTorch port's training step with the JAX package's.

One step at n=11, f=2 (2 real Byzantine workers against `empire(1.1)`),
batch 4, 11 sampled gradients, clip 5: Bulyan for every momentum
placement with and without the Nesterov lookahead, and each of Krum,
Median, Trimmed mean, Phocas, MeaMed, Aksel, Brute and CGE with momentum
at the update. Both packages start
from the same weights (`convert.params_from_jax`), the same momentum
buffers and past ring, and the port gets the JAX dropout masks of each
worker's key:

* the honest phase is held per worker: gradients, losses, the composed
  BatchNorm state, the momentum buffers and the submitted rows (gradient
  rows with the near-tie allowance of `_close_rows`);
* the defense and update phases are held by feeding both packages the
  same JAX honest outputs: new theta, momentum buffers and all 24 study
  columns.

Tolerance rtol 1e-4, atol 1e-5 (convolution and BatchNorm sums in another
order); NaN positions exact.
"""

import jax
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
from byzantinemomentum_tpu_torch import convert, models, optim
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig
from byzantinemomentum_tpu_torch.engine.metrics import STUDY_COLUMNS
from byzantinemomentum_tpu_torch.engine.state import init_state
from byzantinemomentum_tpu_torch.engine.step import compose_bn_updates
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.ops import gars

from tests.test_torch_model import jax_masks
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
N, F, F_REAL, B, LR = 11, 2, 2, 4, 0.05
CFG = dict(nb_workers=N, nb_decl_byz=F, nb_real_byz=F_REAL, nb_for_study=11,
           nb_for_study_past=2, momentum=0.99, dampening=0.0,
           gradient_clip=5.0, weight_decay=1e-4)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


def _close_rows(got, want):
    """Gradient rows: elementwise as `_close`, except that a row may
    instead sit within 1e-2 relative L2 of the JAX row. A ReLU
    pre-activation within rounding of 0 can change which element of a
    max-pool window wins (a genuine near-tie), which moves that worker's
    early-convolution gradient by up to a few 1e-3 of the row's norm; at
    most a third of the rows may take that exception."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    exact = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=1)
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.all(exact | (rel < 1e-2)), rel
    assert np.sum(~exact) <= len(want) // 3, rel


def _t(x):
    return torch.from_numpy(np.array(x))


def test_compose_bn_updates_equals_sequential_fold():
    rng = np.random.default_rng(0)
    r0 = {"b.mean": _t(rng.standard_normal(6).astype(np.float32))}
    batch_stats = rng.standard_normal((5, 6)).astype(np.float32)
    # Each worker's update starts from r0, as the batched honest phase has it
    stack = 0.9 * r0["b.mean"] + 0.1 * _t(batch_stats)
    r = r0["b.mean"].clone()
    for s in batch_stats:
        r = 0.9 * r + 0.1 * _t(s)
    got = compose_bn_updates(r0, {"b.mean": stack}, 5)["b.mean"]
    np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-5, atol=1e-6)


STEP_CASES = ([("bulyan", momentum_at, nesterov)
               for nesterov in (False, True)
               for momentum_at in ("update", "server", "worker")]
              + [(gar, "update", False) for gar in
                 ("krum", "median", "trmean", "phocas", "meamed", "aksel",
                  "brute", "cge")])


@pytest.fixture(scope="module")
def jax_honest():
    """The JAX honest phase's outputs by (momentum placement, Nesterov):
    the phase does not depend on the GAR or the attack, so the cases of
    one configuration share one run of it (eager JAX on the CPU, the
    longest part of a case)."""
    return {}


@pytest.mark.parametrize(
    "gar,momentum_at,nesterov", STEP_CASES,
    ids=[f"{nesterov}-{momentum_at}" if gar == "bulyan" else f"{gar}-{momentum_at}"
         for gar, momentum_at, nesterov in STEP_CASES])
def test_step_matches_jax(gar, momentum_at, nesterov, jax_honest):
    jcfg = JaxConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov)
    mdef = jax_models.build("empire-cnn")
    jengine = build_engine(
        cfg=jcfg, model_def=mdef, loss=jax_losses.Loss("nll"),
        criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars[gar], 1.0, {})],
        attack=jax_attacks.attacks["empire"], attack_kwargs={"factor": 1.1})
    key = jax.random.PRNGKey(3)
    params, net_state = mdef.init(key)
    jstate = jengine.init(key, params=params, net_state=net_state)
    d, h, S = jengine.d, jcfg.nb_honests, jcfg.nb_sampled
    rng = np.random.default_rng(5)
    ms = (0.01 * rng.standard_normal(d)).astype(np.float32)
    mw = (0.01 * rng.standard_normal((h if momentum_at == "worker" else 0, d))).astype(np.float32)
    past = (0.01 * rng.standard_normal((2, d))).astype(np.float32)
    past_norms = np.linalg.norm(past, axis=1).astype(np.float32)
    jstate = jstate._replace(
        momentum_server=jnp.asarray(ms), momentum_workers=jnp.asarray(mw),
        past_grads=jnp.asarray(past), past_norms=jnp.asarray(past_norms),
        past_count=jnp.int32(1))
    xs = rng.standard_normal((S, B, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, B)).astype(np.int32)

    cfg = EngineConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov)
    model = models.build("empire-cnn", device="cpu")
    engine = Engine(cfg, model, Loss("nll"), Criterion("top-k"),
                    [(gars[gar], 1.0, {})], attacks["empire"],
                    {"factor": 1.1},
                    optim.build("sgd", weight_decay=cfg.weight_decay))
    theta, bn = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, net_state))
    state = init_state(cfg, theta, bn)
    state = type(state)(**{**state.__dict__, "momentum_server": _t(ms),
                           "momentum_workers": _t(mw), "past_grads": _t(past),
                           "past_norms": _t(past_norms),
                           "past_count": torch.tensor(1, dtype=torch.int32)})

    # --- honest phase, per worker, on the JAX dropout masks --- #
    _, _, *wkeys = jax.random.split(jstate.rng, S + 2)
    masks = [jax_masks(k, B) for k in wkeys]
    masks = tuple(_t(np.stack(m)) for m in zip(*masks))
    shared = (momentum_at, nesterov)
    if shared not in jax_honest:
        jax_honest[shared] = jengine._phase_honest(
            jstate, jnp.asarray(xs), jnp.asarray(ys), LR)
    (_, mix_key, jG_sampled, jloss, jnet, jmw, jG_honest, _, _) = \
        jax_honest[shared]
    G_sampled, loss_avg, net, new_mw, G_honest = engine.phase_honest(
        state, _t(xs), _t(ys), LR, masks)
    _close_rows(G_sampled, jG_sampled)
    _close(loss_avg, jloss)
    _close_rows(new_mw, jmw)
    _close_rows(G_honest, jG_honest)
    for name, value in convert.flat_items(jax.tree.map(np.asarray, jnet)):
        _close(net[name], value)

    # --- defense + update on the same JAX honest outputs --- #
    (jG_attack, jdef, jratio, _, _, _) = jengine._phase_defense(jG_honest, mix_key)
    jnew, jmetrics = jengine._phase_update(
        jstate, None, jG_sampled, jloss, jnet, jmw, jG_honest, jG_attack,
        jdef, jratio, LR, B)
    G_attack, grad_def, ratio, attack_state = engine.phase_defense(
        _t(jG_honest), state.attack_state)
    _close(G_attack, jG_attack)
    _close(grad_def, jdef)
    # Krum, Aksel, Brute and CGE select rows, so they have an acceptation
    # ratio
    assert np.isfinite(ratio) == (gar in ("krum", "aksel", "brute", "cge")) \
        == np.isfinite(float(jratio))
    net_t = {name: _t(v) for name, v in convert.flat_items(jax.tree.map(np.asarray, jnet))}
    new, metrics = engine.phase_update(
        state, _t(jG_sampled), _t(jloss), net_t, _t(jmw), _t(jG_honest),
        G_attack, grad_def, ratio, attack_state, LR, B)
    _close(new.theta, jnew.theta)
    _close(new.momentum_server, jnew.momentum_server)
    _close(new.momentum_workers, jnew.momentum_workers)
    _close(new.past_grads, jnew.past_grads)
    assert (new.steps, new.datapoints, new.past_count) == (
        int(jnew.steps), int(jnew.datapoints), int(jnew.past_count))
    assert set(metrics) == set(STUDY_COLUMNS[2:])
    for column in STUDY_COLUMNS[2:]:
        # The JAX package's CPU dot sums d = 1.3M products sequentially in
        # f32 (measured 1.5e-4 relative error against a float64 sum), and
        # a cosine near -1 amplifies it: the dot-product columns are held
        # to the JAX values at rtol 2e-3, and to a float64 oracle below
        # at rtol 1e-5
        dot_column = "cosine" in column or "curvature" in column
        _close(torch.as_tensor(metrics[column]), jmetrics[column],
               rtol=2e-3 if dot_column else RTOL)
    avgs = {name: np.asarray(rows, np.float64).mean(axis=0) for name, rows in (
        ("Sampled", jG_sampled), ("Honest", jG_honest), ("Attack", G_attack))}
    avgs["Defense"] = grad_def.numpy().astype(np.float64)
    for a, b in (("Sampled", "Honest"), ("Sampled", "Attack"), ("Sampled", "Defense"),
                 ("Honest", "Attack"), ("Honest", "Defense"), ("Attack", "Defense")):
        va, vb = avgs[a], avgs[b]
        want = va @ vb / np.linalg.norm(va) / np.linalg.norm(vb)
        np.testing.assert_allclose(float(metrics[f"{a}-{b.lower()} cosine"]), want,
                                   rtol=1e-5)
