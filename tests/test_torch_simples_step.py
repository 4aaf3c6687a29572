"""Parity of the PyTorch port's training step with the JAX package's on
the MNIST grid's models (`tests/test_torch_engine.py`'s pattern).

One step at n=11, f=2 (2 real Byzantine workers), batch 4, 11 sampled
gradients, clip 2, on `simples-full` and `simples-conv` (no dropout, so
no masks to carry across): each of the paper's six GARs (Krum, Median,
Trimmed mean, Phocas, MeaMed, Bulyan) against `little` (factor 1.5,
negative) and against `nan`, with momentum at the update; and Bulyan
against `little` with momentum at the server and at the workers (with
the Nesterov lookahead). Both packages take the grouped honest phase
(both models have a grouped forward) from the same weights, momentum
buffers and past ring:

* the honest phase: gradient rows, loss and the momentum buffers;
* the defense and update phases, fed the same JAX honest rows: the
  attack rows (NaN positions exact), the aggregate, new theta and
  momentum, and all 24 study columns.

Tolerance rtol 1e-4, atol 1e-5; the study's dot-product columns rtol
2e-3, as in `tests/test_torch_engine.py`.
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
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.ops import gars

from tests.test_torch_engine import _close
from tests.torch_threads import one_torch_thread  # noqa: F401

N, F, B, LR = 11, 2, 4, 0.05
CFG = dict(nb_workers=N, nb_decl_byz=F, nb_real_byz=F, nb_for_study=11,
           nb_for_study_past=2, momentum=0.9, dampening=0.0,
           gradient_clip=2.0, weight_decay=1e-4)
ATTACKS = {"little": {"factor": 1.5, "negative": True}, "nan": {}}
CASES = ([(gar, attack, "update", False)
          for gar in ("krum", "median", "trmean", "phocas", "meamed", "bulyan")
          for attack in ATTACKS]
         + [("bulyan", "little", "server", False),
            ("bulyan", "little", "worker", True)])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_honest():
    """The JAX honest phase's outputs by (model, momentum placement, Nesterov):
    the phase does not depend on the GAR or the attack, so the cases of
    one configuration share one run of it (eager JAX on the CPU, the
    longest part of a case)."""
    return {}


@pytest.mark.parametrize("model_name", ("simples-full", "simples-conv"))
@pytest.mark.parametrize(
    "gar,attack,momentum_at,nesterov", CASES,
    ids=[f"{gar}-{attack}-{at}{'-nesterov' * nesterov}"
         for gar, attack, at, nesterov in CASES])
def test_step_matches_jax(model_name, gar, attack, momentum_at, nesterov,
                          jax_honest):
    jcfg = JaxConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov)
    mdef = jax_models.build(model_name)
    jengine = build_engine(
        cfg=jcfg, model_def=mdef, loss=jax_losses.Loss("nll"),
        criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars[gar], 1.0, {})],
        attack=jax_attacks.attacks[attack], attack_kwargs=ATTACKS[attack])
    key = jax.random.PRNGKey(3)
    params, net_state = mdef.init(key)
    jstate = jengine.init(key, params=params, net_state=net_state)
    d, h, S = jengine.d, jcfg.nb_honests, jcfg.nb_sampled
    rng = np.random.default_rng(5)
    ms = (0.01 * rng.standard_normal(d)).astype(np.float32)
    mw = (0.01 * rng.standard_normal(
        (h if momentum_at == "worker" else 0, d))).astype(np.float32)
    past = (0.01 * rng.standard_normal((2, d))).astype(np.float32)
    past_norms = np.linalg.norm(past, axis=1).astype(np.float32)
    jstate = jstate._replace(
        momentum_server=jnp.asarray(ms), momentum_workers=jnp.asarray(mw),
        past_grads=jnp.asarray(past), past_norms=jnp.asarray(past_norms),
        past_count=jnp.int32(1))
    xs = rng.standard_normal((S, B, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, B)).astype(np.int32)

    cfg = EngineConfig(**CFG, momentum_at=momentum_at, nesterov=nesterov)
    engine = Engine(cfg, models.build(model_name, device="cpu"), Loss("nll"),
                    Criterion("top-k"), [(gars[gar], 1.0, {})],
                    attacks[attack], ATTACKS[attack],
                    optim.build("sgd", weight_decay=cfg.weight_decay))
    theta, bn = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, net_state))
    state = init_state(cfg, theta, bn,
                       torch.from_numpy(np.asarray(jstate.rng).astype(np.int64)))
    state = type(state)(**{**state.__dict__, "momentum_server": _t(ms),
                           "momentum_workers": _t(mw), "past_grads": _t(past),
                           "past_norms": _t(past_norms),
                           "past_count": torch.tensor(1, dtype=torch.int32)})

    shared = (model_name, momentum_at, nesterov)
    if shared not in jax_honest:
        jax_honest[shared] = jengine._phase_honest(
            jstate, jnp.asarray(xs), jnp.asarray(ys), LR)
    (_, mix_key, jG_sampled, jloss, jnet, jmw, jG_honest, _, _) = \
        jax_honest[shared]
    G_sampled, loss_avg, net, new_mw, G_honest = engine.phase_honest(
        state, _t(xs), _t(ys), LR)
    assert engine.counts == {"grouped_phases": 1} and net == {}
    _close(G_sampled, jG_sampled)
    _close(loss_avg, jloss)
    _close(new_mw, jmw)
    _close(G_honest, jG_honest)

    (jG_attack, jdef, jratio, _, _, _) = jengine._phase_defense(jG_honest, mix_key)
    jnew, jmetrics = jengine._phase_update(
        jstate, None, jG_sampled, jloss, jnet, jmw, jG_honest, jG_attack,
        jdef, jratio, LR, B)
    G_attack, grad_def, ratio, attack_state = engine.phase_defense(
        _t(jG_honest), state.attack_state)
    _close(G_attack, jG_attack)
    assert bool(G_attack.isnan().all()) == (attack == "nan")
    _close(grad_def, jdef)
    assert bool(torch.isfinite(grad_def).all())
    assert np.isfinite(ratio) == (gar == "krum") == np.isfinite(float(jratio))
    if gar == "krum":
        _close(ratio, jratio)
    new, metrics = engine.phase_update(
        state, _t(jG_sampled), _t(jloss), {}, _t(jmw), _t(jG_honest),
        G_attack, grad_def, ratio, attack_state, LR, B)
    _close(new.theta, jnew.theta)
    _close(new.momentum_server, jnew.momentum_server)
    _close(new.momentum_workers, jnew.momentum_workers)
    _close(new.past_grads, jnew.past_grads)
    assert (new.steps, new.datapoints, new.past_count) == (
        int(jnew.steps), int(jnew.datapoints), int(jnew.past_count))
    for column in STUDY_COLUMNS[2:]:
        dot_column = "cosine" in column or "curvature" in column
        _close(torch.as_tensor(metrics[column]), jmetrics[column],
               rtol=2e-3 if dot_column else 1e-4)
