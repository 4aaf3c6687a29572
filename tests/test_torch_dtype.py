"""Half precision in the PyTorch port (`--dtype`, `--compute-dtype`) against
the JAX package.

* The bf16 and f16 forms of kernels 5-8 (`colsort`, `lower_median`,
  `trimmed_mean`, `closest_mean`): the port's wrappers, which run their
  plain versions on a CPU tensor, against the JAX Pallas kernels in
  interpret mode, on a ragged d = 301 with NaN rows, +-inf and ties.
  `colsort` and `lower_median` only move values, so they must match bit
  for bit (NaN positions, then the bits of every other value);
  `trimmed_mean` and `closest_mean` round after every add and divide, as
  the JAX kernels do in the storage dtype, but XLA on the CPU may carry a
  fused half chain at f32 and round once, so they are held within 2 ulps
  of the dtype (rtol 2^-7 for bf16, 2^-10 for f16), NaN and +-inf
  positions exact. `closest_mean`'s tie rule is also held exactly on
  values from a grid on which every deviation is exact in the dtype.
* One training step at `dtype="bfloat16"` with Median (n=11, f=2, 2 real
  Byzantine workers against `empire(1.1)`) and one at `dtype="float32",
  compute_dtype="bfloat16"` with Bulyan, against the JAX engine, from the
  same weights and dropout masks. A bf16 forward and backward at batch 4
  puts each gradient row 7-17% (relative L2) away from the f32 row in
  both packages, and the two round the convolutions' and BatchNorm's
  intermediate values at other places, so the rows are held to the f32
  reference instead: each of the port's half rows must be within 1.5x
  the JAX half row's distance from the JAX f32 row, and within 2x that
  distance from the JAX half row. The defense and update, fed the same
  JAX honest outputs, are held within rtol 2e-2
  (`tests/test_dtype.py`'s bf16 tolerance, 8 significant bits), the
  study columns within 3e-2. The attack rows and the aggregate are held
  within 2e-2 relative L2 (the bf16 bound of `tests/test_dtype.py`); the
  port rounds a Python scalar to the half dtype before it applies it, as
  JAX's weak typing does (`utils.weak_scalar`), and both come out bit for
  bit equal here. The mixed step's rows are also held to the port's own
  f32 step the same way: close, not bit-identical.
* Scalars (bf16 and f16): `utils.weak_scalar` rounds 1.1 to 1.1015625 and
  0.99 to 0.98828125 in bf16; the fixed-factor attacks (`empire(1.1)`,
  `little(1.5, negative)`, `bulyan(1.1)`, `empire-strict(3)`) give the
  JAX rows bit for bit; the per-row clip, and the update's momentum,
  dampening, learning rate and weight decay at each momentum placement
  give the JAX values bit for bit.
* The state's dtypes stay the parameter dtype over two steps.
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
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu.engine.step import _clip_rows
from byzantinemomentum_tpu.ops import pallas_sort
from byzantinemomentum_tpu_torch import convert, models, optim, prng
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig
from byzantinemomentum_tpu_torch.engine.metrics import STUDY_COLUMNS
from byzantinemomentum_tpu_torch.engine.state import init_state
from byzantinemomentum_tpu_torch.engine.step import clip_rows
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.utils import weak_scalar
from byzantinemomentum_tpu_torch.ops import gars, sort_kernels

from tests.test_torch_brute_cge import D, _kernel_input
from tests.test_torch_model import jax_masks

HALF = {"bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7, 2.0 ** -133),
        "f16": (jnp.float16, torch.float16, 2.0 ** -10, 2.0 ** -24)}


def _pair(g32, name):
    """The same half values as a JAX array and a torch tensor."""
    jdt, tdt, _, _ = HALF[name]
    gj = jnp.asarray(g32).astype(jdt)
    return gj, torch.from_numpy(np.array(gj.astype(jnp.float32))).to(tdt)


def _host(x):
    """f32 numpy values of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_exact(got, want, name):
    assert got.dtype == HALF[name][1]
    got, want = _host(got), _host(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.uint32),
                                  want[keep].view(np.uint32))


def _assert_ulps(got, want, name):
    """Within 2 ulps of the dtype; NaN and +-inf positions exact."""
    assert got.dtype == HALF[name][1]
    _, _, rtol, tiny = HALF[name]
    got, want = _host(got), _host(want)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=2 * tiny)


HALF_NS = (2, 9, 25)


@pytest.mark.parametrize("name", HALF)
@pytest.mark.parametrize("n", HALF_NS + (64,))
def test_half_lower_median_matches_pallas_bit_for_bit(n, name):
    gj, gt = _pair(_kernel_input(n, seed=600 + n), name)
    _assert_exact(sort_kernels.lower_median(gt),
                  pallas_sort.lower_median(gj, interpret=True), name)


@pytest.mark.parametrize("name", HALF)
@pytest.mark.parametrize("n", HALF_NS)
def test_half_colsort_matches_pallas_bit_for_bit(n, name):
    gj, gt = _pair(_kernel_input(n, seed=700 + n), name)
    got = sort_kernels.colsort(gt)
    assert got.shape == gt.shape
    _assert_exact(got, pallas_sort.colsort(gj, interpret=True), name)


@pytest.mark.parametrize("name", HALF)
@pytest.mark.parametrize("n,f", ((2, 0), (9, 4), (25, 5), (25, 11)))
def test_half_trimmed_mean_matches_pallas(n, f, name):
    gj, gt = _pair(_kernel_input(n, seed=800 + n), name)
    _assert_ulps(sort_kernels.trimmed_mean(gt, f),
                 pallas_sort.trimmed_mean(gj, f, interpret=True), name)


@pytest.mark.parametrize("name", HALF)
@pytest.mark.parametrize("n,m", ((2, 1), (9, 5), (25, 14), (25, 25)))
def test_half_closest_mean_matches_pallas(n, m, name):
    """Centred on the lower median, with NaN centre entries: NaN there."""
    g = _kernel_input(n, seed=900 + n)
    c = np.sort(g, axis=0)[(n - 1) // 2]
    c[:7] = np.nan
    gj, gt = _pair(g, name)
    cj, ct = _pair(c, name)
    got = sort_kernels.closest_mean(gt, ct, m)
    _assert_ulps(got, pallas_sort.closest_mean(gj, cj, m, interpret=True), name)
    assert np.isnan(_host(got)[:7]).all()


@pytest.mark.parametrize("name", HALF)
def test_half_closest_mean_tie_rule_on_an_exact_grid(name):
    """Values and centres in quarters within [-4, 4]: every value,
    deviation and partial sum of at most 13 of them is exact in both
    dtypes, so ties at the threshold are real ties and the index-order
    tie fill must pick the same rows. With m a power of two the mean is
    exact too (XLA may divide by m as a product with its rounded
    reciprocal), so the results must agree bit for bit."""
    rng = np.random.default_rng(11)
    g = (rng.integers(-16, 17, size=(13, D)) / 4.0).astype(np.float32)
    c = (rng.integers(-8, 9, size=D) / 4.0).astype(np.float32)
    gj, gt = _pair(g, name)
    cj, ct = _pair(c, name)
    for m in (1, 2, 4, 8):
        _assert_exact(sort_kernels.closest_mean(gt, ct, m),
                      pallas_sort.closest_mean(gj, cj, m, interpret=True), name)


# --------------------------------------------------------------------------- #
# Engine steps

N, F, F_REAL, B, LR = 11, 2, 2, 4, 0.05
CFG = dict(nb_workers=N, nb_decl_byz=F, nb_real_byz=F_REAL, nb_for_study=11,
           nb_for_study_past=2, momentum=0.99, dampening=0.0,
           gradient_clip=5.0, weight_decay=1e-4)


def _t(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


def _rel(got, want):
    """Relative L2 distance of each row of `got` from that of `want`."""
    got, want = _host(got).astype(np.float64), _host(want).astype(np.float64)
    return np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)


def _half_rows_close(got, want, got32, want32):
    """Half-precision gradient rows `got` (the port's) against `want` (the
    JAX package's), anchored on the f32 rows `got32`, `want32` of the same
    step: the port's rows are no farther from the f32 rows than 1.5x the
    JAX rows' distance, and within 2x that distance of the JAX rows."""
    err = _rel(want, want32)
    assert np.all(err < 0.3), err  # half precision engaged, not garbage
    assert np.all(_rel(got, got32) <= 1.5 * err), (_rel(got, got32), err)
    assert np.all(_rel(got, want) <= 2.0 * err), (_rel(got, want), err)


def _values_close(got, want, rtol):
    got, want = _host(got), _host(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=rtol * scale)


def _engines(gar, **dtypes):
    """The JAX engine and the port's at `dtypes`, their initial states on
    the same weights, the inputs and the JAX dropout masks."""
    jcfg = JaxConfig(**CFG, **dtypes)
    mdef = jax_models.build("empire-cnn")
    jengine = build_engine(
        cfg=jcfg, model_def=mdef, loss=jax_losses.Loss("nll"),
        criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars[gar], 1.0, {})],
        attack=jax_attacks.attacks["empire"], attack_kwargs={"factor": 1.1})
    key = jax.random.PRNGKey(3)
    params, net_state = mdef.init(key)
    jstate = jengine.init(key, params=params, net_state=net_state)
    rng = np.random.default_rng(5)
    S = jcfg.nb_sampled
    xs = rng.standard_normal((S, B, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, B)).astype(np.int32)

    cfg = EngineConfig(**CFG, **dtypes)
    engine = _port_engine(cfg, gar)
    theta, bn = convert.params_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, net_state),
        dtype=cfg.torch_dtype)
    state = init_state(cfg, theta, bn)
    _, _, *wkeys = jax.random.split(jstate.rng, S + 2)
    masks = [jax_masks(k, B) for k in wkeys]
    masks = tuple(torch.from_numpy(np.stack(m)) for m in zip(*masks))
    return jengine, jstate, engine, state, xs, ys, masks


def _port_engine(cfg, gar):
    model = models.build("empire-cnn", device="cpu", dtype=cfg.torch_dtype)
    return Engine(cfg, model, Loss("nll"), Criterion("top-k"), (gars[gar], {}),
                  attacks["empire"], {"factor": 1.1},
                  optim.build("sgd", weight_decay=cfg.weight_decay))


def _step_matches_jax(gar, **dtypes):
    jengine, jstate, engine, state, xs, ys, masks = _engines(gar, **dtypes)
    jengine32, jstate32, engine32, state32, _, _, _ = _engines(gar)
    pdt = engine.dtype
    (_, mix_key, jG_sampled, jloss, jnet, jmw, jG_honest, _, _) = \
        jengine._phase_honest(jstate, jnp.asarray(xs), jnp.asarray(ys), LR)
    G_sampled, loss_avg, net, new_mw, G_honest = engine.phase_honest(
        state, torch.from_numpy(xs), torch.from_numpy(ys), LR, masks)
    assert G_sampled.dtype == G_honest.dtype == pdt
    assert jG_sampled.dtype == jnp.dtype(dtypes["dtype"])
    jG32 = jengine32._phase_honest(jstate32, jnp.asarray(xs), jnp.asarray(ys),
                                   LR)[2]
    G32 = engine32.phase_honest(state32, torch.from_numpy(xs),
                                torch.from_numpy(ys), LR, masks)[0]
    _half_rows_close(G_sampled, jG_sampled, G32, jG32)
    _values_close(loss_avg, jloss, 2e-2)
    for name, value in convert.flat_items(jnet):
        assert net[name].dtype == pdt
        _values_close(net[name], value, 2e-2)

    (jG_attack, jdef, jratio, _, _, _) = jengine._phase_defense(jG_honest, mix_key)
    jnew, jmetrics = jengine._phase_update(
        jstate, None, jG_sampled, jloss, jnet, jmw, jG_honest, jG_attack,
        jdef, jratio, LR, B)
    G_honest_t = _t(jG_honest).to(pdt)
    G_attack, grad_def, ratio, attack_state = engine.phase_defense(
        G_honest_t, state.attack_state)
    assert G_attack.dtype == grad_def.dtype == pdt
    assert np.all(_rel(G_attack, jG_attack) < 2e-2)
    assert np.all(_rel(grad_def[None], jnp.asarray(jdef)[None]) < 2e-2)
    net_t = {name: _t(v).to(pdt) for name, v in convert.flat_items(jnet)}
    new, metrics = engine.phase_update(
        state, _t(jG_sampled).to(pdt), _t(jloss).to(loss_avg.dtype), net_t,
        _t(jmw).to(pdt), G_honest_t, G_attack, grad_def, ratio, attack_state,
        LR, B)
    assert new.theta.dtype == new.momentum_server.dtype == pdt
    _values_close(new.theta, jnew.theta, 2e-2)
    _values_close(new.momentum_server, jnew.momentum_server, 2e-2)
    assert set(metrics) == set(STUDY_COLUMNS[2:])
    for column in STUDY_COLUMNS[2:-1]:
        _values_close(torch.as_tensor(metrics[column]).float(),
                      jmetrics[column], 3e-2)
    return engine, G_sampled, G32


def test_bf16_step_matches_jax():
    _step_matches_jax("median", dtype="bfloat16")


def test_mixed_precision_step_matches_jax_and_tracks_f32():
    """f32 weights, momentum and GAR space (Bulyan's f32 path), bf16
    forward and backward: the gradient rows come back in f32, held to the
    JAX engine's and to the port's own f32 step as the module docstring
    says, and not equal to the latter."""
    engine, G_mixed, G32 = _step_matches_jax(
        "bulyan", dtype="float32", compute_dtype="bfloat16")
    assert engine.compute_dtype == torch.bfloat16
    assert G32.dtype == G_mixed.dtype == torch.float32
    assert not torch.equal(G_mixed, G32)


@pytest.mark.parametrize("dtype,compute_dtype,state_dtype",
                         (("bfloat16", None, torch.bfloat16),
                          ("float32", "bfloat16", torch.float32)))
def test_state_dtypes_stay_stable(dtype, compute_dtype, state_dtype):
    cfg = EngineConfig(**CFG, dtype=dtype, compute_dtype=compute_dtype)
    engine = _port_engine(cfg, "median")
    engine.model.init(prng.PRNGKey(1))
    state = engine.init(prng.PRNGKey(1))
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal(
        (cfg.nb_sampled, B, 32, 32, 3)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(cfg.nb_sampled, B)))
    for _ in range(2):
        state, metrics = engine.train_step(state, xs, ys, LR)
        tensors = [state.theta, state.momentum_server, state.momentum_workers,
                   state.origin, state.past_grads, state.past_norms,
                   *state.net_state.values()]
        assert {t.dtype for t in tensors} == {state_dtype}
        assert bool(torch.isfinite(state.theta).all())
        assert bool(torch.isfinite(metrics["Defense gradient norm"]))
    assert state.steps == 2 and state.past_count == 2


def test_weak_scalars_round_to_the_half_dtype():
    assert weak_scalar(1.1, torch.bfloat16) == 1.1015625
    assert weak_scalar(0.99, torch.bfloat16) == 0.98828125
    assert weak_scalar(0.99, torch.float16) == 0.990234375
    assert weak_scalar(0.99, torch.float32) == float(np.float32(0.99))
    assert weak_scalar(0.99, torch.float64) == 0.99


FIXED_ATTACKS = (("empire", {"factor": 1.1}),
                 ("little", {"factor": 1.5, "negative": True}),
                 ("bulyan", {"factor": 1.1}), ("empire-strict", {"epsilon": 3}))


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("attack,kwargs", FIXED_ATTACKS,
                         ids=[name for name, _ in FIXED_ATTACKS])
def test_fixed_attack_factors_round_as_jax(half, attack, kwargs):
    """`empire(1.1)` applies 1.1015625 in bf16, as JAX does: the rows of
    each fixed-factor attack equal the JAX package's bit for bit."""
    rng = np.random.default_rng(7)
    gj, gt = _pair(rng.standard_normal((9, 1001)).astype(np.float32), half)
    want = jax_attacks.attacks[attack].unchecked(
        gj, f_decl=2, f_real=2, defense=None, **kwargs)
    got = attacks[attack].unchecked(gt, f_decl=2, f_real=2, defense=None,
                                    **kwargs)
    assert got.dtype == gt.dtype and got.shape == (2, 1001)
    np.testing.assert_array_equal(_host(got), _host(want))


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("momentum_at", ("update", "server", "worker"))
def test_update_scalars_round_as_jax(half, momentum_at):
    """The clip, and the update's momentum 0.99, dampening 0.1, learning
    rate and weight decay 1e-3, in the half parameter dtype: bit for bit
    the JAX engine's (`simples-full`, the same initial weights from the
    same key, the same rows fed to both)."""
    jdt, tdt, _, _ = HALF[half]
    dtype = "bfloat16" if half == "bf16" else "float16"
    cfg = dict(nb_workers=7, nb_decl_byz=1, nb_real_byz=1, nb_for_study=7,
               nb_for_study_past=2, momentum=0.99, dampening=0.1,
               gradient_clip=0.7, weight_decay=1e-3, momentum_at=momentum_at,
               dtype=dtype)
    jengine = build_engine(
        cfg=JaxConfig(**cfg), model_def=jax_models.build("simples-full"),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars["average"], 1.0, {})],
        attack=jax_attacks.attacks["empire"], attack_kwargs={"factor": 1.1})
    jstate = jengine.init(jax.random.PRNGKey(3))
    pcfg = EngineConfig(**cfg)
    engine = Engine(pcfg, models.build("simples-full", device="cpu", dtype=tdt),
                    Loss("nll"), Criterion("top-k"), (gars["average"], {}),
                    attacks["empire"], {"factor": 1.1},
                    optim.build("sgd", weight_decay=pcfg.weight_decay))
    engine.model.init(prng.PRNGKey(3))
    state = engine.init(prng.PRNGKey(3))
    np.testing.assert_array_equal(_host(state.theta), _host(jstate.theta))
    rng = np.random.default_rng(1)
    G = rng.standard_normal((7, engine.d)).astype(np.float32)
    ms = (0.01 * rng.standard_normal(engine.d)).astype(np.float32)
    jG, tG = _pair(G, half)
    jms, tms = _pair(ms, half)
    np.testing.assert_array_equal(_host(clip_rows(tG, 0.7)),
                                  _host(_clip_rows(jG, 0.7)))
    jstate = jstate._replace(momentum_server=jms)
    state = dataclasses.replace(state, momentum_server=tms)
    h = pcfg.nb_honests
    jnew, _ = jengine._phase_update(
        jstate, None, jG, jnp.float32(1.0), jstate.net_state,
        jstate.momentum_workers, jG[:h], jG[h:], jG[0], jnp.float32(0.5),
        LR, B)
    new, _ = engine.phase_update(
        state, tG, torch.tensor(1.0), state.net_state, state.momentum_workers,
        tG[:h], tG[h:], tG[0], 0.5, (), LR, B)
    for field in ("theta", "momentum_server"):
        assert getattr(new, field).dtype == tdt
        np.testing.assert_array_equal(_host(getattr(new, field)),
                                      _host(getattr(jnew, field)))
