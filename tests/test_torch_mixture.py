"""The `--gars` mixture of the PyTorch port against the JAX package, on the
CPU.

* `mixture_index` (the inverse CDF over the cumulative frequencies) at
  the edges of the CDF, on the host and as a tensor, equal to JAX's;
* the per-call draw: `operand_hash` and `mixture_draw` (their plain
  versions, which a CPU tensor takes) against the JAX engine's
  `_per_call_uniform` and `mixture_index`, bit for bit, on stacks with NaN
  payloads, -0, and in f32, bf16 and f16;
* the per-step mixture through both engines (average and median, the
  case of the JAX package's `test_gar_mixture_draws_all_branches`, on
  `simples-full`): the same member each step, parameters within rtol
  1e-4, atol 1e-5, and the host's mirror of the key chain equal to the
  device's key;
* the per-call draw at the defense phase, both engines fed the same
  honest rows and the `nan` attack (whose rows are the same bits), so the
  operands are bit-equal: the same members, aggregates within rtol 1e-5,
  atol 1e-6 and acceptation ratios within 1e-6;
* the driver: `--gars "average,1;median,2"` against the JAX driver's
  study CSV (rtol 1e-4, atol 1e-6, as `test_torch_attack_cli.py`), and a
  resume from a checkpoint, where the mirror restarts from the file's key
  and the resumed rows equal the uninterrupted run's.

A per-call driver trajectory is not held against the JAX driver: the
port's gradients differ from JAX's in the last bits, and the hash sees
every bit.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import attacks as jax_attacks
from byzantinemomentum_tpu import losses as jax_losses
from byzantinemomentum_tpu import models as jax_models
from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.cli.attack import main as jax_main
from byzantinemomentum_tpu.engine import EngineConfig as JaxConfig
from byzantinemomentum_tpu.engine import build_engine
from byzantinemomentum_tpu.engine import program as jax_program
from byzantinemomentum_tpu_torch import models, optim, prng, utils
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig, program
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.ops import gars, mixture_kernels

from tests.torch_threads import one_torch_thread  # noqa: F401

MIXTURES = {"two": (1.0, 3.0), "three": (2.0, 3.0, 4.0),
            "uneven": (0.1, 0.30000001, 0.6)}


def _defenses(cum, registry):
    names = ("average", "median", "krum")
    return [(registry[names[i]], freq, {}) for i, freq in enumerate(cum)]


def _edges(cum):
    """Uniforms at and beside each boundary cum[k] / cum[-1], at 0 and at
    the largest f32 below 1."""
    cum = np.asarray(cum, np.float32)
    us = [np.float32(0.0), np.float32(1.0 - 2.0 ** -24)]
    for c in cum[:-1]:
        u = np.float32(c / cum[-1])
        us += [u, np.nextafter(u, np.float32(0)), np.nextafter(u, np.float32(1))]
    return us


@pytest.mark.parametrize("mixture", sorted(MIXTURES))
def test_mixture_index_at_the_edges_of_the_cdf(mixture):
    cum = MIXTURES[mixture]
    jdef, pdef = _defenses(cum, jax_ops.gars), _defenses(cum, gars)
    for u in _edges(cum):
        want = int(jax_program.mixture_index(jdef, jnp.float32(u)))
        assert program.mixture_index(pdef, u) == want, u
        got = mixture_kernels.inverse_cdf(
            torch.tensor(u, dtype=torch.float32),
            program.cumulative(pdef, torch.device("cpu")))
        assert got.dtype == torch.int32 and int(got) == want, u


def _stack(dtype, seed):
    """An [7, 33] stack with NaN payloads (quiet and signalling, both
    signs), -0 and +0, +-inf and subnormals of `dtype`, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7, 33)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, np.inf, -np.inf]
    if dtype == "float32":
        bits = x.view(np.uint32)
        bits[1, :5] = [0x7FC00000, 0xFFC00001, 0x7F800001, 0x7FA5A5A5, 1]
        return x
    if dtype == "bfloat16":
        h = x.astype(ml_dtypes.bfloat16)
        bits = h.view(np.uint16)
        bits[1, :5] = [0x7FC0, 0xFFC1, 0x7F81, 0x7FA5, 1]
        return h
    h = x.astype(np.float16)
    bits = h.view(np.uint16)
    bits[1, :5] = [0x7E00, 0xFE01, 0x7C01, 0x7D55, 1]
    return h


def _jax_hash(G):
    """The JAX engine's content hash (`_per_call_uniform`'s h)."""
    from jax import lax
    bits = lax.bitcast_convert_type(G.astype(jnp.float32), jnp.uint32)
    mult = (jnp.arange(bits.size, dtype=jnp.uint32).reshape(bits.shape)
            * jnp.uint32(2654435761) | jnp.uint32(1))
    return int(jnp.sum(bits * mult, dtype=jnp.uint32))


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.fixture(scope="module")
def per_call_engines():
    """A JAX engine with `gars_per_call` over average/median/krum (its
    `_per_call_uniform`), and the port's, on `simples-full`."""
    defenses = _defenses(MIXTURES["three"], jax_ops.gars)
    jcfg = JaxConfig(nb_workers=7, nb_decl_byz=2, nb_real_byz=2,
                     nb_for_study=0, momentum=0.0, gars_per_call=True)
    jengine = build_engine(
        cfg=jcfg, model_def=jax_models.build("simples-full"),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=defenses, attack=jax_attacks.attacks["nan"])
    cfg = EngineConfig(nb_workers=7, nb_decl_byz=2, nb_real_byz=2,
                       nb_for_study=0, momentum=0.0, gars_per_call=True)
    engine = Engine(cfg, models.build("simples-full", device="cpu"),
                    Loss("nll"), Criterion("top-k"),
                    _defenses(MIXTURES["three"], gars), attacks["nan"], {},
                    optim.build("sgd"))
    return jengine, engine


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
def test_operand_hash_and_draw_equal_jax_bit_for_bit(per_call_engines, dtype):
    jengine, engine = per_call_engines
    defenses = jengine.defenses
    members = set()
    for seed in range(6):
        x = _stack(dtype, seed)
        G, t = jnp.asarray(x), _torch(x)
        h = mixture_kernels.operand_hash_plain(t)
        assert int(h) == _jax_hash(G)
        assert int(mixture_kernels.operand_hash_int64(t)) == int(h)
        key = jax.random.PRNGKey(11 + seed)
        pkey = prng.PRNGKey(11 + seed)
        u = jengine._per_call_uniform(key, G)
        got_u = prng.uniform(prng.fold_in(pkey, h), ())
        assert got_u.view(torch.int32).item() == int(
            np.asarray(u).view(np.int32))
        want = int(jax_program.mixture_index(defenses, u))
        cum = program.cumulative(engine.defenses, "cpu")
        assert int(mixture_kernels.mixture_draw_plain(pkey, h, cum)) == want
        assert int(engine.per_call_member(pkey, t)) == want
        members.add(want)
    assert len(members) > 1


def test_operand_hash_sees_every_bit():
    """-0 against +0, two NaN payloads, two positions of one value: four
    different hashes."""
    base = torch.zeros((2, 3))
    neg = base.clone()
    neg[0, 0] = -0.0
    nan1, nan2 = torch.full((2, 3), np.nan), torch.full((2, 3), np.nan)
    nan2.view(torch.int32)[0, 0] = 0x7FC00001
    moved = base.clone()
    moved[1, 2], base2 = 1.0, base.clone()
    base2[0, 1] = 1.0
    hashes = {int(mixture_kernels.operand_hash(g))
              for g in (base, neg, nan1, nan2, moved, base2)}
    assert len(hashes) == 6


def test_per_call_draws_at_the_defense_phase(per_call_engines):
    """The same honest rows and the `nan` attack: both engines' outer
    draw and influence draw pick the same members on bit-equal operands,
    and the aggregates and ratios agree."""
    jengine, engine = per_call_engines
    rng = np.random.default_rng(3)
    drawn = set()
    for seed in range(16):
        G = rng.standard_normal((5, engine.d)).astype(np.float32)
        key = jax.random.PRNGKey(1000 * seed + 7)
        jG_attack, jdef, jratio, *_ = jengine._phase_defense(jnp.asarray(G), key)
        pkey = prng.PRNGKey(1000 * seed + 7)
        G_attack, grad_def, ratio, _ = engine.phase_defense(
            torch.from_numpy(G), (), mix_key=pkey)
        G_all = np.concatenate([G, np.asarray(jG_attack)])
        want = int(jax_program.mixture_index(
            jengine.defenses, jengine._per_call_uniform(key, jnp.asarray(G_all))))
        assert int(engine.per_call_member(pkey, torch.from_numpy(G_all))) == want
        drawn.add(want)
        np.testing.assert_array_equal(G_attack.numpy().view(np.int32),
                                      np.asarray(jG_attack).view(np.int32))
        np.testing.assert_allclose(grad_def.numpy(), np.asarray(jdef),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(ratio), float(jratio), atol=1e-6)
    assert len(drawn) > 1


def test_per_step_mixture_through_both_engines():
    """Average and median 1:2 (cumulative 1, 2) on `simples-full`, 20
    steps from one key: the port's host mirror draws JAX's member every
    step, both members are drawn, the parameters track and the mirror
    ends on the device's key."""
    S, B, steps = 3, 4, 20
    jdefenses = [(jax_ops.gars["average"], 1.0, {}),
                 (jax_ops.gars["median"], 2.0, {})]
    jcfg = JaxConfig(nb_workers=S, nb_decl_byz=1, nb_real_byz=0,
                     nb_for_study=0, momentum=0.0)
    mdef = jax_models.build("simples-full")
    jengine = build_engine(cfg=jcfg, model_def=mdef,
                           loss=jax_losses.Loss("nll"),
                           criterion=jax_losses.Criterion("top-k"),
                           defenses=jdefenses)
    jstate = jengine.init(jax.random.PRNGKey(4))
    cfg = EngineConfig(nb_workers=S, nb_decl_byz=1, nb_real_byz=0,
                       nb_for_study=0, momentum=0.0)
    model = models.build("simples-full", device="cpu")
    model.init(prng.PRNGKey(4))
    engine = Engine(cfg, model, Loss("nll"), Criterion("top-k"),
                    [(gars["average"], 1.0, {}), (gars["median"], 2.0, {})],
                    None, {}, optim.build("sgd"))
    state = engine.init(prng.PRNGKey(4))
    rng = np.random.default_rng(0)
    members = []
    for _ in range(steps):
        xs = rng.standard_normal((S, B, 28, 28, 1)).astype(np.float32)
        ys = rng.integers(0, 10, (S, B)).astype(np.int32)
        mix_key = jax.random.split(jstate.rng, S + 2)[1]
        want = int(jax_program.mixture_index(
            jdefenses, jax.random.uniform(mix_key)))
        assert engine.mirror_keys(state)[1] == want
        members.append(want)
        jstate, _ = jengine.train_step(jstate, jnp.asarray(xs),
                                       jnp.asarray(ys), jnp.float32(0.5))
        state, _ = engine.train_step(state, torch.from_numpy(xs),
                                     torch.from_numpy(ys), 0.5)
    assert set(members) == {0, 1}
    assert tuple(state.rng.tolist()) == state.rng_host
    assert state.rng.tolist() == np.asarray(jstate.rng).tolist()
    np.testing.assert_allclose(state.theta.numpy(), np.asarray(jstate.theta),
                               rtol=1e-4, atol=1e-5)


COMMON = ["--seed", "3", "--model", "simples-full", "--dataset", "mnist",
          "--nb-workers", "9", "--nb-decl-byz", "2", "--nb-real-byz", "2",
          "--batch-size", "8", "--batch-size-test", "16",
          "--batch-size-test-reps", "2", "--evaluation-delta", "2",
          "--learning-rate", "0.1", "--nb-for-study", "1",
          "--nb-for-study-past", "2", "--attack", "empire", "--attack-args",
          "factor:1.1", "--gars", "average,1;median,2"]


@pytest.fixture(autouse=True)
def small_sets(monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "300")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")


def _rows(resdir, name):
    lines = (resdir / name).read_text().split(os.linesep)
    return [line.split("\t") for line in lines[1:] if line]


def test_driver_mixture_tracks_the_jax_driver(tmp_path):
    argv = ["--device", "cpu", *COMMON, "--nb-steps", "6"]
    assert jax_main([*argv, "--result-directory", str(tmp_path / "jax")]) == 0
    summary = driver.run([*argv, "--result-directory", str(tmp_path / "port"),
                          "--checkpoint-delta", "2"])
    assert summary["steps"] == 6
    want, got = _rows(tmp_path / "jax", "study"), _rows(tmp_path / "port", "study")
    assert [row[:2] for row in got] == [row[:2] for row in want]
    want = np.array([[float(v) for v in row[2:]] for row in want])
    got = np.array([[float(v) for v in row[2:]] for row in got])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-6)
    assert _rows(tmp_path / "port", "eval") == _rows(tmp_path / "jax", "eval")
    # A resume from step 2: the mirror restarts from the file's key (a
    # mismatch at a chunk's end fails the run) and the rows are the
    # uninterrupted run's
    resumed = tmp_path / "resumed"
    driver.run([*argv[:-2], "--nb-steps", "4", "--load-checkpoint",
                str(tmp_path / "port" / "checkpoint-2"), "--result-directory",
                str(resumed)])
    uninterrupted = [row for row in _rows(tmp_path / "port", "study")
                     if int(row[0]) >= 2]
    assert _rows(resumed, "study") == uninterrupted


def test_mirror_mismatch_fails_the_run(tmp_path, monkeypatch):
    """A mirror that drifts from the device's key is caught at the chunk's
    end."""
    real = Engine.mirror_keys

    def drifting(self, state):
        words, member = real(self, state)
        return (words[0], words[1] ^ 1), member

    monkeypatch.setattr(Engine, "mirror_keys", drifting)
    with pytest.raises(RuntimeError, match="mirror of the key chain"):
        driver.run(["--device", "cpu", *COMMON, "--nb-steps", "2",
                    "--result-directory", str(tmp_path)])


def test_gars_parse_errors_match_the_jax_driver():
    for spec in ("average,1,{bad", "average,1,[1]", "nope,1"):
        with pytest.raises(utils.UserException):
            driver._parse_gars(spec)
    parsed = driver._parse_gars('average;median,-;krum,2,{"m": 2}')
    assert [(gar.name, freq, conf) for gar, freq, conf in parsed] == [
        ("average", 1.0, {}), ("median", 2.0, {}), ("krum", 4.0, {"m": 2})]
