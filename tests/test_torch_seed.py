"""Same `--seed`, same run: the port's key tree against the JAX package's,
on the CPU.

* Initial weights: `model.init(PRNGKey(seed))` gives, bit for bit, the
  flat vector `ravel_pytree(model_def.init(PRNGKey(seed)))` of the JAX
  model (rounded to the parameter dtype in bf16, as the JAX engine casts
  its f32 init), for `empire-cnn` (BatchNorm state too) and the four
  simple models, for several seeds.
* Step keys: `Engine.init(key).rng` is the JAX engine's `fold_in(key, 1)`
  and `Engine.step_keys` gives the JAX step's `(rng, mix_key, *wkeys) =
  split(state.rng, S + 2)`.
* Dropout: `empire-cnn`'s three keep-masks for S = 3 workers, B = 4, from
  the worker keys, equal JAX's `_dropout_mask` under `split(wkey, 3)[j]`
  and the masks `grouped_dropout_apply` applies, bit for bit (the port
  lays them out NCHW); a keep rate that is no 8-bit threshold (0.7) takes
  `bernoulli`, as JAX's branch does. The mask wrapper's kernel path runs
  only on the card (`tests/test_torch_gpu.py`); here its plain version.

The two drivers from `--seed` alone: `tests/test_torch_seed_driver.py`.
"""

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
from byzantinemomentum_tpu.models.core import (
    _dropout_mask, grouped_dropout_apply)
from byzantinemomentum_tpu_torch import convert, models, optim, prng
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig
from byzantinemomentum_tpu_torch.losses import Criterion, Loss
from byzantinemomentum_tpu_torch.models.core import worker_dropout_masks
from byzantinemomentum_tpu_torch.ops import gars, prng_kernels

from tests.torch_threads import one_torch_thread  # noqa: F401

MODELS = ("empire-cnn", "simples-full", "simples-conv", "simples-logit",
          "simples-linear")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _words(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _bits(t):
    """The raw bits of a float tensor, for exact comparison."""
    return t.detach().contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.int32).numpy()


# Four seeds a simple model, two for the 1.3M-parameter empire-cnn
INIT_CASES = [(name, seed, dtype) for name in MODELS
              for seed in ((0, 1) if name == "empire-cnn" else (0, 1, 42, 2**32 - 1))
              for dtype in sorted(DTYPES)]


@pytest.mark.parametrize("name,seed,dtype", INIT_CASES)
def test_init_matches_jax(name, seed, dtype):
    jdt, tdt = DTYPES[dtype]
    params, state = jax_models.build(name).init(jax.random.PRNGKey(seed))
    want, _ = jax.flatten_util.ravel_pytree(params)
    module = models.build(name, device="cpu", dtype=tdt)
    module.init(prng.PRNGKey(seed))
    flat = models.FlatParams(module)
    got = flat.flatten(dict(module.named_parameters())).detach()
    assert got.dtype == tdt
    np.testing.assert_array_equal(
        _bits(got), _bits(torch.from_numpy(np.array(want.astype(jnp.float32)))
                          .to(tdt)))
    for name_, value in convert.flat_items(jax.tree.map(np.asarray, state)):
        np.testing.assert_array_equal(module.get_buffer(name_).float().numpy(),
                                      value)


def _engines(S_workers=3):
    """The JAX and port engines of `empire-cnn` (n = S_workers, one
    declared Byzantine, none real), initialized from the same key."""
    cfg = dict(nb_workers=S_workers, nb_decl_byz=0, nb_real_byz=0,
               nb_for_study=0, nb_for_study_past=1, momentum=0.9)
    jengine = build_engine(
        cfg=JaxConfig(**cfg), model_def=jax_models.build("empire-cnn"),
        loss=jax_losses.Loss("nll"), criterion=jax_losses.Criterion("top-k"),
        defenses=[(jax_ops.gars["average"], 1.0, {})],
        attack=jax_attacks.attacks["nan"], attack_kwargs={})
    pcfg = EngineConfig(**cfg)
    engine = Engine(pcfg, models.build("empire-cnn", device="cpu"), Loss("nll"),
                    Criterion("top-k"), [(gars["average"], 1.0, {})],
                    attacks["nan"], {}, optim.build("sgd"))
    return jengine, engine


@pytest.mark.parametrize("seed", (0, 5))
def test_step_keys_match_jax(seed):
    jengine, engine = _engines()
    jstate = jengine.init(jax.random.PRNGKey(seed))
    engine.model.init(prng.PRNGKey(seed))
    state = engine.init(prng.PRNGKey(seed))
    np.testing.assert_array_equal(state.rng.numpy(), _words(jstate.rng).numpy())
    rng, mix_key, wkeys = engine.step_keys(state.rng)
    want = _words(jax.random.split(jstate.rng, 3 + 2)).numpy()
    np.testing.assert_array_equal(rng.numpy(), want[0])
    np.testing.assert_array_equal(mix_key.numpy(), want[1])
    np.testing.assert_array_equal(wkeys.numpy(), want[2:])


def _nchw(mask):
    """An NHWC mask `(B, H, W, C)`, or a stack `(S, B, H, W, C)`, as NCHW;
    a dense mask as it is."""
    if mask.ndim == 4:
        return mask.transpose(0, 3, 1, 2)
    if mask.ndim == 5:
        return mask.transpose(0, 1, 4, 2, 3)
    return mask


@pytest.mark.parametrize("seed", (0, 3))
def test_dropout_masks_match_jax(seed):
    """The three masks of S = 3 workers at B = 4: the port's draw against
    `_dropout_mask` per worker (the vmapped path) and against the masks
    `grouped_dropout_apply` applies (the grouped path)."""
    S, B = 3, 4
    _, engine = _engines(S)
    wkeys = jax.random.split(jax.random.PRNGKey(seed), S)
    got = engine.model.draw_masks(_words(wkeys), B)
    jax_shapes = ((B, 16, 16, 64), (B, 8, 8, 128), (B, 128))
    assert [tuple(m.shape) for m in got] == [
        (S, *shape) for shape in engine.model.mask_shapes(B)]
    dks = jax.vmap(lambda k: jax.random.split(k, 3))(wkeys)
    for j, shape in enumerate(jax_shapes):
        per_worker = np.stack([_nchw(np.asarray(_dropout_mask(dks[s, j], 0.75,
                                                              shape)))
                               for s in range(S)])
        np.testing.assert_array_equal(got[j].numpy(), per_worker)
        # The grouped path's masks: where it keeps (a positive input)
        ones = jnp.ones(shape[:-1] + (S, shape[-1]))
        kept = np.asarray(grouped_dropout_apply(dks[:, j], ones, 0.25,
                                                train=True)) != 0
        kept = np.moveaxis(kept, -2, 0)  # (S, B, ..., C)
        np.testing.assert_array_equal(got[j].numpy(), _nchw(kept))
        assert 0.7 < got[j].float().mean() < 0.8


@pytest.mark.parametrize("keep,shape", ((0.7, (4, 8, 8, 16)), (0.7, (4, 33)),
                                        (0.75, (3, 5, 7, 9))))
def test_worker_dropout_masks_take_jax_branch(keep, shape):
    """An 8-bit keep threshold draws `bits8` (the kernel's plain version
    here, at a size that fills no whole block), any other keep rate
    `bernoulli`: each worker's mask is JAX's `_dropout_mask` under key j
    of `split(wkey, 3)`."""
    wkeys = jax.random.split(jax.random.PRNGKey(1), 5)
    got = worker_dropout_masks(_words(wkeys), 2, keep, shape)
    want = np.stack([_nchw(np.asarray(_dropout_mask(
        jax.random.split(k, 3)[2], keep, shape))) for k in wkeys])
    np.testing.assert_array_equal(got.numpy(), want)
    if keep == 0.75:
        np.testing.assert_array_equal(
            prng_kernels.dropout_masks(_words(wkeys), 2, shape, 192).numpy(),
            want)
