"""The port's copy of `jax.random` (`byzantinemomentum_tpu_torch/prng.py`)
against JAX on the CPU (threefry-2x32, `jax_threefry_partitionable` on).

Keys, `fold_in`, `split`, the 32-bit random words, `bits8`, `uniform`
and `bernoulli` equal JAX's (one key or a batch of keys, `jax.vmap`)
exactly, in every dtype the attacks draw. `normal` equals JAX's exactly
in f32, bf16 and f16, and in f64 (`torch.erfinv`) within rtol 1e-12;
`log1p32` equals XLA's float32 `log1p` bit for bit, and `fma32` rounds
`a * b + c` once (where a float64 sum rounded to float32 would round
twice). The uint32 helpers equal numpy's wrapping uint32 arithmetic.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu_torch import prng

from tests.torch_threads import one_torch_thread  # noqa: F401

SEEDS = (0, 1, 42, 0xA11E, 2**31 - 1, 2**32 - 1, -7)
DTYPES = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float16, torch.float16))


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", (0, 1, 7, 123_456_789, 2**31, 2**32 - 1))
@pytest.mark.parametrize("seed", (0, 0xA11E))
def test_fold_in_matches_jax(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data))
    got = prng.fold_in(prng.PRNGKey(seed), data)
    assert np.array_equal(got.numpy(), _words(want))
    # A 0-d tensor on the key's device folds in the same way
    got = prng.fold_in(prng.PRNGKey(seed), torch.tensor(data, dtype=torch.int64))
    assert np.array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("shape", ((1,), (7,), (3, 1001), (2, 5, 33)))
def test_random_bits_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(0xA11E), 9)
    want = jax.random.bits(key, shape, dtype=jnp.uint32)
    got = prng.random_bits(prng.fold_in(prng.PRNGKey(0xA11E), 9), shape)
    assert got.shape == shape
    assert np.array_equal(got.numpy(), _words(want))


def test_threefry2x32_known_answer():
    """The Random123 known-answer vector of threefry-2x32, 20 rounds."""
    k = torch.tensor(0x13198A2E, dtype=torch.int64), torch.tensor(0x03707344, dtype=torch.int64)
    x = torch.tensor(0x243F6A88, dtype=torch.int64), torch.tensor(0x85A308D3, dtype=torch.int64)
    o1, o2 = prng.threefry2x32(*k, *x)
    assert (int(o1), int(o2)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("bounds", ((0.0, 1.0), (-1.5, 2.25)))
def test_uniform_matches_jax(jdt, tdt, bounds):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    want = jax.random.uniform(key, (4, 5003), dtype=jdt, minval=bounds[0],
                              maxval=bounds[1])
    got = prng.uniform(prng.fold_in(prng.PRNGKey(3), 1), (4, 5003), tdt,
                       *bounds)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("data", (5, 77))
def test_normal_matches_jax(jdt, tdt, data):
    key = jax.random.fold_in(jax.random.PRNGKey(0xA11E), data)
    shape = (5, 40_001)
    want = np.asarray(jax.random.normal(key, shape, dtype=jdt).astype(jnp.float32))
    got = prng.normal(prng.fold_in(prng.PRNGKey(0xA11E), data), shape, tdt)
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _log1p_inputs(kind, rng):
    """f32 inputs of `log1p`: those `normal` gives it (-u^2), both sides
    of sqrt2 - 1, tiny and huge magnitudes, and the special values."""
    if kind == "normal":
        return -(rng.uniform(-1, 1, 200_000).astype(np.float32) ** 2)
    if kind == "range":
        return rng.uniform(-1, 3, 200_000).astype(np.float32)
    if kind == "magnitudes":
        mag = np.exp(rng.uniform(-100, 80, 200_000)).astype(np.float32)
        return np.where(rng.random(mag.shape) < 0.5, -np.minimum(mag, 1), mag)
    return np.array([0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, -2.0, 1e-30,
                     -1e-40, 1e-40, -0.41421356, -0.4142135, -0.41421357,
                     0.41421357, 5.0, 1e30], np.float32)


@pytest.mark.parametrize("kind", ("normal", "range", "magnitudes", "special"))
def test_log1p32_matches_xla(kind):
    x = _log1p_inputs(kind, np.random.default_rng(len(kind)))
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = prng.log1p32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _round_once(a, b, c):
    """The float32 nearest `a * b + c` (ties to even), exactly."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    candidates = [np.nextafter(near, np.float32(-np.inf)), near,
                  np.nextafter(near, np.float32(np.inf))]
    return min(candidates, key=lambda y: (abs(Fraction(float(y)) - exact),
                                          int(y.view(np.int32)) & 1))


def test_fma32_rounds_once():
    # (1 + 2^-11)(1 - 2^-11 + 2^-22) = 1 + 2^-33: 2^24 + 1 + 2^-33 rounds
    # to the float32 midpoint 2^24 + 1 in float64, then to even, 2^24
    a = torch.tensor([1 + 2.0 ** -11])
    b = torch.tensor([1 - 2.0 ** -11 + 2.0 ** -22])
    assert float(prng.fma32(a, b, 2.0 ** 24)) == 2.0 ** 24 + 2
    assert float(prng.fma32(a, -b, -(2.0 ** 24))) == -(2.0 ** 24 + 2)
    rng = np.random.default_rng(3)
    a = rng.standard_normal(3000).astype(np.float32)
    b = (rng.standard_normal(3000) * 2.0 ** rng.integers(-30, 30, 3000)
         ).astype(np.float32)
    # c beside -a * b (cancellation), far above it and far below it
    c = (-(a.astype(np.float64) * b) * rng.choice(
        [1 + 1e-7, 2.0 ** 29, 2.0 ** -29], 3000)).astype(np.float32)
    got = prng.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_once(*abc) for abc in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_f64_matches_jax():
    jax.config.update("jax_enable_x64", True)
    try:
        key = jax.random.fold_in(jax.random.PRNGKey(1), 2)
        want = np.asarray(jax.random.normal(key, (3, 2001), dtype=jnp.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = prng.normal(prng.fold_in(prng.PRNGKey(1), 2), (3, 2001), torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_uint32_helpers_wrap_as_numpy():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    a[:3], b[:3] = 2**32 - 1, 2**32 - 1  # the largest words
    got = prng.mul32(torch.from_numpy(a.astype(np.int64)),
                     torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(got.numpy(), (a * b).astype(np.int64))
    assert prng.mul32(torch.tensor(2**32 - 1), 2654435761).item() == \
        (2**32 - 1) * 2654435761 % 2**32
    total = prng.wrapping_sum32(torch.from_numpy(a.astype(np.int64)))
    assert total.item() == int(np.sum(a, dtype=np.uint32))


@pytest.mark.parametrize("n", (1, 2, 3, 6, 27))
@pytest.mark.parametrize("seed", (0, 1, 0xA11E, 2**32 - 1))
def test_split_matches_jax(seed, n):
    want = jax.random.split(jax.random.PRNGKey(seed), n)
    got = prng.split(prng.PRNGKey(seed), n)
    assert got.shape == (n, 2)
    assert np.array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("n", (2, 3, 13))
def test_split_of_a_batch_of_keys_matches_jax_vmap(n):
    """Keys `[K, 2]` split each on its own: `jax.vmap(split)`."""
    keys = jax.random.split(jax.random.PRNGKey(5), 7)
    want = jax.vmap(lambda k: jax.random.split(k, n))(keys)
    got = prng.split(torch.from_numpy(_words(keys)), n)
    assert got.shape == (7, n, 2)
    assert np.array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("shape", ((1,), (7,), (3, 1001), (4, 16, 16, 64)))
def test_bits8_matches_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(0xA11E), 3)
    want = jax.random.bits(key, shape, dtype=jnp.uint8)
    got = prng.bits8(prng.fold_in(prng.PRNGKey(0xA11E), 3), shape)
    assert got.dtype == torch.uint8 and got.shape == shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    # A batch of keys draws each key's bits under its index
    keys = jax.random.split(key, 3)
    want = jax.vmap(lambda k: jax.random.bits(k, shape, dtype=jnp.uint8))(keys)
    got = prng.bits8(torch.from_numpy(_words(keys)), shape)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", (0.7, 0.75, 0.3, 0.5))
def test_bernoulli_matches_jax(p):
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    shape = (3, 2001)
    want = jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(keys)
    got = prng.bernoulli(torch.from_numpy(_words(keys)), p, shape)
    assert got.dtype == torch.bool and got.shape == (4, *shape)
    assert np.array_equal(got.numpy(), np.asarray(want))
    one = prng.bernoulli(torch.from_numpy(_words(keys[1])), p, shape)
    assert np.array_equal(one.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_uniform_of_a_batch_of_keys_matches_jax(jdt, tdt):
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    want = jax.vmap(lambda k: jax.random.uniform(k, (5, 7), jdt, -0.5, 0.5))(keys)
    got = prng.uniform(torch.from_numpy(_words(keys)), (5, 7), tdt, -0.5, 0.5)
    assert got.shape == (3, 5, 7)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
