"""The parts of `jax.random` that the attacks draw from, as the JAX
package's PRNG computes them (the threefry-2x32 implementation with
`jax_threefry_partitionable` on, the default of JAX 0.9).

A key is an int64 tensor `[2]` holding two uint32 words, on the device
that will use it; nothing here moves a value to the host. `split`,
`random_bits`, `bits8`, `uniform` and `bernoulli` also take a batch of
keys `[..., 2]` (what `jax.vmap` over the keys computes): each key's
draw comes out under its batch index, ahead of the requested shape. Every uint32
operation runs on int64 tensors with the high bits masked off; products
are split into 16-bit halves, so that no intermediate value leaves the
signed 64-bit range.

- `PRNGKey(seed)`: the key `[0, seed mod 2^32]` (JAX without x64 takes
  a seed as a 32-bit integer).
- `fold_in(key, data)`: `threefry2x32(key, [0, data])`.
- `split(key, n)`: `n` new keys, key i the two output words of the hash
  of the counter i (JAX's `_threefry_split_foldlike`).
- `random_bits(key, shape)`: 32-bit words; element i hashes the 64-bit
  counter i split into its two words and returns the xor of the two
  output words. `bits8(key, shape)`: the low byte of each of those words
  (`jax.random.bits(key, shape, uint8)`, which converts the 32-bit xor).
- `uniform(key, shape, dtype, minval, maxval)`: the top mantissa bits of
  those words under the exponent of 1.0, minus 1, scaled and shifted (in
  one multiply-add for f32 and f16, as XLA on the CPU fuses it); f32,
  bf16, f16 (bf16 from 8 bits) and f64 (from two words).
- `bernoulli(key, p, shape)`: `uniform(key, shape) < p` in float32.
- `normal(key, shape, dtype)`: `sqrt(2) * erfinv(u)` for u uniform in
  (-1, 1), with XLA's polynomial for the inverse error function (its
  float32 form; the half dtypes compute it in float32 and round). Its
  `log1p`, `sqrt` and multiply-adds are taken in float64 and rounded, so
  the CPU and the card give the same bits; XLA's own float32 `log1p`
  differs from that in the last bits of about 1% of the values (within
  4 ulps). float64 uses `torch.erfinv`.

`mul32` and `wrapping_sum32` give the uint32 product and sum (modulo
2^32) that content hashes need (`attacks/alie.py::row_key`).
"""

import math

import torch

__all__ = ["PRNGKey", "fold_in", "split", "threefry2x32", "random_bits",
           "bits8", "uniform", "bernoulli", "normal", "mul32",
           "wrapping_sum32", "MASK32"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's float32 inverse error function (`ErfInv32`): coefficients of the
# polynomial in w - 2.5 (w < 5) and in sqrt(w) - 3 (w >= 5), w =
# -log1p(-x^2), highest degree first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# (bits of the random words used, mantissa bits, bits of 1.0) by dtype
_FLOAT_LAYOUT = {torch.float32: (32, 23, 0x3F800000),
                 torch.bfloat16: (8, 7, 0x3F80),
                 torch.float16: (16, 10, 0x3C00),
                 torch.float64: (64, 52, 0x3FF0000000000000)}
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16, torch.float64: torch.int64}


def mul32(a, b):
    """(a * b) mod 2^32 of uint32 words (int64 tensors or ints), through
    16-bit halves of b: every partial product stays below 2^48."""
    low = a * (b & 0xFFFF)
    high = ((a * (b >> 16)) & 0xFFFF) << 16
    return (low + high) & MASK32


def wrapping_sum32(words):
    """The sum of uint32 words modulo 2^32 (exact below 2^31 words)."""
    return torch.sum(words, dtype=torch.int64) & MASK32


def _rotate_left(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2), all uint32 words in int64 tensors that
    broadcast together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = x1 ^ _rotate_left(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed, device=None):
    """`jax.random.PRNGKey(seed)` for an integer seed, as JAX without x64
    computes it: `[2]` int64 words."""
    # [0, seed] made on the device: no copy from the host to wait on
    return torch.arange(2, dtype=torch.int64, device=device) * (int(seed) & MASK32)


def fold_in(key, data):
    """`jax.random.fold_in(key, data)`; `data` a Python int or a 0-d
    integer tensor (taken modulo 2^32), on the key's device."""
    data = (data.to(device=key.device, dtype=torch.int64)
            if isinstance(data, torch.Tensor)
            else torch.full((), int(data), dtype=torch.int64, device=key.device))
    data = data & MASK32
    o1, o2 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([o1, o2])


def split(key, n=2):
    """`jax.random.split(key, n)`: `[n, 2]` keys, or `[..., n, 2]` for a
    batch of keys `[..., 2]` (each key split on its own)."""
    return torch.stack(_counter_hash(key, n), dim=-1)


def _counter_hash(key, count):
    """The two output words of the hash of each counter 0 .. count - 1,
    which enters as its high and low 32-bit words (the partitionable
    layout): `[..., count]` each for keys `[..., 2]`."""
    i = torch.arange(count, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32,
                        i & MASK32)


def random_bits(key, shape):
    """`shape` uint32 words (int64 tensor): element i (row-major) is the
    xor of the two words hashed from the counter i; `[..., *shape]` for
    keys `[..., 2]`."""
    b1, b2 = _counter_hash(key, math.prod(shape))
    return (b1 ^ b2).view(*key.shape[:-1], *shape)


def bits8(key, shape):
    """`jax.random.bits(key, shape, uint8)`: the low byte of each
    `random_bits` word, as uint8; `[..., *shape]` for keys `[..., 2]`."""
    return (random_bits(key, shape) & 0xFF).to(torch.uint8)


def _unit_floats(key, shape, dtype):
    """Floats in [0, 1) of `dtype` from the words' top mantissa bits."""
    width, mantissa, one = _FLOAT_LAYOUT[dtype]
    if width == 64:
        b1, b2 = _counter_hash(key, math.prod(shape))
        bits = (b1 << (64 - 12 - 32)) | (b2 >> 12)
    else:
        bits = (random_bits(key, shape) & ((1 << width) - 1)) >> (width - mantissa)
    ints = (bits | one).to(_INT_VIEW[dtype])
    return (ints.view(dtype) - 1.0).view(*key.shape[:-1], *shape)


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """`jax.random.uniform`: `max(minval, u * (maxval - minval) + minval)`
    in `dtype`, u in [0, 1)."""
    floats = _unit_floats(key, tuple(shape), dtype)
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    if dtype in (torch.float64, torch.bfloat16):
        return torch.maximum(lo, floats * (hi - lo) + lo)
    # XLA on the CPU fuses the scale and shift of f32 (and of f16, at f32)
    # into one multiply-add; the product is exact in float64
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float().to(dtype))


def bernoulli(key, p, shape):
    """`jax.random.bernoulli(key, p, shape)` for a Python float p: a
    float32 uniform below float32(p); `[..., *shape]` for keys
    `[..., 2]`."""
    threshold = torch.full((), p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < threshold


def _erfinv32(x):
    """XLA's float32 inverse error function on an f32 tensor."""
    w = -torch.log1p(-(x * x).double()).float()
    small = w < 5.0
    # The card's float32 sqrt is not correctly rounded (0.7% of values
    # off by an ulp); float64's, rounded once more, is
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    w64 = w.double()
    for lo, hi in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        # XLA fuses each step into one multiply-add; the f32 product is
        # exact in float64, so one rounding of the sum stands in for it
        p = (torch.where(small, lo, hi).double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(key, shape, dtype=torch.float32):
    """`jax.random.normal`: `sqrt(2) * erfinv(u)`, u uniform in
    [nextafter(-1, 0), 1)."""
    # nextafter(-1, 0) = -1 + eps / 2 in every binary float type
    lo = -1.0 + torch.finfo(dtype).eps / 2
    u = uniform(key, shape, dtype, lo, 1.0)
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=dtype, device=key.device)
    if dtype == torch.float64:
        return sqrt2 * torch.erfinv(u)
    return sqrt2 * _erfinv32(u.float()).to(dtype)
