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
  float32 form; the half dtypes compute it in float32 and round), and
  XLA's float32 `log1p` (`log1p32`, its CPU intrinsic, step for step).
  Each fused multiply-add is one rounding (`fma32`), a `sqrt` or a
  quotient is taken in float64 and rounded once (the card's float32
  `sqrt` is not correctly rounded), so the CPU and the card give XLA's
  bits. float64 uses `torch.erfinv`.

`mul32` and `wrapping_sum32` give the uint32 product and sum (modulo
2^32) that content hashes need (`attacks/alie.py::row_key`).

`truncated_normal(key, lower, upper, shape)`: JAX's inverse-CDF draw, a
uniform between erf(lower / sqrt2) and erf(upper / sqrt2) (XLA's float32
`erf`, `erf32`), `sqrt2 * erfinv(u)`, clipped to the open interval.

The same hash on a key held on the host as two Python ints, for a host
that mirrors a chain of device keys without reading them:
`split_words(words, i)` (key i of `split(key, n)`, for any n > i),
`fold_in_words(words, data)` and `uniform_words(words)` (a float32
uniform, as a numpy scalar).
"""

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "split", "threefry2x32", "random_bits",
           "bits8", "uniform", "bernoulli", "normal", "truncated_normal",
           "erf32", "log1p32", "fma32", "mul32", "wrapping_sum32",
           "split_words", "fold_in_words", "uniform_words", "MASK32"]

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
    return (b1 ^ b2).view((*key.shape[:-1], *shape))


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
    return (ints.view(dtype) - 1.0).view((*key.shape[:-1], *shape))


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """`jax.random.uniform`: `max(minval, u * (maxval - minval) + minval)`
    in `dtype`, u in [0, 1)."""
    floats = _unit_floats(key, tuple(shape), dtype)
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    if dtype in (torch.float64, torch.bfloat16):
        return torch.maximum(lo, floats * (hi - lo) + lo)
    # XLA on the CPU fuses the scale and shift of f32 (and of f16, at f32)
    # into one multiply-add
    scaled = fma32(floats.float(), (hi - lo).float(), lo.float())
    return torch.maximum(lo, scaled.to(dtype))


def fma32(a, b, c):
    """`a * b + c` of float32 tensors (c may be a Python float, taken as
    a float32) with one rounding, as a fused multiply-add gives it: the
    product is exact in float64, the sum is rounded to odd there (its
    exact error from Knuth's two-sum), and rounding that to float32 is
    then correct."""
    p = a.double() * b.double()
    c = (c.double() if isinstance(c, torch.Tensor)
         else torch.full_like(p, float(np.float32(c))))
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.view(torch.int64)
    even = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(even, bits + toward, bits).view(torch.float64).float()


def bernoulli(key, p, shape):
    """`jax.random.bernoulli(key, p, shape)` for a Python float p: a
    float32 uniform below float32(p); `[..., *shape]` for keys
    `[..., 2]`."""
    threshold = torch.full((), p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < threshold


def _erfinv32(x):
    """XLA's float32 inverse error function on an f32 tensor."""
    w = -log1p32(-(x * x))
    small = w < 5.0
    # The card's float32 sqrt is not correctly rounded (0.7% of values
    # off by an ulp); float64's, rounded once more, is
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for lo, hi in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        # XLA fuses each step into one multiply-add
        p = fma32(p, w, torch.where(small, lo, hi))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def _f32(values):
    return tuple(float(np.float32(v)) for v in values)


# XLA's float32 `log1p` (its CPU intrinsic). For |x| < sqrt2 - 1, Cephes'
# x - x^2 / 2 + x^3 P(x) / Q(x) (coefficients highest degree first);
# otherwise Cephes' float32 log of 1 + x: 1 + x = 2^e m, m in
# [sqrt(0.5), sqrt(2)), y = m - 1, y - y^2 / 2 + y^3 R(y) + e log(2),
# R evaluated as three quadratics (c0 y + c1) y + c2 joined in y^3, and
# log(2) split in two
_LOG1P_P = _f32((4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                 6.5787325942061044846969, 2.9911919328553073277375e1,
                 6.0949667980987787057556e1, 5.7112963590585538103336e1,
                 2.0039553499201281259648e1))
_LOG1P_Q = _f32((1.5062909083469192043167e1, 8.3047565967967209469434e1,
                 2.2176239823732856465394e2, 3.0909872225312059774938e2,
                 2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOGF_R = _f32((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LN2_HI, _LN2_LO = 0.693359375, float(np.float32(-2.12194440e-4))
_SQRT_HALF = float(np.float32(0.707106781186547524))
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))


def _logf32(x):
    """Cephes' float32 log of an f32 tensor as XLA's CPU computes it: NaN
    at and below zero (all bits set), -inf at zero, +inf at +inf."""
    tiny = torch.finfo(torch.float32).tiny
    bits = torch.where(x > tiny, x, torch.full_like(x, tiny)).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    y = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = torch.where(low, e - 1.0, e)
    y2 = y * y
    y3 = y2 * y
    c = _LOGF_R
    q0, q1, q2 = (fma32(fma32(y, torch.full_like(y, c[k]), c[k + 1]), y,
                        c[k + 2]) for k in (0, 3, 6))
    r = fma32(fma32(fma32(q0, y3, q1), y3, q2), y3, e * _LN2_LO)
    out = fma32(e, torch.full_like(e, _LN2_HI), (y - y2 * 0.5) + r)
    nan = torch.full_like(out, -1, dtype=torch.int32).view(torch.float32)
    out = torch.where(x > 0, out, nan)
    return torch.where(x == 0, -torch.inf,
                       torch.where(x == torch.inf, torch.inf, out))


def log1p32(x):
    """XLA's float32 `log1p` of an f32 tensor, bit for bit (a subnormal
    input read as a zero of its sign, as XLA's CPU reads it)."""
    x = torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0, x)
    x2 = x * x
    num = torch.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        num = fma32(num, x, c)
    den = torch.ones_like(x)
    for c in _LOG1P_Q:
        den = fma32(den, x, c)
    ratio = (num.double() / den.double()).float()
    small = x + ((x * x2) * ratio - x2 * 0.5)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _logf32(x + 1.0))


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


# XLA's float32 `erf` (its CPU emitter): x clamped to +-erfinv(1 - 2^-23),
# then x P(x^2) / Q(x^2), each Horner step one multiply-add; coefficients
# highest degree first
_ERF_CLAMP = 3.7439211627767994
_ERF_P = (0.00022905065861350646, 0.0034082910107109506,
          0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185,
          0.0010179625278914885, 0.014070470171167667, 0.11098505178285362,
          0.49746925110067538, 1.0)


def _horner32(x2, coefficients):
    """A float32 polynomial in `x2` with one rounding a multiply-add."""
    p = torch.full_like(x2, coefficients[0])
    for c in coefficients[1:]:
        p = fma32(p, x2, c)
    return p


def erf32(x):
    """XLA's float32 `erf` of an f32 tensor, bit for bit (a subnormal
    input read as a zero of its sign, as XLA's CPU reads it)."""
    x = torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0, x)
    c = float(np.float32(_ERF_CLAMP))
    x = torch.clamp(x, -c, c)
    x2 = x * x
    return (x * _horner32(x2, _ERF_P)) / _horner32(x2, _ERF_Q)


def truncated_normal(key, lower, upper, shape):
    """`jax.random.truncated_normal(key, lower, upper, shape)` in float32
    for Python bounds: u uniform in [erf(lower / sqrt2), erf(upper /
    sqrt2)), `sqrt2 * erfinv(u)` clipped to the open interval (lower,
    upper) (the nearest floats inside it)."""
    f32 = torch.float32
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=f32, device=key.device)
    lo = torch.full((), lower, dtype=f32, device=key.device)
    hi = torch.full((), upper, dtype=f32, device=key.device)
    a, b = (float(erf32(bound / sqrt2)) for bound in (lo, hi))
    u = uniform(key, shape, f32, a, b)
    out = sqrt2 * _erfinv32(u)
    inf = torch.full((), math.inf, dtype=f32, device=key.device)
    return torch.clamp(out, torch.nextafter(lo, inf), torch.nextafter(hi, -inf))


# --------------------------------------------------------------------------- #
# Keys held on the host (two Python ints)

def split_words(words, i):
    """Key i of `split(key, n)` (any n > i) of the key `words = (k1, k2)`."""
    return threefry2x32(words[0], words[1], i >> 32, i & MASK32)


def fold_in_words(words, data):
    """`fold_in(key, data)` of the key `words`."""
    return threefry2x32(words[0], words[1], 0, int(data) & MASK32)


def uniform_words(words):
    """`uniform(key, ())` in float32 of the key `words`, a numpy scalar."""
    b1, b2 = threefry2x32(words[0], words[1], 0, 0)
    one_plus = np.uint32(((b1 ^ b2) >> 9) | 0x3F800000).view(np.float32)
    return one_plus - np.float32(1.0)
