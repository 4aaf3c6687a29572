"""Parity of the PyTorch port's GAR layer with the JAX package.

The same numpy inputs go through the JAX function and the port's
counterpart. The JAX kernels run as `tests/test_pallas.py` runs them, in
Pallas interpret mode. Discrete outputs (selection weights, +inf and NaN
positions) must match exactly; values within rtol 1e-5, atol 1e-6 (f32
sums taken in another order). The CUDA kernels themselves only run on a
card: `test_kernels_match_plain_on_card` is marked `gpu` and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.attacks import attacks as jax_attacks
from byzantinemomentum_tpu.ops import _common as jax_common
from byzantinemomentum_tpu.ops import bulyan as jax_bulyan
from byzantinemomentum_tpu.ops import gars as jax_gars
from byzantinemomentum_tpu.ops import pallas_gar, pallas_sort
from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.attacks import attacks
from byzantinemomentum_tpu_torch.ops import _common, bulyan, gar_kernels, gars, sort_kernels

RTOL, ATOL = 1e-5, 1e-6


def _mat(n, d, seed, nan_rows=(), inf_rows=(), dup=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    if dup:  # equal values across rows: ties in sorts and deviations
        g = np.round(g * 2.0).astype(np.float32) / 2.0
    for r in nan_rows:
        g[r, rng.integers(0, d, size=3)] = np.nan
    for r in inf_rows:
        g[r, rng.integers(0, d)] = np.inf
    return g


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_values(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", range(1, 65))
def test_batcher_network_sorts_nan_last(n):
    rng = np.random.default_rng(n)
    g = np.round(rng.standard_normal((n, 40)), 1).astype(np.float32)
    g[rng.random((n, 40)) < 0.2] = np.nan
    assert sort_kernels.batcher_pairs(n) == pallas_sort._batcher_pairs(n)
    keys = sort_kernels.select_keys(list(sort_kernels.value_keys(_t(g))))
    got = torch.stack([sort_kernels.key_values(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, np.sort(g, axis=0))


@pytest.mark.parametrize("n", (5, 11, 25))
def test_sq_gram_and_distances_match_jax(n):
    g = _mat(n, 4999, seed=n, nan_rows=(1,), inf_rows=(2,))
    want = np.asarray(pallas_gar.sq_gram(jnp.asarray(g), interpret=True))
    got = gar_kernels.sq_gram(_t(g)).numpy()
    # Gram entries are compared against the scale of their rows
    # (Cauchy-Schwarz): an off-diagonal dot may cancel to near zero
    norms = np.sqrt(np.abs(np.diagonal(want)))
    _assert_values(got, want, atol=RTOL * float(np.max(norms[np.isfinite(norms)])) ** 2)
    dist = _common.pairwise_distances(_t(g)).numpy()
    _assert_values(dist, np.asarray(jax_common.pairwise_distances(jnp.asarray(g))))
    assert bool(_common.all_finite_from_dist(_t(dist))) is False
    finite = np.delete(g, (1, 2), axis=0)
    clean = _common.pairwise_distances(_t(finite))
    assert bool(_common.all_finite_from_dist(clean)) == bool(
        jax_common.all_finite_from_dist(jnp.asarray(clean.numpy())))


@pytest.mark.parametrize("n,f,m,dup", ((11, 2, None, False), (25, 5, None, False),
                                       (25, 5, 7, False), (25, 5, None, True)))
def test_selection_weights_match_exactly(n, f, m, dup):
    g = _mat(n, 300, seed=n + f, nan_rows=(n - 1,), dup=dup)
    if dup:
        g[3] = g[4]  # identical rows: tied scores resolve by index
    dist = np.asarray(jax_common.pairwise_distances(jnp.asarray(g)))
    want = np.asarray(jax_bulyan.selection_weights(jnp.asarray(dist), f, m))
    got = bulyan.selection_weights(_t(dist), f, m).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,f,nan_rows", (
    (25, 5, ()),          # m2 = 3
    (11, 2, ()),          # m2 = 1
    (25, 5, (20, 23)),    # non-finite rows that are never selected
    (16, 3, ()),          # m2 = 2
))
def test_bulyan_aggregate_matches_jax(n, f, nan_rows):
    g = _mat(n, 3001, seed=7 * n, nan_rows=nan_rows)
    want = np.asarray(jax_bulyan.aggregate(jnp.asarray(g), f))
    got = gars["bulyan"](_t(g), f=f).numpy()
    _assert_values(got, want)
    dist = _common.pairwise_distances(_t(g))
    W = bulyan.selection_weights(dist, f)
    m2 = W.shape[0] - 2 * f
    fused = np.asarray(pallas_gar.selected_median_mean(
        jnp.asarray(W.numpy()), jnp.asarray(g), m2, interpret=True))
    plain = gar_kernels.selected_median_mean(W, _t(g), m2).numpy()
    _assert_values(plain, fused)
    _assert_values(plain, got)


@pytest.mark.parametrize("m2", (1, 3))
def test_selected_nan_and_ties(m2):
    """A NaN inside a SELECTED row gives NaN at exactly its coordinate of
    that round's average; the median and closest mean then see it last.
    Half-integer rows averaged with weight 1/4 are exact in any summation
    order, so the deviation ties survive into both packages intact."""
    n, rounds = 9, 5
    g = _mat(n, 257, seed=3, dup=True)
    g[0, 10] = np.nan
    g[0, 11] = np.inf
    g[1, 10] = np.nan
    W = np.zeros((rounds, n), np.float32)
    for r in range(rounds):
        W[r, r:r + 4] = 0.25  # rounds 0 and 1 select the bad rows
    want = np.asarray(pallas_gar.selected_median_mean(
        jnp.asarray(W), jnp.asarray(g), m2, interpret=True))
    got = gar_kernels.selected_median_mean(_t(W), _t(g), m2).numpy()
    _assert_values(got, want)
    stack = np.asarray(jax_common.weighted_rows_mean(jnp.asarray(W), jnp.asarray(g)))
    _assert_values(_common.weighted_rows_mean(_t(W), _t(g)).numpy(), stack)
    _assert_values(_common.averaged_median(_t(stack), m2).numpy(),
                   np.asarray(jax_common.averaged_median(jnp.asarray(stack), m2)))


def test_average_and_checks_match_jax():
    g = _mat(11, 100, seed=1)
    _assert_values(gars["average"](_t(g)).numpy(),
                   np.asarray(jax_gars["average"](jnp.asarray(g))))
    for n, f in ((11, 2), (11, 3), (25, 5), (7, 1)):
        z = np.zeros((n, 2), np.float32)
        assert gars["bulyan"].check(gradients=_t(z), f=f) == \
            jax_gars["bulyan"].check(gradients=jnp.asarray(z), f=f)
        assert gars["bulyan"].upper_bound(n, f, 10) == \
            jax_gars["bulyan"].upper_bound(n, f, 10)
    assert gars["bulyan"].influence is None
    with pytest.raises(utils.UserException):
        gars["bulyan"](_t(np.zeros((10, 3), np.float32)), f=2)


@pytest.mark.parametrize("name,kwargs", (("empire", {"factor": 1.1}),
                                         ("little", {"factor": 1.5}),
                                         ("bulyan", {"factor": 2.0, "negative": True})))
def test_identical_attacks_match_jax(name, kwargs):
    g = _mat(9, 50, seed=4)
    defense = jax_gars["average"].unchecked
    want = np.asarray(jax_attacks[name](jnp.asarray(g), 2, 3, defense=defense, **kwargs))
    got = attacks[name](_t(g), 2, 3, defense=gars["average"].unchecked, **kwargs).numpy()
    _assert_values(got, want)
    # A negative factor line-searches the defense (4 evaluations)
    kwargs = {**kwargs, "factor": -4}
    want = np.asarray(jax_attacks[name](jnp.asarray(g), 2, 3, defense=defense, **kwargs))
    got = attacks[name](_t(g), 2, 3, defense=gars["average"].unchecked, **kwargs).numpy()
    _assert_values(got, want)


# --------------------------------------------------------------------------- #
# Launch geometry of the redesigned sq_gram and weighted_rows_mean kernels
# (plain Python: the kernels themselves run only on a card)

HEADLINE_D = 1_310_922
# (d, address) for each residue of d mod 4 and of the address mod 16; 256
# is where torch places a fresh allocation, the rest are row slices
WIDTH_PATHS = [(HEADLINE_D - 2 + dm, 256 + off) for dm in range(4)
               for off in (0, 4, 8, 12)]


@pytest.mark.parametrize("d,address", WIDTH_PATHS)
def test_vector_bytes_is_the_widest_aligned_access(d, address):
    width = gar_kernels.vector_bytes(d, address)
    assert width in (4, 8, 16)
    # Every row i starts at address + 4 i d: aligned to the width for all i
    assert all((address + 4 * i * d) % width == 0 for i in range(8))
    wider = [w for w in (8, 16) if w > width]
    assert all((4 * d) % w or address % w for w in wider)
    r1 = gar_kernels.rows_mean_geometry(1, d, address)
    assert r1 == (width // 4, 1)
    assert gar_kernels.gram_geometry(25, d, address).copy == width


@pytest.mark.parametrize("n", range(1, 65))
def test_gram_geometry_covers_every_pair(n):
    geo = gar_kernels.gram_geometry(n, HEADLINE_D, 256)
    b = geo.block
    nb = -(-n // b)
    assert 1 <= b <= gar_kernels.GRAM_MAX_BLOCK
    assert geo.pairs == nb * (nb + 1) // 2 <= 36
    # Threads: 8 per (pair, slice) unit, whole warps, within the limit
    units = geo.pairs * geo.slices
    assert units <= 32 or geo.slices == 1
    assert geo.threads % 32 == 0 and units * 8 <= geo.threads < units * 8 + 32
    assert geo.threads <= gar_kernels.GRAM_MAX_THREADS
    # Lanes s * 8 + l + k * slices * 8 cover a slab row's float4s once
    assert geo.tile % (32 * geo.slices) == 0 and geo.tile >= gar_kernels.GRAM_MIN_TILE
    seen = sorted(s * 8 + lane + k * geo.slices * 8 for s in range(geo.slices)
                  for lane in range(8) for k in range(geo.tile // (32 * geo.slices)))
    assert seen == list(range(geo.tile // 4))
    # Every entry i <= j < n lies in exactly one block pair I <= J
    owners = {(i // b, j // b) for i in range(n) for j in range(i, n)}
    assert owners == {(I, J) for I in range(nb) for J in range(I, nb)}
    # Shared memory: the ring of padded slabs and the slice reduction
    assert geo.smem >= 4 * gar_kernels.GRAM_STAGES * nb * b * geo.tile
    assert geo.smem >= 4 * geo.slices * geo.pairs * b * b
    assert geo.smem <= gar_kernels.SMEM_LIMIT
    # No other block that fits costs less a column: FMAs + 8 x shared reads
    def cost(c):
        pairs = -(-n // c) * (-(-n // c) + 1) // 2
        return pairs * (c * c + 8 * c) if 8 * pairs <= gar_kernels.GRAM_MAX_THREADS else None
    assert cost(b) == min(x for x in map(cost, range(1, 9)) if x is not None)
    # The block the design names: no padding at n = 25, B = 8 at n = 64
    assert {25: 5, 64: 8}.get(n, b) == b


@pytest.mark.parametrize("r", (1, 2, 8, 15, 16, 17, 33, 64))
def test_rows_mean_geometry_reads_g_once(r):
    for d, address in WIDTH_PATHS:
        width, row_block = gar_kernels.rows_mean_geometry(r, d, address)
        # One block holds every row of W: one form for Krum's w, one for
        # any other r
        assert row_block == (1 if r == 1 else gar_kernels.MAX_ROWS) >= r
        assert d % width == 0 and address % (4 * width) == 0
        assert width == 1 or r == 1


def test_persistent_blocks():
    assert gar_kernels.persistent_blocks(10_242, 3, 132) == 396
    assert gar_kernels.persistent_blocks(5, 3, 132) == 5
    with pytest.raises(RuntimeError, match="resident"):
        gar_kernels.persistent_blocks(5, 0, 132)
