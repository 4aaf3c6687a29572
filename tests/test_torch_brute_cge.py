"""Parity of the port's Brute and CGE GARs, and of the plain versions of
kernels 4 and 5 (`masked_rows_mean`, `colsort`), with the JAX package.

* Kernel 4: the port's `gar_kernels.masked_rows_mean`, which runs its
  plain version on a CPU tensor, against `pallas_gar.masked_rows_mean` in
  interpret mode: an excluded NaN row, a selected +inf that must stay
  +inf, selected -inf and NaN entries, at n in {1, 2, 9, 25, 64} and a
  ragged d = 301. Values within rtol 1e-6, atol 1e-6 (f32 sums in another
  order); NaN and +-inf positions exact.
* Kernel 5: `sort_kernels.colsort` against `pallas_sort.colsort` in
  interpret mode on f32 at the same n, with NaN rows, +-inf and ties:
  exactly equal (a sort moves values, it computes none).
* Brute against the JAX registry at (n, f) in {(7, 2), (11, 4), (13, 6)},
  with duplicated rows that make many subsets tie: the selection and the
  influence exactly, the aggregate within rtol 1e-5, atol 1e-6; the
  unranking against `itertools.combinations`; the rank-space refusal;
  `check` and `upper_bound`.
* CGE against the JAX registry: the selection exactly (norm ties in index
  order, a NaN row last), the aggregate, the influence and `check`.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.ops import brute as jax_brute
from byzantinemomentum_tpu.ops import cge as jax_cge
from byzantinemomentum_tpu.ops import gars as jax_gars
from byzantinemomentum_tpu.ops import pallas_gar, pallas_sort
from byzantinemomentum_tpu_torch.ops import (
    brute, cge, gar_kernels, gars, sort_kernels)

from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
NS = (1, 2, 9, 25, 64)
D = 301  # not a multiple of any tile width


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


def _kernel_input(n, seed):
    """f32[n, D]: normal values, the second half of the columns rounded to
    half-integers (ties; +0, never -0), NaN entries in the last row, +inf
    in row 0 and -inf in row 1 (the same row at n = 1)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, D)).astype(np.float32)
    g[:, D // 2:] = np.round(g[:, D // 2:] * 2.0) / 2.0 + np.float32(0.0)
    g[n - 1, rng.integers(0, D, size=9)] = np.nan
    g[0, rng.integers(0, D, size=5)] = np.inf
    g[1 % n, rng.integers(0, D, size=5)] = -np.inf
    return g


# --------------------------------------------------------------------------- #
# Kernels 4 and 5

@pytest.mark.parametrize("n", NS)
def test_masked_rows_mean_matches_pallas(n):
    """A random subset that always takes row 0 (+inf entries) and, from
    n = 3 on, leaves out the last row (NaN entries); at n <= 2 the NaN
    row is selected and its NaN must come out."""
    g = _kernel_input(n, seed=400 + n)
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.6
    mask[0] = True
    if n >= 3:
        mask[n - 1] = False
    k = max(int(mask.sum()), 1)
    want = pallas_gar.masked_rows_mean(jnp.asarray(mask), jnp.asarray(g), k,
                                       interpret=True)
    got = gar_kernels.masked_rows_mean(_t(mask), _t(g), k)
    _assert_values(got, want, rtol=1e-6)
    # Where a column's selected entries hold a +inf and no -inf or NaN,
    # the +inf comes out; a selected NaN comes out as NaN
    picked = g[mask]
    posinf = (np.isposinf(picked).any(axis=0)
              & ~(np.isneginf(picked) | np.isnan(picked)).any(axis=0))
    assert posinf.any() and np.isposinf(np.asarray(got)[posinf]).all()
    assert np.isnan(np.asarray(got)[np.isnan(picked).any(axis=0)]).all()


def test_masked_rows_mean_keeps_brute_inf_contract():
    """The case of the JAX package's own test: an excluded all-NaN row is
    zeroed, a selected +inf stays +inf (not normalised to NaN)."""
    rng = np.random.default_rng(2)
    g = rng.standard_normal((6, 64)).astype(np.float32)
    g[5, :] = np.nan
    g[1, 3] = np.inf
    mask = np.array([True, True, True, True, False, False])
    want = pallas_gar.masked_rows_mean(jnp.asarray(mask), jnp.asarray(g), 4,
                                       interpret=True)
    got = gar_kernels.masked_rows_mean(_t(mask), _t(g), 4)
    assert np.isposinf(np.asarray(got)[3]) and np.isposinf(np.asarray(want)[3])
    _assert_values(got, want, rtol=1e-6)


@pytest.mark.parametrize("n", NS)
def test_colsort_matches_pallas(n):
    g = _kernel_input(n, seed=500 + n)
    want = np.asarray(pallas_sort.colsort(jnp.asarray(g), interpret=True))
    got = sort_kernels.colsort(_t(g)).numpy()
    assert got.shape == want.shape == g.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)
    # NaN sorts last in every column
    assert not (np.isnan(got[:-1]) & ~np.isnan(got[1:])).any()


# --------------------------------------------------------------------------- #
# Brute

BRUTE_CELLS = ((7, 2), (11, 4), (13, 6))


def _tied_input(n, f, seed):
    """n - f honest rows, three of them copies of row 1 and one with NaN
    entries past n = 7, then f identical Byzantine rows at
    `mean - 1.5 * std` of the honest ones: many subsets share a diameter."""
    rng = np.random.default_rng(seed)
    honest = rng.standard_normal((n - f, 33)).astype(np.float32)
    honest[2] = honest[1]
    honest[3] = honest[1]
    if n > 7:
        honest[4, rng.integers(0, 33, size=3)] = np.nan
    byz = honest[np.isfinite(honest).all(axis=1)].mean(axis=0) \
        - 1.5 * honest[np.isfinite(honest).all(axis=1)].std(axis=0)
    return honest, np.repeat(byz[None, :], f, axis=0).astype(np.float32)


@pytest.mark.parametrize("n,f", BRUTE_CELLS)
def test_brute_matches_jax(n, f):
    honest, byz = _tied_input(n, f, seed=n * f)
    g = np.concatenate([honest, byz])
    sel = brute.selection(_t(g), f).numpy()
    np.testing.assert_array_equal(sel, np.asarray(jax_brute.selection(jnp.asarray(g), f)))
    dist = jax_brute.pairwise_distances(jnp.asarray(g))
    np.testing.assert_array_equal(
        brute.best_subset_mask_from_dist(_t(np.asarray(dist)), f).numpy(),
        np.asarray(jax_brute.best_subset_mask_from_dist(dist, f)))
    _assert_values(gars["brute"](_t(g), f=f), jax_gars["brute"](jnp.asarray(g), f=f))
    got = float(gars["brute"].influence(_t(honest), _t(byz), f=f))
    want = float(jax_gars["brute"].influence(jnp.asarray(honest), jnp.asarray(byz), f=f))
    assert round(got * (n - f)) == round(want * (n - f)) == np.sum(sel >= n - f)
    assert got == pytest.approx(want, rel=1e-6, abs=0)


def test_brute_tie_break_is_the_first_minimum():
    """Rows 3 and 4 copy rows 0 and 1, so several size-4 subsets share the
    smallest diameter: the winner is the first in
    `itertools.combinations` order, as in the JAX package."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((3, 4)).astype(np.float32)
    g = np.concatenate([base, base[:2]])
    sel = brute.selection(_t(g), 1).numpy()
    dist = np.linalg.norm(g[:, None] - g[None, :], axis=2)
    diams = {combo: max(dist[x, y] for x, y in itertools.combinations(combo, 2))
             for combo in itertools.combinations(range(5), 4)}
    best = min(diams.values())
    first = next(c for c in itertools.combinations(range(5), 4)
                 if diams[c] <= best + 1e-6)
    assert tuple(sel) == first
    np.testing.assert_array_equal(sel, np.asarray(jax_brute.selection(jnp.asarray(g), 1)))


@pytest.mark.parametrize("n,k", ((9, 5), (9, 4), (12, 1), (12, 12)))
def test_brute_unranking_matches_itertools(n, k):
    tbl_np = brute._binom_table(n, k)
    total = int(tbl_np[n, k])
    masks = brute._unrank_masks(torch.arange(total), n, k,
                                torch.from_numpy(np.array(tbl_np))).numpy()
    assert [tuple(np.nonzero(m)[0]) for m in masks] == list(
        itertools.combinations(range(n), k))


def test_brute_refuses_a_rank_space_beyond_int32():
    """C(34, 17) = 2,333,606,220 subsets: both packages refuse with the
    same message before enumerating anything."""
    dist = np.zeros((34, 34), np.float32)
    with pytest.raises(ValueError) as want:
        jax_brute.best_subset_mask_from_dist(jnp.asarray(dist), 17)
    with pytest.raises(ValueError) as got:
        brute.best_subset_mask_from_dist(_t(dist), 17)
    assert str(got.value) == str(want.value)
    assert "exceeds int32 rank space" in str(got.value)


# --------------------------------------------------------------------------- #
# CGE

@pytest.mark.parametrize("n,f", ((7, 2), (11, 4), (25, 11)))
def test_cge_matches_jax(n, f):
    """Rows 2 and 3 copy row 1 (equal norms: index order), row 4 holds a
    NaN (+inf norm: last); f identical Byzantine rows."""
    honest, byz = _tied_input(n, f, seed=100 + n)
    honest[4, 0] = np.nan
    g = np.concatenate([honest, byz])
    sel = cge.selection(_t(g), f).numpy()
    np.testing.assert_array_equal(sel, np.asarray(jax_cge.selection(jnp.asarray(g), f)))
    assert 4 not in sel
    assert list(sel).index(1) < list(sel).index(2) < list(sel).index(3)
    _assert_values(cge.norms(_t(g)), jax_cge.norms(jnp.asarray(g)))
    _assert_values(gars["cge"](_t(g), f=f), jax_gars["cge"](jnp.asarray(g), f=f))
    got = float(gars["cge"].influence(_t(honest), _t(byz), f=f))
    want = float(jax_gars["cge"].influence(jnp.asarray(honest), jnp.asarray(byz), f=f))
    assert round(got * (n - f)) == round(want * (n - f)) == np.sum(sel >= n - f)
    assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("name", ("brute", "cge"))
def test_brute_and_cge_checks_and_bounds_match_jax(name):
    for n, f in ((11, 4), (11, 5), (25, 11), (25, 12), (7, 0), (7, 3), (3, 1),
                 (0, 1)):
        z = np.zeros((n, 2), np.float32)
        assert gars[name].check(gradients=_t(z), f=f) == \
            jax_gars[name].check(gradients=jnp.asarray(z), f=f)
    if jax_gars[name].upper_bound is None:
        assert gars[name].upper_bound is None
    else:
        for n, f in ((11, 4), (25, 11), (25, 5)):
            assert gars[name].upper_bound(n, f, 10) == \
                jax_gars[name].upper_bound(n, f, 10)
