"""Parity of the port's Krum, Median, Trimmed-mean, Phocas, MeaMed and
Aksel GARs and of the plain versions of their kernels with the JAX
package.

* Kernels 3, 6, 7 and 8 (`weighted_rows_mean`, `lower_median`,
  `trimmed_mean`, `closest_mean`): the port's wrappers, which run their
  plain versions on a CPU tensor, against the JAX Pallas kernels in
  interpret mode, at n in {1, 2, 9, 25, 64} and d = 1001 (not a multiple
  of 128), with NaN entries, +-inf entries and half-integer values (ties
  in sorts and deviations).
* Each GAR against the JAX registry at (n, f) in {(11, 4), (25, 11),
  (25, 5)}, on f identical Byzantine rows and an honest row with NaN
  entries; Krum's and Aksel's selections and influence, and every rule's
  `check` messages and `upper_bound` values.

Discrete outputs (selections, weights, influence, NaN/+-inf positions)
must match exactly; values within rtol 1e-5, atol 1e-6 (f32 sums taken
in another order). The CUDA kernels themselves run on a card only
(`tests/test_torch_gpu.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.ops import gars as jax_gars
from byzantinemomentum_tpu.ops import krum as jax_krum
from byzantinemomentum_tpu.ops import aksel as jax_aksel
from byzantinemomentum_tpu.ops import pallas_gar, pallas_sort
from byzantinemomentum_tpu_torch.ops import (
    _common, aksel, gar_kernels, gars, krum, sort_kernels)

RTOL, ATOL = 1e-5, 1e-6
D = 1001


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_values(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=ATOL)


def _kernel_input(n, seed):
    """f32[n, D]: normal values, the second half of the columns rounded to
    half-integers (equal values across rows), NaN entries in the last row,
    +inf in row 0 and -inf in row 1 (the same row at n = 1)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, D)).astype(np.float32)
    g[:, D // 2:] = np.round(g[:, D // 2:] * 2.0) / 2.0
    g[n - 1, rng.integers(0, D, size=9)] = np.nan
    g[0, rng.integers(0, D, size=5)] = np.inf
    g[1 % n, rng.integers(0, D, size=5)] = -np.inf
    return g


NS = (1, 2, 9, 25, 64)


@pytest.mark.parametrize("n", NS)
def test_lower_median_matches_pallas(n):
    g = _kernel_input(n, seed=n)
    want = pallas_sort.lower_median(jnp.asarray(g), interpret=True)
    _assert_values(sort_kernels.lower_median(_t(g)), want)
    _assert_values(_common.lower_median(_t(g)), want)


@pytest.mark.parametrize("n,f", ((1, 0), (2, 0), (9, 0), (9, 4), (25, 5),
                                 (25, 11), (64, 7)))
def test_trimmed_mean_matches_pallas(n, f):
    g = _kernel_input(n, seed=100 + n)
    want = pallas_sort.trimmed_mean(jnp.asarray(g), f, interpret=True)
    _assert_values(sort_kernels.trimmed_mean(_t(g), f), want)


@pytest.mark.parametrize("n,m", ((1, 1), (2, 1), (2, 2), (9, 5), (9, 9),
                                 (25, 14), (25, 25), (64, 57)))
def test_closest_mean_matches_pallas(n, m):
    """Centred on the lower median, with NaN centre entries: the output is
    NaN exactly there."""
    g = _kernel_input(n, seed=200 + n)
    c = np.sort(g, axis=0)[(n - 1) // 2]
    c[:7] = np.nan
    want = pallas_sort.closest_mean(jnp.asarray(g), jnp.asarray(c), m,
                                    interpret=True)
    got = sort_kernels.closest_mean(_t(g), _t(c), m)
    _assert_values(got, want)
    assert np.isnan(np.asarray(got)[:7]).all()
    _assert_values(_common.closest_mean(_t(g), _t(c), m), want)


@pytest.mark.parametrize("rows", (0, 3), ids=("w1d", "w2d"))
@pytest.mark.parametrize("n", NS)
def test_weighted_rows_mean_matches_pallas(n, rows):
    """Krum-style 1/m weights over random subsets; the first set of
    weights always selects the last row, whose NaN entries must come out
    as NaN at exactly their coordinates. Other non-finite rows count only
    where selected."""
    g = _kernel_input(n, seed=300 + n)
    rng = np.random.default_rng(n)
    W = np.zeros((max(rows, 1), n), np.float32)
    for r in range(W.shape[0]):
        m = int(rng.integers(1, n + 1))
        picked = rng.permutation(n)[:m]
        if r == 0:
            picked = np.union1d(picked[:m - 1], [n - 1])
        W[r, picked] = np.float32(1.0) / len(picked)
    w = W[0] if rows == 0 else W
    want = pallas_gar.weighted_rows_mean(jnp.asarray(w), jnp.asarray(g),
                                         interpret=True)
    got = gar_kernels.weighted_rows_mean(_t(w), _t(g))
    assert got.shape == want.shape
    _assert_values(got, want)
    _assert_values(_common.weighted_rows_mean(_t(w), _t(g)), want)
    nan_cols = np.isnan(g[n - 1])
    first = np.asarray(got if rows == 0 else got[0])
    assert np.isnan(first[nan_cols]).all()


# --------------------------------------------------------------------------- #
# The GARs

RULES = (("krum", {}), ("median", {}), ("trmean", {}), ("phocas", {}),
         ("meamed", {}), ("aksel", {"mode": "mid"}), ("aksel", {"mode": "n-f"}))


def _gar_input(n, f, seed):
    """n - f honest rows (one with NaN entries) then f identical Byzantine
    rows at `mean - 1.5 * std` of the honest ones."""
    rng = np.random.default_rng(seed)
    honest = rng.standard_normal((n - f, 2001)).astype(np.float32)
    byz = honest.mean(axis=0) - 1.5 * honest.std(axis=0)
    honest[1, rng.integers(0, 2001, size=4)] = np.nan
    return honest, np.repeat(byz[None, :], f, axis=0).astype(np.float32)


@pytest.mark.parametrize("name,kwargs", RULES,
                         ids=[name + "-" + "-".join(kw.values()) if kw else name
                              for name, kw in RULES])
@pytest.mark.parametrize("n,f", ((11, 4), (25, 11), (25, 5)))
def test_gar_matches_jax(name, kwargs, n, f):
    honest, byz = _gar_input(n, f, seed=n * f)
    g = np.concatenate([honest, byz])
    want = jax_gars[name](jnp.asarray(g), f=f, **kwargs)
    got = gars[name](_t(g), f=f, **kwargs)
    _assert_values(got, want)
    if name in ("krum", "aksel"):
        jax_mod, mod = (jax_krum, krum) if name == "krum" else (jax_aksel, aksel)
        sel = mod.selection(_t(g), f, **kwargs).numpy()
        np.testing.assert_array_equal(
            sel, np.asarray(jax_mod.selection(jnp.asarray(g), f, **kwargs)))
        # The influence is the Byzantine share of the selection: its count
        # must match exactly; XLA divides by the count as a product with
        # its f32 reciprocal, which may round the ratio one ulp away
        got = float(gars[name].influence(_t(honest), _t(byz), f=f, **kwargs))
        want = float(jax_gars[name].influence(
            jnp.asarray(honest), jnp.asarray(byz), f=f, **kwargs))
        assert round(got * len(sel)) == round(want * len(sel)) == np.sum(sel >= n - f)
        assert got == pytest.approx(want, rel=1e-6, abs=0)
    else:
        assert gars[name].influence is None and jax_gars[name].influence is None
    if name == "krum":
        dist = _common.pairwise_distances(_t(g))
        np.testing.assert_array_equal(
            krum.selection_weights(dist, f).numpy(),
            np.asarray(jax_krum.selection_weights(jnp.asarray(dist.numpy()), f)))
        _assert_values(krum.scores(_t(g), f), jax_krum.scores(jnp.asarray(g), f))


@pytest.mark.parametrize("m", (1, 3))
def test_krum_with_m_matches_jax(m):
    honest, byz = _gar_input(11, 2, seed=m)
    g = np.concatenate([honest, byz])
    _assert_values(gars["krum"](_t(g), f=2, m=m),
                   jax_gars["krum"](jnp.asarray(g), f=2, m=m))
    np.testing.assert_array_equal(
        krum.selection(_t(g), 2, m=m).numpy(),
        np.asarray(jax_krum.selection(jnp.asarray(g), 2, m=m)))


@pytest.mark.parametrize("name", ("krum", "median", "trmean", "phocas",
                                  "meamed", "aksel"))
def test_checks_and_bounds_match_jax(name):
    for n, f, kwargs in ((11, 4, {}), (11, 5, {}), (25, 11, {}), (25, 12, {}),
                         (7, 0, {}), (7, 3, {}), (3, 1, {}), (11, 4, {"m": 5}),
                         (11, 4, {"m": 6}), (11, 2, {"m": 0}),
                         (11, 4, {"mode": "n-f"}), (11, 4, {"mode": "bad"})):
        if "m" in kwargs and name != "krum" or "mode" in kwargs and name != "aksel":
            continue
        z = np.zeros((n, 2), np.float32)
        assert gars[name].check(gradients=_t(z), f=f, **kwargs) == \
            jax_gars[name].check(gradients=jnp.asarray(z), f=f, **kwargs)
    if jax_gars[name].upper_bound is None:
        assert gars[name].upper_bound is None
    else:
        for n, f in ((11, 4), (25, 11), (25, 5)):
            assert gars[name].upper_bound(n, f, 10) == \
                jax_gars[name].upper_bound(n, f, 10)
