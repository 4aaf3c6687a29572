"""The `method` argument of the distance-based GARs: the port against the
JAX package on the CPU.

* `_common.pairwise_distances(g, method=...)`: "dot" (the Gram matrix)
  and "diff" (the differences reduced directly) against the JAX
  package's, `squared` both ways, with +inf for the rows that hold a
  non-finite value and on the diagonal; values within rtol 1e-5 (f32
  sums taken in another order).
* Krum, Bulyan and Brute (Brute at n = 8, f = 2) take `method` and pass
  it on: with "dot" and with "diff", their selections (Krum's and
  Brute's indices, Bulyan's stage-1 weights) equal the JAX package's
  exactly, on inputs whose distances have no near-tie (the test checks
  the gaps), and their aggregates agree within rtol 1e-5, atol 1e-6.
* Any other method raises ValueError in both packages, and
  `--gar-args method:bogus` makes the port's driver fail with
  `--device cpu`.

Inputs are made with numpy from a seed.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.ops import _common as jax_common
from byzantinemomentum_tpu.ops import brute as jax_brute
from byzantinemomentum_tpu.ops import bulyan as jax_bulyan
from byzantinemomentum_tpu.ops import gars as jax_gars
from byzantinemomentum_tpu.ops import krum as jax_krum
from byzantinemomentum_tpu_torch.ops import _common, brute, bulyan, gars, krum

RTOL, ATOL = 1e-5, 1e-6
METHODS = ("dot", "diff")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_values(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=ATOL)


def _rows(n, d, seed, nan_row=None):
    """f32[n, d]: rows of normal values at distinct scales (distances far
    apart), optionally one row with NaN and +inf entries."""
    rng = np.random.default_rng(seed)
    scales = np.linspace(0.5, 2.0, n)[rng.permutation(n), None]
    g = (rng.standard_normal((n, d)) * scales).astype(np.float32)
    if nan_row is not None:
        g[nan_row, rng.integers(0, d, size=3)] = np.nan
        g[nan_row, rng.integers(0, d, size=2)] = np.inf
    return g


def _no_near_tie(values):
    """The sorted finite values differ by more than 1e-4 relative."""
    v = np.sort(np.asarray(values, np.float64)[np.isfinite(values)])
    assert np.all(np.diff(v) > 1e-4 * np.abs(v[1:])), v


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("squared", (False, True))
def test_pairwise_distances_match_jax(method, squared):
    g = _rows(9, 1001, seed=3, nan_row=4)
    got = _common.pairwise_distances(_t(g), squared=squared, method=method)
    want = jax_common.pairwise_distances(jnp.asarray(g), squared=squared,
                                         method=method)
    _assert_values(got, want)
    inf = np.eye(9, dtype=bool)
    inf[4, :] = inf[:, 4] = True
    np.testing.assert_array_equal(np.isposinf(got.numpy()), inf)


def test_pairwise_distance_methods_agree():
    """"diff" and "dot" are the same distances, up to rounding."""
    g = _t(_rows(11, 2001, seed=5))
    for squared in (False, True):
        torch.testing.assert_close(
            _common.pairwise_distances(g, squared=squared, method="diff"),
            _common.pairwise_distances(g, squared=squared, method="dot"),
            rtol=1e-4, atol=0)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,f", ((11, 2), (11, 4), (25, 11)))
def test_krum_method_matches_jax(method, n, f):
    g = _rows(n, 2001, seed=n + f, nan_row=1)
    _no_near_tie(krum.scores(_t(g), f, method=method).numpy())
    np.testing.assert_array_equal(
        krum.selection(_t(g), f, method=method).numpy(),
        np.asarray(jax_krum.selection(jnp.asarray(g), f, method=method)))
    _assert_values(krum.scores(_t(g), f, method=method),
                   jax_krum.scores(jnp.asarray(g), f, method=method))
    _assert_values(gars["krum"](_t(g), f=f, method=method),
                   jax_gars["krum"](jnp.asarray(g), f=f, method=method))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,f", ((11, 2), (25, 5)))
def test_bulyan_method_matches_jax(method, n, f):
    g = _rows(n, 2001, seed=7 * n + f, nan_row=2)
    dist = _common.pairwise_distances(_t(g), method=method)
    jax_dist = jax_common.pairwise_distances(jnp.asarray(g), method=method)
    _no_near_tie(torch.sort(dist, dim=1).values[:, :n - f - 2].sum(dim=1).numpy())
    np.testing.assert_array_equal(
        bulyan.selection_weights(dist, f).numpy(),
        np.asarray(jax_bulyan.selection_weights(jax_dist, f)))
    _assert_values(gars["bulyan"](_t(g), f=f, method=method),
                   jax_gars["bulyan"](jnp.asarray(g), f=f, method=method))


@pytest.mark.parametrize("method", METHODS)
def test_brute_method_matches_jax(method):
    n, f = 8, 2
    g = _rows(n, 1001, seed=11, nan_row=6)
    sel = brute.selection(_t(g), f, method=method).numpy()
    np.testing.assert_array_equal(
        sel, np.asarray(jax_brute.selection(jnp.asarray(g), f, method=method)))
    assert 6 not in sel
    _assert_values(gars["brute"](_t(g), f=f, method=method),
                   jax_gars["brute"](jnp.asarray(g), f=f, method=method))
    # The winner's diameter is clear of the runner-up's
    dist = _common.pairwise_distances(_t(g), method=method).numpy()
    diameters = []
    for mask in range(2 ** n):
        members = [i for i in range(n) if mask >> i & 1]
        if len(members) == n - f:
            sub = dist[np.ix_(members, members)]
            diameters.append(sub[~np.eye(n - f, dtype=bool)].max())
    _no_near_tie(np.unique(np.asarray(diameters))[:2])


@pytest.mark.parametrize("name", ("krum", "bulyan", "brute"))
def test_unknown_method_raises_in_both_packages(name):
    g = _rows(11, 101, seed=13)
    f = 2
    with pytest.raises(ValueError, match="Unknown pairwise distance method 'bogus'"):
        gars[name](_t(g), f=f, method="bogus")
    with pytest.raises(ValueError, match="Unknown pairwise distance method 'bogus'"):
        jax_gars[name](jnp.asarray(g), f=f, method="bogus")
    for module in (_common, jax_common):
        with pytest.raises(ValueError, match="Unknown pairwise distance method"):
            module.pairwise_distances(g if module is jax_common else _t(g),
                                      method="dot ")


def test_driver_refuses_an_unknown_method(tmp_path):
    env = {**os.environ, "BMT_SYNTH_TRAIN": "64", "BMT_SYNTH_TEST": "16",
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch", "--device", "cpu",
         "--seed", "1", "--nb-steps", "1", "--nb-workers", "7",
         "--nb-decl-byz", "2", "--nb-real-byz", "2", "--gar", "krum",
         "--gar-args", "method:bogus", "--attack", "empire",
         "--attack-args", "factor:1.1", "--model", "empire-cnn",
         "--dataset", "cifar10", "--batch-size", "2",
         "--batch-size-test", "8", "--batch-size-test-reps", "1",
         "--evaluation-delta", "0", "--nb-for-study", "1",
         "--nb-for-study-past", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
        check=False)
    assert proc.returncode != 0
    assert "Unknown pairwise distance method 'bogus'" in proc.stderr
