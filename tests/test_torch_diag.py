"""The port's GAR diagnostics (`ops/diag.py`, each rule's `diagnose`, and
`GAR.diagnosed`/`GAR.checked(..., diagnostics=True)`) against the JAX
package's.

* Every registered rule (`average` through `_generic_diagnose`) on stacks
  with a NaN row, +-inf entries, half-integer ties and a column of +-0:
  the port's `diagnosed` against the JAX `diagnosed` (op by op, as the
  JAX tests call it; the JAX package's CPU path, which takes its jnp
  forms where the Pallas kernels do not run), in f32 at n = 11, f = 2 and
  at n = 25, f = 5 (the headline's n and f), and in bf16 and f16 at
  n = 11, f = 2:
  - the aggregate is the port's plain aggregate bit for bit, and the
    JAX aggregate within the GAR tolerance (in bf16 and f16 2 ulps at the
    stack's largest magnitude: the port's half kernels round every add
    in the dtype, as the Pallas kernels do, where the JAX CPU path sums
    at f32);
  - `selection` and `trim_frac` are JAX's exactly (0/1 masks, k/rounds
    masses, counts over d in f32);
  - `scores` and `dist` within rtol 1e-5, atol 1e-6 (the GAR tests'
    tolerance; in bf16 and f16 the dtype's 2 ulps, rtol 2^-7 and 2^-10,
    with the dtype's absolute floor at the values' scale, since a bf16
    Gram cancels in its own dtype), +-inf at the same positions;
  - the aux schema is uniform (the JAX `test_diagnostics_aux_schema_
    uniform`): the four keys, f32, [n] and [n, n], real distances.
* The helpers (`make_aux`, `selection_from_indices`, `distance_summary`,
  `var_norm_ratio`, `rank_kept_mask`, `rank_kept_fraction`) against
  JAX's, with NaN columns, a column whose kept threshold is NaN, +inf
  rows and an all-+inf slice.
* The plain path: with every function of `ops/diag.py` made to raise,
  every rule's `checked` and `unchecked` still run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.ops import diag as jax_diag
from byzantinemomentum_tpu_torch import ops
from byzantinemomentum_tpu_torch.ops import diag

from tests.torch_threads import one_torch_thread  # noqa: F401

RULES = ("average", "bulyan", "krum", "median", "trmean", "phocas", "meamed",
         "aksel", "brute", "cge")
# (case, torch dtype, numpy dtype for JAX, n, f, d)
CASES = {
    "f32-n11": (torch.float32, jnp.float32, 11, 2, 301),
    "f32-n25": (torch.float32, jnp.float32, 25, 5, 203),
    "bf16-n11": (torch.bfloat16, jnp.bfloat16, 11, 2, 301),
    "f16-n11": (torch.float16, jnp.float16, 11, 2, 301),
}
# rtol by dtype: the GAR tests' f32 tolerance, 2 ulps of a half dtype
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
ATOL = 1e-6


def stack(n, d, seed):
    """f32[n, d]: normal rows, two far rows, the second half of the
    columns rounded to half-integers (ties), NaN entries in the last
    honest-looking row, +inf in row 0, -inf in row 1 and a column of
    +-0."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[n - 2:] += 6.0
    g[:, d // 2:] = np.round(g[:, d // 2:] * 2.0) / 2.0
    g[n - 3, rng.integers(0, d, size=4)] = np.nan
    g[0, rng.integers(0, d, size=3)] = np.inf
    g[1, rng.integers(0, d, size=3)] = -np.inf
    g[:, 5] = 0.0
    g[::2, 5] = -0.0
    return g


def as_pair(g, tdtype, jdtype):
    """The same values as a torch tensor and a JAX array of the dtype."""
    t = torch.from_numpy(g).to(tdtype)
    return t, jnp.asarray(t.float().numpy()).astype(jdtype)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_values(got, want, rtol, scale=0.0):
    """NaN and +-inf at the same positions, finite values within rtol
    (and the absolute floor `rtol * scale`)."""
    got, want = f32(got), f32(want)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=max(ATOL, rtol * scale))


def assert_exact(got, want):
    np.testing.assert_array_equal(f32(got).view(np.int32),
                                  f32(want).view(np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rule", RULES)
def test_diagnosed_matches_jax(rule, case):
    tdtype, jdtype, n, f, d = CASES[case]
    g = stack(n, d, seed=len(rule) + n)
    G, jG = as_pair(g, tdtype, jdtype)
    gar = ops.gars[rule]
    agg, aux = gar.diagnosed(G, f=f)
    jagg, jaux = jax_ops.gars[rule].diagnosed(jG, f=f)
    rtol = RTOL[tdtype]
    half = tdtype != torch.float32
    values = np.abs(g[np.isfinite(g)])

    # The aggregate: the plain one bit for bit, JAX's within tolerance
    plain = gar.unchecked(G, f=f)
    assert agg.dtype == plain.dtype == tdtype
    assert_exact(agg, plain)
    assert_values(agg, jagg, rtol, float(values.max()) if half else 0.0)

    # Schema: the four keys, f32, real distances off the diagonal
    assert set(aux) == set(diag.AUX_KEYS) == set(jax_diag.AUX_KEYS)
    for key in ("scores", "selection", "trim_frac"):
        assert aux[key].shape == (n,) and aux[key].dtype == torch.float32
    assert aux["dist"].shape == (n, n) and aux["dist"].dtype == torch.float32
    offdiag = ~np.eye(n, dtype=bool)
    assert np.all(aux["dist"].numpy()[offdiag] > 0)

    # Discrete keys exactly, values within the tolerance
    assert_exact(aux["selection"], jaux["selection"])
    assert_exact(aux["trim_frac"], jaux["trim_frac"])
    finite = f32(jaux["dist"])[np.isfinite(f32(jaux["dist"]))]
    scale = float(np.abs(finite).max()) if tdtype != torch.float32 else 0.0
    assert_values(aux["dist"], jaux["dist"], rtol, scale)
    assert_values(aux["scores"], jaux["scores"], rtol,
                  scale * (n if rule == "bulyan" else 1.0) if scale else 0.0)


@pytest.mark.parametrize("rule", RULES)
def test_checked_with_diagnostics_returns_the_pair(rule):
    g = torch.from_numpy(stack(11, 64, seed=3))
    gar = ops.gars[rule]
    agg, aux = gar.checked(g, f=2, diagnostics=True)
    want_agg, want_aux = gar.diagnosed(g, f=2)
    assert_exact(agg, want_agg)
    for key in diag.AUX_KEYS:
        assert_exact(aux[key], want_aux[key])
    assert_exact(gar(g, f=2), want_agg)


def test_krum_selection_is_the_weight_mass():
    """Krum's selection is `w * m`: 1 on each of the m = n - f - 2
    selected rows, the far rows out."""
    g = torch.from_numpy(stack(11, 64, seed=4))
    _, aux = ops.gars["krum"].diagnosed(g, f=2)
    sel = aux["selection"].numpy()
    assert sorted(set(sel.tolist())) == [0.0, 1.0]
    assert int(sel.sum()) == 11 - 2 - 2
    assert sel[9] == sel[10] == 0.0


# --------------------------------------------------------------------------- #
# Helpers

def _dist(seed, inf_rows=()):
    """A symmetric f32 distance matrix with a +inf diagonal and +inf rows
    and columns `inf_rows`."""
    rng = np.random.default_rng(seed)
    n = 9
    x = rng.random((n, n)).astype(np.float32) * 10
    x = (x + x.T).astype(np.float32)
    for i in inf_rows:
        x[i, :] = x[:, i] = np.inf
    np.fill_diagonal(x, np.inf)
    return x


@pytest.mark.parametrize("rows", (None, 1, 5, 9))
@pytest.mark.parametrize("inf_rows", ((), (0,), (6, 8), tuple(range(9))),
                         ids=("finite", "row0", "rows68", "all"))
def test_distance_summary_matches_jax(rows, inf_rows):
    x = _dist(len(inf_rows), inf_rows)
    got = diag.distance_summary(torch.from_numpy(x), rows=rows)
    want = jax_diag.distance_summary(jnp.asarray(x), rows=rows)
    for a, b in zip(got, want):
        assert_exact(a, b)


@pytest.mark.parametrize("m", (1, 2, 7))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
def test_var_norm_ratio_matches_jax(m, dtype):
    g = np.random.default_rng(m).standard_normal((m, 513)).astype(np.float32)
    g += 0.5
    t, jg = as_pair(g, getattr(torch, dtype), getattr(jnp, dtype))
    got, want = diag.var_norm_ratio(t), jax_diag.var_norm_ratio(jg)
    assert got.dtype == torch.float32 and got.shape == ()
    assert_values(got, want, RTOL[t.dtype] * (2 if dtype != "float32" else 1))


def _trim_input(dtype):
    """f32/half [9, 40]: ties, +-0, a NaN row, a column with NaN in 4
    rows (its sorted[n - f - 1] is NaN at f = 3) and an all-NaN column."""
    g = stack(9, 40, seed=11)
    g[:, 7] = np.nan
    g[:4, 8] = np.nan
    t = torch.from_numpy(g).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("f,low,high", ((2, None, None), (3, None, None),
                                        (2, 0, 7), (4, 0, 5)))
def test_rank_kept_matches_jax(dtype, f, low, high):
    t, jg = _trim_input(dtype)
    mask = diag.rank_kept_mask(t, f, n_low=low, n_high=high)
    want = np.asarray(jax_diag.rank_kept_mask(jg, f, n_low=low, n_high=high))
    np.testing.assert_array_equal(mask.numpy(), want)
    assert not mask[:, 7].any()  # NaN is never kept
    if high is None and f == 3:
        assert not mask[:, 8].any()  # the threshold sorted[n - f - 1] is NaN
    assert_exact(diag.rank_kept_fraction(t, f, n_low=low, n_high=high),
                 jax_diag.rank_kept_fraction(jg, f, n_low=low, n_high=high))


def test_make_aux_and_selection_from_indices_match_jax():
    n = 7
    idx = np.array([5, 0, 3])
    sel = diag.selection_from_indices(n, torch.from_numpy(idx))
    assert_exact(sel, jax_diag.selection_from_indices(n, jnp.asarray(idx)))
    dist = torch.from_numpy(_dist(0)[:n, :n].copy())
    aux = diag.make_aux(n, dist=dist, scores=torch.arange(n, dtype=torch.int32))
    jaux = jax_diag.make_aux(n, dist=jnp.asarray(dist.numpy()),
                             scores=jnp.arange(n, dtype=jnp.int32))
    assert set(aux) == set(jaux)
    for key in aux:
        assert aux[key].dtype == torch.float32
        assert_exact(aux[key], jaux[key])


# --------------------------------------------------------------------------- #
# The plain path never reaches ops/diag.py

def test_plain_calls_run_no_diag_code(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain path called ops/diag.py")

    for name in diag.__all__:
        if callable(getattr(diag, name)):
            monkeypatch.setattr(diag, name, refuse)
    g = torch.from_numpy(stack(11, 64, seed=5))
    for rule in RULES:
        gar = ops.gars[rule]
        assert gar(g, f=2).shape == (64,)
        assert gar.unchecked(g, f=2).shape == (64,)
        with pytest.raises(AssertionError, match="ops/diag.py"):
            gar.diagnosed(g, f=2)
