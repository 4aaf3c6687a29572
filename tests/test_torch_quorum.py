"""The port's dynamic quorum (`faults/quorum.py`) and the masked forms of
every rule (`ops/_common.py`, `ops/krum.py`, `ops/bulyan.py`,
`ops/brute.py`, `ops/aksel.py`, `ops/cge.py`, `ops/trmean.py`) against
the JAX package's, on the CPU, op by op (the JAX functions as the JAX
tests call them: their jnp forms, where the Pallas kernels do not run).

Stacks (numpy, from a seed) at n = 9, 11 and 25 hold half-integer ties,
a dropped row full of NaN, a NaN row and a row with +-inf entries (left
active: the masked forms are NaN-resilient, as the static ones), and a
zero column; the active masks drop two or three rows.

* `masked_aggregate` of each of the ten rules: `f_eff` exactly, the
  aggregate within rtol 1e-5, atol 1e-6 of the JAX one (the GAR tests'
  tolerance: the port's sums run in torch's order, the JAX ones in the
  einsum's and `jnp.sum`'s), NaN and +-inf at the same positions.
* The selections on the same distance matrix, exactly: Krum's and
  Bulyan's masked weights (and Bulyan's real rounds), brute's
  minimum-diameter subset.
* Against the port's static rule on the compacted active rows (the JAX
  `test_masked_aggregation_matches_static_compaction`), finite rows
  only, within the same tolerance.
* Masked Krum never selects an inactive or a NaN row; Krum's and
  Bulyan's masked weights are 0 on every inactive row, so the aggregate
  is that of the stack with the inactive rows zeroed, bit for bit.
* Brute on both sides of `MASKED_MAX_SUBSETS`: the rank space's
  boundary (C(24, 10) is feasible, C(25, 9) and C(25, 11) are not) as
  the JAX function gives it, and, with the cap lowered in both packages,
  the masked enumeration and the NaN-routing fallback against JAX's.
* The masked helpers with device counts never read them: every count
  stays a 0-d tensor (a `.item()`, `int()` or `bool()` on one raises).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu import ops as jax_ops
from byzantinemomentum_tpu.faults import quorum as jax_quorum
from byzantinemomentum_tpu.ops import brute as jax_brute
from byzantinemomentum_tpu.ops import bulyan as jax_bulyan
from byzantinemomentum_tpu.ops import krum as jax_krum
from byzantinemomentum_tpu_torch.faults import quorum
from byzantinemomentum_tpu_torch.ops import (
    _common, brute, bulyan, gars, krum)

from tests.torch_threads import one_torch_thread  # noqa: F401

RULES = ("average", "median", "trmean", "krum", "bulyan", "phocas", "meamed",
         "aksel", "cge", "brute")
# (n, f, d, dropped rows): the MNIST fault grid's n, the driver's default
# and the headline's
CASES = {"n9": (9, 2, 37, (1, 6)), "n11": (11, 2, 41, (3, 6, 9)),
         "n25": (25, 5, 29, (3, 22))}
RTOL, ATOL = 1e-5, 1e-6


def stack(n, d, dropped, seed):
    """f32[n, d] and bool[n]: normal rows, half-integer ties in the
    second half of the columns, a zero column, the dropped rows NaN,
    one more active row NaN in a few entries and one with +-inf."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[:, d // 2:] = np.round(g[:, d // 2:] * 2.0) / 2.0
    g[:, 2] = 0.0
    active = np.ones(n, bool)
    for row in dropped:
        g[row] = np.nan
        active[row] = False
    g[n - 1, rng.integers(0, d, size=3)] = np.nan
    g[0, rng.integers(0, d, size=2)] = np.inf
    g[0, rng.integers(0, d, size=2)] = -np.inf
    return g, active


def close(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rule", RULES)
def test_masked_aggregate_matches_jax(rule, case):
    n, f, d, dropped = CASES[case]
    g, active = stack(n, d, dropped, seed=len(rule) + n)
    got, f_eff = quorum.masked_aggregate(
        gars[rule], torch.from_numpy(g), torch.from_numpy(active), f_decl=f)
    want, jf_eff = jax_quorum.masked_aggregate(
        jax_ops.gars[rule], jnp.asarray(g), jnp.asarray(active), f_decl=f)
    assert f_eff.dtype == torch.int32 and f_eff.dim() == 0
    assert int(f_eff) == int(jf_eff)
    assert got.shape == (d,) and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("dynamic", (True, False))
@pytest.mark.parametrize("rule", ("krum", "bulyan", "median"))
def test_static_quorum_and_eviction_credit_match_jax(rule, dynamic):
    """`dynamic=False` keeps the declared f; `f_evicted` is credited
    before the clamp: `f_eff` as JAX's, the aggregate within tolerance."""
    n, f, d, dropped = CASES["n25"]
    g, active = stack(n, d, dropped, seed=3)
    for evicted in (None, 2):
        got, f_eff = quorum.masked_aggregate(
            gars[rule], torch.from_numpy(g), torch.from_numpy(active),
            f_decl=f, dynamic=dynamic,
            f_evicted=None if evicted is None else torch.tensor(evicted))
        want, jf_eff = jax_quorum.masked_aggregate(
            jax_ops.gars[rule], jnp.asarray(g), jnp.asarray(active),
            f_decl=f, dynamic=dynamic,
            f_evicted=None if evicted is None else jnp.int32(evicted))
        assert int(f_eff) == int(jf_eff)
        close(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_selections_match_jax(case):
    """On JAX's own distance matrix (as f32), the port's masked Krum
    weights, Bulyan weights and real rounds, and brute's subset equal
    JAX's exactly, at f_eff and at f_eff - 1."""
    n, f, d, dropped = CASES[case]
    g, active = stack(n, d, dropped, seed=n)
    jdist = jax_ops._common.pairwise_distances(jnp.asarray(g))
    dist = torch.from_numpy(np.array(jdist))
    act, jact = torch.from_numpy(active), jnp.asarray(active)
    n_eff = int(active.sum())
    for f_eff in (f, f - 1):
        counts = (torch.tensor(n_eff, dtype=torch.int32),
                  torch.tensor(f_eff, dtype=torch.int32))
        jcounts = (jnp.int32(n_eff), jnp.int32(f_eff))
        w = krum.selection_weights_masked(dist, act, *counts)
        jw = jax_krum.selection_weights_masked(jdist, jact, *jcounts)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        assert set(np.nonzero(w.numpy())[0]) <= set(np.nonzero(active)[0])
        W, rounds = bulyan.selection_weights_masked(dist, act, *counts)
        jW, jrounds = jax_bulyan.selection_weights_masked(jdist, jact,
                                                          *jcounts)
        np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(rounds.numpy(), np.asarray(jrounds))
        total = brute.masked_rank_space(n, f)
        mask = brute.best_subset_mask_masked(dist, act, *counts, total)
        jmask = jax_brute.best_subset_mask_masked(jdist, jact, *jcounts, total)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert int(mask.sum()) == n_eff - f_eff


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rule", RULES)
def test_masked_matches_static_on_compacted_rows(rule, case):
    """Finite rows: the masked form over `active` is the static rule on
    `G[active]` at the masked form's own f_eff."""
    n, f, d, dropped = CASES[case]
    rng = np.random.default_rng(n + len(rule))
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[:, d // 2:] = np.round(g[:, d // 2:] * 2.0) / 2.0
    active = np.ones(n, bool)
    active[list(dropped)] = False
    G, act = torch.from_numpy(g), torch.from_numpy(active)
    got, f_eff = quorum.masked_aggregate(gars[rule], G, act, f_decl=f)
    kwargs = {} if rule in ("average", "median") else {"f": int(f_eff)}
    want = gars[rule].unchecked(G[act], **kwargs)
    close(got, want.numpy())


def test_masked_krum_never_selects_inactive_or_nan_rows():
    """Dropped rows hold small values (they would win on merit) and an
    active row is NaN: the weights are 0 on all of them, and the
    aggregate is finite."""
    n, f, d = 11, 2, 16
    rng = np.random.default_rng(4)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[[1, 5]] = 1e-3
    g[7] = np.nan
    active = np.ones(n, bool)
    active[[1, 5]] = False
    G, act = torch.from_numpy(g), torch.from_numpy(active)
    dist = _common.pairwise_distances(G)
    n_eff = torch.tensor(int(active.sum()), dtype=torch.int32)
    w = krum.selection_weights_masked(dist, act, n_eff,
                                      torch.tensor(f, dtype=torch.int32))
    assert float(w[[1, 5, 7]].abs().sum()) == 0.0
    assert int((w > 0).sum()) == int(n_eff) - f - 2
    agg, _ = quorum.masked_aggregate(gars["krum"], G, act, f_decl=f)
    assert bool(torch.isfinite(agg).all())


@pytest.mark.parametrize("rule", ("krum", "bulyan"))
def test_inactive_payloads_never_reach_the_aggregate(rule):
    """Krum's and Bulyan's masked weights are 0 on every inactive row
    (rows holding NaN, +-inf or small values that would win on merit),
    so the aggregate equals, bit for bit, the one of the stack with the
    inactive rows zeroed (the JAX `masked_weighted_rows_mean` operand)."""
    n, f, d = 13, 2, 24
    rng = np.random.default_rng(5)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[1] = 1e-3
    g[5] = np.nan
    g[9, :3] = (np.inf, -np.inf, np.nan)
    active = np.ones(n, bool)
    active[[1, 5, 9]] = False
    G, act = torch.from_numpy(g), torch.from_numpy(active)
    n_eff = torch.tensor(int(active.sum()), dtype=torch.int32)
    f_eff = quorum.effective_f(rule, n_eff, f)
    dist = _common.pairwise_distances(G)
    mod = {"krum": krum, "bulyan": bulyan}[rule]
    w = mod.selection_weights_masked(dist, act, n_eff, f_eff)
    if rule == "bulyan":  # (W [n - 2, n], the rounds' activity)
        w = w[0]
    assert float(w[..., [1, 5, 9]].abs().sum()) == 0.0
    assert float(w.sum()) > 0.0
    agg, _ = quorum.masked_aggregate(gars[rule], G, act, f_decl=f)
    zeroed, _ = quorum.masked_aggregate(
        gars[rule], torch.where(act[:, None], G, 0.0), act, f_decl=f)
    assert bool(torch.isfinite(agg).all())
    assert torch.equal(agg, zeroed)


def test_brute_rank_space_boundary_matches_jax():
    assert brute.MASKED_MAX_SUBSETS == jax_brute.MASKED_MAX_SUBSETS
    for n, f in ((24, 10), (25, 9), (25, 11), (25, 5), (9, 4), (51, 24)):
        assert brute.masked_rank_space(n, f) == jax_brute.masked_rank_space(
            n, f)
    assert brute.masked_rank_space(24, 10) == 1_961_256
    assert brute.masked_rank_space(25, 9) is None
    assert brute.masked_rank_space(25, 11) is None


@pytest.mark.parametrize("f", (2, 4))
def test_brute_both_sides_of_the_cap_match_jax(monkeypatch, f):
    """With the cap lowered to 100 in both packages, n = 9: f = 2 (C(9, 2)
    = 36 subsets) takes the masked enumeration, f = 4 (C(9, 4) = 126) the
    NaN-routing fallback through the static rule at the declared f."""
    monkeypatch.setattr(brute, "MASKED_MAX_SUBSETS", 100)
    monkeypatch.setattr(jax_brute, "MASKED_MAX_SUBSETS", 100)
    n, d = 9, 23
    g, active = stack(n, d, (2,), seed=f)
    g[n - 1] = 0.25  # no non-finite active row: the fallback stays finite
    g[0] = 0.5
    got, f_eff = quorum.masked_aggregate(
        gars["brute"], torch.from_numpy(g), torch.from_numpy(active),
        f_decl=f)
    want, jf_eff = jax_quorum.masked_aggregate(
        jax_ops.gars["brute"], jnp.asarray(g), jnp.asarray(active), f_decl=f)
    assert int(f_eff) == int(jf_eff) == (f if f == 4 else min(f, 3))
    close(got, want)
    if f == 4:
        with pytest.raises(ValueError, match="MASKED_MAX_SUBSETS"):
            brute.aggregate_masked(
                torch.from_numpy(g), torch.from_numpy(active),
                torch.tensor(8, dtype=torch.int32),
                torch.tensor(4, dtype=torch.int32), f)


class _Unreadable(torch.Tensor):
    """A tensor whose value the host may not read."""

    def item(self):
        raise AssertionError("a device count was read on the host")

    def __int__(self):
        raise AssertionError("a device count was read on the host")

    def __bool__(self):
        raise AssertionError("a device count was read on the host")

    def __index__(self):
        raise AssertionError("a device count was read on the host")


@pytest.mark.parametrize("rule", RULES)
def test_masked_forms_never_read_a_count(monkeypatch, rule):
    """Every count stays a tensor: the active mask's sum is made a tensor
    that raises when read, and the rule still runs."""
    n, f, d, dropped = CASES["n11"]
    g, active = stack(n, d, dropped, seed=9)
    act = torch.from_numpy(active)
    real_sum = torch.Tensor.sum

    def unreadable_sum(self, *args, **kwargs):
        out = real_sum(self, *args, **kwargs)
        if self.dtype == torch.bool and out.dim() == 0:
            return out.as_subclass(_Unreadable)
        return out

    monkeypatch.setattr(torch.Tensor, "sum", unreadable_sum)
    got, _ = quorum.masked_aggregate(gars[rule], torch.from_numpy(g), act,
                                     f_decl=f)
    monkeypatch.undo()
    want, _ = quorum.masked_aggregate(gars[rule], torch.from_numpy(g), act,
                                      f_decl=f)
    close(got.as_subclass(torch.Tensor), want.numpy())
