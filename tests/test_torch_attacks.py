"""Parity of the port's attack registry with the JAX package's.

The same numpy inputs (9 honest rows of width 50 unless stated) go
through each JAX attack and its port, against the same GAR of each
package (the JAX GARs as the JAX package runs them on the CPU). NaN
positions must match exactly; values within rtol 1e-5, atol 1e-6 (f32
sums taken in another order; XLA also fuses `avg + x * dir` into one
multiply-add, which the port rounds twice).

* The adaptive factor (`empire`, `little`, `bulyan` at `factor:-16`, with
  and without `negative`; `empire-strict` at `epsilon:-16`) against
  Average, Krum, Bulyan, Median and Trimmed mean: the searched factor must
  equal JAX's bit for bit, or else the JAX objective must take the same
  value at both factors within rtol 1e-6 (a near-tie: both packages'
  objectives round differently in the last bits), and the rows are then
  compared only where the factors agree.
* Under bf16 the searched factor is an f32 scalar in both packages: every
  probe's stack and the returned rows are f32 (rows within 2^-7
  relative); a positive factor keeps the rows in bf16.
* `anticge` in both branches (NaN rows where f_real > f_decl; the scaled
  `2 g(0) + g(1) + ...` otherwise, with an infinite row and tied norms).
* `alie`: `zmax` equals the JAX package's at several (n, f), the
  attacker-majority 0 included; the rows with the default and a given z,
  with jitter (the noise key `row_key` equals JAX's `_row_key` bit for
  bit) and at a single honest row.
* `alie-warmup` across its window (its state threaded step by step),
  `framing` and `mimic` with and without jitter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.attacks import alie as jax_alie
from byzantinemomentum_tpu.attacks import attacks as jax_attacks
from byzantinemomentum_tpu.attacks import empire as jax_empire
from byzantinemomentum_tpu.attacks import identical as jax_identical
from byzantinemomentum_tpu.ops import gars as jax_gars
from byzantinemomentum_tpu_torch.attacks import alie, attacks, empire, identical
from byzantinemomentum_tpu_torch.ops import gars

RTOL, ATOL = 1e-5, 1e-6
H, D, F = 9, 50, 2
ADAPTIVE_GARS = ("average", "krum", "bulyan", "median", "trmean")


def _mat(n, d, seed, dtype=np.float32):
    g = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return np.array(jnp.asarray(g).astype(dtype)) if dtype != np.float32 else g


def _pair(g):
    """The same rows as a JAX array and a torch tensor (bf16 through
    float32, which holds it exactly)."""
    g = np.asarray(g)
    if g.dtype == jnp.bfloat16:
        return jnp.asarray(g), torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(g), torch.from_numpy(g.copy())


def _assert_values(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


@pytest.fixture
def searched(monkeypatch):
    """The factor each package's line search returned, by package."""
    found = {}

    def recorder(module, key):
        original = module.line_maximize

        def line_maximize(*args, **kwargs):
            found[key] = original(*args, **kwargs)
            return found[key]
        monkeypatch.setattr(module, "line_maximize", line_maximize)

    for module, key in ((jax_identical, "jax"), (jax_empire, "jax"),
                        (identical, "port"), (empire, "port")):
        recorder(module, key)
    return found


def _jax_objective(gar, g, byz_of, f_real):
    """The JAX package's line-search objective at factor x."""
    avg = jnp.mean(g, axis=0)

    def objective(x):
        byz = byz_of(jnp.float32(x))
        stacked = jnp.concatenate([g, jnp.tile(byz[None, :], (f_real, 1))])
        agg = jax_gars[gar].unchecked(stacked, f=F) - avg
        return float(jnp.dot(agg, agg))
    return objective


def _check_search(searched, objective, got, want):
    """Rows equal where the factors are; a differing factor must be a
    near-tie of the JAX objective."""
    jf, pf = np.float32(searched["jax"]), searched["port"]
    # The port's factor is an f32 0-d tensor on the rows' device
    assert pf.dtype == torch.float32 and pf.dim() == 0
    pf = np.float32(pf.item())
    if jf == pf:
        _assert_values(got, want)
    else:
        a, b = objective(jf), objective(pf)
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b), 1e-30), (jf, pf, a, b)


@pytest.mark.parametrize("gar", ADAPTIVE_GARS)
@pytest.mark.parametrize("negative", (False, True))
@pytest.mark.parametrize("name", ("empire", "little", "bulyan"))
@pytest.mark.parametrize("seed", (0, 1))
def test_adaptive_identical_attacks_match_jax(searched, name, negative, gar, seed):
    jg, tg = _pair(_mat(H, D, seed))
    kwargs = {"factor": -16, "negative": negative}
    want = jax_attacks[name](jg, F, F, defense=jax_gars[gar].unchecked, **kwargs)
    got = attacks[name](tg, F, F, defense=gars[gar].unchecked, **kwargs)
    assert got.dtype == torch.float32 and got.shape == (F, D)
    direction = {"empire": lambda: -jnp.mean(jg, axis=0),
                 "little": lambda: jnp.sqrt(jnp.var(jg, axis=0, ddof=1)),
                 "bulyan": lambda: jnp.zeros(D, jnp.float32).at[-1].set(1.0)}[name]()
    avg = jnp.mean(jg, axis=0)
    sign = -1 if negative else 1
    _check_search(searched, _jax_objective(
        gar, jg, lambda x: avg + (sign * x) * direction, F),
        got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gar", ("krum", "median", "bulyan"))
@pytest.mark.parametrize("epsilon", (-16, -5, 2))
def test_empire_strict_matches_jax(searched, gar, epsilon):
    jg, tg = _pair(_mat(H, D, 3))
    want = jax_attacks["empire-strict"](jg, F, F, defense=jax_gars[gar].unchecked,
                                        epsilon=epsilon)
    got = attacks["empire-strict"](tg, F, F, defense=gars[gar].unchecked,
                                   epsilon=epsilon)
    if epsilon > 0:
        assert "port" not in searched
        _assert_values(got.numpy(), want)
        return
    avg = jnp.mean(jg, axis=0)
    _check_search(searched, _jax_objective(gar, jg, lambda x: avg * (-x), F),
                  got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gar", ("median", "krum"))
@pytest.mark.parametrize("name,kwargs", (
    ("little", {"factor": -16, "negative": True}),
    ("empire", {"factor": -16}),
    ("empire-strict", {"epsilon": -16})))
def test_bf16_probes_and_rows_are_f32(searched, name, kwargs, gar):
    """The searched factor is an f32 scalar: the probes run the f32 GAR
    and the rows come back in f32, in both packages."""
    jg, tg = _pair(_mat(H, D, 4, jnp.bfloat16))
    probe_dtypes = {"jax": [], "port": []}

    def jax_defense(gradients, f):
        probe_dtypes["jax"].append(gradients.dtype)
        return jax_gars[gar].unchecked(gradients, f=f)

    def port_defense(gradients, f):
        probe_dtypes["port"].append(gradients.dtype)
        return gars[gar].unchecked(gradients, f=f)

    want = jax_attacks[name](jg, F, F, defense=jax_defense, **kwargs)
    got = attacks[name](tg, F, F, defense=port_defense, **kwargs)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert probe_dtypes["port"] == [torch.float32] * 16
    assert set(probe_dtypes["jax"]) == {np.dtype(np.float32)}
    if np.float32(searched["jax"]) == searched["port"].item():
        _assert_values(got.numpy(), want, rtol=2.0 ** -7, atol=1e-6)
    # A positive factor is a weak scalar: the rows stay in bf16
    if name != "empire-strict":
        rows = attacks[name](tg, F, F, defense=port_defense, factor=1.5)
        assert rows.dtype == torch.bfloat16
        assert jax_attacks[name](jg, F, F, defense=jax_defense,
                                 factor=1.5).dtype == jnp.bfloat16


@pytest.mark.parametrize("f_real,f_decl", ((3, 2), (2, 2), (1, 3), (2, 5)))
@pytest.mark.parametrize("dtype", (np.float32, jnp.bfloat16))
def test_anticge_matches_jax(f_real, f_decl, dtype):
    g = _mat(H, D, 5)
    g[3] = g[1]             # a tie in the norms (stable order)
    g[6, 7] = np.inf        # a non-finite norm sorts last
    jg, tg = _pair(np.asarray(jnp.asarray(g).astype(dtype)))
    want = jax_attacks["anticge"](jg, f_decl, f_real, defense=None)
    got = attacks["anticge"](tg, f_decl, f_real, defense=None)
    assert got.shape == (f_real, D)
    if f_real > f_decl:
        assert bool(got.isnan().all()) and bool(jnp.isnan(want).all())
        return
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    rtol = RTOL if dtype == np.float32 else 2.0 ** -7
    _assert_values(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol)
    if dtype != np.float32:
        return
    # The rows sit strictly under the (h - f_decl)-th smallest finite norm
    norm = float(np.linalg.norm(np.asarray(got[0].double())))
    norms = np.sort(np.linalg.norm(np.asarray(jg, np.float64), axis=1))
    assert norm < norms[H - f_decl] * (1 + 1e-6)


@pytest.mark.parametrize("n,f", ((11, 2), (11, 4), (25, 5), (25, 11),
                                 (51, 24), (51, 12), (7, 4), (5, 3), (3, 1)))
def test_zmax_matches_jax(n, f):
    assert alie.zmax(n, f) == jax_alie.zmax(n, f)
    if n // 2 + 1 - f <= 0:
        assert alie.zmax(n, f) == 0.0


@pytest.mark.parametrize("dtype", (np.float32, jnp.bfloat16))
@pytest.mark.parametrize("shape", ((9, 50), (1, 7), (4, 1001)))
def test_row_key_matches_jax(shape, dtype):
    g = _mat(*shape, seed=6, dtype=dtype)
    g[0, 0] = -0.0
    jg, tg = _pair(g)
    want = np.asarray(jax_alie._row_key(jg)).astype(np.int64)
    assert np.array_equal(alie.row_key(tg).numpy(), want)


@pytest.mark.parametrize("h,f_real,f_decl", ((9, 2, 2), (7, 4, 4), (6, 5, 6),
                                             (1, 2, 2)))
@pytest.mark.parametrize("z,jitter", ((None, 0.0), (1.5, 0.0), (None, 0.1),
                                      (0.3, 0.5)))
def test_alie_matches_jax(h, f_real, f_decl, z, jitter):
    jg, tg = _pair(_mat(h, D, 7))
    want = jax_attacks["alie"](jg, f_decl, f_real, defense=None, z=z,
                               jitter=jitter)
    got = attacks["alie"](tg, f_decl, f_real, defense=None, z=z, jitter=jitter)
    _assert_values(got.numpy(), want)
    if jitter and h > 1:
        assert not torch.equal(got[0], got[-1])


def test_alie_warmup_matches_jax_across_its_window():
    """`window` burst steps, then the hidden ALIE rows; the state is the
    step counter in both packages, threaded through `checked`."""
    window, kwargs = 3, {"window": 3, "burst": 20.0, "z": 0.3, "jitter": 0.1}
    jatk, atk = jax_attacks["alie-warmup"], attacks["alie-warmup"]
    assert atk.stateful and jatk.stateful and not attacks["alie"].stateful
    jstate, state = None, None
    for step in range(window + 3):
        jg, tg = _pair(_mat(H, D, 10 + step))
        want, jstate = jatk.checked(jg, F, F, defense=None, state=jstate, **kwargs)
        got, state = atk.checked(tg, F, F, defense=None, state=state, **kwargs)
        assert state == int(jstate) == step + 1
        _assert_values(got.numpy(), want)
        hot = np.allclose(np.asarray(want), -20.0 * np.asarray(jnp.mean(jg, axis=0)))
        assert hot == (step < window)
    # No Byzantine row: the counter does not move
    rows, same = atk.checked(tg, F, 0, defense=None, state=state, **kwargs)
    assert rows.shape == (0, D) and same == state
    assert atk.state_init(f_real=F, d=D) == 0


@pytest.mark.parametrize("victim,push", ((0, 1.0), (4, 0.5)))
@pytest.mark.parametrize("jitter", (0.0, 0.1))
def test_framing_matches_jax(victim, push, jitter):
    jg, tg = _pair(_mat(H, D, 8))
    kwargs = {"victim": victim, "push": push, "jitter": jitter}
    want = jax_attacks["framing"](jg, F, 3, defense=None, **kwargs)
    got = attacks["framing"](tg, F, 3, defense=None, **kwargs)
    _assert_values(got.numpy(), want)


@pytest.mark.parametrize("victim", (0, 5))
@pytest.mark.parametrize("jitter", (0.0, 0.1))
def test_mimic_matches_jax(victim, jitter):
    jg, tg = _pair(_mat(H, D, 9))
    want = jax_attacks["mimic"](jg, F, 3, defense=None, victim=victim,
                                jitter=jitter)
    got = attacks["mimic"](tg, F, 3, defense=None, victim=victim, jitter=jitter)
    _assert_values(got.numpy(), want)
    if not jitter:
        assert all(torch.equal(row, tg[victim]) for row in got)


@pytest.mark.parametrize("name", sorted(attacks))
def test_every_attack_without_byzantine_rows(name):
    tg = torch.from_numpy(_mat(H, D, 11))
    out = attacks[name](tg, F, 0, defense=gars["median"].unchecked)
    rows = out[0] if attacks[name].stateful else out
    assert rows.shape == (0, D)


def test_registry_holds_every_jax_attack():
    assert set(attacks) == set(jax_attacks) - {"template"}
    for name, atk in attacks.items():
        assert atk.stateful == jax_attacks[name].stateful, name
