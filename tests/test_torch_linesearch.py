"""The port's line search (`byzantinemomentum_tpu_torch/ops/linesearch.py`)
against the JAX package's `line_maximize` and the reference oracle
(`tests/reference_oracles.py::line_maximize`, given float32 arguments so
that its arithmetic is float32 too).

Each objective's values round the same way in all three (piecewise
constant or integer valued), so the probe sequences and the results must
be equal exactly, for every budget of 1 to 16 evaluations: plateaus and
ties (strict improvement only), a peak found by expansion and refined by
contraction, and a case that fires the negative-x guard (start 0, the
first expansion fails, the first contraction succeeds, the next
contraction step overshoots below 0 and is halved back toward the
previous probe). The port's search keeps its state on the objective's
device (`ops/search_kernels.py`): a probe is an f32 0-d tensor and the
objective returns a 0-d tensor. Searches on tensor objectives are held
against the JAX package's `line_maximize` on the same objective written
in jnp: f64 values (under `jax.enable_x64`), NaN values, and budgets of
up to 450 probes that drive the state to deltas near 2^100 and to probes
near the smallest normal, where XLA flushes subnormals to zero. The state
update's plain version (the CPU's; the kernel on the card,
`tests/test_torch_gpu.py`) is held against a numpy transcription of the
JAX loop's body on swept states, the guard down to -0 included, with
f32, f64 and NaN values, and its guard against the kernel's loop on
200,000 swept (prop_x, delta) pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.ops.linesearch import line_maximize as jax_line_maximize
from byzantinemomentum_tpu_torch.ops import search_kernels
from byzantinemomentum_tpu_torch.ops.linesearch import line_maximize

from tests.reference_oracles import line_maximize as oracle_line_maximize

F32 = np.float32
OBJECTIVES = {
    # Integer-valued peak at 7.7: expansion to 7, then contraction
    "peak": lambda x: np.floor(-np.abs(x - F32(7.7)) * F32(4)),
    # A plateau everywhere: no probe improves (ties)
    "flat": lambda x: F32(0),
    # Increasing integer steps: expansion to the end of the budget
    "steps": lambda x: np.floor(x),
    # Better only on (0.1, 0.4): the negative-x guard fires
    "window": lambda x: F32(1) if F32(0.1) < x < F32(0.4) else F32(0),
    # A plateau then a ridge: ties before the first improvement
    "ridge": lambda x: F32(2) if x > F32(2.5) else F32(0),
}


def _probes_port(objective, evals, dtype=torch.float32):
    """The port's probes (numpy f32) and result on the CPU; the objective
    sees the probe as a numpy f32 and its value goes back as a 0-d
    tensor of `dtype`."""
    probes = []

    def scape(x):
        assert x.dtype == torch.float32 and x.dim() == 0
        probes.append(F32(x.item()))
        return torch.tensor(objective(probes[-1]), dtype=dtype)

    best = line_maximize(scape, evals=evals)
    assert best.dtype == torch.float32 and best.dim() == 0
    return F32(best.item()), probes


def _probes_oracle(objective, evals):
    probes = []
    best = oracle_line_maximize(
        lambda x: (probes.append(F32(x)), float(objective(F32(x))))[1],
        evals=evals, start=F32(0), delta=F32(1), ratio=F32(0.8))
    return F32(best), probes


def _probes_jax(objective, evals):
    probes = []

    def scape(x):
        jax.debug.callback(lambda v: probes.append(F32(v)), x, ordered=True)
        return jax.pure_callback(lambda v: F32(objective(F32(v))),
                                 jax.ShapeDtypeStruct((), jnp.float32), x)

    best = jax.jit(lambda: jax_line_maximize(scape, evals=evals))()
    jax.effects_barrier()
    return F32(best), probes


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_line_search_matches_jax_and_the_oracle(name):
    objective = OBJECTIVES[name]
    for evals in range(1, 17):
        best, probes = _probes_port(objective, evals)
        assert len(probes) == evals
        for other in (_probes_jax, _probes_oracle):
            want_best, want_probes = other(objective, evals)
            assert [x.tobytes() for x in probes] == \
                [F32(x).tobytes() for x in want_probes], (other.__name__, evals)
            assert best.tobytes() == want_best.tobytes()


def test_negative_guard_fires():
    """Probes 0, 1 (worse), 0.2 (better), then 0.2 - 0.64 < 0 is halved
    twice toward 0.2: the fourth probe is 0.04 in float32."""
    _, probes = _probes_port(OBJECTIVES["window"], 4)
    prop = F32(1) - F32(0.8)
    x = prop - F32(0.8) * F32(0.8)  # the third contraction's step
    assert x < 0
    while x < 0:
        x = (x + prop) / F32(2)
    assert probes[2] == prop and probes[3] == x > 0


def _search_port(objective, evals):
    """The port's probes and result on a tensor objective."""
    probes = []

    def scape(x):
        probes.append(F32(x.item()))
        return objective(x)

    best = line_maximize(scape, evals=evals)
    return F32(best.item()), probes


def _search_jax(objective, evals):
    """JAX's probes and result on a traceable objective, as XLA's CPU
    runs it (subnormals flushed to zero)."""
    probes = []

    def scape(x):
        jax.debug.callback(lambda v: probes.append(F32(v)), x, ordered=True)
        return objective(x)

    best = jax.jit(lambda: jax_line_maximize(scape, evals=evals))()
    jax.effects_barrier()
    return F32(best), probes


# Objectives written twice, for the port (torch) and for JAX (jnp), and
# whether their values are f64
TENSOR_OBJECTIVES = {
    # Better only in f64: 1 + 1e-12 x rounds to 1 in f32
    "f64-rising": (lambda x: 1.0 + 1e-12 * x.to(torch.float64),
                   lambda x: 1.0 + 1e-12 * x.astype(jnp.float64), True),
    # A peak at 7.7 valued in f64
    "f64-peak": (lambda x: -(d := x.to(torch.float64) - 7.7) * d,
                 lambda x: -(d := x.astype(jnp.float64) - 7.7) * d, True),
    # NaN at every probe but the start: no probe improves
    "nan": (lambda x: torch.where(x > 0, torch.nan, 0.0),
            lambda x: jnp.where(x > 0, jnp.nan, 0.0), False),
    # Increasing, then NaN above 5: the expansion stops at a NaN
    "nan-above-5": (lambda x: torch.where(x > 5, torch.nan, torch.floor(x)),
                    lambda x: jnp.where(x > 5, jnp.nan, jnp.floor(x)), False),
    # Increasing up to a cliff at 1e30: the step doubles to about 2^100,
    # then contracts from there, the guard halving from large negatives
    "cliff": (lambda x: torch.where(x < 1e30, x, 0.0),
              lambda x: jnp.where(x < 1e30, x, 0.0), False),
    # Best at 0: the contraction's probes shrink toward 0 through the
    # guard, past the smallest normal, where they flush to -0
    "falling": (lambda x: -x, lambda x: -x, False),
}


@pytest.mark.parametrize("evals", (3, 16, 140, 450))
@pytest.mark.parametrize("name", sorted(TENSOR_OBJECTIVES))
def test_tensor_objective_matches_jax(name, evals):
    """The probes and the result, bit for bit (signed zeros included)."""
    port, jnp_objective, x64 = TENSOR_OBJECTIVES[name]
    with jax.enable_x64(x64):
        want_best, want_probes = _search_jax(jnp_objective, evals)
    best, probes = _search_port(port, evals)
    assert len(probes) == evals
    assert [x.tobytes() for x in probes] == [x.tobytes() for x in want_probes]
    assert best.tobytes() == want_best.tobytes()


def test_tensor_objectives_reach_the_far_states():
    """The sweep above does drive the state where it is meant to: deltas
    beyond 1e29 (`cliff`), positive probes below 2^-120 and probes of -0
    (`falling`, the guard flushing)."""
    _, cliff = _search_port(TENSOR_OBJECTIVES["cliff"][0], 450)
    _, falling = _search_port(TENSOR_OBJECTIVES["falling"][0], 450)
    falling = np.array(falling)
    assert max(cliff) > 1e29
    assert ((falling > 0) & (falling < 2.0**-120)).any()
    assert ((falling == 0) & np.signbit(falling)).sum() > 100


def test_line_search_reads_the_objective_at_its_precision():
    """Values that differ below float32's resolution still compare as the
    float64 objective has them (a float64 run's objective)."""
    best = line_maximize(
        lambda x: 1.0 + 1e-12 * x.to(torch.float64), evals=3)
    assert best.item() == F32(3)


def test_nan_objective_never_improves():
    best = line_maximize(
        lambda x: torch.where(x > 0, torch.nan, 0.0), evals=8)
    assert best.item() == F32(0)


# ---------------------------------------------------------------------------
# The state update (`search_kernels.linesearch_step`) against the JAX body

def _flush(v):
    """XLA's CPU on a subnormal operand or result: a zero of its sign."""
    v = np.asarray(v)
    with np.errstate(invalid="ignore"):  # inf * 0, in the branch not taken
        return np.where(np.abs(v) < np.finfo(v.dtype).tiny, v * 0, v)[()]


def _mul(a, c):
    """f32 `a * c`, flushed where the exact product is below the smallest
    normal (x86 detects tininess before rounding)."""
    exact = np.float64(_flush(F32(a))) * np.float64(F32(c))
    tiny = np.finfo(np.float32).tiny
    with np.errstate(over="ignore"):
        return F32(exact * 0) if abs(exact) < tiny else F32(exact)


def _half(a):
    """f32 `a / 2`, flushed where the exact half is below the smallest
    normal."""
    a = _flush(a)
    with np.errstate(invalid="ignore"):  # inf * 0, in the branch not taken
        return np.where(np.abs(a) < 2 * np.finfo(np.float32).tiny, a * F32(0),
                        a / F32(2))[()]


def _jax_body(best_x, best_y, prop_x, delta, phase, y):
    """One step of the JAX `lax.while_loop` after the objective's value
    `y` at `prop_x`, then the next probe, in numpy f32 (the y's in their
    own dtype), each operation and comparison flushing subnormals as XLA
    does (a product and a halving on their exact results) and each
    selection moving its value as it is:
    `byzantinemomentum_tpu/ops/linesearch.py:50-90`."""
    F = _flush
    better = F(y) > F(best_y)
    if better:
        best_x, best_y = prop_x, y
    with np.errstate(over="ignore"):  # the largest delta doubles to inf
        if phase == 0 and better:
            delta = _mul(delta, 2)
        else:
            phase, delta = 1, _mul(delta, 0.8)
        if phase == 0:
            nxt = F(F(best_x) + delta)
        elif F(prop_x) < F(best_x):
            nxt = F(F(prop_x) + delta)
        else:
            nxt = F(F(prop_x) - delta)
            while nxt < 0:
                nxt = _half(F(nxt + F(prop_x)))
    return best_x, best_y, nxt, delta, phase


def _states():
    """Search states through expansion, contraction and the guard: prop_x
    above and below best_x, prop_x = 0 with deltas up to the largest f32
    (the guard runs to -0), subnormal steps, and 48 random states within
    8 times the smallest normal (the flushes); better, worse, equal, NaN
    and subnormal values."""
    big, tiny = np.finfo(np.float32).max, F32(1e-45)
    normal = np.finfo(np.float32).tiny
    xs = [(F32(0), F32(1), F32(1)), (F32(3), F32(7), F32(4)),
          (F32(7), F32(3), F32(0.8)), (F32(5.5), F32(5.5), F32(2.25)),
          (F32(1), F32(0), big), (F32(1), F32(0), F32(1)),
          (F32(2), tiny, big), (F32(0.2), F32(0.2), F32(0.64)),
          (F32(1e30), F32(1e-30), F32(3e38)), (F32(0), F32(-0.0), F32(0.5)),
          (F32(4), F32(4), tiny), (F32(0), F32(2.0**-125), F32(2.0**-123)),
          (F32(0), normal, F32(normal / F32(0.8)))]
    rng = np.random.default_rng(0)
    xs += [tuple(row) for row in np.float32(rng.uniform(0, 8, (48, 3)) * normal)]
    ys = [(0.0, 1.0), (1.0, 0.0), (2.0, 2.0), (0.0, float("nan")),
          (float("nan"), 1.0), (1.0, 1.0 + 2**-40), (0.0, 1e-40),
          (0.0, 1e-310)]
    for best_x, prop_x, delta in xs:
        for best_y, y in ys:
            for phase in (0, 1):
                yield best_x, prop_x, delta, phase, best_y, y


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_linesearch_step_plain_is_the_jax_body(dtype):
    """The plain version's next state equals the JAX body's bit for bit
    (signed zeros included), at f32 and f64 values (1 + 2^-40 is better
    than 1 only in f64)."""
    ydt, npdt = getattr(torch, dtype), getattr(np, dtype)
    for best_x, prop_x, delta, phase, best_y, y in _states():
        state = (torch.tensor([best_x, prop_x, delta]),
                 torch.tensor(best_y, dtype=ydt),
                 torch.tensor([phase, 9], dtype=torch.int32))
        xs, by, ints = search_kernels.linesearch_step(
            *state, torch.tensor(y, dtype=ydt))
        want = _jax_body(best_x, npdt(best_y), prop_x, delta, phase, npdt(y))
        got = (xs[0].numpy(), by.numpy(), xs[1].numpy(), xs[2].numpy())
        for g, w in zip(got, want[:4]):
            assert g.tobytes() == np.asarray(w, g.dtype).tobytes(), (
                best_x, prop_x, delta, phase, best_y, y, got, want)
        assert ints.tolist() == [want[4], 8]


def test_flushes_are_xla_cpus():
    """The plain version's halving, product by 0.8 and sum near the
    smallest normal give XLA's CPU bits: subnormal operands read as
    zeros, subnormal results flushed, a product or a halving on its exact
    result (2^-126 (1 - 2^-24) rounds up to 2^-126 but flushes)."""
    tiny = np.finfo(np.float32).tiny
    rng = np.random.default_rng(3)
    corners = np.float32([2.0**-125 * (1 - 2.0**-24), 2.0**-125, tiny,
                          tiny * (1 + 2.0**-23), tiny / F32(0.8), 0.0, 1e-45])
    a = np.concatenate([corners, -corners, (rng.uniform(-4, 4, 4000)
                                            * tiny).astype(F32)])
    b = np.roll(a, 1)[::-1].copy()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    flush = search_kernels.flush
    pairs = (
        (search_kernels._half(ta), jax.jit(lambda v: v / 2.0)(a)),
        (search_kernels._mul(ta, search_kernels._RATIO32),
         jax.jit(lambda v: v * jnp.float32(0.8))(a)),
        (flush(flush(ta) + flush(tb)), jax.jit(lambda u, v: u + v)(a, b)))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_guard_runs_to_negative_zero_within_its_bound():
    """At prop_x = 0 the guard halves -delta down to -0 (flushed below the
    smallest normal): 254 halvings from the largest f32, within
    `GUARD_STEPS`; the plain version's unrolled guard gives -0 as the
    loop does."""
    x, steps = -np.finfo(np.float32).max, 0
    while x < 0:
        x, steps = _half(x), steps + 1
    assert steps == 254 <= search_kernels.GUARD_STEPS
    assert x == 0 and np.signbit(x)
    xs, _, _ = search_kernels.linesearch_step(
        torch.tensor([F32(0), F32(0), np.finfo(np.float32).max]),
        torch.tensor(1.0), torch.tensor([1, 3], dtype=torch.int32),
        torch.tensor(0.0))
    nxt = xs[1].numpy()
    assert nxt == 0 and np.signbit(nxt)


def test_line_search_guard_to_negative_zero_matches_jax():
    """A search whose contraction probes reach 0 and then -0 (the guard's
    halving from prop_x = 0), the same probes in both packages."""
    def objective(x):
        return F32(1) if x == 0 and not np.signbit(x) else F32(0)

    for evals in (4, 8, 16):
        best, probes = _probes_port(objective, evals)
        want_best, want_probes = _probes_jax(objective, evals)
        assert [x.tobytes() for x in probes] == [
            F32(x).tobytes() for x in want_probes]
        assert best.tobytes() == want_best.tobytes()


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_probe_rows_with_a_tensor_x_equal_the_float_x_rows(dtype):
    """`avg + x * att` (identical) and `avg * -x` (empire-strict) with the
    probe x an f32 0-d tensor give the bits of the same x as a Python
    float: one multiply and one add (a float64 operand widens x
    exactly)."""
    rng = np.random.default_rng(7)
    avg, att = (torch.from_numpy(rng.standard_normal(50_001)).to(
        getattr(torch, dtype)) for _ in range(2))
    for value in (0.0, 1.0, 0.2, 3.5849626, 1e-30, 32767.0, -0.0, 7.7e-45):
        x = torch.tensor(F32(value))
        for got, want in ((avg + x * att, avg + float(x.item()) * att),
                          (avg + -x * att, avg + float(-x.item()) * att),
                          (avg * -x, avg * float(-x.item()))):
            assert got.dtype == avg.dtype
            assert torch.equal(got.view(torch.int64 if dtype == "float64"
                                        else torch.int32),
                               want.view(torch.int64 if dtype == "float64"
                                         else torch.int32)), value


def _guard_sweep(count=200_000, seed=0):
    """(prop_x, delta) f32 pairs, prop_x >= 0: random magnitudes over the
    whole f32 range, binade edges (a significand of 1, 1.5 or just below
    2) with deltas 2^0 to 2^60 times larger, small values, and the
    extremes (the smallest subnormal, the largest f32, 0)."""
    rng = np.random.default_rng(seed)
    n = count // 3
    p1 = 10.0 ** rng.uniform(-45, 38, n)
    d1 = 10.0 ** rng.uniform(-45, 38.5, n)
    sig = rng.choice([1.0, 1.5, 1.9999999, 1.0000001], n)
    p2 = sig * 2.0 ** rng.integers(-149, 128, n)
    d2 = p2 * 2.0 ** rng.integers(0, 61, n) * rng.choice(
        [1.0, 1.5, 1.9999999, 0.75], n)
    p3, d3 = rng.uniform(0, 100, n), rng.uniform(0, 1e6, n)
    tiny, big = 1e-45, float(np.finfo(np.float32).max)
    edges = [tiny, 2 * tiny, float(np.finfo(np.float32).tiny), 1.0, 3e38, 0.0]
    p4 = np.repeat(edges, 6)
    d4 = np.tile([big, 2.0**127, 1.0, tiny, 1e-40, 1.5], len(edges))
    with np.errstate(over="ignore"):
        prop = np.concatenate([p1, p2, p3, p4]).astype(np.float32)
        delta = np.concatenate([d1, d2, d3, d4]).astype(np.float32)
    keep = np.isfinite(prop) & np.isfinite(delta)
    return prop[keep], delta[keep]


def test_plain_guard_is_the_kernel_loop():
    """`search_kernels.guard` (exact halvings in one step, then
    `GUARD_TAIL` steps, -0 at p = 0) gives the bits of the kernel's loop
    (`x = (x + p) / 2` while x < 0, at most `GUARD_STEPS` times, with
    XLA's flushing of subnormals) on the sweep, run elementwise; the tail
    after the exact halvings is at most 27 steps there."""
    F = _flush
    prop, delta = _guard_sweep()
    x = F(F(prop) - F(delta))
    want = x.copy()
    with np.errstate(over="ignore"):  # the branch np.where drops may overflow
        for _ in range(search_kernels.GUARD_STEPS):
            want = np.where(want < 0, _half(F(want + F(prop))), want)
    got = search_kernels.guard(torch.from_numpy(prop), torch.from_numpy(delta))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # The steps left after the exact halvings, where p > 0
    ex, ep = np.frexp(x)[1], np.frexp(prop)[1]
    tail = (x * 2.0 ** -np.maximum(ex - ep - 26, 0).astype(np.float64)).astype(
        np.float32)
    steps = np.zeros(len(tail), int)
    with np.errstate(over="ignore"):
        for _ in range(search_kernels.GUARD_TAIL + 1):
            negative = (tail < 0) & (F(prop) > 0)
            steps += negative
            tail = np.where(negative, _half(F(tail + F(prop))), tail)
    assert steps.max() <= 27 < search_kernels.GUARD_TAIL
