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
previous probe).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from byzantinemomentum_tpu.ops.linesearch import line_maximize as jax_line_maximize
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


def _probes_port(objective, evals):
    probes = []
    best = line_maximize(
        lambda x: (probes.append(x), F32(objective(x)))[1], evals=evals)
    return best, probes


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
        assert all(type(x) is F32 for x in probes) and type(best) is F32
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


def test_line_search_reads_the_objective_at_its_precision():
    """Values that differ below float32's resolution still compare as the
    float64 objective has them (a float64 run's objective)."""
    base = 1.0
    best = line_maximize(lambda x: base + 1e-12 * float(x), evals=3)
    assert best == F32(3)


def test_nan_objective_never_improves():
    best = line_maximize(lambda x: float("nan") if x > 0 else 0.0, evals=8)
    assert best == F32(0)
