"""The keyed selection network of `csrc/batcher.cuh` and the window walk of
`csrc/gar_kernels.cu::median_closest_mean`, modelled in torch on the CPU.

The CUDA kernels of `lower_median`, `trimmed_mean`, `closest_mean`,
`selected_median_mean` and `colsort` run on a card only
(`tests/test_torch_gpu.py`); what they compute is held here:

* (a) `sort_kernels.selection_pairs(n, rank)`, the Batcher schedule
  pruned to one output rank, applied to order keys column by column
  (`select_keys`), gives the value of that rank of `sort_nan_last`, for
  every n in 1..64 and every rank, on values with NaN, +-inf, ties and
  +-0 (compared as equal: keys order -0 below +0); so does the schedule
  pruned to a window of ranks, for every window [f, n - f) and others;
  the operation counts of the kernels' schedules are pinned;
* (a') models of the `lower_median` and `trimmed_mean` kernels (keys,
  the f32 ones or the 16-bit ones of the half forms at two columns a
  thread, the pruned network, the decode, the rank-order sum rounded to
  the dtype, the divide) equal the JAX package's `pallas_sort.lower_median`
  and `pallas_sort.trimmed_mean` in interpret mode, in f32, bf16 and
  f16: NaN positions exactly, values with +-0 equal, bit for bit in f32
  and for the median; the half trimmed means within the 2 ulps of XLA's
  fused f16 chains (`tests/test_torch_dtype.py`), and bit for bit
  against `sort_kernels.trimmed_mean_plain`;
* (a'') a model of the `colsort` kernel (keys, the whole network: every
  comparator of Batcher's two-sided, every rank decoded) equals the JAX
  package's `pallas_sort.colsort` in interpret mode and
  `sort_kernels.colsort_plain`, in f32, bf16 and f16, on values with
  NaNs of both signs: NaN positions exactly, values with +-0 equal; every
  -0 of a column comes before its +0, every other value comes back bit
  for bit, and the half forms' pair keys give the one-column form's bits;
* (b) the key maps (`value_keys`, `deviation_keys`, and `half_keys` in
  bf16 and f16, with negative NaNs and subnormals) order like
  `sort_nan_last` in f32, bf16 and f16;
* (c) a model of the window walk gives the threshold of the full
  deviation sort wherever the median is finite, and flags every column
  whose median is +-inf (the kernel's keyed-network branch);
* (d) a model of the whole stage 2 (keyed sort, walk or branch,
  index-order count and sum) equals `pallas_sort.closest_mean_values` of
  the JAX package over `pallas_sort.sort_values`' median: NaN positions
  and counts exactly, values within rtol 1e-6 (the same f32 operations
  in the same order).

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.ops import pallas_sort
from byzantinemomentum_tpu_torch.ops import gar_kernels, sort_kernels

D = 512
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
NONE_KEY = 0xFFFFFFFF + 1  # past every key: the end of a run


def _values(n, d, seed):
    """f32[n, d] on a coarse grid (ties across rows), with NaN, +-inf,
    +-0 and +-3e38 (whose sums overflow); columns 0..19 hold more than
    half +inf, 20..39 more than half -inf. No denormals: XLA on the CPU
    flushes them to zero, torch does not."""
    rng = np.random.default_rng(seed)
    g = np.round(rng.standard_normal((n, d)) * 2.0).astype(np.float32) / 2.0
    for value, share in ((np.nan, 0.08), (np.inf, 0.06), (-np.inf, 0.06),
                         (-0.0, 0.06), (0.0, 0.06), (3e38, 0.03),
                         (-3e38, 0.03)):
        g[rng.random((n, d)) < share] = value
    half = n // 2 + 1
    g[:half, 0:20] = np.inf
    g[:half, 20:40] = -np.inf
    return torch.from_numpy(g)


def _same(got, want):
    """Equal values (+-0 equal), NaN at the same places."""
    got, want = got.float(), want.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


# --------------------------------------------------------------------------- #
# (a) the pruned schedule

@pytest.mark.parametrize("n", range(1, 65))
def test_selection_pairs_select_every_rank(n):
    g = _values(n, 64, seed=n)
    keys = list(sort_kernels.value_keys(g))
    want = sort_kernels.sort_nan_last(g)
    full = sort_kernels.select_keys(keys)
    for rank in range(n):
        got = sort_kernels.select_keys(keys, rank)[rank]
        _same(sort_kernels.key_values(got), want[rank])
        assert torch.equal(got, full[rank])
    # The pruned schedule is a subsequence of Batcher's, in its order
    pairs = sort_kernels.batcher_pairs(n)
    assert [(i, j) for i, j, _ in sort_kernels.selection_pairs(n)] == list(pairs)
    for rank in range(n):
        kept = [(i, j) for i, j, _ in sort_kernels.selection_pairs(n, rank)]
        it = iter(pairs)
        assert all(pair in it for pair in kept)


@pytest.mark.parametrize("n,rank,operations", ((25, 13, 204), (25, None, 280),
                                               (13, 6, 66), (13, None, 96),
                                               (64, 56, 715), (64, None, 1086),
                                               (1, 0, 0), (25, 12, 202),
                                               (25, range(11, 14), 212),
                                               (25, range(5, 20), 258),
                                               (25, range(0, 25), 280)))
def test_selection_operations(n, rank, operations):
    """Min/max instructions: two a two-sided comparator, one a one-sided
    one (rank 13 of 25 keeps 90 two-sided and 24 one-sided). At n = 25,
    `lower_median` reads rank 12, `trimmed_mean` the window [11, 14) at
    f = 11 and [5, 20) at f = 5; [0, n) is the full sort."""
    assert sort_kernels.selection_operations(n, rank) == operations
    if (n, rank) == (25, 13):
        sides = [side for _, _, side in sort_kernels.selection_pairs(n, rank)]
        assert sides.count("both") == 90
        assert sides.count("min") + sides.count("max") == 24


def test_selection_pairs_refuse_a_rank_outside_the_rows():
    for rank in (-1, 5, range(2, 2), range(-1, 3), range(3, 6), range(0, 4, 2)):
        with pytest.raises(ValueError, match="rank"):
            sort_kernels.selection_pairs(5, rank)


def _windows(n):
    """[f, n - f) for every f with 2f < n, the first and last half, the
    first and last rank and a pair of ranks."""
    wins = {range(f, n - f) for f in range((n + 1) // 2)}
    wins |= {range(0, (n + 1) // 2), range(n // 2, n), range(0, 1),
             range(n - 1, n), range(n // 3, min(n // 3 + 2, n))}
    return sorted(wins, key=lambda w: (w.start, w.stop))


@pytest.mark.parametrize("n", range(1, 65))
def test_selection_pairs_select_every_window(n):
    g = _values(n, 64, seed=300 + n)
    keys = list(sort_kernels.value_keys(g))
    want = sort_kernels.sort_nan_last(g)
    full = sort_kernels.select_keys(keys)
    pairs = sort_kernels.batcher_pairs(n)
    for window in _windows(n):
        got = sort_kernels.select_keys(keys, window)
        for rank in window:
            _same(sort_kernels.key_values(got[rank]), want[rank])
            assert torch.equal(got[rank], full[rank])
        # A subsequence of Batcher's schedule, which holds the one-rank ones
        kept = [(i, j) for i, j, _ in sort_kernels.selection_pairs(n, window)]
        it = iter(pairs)
        assert all(pair in it for pair in kept)
    assert sort_kernels.selection_pairs(n, range(n)) == sort_kernels.selection_pairs(n)


# --------------------------------------------------------------------------- #
# (a') the lower_median and trimmed_mean kernels

HALF_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float16: jnp.float16}


def _key_maps(dtype):
    """(keys, decode) of the kernels' forms in `dtype`: the f32 value keys
    (every f32 form, the half forms at one column a thread) and, for bf16
    and f16, the 16-bit keys of two columns a thread."""
    maps = [(sort_kernels.value_keys,
             lambda keys: sort_kernels.key_values(keys).to(dtype))]
    if dtype != torch.float32:
        maps.append((sort_kernels.half_keys,
                     lambda keys: sort_kernels.half_key_values(keys, dtype)))
    return maps


def _lower_median_model(x, keys, decode):
    """The kernel a column: keys, the network pruned to rank (n - 1) // 2,
    the decode."""
    mid = (x.shape[0] - 1) // 2
    return decode(sort_kernels.select_keys(list(keys(x)), mid)[mid])


def _trimmed_sum_model(x, f, keys, decode):
    """The kernel's sum a column: keys, the network pruned to the ranks
    [f, n - f), their decode summed in rank order from -0 (each add
    rounded to the dtype). The kernel then divides it by n - 2f."""
    n = x.shape[0]
    srt = sort_kernels.select_keys(list(keys(x)), range(f, n - f))
    acc = torch.full_like(x[0], -0.0)
    for rank in range(f, n - f):
        acc = acc + decode(srt[rank])
    return acc


def _jax(x, fn, *args):
    """`fn` of the JAX package on the values of the torch tensor `x`, as a
    torch tensor of x's dtype."""
    xj = jnp.asarray(x.float().numpy()).astype(JAX_DTYPES[x.dtype])
    out = fn(xj, *args, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(x.dtype)


def _within_ulps(got, want):
    """Within 2 ulps of a half dtype; NaN and +-inf positions exact."""
    rtol = HALF_TOL[got.dtype]
    got, want = got.float(), want.float()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want))
    finite = torch.isfinite(want)
    torch.testing.assert_close(got[finite], want[finite], rtol=rtol, atol=0)


KERNEL_NS = (1, 2, 9, 25, 64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", KERNEL_NS)
def test_lower_median_model_matches_pallas(n, dtype):
    x = _values(n, D, seed=400 + n).to(dtype)
    want = _jax(x, pallas_sort.lower_median)
    for keys, decode in _key_maps(dtype):
        got = _lower_median_model(x, keys, decode)
        _same(got, want)
        _same(got, sort_kernels.lower_median_plain(x))


def _trims(n):
    """The trims tested at n rows (each is one run of the JAX kernel in
    interpret mode, seconds at n = 64)."""
    if n == 25:
        return (0, 5, 11, 12)
    return sorted({0, (n - 1) // 4, (n - 1) // 2} if n < 64 else {(n - 1) // 2})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", KERNEL_NS)
def test_trimmed_mean_model_matches_pallas(n, dtype):
    """In f32, XLA on the CPU divides by the constant n - 2f as a product
    with its f32 reciprocal, which may round the quotient one ulp away
    from the division that the kernel and the plain version make: the
    model's sum times that reciprocal is JAX's bit for bit."""
    x = _values(n, D, seed=500 + n).to(dtype)
    for f in _trims(n):
        want = _jax(x, pallas_sort.trimmed_mean, f)
        count = torch.tensor(n - 2 * f, dtype=dtype)
        for keys, decode in _key_maps(dtype):
            total = _trimmed_sum_model(x, f, keys, decode)
            got = total / count
            if dtype == torch.float32:
                _same(total * (torch.tensor(1.0) / count), want)
            else:
                _within_ulps(got, want)
            _same(got, sort_kernels.trimmed_mean_plain(x, f))


# --------------------------------------------------------------------------- #
# (a'') the colsort kernel

@pytest.mark.parametrize("n", range(1, 65))
def test_full_sort_is_batcher_two_sided(n):
    """`selection_pairs(n)` (every rank) keeps Batcher's every comparator,
    two-sided: colsort's network."""
    pairs = sort_kernels.batcher_pairs(n)
    assert sort_kernels.selection_pairs(n) == tuple((i, j, "both") for i, j in pairs)
    assert sort_kernels.selection_operations(n) == 2 * len(pairs)


def _colsort_model(x, keys, decode):
    """The kernel a column: keys, the whole network, every rank decoded."""
    return torch.stack([decode(k) for k in sort_kernels.select_keys(list(keys(x)))])


def _signed_nans(x, seed):
    """x with a NaN whose sign bit is set (a payload too) at about 4% of
    its entries: f32 0xffc00001, bf16 and f16 0xffc1."""
    rng = np.random.default_rng(seed)
    at = torch.from_numpy(rng.random(tuple(x.shape)) < 0.04)
    if x.dtype == torch.float32:
        x.view(torch.int32)[at] = -0x3FFFFF
    else:
        x.view(torch.int16)[at] = -63
    return x


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16).to(torch.int64)


def _value_bits(t):
    """Each column's bit patterns, sorted, with every NaN as one pattern
    above all."""
    return torch.sort(torch.where(torch.isnan(t), 1 << 40, _bits(t)), dim=0).values


def _signed_zeros_in_order(t):
    """Assert that every -0 of a column comes before its +0; returns the
    number of columns that hold both."""
    rank = torch.arange(t.shape[0])[:, None]
    zero = t.float() == 0
    neg, pos = zero & torch.signbit(t.float()), zero & ~torch.signbit(t.float())
    last_neg = torch.where(neg, rank, -1).max(dim=0).values
    first_pos = torch.where(pos, rank, t.shape[0]).min(dim=0).values
    assert bool((last_neg < first_pos).all())
    return int((neg.any(dim=0) & pos.any(dim=0)).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", KERNEL_NS + (32, 33))
def test_colsort_model_matches_pallas(n, dtype):
    x = _signed_nans(_values(n, D, seed=600 + n).to(dtype), seed=600 + n)
    assert bool((torch.isnan(x) & torch.signbit(x.float())).any())
    want = _jax(x, pallas_sort.colsort)
    forms = []
    for keys, decode in _key_maps(dtype):
        got = _colsort_model(x, keys, decode)
        assert got.dtype == dtype
        _same(got, want)
        _same(got, sort_kernels.colsort_plain(x))
        assert torch.equal(_value_bits(got), _value_bits(x))
        both = _signed_zeros_in_order(got)
        assert both > 0 or n < 9
        forms.append(got)
    if len(forms) == 2:  # the pair keys give the one-column form's bits
        one, pair = forms
        nan = torch.isnan(one)
        assert torch.equal(nan, torch.isnan(pair))
        assert torch.equal(_bits(one)[~nan], _bits(pair)[~nan])


# --------------------------------------------------------------------------- #
# (b) the key maps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ("values", "deviations"))
def test_keys_order_like_sort_nan_last(dtype, kind):
    x = _values(25, D, seed=7).to(dtype)
    if kind == "values":
        keys = sort_kernels.value_keys(x)
    else:  # |x - c| in the storage type: +0 or more, or NaN
        c = sort_kernels.lower_median_plain(x)
        x = torch.abs(x - c[None, :])
        keys = sort_kernels.deviation_keys(x)
        assert not bool(torch.signbit(x[~torch.isnan(x)]).any())
    assert bool((keys >= 0).all()) and bool((keys <= 0xFFFFFFFF).all())
    order = torch.sort(keys, dim=0, stable=True).values
    want = sort_kernels.sort_nan_last(x)
    got = (sort_kernels.key_values(order) if kind == "values"
           else order.to(torch.int32).view(torch.float32))
    _same(got, want.float())
    # Every non-NaN value comes back bit for bit; each NaN is one key above +inf's
    finite = ~torch.isnan(x)
    if kind == "values":
        back = sort_kernels.key_values(keys)
        assert torch.equal(back[finite].view(torch.int32),
                           x.float()[finite].view(torch.int32))
        assert bool((keys[~finite] == sort_kernels.NAN_KEY).all())
    assert bool((keys[~finite] > sort_kernels.INF_KEY).all())
    assert bool((keys[finite] <= sort_kernels.INF_KEY + (kind == "values") * 2**31).all())


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_half_keys_order_like_sort_nan_last(dtype):
    """The 16-bit keys of the half forms at two columns a thread, on
    values with negative NaNs with payloads and subnormals besides."""
    x = _values(25, D, seed=9).to(dtype)
    rng = np.random.default_rng(9)
    bits = x.view(torch.int16)
    bits[torch.from_numpy(rng.random(tuple(x.shape)) < 0.05)] = -63  # 0xffc1
    sub = torch.from_numpy(rng.random(tuple(x.shape)) < 0.05)
    bits[sub] = torch.from_numpy(
        rng.integers(1, 0x3FF, size=int(sub.sum())) - 32768 * rng.integers(0, 2, size=int(sub.sum()))
    ).to(torch.int16)
    keys = sort_kernels.half_keys(x)
    assert bool((keys >= 0).all()) and bool((keys <= 0xFFFF).all())
    order = torch.sort(keys, dim=0, stable=True).values
    _same(sort_kernels.half_key_values(order, dtype), sort_kernels.sort_nan_last(x))
    finite = ~torch.isnan(x)
    back = sort_kernels.half_key_values(keys, dtype)
    assert torch.equal(back[finite].view(torch.int16), x[finite].view(torch.int16))
    assert bool(torch.isnan(back[~finite]).all())
    assert bool((keys[~finite] > keys[torch.isposinf(x)].max()).all())


def test_value_keys_order_signed_zero_below_positive_zero():
    keys = sort_kernels.value_keys(torch.tensor([-torch.inf, -1.0, -0.0, 0.0, 1e-45,
                                                 torch.inf, torch.nan]))
    assert keys.tolist() == sorted(keys.tolist())
    assert len(set(keys.tolist())) == 7


# --------------------------------------------------------------------------- #
# (c) the window walk, (d) the whole stage 2

def _walk_threshold(stack, m2):
    """The kernel's walk over the sorted stack: `(threshold key, +-inf
    median flag)` a column. The sorted values' deviations from the
    median, then m2 - 1 steps, each taking the smaller of the next
    deviation on the left and on the right of the median."""
    r = stack.shape[0]
    mid = (r - 1) // 2
    srt = torch.stack(sort_kernels.select_keys(list(sort_kernels.value_keys(stack))))
    med = sort_kernels.key_values(srt[mid])
    devs = sort_kernels.deviation_keys(
        torch.abs(sort_kernels.key_values(srt) - med[None, :]))
    none = torch.full_like(devs[:1], NONE_KEY)
    padded = torch.cat([none, devs, none])  # run ends read NONE_KEY
    left = torch.full_like(med, mid, dtype=torch.int64)      # padded index of srt[mid - 1]
    right = torch.full_like(med, mid + 2, dtype=torch.int64)  # of srt[mid + 1]
    thresh = torch.zeros_like(left)  # the median's own deviation
    for _ in range(m2 - 1):
        a = padded.gather(0, left[None])[0]
        b = padded.gather(0, right[None])[0]
        take_left = a <= b
        thresh = torch.where(take_left, a, b)
        left = torch.where(take_left, left - 1, left)
        right = torch.where(take_left, right, right + 1)
    return thresh, med, torch.isinf(med)


def _stage2_model(stack, m2):
    """The kernel's stage 2 (`median_closest_mean`) a column: the keyed
    sort, the walk (or, for a +-inf median, the keyed deviation network
    read at rank m2 - 1), the index-order count and sum."""
    thresh, med, inf = _walk_threshold(stack, m2)
    if m2 == 1:
        return med
    dev = sort_kernels.deviation_keys(torch.abs(stack - med[None, :]))
    branch = sort_kernels.select_keys(list(dev), m2 - 1)[m2 - 1]
    thresh = torch.where(inf, branch, thresh)
    need = m2 - (dev < thresh).sum(dim=0)
    total = torch.zeros_like(med)
    cum = torch.zeros_like(need)
    for r in range(stack.shape[0]):
        eq = dev[r] == thresh
        cum = cum + eq
        take = (dev[r] < thresh) | (eq & (cum <= need))
        total = torch.where(take, total + stack[r], total)
    out = total / m2
    return torch.where(torch.isnan(med) | (thresh > sort_kernels.INF_KEY),
                       torch.nan, out)


ROUNDS = (1, 2, 3, 4, 5, 8, 13, 25, 48, 62)


@pytest.mark.parametrize("rounds", ROUNDS)
def test_window_walk_threshold_is_the_deviation_sort_s(rounds):
    stack = _values(rounds, D, seed=100 + rounds)
    med = sort_kernels.lower_median_plain(stack)
    for m2 in range(1, rounds + 1):
        thresh, walk_med, inf = _walk_threshold(stack, m2)
        _same(walk_med, med)
        assert torch.equal(inf, torch.isinf(med))
        want = sort_kernels.deviation_keys(
            sort_kernels.sort_nan_last(torch.abs(stack - med[None, :]))[m2 - 1])
        # NaN keys differ in their payload bits: each is above +inf's
        finite = torch.isfinite(med)
        nan = thresh > sort_kernels.INF_KEY
        assert torch.equal(nan[finite], (want > sort_kernels.INF_KEY)[finite])
        assert torch.equal(thresh[finite & ~nan], want[finite & ~nan])
    if rounds >= 3:  # the input holds +inf and -inf medians, all flagged
        assert bool(inf[0:20].all()) and bool(inf[20:40].all())


@pytest.mark.parametrize("rounds", ROUNDS)
def test_stage2_model_matches_jax_closest_mean_values(rounds):
    stack = _values(rounds, D, seed=200 + rounds)
    rows = [jnp.asarray(row) for row in stack.numpy()]
    med = pallas_sort.sort_values(rows)[(rounds - 1) // 2]
    for m2 in sorted({m for m in (1, 2, 3, (rounds + 1) // 2, rounds - 1, rounds)
                      if 1 <= m <= rounds}):
        want = np.asarray(med if m2 == 1 else
                          pallas_sort.closest_mean_values(rows, med, m2))
        got = _stage2_model(stack, m2).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert int(np.isnan(got).sum()) == int(np.isnan(want).sum())
        for test in (np.isposinf, np.isneginf):
            np.testing.assert_array_equal(test(got), test(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=0)
        # and the port's plain stage 2 over the same stack
        plain = (sort_kernels.lower_median_plain(stack) if m2 == 1 else
                 sort_kernels.closest_mean_plain(
                     stack, sort_kernels.lower_median_plain(stack), m2))
        _same(torch.from_numpy(got), plain)


# --------------------------------------------------------------------------- #
# The load widths the wrappers choose

@pytest.mark.parametrize("n,d,size,addresses,width", (
        (25, 1_310_922, 4, (0, 0), 2), (25, 1_310_922, 4, (4, 0), 1),
        (25, 1_310_922, 4, (8, 8), 2), (25, 1_310_921, 4, (0, 0), 1),
        (25, 20_014, 2, (0, 2), 1), (25, 20_014, 2, (4, 4), 2),
        (32, 10, 2, (0, 0), 2), (33, 10, 2, (0, 0), 1), (64, 10, 4, (0, 0), 1),
        (1, 2, 4, (0, 0), 2)))
def test_closest_mean_width(n, d, size, addresses, width):
    """closest_mean's operands g and c (the helper it shares with
    lower_median and trimmed_mean)."""
    assert sort_kernels.column_width(n, d, size, *addresses) == width


@pytest.mark.parametrize("size", (2, 4))
def test_column_width_every_case(size):
    """One operand (lower_median, trimmed_mean): two columns a thread
    exactly where n <= 32, d is even and the address is aligned to two
    elements; for every n in 1..64, d mod 2 and an address 0..3 elements
    past an aligned one."""
    for n in range(1, 65):
        for d in (1_310_922, 1_310_921, 2, 1):
            for offset in range(4):
                address = 4096 + offset * size
                want = 2 if n <= 32 and d % 2 == 0 and offset % 2 == 0 else 1
                assert sort_kernels.column_width(n, d, size, address) == want


@pytest.mark.parametrize("rounds,d,address,width", (
        (13, 1_310_922, 0, 2), (13, 1_310_922, 8, 2), (13, 1_310_922, 4, 1),
        (13, 1_310_921, 0, 1), (13, 1_310_924, 0, 2), (32, 100, 0, 2),
        (33, 100, 0, 1), (62, 100, 0, 1), (1, 2, 0, 2)))
def test_median_mean_width(rounds, d, address, width):
    assert gar_kernels.median_mean_width(rounds, d, address) == width


@pytest.mark.parametrize("kernel,kwargs", (
        ("lower_median", {"f": 3}), ("colsort", {"f": 0}),
        ("closest_mean", {"m": 3, "f": 1}), ("trimmed_mean", {}),
        ("trimmed_mean", {"m": 3, "f": 1}), ("trimmed_mean", {"f": 13}),
        ("trimmed_mean", {"f": -1}), ("lower_median", {"m": 3})))
def test_build_takes_m_and_f_only_for_their_kernels(kernel, kwargs):
    """A library is built for m (closest_mean) or f (trimmed_mean) and no
    other; checked before nvcc is looked for, so this runs on any host."""
    with pytest.raises(ValueError, match="f = |m = "):
        sort_kernels.build(kernel, 25, torch.float32, **kwargs)
