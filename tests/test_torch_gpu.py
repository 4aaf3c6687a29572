"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device: marked `gpu`, each skips without one.
This file imports no JAX, so it also runs on a machine that has only
PyTorch: `python -m pytest --noconftest -q tests/test_torch_gpu.py`.
Tolerances are those of `tests/test_torch_ops.py`: NaN/inf positions
exact, values within rtol 1e-5, atol 1e-6 (f32 sums in another order),
Gram entries within 1e-5 of their largest diagonal entry. The half forms
of the sorting kernels: `colsort` and `lower_median` exactly (they move
values) and `trimmed_mean` exactly (it adds and divides as its plain
version does, in the same order), `closest_mean` within 2 ulps of the
dtype (rtol 2^-7 for bf16, 2^-10 for f16). `trimmed_mean` in f32 is
exact too. +-0 compare as equal: the keyed networks of `lower_median`,
`trimmed_mean`, `closest_mean`, `selected_median_mean` and `colsort`
order -0 below +0, so a median or a zero sum may come back as the other
zero, and `colsort` puts every -0 of a column before its +0. Every
launch of a kernel must add one to its wrapper's count, and to its count
for the operand's dtype. Each rule's diagnose form on the card (`ops/diag.py`,
the form `tests/test_torch_diag.py` holds to the JAX package on the CPU):
its aggregate bit for bit its plain aggregate, its launches exactly
`chip_smoke.DIAG_CALLS`, and its aux against the CPU port's: selection
and trim fraction exactly, distances and scores within rtol 1e-5 and
1e-5 of their largest finite magnitude. The masked forms of the
dynamic quorum (`faults/quorum.py`) on the card: their launches exactly
`chip_smoke.MASKED_CALLS` (Krum and Bulyan through `sq_gram` and
`weighted_rows_mean`, the masked sorts through `colsort`), `f_eff` and
the aggregate as the same forms with every kernel's plain version on
the card (`chip_smoke.plain_kernels`) within rtol 1e-5, atol 1e-6; and a
chunk with a fault plan makes no synchronizing call.
"""

import numpy as np
import pytest
import torch

from byzantinemomentum_tpu_torch.ops import (
    _common, bulyan, gar_kernels, gars, sort_kernels)
from chip_smoke import (
    DIAG_CALLS, HEADLINE_PLAN, MASKED_CALLS, diag_launches, diag_operand,
    hash_stack, launched, masked_launches, nan_attack_operand, plain_kernels)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mat(n, d, seed, nan_rows=(), dup=False, inf=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    if dup:  # equal values across rows: ties in sorts and deviations
        g = np.round(g * 2.0).astype(np.float32) / 2.0
    for r in nan_rows:
        g[r, rng.integers(0, d, size=7)] = np.nan
    if inf:
        g[0, rng.integers(0, d, size=5)] = np.inf
        g[n - 1, rng.integers(0, d, size=5)] = -np.inf
    return torch.from_numpy(g)


def _launched(wrapper, fn, dtype=torch.float32):
    """`fn()`, checking that it launched `wrapper`'s kernel once, on a
    `dtype` operand."""
    before = wrapper.launches
    before_dtype = wrapper.launches_by_dtype.get(dtype, 0)
    out = fn()
    assert wrapper.launches == before + 1
    assert wrapper.launches_by_dtype[dtype] == before_dtype + 1
    return out


def _assert_values(got, want, atol=ATOL):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    finite = torch.isfinite(want)
    torch.testing.assert_close(got[finite], want[finite], rtol=RTOL, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", ((1, 7), (2, 129), (25, 100_003), (64, 4097)))
def test_sq_gram_matches_plain(cuda, n, d):
    g = _mat(n, d, seed=n, nan_rows=(n - 1,) if n > 2 else ()).to(cuda)
    before = gar_kernels.sq_gram.launches
    got = gar_kernels.sq_gram(g)
    assert gar_kernels.sq_gram.launches == before + 1
    want = gar_kernels.sq_gram_plain(g)
    diag = torch.diagonal(want)
    _assert_values(got, want, atol=RTOL * float(diag[torch.isfinite(diag)].max()))
    # Deterministic: no atomics in the cross-block sum
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(gar_kernels.sq_gram(g)))


def _stack_columns(g, rounds, m2):
    """Columns of g (n >= rounds rows) whose stack under `W = 2 I` (round k
    takes 2 g[k], exact) has a median of +inf (0..4: 3e38 doubled
    overflows) or -inf (5..9), only NaN (10..12), fewer than m2 finite
    values (13..15), +-0 only (16), +-inf and NaN mixed (17..19)."""
    half = rounds // 2 + 1
    g[:half, 0:5] = 3e38
    g[:half, 5:10] = -3e38
    g[:, 10:13] = torch.nan
    g[:rounds - m2 + 1, 13:16] = torch.nan
    g[:, 16] = torch.where(torch.arange(g.shape[0], device=g.device) % 3 == 0,
                           -0.0, 0.0)
    g[0:rounds:3, 17:20] = 3e38
    g[1:rounds:3, 17:20] = -3e38
    g[2, 17:20] = torch.nan
    W = torch.zeros((rounds, g.shape[0]), device=g.device)
    W[torch.arange(rounds), torch.arange(rounds)] = 2.0
    return W


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,dup", ((25, 5, False), (25, 5, True), (11, 2, False),
                                     (64, 7, False), (16, 3, True), (64, 1, True)))
def test_selected_median_mean_matches_plain(cuda, n, f, dup):
    """Bulyan's W on random values with a NaN row; then `W = 2 I` over
    columns whose stack median is +-inf (the kernel's rare branch), all
    NaN, fewer than m2 finite or +-0 only, for every m2 up to the rounds.
    +-0 compare as equal; repeat calls are bitwise equal."""
    g = _mat(n, 20_011, seed=3 * n, nan_rows=(n - 1,), dup=dup).to(cuda)
    W = bulyan.selection_weights(_common.pairwise_distances(g), f)
    rounds = W.shape[0]
    W[0, n - 1] = W[0][W[0] > 0][0]  # round 0 also selects the NaN row
    for m2 in sorted({1, max(rounds - 2 * f, 1), rounds}):
        got = _launched(gar_kernels.selected_median_mean,
                        lambda: gar_kernels.selected_median_mean(W, g, m2))
        _assert_values(got, gar_kernels.selected_median_mean_plain(W, g, m2))
        assert torch.equal(_bits(got), _bits(gar_kernels.selected_median_mean(W, g, m2)))
        if m2 == rounds:
            assert bool(got.isnan().any())  # the selected NaN comes out
    for m2 in sorted({1, 2, 3, (rounds + 1) // 2, rounds - 1, rounds} - {0}):
        h = g.clone()
        W2 = _stack_columns(h, rounds, m2)
        got = gar_kernels.selected_median_mean(W2, h, m2)
        want = gar_kernels.selected_median_mean_plain(W2, h, m2)
        _assert_values(got, want)
        if rounds >= 3:
            med = sort_kernels.lower_median_plain(gar_kernels.select_rows(W2, h))
            assert bool(med[0:5].isposinf().all()) and bool(med[5:10].isneginf().all())


@pytest.mark.gpu
def test_bulyan_on_card_matches_cpu(cuda):
    g = _mat(25, 30_001, seed=9)
    _assert_values(gars["bulyan"](g.to(cuda), f=5), gars["bulyan"](g, f=5))


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = _mat(5, 100, seed=1).to(cuda)
    for bad in (g.double(), g.T, g[None], _mat(65, 10, seed=2).to(cuda)):
        with pytest.raises(ValueError):
            gar_kernels.sq_gram(bad)
    W = torch.full((1, 5), 0.2, device=cuda)
    with pytest.raises(ValueError):
        gar_kernels.selected_median_mean(W.cpu(), g, 1)
    with pytest.raises(ValueError):
        gar_kernels.selected_median_mean(W, g, 2)
    with pytest.raises(ValueError, match="rounds"):  # past MAX_ROUNDS
        gar_kernels.selected_median_mean(W.expand(gar_kernels.MAX_ROUNDS + 1, 5)
                                         .contiguous(), g, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n,rows", ((1, 0), (2, 0), (2, 2), (25, 0), (25, 13),
                                    (64, 0), (64, 64)))
def test_weighted_rows_mean_matches_plain(cuda, n, rows):
    """Krum weights (rows == 0, w f32[n]) or a (rows, n) stack of random
    selections; the first selection also takes the NaN row."""
    g = _mat(n, 20_011, seed=5 * n, nan_rows=(n - 1,), inf=True).to(cuda)
    rng = np.random.default_rng(n + rows)
    W = np.zeros((max(rows, 1), n), np.float32)
    for r in range(W.shape[0]):
        picked = np.union1d(rng.permutation(n)[:int(rng.integers(1, n + 1))],
                            [n - 1] if r == 0 else [])
        W[r, picked.astype(int)] = np.float32(1.0) / len(picked)
    w = torch.from_numpy(W[0] if rows == 0 else W).to(cuda)
    got = _launched(gar_kernels.weighted_rows_mean,
                    lambda: gar_kernels.weighted_rows_mean(w, g))
    _assert_values(got, gar_kernels.select_rows(w, g))
    assert bool((got if rows == 0 else got[0]).isnan().any())


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 2, 25, 64))
@pytest.mark.parametrize("dup", (False, True))
def test_lower_median_matches_plain(cuda, n, dup):
    g = _mat(n, 20_011, seed=7 * n, nan_rows=(n - 1,), dup=dup, inf=True).to(cuda)
    got = _launched(sort_kernels.lower_median, lambda: sort_kernels.lower_median(g))
    assert torch.equal(got.nan_to_num(), sort_kernels.lower_median_plain(g).nan_to_num())
    _assert_values(got, sort_kernels.lower_median_plain(g))


@pytest.mark.gpu
@pytest.mark.parametrize("n,f", ((1, 0), (2, 0), (25, 0), (25, 5), (25, 11),
                                 (64, 7), (64, 31)))
def test_trimmed_mean_matches_plain(cuda, n, f):
    g = _mat(n, 20_011, seed=11 * n + f, nan_rows=(n - 1,), dup=True,
             inf=True).to(cuda)
    got = _launched(sort_kernels.trimmed_mean,
                    lambda: sort_kernels.trimmed_mean(g, f))
    want = sort_kernels.trimmed_mean_plain(g, f)
    _assert_values(got, want)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def _closest_columns(g, m):
    """Columns of g whose median is +inf (9..13) or -inf (14..18), only
    NaN (19..21), fewer than m finite values (22..24) or +-0 only (25)."""
    n = g.shape[0]
    g[:n // 2 + 1, 9:14] = torch.inf
    g[:n // 2 + 1, 14:19] = -torch.inf
    g[:, 19:22] = torch.nan
    g[:n - m + 1, 22:25] = torch.nan
    g[:, 25] = torch.where(torch.arange(n, device=g.device) % 3 == 0, -0.0, 0.0)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", ((1, 1), (2, 1), (2, 2), (25, 1), (25, 14),
                                 (25, 25), (64, 57), (64, 64)))
@pytest.mark.parametrize("centre", ("median", "trmean"))
def test_closest_mean_matches_plain(cuda, n, m, centre):
    """Random values with ties, NaN and +-inf, and columns whose centre is
    NaN (0..8), +inf or -inf, all NaN, with fewer than m finite values or
    +-0 only; repeat calls are bitwise equal."""
    g = _mat(n, 20_011, seed=13 * n + m, nan_rows=(n - 1,), dup=True,
             inf=True).to(cuda)
    g = _closest_columns(g, m)
    c = (sort_kernels.lower_median_plain(g) if centre == "median"
         else sort_kernels.trimmed_mean_plain(g, (n - 1) // 4))
    c[:9] = torch.nan
    got = _launched(sort_kernels.closest_mean,
                    lambda: sort_kernels.closest_mean(g, c, m))
    _assert_values(got, sort_kernels.closest_mean_plain(g, c, m))
    assert bool(got[:9].isnan().all())
    assert torch.equal(_bits(got), _bits(sort_kernels.closest_mean(g, c, m)))
    if centre == "median" and n > 2:
        assert bool(c[9:14].isposinf().all()) and bool(c[14:19].isneginf().all())


@pytest.mark.gpu
@pytest.mark.parametrize("name,kwargs", (("krum", {}), ("krum", {"m": 3}),
                                         ("median", {}), ("trmean", {}),
                                         ("phocas", {}), ("meamed", {}),
                                         ("aksel", {"mode": "mid"}),
                                         ("aksel", {"mode": "n-f"})))
def test_gars_on_card_match_cpu(cuda, name, kwargs):
    g = _mat(25, 30_001, seed=17, nan_rows=(3,))
    g[14:] = g[:14].mean(dim=0) - 1.5 * g[:14].std(dim=0)  # 11 identical rows
    # Which of the identical rows a selection takes may differ with the
    # rounding of their distances; their mean and Byzantine share may not
    _assert_values(gars[name](g.to(cuda), f=11, **kwargs), gars[name](g, f=11, **kwargs))
    if gars[name].influence is not None:
        assert float(gars[name].influence(g[:14].to(cuda), g[14:].to(cuda), f=11, **kwargs)) \
            == float(gars[name].influence(g[:14], g[14:], f=11, **kwargs))


@pytest.mark.gpu
def test_sort_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = _mat(5, 100, seed=1).to(cuda)
    c = torch.zeros(100, device=cuda)
    for bad in (g.double(), g.T, g[None], _mat(65, 10, seed=2).to(cuda)):
        for call in (lambda: sort_kernels.lower_median(bad),
                     lambda: sort_kernels.trimmed_mean(bad, 1),
                     lambda: sort_kernels.closest_mean(bad, c, 1),
                     lambda: sort_kernels.colsort(bad),
                     lambda: gar_kernels.weighted_rows_mean(torch.ones(5, device=cuda), bad)):
            with pytest.raises(ValueError):
                call()
    # The GAR kernels take f32 only
    with pytest.raises(ValueError, match="float32"):
        gar_kernels.weighted_rows_mean(torch.ones(5, device=cuda), g.half())
    for f in (-1, 3, 1.0):
        with pytest.raises(ValueError, match="f ="):
            sort_kernels.trimmed_mean(g, f)
    for m in (0, 6):
        with pytest.raises(ValueError, match="m ="):
            sort_kernels.closest_mean(g, c, m)
    for bad_c in (c.double(), c[:50], c.cpu(), torch.zeros(200, device=cuda)[::2]):
        with pytest.raises(ValueError, match="c must"):
            sort_kernels.closest_mean(g, bad_c, 1)
    for w in (torch.ones(4, device=cuda), torch.ones(5), torch.ones(5, device=cuda).double(),
              torch.ones((65, 5), device=cuda), torch.ones((1, 1, 5), device=cuda)):
        with pytest.raises(ValueError):
            gar_kernels.weighted_rows_mean(w, g)
    # Outside the kernels' domain the callers take the plain path on the card
    wide = g.double()
    before = sort_kernels.lower_median.launches
    assert torch.equal(_common.lower_median(wide), sort_kernels.lower_median_plain(wide))
    assert sort_kernels.lower_median.launches == before


# --------------------------------------------------------------------------- #
# Kernel 4 (masked_rows_mean), kernel 5 (colsort) and the half forms of 5-8

HALF_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
SORT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _assert_exact(got, want):
    assert got.dtype == want.dtype
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def _assert_ulps(got, want):
    """Within 2 ulps of a half dtype; non-finite positions exact."""
    assert got.dtype == want.dtype
    rtol = HALF_TOL[got.dtype]
    got, want = got.float().cpu(), want.float().cpu()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want))
    finite = torch.isfinite(want)
    torch.testing.assert_close(got[finite], want[finite], rtol=rtol, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 2, 25, 64))
def test_masked_rows_mean_matches_plain(cuda, n):
    """Brute's n - f kept rows at f = (n - 1) // 2 (every row at n <= 2):
    row 0 (+inf entries) always, the last row (NaN entries) never from
    n = 3 on; a selected +inf stays +inf."""
    g = _mat(n, 20_011, seed=19 * n, nan_rows=(n - 1,), inf=True)
    rng = np.random.default_rng(n)
    keep = np.ones(n, bool)
    if n > 2:
        keep[:] = False
        keep[0] = True
        keep[1 + rng.permutation(n - 2)[:n - (n - 1) // 2 - 1]] = True
    mask = torch.from_numpy(keep).to(cuda)
    g = g.to(cuda)
    got = _launched(gar_kernels.masked_rows_mean,
                    lambda: gar_kernels.masked_rows_mean(mask, g, int(mask.sum())))
    want = gar_kernels.masked_rows_mean_plain(mask, g, int(mask.sum()))
    _assert_values(got, want)
    assert bool(got.isposinf().any())


def _signed_zeros_in_order(t):
    """Assert that every -0 of a column comes before its +0; returns the
    number of columns that hold both."""
    t = t.float().cpu()
    rank = torch.arange(t.shape[0])[:, None]
    zero = t == 0
    neg, pos = zero & torch.signbit(t), zero & ~torch.signbit(t)
    last_neg = torch.where(neg, rank, -1).max(dim=0).values
    first_pos = torch.where(pos, rank, t.shape[0]).min(dim=0).values
    assert bool((last_neg < first_pos).all())
    return int((neg.any(dim=0) & pos.any(dim=0)).sum())


def _colsort_operand(n, d, dtype, seed):
    """`_selection_columns` (all NaN, +-0 only, +-inf, overflowing sums)
    over rounded values (ties, -0 and +0 in many columns), a NaN row, +inf
    and -inf rows, and NaNs with the sign bit set (f32 0xffc00001, bf16
    and f16 0xffc1) in column 9 and every fifth row."""
    g = _selection_columns(_mat(n, d, seed=seed, nan_rows=(n - 1,), dup=True,
                                inf=True)).to(dtype)
    bits = g.view(torch.int32 if dtype == torch.float32 else torch.int16)
    bits[:, 9] = -0x3FFFFF if dtype == torch.float32 else -63
    bits[::5, 10:] = -0x3FFFFF if dtype == torch.float32 else -63
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 2, 25, 32, 33, 64))
@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_colsort_matches_plain(cuda, n, dtype):
    """Both column widths: up to 32 rows, an even d and an operand aligned
    to two elements take two columns a thread (d / 2 even and odd, the
    operand as allocated and two elements off); an odd d or an operand
    one element off, one. Values and NaN positions the plain version's
    (+-0 equal), every -0 of a column before its +0, repeat launches equal
    bit for bit, one launch a call counted in the operand's dtype."""
    for d in (20_012, 20_014, 20_011):
        g = _colsort_operand(n, d, dtype, seed=23 * n + d).to(cuda)
        # The sign read off the bits: the card's f16 -> f32 conversion
        # gives every NaN the same bits
        assert bool((torch.isnan(g).cpu() & (_bits(g) < 0)).any())
        for offset in (0, 1, 2):
            gs = _shifted(g, offset)
            assert sort_kernels.column_width(n, d, gs.element_size(), gs.data_ptr()) == (
                2 if n <= 32 and d % 2 == 0 and offset != 1 else 1)
            got = _launched(sort_kernels.colsort, lambda: sort_kernels.colsort(gs), dtype)
            _assert_exact(got, sort_kernels.colsort_plain(gs))
            both = _signed_zeros_in_order(got)
            assert both > 0 or n == 1
            assert bool(got[:, 0].isnan().all())
            assert torch.equal(_bits(got), _bits(sort_kernels.colsort(gs)))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (1, 2))
@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_colsort_checks_the_output_address(cuda, monkeypatch, dtype, offset):
    """An output one element off alignment takes one column a thread,
    though the operand would allow two (a store of two elements there
    would fault); two elements off, two."""
    n = 25
    for d in (20_012, 20_014):
        g = _colsort_operand(n, d, dtype, seed=71 + d).to(cuda)

        def shifted_output(g, rows=None):
            return torch.empty(rows * g.shape[1] + offset, dtype=g.dtype,
                               device=g.device)[offset:].view(rows, g.shape[1])
        monkeypatch.setattr(sort_kernels, "_output", shifted_output)
        got = _launched(sort_kernels.colsort, lambda: sort_kernels.colsort(g), dtype)
        torch.cuda.synchronize()
        assert sort_kernels.column_width(n, d, g.element_size(), g.data_ptr(),
                                         got.data_ptr()) == (2 if offset == 2 else 1)
        _assert_exact(got, sort_kernels.colsort_plain(g))
        _signed_zeros_in_order(got)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 2, 25, 64))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_half_sort_kernels_match_plain(cuda, n, dtype):
    g = _mat(n, 20_011, seed=29 * n, nan_rows=(n - 1,), dup=True, inf=True)
    g = (g + 0.0).to(dtype).to(cuda)
    med = _launched(sort_kernels.lower_median,
                    lambda: sort_kernels.lower_median(g), dtype)
    _assert_exact(med, sort_kernels.lower_median_plain(g))
    for f in sorted({0, (n - 1) // 4, (n - 1) // 2}):
        _assert_exact(_launched(sort_kernels.trimmed_mean,
                                lambda: sort_kernels.trimmed_mean(g, f), dtype),
                      sort_kernels.trimmed_mean_plain(g, f))
    c = sort_kernels.lower_median_plain(g)
    c[:9] = torch.nan
    for m in sorted({1, n - (n - 1) // 2, n}):
        got = _launched(sort_kernels.closest_mean,
                        lambda: sort_kernels.closest_mean(g, c, m), dtype)
        _assert_ulps(got, sort_kernels.closest_mean_plain(g, c, m))
        assert bool(got[:9].isnan().all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("brute", "cge"))
def test_brute_and_cge_on_card_match_cpu(cuda, name):
    g = _mat(11, 30_001, seed=31, nan_rows=(3,))
    g[7:] = g[:7].mean(dim=0) - 1.5 * g[:7].std(dim=0)  # 4 identical rows
    _assert_values(gars[name](g.to(cuda), f=4), gars[name](g, f=4))
    assert float(gars[name].influence(g[:7].to(cuda), g[7:].to(cuda), f=4)) \
        == float(gars[name].influence(g[:7], g[7:], f=4))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_half_gars_on_card_match_cpu(cuda, dtype):
    """Median, Trimmed mean, Phocas and MeaMed on a half stack reach the
    half kernels, and agree with the same rule on the CPU."""
    g = _mat(25, 30_001, seed=37, nan_rows=(3,)).to(dtype)
    for name in ("median", "trmean", "phocas", "meamed"):
        _assert_ulps(gars[name](g.to(cuda), f=11), gars[name](g, f=11))
    assert sort_kernels.lower_median.launches_by_dtype[dtype] >= 2
    assert sort_kernels.closest_mean.launches_by_dtype[dtype] >= 2


@pytest.mark.gpu
def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = _mat(5, 100, seed=1).to(cuda)
    mask = torch.tensor([True, False, True, True, False], device=cuda)
    for call in (lambda: gar_kernels.sq_gram(g.bfloat16()),
                 lambda: gar_kernels.masked_rows_mean(mask, g.bfloat16(), 3),
                 lambda: gar_kernels.selected_median_mean(
                     torch.full((1, 5), 0.2, device=cuda, dtype=torch.bfloat16),
                     g.bfloat16(), 1)):
        with pytest.raises(ValueError):
            call()
    for bad_mask in (mask[:4], mask.float(), mask.cpu(), torch.ones(10, dtype=torch.bool,
                                                                     device=cuda)[::2]):
        with pytest.raises(ValueError, match="mask must"):
            gar_kernels.masked_rows_mean(bad_mask, g, 3)
    for k in (0, -1, 3.0):
        with pytest.raises(ValueError, match="k ="):
            gar_kernels.masked_rows_mean(mask, g, k)
    for dtype in (torch.bfloat16, torch.float16):
        h = g.to(dtype)
        with pytest.raises(ValueError, match="c must"):
            sort_kernels.closest_mean(h, torch.zeros(100, device=cuda), 1)
        for call in (lambda: sort_kernels.colsort(h.double()),
                     lambda: sort_kernels.lower_median(h.double())):
            with pytest.raises(ValueError, match="float32 or"):
                call()


# --------------------------------------------------------------------------- #
# The redesigned sq_gram and weighted_rows_mean: every vector width (d mod
# 4), operands that start off alignment, the headline d, repeat calls

WIDTH_DS = (20_012, 20_013, 20_014, 20_015)  # d = 0, 1, 2, 3 (mod 4)
OFFSETS = (0, 1, 2)  # f32 elements past an aligned allocation


def _shifted(g, floats):
    """A contiguous copy of `g` whose first element lies `floats`
    elements past the start of its allocation (an f32 operand 4 or 8
    bytes off 16-byte alignment)."""
    view = torch.empty(g.numel() + floats, dtype=g.dtype,
                       device=g.device)[floats:].view(g.shape)
    view.copy_(g)
    return view


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16).cpu()


def _check_gram(g):
    got = _launched(gar_kernels.sq_gram, lambda: gar_kernels.sq_gram(g))
    want = gar_kernels.sq_gram_plain(g)
    diag = torch.diagonal(want)
    _assert_values(got, want, atol=RTOL * float(diag[torch.isfinite(diag)].max()))
    assert torch.equal(_bits(got), _bits(gar_kernels.sq_gram(g)))


def _check_rows_mean(W, g):
    got = _launched(gar_kernels.weighted_rows_mean,
                    lambda: gar_kernels.weighted_rows_mean(W, g))
    _assert_values(got, gar_kernels.select_rows(W, g))
    assert torch.equal(_bits(got), _bits(gar_kernels.weighted_rows_mean(W, g)))
    return got


def _selections(n, rows, seed):
    """`rows` random selections of n rows (1/count weights), the first
    also taking the last row; a 1-D Krum-style w when rows == 1."""
    rng = np.random.default_rng(seed)
    W = np.zeros((rows, n), np.float32)
    for r in range(rows):
        picked = np.union1d(rng.permutation(n)[:int(rng.integers(1, n + 1))],
                            [n - 1] if r == 0 else [])
        W[r, picked.astype(int)] = np.float32(1.0) / len(picked)
    return torch.from_numpy(W[0] if rows == 1 else W)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 2, 5, 25, 33, 64))
@pytest.mark.parametrize("d", WIDTH_DS)
def test_sq_gram_every_width_and_offset(cuda, n, d):
    g = _mat(n, d, seed=41 * n + d, nan_rows=(n - 1,) if n > 2 else (),
             inf=n > 2).to(cuda)
    for offset in OFFSETS:
        _check_gram(_shifted(g, offset))


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 2, 5, 25, 33, 64))
@pytest.mark.parametrize("rows", (1, 8, 15, 64))
def test_weighted_rows_mean_every_width_and_offset(cuda, n, rows):
    """Every r in 1..64 reads g once; the first row of W selects the NaN
    row, whose NaN must reach exactly its columns."""
    W = _selections(n, rows, seed=43 * n + rows).to(cuda)
    for d in WIDTH_DS:
        g = _mat(n, d, seed=47 * n + d, nan_rows=(n - 1,), inf=True).to(cuda)
        for offset in OFFSETS:
            got = _check_rows_mean(W, _shifted(g, offset))
            assert bool((got if rows == 1 else got[0]).isnan().any())


@pytest.mark.gpu
def test_sq_gram_after_a_plan_with_less_shared_memory(cuda):
    """n = 64 and n = 50 take the same kernel form (B = 8) with 64 KB and
    56 KB of shared memory: querying the second plan must not take from
    the first the shared memory it launches with."""
    for n in (64, 50, 64):
        _check_gram(_mat(n, 20_014, seed=n, nan_rows=(1,), inf=True).to(cuda))


@pytest.mark.gpu
def test_redesigned_kernels_at_the_headline_shape(cuda):
    """f32[25, 1,310,922] (d = 2 mod 4: 8-byte vectors), as allocated, 4
    bytes off alignment, and as the row slice big[1:] of a 26-row
    matrix (8 bytes off 16-byte alignment)."""
    n, d = 25, 1_310_922
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = torch.randn((n + 1, d), generator=gen, device=cuda)
    big[n, :100] = torch.nan
    big[1, 7] = torch.inf
    w = _selections(n, 1, seed=5).to(cuda)
    W = _selections(n, 15, seed=7).to(cuda)
    for g in (big[:n].contiguous(), _shifted(big[:n], 1), big[1:]):
        assert g.is_contiguous()
        _check_gram(g)
        for weights in (w, W):
            _check_rows_mean(weights, g)


# --------------------------------------------------------------------------- #
# The redesigned closest_mean and selected_median_mean: every m a GAR
# meets, every load width (d mod 4), operands off alignment, repeat calls


def _build_all(jobs):
    """Build the libraries of `jobs` ((kernel, n, dtype, m) of
    `sort_kernels.build`) side by side."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda job: sort_kernels.build(*job), jobs))


# (n, m) of closest_mean that the GARs meet at n = 25: Phocas and MeaMed
# take m = n - f, f = 1..12; Bulyan on a half stack takes n = rounds =
# 25 - 2f - 2 rows and m = rounds - 2f, f = 1..5
GAR_CLOSEST = (tuple((25, 25 - f) for f in range(1, 13))
               + tuple((23 - 2 * f, 23 - 4 * f) for f in range(1, 6)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_closest_mean_every_m_a_gar_meets(cuda, dtype):
    _build_all([("closest_mean", n, dtype, m) for n, m in GAR_CLOSEST])
    for n, m in GAR_CLOSEST:
        g = _closest_columns(_mat(n, 20_012, seed=53 * n + m, nan_rows=(n - 1,),
                                  dup=True, inf=True), m)
        g = (g + 0.0).to(dtype).to(cuda)
        c = sort_kernels.lower_median_plain(g)
        got = _launched(sort_kernels.closest_mean,
                        lambda: sort_kernels.closest_mean(g, c, m), dtype)
        want = sort_kernels.closest_mean_plain(g, c, m)
        if dtype == torch.float32:
            _assert_values(got, want)
        else:
            _assert_ulps(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", ((2, 2), (25, 14), (33, 20), (64, 57)))
@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_closest_mean_every_width_and_offset(cuda, n, m, dtype):
    """d = 0..3 (mod 4), g and c 0, 1 or 2 elements past an aligned
    allocation: two columns a thread where d is even, both addresses are
    aligned to two elements and n <= 32, else one."""
    for d in WIDTH_DS:
        g = _closest_columns(_mat(n, d, seed=59 * n + d, nan_rows=(n - 1,),
                                  dup=True, inf=True), m)
        g = (g + 0.0).to(dtype).to(cuda)
        c = sort_kernels.lower_median_plain(g)
        c[:9] = torch.nan
        want = sort_kernels.closest_mean_plain(g, c, m)
        for g_off, c_off in ((0, 0), (1, 0), (0, 1), (2, 2)):
            gs, cs = _shifted(g, g_off), _shifted(c, c_off)
            got = _launched(sort_kernels.closest_mean,
                            lambda: sort_kernels.closest_mean(gs, cs, m), dtype)
            if dtype == torch.float32:
                _assert_values(got, want)
            else:
                _assert_ulps(got, want)
            assert torch.equal(_bits(got), _bits(sort_kernels.closest_mean(gs, cs, m)))
        assert sort_kernels.column_width(n, d, g.element_size(), 0, 0) == (
            2 if d % 2 == 0 and n <= 32 else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("d", WIDTH_DS)
def test_selected_median_mean_every_width_and_offset(cuda, d):
    """Bulyan's 13 rounds at n = 25, f = 5 over d = 0..3 (mod 4) and
    operands 0, 4 or 8 bytes off 16-byte alignment (float2 columns where
    d is even and the address 8-byte aligned), and the +-inf-median
    columns; repeat calls bitwise equal."""
    n, f = 25, 5
    g = _mat(n, d, seed=61 + d, nan_rows=(n - 1,), dup=True).to(cuda)
    W = bulyan.selection_weights(_common.pairwise_distances(g), f)
    h = g.clone()
    W2 = _stack_columns(h, W.shape[0], 3)
    for offset in OFFSETS:
        for weights, x in ((W, g), (W2, h)):
            xs = _shifted(x, offset)
            for m2 in (1, 3):
                got = _launched(gar_kernels.selected_median_mean,
                                lambda: gar_kernels.selected_median_mean(weights, xs, m2))
                _assert_values(got, gar_kernels.selected_median_mean_plain(weights, xs, m2))
                assert torch.equal(_bits(got), _bits(
                    gar_kernels.selected_median_mean(weights, xs, m2)))


@pytest.mark.gpu
def test_redesigned_sort_kernels_at_the_headline_shape(cuda):
    """closest_mean (m = 14, each dtype) and selected_median_mean (13
    rounds, m2 = 3) at [25, 1,310,922], as allocated and as the row slice
    big[1:] of a 26-row matrix (8 bytes off 16-byte alignment)."""
    n, d = 25, 1_310_922
    gen = torch.Generator(device=cuda).manual_seed(11)
    big = torch.randn((n + 1, d), generator=gen, device=cuda)
    big[n, :100] = torch.nan
    big[1, 7] = torch.inf
    for g in (big[:n].contiguous(), big[1:]):
        W = bulyan.selection_weights(_common.pairwise_distances(g), 5)
        _assert_values(gar_kernels.selected_median_mean(W, g, 3),
                       gar_kernels.selected_median_mean_plain(W, g, 3))
        for dtype in SORT_DTYPES:
            x = g.to(dtype)
            c = sort_kernels.lower_median_plain(x)
            got = sort_kernels.closest_mean(x, c, 14)
            want = sort_kernels.closest_mean_plain(x, c, 14)
            if dtype == torch.float32:
                _assert_values(got, want)
            else:
                _assert_ulps(got, want)


# --------------------------------------------------------------------------- #
# The redesigned lower_median and trimmed_mean: every trim a GAR meets at
# n = 25, the ends of the row range, special columns, both column widths
# (d even and aligned: two columns a thread up to 32 rows, whose bf16 and
# f16 forms key both columns in one word), operands one element off
# alignment, repeat calls


def _selection_columns(g):
    """g with an all-NaN column (0), +-0 only (1), +inf only (2), -inf
    only (3), +inf and -inf (4), +-3e38 whose sums overflow (5, 6, 7: in
    f16 these are +-inf) and a NaN in every other row (8)."""
    n = g.shape[0]
    rows = torch.arange(n, device=g.device)
    g[:, 0] = torch.nan
    g[:, 1] = torch.where(rows % 3 == 0, -0.0, 0.0)
    g[:, 2] = torch.inf
    g[:, 3] = -torch.inf
    g[:, 4] = torch.where(rows % 2 == 0, torch.inf, -torch.inf)
    g[:, 5] = 3e38
    g[:, 6] = -3e38
    g[:, 7] = torch.where(rows % 2 == 0, 3e38, -3e38)
    g[rows % 2 == 1, 8] = torch.nan
    return g


def _trims(n, dtype):
    """Every f a GAR meets at n = 25 in f32 (Trimmed mean and Phocas take
    f = 1..12; f = 0 is the full sort), f = 5 and 11 in the half types,
    and 0, (n - 1) // 4 and (n - 1) // 2 elsewhere."""
    if n == 25:
        return tuple(range(13)) if dtype == torch.float32 else (5, 11)
    return tuple(sorted({0, (n - 1) // 4, (n - 1) // 2}))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SORT_DTYPES)
@pytest.mark.parametrize("n", (1, 2, 25, 63, 64))
def test_keyed_lower_median_and_trimmed_mean_every_form(cuda, n, dtype):
    fs = _trims(n, dtype)
    _build_all([("lower_median", n, dtype)]
               + [("trimmed_mean", n, dtype, None, f) for f in fs])
    for d in (20_012, 20_013):
        g = _selection_columns(_mat(n, d, seed=67 * n + d, nan_rows=(n - 1,),
                                    dup=True, inf=True)).to(dtype).to(cuda)
        for offset in (0, 1):
            gs = _shifted(g, offset)
            assert sort_kernels.column_width(n, d, gs.element_size(),
                                             gs.data_ptr()) == (
                2 if n <= 32 and d % 2 == 0 and offset == 0 else 1)
            got = _launched(sort_kernels.lower_median,
                            lambda: sort_kernels.lower_median(gs), dtype)
            _assert_exact(got, sort_kernels.lower_median_plain(gs))
            assert torch.equal(_bits(got), _bits(sort_kernels.lower_median(gs)))
            for f in fs:
                got = _launched(sort_kernels.trimmed_mean,
                                lambda: sort_kernels.trimmed_mean(gs, f), dtype)
                _assert_exact(got, sort_kernels.trimmed_mean_plain(gs, f))
                assert torch.equal(_bits(got),
                                   _bits(sort_kernels.trimmed_mean(gs, f)))
                assert bool(got[0].isnan())
                if n - 2 * f >= 2:  # sums that overflow
                    assert bool(got[5].isposinf()) and bool(got[6].isneginf())


@pytest.mark.gpu
def test_keyed_lower_median_and_trimmed_mean_at_the_headline_shape(cuda):
    """[25, 1,310,922] in each dtype, as allocated (two columns a thread)
    and one element off alignment (one), f = 5 and 11; colsort too."""
    n, d = 25, 1_310_922
    gen = torch.Generator(device=cuda).manual_seed(13)
    g = torch.randn((n, d), generator=gen, device=cuda)
    g[n - 1, :100] = torch.nan
    g[1, 7] = torch.inf
    for dtype in SORT_DTYPES:
        x = g.to(dtype)
        for xs in (x, _shifted(x, 1)):
            _assert_exact(sort_kernels.lower_median(xs),
                          sort_kernels.lower_median_plain(xs))
            _assert_exact(sort_kernels.colsort(xs), sort_kernels.colsort_plain(xs))
            for f in (5, 11):
                _assert_exact(sort_kernels.trimmed_mean(xs, f),
                              sort_kernels.trimmed_mean_plain(xs, f))


# --------------------------------------------------------------------------- #
# The device-resident path: the gather on the card, the grouped honest phase


def _image_splits(no_transform):
    """A 130-image train and test split (B = 10) with the CIFAR transform."""
    from byzantinemomentum_tpu_torch import data
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (130, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 130).astype(np.int32)
    transform = data._image_transform("cifar10", no_transform)
    return [data.Dataset(x, y, 10, train=train, transform=transform, seed=3)
            for train in (True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("no_transform", (False, True))
def test_device_gather_on_the_card_equals_the_cpu_gather(cuda, no_transform):
    """Bit for bit, over an epoch boundary inside a call."""
    from byzantinemomentum_tpu_torch.data.device import DeviceData
    for split in _image_splits(no_transform):
        cpu, card = DeviceData(split, "cpu"), DeviceData(split, cuda)
        for _ in range(5):
            idx, flips = cpu.sample_indices(4)
            x, y = card.gather(*card.upload(idx, flips))
            cx, cy = cpu.gather(*cpu.upload(idx, flips))
            assert x.device.type == "cuda" and x.dtype == cx.dtype == torch.float32
            assert torch.equal(x.cpu().view(torch.int32), cx.view(torch.int32))
            assert torch.equal(y.cpu(), cy)


def _honest_setup(device, momentum_at="update", nesterov=False, **dtypes):
    """A grouped and a vmapped engine (n = 11, 2 real Byzantine workers,
    batch 8, clip 5) and the state, inputs and dropout masks both take:
    `(engines, state, xs, ys, masks)`."""
    import dataclasses

    from byzantinemomentum_tpu_torch import models, optim, prng
    from byzantinemomentum_tpu_torch.attacks import attacks
    from byzantinemomentum_tpu_torch.engine import Engine, EngineConfig
    from byzantinemomentum_tpu_torch.losses import Criterion, Loss
    cfg = EngineConfig(nb_workers=11, nb_decl_byz=2, nb_real_byz=2,
                       nb_for_study=11, momentum=0.99, gradient_clip=5.0,
                       momentum_at=momentum_at, nesterov=nesterov, **dtypes)
    engines = [Engine(c, models.build("empire-cnn", device=device,
                                      dtype=cfg.torch_dtype),
                      Loss("nll") + 1e-2 * Loss("l2"), Criterion("top-k"),
                      [(gars["bulyan"], 1.0, {})], attacks["empire"],
                      {"factor": 1.1},
                      optim.build("sgd"))
               for c in (cfg, dataclasses.replace(cfg, grouped_workers=False))]
    engines[0].model.init(prng.PRNGKey(1, device=device))
    state = engines[0].init(prng.PRNGKey(1, device=device))
    rng = np.random.default_rng(4)
    S, h, d = cfg.nb_sampled, cfg.nb_honests, engines[0].d
    state = dataclasses.replace(
        state,
        momentum_server=torch.from_numpy(0.01 * rng.standard_normal(d)).to(state.theta),
        momentum_workers=torch.from_numpy(0.01 * rng.standard_normal(
            (h if momentum_at == "worker" else 0, d))).to(state.theta))
    xs = torch.from_numpy(rng.standard_normal((S, 8, 32, 32, 3)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(S, 8)))
    masks = engines[0].model.draw_masks(engines[0].step_keys(state.rng)[2], 8)
    return engines, state, xs.to(device), ys.to(device), masks


def _honest_phases(device, momentum_at="update", nesterov=False, **dtypes):
    """The grouped and the vmapped honest phase of `_honest_setup`."""
    engines, *inputs = _honest_setup(device, momentum_at, nesterov, **dtypes)
    state, xs, ys, masks = inputs
    outs = [engine.phase_honest(state, xs, ys, 0.05, masks)
            for engine in engines]
    assert engines[0].counts == {"grouped_phases": 1}
    assert engines[1].counts == {"vmapped_phases": 1}
    return outs


def _honest_phases_on_one_argmax(device, **dtypes):
    """`_honest_phases`, then both phases again with every max-pool window
    taking the input that the grouped phase's max-pool picked in its first
    run: `(grouped, vmapped, grouped on that argmax, vmapped on it)`. The
    grouped program's pools record their argmax (`(S*B, C, h, w)`,
    worker-major) and take it back as it is; the vmapped program gets
    each worker's own through `vmap`, beside its dropout masks. So the
    two programs' second runs differ by no max-pool near tie."""
    from unittest import mock

    import torch.nn.functional as F

    from byzantinemomentum_tpu_torch.models import empire
    (grouped, vmapped), state, xs, ys, masks = _honest_setup(device, **dtypes)
    picked, given = [], []

    def recording_pool(x, window=2):
        out, idx = F.max_pool2d(x, window, return_indices=True)
        picked.append(idx)
        return out

    def given_pool(x, window=2):
        idx = given.pop(0)
        return x.flatten(-2).gather(-1, idx.flatten(-2)).view(idx.shape)

    forward = empire.EmpireCNN.forward

    def forward_taking_argmax(self, x, train=False, masks=None):
        given[:] = masks[3:]
        return forward(self, x, train, masks[:3])

    with mock.patch.object(empire, "max_pool", recording_pool):
        G = grouped.phase_honest(state, xs, ys, 0.05, masks)
    V = vmapped.phase_honest(state, xs, ys, 0.05, masks)
    with mock.patch.object(empire, "max_pool", given_pool):
        given[:] = picked
        GA = grouped.phase_honest(state, xs, ys, 0.05, masks)
        S = xs.shape[0]
        argmax = tuple(idx.view(S, -1, *idx.shape[1:]) for idx in picked)
        with mock.patch.object(empire.EmpireCNN, "forward",
                               forward_taking_argmax):
            VA = vmapped.phase_honest(state, xs, ys, 0.05,
                                      tuple(masks) + argmax)
    assert not given and len(argmax) == 2
    assert grouped.counts == {"grouped_phases": 2}
    assert vmapped.counts == {"vmapped_phases": 2}
    return G, V, GA, VA


def _row_distance(got, want):
    return (torch.linalg.vector_norm((got - want).double(), dim=1)
            / torch.linalg.vector_norm(want.double(), dim=1))


@pytest.mark.gpu
@pytest.mark.parametrize("momentum_at,nesterov",
                         (("update", False), ("server", True), ("worker", True)))
def test_grouped_honest_phase_on_the_card_matches_vmapped(cuda, momentum_at,
                                                          nesterov):
    """float64: every value within rtol 1e-9, atol 1e-12 (no ReLU input
    within rounding of 0, so no max-pool near tie). f32: every gradient
    row within 1e-2 relative L2 (the engine tests' near-tie bound), the
    losses within rtol 1e-4, the BatchNorm state within rtol 1e-4, atol
    1e-5."""
    grouped, vmapped = _honest_phases(cuda, momentum_at, nesterov,
                                      dtype="float64")
    for got, want in zip(grouped, vmapped):
        for name in (want if isinstance(want, dict) else (None,)):
            g, w = (got[name], want[name]) if name else (got, want)
            assert g.dtype == torch.float64
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
    (G, loss, net, *_), (V, vloss, vnet, *_) = _honest_phases(
        cuda, momentum_at, nesterov)
    assert bool((_row_distance(G, V) < 1e-2).all())
    torch.testing.assert_close(loss, vloss, rtol=1e-4, atol=0.0)
    for name in vnet:
        torch.testing.assert_close(net[name], vnet[name], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_mixed_grouped_honest_phase_on_the_card_matches_vmapped(cuda):
    """bf16-mixed, as `tests/test_torch_grouped.py` holds it: each grouped
    row within 0.5x the vmapped row's distance from its f32 row, unless a
    max-pool near tie between the two programs moved it; then it is within
    0.5x once both programs pool from one argmax
    (`_honest_phases_on_one_argmax`), where every row is held so. The
    grouped rows' mean distance from their f32 rows within 1.5x the
    vmapped rows'; the losses within rtol 2e-2."""
    mixed = {"dtype": "float32", "compute_dtype": "bfloat16"}
    (G, loss, *_), (V, vloss, *_), (GA, *_), (VA, *_) = \
        _honest_phases_on_one_argmax(cuda, **mixed)
    (G32, *_), (V32, *_) = _honest_phases(cuda)
    assert G.dtype == torch.float32 and loss.dtype == torch.float32
    err = _row_distance(V, V32)
    assert bool((_row_distance(GA, VA) <= 0.5 * _row_distance(VA, V32)).all())
    assert float(_row_distance(G, G32).mean()) <= 1.5 * float(err.mean())
    torch.testing.assert_close(loss, vloss, rtol=2e-2, atol=0.0)


# The MNIST half of the paper's grid: n = 51 at f = 24 and 12 on
# `simples-full` (d = 79,510), n = 11 at f = 4 on `simples-conv`
# (d = 431,080) and `simples-logit` (d = 69, phishing); the last f rows all
# NaN, as the `nan` attack sends them (`chip_smoke.nan_attack_operand`)
MNIST_SHAPES = ((51, 24, 79_510), (51, 12, 79_510), (11, 4, 431_080),
                (11, 4, 69))


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,d", MNIST_SHAPES)
def test_gar_kernels_at_the_mnist_grid_shapes(cuda, n, f, d):
    """Krum's w (and Bulyan's W where n >= 4f + 3) from `sq_gram` equal
    those from `sq_gram_plain` and never select a NaN row; `sq_gram`,
    `weighted_rows_mean` and `selected_median_mean` agree with their plain
    versions."""
    from byzantinemomentum_tpu_torch.ops import krum
    g = nan_attack_operand(n, f, d, seed=n + f, device=cuda)
    gram = _launched(gar_kernels.sq_gram, lambda: gar_kernels.sq_gram(g))
    plain = gar_kernels.sq_gram_plain(g)
    diag = torch.diagonal(plain)
    _assert_values(gram, plain, atol=RTOL * float(diag[torch.isfinite(diag)].max()))
    dist = _common.distances_from_sq_gram(gram)
    plain_dist = _common.distances_from_sq_gram(plain)
    w = krum.selection_weights(dist, f)
    assert torch.equal(w, krum.selection_weights(plain_dist, f))
    assert not bool((w[n - f:] > 0).any()) and int((w > 0).sum()) == n - f - 2
    got = _launched(gar_kernels.weighted_rows_mean,
                    lambda: gar_kernels.weighted_rows_mean(w, g))
    _assert_values(got, gar_kernels.select_rows(w, g))
    if 4 * f + 3 <= n:
        W = bulyan.selection_weights(dist, f)
        assert torch.equal(W, bulyan.selection_weights(plain_dist, f))
        rounds = W.shape[0]
        for m2 in (1, rounds - 2 * f, rounds):
            got = _launched(gar_kernels.selected_median_mean,
                            lambda: gar_kernels.selected_median_mean(W, g, m2))
            _assert_values(got, gar_kernels.selected_median_mean_plain(W, g, m2))
            assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,d", MNIST_SHAPES)
def test_sort_kernels_at_the_mnist_grid_shapes(cuda, n, f, d):
    """`lower_median` and `trimmed_mean` (f) exactly, `closest_mean`
    (m = n - f, n = 51: every finite value of a column, never a NaN)
    about the median and the trimmed mean, on rows with NaN, +-inf and
    +-0."""
    h = n - f
    g = nan_attack_operand(n, f, d, seed=n + f + 1, extremes=True,
                           device=cuda)
    finite = torch.isfinite(g[:h]).all(dim=0)
    med = _launched(sort_kernels.lower_median, lambda: sort_kernels.lower_median(g))
    _assert_exact(med, sort_kernels.lower_median_plain(g))
    trmean = _launched(sort_kernels.trimmed_mean,
                       lambda: sort_kernels.trimmed_mean(g, f))
    _assert_exact(trmean, sort_kernels.trimmed_mean_plain(g, f))
    # NaN sorts last: the window [f, n - f) holds finite ranks only
    top = torch.sort(g[:h, finite], dim=0).values[f:n - f].mean(dim=0)
    _assert_values(trmean[finite], top)
    assert bool(trmean[1].isposinf()) and bool(trmean[2].isneginf())
    if n != 51:
        return
    for c in (sort_kernels.lower_median_plain(g),
              sort_kernels.trimmed_mean_plain(g, f)):
        got = _launched(sort_kernels.closest_mean,
                        lambda: sort_kernels.closest_mean(g, c, h))
        _assert_values(got, sort_kernels.closest_mean_plain(g, c, h))
        _assert_values(got[finite], g[:h, finite].mean(dim=0))


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,d", MNIST_SHAPES)
def test_mnist_grid_gars_on_card_match_cpu(cuda, n, f, d):
    """Krum, Median, Trimmed mean, Phocas, MeaMed (and Bulyan where
    n >= 4f + 3) on the `nan` attack's rows: the card's aggregate equals
    the CPU's, and is finite."""
    g = nan_attack_operand(n, f, d, seed=3 * n + f, device="cpu")
    for name in ("krum", "median", "trmean", "phocas", "meamed", "bulyan"):
        if name == "bulyan" and 4 * f + 3 > n:
            continue
        got = gars[name](g.to(cuda), f=f)
        assert bool(torch.isfinite(got).all()), name
        _assert_values(got, gars[name](g, f=f))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("mnist", "fashionmnist", "phishing"))
def test_mnist_device_gather_on_the_card_equals_the_cpu_gather(cuda, monkeypatch, name):
    """MNIST (normalized, no flips), FashionMNIST (flipped, not
    normalized) and phishing (raw rows, float (B, 1) labels), bit for
    bit."""
    from byzantinemomentum_tpu_torch import data
    from byzantinemomentum_tpu_torch.data.device import DeviceData
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "130")
    monkeypatch.setenv("BMT_SYNTH_TEST", "40")
    for split in data.make_datasets(name, 10, 10, seed=3):
        cpu, card = DeviceData(split, "cpu"), DeviceData(split, cuda)
        for _ in range(5):
            idx, flips = cpu.sample_indices(4)
            x, y = card.gather(*card.upload(idx, flips))
            cx, cy = cpu.gather(*cpu.upload(idx, flips))
            assert x.device.type == "cuda" and x.dtype == cx.dtype == torch.float32
            assert torch.equal(x.cpu().view(torch.int32), cx.view(torch.int32))
            assert torch.equal(y.cpu(), cy)


# The attacks on the card against the same attacks on the CPU: (attack,
# its arguments, the GAR it runs against, the kernels each probe of a
# line search launches). h = 20 honest rows, f = 5, d = 20,001.
ATTACK_CASES = (
    ("empire", {"factor": -16}, "bulyan", ("sq_gram", "selected_median_mean")),
    ("little", {"factor": -16, "negative": True}, "median", ("lower_median",)),
    ("bulyan", {"factor": -16}, "krum", ("sq_gram", "weighted_rows_mean")),
    ("empire-strict", {"epsilon": -16}, "trmean", ("trimmed_mean",)),
    ("empire", {"factor": 1.1}, "bulyan", ()),
    ("anticge", {}, "cge", ()),
    ("alie", {}, "krum", ()),
    ("alie", {"jitter": 0.1}, "krum", ()),
    ("alie-warmup", {"window": 1, "jitter": 0.1}, "krum", ()),
    ("framing", {"victim": 0, "push": 1.0, "jitter": 0.1}, "krum", ()),
    ("mimic", {"victim": 3, "jitter": 0.1}, "median", ()),
    ("nan", {}, "median", ()),
)


def _attack_rows(name, kwargs, gar, g, f):
    """The attack's rows (a stateful attack's second step, past its
    burst)."""
    from byzantinemomentum_tpu_torch.attacks import attacks
    atk = attacks[name]
    defense = gars[gar].unchecked
    if atk.stateful:
        _, state = atk(g, f, f, defense=defense, **kwargs)
        rows, _ = atk.checked(g, f, f, defense=defense, state=state, **kwargs)
        return rows
    return atk(g, f, f, defense=defense, **kwargs)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kwargs,gar,kernels", ATTACK_CASES,
                         ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(ATTACK_CASES)])
def test_attacks_on_card_match_cpu(cuda, monkeypatch, name, kwargs, gar, kernels):
    """The rows on the card equal the CPU's (NaN by position; values
    within rtol 1e-5, atol 1e-6 times the rows' largest magnitude: the
    mean's last bits differ between the card's sum and the CPU's, and a
    factor of up to 32767 scales them); a line search launches each
    kernel of its GAR once a probe, 16 times, and finds the CPU's factor
    or a near-tie of the CPU's objective (rtol 1e-6)."""
    from byzantinemomentum_tpu_torch.attacks import empire, identical
    factors = []
    for module in (identical, empire):
        original = module.line_maximize

        def line_maximize(scape, *args, original=original, **kw):
            best = original(scape, *args, **kw)
            factors.append((best, scape))
            return best
        monkeypatch.setattr(module, "line_maximize", line_maximize)
    h, f, d = 20, 5, 20_001
    g = _mat(h, d, seed=11)
    wrappers = {kernel: getattr(gar_kernels, kernel, None)
                or getattr(sort_kernels, kernel) for kernel in kernels}
    before = {kernel: w.launches for kernel, w in wrappers.items()}
    got = _attack_rows(name, kwargs, gar, g.to(cuda), f)
    for kernel, wrapper in wrappers.items():
        assert wrapper.launches - before[kernel] == 16, kernel
    want = _attack_rows(name, kwargs, gar, g, f)
    assert got.device.type == "cuda" and got.shape == want.shape == (f, d)
    if factors:
        (card, _), (cpu, objective) = factors
        card, cpu = card.cpu(), cpu  # f32 0-d tensors, the search's state
        if card != cpu:
            a, b = float(objective(card)), float(objective(cpu))
            assert abs(a - b) <= 1e-6 * max(abs(a), abs(b)), (card, cpu, a, b)
            return
    # The rows scale the honest mean's rounding by the factor: the
    # absolute tolerance follows the rows' magnitude
    finite = torch.isfinite(want)
    scale = float(want[finite].abs().max()) if bool(finite.any()) else 1.0
    _assert_values(got, want, atol=ATOL * max(1.0, scale))


@pytest.mark.gpu
def test_normal_on_card_equals_the_cpu_bits(cuda):
    """`prng.normal` (and its key from `alie.row_key`) on the card gives
    the CPU's bits."""
    from byzantinemomentum_tpu_torch import prng
    from byzantinemomentum_tpu_torch.attacks import alie
    g = _mat(20, 100_003, seed=12)
    key = alie.row_key(g)
    assert torch.equal(alie.row_key(g.to(cuda)).cpu(), key)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = prng.normal(key.to(cuda), (5, 100_003), dtype)
        want = prng.normal(key, (5, 100_003), dtype)
        assert got.dtype == dtype
        assert torch.equal(got.cpu().view(torch.int16 if dtype != torch.float32
                                          else torch.int32),
                           want.view(torch.int16 if dtype != torch.float32
                                     else torch.int32))


# The masks of the headline (S = 20, B = 50), of krum_f11 (S = 14), and a
# ragged S = 3, B = 5 (75 elements a worker at the dense layer, 12,800 at
# the first: neither a multiple of a block's 2,048)
MASK_CASES = ((20, 50), (14, 50), (3, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("S,B", MASK_CASES)
def test_dropout_mask_kernel_equals_its_plain_version(cuda, S, B):
    """`prng_kernels.dropout_masks` on the card against its plain version
    on the CPU, bit for bit, for the three masks of `empire-cnn`; the
    model's draw (`draw_masks`) takes the kernel, three launches."""
    from byzantinemomentum_tpu_torch import models, prng
    from byzantinemomentum_tpu_torch.ops import _cuda, prng_kernels
    wkeys = prng.split(prng.PRNGKey(S * 100 + B), S)
    shapes = ((B, 16, 16, 64), (B, 8, 8, 128), (B, 128))
    for j, shape in enumerate(shapes):
        got = prng_kernels.dropout_masks(wkeys.to(cuda), j, shape, 192)
        want = prng_kernels.dropout_masks_plain(wkeys, j, shape, 192)
        assert got.dtype == torch.bool and got.is_cuda
        assert torch.equal(got.cpu(), want)
    model = models.build("empire-cnn", device=cuda)
    _cuda.reset_launches()
    masks = model.draw_masks(wkeys.to(cuda), B)
    assert prng_kernels.dropout_masks.launches == 3
    for got, want in zip(masks, model.draw_masks(wkeys, B)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (3, 22, 27, 53))
def test_split_kernel_equals_the_cpu_bits(cuda, n):
    from byzantinemomentum_tpu_torch import prng
    from byzantinemomentum_tpu_torch.ops import prng_kernels
    key = prng.fold_in(prng.PRNGKey(n), 1)
    got = prng_kernels.split_keys(key.to(cuda), n)
    assert torch.equal(got.cpu(), prng.split(key, n))
    keys = prng.split(key, 5)
    assert torch.equal(prng_kernels.split_keys(keys.to(cuda), n).cpu(),
                       prng.split(keys, n))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("empire-cnn", "simples-conv"))
def test_init_on_the_card_equals_the_cpu_bits(cuda, name):
    from byzantinemomentum_tpu_torch import models, prng
    card = models.build(name, device=cuda)
    card.init(prng.PRNGKey(7, device=cuda))
    cpu = models.build(name, device="cpu")
    cpu.init(prng.PRNGKey(7))
    for (key, a), (_, b) in zip(card.state_dict().items(),
                                cpu.state_dict().items()):
        assert torch.equal(a.cpu(), b), key


# WRN's keep 0.7 and a sweep of other rates that are no 8-bit threshold;
# 0 and 1 keep nothing and everything, 2^-23 only the draws whose top 23
# bits are 0
BERNOULLI_KEEPS = (0.7, 0.3, 0.9, 0.123456, 2.0**-23, 0.0, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("keep", BERNOULLI_KEEPS)
@pytest.mark.parametrize("S,B", ((3, 5), (9, 2)))
def test_bernoulli_mask_kernel_equals_its_plain_version(cuda, keep, S, B):
    """`prng_kernels.bernoulli_masks` on the card against
    `prng.bernoulli` on the CPU, bit for bit: WRN-28-10's three mask
    shapes at (S, B) and a dense (B, F) mask; one launch each."""
    from byzantinemomentum_tpu_torch import prng
    from byzantinemomentum_tpu_torch.ops import prng_kernels
    wkeys = prng.split(prng.PRNGKey(S * 100 + B), S)
    shapes = ((B, 32, 32, 160), (B, 16, 16, 320), (B, 8, 8, 640), (B, 129))
    for j, shape in enumerate(shapes):
        before = prng_kernels.bernoulli_masks.launches
        got = prng_kernels.bernoulli_masks(wkeys.to(cuda), j, shape, keep)
        assert prng_kernels.bernoulli_masks.launches == before + 1
        want = prng_kernels.bernoulli_masks_plain(wkeys, j, shape, keep)
        assert got.dtype == torch.bool and got.is_cuda
        assert torch.equal(got.cpu(), want), (keep, shape)
    if keep in (0.0, 1.0):
        assert bool((got == bool(keep)).all())


@pytest.mark.gpu
def test_wide_resnet_draws_its_masks_through_the_kernel(cuda):
    from byzantinemomentum_tpu_torch import models, prng
    from byzantinemomentum_tpu_torch.ops import _cuda, prng_kernels
    args = {"depth": 16, "widen_factor": 2, "dropout_rate": 0.3,
            "num_classes": 10}
    card = models.build("wide_resnet-Wide_ResNet", device=cuda, **args)
    cpu = models.build("wide_resnet-Wide_ResNet", device="cpu", **args)
    card.init(prng.PRNGKey(5, device=cuda))
    cpu.init(prng.PRNGKey(5))
    for (key, a), (_, b) in zip(card.state_dict().items(),
                                cpu.state_dict().items()):
        assert torch.equal(a.cpu(), b), key
    wkeys = prng.split(prng.PRNGKey(4), 3)
    _cuda.reset_launches()
    masks = card.draw_masks(wkeys.to(cuda), 4)
    assert prng_kernels.bernoulli_masks.launches == 6
    assert prng_kernels.dropout_masks.launches == 0
    for got, want in zip(masks, cpu.draw_masks(wkeys, 4)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("size", (32, 16, 7))
@pytest.mark.parametrize("k,padding", ((3, "same"), (1, "valid")))
@pytest.mark.parametrize("shared", (False, True))
def test_strided_grouped_conv_matches_the_vmapped_one(cuda, size, k, padding,
                                                      shared):
    """`grouped_conv` at stride 2 (XLA's SAME, 0 before and 1 after on an
    even width) against `torch.func.vmap` of the per-worker `Conv` on the
    card: the output and the input, kernel and bias gradients within rtol
    1e-4, atol 1e-5 (cuDNN's algorithms sum in other orders; TF32 off)."""
    from byzantinemomentum_tpu_torch.engine.step import pin_precision
    from byzantinemomentum_tpu_torch.models.core import Conv, grouped_conv
    pin_precision()
    S, Bc, cin, cout = 3, 4, 16, 32
    gen = torch.Generator(device=cuda).manual_seed(size * k)
    x = torch.randn((S, Bc, cin, size, size), generator=gen, device=cuda)
    w = torch.randn((S, k, k, cin, cout), generator=gen, device=cuda) / k
    b = torch.randn((S, cout), generator=gen, device=cuda)
    if shared:
        w, b = w[:1].expand_as(w).contiguous(), b[:1].expand_as(b).contiguous()
    out_size = -(-size // 2) if padding == "same" else (size - 1) // 2 + 1
    gy = torch.randn((S, Bc, cout, out_size, out_size), generator=gen,
                     device=cuda)
    conv = Conv(cin, cout, k, padding, stride=2, device=cuda)

    def one(x, w, b):
        return torch.func.functional_call(conv, {"w": w, "b": b}, (x,))

    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.func.vmap(one)(*leaves)
    want.backward(gy)
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    got = grouped_conv(xg.flatten(0, 1), wg, bg, shared, padding, stride=2)
    got.backward(gy.flatten(0, 1))
    torch.testing.assert_close(got.view(want.shape), want, rtol=1e-4, atol=1e-5)
    for mine, theirs in zip((xg, wg, bg), leaves):
        torch.testing.assert_close(mine.grad, theirs.grad, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# Fused dispatch: the line search's state update and a step with no host read

@pytest.mark.gpu
@pytest.mark.parametrize("ydtype", (torch.float32, torch.float64))
def test_linesearch_step_kernel_equals_its_plain_version(cuda, ydtype):
    """The kernel's next state equals its plain version's on the card and
    the CPU's, bit for bit, on `chip_smoke.search_states()` (expansion,
    contraction, the guard to -0, NaN values); one launch a call, counted
    under the values' dtype."""
    from byzantinemomentum_tpu_torch.ops import search_kernels
    from chip_smoke import search_states

    def bits(t):
        view = {torch.float32: torch.int32, torch.float64: torch.int64,
                torch.int32: torch.int32}[t.dtype]
        return t.contiguous().view(view).cpu()

    for x, best_y, ints, y in search_states():
        cpu = (torch.tensor(x, dtype=torch.float32),
               torch.tensor(best_y, dtype=ydtype),
               torch.tensor(ints, dtype=torch.int32),
               torch.tensor(y, dtype=ydtype))
        card = tuple(t.to(cuda) for t in cpu)
        got = _launched(search_kernels.linesearch_step,
                        lambda: search_kernels.linesearch_step(*card), ydtype)
        for want in (search_kernels.linesearch_step_plain(*card),
                     search_kernels.linesearch_step_plain(*cpu)):
            assert all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))


@pytest.mark.gpu
def test_headline_chunk_makes_no_synchronizing_call(cuda, tmp_path, monkeypatch):
    """One chunk of 3 headline steps (Bulyan f = 5 against the default
    `empire` search, empire-cnn at n = 25, cut to batch 8 and 500 train
    images) through `Engine.train_multi_indexed` under
    `set_sync_debug_mode("error")`, after one warm-up step."""
    from byzantinemomentum_tpu_torch.cli import attack as driver
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "500")
    monkeypatch.setenv("BMT_SYNTH_TEST", "100")
    args = driver._postprocess(driver.process_commandline([
        "--seed", "1", "--dataset", "cifar10", "--model", "empire-cnn",
        "--nb-workers", "25", "--nb-decl-byz", "5", "--nb-real-byz", "5",
        "--gar", "bulyan", "--attack", "empire", "--batch-size", "8",
        "--momentum", "0.99", "--gradient-clip", "5", "--nb-for-study", "1",
        "--nb-for-study-past", "2", "--result-directory", str(tmp_path)]))
    _, engine, state = driver._setup(args)
    lrs = np.full(3, 0.01, np.float32)
    state, _ = engine.train_multi_indexed(state, *engine.sample_indices(1),
                                          lrs[:1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = engine.train_multi_indexed(
            state, *engine.sample_indices(3), lrs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert metrics["Defense gradient norm"].shape == (3,)
    assert bool(torch.isfinite(metrics["Defense gradient norm"]).all())
    assert int(state.past_count) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16, torch.float16))
@pytest.mark.parametrize("n,d", ((25, 1032), (7, 4), (3, 1)))
def test_operand_hash_kernel_equals_its_plain_version(cuda, dtype, n, d):
    """The hash bit for bit on the card, on stacks with NaN payloads,
    +-0, +-inf and a subnormal (`chip_smoke.hash_stack`; 16-byte loads
    where d allows, scalar ones otherwise; an offset view takes the
    scalar path) and the draw from it; one launch each."""
    from byzantinemomentum_tpu_torch import prng
    from byzantinemomentum_tpu_torch.ops import mixture_kernels as mk
    g = hash_stack(n, d, dtype, seed=n + d, device=cuda)
    for operand in (g, g.reshape(-1)[1:].reshape(1, -1)):
        want = mk.operand_hash_plain(operand.cpu())
        got = _launched(mk.operand_hash, lambda: mk.operand_hash(operand),
                        dtype)
        assert int(got) == int(want)
        assert int(mk.operand_hash_plain(operand)) == int(want)
        key = prng.PRNGKey(n * 31 + d)
        cum = torch.tensor([2.0, 3.0, 4.0])
        drawn = _launched(mk.mixture_draw, lambda: mk.mixture_draw(
            key.to(cuda), got, cum.to(cuda)), torch.int64)
        assert int(drawn) == int(mk.mixture_draw_plain(key, want, cum))


@pytest.mark.gpu
@pytest.mark.parametrize("keep", (0.8, 0.5))
def test_mask_kernels_draw_from_the_keys_as_given(cuda, keep):
    """`j` None: the mask kernels hash under the workers' keys themselves
    (MobileNetV2's classifier mask), bit for bit the CPU's draw."""
    from byzantinemomentum_tpu_torch import prng
    from byzantinemomentum_tpu_torch.ops import prng_kernels
    wkeys = prng.split(prng.PRNGKey(31), 5)
    wrapper, plain, arg = (
        (prng_kernels.bernoulli_masks, prng_kernels.bernoulli_masks_plain, keep)
        if keep == 0.8 else
        (prng_kernels.dropout_masks, prng_kernels.dropout_masks_plain, 128))
    for shape in ((7, 1280), (3, 4, 4, 9)):
        got = _launched(wrapper, lambda: wrapper(wkeys.to(cuda), None, shape,
                                                 arg), torch.bool)
        assert torch.equal(got.cpu(), plain(wkeys, None, shape, arg))
        assert not torch.equal(got.cpu(), plain(wkeys, 0, shape, arg))


@pytest.mark.gpu
@pytest.mark.parametrize("name,cpu_init", (
    ("resnet18", True), ("resnet50", False), ("vgg11", False),
    ("densenet121", True), ("mobilenet_v2", True),
    ("transformer-classifier", True)))
def test_zoo_gradient_on_the_card_matches_the_cpu(cuda, name, cpu_init):
    """Each zoo family at full width, batch 4, train mode: the card's
    outputs, gradient and BatchNorm state against the CPU's float64 ones
    on the same weights and masks, no farther than 4 times the CPU's own
    f32 run (`chip_smoke.card_vs_cpu_gradient`)."""
    from chip_smoke import card_vs_cpu_gradient
    from byzantinemomentum_tpu_torch.engine.step import pin_precision
    pin_precision()
    card_vs_cpu_gradient(name, seed=2, cpu_init=cpu_init)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DIAG_CALLS))
def test_diagnose_on_the_card_matches_the_cpu(cuda, name):
    n, f = 25, 5
    g = diag_operand(n, 20_011, seed=len(name), device="cpu")
    gar = gars[name]
    gar_kernels.reset_launches()
    agg, aux = gar.diagnosed(g.to(cuda), f=f)
    torch.cuda.synchronize()
    assert launched() == diag_launches(name, influence=False)
    plain = gar.unchecked(g.to(cuda), f=f)
    assert torch.equal(agg.view(torch.int32), plain.view(torch.int32))
    want_agg, want_aux = gar.diagnosed(g, f=f)
    _assert_values(agg, want_agg)
    for key in ("selection", "trim_frac"):
        assert torch.equal(aux[key].cpu(), want_aux[key]), key
    for key in ("dist", "scores"):
        want = want_aux[key]
        finite = want[torch.isfinite(want)].abs()
        scale = float(finite.max()) if finite.numel() else 0.0
        _assert_values(aux[key], want, atol=max(ATOL, RTOL * scale))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MASKED_CALLS))
def test_masked_forms_on_the_card_match_their_plain_kernel_forms(cuda, name):
    from byzantinemomentum_tpu_torch.faults import quorum
    n, f, d = 25, 5, 20_011
    g = _mat(n, d, seed=len(name), nan_rows=(7,), dup=True, inf=True)
    g[[3, 22]] = float("nan")
    active = torch.ones(n, dtype=torch.bool)
    active[[3, 22]] = False
    G, act = g.to(cuda), active.to(cuda)
    gar_kernels.reset_launches()
    agg, f_eff = quorum.masked_aggregate(gars[name], G, act, f_decl=f)
    torch.cuda.synchronize()
    assert launched() == masked_launches(name)
    with plain_kernels():
        want, want_f = quorum.masked_aggregate(gars[name], G, act, f_decl=f)
    assert int(f_eff) == int(want_f)
    _assert_values(agg, want)


@pytest.mark.gpu
def test_fault_chunk_makes_no_synchronizing_call(cuda, tmp_path, monkeypatch):
    """The headline chunk test's run with `chip_smoke.HEADLINE_PLAN`: one
    warm-up step, then steps 1-4 (the NaN window and the lost worker, the
    masked Bulyan and the quarantine) under `set_sync_debug_mode("error")`;
    the fault columns come back as [4] int32 tensors."""
    from byzantinemomentum_tpu_torch.cli import attack as driver
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "500")
    monkeypatch.setenv("BMT_SYNTH_TEST", "100")
    plan = HEADLINE_PLAN.save(tmp_path / "plan.json")
    args = driver._postprocess(driver.process_commandline([
        "--seed", "1", "--dataset", "cifar10", "--model", "empire-cnn",
        "--nb-workers", "25", "--nb-decl-byz", "5", "--nb-real-byz", "5",
        "--gar", "bulyan", "--attack", "empire", "--batch-size", "8",
        "--momentum", "0.99", "--gradient-clip", "5", "--nb-for-study", "1",
        "--nb-for-study-past", "2", "--fault-plan", str(plan),
        "--result-directory", str(tmp_path / "run")]))
    _, engine, state = driver._setup(args)
    lrs = np.full(4, 0.01, np.float32)
    state, _ = engine.train_multi_indexed(state, *engine.sample_indices(1),
                                          lrs[:1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = engine.train_multi_indexed(
            state, *engine.sample_indices(4), lrs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert metrics["Workers active"].dtype == torch.int32
    assert metrics["Workers active"].tolist() == [25, 18, 18, 18]
    assert bool(torch.isfinite(metrics["Defense gradient norm"]).all())
