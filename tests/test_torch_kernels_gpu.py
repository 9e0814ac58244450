"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: without a card every test here skips. On the card run
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``
(``tests/conftest.py`` imports JAX, which the card's machine need not
have).
"""

import re

import numpy as np
import pytest
import torch

from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.memory import device_pages as dp
from filodb_tpu_torch.query.engine import cuda_kernels as ck
from filodb_tpu_torch.query.engine.device_batch import (
    assemble_hist,
    pack_series_pages,
    to_device,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(nb, seed):
    """nb blocks cycling through every width 0..32 and every shift 0..32
    (5 is prime to 33, so any 33 neighbours hold each shift once), words
    random across the whole row, past 4*w as well."""
    rng = np.random.default_rng(seed)
    i = np.arange(nb)
    widths = (i % 33).astype(np.int32)
    shifts = (i * 5 % 33).astype(np.int32)
    words = rng.integers(0, 2**32, (nb, 128), dtype=np.uint64).astype(
        np.uint32)
    slopes = rng.integers(-2**31, 2**31 - 1, nb).astype(np.int32)
    firsts = rng.integers(0, 2**32, nb, dtype=np.uint64).astype(np.uint32)
    return (torch.from_numpy(slopes), torch.from_numpy(widths),
            torch.from_numpy(shifts), dp.u32_as_i32(firsts),
            dp.u32_as_i32(words))


def _block_count(case):
    """Block counts at and around the decode kernel's boundaries: "warp"
    and "cta" are the blocks one warp walks and one CTA covers, read from
    the library, and "+1"/"-1" step off them."""
    if isinstance(case, int):
        return case
    from filodb_tpu_torch import _build

    unit, delta = re.fullmatch(r"(warp|cta)([+-]1)?", case).groups()
    n = _build.constant("decode_pages", f"decode_pages_blocks_per_{unit}")
    return n + int(delta or 0)


@pytest.mark.parametrize("nb", [1, 5, 4099, "warp-1", "warp", "warp+1",
                                "cta-1", "cta", "cta+1", 2**20 + 3])
def test_b1_b2_bitwise_equal_to_plain(cuda, nb):
    nb = _block_count(nb)
    slopes, widths, shifts, firsts, words = _blocks(nb, nb)
    ts_cpu = dp.decode_ts_blocks(slopes, widths, words)
    f_cpu = dp.decode_f32_blocks(firsts, shifts, widths, words)
    ts_gpu = dp.decode_ts_blocks(slopes.to(cuda), widths.to(cuda),
                                 words.to(cuda)).cpu()
    f_gpu = dp.decode_f32_blocks(firsts.to(cuda), shifts.to(cuda),
                                 widths.to(cuda), words.to(cuda)).cpu()
    assert torch.equal(ts_gpu, ts_cpu)
    assert torch.equal(f_gpu.view(torch.int32), f_cpu.view(torch.int32))


def test_b1_b2_raise_on_misaligned_words(cuda):
    slopes, widths, shifts, firsts, words = (
        t.to(cuda) for t in _blocks(9, 0))
    # a view one word into a buffer: contiguous, 4 bytes off a 16-byte line
    buf = torch.zeros(9 * 128 + 1, dtype=torch.int32, device=cuda)
    view = buf[1:].view(9, 128)
    view.copy_(words)
    with pytest.raises(ValueError, match="words must be 16-byte aligned"):
        dp.decode_ts_blocks(slopes, widths, view)
    with pytest.raises(ValueError, match="words must be 16-byte aligned"):
        dp.decode_f32_blocks(firsts, shifts, widths, view)


def _packed(n_series, n, seed, reset_at=None, gauge=False, nan_at=None):
    """Series of n samples at about 10 s, cut into 400-sample chunks as the
    store seals them (so a block boundary falls every 128 samples of a
    chunk); counters reset at ``reset_at`` (every third series) or at
    n // 2; every other series has NaN samples (staleness markers) at the
    indices ``nan_at``."""
    rng = np.random.default_rng(seed)
    per = []
    for i in range(n_series):
        ts = np.cumsum(rng.integers(8000, 12000, n)).astype(np.int64)
        if gauge:
            vals = rng.integers(-50, 50, n).astype(np.float64)
        else:
            vals = np.cumsum(rng.integers(0, 20, n)).astype(np.float64)
            if i % 3 == 0:
                for r in np.atleast_1d(reset_at if reset_at is not None
                                       else n // 2):
                    vals[r:] -= vals[r]
        if nan_at is not None and i % 2 == 0:
            vals[nan_at] = np.nan
        per.append([(dp.encode_ts_page(ts[a : a + 400]),
                     dp.encode_f32_page(vals[a : a + 400]),
                     len(ts[a : a + 400])) for a in range(0, n, 400)])
    return pack_series_pages(per, 0)[0]


def _b3_both(packed, steps, window, kind="rate", counter=True):
    got = ck.fused_decode_rate(packed, steps, window, kind, counter)
    want = ck.fused_decode_rate_plain(packed, steps, window, kind, counter)
    # correction sums are exact on integer-valued counters, so only the
    # last float32 roundings of the rate formula may differ
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    return got


@pytest.mark.parametrize("n", [100, 250, 720])
@pytest.mark.parametrize("kind", ["rate", "increase", "delta"])
def test_b3_matches_plain(cuda, n, kind):
    packed = to_device(_packed(37, n, n), cuda)
    steps = torch.arange(60_000, n * 12_000, 60_000, dtype=torch.int32,
                         device=cuda)
    _b3_both(packed, steps, 300_000, kind)


@pytest.mark.parametrize("nb,n", [(128, 6800), (256, 17280)])
@pytest.mark.parametrize("kind", ["rate", "increase", "delta"])
def test_b3_matches_plain_on_long_series(cuda, nb, n, kind):
    packed = to_device(_packed(9, n, nb), cuda)
    assert packed[0].shape[1] == nb
    steps = torch.arange(0, n * 10_000, 60_000, dtype=torch.int32,
                         device=cuda)
    got = _b3_both(packed, steps, 300_000, kind)
    assert torch.isfinite(got[:9, 10:-10]).float().mean() > 0.9


def _limit(lib, entry):
    from filodb_tpu_torch import _build

    return _build.constant(lib, f"{entry}_max_in_flight")


def _edge_steps(case, limit=None):
    """(steps, window) of one edge case over series of about 30 to 40
    minutes (300 samples at 8-12 s)."""
    if case == "one_step":
        return np.array([1_500_000]), 300_000
    if case == "window_wider_than_series":
        return np.arange(0, 4_000_000, 60_000), 100_000_000
    if case == "steps_outside_the_series":
        return np.arange(-3_000_000, 9_000_000, 120_000), 300_000
    if case == "window_below_scrape_interval":
        return np.arange(0, 4_000_000, 30_000), 5_000
    if case == "more_than_32_in_flight":
        return np.arange(0, 4_000_000, 7_000), 300_000
    if case == "11000_steps_any_window":
        return np.arange(0, 11_000) * 300, 2_000_000_000
    # the largest number of steps in flight the kernel takes, and one more
    k = limit if case == "most_in_flight" else limit + 1
    return np.arange(k) * 250, k * 250


EDGES = ("one_step", "window_wider_than_series", "steps_outside_the_series",
         "window_below_scrape_interval", "more_than_32_in_flight",
         "11000_steps_any_window", "most_in_flight")


@pytest.mark.parametrize("case", EDGES)
@pytest.mark.parametrize("kind", ["rate", "increase"])
def test_b3_edge_cases(cuda, case, kind):
    packed = to_device(_packed(5, 300, 11), cuda)
    steps, w = _edge_steps(case, _limit("fused_rate", "fused_decode_rate"))
    steps = torch.from_numpy(steps.astype(np.int32)).to(cuda)
    assert ck.steps_in_flight(steps, w) <= steps.numel()
    got = _b3_both(packed, steps, w, kind)
    if case == "window_below_scrape_interval":
        assert torch.isnan(got).all()
    if case == "steps_outside_the_series":
        assert torch.isnan(got[:5, :5]).all() and torch.isnan(
            got[:5, -5:]).all()


@pytest.mark.parametrize("reset_at", [[128], [400], [128, 400, 528]])
def test_b3_reset_on_a_blocks_first_lane(cuda, reset_at):
    # the previous valid sample of lane 0 is carried from the block before
    packed = to_device(_packed(6, 900, 5, reset_at=reset_at), cuda)
    steps = torch.arange(0, 9_000_000, 20_000, dtype=torch.int32,
                         device=cuda)
    for kind in ("rate", "increase", "delta"):
        _b3_both(packed, steps, 300_000, kind)


# NaN samples at block lanes: chunks of 400 give blocks of samples 0-127,
# 128-255, 256-383, 384-399, then 400-527, ...
NAN_CASES = {
    "lane_0": [0, 128, 400],
    "lane_127": [127, 255, 527],
    "whole_block": list(range(128, 256)),
    "across_a_block_edge": list(range(124, 133)) + list(range(396, 404)),
    "a_partial_block": list(range(384, 400)),
    "runs_of_stale_markers": list(range(30, 36)) + list(range(600, 604)),
    "every_sample": list(range(900)),
}


@pytest.mark.parametrize("case", NAN_CASES)
def test_b3_drops_nan_samples_as_its_plain_version(cuda, case):
    """NaN samples are gaps in B3 as in ``decode_packed``: the window's
    count, first and last samples and the counter correction skip them."""
    packed = to_device(_packed(6, 900, 3, reset_at=[130, 401],
                               nan_at=NAN_CASES[case]), cuda)
    steps = torch.arange(0, 9_000_000, 20_000, dtype=torch.int32,
                         device=cuda)
    for kind in ("rate", "increase", "delta"):
        got = _b3_both(packed, steps, 300_000, kind)
        if case == "every_sample":
            assert torch.isnan(got[0::2]).all()
            assert torch.isfinite(got[1:6:2]).any()


def test_stale_markers_on_card_equal_cpu(cuda):
    """Every family of query over series with runs of NaN samples answers
    the same on the card as on the CPU."""
    rng = np.random.default_rng(3)
    n, T = 200, 720
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
    for i in range(0, n, 2):
        a = int(rng.integers(0, T - 6))
        vals[i, a : a + int(rng.integers(3, 7))] = np.nan
    labels = [{"_metric_": "m", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store = MemStore(4, 1, 400)
    store.ingest_series(labels, ts, vals)
    gpu, cpu = QueryService(store, cuda), QueryService(store, "cpu")
    for q in ("sum(rate(m[5m])) by (_ns_)", "delta(m[5m])", "m",
              "max(sum_over_time(m[2m])) by (job)", "changes(m[5m])",
              "avg(avg_over_time(m[5m]))", "count(count_over_time(m[1m]))",
              "max_over_time(m[5m])", "irate(m[5m])", "deriv(m[5m])"):
        a = gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        b = cpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        assert [str(k) for k in a.result.keys] == \
            [str(k) for k in b.result.keys]
        np.testing.assert_allclose(a.result.values, b.result.values,
                                   rtol=2e-5, atol=1e-6, equal_nan=True)


def test_b3_delta_on_gauges(cuda):
    packed = to_device(_packed(7, 900, 6, gauge=True), cuda)
    steps = torch.arange(0, 9_000_000, 60_000, dtype=torch.int32,
                         device=cuda)
    got = _b3_both(packed, steps, 300_000, "delta", counter=False)
    assert (got[torch.isfinite(got)] < 0).any()


def test_b3_raises_past_steps_in_flight(cuda):
    packed = to_device(_packed(2, 300, 0), cuda)
    steps, w = _edge_steps("past",
                           _limit("fused_rate", "fused_decode_rate"))
    steps = torch.from_numpy(steps.astype(np.int32)).to(cuda)
    with pytest.raises(ValueError, match="limit"):
        ck.fused_decode_rate(packed, steps, w)
    with pytest.raises(ValueError, match="non-decreasing"):
        ck.fused_decode_rate(packed, steps.flip(0).contiguous(), 300_000)


def _sum_rows(P, S, seed, span=15_000):
    rng = np.random.default_rng(seed)
    ts = np.full((P, S), ck.TS_PAD, np.int32)
    vals = np.zeros((P, S), np.float32)
    for p in range(P):
        k = int(rng.integers(1, S))
        ts[p, :k] = np.cumsum(rng.integers(5_000, span, k))
        vals[p, :k] = rng.normal(50, 10, k)
        hole = rng.choice(k, k // 4, replace=False)
        ts[p, hole], vals[p, hole] = ck.TS_PAD, 0.0
    return torch.from_numpy(ts), torch.from_numpy(vals)


def _b4_both(cuda, t, v, steps, window):
    want = ck.windowed_sum(t, v, steps, window)
    got = ck.windowed_sum(t.to(cuda), v.to(cuda), steps.to(cuda),
                          window).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("S", [1024, 1000, 32768])
def test_b4_bitwise_equal_to_plain(cuda, S):
    # S = 1000 is not a multiple of 4: rows stream without 16-byte copies
    P = 300 if S < 32768 else 40
    t, v = _sum_rows(P, S, S, span=15_000 if S < 32768 else 11_000)
    steps = torch.arange(0, int(t[t < ck.TS_PAD].max()) + 600_000, 60_000,
                         dtype=torch.int32)
    _b4_both(cuda, t, v, steps, 300_000)


@pytest.mark.parametrize("case", EDGES)
def test_b4_edge_cases(cuda, case):
    t, v = _sum_rows(6, 384, 4, span=12_000)
    steps, w = _edge_steps(case, _limit("windowed_sum", "windowed_sum"))
    steps = torch.from_numpy(steps.astype(np.int32))
    got = _b4_both(cuda, t, v, steps, w)
    if case == "steps_outside_the_series":
        assert (got[:, :5] == 0.0).all() and (got[:, -5:] == 0.0).all()


def test_b4_raises_past_steps_in_flight(cuda):
    t, v = _sum_rows(2, 256, 1)
    steps, w = _edge_steps("past", _limit("windowed_sum", "windowed_sum"))
    steps = torch.from_numpy(steps.astype(np.int32)).to(cuda)
    with pytest.raises(ValueError, match="limit"):
        ck.windowed_sum(t.to(cuda), v.to(cuda), steps, w)


def test_query_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(1)
    n, T = 300, 720
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
    labels = [{"_metric_": "m", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store = MemStore(4, 1, 400)
    store.ingest_series(labels, ts, vals)
    gpu, cpu = QueryService(store, cuda), QueryService(store, "cpu")
    for q in ("sum(rate(m[5m])) by (_ns_)", "delta(m[5m])",
              "max(sum_over_time(m[2m])) by (job)",
              "avg(avg_over_time(m[5m]))", "count(count_over_time(m[1m]))"):
        a = gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        b = cpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        assert [str(k) for k in a.result.keys] == \
            [str(k) for k in b.result.keys]
        np.testing.assert_allclose(a.result.values, b.result.values,
                                   rtol=2e-5, atol=1e-6, equal_nan=True)


def _bucket_blocks(P, B, NB, seed):
    """Histogram batch arrays as ``pack_hist_blocks`` lays them out, with
    random words: bucket blocks [P, B, NB] cycling through every width
    0..32, int64 bases past 2^32, random slopes; timestamp blocks of width
    12 on a 10 s line; block counts 0..128."""
    rng = np.random.default_rng(seed)
    i = np.arange(P * B * NB).reshape(P, B, NB)
    words = rng.integers(0, 2**32, (P, B, NB, 128), dtype=np.uint64)
    ts_words = rng.integers(0, 2**12, (P, NB, 128), dtype=np.uint64)
    arrays = (
        rng.integers(0, 10_000_000, (P, NB)).astype(np.int32),
        np.full((P, NB), 10_000, np.int32), np.full((P, NB), 12, np.int32),
        ts_words.astype(np.uint32),
        rng.integers(2**33, 2**40, (P, B, NB)),
        rng.integers(-2**20, 2**20, (P, B, NB)).astype(np.int32),
        (i % 33).astype(np.int32), words.astype(np.uint32),
        rng.integers(0, 129, (P, NB)).astype(np.int32))
    return to_device(arrays, torch.device("cpu"))


@pytest.mark.parametrize("P,B,NB", [(3, 1, 8), (37, 11, 8), (1001, 12, 4),
                                    (129, 63, 2)])
def test_b1_on_bucket_blocks_bitwise_equal_to_plain(cuda, P, B, NB):
    """``assemble_hist`` on the card (B1 on the timestamp blocks, then on
    all P·B·NB bucket blocks in one launch) equals its plain version on
    the CPU bit for bit: ts, float64 counts and validity."""
    from filodb_tpu_torch import _build

    cta = _build.constant("decode_pages", "decode_pages_blocks_per_cta")
    assert (P * B * NB) % cta
    packed = _bucket_blocks(P, B, NB, P * B)
    want = assemble_hist(packed, 2**31 - 1)
    got = assemble_hist(tuple(t.to(cuda) for t in packed), 2**31 - 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_histogram_queries_on_card_equal_cpu(cuda):
    rng = np.random.default_rng(2)
    n, T, les = 200, 720, np.array([0.1, 0.5, 1.0, 5.0, np.inf])
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    counts = np.cumsum(np.cumsum(rng.integers(0, 4, (n, T, len(les))),
                                 axis=2), axis=1)
    labels = [{"_metric_": "h", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store = MemStore(4, 1, 400)
    store.ingest_histograms(labels, ts, counts, les)
    gpu, cpu = QueryService(store, cuda), QueryService(store, "cpu")
    for q in ("histogram_quantile(0.9, sum(rate(h[5m])) by (_ns_))",
              "sum(increase(h[10m])) by (job)", "max_over_time(h[5m])",
              "h", "histogram_quantile(0.5, rate(h[5m]))"):
        a = gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        b = cpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        assert [str(k) for k in a.result.keys] == \
            [str(k) for k in b.result.keys]
        np.testing.assert_allclose(a.result.values, b.result.values,
                                   rtol=1e-9, atol=0, equal_nan=True)
