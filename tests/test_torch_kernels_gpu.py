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


def _counter_store(store, n=300, T=720, seed=1):
    rng = np.random.default_rng(seed)
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
    labels = [{"_metric_": "m", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store.ingest_series(labels, ts, vals)
    return store


def test_paged_back_shells_on_card_equal_their_plain_version(cuda,
                                                             tmp_path):
    """Whole partitions evicted (paged shells): a query pages their chunks
    back and B1-B4 serve them as before the eviction, and as the plain
    versions on the CPU."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.testing.from_jax import open_local

    store = _counter_store(open_local(str(tmp_path), num_shards=4,
                                      spread=1))
    store.flush_all()
    gpu, cpu = QueryService(store, cuda), QueryService(store, "cpu")
    qs = ("sum(rate(m[5m])) by (_ns_)", "count(count_over_time(m[1m]))")
    before = [gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
              for q in qs]
    assert sum(sh.evict_cold_partitions(10**9) for sh in store.shards) \
        == 300
    _build.reset_counts()
    for q, b in zip(qs, before):
        a = gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        c = cpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        np.testing.assert_array_equal(a.result.values, b.result.values)
        np.testing.assert_allclose(a.result.values, c.result.values,
                                   rtol=2e-5, atol=1e-6, equal_nan=True)
    assert all(_build.LAUNCHES.values())
    store.close()


def test_sidecar_lane_on_card_equals_cpu(cuda, monkeypatch):
    """The sidecar lane's folds on the card (its edge chunks decoded by
    B1/B2, its write buffers folded on the host) against the same lane on
    the CPU."""
    from filodb_tpu_torch.query.engine import sidecar_lane

    store = _counter_store(MemStore(4, 1, 400))
    monkeypatch.setenv("FILODB_SIDECARS", "1")
    monkeypatch.setenv("FILODB_SIDECAR_SEALED_GATE", "0")  # always fold
    gpu = QueryService(store, cuda, engine="exec")
    cpu = QueryService(store, "cpu", engine="exec")
    for q in ("sum(rate(m[5m])) by (_ns_)", "count_over_time(m[30m])",
              "max_over_time(m[1h])", "changes(m[10m])", "m"):
        for start in (1_600_007_200, 1_600_003_600):
            served = sidecar_lane.SIDECAR_SERVED.value
            a = gpu.query_range(q, start, 60, 1_600_007_200)
            assert sidecar_lane.SIDECAR_SERVED.value > served
            b = cpu.query_range(q, start, 60, 1_600_007_200)
            assert [str(k) for k in a.result.keys] == \
                [str(k) for k in b.result.keys]
            np.testing.assert_allclose(a.result.values, b.result.values,
                                       rtol=2e-5, atol=1e-9,
                                       equal_nan=True)


def test_host_lane_on_card_equals_cpu(cuda):
    """Values float32 does not hold (byte counters past 2^24, load
    averages with two decimals) take the host-decode lane, on the card as
    on the CPU, on both engines, and launch no B3."""
    from filodb_tpu_torch import _build

    rng = np.random.default_rng(3)
    n, T = 300, 720
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    labels = [{"_metric_": "bytes", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store = MemStore(4, 1, 400)
    store.ingest_series(labels, ts, (rng.integers(10**9, 10**12, (n, 1))
                        + np.cumsum(rng.integers(0, 10**6, (n, T)), 1)
                        ).astype(float))
    store.ingest_series([{**lb, "_metric_": "load"} for lb in labels], ts,
                        np.abs(np.cumsum(rng.integers(-50, 51, (n, T)), 1))
                        / 100.0, schema="gauge")
    for engine in ("mesh", "exec"):
        gpu = QueryService(store, cuda, engine=engine)
        cpu = QueryService(store, "cpu", engine=engine)
        _build.reset_counts()
        for q in ("sum(rate(bytes[5m])) by (_ns_)", "irate(bytes[5m])",
                  "sum(idelta(load[5m])) by (job)", "deriv(load[10m])",
                  "stddev_over_time(load[5m])", "changes(load[5m])"):
            a = gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
            b = cpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
            assert a.stats.host_lane and b.stats.host_lane, q
            assert [str(k) for k in a.result.keys] == \
                [str(k) for k in b.result.keys]
            np.testing.assert_allclose(a.result.values, b.result.values,
                                       rtol=2e-5, atol=1e-6, equal_nan=True,
                                       err_msg=f"{q} {engine}")
        assert _build.LAUNCHES["fused_decode_rate"] == 0


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


def _restarted_store(root, hist: bool = False):
    """Series (counters, or 5-bucket histograms) flushed to a local-disk
    store, which is then reopened index-only: a query pages every chunk
    back in from disk (``core/memstore/odp.py``)."""
    from filodb_tpu_torch.core.store.localstore import (
        LocalDiskColumnStore,
        LocalDiskMetaStore,
    )

    def opened():
        return MemStore(4, 1, 400, column_store=LocalDiskColumnStore(root),
                        meta_store=LocalDiskMetaStore(root))

    rng = np.random.default_rng(5)
    n, T = 150, 720
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    labels = [{"_metric_": "m", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store = opened()
    if hist:
        counts = np.cumsum(np.cumsum(rng.integers(0, 4, (n, T, 5)), axis=2),
                           axis=1)
        store.ingest_histograms(labels, ts, counts,
                                np.array([0.1, 0.5, 1.0, 5.0, np.inf]))
    else:
        vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
        vals[::9, 300:] -= vals[::9, 300:301]
        vals[::11, 100:104] = np.nan
        store.ingest_series(labels, ts, vals)
    store.flush_all()
    store.close()
    again = opened()
    for s in range(4):
        again.recover_index(s)
    return again


def _paged_batch(store, cuda):
    from filodb_tpu_torch.query.engine.device_batch import build_device_batch

    lo, hi = 1_600_000_000_000, 1_600_007_200_000
    batch = build_device_batch(
        [(sh, sh.lookup_partitions([], lo, hi)) for sh in store.shards], lo,
        hi, cuda)
    assert sum(sh.odp_cache.chunks_paged for sh in store.shards) == 300
    return batch


def test_b1_b2_b3_on_paged_chunks_equal_plain(cuda, tmp_path):
    """The blocks of chunks paged in from disk after a restart: B1 and B2
    bitwise equal to their plain versions, B3 within ``_b3_both``'s
    tolerance."""
    from filodb_tpu_torch.query.engine.device_batch import decode_packed

    batch = _paged_batch(_restarted_store(str(tmp_path)), cuda)
    got = decode_packed(batch.packed)
    want = decode_packed(tuple(t.cpu() for t in batch.packed), plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32) if g.is_floating_point()
                           else g.cpu(),
                           w.view(torch.int32) if w.is_floating_point()
                           else w)
    steps = torch.arange(300_000, 7_200_000, 60_000, dtype=torch.int32,
                         device=cuda)
    _b3_both(batch.packed, steps, 300_000)


def test_b1_on_paged_histogram_chunks_equal_plain(cuda, tmp_path):
    batch = _paged_batch(_restarted_store(str(tmp_path), hist=True), cuda)
    got = assemble_hist(batch.packed, 7_200_000)
    want = assemble_hist(tuple(t.cpu() for t in batch.packed), 7_200_000,
                         plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_restarted_store_on_card_equals_cpu(cuda, tmp_path):
    store = _restarted_store(str(tmp_path))
    for engine in ("mesh", "exec"):
        gpu = QueryService(store, cuda, engine=engine)
        cpu = QueryService(store, "cpu", engine=engine)
        for q in ("sum(rate(m[5m])) by (_ns_)",
                  "sum(count_over_time(m[5m])) by (job)"):
            a = gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
            b = cpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
            assert [str(k) for k in a.result.keys] == \
                [str(k) for k in b.result.keys]
            np.testing.assert_allclose(a.result.values, b.result.values,
                                       rtol=2e-5, atol=1e-6, equal_nan=True)


def test_server_on_card_answers_as_its_query_service(cuda, tmp_path):
    """A ``FiloServer`` on the card, fed through its gateway, answers one
    query a kernel path (B3; B1/B2 with B4; B1/B2 with a float64
    function) through the HTTP API with the bytes its ``QueryService``
    renders on the card."""
    import json
    import socket
    import time
    import urllib.parse
    import urllib.request

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.http.promjson import matrix_json_str
    from filodb_tpu_torch.standalone import FiloServer
    from filodb_tpu_torch.testing.from_jax import boot

    conf = {"datasets": {"timeseries": {
        "num_shards": 4, "spread": 1,
        "store": {"max_chunk_size": 400, "groups_per_shard": 4}}}}
    srv = boot(FiloServer, ServerConfig, conf, str(tmp_path), device=cuda)
    try:
        rng = np.random.default_rng(3)
        n, T, t0 = 64, 500, 1_600_000_000
        vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1)
        with socket.create_connection(("127.0.0.1", srv.gateway.port)) as s:
            s.sendall("".join(
                f"m,_ws_=w,_ns_=ns-{i % 5},instance=i-{i},job=j-{i % 3} "
                f"counter={vals[i, t]} {(t0 + 10 * t) * 10**9}\n"
                for t in range(T) for i in range(n)).encode())
        svc = srv.services["timeseries"]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            srv.gateway.sink.flush()
            got = svc.query_range("sum(count_over_time(m[1d]))", t0 + 5000,
                                  60, t0 + 5000).result
            if got.num_series and got.values[0, -1] == n * T:
                break
            time.sleep(0.2)
        assert got.values[0, -1] == n * T
        _build.reset_counts()
        for q in ("sum(rate(m[5m])) by (_ns_)",
                  "sum(count_over_time(m[5m])) by (job)",
                  "max(max_over_time(m[5m])) by (_ns_)"):
            args = dict(query=q, start=t0 + 600, end=t0 + 10 * T, step=60)
            url = (f"http://127.0.0.1:{srv.http.port}/promql/timeseries/api"
                   f"/v1/query_range?" + urllib.parse.urlencode(args))
            with urllib.request.urlopen(url, timeout=120) as r:
                body = r.read().decode()
            want = matrix_json_str(svc.query_range(q, t0 + 600, 60,
                                                   t0 + 10 * T))
            cut = ',"queryStats"'
            assert body[:body.index(cut)] == want[:want.index(cut)], q
            assert json.loads(body)["data"]["result"], q
        assert all(v > 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    finally:
        srv.shutdown()


def test_execute_many_shares_a_batch_and_launches_once_a_grid(cuda):
    """``execute_many`` over one shared batch a leaf signature equals each
    plan's own ``execute`` (rate bit for bit; sum_over_time within rtol
    2e-5), and B3 and B4 launch as often as one evaluation of a distinct
    grid launches them: members of equal grids share one evaluation."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.model import QueryStats

    store = _counter_store(MemStore(4, 1, 400))
    svc = QueryService(store, cuda)
    t0 = 1_600_000_000
    grids = [(t0 + 600 + 60 * s, 60, t0 + 6600 + 60 * s) for s in range(3)]
    qs = [("sum(rate(m[5m])) by (_ns_)", g) for g in grids + grids] \
        + [("sum_over_time(m[2m])", g) for g in grids[:2] * 2]
    plans = [parse_query(q, TimeStepParams(*g)) for q, g in qs]
    one = {}
    for i in (0, 6):  # one evaluation of each shape, on its own
        _build.reset_counts()
        QueryService(store, cuda).mesh.execute(store, plans[i],
                                               QueryStats())
        one[qs[i][0]] = dict(_build.LAUNCHES)
    _build.reset_counts()
    got = svc.mesh.execute_many(store, plans, [QueryStats() for _ in plans])
    launches = dict(_build.LAUNCHES)
    rate, over = one[qs[0][0]], one[qs[6][0]]
    assert rate["fused_decode_rate"] == 1 and over["windowed_sum"] > 0
    assert launches["fused_decode_rate"] == 3 * rate["fused_decode_rate"]
    assert launches["windowed_sum"] == 2 * over["windowed_sum"]
    assert len(svc.batches.batches("mesh")) == 2
    for (q, _), plan, m in zip(qs, plans, got):
        want = svc.mesh.execute(store, plan, QueryStats()).materialize()
        m.materialize()
        assert [str(k) for k in m.keys] == [str(k) for k in want.keys]
        if "rate" in q:
            assert np.array_equal(m.values, want.values, equal_nan=True)
        else:
            np.testing.assert_allclose(m.values, want.values, rtol=2e-5,
                                       atol=1e-6, equal_nan=True)


WINDOW_QUERIES = ("sum(rate(m[5m])) by (_ns_)", "increase(m[5m])",
                  "sum(count_over_time(m[5m])) by (job)",
                  "avg(avg_over_time(m[5m]))", "max(m) by (job)")


def test_window_cache_on_card_is_bitwise_the_valve_off(cuda, monkeypatch):
    """A warm query served from the window cache launches no B3 or B4
    and answers bit for bit as the first query and as a service with
    ``FILODB_MESH_SPLIT=0``; the cache's bytes stay within the batch
    cache's budget."""
    from filodb_tpu_torch import _build

    store = _counter_store(MemStore(4, 1, 400))
    svc = QueryService(store, cuda)
    t0 = 1_600_000_000
    for q in WINDOW_QUERIES:
        cold = svc.query_range(q, t0 + 600, 60, t0 + 7200)
        _build.reset_counts()
        warm = svc.query_range(q, t0 + 600, 60, t0 + 7200)
        assert _build.LAUNCHES["fused_decode_rate"] == 0, q
        assert _build.LAUNCHES["windowed_sum"] == 0, q
        monkeypatch.setenv("FILODB_MESH_SPLIT", "0")
        off = QueryService(store, cuda).query_range(q, t0 + 600, 60,
                                                    t0 + 7200)
        monkeypatch.delenv("FILODB_MESH_SPLIT")
        for got in (warm, off):
            assert [str(k) for k in got.result.keys] == \
                [str(k) for k in cold.result.keys]
            assert np.array_equal(got.result.values, cold.result.values,
                                  equal_nan=True), q
    entries, nbytes = svc.mesh.window_cache
    assert entries == len(WINDOW_QUERIES) and nbytes > 0
    assert svc.batches.nbytes() <= svc.batches.budget


def test_adaptive_lanes_on_card_answer_as_mesh(cuda):
    """``engine="adaptive"`` on the card builds its host lane (the plain
    versions on the CPU) and routes between it and the card: every
    answer equals mesh's, within the plain versions' tolerance."""
    store = _counter_store(MemStore(4, 1, 400))
    svc = QueryService(store, cuda, engine="adaptive")
    mesh = QueryService(store, cuda)
    t0 = 1_600_000_000
    qs = [("sum(rate(m[5m])) by (_ns_)", t0 + 600 + 60 * i, 60, t0 + 7200)
          for i in range(4)]
    for batch in ([qs[0]], qs, [qs[1]], qs):
        got = svc.query_range_many(batch)
        want = mesh.query_range_many(batch)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.result.values, w.result.values,
                                       rtol=2e-5, atol=1e-6, equal_nan=True)
    svc.mesh.drain()
    assert svc.mesh._host() is not None
    assert sum(svc.mesh.routed.values()) == 4
    assert sum(svc.mesh.shadowed.values()) >= 1
    assert svc.mesh.sync_floor_s is not None


def test_three_tier_query_on_card_equals_cpu(cuda, tmp_path):
    """A query across the downsample tier, cold raw chunks and the
    memstore (the job's ds chunks, the raw chunks paged in from the local
    store), on the card against the same planners with device="cpu";
    B1-B4 launch on the colder tiers' data."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.coordinator.tiered_planner import (
        build_tiered_planner,
    )
    from filodb_tpu_torch.core.downsample import (
        DownsampledTimeSeriesStore,
        DownsamplerJob,
    )
    from filodb_tpu_torch.testing.from_jax import open_local

    store = open_local(str(tmp_path), 4, 1)
    rng = np.random.default_rng(3)
    n, T = 200, 2160
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    counters = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
    gauges = np.round(rng.normal(50, 10, (n, T)))
    for metric, vals, schema in (("m", counters, "prom-counter"),
                                 ("g", gauges, "gauge")):
        labels = [{"_metric_": metric, "_ws_": "w", "_ns_": f"ns-{i % 7}",
                   "instance": f"i-{i}", "job": f"j-{i % 3}"}
                  for i in range(n)]
        store.ingest_series(labels, ts, vals, schema=schema)
    store.flush_all(1_000)
    DownsamplerJob(store.column_store, store.dataset, 4,
                   meta_store=store.meta_store).catch_up(2_000)
    now = 1_600_000_000_000 + T * 10_000

    def planner():
        ds = SingleClusterPlanner(4, 1, store=DownsampledTimeSeriesStore(
            store.column_store, store.dataset, 300_000, 4))
        return build_tiered_planner(
            SingleClusterPlanner(4, 1), store.column_store, store.dataset,
            4, 1, mem_retention_ms=3_600_000, raw_retention_ms=7_200_000,
            ds_planner=ds, now_ms=lambda: now)

    gpu, cpu = QueryService(store, cuda), QueryService(store, "cpu")
    gpu.planner, cpu.planner = planner(), planner()
    _build.reset_counts()
    end = now // 1000
    for q in ("sum(rate(m[15m])) by (_ns_)",
              "sum(count_over_time(g[15m])) by (job)",
              "avg(avg_over_time(g[15m]))", "max(max_over_time(g[15m]))"):
        a = gpu.query_range(q, end - 6 * 3600, 60, end)
        b = cpu.query_range(q, end - 6 * 3600, 60, end)
        assert set(a.stats.tiers) == {"memstore", "objectstore",
                                      "downsample"}
        assert [str(k) for k in a.result.keys] == \
            [str(k) for k in b.result.keys]
        np.testing.assert_allclose(a.result.values, b.result.values,
                                   rtol=2e-5, atol=1e-6, equal_nan=True)
    assert all(_build.LAUNCHES.values()), _build.LAUNCHES


def test_pyramid_lane_on_card_equals_cpu(cuda, tmp_path):
    """Cold-tier queries over an object store through the pyramid lane on
    the card against the same planner with device="cpu": the edge chunks
    decode by B1/B2 on the card, the answers agree, and modes 1 and decode
    agree bit for bit on the card."""
    import os

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.coordinator.tiered_planner import (
        build_tiered_planner,
    )
    from filodb_tpu_torch.core.store.objectstore import (
        ObjectStoreColumnStore,
        open_object_store,
    )
    from filodb_tpu_torch.testing.fake_s3 import FakeS3

    root = str(tmp_path / "bucket")
    cs, meta = open_object_store({"endpoint": root}, str(tmp_path))
    store = MemStore(4, 1, column_store=cs, meta_store=meta)
    rng = np.random.default_rng(4)
    n, T = 200, 2160
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    counters = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
    labels = [{"_metric_": "m", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store.ingest_series(labels, ts, counters)
    store.flush_all(1_000)
    cs.flush()
    now = 1_600_000_000_000 + T * 10_000

    def planner():
        return build_tiered_planner(
            SingleClusterPlanner(4, 1), ObjectStoreColumnStore(
                FakeS3(root=root)), store.dataset, 4, 1,
            mem_retention_ms=3_600_000, now_ms=lambda: now)

    gpu, cpu = QueryService(store, cuda), QueryService(store, "cpu")
    gpu.planner, cpu.planner = planner(), planner()
    end = now // 1000
    for q, a, step, b in (
            ("max_over_time(m[3h])", end - 3 * 3600, 900, end - 3600),
            ("sum(rate(m[15m])) by (_ns_)", end - 6 * 3600, 60, end),
            ("avg_over_time(m[40m])", end - 5 * 3600, 700, end - 3600)):
        _build.reset_counts()
        x = gpu.query_range(q, a, step, b)
        assert x.stats.pyramid and not x.stats.sidecar_bypassed.get(
            "values float32 does not hold")
        assert _build.LAUNCHES["decode_ts_page"] \
            and _build.LAUNCHES["decode_f32_page"]
        y = cpu.query_range(q, a, step, b)
        assert x.result.keys == y.result.keys
        np.testing.assert_allclose(np.asarray(x.result.values),
                                   np.asarray(y.result.values), rtol=2e-5,
                                   atol=1e-6, equal_nan=True, err_msg=q)
        outs = []
        for mode in ("1", "decode"):
            os.environ["FILODB_SIDECARS"] = mode
            try:
                gpu.planner = planner()
                outs.append(np.asarray(gpu.query_range(q, a, step,
                                                       b).result.values))
            finally:
                del os.environ["FILODB_SIDECARS"]
        assert outs[0].tobytes() == outs[1].tobytes(), q
    cs.close()


def test_rule_ticks_on_card_equal_cpu(cuda):
    """A 60 s group and a 10 s group ticked by a ``RuleManager`` on the card
    and by one on the CPU over twin stores: the fresh-start ticks (one step:
    the sidecar lane, B1/B2 on the edge chunks) and a catch-up of 12 steps
    (mesh: B3 and B4) write the same series, within the reference's rule
    tolerance, and the same watermarks and alert states."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.rules import (
        AlertingRule,
        MemstoreSink,
        RecordingRule,
        RuleGroup,
        RuleManager,
    )

    rng = np.random.default_rng(5)
    n, T = 400, 360
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    counters = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
    labels = [{"_metric_": "m", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    groups = [
        RuleGroup("g60", 60_000, "timeseries", (
            RecordingRule("ns:m:rate5m", "sum(rate(m[5m])) by (_ns_)"),
            AlertingRule("Busy", "sum(rate(m[5m])) by (_ns_) > 1.9",
                         for_ms=60_000))),
        RuleGroup("g10", 10_000, "timeseries", (
            RecordingRule("job:m:sum1m", "sum(sum_over_time(m[1m])) by (job)"),
        ))]
    sides = {}
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        store = MemStore(4, 1, max_chunk_size=100)
        store.ingest_series(labels, ts[:, :240], counters[:, :240])
        svc = QueryService(store, dev)
        mgr = RuleManager(svc, MemstoreSink(store, "timeseries", 4, 1),
                          groups, ooo_allowance_ms=0)
        _build.reset_counts()
        fresh = mgr.tick()
        store.ingest_series(labels, ts[:, 240:], counters[:, 240:])
        catch_up = mgr.tick()
        sides[name] = (svc, mgr, fresh, catch_up, dict(_build.LAUNCHES))
    (gsvc, gmgr, gf, gc, launches), (csvc, cmgr, cf, cc, _) = \
        sides["card"], sides["cpu"]
    assert (gf, gc) == (cf, cc) and gc > 12
    assert all(launches.values()), launches
    for g in groups:
        assert gmgr._state[g.name].last_step == cmgr._state[g.name].last_step
    assert [(a["labels"], a["state"]) for a in gmgr.alerts_snapshot()] == \
        [(a["labels"], a["state"]) for a in cmgr.alerts_snapshot()]
    end = gmgr._state["g10"].last_step // 1000
    for rec in ("ns:m:rate5m", "job:m:sum1m", "ALERTS"):
        x = gsvc.query_range(rec, end - 3600, 10, end)
        y = csvc.query_range(rec, end - 3600, 10, end)
        assert x.result.keys == y.result.keys and x.result.num_series
        np.testing.assert_allclose(np.asarray(x.result.values),
                                   np.asarray(y.result.values), rtol=2e-5,
                                   atol=1e-9, equal_nan=True, err_msg=rec)


def test_multiproc_on_card_equals_cpu(cuda):
    """Two mesh worker processes on the card under a runtime on the card,
    and two on the CPU under one on the CPU, over the seeded harness store:
    the card's answers are bitwise the card's single-process engine's and
    agree with the CPU's within the mesh tolerance, and the card workers
    launched B3 (rate) and B1/B2/B4 (sum_over_time)."""
    from filodb_tpu_torch.coordinator.mesh_cluster import MeshClusterRuntime
    from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
    from filodb_tpu_torch.parallel.multiproc import MeshWorkerSupervisor
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.model import QueryStats
    from filodb_tpu_torch.testing import mesh_store

    start = mesh_store.START_MS // 1000
    params = TimeStepParams(start + 600, 60, start + 1500)
    queries = ["sum(rate(http_requests_total[10m]))",
               "sum by (job) (rate(http_requests_total[5m]))",
               "avg(rate(http_requests_total[10m]))",
               "sum(sum_over_time(http_requests_total[5m])) by (job)"]
    answers = {}
    for name, dev in (("card", None), ("cpu", "cpu")):
        store = mesh_store.build_store()
        sup = MeshWorkerSupervisor(
            mesh_store.DATASET, mesh_store.NUM_SHARDS, 2,
            seed="filodb_tpu_torch.testing.mesh_store:build_store",
            device=dev).spawn()
        try:
            sup.wait_ready(timeout_s=300)
            rt = MeshClusterRuntime(store, mesh_store.DATASET,
                                    mesh_store.NUM_SHARDS, sup.slices,
                                    device=dev)
            got = [rt.execute_plan(parse_query(q, params)) for q in queries]
            assert all(g is not None for g in got), name
            answers[name] = [g.materialize() for g in got]
            single = MeshQueryEngine(rt.device)
            for q, g in zip(queries, answers[name]):
                want = single.execute(store, parse_query(q, params),
                                      QueryStats()).materialize()
                assert g.keys == want.keys
                assert g.values.tobytes() == want.values.tobytes(), q
            launches = [w["launches"] for w in rt.status()["workers"]]
            rt.shutdown()
        finally:
            sup.stop()
        if name == "card":
            total = {k: sum(lc[k] for lc in launches) for k in launches[0]}
            assert all(total.values()), total
    for g, c in zip(answers["card"], answers["cpu"]):
        assert g.keys == c.keys and g.num_series
        np.testing.assert_allclose(g.values, c.values, rtol=2e-5, atol=1e-6,
                                   equal_nan=True)


def test_every_kernel_launches_on_its_inputs_card():
    """B1, B2, B3 and B4 on ``cuda:1``, with ``cuda:0`` current, give what
    they give on ``cuda:0``, bit for bit: each wrapper enters its input's
    device around the launch (the launch and B3 / B4's
    ``cudaFuncSetAttribute`` act on the current device)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    slopes, widths, shifts, firsts, words = _blocks(4099, 7)
    packed = _packed(37, 720, 720)
    t, v = _sum_rows(300, 1000, 3)
    steps = torch.arange(60_000, 720 * 12_000, 60_000, dtype=torch.int32)
    with torch.cuda.device(d0):
        out = {}
        for dev in (d0, d1):
            out[dev] = (
                dp.decode_ts_blocks(slopes.to(dev), widths.to(dev),
                                    words.to(dev)),
                dp.decode_f32_blocks(firsts.to(dev), shifts.to(dev),
                                     widths.to(dev), words.to(dev)),
                ck.fused_decode_rate(to_device(packed, dev), steps.to(dev),
                                     300_000),
                ck.windowed_sum(t.to(dev), v.to(dev), steps.to(dev),
                                300_000))
            assert all(x.device == dev for x in out[dev])
        for a, b in zip(out[d0], out[d1]):
            assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


def test_mesh_of_repeated_slots_on_the_card_answers_as_one_slot(cuda):
    """Four slots of one card (4×1 and 2×2): every block is launched on
    it; per-series rows equal the one-slot engine's bit for bit on 4×1,
    and an aggregate within rtol 1e-9 (2×2: B3's tolerance against the
    float64 split programs)."""
    from filodb_tpu_torch.parallel.mesh_engine import make_query_mesh

    store = MemStore(4, 1, max_chunk_size=400)
    rng = np.random.default_rng(0)
    ts = 1_600_000_000_000 + np.arange(720) * 10_000
    for i in range(400):
        store.ingest({"_metric_": "http_requests_total", "_ws_": "demo",
                      "_ns_": f"App-{i % 7}", "instance": f"i{i}"}, ts,
                     np.cumsum(rng.integers(0, 20, 720)).astype(float))
    start, end = 1_600_000_000 + 600, 1_600_000_000 + 7000
    one = QueryService(store, device=cuda)
    for layout, dt in (((4, 1), 1), ((2, 2), 2)):
        svc = QueryService(store, mesh=make_query_mesh(
            devices=[cuda] * 4, time_axis=dt))
        for q, agg in (("rate(http_requests_total[5m])", False),
                       ("sum(rate(http_requests_total[5m])) by (_ns_)",
                        True)):
            got = svc.query_range(q, start, 60, end).result.materialize()
            want = one.query_range(q, start, 60, end).result.materialize()
            assert [str(k) for k in got.keys] == [str(k) for k in want.keys]
            if dt > 1:
                np.testing.assert_allclose(got.values, want.values,
                                           rtol=2e-5, atol=1e-6,
                                           equal_nan=True)
            elif agg:
                np.testing.assert_allclose(got.values, want.values,
                                           rtol=1e-9, atol=1e-12,
                                           equal_nan=True)
            else:
                assert got.values.tobytes() == want.values.tobytes()


def test_node_without_a_device_takes_every_visible_card(cuda, tmp_path):
    """``FiloServer`` with no device named runs its mesh engines over a
    ``make_query_mesh()`` of every visible card (1×1 on a host of one);
    ``cuda:0`` named pins them to that card alone."""
    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.standalone import FiloServer
    from filodb_tpu_torch.testing.from_jax import boot

    conf = {"datasets": {"timeseries": {
        "num_shards": 4, "spread": 1,
        "store": {"max_chunk_size": 400, "groups_per_shard": 4}}}}
    for device, slots in ((None, torch.cuda.device_count()), ("cuda:0", 1)):
        srv = boot(FiloServer, ServerConfig, conf,
                   str(tmp_path / str(device)), device=device)
        try:
            eng = srv.services["timeseries"].mesh
            assert len(eng.mesh) == slots and eng.mesh.size(1) == 1
            assert eng.device == torch.device("cuda", 0)
        finally:
            srv.shutdown()
