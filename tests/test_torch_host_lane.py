"""The host-decode lane: values that float32 cannot hold are answered in
float64, as the reference's default lane answers them.

The reference's default store (``StoreConfig(device_pages=False)``) decodes
the codec chunks on the host in float64 (``filodb_tpu/query/engine/
batch.py``); the port's page lane reads float32 device pages. A batch whose
selected values do not survive float64 → float32 → float64 takes the
port's host-decode lane (``filodb_tpu_torch/query/engine/batch.py``): its
float64 values are decoded from the codec chunks (held, read back from the
column store, or paged in) and the write buffers, and the delta family
reads the reference's float64 reset correction and rebase.

The store holds, per series, 200 samples at 10 s in 64-sample chunks, 4
shards, spread 1 (the probe of ROADMAP §C.8): counters from 1e9 with
increments of 1-19 (``big_total``, a reset in one series), gauges at 1e5
with steps of ±0.01 (``g``) and fractional-seconds counters
(``cpu_seconds_total``, increments in hundredths of 0.01-0.5 s). The
reference runs at ``device_pages=False`` with ``FILODB_SIDECARS`` at 0 and
at 1 on exec, and its mesh engine (``test_torch_slice.reference_lanes``);
the port on both engines at both valves, on the CPU. Tolerance: ``rtol=2e-5,
atol=1e-6``, NaN equal; ``build_batch`` and ``delta_host`` are held
bitwise.
"""

import numpy as np
import pytest
import torch

from filodb_tpu.core.store.config import StoreConfig as RefStoreConfig
from filodb_tpu.query.engine.batch import build_batch as ref_build_batch
from test_torch_slice import (
    DS,
    NUM_SHARDS,
    Q_START,
    Q_STEP,
    START_S,
    Valved,
    _build_stores,
    _series_specs,
    _sorted,
    reference_lanes,
)
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.store.api import (
    InMemoryColumnStore,
    NullColumnStore,
)
from filodb_tpu_torch.parallel.mesh_engine import UnsupportedQuery
from filodb_tpu_torch.promql.parser import TimeStepParams
from filodb_tpu_torch.promql.parser import parse_query as port_parse
from filodb_tpu_torch.query.engine.batch import SeriesBatch
from filodb_tpu_torch.query.engine.device_batch import build_device_batch
from filodb_tpu_torch.testing.from_jax import SeriesState, ingest_states

TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
CHUNK = 64
Q_END = START_S + 1900
CPU = torch.device("cpu")


def _probe_specs():
    """(schema, labels, ts, vals) of the three metrics, six series each."""
    rng = np.random.default_rng(23)
    specs = []
    for i in range(6):
        ts = (START_S * 1000 + np.arange(200) * 10_000
              + rng.integers(-500, 501, 200)).astype(np.int64)

        def labels(metric):
            return {"_metric_": metric, "_ws_": "demo", "_ns_": "App-0",
                    "instance": f"instance-{i}", "job": f"job-{i % 2}"}

        big = 1e9 + 1000 * i + np.cumsum(rng.integers(1, 20, 200)).astype(
            np.float64)
        if i == 0:
            big[120:] -= big[120] - 7.0
        gauge = 1e5 + np.cumsum(rng.choice([-1.0, 1.0], 200) * 0.01)
        cpu = 1e3 * (i + 1) + np.cumsum(rng.integers(1, 51, 200)) * 0.01
        specs += [("prom-counter", labels("big_total"), ts, big),
                  ("gauge", labels("g"), ts, gauge),
                  ("prom-counter", labels("cpu_seconds_total"), ts, cpu)]
    return specs


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_probe_specs(), CHUNK, device_pages=False)


@pytest.fixture(scope="module")
def lanes(stores):
    return reference_lanes(stores[0])


@pytest.fixture(scope="module", params=[("mesh", "0"), ("mesh", "1"),
                                        ("exec", "0"), ("exec", "1")],
                ids=lambda p: f"{p[0]}-valve{p[1]}")
def services(stores, lanes, request):
    """The reference's lanes and the port on one engine at one valve."""
    engine, valve = request.param
    return (*lanes, Valved(QueryService(stores[1], device="cpu",
                                        engine=engine), valve))


# E[x²] − E[x]² over gauges at 1e5 cancels to its last digits, so the
# reference's lanes, which add in different orders, disagree with each
# other: its sidecar folds (exec at valve 1) by up to 10 %, its mesh
# engine over the tests' 8 CPU devices by up to 2.5 %
# (``test_the_reference_lanes_disagree_on_moments_at_large_magnitudes``).
# The port's host-decode lane adds as exec at valve 0 adds (``kernels.
# _scan``, and the fused multiply-add of the variance), and is held to it
MOMENTS = ("stddev_over_time", "stdvar_over_time", "zscore")


def _check(services, q, start=Q_START, step=Q_STEP, end=Q_END):
    """The port against every reference lane (against exec at valve 0 and
    mesh for the moments over ``g``); returns the port's result."""
    *refs, port = services
    res = port.query_range(q, start, step, end)
    got_keys, got = _sorted(res)
    assert len(got_keys) > 0 and np.isfinite(got).any(), q
    if any(m in q for m in MOMENTS) and "(g[" in q:
        refs = refs[:1]
    for svc in refs:
        r = svc.query_range(q, start, step, end)
        r.result.materialize()
        want_keys, want = _sorted(r)
        assert got_keys == want_keys, (q, svc.engine)
        np.testing.assert_allclose(got, want, err_msg=f"{q} {svc.engine}",
                                   **TOL)
    assert res.stats.host_lane > 0, q
    return res


FUNCTIONS = [
    *[f"sum({fn}(big_total[5m])) by (job)" for fn in (
        "rate", "increase", "irate", "changes", "resets", "delta", "idelta",
        "deriv")],
    *[f"sum({fn}(g[5m])) by (job)" for fn in (
        "idelta", "irate", "delta", "deriv", "stddev_over_time",
        "stdvar_over_time", "avg_over_time", "sum_over_time",
        "min_over_time", "max_over_time", "changes", "last_over_time")],
    "zscore(g[5m])", "quantile_over_time(0.5, g[5m])",
    "count_over_time(g[2m])", "present_over_time(g[2m])", "g",
    "timestamp(g)", "predict_linear(g[10m], 600)",
    "holt_winters(g[5m], 0.5, 0.5)",
    *[f"sum({fn}(cpu_seconds_total[5m])) by (job)" for fn in (
        "rate", "increase", "changes", "resets", "irate", "delta")],
    "rate(cpu_seconds_total[10m])",
]


@pytest.mark.parametrize("q", FUNCTIONS)
def test_functions_match_the_reference_default_lane(services, q):
    _check(services, q)


# the five cases of ROADMAP §C.8's probe, where the page lane was up to
# 2.5 times off


def test_c8_rate_of_counters_past_float32(services):
    _check(services, "sum(rate(big_total[5m])) by (job)")


def test_c8_irate_of_counters_past_float32(services):
    _check(services, "sum(irate(big_total[5m])) by (job)")


def test_c8_changes_of_counters_past_float32(services):
    res = _check(services, "sum(changes(big_total[5m])) by (job)")
    # in float64 every sample changes: about 30 a 5 m window a series
    assert np.nanmin(_sorted(res)[1][:, 2:]) > 50


def test_c8_idelta_of_fine_gauges(services):
    _check(services, "sum(idelta(g[5m])) by (job)")


def test_c8_stddev_of_fine_gauges(services):
    _check(services, "sum(stddev_over_time(g[5m])) by (job)")


def test_instant_queries_match_the_reference(services):
    """One-step grids: the mesh engine hands them to exec, whose leaves try
    the sidecar lane first at valve 1."""
    *refs, port = services
    for q in ("sum(rate(big_total[5m])) by (job)",
              "sum(last_over_time(g[5m])) by (job)",
              "sum(changes(cpu_seconds_total[5m])) by (job)"):
        got = port.query_instant(q, Q_END)
        gk, gv = _sorted(got)
        for svc in refs:
            want = svc.query_instant(q, Q_END)
            want.result.materialize()
            wk, wv = _sorted(want)
            assert gk == wk, (q, svc.engine)
            np.testing.assert_allclose(gv, wv, err_msg=f"{q} {svc.engine}",
                                       **TOL)


def test_the_reference_lanes_disagree_on_moments_at_large_magnitudes(lanes):
    """Why the moments over ``g`` are held to one of the reference's three
    lanes: its sidecar folds and its prefix sums cancel differently."""
    exec0, exec1, _ = lanes
    q = "sum(stddev_over_time(g[5m])) by (job)"
    a, b = (_sorted(svc.query_range(q, Q_START, Q_STEP, Q_END))[1]
            for svc in (exec0, exec1))
    assert np.nanmax(np.abs(a - b) / np.abs(a)) > 1e-3


def test_the_sidecar_lane_bypasses_values_float32_does_not_hold(stores,
                                                                 lanes):
    """At valve 1 the exec leaf tries the sidecar lane, whose edges and
    buffers are float32 page values: it bypasses a selection that holds
    values float32 does not, the query counts the reason, and the
    host-decode lane answers as the reference's sidecar lane does."""
    q = "sum(rate(big_total[5m])) by (job)"
    port = Valved(QueryService(stores[1], device="cpu", engine="exec"), "1")
    res = port.query_range(q, Q_START, Q_STEP, Q_END)
    bypassed = res.stats.sidecar_bypassed.get("values float32 does not hold")
    assert bypassed and res.stats.host_lane == bypassed
    assert res.stats.sidecar_chunks == 0
    want = lanes[1].query_range(q, Q_START, Q_STEP, Q_END)
    want.result.materialize()
    np.testing.assert_allclose(_sorted(res)[1], _sorted(want)[1], **TOL)


def test_samples_scanned_count_as_the_reference_default_lane(services):
    """A host-lane batch counts its in-range non-NaN samples, as the
    reference's host-decode lane counts them (ROADMAP §C's pin, settled
    for this lane)."""
    *refs, port = services
    q = "sum(rate(big_total[5m])) by (job)"
    got = port.query_range(q, Q_START, Q_STEP, Q_END).stats
    assert got.host_lane and not got.sidecar_chunks
    for svc in (refs[0], refs[2]):
        want = svc.query_range(q, Q_START, Q_STEP, Q_END).stats
        assert (got.samples_scanned, got.series_scanned) == \
            (want.samples_scanned, want.series_scanned), svc.engine


def _pids(store, q: str, start: int, end: int):
    from filodb_tpu.promql.parser import TimeStepParams as RefParams
    from filodb_tpu.promql.parser import parse_query as ref_parse

    ref_filters = list(ref_parse(q, RefParams(0, 0, 0)).raw.filters)
    filters = list(port_parse(q, TimeStepParams(0, 0, 0)).raw.filters)
    ref, port = store
    for rs, ps in zip(ref.shards_for(DS), port.shards):
        yield (rs, rs.lookup_partitions(ref_filters, start, end), ps,
               ps.lookup_partitions(filters, start, end))


@pytest.mark.parametrize("metric", ["big_total", "g", "cpu_seconds_total"])
def test_build_batch_and_delta_host_bitwise_the_reference(stores, metric):
    """Over the same partitions and range, the port's ``SeriesBatch`` holds
    the reference's ``build_batch`` ts, counts and float64 values bit for
    bit over the unpadded region (the reference pads P and S to powers of
    two), and ``delta_host`` both ways."""
    start, end = Q_START * 1000 - 300_000, Q_END * 1000
    seen = 0
    for rs, rpids, ps, pids in _pids(stores, metric, start, end):
        if not len(pids):
            continue
        want = ref_build_batch([rs.partition(p) for p in rpids], start, end)
        got = build_device_batch([(ps, pids)], start, end, CPU)
        assert isinstance(got, SeriesBatch)
        P, S = got.ts.shape
        assert P == len(rpids)
        np.testing.assert_array_equal(got.ts.numpy(), want.ts[:P, :S])
        assert (want.ts[:P, S:] == np.iinfo(np.int32).max).all()
        np.testing.assert_array_equal(got.counts, want.counts[:P])
        assert got.vals.numpy().tobytes() == \
            np.ascontiguousarray(want.vals[:P, :S]).tobytes()
        for counter in (True, False):
            assert got.delta_host(counter).tobytes() == np.ascontiguousarray(
                want.delta_host(counter)[:P, :S]).tobytes()
        seen += P
    assert seen == 6


def test_exact_stores_keep_the_page_lane():
    """Integer counters and gauges, exact in float32: no batch takes the
    host-decode lane, and rate takes B3 (its plain version here), not the
    float64 precise lane."""
    _, port = _build_stores(_series_specs(), CHUNK)
    for engine in ("mesh", "exec"):
        svc = QueryService(port, device="cpu", engine=engine)
        for q in ("sum(rate(http_requests_total[5m])) by (job)",
                  "sum(changes(http_requests_total[5m])) by (job)",
                  "sum(idelta(queue_depth[5m])) by (job)",
                  "stddev_over_time(queue_depth[5m])"):
            stats = svc.query_range(q, Q_START, Q_STEP, Q_END).stats
            assert (stats.host_lane, stats.precise_lane) == (0, 0), q
        assert not any(isinstance(b, SeriesBatch)
                       for b in svc.batches.batches())


def _fractional_month():
    """Counters of 30 days at 1 h, fractional: their relative ms pass
    2^31 and float32 does not hold their values."""
    rng = np.random.default_rng(29)
    out = []
    n = 30 * 24
    for i in range(4):
        ts = START_S * 1000 + np.arange(n, dtype=np.int64) * 3_600_000
        vals = np.cumsum(rng.integers(1, 2000, n)) * 0.001 + 1e4
        out.append(("prom-counter", {
            "_metric_": "m", "_ws_": "demo", "_ns_": "App-0",
            "instance": f"instance-{i}", "job": f"job-{i % 2}"}, ts, vals))
    return out


def test_ranges_past_2_31_ms_raise_on_the_host_lane():
    """Relative ms steps past 2^31 raise ``UnsupportedQuery`` on the
    host-decode lane too, as on the page lane (ROADMAP §C: the reference's
    host-decode lane answers wrapped values there)."""
    _, port = _build_stores(_fractional_month(), 400)
    svc = QueryService(port, device="cpu")
    with pytest.raises(UnsupportedQuery, match="int32"):
        svc.query_range("sum(rate(m[3h])) by (job)", START_S, 3_600,
                        START_S + 30 * 86_400 - 3_600)
    assert any(isinstance(b, SeriesBatch) for b in svc.batches.batches())


def _answers(store, queries):
    svc = QueryService(store, device="cpu")
    out = {}
    for q in queries:
        res = svc.query_range(q, Q_START, Q_STEP, Q_END)
        assert res.stats.host_lane > 0, q
        out[q] = _sorted(res)
    return out


def test_flushed_and_paged_chunks_give_their_float64_values(stores):
    """Chunks flushed to the column store are read back from it, and chunks
    evicted and paged in are decoded from their paged codec chunks: the
    answers are bitwise those of the store that holds every chunk."""
    queries = ["sum(rate(big_total[5m])) by (job)",
               "sum(stddev_over_time(g[5m])) by (job)", "idelta(g[5m])"]
    want = _answers(stores[1], queries)
    states = []
    for shard in stores[0].shards_for(DS):
        for p in shard.partitions:
            states.append(SeriesState(
                p.schema.name, p.part_key.label_map,
                np.concatenate([c.decode_column(0) for c in p.chunks]
                               + [p._buf.ts[: p._buf.n]]),
                np.concatenate([np.asarray(c.decode_column(1))
                                for c in p.chunks]
                               + [p._buf.cols[0][: p._buf.n]]),
                [c.num_rows for c in p.chunks]))
    store = MemStore(NUM_SHARDS, spread=1, max_chunk_size=CHUNK,
                     column_store=InMemoryColumnStore())
    ingest_states(store, states)
    store.flush_all()
    assert not any(sh.chunks["pending"].any() for sh in store.shards)
    flushed = _answers(store, queries)
    for sh in store.shards:
        sh.evict_partition_chunks(np.arange(sh.num_partitions))
    paged = _answers(store, queries)
    assert sum(sh.odp_cache.chunks_paged for sh in store.shards) > 0
    for q in queries:
        for got in (flushed[q], paged[q]):
            assert got[0] == want[q][0]
            assert got[1].tobytes() == want[q][1].tobytes(), q


def test_chunks_flushed_to_a_discarding_store_give_their_page_values():
    """A store that discards what it flushes keeps no codec chunk after a
    flush: those chunks' samples come from their float32 pages, the write
    buffer's in float64."""
    specs = [s for s in _probe_specs() if s[1]["_metric_"] == "g"][:1]
    labels, ts, vals = specs[0][1:]
    store = MemStore(1, spread=0, max_chunk_size=CHUNK,
                     column_store=NullColumnStore())
    sealed = 150
    store.ingest(labels, ts[:sealed], vals[:sealed], schema="gauge")
    store.flush_all()
    store.ingest(labels, ts[sealed:], vals[sealed:], schema="gauge")
    shard = store.shards[0]
    assert int(shard.chunks["rows"].sum()) == sealed
    start = int(ts[0]) - 1_000
    got = build_device_batch([(shard, np.array([0]))], start,
                             int(ts[-1]) + 1_000, CPU)
    assert isinstance(got, SeriesBatch) and got.counts[0] == len(ts)
    got_vals = got.vals[0].numpy()
    np.testing.assert_array_equal(got_vals[:sealed],
                                  vals[:sealed].astype(np.float32))
    np.testing.assert_array_equal(got_vals[sealed:], vals[sealed:])
    np.testing.assert_array_equal(got.ts[0].numpy(), ts - start)


# ---------------------------------------------------------------------------
# a histogram's sum column with fractional sums


@pytest.fixture(scope="module")
def hist_services():
    import test_torch_histograms as th
    from filodb_tpu.coordinator.ingestion import ingest_routed
    from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu.core.partkey import PartKey as RefPartKey
    from filodb_tpu.core.record import IngestRecord, RecordContainer, SomeData

    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, RefStoreConfig(max_chunk_size=CHUNK,
                                        groups_per_shard=2,
                                        device_pages=False))
    stream = []
    for labels, ts, segs in th._hist_specs()[:12]:
        key = RefPartKey.create("prom-histogram", labels)
        c, a = RecordContainer(), 0
        for les, counts in segs:
            for row in counts:
                c.add(IngestRecord(key, int(ts[a]), (
                    0.137 * float(row[-1]) + 1e6, float(row[-1]),
                    (les, row.astype(np.int64)))))
                a += 1
        stream.append(SomeData(c, len(stream)))
    ingest_routed(ref, DS, iter(stream), NUM_SHARDS, spread=1)
    port = MemStore(NUM_SHARDS, spread=1, max_chunk_size=CHUNK)
    ingest_states(port, th._states(ref))
    return (*reference_lanes(ref), port)


@pytest.mark.parametrize("q", [
    "sum(rate(lat::sum[5m])) by (job)", "increase(lat::sum[5m])",
    "sum(rate(lat::sum[5m])) by (job) / sum(rate(lat::count[5m])) by (job)",
    "max_over_time(lat::sum[5m])"])
def test_histogram_sums_match_the_reference_default_lane(hist_services, q):
    *refs, port = hist_services
    res = _check((*refs, QueryService(port, device="cpu")), q, end=Q_START
                 + 1800)
    assert res.stats.engine == "exec"
