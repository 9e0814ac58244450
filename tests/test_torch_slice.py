"""Port parity for the slice as a whole: the same series go into a JAX
store (device pages on, 4 shards, spread 1) and into the port's MemStore on
the CPU; packed pages must be byte-equal, and ``query_range`` must agree
with the JAX ``QueryService`` on both its engines, each lane named
(``reference_lanes``): exec over device pages with ``FILODB_SIDECARS`` at
0 (the decode lane) and at 1 (sidecar folds for the functions they
serve), and mesh, which falls back to exec for the shapes it does not
lower, for the range functions and aggregation forms here.

Keys compare as sorted strings; values with ``rtol=2e-5, atol=1e-6``,
NaN equal. The data are integer counters and gauges, exact in float32,
because device pages store float32.
"""

import numpy as np
import pytest

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord, RecordContainer, SomeData
from filodb_tpu.core.store.config import StoreConfig
from filodb_tpu.memory.device_pages import encode_f32_page, encode_ts_page
from filodb_tpu.query.engine.device_batch import (
    chunk_device_pages,
    pack_series_pages,
)
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.http.promjson import matrix_json
from filodb_tpu_torch.parallel.mesh_engine import UnsupportedQuery
from filodb_tpu_torch.promql.parser import TimeStepParams as PortParams
from filodb_tpu_torch.promql.parser import parse_query as port_parse
from filodb_tpu_torch.query.engine.device_batch import pack_blocks
from filodb_tpu_torch.testing.from_jax import SeriesState, ingest_states

DS = "timeseries"
NUM_SHARDS = 4
CHUNK = 64
START_S = 1_600_000_000
Q_START, Q_STEP, Q_END = START_S + 600, 60, START_S + 2400

FNS = ("rate", "increase", "delta", "sum_over_time", "count_over_time",
       "avg_over_time")
AGGS = ("sum({}) by (job)", "avg({})", "max({}) by (instance)",
        "min({}) without (instance)", "count({})", "{}")


def _series_specs():
    """(schema, labels, ts, vals): jittered 10 s scrapes, counters with
    resets and gauges, series of staggered lengths in two namespaces."""
    rng = np.random.default_rng(7)
    specs = []
    for i in range(28):
        ns = "App-0" if i % 4 else "App-1"
        counter = i < 20
        metric = "http_requests_total" if counter else "queue_depth"
        n = int(rng.integers(150, 300))
        ts = (START_S * 1000 + np.arange(n) * 10_000
              + rng.integers(-500, 501, n)).astype(np.int64)
        if counter:
            vals = np.cumsum(rng.integers(0, 20, n)).astype(np.float64)
            if i % 3 == 0:
                r = int(rng.integers(20, n - 20))
                vals[r:] -= vals[r] - rng.integers(0, 5)
        else:
            vals = rng.integers(-100, 100, n).astype(np.float64)
        labels = {"_metric_": metric, "_ws_": "demo", "_ns_": ns,
                  "instance": f"instance-{i}", "job": f"job-{i % 3}"}
        specs.append(("prom-counter" if counter else "gauge", labels, ts,
                      vals))
    return specs


def _build_stores(specs, chunk, device_pages=True):
    """The same series in a JAX store (4 shards, spread 1; device pages on,
    or off for the reference's default lane, host decode) and in the port's
    MemStore, sealed alike."""
    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, StoreConfig(max_chunk_size=chunk, groups_per_shard=2,
                                     device_pages=device_pages))
    stream, off = [], 0
    for schema, labels, ts, vals in specs:
        key = RefPartKey.create(schema, labels)
        c = RecordContainer()
        for t, v in zip(ts, vals):
            c.add(IngestRecord(key, int(t), (float(v),)))
        stream.append(SomeData(c, off))
        off += 1
    ingest_routed(ref, DS, iter(stream), NUM_SHARDS, spread=1)

    states = []
    for shard in ref.shards_for(DS):
        for p in shard.partitions:
            ts = np.concatenate([c.decode_column(0) for c in p.chunks]
                                + [p._buf.ts[: p._buf.n]])
            vals = np.concatenate([np.asarray(c.decode_column(1))
                                   for c in p.chunks]
                                  + [p._buf.cols[0][: p._buf.n]])
            states.append(SeriesState(p.schema.name, p.part_key.label_map,
                                      ts, vals,
                                      [c.num_rows for c in p.chunks]))
    port = MemStore(NUM_SHARDS, spread=1, max_chunk_size=chunk)
    ingest_states(port, states)
    return ref, port


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), CHUNK)


def test_port_routes_and_seals_like_the_reference(stores):
    ref, port = stores
    for rs, ps in zip(ref.shards_for(DS), port.shards):
        assert [p.part_key.labels for p in rs.partitions] == \
            [k.labels for k in ps.keys]
        assert len(ps.chunks["pid"]) == sum(len(p.chunks)
                                            for p in rs.partitions)


def test_direct_ingest_seals_like_the_reference(stores):
    """Series ingested straight into the port (no carried chunk bounds)
    come out with the reference's chunks."""
    ref, _ = stores
    port = MemStore(NUM_SHARDS, spread=1, max_chunk_size=CHUNK)
    specs = _series_specs()
    for schema in ("prom-counter", "gauge"):
        sel = [s for s in specs if s[0] == schema]
        n = max(len(s[2]) for s in sel)
        ts = np.zeros((len(sel), n), np.int64)
        vals = np.zeros((len(sel), n))
        lens = np.array([len(s[2]) for s in sel])
        for i, s in enumerate(sel):
            ts[i, : lens[i]], vals[i, : lens[i]] = s[2], s[3]
        port.ingest_series([s[1] for s in sel], ts, vals, lens,
                           schema=schema)
    for rs, ps in zip(ref.shards_for(DS), port.shards):
        want = sorted((p.part_key.labels, c.num_rows)
                      for p in rs.partitions for c in p.chunks)
        ch = ps.chunks
        got = sorted((ps.keys[pid].labels, int(n))
                     for pid, n in zip(ch["pid"], ch["rows"]))
        assert got == want
        np.testing.assert_array_equal(
            np.sort(ps.buffers.n[: ps.num_partitions]),
            np.sort([p._buf.n for p in rs.partitions]))


@pytest.mark.parametrize("selector,window", [
    ('http_requests_total', 300_000),
    ('http_requests_total{_ns_="App-0",job=~"job-[12]"}', 120_000),
    ('queue_depth{instance!="instance-21"}', 300_000),
])
def test_packed_pages_byte_equal(stores, selector, window):
    from filodb_tpu.promql.parser import TimeStepParams, parse_query

    ref, port = stores
    q = f"sum_over_time({selector}[{window // 1000}s])"
    filters = list(parse_query(q, TimeStepParams(Q_START, Q_STEP,
                                                 Q_END)).raw.filters)
    port_filters = list(port_parse(q, PortParams(Q_START, Q_STEP,
                                                 Q_END)).raw.filters)
    start = Q_START * 1000 - window
    end = Q_END * 1000
    per_series = []
    for shard in ref.shards_for(DS):
        for pid in shard.lookup_partitions(filters, start, end):
            p = shard.partition(pid)
            entries = [(*chunk_device_pages(c, p.schema, 1), c.num_rows)
                       for c in p.chunks_in_range(start, end,
                                                  include_buffer=False)]
            b = p._buf
            if b.n and b.ts[b.n - 1] >= start and b.ts[0] <= end:
                entries.append((encode_ts_page(b.ts[: b.n]),
                                encode_f32_page(b.cols[0][: b.n]), b.n))
            per_series.append(entries)
    want, wcounts = pack_series_pages(per_series, start)

    tables, t_of, b_of, r_of, n = [], [], [], [], 0
    for shard in port.shards:
        pids = shard.lookup_partitions(port_filters, start, end)
        if not len(pids):
            continue
        tabs, t, b, r, _ = shard.select_blocks(pids, start, end)
        t_of.append(t + len(tables))
        tables += tabs
        b_of.append(b)
        r_of.append(r + n)
        n += len(pids)
    assert n == len(per_series) > 0
    got, gcounts = pack_blocks(tables, np.concatenate(t_of),
                               np.concatenate(b_of), np.concatenate(r_of), n,
                               start)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(wcounts, gcounts)


class Valved:
    """A reference ``QueryService`` whose every call runs with
    ``FILODB_SIDECARS`` set to ``valve``: the valve is read at query time,
    so it is set around each call, not around a module-scoped fixture.
    ``engine`` names the lane. Its ``query_range`` and ``query_instant``
    answers are kept per arguments, so that the port's two engines are
    held against one reference answer each (the store does not change
    under a fixture)."""

    _KEPT = ("query_range", "query_instant")

    def __init__(self, svc, valve: str):
        self.svc = svc
        self.valve = valve
        self.engine = f"{svc.engine} FILODB_SIDECARS={valve}"
        self._answers: dict = {}

    def __getattr__(self, name):
        attr = getattr(self.svc, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            key = (name, args, tuple(sorted(kwargs.items())))
            if name in self._KEPT and key in self._answers:
                return self._answers[key]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("FILODB_SIDECARS", self.valve)
                out = attr(*args, **kwargs)
            if name in self._KEPT:
                self._answers[key] = out
            return out
        return call


def reference_lanes(ref):
    """(exec at valve 0: the decode lane; exec at valve 1: the sidecar
    folds for ``ELIGIBLE_FNS``; mesh at valve 0, whose fallbacks to exec
    then decode) over the reference store ``ref``."""
    def svc(engine):
        return RefService(ref, DS, NUM_SHARDS, spread=1, engine=engine)

    return (Valved(svc("exec"), "0"), Valved(svc("exec"), "1"),
            Valved(svc("mesh"), "0"))


@pytest.fixture(scope="module")
def lanes(stores):
    return reference_lanes(stores[0])


@pytest.fixture(scope="module", params=["mesh", "exec"])
def services(stores, lanes, request):
    """The reference lanes and the port on one of its two engines."""
    return (*lanes, QueryService(stores[1], device="cpu",
                                 engine=request.param))


def _sorted(result):
    m = result.result
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order]


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("fn", FNS)
def test_query_range_matches_both_reference_engines(services, fn, agg):
    *refs, port = services
    window = "2m" if fn == "avg_over_time" else "5m"
    metric = "queue_depth" if fn == "delta" else "http_requests_total"
    q = agg.format(f"{fn}({metric}[{window}])")
    got_keys, got = _sorted(port.query_range(q, Q_START, Q_STEP, Q_END))
    assert len(got_keys) > 0 and np.isfinite(got).any()
    for svc in refs:
        r = svc.query_range(q, Q_START, Q_STEP, Q_END)
        r.result.materialize()
        want_keys, want = _sorted(r)
        assert got_keys == want_keys, (q, svc.engine)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                   equal_nan=True, err_msg=f"{q} {svc.engine}")


def test_delta_on_counters_is_reset_corrected(services):
    ref_exec, *_, port = services
    q = "sum(delta(http_requests_total[5m])) by (job)"
    got_keys, got = _sorted(port.query_range(q, Q_START, Q_STEP, Q_END))
    r = ref_exec.query_range(q, Q_START, Q_STEP, Q_END)
    r.result.materialize()
    want_keys, want = _sorted(r)
    assert got_keys == want_keys
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                               equal_nan=True)


def test_answer_renders_as_prometheus_matrix(services):
    *_, port = services
    body = matrix_json(port.query_range(
        "sum(rate(http_requests_total[5m])) by (_ns_)", Q_START, Q_STEP,
        Q_END))
    assert body["status"] == "success"
    assert body["data"]["resultType"] == "matrix"
    assert {s["metric"]["_ns_"] for s in body["data"]["result"]} == \
        {"App-0", "App-1"}


@pytest.mark.parametrize("q", [
    "http_requests_total::sum",
    "sum(rate(http_requests_total::count[5m])) by (job)",
])
def test_other_plan_shapes_raise(services, q):
    """Column selectors raise in the mesh engine, the signal that hands
    them to the exec engine; a scalar series has no ``sum`` or ``count``
    column, so exec reads its value column, as the reference's exec engine
    does (``rtol=2e-5, atol=1e-6``)."""
    from filodb_tpu_torch.query.model import QueryStats

    exec0, *_, port = services
    plan = port_parse(q, PortParams(Q_START, Q_STEP, Q_END))
    with pytest.raises(UnsupportedQuery):
        port.mesh.execute(port.memstore, plan, QueryStats())
    res = port.query_range(q, Q_START, Q_STEP, Q_END)
    assert res.stats.engine == "exec"
    assert ("RawSeries" in res.stats.fallback) == (port.engine == "mesh")
    r = exec0.query_range(q, Q_START, Q_STEP, Q_END)
    r.result.materialize()
    got_keys, got = _sorted(res)
    want_keys, want = _sorted(r)
    assert got_keys == want_keys and len(got_keys) > 0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                               equal_nan=True)


def test_entry_points_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryService(MemStore())


def test_partkey_hashes_match_reference():
    from filodb_tpu.core.partkey import murmur3_32, shard_key_hash
    from filodb_tpu_torch.core import partkey as port_pk

    rng = np.random.default_rng(5)
    keys = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
            for n in list(range(0, 21)) * 3]
    np.testing.assert_array_equal(port_pk.murmur3_32_many(keys),
                                  [murmur3_32(k) for k in keys])
    np.testing.assert_array_equal(port_pk.murmur3_32_many(keys, seed=0x5EED),
                                  [murmur3_32(k, 0x5EED) for k in keys])
    sk = {"_ws_": "demo", "_ns_": "App-7", "_metric_": "m"}
    assert port_pk.shard_key_hash(sk) == shard_key_hash(sk)


@pytest.mark.parametrize("selector", [
    'http_requests_total{job="job-1"}',
    'http_requests_total{job!="job-1",_ns_="App-0"}',
    'http_requests_total{instance=~"instance-1.*"}',
    'http_requests_total{instance!~"instance-1.*"}',
    '{_ns_="App-1"}',
    '{_ws_="demo",nolabel=""}',
    '{_ws_="demo",nolabel=~".*"}',
    '{__name__=~"http.*|queue_depth",job=~"job-0|job-2"}',
])
def test_index_selects_like_the_reference(stores, selector):
    from filodb_tpu.promql.parser import TimeStepParams, parse_query

    ref, port = stores
    q = f"rate({selector}[5m])"
    filters = list(parse_query(q, TimeStepParams(Q_START, Q_STEP,
                                                 Q_END)).raw.filters)
    port_filters = list(port_parse(q, PortParams(Q_START, Q_STEP,
                                                 Q_END)).raw.filters)
    lo, hi = Q_START * 1000 - 300_000, Q_END * 1000
    for rs, ps in zip(ref.shards_for(DS), port.shards):
        want = [rs.partition(p).part_key.labels
                for p in rs.lookup_partitions(filters, lo, hi)]
        got = [ps.keys[p].labels
               for p in ps.lookup_partitions(port_filters, lo, hi)]
        assert got == want


def test_precision_gate_runs_large_counters_in_float64():
    """Counters past 2^20 fail the float32 gate: the leaf runs the plain
    float64 path on the device, as the reference's exec path computes over
    the same float32 pages, and the query's stats count it."""
    rng = np.random.default_rng(9)
    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, StoreConfig(max_chunk_size=CHUNK, groups_per_shard=2,
                                     device_pages=True))
    stream = []
    for i in range(6):
        key = RefPartKey.create("prom-counter", {
            "_metric_": "big_total", "_ws_": "demo", "_ns_": "App-0",
            "instance": f"instance-{i}", "job": f"job-{i % 2}"})
        c = RecordContainer()
        v = float(2**22 + 1000 * i)
        for j in range(200):
            v += float(rng.integers(0, 20) * 4)
            c.add(IngestRecord(key, START_S * 1000 + j * 10_000
                               + int(rng.integers(-500, 501)), (v,)))
        stream.append(SomeData(c, i))
    ingest_routed(ref, DS, iter(stream), NUM_SHARDS, spread=1)
    states = []
    for shard in ref.shards_for(DS):
        for p in shard.partitions:
            states.append(SeriesState(
                p.schema.name, p.part_key.label_map,
                np.concatenate([c.decode_column(0) for c in p.chunks]
                               + [p._buf.ts[: p._buf.n]]),
                np.concatenate([np.asarray(c.decode_column(1))
                                for c in p.chunks]
                               + [p._buf.cols[0][: p._buf.n]]),
                [c.num_rows for c in p.chunks]))
    port = MemStore(NUM_SHARDS, spread=1, max_chunk_size=CHUNK)
    ingest_states(port, states)
    q = "sum(rate(big_total[5m])) by (job)"
    res = QueryService(port, device="cpu").query_range(q, Q_START, Q_STEP,
                                                        START_S + 1900)
    assert res.stats.precise_lane == 1
    want = Valved(RefService(ref, DS, NUM_SHARDS, spread=1, engine="exec"),
                  "0").query_range(q, Q_START, Q_STEP, START_S + 1900)
    want.result.materialize()
    got_keys, got = _sorted(res)
    want_keys, want_v = _sorted(want)
    assert got_keys == want_keys
    np.testing.assert_allclose(got, want_v, rtol=2e-5, atol=1e-6,
                               equal_nan=True)


def test_small_counters_take_the_fused_kernel(services):
    *_, port = services
    res = port.query_range("sum(rate(http_requests_total[5m]))", Q_START,
                           Q_STEP, Q_END)
    assert res.stats.precise_lane == 0


@pytest.mark.parametrize("q", [
    'sum(rate(http_requests_total{job=~"job-.*",_ns_!="x"}[5m] offset 1m)) by (job)',
    "avg without (instance) (delta(queue_depth[2m]))",
    "topk(3, sum_over_time(m[10m]))",
    "1 + 2 * 3",
    "2 > bool 1",
    "3 < 1",
    "histogram_quantile(0.9, sum(rate(h[5m])) by (le))",
    "rate(m[5m]) / on (job) group_left rate(n[5m])",
])
def test_parser_matches_reference(q):
    from filodb_tpu.promql.parser import TimeStepParams, parse_query

    want = parse_query(q, TimeStepParams(Q_START, Q_STEP, Q_END))
    got = port_parse(q, PortParams(Q_START, Q_STEP, Q_END))
    assert repr(got) == repr(want)


LONG_SAMPLES = 17_280  # 48 h at 10 s: 43 chunks of 400, 256 packed blocks


@pytest.fixture(scope="module")
def long_services():
    """A few counters of 48 h each, one with a reset, in 400-sample
    chunks as ``conf/server.json`` seals them."""
    rng = np.random.default_rng(11)
    specs = []
    for i in range(4):
        ts = (START_S * 1000 + np.arange(LONG_SAMPLES) * 10_000
              + rng.integers(-500, 501, LONG_SAMPLES)).astype(np.int64)
        vals = np.cumsum(rng.integers(0, 20, LONG_SAMPLES)).astype(
            np.float64)
        if i == 1:
            vals[9_000:] -= vals[9_000]
        specs.append(("prom-counter", {
            "_metric_": "http_requests_total", "_ws_": "demo",
            "_ns_": f"App-{i % 2}", "instance": f"instance-{i}",
            "job": f"job-{i % 2}"}, ts, vals))
    ref, port = _build_stores(specs, 400)
    return (*reference_lanes(ref), QueryService(port, device="cpu"))


@pytest.mark.parametrize("q", [
    "sum(rate(http_requests_total[5m])) by (job)",
    "increase(http_requests_total[1h])",
    "count_over_time(http_requests_total[5m])",
])
def test_long_range_matches_both_reference_engines(long_services, q):
    """48 h at a 60 s step (K = 2,881): the series the one-CTA kernels
    refused on the card."""
    *refs, port = long_services
    start, end = START_S, START_S + LONG_SAMPLES * 10
    res = port.query_range(q, start, 60, end)
    assert res.result.num_steps == 2_881
    got_keys, got = _sorted(res)
    assert np.isfinite(got).mean() > 0.99
    for svc in refs:
        r = svc.query_range(q, start, 60, end)
        r.result.materialize()
        want_keys, want = _sorted(r)
        assert got_keys == want_keys, (q, svc.engine)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                   equal_nan=True, err_msg=f"{q} {svc.engine}")


@pytest.mark.parametrize("S,rows", [(1024, 2**17), (32_768, 4_096),
                                    (2**28, 1)])
def test_decode_chunk_is_sized_by_samples(S, rows):
    from filodb_tpu_torch.query.exec.transformers import decode_rows

    assert decode_rows(S) == rows
