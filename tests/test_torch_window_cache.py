"""Port parity for the mesh engine's per-series window cache (the
reference's split pipeline, ``_series_eval_cached``).

On the slice store (``test_torch_slice``: the same series in a JAX store
and in the port's ``MemStore``), on the CPU:

- every range function the mesh engine serves answers warm (from the
  cache) bit for bit as the port with ``FILODB_MESH_SPLIT=0`` and within
  ``rtol=2e-5, atol=1e-6`` of the reference's mesh with its split
  pipeline on;
- one query sequence gives the reference's ``filodb_mesh_eval_cache``
  hits and misses;
- an ingest moves the store's version: the next query misses, and the
  entries of the old version go;
- entries count against the batch cache's byte budget, the least
  recently used dropped first; ``execute_many`` reads the cache too.
"""

import numpy as np
import pytest

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord, RecordContainer, SomeData
from filodb_tpu.core.store.config import StoreConfig
from filodb_tpu.parallel import mesh_engine as ref_mesh
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.parallel import mesh_engine
from filodb_tpu_torch.promql.parser import TimeStepParams
from filodb_tpu_torch.query.exec.transformers import SERVED_FNS
from filodb_tpu_torch.query.model import QueryStats
from test_torch_slice import (
    CHUNK,
    DS,
    NUM_SHARDS,
    Q_END,
    Q_START,
    Q_STEP,
    START_S,
    _build_stores,
    _series_specs,
    _sorted,
)

GAUGE_FNS = ("delta", "idelta", "deriv", "predict_linear", "holt_winters",
             "changes", "stddev_over_time", "stdvar_over_time", "zscore")


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), CHUNK)


def _query(fn: str) -> str:
    metric = "queue_depth" if fn in GAUGE_FNS else "http_requests_total"
    args = {"predict_linear": ", 60", "holt_winters": ", 0.5, 0.5"}
    if fn == "last_sample":  # the instant selector
        return f"sum({metric}) by (job)"
    if fn == "quantile_over_time":
        return f"sum(quantile_over_time(0.9, {metric}[5m])) by (job)"
    return f"sum({fn}({metric}[5m]{args.get(fn, '')})) by (job)"


def _counts() -> tuple[int, int]:
    return (mesh_engine._M_EVAL["hit"].value,
            mesh_engine._M_EVAL["miss"].value)


def _ref_counts() -> tuple[int, int]:
    return (ref_mesh._M_EVAL["hit"].value, ref_mesh._M_EVAL["miss"].value)


@pytest.mark.parametrize("fn", sorted(SERVED_FNS))
def test_warm_answers_are_bitwise_the_uncached_ones(stores, fn,
                                                    monkeypatch):
    ref, port = stores
    q = _query(fn)
    svc = QueryService(port, device="cpu")
    cold = svc.query_range(q, Q_START, Q_STEP, Q_END)
    h0, m0 = _counts()
    warm = svc.query_range(q, Q_START, Q_STEP, Q_END)
    h1, m1 = _counts()
    assert warm.stats.engine == "mesh"
    assert (h1 - h0, m1 - m0) == ((1, 0) if fn in mesh_engine.SPLIT_FNS
                                  else (0, 0))
    monkeypatch.setenv("FILODB_MESH_SPLIT", "0")
    off = QueryService(port, device="cpu").query_range(q, Q_START, Q_STEP,
                                                       Q_END)
    for got in (cold, warm):
        assert _sorted(got)[0] == _sorted(off)[0]
        np.testing.assert_array_equal(_sorted(got)[1], _sorted(off)[1])
    monkeypatch.setenv("FILODB_MESH_SPLIT", "1")
    r = RefService(ref, DS, NUM_SHARDS, spread=1, engine="mesh")
    want = r.query_range(q, Q_START, Q_STEP, Q_END)
    want.result.materialize()
    assert _sorted(warm)[0] == _sorted(want)[0]
    np.testing.assert_allclose(_sorted(warm)[1], _sorted(want)[1],
                               rtol=2e-5, atol=1e-6, equal_nan=True)


SEQUENCE = [
    "sum(rate(http_requests_total[5m])) by (job)",
    "sum(rate(http_requests_total[5m])) by (job)",     # hit
    "max(rate(http_requests_total[5m])) by (instance)",  # same windows
    "sum(rate(http_requests_total[2m])) by (job)",     # another window
    "sum(sum_over_time(queue_depth[5m]))",
    "avg(sum_over_time(queue_depth[5m])) by (job)",    # hit
    "sum(increase(http_requests_total[5m]))",
]


def test_hits_and_misses_are_the_references(stores, monkeypatch):
    monkeypatch.setenv("FILODB_SIDECARS", "0")
    ref, port = stores
    rsvc = RefService(ref, DS, NUM_SHARDS, spread=1, engine="mesh")
    psvc = QueryService(port, device="cpu")
    got, want = [], []
    for q in SEQUENCE:
        before, rbefore = _counts(), _ref_counts()
        psvc.query_range(q, Q_START, Q_STEP, Q_END)
        rsvc.query_range(q, Q_START, Q_STEP, Q_END).result.materialize()
        got.append(tuple(a - b for a, b in zip(_counts(), before)))
        want.append(tuple(a - b for a, b in zip(_ref_counts(), rbefore)))
    assert got == want
    assert got == [(0, 1), (1, 0), (1, 0), (0, 1), (0, 1), (1, 0), (0, 1)]
    entries, nbytes = psvc.mesh.window_cache
    assert entries == 4 and nbytes > 0


def _twins(n: int):
    """12 gauges in a JAX store and in the port's, ``n`` samples each."""
    keys = [{"_metric_": "heap_usage", "_ws_": "demo", "_ns_": f"App-{ns}",
             "host": f"h{i}"} for ns in (8, 9) for i in range(6)]
    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, StoreConfig(max_chunk_size=100, groups_per_shard=4,
                                     device_pages=True))
    port = MemStore(NUM_SHARDS, 1, max_chunk_size=100)
    twins = (ref, port, keys, [0])
    _ingest_to(twins, n)
    return twins


def _ingest_to(twins, n: int) -> None:
    ref, port, keys, done = twins
    rng = np.random.default_rng(5)
    vals = rng.integers(-50, 50, (len(keys), 1000)).astype(np.float64)
    ts = START_S * 1000 + np.arange(1000) * 10_000
    a = done[0]
    stream = []
    for i, labels in enumerate(keys):
        c = RecordContainer()
        key = RefPartKey.create("gauge", labels)
        for t, v in zip(ts[a:n], vals[i, a:n]):
            c.add(IngestRecord(key, int(t), (float(v),)))
        stream.append(SomeData(c, i))
        port.ingest(labels, ts[a:n], vals[i, a:n], schema="gauge")
    ingest_routed(ref, DS, iter(stream), NUM_SHARDS, spread=1)
    done[0] = n


def test_a_scrape_invalidates_the_entries():
    twins = _twins(300)
    ref, port = twins[:2]
    rsvc = RefService(ref, DS, NUM_SHARDS, spread=1, engine="mesh")
    svc = QueryService(port, device="cpu")
    q, qs, qe = "sum(avg_over_time(heap_usage[3m]))", START_S + 600, \
        START_S + 2900
    counts = []
    for step in ("cold", "warm", "scrape", "after", "again"):
        if step == "scrape":
            _ingest_to(twins, 310)
            continue
        before, rbefore = _counts(), _ref_counts()
        got = svc.query_range(q, qs, 60, qe)
        want = rsvc.query_range(q, qs, 60, qe)
        want.result.materialize()
        np.testing.assert_allclose(got.result.values, want.result.values,
                                   rtol=2e-5, atol=1e-6, equal_nan=True)
        counts.append((tuple(a - b for a, b in zip(_counts(), before)),
                       tuple(a - b for a, b in zip(_ref_counts(), rbefore))))
    assert [c[0] for c in counts] == [c[1] for c in counts] == \
        [(0, 1), (1, 0), (0, 1), (1, 0)]
    # the old version's entry went when the new one was put
    assert svc.mesh.window_cache[0] == 1


def test_entries_count_against_the_batch_budget(stores):
    _, port = stores
    svc = QueryService(port, device="cpu")
    a = "sum(rate(http_requests_total[5m])) by (job)"
    b = "sum(increase(http_requests_total[5m])) by (job)"  # same batch
    svc.query_range(a, Q_START, Q_STEP, Q_END)
    (entries, one), batch = svc.mesh.window_cache, svc.batches.nbytes("mesh")
    assert entries == 1 and one > 0 and batch > 0
    assert svc.batches.nbytes() == one + batch
    small = QueryService(port, device="cpu")
    small.batches.budget = batch + one + one // 2
    first = small.query_range(a, Q_START, Q_STEP, Q_END)
    small.query_range(b, Q_START, Q_STEP, Q_END)
    # b's windows pushed out a's (least recently used), not the batch
    assert small.mesh.window_cache == (1, one)
    assert small.batches.nbytes("mesh") == batch
    assert small.batches.nbytes() <= small.batches.budget
    h0, m0 = _counts()
    again = small.query_range(a, Q_START, Q_STEP, Q_END)
    assert _counts() == (h0, m0 + 1)
    np.testing.assert_array_equal(again.result.values, first.result.values)


def test_execute_many_reads_and_fills_the_cache(stores):
    _, port = stores
    svc = QueryService(port, device="cpu")
    qs = [("sum(rate(http_requests_total[5m])) by (job)", Q_START + 60 * i,
           Q_STEP, Q_END) for i in range(3)]
    h0, m0 = _counts()
    cold = svc.query_range_many(qs)
    assert _counts() == (h0, m0 + 3)
    warm = svc.query_range_many(qs)
    assert _counts() == (h0 + 3, m0 + 3)
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(c.result.values, w.result.values)
    stats = QueryStats()
    plan = svc._parse_cached(qs[0][0], TimeStepParams(*qs[0][1:]))
    out = svc.mesh.execute_many(port, [plan], [stats])
    assert stats.series_scanned > 0 and out[0] is not None
