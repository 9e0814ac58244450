"""Port parity for query tracing (``utils/tracing.py``).

- One query on each engine, traced in both packages on the slice store
  (``test_torch_slice``): the reference's stage spans (``parse``,
  ``mesh-execute``, ``plan-materialize``, ``exec-dispatch``, ``scan``,
  ``decode``, ``reduce``, ``cache``) come in the same order.
- Head sampling at ``sample_rate`` 1 and the slow-query ring, for single
  queries and for the members of a ``query_range_many`` batch, as the
  reference records them; the ingest ring for shard ingests; the stage
  histograms.
- The HTTP routes ``debug/trace``, ``debug/slow_queries``,
  ``debug/costmodel`` and ``status/ingest``.
"""

import json

import numpy as np
import pytest

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.utils import tracing as rtracing
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import (
    IngestRecord,
    RecordContainer,
    SomeData,
)
from filodb_tpu_torch.http.server import HttpDispatcher
from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.utils import tracing
from filodb_tpu_torch.utils.metrics import render_prometheus
from test_torch_slice import (
    CHUNK,
    DS,
    NUM_SHARDS,
    Q_END,
    Q_START,
    Q_STEP,
    _build_stores,
    _series_specs,
)

Q = "sum(rate(http_requests_total[5m])) by (job)"
STAGES = set(tracing._STAGES)


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), CHUNK)


@pytest.fixture(autouse=True)
def fresh_tracing():
    for mod in (tracing, rtracing):
        mod.configure()
        mod.flight_recorder().clear()
        mod.ingest_recorder().clear()
    yield
    for mod in (tracing, rtracing):
        mod.configure()
        mod.flight_recorder().clear()
        mod.ingest_recorder().clear()


def _stages(trace) -> list:
    return [s.name for s in trace.spans if s.name in STAGES]


def test_spans_nest_and_cost_nothing_untraced():
    with tracing.start_trace() as trace:
        with tracing.span("outer", q="x"):
            with tracing.span("inner"):
                pass
        with tracing.span("sibling"):
            pass
    assert [(s.name, s.depth) for s in trace.spans] == \
        [("outer", 0), ("inner", 1), ("sibling", 0)]
    assert trace.find("outer")[0].tags == {"q": "x"}
    with tracing.span("orphan") as s:
        assert s is None


@pytest.mark.parametrize("cache", [False, True], ids=["", "extent-cache"])
@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_stage_spans_come_in_the_references_order(stores, engine, cache,
                                                  monkeypatch):
    monkeypatch.setenv("FILODB_SIDECARS", "0")
    ref, port = stores
    rc = {"extent_steps": 8} if cache else None
    rsvc = RefService(ref, DS, NUM_SHARDS, spread=1, engine=engine,
                      result_cache=rc)
    psvc = QueryService(port, device="cpu", engine=engine, result_cache=rc)
    runs = []
    for mod, svc in ((rtracing, rsvc), (tracing, psvc)):
        out = []
        for _ in range(2):  # cold (a batch built), then warm
            with mod.start_trace() as trace:
                r = svc.query_range(Q, Q_START, Q_STEP, Q_END)
            r.result.materialize()
            out.append(_stages(trace))
        runs.append(out)
    if cache and engine == "mesh":
        # the port's mesh engine evaluates the missing extents as one
        # batch where the reference runs one mesh-execute an extent
        # (ROADMAP §C): the stages come in the same order, once
        runs = [[list(dict.fromkeys(seq)) for seq in out] for out in runs]
    assert runs[0] == runs[1], engine
    names = set(runs[1][0])
    assert "parse" in names
    assert ("mesh-execute" in names) == (engine == "mesh")
    assert ("exec-dispatch" in names) == (engine == "exec")
    assert ("cache" in names) == cache


def test_a_sampled_query_lands_in_the_slow_ring_with_its_tree(stores):
    _, port = stores
    tracing.configure(sample_rate=1.0, slow_query_threshold_ms=1e-6)
    svc = QueryService(port, device="cpu", engine="exec")
    before = tracing._sampled.value
    svc.query_range(Q, Q_START, Q_STEP, Q_END)
    assert tracing._sampled.value == before + 1
    (entry,) = tracing.slow_queries()
    assert entry["kind"] == "query" and entry["query"] == Q
    assert entry["dataset"] == DS and entry["sampled"]
    names = [s["name"] for s in entry["spans"]]
    assert names[0] == "parse" and "exec-dispatch" in names
    assert entry["stats"]["series_scanned"] > 0
    assert 'filodb_query_stage_seconds_count{stage="parse"}' in \
        render_prometheus()


def test_an_unsampled_slow_query_records_stats_without_spans(stores):
    _, port = stores
    tracing.configure(sample_rate=0.0, slow_query_threshold_ms=1e-6)
    QueryService(port, device="cpu").query_range(Q, Q_START, Q_STEP, Q_END)
    (entry,) = tracing.slow_queries()
    assert not entry["sampled"] and entry["spans"] == []


def test_batched_members_are_recorded_as_the_reference_records_them(
        stores):
    ref, port = stores
    qs = [(Q, Q_START + 60 * i, Q_STEP, Q_END) for i in range(3)]
    got = []
    for mod, svc in ((rtracing, RefService(ref, DS, NUM_SHARDS, spread=1,
                                           engine="mesh")),
                     (tracing, QueryService(port, device="cpu"))):
        mod.configure(slow_query_threshold_ms=1e-6)
        svc.query_range_many(qs)
        got.append(sorted((e["kind"], e["query"], e["dataset"],
                           e.get("batched"), e["spans"] == [])
                          for e in mod.slow_queries()))
    assert got[0] == got[1] and len(got[1]) == 3


def test_shard_ingests_land_in_the_ingest_ring():
    tracing.configure(slow_ingest_threshold_ms=1e-6)
    store = MemStore(1, 0, max_chunk_size=50)
    c = RecordContainer()
    key = PartKey.create("gauge", {"_metric_": "g", "_ws_": "demo",
                                   "_ns_": "App-0", "host": "h"})
    for t in range(3):
        c.add(IngestRecord(key, 1_600_000_000_000 + t * 10_000, (1.0,)))
    store.shards[0].ingest(SomeData(c, 0))
    store.shards[0].flush_group(0)
    kinds = [e["kind"] for e in tracing.slow_ingest()]
    assert kinds == ["flush", "ingest"]
    assert not tracing.slow_queries()


class _App:
    def __init__(self, svc):
        self.services = {DS: svc}
        self.response_cache = None
        self.cluster = None

    def batched(self, svc):
        return svc


def _get(svc, path: str):
    code, _, body = HttpDispatcher(_App(svc)).handle("GET", path)
    return code, json.loads(body)


def test_debug_and_status_routes(stores):
    _, port = stores
    svc = QueryService(port, device="cpu")
    tracing.configure(slow_query_threshold_ms=1e-6)
    code, body = _get(svc, f"/promql/{DS}/api/v1/debug/trace?query={Q}"
                           f"&start={Q_START}&end={Q_END}&step={Q_STEP}")
    assert code == 200 and body["data"]["result_series"] == 3
    names = [s["name"] for s in body["data"]["spans"]]
    assert names[:2] == ["parse", "mesh-execute"]
    assert all(np.isfinite(s["duration_ms"]) for s in body["data"]["spans"])
    code, body = _get(svc, f"/promql/{DS}/api/v1/debug/slow_queries?limit=1")
    assert code == 200 and len(body["data"]["slow_queries"]) == 1
    assert body["data"]["slow_queries"][0]["query"] == Q
    cm.model_for(DS).observe("sidecar", "fold:pw8", "decode", 0.5)
    code, body = _get(svc, f"/promql/{DS}/api/v1/debug/costmodel")
    assert code == 200 and body["data"]["dataset"] == DS
    assert any(r["site"] == "sidecar" for r in body["data"]["estimates"])
    code, body = _get(svc, "/api/v1/status/ingest")
    shards = body["data"]["datasets"][DS]["shards"]
    assert code == 200 and len(shards) == NUM_SHARDS
    assert all(s["maxIngestedTs"] > 0 for s in shards)
    assert "slowIngest" in body["data"]
    code, body = _get(svc, "/api/v1/status/tsdb")
    assert code == 200
    assert body["data"][DS]["headStats"]["numShards"] == NUM_SHARDS
    cm.reset_models()
