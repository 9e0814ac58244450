"""The last single-node routes of the port's HTTP API, against the
reference's.

- ``status/mesh``: one process answers ``multiproc: false`` with the
  engine's counters, under the reference's keys; a dataset with a
  multi-process runtime answers ``multiproc: true`` with the runtime's
  status, its workers' slices, devices and launches, on both fronts.
- ``?stats=all``'s ``decodeMs`` and ``reduceMs``: present and not
  negative, and above zero where a stage ran, for an exec leaf on the
  decode lane, a leaf the sidecar lane folds and a cold leaf the pyramid
  lane folds; the rest of the expanded stats carries the reference's keys,
  ``wireBytes`` among them since remote dispatch came.
- Remote read (``POST .../api/v1/read``), from ``tests/test_http.py::
  TestRemoteRead``: for the same store and request the response bytes are
  the reference's, on both fronts; without ``snappy`` they go as
  ``identity``.
- No route answers 501 any more: every route the reference serves on one
  node answers, and without a cluster the shard commands and migration
  answer 404 and ``shardmap`` the store's shards, as the reference's do.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.http import promjson as ref_promjson
from filodb_tpu.http import remote_read as ref_rr
from filodb_tpu.http.fastserver import FastHttpServer as RefFast
from filodb_tpu.http.server import FiloHttpServer as RefThreaded
from filodb_tpu.testing.data import counter_series, counter_stream
from filodb_tpu.testing.data import histogram_series, histogram_stream
from filodb_tpu_torch.coordinator.ingestion import route_container
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import RecordContainer, SomeData
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.http import promjson
from filodb_tpu_torch.http import remote_read as rr
from filodb_tpu_torch.http.fastserver import FastHttpServer
from filodb_tpu_torch.http.server import FiloHttpServer

DS = "timeseries"
START = 1_600_000_000
FRONTS = {"fast": (RefFast, FastHttpServer),
          "threaded": (RefThreaded, FiloHttpServer)}


@pytest.fixture(scope="module")
def stores():
    """Five counters of 400 samples and two histograms over four shards,
    in a store of each package (the reference's ``test_http`` data)."""
    ref = TimeSeriesMemStore()
    for s in range(4):
        ref.setup(DS, s, RefConfig(max_chunk_size=100))
    port = MemStore(4, 1, config=StoreConfig(max_chunk_size=100))
    streams = [counter_stream(counter_series(5), 400,
                              start_ms=START * 1000),
               histogram_stream(histogram_series(2), 100,
                                start_ms=START * 1000)]
    for stream in streams:
        stream = list(stream)
        ingest_routed(ref, DS, stream, 4, 1)
        for sd in stream:
            cont = RecordContainer.deserialize(sd.container.serialize())
            for s, c in route_container(cont, 4, 1).items():
                port.shards[s].ingest(SomeData(c, sd.offset))
    return ref, port


@pytest.fixture(params=list(FRONTS))
def fronts(request, stores):
    """(reference front, port front) of the same kind over the stores."""
    ref_cls, port_cls = FRONTS[request.param]
    ref = ref_cls({DS: RefService(stores[0], DS, 4, spread=1)},
                  port=0).start()
    port = port_cls({DS: QueryService(stores[1], device="cpu")},
                    port=0).start()
    yield ref, port
    port.stop()
    ref.stop()


def _call(srv, path: str, body: bytes | None = None):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=body,
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ---- status/mesh ---------------------------------------------------------------


def test_status_mesh_is_one_process_with_the_engines_counters(stores):
    port = FiloHttpServer({DS: QueryService(stores[1], device="cpu")},
                          port=0).start()
    try:
        svc = port.services[DS]
        svc.query_range("sum(rate(http_requests_total[5m]))", START + 600,
                        60, START + 3000)
        code, _, body = _call(port, "/api/v1/status/mesh")
        assert code == 200
        data = json.loads(body)["data"]
        assert list(data) == [DS]
        entry = data[DS]
        assert entry["multiproc"] is False
        # the reference's engine keys, and the kernels' launches
        assert set(entry["engine"]) == {"hits", "misses", "batch_cache",
                                        "programs", "launches"}
        assert entry["engine"]["batch_cache"] == len(svc.batches.batches())
        assert entry["engine"]["batch_cache"] >= 1
        assert set(entry["engine"]["launches"]) == {
            "decode_ts_page", "decode_f32_page", "fused_decode_rate",
            "windowed_sum"}
        code, _, body = _call(port, "/api/v1/status/mesh?dataset=nope")
        assert code == 200 and json.loads(body)["data"] == {}
    finally:
        port.stop()


@pytest.mark.parametrize("front", list(FRONTS))
def test_status_mesh_is_multiproc_with_a_runtime(stores, front):
    from filodb_tpu_torch.coordinator.mesh_cluster import MeshClusterRuntime
    from filodb_tpu_torch.parallel.multiproc import (
        MeshWorker,
        _ShardSliceStore,
    )

    workers = [MeshWorker(_ShardSliceStore(stores[1], DS, lo, lo + 2), DS,
                          (lo, lo + 2), device="cpu").start()
               for lo in (0, 2)]
    svc = QueryService(stores[1], device="cpu")
    svc.mesh_cluster = rt = MeshClusterRuntime(
        stores[1], DS, 4, [("127.0.0.1", w.port, w.shard_range)
                           for w in workers], device="cpu")
    port = FRONTS[front][1]({DS: svc}, port=0).start()
    try:
        res = svc.query_range("sum(rate(http_requests_total[5m]))",
                              START + 600, 60, START + 3000)
        assert res.stats.engine == "mesh-proc"
        code, _, body = _call(port, "/api/v1/status/mesh")
        assert code == 200
        entry = json.loads(body)["data"][DS]
        assert entry["multiproc"] is True
        # the reference's runtime keys, and this process's engine
        assert {"dataset", "num_shards", "enabled", "workers",
                "last_collective_s", "engine"} <= set(entry)
        assert entry["enabled"] and entry["last_collective_s"] >= 0
        assert [w["shards"] for w in entry["workers"]] == [[0, 2], [2, 4]]
        for w in entry["workers"]:
            assert w["reachable"] and w["devices"] == 1
            assert w["breaker"] == "closed" and w["queries"] == 1
            assert set(w["launches"]) == set(entry["engine"]["launches"])
    finally:
        port.stop()
        rt.shutdown()
        for w in workers:
            w.stop()


# ---- decodeMs and reduceMs -------------------------------------------------------


def _full_stats(result) -> dict:
    return json.loads(promjson.matrix_json_str(result, True))["queryStats"]


@pytest.mark.parametrize("valve", ["0", "1"])
def test_decode_and_reduce_ms_on_exec_and_sidecar_leaves(stores, valve,
                                                         monkeypatch):
    """An exec leaf on the decode lane (valve 0) times its batch build and
    its windowing; at valve 1 a tick-shaped query's leaves fold in the
    sidecar lane, whose whole fold is its decode stage."""
    monkeypatch.setenv("FILODB_SIDECARS", valve)
    ref = RefService(stores[0], DS, 4, spread=1)
    svc = QueryService(stores[1], device="cpu", engine="exec")
    # a 40-minute window spans whole chunks, which the lane folds
    q = "sum(rate(http_requests_total[40m])) by (job)"
    t = START + 3900
    got = svc.query_range(q, t, 60, t)
    want = ref.query_range(q, t, 60, t)
    assert (got.stats.sidecar_chunks > 0) == (valve == "1")
    stats = _full_stats(got)
    ref_stats = json.loads(ref_promjson.matrix_json_str(
        want, full_stats=True))["queryStats"]
    assert set(ref_stats) - set(stats) == set()
    assert stats["wireBytes"] == 0  # nothing left the process
    assert stats["decodeMs"] > 0 and stats["reduceMs"] > 0
    assert got.stats.decode_s > 0 and got.stats.reduce_s > 0
    assert ref_stats["decodeMs"] >= 0 and ref_stats["reduceMs"] >= 0


def test_decode_ms_on_the_pyramid_lane(tmp_path):
    from test_torch_pyramids import ALIGNED, Env

    env = Env(tmp_path)
    got = env.port_run("sum_over_time(heap_usage[4000s])", *ALIGNED)
    assert got.stats.pyramid.get("segmentNodes", 0) \
        + got.stats.pyramid.get("chunkNodes", 0) > 0
    stats = _full_stats(got)
    assert stats["decodeMs"] > 0 and stats["reduceMs"] >= 0


def test_mesh_leaves_time_no_stage_and_merge_counts_adds_them(stores):
    """The mesh engine sets neither, as the reference's; a sub-query's
    timings fold into its parent's (the extent cache's merge)."""
    from filodb_tpu_torch.query.model import QueryStats

    got = QueryService(stores[1], device="cpu").query_range(
        "sum(rate(http_requests_total[5m]))", START + 600, 60, START + 3000)
    assert got.stats.engine == "mesh"
    stats = _full_stats(got)
    assert stats["decodeMs"] == 0 and stats["reduceMs"] == 0
    parent, child = QueryStats(), QueryStats(decode_s=0.25, reduce_s=0.5)
    parent.merge_counts(child)
    parent.merge_counts(child)
    assert (parent.decode_s, parent.reduce_s) == (0.5, 1.0)


# ---- remote read -----------------------------------------------------------------


def _read_request(start_ms: int, end_ms: int, matchers) -> bytes:
    body = b""
    for mtype, name, value in matchers:
        body += rr._ld(3, rr._key(1, 0) + rr._varint(mtype)
                       + rr._ld(2, name.encode()) + rr._ld(3, value.encode()))
    query = (rr._key(1, 0) + rr._varint(start_ms) + rr._key(2, 0)
             + rr._varint(end_ms) + body)
    return rr._ld(1, query)


READS = [
    [(0, "__name__", "http_requests_total")],
    [(0, "__name__", "http_requests_total"), (2, "job", "job-[01]")],
    [(1, "instance", "instance-3"), (0, "__name__", "http_requests_total")],
]


@pytest.mark.parametrize("matchers", READS, ids=["name", "regex", "neq"])
def test_remote_read_bytes_are_the_references(fronts, matchers):
    ref, port = fronts
    req = _read_request(START * 1000, (START + 4000) * 1000, matchers)
    code, headers, body = _call(port, f"/promql/{DS}/api/v1/read", req)
    rcode, rheaders, rbody = _call(ref, f"/promql/{DS}/api/v1/read", req)
    assert code == rcode == 200
    assert body == rbody and body
    assert headers["Content-Type"] == "application/x-protobuf"
    assert headers["Content-Encoding"] == rheaders["Content-Encoding"] == (
        "snappy" if rr.HAVE_SNAPPY else "identity")


def test_remote_read_round_trip(fronts):
    """The reference's case: 5 series of 400 samples, histograms left
    out, labels under ``__name__``."""
    _, port = fronts
    req = _read_request(START * 1000, (START + 4000) * 1000,
                        [(0, "__name__", "http_requests_total")])
    code, _, payload = _call(port, f"/promql/{DS}/api/v1/read",
                             rr.maybe_compress(req))
    assert code == 200
    payload = rr.maybe_decompress(payload)
    n_series = n_samples = 0
    for field, _, qr in rr._iter_fields(payload):
        assert field == 1
        for _, _, ts_msg in rr._iter_fields(qr):
            n_series += 1
            labels = {}
            for f3, _, v in rr._iter_fields(ts_msg):
                if f3 == 1:
                    kv = {f4: x.decode() for f4, _, x in rr._iter_fields(v)}
                    labels[kv[1]] = kv[2]
                elif f3 == 2:
                    n_samples += 1
            assert labels["__name__"] == "http_requests_total"
    assert (n_series, n_samples) == (5, 5 * 400)
    hist = _read_request(START * 1000, (START + 4000) * 1000,
                         [(0, "__name__", "http_req_latency")])
    code, _, payload = _call(port, f"/promql/{DS}/api/v1/read", hist)
    assert code == 200
    assert list(rr._iter_fields(rr.maybe_decompress(payload))) == \
        [(1, 2, b"")]


def test_remote_read_samples_are_exact_float64(stores):
    """Values float32 does not hold come back as ingested."""
    port = MemStore(1, 0)
    labels = {"_metric_": "big", "_ws_": "w", "_ns_": "n"}
    ts = START * 1000 + np.arange(50) * 10_000
    vals = 1e12 + np.arange(50) * 0.125
    port.ingest(labels, ts, vals, schema="gauge")
    port.seal(labels, schema="gauge")
    port.ingest(labels, ts + 500_000, vals + 7.0, schema="gauge")
    q = rr.decode_read_request(_read_request(
        0, 2**62, [(0, "__name__", "big")]))[0]
    (got_labels, got_ts, got_vals), = rr.read_series(port, q)
    assert dict(got_labels)["_metric_"] == "big"
    np.testing.assert_array_equal(got_ts, np.concatenate([ts, ts + 500_000]))
    np.testing.assert_array_equal(got_vals,
                                  np.concatenate([vals, vals + 7.0]))


def test_request_decode_is_the_references():
    matcher = (rr._key(1, 0) + rr._varint(2)
               + rr._ld(2, b"job") + rr._ld(3, b"api.*"))
    req = rr._ld(1, rr._key(1, 0) + rr._varint(1000) + rr._key(2, 0)
                 + rr._varint(2000) + rr._ld(3, matcher))
    out, want = rr.decode_read_request(req), ref_rr.decode_read_request(req)
    assert out[0]["start_ms"] == 1000 and out[0]["end_ms"] == 2000
    f = out[0]["filters"][0]
    assert f.column == "job" and type(f.filter).__name__ == "EqualsRegex"
    assert [(str(f.column), type(f.filter).__name__, f.filter.pattern)
            for f in out[0]["filters"]] == \
        [(str(f.column), type(f.filter).__name__, f.filter.pattern)
         for f in want[0]["filters"]]


# ---- nothing answers 501 ------------------------------------------------------------


SERVED = ["/api/v1/rules", "/api/v1/alerts", "/api/v1/status/tsdb",
          "/api/v1/status/ingest", "/api/v1/status/tiers",
          "/api/v1/status/mesh", f"/promql/{DS}/api/v1/rules",
          f"/promql/{DS}/api/v1/alerts"]
A7 = [f"/api/v1/cluster/{DS}/{cmd}" for cmd in
      ("startshards", "stopshards", "shardmap", "migrate")]


def test_only_the_multi_node_routes_answer_501(stores):
    port = FastHttpServer({DS: QueryService(stores[1], device="cpu")},
                          port=0).start()
    try:
        for path in SERVED:
            code, _, _ = _call(port, path)
            assert code == 200, path
        code, _, _ = _call(port, f"/promql/{DS}/api/v1/read",
                           _read_request(0, 1, [(0, "__name__", "x")]))
        assert code == 200
        # since high availability came none answers 501: without a
        # cluster the shard commands and migrate answer 404 and the
        # shardmap the store's shards, as the reference's do
        for path in A7:
            code, _, body = _call(port, path)
            want = 200 if path.endswith("shardmap") else 404
            assert code == want, (path, code)
            if code == 200:
                assert [e["shard"] for e in
                        json.loads(body)["data"]["shards"]] == \
                    list(range(len(stores[1].shards)))
    finally:
        port.stop()
    assert os.environ.get("FILODB_SIDECARS") is None
