"""The HTTP API: the Prometheus query API and the node's admin routes.

Port of ``filodb_tpu/http/server.py``'s ``HttpDispatcher`` and
``FiloHttpServer``. Routes:

- ``GET /promql/{dataset}/api/v1/query_range?query=&start=&end=&step=``
- ``GET/POST /promql/{dataset}/api/v1/query?query=&time=`` (a form POST
  carries the parameters in its body)
- ``GET /promql/{dataset}/api/v1/series?match[]=&start=&end=``
- ``GET /promql/{dataset}/api/v1/labels``
- ``GET /promql/{dataset}/api/v1/label/{name}/values``
- ``GET /promql/{dataset}/api/v1/debug/trace?query=&start=&end=&step=``
  (or ``&time=``): the query run traced, its spans and stats
- ``GET /promql/{dataset}/api/v1/debug/slow_queries?limit=``: the
  slow-query ring, newest first
- ``GET /promql/{dataset}/api/v1/debug/costmodel?limit=``: the cost
  model's estimates, calibration and recent decisions
- ``POST /promql/{dataset}/api/v1/read``: Prometheus remote read
  (``http/remote_read.py``)
- ``GET /api/v1/rules`` and ``/api/v1/alerts`` (every dataset's), and
  ``/promql/{dataset}/api/v1/rules`` and ``.../alerts`` (one dataset's):
  the rule managers' groups and active alerts (``app.rule_managers``)
- ``GET /api/v1/cluster`` (datasets) and ``/api/v1/cluster/{dataset}/status``
  (a member answers from its mirror of the coordinator's map,
  ``shard_maps``); ``.../shardmap`` (each shard's node, status, covered
  offset, replica set with the followers' applied offsets and migration
  in flight, and the tenants' series against their quotas); on the
  coordinator ``.../startshards`` and ``.../stopshards``
  (``shards=0,1``, ``node=``) and ``GET/POST .../migrate?shard=&dest=``
  (a live migration, started on a thread of its own)
- ``GET /api/v1/status/tsdb?dataset=&topk=``: each shard's series and
  encode counts, and the top metrics and labels by cardinality
- ``GET /api/v1/status/ingest?dataset=&limit=``: each shard's ingest
  freshness and offsets, the object store's upload queue, the rule groups'
  watermark lag and the slow-ingest ring
- ``GET /api/v1/status/tiers?dataset=``: each dataset's retention tiers,
  their floors and series (``query/federation.py::tier_status``)
- ``GET /api/v1/status/mesh?dataset=``: ``multiproc: false`` and the
  engine's counters (one process; the multi-process runtime is §A.12)
- ``GET /__health``, ``GET /metrics`` (Prometheus exposition)

Status codes and error envelopes are the reference's: 400 for a parse
error or a bad parameter, 404 for an unknown dataset or route, 422 for a
query limit or a budget in ``degrade="error"``, 503 with ``Retry-After``
for a query the governor shed (``unavailable``) or whose deadline passed
(``timeout``), 500 (``internal``) for anything else. ``?stats=all``
renders the basic stats,
the counters the port keeps beside them (``wireBytes``, ``decodeMs`` and
``reduceMs`` among them), a federated query's per-tier buckets and the
pyramid lane's keys. A partial answer (a budget's, or a gather that lost
children) carries ``partial`` and ``warnings``.

The hot routes (``query`` and ``query_range``) go through the rendered-
response cache (``ResponseCache``, ``response_cache=True`` by default, as
the reference's ``http_response_cache``): the rendered body is kept under
the resolved query parameters and the service's construction serial, and
served while the store's version (``service_version``: the sum of its
shards' versions) has not moved, and bypassed while shards of the
dataset are other nodes'. Any ingested row moves it, so under
live ingest the extent cache below answers instead. A miss runs through
``app.batched(svc)``: on this threaded front a ``QueryBatcher`` a service
coalesces the queries of concurrent request threads into one
``query_range_many`` batch.

Two fronts share ``HttpDispatcher``: ``FiloHttpServer`` here (stdlib
threaded server, ``http_impl: "threaded"``) and
``http/fastserver.py::FastHttpServer`` (the default).
"""

from __future__ import annotations

import datetime as dt
import json
import logging
import socket
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from filodb_tpu_torch.coordinator.query_service import QueryBatcher
from filodb_tpu_torch.http import promjson
from filodb_tpu_torch.promql.parser import (
    ParseError,
    TimeStepParams,
    parse_query,
)
from filodb_tpu_torch.query import cost_model
from filodb_tpu_torch.query.model import QueryLimitExceeded
from filodb_tpu_torch.utils import metrics as metrics_mod
from filodb_tpu_torch.utils.governor import QueryRejected
from filodb_tpu_torch.utils.governor import config as governor_config
from filodb_tpu_torch.utils.metrics import render_prometheus
from filodb_tpu_torch.utils.resilience import DeadlineExceeded
from filodb_tpu_torch.utils.tracing import slow_ingest, slow_queries, start_trace

log = logging.getLogger(__name__)

JSON_CT = "application/json"

def retry_after_headers(after_s: float | None = None) -> dict:
    """``Retry-After`` of a 503, alike on both fronts: whole seconds, at
    least 1 (the governor's ``retry_after_s`` unless given)."""
    if after_s is None:
        after_s = governor_config().retry_after_s
    return {"Retry-After": str(max(1, int(round(float(after_s)))))}


def error_response(e: Exception) -> tuple[int, dict, dict] | None:
    """(status, extra headers, error body) of a query's failure that the
    API names, alike on both fronts; None for an internal error."""
    if isinstance(e, (ParseError, ValueError)):
        return 400, {}, promjson.error_json(str(e))
    if isinstance(e, QueryLimitExceeded):
        return 422, {}, promjson.error_json(str(e), "query_limit")
    if isinstance(e, QueryRejected):
        # shed by the admission gate: a distinct errorType from a timeout,
        # and Retry-After, so clients back off
        return 503, retry_after_headers(e.retry_after_s), \
            promjson.error_json(str(e), "unavailable")
    if isinstance(e, DeadlineExceeded):
        return 503, retry_after_headers(), \
            promjson.error_json(str(e), "timeout")
    return None


class ResponseCache:
    """Rendered bodies of hot queries, least recently used dropped past
    ``cap``: a key's entry serves while its service's version is the one
    it was stored at. Both fronts' request threads share it."""

    def __init__(self, cap: int = 1024):
        self.cap = cap
        self.hits = 0
        self.misses = 0
        self._lru: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: tuple, version: int) -> bytes | None:
        with self._lock:
            entry = self._lru.get(key)
            if entry is None or entry[0] != version:
                self.misses += 1
                return None
            self._lru.move_to_end(key)
            self.hits += 1
            return entry[1]

    def put(self, key: tuple, version: int, body: bytes) -> None:
        with self._lock:
            self._lru.pop(key, None)
            while len(self._lru) >= self.cap:
                self._lru.popitem(last=False)
            self._lru[key] = (version, body)


def service_version(svc) -> int | None:
    """The response cache's stamp for ``svc``: the sum of its store's shard
    versions (every ingest call moves it), and under a tiered planner its
    colder tiers' version (``version_token``). None (no caching) where
    shards of the dataset are other nodes' (``QueryService.shards_local``):
    their ingest never moves this stamp, as the reference bypasses the
    cache then."""
    if not svc.shards_local():
        return None
    tok = getattr(svc.planner, "version_token", None)
    return svc.memstore.version + (tok() if tok is not None else 0)


def response_cache_key(svc, kind: str, params: tuple) -> tuple:
    """The response cache's key, alike on both fronts: the service's
    construction ``serial`` (never ``id()``, which a later service may
    reuse), the kind, and the resolved parameters, (query, start, step,
    end) for a range, (query, time) for an instant query."""
    if kind == "instant":
        return (svc.serial, "instant", params[0], params[1])
    return (svc.serial, "range", *params)


def parse_time(s: str) -> float:
    """Unix seconds (float) or RFC 3339 (Grafana sends either)."""
    try:
        return float(s)
    except ValueError:
        return dt.datetime.fromisoformat(s.replace("Z", "+00:00")) \
            .timestamp()


class HttpDispatcher:
    """All routing and rendering, shared by both fronts. ``handle`` never
    raises: every outcome is a (status, headers, body) triple."""

    def __init__(self, app):
        self.app = app

    def handle(self, command: str, path: str, raw: bytes = b"",
               content_type: str = "") -> tuple[int, dict, bytes]:
        try:
            url = urlparse(path)
            qs = parse_qs(url.query)
            parts = [p for p in url.path.split("/") if p]
            if command == "POST":
                if parts[-1:] == ["read"]:
                    return self._remote_read(parts, raw)
                if raw and "x-www-form-urlencoded" in content_type:
                    for k, v in parse_qs(raw.decode()).items():
                        qs.setdefault(k, v)
            return self._dispatch(parts, qs)
        except Exception as e:  # noqa: BLE001 - every failure answers
            named = error_response(e)
            if named is not None:
                code, headers, body = named
                return self._json(code, body, headers)
            log.exception("request failed")
            return self._json(500, promjson.error_json(str(e), "internal"))

    @staticmethod
    def _json(code: int, payload,
              headers: dict | None = None) -> tuple[int, dict, bytes]:
        body = payload.encode() if isinstance(payload, str) \
            else json.dumps(payload).encode()
        return code, {"Content-Type": JSON_CT, **(headers or {})}, body

    def _dispatch(self, parts: list[str], qs: dict):
        if parts == ["__health"]:
            return self._json(200, {"status": "healthy"})
        if parts == ["metrics"]:
            return (200, {"Content-Type": "text/plain; version=0.0.4"},
                    render_prometheus().encode())
        if len(parts) >= 4 and parts[0] == "promql" \
                and parts[2] == "api" and parts[3] == "v1":
            svc = self.app.services.get(parts[1])
            if svc is None:
                return self._json(404, promjson.error_json(
                    f"unknown dataset {parts[1]}"))
            return self._prom_api(svc, parts[4:], qs)
        if len(parts) >= 3 and parts[:3] == ["api", "v1", "cluster"]:
            return self._cluster_api(parts[3:], qs)
        if parts == ["api", "v1", "rules"]:
            # every dataset's groups
            groups = [g for mgr in self.app.rule_managers.values()
                      for g in mgr.rules_snapshot()]
            return self._json(200, {"status": "success",
                                    "data": {"groups": groups}})
        if parts == ["api", "v1", "alerts"]:
            alerts = [a for mgr in self.app.rule_managers.values()
                      for a in mgr.alerts_snapshot()]
            return self._json(200, {"status": "success",
                                    "data": {"alerts": alerts}})
        if parts == ["api", "v1", "status", "tsdb"]:
            return self._status_tsdb(qs)
        if parts == ["api", "v1", "status", "ingest"]:
            return self._status_ingest(qs)
        if parts == ["api", "v1", "status", "tiers"]:
            return self._status_tiers(qs)
        if parts == ["api", "v1", "status", "mesh"]:
            return self._status_mesh(qs)
        return self._json(404, promjson.error_json("not found", "not_found"))

    # ---- the Prometheus API --------------------------------------------------

    @staticmethod
    def range_params(qs: dict) -> tuple[str, int, int, int]:
        """(query, start, step, end) of a query_range request."""
        return (qs["query"][0], int(parse_time(qs["start"][0])),
                int(float(qs.get("step", ["60"])[0])),
                int(parse_time(qs["end"][0])))

    @staticmethod
    def instant_params(qs: dict) -> tuple[str, int]:
        """(query, time) of an instant query; the server's clock when no
        time is given, as Prometheus does."""
        if "time" in qs:
            return qs["query"][0], int(parse_time(qs["time"][0]))
        return qs["query"][0], int(time.time())

    def _cached_query(self, svc, kind: str, params: tuple,
                      full_stats: bool = False):
        """A hot query through the response cache; a miss runs through
        ``app.batched(svc)`` and stores its rendered body. ``full_stats``
        (``?stats=all``) renders the full stats, a body of its own."""
        cache = self.app.response_cache
        version = service_version(svc) if cache is not None else None
        if version is None:
            cache = None  # remote shards: the stamp does not see them
        if cache is not None:
            key = response_cache_key(svc, kind, params)
            if full_stats:
                key = key + ("stats",)
            body = cache.get(key, version)
            if body is not None:
                return 200, {"Content-Type": JSON_CT}, body
        r = self.app.batched(svc).query_range(*params)
        out = self._json(200, promjson.matrix_json_str(r, full_stats)
                         if kind == "range"
                         else promjson.vector_json_str(r, full_stats))
        if cache is not None:
            cache.put(key, version, out[2])
        return out

    def _prom_api(self, svc, rest: list[str], qs: dict):
        full = qs.get("stats", [""])[0] == "all"
        if rest == ["query_range"]:
            return self._cached_query(svc, "range", self.range_params(qs),
                                      full)
        if rest == ["query"]:
            query, t = self.instant_params(qs)
            return self._cached_query(svc, "instant", (query, t, 0, t), full)
        if rest == ["series"]:
            start = int(parse_time(qs.get("start", ["0"])[0]))
            end = int(parse_time(qs.get("end", ["9999999999"])[0]))
            out = []
            for mtext in qs.get("match[]", []):
                plan = parse_query(mtext, TimeStepParams(start, 0, end))
                raw = getattr(plan, "raw", None)
                filters = raw.filters if raw is not None else ()
                for lm in svc.series(list(filters), start, end):
                    out.append({("__name__" if k == "_metric_" else k): v
                                for k, v in lm.items()})
            return self._json(200, {"status": "success", "data": out})
        if rest == ["labels"]:
            names = [("__name__" if n == "_metric_" else n)
                     for n in svc.label_names()]
            return self._json(200, {"status": "success", "data": names})
        if len(rest) == 3 and rest[0] == "label" and rest[2] == "values":
            label = unquote(rest[1])
            if label == "__name__":
                label = "_metric_"
            return self._json(200, {"status": "success",
                                    "data": svc.label_values(label)})
        if rest == ["rules"]:
            mgr = self.app.rule_managers.get(svc.dataset)
            return self._json(200, {"status": "success", "data": {
                "groups": mgr.rules_snapshot() if mgr is not None else []}})
        if rest == ["alerts"]:
            mgr = self.app.rule_managers.get(svc.dataset)
            return self._json(200, {"status": "success", "data": {
                "alerts": mgr.alerts_snapshot() if mgr is not None else []}})
        if rest[:1] == ["debug"]:
            return self._debug(svc, rest[1:], qs)
        return self._json(404, promjson.error_json("unknown endpoint"))

    def _remote_read(self, parts: list[str], body: bytes):
        """Prometheus remote read (``http/remote_read.py``): each query's
        raw samples, float64 as ingested (``Shard.exact_samples``);
        histograms are left out, as remote-read v1 has them. Without the
        ``snappy`` module the body goes both ways uncompressed and says
        ``identity``, as the reference's ``HAVE_SNAPPY = False``."""
        from filodb_tpu_torch.http import remote_read as rr

        if len(parts) < 2 or parts[0] != "promql":
            return self._json(404, promjson.error_json("not found"))
        svc = self.app.services.get(parts[1])
        if svc is None:
            return self._json(404, promjson.error_json(
                f"unknown dataset {parts[1]}"))
        try:
            queries = rr.decode_read_request(rr.maybe_decompress(body))
        except Exception:  # noqa: BLE001 - any undecodable body
            return self._json(501 if not rr.HAVE_SNAPPY else 400,
                              promjson.error_json(
                                  "could not decode read request "
                                  "(snappy unavailable?)"))
        results = [rr.read_series(svc.memstore, q) for q in queries]
        return (200, {"Content-Type": "application/x-protobuf",
                      "Content-Encoding":
                          "snappy" if rr.HAVE_SNAPPY else "identity"},
                rr.maybe_compress(rr.encode_read_response(results)))

    @staticmethod
    def _limit(qs: dict, default: int = 0) -> int:
        try:
            return int(qs.get("limit", [str(default)])[0])
        except ValueError:
            return default

    def _debug(self, svc, rest: list[str], qs: dict):
        """The reference's ``debug/trace``, ``debug/slow_queries`` and
        ``debug/costmodel``."""
        if rest == ["trace"]:
            # this one query traced, whatever the sampling rate
            if "start" in qs:
                query, start, step, end = self.range_params(qs)
            else:
                query, t = self.instant_params(qs)
                start, step, end = t, 0, t
            with start_trace() as trace:
                r = svc.query_range(query, start, step, end)
            return self._json(200, {
                "status": "success",
                "data": {"spans": trace.as_dicts(),
                         "result_series": r.result.num_series,
                         "stats": {
                             "series_scanned": r.stats.series_scanned,
                             "samples_scanned": r.stats.samples_scanned,
                             "wall_time_s": r.stats.wall_time_s,
                         }}})
        if rest == ["slow_queries"]:
            limit = self._limit(qs)
            entries = [e for e in slow_queries()
                       if e.get("dataset") in (None, svc.dataset)]
            if limit > 0:
                entries = entries[:limit]
            return self._json(200, {"status": "success",
                                    "data": {"slow_queries": entries}})
        if rest == ["costmodel"]:
            snap = cost_model.model_for(svc.dataset).snapshot()
            limit = self._limit(qs)
            if limit > 0:
                snap["estimates"] = snap["estimates"][:limit]
            return self._json(200, {"status": "success", "data": snap})
        return self._json(404, promjson.error_json("unknown endpoint"))

    def _status_datasets(self, qs: dict) -> dict:
        """The services, filtered by an optional ``?dataset=``."""
        want = qs.get("dataset", [None])[0]
        return {name: svc for name, svc in self.app.services.items()
                if want is None or name == want}

    def _status_tsdb(self, qs: dict):
        """Prometheus-shaped TSDB status, as the reference's: each shard's
        series, index and encode counts, and the top ``topk`` metrics by
        active series (from the shards' cardinality trees) and labels by
        distinct values."""
        try:
            k = max(1, int(qs.get("topk", ["10"])[0]))
        except ValueError:
            k = 10
        data = {}
        for name, svc in self._status_datasets(qs).items():
            by_metric: dict[str, dict] = {}
            by_label: dict[str, int] = {}
            shards = []
            num_series = 0
            for sh in svc.memstore.shards:
                root = sh.cardinality.cardinality([])
                num_series += root.active_ts
                shards.append({
                    "shard": sh.shard_num,
                    "numSeries": root.active_ts,
                    "totalSeries": root.total_ts,
                    "indexRamBytes": sh.index.ram_bytes,
                    "encodedBytes": sh.stats.encoded_bytes.value,
                    "samplesEncoded": sh.stats.samples_encoded.value,
                    "chunksFlushed": sh.stats.chunks_flushed.value,
                    "partitionsEvicted": sh.stats.partitions_evicted.value,
                })
                tracker = sh.cardinality
                # the tree's ws -> ns -> metric levels, metric counts summed
                # over prefixes and shards
                for ws in tracker.top_k([], 1000):
                    for ns in tracker.top_k([ws.name], 1000):
                        for mc in tracker.top_k([ws.name, ns.name], 1000):
                            agg = by_metric.setdefault(
                                mc.name, {"active": 0, "total": 0})
                            agg["active"] += mc.active_ts
                            agg["total"] += mc.total_ts
                for label in sh.label_names():
                    by_label[label] = max(by_label.get(label, 0),
                                          len(sh.label_values(label)))
            top_metrics = sorted(by_metric.items(),
                                 key=lambda kv: -kv[1]["active"])[:k]
            top_labels = sorted(by_label.items(), key=lambda kv: -kv[1])[:k]
            data[name] = {
                "headStats": {"numSeries": num_series,
                              "numShards": len(shards)},
                "shards": shards,
                "seriesCountByMetricName": [
                    {"name": m, "value": v["active"],
                     "totalValue": v["total"]} for m, v in top_metrics],
                "labelValueCountByLabelName": [
                    {"name": label, "value": v} for label, v in top_labels],
            }
        return self._json(200, {"status": "success", "data": data})

    def _status_mesh(self, qs: dict):
        """The mesh runtime's status. A dataset with a multi-process
        runtime (``mesh_workers``) answers ``multiproc: true`` with the
        runtime's ``status()`` (each worker's slice, breaker, devices,
        caches, launches; the last collective's seconds); any other
        ``multiproc: false``. Both carry this process's engine counters,
        the reference's keys (the window cache's hits and misses, the
        batches held, the hand-written kernels loaded) and the kernels'
        launches since boot."""
        from filodb_tpu_torch import _build
        from filodb_tpu_torch.parallel import mesh_engine

        programs = sum(1 for n in _build._libs if n in _build.SOURCES)
        data = {}
        for name, svc in self._status_datasets(qs).items():
            rt = getattr(svc, "mesh_cluster", None)
            entry = {**rt.status(), "multiproc": True} if rt is not None \
                else {"multiproc": False}
            data[name] = {**entry, "engine": {
                "hits": mesh_engine._M_EVAL["hit"].value,
                "misses": mesh_engine._M_EVAL["miss"].value,
                "batch_cache": len(svc.batches.batches()),
                "programs": programs,
                "launches": dict(_build.LAUNCHES),
            }}
        return self._json(200, {"status": "success", "data": data})

    def _status_tiers(self, qs: dict):
        """Each dataset's retention tiers (memstore, cold raw, downsample):
        their floors and series, the face of tier federation."""
        from filodb_tpu_torch.query import federation

        data = {name: federation.tier_status(name, svc)
                for name, svc in self._status_datasets(qs).items()}
        return self._json(200, {"status": "success", "data": data})

    def _status_ingest(self, qs: dict):
        """Each shard's ingest freshness (lag against the wall clock, the
        log's offsets and the checkpoint watermarks), the object store's
        upload queue, the gateway's queue depth, each rule group's
        watermark lag and the slow-ingest ring, as the reference's
        route."""
        from filodb_tpu_torch.core.store import objectstore

        cluster = self.app.cluster
        now = time.time()
        data = {"datasets": {}}
        for name, svc in self._status_datasets(qs).items():
            shards = []
            for sh in svc.memstore.shards:
                lag = (None if sh.max_ingested_ts < 0
                       else max(0.0, now - sh.max_ingested_ts / 1000.0))
                entry = {"shard": sh.shard_num,
                         "maxIngestedTs": sh.max_ingested_ts,
                         "ingestLagSeconds": lag,
                         "ingestedOffset": sh.latest_offset,
                         "groupWatermarks": [
                             int(w) for w in sh.group_watermarks]}
                log_ = cluster.logs.get((name, sh.shard_num)) \
                    if cluster is not None else None
                if log_ is not None:
                    entry["logLatestOffset"] = log_.latest_offset
                    entry["offsetLag"] = log_.offset_lag(sh.latest_offset)
                    entry["checkpointLag"] = log_.offset_lag(
                        int(min(sh.group_watermarks, default=-1)))
                shards.append(entry)
            data["datasets"][name] = {"shards": shards}
        data["objectstore"] = {
            "queueDepth": objectstore.QUEUE_DEPTH.value,
            "oldestTaskAgeSeconds": objectstore._oldest_task_age(),
        }
        # gauges of objects this server does not hold (the gateway's sink,
        # the rule groups) are read from the registry by family name
        with metrics_mod._lock:
            fams = list(metrics_mod._registry.values())
        for m in fams:
            if m.name == "gateway_queue_depth" and m.value is not None:
                data["gatewayQueueDepth"] = m.value
            elif m.name == "filodb_rules_watermark_lag_seconds" \
                    and m.tags.get("group"):  # not the untagged anchor
                data.setdefault("rulesWatermarkLagSeconds", {})[
                    m.tags["group"]] = m.value
        data["slowIngest"] = slow_ingest(self._limit(qs, 20))
        return self._json(200, {"status": "success", "data": data})

    # ---- cluster admin -------------------------------------------------------

    def _cluster_api(self, rest: list[str], qs: dict):
        """``/api/v1/cluster``: the datasets, a dataset's ``status``, and
        on the coordinator the shard commands ``startshards`` /
        ``stopshards`` (``shards=0,1`` and ``node=``), ``shardmap`` and
        ``migrate`` (``shard=`` and ``dest=``; the migration runs on a
        thread of its own), as the reference's answers them."""
        cluster = self.app.cluster
        if not rest:
            return self._json(200, {"status": "success",
                                    "data": list(self.app.services)})
        dataset = rest[0]
        if len(rest) == 2 and rest[1] in ("startshards", "stopshards") \
                and cluster is not None:
            return self._shard_commands(cluster, dataset, rest[1], qs)
        if len(rest) == 2 and rest[1] == "status":
            mirror = self.app.shard_maps.get(dataset)
            if cluster is not None:
                data = cluster.shard_statuses(dataset)
            elif mirror is not None:
                # a member: the coordinator's map, from its mirror
                data = mirror().snapshot()
            else:
                data = []
            return self._json(200, {"status": "success", "data": data})
        if len(rest) == 2 and rest[1] == "shardmap":
            return self._shardmap(dataset)
        if len(rest) == 2 and rest[1] == "migrate" and cluster is not None:
            try:
                shard = int(qs.get("shard", [""])[0])
            except ValueError:
                return self._json(400,
                                  promjson.error_json("shard must be an int"))
            dest = qs.get("dest", [""])[0]
            if not dest:
                return self._json(400, promjson.error_json("dest required"))

            def run():
                try:
                    cluster.migrate_shard(dataset, shard, dest)
                except Exception:
                    log.exception("migration of %s shard %d -> %s failed",
                                  dataset, shard, dest)

            threading.Thread(target=run, daemon=True,
                             name=f"migrate-{dataset}-{shard}").start()
            return self._json(200, {"status": "success",
                                    "data": {"dataset": dataset,
                                             "shard": shard, "dest": dest,
                                             "state": "started"}})
        return self._json(404, promjson.error_json("unknown cluster endpoint"))

    def _shard_commands(self, cluster, dataset: str, cmd: str, qs: dict):
        """Stop each shard of ``shards`` on its owner (STOPPED), or
        assign it to ``node`` (the first member without one) and start
        it there."""
        from filodb_tpu_torch.coordinator.shardmapper import (
            ShardEvent,
            ShardStatus,
        )

        shards = [int(x) for x in qs.get("shards", [""])[0].split(",") if x]
        node = qs.get("node", [None])[0]
        sm = cluster.shard_managers.get(dataset)
        if sm is None:
            return self._json(404, promjson.error_json(
                f"unknown dataset {dataset}"))
        done = []
        for shard in shards:
            if cmd == "stopshards":
                owner = sm.mapper.node_for(shard)
                if owner and owner in cluster.nodes:
                    cluster.nodes[owner].stop_shard(dataset, shard)
                    sm._publish(ShardEvent(shard, ShardStatus.STOPPED, None))
                    done.append(shard)
            else:
                target = node or next(iter(cluster.nodes), None)
                if target:
                    ev = ShardEvent(shard, ShardStatus.ASSIGNED, target)
                    sm._publish(ev)
                    cluster._on_event(dataset, ev)
                    done.append(shard)
        return self._json(200, {"status": "success", "data": done})

    def _shardmap(self, dataset: str):
        """Each shard's node, status, replica set and migration in
        flight, with the leader's covered offset and the followers'
        applied ones, and each tenant's active series against its quota
        (the reference's ``filo-cli shardmap`` backend)."""
        cluster = self.app.cluster
        svc = self.app.services.get(dataset)
        if cluster is not None:
            shards = cluster.shard_statuses(dataset)
            for entry in shards:
                mig = cluster.migrations.get((dataset, entry["shard"]))
                if mig is not None:
                    entry["migration"] = mig.snapshot()
                owner = entry.get("node")
                node = cluster.nodes.get(owner) if owner else None
                if node is not None:
                    try:
                        entry["watermark"] = node.shard_offset(
                            dataset, entry["shard"])
                    except Exception:  # noqa: BLE001 - the map still answers
                        pass
                for rep in entry.get("replicas", ()):
                    sy = cluster.replica_syncers.get(
                        (dataset, entry["shard"], rep["node"]))
                    if sy is not None:
                        rep["watermark"] = sy.applied
        elif dataset in self.app.shard_maps:
            shards = self.app.shard_maps[dataset]().snapshot()
        else:
            shards = [{"shard": s.shard_num, "status": "active",
                       "node": None}
                      for s in svc.memstore.shards] if svc else []
        trackers = [s.cardinality for s in svc.memstore.shards] \
            if svc else []
        tenants = []
        for tenant, tc in sorted(governor_config().tenants.items()):
            prefix = tenant.split("/")
            active = sum(t.cardinality(prefix).active_ts for t in trackers)
            tenants.append({
                "tenant": tenant,
                "active_series": active,
                "max_series": int(tc.get("max_series", 0) or 0),
                "max_inflight": int(tc.get("max_inflight", 0) or 0)})
        return self._json(200, {"status": "success",
                                "data": {"shards": shards,
                                         "tenants": tenants}})


class FiloHttpServer:
    """The threaded front end: one thread a connection, keep-alive; the
    hot queries of concurrent connections meet in one ``QueryBatcher`` a
    service (``batched``)."""

    def __init__(self, services: dict, host: str = "127.0.0.1",
                 port: int = 8080, cluster=None, reuse_port: bool = False,
                 response_cache: bool = True, rule_managers=None,
                 shard_maps=None):
        self.services = services
        self.cluster = cluster
        # a member's mirrors of the coordinator's map: dataset → a
        # callable giving its ``ShardMapper``
        self.shard_maps = shard_maps or {}
        # dataset -> RuleManager: /api/v1/rules and /api/v1/alerts
        self.rule_managers = rule_managers or {}
        self.response_cache = ResponseCache() if response_cache else None
        self._batchers: dict[int, QueryBatcher] = {}
        self._batchers_lock = threading.Lock()
        self.dispatcher = HttpDispatcher(self)
        cls = _ReusePortHTTPServer if reuse_port else ThreadingHTTPServer
        self.httpd = cls((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def batched(self, svc) -> QueryBatcher:
        """The service's batcher, made on first use."""
        with self._batchers_lock:
            b = self._batchers.get(svc.serial)
            if b is None:
                b = self._batchers[svc.serial] = QueryBatcher(svc)
            return b

    def start(self) -> "FiloHttpServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="http")
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for b in self._batchers.values():
            b.close()


class _ReusePortHTTPServer(ThreadingHTTPServer):
    """SO_REUSEPORT: several server processes share one port."""

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def _make_handler(server: FiloHttpServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def do_GET(self):
            self._route()

        def do_POST(self):
            self._route()

        def _route(self):
            raw = b""
            if self.command == "POST":
                try:
                    ln = int(self.headers.get("Content-Length") or 0)
                    if ln < 0:
                        raise ValueError("negative Content-Length")
                except ValueError as e:
                    # an unreadable length desyncs the connection: answer
                    # 400 and close it
                    self.close_connection = True
                    self._send(400, {"Content-Type": JSON_CT}, json.dumps(
                        promjson.error_json(str(e))).encode())
                    return
                raw = self.rfile.read(ln) if ln else b""
            self._send(*server.dispatcher.handle(
                self.command, self.path, raw,
                self.headers.get("Content-Type", "")))

        def _send(self, code: int, headers: dict, body: bytes):
            self.send_response(code)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler
