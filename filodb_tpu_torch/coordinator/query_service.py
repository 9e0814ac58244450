"""Query facade: PromQL text → ``QueryResult`` on the card.

Port of the query and metadata paths of
``filodb_tpu/coordinator/query_service.py``: ``query_range`` and
``query_instant`` (steps ``(t, 0, t)``) parse (``_parse_cached``, a memo of
256 plans), run on one of the two engines and materialize;
``label_names``, ``label_values`` and ``series`` answer from the shards'
part-key indexes, and ``chunk_infos`` from their chunk tables, on the
host. A range answer's ``StepMatrix`` renders with
``http.promjson.matrix_json``, an instant one with ``vector_json`` or, for
a scalar expression, ``scalar_json``. A query may carry a
``QueryContext``: its ``PlannerParams.spread`` overrides the planner's
spread (per shard key in ``planner.spread_overrides``) for the exec
engine, and its ``sample_limit`` bounds the answer's samples.

``engine`` picks the engine, as the reference's does:

- ``"mesh"`` (the default, as ``standalone`` boots the reference): the
  one-card split pipeline (``parallel/mesh_engine.py``); a plan that it
  does not ``supports`` runs through the planner and the exec engine
  instead, decided before either runs, as the reference falls back for
  the plans its mesh engine does not support. An ``UnsupportedQuery``
  that the mesh engine raises while it runs routes too, as a backstop;
  any other exception reaches the caller;
- ``"exec"``: ``SingleClusterPlanner`` materializes the exec plan tree
  (``query/exec/plan.py``), a leaf a shard.

The service's mesh engine delegates, as the reference's production
service does: a grid of at most two steps over a function the sidecar
lane serves goes to exec, whose leaves fold it from the chunks' summaries
(``query/engine/sidecar_lane.py``).

``result_cache`` (off by default, as the reference's dataclass has it; a
node turns it on from its config) puts the extent result cache
(``query/result_cache.py``) in front of both engines: ``execute_logical``
answers from it where it does not bypass the plan, and it evaluates each
missing extents through ``_execute_many_uncached``.

``query_range_many`` answers many range queries at once, as the
reference's: each is parsed, then looked up in the extent cache; the rest
go to the mesh engine's ``execute_many`` (one shared batch a leaf
signature) and those it does not serve to exec; the answers still on the
card come to the host in one copy a shape group; limits and stats are
applied after. Only ``UnsupportedQuery`` routes a query to exec: any other
exception reaches the caller or, with ``return_errors``, stands at its
query's position (the reference sends every member to exec when its
batch raises, which would hide a kernel that failed; ROADMAP §C).
``QueryBatcher`` coalesces the queries of concurrent threads into such
batches (the threaded HTTP front end).

``QueryStats.engine`` records which engine answered and
``QueryStats.fallback`` why mesh handed the plan on. Both engines keep
their uploaded batches in one ``BatchCache``, under one budget of device
memory, and their group ids in one ``GroupIdCache``.

Threads share a service (the HTTP front ends, a node's callers): its
queries run one at a time under ``lock`` (re-entrant; the engines' caches
are not shared between two queries in flight; a batch takes it once),
while the shards' locks let ingest and flushes go on between a query's
selections. The metadata calls take only the shards' locks.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

import torch

from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.device import resolve
from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.engine.device_batch import BatchCache
from filodb_tpu_torch.query.exec.plan import ExecContext
from filodb_tpu_torch.query.exec.transformers import GroupIdCache
from filodb_tpu_torch.query.model import (
    QueryContext,
    QueryResult,
    QueryStats,
    UnsupportedQuery,
    enforce_limits,
)
from filodb_tpu_torch.query.result_cache import ResultCache

ENGINES = ("mesh", "exec")
_PLAN_MEMO = 256  # parsed plans kept by ``_parse_cached``


class QueryService:
    """Serves queries over ``memstore`` on ``device`` (default: the CUDA
    card; ``device="cpu"`` runs every kernel's plain version) with
    ``engine`` ``"mesh"`` (falling back to exec) or ``"exec"``;
    ``time_split_ms`` > 0 has the planner split longer ranges;
    ``result_cache`` (a ``result_cache`` config block, True, or a
    ``ResultCache``; None or False: off) caches range answers by extent.
    The batches both engines keep take at most half the card's memory
    (``batches.budget``)."""

    # construction serials: a response-cache key names its service by it,
    # never by ``id()``, which a later service can reuse
    _serials = itertools.count(1)

    def __init__(self, memstore: MemStore,
                 device: "str | torch.device | None" = None,
                 engine: str = "mesh", time_split_ms: int = 0,
                 result_cache=None):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: one of {ENGINES}")
        self.memstore = memstore
        self.device = resolve(device)
        self.engine = engine
        self.serial = next(QueryService._serials)
        self.batches = BatchCache(self.device)
        self.gids = GroupIdCache()
        self.mesh = MeshQueryEngine(self.device, self.batches, self.gids,
                                    sidecars=True)
        self.planner = SingleClusterPlanner(memstore.num_shards,
                                            memstore.spread,
                                            time_split_ms=time_split_ms)
        self.result_cache = ResultCache.from_config(result_cache)
        self.lock = threading.RLock()
        self._plans: dict = {}

    def query_range(self, promql: str, start_sec: int, step_sec: int,
                    end_sec: int, qcontext: QueryContext | None = None
                    ) -> QueryResult:
        t0 = time.perf_counter()
        with self.lock:
            plan = self._parse_cached(promql, TimeStepParams(
                start_sec, step_sec, end_sec))
            result = self.execute_logical(plan, qcontext)
        result.stats.wall_time_s = time.perf_counter() - t0
        return result

    def query_instant(self, promql: str, time_sec: int,
                      qcontext: QueryContext | None = None) -> QueryResult:
        """The query at one instant: steps (t, 0, t), one step at t."""
        return self.query_range(promql, time_sec, 0, time_sec, qcontext)

    def _parse_cached(self, promql: str, params: TimeStepParams):
        """The plan of (``promql``, ``params``), parsed once: plans are
        immutable, and a dashboard cycles few. The caller holds ``lock``."""
        key = (promql, params.start, params.step, params.end)
        plan = self._plans.get(key)
        if plan is None:
            plan = parse_query(promql, params)
            if len(self._plans) >= _PLAN_MEMO:
                self._plans.pop(next(iter(self._plans)))
            self._plans[key] = plan
        return plan

    def execute_logical(self, plan, qcontext: QueryContext | None = None,
                        materialize: bool = True) -> QueryResult:
        """``plan``'s answer and stats, from the extent cache where it
        serves the plan, else from an engine (``_execute_uncached``); with
        ``materialize`` False the values stay on the card."""
        qcontext = qcontext or QueryContext()
        with self.lock:
            if self.result_cache is not None and materialize:
                cached = self.result_cache.execute(self, plan, qcontext)
                if cached is not None:
                    return cached
            return self._execute_uncached(plan, qcontext, materialize)

    def _execute_uncached(self, plan, qcontext: QueryContext | None = None,
                          materialize: bool = True) -> QueryResult:
        """``plan`` on an engine, without the extent cache (which
        evaluates its extents through here); the caller holds ``lock``."""
        qcontext = qcontext or QueryContext()
        t0 = time.perf_counter()
        fallback = ""
        result = None
        if self.engine == "mesh":
            fallback = self.mesh.supports(self.memstore, plan)
            if fallback is None:
                stats = QueryStats(engine="mesh")
                try:
                    result = QueryResult(self.mesh.execute(
                        self.memstore, plan, stats), stats, qcontext.query_id)
                except UnsupportedQuery as e:
                    fallback = str(e)
        if result is None:
            result = self._on_exec(plan, qcontext, fallback)
        if materialize:
            _finish(result, qcontext)
            result.stats.wall_time_s = time.perf_counter() - t0
        return result

    def _on_exec(self, plan, qcontext: QueryContext,
                 fallback: str) -> QueryResult:
        """``plan`` through the planner and the exec engine; ``fallback``
        says why mesh handed it on ("" where exec is the engine)."""
        stats = QueryStats(engine="exec", fallback=fallback)
        tree = self.planner.materialize(plan, qcontext)
        ctx = ExecContext(self.memstore, stats, self.device, self.batches,
                          self.gids)
        return QueryResult(tree.execute(ctx), stats, qcontext.query_id)

    def query_range_many(self, queries, return_errors: bool = False
                         ) -> list:
        """The answers of many range queries, ``(promql, start_sec,
        step_sec, end_sec)`` each, in order, evaluated together (see the
        module's text). With ``return_errors`` a query that fails leaves
        its exception at its own position; without, the first failure
        raises. Every answer's ``wall_time_s`` is the batch's."""
        t0 = time.perf_counter()
        n = len(queries)
        if n == 1:
            try:
                return [self.query_range(*queries[0])]
            except Exception as e:  # noqa: BLE001 - at its position
                if not return_errors:
                    raise
                return [e]
        outcomes: list = [None] * n

        def failed(i: int, e: Exception) -> None:
            if not return_errors:
                raise e
            outcomes[i] = e

        with self.lock:
            plans: list = [None] * n
            for i, (promql, start, step, end) in enumerate(queries):
                try:
                    plans[i] = self._parse_cached(promql, TimeStepParams(
                        start, step, end))
                except Exception as e:  # noqa: BLE001
                    failed(i, e)
            if self.result_cache is not None:
                for i, plan in enumerate(plans):
                    if plan is None:
                        continue
                    try:
                        outcomes[i] = self.result_cache.execute(
                            self, plan, QueryContext())
                    except Exception as e:  # noqa: BLE001
                        failed(i, e)
            pending = [i for i in range(n)
                       if outcomes[i] is None and plans[i] is not None]
            answers = self._execute_many_uncached(
                [plans[i] for i in pending], QueryContext())
            for i, r in zip(pending, answers):
                if isinstance(r, Exception):
                    failed(i, r)
                else:
                    outcomes[i] = r
        wall = time.perf_counter() - t0
        for r in outcomes:
            if isinstance(r, QueryResult):
                r.stats.wall_time_s = wall
        return outcomes

    def _execute_many_uncached(self, plans: list, qcontext: QueryContext
                               ) -> list:
        """``plans`` on the engines together, without the extent cache
        (which evaluates the extents a query misses through here): one
        ``execute_many`` on the mesh engine, exec for what it does not
        serve, one device→host copy a shape group (``_fetch``), then each
        answer materialized and held to ``qcontext``'s limit. Returns an
        answer or the exception it raised a plan; the caller holds
        ``lock``."""
        on_mesh: dict = {}
        if self.engine == "mesh" and plans:
            stats = [QueryStats(engine="mesh") for _ in plans]
            on_mesh = dict(enumerate(zip(self.mesh.execute_many(
                self.memstore, plans, stats), stats)))
        out: list = []
        for i, plan in enumerate(plans):
            answer, stats = on_mesh.get(i, (None, None))
            try:
                if isinstance(answer, Exception):
                    raise answer
                out.append(QueryResult(answer, stats, qcontext.query_id)
                           if answer is not None else self._on_exec(
                               plan, qcontext,
                               "" if self.engine == "exec" else
                               self.mesh.supports(self.memstore, plan)
                               or "declined by the mesh engine's batch"))
            except Exception as e:  # noqa: BLE001 - at its position
                out.append(e)
        done = [i for i, r in enumerate(out) if isinstance(r, QueryResult)]
        for j, e in _fetch([out[i] for i in done]):
            out[done[j]] = e
        for i, r in enumerate(out):
            if isinstance(r, QueryResult):
                try:
                    _finish(r, qcontext)
                except Exception as e:  # noqa: BLE001
                    out[i] = e
        return out

    # ---- metadata ------------------------------------------------------------

    def label_names(self) -> list[str]:
        """Every label name in the store, sorted (``/api/v1/labels``)."""
        return self.memstore.label_names()

    def label_values(self, label: str, filters=None) -> list[str]:
        """The values of one label, among the series ``filters`` (column
        filters) select if given, sorted (``/api/v1/label/<l>/values``)."""
        return self.memstore.label_values(label, filters)

    def chunk_infos(self, filters, start_ms: int, end_ms: int,
                    include_buffer: bool = False) -> list[dict]:
        """The resident chunks of the series the filters select over
        [start, end] (and their write buffers with ``include_buffer``),
        shard by shard (the reference's ``SelectChunkInfosExec``)."""
        out = []
        for shard in self.memstore.shards:
            pids = shard.lookup_partitions(list(filters), start_ms, end_ms)
            for pid, cid, rows, t0, t1, nbytes in shard.chunk_infos(
                    pids, start_ms, end_ms, include_buffer):
                out.append({"shard": shard.shard_num, "partId": pid,
                            "partKey": str(shard.keys[pid]), "chunkId": cid,
                            "numRows": rows, "startTime": t0, "endTime": t1,
                            "numBytes": nbytes})
        return out

    def series(self, filters, start_sec: int, end_sec: int) -> list[dict]:
        """The label maps of the series the filters select over [start,
        end], shard by shard (``/api/v1/series``)."""
        out = []
        for shard in self.memstore.shards:
            for pid in shard.lookup_partitions(list(filters), start_sec * 1000,
                                               end_sec * 1000):
                out.append(shard.keys[pid].label_map)
        return out


def _finish(result: QueryResult, qcontext: QueryContext) -> None:
    """Materialize an answer (deferred compaction first, on the card),
    then hold it to the query's limit and count its series."""
    data = result.result.materialize()
    enforce_limits(data, qcontext)
    result.stats.result_series = data.num_series


def _fetch(results: list[QueryResult]) -> list[tuple[int, Exception]]:
    """Bring answers still on the card to the host in one copy a shape
    group: each is compacted on the card, then the distinct value tensors
    of one (shape, dtype, device) are stacked and copied at once, into
    float64. Answers that hold one tensor (members of one grid over one
    leaf) share one host array, so a caller treats values as read-only.
    Returns (position, exception) where a group's copy failed."""
    groups: dict = {}
    errors = []
    for j, r in enumerate(results):
        try:
            v = r.result.settle().values
        except Exception as e:  # noqa: BLE001
            errors.append((j, e))
            continue
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            groups.setdefault((tuple(v.shape), v.dtype, v.device),
                              {}).setdefault(id(v), (v, []))[1].append(j)
    for group in groups.values():
        tensors = list(group.values())
        try:
            host = torch.stack([v for v, _ in tensors]).to(
                "cpu", torch.float64).numpy()
        except Exception as e:  # noqa: BLE001
            errors += [(j, e) for _, members in tensors for j in members]
            continue
        for (_, members), values in zip(tensors, host):
            for j in members:
                results[j].result.values = values
    return errors


class QueryBatcher:
    """Coalesces the range queries of concurrent threads into
    ``query_range_many`` batches (the threaded HTTP front end): callers
    queue and wait, one thread drains what is queued (at most
    ``max_batch``) and answers each caller with its own result or
    exception. An idle service answers a lone query at once. ``close``
    stops the thread."""

    def __init__(self, svc: QueryService, max_batch: int = 64):
        self.svc = svc
        self.max_batch = max_batch
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="query-batcher")
        self._thread.start()

    def query_range(self, promql: str, start_sec: int, step_sec: int,
                    end_sec: int) -> QueryResult:
        item = {"params": (promql, start_sec, step_sec, end_sec),
                "event": threading.Event(), "result": None, "error": None}
        self._q.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        while True:
            items = [self._q.get()]
            try:
                while len(items) < self.max_batch:
                    items.append(self._q.get_nowait())
            except queue.Empty:
                pass
            stop = None in items
            items = [it for it in items if it is not None]
            try:
                results = self.svc.query_range_many(
                    [it["params"] for it in items], return_errors=True)
            except Exception as e:  # noqa: BLE001 - every caller hears it
                results = [e] * len(items)
            for it, r in zip(items, results):
                it["error" if isinstance(r, Exception) else "result"] = r
                it["event"].set()
            if stop:
                return
