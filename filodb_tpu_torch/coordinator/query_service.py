"""Query facade: PromQL text → ``QueryResult`` on the card.

Port of the query and metadata paths of
``filodb_tpu/coordinator/query_service.py``: ``query_range`` and
``query_instant`` (steps ``(t, 0, t)``) parse, run on one of the two
engines and materialize; ``label_names``, ``label_values`` and ``series``
answer from the shards' part-key indexes, and ``chunk_infos`` from their
chunk tables, on the host. A range answer's
``StepMatrix`` renders with ``http.promjson.matrix_json``, an instant one
with ``vector_json`` or, for a scalar expression, ``scalar_json``.

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

``QueryStats.engine`` records which engine answered and
``QueryStats.fallback`` why mesh handed the plan on. Both engines keep
their uploaded batches in one ``BatchCache``, under one budget of device
memory, and their group ids in one ``GroupIdCache``.

Threads share a service (the HTTP front end, a node's callers): its
queries run one at a time under ``lock`` (the engines' caches are not
shared between two queries in flight), while the shards' locks let
ingest and flushes go on between a query's selections. The metadata
calls take only the shards' locks.
"""

from __future__ import annotations

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
    QueryResult,
    QueryStats,
    StepMatrix,
    UnsupportedQuery,
)

ENGINES = ("mesh", "exec")


class QueryService:
    """Serves queries over ``memstore`` on ``device`` (default: the CUDA
    card; ``device="cpu"`` runs every kernel's plain version) with
    ``engine`` ``"mesh"`` (falling back to exec) or ``"exec"``;
    ``time_split_ms`` > 0 has the planner split longer ranges. The
    batches both engines keep take at most half the card's memory
    (``batches.budget``)."""

    def __init__(self, memstore: MemStore,
                 device: "str | torch.device | None" = None,
                 engine: str = "mesh", time_split_ms: int = 0):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: one of {ENGINES}")
        self.memstore = memstore
        self.device = resolve(device)
        self.engine = engine
        self.batches = BatchCache(self.device)
        self.gids = GroupIdCache()
        self.mesh = MeshQueryEngine(self.device, self.batches, self.gids,
                                    sidecars=True)
        self.planner = SingleClusterPlanner(memstore.num_shards,
                                            memstore.spread,
                                            time_split_ms=time_split_ms)
        self.lock = threading.Lock()

    def query_range(self, promql: str, start_sec: int, step_sec: int,
                    end_sec: int) -> QueryResult:
        return self._run(promql, TimeStepParams(start_sec, step_sec,
                                                end_sec))

    def query_instant(self, promql: str, time_sec: int) -> QueryResult:
        """The query at one instant: steps (t, 0, t), one step at t."""
        return self._run(promql, TimeStepParams(time_sec, 0, time_sec))

    def _run(self, promql: str, params: TimeStepParams) -> QueryResult:
        t0 = time.perf_counter()
        plan = parse_query(promql, params)
        with self.lock:
            m, stats = self.execute_logical(plan)
            m.materialize()
        stats.result_series = m.num_series
        stats.wall_time_s = time.perf_counter() - t0
        return QueryResult(m, stats)

    def execute_logical(self, plan) -> tuple[StepMatrix, QueryStats]:
        """``plan``'s answer (values still on the card) and its stats;
        a caller that shares the service holds ``lock``."""
        fallback = ""
        if self.engine == "mesh":
            fallback = self.mesh.supports(self.memstore, plan)
            if fallback is None:
                stats = QueryStats(engine="mesh")
                try:
                    return self.mesh.execute(self.memstore, plan, stats), \
                        stats
                except UnsupportedQuery as e:
                    fallback = str(e)
        stats = QueryStats(engine="exec", fallback=fallback)
        tree = self.planner.materialize(plan)
        ctx = ExecContext(self.memstore, stats, self.device, self.batches,
                          self.gids)
        return tree.execute(ctx), stats

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
