"""Query facade: PromQL text → ``QueryResult`` on the card.

Port of the query and metadata paths of
``filodb_tpu/coordinator/query_service.py``: ``query_range`` and
``query_instant`` (steps ``(t, 0, t)``) parse, lower, run on the one-GPU
engine and materialize; ``label_names``, ``label_values`` and ``series``
answer from the shards' part-key indexes, on the host. A range answer's
``StepMatrix`` renders with ``http.promjson.matrix_json``, an instant one
with ``vector_json`` or, for a scalar expression, ``scalar_json``.
"""

from __future__ import annotations

import time

import torch

from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.device import resolve
from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.model import QueryResult, QueryStats


class QueryService:
    """Serves queries over ``memstore`` on ``device`` (default: the CUDA
    card; ``device="cpu"`` runs every kernel's plain version)."""

    def __init__(self, memstore: MemStore,
                 device: "str | torch.device | None" = None):
        self.memstore = memstore
        self.device = resolve(device)
        self.engine = MeshQueryEngine(self.device)

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
        stats = QueryStats()
        m = self.engine.execute(self.memstore, plan, stats).materialize()
        stats.result_series = m.num_series
        stats.wall_time_s = time.perf_counter() - t0
        return QueryResult(m, stats)

    # ---- metadata ------------------------------------------------------------

    def label_names(self) -> list[str]:
        """Every label name in the store, sorted (``/api/v1/labels``)."""
        return self.memstore.label_names()

    def label_values(self, label: str, filters=None) -> list[str]:
        """The values of one label, among the series ``filters`` (column
        filters) select if given, sorted (``/api/v1/label/<l>/values``)."""
        return self.memstore.label_values(label, filters)

    def series(self, filters, start_sec: int, end_sec: int) -> list[dict]:
        """The label maps of the series the filters select over [start,
        end], shard by shard (``/api/v1/series``)."""
        out = []
        for shard in self.memstore.shards:
            for pid in shard.lookup_partitions(list(filters), start_sec * 1000,
                                               end_sec * 1000):
                out.append(shard.keys[pid].label_map)
        return out
