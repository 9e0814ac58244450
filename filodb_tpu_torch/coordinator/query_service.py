"""Query facade: PromQL text → ``QueryResult`` on the card.

Port of the range-query path of ``filodb_tpu/coordinator/query_service.py``
(``QueryService.query_range``): parse, lower, run on the one-GPU engine,
materialize. The answer's ``StepMatrix`` renders to a Prometheus response
body with ``http.promjson.matrix_json``.
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
    """Serves range queries over ``memstore`` on ``device`` (default: the
    CUDA card; ``device="cpu"`` runs every kernel's plain version)."""

    def __init__(self, memstore: MemStore,
                 device: "str | torch.device | None" = None):
        self.memstore = memstore
        self.device = resolve(device)
        self.engine = MeshQueryEngine(self.device)

    def query_range(self, promql: str, start_sec: int, step_sec: int,
                    end_sec: int) -> QueryResult:
        t0 = time.perf_counter()
        plan = parse_query(promql, TimeStepParams(start_sec, step_sec,
                                                  end_sec))
        stats = QueryStats()
        m = self.engine.execute(self.memstore, plan, stats).materialize()
        stats.result_series = m.num_series
        stats.wall_time_s = time.perf_counter() - t0
        return QueryResult(m, stats)
