"""TieredPlanner: one query routed across the memstore, cold raw chunks and
the downsample tier.

Port of ``filodb_tpu/coordinator/tiered_planner.py``, the three-tier form
of ``LongTimeRangePlanner``:

- ``memstore``: raw data resident in memory, the newest;
- ``objectstore``: raw data older than memory retention but inside raw
  retention, served by a ``ColdTierStore`` (``query/federation.py``) whose
  chunks page in from the column store;
- ``downsample``: rollups older than raw retention, the
  ``rewrite_for_downsample`` rewrites applied.

``route_tiers`` gives each step to one tier; each tier's sub-plan runs
under a ``TierExec`` (its stats attributed to the tier) and the parts are
stitched with ``StitchRvsExec``. ``mem_only`` and ``cost_hint`` are the
service's hooks (mesh engine, admission class), ``version_token`` the
extent cache's stamp of the colder tiers' indexes, ``tier_detail`` the
status route's view.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from filodb_tpu_torch.coordinator.longtime_planner import (
    _plan_times,
    rewrite_for_downsample,
    store_version,
)
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.exec.plan import ExecPlan, StitchRvsExec
from filodb_tpu_torch.query.federation import (
    DOWNSAMPLE,
    MEMSTORE,
    OBJECTSTORE,
    ColdTierStore,
    TierExec,
    fed_queries,
    route_tiers,
)
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.utils.governor import EXPENSIVE


@dataclass
class TieredPlanner:
    """The retention-tier router; takes ``LongTimeRangePlanner``'s place."""

    raw_planner: SingleClusterPlanner
    cold_planner: SingleClusterPlanner
    ds_planner: "SingleClusterPlanner | None" = None
    # data floors as retentions before now_ms(): memory keeps
    # mem_retention_ms of raw data, the column store raw_retention_ms
    # (older data is there downsampled only)
    mem_retention_ms: int = 0
    raw_retention_ms: "int | None" = None
    now_ms: "callable" = field(default=lambda: int(time.time() * 1000))

    def _floors(self) -> tuple[int, "int | None"]:
        now = self.now_ms()
        raw_floor = None if self.raw_retention_ms is None \
            or self.ds_planner is None else now - self.raw_retention_ms
        return now - self.mem_retention_ms, raw_floor

    def mem_only(self, plan: lp.LogicalPlan) -> bool:
        """Whether the memstore tier alone serves the whole plan."""
        times = _plan_times(plan)
        if times is None:
            return True
        start, _, _, lookback = times
        return start - lookback >= self._floors()[0]

    def cost_hint(self, plan: lp.LogicalPlan) -> "str | None":
        """EXPENSIVE for a plan that reads a colder tier, else None."""
        return None if self.mem_only(plan) else EXPENSIVE

    def version_token(self) -> int:
        """The colder tiers' index versions, summed: it moves when their
        part-key indexes change, so settled extents do not outlive them."""
        return sum(store_version(getattr(p, "store", None))
                   for p in (self.cold_planner, self.ds_planner))

    def tier_detail(self) -> dict:
        mem_floor, raw_floor = self._floors()
        tiers = []
        cold = self.cold_planner.store
        if isinstance(cold, ColdTierStore):
            tiers.append({"tier": OBJECTSTORE, "floorMs": raw_floor,
                          "ceilMs": mem_floor, **cold.tier_stats()})
        ds = self.ds_planner.store if self.ds_planner is not None else None
        if ds is not None:
            refresh = getattr(ds, "refresh", None)  # a streaming ds store
            if refresh is not None:                 # has no index to load
                refresh()
            entry = {"tier": DOWNSAMPLE,
                     "series": sum(sh.num_partitions for sh in ds.shards),
                     "bytes": None, "floorMs": None, "ceilMs": raw_floor,
                     "resolutionMs": getattr(ds, "resolution_ms", None)}
            # the bytes where the store can say them (the object store),
            # under the ds dataset's name, as the reference's
            stats = getattr(ds.column_store, "dataset_stats", None)
            if stats is not None:
                entry["bytes"] = stats(getattr(ds, "ds_dataset",
                                               ds.dataset)).get("bytes")
            tiers.append(entry)
        return {"memFloorMs": mem_floor, "rawFloorMs": raw_floor,
                "tiers": tiers}

    def materialize(self, plan: lp.LogicalPlan,
                    qcontext: QueryContext | None = None) -> ExecPlan:
        qcontext = qcontext or QueryContext()
        times = _plan_times(plan)
        if times is None:  # metadata plans: the raw tier
            return self.raw_planner.materialize(plan, qcontext)
        start, step, end, lookback = times
        mem_floor, raw_floor = self._floors()
        ranges = route_tiers(start, step, end, lookback, mem_floor,
                             raw_floor)
        if len(ranges) == 1 and ranges[0].tier == MEMSTORE:
            return self.raw_planner.materialize(plan, qcontext)
        fed_queries.inc()
        parts: list[ExecPlan] = []
        for r in ranges:
            sub = plan if (r.start == start and r.end == end) \
                else lp.retime(plan, r.start, step, r.end)
            if r.tier == MEMSTORE:
                ep = self.raw_planner.materialize(sub, qcontext)
            elif r.tier == OBJECTSTORE:
                ep = self.cold_planner.materialize(sub, qcontext)
            else:
                ep = self.ds_planner.materialize(rewrite_for_downsample(sub),
                                                 qcontext)
            parts.append(TierExec(tier=r.tier, children_plans=[ep]))
        if len(parts) == 1:
            return parts[0]
        return StitchRvsExec(children_plans=parts)


def build_tiered_planner(raw_planner: SingleClusterPlanner, column_store,
                         dataset: str, num_shards: int, spread: int = 0, *,
                         mem_retention_ms: int,
                         raw_retention_ms: "int | None" = None,
                         ds_planner: "SingleClusterPlanner | None" = None,
                         odp_max_chunks: int = 10_000,
                         refresh_s: float = 60.0,
                         now_ms=None) -> TieredPlanner:
    """The cold tier over ``column_store``'s ``dataset`` and the planner
    over it and the given tiers (``ds_planner`` None: two tiers)."""
    cold = ColdTierStore(column_store, dataset, num_shards,
                         odp_max_chunks=odp_max_chunks, refresh_s=refresh_s)
    cold_planner = SingleClusterPlanner(num_shards, spread, store=cold)
    kw = {} if now_ms is None else {"now_ms": now_ms}
    return TieredPlanner(raw_planner, cold_planner, ds_planner,
                         mem_retention_ms=mem_retention_ms,
                         raw_retention_ms=raw_retention_ms, **kw)
