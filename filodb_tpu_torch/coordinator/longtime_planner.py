"""LongTimeRangePlanner: a query routed between raw and downsampled data.

Port of ``filodb_tpu/coordinator/longtime_planner.py``: a query whose
range, lookback included, lies within raw retention goes to the raw
planner; one that ends before it to the downsample planner, its range
functions rewritten onto the ``ds-gauge`` columns
(``rewrite_for_downsample``); one that straddles splits at the first step
whose whole lookback lies in raw data, the two exec plans stitched
(``StitchRvsExec``).

``mem_only`` says whether the raw tier alone serves a plan (only such a
plan may take the mesh engine, which reads the memstore only), and
``cost_hint`` classes any other EXPENSIVE for the governor.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.exec.plan import ExecPlan, StitchRvsExec
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.utils.governor import EXPENSIVE

# range function → (ds-gauge column, the function over it)
_DS_FN_MAP = {
    "min_over_time": ("min", "min_over_time"),
    "max_over_time": ("max", "max_over_time"),
    "sum_over_time": ("sum", "sum_over_time"),
    "count_over_time": ("count", "sum_over_time"),
}


def rewrite_for_downsample(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """``plan`` over the rollup columns: min/max/sum_over_time read their
    column, count_over_time sums the count column, and avg_over_time is
    the exact average, the sum column's sum over the count column's."""
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        if plan.function == "avg_over_time" and plan.raw.column is None:
            num = dataclasses.replace(
                plan, raw=dataclasses.replace(plan.raw, column="sum"),
                function="sum_over_time")
            den = dataclasses.replace(
                plan, raw=dataclasses.replace(plan.raw, column="count"),
                function="sum_over_time")
            return lp.BinaryJoin(num, "/", den)
        m = _DS_FN_MAP.get(plan.function)
        if m is not None and plan.raw.column is None:
            col, fn = m
            return dataclasses.replace(
                plan, raw=dataclasses.replace(plan.raw, column=col),
                function=fn)
        return plan
    if dataclasses.is_dataclass(plan):
        changes = {f.name: rewrite_for_downsample(getattr(plan, f.name))
                   for f in dataclasses.fields(plan)
                   if isinstance(getattr(plan, f.name), lp.LogicalPlan)}
        if changes:
            return dataclasses.replace(plan, **changes)
    return plan


def store_version(store) -> int:
    """A colder tier's stamp for the extent cache: a read-only store's
    index version (``data_version``, after the refresh its next lookup
    would make, so the stamp a query is keyed by is the one it reads
    under), a streaming ds dataset's store version (every rollup it
    ingests moves it); 0 for none."""
    if store is None:
        return 0
    refresh = getattr(store, "refresh", None)
    if refresh is None:
        return store.version
    refresh()
    return store.data_version


def _plan_times(plan: lp.LogicalPlan):
    """(start, step, end, longest lookback) over the plan tree, or None."""
    return lp.plan_times(plan)


@dataclass
class LongTimeRangePlanner:
    raw_planner: SingleClusterPlanner
    ds_planner: SingleClusterPlanner
    raw_retention_ms: int
    now_ms: "callable" = field(default=lambda: int(time.time() * 1000))

    def mem_only(self, plan: lp.LogicalPlan) -> bool:
        """Whether raw data serves the whole range, lookback included."""
        times = _plan_times(plan)
        if times is None:
            return True
        start, _step, _end, lookback = times
        return start - lookback >= self.now_ms() - self.raw_retention_ms

    def cost_hint(self, plan: lp.LogicalPlan):
        """EXPENSIVE for a plan that reads the downsample tier (its chunks
        page in from the column store), else None."""
        return None if self.mem_only(plan) else EXPENSIVE

    def version_token(self) -> int:
        """The downsample store's version (``store_version``)."""
        return store_version(self.ds_planner.store)

    def materialize(self, plan: lp.LogicalPlan,
                    qcontext: QueryContext | None = None) -> ExecPlan:
        qcontext = qcontext or QueryContext()
        times = _plan_times(plan)
        if times is None:
            return self.raw_planner.materialize(plan, qcontext)
        start, step, end, lookback = times
        earliest_raw = self.now_ms() - self.raw_retention_ms
        if start - lookback >= earliest_raw:
            return self.raw_planner.materialize(plan, qcontext)
        if end < earliest_raw:
            return self.ds_planner.materialize(rewrite_for_downsample(plan),
                                               qcontext)
        # straddling: the first step whose whole window lies in raw data
        step = max(step, 1)
        boundary = start
        while boundary - lookback < earliest_raw and boundary <= end:
            boundary += step
        ds_end = boundary - step
        parts = []
        if ds_end >= start:
            parts.append(self.ds_planner.materialize(
                rewrite_for_downsample(lp.retime(plan, start, step, ds_end)),
                qcontext))
        if boundary <= end:
            parts.append(self.raw_planner.materialize(
                lp.retime(plan, boundary, step, end), qcontext))
        if len(parts) == 1:
            return parts[0]
        return StitchRvsExec(children_plans=parts)
