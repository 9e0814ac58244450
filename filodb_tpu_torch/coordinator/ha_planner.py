"""HA and federation planners.

Port of ``filodb_tpu/coordinator/ha_planner.py`` (``:39-237``):

- ``HighAvailabilityPlanner`` over a ``FailureProvider``: the steps whose
  window overlaps a known failure of the local cluster go to a replica
  cluster as PromQL over HTTP (``PromQlRemoteExec``), the rest run the
  local planner's exec tree on the card, and ``StitchRvsExec`` stitches
  the runs on the card;
- ``MultiPartitionPlanner``: a ``PartitionLocationProvider`` maps shard
  keys to the partition (cluster) owning them; a query of one remote
  partition goes there whole;
- ``SinglePartitionPlanner``: one planner of several, chosen per plan;
- ``ShardKeyRegexPlanner``: regex shard-key filters fanned out into
  concrete shard keys (``_replace_shard_keys``), associative aggregations
  pushed down a key and reduced across them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from filodb_tpu_torch.core.filters import ColumnFilter, Equals, EqualsRegex
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.exec.plan import (
    DistConcatExec,
    ExecPlan,
    ReduceAggregateExec,
    StitchRvsExec,
)
from filodb_tpu_torch.query.exec.remote_exec import PromQlRemoteExec
from filodb_tpu_torch.query.logical_parser import to_promql
from filodb_tpu_torch.query.model import QueryContext


@dataclass(frozen=True)
class TimeRange:
    start: int
    end: int


class FailureProvider:
    """Known failure time ranges of a cluster (the reference's
    ``FailureProvider``)."""

    def failures(self, dataset: str, time_range: TimeRange
                 ) -> list[TimeRange]:
        raise NotImplementedError


@dataclass
class StaticFailureProvider(FailureProvider):
    ranges: list[TimeRange] = field(default_factory=list)

    def failures(self, dataset, time_range):
        return [r for r in self.ranges
                if r.end >= time_range.start and r.start <= time_range.end]


@dataclass
class HighAvailabilityPlanner:
    dataset: str
    local_planner: object
    failure_provider: FailureProvider
    remote_endpoint: str  # the replica cluster's …/promql/{dataset}

    def materialize(self, plan, qcontext=None) -> ExecPlan:
        qcontext = qcontext or QueryContext()
        times = lp.plan_times(plan)
        if times is None:
            return self.local_planner.materialize(plan, qcontext)
        start, step, end, lookback = times
        fails = self.failure_provider.failures(
            self.dataset, TimeRange(start - lookback, end))
        if not fails:
            return self.local_planner.materialize(plan, qcontext)
        step = max(step, 1)
        # a step is poisoned where its window overlaps a failure; runs of
        # like steps become local or remote sub-plans
        parts: list[ExecPlan] = []
        run_start = start
        run_remote = self._poisoned(start, lookback, fails)
        t = start + step
        while t <= end + step:
            poisoned = (self._poisoned(t, lookback, fails)
                        if t <= end else not run_remote)
            if t > end or poisoned != run_remote:
                sub = lp.retime(plan, run_start, step, t - step)
                parts.append(self._remote(sub, run_start, step, t - step)
                             if run_remote
                             else self.local_planner.materialize(sub,
                                                                 qcontext))
                run_start = t
                run_remote = poisoned
            t += step
        if len(parts) == 1:
            return parts[0]
        return StitchRvsExec(children_plans=parts)

    @staticmethod
    def _poisoned(step_ms: int, lookback: int, fails) -> bool:
        return any(f.start <= step_ms and step_ms - lookback <= f.end
                   for f in fails)

    def _remote(self, plan, start, step, end) -> PromQlRemoteExec:
        return PromQlRemoteExec(endpoint=self.remote_endpoint,
                                promql=to_promql(plan), start=start,
                                step=step, end=end)


class PartitionLocationProvider:
    """Shard-key label values → the cluster partition owning them (the
    reference's ``PartitionLocationProvider``)."""

    def partition_of(self, shard_key: dict[str, str]) -> str:
        raise NotImplementedError

    def endpoint_of(self, partition: str) -> str:
        raise NotImplementedError


@dataclass
class MultiPartitionPlanner:
    locator: PartitionLocationProvider
    local_partition: str
    local_planner: object
    shard_key_labels: tuple[str, ...] = ("_ws_", "_ns_")

    def materialize(self, plan, qcontext=None) -> ExecPlan:
        qcontext = qcontext or QueryContext()
        keys = self._shard_keys(plan)
        partitions = {self.locator.partition_of(k) for k in keys} or {
            self.local_partition}
        if partitions == {self.local_partition}:
            return self.local_planner.materialize(plan, qcontext)
        if len(partitions) == 1:
            part = next(iter(partitions))
            start, step, end, _ = lp.plan_times(plan)
            return PromQlRemoteExec(
                endpoint=self.locator.endpoint_of(part),
                promql=to_promql(plan), start=start, step=max(step, 1),
                end=end)
        raise ValueError(
            "queries spanning multiple partitions must target a single "
            "shard key per selector (reference MultiPartitionPlanner "
            "limitation)")

    def _shard_keys(self, plan) -> list[dict[str, str]]:
        out = []
        for raw in lp.leaf_raw_series(plan):
            eq = {f.column: f.filter.value for f in raw.filters
                  if isinstance(f.filter, Equals)}
            if all(lbl in eq for lbl in self.shard_key_labels):
                out.append({k: eq[k] for k in self.shard_key_labels})
        return out


@dataclass
class SinglePartitionPlanner:
    """One planner of several, picked by ``select`` over the plan (the
    reference's ``SinglePartitionPlanner`` routes a metric)."""

    planners: dict = field(default_factory=dict)
    select: "callable" = None  # plan → planner name
    default: str = ""

    def materialize(self, plan, qcontext=None) -> ExecPlan:
        name = self.select(plan) if self.select else self.default
        return self.planners.get(name, self.planners[self.default]) \
            .materialize(plan, qcontext or QueryContext())


@dataclass
class ShardKeyRegexPlanner:
    """Regex shard-key filters expanded into concrete shard keys and
    fanned out (the reference's ``ShardKeyRegexPlanner``): aggregations
    reduce across the fan-out, plain selectors concatenate."""

    inner_planner: object
    shard_key_matcher: "callable"  # filters → list[dict[label, value]]
    shard_key_labels: tuple[str, ...] = ("_ws_", "_ns_")

    def materialize(self, plan, qcontext=None) -> ExecPlan:
        qcontext = qcontext or QueryContext()
        raws = lp.leaf_raw_series(plan)
        needs_fanout = any(
            isinstance(f.filter, EqualsRegex) and f.column in
            self.shard_key_labels for raw in raws for f in raw.filters)
        if not needs_fanout:
            return self.inner_planner.materialize(plan, qcontext)
        combos = self.shard_key_matcher(raws[0].filters)

        def fan(p):
            return [self.inner_planner.materialize(
                _replace_shard_keys(p, combo, self.shard_key_labels),
                qcontext) for combo in combos]

        if isinstance(plan, lp.Aggregate):
            if plan.op in ("sum", "min", "max", "group"):
                # associative: pushed down a combo, reduced with the op
                return ReduceAggregateExec(children_plans=fan(plan),
                                           op=plan.op, params=plan.params,
                                           by=plan.by, without=plan.without)
            if plan.op == "count":
                # partial counts add up
                return ReduceAggregateExec(children_plans=fan(plan),
                                           op="sum", params=plan.params,
                                           by=plan.by, without=plan.without)
            # avg, stddev, topk, quantile...: the unaggregated inner fanned
            # out, aggregated once at the root
            return ReduceAggregateExec(children_plans=fan(plan.vector),
                                       op=plan.op, params=plan.params,
                                       by=plan.by, without=plan.without)
        return DistConcatExec(children_plans=fan(plan))


def _replace_shard_keys(plan, combo: dict[str, str], shard_labels):
    """``plan`` with its shard-key filters set to ``combo``'s values."""
    if isinstance(plan, lp.RawSeries):
        new_filters = tuple(
            ColumnFilter(f.column, Equals(combo[f.column]))
            if f.column in combo else f for f in plan.filters)
        return dataclasses.replace(plan, filters=new_filters)
    if dataclasses.is_dataclass(plan):
        changes = {}
        for f in dataclasses.fields(plan):
            v = getattr(plan, f.name)
            if isinstance(v, lp.LogicalPlan):
                changes[f.name] = _replace_shard_keys(v, combo, shard_labels)
        if changes:
            return dataclasses.replace(plan, **changes)
    return plan
