"""The single-cluster planner: a logical plan → an exec plan tree.

Port of ``filodb_tpu/coordinator/planner.py``'s ``SingleClusterPlanner``:
shard-aware materialization with shard-key pruning (a selector with
equality filters on every shard-key label reads only the 2^spread shards
its shard key maps to), one ``SelectRawPartitionsExec`` leaf a shard
under a ``DistConcatExec``, the time split (``time_split_ms`` > 0 plans a long range as sequential
sub-ranges and stitches them, ``StitchRvsExec``), and a ``_mat_*`` for
every logical plan the port parses.

``dispatcher_for_shard`` (a cluster's, ``coordinator/cluster.py``)
gives each leaf the dispatcher of the node that owns its shard (None:
in-process). Aggregations reduce at the root over the gathered series,
or, with two-phase pushdown (the reference's
``filodb_tpu/coordinator/planner.py:185-247``), each selector leaf ends in
an ``AggregatePartialMapper`` and the root folds their partials
(``ReduceAggregateExec(pushdown=True)``). ``agg_pushdown``: ``"off"``
never; ``"always"`` wherever the shape allows (the plan under the
aggregation is a leaf or a plain concat of leaves, and the op is in
``AGG_PUSHDOWN_OPS``); ``"auto"`` (the default) by the cost model's
``pushdown`` site, whose static arm pushes only where a leaf leaves the
process (the win is wire bytes); its decision is deferred onto the query
context and settled with the query's wall time. Each aggregation moves
``filodb_agg_pushdown_applied`` or ``filodb_agg_pushdown_bypassed``.

Spread overrides, as the reference's: a per-query ``PlannerParams.spread``
wins over the override of the selector's shard key
(``spread_overrides``), which wins over the planner's ``spread``. Ingest
writes every key at the store's spread whatever the overrides say, in both
packages, so an override narrower than it prunes shards that hold the
key's series (ROADMAP §C). Only the exec engine prunes: the mesh engine
reads every shard.
"""

from __future__ import annotations

from dataclasses import dataclass

from filodb_tpu_torch.core.filters import Equals
from filodb_tpu_torch.core.partkey import shard_key_hash, shards_for_shard_key
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.exec import transformers as tf
from filodb_tpu_torch.query.exec.binaryjoin import (
    SET_OPS,
    BinaryJoinExec,
    SetOperatorExec,
)
from filodb_tpu_torch.query.exec.plan import (
    DistConcatExec,
    ExecContext,
    ExecPlan,
    InProcessPlanDispatcher,
    ReduceAggregateExec,
    ScalarBinaryOperationExec,
    ScalarFixedDoubleExec,
    ScalarVaryingExec,
    SelectRawPartitionsExec,
    StitchRvsExec,
    TimeScalarGeneratorExec,
    VectorFromScalarExec,
)
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.utils.metrics import get_counter

# the labels of a shard key, as every schema of the store has them
SHARD_KEY_LABELS = ("_ws_", "_ns_", "_metric_")

# aggregations planned with a map stage in their leaves, and without
PUSHDOWN_APPLIED = get_counter("filodb_agg_pushdown_applied")
PUSHDOWN_BYPASSED = get_counter("filodb_agg_pushdown_bypassed")
AGG_PUSHDOWN_MODES = ("auto", "always", "off")


@dataclass
class SingleClusterPlanner:
    num_shards: int = 1
    spread: int = 1
    # ms above which a range query is split into sequential sub-plans and
    # stitched (0: never)
    time_split_ms: int = 0
    # per-shard-key spreads: the shard key's values but the metric's
    # (("demo", "App-1")) → the spread its selectors read at
    spread_overrides: dict | None = None
    # leaves read this store instead of the exec context's (a downsample
    # or cold tier's, or a streaming ds dataset's), of this dataset
    store: object = None
    dataset_name_override: str | None = None
    # shard → the dispatcher of the node that owns it (None: in-process)
    dispatcher_for_shard: "callable | None" = None
    # two-phase aggregation pushdown: "auto", "always" or "off"
    agg_pushdown: str = "auto"
    # the cost model's key ("": the default model)
    dataset: str = ""

    # ---- shard selection ----------------------------------------------------

    def shards_for_filters(self, filters, spread: int | None = None
                           ) -> list[int]:
        """The shards a selector reads: with equality filters on every
        shard-key label, the 2^spread shards of its shard key, else all.
        The spread is ``spread`` (a query's own) where given, else the
        override of the selector's shard key (its values but the metric's)
        in ``spread_overrides``, else the planner's."""
        eq = {f.column: f.filter.value for f in filters
              if isinstance(f.filter, Equals)}
        if spread is None and self.spread_overrides:
            spread = self.spread_overrides.get(tuple(
                eq.get(lbl) for lbl in SHARD_KEY_LABELS
                if lbl != "_metric_"))
        spread = self.spread if spread is None else spread
        if all(lbl in eq for lbl in SHARD_KEY_LABELS):
            skh = shard_key_hash({k: eq[k] for k in SHARD_KEY_LABELS})
            return shards_for_shard_key(skh, self.num_shards, spread)
        return list(range(self.num_shards))

    # ---- materialization ----------------------------------------------------

    def materialize(self, plan: lp.LogicalPlan,
                    qcontext: QueryContext | None = None) -> ExecPlan:
        """The exec plan tree of ``plan``; its leaves read the shards
        ``qcontext``'s spread (if set) maps their selectors to."""
        return self._walk(plan, qcontext or QueryContext())

    def _walk(self, plan, q: QueryContext) -> ExecPlan:
        m = getattr(self, "_mat_" + type(plan).__name__, None)
        if m is None:
            raise ValueError(f"cannot materialize {type(plan).__name__}")
        return m(plan, q)

    def _leaves(self, raw: lp.RawSeries, mapper, q) -> list[ExecPlan]:
        chunk_start = raw.range_start - raw.lookback - raw.offset
        chunk_end = raw.range_end - raw.offset
        out = []
        for shard in self.shards_for_filters(raw.filters,
                                             q.planner_params.spread):
            leaf = SelectRawPartitionsExec(
                shard=shard, filters=raw.filters, chunk_start=chunk_start,
                chunk_end=chunk_end, value_column=raw.column,
                store=self.store, dataset_name=self.dataset_name_override)
            d = self.dispatcher_for_shard(shard) \
                if self.dispatcher_for_shard is not None else None
            if d is not None:
                leaf.dispatcher = d
            out.append(leaf.add_transformer(mapper))
        return out

    @staticmethod
    def _concat(plans: list[ExecPlan]) -> ExecPlan:
        return plans[0] if len(plans) == 1 \
            else DistConcatExec(children_plans=plans)

    def _split_ranges(self, start: int, step: int, end: int):
        """[start, end] as sequential sub-ranges on step boundaries."""
        if (self.time_split_ms <= 0 or step <= 0
                or end - start <= self.time_split_ms):
            return [(start, end)]
        out = []
        cur = start
        steps_per_split = max(self.time_split_ms // step, 1)
        while cur <= end:
            sub_end = min(cur + steps_per_split * step - step, end)
            out.append((cur, sub_end))
            cur = sub_end + step
        return out

    def _split(self, plan, mapper_for, lookback: int, q) -> ExecPlan:
        parts = []
        for s, e in self._split_ranges(plan.start, plan.step, plan.end):
            raw = plan.raw if plan.at_ms is not None else lp.RawSeries(
                plan.raw.filters, s, e, lookback, plan.raw.offset,
                plan.raw.column)
            parts.append(self._concat(self._leaves(raw, mapper_for(s, e),
                                                   q)))
        return parts[0] if len(parts) == 1 \
            else StitchRvsExec(children_plans=parts)

    def _mat_PeriodicSeries(self, plan: lp.PeriodicSeries, q) -> ExecPlan:
        return self._split(plan, lambda s, e: tf.PeriodicSamplesMapper(
            s, plan.step, e, offset=plan.offset, at_ms=plan.at_ms),
            plan.raw.lookback, q)

    def _mat_PeriodicSeriesWithWindowing(
            self, plan: lp.PeriodicSeriesWithWindowing, q) -> ExecPlan:
        return self._split(plan, lambda s, e: tf.PeriodicSamplesMapper(
            s, plan.step, e, plan.window, plan.function, plan.params,
            plan.offset, plan.at_ms), max(plan.raw.lookback, plan.window),
            q)

    def _mat_RawSeries(self, plan: lp.RawSeries, q) -> ExecPlan:
        # a raw export: the last sample at the end of the range
        mapper = tf.PeriodicSamplesMapper(plan.range_start, 0, plan.range_end,
                                          offset=plan.offset)
        return self._concat(self._leaves(plan, mapper, q))

    # -- aggregations and joins --

    def _pushdown_leaves(self, plan: lp.Aggregate, inner: ExecPlan,
                         q) -> list | None:
        """The selector leaves to push the map stage into, or None (see
        the module's text). The map stage rides the leaves' transformers,
        so the plan under the aggregation must be a leaf or a concat of
        leaves with nothing above them."""
        if self.agg_pushdown not in AGG_PUSHDOWN_MODES:
            raise ValueError(f"agg_pushdown {self.agg_pushdown!r}: one of "
                             f"{AGG_PUSHDOWN_MODES}")
        if self.agg_pushdown == "off" or plan.op not in tf.AGG_PUSHDOWN_OPS:
            return None
        if isinstance(inner, SelectRawPartitionsExec):
            leaves = [inner]
        elif isinstance(inner, DistConcatExec) and not inner.transformers \
                and all(isinstance(c, SelectRawPartitionsExec)
                        for c in inner.children_plans):
            leaves = inner.children_plans
        else:
            return None
        if self.agg_pushdown == "always":
            return leaves
        from filodb_tpu_torch.query import cost_model as cm

        local = all(isinstance(c.dispatcher, InProcessPlanDispatcher)
                    for c in leaves)
        model = cm.model_for(self.dataset)
        d = model.decide(
            "pushdown", f"agg:{plan.op}:leaves{cm.bucket(len(leaves))}:"
            f"{'local' if local else 'remote'}", ("pushdown", "local"),
            "local" if local else "pushdown")
        if q is not None:
            model.defer(q, d)
        return None if d.arm == "local" else leaves

    def _mat_Aggregate(self, plan: lp.Aggregate, q) -> ExecPlan:
        inner = self._walk(plan.vector, q)
        params = tuple(plan.params)
        leaves = self._pushdown_leaves(plan, inner, q)
        if leaves is not None:
            PUSHDOWN_APPLIED.inc()
            for leaf in leaves:
                leaf.add_transformer(tf.AggregatePartialMapper(
                    plan.op, params, plan.by, plan.without))
            return ReduceAggregateExec(children_plans=leaves, op=plan.op,
                                       params=params, by=plan.by,
                                       without=plan.without, pushdown=True)
        PUSHDOWN_BYPASSED.inc()
        return ReduceAggregateExec(children_plans=[inner], op=plan.op,
                                   params=params, by=plan.by,
                                   without=plan.without)

    def _mat_BinaryJoin(self, plan: lp.BinaryJoin, q) -> ExecPlan:
        lhs, rhs = self._walk(plan.lhs, q), self._walk(plan.rhs, q)
        if plan.op in SET_OPS:
            return SetOperatorExec(lhs_plans=[lhs], rhs_plans=[rhs],
                                   op=plan.op, on=plan.on,
                                   ignoring=plan.ignoring)
        return BinaryJoinExec(lhs_plans=[lhs], rhs_plans=[rhs], op=plan.op,
                              cardinality=plan.cardinality, on=plan.on,
                              ignoring=plan.ignoring, include=plan.include,
                              bool_mode=plan.bool_mode)

    def _mat_ScalarVectorBinaryOperation(
            self, plan: lp.ScalarVectorBinaryOperation, q) -> ExecPlan:
        vec = self._walk(plan.vector, q)
        return vec.add_transformer(_ScalarOpDeferred(
            plan.op, self._walk(plan.scalar, q), plan.scalar_is_lhs,
            plan.bool_mode))

    # -- functions --

    def _mapped(self, plan, mapper, q) -> ExecPlan:
        return self._walk(plan.vector, q).add_transformer(mapper)

    def _mat_ApplyInstantFunction(self, plan, q) -> ExecPlan:
        return self._mapped(plan, tf.InstantVectorFunctionMapper(
            plan.function, tuple(plan.args)), q)

    def _mat_ApplyMiscellaneousFunction(self, plan, q) -> ExecPlan:
        return self._mapped(plan, tf.MiscellaneousFunctionMapper(
            plan.function, tuple(plan.args)), q)

    def _mat_ApplySortFunction(self, plan, q) -> ExecPlan:
        return self._mapped(plan, tf.SortFunctionMapper(plan.descending), q)

    def _mat_ApplyAbsentFunction(self, plan, q) -> ExecPlan:
        return self._mapped(plan, tf.AbsentFunctionMapper(
            plan.filters, plan.start, plan.step or 1000, plan.end), q)

    def _mat_ApplyLimitFunction(self, plan, q) -> ExecPlan:
        return self._mapped(plan, tf.LimitFunctionMapper(plan.limit), q)

    # -- subqueries --

    def _mat_SubqueryWithWindowing(self, plan: lp.SubqueryWithWindowing,
                                   q) -> ExecPlan:
        return self._walk(lp.subquery_inner(plan), q).add_transformer(
            tf.PeriodicSamplesMapper(
                plan.start, plan.step, plan.end, plan.subquery_window,
                plan.function, tuple(plan.params), plan.offset))

    def _mat_TopLevelSubquery(self, plan: lp.TopLevelSubquery, q) -> ExecPlan:
        return self._walk(lp.retime(plan.inner, plan.start, plan.step,
                                    plan.end), q)

    # -- scalars --

    def _mat_ScalarFixedDoublePlan(self, plan, q) -> ExecPlan:
        return ScalarFixedDoubleExec(value=plan.value, start=plan.start,
                                     step=plan.step or 1000, end=plan.end)

    def _mat_ScalarTimeBasedPlan(self, plan, q) -> ExecPlan:
        return TimeScalarGeneratorExec(function=plan.function,
                                       start=plan.start,
                                       step=plan.step or 1000, end=plan.end)

    def _mat_ScalarVaryingDoublePlan(self, plan, q) -> ExecPlan:
        times = lp.plan_times(plan.vector)
        start, step, end = (times[0], max(times[1], 1), times[2]) if times \
            else (0, 1000, 0)
        return ScalarVaryingExec(inner=self._walk(plan.vector, q),
                                 start=start, step=step, end=end)

    def _mat_ScalarBinaryOperation(self, plan, q) -> ExecPlan:
        def side(x):
            if isinstance(x, (int, float)):
                return float(x)
            return self._walk(x, q)

        return ScalarBinaryOperationExec(op=plan.op, lhs=side(plan.lhs),
                                         rhs=side(plan.rhs), start=plan.start,
                                         step=plan.step or 1000, end=plan.end)

    def _mat_VectorPlan(self, plan, q) -> ExecPlan:
        return VectorFromScalarExec(inner=self._walk(plan.scalar, q))


class _ScalarOpDeferred(tf.RangeVectorTransformer):
    """``ScalarOperationMapper`` whose scalar side is a scalar plan,
    evaluated when the transformer runs (it takes the exec context through
    ``bind``)."""

    def __init__(self, op, scalar_exec, scalar_is_lhs, bool_mode):
        self.op = op
        self.scalar_exec = scalar_exec
        self.scalar_is_lhs = scalar_is_lhs
        self.bool_mode = bool_mode
        self._ctx: ExecContext | None = None

    def bind(self, ctx: ExecContext) -> None:
        self._ctx = ctx

    def apply(self, data):
        scalar, _ = self.scalar_exec.execute_scalar(self._ctx)
        return tf.ScalarOperationMapper(self.op, scalar, self.scalar_is_lhs,
                                        self.bool_mode).apply(data)
