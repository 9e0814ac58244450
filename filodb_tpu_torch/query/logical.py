"""LogicalPlan algebra.

Copy of ``filodb_tpu/query/logical.py`` (the port imports nothing of ``filodb_tpu``).

Counterpart of reference ``query/src/main/scala/filodb/query/LogicalPlan.scala:6-509``
and ``PlanEnums.scala``: the planner-facing description of a query, produced by
the PromQL front end and materialized into ExecPlans by the planners.

The plan rewrites at the end (``subquery_inner``, ``retime``,
``plan_times``) are copies of the reference planners' (``_retime`` in
``coordinator/planner.py``, ``_plan_times`` in
``coordinator/longtime_planner.py``), kept here so that the planner and
the mesh engine share them.

Times are epoch millis throughout (reference uses millis too); windows/offsets
are millis.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass, replace

from filodb_tpu_torch.core.filters import ColumnFilter

# --- enums (reference PlanEnums.scala) -------------------------------------

AGGREGATION_OPERATORS = {
    "sum", "avg", "count", "min", "max", "stddev", "stdvar", "topk",
    "bottomk", "quantile", "count_values", "group",
}

RANGE_FUNCTIONS = {
    "rate", "increase", "delta", "idelta", "irate", "resets", "changes",
    "deriv", "predict_linear", "holt_winters", "avg_over_time",
    "min_over_time", "max_over_time", "sum_over_time", "count_over_time",
    "stddev_over_time", "stdvar_over_time", "quantile_over_time",
    "last_over_time", "present_over_time", "absent_over_time", "timestamp",
    "zscore",
}

INSTANT_FUNCTIONS = {
    "abs", "ceil", "clamp", "clamp_max", "clamp_min", "exp", "floor",
    "histogram_quantile", "ln", "log10", "log2", "round", "sgn", "sqrt",
    "day_of_month", "day_of_week", "day_of_year", "days_in_month", "hour",
    "minute", "month", "year", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "deg", "rad",
    "histogram_max_quantile", "hist_to_prom_vectors",
}

MISC_FUNCTIONS = {"label_replace", "label_join", "sort", "sort_desc",
                  "absent", "scalar", "vector", "time", "pi"}


class LogicalPlan:
    """Base of the plan algebra."""

    def is_raw_series(self) -> bool:
        return isinstance(self, RawSeries)


# --- leaf / series plans ----------------------------------------------------


@dataclass(frozen=True)
class RawSeries(LogicalPlan):
    """Select raw chunks for matching series over [start-lookback, end]
    (reference ``RawSeries``)."""

    filters: tuple[ColumnFilter, ...]
    range_start: int  # ms
    range_end: int    # ms
    lookback: int = 0
    offset: int = 0
    column: str | None = None  # explicit value column (::sum etc.)


@dataclass(frozen=True)
class RawChunkMeta(LogicalPlan):
    """Chunk metadata debug query (reference ``RawChunkMeta``)."""

    filters: tuple[ColumnFilter, ...]
    range_start: int
    range_end: int
    column: str = ""


# --- periodic (step) plans --------------------------------------------------


@dataclass(frozen=True)
class PeriodicSeries(LogicalPlan):
    """Instant-vector materialization at each step: latest sample within
    the staleness lookback (reference ``PeriodicSeries``)."""

    raw: RawSeries
    start: int
    step: int
    end: int
    offset: int = 0
    at_ms: int | None = None  # @ modifier: fixed evaluation time


@dataclass(frozen=True)
class PeriodicSeriesWithWindowing(LogicalPlan):
    """Range function over a window at each step
    (reference ``PeriodicSeriesWithWindowing``)."""

    raw: RawSeries
    start: int
    step: int
    end: int
    window: int
    function: str  # one of RANGE_FUNCTIONS
    params: tuple = ()
    offset: int = 0
    at_ms: int | None = None  # @ modifier: fixed evaluation time


@dataclass(frozen=True)
class SubqueryWithWindowing(LogicalPlan):
    """Range function applied over a subquery's inner plan
    (reference ``SubqueryWithWindowing:199``)."""

    inner: LogicalPlan
    start: int
    step: int
    end: int
    function: str
    params: tuple
    subquery_window: int
    subquery_step: int
    offset: int = 0


@dataclass(frozen=True)
class TopLevelSubquery(LogicalPlan):
    """Top-level subquery sampling (reference ``TopLevelSubquery:239``)."""

    inner: LogicalPlan
    start: int
    step: int
    end: int
    original_step: int = 0


# --- transforms -------------------------------------------------------------


@dataclass(frozen=True)
class Aggregate(LogicalPlan):
    op: str
    vector: LogicalPlan
    params: tuple = ()
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()


@dataclass(frozen=True)
class BinaryJoin(LogicalPlan):
    lhs: LogicalPlan
    op: str
    rhs: LogicalPlan
    cardinality: str = "one-to-one"  # one-to-one|many-to-one|one-to-many|many-to-many
    on: tuple[str, ...] | None = None
    ignoring: tuple[str, ...] = ()
    include: tuple[str, ...] = ()  # group_left/right labels
    bool_mode: bool = False


@dataclass(frozen=True)
class ScalarVectorBinaryOperation(LogicalPlan):
    op: str
    scalar: LogicalPlan  # scalar-producing plan
    vector: LogicalPlan
    scalar_is_lhs: bool = True
    bool_mode: bool = False


@dataclass(frozen=True)
class ApplyInstantFunction(LogicalPlan):
    vector: LogicalPlan
    function: str
    args: tuple = ()  # scalar plans or literals


@dataclass(frozen=True)
class ApplyMiscellaneousFunction(LogicalPlan):
    vector: LogicalPlan
    function: str  # label_replace | label_join | ...
    args: tuple = ()


@dataclass(frozen=True)
class ApplySortFunction(LogicalPlan):
    vector: LogicalPlan
    descending: bool = False


@dataclass(frozen=True)
class ApplyAbsentFunction(LogicalPlan):
    vector: LogicalPlan
    filters: tuple[ColumnFilter, ...]
    start: int
    step: int
    end: int


@dataclass(frozen=True)
class ApplyLimitFunction(LogicalPlan):
    vector: LogicalPlan
    limit: int


# --- scalar plans -----------------------------------------------------------


@dataclass(frozen=True)
class ScalarFixedDoublePlan(LogicalPlan):
    value: float
    start: int = 0
    step: int = 0
    end: int = 0


@dataclass(frozen=True)
class ScalarTimeBasedPlan(LogicalPlan):
    function: str  # time | pi | scalar fns of time: hour, month...
    start: int = 0
    step: int = 0
    end: int = 0


@dataclass(frozen=True)
class ScalarVaryingDoublePlan(LogicalPlan):
    """scalar(vector) — per-step scalar from a 1-series vector."""

    vector: LogicalPlan
    function: str = "scalar"


@dataclass(frozen=True)
class ScalarBinaryOperation(LogicalPlan):
    op: str
    lhs: LogicalPlan | float
    rhs: LogicalPlan | float
    start: int = 0
    step: int = 0
    end: int = 0


@dataclass(frozen=True)
class VectorPlan(LogicalPlan):
    """vector(scalar) — 1-series vector from a scalar."""

    scalar: LogicalPlan


# --- metadata plans ---------------------------------------------------------


@dataclass(frozen=True)
class LabelValues(LogicalPlan):
    label: str
    filters: tuple[ColumnFilter, ...] = ()
    start: int = 0
    end: int = 0


@dataclass(frozen=True)
class LabelNames(LogicalPlan):
    filters: tuple[ColumnFilter, ...] = ()
    start: int = 0
    end: int = 0


@dataclass(frozen=True)
class SeriesKeysByFilters(LogicalPlan):
    filters: tuple[ColumnFilter, ...]
    start: int = 0
    end: int = 0


# --- utilities --------------------------------------------------------------


def leaf_raw_series(plan: LogicalPlan) -> list[RawSeries]:
    """All RawSeries leaves of a plan tree."""
    out: list[RawSeries] = []

    def walk(p):
        if isinstance(p, RawSeries):
            out.append(p)
            return
        for f in getattr(p, "__dataclass_fields__", {}):
            v = getattr(p, f)
            if isinstance(v, LogicalPlan):
                walk(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, LogicalPlan):
                        walk(x)

    walk(plan)
    return out


# --- plan rewrites the planner and the mesh engine share --------------------


def subquery_inner(plan: SubqueryWithWindowing) -> LogicalPlan:
    """A subquery's inner plan over the window before its first step, at
    the sub-step (60 s without one), its start aligned down to a multiple
    of the sub-step as the reference planner aligns it."""
    sub_step = plan.subquery_step or 60_000
    inner_start = plan.start - plan.subquery_window - plan.offset
    inner_start = (inner_start // sub_step) * sub_step
    return retime(plan.inner, inner_start, sub_step, plan.end - plan.offset)


def retime(plan: LogicalPlan, start: int, step: int, end: int):
    """``plan`` evaluated over [start, end] at ``step`` (the reference
    planner's ``_retime``, for subqueries)."""
    if isinstance(plan, (PeriodicSeries, PeriodicSeriesWithWindowing)):
        raw = replace(plan.raw, range_start=start, range_end=end)
        return replace(plan, raw=raw, start=start, step=step, end=end)
    if isinstance(plan, (SubqueryWithWindowing, ScalarFixedDoublePlan,
                         ScalarTimeBasedPlan, ScalarBinaryOperation)):
        return replace(plan, start=start, step=step, end=end)
    if is_dataclass(plan):
        changes = {f.name: retime(getattr(plan, f.name), start, step, end)
                   for f in fields(plan)
                   if isinstance(getattr(plan, f.name), LogicalPlan)}
        if changes:
            return replace(plan, **changes)
    return plan


def plan_times(plan: LogicalPlan):
    """(start, step, end, longest lookback) over a plan tree's periodic
    nodes, or None (a copy of the reference's
    ``coordinator/longtime_planner._plan_times``)."""
    lo, st, hi, lb = [], [], [], [0]

    def walk(p):
        if isinstance(p, (PeriodicSeries, PeriodicSeriesWithWindowing,
                          SubqueryWithWindowing)):
            lo.append(p.start)
            st.append(p.step)
            hi.append(p.end)
            if isinstance(p, PeriodicSeriesWithWindowing):
                lb.append(p.window + p.offset)
            elif isinstance(p, SubqueryWithWindowing):
                lb.append(p.subquery_window + p.offset)
            else:
                lb.append(300_000 + p.offset)
        if is_dataclass(p):
            for f in fields(p):
                v = getattr(p, f.name)
                if isinstance(v, LogicalPlan):
                    walk(v)

    walk(plan)
    if not lo:
        return None
    return min(lo), max(st), max(hi), max(lb)
