"""LogicalPlanParser: reconstruct PromQL text from a LogicalPlan.

Copy of ``filodb_tpu/query/logical_parser.py`` over the port's logical
plans: the HA and multi-partition planners (``coordinator/
ha_planner.py``) send a sub-plan to another cluster as a query string
(``PromQlRemoteExec`` carries PromQL, not serialized plans, across
cluster boundaries).
"""

from __future__ import annotations

from filodb_tpu_torch.core.filters import (
    Equals,
    EqualsRegex,
    In,
    NotEquals,
    NotEqualsRegex,
)
from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.query import logical as lp


def _dur(ms: int) -> str:
    if ms % 3_600_000 == 0:
        return f"{ms // 3_600_000}h"
    if ms % 60_000 == 0:
        return f"{ms // 60_000}m"
    if ms % 1000 == 0:
        return f"{ms // 1000}s"
    return f"{ms}ms"


def _q(v: str) -> str:
    """Quote a label value/pattern as re-parseable PromQL."""
    return '"' + v.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n").replace("\t", "\\t") + '"'


def _selector(filters, column=None) -> str:
    metric = ""
    matchers = []
    for f in filters:
        flt = f.filter
        if f.column == METRIC_LABEL and isinstance(flt, Equals):
            metric = flt.value
            continue
        if isinstance(flt, Equals):
            matchers.append(f'{f.column}={_q(flt.value)}')
        elif isinstance(flt, NotEquals):
            matchers.append(f'{f.column}!={_q(flt.value)}')
        elif isinstance(flt, EqualsRegex):
            matchers.append(f'{f.column}=~{_q(flt.pattern)}')
        elif isinstance(flt, NotEqualsRegex):
            matchers.append(f'{f.column}!~{_q(flt.pattern)}')
        elif isinstance(flt, In):
            import re as _re
            # regex-escape each value: the rendered =~ must match the
            # literal strings, not treat '.' or '|' inside them as regex
            vals = "|".join(_re.escape(v) for v in sorted(flt.values))
            matchers.append(f'{f.column}=~{_q(vals)}')
    body = metric
    if column:
        body += f"::{column}"
    if matchers:
        body += "{" + ",".join(matchers) + "}"
    return body or "{}"


def _offset_suffix(offset: int) -> str:
    return f" offset {_dur(offset)}" if offset else ""


def _at_suffix(at_ms) -> str:
    return f" @ {at_ms // 1000}" if at_ms is not None else ""


def to_promql(plan: lp.LogicalPlan) -> str:
    """Render a LogicalPlan back to PromQL."""
    if isinstance(plan, lp.PeriodicSeries):
        return _selector(plan.raw.filters, plan.raw.column) \
            + _offset_suffix(plan.offset) + _at_suffix(plan.at_ms)
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        sel = _selector(plan.raw.filters, plan.raw.column)
        rng = (f"{sel}[{_dur(plan.window)}]{_offset_suffix(plan.offset)}"
               f"{_at_suffix(plan.at_ms)}")
        args = [rng]
        if plan.function == "quantile_over_time":
            args = [str(plan.params[0]), rng]
        elif plan.function in ("holt_winters", "predict_linear"):
            args = [rng] + [_num(p) for p in plan.params]
        return f"{plan.function}({', '.join(args)})"
    if isinstance(plan, lp.SubqueryWithWindowing):
        inner = to_promql(plan.inner)
        sub = (f"{inner}[{_dur(plan.subquery_window)}:"
               f"{_dur(plan.subquery_step)}]{_offset_suffix(plan.offset)}")
        args = [sub]
        if plan.function == "quantile_over_time":
            args = [str(plan.params[0]), sub]
        elif plan.function in ("holt_winters", "predict_linear"):
            args = [sub] + [_num(p) for p in plan.params]
        return f"{plan.function}({', '.join(args)})"
    if isinstance(plan, lp.TopLevelSubquery):
        return to_promql(plan.inner)
    if isinstance(plan, lp.Aggregate):
        inner = to_promql(plan.vector)
        clause = ""
        if plan.by:
            clause = f" by ({', '.join(plan.by)})"
        elif plan.without:
            clause = f" without ({', '.join(plan.without)})"
        if plan.op in ("topk", "bottomk", "quantile", "count_values"):
            p = plan.params[0]
            pstr = f'"{p}"' if isinstance(p, str) else _num(p)
            return f"{plan.op}({pstr}, {inner}){clause}"
        return f"{plan.op}({inner}){clause}"
    if isinstance(plan, lp.BinaryJoin):
        l, r = to_promql(plan.lhs), to_promql(plan.rhs)
        mods = []
        if plan.bool_mode:
            mods.append("bool")
        if plan.on is not None:
            mods.append(f"on ({', '.join(plan.on)})")
        elif plan.ignoring:
            mods.append(f"ignoring ({', '.join(plan.ignoring)})")
        if plan.cardinality == "many-to-one":
            mods.append(f"group_left ({', '.join(plan.include)})"
                        if plan.include else "group_left")
        elif plan.cardinality == "one-to-many":
            mods.append(f"group_right ({', '.join(plan.include)})"
                        if plan.include else "group_right")
        mod = (" " + " ".join(mods)) if mods else ""
        return f"({l} {plan.op}{mod} {r})"
    if isinstance(plan, lp.ScalarVectorBinaryOperation):
        s = to_promql(plan.scalar)
        v = to_promql(plan.vector)
        b = "bool " if plan.bool_mode else ""
        if plan.scalar_is_lhs:
            return f"({s} {plan.op} {b}{v})"
        return f"({v} {plan.op} {b}{s})"
    if isinstance(plan, lp.ApplyInstantFunction):
        inner = to_promql(plan.vector)
        args = [_num(a) if isinstance(a, (int, float)) else str(a)
                for a in plan.args]
        if plan.function == "histogram_quantile":
            return f"histogram_quantile({args[0]}, {inner})"
        all_args = ", ".join([inner] + args)
        return f"{plan.function}({all_args})"
    if isinstance(plan, lp.ApplyMiscellaneousFunction):
        inner = to_promql(plan.vector)
        args = ", ".join(f'"{a}"' for a in plan.args)
        return f"{plan.function}({inner}, {args})" if args \
            else f"{plan.function}({inner})"
    if isinstance(plan, lp.ApplySortFunction):
        fn = "sort_desc" if plan.descending else "sort"
        return f"{fn}({to_promql(plan.vector)})"
    if isinstance(plan, lp.ApplyAbsentFunction):
        return f"absent({to_promql(plan.vector)})"
    if isinstance(plan, lp.ApplyLimitFunction):
        return f"limit({plan.limit}, {to_promql(plan.vector)})"
    if isinstance(plan, lp.ScalarFixedDoublePlan):
        return _num(plan.value)
    if isinstance(plan, lp.ScalarTimeBasedPlan):
        return f"{plan.function}()"
    if isinstance(plan, lp.ScalarVaryingDoublePlan):
        return f"scalar({to_promql(plan.vector)})"
    if isinstance(plan, lp.ScalarBinaryOperation):
        l = _num(plan.lhs) if isinstance(plan.lhs, (int, float)) \
            else to_promql(plan.lhs)
        r = _num(plan.rhs) if isinstance(plan.rhs, (int, float)) \
            else to_promql(plan.rhs)
        return f"({l} {plan.op} {r})"
    if isinstance(plan, lp.VectorPlan):
        return f"vector({to_promql(plan.scalar)})"
    if isinstance(plan, lp.RawSeries):
        return _selector(plan.filters, plan.column)
    raise ValueError(f"cannot render {type(plan).__name__} to PromQL")


def _num(x) -> str:
    f = float(x)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)
