"""PromQL parser: query text → LogicalPlan.

Copy of ``filodb_tpu/promql/parser.py`` (the port imports nothing of ``filodb_tpu``).

Counterpart of the reference's parser facade and ANTLR grammar
(``prometheus/src/main/scala/filodb/prometheus/parse/Parser.scala:13-48``,
``AntlrParser.scala``, grammar ``antlr/PromQL.g4``, AST lowering in
``prometheus/src/main/scala/filodb/prometheus/ast/``). A hand-written
recursive-descent parser (no parser generator dependency) covering:

- selectors with label matchers (=, !=, =~, !~), metric names, ``__name__``
- matrix selectors ``[5m]``, offsets ``offset 5m``, subqueries ``[1h:5m]``
- step-multiple durations ``[5i]`` (reference README.md:429-460: ``i`` =
  publish/step interval multiples)
- full operator precedence: or < and/unless < comparisons < +- < */% <
  ^ < unary, with ``bool`` modifier and vector matching (on/ignoring/
  group_left/group_right)
- aggregations with by/without (prefix or suffix), topk/quantile/
  count_values parameters
- range/instant/misc functions incl. ``histogram_quantile``,
  ``label_replace``, ``absent``, ``vector``/``scalar``/``time``

The metric name maps to the ``_metric_`` label filter, matching the
reference's partition-key convention (``Schemas`` metric column).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from filodb_tpu_torch.core.filters import (
    ColumnFilter,
    Equals,
    EqualsRegex,
    NotEquals,
    NotEqualsRegex,
)
from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.query import logical as lp

DEFAULT_STALENESS_MS = 300_000  # prometheus 5m staleness lookback


class ParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# lexer

_TOKEN_RE = re.compile(r"""
      (?P<WS>\s+)
    | (?P<COMMENT>\#[^\n]*)
    | (?P<DURATION>[0-9]+(?:\.[0-9]+)?(?:ms|s|m|h|d|w|y|i)(?:[0-9]+(?:ms|s|m|h|d|w|y))*)
    | (?P<NUMBER>0x[0-9a-fA-F]+|(?:[0-9]*\.[0-9]+|[0-9]+\.?)(?:[eE][+-]?[0-9]+)?|[Ii][Nn][Ff](?![a-zA-Z0-9_:])|[Nn][Aa][Nn](?![a-zA-Z0-9_:]))
    | (?P<IDENT>[a-zA-Z_][a-zA-Z0-9_:]*)
    | (?P<STRING>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*'|`[^`]*`)
    | (?P<OP>=~|!~|==|!=|<=|>=|<|>|=|\+|-|\*|/|%|\^|\(|\)|\{|\}|\[|\]|,|:|@)
""", re.VERBOSE)

_DUR_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000,
           "w": 604_800_000, "y": 31_536_000_000}

_KEYWORDS = {"and", "or", "unless", "by", "without", "on", "ignoring",
             "group_left", "group_right", "offset", "bool", "atan2"}


# required scalar-parameter counts for instant functions (exact, or
# (min, max) range) — the reference parser validates arity in the grammar;
# here it's a table check at plan construction
_INSTANT_FN_PARAMS = {
    "clamp": 2, "clamp_max": 1, "clamp_min": 1,
    "histogram_quantile": 1, "histogram_max_quantile": 1,
    "round": (0, 1),
    "abs": 0, "ceil": 0, "floor": 0, "exp": 0, "ln": 0, "log2": 0,
    "log10": 0, "sqrt": 0, "sgn": 0, "deg": 0, "rad": 0,
    "acos": 0, "asin": 0, "atan": 0, "cos": 0, "cosh": 0, "sin": 0,
    "sinh": 0, "tan": 0, "tanh": 0, "asinh": 0, "acosh": 0, "atanh": 0,
    "hour": 0, "minute": 0, "month": 0, "year": 0, "day_of_month": 0,
    "day_of_week": 0, "day_of_year": 0, "days_in_month": 0,
    "timestamp": 0,
}


@dataclass
class Token:
    kind: str
    text: str
    pos: int


def tokenize(text: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ParseError(f"unexpected character {text[pos]!r} at {pos}")
        kind = m.lastgroup
        if kind not in ("WS", "COMMENT"):
            tok_text = m.group()
            if kind == "IDENT" and tok_text in _KEYWORDS:
                kind = "KEYWORD"
            out.append(Token(kind, tok_text, pos))
        pos = m.end()
    out.append(Token("EOF", "", pos))
    return out


def parse_duration_ms(text: str, step_ms: int = 0) -> int:
    """Parse '5m', '1h30m', or step-multiple '5i' into millis."""
    if text.endswith("i"):
        mult = float(text[:-1])
        if step_ms <= 0:
            raise ParseError("step-multiple duration used without a step")
        return int(mult * step_ms)
    total = 0
    for num, unit in re.findall(r"([0-9]+(?:\.[0-9]+)?)(ms|s|m|h|d|w|y)", text):
        total += int(float(num) * _DUR_MS[unit])
    return total


def _unquote(s: str) -> str:
    body = s[1:-1]
    if s[0] == "`":
        return body  # raw string: no escape processing (PromQL backticks)
    return (body.replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\'", "'").replace("\\n", "\n").replace("\\t", "\t")
            .replace("\x00", "\\"))


# ---------------------------------------------------------------------------
# time params

@dataclass(frozen=True)
class TimeStepParams:
    """Query range params (epoch seconds, like the HTTP API)."""

    start: int
    step: int
    end: int

    @property
    def start_ms(self) -> int:
        return self.start * 1000

    @property
    def end_ms(self) -> int:
        return self.end * 1000

    @property
    def step_ms(self) -> int:
        return self.step * 1000


def instant_params(time_sec: int) -> TimeStepParams:
    return TimeStepParams(time_sec, 0, time_sec)


# ---------------------------------------------------------------------------
# parser

class Parser:
    def __init__(self, text: str, params: TimeStepParams,
                 lookback_ms: int = DEFAULT_STALENESS_MS):
        self.toks = tokenize(text)
        self.i = 0
        self.params = params
        self.lookback = lookback_ms

    # -- token helpers --

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        if self.i >= len(self.toks):
            raise ParseError("unexpected end of query")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: str | None = None) -> Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise ParseError(f"expected {text or kind}, got {t.text!r} at {t.pos}")
        return t

    def accept(self, kind: str, text: str | None = None) -> Token | None:
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    # -- entry --

    def parse(self) -> lp.LogicalPlan:
        plan = self.parse_or()
        if self.peek().kind != "EOF":
            t = self.peek()
            raise ParseError(f"unexpected trailing input {t.text!r} at {t.pos}")
        return self._finalize(plan)

    def _finalize(self, plan) -> lp.LogicalPlan:
        """Wrap a bare selector / range expr into its periodic form."""
        if isinstance(plan, _Selector):
            return self._periodicize(plan)
        if isinstance(plan, _RangeExpr):
            raise ParseError("range expression must be wrapped in a function")
        return plan

    # -- precedence climbing --

    def parse_or(self):
        left = self.parse_and()
        while self.accept("KEYWORD", "or"):
            matching = self._vector_matching()
            right = self.parse_and()
            left = self._binary("or", left, right, matching)
        return left

    def parse_and(self):
        left = self.parse_comparison()
        while True:
            t = self.peek()
            if t.kind == "KEYWORD" and t.text in ("and", "unless"):
                self.next()
                matching = self._vector_matching()
                right = self.parse_comparison()
                left = self._binary(t.text, left, right, matching)
            else:
                return left

    def parse_comparison(self):
        left = self.parse_addsub()
        while self.peek().kind == "OP" and self.peek().text in (
                "==", "!=", "<", ">", "<=", ">="):
            op = self.next().text
            bool_mode = self.accept("KEYWORD", "bool") is not None
            matching = self._vector_matching()
            right = self.parse_addsub()
            left = self._binary(op, left, right, matching, bool_mode)
        return left

    def parse_addsub(self):
        left = self.parse_muldiv()
        while self.peek().kind == "OP" and self.peek().text in ("+", "-"):
            op = self.next().text
            matching = self._vector_matching()
            right = self.parse_muldiv()
            left = self._binary(op, left, right, matching)
        return left

    def parse_muldiv(self):
        left = self.parse_power()
        while ((self.peek().kind == "OP" and self.peek().text in ("*", "/", "%"))
               or (self.peek().kind == "KEYWORD" and self.peek().text == "atan2")):
            op = self.next().text
            matching = self._vector_matching()
            right = self.parse_power()
            left = self._binary(op, left, right, matching)
        return left

    def parse_power(self):
        left = self.parse_unary()
        if self.peek().kind == "OP" and self.peek().text == "^":
            self.next()
            matching = self._vector_matching()
            right = self.parse_power()  # right-associative
            left = self._binary("^", left, right, matching)
        return left

    def parse_unary(self):
        if self.peek().kind == "OP" and self.peek().text in ("+", "-"):
            op = self.next().text
            operand = self.parse_unary()
            if op == "-":
                return self._binary("*", _Scalar(-1.0), operand, None)
            return operand
        return self.parse_postfix()

    # -- atoms & postfix ([range], [sub:step], offset) --

    def parse_postfix(self):
        e = self.parse_atom()
        while True:
            if self.accept("OP", "["):
                first = self.expect("DURATION").text
                if self.accept("OP", ":"):
                    # subquery [window:step]
                    step_tok = self.accept("DURATION")
                    sub_step = (parse_duration_ms(step_tok.text,
                                                  self.params.step_ms)
                                if step_tok else 0)
                    self.expect("OP", "]")
                    window = parse_duration_ms(first, self.params.step_ms)
                    e = _Subquery(self._finalize(e), window, sub_step)
                else:
                    self.expect("OP", "]")
                    if not isinstance(e, _Selector):
                        raise ParseError("range selector on non-selector")
                    e = _RangeExpr(e, parse_duration_ms(first,
                                                        self.params.step_ms))
            elif self.accept("KEYWORD", "offset"):
                neg = self.accept("OP", "-") is not None
                d = parse_duration_ms(self.expect("DURATION").text,
                                      self.params.step_ms)
                d = -d if neg else d
                if isinstance(e, _Selector):
                    e = _Selector(e.filters, e.offset + d, e.at_ms, e.column)
                elif isinstance(e, _RangeExpr):
                    e = _RangeExpr(_Selector(e.sel.filters, e.sel.offset + d,
                                             e.sel.at_ms, e.sel.column),
                                   e.window)
                elif isinstance(e, _Subquery):
                    e = _Subquery(e.inner, e.window, e.step, e.offset + d,
                                  e.at_ms)
                else:
                    raise ParseError("offset on non-selector")
            elif self.accept("OP", "@"):
                at_ms = self._at_modifier()
                if isinstance(e, _Selector):
                    e = _Selector(e.filters, e.offset, at_ms, e.column)
                elif isinstance(e, _RangeExpr):
                    e = _RangeExpr(_Selector(e.sel.filters, e.sel.offset,
                                             at_ms, e.sel.column), e.window)
                elif isinstance(e, _Subquery):
                    e = _Subquery(e.inner, e.window, e.step, e.offset, at_ms)
                else:
                    raise ParseError("@ on non-selector")
            else:
                return e

    def _at_modifier(self) -> int:
        """Parse the @ timestamp: unix seconds, start(), or end()."""
        t = self.next()
        if t.kind == "NUMBER":
            return int(self._num(t.text) * 1000)
        if t.kind == "IDENT" and t.text in ("start", "end"):
            self.expect("OP", "(")
            self.expect("OP", ")")
            return (self.params.start_ms if t.text == "start"
                    else self.params.end_ms)
        raise ParseError(f"bad @ modifier {t.text!r} at {t.pos}")

    def parse_atom(self):
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            return _Scalar(self._num(t.text))
        if t.kind == "DURATION":
            # bare durations act as second-scalars (promql extension)
            self.next()
            return _Scalar(parse_duration_ms(t.text, self.params.step_ms) / 1000.0)
        if t.kind == "STRING":
            self.next()
            return _Str(_unquote(t.text))
        if t.kind == "OP" and t.text == "(":
            self.next()
            inner = self.parse_or()
            self.expect("OP", ")")
            return inner
        if t.kind == "OP" and t.text == "{":
            return self._selector(None)
        if t.kind == "IDENT":
            name = self.next().text
            if name in lp.AGGREGATION_OPERATORS:
                return self._aggregation(name)
            if self.peek().kind == "OP" and self.peek().text == "(":
                return self._function(name)
            return self._selector(name)
        if t.kind == "KEYWORD" and t.text in ("and", "or", "unless"):
            # metric named like keyword — not supported, clearer error
            raise ParseError(f"unexpected keyword {t.text!r} at {t.pos}")
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    @staticmethod
    def _num(text: str) -> float:
        tl = text.lower()
        if tl == "inf":
            return float("inf")
        if tl == "nan":
            return float("nan")
        if tl.startswith("0x"):
            return float(int(text, 16))
        return float(text)

    # -- selectors --

    def _selector(self, metric: str | None):
        filters: list[ColumnFilter] = []
        column = None
        if metric is not None and "::" in metric:
            # filodb extension: metric::column selects a value column
            # (e.g. ds rollup columns min/max/sum/count/avg)
            metric, column = metric.split("::", 1)
        if metric is not None:
            filters.append(ColumnFilter(METRIC_LABEL, Equals(metric)))
        if self.accept("OP", "{"):
            while not self.accept("OP", "}"):
                label = self.next()
                if label.kind not in ("IDENT", "KEYWORD"):
                    raise ParseError(f"bad label name {label.text!r}")
                op = self.next().text
                val = _unquote(self.expect("STRING").text)
                lname = METRIC_LABEL if label.text == "__name__" else label.text
                if op == "=":
                    filters.append(ColumnFilter(lname, Equals(val)))
                elif op == "!=":
                    filters.append(ColumnFilter(lname, NotEquals(val)))
                elif op == "=~":
                    filters.append(ColumnFilter(lname, EqualsRegex(val)))
                elif op == "!~":
                    filters.append(ColumnFilter(lname, NotEqualsRegex(val)))
                else:
                    raise ParseError(f"bad matcher op {op!r}")
                if not self.accept("OP", ","):
                    self.expect("OP", "}")
                    break
        if not filters:
            raise ParseError("empty selector")
        return _Selector(tuple(filters), column=column)

    # -- vector matching clauses --

    def _vector_matching(self):
        on = None
        ignoring: tuple[str, ...] = ()
        card = "one-to-one"
        include: tuple[str, ...] = ()
        t = self.peek()
        if t.kind == "KEYWORD" and t.text in ("on", "ignoring"):
            self.next()
            labels = self._label_list()
            if t.text == "on":
                on = labels
            else:
                ignoring = labels
            t2 = self.peek()
            if t2.kind == "KEYWORD" and t2.text in ("group_left", "group_right"):
                self.next()
                card = ("many-to-one" if t2.text == "group_left"
                        else "one-to-many")
                if self.peek().kind == "OP" and self.peek().text == "(":
                    include = self._label_list()
            return (on, ignoring, card, include)
        return None

    def _label_list(self) -> tuple[str, ...]:
        self.expect("OP", "(")
        labels = []
        while not self.accept("OP", ")"):
            tok = self.next()
            if tok.kind not in ("IDENT", "KEYWORD"):
                raise ParseError(f"bad label {tok.text!r}")
            labels.append(tok.text)
            if not self.accept("OP", ","):
                self.expect("OP", ")")
                break
        return tuple(labels)

    # -- aggregations --

    def _aggregation(self, op: str):
        by: tuple[str, ...] = ()
        without: tuple[str, ...] = ()
        # prefix clause: sum by (x) (...)
        t = self.peek()
        if t.kind == "KEYWORD" and t.text in ("by", "without"):
            self.next()
            labels = self._label_list()
            if t.text == "by":
                by = labels
            else:
                without = labels
        self.expect("OP", "(")
        args = [self.parse_or()]
        while self.accept("OP", ","):
            args.append(self.parse_or())
        self.expect("OP", ")")
        # suffix clause
        t = self.peek()
        if t.kind == "KEYWORD" and t.text in ("by", "without"):
            self.next()
            labels = self._label_list()
            if t.text == "by":
                by = labels
            else:
                without = labels
        params: tuple = ()
        if op in ("topk", "bottomk", "quantile", "count_values"):
            if len(args) != 2:
                raise ParseError(f"{op} expects 2 arguments")
            p = args[0]
            if isinstance(p, _Scalar):
                params = (p.value,)
            elif isinstance(p, _Str):
                params = (p.value,)
            else:
                params = (p,)
            vec = args[1]
        else:
            if len(args) != 1:
                raise ParseError(f"{op} expects 1 argument")
            vec = args[0]
        return lp.Aggregate(op, self._finalize(vec), params, by, without)

    # -- functions --

    def _function(self, name: str):
        self.expect("OP", "(")
        args = []
        if not (self.peek().kind == "OP" and self.peek().text == ")"):
            args.append(self.parse_or())
            while self.accept("OP", ","):
                args.append(self.parse_or())
        self.expect("OP", ")")
        return self._build_function(name, args)

    def _build_function(self, name: str, args: list):
        p = self.params
        # range functions over a matrix/subquery argument
        if name in lp.RANGE_FUNCTIONS:
            if (name in ("timestamp", "last_over_time", "absent_over_time")
                    and len(args) == 1 and isinstance(args[0], _Selector)):
                # instant-vector forms: window = staleness lookback
                sel = args[0]
                raw = self._raw(sel, self.lookback)
                return lp.PeriodicSeriesWithWindowing(
                    raw, p.start_ms, p.step_ms, p.end_ms, self.lookback,
                    name, (), sel.offset)
            scalars_front: list[float] = []
            scalars_back: list[float] = []
            range_arg = None
            for a in args:
                if isinstance(a, (_RangeExpr, _Subquery)):
                    range_arg = a
                elif isinstance(a, _Scalar):
                    (scalars_front if range_arg is None
                     else scalars_back).append(a.value)
                else:
                    raise ParseError(f"{name}: unsupported argument")
            if range_arg is None:
                # last_over_time-style defaulting doesn't exist; timestamp()
                # takes an instant vector
                if name == "timestamp" and len(args) == 1 and isinstance(
                        args[0], _Selector):
                    sel = args[0]
                    raw = self._raw(sel, self.lookback)
                    return lp.PeriodicSeriesWithWindowing(
                        raw, p.start_ms, p.step_ms, p.end_ms, self.lookback,
                        "timestamp", (), sel.offset)
                raise ParseError(f"{name} needs a range-vector argument")
            fn_params = tuple(scalars_front + scalars_back)
            required = {"quantile_over_time": 1, "holt_winters": 2,
                        "predict_linear": 1}.get(name, 0)
            if len(fn_params) != required:
                raise ParseError(
                    f"{name} expects {required} scalar parameter(s), "
                    f"got {len(fn_params)}")
            if isinstance(range_arg, _Subquery):
                sub_step = range_arg.step or p.step_ms or 60_000
                return lp.SubqueryWithWindowing(
                    range_arg.inner, p.start_ms, p.step_ms, p.end_ms, name,
                    fn_params, range_arg.window, sub_step, range_arg.offset)
            sel = range_arg.sel
            raw = self._raw(sel, range_arg.window)
            psww = lp.PeriodicSeriesWithWindowing(
                raw, p.start_ms, p.step_ms, p.end_ms, range_arg.window,
                "present_over_time" if name == "absent_over_time" else name,
                fn_params, sel.offset, sel.at_ms)
            if name == "absent_over_time":
                # promql: 1 when NO matching series has samples in the window
                # (combine across series, like absent())
                return lp.ApplyAbsentFunction(
                    psww, sel.filters, p.start_ms, p.step_ms or 1000,
                    p.end_ms)
            return psww

        if name in lp.INSTANT_FUNCTIONS:
            if not args and name in ("hour", "minute", "month", "year",
                                     "day_of_month", "day_of_week",
                                     "day_of_year", "days_in_month"):
                # promql: zero-arg form defaults to vector(time())
                t = lp.ScalarTimeBasedPlan("time", p.start_ms,
                                           p.step_ms or 1000, p.end_ms)
                return lp.ApplyInstantFunction(lp.VectorPlan(t), name, ())
            vec = None
            fargs: list = []
            for a in args:
                if isinstance(a, _Scalar):
                    fargs.append(a.value)
                elif vec is None and isinstance(
                        a, (_Selector, lp.LogicalPlan, _Subquery)):
                    vec = a
                else:
                    # a second vector, or a string where a scalar parameter
                    # belongs: reject at parse time (the reference grammar
                    # types function params as scalars)
                    raise ParseError(
                        f"{name}: expected scalar parameter, got "
                        f"{type(a).__name__}")
            if vec is None:
                raise ParseError(f"{name} needs a vector argument")
            need = _INSTANT_FN_PARAMS.get(name)
            if need is not None:
                lo_n, hi_n = need if isinstance(need, tuple) else (need, need)
                if not lo_n <= len(fargs) <= hi_n:
                    raise ParseError(
                        f"{name} expects {need} parameter(s), "
                        f"got {len(fargs)}")
            return lp.ApplyInstantFunction(self._finalize(vec), name,
                                           tuple(fargs))

        if name == "absent":
            vec = self._finalize(args[0])
            filters = (args[0].filters if isinstance(args[0], _Selector)
                       else ())
            return lp.ApplyAbsentFunction(vec, filters, p.start_ms,
                                          p.step_ms or 1000, p.end_ms)
        if name in ("sort", "sort_desc"):
            return lp.ApplySortFunction(self._finalize(args[0]),
                                        name == "sort_desc")
        if name in ("label_replace", "label_join"):
            vec = self._finalize(args[0])
            fargs = tuple(a.value for a in args[1:]
                          if isinstance(a, (_Str, _Scalar)))
            if name == "label_replace" and len(fargs) != 4:
                raise ParseError("label_replace expects "
                                 "(v, dst, replacement, src, regex)")
            if name == "label_join" and len(fargs) < 2:
                raise ParseError("label_join expects "
                                 "(v, dst, sep, src...)")
            return lp.ApplyMiscellaneousFunction(vec, name, fargs)
        if name == "scalar":
            if not args:
                raise ParseError("scalar expects one vector argument")
            return lp.ScalarVaryingDoublePlan(self._finalize(args[0]))
        if name == "vector":
            if not args:
                raise ParseError("vector expects one scalar argument")
            sc = args[0]
            if isinstance(sc, _Scalar):
                sc = lp.ScalarFixedDoublePlan(sc.value, p.start_ms,
                                              p.step_ms or 1000, p.end_ms)
            return lp.VectorPlan(sc)
        if name == "time":
            return lp.ScalarTimeBasedPlan("time", p.start_ms,
                                          p.step_ms or 1000, p.end_ms)
        if name == "pi":
            return lp.ScalarFixedDoublePlan(3.141592653589793, p.start_ms,
                                            p.step_ms or 1000, p.end_ms)
        if name == "limit":  # filodb extension
            return lp.ApplyLimitFunction(self._finalize(args[1]),
                                         int(args[0].value))
        raise ParseError(f"unknown function {name!r}")

    # -- plan construction helpers --

    def _raw(self, sel: "_Selector", lookback: int) -> lp.RawSeries:
        p = self.params
        if sel.at_ms is not None:
            # @ pins evaluation: the chunk range collapses to that instant
            return lp.RawSeries(sel.filters, sel.at_ms, sel.at_ms, lookback,
                                sel.offset, sel.column)
        return lp.RawSeries(sel.filters, p.start_ms, p.end_ms, lookback,
                            sel.offset, sel.column)

    def _periodicize(self, sel: "_Selector") -> lp.PeriodicSeries:
        p = self.params
        return lp.PeriodicSeries(self._raw(sel, self.lookback), p.start_ms,
                                 p.step_ms, p.end_ms, sel.offset, sel.at_ms)

    def _binary(self, op, left, right, matching, bool_mode: bool = False):
        on, ignoring, card, include = matching or (None, (), "one-to-one", ())
        lscalar = isinstance(left, (_Scalar, lp.ScalarFixedDoublePlan,
                                    lp.ScalarTimeBasedPlan,
                                    lp.ScalarVaryingDoublePlan,
                                    lp.ScalarBinaryOperation))
        rscalar = isinstance(right, (_Scalar, lp.ScalarFixedDoublePlan,
                                     lp.ScalarTimeBasedPlan,
                                     lp.ScalarVaryingDoublePlan,
                                     lp.ScalarBinaryOperation))
        p = self.params
        if lscalar and rscalar:
            lv = (left.value if isinstance(left, (_Scalar,
                                                  lp.ScalarFixedDoublePlan))
                  else left)
            rv = (right.value if isinstance(right, (_Scalar,
                                                    lp.ScalarFixedDoublePlan))
                  else right)
            if isinstance(lv, float) and isinstance(rv, float):
                out = _fold_scalars(op, lv, rv, bool_mode)
                return lp.ScalarFixedDoublePlan(out, p.start_ms,
                                                p.step_ms or 1000, p.end_ms)
            return lp.ScalarBinaryOperation(op, lv, rv, p.start_ms,
                                            p.step_ms or 1000, p.end_ms)
        if lscalar or rscalar:
            scalar = left if lscalar else right
            vector = right if lscalar else left
            if isinstance(scalar, _Scalar):
                scalar = lp.ScalarFixedDoublePlan(scalar.value, p.start_ms,
                                                  p.step_ms or 1000, p.end_ms)
            return lp.ScalarVectorBinaryOperation(
                op, scalar, self._finalize(vector), scalar_is_lhs=lscalar,
                bool_mode=bool_mode)
        if op in ("and", "or", "unless"):
            card = "many-to-many"
        return lp.BinaryJoin(self._finalize(left), op, self._finalize(right),
                             card, on, ignoring, include, bool_mode)


_SCALAR_OPS = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
    "%": np.fmod, "^": np.power, "atan2": np.arctan2,
}
_SCALAR_CMPS = {
    "==": np.equal, "!=": np.not_equal, ">": np.greater, "<": np.less,
    ">=": np.greater_equal, "<=": np.less_equal,
}


def _fold_scalars(op: str, lhs: float, rhs: float, bool_mode: bool) -> float:
    """Constant-fold a scalar-scalar operator with the instant-function
    semantics: a comparison without ``bool`` keeps lhs where true and NaN
    where false; with ``bool`` it gives 1.0/0.0."""
    a, b = np.float64(lhs), np.float64(rhs)
    with np.errstate(all="ignore"):
        if op in _SCALAR_OPS:
            return float(_SCALAR_OPS[op](a, b))
        if op not in _SCALAR_CMPS:
            raise ValueError(f"unknown binary operator {op}")
        if np.isnan(a) or np.isnan(b):
            return float("nan")
        c = bool(_SCALAR_CMPS[op](a, b))
        if bool_mode:
            return 1.0 if c else 0.0
        return float(a) if c else float("nan")


# -- intermediate parse nodes (not logical plans) --


@dataclass(frozen=True)
class _Scalar:
    value: float


@dataclass(frozen=True)
class _Str:
    value: str


@dataclass(frozen=True)
class _Selector:
    filters: tuple[ColumnFilter, ...]
    offset: int = 0
    at_ms: "int | None" = None
    column: "str | None" = None


@dataclass(frozen=True)
class _RangeExpr:
    sel: _Selector
    window: int


@dataclass(frozen=True)
class _Subquery:
    inner: lp.LogicalPlan
    window: int
    step: int
    offset: int = 0
    at_ms: "int | None" = None


# ---------------------------------------------------------------------------

def parse_query(text: str, params: TimeStepParams,
                lookback_ms: int = DEFAULT_STALENESS_MS) -> lp.LogicalPlan:
    """Parse a PromQL query into a LogicalPlan for the given time params
    (reference ``Parser.queryRangeToLogicalPlan``; ``lookback_ms`` is the
    instant-selector staleness window, reference QueryConfig
    ``staleSampleAfterMs``)."""
    return Parser(text, params, lookback_ms).parse()


def parse_instant_query(text: str, time_sec: int) -> lp.LogicalPlan:
    return parse_query(text, instant_params(time_sec))
