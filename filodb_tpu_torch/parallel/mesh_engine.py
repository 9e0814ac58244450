"""The one-GPU query engine: PromQL plans over scalar series on the card.

Port of ``filodb_tpu/parallel/mesh_engine.py`` for one card. A leaf is
lowered (``lower_plan``) from

    range_fn(selector[w] offset o)   every range function of
                                     ``query/engine/kernels.py`` plus
                                     quantile_over_time and holt_winters
    selector offset o                the instant selector: the last sample
                                     within the staleness lookback

(either at the query's steps, or once at an ``@`` time and repeated
across them) and ``execute`` walks everything above the leaves:
aggregations (sum, avg, min, max, count, group, stddev, stdvar, topk,
bottomk, quantile, count_values), instant functions, absent, sort,
label_replace / label_join, limit, operators with a number or a per-step
scalar, binary joins and set operators of two vectors, scalar plans
(numbers, ``time()``, ``scalar(v)``, scalar arithmetic, ``vector(s)``)
and subqueries, whose range function runs over the inner matrix's steps
as samples.

A leaf selects its partitions on every shard into one batch
(``device_batch.build_device_batch``: the packed pages are uploaded once
and cached per (selector, data range) until the store ingests again, as
the reference's mesh engine caches placed batches, in a ``BatchCache``
that the service's exec engine shares) and evaluates it with
the exec engine's own windowing stage
(``transformers.PeriodicSamplesMapper.eval_batch``), so both engines
launch the same kernels through the same code: B3 for rate / increase /
delta, B1 and B2 then B4 or the float64 functions for the rest, B1 for
histogram buckets; and both take the same lane for a batch whose values
float32 does not hold (the host-decode lane, ``query/engine/batch.py``). Aggregations, instant functions and operators are plain
torch on the card (``query/exec``); joins match labels on the host.

Histograms: a selector that matches ``prom-histogram`` series reads their
bucket pages; every range function of ``HIST_FNS`` and the instant
selector run per bucket. Above the leaf a histogram matrix is [P, K, B]:
sum … stdvar aggregate per bucket, ``histogram_quantile`` /
``histogram_max_quantile`` interpolate on the card, instant functions and
operators with a number are element-wise. ``histogram_quantile`` over
``le``-labelled scalar series (the classic Prometheus form) groups the
bucket series on the host and interpolates on the card.

``execute_many`` evaluates many plans at once, as the reference's does
for ``QueryService.query_range_many``: leaves that differ only in their
step grid (``Lowered.signature``) share one batch over the union of their
data ranges, selected, packed and uploaded once, and each distinct grid
is evaluated over it once. The reference joins its members' grids into
one padded grid for one program; B3 and B4 take only non-decreasing
steps, so here each grid is launched on its own over the shared batch. A
histogram batch under an aggregation other than ``sum`` goes to exec
there, as the reference's batch declines it.

The per-series window cache (the reference's split pipeline,
``_series_eval_cached``): a leaf's evaluated windows [P, K] (the
windowing stage's answer, before any aggregation) are kept on the card in
the ``BatchCache``, keyed as the reference keys them, by the batch's key
and version, the window, the step grid and the function (the functions of
``SPLIT_FNS``; the instant selector is the reference's
``last_over_time``). Every aggregation over one inner range function
shares an entry, so a warm query runs only the group reduce and the
device→host copy, and launches no B3 or B4. Entries count against the
batch cache's budget (least recently used dropped first) and, stamped
with the batch's version, are dropped once the store ingests; counted in
``filodb_mesh_eval_cache{event}``. B3 fuses decode, counter correction
and the window bounds, so the reference's prepare and bounds stages have
no counterpart and no cache of their own (ROADMAP §C).
``FILODB_MESH_SPLIT=0``, read at query time, turns the cache off, as in
the reference.

A query's deadline (``utils.resilience.Deadline``, handed to ``execute``
and ``execute_many``) is checked where each leaf starts and ends, never
inside a kernel.

The multi-process runtime (``coordinator/mesh_cluster.py``,
``parallel/multiproc.py``) splits a plan at its leaf. ``_lower``
recognizes the reference's mesh shapes, ``agg by|without
(fn(selector[w]))`` or a bare leaf under value-wise post-transforms
(instant functions, an operator with a number, topk / bottomk), as a
``MeshLowered``, and declines the grids the sidecar lane takes where
``sidecars`` is set. A worker runs the leaf alone
(``execute_lowered_many`` over the agg-stripped form): its per-series
windows with every series' full key, in its shards' part order. The root
runs the rest over the workers' rows concatenated in shard order
(``reduce_rows``): this engine's own aggregation and transformer code, as
``execute`` would run it over the same rows, so the answers are bitwise
equal to the single-process engine's.

``supports`` decides, before anything runs, whether the engine serves a
plan, as the reference's ``supports`` does: from the plan, and from the
shards' indexes for which selectors match histograms. For any other plan
it names the shape, and ``execute`` raises ``UnsupportedQuery`` with that
text. As in the reference, that is the signal to hand the plan to the
exec engine (``QueryService(engine="mesh")`` does): column selectors
(``h::sum``, ``h::count``), joins and set operators with a histogram
side, ``timestamp(h)``, ``predict_linear(h[w], t)`` and the plan shapes
over a histogram that the exec engine answers go there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from filodb_tpu_torch.device import EXACT_DTYPE
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.engine import sidecar_lane
from filodb_tpu_torch.query.engine.aggregations import AGG_OPS
from filodb_tpu_torch.query.engine.device_batch import (
    MIXED_KINDS,
    BatchCache,
    DeviceBatch,
    build_device_batch,
)
from filodb_tpu_torch.query.engine.instantfns import (
    INSTANT_FNS,
    apply_binary_op,
)
from filodb_tpu_torch.query.engine.kernels import RANGE_FNS
from filodb_tpu_torch.query.exec.binaryjoin import (
    SET_OPS,
    binary_join,
    set_operator,
)
from filodb_tpu_torch.query.exec.transformers import (
    SERVED_FNS,
    STALENESS_MS,
    AbsentFunctionMapper,
    AggregateMapReduce,
    GroupIdCache,
    InstantVectorFunctionMapper,
    LimitFunctionMapper,
    MiscellaneousFunctionMapper,
    PeriodicSamplesMapper,
    ScalarOperationMapper,
    SortFunctionMapper,
    steps_array,
    tensor_of,
)
from filodb_tpu_torch.query.model import (
    QueryStats,
    RangeVectorKey,
    StepMatrix,
    UnsupportedQuery,
)
from filodb_tpu_torch.utils.metrics import get_counter
from filodb_tpu_torch.utils.resilience import check

# the reference's split-pipeline functions (``dist_query.SPLIT_FNS``) and
# the instant selector, which the reference evaluates as last_over_time:
# their evaluated windows are cached
SPLIT_FNS = ("rate", "increase", "delta", "sum_over_time",
             "count_over_time", "avg_over_time", "last_over_time",
             "present_over_time", "stddev_over_time", "stdvar_over_time",
             "last_sample")
_M_EVAL = {e: get_counter("filodb_mesh_eval_cache", {"event": e},
                          help="cached per-series window evaluation "
                          "hits/misses on the split pipeline")
           for e in ("hit", "miss")}


def split_enabled() -> bool:
    """The window cache's valve, ``FILODB_MESH_SPLIT`` (on unless "0")."""
    return os.environ.get("FILODB_MESH_SPLIT", "1") != "0"


@dataclass
class Evaluated:
    """A window-cache entry: a leaf's evaluated windows, the stats its
    evaluation counted, its device bytes and its batch's version."""

    matrix: StepMatrix
    stats: QueryStats
    nbytes: int
    version: int

# range functions a histogram leaf serves here. The exec engine also
# answers timestamp (in seconds from the batch start, not epoch seconds)
# and predict_linear (with its horizon dropped) over a histogram, as the
# reference's exec engine does; this engine raises ``UnsupportedQuery`` for
# them, the signal that sends them there
HIST_FNS = tuple(f for f in RANGE_FNS
                 if f not in ("timestamp", "predict_linear"))
HIST_INSTANT_FNS = ("histogram_quantile", "histogram_max_quantile",
                    "hist_to_prom_vectors")
_RANK_AGGS = ("topk", "bottomk", "quantile")  # one scalar parameter
# the multi-process runtime's shapes (the reference's ``MESH_FNS`` and
# ``MESH_AGG_OPS``) and the value-wise instant functions it applies after
# the reduce
MESH_FNS = ("rate", "increase", "delta", "sum_over_time", "count_over_time",
            "avg_over_time", "min_over_time", "max_over_time",
            "last_over_time", "present_over_time", "stddev_over_time",
            "stdvar_over_time")
MESH_AGGS = ("sum", "avg", "count", "min", "max", "stddev", "stdvar",
             "group")
_POST_INSTANT_FNS = (
    "abs", "ceil", "floor", "exp", "ln", "log2", "log10", "sqrt", "round",
    "clamp", "clamp_min", "clamp_max", "sgn", "deg", "rad", "acos", "asin",
    "atan", "cos", "cosh", "sin", "sinh", "tan", "tanh",
)
_SCALAR_PLANS = (lp.ScalarFixedDoublePlan, lp.ScalarTimeBasedPlan,
                 lp.ScalarVaryingDoublePlan, lp.ScalarBinaryOperation)


@dataclass(frozen=True)
class Lowered:
    filters: tuple
    start: int
    step: int
    end: int
    window: int
    fn: str
    offset: int
    params: tuple = ()
    keep_metric: bool = False  # the instant selector keeps the metric
    at_ms: int | None = None   # @: every step evaluates at this time

    @property
    def signature(self) -> tuple:
        """What leaves that share a batch have in common: everything but
        the step grid (the step stays: only grids of one step share)."""
        return (str(self.filters), self.window, self.fn, self.offset,
                self.params, self.keep_metric, self.at_ms, self.step)

    @property
    def chunk_range(self) -> tuple[int, int]:
        lo, hi = (self.start, self.end) if self.at_ms is None \
            else (self.at_ms, self.at_ms)
        return lo - self.window - self.offset, hi - self.offset

    @property
    def mapper(self) -> PeriodicSamplesMapper:
        """The windowing stage that evaluates the leaf."""
        return PeriodicSamplesMapper(
            self.start, self.step, self.end, self.window,
            None if self.keep_metric else self.fn, self.params, self.offset,
            self.at_ms)


@dataclass(frozen=True)
class MeshLowered:
    """A plan in the multi-process runtime's shape (the reference's
    ``_Lowered``): a leaf (``filters`` … ``offset``), the aggregation over
    it (``agg``, ``by``, ``without``; ``agg`` None for none), whether the
    leaf's keys keep the metric, and the post-transforms applied after the
    reduce, innermost first: ``("instant", fn, args)``, ``("scalarop", op,
    scalar, scalar_is_lhs, bool_mode)``, ``("kagg", op, params, by,
    without)``."""

    filters: tuple
    start: int
    step: int
    end: int
    window: int
    fn: str
    offset: int
    agg: str | None
    by: tuple
    without: tuple
    keep_metric: bool
    post: tuple = ()

    @property
    def leaf(self) -> Lowered:
        """The leaf as this engine evaluates it."""
        return Lowered(tuple(self.filters), self.start, self.step, self.end,
                       self.window, self.fn, self.offset,
                       keep_metric=self.fn == "last_sample")


def _with_post(low: MeshLowered, op: tuple) -> MeshLowered:
    return replace(low, post=low.post + (op,))


def _shape(plan) -> str:
    name = type(plan).__name__
    detail = getattr(plan, "function", None) or getattr(plan, "op", None)
    return f"{name}({detail})" if detail else name


def _is_number(x) -> bool:
    return isinstance(x, (int, float))


def _raw_selector(plan) -> lp.RawSeries:
    raw = plan.raw
    if not isinstance(raw, lp.RawSeries):
        raise UnsupportedQuery(
            f"{_shape(plan)} over {_shape(raw)} is not served by the mesh "
            f"engine")
    if raw.column is not None:
        raise UnsupportedQuery(
            f"the column selector ::{raw.column} ({_shape(plan)} over "
            f"RawSeries) is not served by the mesh engine")
    return raw


def lower_plan(plan) -> Lowered:
    """Lower a leaf (a range function or an instant selector over a raw
    selector), or raise ``UnsupportedQuery``; ``execute`` evaluates what
    stands above the leaves."""
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        if SERVED_FNS.get(plan.function) != len(plan.params) \
                or not all(_is_number(p) for p in plan.params):
            raise UnsupportedQuery(
                f"range function {plan.function}"
                f"{tuple(plan.params) if plan.params else ''} is not "
                f"served by the mesh engine (served: {', '.join(SERVED_FNS)})")
        raw = _raw_selector(plan)
        # the parser records the selector offset on both nodes: one value
        return Lowered(tuple(raw.filters), plan.start, plan.step, plan.end,
                       plan.window, plan.function, plan.offset or raw.offset,
                       tuple(float(p) for p in plan.params),
                       at_ms=plan.at_ms)
    if isinstance(plan, lp.PeriodicSeries):
        raw = _raw_selector(plan)
        return Lowered(tuple(raw.filters), plan.start, plan.step, plan.end,
                       raw.lookback or STALENESS_MS, "last_sample",
                       plan.offset or raw.offset, keep_metric=True,
                       at_ms=plan.at_ms)
    raise UnsupportedQuery(
        f"plan shape {_shape(plan)} is not served by the mesh engine: it serves "
        f"range functions and instant selectors, the plans above them and "
        f"scalar plans")


class MeshQueryEngine:
    """Runs plans on one device. Its batches live in ``batches`` and its
    group ids in ``gids``, which a service shares with its exec engine."""

    def __init__(self, device: torch.device,
                 batches: BatchCache | None = None,
                 gids: GroupIdCache | None = None, sidecars: bool = False):
        self.device = device
        # the reference's sidecar delegation: grids of at most two steps
        # (rule ticks, alert probes, instant queries) over a function the
        # sidecar lane serves go to exec, whose leaves fold them from the
        # chunks' summaries; off for an engine built directly, on in
        # ``QueryService``
        self.sidecars = sidecars
        self.batches = batches if batches is not None else BatchCache(device)
        self.gids = gids if gids is not None else GroupIdCache()
        # (selector, data range) → 0 scalar series, 1 histograms, 2 both,
        # for the store (id, version) in ``_kinds_of``
        self._kinds: dict = {}
        self._kinds_of = None
        # while ``execute_many`` runs: leaf signature → (the group's shared
        # batch, its evaluations by grid, its batch key); None otherwise
        self._shared: dict | None = None
        # while ``execute_many`` checks its plans: the leaves ``_check``
        # lowers are appended here
        self._collect: list | None = None
        # the deadline of the query or batch running
        self._deadline = None

    # ---- what the engine serves, decided before anything runs ---------------

    def supports(self, memstore, plan) -> str | None:
        """None where this engine serves ``plan``, else why not. It is
        decided from the plan and the shards' indexes (which selectors
        match histograms) before any batch is built, as the reference's
        ``supports`` decides."""
        try:
            self._check(memstore, plan)
        except UnsupportedQuery as e:
            return str(e)
        return None

    def _kind(self, memstore, low: Lowered) -> bool:
        """Whether the leaf's selector matches histograms; raises where it
        matches both kinds."""
        if self._kinds_of != (id(memstore), memstore.version):
            self._kinds.clear()
            self._kinds_of = (id(memstore), memstore.version)
        lo_ms, hi_ms = low.chunk_range
        key = (str(low.filters), lo_ms, hi_ms)
        kind = self._kinds.get(key)
        if kind is None:
            # read ``hist`` after the lookup: an ingest the lookup waited
            # for may have grown it for the pids it returns
            pids = [shard.lookup_partitions(list(low.filters), lo_ms, hi_ms)
                    for shard in memstore.shards]
            hist = np.concatenate([shard.hist[p] for shard, p in
                                   zip(memstore.shards, pids)])
            kind = self._kinds[key] = 2 if hist.any() and not hist.all() \
                else int(hist.any())
        if kind == 2:
            raise UnsupportedQuery(MIXED_KINDS)
        return kind == 1

    def _check_scalar(self, memstore, plan) -> None:
        if isinstance(plan, lp.ScalarVaryingDoublePlan):
            if self._check(memstore, plan.vector):
                raise UnsupportedQuery("scalar() of a histogram is not "
                                       "served by the mesh engine")
        elif isinstance(plan, lp.ScalarBinaryOperation):
            for side in (plan.lhs, plan.rhs):
                if not _is_number(side):
                    self._check_scalar(memstore, side)

    def _not_histogram(self, memstore, plan, what: str) -> bool:
        if self._check(memstore, plan):
            raise UnsupportedQuery(f"{what} over a histogram is not served "
                                   f"by the mesh engine")
        return False

    def _check(self, memstore, plan) -> bool:
        """Raise ``UnsupportedQuery`` where this engine does not serve
        ``plan``; else whether its answer is a histogram matrix."""
        if isinstance(plan, lp.Aggregate):
            amr = self._aggregation(plan)
            if amr.op not in AGG_OPS:
                return self._not_histogram(memstore, plan.vector,
                                           f"aggregation {plan.op}")
            hist = self._check(memstore, plan.vector)
            if hist and amr.op != "sum" and self._collect is not None:
                raise UnsupportedQuery(
                    f"a histogram batch under {amr.op} goes to the exec "
                    f"engine, as the reference's batch declines it")
            return hist
        if isinstance(plan, lp.ApplyInstantFunction):
            if plan.function not in INSTANT_FNS + HIST_INSTANT_FNS \
                    or not all(_is_number(a) for a in plan.args):
                raise UnsupportedQuery(
                    f"instant function {plan.function} is not served by "
                    f"the mesh engine (served: "
                    f"{', '.join(INSTANT_FNS + HIST_INSTANT_FNS)}, with "
                    f"number arguments)")
            return self._check(memstore, plan.vector) \
                and plan.function not in HIST_INSTANT_FNS
        if isinstance(plan, lp.ScalarVectorBinaryOperation):
            if isinstance(plan.scalar, lp.ScalarFixedDoublePlan) \
                    or _is_number(plan.scalar):
                return self._check(memstore, plan.vector)
            self._check_scalar(memstore, plan.scalar)
            return self._not_histogram(memstore, plan.vector,
                                       f"operator {plan.op} with a "
                                       f"{_shape(plan.scalar)} scalar")
        if isinstance(plan, _SCALAR_PLANS):
            self._check_scalar(memstore, plan)
            return False
        if isinstance(plan, lp.VectorPlan):
            self._check_scalar(memstore, plan.scalar)
            return False
        if isinstance(plan, lp.ApplyAbsentFunction):
            return self._not_histogram(memstore, plan.vector, "absent")
        if isinstance(plan, lp.ApplySortFunction):
            return self._not_histogram(memstore, plan.vector, "sort")
        if isinstance(plan, (lp.ApplyMiscellaneousFunction,
                             lp.ApplyLimitFunction)):
            return self._check(memstore, plan.vector)
        if isinstance(plan, lp.SubqueryWithWindowing):
            _subquery_mapper(plan)._served("a subquery")
            return self._not_histogram(memstore, lp.subquery_inner(plan),
                                       "a subquery")
        if isinstance(plan, lp.TopLevelSubquery):
            return self._check(memstore, lp.retime(plan.inner, plan.start,
                                                   plan.step, plan.end))
        if isinstance(plan, lp.BinaryJoin):
            if self._check(memstore, plan.lhs) \
                    or self._check(memstore, plan.rhs):
                raise UnsupportedQuery(
                    f"operator {plan.op} with a histogram side is not served "
                    f"by the mesh engine")
            return False
        low = lower_plan(plan)
        if self.sidecars and (low.end - low.start) // max(low.step, 1) + 1 \
                <= 2 and sidecar_lane.covers_fn(low.fn):
            raise UnsupportedQuery(
                f"sidecar delegation: {low.fn} at "
                f"{(low.end - low.start) // max(low.step, 1) + 1} step(s) "
                f"goes to the exec engine's sidecar lane")
        hist = self._kind(memstore, low)
        if hist and low.fn not in HIST_FNS:
            raise UnsupportedQuery(
                f"range function {low.fn} over a histogram is not served by "
                f"the mesh engine (served: {', '.join(HIST_FNS)})")
        if self._collect is not None:
            self._collect.append(low)
        return hist

    # ---- the multi-process runtime's split ------------------------------------

    def _lower(self, plan) -> MeshLowered | None:
        """``plan`` as a ``MeshLowered``, or None where it is not of the
        runtime's shapes, or (with ``sidecars``) where its grid of at most
        two steps goes to the sidecar lane, as ``_check`` hands it on."""
        low = self._lower_plan(plan)
        if low is not None and self.sidecars \
                and (low.end - low.start) // max(low.step, 1) + 1 <= 2 \
                and sidecar_lane.covers_fn(low.fn):
            return None
        return low

    def _lower_plan(self, plan) -> MeshLowered | None:
        """The reference's recognition: wrappers peel off into
        post-transforms, then an aggregation, then the leaf."""
        if isinstance(plan, lp.ApplyInstantFunction) \
                and plan.function in _POST_INSTANT_FNS \
                and all(_is_number(a) for a in plan.args):
            inner = self._lower(plan.vector)
            return None if inner is None else _with_post(
                inner, ("instant", plan.function, tuple(plan.args)))
        if isinstance(plan, lp.ApplyInstantFunction) \
                and plan.function == "histogram_quantile":
            args = [a.value if isinstance(a, lp.ScalarFixedDoublePlan)
                    else a for a in plan.args]
            if len(args) != 1 or not _is_number(args[0]):
                return None
            inner = self._lower(plan.vector)
            return None if inner is None else _with_post(
                inner, ("instant", "histogram_quantile", (float(args[0]),)))
        if isinstance(plan, lp.ScalarVectorBinaryOperation):
            sc = plan.scalar
            if isinstance(sc, lp.ScalarFixedDoublePlan):
                sc = sc.value
            if not _is_number(sc):
                return None
            inner = self._lower(plan.vector)
            return None if inner is None else _with_post(
                inner, ("scalarop", plan.op, float(sc), plan.scalar_is_lhs,
                        plan.bool_mode))
        if isinstance(plan, lp.Aggregate) and plan.op in ("topk", "bottomk") \
                and len(plan.params) == 1:
            inner = self._lower(plan.vector)
            if inner is None or inner.post:
                return None
            return _with_post(inner, ("kagg", plan.op, tuple(plan.params),
                                      tuple(plan.by), tuple(plan.without)))
        if isinstance(plan, lp.Aggregate):
            if plan.op not in MESH_AGGS or plan.params:
                return None
            core = self._lower_periodic(plan.vector)
            if core is None or core.agg is not None:
                return None
            return replace(core, agg=plan.op, by=tuple(plan.by),
                           without=tuple(plan.without))
        return self._lower_periodic(plan)

    @staticmethod
    def _lower_periodic(plan) -> MeshLowered | None:
        if isinstance(plan, lp.PeriodicSeriesWithWindowing):
            if plan.function not in MESH_FNS or plan.params \
                    or plan.at_ms is not None:
                return None
            raw = plan.raw
            if not isinstance(raw, lp.RawSeries) or raw.column is not None:
                return None
            # the parser records the selector offset on both nodes: one value
            return MeshLowered(tuple(raw.filters), plan.start, plan.step,
                               plan.end, plan.window, plan.function,
                               plan.offset or raw.offset, None, (), (), False)
        if isinstance(plan, lp.PeriodicSeries):
            raw = plan.raw
            if plan.at_ms is not None or not isinstance(raw, lp.RawSeries) \
                    or raw.column is not None:
                return None
            return MeshLowered(tuple(raw.filters), plan.start, plan.step,
                               plan.end, raw.lookback or STALENESS_MS,
                               "last_sample", plan.offset or raw.offset,
                               None, (), (), True)
        return None

    def execute_lowered_many(self, lows: list, memstore,
                             stats: "QueryStats | list | None" = None
                             ) -> list:
        """Each ``MeshLowered`` evaluated: its leaf over every shard of
        ``memstore`` (a worker's is its shard slice), then ``reduce_rows``.
        None for one whose selector matches scalar series and histograms
        both. ``stats`` is one ``QueryStats`` or one a lowered plan."""
        if not isinstance(stats, list):
            stats = [stats if stats is not None else QueryStats()] \
                * len(lows)
        out = []
        for low, st in zip(lows, stats):
            leaf = low.leaf
            try:
                self._kind(memstore, leaf)
            except UnsupportedQuery:
                out.append(None)
                continue
            m = self._leaf(memstore, leaf, st)
            keys = self._batch(memstore, leaf).keys if m.num_series else []
            out.append(self.reduce_rows(low, keys, m.values, m.steps_ms,
                                        m.les))
        return out

    def reduce_rows(self, low: MeshLowered, keys: list, values, steps_ms,
                    les=None, dropped: list | None = None) -> StepMatrix:
        """What stands above ``low``'s leaf, over the leaf's rows (``keys``
        with the metric, ``values`` [P, K] or [P, K, B]): the metric
        dropped unless the leaf keeps it (``dropped``: the keys without it,
        where the caller has them), the aggregation, then the
        post-transforms, by the code ``_eval`` runs, on this engine's
        device. ``keys`` may be handed on as they are: no one changes
        them."""
        if not keys:
            return self._apply_post(StepMatrix.empty(steps_ms), low)
        v = torch.as_tensor(values).to(self.device)
        if not low.keep_metric:
            keys = dropped if dropped is not None \
                else [k.drop_metric() for k in keys]
        m = StepMatrix(keys, v, steps_ms, les=les)
        if low.agg is not None:
            amr = AggregateMapReduce(low.agg, (), tuple(low.by),
                                     tuple(low.without))
            m = amr.apply(m, self.gids.of(amr, m))
        return self._apply_post(m, low)

    @staticmethod
    def _apply_post(m: StepMatrix, low: MeshLowered) -> StepMatrix:
        """``low``'s post-transforms, innermost first."""
        for op in low.post:
            if op[0] == "instant":
                m = InstantVectorFunctionMapper(op[1], tuple(op[2])).apply(m)
            elif op[0] == "scalarop":
                m = ScalarOperationMapper(op[1], op[2], op[3],
                                          op[4]).apply(m)
            elif op[0] == "kagg":
                amr = AggregateMapReduce(op[1], tuple(op[2]), tuple(op[3]),
                                         tuple(op[4]))
                m = amr.apply(m.settle())
        return m

    # ---- leaves ---------------------------------------------------------------

    def _batch(self, memstore, low: Lowered) -> DeviceBatch:
        """The leaf's batch over every shard (``_batch_over``)."""
        return self._batch_over(memstore, low.filters, *low.chunk_range)

    @staticmethod
    def _batch_key(filters, lo_ms: int, hi_ms: int) -> tuple:
        return ("mesh", str(filters), lo_ms, hi_ms)

    def _batch_over(self, memstore, filters, lo_ms: int, hi_ms: int
                    ) -> DeviceBatch:
        """The batch of a selector over every shard and the data range
        [lo_ms, hi_ms], cached per (selector, data range) until the store
        ingests again."""
        key = self._batch_key(filters, lo_ms, hi_ms)
        batch = self.batches.get(key, memstore)
        if batch is None:
            # each shard's version before its lookup
            versions = [shard.version for shard in memstore.shards]
            selected = [(shard, shard.lookup_partitions(list(filters),
                                                        lo_ms, hi_ms))
                        for shard in memstore.shards]
            batch = build_device_batch(selected, lo_ms, hi_ms, self.device,
                                       versions=versions)
            self.batches.put(key, memstore, None, batch)
        return batch

    @property
    def batch_bytes(self) -> int:
        """Device bytes of the packed pages the engine holds."""
        return self.batches.nbytes("mesh")

    @property
    def window_cache(self) -> tuple[int, int]:
        """(entries, device bytes) of the window cache."""
        held = self.batches.batches("mesh-eval")
        return len(held), sum(e.nbytes for e in held)

    def _leaf(self, memstore, low: Lowered, stats: QueryStats) -> StepMatrix:
        """A leaf at its steps through its windowing stage, from the window
        cache where it holds it; in ``execute_many``, over its group's
        shared batch, once a grid."""
        check(self._deadline, "the mesh engine's leaf")
        shared = self._shared.get(low.signature) if self._shared else None
        if shared is None:
            bkey = self._batch_key(low.filters, *low.chunk_range)
            batch = self._batch(memstore, low)
        else:
            batch, _, bkey = shared
        stats.series_scanned += len(batch.keys)
        stats.samples_scanned += int(batch.counts.sum())
        if split_enabled() and low.fn in SPLIT_FNS:
            m = self._evaluated(memstore, bkey, batch, low, stats)
        elif shared is None:
            m = low.mapper.eval_batch(batch, stats)
        else:
            m = shared[1].get((low.start, low.end))
            if m is None:
                m = shared[1][(low.start, low.end)] = \
                    low.mapper.eval_batch(batch, stats)
        check(self._deadline, "the mesh engine's leaf")
        # a matrix of the leaf's own: what is above it settles in place
        return replace(m)

    def _evaluated(self, memstore, bkey: tuple, batch, low: Lowered,
                   stats: QueryStats) -> StepMatrix:
        """The leaf's evaluated windows through the window cache, keyed as
        the reference's ``_series_eval_cached``: the batch's key (and, by
        the cache's stamp, its version), the window, the step grid and the
        function (with its parameters, offset and ``@``)."""
        ekey = ("mesh-eval", bkey, low.window, low.start, low.step, low.end,
                low.fn, low.params, low.offset, low.at_ms, low.keep_metric)
        hit = self.batches.get(ekey, memstore)
        if hit is not None:
            _M_EVAL["hit"].inc()
            stats.merge_counts(hit.stats)
            return hit.matrix
        _M_EVAL["miss"].inc()
        counted = QueryStats()
        m = low.mapper.eval_batch(batch, counted)
        stats.merge_counts(counted)
        values = torch.as_tensor(m.values)
        self.batches.put(ekey, memstore, None, Evaluated(
            m, counted, values.numel() * values.element_size(),
            batch.version))
        return m

    def execute_many(self, memstore, plans: list,
                     stats_list: list[QueryStats], deadline=None) -> list:
        """Evaluate many plans with one batch a leaf signature: the leaves
        of every served plan are grouped by ``Lowered.signature`` (all but
        the step grid), each group's batch is selected, packed and
        uploaded once over the union of its members' data ranges, and each
        member's grid is evaluated over it, once for grids that are equal
        (the kernels take each grid as it is; grids are never joined).
        Returns, a plan, its matrix (values still on the card), None where
        the engine does not serve it (the caller runs it on exec, as for
        an ``UnsupportedQuery`` it raised while it ran), or the exception
        it raised."""
        out: list = [None] * len(plans)
        leaves: dict = {}  # served plan → its lowered leaves
        for i, plan in enumerate(plans):
            self._collect = []
            try:
                self._check(memstore, plan)
                leaves[i] = self._collect
            except UnsupportedQuery:
                pass
            finally:
                self._collect = None
        groups: dict = {}
        for lows in leaves.values():
            for low in lows:
                groups.setdefault(low.signature, []).append(low)
        self._shared, failed = {}, {}
        self._deadline = deadline
        try:
            for sig, lows in groups.items():
                try:
                    span = (lows[0].filters,
                            min(lo.chunk_range[0] for lo in lows),
                            max(lo.chunk_range[1] for lo in lows))
                    self._shared[sig] = (self._batch_over(memstore, *span),
                                         {}, self._batch_key(*span))
                except Exception as e:  # noqa: BLE001 - at each member
                    failed[sig] = e
            for i, lows in leaves.items():
                err = next((failed[low.signature] for low in lows
                            if low.signature in failed), None)
                try:
                    out[i] = err if err is not None \
                        else self._eval(memstore, plans[i], stats_list[i])
                except UnsupportedQuery:
                    out[i] = None
                except Exception as e:  # noqa: BLE001 - at its position
                    out[i] = e
        finally:
            self._shared = None
            self._deadline = None
        return out

    # ---- the plan above the leaves ------------------------------------------

    def _aggregation(self, plan: lp.Aggregate) -> AggregateMapReduce:
        params = tuple(plan.params)
        if not (plan.op in AGG_OPS and not params
                or plan.op in _RANK_AGGS and len(params) == 1
                and _is_number(params[0])
                or plan.op == "count_values" and len(params) == 1
                and isinstance(params[0], str)):
            raise UnsupportedQuery(
                f"aggregation {plan.op}"
                f"{'(' + ', '.join(map(str, params)) + ')' if params else ''}"
                f" is not served by the mesh engine (served: "
                f"{', '.join(AGG_OPS + _RANK_AGGS)}, the last three with a "
                f"number, and count_values with a label)")
        return AggregateMapReduce(plan.op, params, tuple(plan.by),
                                  tuple(plan.without))

    # ---- scalars and subqueries ----------------------------------------------

    def _scalar(self, memstore, plan, stats: QueryStats):
        """A scalar plan → (values float64 [K] on the device, steps_ms),
        as the reference's scalar execs compute them."""
        if isinstance(plan, lp.ScalarVaryingDoublePlan):
            data = self._eval(memstore, plan.vector, stats).settle()
            if data.num_series == 0:
                return torch.full((data.num_steps,), float("nan"),
                                  dtype=EXACT_DTYPE, device=self.device), \
                    data.steps_ms
            v = tensor_of(data, self.device)
            present = ~torch.isnan(v)
            one = torch.where(present, v, 0.0).sum(0)
            return torch.where(present.sum(0) == 1, one, float("nan")), \
                data.steps_ms
        steps = steps_array(plan.start, plan.step or 1000, plan.end)
        if isinstance(plan, lp.ScalarFixedDoublePlan):
            return torch.full((len(steps),), float(plan.value),
                              dtype=EXACT_DTYPE, device=self.device), steps
        if isinstance(plan, lp.ScalarTimeBasedPlan):
            if plan.function != "time":
                raise ValueError(f"unknown scalar generator {plan.function}")
            return torch.from_numpy(steps / 1000.0).to(self.device), steps

        def side(x):
            if _is_number(x):
                return torch.full((len(steps),), float(x), dtype=EXACT_DTYPE,
                                  device=self.device)
            return self._scalar(memstore, x, stats)[0]

        return apply_binary_op(plan.op, side(plan.lhs), side(plan.rhs)), steps

    def _subquery(self, memstore, plan: lp.SubqueryWithWindowing,
                  stats: QueryStats) -> StepMatrix:
        """A range function over a subquery: the inner plan over the window
        before the first step at the sub-step, then the function over the
        inner steps as samples."""
        inner = self._eval(memstore, lp.subquery_inner(plan), stats)
        return _subquery_mapper(plan).apply(inner)

    @staticmethod
    def _scalar_matrix(values: torch.Tensor, steps_ms) -> StepMatrix:
        """A scalar as the one-series, label-free matrix the reference's
        scalar execs answer."""
        return StepMatrix([RangeVectorKey(())], values[None, :], steps_ms)

    def execute(self, memstore, plan, stats: QueryStats,
                deadline=None) -> StepMatrix:
        """Evaluate ``plan``; where the engine does not serve it, raise
        ``UnsupportedQuery`` before anything runs (``supports``)."""
        self._check(memstore, plan)
        self._deadline = deadline
        try:
            return self._eval(memstore, plan, stats)
        finally:
            self._deadline = None

    def _eval(self, memstore, plan, stats: QueryStats) -> StepMatrix:
        """The one place that walks a plan tree, once ``_check`` passed."""
        if isinstance(plan, lp.Aggregate):
            amr = self._aggregation(plan)
            data = self._eval(memstore, plan.vector, stats).settle()
            return amr.apply(data, self.gids.of(amr, data))
        if isinstance(plan, lp.ApplyInstantFunction):
            return InstantVectorFunctionMapper(plan.function, tuple(
                plan.args)).apply(self._eval(memstore, plan.vector, stats))
        if isinstance(plan, lp.ScalarVectorBinaryOperation):
            data = self._eval(memstore, plan.vector, stats)
            if isinstance(plan.scalar, lp.ScalarFixedDoublePlan) \
                    or _is_number(plan.scalar):
                sc = float(getattr(plan.scalar, "value", plan.scalar))
            else:
                sc = self._scalar(memstore, plan.scalar, stats)[0]
            return ScalarOperationMapper(
                plan.op, sc, plan.scalar_is_lhs, plan.bool_mode).apply(data)
        if isinstance(plan, _SCALAR_PLANS):
            return self._scalar_matrix(*self._scalar(memstore, plan, stats))
        if isinstance(plan, lp.VectorPlan):
            return self._scalar_matrix(*self._scalar(memstore, plan.scalar,
                                                     stats))
        if isinstance(plan, lp.ApplyAbsentFunction):
            return AbsentFunctionMapper(
                plan.filters, plan.start, plan.step or 1000, plan.end,
                self.device).apply(self._eval(memstore, plan.vector, stats))
        if isinstance(plan, lp.ApplySortFunction):
            return SortFunctionMapper(plan.descending).apply(
                self._eval(memstore, plan.vector, stats))
        if isinstance(plan, lp.ApplyMiscellaneousFunction):
            return MiscellaneousFunctionMapper(plan.function, tuple(
                plan.args)).apply(self._eval(memstore, plan.vector, stats))
        if isinstance(plan, lp.ApplyLimitFunction):
            return LimitFunctionMapper(plan.limit).apply(
                self._eval(memstore, plan.vector, stats))
        if isinstance(plan, lp.SubqueryWithWindowing):
            return self._subquery(memstore, plan, stats)
        if isinstance(plan, lp.TopLevelSubquery):
            return self._eval(memstore, lp.retime(plan.inner, plan.start,
                                                  plan.step, plan.end), stats)
        if isinstance(plan, lp.BinaryJoin):
            lhs = self._eval(memstore, plan.lhs, stats)
            rhs = self._eval(memstore, plan.rhs, stats)
            if plan.op in SET_OPS:
                return set_operator(lhs, rhs, plan.op, plan.on,
                                    plan.ignoring)
            return binary_join(lhs, rhs, plan.op, plan.cardinality, plan.on,
                               plan.ignoring, plan.include, plan.bool_mode)
        return self._leaf(memstore, lower_plan(plan), stats)


def _subquery_mapper(plan: lp.SubqueryWithWindowing) -> PeriodicSamplesMapper:
    """The range function of a subquery, over the inner plan's steps."""
    return PeriodicSamplesMapper(plan.start, plan.step, plan.end,
                                 plan.subquery_window, plan.function,
                                 tuple(plan.params), plan.offset)
