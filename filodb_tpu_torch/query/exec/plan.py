"""The exec plan tree: a query as a tree of plans that each run on the card.

Port of ``filodb_tpu/query/exec/plan.py``, trimmed to an in-process
engine on one card: ``ExecPlan`` (``execute`` = ``do_execute``, then the
plan's transformers in order), the leaf ``SelectRawPartitionsExec`` (one
shard), the gathering plans ``DistConcatExec``, ``ReduceAggregateExec``
and ``StitchRvsExec`` (children run one after another on the calling
thread, as the reference runs in-process children), and the scalar
plans. ``coordinator/planner.py`` builds the
tree; ``query/exec/binaryjoin.py`` adds the join plans.

A leaf selects its shard's partitions, groups them by schema (each schema
its own batch, as the reference's ``SelectRawPartitionsExec`` does), and
runs its first transformer, the ``PeriodicSamplesMapper``, on each batch
of packed pages (``device_batch.build_device_batch``); the matrices are
concatenated and the other transformers applied. Batches are cached per
shard, keyed as the reference keys them (schema, filters, data range,
column, partitions) and by the shard's dataset (a leaf may read a
downsample or cold tier's store, ``store``), until that shard ingests
again, in the service's ``BatchCache`` beside the mesh engine's.

A leaf first tries the sidecar lane (``query/engine/sidecar_lane.py``),
which folds its windows from the chunks' summaries, as the reference's
leaf does; on a bypass it builds its batches. A batch is the page lane's
packed pages, or, where the selected values float32 does not hold, the
host-decode lane's float64 samples (the gate in
``device_batch.build_device_batch``); ``samples_scanned`` counts the
batch's samples as that lane counts them (the page lane every row of the
selected blocks, the host-decode lane the in-range non-NaN samples, as
the reference's two lanes count).

A query's ``ExecContext`` carries its deadline and its budget
(``utils.governor.QueryBudget``). A leaf and a gather check the deadline
where they start and a leaf again where it ends; a leaf stops at the
samples budget, ``ReduceAggregateExec`` at the group-cardinality budget
(a breach in ``degrade="partial"`` flags the context partial with the
budget's warning; in ``"error"`` it raises). Spans wrap the reference's
stages: ``scan`` (the sidecar attempt and the batches), ``decode`` (a
batch built), ``reduce`` (the windowing and the leaf's other
transformers, and the root's aggregation). After its sidecar attempt a
leaf settles the cost model's deferred ``sidecar`` decisions with its
whole evaluation's wall time, the card synchronized first.

Left out, with the reason in ``ROADMAP.md``: the plan dispatchers, remote
dispatch and partial scatter-gather (a plan runs where it is,
``execute``), and two-phase aggregation pushdown.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from filodb_tpu_torch.device import EXACT_DTYPE
from filodb_tpu_torch.query.engine import sidecar_lane
from filodb_tpu_torch.query.engine.device_batch import (
    BatchCache,
    build_device_batch,
)
from filodb_tpu_torch.query.engine.instantfns import apply_binary_op
from filodb_tpu_torch.query.exec.transformers import (
    AggregateMapReduce,
    GroupIdCache,
    PeriodicSamplesMapper,
    RangeVectorTransformer,
    steps_array,
    tensor_of,
)
from filodb_tpu_torch.query.cost_model import CostModel
from filodb_tpu_torch.query.model import (
    QueryLimitExceeded,
    QueryStats,
    RangeVectorKey,
    StepMatrix,
)
from filodb_tpu_torch.utils.resilience import check
from filodb_tpu_torch.utils.tracing import span


class PlanDispatcher:
    """Ships a plan to where its data lives (the reference's
    ``PlanDispatcher``). The framed transport's client
    (``coordinator/remote.py``) and the mesh worker client derive from it,
    which registers them on the plan wire; shipping exec plans themselves
    comes with remote plan dispatch (ROADMAP A7)."""

    def dispatch(self, plan: "ExecPlan", ctx: "ExecContext"):
        raise NotImplementedError


@dataclass
class ExecContext:
    """What a plan runs against: the store, the query's stats, the card,
    the leaves' batch cache and the aggregations' group-id cache (the
    service's, which the mesh engine shares)."""

    memstore: object
    stats: QueryStats = field(default_factory=QueryStats)
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    batches: BatchCache | None = None
    gids: GroupIdCache = field(default_factory=GroupIdCache)
    # the query's deadline (``utils.resilience.Deadline``) and scan budget
    # (``utils.governor.QueryBudget``); None: none
    deadline: object = None
    budget: object = None
    # a budget in ``degrade="partial"`` stopped the query
    partial: bool = False
    warnings: list[str] = field(default_factory=list)

    def __post_init__(self):
        if self.batches is None:
            self.batches = BatchCache(self.device)

    @property
    def dataset(self) -> str:
        """The cost model's key."""
        return self.memstore.dataset


def apply_result_budget(data: StepMatrix, ctx) -> StepMatrix:
    """The result-bytes budget over a materialized answer: in
    ``degrade="partial"`` the rows that fit (the breach flagged on
    ``ctx``); ``"error"`` raises from the check."""
    budget = getattr(ctx, "budget", None)
    if budget is None or not isinstance(data.values, np.ndarray) \
            or data.num_series == 0:
        return data
    nbytes = int(data.values.nbytes)
    if not budget.check_result_bytes(ctx, nbytes):
        return data
    per_row = max(1, nbytes // data.num_series)
    keep = max(1, int(budget.max_result_bytes) // per_row)
    if keep >= data.num_series:
        return data
    return StepMatrix(list(data.keys[:keep]), data.values[:keep],
                      data.steps_ms, les=data.les)


@dataclass
class ExecPlan:
    """A node of the physical plan tree."""

    transformers: list[RangeVectorTransformer] = field(default_factory=list,
                                                      kw_only=True)

    def execute(self, ctx: ExecContext) -> StepMatrix:
        data = self.do_execute(ctx)
        for t in self.transformers:
            data = _applied(t, data, ctx)
        return data

    def do_execute(self, ctx: ExecContext) -> StepMatrix:
        raise NotImplementedError

    def add_transformer(self, t: RangeVectorTransformer) -> "ExecPlan":
        self.transformers.append(t)
        return self

    def children(self) -> list["ExecPlan"]:
        return []

    def tree_str(self, indent: int = 0) -> str:
        lines = [" " * indent + repr(self)]
        for t in self.transformers:
            lines.append(" " * (indent + 2) + f"~> {type(t).__name__}")
        for c in self.children():
            lines.append(c.tree_str(indent + 2))
        return "\n".join(lines)


def _applied(t: RangeVectorTransformer, data: StepMatrix,
             ctx: ExecContext) -> StepMatrix:
    if hasattr(t, "bind"):
        t.bind(ctx)
    return t.apply(data)


def leaves(plan: ExecPlan) -> list["SelectRawPartitionsExec"]:
    """The leaves of a plan tree, left to right."""
    if isinstance(plan, SelectRawPartitionsExec):
        return [plan]
    out = []
    for c in plan.children():
        out.extend(leaves(c))
    return out


# ---------------------------------------------------------------------------
# leaves


@dataclass
class SelectRawPartitionsExec(ExecPlan):
    """Leaf: one shard's partitions that match ``filters`` over
    [chunk_start, chunk_end] (the lookback already included), evaluated by
    the first transformer, a ``PeriodicSamplesMapper``."""

    shard: int = 0
    filters: tuple = ()
    chunk_start: int = 0
    chunk_end: int = 0
    value_column: str | None = None
    # the store the leaf reads (a downsample or cold tier's, or a streaming
    # ds dataset's), and its dataset's name; None: the context's memstore
    store: object = None
    dataset_name: str | None = None

    def execute(self, ctx: ExecContext) -> StepMatrix:
        check(ctx.deadline, "SelectRawPartitionsExec")
        t0 = time.perf_counter()
        data = self._execute(ctx)
        if getattr(ctx, "_cost_decisions", None):
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            CostModel.settle_deferred(ctx, time.perf_counter() - t0)
        check(ctx.deadline, "SelectRawPartitionsExec")
        return data

    def _execute(self, ctx: ExecContext) -> StepMatrix:
        # a shard with no matching partition answers the empty matrix
        # without running the transformers, as the reference's leaf does
        shard = (ctx.memstore if self.store is None
                 else self.store).shards[self.shard]
        version = shard.version  # before the lookup its batches cover
        pids = shard.lookup_partitions(list(self.filters), self.chunk_start,
                                       self.chunk_end)
        limit = shard.config.max_query_matches
        if limit and len(pids) > limit:
            # the reference's query-size guardrail
            raise QueryLimitExceeded(
                f"query matches {len(pids)} series on shard {self.shard} > "
                f"limit {limit}")
        ctx.stats.series_scanned += len(pids)
        psm, rest = self.transformers[0], self.transformers[1:]
        with span("scan", shard=self.shard):
            data = sidecar_lane.try_execute(self, ctx, shard, pids, version)
            batches = None if data is not None \
                else self._scan_batches(ctx, shard, pids, version, psm)
        if data is None and batches is None:
            return StepMatrix.empty()
        with span("reduce"), ctx.stats.timed("reduce_s", ctx.device):
            if data is None:
                data = StepMatrix.concat([psm.eval_batch(b, ctx.stats)
                                          for b in batches])
            for t in rest:
                data = _applied(t, data, ctx)
        return data

    def _scan_batches(self, ctx, shard, pids, version, psm) -> list | None:
        """The leaf's batches, a schema each (None: no partition); stops
        at the samples budget, which counts this leaf's samples."""
        if not len(pids):
            return None
        if not isinstance(psm, PeriodicSamplesMapper):
            raise ValueError("a leaf's transformers start with "
                             "PeriodicSamplesMapper")
        batches, scanned = [], 0
        for s, spids in _by_schema(shard, pids):
            key = ("exec", shard.dataset, self.shard, s, str(self.filters),
                   self.chunk_start, self.chunk_end, self.value_column)
            batch = ctx.batches.get(key, shard, spids)
            if batch is None:
                with span("decode", schema=s, partitions=len(spids)), \
                        ctx.stats.timed("decode_s", ctx.device):
                    batch = build_device_batch(
                        [(shard, spids)], self.chunk_start, self.chunk_end,
                        ctx.device, self.value_column, [version])
                ctx.batches.put(key, shard, spids, batch)
                version = batch.version  # this build's page-ins included
            n = int(batch.counts.sum())
            ctx.stats.samples_scanned += n
            scanned += n
            batches.append(batch)
            if ctx.budget is not None \
                    and ctx.budget.check_samples(ctx, scanned):
                break
        return batches

    def __repr__(self):
        f = ",".join(str(x) for x in self.filters)
        return (f"SelectRawPartitionsExec(shard={self.shard}, filters=[{f}], "
                f"range=[{self.chunk_start},{self.chunk_end}])")


def _cardinality_budget(ctx, data: StepMatrix, groups):
    """The group-cardinality budget, checked before the aggregation runs:
    in ``degrade="partial"`` the series of the first ``limit`` groups and
    those groups (``"error"`` raises from the check)."""
    gids, out_keys = groups
    budget = ctx.budget
    if budget is None or not budget.check_cardinality(ctx, len(out_keys)):
        return data, groups
    limit = int(budget.max_group_cardinality)
    g = torch.as_tensor(gids)  # on the values' device (``GroupIdCache``)
    idx = (g < limit).nonzero().squeeze(1)
    return StepMatrix([data.keys[i] for i in idx.tolist()],
                      torch.as_tensor(data.values)[idx], data.steps_ms,
                      les=data.les), (g[idx], out_keys[:limit])


def _by_schema(shard, pids: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """(schema index, its partitions) in order of each schema's first
    partition, as the reference's leaf groups them."""
    sid = shard.schema_of[pids]
    if (sid == sid[0]).all():
        return [(int(sid[0]), pids)]
    uniq, first = np.unique(sid, return_index=True)
    return [(int(s), pids[sid == s]) for s in uniq[np.argsort(first)]]


# ---------------------------------------------------------------------------
# gathering plans


@dataclass
class NonLeafExecPlan(ExecPlan):
    children_plans: list[ExecPlan] = field(default_factory=list)

    def children(self):
        return self.children_plans

    def gather(self, ctx: ExecContext) -> list[StepMatrix]:
        """The children's answers in child order, run one after another on
        the calling thread (they share ``ctx``, as the reference's
        in-process children do)."""
        check(ctx.deadline, type(self).__name__ + ".gather")
        return [c.execute(ctx) for c in self.children_plans]


@dataclass
class DistConcatExec(NonLeafExecPlan):
    """The children's series, concatenated."""

    def do_execute(self, ctx) -> StepMatrix:
        return StepMatrix.concat(self.gather(ctx))

    def __repr__(self):
        return f"DistConcatExec({len(self.children_plans)} children)"


@dataclass
class ReduceAggregateExec(NonLeafExecPlan):
    """The aggregation over the children's series, at the root (the
    reference's single-phase form; two-phase pushdown is left out)."""

    op: str = "sum"
    params: tuple = ()
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()

    def do_execute(self, ctx) -> StepMatrix:
        data = StepMatrix.concat(self.gather(ctx)).settle()
        amr = AggregateMapReduce(self.op, self.params, self.by, self.without)
        if data.num_series == 0:
            return data
        with span("reduce", op=self.op), \
                ctx.stats.timed("reduce_s", ctx.device):
            data, groups = _cardinality_budget(ctx, data,
                                               ctx.gids.of(amr, data))
            return amr.apply(data, groups)

    def __repr__(self):
        return (f"ReduceAggregateExec(op={self.op}, by={self.by}, "
                f"without={self.without}, "
                f"{len(self.children_plans)} children)")


@dataclass
class StitchRvsExec(NonLeafExecPlan):
    """Children evaluated over adjacent time ranges, stitched on the card:
    a series' value at a step comes from the first child that has one."""

    def do_execute(self, ctx) -> StepMatrix:
        mats = [m.settle() for m in self.gather(ctx) if m.num_steps > 0]
        if not mats:
            return StepMatrix.empty()
        mats.sort(key=lambda m: int(m.steps_ms[0]))
        rows: dict[RangeVectorKey, int] = {}
        for m in mats:
            for k in m.keys:
                rows.setdefault(k, len(rows))
        steps = np.unique(np.concatenate([m.steps_ms for m in mats]))
        les = next((m.les for m in mats if m.les is not None), None)
        shape = (len(rows), len(steps)) if les is None \
            else (len(rows), len(steps), mats[0].values.shape[2])
        out = torch.full(shape, float("nan"), dtype=EXACT_DTYPE,
                         device=ctx.device)
        for m in mats:
            if not m.num_series:
                continue
            r = torch.tensor([rows[k] for k in m.keys], device=ctx.device)
            c = torch.from_numpy(np.searchsorted(steps, m.steps_ms)).to(
                ctx.device)
            cur = out[r[:, None], c[None, :]]
            new = tensor_of(m, ctx.device)
            out[r[:, None], c[None, :]] = torch.where(
                torch.isnan(cur) & ~torch.isnan(new), new, cur)
        return StepMatrix(list(rows), out, steps.astype(np.int64), les=les)

    def __repr__(self):
        return f"StitchRvsExec({len(self.children_plans)} children)"


# ---------------------------------------------------------------------------
# scalar plans: ``execute_scalar`` → (values [K] on the card, steps_ms)


class _ScalarExec(ExecPlan):
    """A plan whose answer is a scalar a step: as a matrix, one label-free
    series."""

    def execute_scalar(self, ctx) -> tuple[torch.Tensor, np.ndarray]:
        raise NotImplementedError

    def do_execute(self, ctx) -> StepMatrix:
        values, steps = self.execute_scalar(ctx)
        return StepMatrix([RangeVectorKey(())], values[None], steps)


def _full(steps: np.ndarray, value: float, ctx) -> torch.Tensor:
    return torch.full((len(steps),), float(value), dtype=EXACT_DTYPE,
                      device=ctx.device)


@dataclass
class ScalarFixedDoubleExec(_ScalarExec):
    value: float = 0.0
    start: int = 0
    step: int = 1000
    end: int = 0

    def execute_scalar(self, ctx):
        steps = steps_array(self.start, self.step, self.end)
        return _full(steps, self.value, ctx), steps

    def __repr__(self):
        return f"ScalarFixedDoubleExec({self.value})"


@dataclass
class TimeScalarGeneratorExec(_ScalarExec):
    function: str = "time"
    start: int = 0
    step: int = 1000
    end: int = 0

    def execute_scalar(self, ctx):
        steps = steps_array(self.start, self.step, self.end)
        if self.function != "time":
            raise ValueError(f"unknown scalar generator {self.function}")
        return torch.from_numpy(steps / 1000.0).to(ctx.device), steps

    def __repr__(self):
        return f"TimeScalarGeneratorExec({self.function})"


@dataclass
class ScalarVaryingExec(_ScalarExec):
    """scalar(v): a step's value where exactly one series has one, else
    NaN. Over a histogram the scalar is per bucket, [K, B], as the
    reference computes it."""

    inner: ExecPlan | None = None
    start: int = 0
    step: int = 1000
    end: int = 0

    def execute_scalar(self, ctx):
        data = self.inner.execute(ctx).settle()
        if data.num_series == 0:
            steps = data.steps_ms if data.num_steps \
                else steps_array(self.start, self.step, self.end)
            return _full(steps, float("nan"), ctx), steps
        v = tensor_of(data, ctx.device)
        present = ~torch.isnan(v)
        one = torch.where(present, v, 0.0).sum(0)
        return torch.where(present.sum(0) == 1, one, float("nan")), \
            data.steps_ms

    def __repr__(self):
        return "ScalarVaryingExec"


@dataclass
class ScalarBinaryOperationExec(_ScalarExec):
    """scalar OP scalar, the sides numbers or scalar plans."""

    op: str = "+"
    lhs: object = 0.0
    rhs: object = 0.0
    start: int = 0
    step: int = 1000
    end: int = 0

    def execute_scalar(self, ctx):
        steps = steps_array(self.start, self.step, self.end)

        def side(x):
            if isinstance(x, (int, float)):
                return _full(steps, x, ctx)
            return x.execute_scalar(ctx)[0]

        return apply_binary_op(self.op, side(self.lhs), side(self.rhs)), steps

    def __repr__(self):
        return f"ScalarBinaryOperationExec({self.op})"


@dataclass
class VectorFromScalarExec(ExecPlan):
    """vector(s): the scalar as one label-free series."""

    inner: ExecPlan | None = None

    def do_execute(self, ctx) -> StepMatrix:
        values, steps = self.inner.execute_scalar(ctx)
        return StepMatrix([RangeVectorKey(())], values[None], steps)

    def __repr__(self):
        return "VectorFromScalarExec"

