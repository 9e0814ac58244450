"""The exec plan tree: a query as a tree of plans that each run on the card.

Port of ``filodb_tpu/query/exec/plan.py``: ``ExecPlan`` (``execute`` =
``do_execute``, then the plan's transformers in order), the leaf
``SelectRawPartitionsExec`` (one shard), ``EmptyResultExec``, the
gathering plans ``DistConcatExec``, ``ReduceAggregateExec`` and
``StitchRvsExec`` (scatter-gather below), and the scalar plans.
``coordinator/planner.py`` builds the tree; ``query/exec/binaryjoin.py``
adds the join plans.

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

A plan runs where its ``dispatcher`` sends it (the reference's
``filodb_tpu/query/exec/plan.py:48-66``): ``InProcessPlanDispatcher``
(the default, a bare tag on the wire) runs ``execute`` on the calling
thread against the caller's context; the framed transport's
``RemotePlanDispatcher`` (``coordinator/remote.py``) ships the subtree to
the node that owns its shard, and a cluster's ``NodeDispatcher``
(``coordinator/cluster.py``) runs it against another in-process node's
store. The planner sets dispatchers on leaves only.

Scatter-gather (``NonLeafExecPlan.gather_each``, the reference's
``:402-556``): children that leave the calling thread run at once on a
pool of the gather's own (a shared pool deadlocks nested gathers), the
in-process ones on the calling thread while those are in flight; each
child's answer is folded in child order, whatever the order they
complete in. A child lost to a transport fault (``TOLERABLE``) becomes
a partial answer, with a warning naming its shards, where the query's
``allow_partial`` (or the resilience config's) allows and at most
``partial_max_fraction`` of the children are lost; past it, the query
fails. A ``DeadlineExceeded`` is never partial, nor is any other error.
A remote child's stats, partial flag and warnings merge into the
context; an in-process child shares the context and merges nothing.

Where local and remote answers meet: ``execute`` returns a
``StepMatrix`` whose values live on the context's device (a torch
tensor, float64 once gathered; the windows the kernels give are float32
until ``StepMatrix.concat`` or an aggregation casts them), while a remote
child's ``dispatch`` returns a ``QueryResult`` whose values the wire
carried as host numpy float64. The gather moves each remote child's
values onto the context's device as float64 (``_on_device``) before they
reach the concat or the pushdown fold, so a root's reduce runs on its
own card over float64 rows, whichever node computed them.

``ReduceAggregateExec(pushdown=True)`` is the root of two-phase
aggregation: its children are leaves that end in an
``AggregatePartialMapper`` (one partial row a group, computed on the
child's card) and it folds their partials one child at a time
(``transformers.PartialAggregateFolder``), so the root holds a group's
rows, not a series'.
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
    PartialAggregateFolder,
    PeriodicSamplesMapper,
    RangeVectorTransformer,
    steps_array,
    tensor_of,
)
from filodb_tpu_torch.query.cost_model import CostModel
from filodb_tpu_torch.query.model import (
    QueryContext,
    QueryLimitExceeded,
    QueryResult,
    QueryStats,
    RangeVectorKey,
    StepMatrix,
)
from filodb_tpu_torch.utils.resilience import (
    DeadlineExceeded,
    FaultInjector,
    check,
    config,
)
from filodb_tpu_torch.utils.tracing import (
    activate,
    current_span,
    current_trace,
    span,
)


class PlanDispatcher:
    """Ships a plan to where its data lives (the reference's
    ``PlanDispatcher``): ``dispatch`` returns the plan's answer, a
    ``StepMatrix`` on the caller's device where it ran in this process,
    or a ``QueryResult`` where it ran elsewhere (its own stats, partial
    flag and warnings; values in host numpy)."""

    def dispatch(self, plan: "ExecPlan", ctx: "ExecContext"):
        raise NotImplementedError


class InProcessPlanDispatcher(PlanDispatcher):
    """Runs the plan here, against the caller's context (the reference's
    ``InProcessPlanDispatcher``). Stateless, so a bare tag on the wire; a
    dispatcher with state (``NodeDispatcher``) has no wire fields and
    fails at encode rather than losing them."""

    __wire_fields__ = ()

    def dispatch(self, plan, ctx):
        return plan.execute(ctx)


@dataclass
class ExecContext:
    """What a plan runs against: the store, the query's stats, the card,
    the leaves' batch cache and the aggregations' group-id cache (the
    service's, which the mesh engine shares), and the dataset's name and
    the ``QueryContext``, which ride to remote leaves with the plan."""

    memstore: object
    stats: QueryStats = field(default_factory=QueryStats)
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    batches: BatchCache | None = None
    gids: GroupIdCache = field(default_factory=GroupIdCache)
    # the query's deadline (``utils.resilience.Deadline``) and scan budget
    # (``utils.governor.QueryBudget``); None: none (the budget: the
    # query context's)
    deadline: object = None
    budget: object = None
    # a budget in ``degrade="partial"`` stopped the query, or a gather
    # lost children below its threshold
    partial: bool = False
    warnings: list[str] = field(default_factory=list)
    # the dataset (the cost model's key; "": the store's) and the query's
    # context
    dataset: str = ""
    qcontext: QueryContext = field(default_factory=QueryContext)

    def __post_init__(self):
        if self.batches is None:
            self.batches = BatchCache(self.device)
        if not self.dataset and self.memstore is not None:
            self.dataset = self.memstore.dataset
        if self.budget is None:
            self.budget = self.qcontext.planner_params.budget


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
    dispatcher: PlanDispatcher = field(
        default_factory=InProcessPlanDispatcher, kw_only=True)

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
class EmptyResultExec(ExecPlan):
    """No series, at the grid's steps (the reference's
    ``EmptyResultExec``)."""

    start: int = 0
    step: int = 1000
    end: int = 0

    def do_execute(self, ctx) -> StepMatrix:
        steps = steps_array(self.start, self.step, self.end)
        return StepMatrix([], np.zeros((0, len(steps))), steps)

    def __repr__(self):
        return "EmptyResultExec"


def plan_shards(plan: ExecPlan) -> list[int]:
    """Every shard a subtree reads, sorted: a partial answer's warning
    names the lost ones."""
    out = set()
    shard = getattr(plan, "shard", None)
    if shard is not None:
        out.add(shard)
    for c in plan.children():
        out.update(plan_shards(c))
    return sorted(out)


def _in_process(plan: ExecPlan) -> bool:
    return isinstance(plan.dispatcher, InProcessPlanDispatcher)


def _on_device(data: StepMatrix, device: torch.device) -> StepMatrix:
    """A remote answer's host values as float64 on ``device`` (see the
    module's text)."""
    if isinstance(data.values, np.ndarray):
        data.values = torch.from_numpy(
            np.ascontiguousarray(data.values, dtype=np.float64)).to(device)
    return data


def _merged(result, ctx: ExecContext) -> StepMatrix:
    """A child's answer as a matrix on ``ctx``'s device: a
    ``QueryResult`` (a child that ran elsewhere) merges its partial flag,
    new warnings and, where they are its own, its stats into ``ctx``."""
    if not isinstance(result, QueryResult):
        return result
    if result.partial:
        ctx.partial = True
        ctx.warnings.extend(w for w in result.warnings
                            if w not in ctx.warnings)
    if result.stats is not None and result.stats is not ctx.stats:
        ctx.stats.merge_counts(result.stats)
    return _on_device(result.result, ctx.device)


def run_plan(plan: ExecPlan, ctx: ExecContext) -> StepMatrix:
    """``plan``'s answer through its dispatcher, on ``ctx``'s device (a
    root or a join's side that is itself a leaf shipped elsewhere)."""
    if _in_process(plan):
        return plan.execute(ctx)
    return _merged(plan.dispatcher.dispatch(plan, ctx), ctx)


@dataclass
class NonLeafExecPlan(ExecPlan):
    children_plans: list[ExecPlan] = field(default_factory=list)

    def children(self):
        return self.children_plans

    # child losses a gather tolerates as a partial answer: a transport's
    # (a dead peer, a reset connection, an open breaker, a socket
    # timeout); a remote error, a limit or a kernel library that does not
    # load (``_build`` raises RuntimeError for it) still fails the query
    TOLERABLE = (ConnectionError, OSError, TimeoutError)

    def gather(self, ctx: ExecContext) -> list[StepMatrix]:
        """The children's answers in child order (see ``gather_each``)."""
        mats: list[StepMatrix] = []
        self.gather_each(ctx, mats.append)
        return mats

    def gather_each(self, ctx: ExecContext, fold) -> None:
        """Run the children and hand each answer, on ``ctx``'s device, to
        ``fold`` in child order (see the module's text)."""
        children = self.children_plans
        check(ctx.deadline, type(self).__name__ + ".gather")
        rc = config()
        pp = ctx.qcontext.planner_params
        allow_partial = rc.allow_partial if pp.allow_partial is None \
            else pp.allow_partial
        max_frac = rc.partial_max_fraction \
            if pp.max_partial_fraction is None else pp.max_partial_fraction
        failures: list[tuple[int, list[int], Exception]] = []
        # pool threads adopt the caller's trace under its open span
        trace, parent_span = current_trace(), current_span()

        def run(i, c):
            FaultInjector.fire("gather.child", index=i,
                               shards=plan_shards(c), plan=c)
            if _in_process(c):
                return c.execute(ctx)
            if trace is not None:
                with activate(trace, parent_span):
                    return c.dispatcher.dispatch(c, ctx)
            return c.dispatcher.dispatch(c, ctx)

        def settle(i, ok, payload):
            if ok:
                fold(_merged(payload, ctx))
                return
            err = payload
            if isinstance(err, DeadlineExceeded) or not allow_partial \
                    or not isinstance(err, self.TOLERABLE):
                raise err
            failures.append((i, plan_shards(children[i]), err))

        pending: dict[int, tuple[bool, object]] = {}
        next_i = 0

        def offer(i, ok, payload):
            nonlocal next_i
            pending[i] = (ok, payload)
            while next_i in pending:
                settle(next_i, *pending.pop(next_i))
                next_i += 1

        def attempt(i, c):
            try:
                return True, run(i, c)
            except Exception as e:  # noqa: BLE001 - sorted in settle
                return False, e

        remote = [i for i, c in enumerate(children) if not _in_process(c)]
        if remote and len(children) > 1:
            from concurrent.futures import ThreadPoolExecutor, as_completed

            # a pool of this gather's own: a shared bounded pool deadlocks
            # nested gathers; the in-process children run here meanwhile,
            # as they share ``ctx``
            with ThreadPoolExecutor(max_workers=min(len(remote), 16),
                                    thread_name_prefix="gather") as ex:
                futs = {ex.submit(attempt, i, children[i]): i
                        for i in remote}
                for i, c in enumerate(children):
                    if _in_process(c):
                        offer(i, *attempt(i, c))
                for f in as_completed(futs):
                    offer(futs[f], *f.result())
        else:
            for i, c in enumerate(children):
                offer(i, *attempt(i, c))

        if failures:
            if len(failures) / len(children) > max_frac:
                lost = sorted({s for _, shards, _ in failures
                               for s in shards})
                raise failures[0][2].__class__(
                    f"{len(failures)}/{len(children)} scatter-gather "
                    f"children failed (> partial threshold {max_frac}); "
                    f"lost shards {lost}: {failures[0][2]}")
            ctx.partial = True
            for i, shards, err in failures:
                ctx.warnings.append(
                    f"partial result: child {i} "
                    f"(shards {shards or 'n/a'}) lost: "
                    f"{type(err).__name__}: {err}")


@dataclass
class DistConcatExec(NonLeafExecPlan):
    """The children's series, concatenated."""

    def do_execute(self, ctx) -> StepMatrix:
        return StepMatrix.concat(self.gather(ctx))

    def __repr__(self):
        return f"DistConcatExec({len(self.children_plans)} children)"


@dataclass
class ReduceAggregateExec(NonLeafExecPlan):
    """The aggregation at the root. Single-phase (``pushdown`` False):
    over the children's series, gathered. Two-phase: the children end in
    an ``AggregatePartialMapper`` and ship one partial row a group, which
    this plan folds one child at a time, then finalizes (avg, stddev and
    stdvar from their components)."""

    op: str = "sum"
    params: tuple = ()
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()
    pushdown: bool = False

    def do_execute(self, ctx) -> StepMatrix:
        if self.pushdown:
            folder = PartialAggregateFolder(self.op, self.params, self.by,
                                            self.without)
            self.gather_each(ctx, folder.fold)
            with span("reduce", op=self.op), \
                    ctx.stats.timed("reduce_s", ctx.device):
                return folder.finalize()
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
        pd = ", pushdown" if self.pushdown else ""
        return (f"ReduceAggregateExec(op={self.op}, by={self.by}, "
                f"without={self.without}{pd}, "
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
        data = run_plan(self.inner, ctx).settle()
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

