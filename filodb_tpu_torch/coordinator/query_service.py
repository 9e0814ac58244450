"""Query facade: PromQL text → ``QueryResult`` on the card.

Port of the query and metadata paths of
``filodb_tpu/coordinator/query_service.py``: ``query_range`` and
``query_instant`` (steps ``(t, 0, t)``) parse (``_parse_cached``, a memo of
256 plans), run on an engine and materialize; ``label_names``,
``label_values`` and ``series`` answer from the shards' part-key indexes,
and ``chunk_infos`` from their chunk tables, on the host. A range answer's
``StepMatrix`` renders with ``http.promjson.matrix_json``, an instant one
with ``vector_json`` or, for a scalar expression, ``scalar_json``. A query
may carry a ``QueryContext``: its ``PlannerParams.spread`` overrides the
planner's spread (per shard key in ``planner.spread_overrides``) for the
exec engine, its ``sample_limit`` (1,000,000 by default, as the
reference's) bounds the answer's samples and its ``budget`` its scan.

``engine`` picks the engine, as the reference's does:

- ``"mesh"`` (the default, as ``standalone`` boots the reference): the
  one-card split pipeline (``parallel/mesh_engine.py``); a plan that it
  does not ``supports`` runs through the planner and the exec engine
  instead, decided before either runs, as the reference falls back for
  the plans its mesh engine does not support. An ``UnsupportedQuery``
  that the mesh engine raises while it runs routes too, as a backstop;
  any other exception reaches the caller;
- ``"adaptive"``: the mesh engine's plans on the card or on a host lane,
  cost-routed by batch size (``parallel/adaptive.py``); the rest as mesh;
- ``"exec"``: ``SingleClusterPlanner`` materializes the exec plan tree
  (``query/exec/plan.py``), a leaf a shard.

The service's mesh engine delegates, as the reference's production
service does: a grid of at most two steps over a function the sidecar
lane serves goes to exec, whose leaves fold it from the chunks' summaries
(``query/engine/sidecar_lane.py``).

The control plane, as the reference's (``utils/governor.py``,
``utils/resilience.py``, ``coordinator/adaptive_planner.py``,
``utils/tracing.py``): a query takes the governor's default budget unless
it brings one, a deadline ``query_timeout_s`` away (the resilience
config's unless given), and a cost class: RULES for ``origin ==
"rules"``, else the cost model's ``admit`` class over the static one
(CHEAP for one step, EXPENSIVE for a range). It is admitted
(``governor().admit``, tenant from its selectors' ``_ws_``/``_ns_``)
before it takes the service's lock, so a queued query holds nothing;
``stats.admission_wait_s`` records the wait. Once answered, its deferred
cost decisions settle with its wall time, the device→host copy included.
``query_range`` traces (``traced_query``: head sampling, the slow-query
ring) with the reference's spans: ``parse``, ``mesh-execute``,
``plan-materialize``, ``exec-dispatch``, ``cache``. An answer over its
result-bytes budget keeps the rows that fit in ``degrade="partial"``,
flagged ``partial`` with a warning.

Where a node boots mesh workers (``mesh_workers``), ``mesh_cluster``
holds the multi-process runtime (``coordinator/mesh_cluster.py``): a plan
that reads the memstore only tries it first, inside its one admission,
and falls through to the engines here where it answers None; a worker's
shed propagates as ``QueryRejected``. Its answers carry ``stats.engine ==
"mesh-proc"``.

``result_cache`` (off by default, as the reference's dataclass has it; a
node turns it on from its config) puts the extent result cache
(``query/result_cache.py``) in front of every engine: ``execute_logical``
answers from it where it does not bypass the plan, and it evaluates each
missing extents through ``_execute_many_uncached``.

``query_range_many`` answers many range queries at once, as the
reference's, under one EXPENSIVE admission slot: each is parsed, then
looked up in the extent cache; the rest go to the mesh engine's
``execute_many`` (one shared batch a leaf signature) and those it does
not serve to exec; the answers still on the card come to the host in one
copy a shape group; limits and stats are applied after, and members of a
slow batch land in the slow-query ring. Only ``UnsupportedQuery`` routes
a query to exec: any other exception reaches the caller or, with
``return_errors``, stands at its query's position (the reference sends
every member to exec when its batch raises, which would hide a kernel
that failed; ROADMAP §C). ``QueryBatcher`` coalesces the queries of
concurrent threads into such batches (the threaded HTTP front end).

A cluster's service (``FilodbCluster.query_service``) plans leaves
whose shards other nodes own: its planner's ``dispatcher_for_shard``
ships them there (``coordinator/remote.py``) and the root gathers them
(partial answers flagged with their warnings, ``filodb_partial_results``
counting them). The mesh engines read this process's store alone, so
they serve only while ``shards_local`` holds (every shard of the dataset
is this node's); otherwise a plan goes to exec and
``filodb_mesh_fallback{reason="shards"}`` counts it. The extent cache
and the node's response cache are stamped with this store's version,
which remote ingest never moves: both are bypassed while shards are
remote, as the reference bypasses them.

``QueryStats.engine`` records which engine answered and
``QueryStats.fallback`` why mesh handed the plan on. Both engines keep
their uploaded batches (and mesh its evaluated windows) in one
``BatchCache``, under one budget of device memory, and their group ids in
one ``GroupIdCache``.

Threads share a service (the HTTP front ends, a node's callers): its
queries run one at a time under ``lock`` (re-entrant; the engines' caches
are not shared between two queries in flight; a batch takes it once),
while the shards' locks let ingest and flushes go on between a query's
selections. The metadata calls take only the shards' locks.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time

import torch

from filodb_tpu_torch.coordinator import adaptive_planner
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.core.filters import Equals
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.device import resolve
from filodb_tpu_torch.parallel.adaptive import AdaptiveQueryEngine
from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.engine.device_batch import BatchCache
from filodb_tpu_torch.query.exec.plan import (
    ExecContext,
    apply_result_budget,
    run_plan,
)
from filodb_tpu_torch.query.exec.transformers import GroupIdCache
from filodb_tpu_torch.query.model import (
    QueryContext,
    QueryResult,
    QueryStats,
    UnsupportedQuery,
    enforce_limits,
)
from filodb_tpu_torch.query.result_cache import ResultCache
from filodb_tpu_torch.utils.governor import (
    CHEAP,
    EXPENSIVE,
    RULES,
    QueryRejected,
    default_budget,
    governor,
    tenant_of,
)
from filodb_tpu_torch.utils.metrics import get_counter
from filodb_tpu_torch.utils.resilience import Deadline
from filodb_tpu_torch.utils.resilience import config as resilience_config
from filodb_tpu_torch.utils.tracing import (
    device_span,
    record_slow,
    span,
    traced_query,
)
from filodb_tpu_torch.utils.tracing import config as tracing_config

ENGINES = ("mesh", "exec", "adaptive")
_PLAN_MEMO = 256  # parsed plans kept by ``_parse_cached``
partial_results = get_counter("filodb_partial_results")
mesh_fallback_shards = get_counter(
    "filodb_mesh_fallback", {"reason": "shards"},
    help="mesh dispatches that fell back to the exec path after "
    "recognition")


# why a plan that reads a colder tier skips the mesh engine
_OLDER_TIER = "the plan reads an older tier than the memstore"


class _BudgetCtx:
    """What a result-bytes check over an answer writes: the budget, and
    the partial flag and warnings so far."""

    def __init__(self, budget, partial: bool = False, warnings=()):
        self.budget = budget
        self.partial = partial
        self.warnings: list[str] = list(warnings)


def _walk(plan, limit: int = 64):
    """The plan's nodes, depth first, at most ``limit``."""
    stack, seen = [plan], 0
    while stack and seen < limit:
        p = stack.pop()
        seen += 1
        yield p
        if dataclasses.is_dataclass(p):
            for f in dataclasses.fields(p):
                v = getattr(p, f.name, None)
                if dataclasses.is_dataclass(v) and not isinstance(v, type):
                    stack.append(v)


def _admission_cost(plan) -> str:
    """The static admission class of a plan, as the reference's: CHEAP
    for one evaluation step (start == end), else EXPENSIVE."""
    for p in _walk(plan):
        start, end = getattr(p, "start", None), getattr(p, "end", None)
        if isinstance(start, int) and isinstance(end, int) and end > 0:
            return CHEAP if start == end else EXPENSIVE
    return EXPENSIVE


def plan_tenant(plan) -> str:
    """The tenant (``ws/ns``) of the first selector with ``_ws_`` or
    ``_ns_`` equality filters; "" where none (no tenant gate)."""
    for p in _walk(plan):
        labels = {}
        for cf in getattr(p, "filters", None) or ():
            f = getattr(cf, "filter", None)
            if getattr(cf, "column", None) in ("_ws_", "_ns_") \
                    and isinstance(f, Equals):
                labels[cf.column] = str(f.value)
        if labels:
            return tenant_of(labels)
    return ""


class QueryService:
    """Serves queries over ``memstore`` on ``device`` (default: the CUDA
    card; ``device="cpu"`` runs every kernel's plain version) with
    ``engine`` ``"mesh"`` (falling back to exec), ``"adaptive"`` or
    ``"exec"``; ``time_split_ms`` > 0 has the planner split longer ranges;
    ``result_cache`` (a ``result_cache`` config block, True, or a
    ``ResultCache``; None or False: off) caches range answers by extent;
    ``query_timeout_s`` (None: the resilience config's) is each query's
    deadline. ``mesh`` (a ``LocalMesh``, ``parallel/mesh_engine.
    make_query_mesh``) spreads the mesh engines' leaves over its slots,
    and its first slot is then the service's device, where the exec
    engine runs; ``variant`` ("gather" or "ring") is their combine over
    the mesh's time axis. The batches both engines keep take at most half
    of each card's memory (``batches.budget`` on the service's device)."""

    # construction serials: a response-cache key names its service by it,
    # never by ``id()``, which a later service can reuse
    _serials = itertools.count(1)

    def __init__(self, memstore: MemStore,
                 device: "str | torch.device | None" = None,
                 engine: str = "mesh", time_split_ms: int = 0,
                 result_cache=None, query_timeout_s: float | None = None,
                 mesh=None, variant: str = "gather"):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: one of {ENGINES}")
        self.memstore = memstore
        self.dataset = memstore.dataset
        self.device = resolve(device if mesh is None else mesh.root)
        self.engine = engine
        self.query_timeout_s = query_timeout_s
        self.serial = next(QueryService._serials)
        self.batches = BatchCache(self.device)
        self.gids = GroupIdCache()
        self.lock = threading.RLock()
        if engine == "adaptive":
            self.mesh = AdaptiveQueryEngine(
                self.device, self.batches, self.gids, sidecars=True,
                dataset=self.dataset, lock=self.lock, mesh=mesh,
                variant=variant)
        else:
            self.mesh = MeshQueryEngine(self.device, self.batches,
                                        self.gids, sidecars=True, mesh=mesh,
                                        variant=variant)
        self.planner = SingleClusterPlanner(memstore.num_shards,
                                            memstore.spread,
                                            time_split_ms=time_split_ms,
                                            dataset=self.dataset)
        # whether every shard of the dataset is this process's (a
        # cluster's service sets it; None: always)
        self.shards_local_fn = None
        self.result_cache = ResultCache.from_config(result_cache)
        # the multi-process runtime (``coordinator/mesh_cluster.py``) where
        # a node boots mesh workers: memstore-only plans try it first
        self.mesh_cluster = None
        # () → [(shard, status)] of the queryable shards an answer may lag
        # (RECOVERY, HANDOFF, a down leader's follower serving): each
        # answer carries a warning a shard (a cluster's service sets it)
        self.shard_status_fn = None
        self._plans: dict = {}
        self._plans_lock = threading.Lock()
        # the deadline of the query or batch holding ``lock``
        self._deadline = None

    def _new_deadline(self) -> Deadline:
        timeout = self.query_timeout_s if self.query_timeout_s is not None \
            else resilience_config().query_timeout_s
        return Deadline.after(timeout)

    def query_range(self, promql: str, start_sec: int, step_sec: int,
                    end_sec: int, qcontext: QueryContext | None = None
                    ) -> QueryResult:
        qcontext = qcontext or QueryContext()
        t0 = time.perf_counter()
        with traced_query(qcontext, query=promql,
                          dataset=self.dataset) as rec:
            with span("parse", promql=promql):
                plan = self._parse_cached(promql, TimeStepParams(
                    start_sec, step_sec, end_sec))
            result = self.execute_logical(plan, qcontext)
            result.stats.wall_time_s = time.perf_counter() - t0
            rec.observe(result)
        return result

    def query_instant(self, promql: str, time_sec: int,
                      qcontext: QueryContext | None = None) -> QueryResult:
        """The query at one instant: steps (t, 0, t), one step at t."""
        return self.query_range(promql, time_sec, 0, time_sec, qcontext)

    def _parse_cached(self, promql: str, params: TimeStepParams):
        """The plan of (``promql``, ``params``), parsed once: plans are
        immutable, and a dashboard cycles few."""
        key = (promql, params.start, params.step, params.end)
        with self._plans_lock:
            plan = self._plans.get(key)
        if plan is None:
            plan = parse_query(promql, params)
            with self._plans_lock:
                if len(self._plans) >= _PLAN_MEMO:
                    self._plans.pop(next(iter(self._plans)))
                self._plans[key] = plan
        return plan

    def _admission_class(self, plan, qcontext: QueryContext) -> str:
        if qcontext.origin == "rules":
            return RULES
        # a tiered planner classes any query that reads a colder tier
        hint = getattr(self.planner, "cost_hint", None)
        forced = hint(plan) if hint is not None else None
        if forced is not None:
            return forced
        return adaptive_planner.admission_class(
            self.dataset, plan, qcontext, _admission_cost(plan))

    def shards_local(self) -> bool:
        """Whether every shard of the dataset lives in this process's
        store (the mesh engines, the extent cache and the response cache
        need it)."""
        f = self.shards_local_fn
        return True if f is None else bool(f())

    def _planner_mem_only(self, plan) -> bool:
        """Whether the planner proves ``plan`` reads the memstore only (a
        planner without tiers reads nothing else): only such a plan may
        take the mesh engine, which reads the memstore alone."""
        f = getattr(self.planner, "mem_only", None)
        return True if f is None else bool(f(plan))

    def execute_logical(self, plan, qcontext: QueryContext | None = None,
                        materialize: bool = True) -> QueryResult:
        """``plan``'s answer and stats, admitted by the governor, then
        from the extent cache where it serves the plan, else from an
        engine (``_execute_uncached``); with ``materialize`` False the
        values stay on the card."""
        qcontext = qcontext or QueryContext()
        pp = qcontext.planner_params
        if pp.budget is None:
            pp.budget = default_budget()
        deadline = self._new_deadline()
        cost = self._admission_class(plan, qcontext)
        t0 = time.perf_counter()
        with governor().admit(deadline=deadline, cost=cost,
                              tenant=plan_tenant(plan)):
            waited = time.perf_counter() - t0
            with self.lock:
                self._deadline = deadline
                try:
                    result = None
                    if self.result_cache is not None and materialize \
                            and self.shards_local():
                        result = self.result_cache.execute(self, plan,
                                                           qcontext)
                    if result is None:
                        result = self._execute_uncached(plan, qcontext,
                                                        materialize)
                finally:
                    self._deadline = None
        result.stats.admission_wait_s += waited
        adaptive_planner.settle_query(self.dataset, qcontext,
                                      time.perf_counter() - t0 - waited, cost)
        if result.partial:
            partial_results.inc()
        return self._attach_recovery_warnings(result)

    def _recovery_warnings(self) -> list[str]:
        """A warning a queryable shard still catching up (a replay, a
        migration's handoff) or served by a follower while its leader is
        unreachable (the reference's ``:531-551``): such answers are
        right or flagged, never silently behind."""
        fn = self.shard_status_fn
        if fn is None:
            return []
        try:
            out = []
            for shard, status in fn():
                if status.startswith("served by"):
                    out.append(f"shard {shard} {status}: results may "
                               f"lag live ingest")
                else:
                    out.append(f"shard {shard} recovering ({status}): "
                               f"results may lag live ingest")
            return out
        except Exception:  # noqa: BLE001 - a warning never fails a query
            return []

    def _attach_recovery_warnings(self, result: QueryResult) -> QueryResult:
        for w in self._recovery_warnings():
            if w not in result.warnings:
                result.warnings.append(w)
        return result

    def _execute_uncached(self, plan, qcontext: QueryContext | None = None,
                          materialize: bool = True) -> QueryResult:
        """``plan`` on an engine, without the extent cache (which
        evaluates its extents through here); the caller holds ``lock``."""
        qcontext = qcontext or QueryContext()
        t0 = time.perf_counter()
        fallback = ""
        result = None
        local = self.engine == "exec" or self.shards_local()
        if not local:
            mesh_fallback_shards.inc()
            fallback = "shards on other nodes"
        if local and self.engine != "exec" and self.mesh_cluster is not None \
                and self._planner_mem_only(plan):
            # the multi-process runtime first, inside this query's one
            # admission; None (a worker lost or stale, a shape it does not
            # take, FILODB_MULTIPROC=0) falls through to the engines here
            stats = QueryStats(engine="mesh-proc")
            with span("mesh-proc-execute"):
                data = self.mesh_cluster.execute_plan(plan, self._deadline,
                                                      stats)
            if data is not None:
                result = QueryResult(data, stats, qcontext.query_id)
        if result is None and local and self.engine != "exec":
            fallback = self.mesh.supports(self.memstore, plan) \
                if self._planner_mem_only(plan) else _OLDER_TIER
            if fallback is None:
                stats = QueryStats(engine="mesh")
                try:
                    with device_span("mesh-execute", self.device):
                        data = self.mesh.execute(self.memstore, plan, stats,
                                                 self._deadline)
                    result = QueryResult(data, stats, qcontext.query_id)
                except UnsupportedQuery as e:
                    fallback = str(e)
        if result is None:
            result = self._on_exec(plan, qcontext, fallback)
        if materialize:
            _finish(result, qcontext)
            result.stats.wall_time_s = time.perf_counter() - t0
        return result

    def _on_exec(self, plan, qcontext: QueryContext,
                 fallback: str) -> QueryResult:
        """``plan`` through the planner and the exec engine; ``fallback``
        says why mesh handed it on ("" where exec is the engine)."""
        stats = QueryStats(engine="exec", fallback=fallback)
        with span("plan-materialize"):
            tree = self.planner.materialize(plan, qcontext)
        ctx = ExecContext(self.memstore, stats, self.device, self.batches,
                          self.gids, deadline=self._deadline,
                          budget=qcontext.planner_params.budget,
                          dataset=self.dataset, qcontext=qcontext)
        with device_span("exec-dispatch", self.device):
            data = run_plan(tree, ctx)
        return QueryResult(data, stats, qcontext.query_id,
                           partial=ctx.partial, warnings=list(ctx.warnings))

    def query_range_many(self, queries, return_errors: bool = False,
                         qcontext: QueryContext | None = None) -> list:
        """The answers of many range queries, ``(promql, start_sec,
        step_sec, end_sec)`` each, in order, evaluated together under one
        EXPENSIVE admission slot (see the module's text). With
        ``return_errors`` a query that fails leaves its exception at its
        own position (a shed batch: ``QueryRejected`` at every position);
        without, the first failure raises. Every answer's ``wall_time_s``
        is the batch's. ``qcontext``'s planner parameters (the sample
        limit, the budget) hold for every member; the reference's batch
        takes none and holds each to the defaults, as a batch here does
        without one."""
        t0 = time.perf_counter()
        n = len(queries)
        if n == 1:
            try:
                return [self.query_range(*queries[0], qcontext=qcontext)]
            except Exception as e:  # noqa: BLE001 - at its position
                if not return_errors:
                    raise
                return [e]
        deadline = self._new_deadline()
        try:
            with governor().admit(deadline=deadline, cost=EXPENSIVE):
                waited = time.perf_counter() - t0
                with self.lock:
                    self._deadline = deadline
                    try:
                        outcomes = self._many_locked(queries, return_errors,
                                                     qcontext)
                    finally:
                        self._deadline = None
        except QueryRejected as e:
            if not return_errors:
                raise
            return [e] * n
        wall = time.perf_counter() - t0
        slow = tracing_config().slow_query_threshold_ms
        for (promql, *_), r in zip(queries, outcomes):
            if isinstance(r, QueryResult):
                self._attach_recovery_warnings(r)
                r.stats.wall_time_s = wall
                r.stats.admission_wait_s += waited
                if slow > 0 and wall * 1000.0 > slow:
                    # a batch runs as one: its members are not span-traced
                    record_slow("query", wall * 1000.0,
                                stats=dataclasses.asdict(r.stats),
                                query=promql, dataset=self.dataset,
                                batched=True)
        return outcomes

    def _many_locked(self, queries, return_errors: bool,
                     qcontext: QueryContext | None) -> list:
        """``query_range_many``'s body, under ``lock``."""
        pp = (qcontext or QueryContext()).planner_params

        def member() -> QueryContext:
            return QueryContext(planner_params=pp)

        n = len(queries)
        outcomes: list = [None] * n

        def failed(i: int, e: Exception) -> None:
            if not return_errors:
                raise e
            outcomes[i] = e

        plans: list = [None] * n
        for i, (promql, start, step, end) in enumerate(queries):
            try:
                plans[i] = self._parse_cached(promql, TimeStepParams(
                    start, step, end))
            except Exception as e:  # noqa: BLE001
                failed(i, e)
        if self.result_cache is not None and self.shards_local():
            for i, plan in enumerate(plans):
                if plan is None:
                    continue
                try:
                    outcomes[i] = self.result_cache.execute(self, plan,
                                                            member())
                except Exception as e:  # noqa: BLE001
                    failed(i, e)
        pending = [i for i in range(n)
                   if outcomes[i] is None and plans[i] is not None]
        answers = self._execute_many_uncached(
            [plans[i] for i in pending], member())
        for i, r in zip(pending, answers):
            if isinstance(r, Exception):
                failed(i, r)
            else:
                outcomes[i] = r
        return outcomes

    def _execute_many_uncached(self, plans: list, qcontext: QueryContext
                               ) -> list:
        """``plans`` on the engines together, without the extent cache
        (which evaluates the extents a query misses through here): one
        ``execute_many`` on the mesh engine, exec for what it does not
        serve, one device→host copy a shape group (``_fetch``), then each
        answer materialized and held to ``qcontext``'s limit and budget.
        Returns an answer or the exception it raised a plan; the caller
        holds ``lock``."""
        on_mesh: dict = {}
        meshable = [i for i, p in enumerate(plans)
                    if self._planner_mem_only(p)]
        remote = self.engine != "exec" and not self.shards_local()
        if remote and meshable:
            mesh_fallback_shards.inc(len(meshable))
            meshable = []
        if self.engine != "exec" and self.mesh_cluster is not None:
            # the multi-process runtime first, a plan at a time (as
            # ``_execute_uncached``); what it does not answer goes on
            for i in meshable:
                stats = QueryStats(engine="mesh-proc")
                try:
                    with span("mesh-proc-execute"):
                        data = self.mesh_cluster.execute_plan(
                            plans[i], self._deadline, stats)
                except Exception as e:  # noqa: BLE001 - at its position
                    data = e
                if data is not None:
                    on_mesh[i] = (data, stats)
            meshable = [i for i in meshable if i not in on_mesh]
        if self.engine != "exec" and meshable:
            stats = [QueryStats(engine="mesh") for _ in meshable]
            with device_span("mesh-execute", self.device):
                on_mesh.update(zip(meshable, zip(self.mesh.execute_many(
                    self.memstore, [plans[i] for i in meshable], stats,
                    self._deadline), stats)))
        out: list = []
        for i, plan in enumerate(plans):
            answer, stats = on_mesh.get(i, (None, None))
            try:
                if isinstance(answer, Exception):
                    raise answer
                out.append(QueryResult(answer, stats, qcontext.query_id)
                           if answer is not None else self._on_exec(
                               plan, qcontext,
                               "" if self.engine == "exec" else
                               "shards on other nodes" if remote else
                               _OLDER_TIER if i not in on_mesh else
                               self.mesh.reason(self.memstore, plan)
                               or "declined by the mesh engine's batch"))
            except Exception as e:  # noqa: BLE001 - at its position
                out.append(e)
        done = [i for i, r in enumerate(out) if isinstance(r, QueryResult)]
        for j, e in _fetch([out[i] for i in done]):
            out[done[j]] = e
        for i, r in enumerate(out):
            if isinstance(r, QueryResult):
                try:
                    _finish(r, qcontext)
                except Exception as e:  # noqa: BLE001
                    out[i] = e
        return out

    # ---- metadata ------------------------------------------------------------

    def label_names(self) -> list[str]:
        """Every label name in the store, sorted (``/api/v1/labels``)."""
        return self.memstore.label_names()

    def label_values(self, label: str, filters=None) -> list[str]:
        """The values of one label, among the series ``filters`` (column
        filters) select if given, sorted (``/api/v1/label/<l>/values``)."""
        return self.memstore.label_values(label, filters)

    def chunk_infos(self, filters, start_ms: int, end_ms: int,
                    include_buffer: bool = False) -> list[dict]:
        """The resident chunks of the series the filters select over
        [start, end] (and their write buffers with ``include_buffer``),
        shard by shard (the reference's ``SelectChunkInfosExec``)."""
        out = []
        for shard in self.memstore.shards:
            pids = shard.lookup_partitions(list(filters), start_ms, end_ms)
            for pid, cid, rows, t0, t1, nbytes in shard.chunk_infos(
                    pids, start_ms, end_ms, include_buffer):
                out.append({"shard": shard.shard_num, "partId": pid,
                            "partKey": str(shard.keys[pid]), "chunkId": cid,
                            "numRows": rows, "startTime": t0, "endTime": t1,
                            "numBytes": nbytes})
        return out

    def series(self, filters, start_sec: int, end_sec: int) -> list[dict]:
        """The label maps of the series the filters select over [start,
        end], shard by shard (``/api/v1/series``)."""
        out = []
        for shard in self.memstore.shards:
            for pid in shard.lookup_partitions(list(filters), start_sec * 1000,
                                               end_sec * 1000):
                out.append(shard.keys[pid].label_map)
        return out


def _finish(result: QueryResult, qcontext: QueryContext) -> None:
    """Materialize an answer (deferred compaction first, on the card),
    then hold it to the query's limit and result-bytes budget and count
    its series."""
    data = result.result.materialize()
    result.stats.settle_timings()  # the copy above waited for the stream
    enforce_limits(data, qcontext)
    shim = _BudgetCtx(qcontext.planner_params.budget, result.partial,
                      result.warnings)
    result.result = apply_result_budget(data, shim)
    result.partial, result.warnings = shim.partial, shim.warnings
    result.stats.result_series = result.result.num_series


def _fetch(results: list[QueryResult]) -> list[tuple[int, Exception]]:
    """Bring answers still on the card to the host in one copy a shape
    group: each is compacted on the card, then the distinct value tensors
    of one (shape, dtype, device) are stacked and copied at once, into
    float64. Answers that hold one tensor (members of one grid over one
    leaf) share one host array, so a caller treats values as read-only.
    Returns (position, exception) where a group's copy failed."""
    groups: dict = {}
    errors = []
    for j, r in enumerate(results):
        try:
            v = r.result.settle().values
        except Exception as e:  # noqa: BLE001
            errors.append((j, e))
            continue
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            groups.setdefault((tuple(v.shape), v.dtype, v.device),
                              {}).setdefault(id(v), (v, []))[1].append(j)
    for group in groups.values():
        tensors = list(group.values())
        try:
            host = torch.stack([v for v, _ in tensors]).to(
                "cpu", torch.float64).numpy()
        except Exception as e:  # noqa: BLE001
            errors += [(j, e) for _, members in tensors for j in members]
            continue
        for (_, members), values in zip(tensors, host):
            for j in members:
                results[j].result.values = values
    return errors


class QueryBatcher:
    """Coalesces the range queries of concurrent threads into
    ``query_range_many`` batches (the threaded HTTP front end): callers
    queue and wait, one thread drains what is queued (at most
    ``max_batch``) and answers each caller with its own result or
    exception. An idle service answers a lone query at once. ``close``
    stops the thread."""

    def __init__(self, svc: QueryService, max_batch: int = 64):
        self.svc = svc
        self.max_batch = max_batch
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="query-batcher")
        self._thread.start()

    def query_range(self, promql: str, start_sec: int, step_sec: int,
                    end_sec: int) -> QueryResult:
        item = {"params": (promql, start_sec, step_sec, end_sec),
                "event": threading.Event(), "result": None, "error": None}
        self._q.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        while True:
            items = [self._q.get()]
            try:
                while len(items) < self.max_batch:
                    items.append(self._q.get_nowait())
            except queue.Empty:
                pass
            stop = None in items
            items = [it for it in items if it is not None]
            try:
                results = self.svc.query_range_many(
                    [it["params"] for it in items], return_errors=True)
            except Exception as e:  # noqa: BLE001 - every caller hears it
                results = [e] * len(items)
            for it, r in zip(items, results):
                it["error" if isinstance(r, Exception) else "result"] = r
                it["event"].set()
            if stop:
                return
