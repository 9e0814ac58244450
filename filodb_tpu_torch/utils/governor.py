"""Node-level resource governor: admission, query budgets and
memory-pressure shedding.

Copy of ``filodb_tpu/utils/governor.py``:

- :class:`ResourceGovernor` — a bounded-concurrency admission gate with a
  deadline-aware wait queue in front of every query entry point (the
  service's queries, a ``query_range_many`` batch, the HTTP fronts'
  passes). Classes CHEAP (instant, metadata), EXPENSIVE (range scans) and
  RULES. Past its wait budget a query is shed with :class:`QueryRejected`
  (HTTP 503 with ``Retry-After``).
- :class:`QueryBudget` — per-query limits on samples scanned, result bytes
  and group cardinality, checked in the leaves, at the aggregation and on
  the answer; ``degrade="partial"`` flags the answer partial with a
  warning, ``degrade="error"`` raises :class:`QueryBudgetExceeded` (422).
- :class:`MemoryWatchdog` — samples utilization sources (write-buffer
  pools, result-cache bytes) and moves the node OK → DEGRADED → CRITICAL:
  DEGRADED halves admission and evicts caches, CRITICAL sheds gateway
  ingest and new EXPENSIVE queries while CHEAP ones stay admitted.
- Tenant quotas and concurrency caps keyed on the ``_ws_``/``_ns_``
  prefix.

Every transition and rejection is a ``filodb_governor_*`` metric, created
at import.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from filodb_tpu_torch.query.model import QueryLimitExceeded
from filodb_tpu_torch.utils.metrics import (
    Counter,
    Gauge,
    Histogram,
    get_counter,
    get_gauge,
)

# ---------------------------------------------------------------------------
# states

OK, DEGRADED, CRITICAL = "ok", "degraded", "critical"
_STATE_VALUE = {OK: 0, DEGRADED: 1, CRITICAL: 2}

# admission cost classes: "cheap" (instant/metadata — stays admissible under
# CRITICAL) vs "expensive" (range scans — shed first under pressure) vs
# "rules" (background standing-query evaluation — strictly lowest priority:
# capped by ``rules_max_inflight``, never queued, shed the moment the node
# leaves OK; a shed evaluation just retries on a later tick)
CHEAP, EXPENSIVE, RULES = "cheap", "expensive", "rules"


# ---------------------------------------------------------------------------
# errors


class QueryRejected(RuntimeError):
    """The admission gate shed this query (HTTP 503 + ``Retry-After``).

    Deliberately NOT a ``ConnectionError``/``TimeoutError``: a peer that
    sheds is *healthy* — scatter-gather must not treat it as a lost child
    and circuit breakers must not count it as a transport failure.
    """

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 reason: str = "capacity"):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.reason = reason


class QueryBudgetExceeded(QueryLimitExceeded):
    """A scan-time cost budget was breached in ``degrade="error"`` mode
    (maps to HTTP 422 through the existing ``QueryLimitExceeded`` arm)."""


# ---------------------------------------------------------------------------
# metrics — pre-created at import so the scrape families render even before
# any traffic moves them

_state_gauge = Gauge("filodb_governor_state")
_inflight_gauge = Gauge("filodb_governor_inflight")
_queue_depth_gauge = Gauge("filodb_governor_queue_depth")
_memory_util_gauge = Gauge("filodb_governor_memory_utilization")
_admitted = Counter("filodb_governor_admitted")
_rejected = {r: Counter("filodb_governor_rejected", {"reason": r})
             for r in ("capacity", "deadline", "queue_full", "critical",
                       "tenant", "rules")}
_transitions = {s: Counter("filodb_governor_transitions", {"to": s})
                for s in (OK, DEGRADED, CRITICAL)}
_budget_exceeded = Counter("filodb_governor_budget_exceeded")
_queue_wait = Histogram("filodb_governor_queue_wait_seconds")

# per-tenant families (tenant = "_ws_" or "_ws_/_ns_" shard-key prefix);
# untagged series pre-created so the families render before any tenant
# config exists — runtime series carry {"tenant": ...} tags
_tenant_inflight = Gauge("filodb_tenant_inflight")
_tenant_admitted = Counter("filodb_tenant_admitted")
_tenant_rejected = Counter("filodb_tenant_rejected")
_tenant_dropped = Counter("filodb_tenant_ingest_dropped")
_tenant_series = Gauge("filodb_tenant_series")
_tenant_quota = Gauge("filodb_tenant_quota")


# ---------------------------------------------------------------------------
# config (process-wide singleton; overridable via config.py "governor" block)


@dataclass
class GovernorConfig:
    admission_capacity: int = 32       # concurrent queries when OK
    admission_queue_limit: int = 128   # waiters beyond that -> queue_full
    max_queue_wait_s: float = 5.0      # hard cap on time spent queued
    queue_headroom_s: float = 0.05     # deadline slack a queued query keeps
    retry_after_s: float = 1.0         # advisory Retry-After on sheds
    degraded_capacity_factor: float = 0.5
    degraded_threshold: float = 0.75   # max source utilization -> degraded
    critical_threshold: float = 0.92   # max source utilization -> critical
    watchdog_interval_s: float = 0.5
    # concurrent standing-query (rule) evaluations; rule evals are their
    # own admission class so a pathological rule cannot starve
    # interactive queries (they never queue and shed outside OK)
    rules_max_inflight: int = 2
    # budget limits; 0 = unlimited (no budget attached to queries)
    max_samples_scanned: int = 0
    max_result_bytes: int = 0
    max_group_cardinality: int = 0
    budget_degrade: str = "partial"    # "partial" | "error"
    # per-tenant admission classes + cardinality quotas, keyed on the
    # shard-key prefix: {"ws": {...}} or {"ws/ns": {...}} with
    #   max_inflight:  concurrent queries for this tenant (0 = unlimited)
    #   max_series:    active-series cardinality quota per shard (0 = off)
    # one tenant's flood sheds ONLY that tenant: its queries reject with
    # reason="tenant" without consuming the shared admission queue, and
    # its over-quota series drop at ingest (QuotaExceededError)
    tenants: dict = field(default_factory=dict)


_config = GovernorConfig()


def config() -> GovernorConfig:
    return _config


def configure(**kw) -> GovernorConfig:
    """Apply server-config overrides (``config.py`` ``governor`` block)."""
    for k, v in kw.items():
        if hasattr(_config, k):
            setattr(_config, k, v)
    return _config


# Optional live Retry-After source (coordinator/adaptive_planner.py): maps
# a shed reason to an advisory delay learned from settled per-class
# latency percentiles. Returning None (or raising nothing useful) falls
# back to the static ``retry_after_s`` constant, so a cold model keeps
# today's behavior bit-for-bit.
_retry_after_provider = None


def set_retry_after_provider(fn) -> None:
    global _retry_after_provider
    _retry_after_provider = fn


def _advised_retry_after(reason: str, static_s: float) -> float:
    fn = _retry_after_provider
    if fn is None:
        return static_s
    try:
        v = fn(reason)
    except Exception:
        return static_s
    if v is None:
        return static_s
    try:
        v = float(v)
    except (TypeError, ValueError):
        return static_s
    # clamp: advisory backoff should never be absurd even if the model is
    return min(max(v, 0.05), 60.0)


# ---------------------------------------------------------------------------
# query budget


@dataclass
class QueryBudget:
    """Per-query scan-time cost limits; 0 means unlimited for that axis.

    Wire-serializable (registered in ``coordinator/wire.py``) and carried on
    ``PlannerParams.budget`` so remote leaves enforce the same budget.
    """

    max_samples_scanned: int = 0
    max_result_bytes: int = 0
    max_group_cardinality: int = 0
    degrade: str = "partial"

    def breach(self, ctx, what: str, limit: int, actual: int) -> bool:
        """Record a budget breach. ``degrade="error"`` raises; partial mode
        flags ``ctx`` partial with a warning and returns True so the caller
        stops scanning and returns what it has."""
        _budget_exceeded.inc()
        msg = (f"query budget exceeded: {what} {actual} > {limit}; "
               f"returning partial data")
        if self.degrade == "error":
            raise QueryBudgetExceeded(
                f"query budget exceeded: {what} {actual} > limit {limit}")
        if ctx is not None:
            ctx.partial = True
            if msg not in ctx.warnings:
                ctx.warnings.append(msg)
        return True

    def check_samples(self, ctx, samples_scanned: int) -> bool:
        """True when the samples budget is breached (and recorded)."""
        lim = self.max_samples_scanned
        if lim and samples_scanned > lim:
            return self.breach(ctx, "samples scanned", lim, samples_scanned)
        return False

    def check_result_bytes(self, ctx, nbytes: int) -> bool:
        lim = self.max_result_bytes
        if lim and nbytes > lim:
            return self.breach(ctx, "result bytes", lim, nbytes)
        return False

    def check_cardinality(self, ctx, groups: int) -> bool:
        lim = self.max_group_cardinality
        if lim and groups > lim:
            return self.breach(ctx, "group cardinality", lim, groups)
        return False


def default_budget() -> QueryBudget | None:
    """Budget from the governor config, or None when every axis is
    unlimited (the common case: budgets are opt-in, existing queries see
    no behavior change)."""
    c = _config
    if not (c.max_samples_scanned or c.max_result_bytes
            or c.max_group_cardinality):
        return None
    return QueryBudget(max_samples_scanned=c.max_samples_scanned,
                       max_result_bytes=c.max_result_bytes,
                       max_group_cardinality=c.max_group_cardinality,
                       degrade=c.budget_degrade)


# ---------------------------------------------------------------------------
# per-tenant isolation (keyed on the _ws_/_ns_ shard-key prefix)


def tenant_of(labels: dict) -> str:
    """Tenant id from a shard-key label map: ``"ws/ns"`` when both are
    present, ``"ws"`` with only a workspace, ``""`` for untenanted data."""
    ws = labels.get("_ws_", "")
    ns = labels.get("_ns_", "")
    return f"{ws}/{ns}" if ws and ns else ws


def tenant_limits(tenant: str) -> dict | None:
    """The configured class for a tenant: exact ``ws/ns`` match first,
    then the ``ws`` prefix; None when the tenant is unclassed."""
    if not tenant or not _config.tenants:
        return None
    tc = _config.tenants.get(tenant)
    if tc is None and "/" in tenant:
        tc = _config.tenants.get(tenant.split("/", 1)[0])
    return tc


def tenant_account_key(tenant: str) -> str:
    """Inflight-accounting key for a tenant: the configured class key when
    one matches (so a ``ws``-scoped cap aggregates across all of that
    workspace's namespaces), else the tenant itself."""
    if not tenant or not _config.tenants or tenant in _config.tenants:
        return tenant
    if "/" in tenant:
        ws = tenant.split("/", 1)[0]
        if ws in _config.tenants:
            return ws
    return tenant


def apply_tenant_quotas(tracker) -> None:
    """Push configured per-tenant cardinality quotas into a shard's
    :class:`CardinalityTracker` (called at shard construction, so every
    shard enforces the same quotas at ingest)."""
    for tenant, tc in _config.tenants.items():
        quota = int(tc.get("max_series", 0) or 0)
        if quota <= 0:
            continue
        tracker.set_quota(tenant.split("/"), quota)
        get_gauge("filodb_tenant_quota", {"tenant": tenant}).set(quota)


def record_tenant_drop(labels: dict) -> None:
    """Count one quota-dropped ingest record against its tenant."""
    tenant = tenant_of(labels)
    _tenant_dropped.inc()
    if tenant:
        get_counter("filodb_tenant_ingest_dropped",
                    {"tenant": tenant}).inc()


def register_tenant_series_gauges(shards_fn) -> None:
    """Per-tenant active-series gauges (``filodb_tenant_series{tenant=}``)
    computed at scrape time by summing each configured tenant's
    cardinality-tree counts over ``shards_fn()`` (the node's live shards) —
    no update path, never stale."""
    from filodb_tpu_torch.utils.metrics import GaugeFn
    for tenant in _config.tenants:
        prefix = tenant.split("/")

        def fn(prefix=prefix):
            total = 0
            for sh in shards_fn() or []:
                total += sh.cardinality.cardinality(prefix).active_ts
            return total

        GaugeFn("filodb_tenant_series", fn, {"tenant": tenant})


# ---------------------------------------------------------------------------
# admission gate


class ResourceGovernor:
    """Bounded-concurrency admission gate with a deadline-aware wait queue.

    Capacity shrinks by ``degraded_capacity_factor`` when the watchdog moves
    the node out of OK; under CRITICAL, new ``EXPENSIVE`` work is shed
    outright while ``CHEAP`` (instant/metadata) queries keep flowing.
    Admission never deadlocks: every wait is bounded by the caller's
    deadline and ``max_queue_wait_s``, and slots are always released via
    the :meth:`admit` context manager.
    """

    def __init__(self, cfg: GovernorConfig | None = None):
        self.cfg = cfg or _config
        self._cond = threading.Condition()
        self._inflight = 0
        self._waiters = 0
        self._rules_inflight = 0
        self._tenant_inflight: dict[str, int] = {}
        self._state = OK
        _state_gauge.set(_STATE_VALUE[OK])
        _inflight_gauge.set(0)
        _queue_depth_gauge.set(0)

    # -- state ------------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def set_state(self, new: str) -> bool:
        """Move to ``new`` state; returns True when this was a transition."""
        if new not in _STATE_VALUE:
            raise ValueError(f"unknown governor state {new!r}")
        with self._cond:
            if new == self._state:
                return False
            self._state = new
            _state_gauge.set(_STATE_VALUE[new])
            _transitions[new].inc()
            self._cond.notify_all()
        return True

    def capacity(self) -> int:
        cap = max(1, int(self.cfg.admission_capacity))
        if self._state != OK:
            cap = max(1, int(cap * self.cfg.degraded_capacity_factor))
        return cap

    @property
    def inflight(self) -> int:
        return self._inflight

    # -- admission --------------------------------------------------------

    def _reject(self, reason: str, detail: str) -> None:
        _rejected[reason].inc()
        raise QueryRejected(f"query shed ({reason}): {detail}",
                            retry_after_s=_advised_retry_after(
                                reason, self.cfg.retry_after_s),
                            reason=reason)

    @contextmanager
    def admit(self, deadline=None, cost: str = EXPENSIVE,
              tenant: str = ""):
        """Admit one query; blocks while at capacity until a slot frees or
        the wait budget (deadline minus headroom, capped at
        ``max_queue_wait_s``) runs out, then sheds with
        :class:`QueryRejected`. ``tenant`` (the ``_ws_/_ns_`` shard-key
        prefix) gates against that tenant's configured ``max_inflight``
        BEFORE the shared queue — a flooding tenant sheds itself without
        occupying capacity others are waiting for."""
        tenant = tenant_account_key(tenant)
        self._acquire(deadline, cost, tenant)
        try:
            yield self
        finally:
            self._release(tenant, cost)

    def _tenant_gate(self, tenant: str) -> None:
        """Per-tenant concurrency cap; caller holds ``_cond``. Rejects
        immediately (no queueing) — the shed is the isolation mechanism."""
        tc = tenant_limits(tenant)
        if tc is None:
            return
        cap = int(tc.get("max_inflight", 0) or 0)
        if cap and self._tenant_inflight.get(tenant, 0) >= cap:
            get_counter("filodb_tenant_rejected",
                        {"tenant": tenant}).inc()
            _tenant_rejected.inc()
            self._reject("tenant",
                         f"tenant {tenant} at max_inflight={cap}")

    def _acquire(self, deadline, cost: str, tenant: str = "") -> None:
        cfg = self.cfg
        t0 = time.monotonic()
        with self._cond:
            self._tenant_gate(tenant)
            if cost == RULES:
                # background standing-query work: strictly lowest
                # priority. Shed the moment the node leaves OK, cap
                # concurrent evaluations, and never occupy the wait
                # queue — interactive queries own it. A shed evaluation
                # retries on a later tick with nothing lost.
                if self._state != OK:
                    self._reject("rules",
                                 f"rule evaluation shed: node {self._state}")
                cap = max(1, int(self.cfg.rules_max_inflight))
                if self._rules_inflight >= cap:
                    self._reject("rules",
                                 f"rule evaluations at max_inflight={cap}")
                if self._inflight >= self.capacity() or self._waiters:
                    self._reject("rules",
                                 "no spare capacity for rule evaluation")
                self._admit_locked(t0, tenant, cost)
                return
            if self._state == CRITICAL and cost == EXPENSIVE:
                self._reject("critical",
                             "node under memory pressure; only cheap "
                             "queries admitted")
            if self._inflight < self.capacity() and self._waiters == 0:
                self._admit_locked(t0, tenant, cost)
                return
            if self._waiters >= cfg.admission_queue_limit:
                self._reject("queue_full",
                             f"admission queue full "
                             f"({self._waiters} waiting)")
            self._waiters += 1
            _queue_depth_gauge.set(self._waiters)
            try:
                while True:
                    if self._state == CRITICAL and cost == EXPENSIVE:
                        self._reject("critical",
                                     "node went critical while queued")
                    if self._inflight < self.capacity():
                        self._admit_locked(t0, tenant, cost)
                        return
                    budget = cfg.max_queue_wait_s - (time.monotonic() - t0)
                    if deadline is not None:
                        budget = min(budget, deadline.remaining()
                                     - cfg.queue_headroom_s)
                    if budget <= 0:
                        reason = "deadline" if deadline is not None \
                            else "capacity"
                        self._reject(reason,
                                     f"no capacity within wait budget "
                                     f"(inflight={self._inflight}, "
                                     f"capacity={self.capacity()})")
                    self._cond.wait(timeout=min(budget, 0.25))
            finally:
                self._waiters -= 1
                _queue_depth_gauge.set(self._waiters)

    def _admit_locked(self, t0: float, tenant: str = "",
                      cost: str = EXPENSIVE) -> None:
        self._inflight += 1
        _inflight_gauge.set(self._inflight)
        _admitted.inc()
        _queue_wait.observe(time.monotonic() - t0)
        if cost == RULES:
            self._rules_inflight += 1
        if tenant:
            n = self._tenant_inflight.get(tenant, 0) + 1
            self._tenant_inflight[tenant] = n
            get_gauge("filodb_tenant_inflight", {"tenant": tenant}).set(n)
            get_counter("filodb_tenant_admitted", {"tenant": tenant}).inc()
            _tenant_admitted.inc()

    def _release(self, tenant: str = "", cost: str = EXPENSIVE) -> None:
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            _inflight_gauge.set(self._inflight)
            if cost == RULES:
                self._rules_inflight = max(0, self._rules_inflight - 1)
            if tenant:
                n = max(0, self._tenant_inflight.get(tenant, 0) - 1)
                self._tenant_inflight[tenant] = n
                get_gauge("filodb_tenant_inflight",
                          {"tenant": tenant}).set(n)
            self._cond.notify()


# ---------------------------------------------------------------------------
# memory watchdog


class MemoryWatchdog:
    """Periodically samples utilization sources (0..1 each) and drives the
    governor's state machine; the max over sources decides the state.

    Sources are callables returning a fraction or None (subject torn down).
    ``on_degraded`` callbacks fire on every upward transition out of OK —
    standalone wires result-cache eviction there.
    """

    def __init__(self, gov: ResourceGovernor | None = None,
                 interval_s: float | None = None, clock=time.monotonic):
        self.gov = gov or governor()
        self.interval_s = interval_s if interval_s is not None \
            else self.gov.cfg.watchdog_interval_s
        self.clock = clock
        self.sources: list[tuple[str, "callable"]] = []
        self.on_degraded: list["callable"] = []
        self._stop = threading.Event()
        self._thread = None

    def add_source(self, name: str, fn) -> "MemoryWatchdog":
        self.sources.append((name, fn))
        return self

    def utilization(self) -> float:
        worst = 0.0
        for _name, fn in self.sources:
            try:
                v = fn()
            except Exception:
                continue
            if v is not None:
                worst = max(worst, float(v))
        return worst

    def sample(self) -> str:
        """One observation: read sources, map to a state, apply it."""
        util = self.utilization()
        _memory_util_gauge.set(util)
        cfg = self.gov.cfg
        if util >= cfg.critical_threshold:
            new = CRITICAL
        elif util >= cfg.degraded_threshold:
            new = DEGRADED
        else:
            new = OK
        prev = self.gov.state
        if self.gov.set_state(new) and _STATE_VALUE[new] > _STATE_VALUE[prev]:
            for cb in self.on_degraded:
                try:
                    cb(new)
                except Exception:
                    pass
        return new

    def start(self) -> "MemoryWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.sample()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="governor-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        # a stopped watchdog leaves no stale pressure behind (tests share
        # the process-global governor)
        self.gov.set_state(OK)


# ---------------------------------------------------------------------------
# process-global governor singleton

_governor: ResourceGovernor | None = None
_governor_lock = threading.Lock()


def governor() -> ResourceGovernor:
    global _governor
    with _governor_lock:
        if _governor is None:
            _governor = ResourceGovernor(_config)
        return _governor


def reset() -> None:
    """Fresh governor + default config (tests)."""
    global _governor, _retry_after_provider
    with _governor_lock:
        _config.__dict__.update(GovernorConfig().__dict__)
        _governor = ResourceGovernor(_config)
        _retry_after_provider = None
