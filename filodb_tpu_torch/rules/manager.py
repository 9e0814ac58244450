"""Standing-query evaluation: incremental recording rules and alerts.

The reference deployment's dashboard workload is dominated by re-polling
the same PromQL; recording/alerting rules (``prometheus/rules``) convert
that into amortized streaming work at write time. Here the evaluation
loop is driven by shard ingest progress: a group's clock is the result
cache's horizon (``min(shard.max_ingested_ts) − ooo_allowance`` — the
point behind which extents are immutable), and each tick evaluates every
rule only over newly-completed step-aligned extents. Evaluation goes
through ``QueryService.query_range`` so the per-extent matrices land in
and are served from the extent result cache, and the recording outputs
are written back as first-class series through the normal ingest path —
they shard, flush, upload, downsample, and migrate like any other
series, and they pass the same per-tenant cardinality quotas as gateway
ingest (rules are not a quota bypass).

Crash-safety contract (proven by the chaos tests):

- Re-evaluating a step is idempotent: shards drop per-partition samples
  at ``ts <= last`` as out-of-order, so a crashed-then-retried write can
  never double-count.
- The group watermark is a COMMIT RECORD, not in-memory state: after all
  rules' outputs for a window are handed to the sink, the manager writes
  one ``FILODB_RULES_WATERMARK{group=...}`` sample at the window's last
  step (value = that step, epoch seconds). Restart recovery reads the
  marker back (``max_over_time`` so selector lookback cannot overstate
  it) and resumes from the step after it — anything written past the
  marker before the crash is simply re-evaluated and deduplicated, so
  there is no skipped extent and no double-write.
- Alert state (inactive→pending→firing per group-key, with ``for:``
  hysteresis) is recomputed from the synthetic ``ALERTS_FOR_STATE``
  series at the recovered watermark; in-memory state only commits
  together with the watermark.

Rule evaluations admit through the governor as their own cost class
(``origin="rules"`` on the QueryContext → ``RULES``), gated by
``rules_max_inflight`` and shed before interactive queries under
pressure; a shed tick leaves the watermark unmoved and retries next
tick.

Cache-consistency hook: rule outputs are written at timestamps at or
below the ingest horizon — inside the region the result cache treats as
immutable. The manager therefore publishes ``svc.rules_horizon_floor``
(min over groups of the last step whose outputs are known VISIBLE in the
memstore); the cache clamps its immutability horizon to that floor so an
extent of a rule-output series can never be frozen before the rule's
write lands. The floor is a plain int republished at every commit and
read lock-free — the cache's per-query call never blocks behind an
in-flight evaluation. A group that has not yet recovered contributes a
BOUNDED conservative floor (recovery and catch-up never write below
``horizon − (max_catchup_steps+1)·interval``) instead of an open-ended
sentinel, so a group stuck before its first recovery costs cache
efficiency over a bounded window only; ``filodb_rules_unrecovered_groups``
surfaces how many groups are still pinning it.

Locking: ``_eval_lock`` serializes ticks; ``_lock`` guards group state
and is held only for brief snapshot reads and commit writes, never
across query evaluation or sink writes — so ``/api/v1/rules`` and
``/api/v1/alerts`` snapshots and interactive queries cannot stall
behind a slow evaluation or a post-restart catch-up.

Port of ``filodb_tpu/rules/manager.py`` over the port's store: a
``MemStore`` holds one dataset (``svc.memstore.shards``), and a
``MemstoreSink`` write goes through the shard's C++ ingest pass
(``Shard.ingest``), whose per-partition ``ts <= latest`` drop is the
deduplication the idempotent re-write relies on. A rule tick is an
ordinary ``QueryService.query_range`` with ``origin="rules"``: a tick of
one or two steps goes from the mesh engine to the sidecar lane, a longer
catch-up runs on mesh (ROADMAP §C: its deadline is checked at leaf
boundaries, as every mesh query's).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np

from filodb_tpu_torch.coordinator.ingestion import route_container
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import (
    IngestRecord,
    RecordContainer,
    SomeData,
)
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.rules import notify
from filodb_tpu_torch.rules.model import (
    AlertingRule,
    RecordingRule,
    RuleGroup,
)
from filodb_tpu_torch.utils import governor as governor_mod
from filodb_tpu_torch.utils import racecheck
from filodb_tpu_torch.utils.metrics import Counter, Gauge, Histogram, get_gauge
from filodb_tpu_torch.utils.resilience import FaultInjector
from filodb_tpu_torch.utils.tracing import traced_operation

log = logging.getLogger("filodb.rules")

WATERMARK_METRIC = "FILODB_RULES_WATERMARK"
ALERTS_METRIC = "ALERTS"
ALERTS_FOR_STATE_METRIC = "ALERTS_FOR_STATE"

_UNRECOVERED = -(1 << 62)

# families pre-registered at import (standalone imports this module
# unconditionally) so dashboards see stable zeros before any rule runs
rules_groups = Gauge("filodb_rules_groups")
rules_evals = Counter("filodb_rules_evals")
rules_eval_failures = Counter("filodb_rules_eval_failures")
rules_evals_shed = Counter("filodb_rules_evals_shed")
rules_steps_evaluated = Counter("filodb_rules_steps_evaluated")
rules_steps_skipped = Counter("filodb_rules_steps_skipped")
rules_samples_written = Counter("filodb_rules_samples_written")
rules_eval_seconds = Histogram("filodb_rules_eval_seconds")
rules_last_eval_ts = Gauge("filodb_rules_last_eval_ts")
rules_unrecovered_groups = Gauge("filodb_rules_unrecovered_groups")
# untagged family anchor — runtime series carry {group=...} tags
rules_watermark_lag = Gauge("filodb_rules_watermark_lag_seconds")
alerts_firing = Gauge("filodb_alerts_firing")
alerts_pending = Gauge("filodb_alerts_pending")
alerts_transitions = Counter("filodb_alerts_transitions")


def _q(value: str) -> str:
    """Quote a string as a PromQL label-value literal. Group and alert
    names are charset-validated at config load, but selector fragments
    are still escaped here so a lexer-breaking name can never turn into
    a silently never-recovering group."""
    return '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'


class LogSink:
    """Route rule outputs into the per-shard replay logs — the gateway
    path. Writes become visible once the shards' ingestion pipelines
    consume the appended offsets; ``write`` returns those offsets so the
    manager can track visibility for the cache horizon floor."""

    def __init__(self, logs, num_shards: int, spread: int = 1):
        self.logs = logs
        self.num_shards = num_shards
        self.spread = spread

    def write(self, container: RecordContainer):
        count = 0
        offsets: dict[int, int] = {}
        for shard, cont in route_container(container, self.num_shards,
                                           self.spread).items():
            offsets[shard] = self.logs[shard].append(cont)
            count += len(cont)
        return count, offsets


class MemstoreSink:
    """Ingest rule outputs directly into local shards (embedded servers,
    tests, benchmarks). Synchronous: visible as soon as ``write``
    returns. Offsets are allocated above both the shard's latest
    ingested offset and its flush watermarks, so direct writes are never
    mistaken for recovery replay and skipped."""

    def __init__(self, memstore, dataset: str, num_shards: int,
                 spread: int = 0):
        # ``memstore``: the port's ``MemStore`` of ``dataset``
        self.memstore = memstore
        self.dataset = dataset
        self.num_shards = num_shards
        self.spread = spread

    def write(self, container: RecordContainer):
        count = 0
        for shard_num, cont in route_container(container, self.num_shards,
                                               self.spread).items():
            shard = self.memstore.shards[shard_num]
            offset = max(shard.latest_offset,
                         int(max(shard.group_watermarks, default=-1))) + 1
            count += shard.ingest(SomeData(cont, offset))
        return count, {}


@dataclass
class AlertState:
    """One active alert instance (pending or firing)."""

    active_since_ms: int
    firing: bool
    value: float


@dataclass
class _GroupState:
    last_step: int | None = None          # committed watermark (epoch ms)
    visible_step: int = _UNRECOVERED      # watermark known shard-visible
    pending_offsets: dict = field(default_factory=dict)
    pending_step: int | None = None
    # rule name -> {label tuple -> AlertState}
    alert_states: dict = field(default_factory=dict)
    last_error: str = ""
    last_eval_wall: float = 0.0
    last_eval_duration: float = 0.0


class RuleManager:
    """Evaluates one dataset's rule groups against its QueryService.

    ``sink`` is a :class:`LogSink` (WAL path) or :class:`MemstoreSink`
    (direct). ``ooo_allowance_ms`` defaults to the service's result-cache
    allowance so the rules horizon and the cache horizon agree exactly.
    """

    def __init__(self, svc, sink, groups: list[RuleGroup],
                 ooo_allowance_ms: int | None = None,
                 max_catchup_steps: int = 512,
                 default_labels: dict[str, str] | None = None,
                 notifier=None):
        self.svc = svc
        self.sink = sink
        # WebhookNotifier (or anything with submit(events)); transition
        # events are handed off AFTER the state-lock commit — the
        # hand-off is non-blocking and the POST runs on the notifier's
        # own worker
        self._notifier = notifier
        self.groups = list(groups)
        if ooo_allowance_ms is None:
            rc = getattr(svc, "result_cache", None)
            ooo_allowance_ms = (rc.config.ooo_allowance_ms
                                if rc is not None else 300_000)
        self.ooo_allowance_ms = ooo_allowance_ms
        self.max_catchup_steps = max(1, int(max_catchup_steps))
        self.default_labels = dict(default_labels
                                   or {"_ws_": "default", "_ns_": "default"})
        # group states are committed under _lock from the tick thread
        # and snapshotted from API/recovery threads; registered with the
        # race sanitizer as the reference registers them
        self._state = racecheck.tracked_dict("RuleManager._state", {
            g.name: racecheck.register(
                _GroupState(), f"RuleManager.state[{g.name}]")
            for g in self.groups})
        # _lock guards group state for brief commits/snapshots only;
        # _eval_lock serializes ticks so queries and sink writes run
        # without blocking state readers
        self._lock = threading.RLock()
        self._eval_lock = threading.Lock()
        self._floor = (1 << 62) if not self.groups else _UNRECOVERED
        self._stalled_ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # start and stop may race (a node's shutdown beside the thread that
        # starts its managers once the shards are active)
        self._life_lock = threading.Lock()
        rules_groups.set(rules_groups.value + len(self.groups))
        # pre-register watermark lag at 0 per group so the family scrapes
        # from boot (the metrics-parity gate lists it)
        for g in self.groups:
            get_gauge("filodb_rules_watermark_lag_seconds",
                      {"group": g.name}).set(0.0)
        # cache-consistency hook: clamp the result cache's immutability
        # horizon to what the rules have verifiably written (module doc)
        svc.rules_horizon_floor = self.horizon_floor

    # ------------------------------------------------------------ clock

    def horizon_ms(self) -> int | None:
        """Ingest-progress clock: the result cache's horizon."""
        shards = self.svc.memstore.shards
        if not shards:
            return None
        max_ts = min((s.max_ingested_ts for s in shards), default=-1)
        if max_ts < 0:
            return None
        return max_ts - self.ooo_allowance_ms

    def horizon_floor(self) -> int:
        """Min over groups of the last shard-visible committed step.

        Lock-free: the value is republished as a plain int at every
        commit (a single attribute store/load is atomic in CPython), so
        the result cache's per-query call can never block behind an
        in-flight evaluation or catch-up."""
        return self._floor

    def _publish_floor(self, horizon: int) -> None:
        """Recompute and publish the cache floor. A group that has not
        recovered yet contributes ``horizon − (max_catchup_steps+1)·
        interval`` — recovery's lookback and the catch-up cap both bound
        how far back its writes can land — rather than the far-negative
        sentinel, so the cache regression before first recovery covers a
        bounded window only."""
        floor = 1 << 62
        unrecovered = 0
        with self._lock:
            for g in self.groups:
                st = self._state[g.name]
                if st.last_step is None:
                    unrecovered += 1
                    floor = min(floor, horizon - (self.max_catchup_steps
                                                  + 1) * g.interval_ms)
                else:
                    floor = min(floor, st.visible_step)
                    # how far the group's evaluation trails the ingest
                    # clock — the per-group freshness gauge
                    get_gauge("filodb_rules_watermark_lag_seconds",
                              {"group": g.name}).set(
                        max(0.0, (horizon - st.last_step) / 1000.0))
        self._floor = floor
        rules_unrecovered_groups.set(unrecovered)

    def _note_no_horizon_locked(self) -> None:
        """No ingest progress yet: nothing to evaluate or recover, but
        surface unrecovered groups so a floor stuck at the sentinel is
        visible instead of a silent cache-efficiency drain. Caller holds
        ``_eval_lock`` (guards ``_stalled_ticks``)."""
        with self._lock:
            unrecovered = sum(1 for g in self.groups
                              if self._state[g.name].last_step is None)
        rules_unrecovered_groups.set(unrecovered)
        if not unrecovered:
            return
        self._stalled_ticks += 1
        if self._stalled_ticks == 10 or self._stalled_ticks % 600 == 0:
            log.warning(
                "rules: no ingest horizon after %d ticks; %d group(s) "
                "unrecovered, cache floor pinned at sentinel until data "
                "flows", self._stalled_ticks, unrecovered)

    # ------------------------------------------------------------- loop

    def start(self, tick_s: float = 1.0) -> "RuleManager":
        """Tick every ``tick_s`` on a thread of its own; a manager already
        started, or stopped, stays as it is."""

        def loop():
            while not self._stop.wait(tick_s):
                try:
                    self.tick()
                except Exception:
                    log.warning("rules tick failed", exc_info=True)

        with self._life_lock:
            if self._thread is not None or not self.groups \
                    or self._stop.is_set():
                return self
            self._thread = threading.Thread(target=loop, daemon=True,
                                            name="rule-manager")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._life_lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if self._notifier is not None:
            self._notifier.close()

    def tick(self) -> int:
        """Evaluate every group over its newly-completed steps; returns
        the number of (rule, step) evaluations performed.

        Queries and sink writes run WITHOUT the state lock: ``_lock`` is
        taken only for the brief commit of each group's watermark and
        alert state, so floor reads and snapshots never wait out a slow
        evaluation. ``_eval_lock`` keeps ticks themselves serial."""
        with self._eval_lock:
            horizon = self.horizon_ms()
            if horizon is None:
                self._note_no_horizon_locked()
                return 0
            self._stalled_ticks = 0
            self._publish_floor(horizon)
            evaluated = 0
            for g in self.groups:
                st = self._state[g.name]
                with self._lock:
                    self._check_visibility(g, st)
                try:
                    evaluated += self._tick_group(g, st, horizon)
                except governor_mod.QueryRejected as e:
                    # shed under pressure: watermark unmoved, the same
                    # window is retried next tick — no skipped extent
                    rules_evals_shed.inc()
                    with self._lock:
                        st.last_error = f"shed: {e}"
                except Exception as e:
                    rules_eval_failures.inc()
                    with self._lock:
                        st.last_error = str(e)
                    log.warning("rule group %s eval failed", g.name,
                                exc_info=True)
            with self._lock:
                self._update_alert_gauges()
            self._publish_floor(horizon)
            return evaluated

    # ------------------------------------------------------ group eval

    def _tick_group(self, g: RuleGroup, st: _GroupState,
                    horizon: int) -> int:
        interval = g.interval_ms
        if horizon < 0:
            return 0
        last_complete = (horizon // interval) * interval
        last_step = st.last_step
        if last_step is None:
            last_step = self._recover(g, st, last_complete)
        if last_complete <= last_step:
            return 0
        first = last_step + interval
        nsteps = (last_complete - first) // interval + 1
        if nsteps > self.max_catchup_steps:
            skipped = nsteps - self.max_catchup_steps
            rules_steps_skipped.inc(skipped * max(1, len(g.rules)))
            log.warning("rule group %s: %d steps behind, skipping %d "
                        "(max_catchup_steps=%d)", g.name, nsteps, skipped,
                        self.max_catchup_steps)
            first = last_complete - (self.max_catchup_steps - 1) * interval
            nsteps = self.max_catchup_steps
        FaultInjector.fire("rules.eval", group=g.name, start=first,
                           end=last_complete)
        t0 = time.perf_counter()
        with traced_operation("rules", group=g.name, steps=nsteps):
            # evaluate ALL rules before writing anything is not possible
            # in bounded memory for wide outputs; instead write per rule
            # and rely on idempotent re-writes, but stage alert-state
            # commits so a mid-group failure retries from clean state
            staged_states: dict[str, tuple[dict, int, list]] = {}
            offsets: dict[int, int] = {}
            for rule in g.rules:
                res = self.svc.query_range(
                    rule.expr, first // 1000, interval // 1000,
                    last_complete // 1000, QueryContext(origin="rules"))
                if res.partial:
                    raise RuntimeError(
                        f"partial result for rule {rule.name}: "
                        f"{'; '.join(res.warnings) or 'unknown'}")
                if isinstance(rule, RecordingRule):
                    samples = self._recording_samples(rule, res)
                else:
                    samples, new_states, transitions, changes = \
                        self._alerting_samples(g, rule, res, first,
                                               interval, last_complete)
                    staged_states[rule.name] = (
                        new_states, transitions,
                        notify.events_from_transitions(
                            g.name, rule.annotations, changes))
                FaultInjector.fire("rules.write", group=g.name,
                                   rule=rule.name, count=len(samples))
                if samples:
                    n, offs = self.sink.write(self._container(samples))
                    rules_samples_written.inc(n)
                    for s, o in offs.items():
                        offsets[s] = max(offsets.get(s, -1), o)
            # commit record: one watermark sample at the window's last
            # step — written only after every rule's outputs
            _, offs = self.sink.write(self._container([(
                dict(self.default_labels,
                     _metric_=WATERMARK_METRIC, group=g.name),
                last_complete, last_complete / 1000.0)]))
            for s, o in offs.items():
                offsets[s] = max(offsets.get(s, -1), o)
        notify_events: list = []
        with self._lock:
            st.last_step = last_complete
            for name, (states, transitions, events) in \
                    staged_states.items():
                st.alert_states[name] = states
                if transitions:
                    # counted only here: a discarded stage (failed or
                    # shed group) re-evaluates the same window next tick
                    # and must not double-count its transitions or
                    # re-notify them
                    alerts_transitions.inc(transitions)
                    notify_events.extend(events)
            if offsets:
                if st.visible_step == _UNRECOVERED:
                    # fresh start over a WAL sink: nothing was ever
                    # written at or below the resume point, which
                    # bounds the floor until the offsets are consumed
                    st.visible_step = last_step
                st.pending_offsets = offsets
                st.pending_step = last_complete
                self._check_visibility(g, st)
            else:
                st.visible_step = last_complete
            st.last_error = ""
            st.last_eval_wall = time.time()
            st.last_eval_duration = time.perf_counter() - t0
        # notification hand-off OUTSIDE _lock: submit() is a bounded
        # put_nowait, and the webhook POST runs on the notifier's worker
        if self._notifier is not None and notify_events:
            self._notifier.submit(notify_events)
        rules_evals.inc()
        rules_steps_evaluated.inc(nsteps * len(g.rules))
        rules_eval_seconds.observe(st.last_eval_duration)
        get_gauge("filodb_rules_last_eval_ts",
                  {"group": g.name}).set(last_complete / 1000.0)
        return nsteps * len(g.rules)

    def _check_visibility(self, g: RuleGroup, st: _GroupState) -> None:
        """Advance the cache-floor watermark once WAL-appended outputs
        have been consumed by the shards (LogSink); MemstoreSink writes
        are visible immediately and never stage pending offsets."""
        if st.pending_step is None:
            return
        for shard_num, off in st.pending_offsets.items():
            shard = self.svc.memstore.shards[shard_num]
            if shard.latest_offset < off:
                return
        st.visible_step = st.pending_step
        st.pending_step = None
        st.pending_offsets = {}

    # -------------------------------------------------------- recovery

    def _recover(self, g: RuleGroup, st: _GroupState,
                 last_complete: int) -> int:
        """Resume the group from its durable commit record; returns the
        watermark step to resume after. A recovered marker is committed
        to group state immediately (outputs through it are durably
        written); a FRESH START is not — its resume point carries no
        recorded data, so it must not surface as a snapshot watermark
        until the first window's outputs commit.

        ``max_over_time(marker[interval])`` windows are (t−i, t] — each
        step sees exactly the marker sample written AT that step, so
        selector lookback (300s staleness) cannot overstate the
        watermark and cause skipped extents. The watermark is taken from
        the last non-NaN step's POSITION (int64 ms, exact), never from
        the sample value: query materialization is float32, which cannot
        represent epoch seconds exactly."""
        interval = g.interval_ms
        lookback = min(self.max_catchup_steps, 10_000)
        start = max(0, last_complete - (lookback - 1) * interval)
        wm = None
        if last_complete >= 0:
            q = (f'max_over_time({WATERMARK_METRIC}'
                 f'{{group={_q(g.name)}}}[{g.interval_s}s])')
            res = self.svc.query_range(q, start // 1000, interval // 1000,
                                       last_complete // 1000,
                                       QueryContext(origin="rules"))
            m = res.result
            if m.num_series:
                vals = np.asarray(m.values, dtype=float)
                # fmax ignores NaN without the all-NaN-slice warning
                best = np.fmax.reduce(vals, axis=0)
                idx = np.where(~np.isnan(best))[0]
                if idx.size:
                    wm = int(np.asarray(m.steps_ms)[idx[-1]])
        if wm is None:
            fresh = last_complete - interval
            log.info("rule group %s: fresh start at %d", g.name, fresh)
            return fresh
        recovered = {rule.name: self._recover_alert_states(g, rule, wm)
                     for rule in g.rules if isinstance(rule, AlertingRule)}
        with self._lock:
            st.last_step = wm
            st.visible_step = wm
            st.alert_states.update(recovered)
        log.info("rule group %s: recovered watermark %d", g.name, wm)
        return wm

    def _recover_alert_states(self, g: RuleGroup, rule: AlertingRule,
                              wm: int) -> dict:
        """``ALERTS_FOR_STATE`` values are SECONDS-ACTIVE at the sample's
        own step (not the activation timestamp, which float32 query
        materialization could not carry exactly); the activation time is
        reconstructed as ``wm − value``. The selector is scoped by the
        ``_group_`` stamp the evaluator puts on every for-state sample:
        an equally-named alert in another group (or a leftover series
        from a deleted rule elsewhere) must not resurrect here."""
        q = (f'max_over_time({ALERTS_FOR_STATE_METRIC}'
             f'{{alertname={_q(rule.name)},_group_={_q(g.name)}}}'
             f'[{g.interval_s}s])')
        res = self.svc.query_range(q, wm // 1000, g.interval_s, wm // 1000,
                                   QueryContext(origin="rules"))
        m = res.result
        states: dict = {}
        for i, key in enumerate(m.keys):
            v = float(np.asarray(m.values)[i, -1])
            if math.isnan(v):
                continue
            active_since = wm - int(round(v)) * 1000
            labels = tuple(sorted(
                (k, val) for k, val in key.labels
                if k not in ("_metric_", "_group_")))
            states[labels] = AlertState(
                active_since_ms=active_since,
                firing=(wm - active_since) >= rule.for_ms,
                value=float("nan"))
        return states

    # ------------------------------------------------------- rule eval

    def _output_labels(self, rule, series_labels) -> dict[str, str]:
        # _group_ is system-owned (the for-state recovery scope stamp)
        # and never flows from inputs to outputs
        out = {k: v for k, v in series_labels
               if k not in ("_metric_", "_group_")}
        out.update(rule.labels)
        for k, v in self.default_labels.items():
            out.setdefault(k, v)
        return out

    def _recording_samples(self, rule: RecordingRule, res) -> list:
        m = res.result
        if m.num_series == 0:
            return []
        vals = np.asarray(m.values, dtype=float)
        if vals.ndim != 2:
            raise ValueError(f"rule {rule.name}: histogram-shaped output "
                             f"cannot be recorded")
        steps = np.asarray(m.steps_ms)
        samples = []
        for i, key in enumerate(m.keys):
            labels = self._output_labels(rule, key.labels)
            labels["_metric_"] = rule.record
            row = vals[i]
            for j in np.where(~np.isnan(row))[0]:
                samples.append((labels, int(steps[j]), float(row[j])))
        return samples

    def _alerting_samples(self, g: RuleGroup, rule: AlertingRule, res,
                          first: int, interval: int, last: int):
        """Run the inactive→pending→firing state machine over the new
        steps; returns (samples, new_states, transitions, changes) with
        state — and the transition count plus the notification change
        list — committed by the caller only after the group's writes all
        succeed. ``changes`` entries are
        ``(labels_key, state, value, active_since_ms, ts_ms)``."""
        m = res.result
        vals = np.asarray(m.values, dtype=float) if m.num_series else None
        if vals is not None and vals.ndim != 2:
            raise ValueError(f"alert {rule.name}: histogram-shaped output "
                             f"is not a valid alert condition")
        keys = []
        if m.num_series:
            for key in m.keys:
                labels = self._output_labels(rule, key.labels)
                labels["alertname"] = rule.name
                keys.append(tuple(sorted(labels.items())))
        states = {k: replace(v) for k, v in
                  self._state[g.name].alert_states.get(rule.name,
                                                       {}).items()}
        steps = np.asarray(m.steps_ms) if m.num_series else np.arange(
            first, last + interval, interval, dtype=np.int64)
        samples = []
        transitions = 0
        changes: list = []
        for j, ts in enumerate(int(t) for t in steps):
            active: dict = {}
            if vals is not None:
                col = vals[:, j]
                for i, k in enumerate(keys):
                    if not math.isnan(col[i]):
                        active[k] = float(col[i])
            for k, v in active.items():
                stt = states.get(k)
                if stt is None:
                    states[k] = stt = AlertState(active_since_ms=ts,
                                                 firing=False, value=v)
                    transitions += 1  # inactive -> pending
                    changes.append((k, notify.PENDING, v, ts, ts))
                stt.value = v
                firing = (ts - stt.active_since_ms) >= rule.for_ms
                if firing and not stt.firing:
                    transitions += 1  # pending -> firing
                    changes.append((k, notify.FIRING, v,
                                    stt.active_since_ms, ts))
                stt.firing = firing
            for k in [k for k in states if k not in active]:
                prev = states.pop(k)
                transitions += 1  # -> inactive
                changes.append((k, notify.RESOLVED, prev.value,
                                prev.active_since_ms, ts))
            for k, stt in states.items():
                labels = dict(k)
                alert_labels = dict(labels)
                alert_labels["_metric_"] = ALERTS_METRIC
                alert_labels["alertstate"] = ("firing" if stt.firing
                                              else "pending")
                samples.append((alert_labels, ts, 1.0))
                for_labels = dict(labels)
                for_labels["_metric_"] = ALERTS_FOR_STATE_METRIC
                # recovery scope stamp: restart filters for-state by
                # {alertname, _group_} so same-named alerts in other
                # groups cannot cross-contaminate recovered state
                for_labels["_group_"] = g.name
                # seconds-active at this step: small enough to survive
                # float32 query materialization exactly (epoch seconds
                # would not); recovery computes wm − value
                samples.append((for_labels, ts,
                                (ts - stt.active_since_ms) / 1000.0))
        return samples, states, transitions, changes

    @staticmethod
    def _container(samples) -> RecordContainer:
        cont = RecordContainer()
        for labels, ts, v in samples:
            cont.add(IngestRecord(PartKey.create("gauge", labels), ts,
                                  (v,)))
        return cont

    def _update_alert_gauges(self) -> None:
        firing = pending = 0
        for g in self.groups:
            for states in self._state[g.name].alert_states.values():
                for stt in states.values():
                    if stt.firing:
                        firing += 1
                    else:
                        pending += 1
        alerts_firing.set(firing)
        alerts_pending.set(pending)

    # ------------------------------------------------------- snapshots

    def rules_snapshot(self) -> list[dict]:
        """Prom-compat ``/api/v1/rules`` group payloads."""
        out = []
        with self._lock:
            for g in self.groups:
                st = self._state[g.name]
                rules = []
                for rule in g.rules:
                    base = {
                        "name": rule.name,
                        "query": rule.expr,
                        "labels": dict(rule.labels),
                        "health": "err" if st.last_error else "ok",
                        "lastError": st.last_error,
                        "evaluationTime": st.last_eval_duration,
                        "lastEvaluation": st.last_eval_wall,
                    }
                    if isinstance(rule, RecordingRule):
                        base["type"] = "recording"
                    else:
                        base["type"] = "alerting"
                        base["duration"] = rule.for_ms / 1000.0
                        base["annotations"] = dict(rule.annotations)
                        base["alerts"] = self._alert_payloads(g, rule)
                    rules.append(base)
                out.append({
                    "name": g.name,
                    "interval": g.interval_s,
                    "dataset": g.dataset,
                    "watermark": st.last_step,
                    "rules": rules,
                })
        return out

    def alerts_snapshot(self) -> list[dict]:
        """Prom-compat ``/api/v1/alerts`` payloads (active only)."""
        out = []
        with self._lock:
            for g in self.groups:
                for rule in g.rules:
                    if isinstance(rule, AlertingRule):
                        out.extend(self._alert_payloads(g, rule))
        return out

    def _alert_payloads(self, g: RuleGroup, rule: AlertingRule) -> list:
        states = self._state[g.name].alert_states.get(rule.name, {})
        out = []
        for labels, stt in sorted(states.items()):
            out.append({
                "labels": dict(labels),
                "annotations": dict(rule.annotations),
                "state": "firing" if stt.firing else "pending",
                "activeAt": stt.active_since_ms / 1000.0,
                "value": (None if math.isnan(stt.value)
                          else str(stt.value)),
            })
        return out
