"""Continuous shard replication: follower tails, in-sync watermarks,
hedged replica reads, divergence checks.

Port of ``filodb_tpu/coordinator/replication.py`` (``:30-512``). A
``ReplicaSyncer`` runs a follower of one shard on one in-process member:
its ``_FollowerTail`` thread bootstraps the member's image of the shard
from the durable tier (as a migration's destination recovers: the
store's view refreshed, the index recovered, the group checkpoints
read), then tails the shard's log into it, on the member's card, and
publishes FOLLOWING / IN_SYNC / LAGGING and the applied offset through
the ``ShardManager``. A follower never writes the durable tier (no
flush, no checkpoint, no log truncation); every ``durable_sync_s`` it
applies the segments the leader sealed since (``sync_shard``).

Failover is a map flip: ``ShardManager.remove_member`` promotes the
highest-watermark in-sync follower with one sequenced ACTIVE event, and
``Node.promote_shard`` starts the ingest worker at the follower's applied
offset, with no store read. Reads go to any in-sync replica through
``ReplicaDispatcher``: candidates in EWMA latency order (unknown keeps
the leader first), an open breaker's to the back, the next one launched
when the hedge timer fires or the running one fails, the first answer
winning. ``check_replicas`` and ``assert_no_divergence`` hold followers
against their leaders. The five metric families register at import.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass, field

from filodb_tpu_torch.coordinator.shardmapper import ShardStatus
from filodb_tpu_torch.kafka.log_server import LogOpError
from filodb_tpu_torch.query.exec.plan import PlanDispatcher
from filodb_tpu_torch.utils.metrics import (
    GaugeFn,
    get_counter,
    get_gauge,
)
from filodb_tpu_torch.utils.resilience import (
    CircuitOpenError,
    FaultInjector,
    breaker_for,
    peer_latency,
    record_peer_latency,
)

log = logging.getLogger(__name__)

# registered at import so the families render at zero before any replica
# exists (cluster.py imports this module; standalone imports cluster)
PROMOTIONS = get_counter(
    "filodb_replica_promotions",
    help="in-sync followers promoted to shard leader")
DIVERGENCE = get_counter(
    "filodb_replica_divergence",
    help="leader/follower state mismatches found by replicacheck")
FOLLOWER_READS = get_counter(
    "filodb_replica_follower_reads",
    help="read dispatches served by a follower replica")
HEDGED = get_counter(
    "filodb_hedged_reads",
    help="hedge requests launched onto a second replica")
HEDGED_WON = get_counter(
    "filodb_hedged_reads_won",
    help="hedge requests that returned before the primary")
# untagged family anchors; runtime series carry dataset/shard/node tags
get_gauge("filodb_replica_lag",
          help="log records behind the leader, per follower replica")
get_gauge("filodb_replica_watermark",
          help="follower applied log offset, per replica")


class _FollowerTail(threading.Thread):
    """Per-replica tail thread: bootstrap the follower image from the
    durable tier, then tail the shard's WAL into it (a read-only
    ``_IngestWorker`` sibling — never registered with the node's flush
    scheduler, so the follower neither flushes nor checkpoints nor
    truncates the shared log)."""

    # consecutive deterministic log errors tolerated before the replica
    # drops to LAGGING and the tail backs off (mirror of _IngestWorker)
    MAX_SERVER_ERRORS = 5

    def __init__(self, syncer: "ReplicaSyncer",
                 poll_interval: float = 0.01,
                 durable_sync_interval_s: float = 5.0):
        super().__init__(daemon=True,
                         name=f"replica-{syncer.dataset}-{syncer.shard_num}"
                              f"@{syncer.node.name}")
        self.syncer = syncer
        self.poll_interval = poll_interval
        self.durable_sync_interval_s = durable_sync_interval_s
        self._stop_ev = threading.Event()
        self._last_durable_sync = 0.0
        self._last_report = 0.0

    def run(self):
        sy = self.syncer
        # the bootstrap's cold load IS the first durable sync — start the
        # cadence clock here so the first loop pass doesn't re-GET the
        # manifest it just read
        self._last_durable_sync = time.monotonic()
        try:
            sy._bootstrap()
        except Exception:
            log.exception("replica bootstrap failed for %s/%d on %s",
                          sy.dataset, sy.shard_num, sy.node.name)
            sy._report(ShardStatus.LAGGING)
            return
        sy._report(ShardStatus.FOLLOWING)
        server_errors = 0
        while not self._stop_ev.is_set() and sy.node.alive:
            try:
                FaultInjector.fire("replica.tail", node=sy.node.name,
                                   dataset=sy.dataset, shard=sy.shard_num)
            except Exception:
                sy._report(ShardStatus.LAGGING)
                self._stop_ev.wait(min(self.poll_interval * 100, 1.0))
                continue
            progressed = False
            it = sy.log.read_from(sy.applied + 1)
            failed = False
            while True:
                try:
                    sd = next(it)
                except StopIteration:
                    server_errors = 0
                    break
                except LogOpError:
                    server_errors += 1
                    if server_errors >= self.MAX_SERVER_ERRORS:
                        log.error("replica %s/%d@%s: persistent log "
                                  "errors; marking LAGGING", sy.dataset,
                                  sy.shard_num, sy.node.name, exc_info=True)
                        sy._report(ShardStatus.LAGGING)
                        server_errors = 0
                    self._stop_ev.wait(min(self.poll_interval * 100, 1.0))
                    failed = True
                    break
                except (ConnectionError, OSError, RuntimeError):
                    self._stop_ev.wait(min(self.poll_interval * 100, 1.0))
                    failed = True
                    break
                if self._stop_ev.is_set() or not sy.node.alive:
                    return
                try:
                    sy.shard.ingest(sd)
                except Exception:
                    # poison record: the LEADER surfaces it; the follower
                    # just stops advancing and shows LAGGING
                    log.exception("replica %s/%d@%s ingest failed at "
                                  "offset %d", sy.dataset, sy.shard_num,
                                  sy.node.name, sd.offset)
                    sy._report(ShardStatus.LAGGING)
                    return
                sy.applied = sd.offset
                progressed = True
                server_errors = 0
            if failed:
                continue
            now = time.monotonic()
            # sealed-segment tail: keep the follower's durable-tier view
            # (and its segment sequence) current, off the hot loop
            if now - self._last_durable_sync >= self.durable_sync_interval_s:
                self._last_durable_sync = now
                sy._sync_durable()
            if progressed or now - self._last_report >= 0.1:
                self._last_report = now
                sy._report_lag()
            if not progressed:
                # interruptible idle wait: a promotion (stop + join) must
                # not sit out the poll interval — failover handoff latency
                # is bounded by this wait
                self._stop_ev.wait(self.poll_interval)

    def stop(self):
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout=5)


@dataclass
class ReplicaSyncer:
    """One follower replica of one shard: owns the bootstrap, the WAL
    tail thread, and the replica-state reporting. Created and tracked by
    ``FilodbCluster.ensure_replicas``; ``promote()`` hands the warm image
    to ``Node.promote_shard`` on failover."""

    node: object                      # follower Node (in-process)
    dataset: str
    shard_num: int
    config: object                    # IngestionConfig
    log: object                       # the shard's ReplayLog
    sm: object                        # ShardManager
    in_sync_lag: int = 0              # max offset lag still counted in-sync
    spread: int = 1                   # the dataset's (the image's store)
    poll_interval: float = 0.01
    durable_sync_interval_s: float = 5.0
    applied: int = -1                 # last WAL offset applied (watermark)
    shard: object = None              # follower's memstore shard image
    _tail: _FollowerTail | None = None
    _status: ShardStatus | None = None
    _was_in_sync: bool = False
    _lock: object = field(init=False, repr=False, default=None)

    def __post_init__(self):
        self._lock = threading.Lock()

    def start(self) -> "ReplicaSyncer":
        """Launch the tail thread (bootstrap runs on it, so membership
        threads never block on durable-tier reads)."""
        if self._tail is None:
            self._tail = _FollowerTail(
                self, self.poll_interval, self.durable_sync_interval_s)
            self._tail.start()
        return self

    def _bootstrap(self) -> None:
        """The follower's image, built as a migration's destination is:
        the store's view refreshed, the index recovered, the group
        checkpoints read; the tail then starts at the smallest one (rows
        at or below a group's watermark are skipped, as on a restart)."""
        refresh = getattr(self.node.column_store, "refresh_shard", None)
        if callable(refresh):
            refresh(self.dataset, self.shard_num)
        ms = self.node.setup_dataset(self.config, self.spread)
        self.shard = ms.shards[self.shard_num]
        self.shard.recover_index()
        self.applied = self.shard.setup_watermarks_for_recovery()
        tags = {"dataset": self.dataset, "shard": str(self.shard_num),
                "node": self.node.name}
        GaugeFn("filodb_replica_lag",
                lambda: float(self.log.offset_lag(self.applied))
                if self._tail is not None else None, tags)
        GaugeFn("filodb_replica_watermark",
                lambda: float(self.applied)
                if self._tail is not None else None, tags)

    def _sync_durable(self) -> None:
        """Apply newly-sealed segments to the follower's durable-tier
        view (objectstore ``sync_shard`` — incremental, GETs only unseen
        segments). No-op on backends without the API."""
        sync = getattr(self.node.column_store, "sync_shard", None)
        if not callable(sync):
            return
        try:
            sync(self.dataset, self.shard_num)
        except Exception:
            log.warning("durable sync failed for replica %s/%d@%s",
                        self.dataset, self.shard_num, self.node.name,
                        exc_info=True)

    def _report_lag(self) -> None:
        lag = self.log.offset_lag(self.applied)
        if lag <= self.in_sync_lag:
            self._was_in_sync = True
            self._report(ShardStatus.IN_SYNC)
        elif self._was_in_sync:
            self._report(ShardStatus.LAGGING)
        else:
            self._report(ShardStatus.FOLLOWING)

    def _report(self, status: ShardStatus) -> None:
        with self._lock:
            if self._tail is None:
                return  # stopped/promoted: never resurrect the entry
            self._status = status
        try:
            self.sm.replica_update(self.shard_num, self.node.name, status,
                                   watermark=self.applied)
        except Exception:
            log.exception("replica state publish failed for %s/%d@%s",
                          self.dataset, self.shard_num, self.node.name)

    @property
    def status(self) -> ShardStatus | None:
        return self._status

    def stop(self) -> None:
        """Stop tailing. The memstore image is left in place — a promotion
        or a rejoin-as-follower reuses it warm."""
        with self._lock:
            tail, self._tail = self._tail, None
        if tail is not None:
            tail.stop()

    def promote(self) -> int:
        """Failover handoff: stop the tail and return the applied offset —
        the exact point ``Node.promote_shard`` resumes ingestion from."""
        self.stop()
        return self.applied


@dataclass
class ReplicaCandidate:
    """One routing choice for a shard read: a dispatcher plus the
    breaker/latency key it is accounted under. ``guard`` wraps the call in
    this breaker (in-process dispatchers have none of their own);
    ``RemotePlanDispatcher`` already breaker-guards per peer."""

    key: str
    dispatcher: PlanDispatcher
    follower: bool = False
    guard: bool = True


class ReplicaDispatcher(PlanDispatcher):
    """Read-path scatter over a shard's replica set.

    Candidates (leader first, then in-sync followers) are ordered by EWMA
    dispatch latency; candidates with open breakers drop to the back.
    The best candidate runs first; when its hedge timer fires before it
    returns — or it fails outright — the next candidate is launched and
    the first success wins. Writes never route here: ingestion targets
    the leader's log, and followers are read-only by construction."""

    def __init__(self, shard: int, candidates: list[ReplicaCandidate],
                 hedge_timeout_s: float = 0.05):
        self.shard = shard
        self.candidates = candidates
        self.hedge_timeout_s = hedge_timeout_s

    def _ordered(self) -> list[ReplicaCandidate]:
        def lat(c):
            v = peer_latency(c.key)
            # unknown latency keeps construction order (leader first)
            return (v is None, v or 0.0)
        by_latency = sorted(self.candidates, key=lat)
        closed = [c for c in by_latency if not breaker_for(c.key).is_open]
        opened = [c for c in by_latency if breaker_for(c.key).is_open]
        return closed + opened

    def _call(self, cand: ReplicaCandidate, plan, ctx):
        FaultInjector.fire("replica.dispatch", node=cand.key,
                           shard=self.shard)
        if dataclasses.is_dataclass(plan):
            # the plan goes out naming the candidate's dispatcher: this
            # one has no wire form, and a remote candidate would fail to
            # encode it (ROADMAP §C.16)
            plan = dataclasses.replace(plan, dispatcher=cand.dispatcher)
        t0 = time.perf_counter()
        if cand.guard:
            with breaker_for(cand.key).calling():
                result = cand.dispatcher.dispatch(plan, ctx)
        else:
            result = cand.dispatcher.dispatch(plan, ctx)
        record_peer_latency(cand.key, time.perf_counter() - t0)
        if cand.follower:
            FOLLOWER_READS.inc()
        return result

    def dispatch(self, plan, ctx):
        order = self._ordered()
        if not order:
            raise ConnectionError(
                f"shard {self.shard}: no live replica to dispatch to")
        if len(order) == 1:
            return self._call(order[0], plan, ctx)
        cond = threading.Condition()
        state = {"result": None, "won": None, "errors": [], "launched": 0,
                 "finished": 0}

        def run(cand, hedged):
            try:
                r = self._call(cand, plan, ctx)
            except Exception as e:
                with cond:
                    state["finished"] += 1
                    state["errors"].append(e)
                    cond.notify_all()
                return
            with cond:
                state["finished"] += 1
                if state["won"] is None:
                    state["won"] = cand
                    state["result"] = r
                    if hedged:
                        HEDGED_WON.inc()
                cond.notify_all()

        def launch(i, hedged):
            state["launched"] += 1
            threading.Thread(
                target=run, args=(order[i], hedged), daemon=True,
                name=f"replica-read-{self.shard}-{order[i].key}").start()

        with cond:
            launch(0, False)
            next_i = 1
            while True:
                settled = (lambda: state["won"] is not None
                           or state["finished"] >= state["launched"])
                timeout = self.hedge_timeout_s \
                    if next_i < len(order) else None
                timer_fired = not cond.wait_for(settled, timeout=timeout)
                if state["won"] is not None:
                    return state["result"]
                all_failed = state["finished"] >= state["launched"]
                if next_i < len(order) and (timer_fired or all_failed):
                    # timer → a hedge (primary still in flight);
                    # failure → plain failover, not counted as hedged
                    hedged = not all_failed
                    if hedged:
                        HEDGED.inc()
                    launch(next_i, hedged)
                    next_i += 1
                    continue
                if all_failed and next_i >= len(order):
                    errors = state["errors"]
                    for e in errors:
                        if not isinstance(e, CircuitOpenError):
                            raise e
                    raise errors[-1]


# ---------------------------------------------------------------------------
# divergence checks (the chaos tests' teardown gate)


def check_replicas(cluster, dataset: str, max_lag: int = 0) -> list[dict]:
    """Compare each shard's leader against its follower images. A
    follower counts as divergent when its applied offset trails the
    leader's covered offset by more than ``max_lag``, or — once fully
    caught up — when its ``max_ingested_ts`` / partition count disagree
    with the leader's. Raw ``data_version`` is deliberately NOT compared:
    a follower only replays rows above its recovered watermark, so its
    ingest counters legitimately differ. Each divergence increments
    ``filodb_replica_divergence_total``."""
    from filodb_tpu_torch.coordinator.cluster import Node

    issues = []
    sm = cluster.shard_managers.get(dataset)
    if sm is None:
        return issues
    for shard in range(sm.num_shards):
        owner = sm.mapper.node_for(shard)
        leader = cluster.nodes.get(owner) if owner else None
        if not isinstance(leader, Node) or dataset not in leader.memstores:
            continue
        lshard = leader.memstores[dataset].shards[shard]
        covered = leader.shard_offset(dataset, shard)
        for name, st in sm.mapper.replicas_of(shard).items():
            if st.status != ShardStatus.IN_SYNC:
                continue
            follower = cluster.nodes.get(name)
            if not isinstance(follower, Node):
                continue
            if dataset not in follower.memstores:
                issues.append({"shard": shard, "follower": name,
                               "kind": "missing_image"})
                continue
            fshard = follower.memstores[dataset].shards[shard]
            sy = cluster.replica_syncers.get((dataset, shard, name))
            applied = sy.applied if sy is not None else st.watermark
            if covered - applied > max_lag:
                issues.append({"shard": shard, "follower": name,
                               "kind": "watermark_lag",
                               "leader_offset": covered,
                               "follower_offset": applied})
                continue
            if applied >= covered:
                # a follower whose image came entirely from the durable
                # tier (every WAL row below its recovered watermark) has
                # ingested nothing this process lifetime: its -1 high-water
                # ts is not comparable, and its state trivially equals the
                # leader's flushed state
                if fshard.max_ingested_ts >= 0 and \
                        fshard.max_ingested_ts != lshard.max_ingested_ts:
                    issues.append({
                        "shard": shard, "follower": name,
                        "kind": "max_ingested_ts",
                        "leader": lshard.max_ingested_ts,
                        "follower_value": fshard.max_ingested_ts})
                if fshard.num_partitions != lshard.num_partitions:
                    issues.append({
                        "shard": shard, "follower": name,
                        "kind": "num_partitions",
                        "leader": lshard.num_partitions,
                        "follower_value": fshard.num_partitions})
    DIVERGENCE.inc(len(issues))
    return issues


def assert_no_divergence(cluster, dataset: str, timeout_s: float = 10.0,
                         max_lag: int = 0) -> None:
    """Chaos-test teardown gate: wait for follower tails to drain, then
    assert zero divergence (the replication analog of a filolint pass)."""
    deadline = time.monotonic() + timeout_s
    issues = check_replicas(cluster, dataset, max_lag)
    while issues and time.monotonic() < deadline:
        time.sleep(0.05)
        issues = check_replicas(cluster, dataset, max_lag)
    assert not issues, f"replica divergence in {dataset}: {issues}"


__all__ = [
    "ReplicaCandidate",
    "ReplicaDispatcher",
    "ReplicaSyncer",
    "assert_no_divergence",
    "check_replicas",
]
