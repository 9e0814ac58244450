"""Shard → node routing table with each shard's status and follower
replica set, and each dataset's shard assignment across members.

Port of ``filodb_tpu/coordinator/shardmapper.py`` (``ShardStatus`` with
the follower states ``FOLLOWING``, ``IN_SYNC`` and ``LAGGING`` and the
migration's ``HANDOFF``; ``ShardEvent`` with ``replica`` and
``watermark``; ``ReplicaState``; ``ShardMapper`` with a follower set a
shard beside its leader slot) and of ``filodb_tpu/coordinator/
shard_manager.py``: ``ShardManager`` assigns unassigned shards to
members through ``DefaultShardAssignmentStrategy`` (least loaded first,
at most ceil(shards / max(members, min_num_nodes)) a member, existing
assignments kept). A lost member's follower roles stop with it; each of
its shards goes to its highest-watermark in-sync follower still a member
(``promote``: one sequenced ACTIVE event, no DOWN window), or else DOWN,
and is reassigned once at least ``min_num_nodes`` members remain (a
shard inside ``reassignment_min_interval_s`` of its last reassignment
waits in ``_deferred`` for ``check_deferred``, which skips a shard a
promotion owns meanwhile and promotes a follower caught up meanwhile).
``adopt`` and ``rebalance`` serve a promoted coordinator; ``plan_rebalance``
proposes the live migrations that level ACTIVE shard counts (or shed a
pressured node's); ``begin_handoff``, ``complete_handoff`` and
``abort_handoff`` are a migration's map events; ``replica_update`` and
``drop_replica`` a follower's (a watermark-only change updates in place,
unsequenced). Events apply to the mapper in order, under a lock, and go
to a sequenced log: ``events_since`` hands a member's mirror the events
after its last sequence, or the whole map with its replica sets (a
resync) where it fell behind the log's window, ran ahead of it, or names
another epoch (the coordinator restarted); ``subscribe`` replays the map
to a new subscriber, then each event. A ``ShardMapper`` and a
``ShardManager`` register with the race sanitizer (``utils/racecheck``),
as the reference's do.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field

from filodb_tpu_torch.utils import racecheck
from filodb_tpu_torch.utils.metrics import get_counter

log = logging.getLogger(__name__)


class ShardStatus(enum.Enum):
    UNASSIGNED = "unassigned"
    ASSIGNED = "assigned"
    ACTIVE = "active"
    RECOVERY = "recovery"
    # a live migration in flight: the source still owns and serves the
    # shard; the owner changes only at the flip's ACTIVE event
    HANDOFF = "handoff"
    ERROR = "error"
    STOPPED = "stopped"
    DOWN = "down"
    # a follower's states (coordinator/replication.py), kept in the
    # shard's follower set, never in its leader slot
    FOLLOWING = "following"
    IN_SYNC = "in_sync"
    LAGGING = "lagging"

    @property
    def queryable(self) -> bool:
        return self in (ShardStatus.ACTIVE, ShardStatus.RECOVERY,
                        ShardStatus.HANDOFF)

    @property
    def is_replica(self) -> bool:
        return self in (ShardStatus.FOLLOWING, ShardStatus.IN_SYNC,
                        ShardStatus.LAGGING)


@dataclass
class ShardEvent:
    shard: int
    status: ShardStatus
    node: str | None = None
    progress: int = 0  # recovery progress percent
    # a replica event changes the shard's follower set, not its leader:
    # FOLLOWING / IN_SYNC / LAGGING upsert the (shard, node) entry,
    # UNASSIGNED / DOWN / STOPPED remove it
    replica: bool = False
    watermark: int = -1  # the follower's applied log offset


@dataclass
class ReplicaState:
    """One follower of a shard: its status and the log offset it has
    applied (held against the leader's for in-sync)."""

    status: ShardStatus
    watermark: int = -1


@dataclass
class ShardMapper:
    num_shards: int
    statuses: list[ShardStatus] = field(default_factory=list)
    owners: list[str | None] = field(default_factory=list)
    # a shard's followers: node → ReplicaState, beside the leader slot so
    # their churn never moves routing
    replicas: list[dict[str, ReplicaState]] = field(default_factory=list)

    def __post_init__(self):
        if self.num_shards & (self.num_shards - 1):
            raise ValueError("num_shards must be a power of 2")
        if not self.statuses:
            self.statuses = [ShardStatus.UNASSIGNED] * self.num_shards
            self.owners = [None] * self.num_shards
        if not self.replicas:
            self.replicas = [{} for _ in range(self.num_shards)]
        # routing table read by every query/ingest thread, written by
        # membership and migration events
        racecheck.register(self, "ShardMapper")

    def apply(self, ev: ShardEvent) -> None:
        if ev.replica:
            if ev.node is None:
                return
            if ev.status in (ShardStatus.UNASSIGNED, ShardStatus.DOWN,
                             ShardStatus.STOPPED):
                self.replicas[ev.shard].pop(ev.node, None)
            else:
                self.replicas[ev.shard][ev.node] = ReplicaState(
                    ev.status, ev.watermark)
            return
        self.statuses[ev.shard] = ev.status
        if ev.node is not None or ev.status in (ShardStatus.UNASSIGNED,
                                                ShardStatus.DOWN):
            self.owners[ev.shard] = ev.node
        if ev.node is not None:
            # a node taking the lead (a promotion, a handoff's flip) is no
            # longer a follower of its own shard
            self.replicas[ev.shard].pop(ev.node, None)

    def node_for(self, shard: int) -> str | None:
        return self.owners[shard]

    def shards_of(self, node: str) -> list[int]:
        return [s for s, o in enumerate(self.owners) if o == node]

    def active_shards(self) -> list[int]:
        return [s for s, st in enumerate(self.statuses) if st.queryable]

    def unassigned_shards(self) -> list[int]:
        return [s for s, o in enumerate(self.owners) if o is None]

    def all_queryable(self, shards: list[int]) -> bool:
        return all(self.statuses[s].queryable for s in shards)

    def replicas_of(self, shard: int) -> dict[str, ReplicaState]:
        return dict(self.replicas[shard])

    def in_sync_followers(self, shard: int) -> list[str]:
        """Followers within the in-sync lag: the promotion candidates and
        the reads' alternates."""
        return [n for n, st in list(self.replicas[shard].items())
                if st.status == ShardStatus.IN_SYNC]

    def follower_shards(self, node: str) -> list[int]:
        """The shards ``node`` holds a follower of."""
        return [s for s in range(self.num_shards)
                if node in self.replicas[s]]

    def snapshot(self) -> list[dict]:
        out = []
        for s in range(self.num_shards):
            entry = {"shard": s, "status": self.statuses[s].value,
                     "node": self.owners[s]}
            if self.replicas[s]:
                entry["replicas"] = [
                    {"node": n, "status": st.status.value,
                     "watermark": st.watermark}
                    for n, st in sorted(self.replicas[s].items())]
            out.append(entry)
        return out


class DefaultShardAssignmentStrategy:
    """Unassigned shards to the least loaded members with room, at most
    ceil(num_shards / max(members, min_num_nodes)) a member, so early
    joiners leave room for the cluster's expected size; existing
    assignments stay."""

    def assignments(self, mapper: ShardMapper, nodes: list[str],
                    min_num_nodes: int = 1) -> dict[int, str]:
        if not nodes:
            return {}
        per_node = {n: len(mapper.shards_of(n)) for n in nodes}
        cap = -(-mapper.num_shards // max(len(nodes), min_num_nodes))
        out = {}
        for shard in mapper.unassigned_shards():
            candidates = [n for n in nodes if per_node[n] < cap]
            if not candidates:
                break
            node = min(candidates, key=per_node.__getitem__)
            out[shard] = node
            per_node[node] += 1
        return out


@dataclass
class ShardManager:
    """One dataset's shard assignment, held by the cluster."""

    dataset: str
    num_shards: int
    min_num_nodes: int = 1
    reassignment_min_interval_s: float = 0.0
    mapper: ShardMapper = field(init=False)
    subscribers: list = field(default_factory=list)
    # events a member's mirror can catch up from before it must resync
    event_log_cap: int = 512
    _nodes: list[str] = field(default_factory=list)
    _last_reassign: dict = field(default_factory=dict)
    _deferred: set = field(default_factory=set)
    _seq: int = 0
    _event_log: list = field(default_factory=list)  # [(seq, ShardEvent)]

    def __post_init__(self):
        self.mapper = ShardMapper(self.num_shards)
        self._lock = threading.Lock()
        # the feed's generation: a restarted coordinator starts its
        # sequence at 0 again, and a mirror whose last sequence falls in
        # the new feed's range would skip events without it
        self.epoch = uuid.uuid4().hex[:16]
        # shared across heartbeat/join/migration/executor-handler threads
        racecheck.register(self, f"ShardManager[{self.dataset}]")

    @property
    def nodes(self) -> list[str]:
        return list(self._nodes)

    def add_member(self, node: str) -> list[ShardEvent]:
        if node in self._nodes:
            return []
        self._nodes.append(node)
        return self.check_deferred() + self._assign()

    def remove_member(self, node: str) -> list[ShardEvent]:
        """A member lost: its follower roles stop; each of its shards goes
        to an in-sync follower (``promote``), or DOWN and then to the
        members left where at least ``min_num_nodes`` remain (a shard
        reassigned within ``reassignment_min_interval_s`` waits for
        ``check_deferred``)."""
        if node not in self._nodes:
            return []
        self._nodes.remove(node)
        now = time.monotonic()
        events = [self._publish(ShardEvent(s, ShardStatus.STOPPED, node,
                                           replica=True))
                  for s in self.mapper.follower_shards(node)]
        down = []
        for s in self.mapper.shards_of(node):
            best = self._promotion_candidate(s)
            if best is not None:
                events.append(self.promote(s, best))
                continue
            down.append(s)
            events.append(self._publish(ShardEvent(s, ShardStatus.DOWN,
                                                   None)))
        if len(self._nodes) >= self.min_num_nodes:
            for shard in down:
                if now - self._last_reassign.get(shard, -float("inf")) \
                        < self.reassignment_min_interval_s:
                    log.warning("shard %d reassignment rate-limited; "
                                "deferred", shard)
                    self._deferred.add(shard)
                    continue
                self._last_reassign[shard] = now
            events += self._assign()
        return events

    def check_deferred(self) -> list[ShardEvent]:
        """Reassign the deferred shards whose interval has passed, where
        at least ``min_num_nodes`` members remain (every membership change
        and heartbeat calls it): a shard a promotion owns meanwhile is
        dropped, one with a follower caught up meanwhile is promoted."""
        if not self._deferred:
            return []
        now = time.monotonic()
        ready = [s for s in self._deferred
                 if now - self._last_reassign.get(s, -float("inf"))
                 >= self.reassignment_min_interval_s]
        if not ready or len(self._nodes) < self.min_num_nodes:
            return []
        events = []
        for s in ready:
            self._deferred.discard(s)
            if self.mapper.node_for(s) is not None:
                continue  # a promotion won the race
            best = self._promotion_candidate(s)
            if best is not None:
                events.append(self.promote(s, best))
                continue
            self._last_reassign[s] = now
        return events + self._assign()

    # ---- a promoted coordinator ----------------------------------------------

    def adopt(self, shard: int, node: str, status: ShardStatus) -> None:
        """Record an ownership that exists, without starting anything (a
        promoted coordinator taking over a running cluster)."""
        if node not in self._nodes:
            self._nodes.append(node)
        with self._lock:
            self.mapper.apply(ShardEvent(shard, status, node))

    def rebalance(self) -> list[ShardEvent]:
        """Assign the unassigned shards to the members."""
        return self._assign()

    def plan_rebalance(self, overloaded: str | None = None,
                       min_imbalance: int = 2
                       ) -> list[tuple[int, str, str]]:
        """Live migrations ``(shard, from, to)`` that level the members'
        shard counts, moving ACTIVE shards; with ``overloaded`` (the
        memory watchdog's pressure) only away from that node, which sheds
        at one below ``min_imbalance`` (1 sheds with counts level)."""
        if len(self._nodes) < 2:
            return []
        active = {n: [s for s in self.mapper.shards_of(n)
                      if self.mapper.statuses[s] == ShardStatus.ACTIVE]
                  for n in self._nodes}
        counts = {n: len(self.mapper.shards_of(n)) for n in self._nodes}
        moves: list[tuple[int, str, str]] = []
        while True:
            src = overloaded if overloaded in counts else \
                max(counts, key=lambda n: counts[n])
            others = [n for n in counts if n != src]
            if not others or not active[src]:
                break
            dst = min(others, key=lambda n: counts[n])
            threshold = min_imbalance - 1 if src == overloaded \
                else min_imbalance
            if counts[src] - counts[dst] < threshold:
                break
            shard = active[src].pop()
            moves.append((shard, src, dst))
            counts[src] -= 1
            counts[dst] += 1
        return moves

    # ---- a live migration's events (coordinator/migration.py) ----------------

    def begin_handoff(self, shard: int, source: str) -> ShardEvent:
        """HANDOFF: the source keeps serving while the destination catches
        up."""
        return self._publish(ShardEvent(shard, ShardStatus.HANDOFF, source))

    def complete_handoff(self, shard: int, dest: str) -> ShardEvent:
        """The flip: one sequenced event moves the owner and the status to
        the destination, so an observer sees the old owner or the new."""
        return self._publish(ShardEvent(shard, ShardStatus.ACTIVE, dest))

    def abort_handoff(self, shard: int, source: str) -> ShardEvent:
        """Back to ACTIVE on the source."""
        return self._publish(ShardEvent(shard, ShardStatus.ACTIVE, source))

    # ---- replica sets (coordinator/replication.py) ---------------------------

    def replica_update(self, shard: int, node: str, status: ShardStatus,
                       watermark: int = -1) -> ShardEvent | None:
        """A follower's state: a change of status is a sequenced event; a
        watermark alone moves in place under the lock (a tail advances
        continuously, and an event an offset would push the log's window
        past slow mirrors)."""
        with self._lock:
            cur = self.mapper.replicas[shard].get(node)
            if cur is not None and cur.status == status:
                cur.watermark = watermark
                return None
        return self._publish(ShardEvent(shard, status, node, replica=True,
                                        watermark=watermark))

    def drop_replica(self, shard: int, node: str) -> ShardEvent | None:
        """``node`` out of the shard's follower set (its tail stopped)."""
        if node not in self.mapper.replicas[shard]:
            return None
        return self._publish(ShardEvent(shard, ShardStatus.STOPPED, node,
                                        replica=True))

    def promote(self, shard: int, node: str) -> ShardEvent:
        """The failover flip: one sequenced ACTIVE event makes an in-sync
        follower the leader (it leaves the follower set), with no DOWN
        window between."""
        get_counter("filodb_replica_promotions",
                    {"dataset": self.dataset}).inc()
        log.warning("promoting in-sync follower %s to leader of %s/%d",
                    node, self.dataset, shard)
        return self._publish(ShardEvent(shard, ShardStatus.ACTIVE, node))

    def _promotion_candidate(self, shard: int) -> str | None:
        """The in-sync follower still a member with the highest applied
        watermark (the shortest log tail left), or None."""
        live = [n for n in self.mapper.in_sync_followers(shard)
                if n in self._nodes]
        if not live:
            return None
        return max(live,
                   key=lambda n: self.mapper.replicas[shard][n].watermark)

    def _assign(self) -> list[ShardEvent]:
        return [self._publish(ShardEvent(shard, ShardStatus.ASSIGNED, node))
                for shard, node in sorted(DefaultShardAssignmentStrategy().assignments(
                    self.mapper, self._nodes, self.min_num_nodes).items())
                if shard not in self._deferred]

    def shard_active(self, shard: int, node: str) -> ShardEvent:
        return self._publish(ShardEvent(shard, ShardStatus.ACTIVE, node))

    def shard_recovery(self, shard: int, node: str,
                       progress: int) -> ShardEvent:
        return self._publish(ShardEvent(shard, ShardStatus.RECOVERY, node,
                                        progress))

    def shard_error(self, shard: int, node: str) -> ShardEvent:
        return self._publish(ShardEvent(shard, ShardStatus.ERROR, None))

    def _publish(self, ev: ShardEvent) -> ShardEvent:
        with self._lock:
            self.mapper.apply(ev)
            self._seq += 1
            self._event_log.append((self._seq, ev))
            if len(self._event_log) > self.event_log_cap:
                del self._event_log[:len(self._event_log)
                                    - self.event_log_cap]
        for sub in list(self.subscribers):
            try:
                sub(ev)
            except Exception:
                get_counter("filodb_shard_event_errors",
                            {"dataset": self.dataset}).inc()
                log.exception("shard event subscriber failed for %s "
                              "(shard %d → %s)", self.dataset, ev.shard,
                              ev.status.name)
        return ev

    def events_since(self, since_seq: int, epoch: str | None = None):
        """(events, current sequence, resynced, epoch): the events after
        ``since_seq``, or the whole map as events where the caller fell
        behind the log, ran ahead of it or names another epoch."""
        with self._lock:
            oldest = self._event_log[0][0] if self._event_log \
                else self._seq + 1
            behind = since_seq + 1 < oldest and self._seq > since_seq
            ahead = since_seq > self._seq
            if behind or ahead or (epoch is not None and epoch != self.epoch):
                return self._state_events(), self._seq, True, self.epoch
            return ([ev for seq, ev in self._event_log if seq > since_seq],
                    self._seq, False, self.epoch)

    def _state_events(self) -> list[ShardEvent]:
        """The map as replayable events: the leaders, then the followers
        (a resyncing mirror rebuilds both)."""
        out = [ShardEvent(s, self.mapper.statuses[s], self.mapper.owners[s])
               for s in range(self.num_shards)]
        for s in range(self.num_shards):
            for node, st in sorted(self.mapper.replicas[s].items()):
                out.append(ShardEvent(s, st.status, node, replica=True,
                                      watermark=st.watermark))
        return out

    def subscribe(self, fn) -> None:
        """Call ``fn`` with the map as events now, then with each event."""
        self.subscribers.append(fn)
        for ev in self._state_events():
            fn(ev)
