"""Shard → node routing table with each shard's status, and each
dataset's shard assignment across members.

Port of ``filodb_tpu/coordinator/shardmapper.py`` (``ShardStatus``,
``ShardEvent``, ``ShardMapper``) without the follower replica sets and
their states (ROADMAP §A.12), and of the membership part of
``filodb_tpu/coordinator/shard_manager.py`` (``:29-59, 104-180,
317-370``): ``ShardManager`` assigns unassigned shards to members through
``DefaultShardAssignmentStrategy`` (least loaded first, at most ceil(shards / max(members, min_num_nodes)) a member, existing
assignments kept), takes a lost member's shards DOWN and reassigns them
once at least ``min_num_nodes`` members remain (a shard inside
``reassignment_min_interval_s`` of its last reassignment waits in
``_deferred`` for ``check_deferred``), applies each shard's lifecycle
events to its mapper in order, under a lock, and keeps them in a
sequenced log: ``events_since`` hands a member's mirror the events after
its last sequence, or the whole map (a resync) where it fell behind the
log's window, ran ahead of it, or names another epoch (the coordinator
restarted); ``subscribe`` replays the map to a new subscriber, then
each event.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field

log = logging.getLogger(__name__)


class ShardStatus(enum.Enum):
    UNASSIGNED = "unassigned"
    ASSIGNED = "assigned"
    ACTIVE = "active"
    RECOVERY = "recovery"
    HANDOFF = "handoff"
    ERROR = "error"
    STOPPED = "stopped"
    DOWN = "down"


@dataclass
class ShardEvent:
    shard: int
    status: ShardStatus
    node: str | None = None
    progress: int = 0  # recovery progress percent


@dataclass
class ShardMapper:
    num_shards: int
    statuses: list[ShardStatus] = field(default_factory=list)
    owners: list[str | None] = field(default_factory=list)

    def __post_init__(self):
        if self.num_shards & (self.num_shards - 1):
            raise ValueError("num_shards must be a power of 2")
        if not self.statuses:
            self.statuses = [ShardStatus.UNASSIGNED] * self.num_shards
            self.owners = [None] * self.num_shards

    def apply(self, ev: ShardEvent) -> None:
        self.statuses[ev.shard] = ev.status
        if ev.node is not None or ev.status in (ShardStatus.UNASSIGNED,
                                                ShardStatus.DOWN):
            self.owners[ev.shard] = ev.node

    def node_for(self, shard: int) -> str | None:
        return self.owners[shard]

    def shards_of(self, node: str) -> list[int]:
        return [s for s, o in enumerate(self.owners) if o == node]

    def unassigned_shards(self) -> list[int]:
        return [s for s, o in enumerate(self.owners) if o is None]

    def snapshot(self) -> list[dict]:
        return [{"shard": s, "status": self.statuses[s].value,
                 "node": self.owners[s]} for s in range(self.num_shards)]


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

    @property
    def nodes(self) -> list[str]:
        return list(self._nodes)

    def add_member(self, node: str) -> list[ShardEvent]:
        if node in self._nodes:
            return []
        self._nodes.append(node)
        return self.check_deferred() + self._assign()

    def remove_member(self, node: str) -> list[ShardEvent]:
        """A member lost: its shards go DOWN, then to the members left
        where at least ``min_num_nodes`` remain (a shard reassigned within
        ``reassignment_min_interval_s`` waits for ``check_deferred``)."""
        if node not in self._nodes:
            return []
        self._nodes.remove(node)
        now = time.monotonic()
        down = self.mapper.shards_of(node)
        events = [self._publish(ShardEvent(s, ShardStatus.DOWN, None))
                  for s in down]
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
        and heartbeat calls it)."""
        if not self._deferred:
            return []
        now = time.monotonic()
        ready = [s for s in self._deferred
                 if now - self._last_reassign.get(s, -float("inf"))
                 >= self.reassignment_min_interval_s]
        if not ready or len(self._nodes) < self.min_num_nodes:
            return []
        for s in ready:
            self._deferred.discard(s)
            self._last_reassign[s] = now
        return self._assign()

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
        return [ShardEvent(s, self.mapper.statuses[s], self.mapper.owners[s])
                for s in range(self.num_shards)]

    def subscribe(self, fn) -> None:
        """Call ``fn`` with the map as events now, then with each event."""
        self.subscribers.append(fn)
        for ev in self._state_events():
            fn(ev)
