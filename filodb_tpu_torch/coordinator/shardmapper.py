"""Shard → node routing table with each shard's status.

Port of ``filodb_tpu/coordinator/shardmapper.py`` (``ShardStatus``,
``ShardEvent``, ``ShardMapper``) without the follower replica sets and
their states (ROADMAP §A.12), the routing helpers no caller of one node
uses, and of the single-node part of
``coordinator/shard_manager.py``: ``ShardManager`` assigns unassigned
shards to members (the reference's default strategy: least loaded first,
at most ceil(shards / max(members, min_num_nodes)) a member) and applies
each shard's lifecycle events to its mapper, in order, under a lock.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field



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

    def shards_of(self, node: str) -> list[int]:
        return [s for s, o in enumerate(self.owners) if o == node]

    def unassigned_shards(self) -> list[int]:
        return [s for s, o in enumerate(self.owners) if o is None]

    def snapshot(self) -> list[dict]:
        return [{"shard": s, "status": self.statuses[s].value,
                 "node": self.owners[s]} for s in range(self.num_shards)]


@dataclass
class ShardManager:
    """One dataset's shard assignment, held by the cluster."""

    dataset: str
    num_shards: int
    min_num_nodes: int = 1
    mapper: ShardMapper = field(init=False)
    _nodes: list[str] = field(default_factory=list)

    def __post_init__(self):
        self.mapper = ShardMapper(self.num_shards)
        self._lock = threading.Lock()

    def add_member(self, node: str) -> list[ShardEvent]:
        if node in self._nodes:
            return []
        self._nodes.append(node)
        return self._assign()

    def _assign(self) -> list[ShardEvent]:
        per_node = {n: len(self.mapper.shards_of(n)) for n in self._nodes}
        cap = -(-self.num_shards // max(len(self._nodes),
                                        self.min_num_nodes))
        out = []
        for shard in self.mapper.unassigned_shards():
            candidates = [n for n in self._nodes if per_node[n] < cap]
            if not candidates:
                break
            node = min(candidates, key=per_node.__getitem__)
            per_node[node] += 1
            out.append(self._publish(ShardEvent(shard, ShardStatus.ASSIGNED,
                                                node)))
        return out

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
        return ev
