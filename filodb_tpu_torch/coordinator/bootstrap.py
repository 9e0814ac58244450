"""Members in other processes: the coordinator's handle of one, a
member's mirror of the shard map, and the coordinator's poll of their
shard statuses.

Port of the remote-membership part of ``filodb_tpu/coordinator/
bootstrap.py`` (``:163-284``), over the framed transport's control
messages (``coordinator/remote.py``; a node's handlers are
``standalone.FiloServer``'s):

- ``RemoteNodeHandle``: a member driven over its executor port, with the
  in-process ``Node``'s face as the cluster uses it (``start_shard``,
  ``stop_shard``, ``shard_status``, ``owned_shards``, ``kill``);
  ``alive`` is a ping, so the failure detector counts a member that does
  not answer as a missed heartbeat.
- ``ShardUpdateSubscriber``: a member's mirror of the coordinator's map
  of one dataset, polled from its ``shard_events`` feed; the member acks
  with its next poll's sequence and echoes the feed's epoch, and the
  coordinator answers the whole map (a resync) where the member fell
  behind, ran ahead or names another epoch.
- ``poll_remote_statuses``: the coordinator's heartbeat pulls each
  remote member's shard statuses into the shard manager (RECOVERY, then
  ACTIVE once the member's replay reached its log's end).

Seed discovery over Consul, the member registry and coordinator failover
come with ROADMAP §A.12.
"""

from __future__ import annotations

from filodb_tpu_torch.coordinator.remote import RemotePlanDispatcher
from filodb_tpu_torch.coordinator.shardmapper import (
    ShardEvent,
    ShardMapper,
    ShardStatus,
)

# what a member's control call may fail with: the transport's errors, or
# the member's own answer as an error (``RemotePlanDispatcher.call``)
_CALL_ERRORS = (ConnectionError, OSError, RuntimeError)


class RemoteNodeHandle:
    """A member in another process, over its control port."""

    def __init__(self, name: str, host: str, control_port: int):
        self.name = name
        self.host = host
        self.executor_port = control_port
        self._client = RemotePlanDispatcher(host, control_port)

    @property
    def alive(self) -> bool:
        return self._client.ping()

    def start_shard(self, dataset: str, shard: int, config=None,
                    shard_log=None, on_status=None) -> None:
        self._client.call("start_shard", dataset, shard)
        if on_status:
            # its progress comes from the heartbeat's status poll
            on_status(shard, ShardStatus.RECOVERY, 0)

    def stop_shard(self, dataset: str, shard: int) -> None:
        try:
            self._client.call("stop_shard", dataset, shard)
        except _CALL_ERRORS:
            pass

    def shard_status(self, dataset: str) -> list[tuple[int, str]]:
        return self._client.call("shard_status", dataset)

    def owned_shards(self, dataset: str) -> list[int]:
        try:
            return sorted(s for s, _ in self.shard_status(dataset))
        except _CALL_ERRORS:
            return []

    def kill(self) -> None:
        """The coordinator's bookkeeping only: the process is the
        member's."""


class ShardUpdateSubscriber:
    """A member's mirror of the coordinator's shard map of ``dataset``."""

    def __init__(self, dataset: str, num_shards: int, dispatcher):
        self.dataset = dataset
        self.dispatcher = dispatcher
        self.mapper = ShardMapper(num_shards)
        self.last_seq = 0
        self.epoch = None  # the feed's generation; a change resyncs
        self.resyncs = 0

    def poll(self) -> int:
        """One poll; returns the events applied."""
        events, seq, resynced, epoch = self.dispatcher.call(
            "shard_events", self.dataset, self.last_seq, self.epoch)
        if resynced:
            self.mapper = ShardMapper(self.mapper.num_shards)
            self.resyncs += 1
        for shard, status_name, node, progress, *_rest in events:
            # the rest (replica, watermark) is the replica sets', which
            # the port's map does not keep (ROADMAP §A.12)
            self.mapper.apply(ShardEvent(int(shard),
                                         ShardStatus[status_name], node,
                                         int(progress)))
        self.last_seq = seq
        self.epoch = epoch
        return len(events)


def poll_remote_statuses(cluster, dataset: str) -> None:
    """Pull each remote member's shard statuses into the dataset's shard
    manager (the reference's status events)."""
    sm = cluster.shard_managers.get(dataset)
    if sm is None:
        return
    for name, node in list(cluster.nodes.items()):
        if not isinstance(node, RemoteNodeHandle):
            continue
        try:
            statuses = node.shard_status(dataset)
        except _CALL_ERRORS:
            continue
        for shard, status in statuses:
            if sm.mapper.node_for(shard) != name:
                continue
            if status == "active" \
                    and sm.mapper.statuses[shard] != ShardStatus.ACTIVE:
                sm.shard_active(shard, name)
            elif status == "recovery" \
                    and sm.mapper.statuses[shard] == ShardStatus.ASSIGNED:
                sm.shard_recovery(shard, name, 0)
