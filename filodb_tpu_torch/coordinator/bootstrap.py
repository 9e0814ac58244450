"""Cluster bootstrap: seed discovery, members in other processes, a
member's mirror of the shard map, the coordinator's poll of the members'
shard statuses, and the member registry coordinator failover elects
from.

Port of ``filodb_tpu/coordinator/bootstrap.py`` over the framed
transport's control messages (``coordinator/remote.py``; a node's
handlers are ``standalone.FiloServer``'s):

- Seed discovery (``:27-160``, the reference's akka-bootstrapper
  strategies): ``ExplicitListDiscovery`` ("host:port" seeds),
  ``FileDiscovery`` (a shared file of them), ``DnsSrvDiscovery`` (SRV
  records through ``utils/dns_srv.py``; a failed resolution yields no
  seeds) and ``ConsulDiscovery`` (a Consul agent's HTTP API: register,
  the passing instances of the service sorted, deregister).
- ``RemoteNodeHandle``: a member driven over its executor port, with the
  in-process ``Node``'s face as the cluster uses it (``start_shard``,
  ``stop_shard``, ``shard_status``, ``owned_shards``, a migration's
  ``prepare_handoff`` and ``shard_offset``, ``kill``); ``alive`` is a
  ping, so the failure detector counts a member that does not answer as
  a missed heartbeat.
- ``ShardUpdateSubscriber``: a member's mirror of the coordinator's map
  of one dataset, polled from its ``shard_events`` feed; the member acks
  with its next poll's sequence and echoes the feed's epoch, and the
  coordinator answers the whole map (a resync) where the member fell
  behind, ran ahead or names another epoch. Events are the reference's
  6-tuples, replica sets included; a 4-tuple applies as a leader event.
- ``poll_remote_statuses``: the coordinator's heartbeat pulls each
  remote member's shard statuses into the shard manager (RECOVERY, then
  ACTIVE once the member's replay reached its log's end).
- ``MemberRegistry`` (``:287-330``): an append-only membership file of
  ``role,name,host,port`` lines; the coordinator is the last ``coord``
  line. ``alive_members`` pings every registered member.
"""

from __future__ import annotations

import json
import logging
import os
import urllib.request
from dataclasses import dataclass, field

from filodb_tpu_torch.coordinator.remote import RemotePlanDispatcher
from filodb_tpu_torch.coordinator.shardmapper import (
    ShardEvent,
    ShardMapper,
    ShardStatus,
)

log = logging.getLogger(__name__)

# what a member's control call may fail with: the transport's errors, or
# the member's own answer as an error (``RemotePlanDispatcher.call``)
_CALL_ERRORS = (ConnectionError, OSError, RuntimeError)


# ---- seed discovery ----------------------------------------------------------


class SeedDiscovery:
    def discover(self) -> list[tuple[str, int]]:
        raise NotImplementedError


@dataclass
class ExplicitListDiscovery(SeedDiscovery):
    """A static list of "host:port" seeds."""

    seeds: list[str] = field(default_factory=list)

    def discover(self):
        out = []
        for s in self.seeds:
            host, port = s.rsplit(":", 1)
            out.append((host, int(port)))
        return out


@dataclass
class FileDiscovery(SeedDiscovery):
    """A shared file of "host:port" lines (Consul's registration on one
    host or a shared volume)."""

    path: str = ""

    def discover(self):
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    host, port = line.rsplit(":", 1)
                    out.append((host, int(port)))
        return out

    def register(self, host: str, port: int) -> None:
        with open(self.path, "a") as f:
            f.write(f"{host}:{port}\n")


@dataclass
class DnsSrvDiscovery(SeedDiscovery):
    """SRV records of ``srv_name`` through the wire-format resolver
    (``utils/dns_srv.py``); ``server`` and ``port`` pin the resolver,
    else ``$FILODB_DNS_SERVER`` or ``/etc/resolv.conf`` names it. A
    failed resolution logs and yields no seeds (the caller retries)."""

    srv_name: str = ""
    server: str | None = None
    port: int | None = None

    def discover(self):
        from filodb_tpu_torch.utils.dns_srv import DnsError, resolve_srv

        try:
            records = resolve_srv(self.srv_name, server=self.server,
                                  port=self.port)
        except (DnsError, OSError) as e:
            log.warning("DNS SRV discovery for %s failed: %s",
                        self.srv_name, e)
            return []
        return [(r.target, r.port) for r in records]


@dataclass
class ConsulDiscovery(SeedDiscovery):
    """A Consul agent's HTTP API: a node registers itself (PUT
    ``/v1/agent/service/register``) and discovers the service's passing
    instances (GET ``/v1/health/service/<name>?passing=true``), sorted so
    every node elects the same head seed."""

    host: str = "127.0.0.1"
    port: int = 8500
    service_name: str = "filodb"
    timeout: float = 5.0

    def _url(self, path: str) -> str:
        return f"http://{self.host}:{self.port}{path}"

    def discover(self):
        try:
            with urllib.request.urlopen(
                    self._url(f"/v1/health/service/{self.service_name}"
                              "?passing=true"),
                    timeout=self.timeout) as r:
                entries = json.loads(r.read())
        except OSError as e:
            log.warning("consul discovery for %s failed: %s",
                        self.service_name, e)
            return []
        out = []
        for e in entries:
            svc = e.get("Service", {})
            addr = svc.get("Address") or e.get("Node", {}).get("Address")
            port = svc.get("Port")
            if addr and port:
                out.append((addr, int(port)))
        return sorted(out)

    def register(self, service_id: str, host: str, port: int) -> None:
        payload = json.dumps({
            "ID": service_id, "Name": self.service_name,
            "Address": host, "Port": port}).encode()
        req = urllib.request.Request(
            self._url("/v1/agent/service/register"), data=payload,
            method="PUT", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            if r.status >= 300:
                raise OSError(f"consul register failed: {r.status}")

    def deregister(self, service_id: str) -> None:
        req = urllib.request.Request(
            self._url(f"/v1/agent/service/deregister/{service_id}"),
            data=b"", method="PUT")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            if r.status >= 300:
                raise OSError(f"consul deregister failed: {r.status}")


# ---- members in other processes ---------------------------------------------


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

    def prepare_handoff(self, dataset: str, shard: int) -> int:
        """A migration's SYNCING on a remote source (its flush, upload
        drain and index snapshot); returns its latest offset."""
        return self._client.call("prepare_handoff", dataset, shard)

    def shard_offset(self, dataset: str, shard: int) -> int:
        try:
            return self._client.call("shard_offset", dataset, shard)
        except _CALL_ERRORS:
            return -1

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
        for shard, status_name, node, progress, *rest in events:
            # (replica, watermark) since replica sets; more fields may
            # come
            replica = bool(rest[0]) if len(rest) > 0 else False
            watermark = int(rest[1]) if len(rest) > 1 else -1
            self.mapper.apply(ShardEvent(int(shard),
                                         ShardStatus[status_name], node,
                                         int(progress), replica=replica,
                                         watermark=watermark))
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


# ---- the member registry and coordinator failover ----------------------------


class MemberRegistry:
    """An append-only membership file of ``role,name,host,port`` lines:
    the coordinator is the last ``coord`` line (the substrate of a
    coordinator's failover, the reference's cluster-singleton hand-off)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def register(self, role: str, name: str, host: str, port: int) -> None:
        with open(self.path, "a") as f:
            f.write(f"{role},{name},{host},{port}\n")

    def read(self) -> list[tuple[str, str, str, int]]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                role, name, host, port = line.split(",")
                out.append((role, name, host, int(port)))
        return out

    def members(self) -> dict[str, tuple[str, str, int]]:
        """name → (role, host, port); later lines win."""
        out = {}
        for role, name, host, port in self.read():
            out[name] = (role, host, port)
        return out

    def current_coordinator(self) -> str | None:
        coord = None
        for role, name, _, _ in self.read():
            if role == "coord":
                coord = name
        return coord


def alive_members(registry: MemberRegistry,
                  exclude: str | None = None) -> dict[str, tuple[str, int]]:
    """name → (host, port) of the registered members that answer a
    ping."""
    out = {}
    for name, (_, host, port) in registry.members().items():
        if name == exclude:
            continue
        if RemotePlanDispatcher(host, port, timeout=1.0).ping():
            out[name] = (host, port)
    return out
