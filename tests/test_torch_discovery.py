"""Seed discovery, the member registry and coordinator failover of the
port.

Mirrors ``tests/test_consul_discovery.py`` and ``tests/test_dns_srv.py``
on the port's ``coordinator/bootstrap.py`` and ``utils/dns_srv.py``, and
the reference's failover (``filodb_tpu/standalone.py:748-800``), on the
CPU:

- Consul: register, discover (sorted, other services filtered) and
  deregister against the reference tests' protocol-level fake agent; an
  unreachable agent yields no seeds; two ``FiloServer``\\ s with a
  ``consul`` block elect a coordinator and join it, and deregister at
  shutdown;
- DNS SRV: the wire format (names, compression, loops, the transaction
  id) and resolution against the reference tests' stub resolver, with
  the port's query bytes and parsed answers equal to the reference's;
- ``MemberRegistry`` and ``alive_members``;
- coordinator failover: two ``FiloServer``\\ s under
  ``enable_failover``; the coordinator stops, the member promotes itself
  after three missed pings, and the cluster answers as before (at
  ``rtol=1e-12``: one node adds up what two did).

Each wait is bounded by a deadline.
"""

from __future__ import annotations

import json
import os
import struct
import time
import urllib.request

import numpy as np
import pytest

from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu.utils import dns_srv as ref_dns
from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.coordinator.bootstrap import (
    ConsulDiscovery,
    DnsSrvDiscovery,
    ExplicitListDiscovery,
    FileDiscovery,
    MemberRegistry,
    alive_members,
)
from filodb_tpu_torch.coordinator.remote import PlanExecutorServer, reset_pool
from filodb_tpu_torch.core.record import BytesContainer
from filodb_tpu_torch.kafka.log import SegmentedFileLog
from filodb_tpu_torch.standalone import FiloServer
from filodb_tpu_torch.testing.from_jax import free_port
from filodb_tpu_torch.utils import dns_srv
from filodb_tpu_torch.utils.dns_srv import (
    DnsError,
    build_query,
    encode_qname,
    parse_srv_response,
    read_name,
    resolve_srv,
)
from filodb_tpu_torch.utils.resilience import reset_breakers
from test_consul_discovery import FakeConsulAgent
from test_dns_srv import StubResolver, _response
from test_torch_remote_dispatch import DS, NUM_SHARDS, START, routed


@pytest.fixture
def agent():
    a = FakeConsulAgent().start()
    yield a
    a.stop()


class TestConsulDiscovery:
    def test_register_discover_deregister(self, agent):
        d = ConsulDiscovery(port=agent.port, service_name="filodb")
        assert d.discover() == []
        d.register("node-a", "10.0.0.1", 2552)
        d.register("node-b", "10.0.0.2", 2552)
        assert d.discover() == [("10.0.0.1", 2552), ("10.0.0.2", 2552)]
        d.deregister("node-a")
        assert d.discover() == [("10.0.0.2", 2552)]

    def test_other_services_filtered(self, agent):
        d = ConsulDiscovery(port=agent.port, service_name="filodb")
        d.register("me", "10.0.0.9", 2552)
        ConsulDiscovery(port=agent.port, service_name="unrelated").register(
            "them", "10.0.0.8", 9999)
        assert d.discover() == [("10.0.0.9", 2552)]

    def test_deterministic_seed_order(self, agent):
        d = ConsulDiscovery(port=agent.port, service_name="filodb")
        for i in (3, 1, 2):
            d.register(f"n{i}", f"10.0.0.{i}", 2552)
        assert d.discover() == [("10.0.0.1", 2552), ("10.0.0.2", 2552),
                                ("10.0.0.3", 2552)]

    def test_unreachable_agent_yields_no_seeds(self):
        d = ConsulDiscovery(port=1, service_name="filodb", timeout=0.3)
        assert d.discover() == []

    def test_register_body_is_the_reference(self, agent):
        from filodb_tpu.coordinator.bootstrap import (
            ConsulDiscovery as RefConsul,
        )

        ConsulDiscovery(port=agent.port).register("a", "10.0.0.1", 1)
        ours = dict(agent.services)
        agent.services.clear()
        RefConsul(port=agent.port).register("a", "10.0.0.1", 1)
        assert ours == agent.services

    def test_servers_elect_and_join_through_consul(self, agent, tmp_path):
        """Two nodes, no seeds: the first registered forms the cluster,
        the second finds it through the agent and joins; shutdown
        deregisters."""
        reset_breakers()
        base = {"wal_dir": str(tmp_path / "wal"), "http_port": 0,
                "consul": {"port": agent.port, "service": "filodb"},
                "datasets": {DS: {"num_shards": 2, "min_num_nodes": 1,
                                  "spread": 0,
                                  "store": {"retention_ms": 2 ** 60}}}}
        servers = []
        try:
            for name in ("first", "second"):
                p = tmp_path / f"{name}.json"
                p.write_text(json.dumps({**base, "node_name": name,
                                         "data_dir": str(tmp_path / name)}))
                servers.append(FiloServer(ServerConfig.load(str(p)),
                                          device="cpu").start())
            first, second = servers
            assert first.is_coordinator and not second.is_coordinator
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if "second" in first.cluster.nodes:
                    break
                time.sleep(0.05)
            assert "second" in first.cluster.nodes
            assert sorted(agent.services) == ["first", "second"]
        finally:
            for srv in reversed(servers):
                srv.shutdown()
            reset_pool()
        assert agent.services == {}


class TestDnsSrv:
    @pytest.mark.parametrize("name,txid", [
        ("_filodb._tcp.example.com", 7), ("seed.example.com", 65535),
        ("a.b.c.d.e", 0)])
    def test_query_bytes_are_the_reference(self, name, txid):
        assert build_query(name, txid) == ref_dns.build_query(name, txid)
        assert encode_qname(name) == ref_dns.encode_qname(name)

    def test_qname_roundtrip(self):
        raw = encode_qname("_filodb._tcp.example.com")
        name, off = read_name(raw, 0)
        assert name == "_filodb._tcp.example.com"
        assert off == len(raw)

    def test_compression_pointer(self):
        base = b"xx" + encode_qname("example.com")
        msg = base + b"\x01a" + struct.pack(">H", 0xC000 | 2)
        assert read_name(msg, len(base)) == ("a.example.com", len(msg))

    def test_compression_loop_rejected(self):
        msg = struct.pack(">H", 0xC000 | 2) + struct.pack(">H", 0xC000 | 0)
        with pytest.raises(DnsError):
            read_name(msg, 2)

    def test_txid_mismatch_rejected(self):
        with pytest.raises(DnsError):
            parse_srv_response(_response(build_query("x.example.com", 7),
                                         []), 8)

    def test_resolves_and_orders_like_the_reference(self):
        stub = StubResolver([(10, 5, 9001, "node-b.example.com"),
                             (5, 1, 9000, "node-a.example.com"),
                             (5, 9, 9002, "node-c.example.com")])
        try:
            ours = resolve_srv("_filodb._tcp.example.com",
                               server="127.0.0.1", port=stub.port)
            theirs = ref_dns.resolve_srv("_filodb._tcp.example.com",
                                         server="127.0.0.1", port=stub.port)
            assert [(r.priority, r.weight, r.port, r.target)
                    for r in ours] == \
                [(r.priority, r.weight, r.port, r.target) for r in theirs]
            assert [(r.target, r.port) for r in ours] == [
                ("node-c.example.com", 9002), ("node-a.example.com", 9000),
                ("node-b.example.com", 9001)]
        finally:
            stub.close()

    def test_discovery_strategy(self):
        stub = StubResolver([(1, 1, 7070, "seed.example.com")])
        try:
            d = DnsSrvDiscovery("_filodb._tcp.example.com",
                                server="127.0.0.1", port=stub.port)
            assert d.discover() == [("seed.example.com", 7070)]
        finally:
            stub.close()

    def test_unreachable_resolver_yields_no_seeds(self, monkeypatch):
        orig = dns_srv.resolve_srv
        monkeypatch.setattr(
            dns_srv, "resolve_srv",
            lambda name, server=None, port=None, timeout=2.0:
            orig(name, server=server, port=port, timeout=0.2))
        d = DnsSrvDiscovery("_filodb._tcp.example.com", server="127.0.0.1",
                            port=1)
        assert d.discover() == []

    def test_nxdomain_is_empty(self):
        class NxStub(StubResolver):
            def _serve(self):
                try:
                    while True:
                        query, addr = self.sock.recvfrom(4096)
                        self.sock.sendto(_response(query, [], rcode=3), addr)
                except OSError:
                    pass

        stub = NxStub([])
        try:
            assert resolve_srv("_nope._tcp.example.com", server="127.0.0.1",
                               port=stub.port) == []
        finally:
            stub.close()


class TestSeedLists:
    def test_explicit_list(self):
        assert ExplicitListDiscovery(["10.0.0.1:2552", "h:1"]).discover() \
            == [("10.0.0.1", 2552), ("h", 1)]

    def test_file_discovery(self, tmp_path):
        d = FileDiscovery(str(tmp_path / "seeds.txt"))
        assert d.discover() == []
        d.register("10.0.0.1", 2552)
        d.register("10.0.0.2", 2553)
        assert d.discover() == [("10.0.0.1", 2552), ("10.0.0.2", 2553)]


class TestMemberRegistry:
    def test_last_coordinator_line_wins(self, tmp_path):
        reg = MemberRegistry(str(tmp_path / "wal" / "members.txt"))
        assert reg.read() == [] and reg.current_coordinator() is None
        reg.register("coord", "a", "127.0.0.1", 1)
        reg.register("member", "b", "127.0.0.1", 2)
        reg.register("coord", "b", "127.0.0.1", 2)
        assert reg.current_coordinator() == "b"
        assert reg.members() == {"a": ("coord", "127.0.0.1", 1),
                                 "b": ("coord", "127.0.0.1", 2)}

    def test_file_is_the_reference(self, tmp_path):
        from filodb_tpu.coordinator.bootstrap import (
            MemberRegistry as RefRegistry,
        )

        path = str(tmp_path / "members.txt")
        MemberRegistry(path).register("coord", "a", "127.0.0.1", 5)
        RefRegistry(path).register("member", "b", "127.0.0.1", 6)
        assert MemberRegistry(path).members() == RefRegistry(path).members()

    def test_a_stopped_executor_closes_its_connections(self):
        """ROADMAP §C.15: a peer's pooled connection to a stopped
        executor fails its next ping, as a dead node's would (the
        reference's stop leaves the connection answering)."""
        from filodb_tpu_torch.coordinator.remote import RemotePlanDispatcher

        srv = PlanExecutorServer({}).start()
        client = RemotePlanDispatcher("127.0.0.1", srv.port, timeout=2.0)
        try:
            assert client.ping()  # the connection is pooled now
            srv.stop()
            assert not client.ping()
        finally:
            reset_pool()

    def test_alive_members_pings(self, tmp_path):
        live = PlanExecutorServer({}).start()
        try:
            reg = MemberRegistry(str(tmp_path / "members.txt"))
            reg.register("coord", "up", "127.0.0.1", live.port)
            reg.register("member", "gone", "127.0.0.1", free_port())
            assert alive_members(reg) == {"up": ("127.0.0.1", live.port)}
            assert alive_members(reg, exclude="up") == {}
        finally:
            live.stop()
            reset_pool()


# ---- coordinator failover -----------------------------------------------------


def _wal(root: str) -> None:
    """The shards' logs under ``<root>/<dataset>/shard-<n>``, as the
    gateway writes them."""
    raws = routed([gauge_stream(machine_metrics_series(12, ns="App-3"), 240,
                                start_ms=START * 1000)])
    for s, containers in raws.items():
        lg = SegmentedFileLog(os.path.join(root, DS, f"shard-{s}"))
        for raw in containers:
            lg.append(BytesContainer(raw))
        lg.close()


def _ask(port: int) -> dict:
    q = urllib.parse.urlencode({"query": 'sum(heap_usage{_ns_="App-3"})',
                                "start": START + 600, "end": START + 1500,
                                "step": 300})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/promql/{DS}/api/v1/query_range?{q}",
            timeout=30) as r:
        return json.load(r)


def test_member_promotes_itself_when_the_coordinator_is_lost(tmp_path):
    reset_breakers()
    wal = str(tmp_path / "wal")
    _wal(wal)
    exec_port = free_port()
    base = {"wal_dir": wal, "http_port": 0, "enable_failover": True,
            "result_cache": {"enabled": False},
            "http_response_cache": False,
            "datasets": {DS: {"num_shards": NUM_SHARDS, "min_num_nodes": 2,
                              "spread": 1, "engine": "exec",
                              "store": {"max_chunk_size": 60,
                                        "groups_per_shard": 2,
                                        "retention_ms": 2 ** 60}}}}
    paths = []
    for name, extra in (("coord", {"executor_port": exec_port}),
                        ("member", {"seeds": [f"127.0.0.1:{exec_port}"]})):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({**base, **extra, "node_name": name,
                                 "data_dir": str(tmp_path / name)}))
        paths.append(str(p))
    coord = FiloServer(ServerConfig.load(paths[0]), device="cpu").start()
    member = None
    try:
        member = FiloServer(ServerConfig.load(paths[1]),
                            device="cpu").start()
        assert coord.cluster.wait_active(DS, 30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                set(coord.cluster.shard_managers[DS].mapper.owners) != \
                {"coord", "member"}:
            time.sleep(0.05)
        assert coord.cluster.wait_active(DS, 30)
        before = _ask(coord.http.port)
        assert before["data"]["result"] and not before.get("partial")
        reg = MemberRegistry(os.path.join(wal, "members.txt"))
        assert reg.current_coordinator() == "coord"
        assert member.services == {}
        coord.shutdown()
        coord = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not member.is_coordinator:
            time.sleep(0.05)

        def state():
            cl = member.cluster
            sm = cl.shard_managers.get(DS) if cl is not None else None
            return (f"map={sm.mapper.snapshot() if sm else None} "
                    f"registry={reg.current_coordinator()!r} "
                    f"is_coordinator={member.is_coordinator}")

        assert member.is_coordinator, state()
        assert reg.current_coordinator() == "member", state()
        assert member.cluster.wait_active(DS, 30), state()
        sm = member.cluster.shard_managers[DS]
        assert set(sm.mapper.owners) == {"member"}, state()
        after = _ask(member.http.port)
        assert not after.get("partial"), (after, state())
        # one node sums what two summed before: the same series and steps,
        # the values to the last bits of float64's order of additions
        got, want = after["data"]["result"], before["data"]["result"]
        assert [r["metric"] for r in got] == [r["metric"] for r in want]
        for g, w in zip(got, want):
            assert [t for t, _ in g["values"]] == [t for t, _ in w["values"]]
            np.testing.assert_allclose([float(v) for _, v in g["values"]],
                                       [float(v) for _, v in w["values"]],
                                       rtol=1e-12)
    finally:
        if member is not None:
            member.shutdown()
        if coord is not None:
            coord.shutdown()
        reset_pool()
