"""A cluster of the port's nodes: shard assignment across members, the
failure detector, scatter-gather across nodes in one process and across
processes, the member's mirror of the shard map, and two ``FiloServer``
processes over one WAL directory.

Mirrors ``tests/test_cluster.py:29-205`` (balanced assignment, a lost
member's shards reassigned, the ``min_num_nodes`` gate; scatter-gather
across three in-process nodes; a node killed, declared down, its shards
recovered elsewhere from the shared store and logs, the answer equal at
``rtol=1e-9``; TCP plan shipping, a remote error, a dead ping),
``tests/test_status_resync.py`` (the member's mirror, its acks and
resyncs, over the wire too) and ``tests/test_multiprocess.py:41`` (a
coordinator and a member process joined through ``seeds``). Answers are
held against the reference's over the same containers (one store,
``rtol=2e-5``) and the cluster's against one node's.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.coordinator.bootstrap import ShardUpdateSubscriber
from filodb_tpu_torch.coordinator.cluster import (
    FilodbCluster,
    Node,
    NodeDispatcher,
)
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.remote import (
    PlanExecutorServer,
    RemotePlanDispatcher,
    reset_pool,
)
from filodb_tpu_torch.coordinator.shardmapper import (
    ShardManager,
    ShardStatus,
)
from filodb_tpu_torch.coordinator.wire import encode
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer, SomeData
from filodb_tpu_torch.core.store.api import (
    InMemoryColumnStore,
    InMemoryMetaStore,
)
from filodb_tpu_torch.core.store.config import IngestionConfig, StoreConfig
from filodb_tpu_torch.kafka.log import InMemoryLog, SegmentedFileLog
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.exec.plan import ExecContext, run_plan
from filodb_tpu_torch.standalone import FiloServer
from filodb_tpu_torch.testing.from_jax import free_port
from filodb_tpu_torch.utils.resilience import reset_breakers
from test_torch_remote_dispatch import (
    DS,
    NUM_SHARDS,
    START,
    assert_same_answer,
    executor,
    port_store,
    ref_store,
    routed,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- shard assignment ------------------------------------------------------------


class TestShardManager:
    def test_assignment_balanced(self):
        sm = ShardManager("ds", 8, min_num_nodes=2)
        sm.add_member("n1")
        sm.add_member("n2")
        assert len(sm.mapper.shards_of("n1")) == 4
        assert len(sm.mapper.shards_of("n2")) == 4
        assert sm.mapper.unassigned_shards() == []

    def test_member_removed_reassigns(self):
        sm = ShardManager("ds", 8, min_num_nodes=2)
        for n in ("n1", "n2", "n3"):
            sm.add_member(n)
        # n1 and n2 filled to the min-num-nodes cap; n3 a standby
        assert len(sm.mapper.shards_of("n1")) == 4
        assert len(sm.mapper.shards_of("n3")) == 0
        evs = sm.remove_member("n1")
        assert len([e for e in evs if e.status == ShardStatus.DOWN]) == 4
        assert sm.mapper.unassigned_shards() == []
        assert len(sm.mapper.shards_of("n2")) == 4
        assert len(sm.mapper.shards_of("n3")) == 4

    def test_subscriber_gets_the_map_then_events(self):
        sm = ShardManager("ds", 4)
        sm.add_member("n1")
        seen = []
        sm.subscribe(seen.append)
        assert len(seen) == 4  # the current map
        sm.shard_active(1, "n1")
        assert seen[-1].shard == 1 and seen[-1].status == ShardStatus.ACTIVE

    def test_min_nodes_gate(self):
        sm = ShardManager("ds", 4, min_num_nodes=2)
        sm.add_member("n1")
        sm.add_member("n2")
        evs = sm.remove_member("n2")
        # one node left, under min_num_nodes: its shards stay DOWN
        assert [e.status for e in evs] == [ShardStatus.DOWN] * 2
        assert len(sm.mapper.unassigned_shards()) == 2

    def test_a_rate_limited_shard_waits_for_check_deferred(self):
        sm = ShardManager("ds", 2, reassignment_min_interval_s=3600.0)
        sm.add_member("a")
        sm.add_member("b")
        sm._last_reassign = {0: time.monotonic(), 1: time.monotonic()}
        owned = sm.mapper.shards_of("a")
        sm.remove_member("a")
        assert sm._deferred == set(owned)
        assert sm.check_deferred() == []  # inside its interval
        sm.reassignment_min_interval_s = 0.0
        evs = sm.check_deferred()
        assert {e.shard for e in evs} == set(owned)
        assert sm.mapper.shards_of("b") == [0, 1]


# ---- the member's mirror (tests/test_status_resync.py) ---------------------------


class _Feed:
    """A shard manager's feed, called as the control transport calls it,
    in the 6-tuples a coordinator sends."""

    def __init__(self, sm: ShardManager):
        self.sm = sm

    def call(self, kind, dataset, since_seq, epoch=None):
        assert kind == "shard_events"
        events, seq, resynced, ep = self.sm.events_since(since_seq, epoch)
        return ([(e.shard, e.status.name, e.node, e.progress, False, -1)
                 for e in events], seq, resynced, ep)


class TestAckResync:
    def test_incremental_delivery_and_ack(self):
        sm = ShardManager("ds", 4)
        sub = ShardUpdateSubscriber("ds", 4, _Feed(sm))
        sm.add_member("n0")
        assert sub.poll() == 4  # four ASSIGNED events
        assert sub.mapper.owners == sm.mapper.owners
        assert sub.poll() == 0  # acked: nothing new
        sm.shard_active(2, "n0")
        assert sub.poll() == 1
        assert sub.mapper.statuses[2] == ShardStatus.ACTIVE
        assert sub.resyncs == 0

    def test_gap_forces_resync(self):
        sm = ShardManager("ds", 4, event_log_cap=3)
        sub = ShardUpdateSubscriber("ds", 4, _Feed(sm))
        sm.add_member("n0")
        for _ in range(5):
            sm.shard_active(0, "n0")
            sm.shard_active(1, "n0")
        assert sub.poll() == 4  # the whole map, one event a shard
        assert sub.resyncs == 1
        assert sub.mapper.owners == sm.mapper.owners
        assert sub.mapper.statuses[0] == ShardStatus.ACTIVE
        sm.shard_recovery(3, "n0", 50)
        assert sub.poll() == 1 and sub.resyncs == 1
        assert sub.mapper.statuses[3] == ShardStatus.RECOVERY

    def test_fresh_subscriber_gets_the_map(self):
        sm = ShardManager("ds", 2)
        sm.add_member("a")
        sm.shard_active(0, "a")
        sub = ShardUpdateSubscriber("ds", 2, _Feed(sm))
        sub.poll()
        assert sub.mapper.owners == sm.mapper.owners
        assert sub.mapper.statuses == sm.mapper.statuses

    def test_coordinator_restart_forces_resync(self):
        sm1 = ShardManager("ds", 2)
        sub = ShardUpdateSubscriber("ds", 2, _Feed(sm1))
        sm1.add_member("a")
        for _ in range(6):
            sm1.shard_active(0, "a")
        sub.poll()
        assert sub.last_seq > 0
        sm2 = ShardManager("ds", 2)
        sm2.add_member("b")
        sub.dispatcher = _Feed(sm2)
        sub.poll()
        assert sub.resyncs == 1 and sub.mapper.owners == sm2.mapper.owners

    def test_restart_with_plausible_seq_forces_resync(self):
        sm1 = ShardManager("ds", 4)
        sub = ShardUpdateSubscriber("ds", 4, _Feed(sm1))
        sm1.add_member("a")  # 4 events, seq 4
        sub.poll()
        assert sub.last_seq == 4
        # the new coordinator's feed is at 4 too: only the epoch tells
        sm2 = ShardManager("ds", 4)
        sm2.add_member("b")
        assert sm2.epoch != sm1.epoch
        sub.dispatcher = _Feed(sm2)
        sub.poll()
        assert sub.resyncs == 1 and sub.epoch == sm2.epoch
        assert sub.mapper.owners == sm2.mapper.owners
        sm2.shard_active(0, "b")
        assert sub.poll() == 1 and sub.resyncs == 1

    def test_member_mirrors_coordinator_over_wire(self):
        sm = ShardManager("ds", 4)
        sm.add_member("n0")
        srv = PlanExecutorServer(None, extra_handlers={
            "shard_events": lambda *a: _Feed(sm).call("shard_events", *a)
        }).start()
        try:
            sub = ShardUpdateSubscriber(
                "ds", 4, RemotePlanDispatcher("127.0.0.1", srv.port))
            assert sub.poll() == 4
            sm.shard_active(1, "n0")
            assert sub.poll() == 1
            assert sub.mapper.statuses[1] == ShardStatus.ACTIVE
            assert sub.mapper.owners == sm.mapper.owners
        finally:
            srv.stop()
            reset_pool()


# ---- three nodes in one process (tests/test_cluster.py:71-167) ------------------


GAUGES = dict(max_chunk_size=60, groups_per_shard=2)
Q_COUNT = 'count(heap_usage{_ns_="App-3"})'
Q_SUM = 'sum(heap_usage{_ns_="App-3"})'


@pytest.fixture(scope="module")
def raws():
    return routed([gauge_stream(machine_metrics_series(12, ns="App-3"), 240,
                                start_ms=START * 1000)])


@pytest.fixture(scope="module")
def ref_svc(raws):
    return RefService(ref_store(raws, GAUGES), DS, NUM_SHARDS, spread=1)


def _logs(raws) -> dict:
    logs = {s: InMemoryLog() for s in range(NUM_SHARDS)}
    for s, containers in raws.items():
        for raw in containers:
            logs[s].append(BytesContainer(raw))
    return logs


@pytest.fixture
def cluster_env(raws):
    cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
    cluster = FilodbCluster()
    for n in ("node-a", "node-b", "node-c"):
        cluster.join(Node(n, cs, meta))
    cluster.setup_dataset(IngestionConfig(DS, NUM_SHARDS, min_num_nodes=2,
                                          store=StoreConfig(**GAUGES)),
                          _logs(raws))
    assert cluster.wait_active(DS, 10)
    yield cluster
    cluster.stop()


class TestClusterQuery:
    def test_scatter_gather_across_nodes(self, cluster_env, ref_svc):
        cluster = cluster_env
        assert cluster.nodes["node-a"].owned_shards(DS) == [0, 1]
        assert cluster.nodes["node-b"].owned_shards(DS) == [2, 3]
        assert cluster.nodes["node-c"].owned_shards(DS) == []
        svc = cluster.query_service(DS, device="cpu")
        assert not svc.shards_local()
        r = svc.query_range(Q_COUNT, START + 600, 60, START + 2000)
        assert r.stats.engine == "exec" and r.result.num_series == 1
        np.testing.assert_array_equal(r.result.values[0], 12.0)
        for q in (Q_SUM, 'heap_usage{_ns_="App-3"}',
                  "avg(heap_usage) by (host)"):
            assert_same_answer(svc.query_range(q, START + 600, 60,
                                               START + 2000),
                               ref_svc.query_range(q, START + 600, 60,
                                                   START + 2000), 2e-5)

    def test_leaves_go_to_their_owners(self, cluster_env):
        cluster = cluster_env
        svc = cluster.query_service(DS, device="cpu")
        ep = svc.planner.materialize(parse_query(
            "heap_usage", TimeStepParams(START, 60, START + 600)))
        disp = {c.shard: c.dispatcher for c in ep.children_plans}
        assert type(disp[0]).__name__ == "InProcessPlanDispatcher"
        assert isinstance(disp[2], NodeDispatcher)
        assert disp[2].node is cluster.nodes["node-b"]
        with pytest.raises(TypeError, match="no wire fields"):
            encode(disp[2])

    def test_query_all_series_found(self, cluster_env):
        svc = cluster_env.query_service(DS, device="cpu")
        r = svc.query_range('heap_usage{_ns_="App-3"}', START + 600, 300,
                            START + 1500)
        assert r.result.num_series == 12

    def test_a_dead_in_process_node_is_a_partial_answer(self, cluster_env):
        cluster = cluster_env
        svc = cluster.query_service(DS, device="cpu")
        cluster.nodes["node-b"].alive = False  # before the detector runs
        r = svc.query_range(Q_SUM, START + 600, 300, START + 1500)
        assert r.partial
        assert any("shards [2]" in w for w in r.warnings)
        assert any("shards [3]" in w for w in r.warnings)

    def test_node_kill_reassign_recover(self, cluster_env):
        cluster = cluster_env
        svc = cluster.query_service(DS, device="cpu")
        r1 = svc.query_range(Q_SUM, START + 600, 300, START + 1500)
        # flush, so recovery reads the shared store and skips what the
        # checkpoints cover
        for node in cluster.nodes.values():
            for shard in node.owned_shards(DS):
                node.memstores[DS].shards[shard].flush_all()
        cluster.start_failure_detector()
        killed = cluster.nodes["node-b"].owned_shards(DS)
        assert killed
        cluster.nodes["node-b"].kill()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if "node-b" not in cluster.nodes \
                    and cluster.wait_active(DS, 0.05):
                break
            time.sleep(0.02)
        assert "node-b" not in cluster.nodes
        owned = (cluster.nodes["node-a"].owned_shards(DS)
                 + cluster.nodes["node-c"].owned_shards(DS))
        assert sorted(owned) == list(range(NUM_SHARDS))
        r2 = cluster.query_service(DS, device="cpu").query_range(
            Q_SUM, START + 600, 300, START + 1500)
        np.testing.assert_allclose(r2.result.values, r1.result.values,
                                   rtol=1e-9)
        assert not r2.partial


class TestRemoteDispatch:
    def test_tcp_plan_shipping(self, raws, ref_svc):
        remote = port_store(raws, StoreConfig(**GAUGES))
        server = executor(remote)
        try:
            disp = RemotePlanDispatcher("127.0.0.1", server.port)
            assert disp.ping()
            planner = SingleClusterPlanner(NUM_SHARDS, spread=1,
                                           dispatcher_for_shard=lambda s:
                                           disp)
            q = "sum(heap_usage)"
            ep = planner.materialize(parse_query(
                q, TimeStepParams(START + 300, 60, START + 1000)))
            assert ep.pushdown  # every leaf leaves the process
            # an empty local store: all the data is remote
            ctx = ExecContext(MemStore(NUM_SHARDS, 1, dataset=DS),
                              dataset=DS)
            result = run_plan(ep, ctx).materialize()
            assert result.num_series == 1
            assert np.isfinite(result.values).all()
            assert ctx.stats.wire_bytes > 0
            assert_same_answer(result, ref_svc.query_range(
                q, START + 300, 60, START + 1000), 2e-5)
        finally:
            server.stop()
            reset_pool()

    def test_remote_error_propagates(self):
        server = executor(MemStore(1, 0, dataset=DS))
        try:
            from filodb_tpu_torch.query.exec.plan import (
                SelectRawPartitionsExec,
            )

            disp = RemotePlanDispatcher("127.0.0.1", server.port)
            leaf = SelectRawPartitionsExec(shard=9, filters=(),
                                           chunk_start=0, chunk_end=1)
            with pytest.raises(RuntimeError, match="remote execution failed"):
                disp.dispatch(leaf, ExecContext(None, dataset=DS))
        finally:
            server.stop()
            reset_pool()

    def test_ping_dead_server(self):
        assert not RemotePlanDispatcher("127.0.0.1", 1, timeout=0.3).ping()


# ---- two FiloServer processes over one WAL (tests/test_multiprocess.py:41) ------


def _get(port, path, **params):
    qs = urllib.parse.urlencode(params, doseq=True)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}?{qs}",
                                timeout=30) as r:
        return json.loads(r.read())


def _one_node_answer(wal_dir: str, q: str, t: int):
    """The query on one store that replayed every shard's log."""
    store = MemStore(NUM_SHARDS, 1, dataset=DS,
                     config=StoreConfig(max_chunk_size=100,
                                        groups_per_shard=2))
    for s in range(NUM_SHARDS):
        lg = SegmentedFileLog(os.path.join(wal_dir, DS, f"shard-{s}"),
                              read_only=True)
        for sd in lg.read_from(0):
            store.shards[s].ingest(sd)
        lg.close()
    return QueryService(store, device="cpu", engine="exec").query_range(
        q, t, 60, t)


def test_two_process_cluster(tmp_path):
    reset_breakers()
    wal_dir = str(tmp_path / "wal")
    exec_port = free_port()
    coord_cfg = {
        "node_name": "coord", "data_dir": str(tmp_path / "coord"),
        "wal_dir": wal_dir, "http_port": 0, "gateway_port": free_port(),
        "executor_port": exec_port, "http_response_cache": True,
        "datasets": {DS: {
            "num_shards": 4, "min_num_nodes": 2, "spread": 1,
            "store": {"max_chunk_size": 100, "groups_per_shard": 2,
                      "retention_ms": 2 ** 60}}},
    }
    member_cfg = {**coord_cfg, "node_name": "member-1",
                  "data_dir": str(tmp_path / "member"), "gateway_port": 0,
                  "executor_port": 0, "seeds": [f"127.0.0.1:{exec_port}"]}
    (tmp_path / "member.json").write_text(json.dumps(member_cfg))
    (tmp_path / "coord.json").write_text(json.dumps(coord_cfg))
    coord = FiloServer(ServerConfig.load(str(tmp_path / "coord.json")),
                       device="cpu").start()
    member_log = open(tmp_path / "member.log", "w")
    member = subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.standalone", "--config",
         str(tmp_path / "member.json"), "--device", "cpu"],
        cwd=ROOT, stdout=member_log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        sm = coord.cluster.shard_managers[DS]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if sm.mapper.owners == ["coord", "coord", "member-1",
                                    "member-1"] \
                    and coord.cluster.wait_active(DS, 0.05):
                break
            assert member.poll() is None, \
                (tmp_path / "member.log").read_text()[-3000:]
            time.sleep(0.1)
        assert coord.cluster.wait_active(DS, 1)
        assert coord.cluster.nodes["member-1"].owned_shards(DS) == [2, 3]
        # two namespaces, so both nodes' shards hold data
        with socket.create_connection(("127.0.0.1",
                                       coord.gateway.port)) as s:
            for i in range(200):
                for ns in ("App-0", "App-5"):
                    for inst in range(8):
                        ts_ns = (START + i * 10) * 1_000_000_000
                        s.sendall(f"cpu_usage,_ws_=demo,_ns_={ns},"
                                  f"instance=i{inst} value={i + inst} "
                                  f"{ts_ns}\n".encode())
        coord.gateway.sink.flush()
        q, t = "sum(cpu_usage) by (_ns_)", START + 1000
        path = f"/promql/{DS}/api/v1/query_range"
        deadline = time.monotonic() + 60
        body = None
        while time.monotonic() < deadline:
            body = _get(coord.http.port, path,
                        query="count(cpu_usage) by (_ns_)", start=t, end=t,
                        step=60)
            res = body["data"]["result"]
            if len(res) == 2 and all(float(r["values"][0][1]) == 8
                                     for r in res):
                break
            time.sleep(0.3)
        assert [float(r["values"][0][1]) for r in body["data"]["result"]] \
            == [8.0, 8.0]
        full = _get(coord.http.port, path, query=q, start=t, end=t, step=60,
                    stats="all")
        assert full["queryStats"]["wireBytes"] > 0
        assert "partial" not in full
        # the member's shards hold data, and its mirror of the map is the
        # coordinator's
        mport = coord.cluster.nodes["member-1"].executor_port
        ctl = RemotePlanDispatcher("127.0.0.1", mport)
        assert ctl.call("role") == ("member", "127.0.0.1", exec_port)
        assert coord.node.owned_shards(DS) == [0, 1]
        # equal to one node's answer over the same WAL
        want = _one_node_answer(wal_dir, q, t)
        got = {r["metric"]["_ns_"]: float(r["values"][0][1])
               for r in full["data"]["result"]}
        assert got == {k.label_map["_ns_"]: v[0] for k, v in
                       zip(want.result.keys, want.result.values)}
        # the remote shards keep the response cache out of the way
        assert not coord.services[DS].shards_local()
        # SIGKILL the member: the next answer is partial, naming its
        # shards (the detector held, so the member is not yet declared
        # down)
        coord.cluster.failure_threshold = 10 ** 6
        member.send_signal(signal.SIGKILL)
        member.wait(timeout=30)
        lost = _get(coord.http.port, path, query=q, start=t, end=t, step=60)
        assert lost.get("partial") is True
        assert any("shards [2]" in w for w in lost["warnings"])
        assert any("shards [3]" in w for w in lost["warnings"])
    finally:
        if member.poll() is None:
            member.kill()
            member.wait(timeout=30)
        member_log.close()
        coord.shutdown()
        reset_pool()
        reset_breakers()


def test_a_member_answers_cluster_status_from_its_mirror(tmp_path):
    """A member in this process (its own FiloServer) joined through
    ``seeds``: its ``/api/v1/cluster/{dataset}/status`` is the
    coordinator's map; the coordinator answers the shard commands as the
    reference's does (no shards named: none started; ``shardmap``: each
    shard's node and covered offset; ``migrate`` without a shard: 400),
    and a member, which holds no cluster, 404 for them."""
    reset_breakers()
    exec_port = free_port()
    base = {"wal_dir": str(tmp_path / "wal"), "http_port": 0,
            "datasets": {DS: {"num_shards": 2, "min_num_nodes": 2,
                              "spread": 0,
                              "store": {"retention_ms": 2 ** 60}}}}
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
        deadline = time.monotonic() + 30
        want = None
        while time.monotonic() < deadline:
            want = _get(coord.http.port, f"/api/v1/cluster/{DS}/status")
            got = _get(member.http.port, f"/api/v1/cluster/{DS}/status")
            if got == want and all(e["status"] == "active"
                                   for e in want["data"]):
                break
            time.sleep(0.2)
        assert got == want
        assert {e["node"] for e in want["data"]} == {"coord", "member"}
        assert member.services == {}  # a member serves no query API
        assert _get(coord.http.port, f"/api/v1/cluster/{DS}/startshards") \
            == {"status": "success", "data": []}
        shardmap = _get(coord.http.port, f"/api/v1/cluster/{DS}/shardmap")
        assert [(e["shard"], e["node"]) for e in
                shardmap["data"]["shards"]] == \
            [(e["shard"], e["node"]) for e in want["data"]]
        assert all("watermark" in e for e in shardmap["data"]["shards"])
        for port, path, code in (
                (coord.http.port, "migrate", 400),
                (member.http.port, "startshards", 404),
                (member.http.port, "migrate", 404)):
            try:
                _get(port, f"/api/v1/cluster/{DS}/{path}")
            except urllib.error.HTTPError as e:
                assert e.code == code, (path, e.code)
            else:
                raise AssertionError(f"{path} answered")
    finally:
        if member is not None:
            member.shutdown()
        coord.shutdown()
        reset_pool()
        reset_breakers()
