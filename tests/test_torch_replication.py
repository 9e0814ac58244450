"""Shard replicas on the port's cluster: followers, hedged reads,
failover as a map flip.

Mirrors ``tests/test_replication.py:177-630`` on the port's in-process
cluster (``coordinator/{replication,cluster,shardmapper}.py``), on the
CPU:

- followers bootstrap from the durable tier, reach IN_SYNC with their
  watermark at the log's head, and read for a leader that is down, with
  the reference's warning;
- a leader's loss promotes an in-sync follower with one sequenced
  ACTIVE event and zero object-store GETs (each node opens its own store
  over one bucket, so a follower's bootstrap GETs for real);
- the kill, detection, promotion and rejoin soak sees no failed and no
  wrong answer against an unkilled control cluster, no whole-object read
  of the durable tier across the flip (its queries' chunk reads on the
  host-decode lane are ranged and left out), and no divergence at its
  end;
- a deferred (rate-limited) reassignment skips a shard a promotion owns
  and promotes a follower caught up meanwhile;
- hedged reads: EWMA order, the hedge timer, failover on failure, open
  breakers to the back;
- the divergence check reports a stalled follower;
- replica events cross the two packages' shard-map feeds both ways.

Answers are held against the reference package's over the same
containers (``rtol=2e-5``) and against the cluster's own before a kill
(``rtol=1e-9``). The reference's tests arm ``lockcheck`` and
``racecheck`` around the cluster; these arm neither of the port's
(``utils/{lockcheck,racecheck}.py``, held on a node by
``tests/test_torch_{lockcheck,racecheck}.py``). Every wait is bounded by a deadline.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from filodb_tpu.coordinator.bootstrap import (
    ShardUpdateSubscriber as RefSubscriber,
)
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.coordinator.shard_manager import ShardManager as RefManager
from filodb_tpu.coordinator.shardmapper import ShardStatus as RefStatus
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.coordinator.bootstrap import ShardUpdateSubscriber
from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
from filodb_tpu_torch.coordinator.replication import (
    FOLLOWER_READS,
    HEDGED,
    HEDGED_WON,
    ReplicaCandidate,
    ReplicaDispatcher,
    assert_no_divergence,
    check_replicas,
)
from filodb_tpu_torch.coordinator.shardmapper import ShardManager, ShardStatus
from filodb_tpu_torch.core.record import BytesContainer
from filodb_tpu_torch.core.store.api import (
    InMemoryColumnStore,
    InMemoryMetaStore,
)
from filodb_tpu_torch.core.store.config import IngestionConfig, StoreConfig
from filodb_tpu_torch.core.store.objectstore import (
    GETS,
    ObjectStoreColumnStore,
    open_object_store,
)
from filodb_tpu_torch.kafka.log import InMemoryLog
from filodb_tpu_torch.query.exec.plan import PlanDispatcher
from filodb_tpu_torch.utils.metrics import get_counter
from filodb_tpu_torch.utils.resilience import (
    FaultInjector,
    breaker_for,
    record_peer_latency,
    reset_breakers,
    reset_peer_latency,
)
from test_torch_remote_dispatch import (
    DS,
    NUM_SHARDS,
    START,
    assert_same_answer,
    ref_store,
    routed,
)

GAUGES = dict(max_chunk_size=60, groups_per_shard=2)
QUERY = 'sum(heap_usage{_ns_="App-3"})'


@pytest.fixture(autouse=True)
def _clean():
    FaultInjector.reset()
    reset_breakers()
    reset_peer_latency()
    yield
    FaultInjector.reset()
    reset_breakers()
    reset_peer_latency()


def _stream(samples: int, start_s: int):
    return gauge_stream(machine_metrics_series(12, ns="App-3"), samples,
                        start_ms=start_s * 1000)


def _publish(logs, raws) -> None:
    for s, containers in raws.items():
        for raw in containers:
            logs[s].append(BytesContainer(raw))


@pytest.fixture(scope="module")
def raws():
    return routed([_stream(240, START)])


@pytest.fixture(scope="module")
def ref_svc(raws):
    return RefService(ref_store(raws, GAUGES), DS, NUM_SHARDS, spread=1)


@pytest.fixture
def replica_env(tmp_path, raws):
    """Three nodes, each over its own object store of one bucket, the
    four shards' logs, every shard ACTIVE."""
    logs = {s: InMemoryLog() for s in range(NUM_SHARDS)}
    _publish(logs, raws)
    cluster = FilodbCluster(replica_in_sync_lag=0,
                            replica_durable_sync_s=3600.0)
    stores = []
    for n in ("node-a", "node-b", "node-c"):
        cs, meta = open_object_store({"endpoint": None, "bucket": "t"},
                                     str(tmp_path))
        stores.append((cs, meta))
        cluster.join(Node(n, cs, meta))
    cluster.setup_dataset(IngestionConfig(DS, NUM_SHARDS, min_num_nodes=2,
                                          store=StoreConfig(**GAUGES)), logs)
    assert cluster.wait_active(DS, 15)
    yield cluster, logs
    cluster.stop()
    for cs, meta in stores:
        cs.close()
        meta.close()


def _query(cluster):
    svc = cluster.query_service(DS, device="cpu")
    return svc.query_range(QUERY, START + 600, 300, START + 1500)


def _flush_leaders(cluster) -> None:
    """Every leader's data sealed and uploaded: the followers bootstrap
    from segments the flip must not read again."""
    for node in cluster.nodes.values():
        for shard in node.owned_shards(DS):
            node.memstores[DS].shards[shard].flush_all()
        node.column_store.flush()


def _wait_in_sync(cluster, timeout: float = 30.0, drive: bool = True):
    sm = cluster.shard_managers[DS]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(sm.mapper.in_sync_followers(s) for s in range(NUM_SHARDS)):
            return
        if drive:
            cluster.ensure_replicas(DS)
        time.sleep(0.05)
    pytest.fail(f"replicas never in-sync: {sm.mapper.snapshot()}")


def _wait_caught_up(cluster, logs, timeout: float = 20.0):
    sm = cluster.shard_managers[DS]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(any(st.status == ShardStatus.IN_SYNC
                   and st.watermark >= logs[s].latest_offset
                   for st in sm.mapper.replicas_of(s).values())
               for s in range(NUM_SHARDS)):
            return
        time.sleep(0.05)
    pytest.fail(f"followers never caught up: {sm.mapper.snapshot()}")


class TestReplicaLifecycle:
    def test_followers_reach_in_sync(self, replica_env, ref_svc):
        cluster, logs = replica_env
        cluster.replication = 1
        cluster.ensure_replicas(DS)
        _wait_in_sync(cluster)
        sm = cluster.shard_managers[DS]
        for s in range(NUM_SHARDS):
            owner = sm.mapper.node_for(s)
            followers = sm.mapper.in_sync_followers(s)
            assert followers and owner not in followers
            name = followers[0]
            # read-only: never an ingest worker of the follower's node
            assert (DS, s) not in cluster.nodes[name]._workers
            assert sm.mapper.replicas_of(s)[name].watermark == \
                logs[s].latest_offset
            lshard = cluster.nodes[owner].memstores[DS].shards[s]
            fshard = cluster.nodes[name].memstores[DS].shards[s]
            assert fshard.num_partitions == lshard.num_partitions
        snap = cluster.shard_statuses(DS)
        assert all(e.get("replicas") for e in snap), snap
        assert check_replicas(cluster, DS) == []
        assert_same_answer(_query(cluster),
                           ref_svc.query_range(QUERY, START + 600, 300,
                                               START + 1500), 2e-5)

    def test_unhealthy_leader_served_by_follower_with_warning(
            self, replica_env):
        cluster, _ = replica_env
        baseline = _query(cluster)
        cluster.replication = 1
        cluster.ensure_replicas(DS)
        _wait_in_sync(cluster)
        owner = cluster.shard_managers[DS].mapper.node_for(0)
        cluster.nodes[owner].alive = False  # down, not yet detected
        try:
            r = _query(cluster)
            assert any("served by follower" in w for w in r.warnings), \
                r.warnings
            np.testing.assert_allclose(r.result.values,
                                       baseline.result.values, rtol=1e-9)
        finally:
            cluster.nodes[owner].alive = True
        reset_breakers()  # the failures counted against the leader
        assert not any("served by follower" in w
                       for w in _query(cluster).warnings)


class TestPromotionMapFlip:
    def test_zero_get_flip(self, replica_env):
        cluster, _ = replica_env
        baseline = _query(cluster)
        _flush_leaders(cluster)
        cluster.replication = 1
        cluster.ensure_replicas(DS)
        _wait_in_sync(cluster)
        sm = cluster.shard_managers[DS]
        a_shards = sm.mapper.shards_of("node-a")
        assert a_shards
        expected = {s: sm.mapper.in_sync_followers(s)[0] for s in a_shards}
        promotions = get_counter("filodb_replica_promotions", {"dataset": DS})
        prom0, gets0 = promotions.value, GETS.value
        _, seq0, _, _ = sm.events_since(0)
        cluster.leave("node-a")
        # no manifest refresh, no index recovery, no segment replay
        assert GETS.value == gets0
        assert promotions.value - prom0 == len(a_shards)
        events, _, resynced, _ = sm.events_since(seq0)
        assert not resynced
        for s, follower in expected.items():
            # the flip is one sequenced ACTIVE event, with no DOWN or
            # ASSIGNED window (the promoted worker's own ACTIVE report,
            # at its catch-up, may follow it)
            flips = [e for e in events if e.shard == s and not e.replica]
            assert flips and {(e.status, e.node) for e in flips} == \
                {(ShardStatus.ACTIVE, follower)}
            assert sm.mapper.node_for(s) == follower
            assert sm.mapper.statuses[s] == ShardStatus.ACTIVE
            assert follower not in sm.mapper.replicas_of(s)
            assert (DS, s) in cluster.nodes[follower]._workers
            assert (DS, s, follower) not in cluster.replica_syncers
        np.testing.assert_allclose(_query(cluster).result.values,
                                   baseline.result.values, rtol=1e-9)


class TestKillNodeSoak:
    """A node killed under continuous queries: no failed and no wrong
    answer against an unkilled control, a rejoin as a follower, no
    divergence at the end."""

    def test_kill_promote_rejoin_soak(self, replica_env, monkeypatch):
        cluster, logs = replica_env
        sm = cluster.shard_managers[DS]
        control = FilodbCluster()
        control.join(Node("control", InMemoryColumnStore(),
                          InMemoryMetaStore()))
        control.setup_dataset(
            IngestionConfig(DS, NUM_SHARDS, min_num_nodes=1,
                            store=StoreConfig(**GAUGES)), logs)
        assert control.wait_active(DS, 15)
        baseline = control.query_service(DS, device="cpu").query_range(
            QUERY, START + 600, 300, START + 1500).result.values
        control.stop()
        np.testing.assert_allclose(_query(cluster).result.values, baseline,
                                   rtol=1e-9)
        _flush_leaders(cluster)
        cluster.replication = 1
        cluster.ensure_replicas(DS)
        _wait_in_sync(cluster)
        # a batch past the queries' window: the followers ingest after
        # their bootstrap, the oracle stays as it was
        _publish(logs, routed([_stream(60, START + 2400)]))
        _wait_caught_up(cluster, logs)
        a_shards = sm.mapper.shards_of("node-a")
        assert a_shards
        promotions = get_counter("filodb_replica_promotions", {"dataset": DS})
        prom0 = promotions.value
        # placement frozen across the kill: the only store reads the flip
        # could make are its own
        cluster.replication = 0
        cluster.start_failure_detector()
        stats = {"ok": 0, "bad": 0, "fail": []}
        stop_ev = threading.Event()

        def soak():
            while not stop_ev.is_set():
                try:
                    vals = _query(cluster).result.values
                except Exception as e:  # noqa: BLE001 - tallied below
                    stats["fail"].append(repr(e))
                    continue
                if vals.shape == baseline.shape and \
                        np.allclose(vals, baseline, rtol=1e-9):
                    stats["ok"] += 1
                else:
                    stats["bad"] += 1

        # a recovery reads whole objects (the manifest, the checkpoints,
        # the index snapshot, every segment); the soak's queries read
        # ranges of chunks on the host-decode lane, which the flip's
        # accounting leaves out
        whole = []
        get_raw = ObjectStoreColumnStore._get_raw

        def counted(store, key, start=None, length=None):
            if start is None and length is None:
                whole.append(key)
            return get_raw(store, key, start, length)

        monkeypatch.setattr(ObjectStoreColumnStore, "_get_raw", counted)
        t = threading.Thread(target=soak, daemon=True, name="soak")
        t.start()
        time.sleep(0.3)
        node_a = cluster.nodes["node-a"]
        node_a.kill()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if "node-a" not in cluster.nodes and all(
                    sm.mapper.node_for(s) not in (None, "node-a")
                    and sm.mapper.statuses[s] == ShardStatus.ACTIVE
                    for s in range(NUM_SHARDS)):
                break
            time.sleep(0.02)
        else:
            pytest.fail(f"failover never settled: {sm.mapper.snapshot()}")
        time.sleep(0.5)  # queries well past the flip
        stop_ev.set()
        t.join(timeout=10)
        assert stats["fail"] == [], stats["fail"]
        assert stats["bad"] == 0
        assert stats["ok"] >= 5, stats
        assert whole == []  # the flip read nothing of the durable tier
        assert promotions.value - prom0 == len(a_shards)
        assert not any(k[2] == "node-a" for k in cluster.replica_syncers)
        r = _query(cluster)
        assert not any("served by follower" in w for w in r.warnings)
        np.testing.assert_allclose(r.result.values, baseline, rtol=1e-9)
        # the rejoin: a follower again, over its warm image. node-a is a
        # member before followers are wanted, so no heartbeat in between
        # hands every slot to node-b and node-c
        node_a.alive = True
        cluster.join(node_a)
        cluster.replication = 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(sm.mapper.in_sync_followers(s)
                   for s in range(NUM_SHARDS)) \
                    and sm.mapper.follower_shards("node-a"):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"rejoin never converged: {sm.mapper.snapshot()}")
        assert sm.mapper.shards_of("node-a") == []
        np.testing.assert_allclose(_query(cluster).result.values, baseline,
                                   rtol=1e-9)
        assert_no_divergence(cluster, DS, timeout_s=15)


class TestFollowerPlacement:
    """§C.17: one ``ensure_replicas`` pass that fills many shards spreads
    their followers over the members, counting the syncers still
    bootstrapping; a member that joined last gets its share."""

    def test_bootstrapping_followers_count_toward_a_members_load(
            self, monkeypatch):
        import filodb_tpu_torch.coordinator.cluster as cluster_mod

        # the syncers stay bootstrapping: none reports into the map
        monkeypatch.setattr(cluster_mod.ReplicaSyncer, "start",
                            lambda self: self)
        cluster = FilodbCluster()
        for name in ("node-b", "node-c", "node-a"):
            cluster.join(Node(name, InMemoryColumnStore(),
                              InMemoryMetaStore()))
        cluster.setup_dataset(
            IngestionConfig(DS, NUM_SHARDS, min_num_nodes=2,
                            store=StoreConfig(**GAUGES)),
            {s: InMemoryLog() for s in range(NUM_SHARDS)})
        try:
            # node-a leads nothing, as after the soak's kill and rejoin
            sm = cluster.shard_managers[DS]
            assert sm.mapper.shards_of("node-a") == []
            cluster.replication = 1
            cluster.ensure_replicas(DS)
            load = {n: 0 for n in cluster.nodes}
            for (_d, _s, n) in cluster.replica_syncers:
                load[n] += 1
            assert len(cluster.replica_syncers) == NUM_SHARDS, load
            assert load["node-a"] >= 1, load
            assert max(load.values()) - min(load.values()) <= 1, load
        finally:
            cluster.replica_syncers.clear()
            cluster.stop()


class TestDeferredPromotionRaces:
    """A deferred shard is not assigned again over a leader a promotion
    made meanwhile."""

    def _two_losses(self, interval: float = 0.2):
        sm = ShardManager("ds", 4, min_num_nodes=2,
                          reassignment_min_interval_s=interval)
        for n in ("n1", "n2", "n3", "n4"):
            sm.add_member(n)
        lost = sm.mapper.shards_of("n1")
        sm.remove_member("n1")
        victim = sm.mapper.node_for(lost[0])
        relost = sm.mapper.shards_of(victim)
        sm.remove_member(victim)  # inside the interval: deferred
        assert set(relost) <= sm._deferred
        return sm, relost

    def test_deferred_skips_shard_promotion_already_owns(self):
        sm, relost = self._two_losses()
        s0, survivor = relost[0], sm.nodes[0]
        sm.promote(s0, survivor)
        time.sleep(0.25)
        events = sm.check_deferred()
        assert not any(e.shard == s0 and e.status == ShardStatus.ASSIGNED
                       for e in events), events
        assert sm.mapper.node_for(s0) == survivor
        assert s0 not in sm._deferred

    def test_deferred_promotes_caught_up_follower(self):
        sm, relost = self._two_losses()
        s0, survivor = relost[0], sm.nodes[0]
        sm.replica_update(s0, survivor, ShardStatus.IN_SYNC, watermark=7)
        time.sleep(0.25)
        flips = [e for e in sm.check_deferred()
                 if e.shard == s0 and not e.replica]
        assert flips and flips[0].status == ShardStatus.ACTIVE
        assert flips[0].node == survivor
        assert sm.mapper.node_for(s0) == survivor
        assert survivor not in sm.mapper.replicas_of(s0)
        assert s0 not in sm._deferred

    @pytest.mark.parametrize("with_follower", [False, True])
    def test_manager_agrees_with_the_reference(self, with_follower):
        """The same losses on both packages' managers give the same map,
        follower sets and events."""
        maps = []
        for cls in (ShardManager, RefManager):
            sm = cls("ds", 8, min_num_nodes=2)
            for n in ("n1", "n2", "n3"):
                sm.add_member(n)
            status = RefStatus if cls is RefManager else ShardStatus
            if with_follower:
                for s in sm.mapper.shards_of("n1"):
                    sm.replica_update(s, "n3", status.IN_SYNC, watermark=s)
            evs = sm.remove_member("n1")
            maps.append((sm.mapper.snapshot(),
                         [(e.shard, e.status.name, e.node, e.replica,
                           e.watermark) for e in evs]))
        assert maps[0] == maps[1]


class _StubDispatcher(PlanDispatcher):
    def __init__(self, result, delay=0.0, error=None):
        self.result, self.delay, self.error = result, delay, error
        self.calls = 0

    def dispatch(self, plan, ctx):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        if self.error:
            raise self.error
        return self.result


class TestHedgedReads:
    def test_hedge_timer_launches_follower_and_wins(self):
        rd = ReplicaDispatcher(0, [
            ReplicaCandidate("hx-leader", _StubDispatcher("leader",
                                                          delay=0.5)),
            ReplicaCandidate("hx-follower", _StubDispatcher("follower"),
                             follower=True),
        ], hedge_timeout_s=0.02)
        h0, w0, f0 = HEDGED.value, HEDGED_WON.value, FOLLOWER_READS.value
        assert rd.dispatch(None, None) == "follower"
        assert HEDGED.value - h0 == 1
        assert HEDGED_WON.value - w0 == 1
        assert FOLLOWER_READS.value - f0 == 1

    def test_failure_failover_is_not_hedged(self):
        rd = ReplicaDispatcher(0, [
            ReplicaCandidate("hf-leader", _StubDispatcher(
                None, error=ConnectionError("down"))),
            ReplicaCandidate("hf-follower", _StubDispatcher("follower"),
                             follower=True),
        ], hedge_timeout_s=5.0)
        h0 = HEDGED.value
        assert rd.dispatch(None, None) == "follower"
        assert HEDGED.value == h0

    def test_all_replicas_failing_raises(self):
        rd = ReplicaDispatcher(0, [
            ReplicaCandidate("af-a", _StubDispatcher(
                None, error=ConnectionError("a"))),
            ReplicaCandidate("af-b", _StubDispatcher(
                None, error=ConnectionError("b")), follower=True),
        ], hedge_timeout_s=0.01)
        with pytest.raises(ConnectionError):
            rd.dispatch(None, None)

    def test_open_breaker_candidate_goes_last(self):
        breaker_for("ob-leader").force_open()
        a, b = _StubDispatcher("leader"), _StubDispatcher("follower")
        rd = ReplicaDispatcher(0, [
            ReplicaCandidate("ob-leader", a),
            ReplicaCandidate("ob-follower", b, follower=True),
        ], hedge_timeout_s=5.0)
        assert rd.dispatch(None, None) == "follower"
        assert a.calls == 0

    def test_ewma_latency_orders_candidates(self):
        record_peer_latency("ew-slow", 0.5)
        record_peer_latency("ew-fast", 0.001)
        rd = ReplicaDispatcher(0, [
            ReplicaCandidate("ew-slow", _StubDispatcher("s")),
            ReplicaCandidate("ew-fast", _StubDispatcher("f"),
                             follower=True),
        ])
        assert [c.key for c in rd._ordered()] == ["ew-fast", "ew-slow"]
        reset_peer_latency()  # unknown: the leader first
        assert [c.key for c in rd._ordered()] == ["ew-slow", "ew-fast"]


class TestRemoteLeader:
    def test_a_remote_leader_serves_the_read(self, raws, ref_svc):
        """ROADMAP §C.16: a replica read whose leader is in another
        process ships the leaf naming the leader's dispatcher, and the
        leader answers (the follower here would fail)."""
        from filodb_tpu_torch.coordinator.query_service import QueryService
        from filodb_tpu_torch.coordinator.remote import (
            RemotePlanDispatcher,
            reset_pool,
        )
        from test_torch_remote_dispatch import executor, port_store

        store = port_store(raws, StoreConfig(**GAUGES))
        srv = executor(store)
        try:
            leader = RemotePlanDispatcher("127.0.0.1", srv.port)
            svc = QueryService(port_store(raws, StoreConfig(**GAUGES)),
                               device="cpu", engine="exec")
            svc.planner.dispatcher_for_shard = lambda s: ReplicaDispatcher(
                s, [ReplicaCandidate(leader.peer, leader, guard=False),
                    ReplicaCandidate("rl-follower", _StubDispatcher(
                        None, error=ConnectionError("follower")),
                        follower=True)], hedge_timeout_s=30.0)
            f0 = FOLLOWER_READS.value
            got = svc.query_range(QUERY, START + 600, 300, START + 1500)
            assert FOLLOWER_READS.value == f0
            assert got.stats.wire_bytes > 0
            assert_same_answer(got, ref_svc.query_range(
                QUERY, START + 600, 300, START + 1500), 2e-5)
        finally:
            srv.stop()
            reset_pool()


class TestDivergenceCheck:
    def test_stalled_follower_reported(self, replica_env):
        cluster, logs = replica_env
        cluster.replication = 1
        cluster.ensure_replicas(DS)
        _wait_in_sync(cluster)
        div = get_counter("filodb_replica_divergence")
        div0 = div.value
        key = next(k for k in cluster.replica_syncers
                   if logs[k[1]].latest_offset >= 0)
        _, stalled_shard, stalled_node = key
        cluster.replica_syncers[key].stop()
        _publish(logs, routed([_stream(20, START + 2400)]))
        deadline = time.monotonic() + 10
        found = []
        while time.monotonic() < deadline:
            found = [i for i in check_replicas(cluster, DS)
                     if i["shard"] == stalled_shard
                     and i["follower"] == stalled_node
                     and i["kind"] == "watermark_lag"]
            if found:
                break
            time.sleep(0.05)
        assert found, "the stalled follower was never reported"
        assert div.value > div0


class _Feed:
    """A manager's ``events_since`` as the executor's control call
    serves it (6-tuples)."""

    def __init__(self, sm):
        self.sm = sm

    def call(self, method, dataset, since_seq, epoch):
        assert method == "shard_events"
        events, seq, resynced, ep = self.sm.events_since(since_seq, epoch)
        return ([(e.shard, e.status.name, e.node, e.progress, e.replica,
                  e.watermark) for e in events], seq, resynced, ep)


_PAIRS = [(ShardManager, ShardUpdateSubscriber, ShardStatus),
          (RefManager, ShardUpdateSubscriber, RefStatus),
          (ShardManager, RefSubscriber, ShardStatus)]


class TestReplicaEventWire:
    @pytest.mark.parametrize("manager,subscriber,status", _PAIRS,
                             ids=["port-port", "ref-to-port", "port-to-ref"])
    def test_replica_events_mirror_round_trip(self, manager, subscriber,
                                              status):
        sm = manager("ds", 4, min_num_nodes=1)
        sm.add_member("n1")
        sub = subscriber("ds", 4, _Feed(sm))
        sub.poll()
        assert sub.mapper.node_for(0) == "n1"
        sm.replica_update(0, "n2", status.FOLLOWING, watermark=3)
        sm.replica_update(0, "n2", status.IN_SYNC, watermark=9)
        sub.poll()
        st = sub.mapper.replicas_of(0)["n2"]
        assert st.status.name == "IN_SYNC" and st.watermark == 9
        assert sub.mapper.in_sync_followers(0) == ["n2"]
        sm.drop_replica(0, "n2")
        sub.poll()
        assert sub.mapper.replicas_of(0) == {}
        # a resync's snapshot carries the replica sets too
        sm.replica_update(1, "n3", status.IN_SYNC, watermark=4)
        fresh = subscriber("ds", 4, _Feed(sm))
        fresh.poll()
        assert fresh.mapper.in_sync_followers(1) == ["n3"]

    def test_legacy_four_tuple_events_still_apply(self):
        class _Legacy:
            def call(self, *_):
                return [(0, "ACTIVE", "n1", 100)], 1, False, "e1"

        sub = ShardUpdateSubscriber("ds", 4, _Legacy())
        sub.poll()
        assert sub.mapper.node_for(0) == "n1"
        assert sub.mapper.statuses[0] == ShardStatus.ACTIVE
