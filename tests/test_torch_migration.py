"""Live shard migration on the port's cluster.

Mirrors ``tests/test_migration.py:109-307, 365-`` on the port's
in-process cluster (``coordinator/{migration,cluster,shardmapper}.py``),
on the CPU:

- a shard moves through PLANNED → SYNCING → CATCHUP → FLIPPING → DONE and
  the answers before and after agree; the same node is refused;
- the manifest round-trips, and its bytes are the reference's for the
  same migration, so a coordinator of either package resumes the other's
  (a reference coordinator resumes one the port planned);
- the migration killed at every ``KILL_POINTS`` site: answers stay equal to
  an unmigrated control's, and ``resume`` finishes the move from the
  durable manifest with no acknowledged sample lost;
- abort returns the shard to its source; a query during HANDOFF carries
  the reference's recovery warning; a rate-limited reassignment is
  deferred and retried; rebalance plans level the counts, and a join
  under ``auto_rebalance`` migrates a shard to the joiner;
- the local-disk and object stores keep manifests durably, in the
  reference's files.

The reference's tests arm ``lockcheck`` and ``racecheck``; these arm
neither of the port's (``utils/{lockcheck,racecheck}.py``, held on a
node by ``tests/test_torch_{lockcheck,racecheck}.py``). Answers are held against the reference
package's over the same containers at ``rtol=2e-5`` and against the
cluster's own at ``rtol=1e-9``. Every wait is bounded by a deadline.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from filodb_tpu.coordinator.cluster import FilodbCluster as RefCluster
from filodb_tpu.coordinator.cluster import Node as RefNode
from filodb_tpu.coordinator.migration import (
    MigrationManifest as RefManifest,
)
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.record import BytesContainer as RefBytes
from filodb_tpu.core.store.api import InMemoryColumnStore as RefColumnStore
from filodb_tpu.core.store.api import InMemoryMetaStore as RefMetaStore
from filodb_tpu.core.store.config import IngestionConfig as RefIngestion
from filodb_tpu.core.store.config import StoreConfig as RefStoreConfig
from filodb_tpu.core.store.localstore import (
    LocalDiskColumnStore as RefLocalStore,
)
from filodb_tpu.core.store.objectstore import (
    open_object_store as ref_open_object_store,
)
from filodb_tpu.kafka.log import InMemoryLog as RefLog
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
from filodb_tpu_torch.coordinator.migration import (
    ABORTED,
    DONE,
    KILL_POINTS,
    MigrationManifest,
    ShardMigration,
)
from filodb_tpu_torch.coordinator.shardmapper import ShardManager, ShardStatus
from filodb_tpu_torch.core.record import BytesContainer
from filodb_tpu_torch.core.store.api import (
    InMemoryColumnStore,
    InMemoryMetaStore,
)
from filodb_tpu_torch.core.store.config import IngestionConfig, StoreConfig
from filodb_tpu_torch.core.store.localstore import LocalDiskColumnStore
from filodb_tpu_torch.core.store.objectstore import open_object_store
from filodb_tpu_torch.kafka.log import InMemoryLog
from filodb_tpu_torch.utils.resilience import FaultInjector
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
def _clean_faults():
    FaultInjector.reset()
    yield
    FaultInjector.reset()


@pytest.fixture(scope="module")
def raws():
    return routed([gauge_stream(machine_metrics_series(12, ns="App-3"), 240,
                                start_ms=START * 1000)])


@pytest.fixture(scope="module")
def ref_svc(raws):
    return RefService(ref_store(raws, GAUGES), DS, NUM_SHARDS, spread=1)


def _logs(raws, log_cls=InMemoryLog, bytes_cls=BytesContainer) -> dict:
    logs = {s: log_cls() for s in range(NUM_SHARDS)}
    for s, containers in raws.items():
        for raw in containers:
            logs[s].append(bytes_cls(raw))
    return logs


@pytest.fixture
def cluster_env(raws):
    cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
    cluster = FilodbCluster()
    for n in ("node-a", "node-b"):
        cluster.join(Node(n, cs, meta))
    cluster.setup_dataset(IngestionConfig(DS, NUM_SHARDS, min_num_nodes=2,
                                          store=StoreConfig(**GAUGES)),
                          _logs(raws))
    assert cluster.wait_active(DS, 10)
    yield cluster, cs
    cluster.stop()


def _query(cluster):
    svc = cluster.query_service(DS, device="cpu")
    return svc.query_range(QUERY, START + 600, 300, START + 1500)


def _pick_shard(cluster, owner: str = "node-a") -> int:
    shards = cluster.shard_managers[DS].mapper.shards_of(owner)
    assert shards, f"{owner} owns no shards"
    return shards[0]


class TestBasicMigration:
    def test_migrate_and_query_equivalence(self, cluster_env, ref_svc):
        cluster, cs = cluster_env
        before = _query(cluster)
        shard = _pick_shard(cluster, "node-a")
        mig = cluster.migrate_shard(DS, shard, "node-b")
        sm = cluster.shard_managers[DS]
        assert mig.phase == DONE
        assert sm.mapper.node_for(shard) == "node-b"
        assert sm.mapper.statuses[shard] == ShardStatus.ACTIVE
        assert (DS, shard) not in cluster.nodes["node-a"]._workers
        assert (DS, shard) in cluster.nodes["node-b"]._workers
        assert cs.read_migration_manifest(DS, shard) is None
        after = _query(cluster)
        np.testing.assert_allclose(after.result.values,
                                   before.result.values, rtol=1e-9)
        assert_same_answer(after, ref_svc.query_range(
            QUERY, START + 600, 300, START + 1500), 2e-5)

    def test_same_node_rejected(self, cluster_env):
        cluster, _ = cluster_env
        shard = _pick_shard(cluster, "node-a")
        with pytest.raises(ValueError):
            cluster.migrate_shard(DS, shard, "node-a")

    def test_manifest_roundtrip(self):
        m = MigrationManifest("ds", 3, "a", "b", "catchup", 5, 10, 20)
        assert MigrationManifest.from_bytes(m.to_bytes()) == m

    @pytest.mark.parametrize("phase", ["planned", "syncing", "catchup",
                                       "flipping", "done", "aborted"])
    def test_manifest_bytes_are_the_reference(self, phase):
        args = (DS, 2, "node-a", "node-b", phase, 3, 1_700_000_000_000,
                1_700_000_000_500)
        ours, theirs = MigrationManifest(*args), RefManifest(*args)
        assert ours.to_bytes() == theirs.to_bytes()
        back = MigrationManifest.from_bytes(theirs.to_bytes())
        assert back == ours
        assert RefManifest.from_bytes(ours.to_bytes()) == theirs


class TestKillPointChaos:
    """The migration killed at each named transition: answers stay right
    throughout, and resume finishes the move from the manifest."""

    @pytest.mark.parametrize("site", KILL_POINTS)
    def test_kill_and_resume(self, cluster_env, site):
        cluster, cs = cluster_env
        control = _query(cluster)
        shard = _pick_shard(cluster, "node-a")
        FaultInjector.arm(site, error=RuntimeError, times=1)
        with pytest.raises(RuntimeError):
            cluster.migrate_shard(DS, shard, "node-b")
        mid = _query(cluster)
        np.testing.assert_allclose(mid.result.values,
                                   control.result.values, rtol=1e-9)
        assert cs.read_migration_manifest(DS, shard) is not None
        mig = cluster.resume_migration(DS, shard)
        assert mig is not None and mig.phase == DONE
        sm = cluster.shard_managers[DS]
        assert sm.mapper.node_for(shard) == "node-b"
        assert sm.mapper.statuses[shard] == ShardStatus.ACTIVE
        assert cs.read_migration_manifest(DS, shard) is None
        after = _query(cluster)
        np.testing.assert_allclose(after.result.values,
                                   control.result.values, rtol=1e-9)
        # every acknowledged sample is on the destination: its shard
        # holds each series' rows the source held
        dst = cluster.nodes["node-b"].memstores[DS].shards[shard]
        src = cluster.nodes["node-a"].memstores[DS].shards[shard]
        assert dst.num_partitions == src.num_partitions
        assert cluster.nodes["node-b"].shard_offset(DS, shard) == \
            cluster.logs[(DS, shard)].latest_offset

    def test_resume_without_manifest_is_noop(self, cluster_env):
        cluster, _ = cluster_env
        assert cluster.resume_migration(DS, 0) is None


class TestAcrossPackages:
    def test_reference_coordinator_resumes_the_ports_migration(self, raws):
        """The port plans a migration and dies after the plan; a
        reference coordinator over the same durable manifest finishes
        it."""
        cs, meta = InMemoryColumnStore(), InMemoryMetaStore()
        port = FilodbCluster()
        for n in ("node-a", "node-b"):
            port.join(Node(n, cs, meta))
        port.setup_dataset(IngestionConfig(DS, NUM_SHARDS, min_num_nodes=2,
                                           store=StoreConfig(**GAUGES)),
                           _logs(raws))
        try:
            assert port.wait_active(DS, 10)
            shard = _pick_shard(port, "node-a")
            FaultInjector.arm("migration.plan", error=RuntimeError, times=1)
            with pytest.raises(RuntimeError):
                port.migrate_shard(DS, shard, "node-b")
            planned = cs.read_migration_manifest(DS, shard)
        finally:
            port.stop()
        assert MigrationManifest.from_bytes(planned).phase == "planned"
        rcs, rmeta = RefColumnStore(), RefMetaStore()
        ref = RefCluster()
        for n in ("node-a", "node-b"):
            ref.join(RefNode(n, TimeSeriesMemStore(rcs, rmeta)))
        ref.setup_dataset(RefIngestion(DS, NUM_SHARDS, min_num_nodes=2,
                                       store=RefStoreConfig(**GAUGES)),
                          _logs(raws, RefLog, RefBytes))
        try:
            assert ref.wait_active(DS, 10)
            assert ref.shard_managers[DS].mapper.node_for(shard) == "node-a"
            rcs.write_migration_manifest(DS, shard, planned)
            mig = ref.resume_migration(DS, shard)
            assert mig is not None and mig.phase == "done"
            assert ref.shard_managers[DS].mapper.node_for(shard) == "node-b"
            assert rcs.read_migration_manifest(DS, shard) is None
        finally:
            ref.stop()

    def test_local_manifests_cross_packages(self, tmp_path):
        root = str(tmp_path / "columnstore")
        ours, theirs = LocalDiskColumnStore(root), RefLocalStore(root)
        try:
            ours.write_migration_manifest(DS, 1, b'{"phase": "syncing"}')
            assert theirs.read_migration_manifest(DS, 1) == \
                b'{"phase": "syncing"}'
            theirs.write_migration_manifest(DS, 2, b'{"phase": "flipping"}')
            assert ours.read_migration_manifest(DS, 2) == \
                b'{"phase": "flipping"}'
            theirs.delete_migration_manifest(DS, 1)
            assert ours.read_migration_manifest(DS, 1) is None
        finally:
            ours.close()
            theirs.close()

    def test_object_manifests_cross_packages(self, tmp_path):
        cs, meta = open_object_store({"endpoint": None, "bucket": "t"},
                                     str(tmp_path))
        rcs, rmeta = ref_open_object_store({"endpoint": None, "bucket": "t"},
                                           str(tmp_path))
        try:
            cs.write_migration_manifest(DS, 3, b'{"phase": "catchup"}')
            assert rcs.read_migration_manifest(DS, 3) == \
                b'{"phase": "catchup"}'
            rcs.delete_migration_manifest(DS, 3)
            assert cs.read_migration_manifest(DS, 3) is None
        finally:
            for s in (cs, meta, rcs, rmeta):
                s.close()


class TestAbort:
    def test_abort_rolls_back_to_source(self, cluster_env):
        cluster, cs = cluster_env
        control = _query(cluster)
        shard = _pick_shard(cluster, "node-a")
        FaultInjector.arm("migration.catchup", error=RuntimeError, times=1)
        with pytest.raises(RuntimeError):
            cluster.migrate_shard(DS, shard, "node-b")
        mig = cluster.migrations[(DS, shard)]
        mig.abort()
        assert mig.phase == ABORTED
        sm = cluster.shard_managers[DS]
        assert sm.mapper.node_for(shard) == "node-a"
        assert sm.mapper.statuses[shard] == ShardStatus.ACTIVE
        assert (DS, shard) not in cluster.nodes["node-b"]._workers
        assert cs.read_migration_manifest(DS, shard) is None
        np.testing.assert_allclose(_query(cluster).result.values,
                                   control.result.values, rtol=1e-9)


class TestRecoveryWarnings:
    def test_handoff_query_carries_warning(self, cluster_env):
        cluster, _ = cluster_env
        sm = cluster.shard_managers[DS]
        shard = _pick_shard(cluster, "node-a")
        sm.begin_handoff(shard, "node-a")
        try:
            r = _query(cluster)
            assert f"shard {shard} recovering (handoff): results may lag " \
                   f"live ingest" in r.warnings, r.warnings
        finally:
            sm.abort_handoff(shard, "node-a")
        assert not any("recovering" in w for w in _query(cluster).warnings)

    def test_handoff_is_queryable(self):
        assert ShardStatus.HANDOFF.queryable


class TestDeferredReassignment:
    def test_deferred_then_reassigned(self):
        sm = ShardManager("ds", 4, min_num_nodes=2,
                          reassignment_min_interval_s=0.3)
        for n in ("n1", "n2", "n3", "n4"):
            sm.add_member(n)
        lost = sm.mapper.shards_of("n1")
        assert lost
        sm.remove_member("n1")
        victim = sm.mapper.node_for(lost[0])
        relost = sm.mapper.shards_of(victim)
        sm.remove_member(victim)
        assert set(relost) <= sm._deferred
        for s in relost:
            assert sm.mapper.node_for(s) is None
        time.sleep(0.35)
        sm.add_member("n1")
        assert not sm._deferred
        assert sm.mapper.unassigned_shards() == []

    def test_check_deferred_respects_interval(self):
        sm = ShardManager("ds", 4, min_num_nodes=2,
                          reassignment_min_interval_s=30.0)
        for n in ("n1", "n2", "n3", "n4"):
            sm.add_member(n)
        lost = sm.mapper.shards_of("n1")
        sm.remove_member("n1")
        victim = sm.mapper.node_for(lost[0])
        relost = sm.mapper.shards_of(victim)
        sm.remove_member(victim)
        assert set(relost) <= sm._deferred
        assert sm.check_deferred() == []
        assert set(relost) <= sm._deferred


class TestRebalancePlanning:
    def test_plan_moves_toward_balance(self):
        sm = ShardManager("ds", 4, min_num_nodes=1)
        sm.add_member("n1")
        sm.add_member("n2")
        for s in range(4):
            sm.shard_active(s, "n1")
        moves = sm.plan_rebalance()
        assert len(moves) == 2
        assert all(src == "n1" and dst == "n2" for _, src, dst in moves)

    def test_overloaded_forces_shed(self):
        sm = ShardManager("ds", 4, min_num_nodes=2)
        sm.add_member("n1")
        sm.add_member("n2")
        for s in range(4):
            sm.shard_active(s, sm.mapper.node_for(s))
        assert sm.plan_rebalance() == []
        moves = sm.plan_rebalance(overloaded="n1", min_imbalance=1)
        assert len(moves) == 1
        assert moves[0][1] == "n1" and moves[0][2] == "n2"

    def test_join_rebalance_via_migration(self, cluster_env):
        cluster, _ = cluster_env
        before = _query(cluster)
        cluster.auto_rebalance = True
        a = cluster.nodes["node-a"]
        cluster.join(Node("node-c", a.column_store, a.meta_store))
        sm = cluster.shard_managers[DS]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if sm.mapper.shards_of("node-c") and not cluster.migrations:
                break
            time.sleep(0.05)
        assert sm.mapper.shards_of("node-c"), "the joiner got no shard"
        np.testing.assert_allclose(_query(cluster).result.values,
                                   before.result.values, rtol=1e-9)


class TestDurableManifests:
    def test_localstore_manifest_roundtrip(self, tmp_path):
        cs = LocalDiskColumnStore(str(tmp_path / "columnstore"))
        try:
            assert cs.read_migration_manifest("ds", 1) is None
            cs.write_migration_manifest("ds", 1, b'{"phase": "syncing"}')
            assert cs.read_migration_manifest("ds", 1) == \
                b'{"phase": "syncing"}'
            cs.delete_migration_manifest("ds", 1)
            assert cs.read_migration_manifest("ds", 1) is None
            cs.delete_migration_manifest("ds", 1)  # idempotent
        finally:
            cs.close()

    def test_objectstore_manifest_roundtrip(self, tmp_path):
        cs, meta = open_object_store({"endpoint": None, "bucket": "t"},
                                     str(tmp_path))
        try:
            assert cs.read_migration_manifest("ds", 2) is None
            cs.write_migration_manifest("ds", 2, b'{"phase": "catchup"}')
            assert cs.read_migration_manifest("ds", 2) == \
                b'{"phase": "catchup"}'
            cs.delete_migration_manifest("ds", 2)
            assert cs.read_migration_manifest("ds", 2) is None
        finally:
            cs.close()
            meta.close()

    def test_in_memory_manifest_roundtrip(self):
        cs = InMemoryColumnStore()
        cs.write_migration_manifest("ds", 0, b"x")
        assert cs.read_migration_manifest("ds", 0) == b"x"
        cs.delete_migration_manifest("ds", 0)
        assert cs.read_migration_manifest("ds", 0) is None


def test_resume_is_a_classmethod_over_the_manifest(cluster_env):
    """``ShardMigration.resume`` of a manifest in SYNCING re-runs the
    phase and finishes the move."""
    cluster, cs = cluster_env
    shard = _pick_shard(cluster, "node-a")
    cs.write_migration_manifest(DS, shard, MigrationManifest(
        DS, shard, "node-a", "node-b", "syncing").to_bytes())
    mig = ShardMigration.resume(cluster, cs, DS, shard)
    assert mig.phase == DONE
    assert cluster.shard_managers[DS].mapper.node_for(shard) == "node-b"
