"""The port's node on the CPU: the shard's lock under concurrent queries,
ingest and flushes; the ingest worker (replay, then tail; a poison record
surfaces ERROR); the flush scheduler's tick (one group flushed, the log
truncated below the smallest watermark, the index snapshot); and index
snapshots (``core/memstore/index_snapshot.py``), mirroring
``tests/test_index_snapshot.py``: round trip, the delta after a snapshot,
a corrupt snapshot falling back to the full scan, histogram partitions,
and a snapshot written by either package restoring in the other.

The JAX store gets the same record containers (``filodb_tpu.testing.data``
generators, seeded). Answers compare bitwise unless a test states a
tolerance.
"""

import threading
import time

import numpy as np
import pytest

from filodb_tpu.core.filters import ColumnFilter as RefFilter
from filodb_tpu.core.filters import Equals as RefEquals
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.memstore.native_shard import native_available
from filodb_tpu.core.record import BytesContainer as RefBytes
from filodb_tpu.core.record import SomeData as RefSomeData
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.core.store.localstore import LocalDiskColumnStore as RefCS
from filodb_tpu.core.store.localstore import LocalDiskMetaStore as RefMS
from filodb_tpu.testing.data import (
    counter_series,
    counter_stream,
    gauge_stream,
    histogram_series,
    histogram_stream,
    machine_metrics_series,
)
from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.memstore import index_snapshot
from filodb_tpu_torch.core.record import BytesContainer, SomeData
from filodb_tpu_torch.core.store.config import IngestionConfig, StoreConfig
from filodb_tpu_torch.core.store.localstore import (
    LocalDiskColumnStore,
    LocalDiskMetaStore,
)
from filodb_tpu_torch.kafka.log import InMemoryLog, SegmentedFileLog
from filodb_tpu_torch.testing.from_jax import open_local
from filodb_tpu_torch.utils.metrics import get_counter

DS = "ds"
CFG = StoreConfig(max_chunk_size=50, groups_per_shard=2)
REF_CFG = RefConfig(max_chunk_size=50, groups_per_shard=2)
ALL = 10**15


def _raws(stream, extra_offset=0):
    return [(sd.container.serialize(), sd.offset + extra_offset)
            for sd in stream]


def _feed(shard, raws) -> int:
    return sum(shard.ingest(SomeData(BytesContainer(r), off))
               for r, off in raws)


def _ref_feed(shard, raws) -> None:
    for r, off in raws:
        shard.ingest(RefSomeData(RefBytes(r), off))


def _gauges(n=6, samples=40, metric="heap_usage", **kw):
    return _raws(gauge_stream(machine_metrics_series(n, metric=metric),
                              samples, batch=1, **kw))


def _port_store(root, config=CFG):
    return open_local(str(root), num_shards=1, spread=0, config=config,
                      dataset=DS)


def _deadline(pred, timeout=30.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# ---- the node ----------------------------------------------------------------

def _node(logs, config=CFG, tick_s=None, num_shards=1, spread=0):
    node = Node("n", flush_tick_s=tick_s)
    cluster = FilodbCluster()
    cluster.join(node)
    cluster.setup_dataset(IngestionConfig(DS, num_shards=num_shards,
                                          store=config), logs, spread)
    return cluster, node


def test_worker_replays_then_tails():
    raws = _gauges(n=4, samples=30)
    log = InMemoryLog()
    for r, _ in raws[:60]:
        log.append(BytesContainer(r))
    cluster, node = _node({0: log})
    try:
        assert cluster.wait_active(DS, 10)
        worker = node._workers[(DS, 0)]
        assert worker.records_replayed == 60 and worker.replay_s is not None
        shard = node.memstores[DS].shards[0]
        assert shard.latest_offset == 59
        for r, _ in raws[60:]:
            log.append(BytesContainer(r))
        _deadline(lambda: shard.latest_offset == len(raws) - 1,
                  what="the tail")
        assert worker.records_replayed == 60  # the rest were tailed
        got = QueryService(node.memstores[DS], device="cpu").query_range(
            "count_over_time(heap_usage[1h])", 300, 60, 300)
        assert sorted(got.result.values[:, -1].tolist()) == [30.0] * 4
    finally:
        cluster.stop()


def test_a_poison_record_surfaces_error():
    raws = _gauges(n=2, samples=5)
    log = InMemoryLog()
    log.append(BytesContainer(raws[0][0]))
    log.append(BytesContainer(b"\x02\x05\x00\x00\x00garbage"))
    log.append(BytesContainer(raws[1][0]))
    errors = get_counter("filodb_ingest_errors", {"dataset": DS,
                                                  "shard": "0"})
    before = errors.value
    cluster, node = _node({0: log})
    try:
        _deadline(lambda: cluster.shard_statuses(DS)[0]["status"] == "error",
                  what="ERROR")
        worker = node._workers[(DS, 0)]
        _deadline(lambda: not worker.is_alive(), what="the worker to stop")
        assert worker.failed is not None and worker.offset == 0
        assert errors.value == before + 1
        assert not cluster.wait_active(DS, 0.05)
    finally:
        cluster.stop()


def test_a_scheduler_tick_flushes_one_group_and_truncates_the_log(tmp_path):
    raws = _gauges(n=8, samples=30)
    log = SegmentedFileLog(str(tmp_path / "wal"), segment_entries=16)
    for r, _ in raws:
        log.append(BytesContainer(r))
    node = Node("n", LocalDiskColumnStore(str(tmp_path / "cs")),
                LocalDiskMetaStore(str(tmp_path / "cs")), flush_tick_s=3600)
    cluster = FilodbCluster()
    cluster.join(node)
    # the gauges are years old: a retention that holds them, or the tick's
    # purge would drop them
    cfg = StoreConfig(max_chunk_size=50, groups_per_shard=2,
                      index_snapshot_interval_ms=1, retention_ms=2**60)
    cluster.setup_dataset(IngestionConfig(DS, num_shards=1, store=cfg),
                          {0: log}, 0)
    try:
        assert cluster.wait_active(DS, 10)
        shard = node.memstores[DS].shards[0]
        sched = node._flusher
        cp0 = node.meta_store.read_checkpoints(DS, 0)
        sched._tick((DS, 0))
        cps = node.meta_store.read_checkpoints(DS, 0)
        assert cp0 == {} and list(cps) == [0]  # one group flushed
        assert (shard.group_watermarks == [len(raws) - 1, -1]).all()
        mine = shard.group[:shard.num_partitions] == 0
        keys = [k.serialized for k, m in zip(shard.keys, mine) if m]
        assert node.column_store.read_chunk_rows(DS, 0, keys, 0, ALL)
        assert log.earliest_offset == 0 and (DS, 0) not in sched.truncated
        time.sleep(0.01)
        sched._tick((DS, 0))  # group 1: every group has a checkpoint
        # whole segments of 16 go; the newest stays
        last_seg = (len(raws) - 1) // 16
        assert sched.truncated[(DS, 0)] == (len(raws), last_seg)
        assert log.earliest_offset == last_seg * 16
        assert sched.snapshots[(DS, 0)][0] == 1
        assert node.column_store.read_index_snapshot(DS, 0)
    finally:
        cluster.stop()
        log.close()
        node.column_store.close()
        node.meta_store.close()


def test_the_scheduler_thread_ticks_on_its_own(tmp_path):
    raws = _gauges(n=4, samples=10)
    log = InMemoryLog()
    for r, _ in raws:
        log.append(BytesContainer(r))
    cluster, node = _node({0: log}, tick_s=0.02)
    try:
        assert cluster.wait_active(DS, 10)
        _deadline(lambda: node.meta_store.read_checkpoints(DS, 0)
                  == {0: len(raws) - 1, 1: len(raws) - 1}, what="the ticks")
    finally:
        cluster.stop()


QUERIES = ("sum(rate(http_requests_total[5m])) by (_ns_)",
           "sum(count_over_time(http_requests_total[5m])) by (job)",
           "max_over_time(http_requests_total[2m])")


def _answers(svc) -> dict:
    out = {}
    for q in QUERIES:
        m = svc.query_range(q, 600, 60, 2400).result
        out[q] = ([str(k) for k in m.keys], np.asarray(m.values).tobytes())
    return out


def test_concurrent_queries_and_ingest_answer_as_a_sequential_run():
    """Four query threads and the ingest worker, with the flush scheduler
    sealing and flushing groups, on one store: every answer over the
    counters equals the sequential run's while the worker appends another
    metric's containers (new partitions, new versions, re-packs)."""
    counters = _raws(counter_stream(counter_series(16), 240, batch=64))
    later = _raws(gauge_stream(machine_metrics_series(16, metric="other"),
                               240, batch=16))
    log = InMemoryLog()
    for r, _ in counters:
        log.append(BytesContainer(r))
    # the series are years old: a retention that holds them, or a tick's
    # purge would drop them mid-run
    cluster, node = _node({0: log, 1: InMemoryLog()}, tick_s=0.01,
                          num_shards=2, spread=1,
                          config=StoreConfig(max_chunk_size=50,
                                             groups_per_shard=4,
                                             retention_ms=2**60))
    try:
        assert cluster.wait_active(DS, 10)
        svc = cluster.query_service(DS, device="cpu")
        want = _answers(svc)
        errors, rounds = [], []

        def query_loop():
            try:
                for _ in range(6):
                    assert _answers(svc) == want
                    rounds.append(1)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=query_loop) for _ in range(4)]
        for t in threads:
            t.start()
        for r, _ in later:
            log.append(BytesContainer(r))
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors[0]
        assert len(rounds) == 24
        shard = node.memstores[DS].shards[0]
        _deadline(lambda: shard.latest_offset == log.latest_offset,
                  what="the worker")
        assert _answers(svc) == want
        others = svc.query_range("count_over_time(other[1h])", 2400, 60,
                                 2400).result
        assert sorted(others.values[:, -1].tolist()) == [240.0] * 16
    finally:
        cluster.stop()


# ---- index snapshots ---------------------------------------------------------

def _lookup(shard, metric):
    return shard.lookup_partitions([ColumnFilter("_metric_",
                                                 Equals(metric))], 0, ALL)


def _build(root, raws=None):
    ms = _port_store(root)
    shard = ms.shards[0]
    _feed(shard, raws if raws is not None else _gauges())
    shard.flush_all()
    return ms, shard


def test_snapshot_round_trip_matches_the_full_scan(tmp_path):
    ms, shard = _build(tmp_path)
    assert shard.snapshot_index() > 0
    full = _port_store(tmp_path / "none")  # no snapshot there
    ms.close()
    again = _port_store(tmp_path)
    s2 = again.shards[0]
    scanned = s2.stats.index_recovery_partkeys.value
    assert s2.recover_index() == 6
    assert s2.stats.index_recovery_partkeys.value == scanned  # no scan
    assert [k.serialized for k in s2.keys] == \
        [k.serialized for k in shard.keys]
    assert len(_lookup(s2, "heap_usage")) == 6
    assert s2.index.label_values("host") == shard.index.label_values("host")
    np.testing.assert_array_equal(s2.index.start_times(np.arange(6)),
                                  shard.index.start_times(np.arange(6)))
    assert (s2.group[:6] == shard.group[:6]).all()
    assert s2.cardinality.to_state() == shard.cardinality.to_state()
    # floors restored: replaying flushed rows adds nothing
    s2.setup_watermarks_for_recovery()
    assert _feed(s2, _gauges()) == 0
    # the same partitions a full scan restores
    fs = LocalDiskColumnStore(str(tmp_path))
    assert [r.part_key.serialized for r in fs.scan_part_keys(DS, 0)] == \
        [k.serialized for k in s2.keys]
    fs.close()
    again.close()
    full.close()


def test_snapshot_then_delta_part_keys_and_floors(tmp_path):
    ms, shard = _build(tmp_path)
    shard.snapshot_index()
    late = _gauges(n=2, samples=30, metric="late_metric")
    _feed(shard, [(r, off + 10_000) for r, off in late])
    shard.flush_all()
    ms.close()
    again = _port_store(tmp_path)
    s2 = again.shards[0]
    assert s2.recover_index() == 8
    assert len(_lookup(s2, "late_metric")) == 2
    s2.setup_watermarks_for_recovery()
    # delta floors: the late chunks are not written twice
    assert _feed(s2, [(r, off + 10_000) for r, off in late]) == 0
    again.close()


def test_a_corrupt_snapshot_falls_back_to_the_full_scan(tmp_path):
    ms, shard = _build(tmp_path)
    shard.snapshot_index()
    ms.column_store.write_index_snapshot(DS, 0, b"FIDX4" + b"\x00" * 40)
    ms.close()
    again = _port_store(tmp_path)
    s2 = again.shards[0]
    scanned = s2.stats.index_recovery_partkeys.value
    assert s2.recover_index() == 6
    assert s2.stats.index_recovery_partkeys.value == scanned + 6
    assert len(_lookup(s2, "heap_usage")) == 6
    again.close()


def test_histogram_partitions_restore_and_page_in(tmp_path):
    raws = _raws(histogram_stream(histogram_series(2), 60, batch=1))
    raws += [(r, off + 1000) for r, off in _gauges(n=2, samples=60)]
    ms, shard = _build(tmp_path, raws)
    q = "sum(rate(http_req_latency[5m])) by (instance)"
    live = QueryService(ms, device="cpu").query_range(q, 300, 60, 590)
    shard.snapshot_index()
    ms.close()
    again = _port_store(tmp_path)
    s2 = again.shards[0]
    assert s2.recover_index() == 4
    assert s2.hist[:4].tolist() == shard.hist[:4].tolist()
    got = QueryService(again, device="cpu").query_range(q, 300, 60, 590)
    assert got.result.les is not None
    np.testing.assert_array_equal(np.asarray(got.result.values),
                                  np.asarray(live.result.values))
    assert s2.odp_cache.chunks_paged > 0
    again.close()


def _ref_store(root, config=REF_CFG):
    ms = TimeSeriesMemStore(RefCS(str(root)), RefMS(str(root)))
    # open the meta store's connection before a flush thread does: two
    # connections setting up one sqlite file at once can find it locked
    ms.meta_store.read_checkpoints(DS, 0)
    return ms, ms.setup(DS, 0, config)


def test_a_port_snapshot_restores_in_the_reference(tmp_path):
    raws = _gauges() + [(r, off + 1000) for r, off in _raws(
        histogram_stream(histogram_series(2), 20, batch=1))]
    ms, shard = _build(tmp_path, raws)
    shard.snapshot_index()
    ms.close()
    ref_ms, ref = _ref_store(tmp_path)
    assert ref.recover_index() == 8
    assert ref.stats.index_recovery_partkeys.value == 0  # the snapshot's
    f = [RefFilter("_metric_", RefEquals("heap_usage"))]
    assert sorted(ref.lookup_partitions(f, 0, ALL)) == list(range(6))
    for pid, key in enumerate(shard.keys[:8]):
        got = ref.index.part_key(pid)
        assert (got.schema, got.labels) == (key.schema, key.labels)
    ref.setup_watermarks_for_recovery()
    _ref_feed(ref, raws)  # flushed rows: below the floors, dropped
    assert sum(p.num_samples for p in ref.partitions if p is not None) == 0
    ref_ms.column_store.close()
    ref_ms.meta_store.close()


@pytest.mark.skipif(not native_available(),
                    reason="the reference's native library is unavailable")
def test_a_reference_snapshot_restores_in_the_port(tmp_path):
    raws = _gauges() + [(r, off + 1000) for r, off in _raws(
        histogram_stream(histogram_series(2), 20, batch=1))]
    ref_ms, ref = _ref_store(tmp_path)
    _ref_feed(ref, raws)
    ref.flush_all()
    ref.snapshot_index()
    ref_ms.column_store.close()
    ref_ms.meta_store.close()
    again = _port_store(tmp_path)
    s2 = again.shards[0]
    scanned = s2.stats.index_recovery_partkeys.value
    assert s2.recover_index() == 8
    assert s2.stats.index_recovery_partkeys.value == scanned  # no scan
    for pid in range(8):
        want = ref.index.part_key(pid)
        assert (s2.keys[pid].schema, s2.keys[pid].labels) == \
            (want.schema, want.labels)
    assert len(_lookup(s2, "heap_usage")) == 6
    assert s2.hist[:8].tolist() == [False] * 6 + [True] * 2
    s2.setup_watermarks_for_recovery()
    assert _feed(s2, raws) == 0
    again.close()


@pytest.mark.skipif(not native_available(),
                    reason="the reference's native library is unavailable")
def test_a_reference_snapshot_with_purged_partitions_takes_the_full_scan(
        tmp_path):
    """Named for what the port did before it kept holes: a snapshot with
    purged entries now restores without the part-key scan, the purged
    series absent, and the survivor answers as the reference's store."""
    ms, ref = _ref_store(tmp_path, RefConfig(
        max_chunk_size=50, groups_per_shard=2, retention_ms=1_000_000))
    _ref_feed(ref, _gauges(n=3, samples=10))
    _ref_feed(ref, [(r, off + 200) for r, off in _gauges(
        n=1, samples=5, metric="fresh", start_ms=10_000_000)])
    assert ref.purge_expired(now_ms=8_000_000) == 3
    ref.flush_all()
    ref.snapshot_index()
    from filodb_tpu.coordinator.query_service import QueryService as RefQS
    q = ("sum_over_time(fresh[1m])", 10_000, 10, 10_040)
    want = RefQS(ms, DS, 1, spread=0).query_range(*q).result
    snap = index_snapshot.read_snapshot(
        ms.column_store.read_index_snapshot(DS, 0))
    assert snap["blobs"][:3] == [b""] * 3 and snap["bloom"] is not None
    ms.column_store.close()
    ms.meta_store.close()
    again = _port_store(tmp_path)
    s2 = again.shards[0]
    scanned = s2.stats.index_recovery_partkeys.value
    assert s2.recover_index() == 1
    assert s2.recovered_from == "snapshot"
    assert s2.stats.index_recovery_partkeys.value == scanned  # no scan
    assert len(_lookup(s2, "fresh")) == 1
    assert len(_lookup(s2, "heap_usage")) == 0
    assert s2.status[:4].tolist() == [2, 2, 2, 0]  # three holes
    got = QueryService(again, device="cpu", engine="exec").query_range(
        *q).result
    np.testing.assert_allclose(np.asarray(got.values),
                               np.asarray(want.values), rtol=2e-5)
    again.close()


@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_a_batch_built_by_a_page_in_is_served_warm(tmp_path, engine):
    """A page-in moves the shard's version; the batch it built is cached at
    the version after it, so the next query pages nothing and reuses the
    batch, and an ingest after it makes the batch stale."""
    ms, _ = _build(tmp_path)
    ms.close()
    again = _port_store(tmp_path)
    again.recover_index(0)
    svc = QueryService(again, device="cpu", engine=engine)
    shard = again.shards[0]
    first = svc.query_range("sum_over_time(heap_usage[5m])", 300, 60, 390)
    paged = shard.odp_cache.chunks_paged
    batches = svc.batches.batches()
    assert paged > 0 and batches
    second = svc.query_range("sum_over_time(heap_usage[5m])", 300, 60, 390)
    assert shard.odp_cache.chunks_paged == paged
    assert [id(b) for b in svc.batches.batches()] == [id(b) for b in batches]
    np.testing.assert_array_equal(np.asarray(second.result.values),
                                  np.asarray(first.result.values))
    _feed(shard, _gauges(n=1, samples=41, metric="heap_usage")[-1:])
    svc.query_range("sum_over_time(heap_usage[5m])", 300, 60, 390)
    assert [id(b) for b in svc.batches.batches()] != [id(b) for b in batches]
    again.close()


def test_the_core_section_is_the_reference_layout_key_by_key():
    """The vectorised core section against one ``struct.pack`` an entry
    (the reference's C++ export layout), and its record-form keys back to
    ``PartKey.serialized``, over keys with empty and non-ASCII values and
    every schema."""
    import struct

    from filodb_tpu_torch.core.partkey import PartKey, murmur3_32_many
    from filodb_tpu_torch.core.record import encode_labels
    from filodb_tpu_torch.core.schemas import SCHEMAS

    keys = [PartKey.create(schema, {"_metric_": f"m{i}", "a": "",
                                    "zeta": "väl" * (i % 3), "_ws_": "w"})
            for i, schema in enumerate(list(SCHEMAS) * 4)]
    keys.append(PartKey("gauge", ()))
    blobs = [k.serialized for k in keys]
    sid = np.array([SCHEMAS[k.schema].schema_id for k in keys])
    hashes = murmur3_32_many(blobs)
    floors = np.arange(len(keys), dtype=np.int64) * 1000 - 1
    ncols = np.array([len(SCHEMAS[k.schema].data.columns) - 1
                      for k in keys])
    core, key_len = index_snapshot.core_section(blobs, sid, hashes, floors,
                                                ncols)
    want, lens = [], []
    for k, h, f, nc in zip(keys, hashes.tolist(), floors.tolist(),
                           ncols.tolist()):
        rec = struct.pack("<H", SCHEMAS[k.schema].schema_id) \
            + encode_labels(k.labels)
        lens.append(len(rec))
        want.append(struct.pack("<I", len(rec)) + rec
                    + struct.pack("<IqBB", h, f, 1, nc))
    assert core == b"".join(want)
    assert key_len.tolist() == lens
    arr = np.frombuffer(core, np.uint8)
    entry = np.concatenate([[0], np.cumsum(np.array(lens) + 18)[:-1]])
    back, sids = index_snapshot.serialized_blobs(arr, entry,
                                                 np.array(lens))
    assert back == blobs and sids.tolist() == sid.tolist()
