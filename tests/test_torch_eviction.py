"""The port's memory bound against the JAX package's
(``tests/test_eviction.py``): both packages take the same containers
(the port's through ``testing/from_jax.py::log_stream``) into a
local-disk store of one shard, flush, and then evict or purge; the port
must hold the same chunk bytes, evict the same chunks and partitions,
purge the same series, keep a bloom with the same state, restore an
evicted series' identity as the reference does, write snapshots either
package restores, and answer as before eviction.

- the six cases of ``tests/test_eviction.py`` (the soak at a few hundred
  evictions);
- ``enforce_memory`` at one budget, ``purge_expired`` with its answers,
  the re-ingest's start time and dedup floor, snapshots both ways with
  purged entries and the bloom, and one scheduler tick that flushes,
  enforces and purges, in that order.
"""

import numpy as np
import pytest

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.memstore.native_shard import part_key_blob
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.core.store.localstore import (
    LocalDiskColumnStore as RefCS,
)
from filodb_tpu.core.store.localstore import LocalDiskMetaStore as RefMS
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.coordinator.cluster import shard_tick
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore import index_snapshot
from filodb_tpu_torch.core.memstore.shard import EVICTED, GONE, LIVE
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.testing.from_jax import log_stream, open_local

DS = "timeseries"
START = 1_600_000_000
MS = 1000
ALL = 2**62


def _raws(n_series=32, n_samples=200, start_s=START, seed=5, ns="App-0",
          start_offset=0):
    keys = machine_metrics_series(n_series, metric="gauge_metric", ns=ns)
    return [(sd.container.serialize(), sd.offset) for sd in gauge_stream(
        keys, n_samples, start_ms=start_s * MS, interval_ms=10_000,
        seed=seed, start_offset=start_offset)]


class Pair:
    """The reference's shard and the port's over their own directories,
    fed alike."""

    def __init__(self, tmp_path, **cfg):
        base = dict(max_chunk_size=50, groups_per_shard=4,
                    flush_interval_ms=0)
        base.update(cfg)
        self.ref_ms = TimeSeriesMemStore(RefCS(str(tmp_path / "ref")),
                                         RefMS(str(tmp_path / "ref")))
        self.ref = self.ref_ms.setup(DS, 0, RefConfig(**base))
        self.ref.meta_store.read_checkpoints(DS, 0)
        self.port_ms = open_local(str(tmp_path / "port"),
                                  config=StoreConfig(**base), dataset=DS)
        self.port = self.port_ms.shards[0]

    def feed(self, raws):
        from filodb_tpu.core.record import RecordContainer, SomeData
        for raw, off in raws:
            self.ref.ingest(SomeData(RecordContainer.deserialize(raw), off))
        for (raw, off) in raws:
            self.port.ingest(log_stream([raw], off)[0])

    def flush(self):
        self.ref.flush_all()
        self.port.flush_all()

    def services(self, engine="mesh"):
        return (RefService(self.ref_ms, DS, 1, spread=0),
                QueryService(self.port_ms, device="cpu", engine=engine))

    def ref_resident(self):
        """Per pid: the reference's resident chunk count, -1 for a pid
        without a partition object (evicted or purged)."""
        return [-1 if p is None else len(p.chunks)
                for p in self.ref.partitions]

    def port_resident(self):
        n = self.port.num_partitions
        out = np.bincount(self.port.chunks["pid"], minlength=n)
        return np.where(self.port.status[:n] == LIVE, out, -1).tolist()

    def close(self):
        self.ref.column_store.close()
        self.ref.meta_store.close()
        self.port_ms.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    p.feed(_raws())
    p.flush()
    yield p
    p.close()


def _values(result):
    m = result.result
    order = np.argsort([str(k) for k in m.keys])
    return np.asarray(m.values)[order]


# ---- the six cases of tests/test_eviction.py ---------------------------------

@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_evict_then_query_pages_from_store(pair, engine):
    ref_svc, svc = pair.services(engine)
    q = "sum(sum_over_time(gauge_metric[10m]))"
    t0, t1 = START + 600, START + 1800
    before = svc.query_range(q, t0, 60, t1)
    n = pair.port.evict_cold_partitions(max_evict=10**9)
    assert n == pair.ref.evict_cold_partitions(max_evict=10**9) > 0
    assert pair.port.stats.partitions_evicted.value == n
    assert (pair.port.status[:pair.port.num_partitions] == EVICTED).all()
    assert pair.port_resident() == pair.ref_resident()
    paged = pair.port.odp_cache.chunks_paged
    after = svc.query_range(q, t0, 60, t1)
    assert pair.port.odp_cache.chunks_paged > paged  # the shells paged in
    np.testing.assert_array_equal(_values(after), _values(before))
    np.testing.assert_allclose(_values(after),
                               _values(ref_svc.query_range(q, t0, 60, t1)),
                               rtol=1e-6)


def test_unpersisted_partition_not_evictable(pair):
    pair.feed(_raws(4, 3, START + 3000, seed=6, start_offset=10_000))
    n = pair.port.evict_cold_partitions(max_evict=10**9)
    assert n == pair.ref.evict_cold_partitions(max_evict=10**9)
    live = pair.port.status[:pair.port.num_partitions] == LIVE
    assert live.sum() == 4 and n == len(pair.port.index) - 4
    assert pair.port_resident() == pair.ref_resident()


def test_reingest_restores_identity(tmp_path):
    p = Pair(tmp_path)
    p.feed(_raws(8))
    p.flush()
    starts = p.port.index.start_times(np.arange(8)).tolist()
    assert p.port.evict_cold_partitions(10**9) == 8
    p.ref.evict_cold_partitions(10**9)
    p.feed(_raws(8, 5, START + 4000, seed=7, start_offset=10_000))
    assert p.port.stats.partitions_restored.value == 8 \
        == p.ref.stats.partitions_restored.value
    pids = p.port.lookup_partitions([], 0, ALL)
    assert pids.tolist() == p.ref.lookup_partitions([], 0, ALL) \
        == list(range(8, 16))
    # the original start times and the old pids gone
    assert p.port.index.start_times(pids).tolist() == starts == [
        p.ref.index.start_time(i) for i in pids.tolist()]
    assert (p.port.status[:8] == GONE).all()
    # the dedup floor: the old end time, so history replays are dropped
    assert p.port.latest[8:16].tolist() == [
        p.ref.partitions[i].latest_ts for i in range(8, 16)]
    p.feed(_raws(8, 100))  # the evicted history again
    assert p.port.latest[8:16].tolist() == [
        p.ref.partitions[i].latest_ts for i in range(8, 16)]
    p.close()


def test_bloom_false_negative_free(pair):
    blobs = [part_key_blob(pair.ref.partition(pid).part_key)
             for pid in pair.ref.lookup_partitions([], 0, ALL)]
    assert pair.port.record_keys(np.arange(32)) == blobs
    pair.port.evict_cold_partitions(max_evict=10**9)
    pair.ref.evict_cold_partitions(max_evict=10**9)
    for b in blobs:
        assert b in pair.port.evicted_keys
    assert pair.port.evicted_keys.state() == pair.ref.evicted_keys.state()


def test_bloom_survives_snapshot_restart(tmp_path):
    p = Pair(tmp_path)
    p.feed(_raws(8))
    p.flush()
    p.port.evict_cold_partitions(max_evict=10**9)
    p.port.snapshot_index()
    state = p.port.evicted_keys.state()
    p.close()
    again = open_local(str(tmp_path / "port"), config=StoreConfig(
        max_chunk_size=50, groups_per_shard=4), dataset=DS)
    s2 = again.shards[0]
    assert s2.recover_index() == 8 and s2.recovered_from == "snapshot"
    assert s2.evicted_keys.state() == state
    # the evicted partitions come back as shells, their keys rebuilt from
    # their postings, and answer from the store
    assert (s2.status[:8] == EVICTED).all()
    got = QueryService(again, device="cpu").query_range(
        "count(count_over_time(gauge_metric[10m]))", START + 600, 60,
        START + 1200)
    assert np.asarray(got.result.values).ravel().tolist() == [8.0] * 11
    again.close()


def test_pressure_soak_hundreds_of_evictions(tmp_path):
    """Sustained over-budget ingest: waves of new series, each flushed and
    then evicted: the same evictions as the reference, queries answering
    throughout, and the full history paged back at the end."""
    p = Pair(tmp_path, max_chunk_size=32)
    ref_svc, svc = p.services()
    total, waves, per_wave = 0, 4, 120
    for w in range(waves):
        p.feed(_raws(per_wave, 40, START + w * 400, seed=w, ns=f"wave{w}",
                     start_offset=(w + 1) * 100_000))
        p.flush()
        n = p.port.evict_cold_partitions(max_evict=per_wave)
        assert n == p.ref.evict_cold_partitions(max_evict=per_wave)
        total += n
        q = (f'count(gauge_metric{{_ns_="wave{w}"}})', START + w * 400 + 100,
             60, START + w * 400 + 300)
        np.testing.assert_array_equal(_values(svc.query_range(*q)),
                                      _values(ref_svc.query_range(*q)))
    assert total >= 300 and p.port.stats.partitions_evicted.value == total
    q = ("count(gauge_metric)", START + 100, 300, START + waves * 400)
    got = svc.query_range(*q)
    assert got.result.num_series == 1
    np.testing.assert_array_equal(_values(got),
                                  _values(ref_svc.query_range(*q)))
    p.close()


# ---- the budget, the purge, snapshots and the tick --------------------------

@pytest.mark.parametrize("budget_chunks", [0, 40, 400, 10**6])
def test_enforce_memory_evicts_what_the_reference_evicts(pair,
                                                         budget_chunks):
    """One budget, both packages: the same chunk bytes before and after,
    the same chunks evicted, the same partitions left whole."""
    assert pair.port.chunk_bytes() == pair.ref.chunk_bytes()
    budget = budget_chunks * 100
    assert pair.port.enforce_memory(budget) == \
        pair.ref.enforce_memory(budget)
    assert pair.port.chunk_bytes() == pair.ref.chunk_bytes()
    assert pair.port_resident() == pair.ref_resident()
    assert pair.port.stats.partitions_evicted.value == \
        pair.ref.stats.partitions_evicted.value


def test_purge_drops_the_expired_series_and_answers_as_the_reference(
        tmp_path):
    p = Pair(tmp_path, retention_ms=1_000_000)
    p.feed(_raws(16, 100))  # [START, START + 990 s]
    p.feed(_raws(8, 100, START + 5000, seed=9, ns="App-1",
                 start_offset=10_000))
    p.flush()
    now = (START + 990) * MS + 1_000_000 + 1
    assert p.port.purge_expired(now) == 16 == p.ref.purge_expired(now)
    assert p.port.stats.partitions_purged.value == 16
    assert p.port.lookup_partitions([], 0, ALL).tolist() == \
        p.ref.lookup_partitions([], 0, ALL) == list(range(16, 24))
    assert p.port.cardinality.to_state() == p.ref.cardinality.to_state()
    ref_svc, svc = p.services()
    for q in ("sum(sum_over_time(gauge_metric[5m])) by (instance)",
              "count(gauge_metric)"):
        for t in (START + 600, START + 5600):
            want = ref_svc.query_range(q, t, 60, t + 300)
            got = svc.query_range(q, t, 60, t + 300)
            assert got.result.num_series == want.result.num_series
            if want.result.num_series:
                np.testing.assert_allclose(_values(got), _values(want),
                                           rtol=2e-5)
    assert len(svc.series([], START, START + 6000)) == 8
    p.close()


def _masked(snap: bytes) -> dict:
    """A snapshot's sections but its floors and its time: the port's floor
    is a partition's largest persisted timestamp (ROADMAP §C), the
    reference's the one raised at eviction and recovery."""
    s = index_snapshot.read_snapshot(snap)
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in s.items()
           if k not in ("floors", "snapshot_ms", "chunk_token", "pk_token",
                        "postings")}
    out["postings"] = [(n, list(v), p.tolist(), c.tolist())
                       for n, v, p, c in s["postings"]]
    return out


def test_snapshots_with_purged_entries_and_the_bloom_both_ways(tmp_path):
    p = Pair(tmp_path, retention_ms=1_000_000)
    p.feed(_raws(12, 100))
    p.feed(_raws(6, 100, START + 5000, seed=9, ns="App-1",
                 start_offset=10_000))
    p.flush()
    now = (START + 990) * MS + 1_000_001
    assert p.port.purge_expired(now) == p.ref.purge_expired(now) == 12
    assert p.port.evict_cold_partitions(3) == p.ref.evict_cold_partitions(3)
    p.port.snapshot_index()
    p.ref.snapshot_index()
    ref_snap = p.ref.column_store.read_index_snapshot(DS, 0)
    port_snap = p.port.column_store.read_index_snapshot(DS, 0)
    assert _masked(port_snap) == _masked(ref_snap)
    # every evicted partition's chunks are flushed and evicted: the floors
    # agree on those
    ev = np.flatnonzero(p.port.status[:18] == EVICTED)
    assert index_snapshot.read_snapshot(port_snap)["floors"][ev].tolist() \
        == index_snapshot.read_snapshot(ref_snap)["floors"][ev].tolist()
    p.close()
    # the reference's restores in the port without the scan, and the port's
    # in the reference
    port2 = open_local(str(tmp_path / "ref"), config=StoreConfig(
        max_chunk_size=50, groups_per_shard=4), dataset=DS)
    s2 = port2.shards[0]
    assert s2.recover_index() == 6
    assert s2.recovered_from == "snapshot"
    assert s2.stats.index_recovery_partkeys.value == 0
    assert s2.status[:18].tolist() == [GONE] * 12 + [EVICTED] * 3 \
        + [LIVE] * 3
    port2.close()
    ref2 = TimeSeriesMemStore(RefCS(str(tmp_path / "port")),
                              RefMS(str(tmp_path / "port")))
    r2 = ref2.setup(DS, 0, RefConfig(max_chunk_size=50, groups_per_shard=4))
    assert r2.recover_index() == 6
    assert r2.stats.index_recovery_partkeys.value == 0
    assert r2.evicted_keys.state() == index_snapshot.read_snapshot(
        port_snap)["bloom"]
    assert sorted(r2.lookup_partitions([], 0, ALL)) == list(range(12, 18))
    r2.column_store.close()
    r2.meta_store.close()


def test_a_scheduler_tick_flushes_then_enforces_then_purges(tmp_path,
                                                            monkeypatch):
    p = Pair(tmp_path, retention_ms=1_000_000, shard_mem_mb=0)
    p.feed(_raws(8, 100))
    p.feed(_raws(4, 100, START + 5000, seed=9, ns="App-1",
                 start_offset=10_000))
    # every sealed chunk flushed, new samples in the write buffers only: the
    # reference's C++ chunk eviction empties the unflushed chunks of a
    # partition that has no flushed one (ROADMAP §C), which this avoids
    p.flush()
    p.feed(_raws(4, 10, START + 6000, seed=3, ns="App-1",
                 start_offset=20_000))
    calls = []
    for name in ("flush_group", "enforce_memory", "purge_expired"):
        orig = getattr(p.port, name)
        monkeypatch.setattr(p.port, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    now = (START + 990) * MS + 1_000_001
    ticks = [shard_tick(p.port, now) for _ in range(4)]
    assert calls == ["flush_group", "enforce_memory", "purge_expired"] * 4
    for _ in range(4):
        p.ref.flush_group(p.ref.next_flush_group())
        p.ref.enforce_memory()
        p.ref.purge_expired(now)
    assert p.port.chunk_bytes() == p.ref.chunk_bytes()
    assert p.port_resident() == p.ref_resident()
    # every expired series goes; the reference skips those it evicted whole
    # on the way (ROADMAP §C), whose index entries it keeps
    kept = [pid for pid, part in enumerate(p.ref.partitions)
            if part is None and p.ref.index.part_key(pid) is not None
            and p.ref.index.end_time(pid) < now - 1_000_000]
    assert sum(t["purged"] for t in ticks) == 8 == \
        p.ref.stats.partitions_purged.value + len(kept)
    assert p.port.lookup_partitions([], 0, ALL).tolist() == [
        pid for pid in p.ref.lookup_partitions([], 0, ALL)
        if pid not in kept]
    p.close()


def test_chunk_eviction_keeps_the_unflushed_chunks(tmp_path):
    """A fault of the reference the port does not share (ROADMAP §C): the
    reference's C++ chunk eviction (``native/filodb_native.cpp``,
    ``part_evict_flushed``) moves every sealed chunk aside and keeps them
    only when it dropped one, so a partition without a flushed chunk is
    left with emptied chunks. The port evicts flushed chunks only."""
    p = Pair(tmp_path)
    p.feed(_raws(8, 100))  # two sealed chunks a series, none flushed
    before = p.port.chunk_bytes()
    assert before == p.ref.chunk_bytes() > 0
    assert p.port.enforce_memory(0) == p.ref.enforce_memory(0) == 0
    assert p.port.chunk_bytes() == before
    assert p.ref.chunk_bytes() == 0  # the reference's chunks emptied
    p.close()


def test_from_jax_carries_holes_and_the_bloom(tmp_path):
    """A reference shard after a purge and an eviction, carried into the
    port's store (``ingest_states`` with holes and the bloom): the same
    live pids, the same bloom, the same answers."""
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.testing.from_jax import SeriesState, ingest_states

    p = Pair(tmp_path, retention_ms=1_000_000)
    p.feed(_raws(6, 100))
    p.feed(_raws(4, 100, START + 5000, seed=9, ns="App-1",
                 start_offset=10_000))
    p.ref.flush_all()
    p.ref.evict_cold_partitions(1)  # an App-0 series, its key in the bloom
    assert p.ref.purge_expired((START + 990) * MS + 1_000_001) == 5
    states = []
    for pid, part in enumerate(p.ref.partitions):
        key = p.ref.index.part_key(pid)
        if part is None:
            states.append(SeriesState(
                "gauge", {"_metric_": "gauge_metric", "hole": str(pid)},
                np.zeros(0, np.int64), np.zeros(0), [], gone=True))
            continue
        ts, vals = part.read_samples(0, ALL)
        states.append(SeriesState(key.schema, key.label_map, ts, vals,
                                  [c.num_rows for c in part.chunks]))
    port = MemStore(1, 0, config=StoreConfig(max_chunk_size=50,
                                             groups_per_shard=4))
    ingest_states(port, states, {0: p.ref.evicted_keys.state()})
    sh = port.shards[0]
    live = [pid for pid, part in enumerate(p.ref.partitions)
            if part is not None]
    assert sh.lookup_partitions([], 0, ALL).tolist() == live
    assert (sh.status[:6] == GONE).all()
    assert sh.evicted_keys.state() == p.ref.evicted_keys.state()
    for i, pid in enumerate(live):
        want = rchunk_stats(p.ref.partitions[pid])
        assert sh.chunks["stats_value"][sh.chunks["pid"] == pid].tobytes() \
            == want, pid
    q = ("sum(sum_over_time(gauge_metric[5m]))", START + 5300, 60,
         START + 5900)
    np.testing.assert_allclose(
        _values(QueryService(port, device="cpu").query_range(*q)),
        _values(p.services()[0].query_range(*q)), rtol=2e-5)
    p.close()


def rchunk_stats(part) -> bytes:
    from filodb_tpu.memory.chunk import ensure_summary
    return b"".join(ensure_summary(c)[1].stats.tobytes()
                    for c in part.chunks)


def test_the_shard_stats_reach_the_metrics_exposition(pair):
    """The reference's names, on the port's ``/metrics``."""
    from filodb_tpu_torch.utils.metrics import render_prometheus

    pair.port.enforce_memory(0)
    pair.port.purge_expired(2**62)
    text = render_prometheus()
    for name in ("memstore_partitions_purged", "memstore_partitions_evicted",
                 "memstore_partitions_paged_restored",
                 "memstore_chunkids_evicted", "evicted_pk_bloom_filter_queries",
                 "evicted_pk_bloom_filter_fp",
                 "memstore_partitions_purge_time_ms",
                 "memstore_eviction_stall_ns"):
        assert name in text, name
    assert pair.port.stats.partitions_purged.value == 32
    assert pair.port.stats.eviction_stall_ns.value > 0


def test_evict_partition_only_when_everything_is_persisted(tmp_path):
    """``evict_partition`` of one pid, as the reference's: refused while
    its write buffer holds samples, done once they are flushed; the
    evicted key is found by ``pid_for_exact_key`` as the reference finds
    it."""
    p = Pair(tmp_path)
    p.feed(_raws(4, 120))  # two sealed chunks and 20 buffered samples each
    p.flush()
    p.feed(_raws(1, 3, START + 2000, seed=2, start_offset=10_000))
    assert p.port.evict_partition(0) is p.ref.evict_partition(0) is False
    assert p.port.evict_partition(1) is p.ref.evict_partition(1) is True
    assert p.port.status[:4].tolist() == [LIVE, EVICTED, LIVE, LIVE]
    key = p.port.keys[1]
    want = p.ref.index.pid_for_exact_key(p.ref.index.part_key(1),
                                         part_key_blob(p.ref.index.part_key(1)))
    assert p.port.index.pid_for_exact_key(
        key.labels, key.serialized, p.port.keys.blob) == want == 1
    assert p.port.index.pid_for_exact_key(
        key.labels, key.serialized, p.port.keys.blob, exclude=1) is None
    assert p.port_resident() == p.ref_resident()
    p.close()
