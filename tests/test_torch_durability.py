"""The port's write path and recovery against the JAX package's: logs and
local-disk store directories written by either package and read by the
other, the reference's crash and recovery cycle run on the port, on-demand
paging after ``evict_partition_chunks``, histograms through flush and
restart, NaN samples that survive a flush, ``chunk_infos``, and both of the
port's engines after a restart.

The port runs on the CPU (``device="cpu"``); the JAX store gets the same
record containers (``filodb_tpu.testing.data`` generators, seeded).
Answers are compared bitwise (``assert_array_equal``) unless a test states
a tolerance: the reference's default lane reads float64 values where the
port's device pages hold float32, so where values are not exact in float32
the comparison is ``rtol=2e-5, atol=1e-6`` (histograms: the reference's
device-path tolerance, ``rtol=5e-5, atol=1e-4``).
"""

import os

import numpy as np
import pytest

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.record import SomeData as RefSomeData
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.core.store.localstore import LocalDiskColumnStore as RefCS
from filodb_tpu.core.store.localstore import LocalDiskMetaStore as RefMS
from filodb_tpu.kafka.log import SegmentedFileLog as RefLog
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query.engine.device_batch import chunk_device_pages
from filodb_tpu.testing.data import (
    counter_series,
    counter_stream,
    gauge_stream,
    histogram_series,
    histogram_stream,
    machine_metrics_series,
)
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.kafka.log import FileLog, InMemoryLog, SegmentedFileLog
from filodb_tpu_torch.promql.parser import TimeStepParams
from filodb_tpu_torch.promql.parser import parse_query as port_parse
from filodb_tpu_torch.query.engine.device_batch import PageBlocks
from filodb_tpu_torch.testing.from_jax import log_stream, open_local, restart

DS = "timeseries"
START = 1_600_000_000
CFG = StoreConfig(max_chunk_size=50, groups_per_shard=4)
TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)


def _raws(stream) -> list[bytes]:
    return [sd.container.serialize() for sd in stream]


def _gauges(n_series=8, n_samples=200, batch=50, seed=0):
    return _raws(gauge_stream(machine_metrics_series(n_series), n_samples,
                              start_ms=START * 1000, batch=batch, seed=seed))


def _counters(n_series=6, n_samples=200, batch=40):
    return _raws(counter_stream(counter_series(n_series), n_samples,
                                start_ms=START * 1000, batch=batch,
                                reset_every=70))


def _hists(n_series=4, n_samples=120, batch=20):
    return _raws(histogram_stream(histogram_series(n_series), n_samples,
                                  start_ms=START * 1000, batch=batch))


def _ref_store(root) -> TimeSeriesMemStore:
    ms = TimeSeriesMemStore(RefCS(str(root)), RefMS(str(root)))
    ms.setup(DS, 0, RefConfig(max_chunk_size=50, groups_per_shard=4))
    # both connections open before the reference's flush threads race to
    # set the journal mode
    ms.column_store.initialize(DS, 1)
    ms.meta_store.read_checkpoints(DS, 0)
    return ms


def _ref_ingest(ms, raws, lo=0, hi=None):
    from filodb_tpu.core.record import BytesContainer as RefBytes
    shard = ms.get_shard(DS, 0)
    for off in range(lo, len(raws) if hi is None else hi):
        shard.ingest(RefSomeData(RefBytes(raws[off]), off))


def _port_ingest(ms, raws, lo=0, hi=None):
    for sd in log_stream(raws[lo:hi], lo):
        ms.shards[0].ingest(sd)


def _answer(res):
    m = res.result
    m.materialize()
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order]


def _ref_answer(ms, q, t0, step, t1):
    return _answer(RefService(ms, DS, 1, spread=0).query_range(q, t0, step,
                                                               t1))


def _port_answer(ms, q, t0, step, t1, engine="mesh"):
    return _answer(QueryService(ms, device="cpu", engine=engine).query_range(
        q, t0, step, t1))


def _crash_cycle(root, raws, crash=True):
    """The reference's cycle on the port: 60 % of the log ingested and
    flushed, 20 % more ingested, a crash, a restart that recovers the index
    and replays the log from the recovery start."""
    log = FileLog(os.path.join(root, "log", "shard0.log"))
    for r in raws:
        log.append(BytesContainer(r))
    n60, n80 = int(len(raws) * 0.6), int(len(raws) * 0.8)
    ms1 = open_local(os.path.join(root, "data"), config=CFG)
    _port_ingest(ms1, raws, 0, n60)
    ms1.flush_all(ingestion_time=1)
    _port_ingest(ms1, raws, n60, n80)
    ms1.close()
    ms2 = open_local(os.path.join(root, "data"), config=CFG)
    assert ms2.recover_index(0) > 0
    start = ms2.recovery_start_offset(0)
    assert start == n60 - 1
    for sd in log.read_from(start):
        ms2.shards[0].ingest(sd)
    return ms2


@pytest.mark.parametrize("kind", ["gauge", "counter"])
def test_full_recovery_cycle(tmp_path, kind):
    """``tests/test_durability.py::TestCrashRecovery::test_full_recovery_
    cycle`` on the port: no sample lost or doubled after the restart, and
    the answers of the reference on the same stream (bitwise for
    count_over_time, ``TOL`` for rate)."""
    raws = _gauges() if kind == "gauge" else _counters()
    metric = "heap_usage" if kind == "gauge" else "http_requests_total"
    ms = _crash_cycle(str(tmp_path / "port"), raws)
    ref = _ref_store(tmp_path / "ref")
    _ref_ingest(ref, raws)
    t = START + 2400
    q = f"count_over_time({metric}[45m])"
    keys, got = _port_answer(ms, q, t, 60, t)
    assert len(keys) == (8 if kind == "gauge" else 6)
    np.testing.assert_array_equal(got[:, 0], 200.0)
    want_keys, want = _ref_answer(ref, q, t, 60, t)
    assert keys == want_keys
    np.testing.assert_array_equal(got, want)
    if kind == "counter":
        q = f"sum(rate({metric}[5m])) by (job)"
        gk, gv = _port_answer(ms, q, START + 600, 60, START + 1990)
        wk, wv = _ref_answer(ref, q, START + 600, 60, START + 1990)
        assert gk == wk
        np.testing.assert_allclose(gv, wv, **TOL)


def test_replay_skips_the_flushed_groups_records(tmp_path):
    """Records of a group whose checkpoint covers their offset are skipped
    on replay; the others are ingested once. Two of four groups flushed: a
    group that never flushed replays from the log's start (ROADMAP §C.4:
    the reference starts at the smallest checkpoint written, 29 here, and
    its series keep 1 sample of 30)."""
    raws = _gauges(n_series=16, n_samples=40, batch=16)  # one scrape each
    ms = open_local(str(tmp_path), config=CFG)
    _port_ingest(ms, raws, 0, 30)
    shard = ms.shards[0]
    flushed = [shard.next_flush_group() for _ in range(2)]
    for g in flushed:
        shard.flush_group(g)
    n_flushed = int(np.isin(shard.group[:16], flushed).sum())
    assert 0 < n_flushed < 16
    ms.close()
    ms2 = open_local(str(tmp_path), config=CFG)
    got = restart(ms2, {0: _Log(raws[:30])})
    # only the flushed groups' part keys are on disk; replay creates the
    # others. Every container holds one record of each series
    assert got["keys"] == n_flushed
    assert got["records"] == 30 * 16
    assert got["skipped"] == 30 * n_flushed
    keys, vals = _port_answer(ms2, "count_over_time(heap_usage[10m])",
                              START + 290, 10, START + 290)
    np.testing.assert_array_equal(vals[:, 0], 30.0)


class _Log:
    """A log of serialized containers at offsets 0.."""

    def __init__(self, raws):
        self.raws = raws

    def read_from(self, offset):
        return log_stream(self.raws[max(offset, 0):], max(offset, 0))


def test_wal_written_by_either_package_is_read_by_the_other(tmp_path):
    raws = _gauges(n_series=4, n_samples=30, batch=10)
    port = SegmentedFileLog(str(tmp_path / "p"), segment_entries=5)
    for r in raws:
        port.append(BytesContainer(r))
    ref = RefLog(str(tmp_path / "p"), segment_entries=5)
    assert [(sd.offset, sd.container.serialize())
            for sd in ref.read_from(4)] == list(enumerate(raws))[4:]
    from filodb_tpu.core.record import BytesContainer as RefBytes
    ref2 = RefLog(str(tmp_path / "r"), segment_entries=5)
    for r in raws:
        ref2.append(RefBytes(r))
    ref2.close()
    back = SegmentedFileLog(str(tmp_path / "r"), segment_entries=5)
    assert [(sd.offset, sd.container.serialize())
            for sd in back.read_from(0)] == list(enumerate(raws))
    assert sorted(os.listdir(tmp_path / "r")) == \
        sorted(os.listdir(tmp_path / "p"))


def test_torn_tail_is_cut_on_reopen(tmp_path):
    raws = _gauges(n_series=2, n_samples=10, batch=4)
    log = SegmentedFileLog(str(tmp_path), segment_entries=100)
    for r in raws:
        log.append(BytesContainer(r))
    log.close()
    seg = os.path.join(tmp_path, sorted(os.listdir(tmp_path))[-1])
    size = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(b"\x40\x00\x00\x00torn")
    again = SegmentedFileLog(str(tmp_path), segment_entries=100)
    assert os.path.getsize(seg) == size
    assert again.append(BytesContainer(raws[0])) == len(raws)
    ref = RefLog(str(tmp_path), segment_entries=100)
    assert [sd.offset for sd in ref.read_from(0)] == list(range(len(raws)
                                                               + 1))


def test_reference_directory_recovers_in_the_port(tmp_path):
    """A store directory and log the JAX package wrote: the port restores
    the index, pages the chunks in and answers as the reference did."""
    raws = _counters()
    ref = _ref_store(tmp_path)
    _ref_ingest(ref, raws, 0, 20)
    ref.flush_all(DS)
    _ref_ingest(ref, raws, 20)
    q = "count_over_time(http_requests_total[30m])"
    want = _ref_answer(ref, q, START + 1800, 60, START + 1990)
    rate = _ref_answer(ref, "rate(http_requests_total[5m])", START + 600,
                       60, START + 1990)
    ref.column_store.close()
    ref.meta_store.close()
    ms = open_local(str(tmp_path), config=CFG)
    got = restart(ms, {0: _Log(raws)})
    assert got["keys"] == 6
    k, v = _port_answer(ms, q, START + 1800, 60, START + 1990)
    assert k == want[0]
    np.testing.assert_array_equal(v, want[1])
    k, v = _port_answer(ms, "rate(http_requests_total[5m])", START + 600, 60,
                        START + 1990)
    assert k == rate[0]
    np.testing.assert_allclose(v, rate[1], **TOL)
    assert ms.shards[0].odp_cache.chunks_paged > 0


def test_port_directory_recovers_in_the_reference(tmp_path):
    raws = _counters()
    ms = open_local(str(tmp_path), config=CFG)
    _port_ingest(ms, raws, 0, 20)
    ms.flush_all()
    _port_ingest(ms, raws, 20)
    q = "count_over_time(http_requests_total[30m])"
    want = _port_answer(ms, q, START + 1800, 60, START + 1990)
    ms.close()
    ref = _ref_store(tmp_path)
    shard = ref.get_shard(DS, 0)
    assert shard.recover_index() == 6
    start = shard.setup_watermarks_for_recovery()
    _ref_ingest(ref, raws, max(start, 0))
    got = _ref_answer(ref, q, START + 1800, 60, START + 1990)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def _chunk_pages(table, row) -> PageBlocks:
    col = table.columns
    a, n = int(col["blk0"][row]), int(col["nblk"][row])
    seg = np.searchsorted(table.offsets, a, side="right") - 1
    return table.pages[seg].take(np.arange(a, a + n) - table.offsets[seg])


def _same_pages(a: PageBlocks, b: PageBlocks) -> bool:
    return all(np.asarray(getattr(a, f)).tobytes()
               == np.asarray(getattr(b, f)).tobytes()
               for f in PageBlocks.__dataclass_fields__)


def test_odp_after_eviction_pages_byte_equal_chunks(tmp_path):
    """``evict_partition_chunks`` keeps the partitions; a query pages the
    chunks back in and answers as before; a repeat inside the range is a
    cache hit; a paged chunk's pages are byte-equal to its pages before
    eviction and to the reference's ``chunk_device_pages`` for it."""
    raws = _gauges(n_series=4, n_samples=300, seed=3)
    ms = MemStore(1, 0, config=CFG)
    _port_ingest(ms, raws)
    ms.flush_all(ingestion_time=1)
    shard = ms.shards[0]
    q = "count_over_time(heap_usage[55m])"
    before = _port_answer(ms, q, START + 3000, 60, START + 3000)
    col = shard._sealed.columns
    resident = {(p, c): _chunk_pages(shard._sealed, r) for r, (p, c) in
                enumerate(zip(col["pid"].tolist(), col["cid"].tolist()))}
    assert shard.evict_partition_chunks(np.arange(4)) == len(resident)
    assert len(shard.chunks["pid"]) == 0
    after = _port_answer(ms, q, START + 3000, 60, START + 3000)
    assert after[0] == before[0]
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[1][:, 0], 300.0)
    cache = shard.odp_cache
    assert cache.chunks_paged == len(resident)
    inner = _port_answer(ms, "sum_over_time(heap_usage[10m])", START + 900,
                         60, START + 900)
    assert cache.range_hits == 4 and cache.chunks_paged == len(resident)
    assert len(inner[0]) == 4

    ref = TimeSeriesMemStore()
    ref.setup(DS, 0, RefConfig(max_chunk_size=50, groups_per_shard=4))
    _ref_ingest(ref, raws)
    ref_chunks = {(p.part_id, c.id): (c, p.schema)
                  for p in ref.get_shard(DS, 0).partitions for c in p.chunks}
    paged = cache.tables[False]
    pairs = list(zip(paged.columns["pid"].tolist(),
                     paged.columns["cid"].tolist()))
    assert sorted(pairs) == sorted(resident) == sorted(ref_chunks)
    for r, key in enumerate(pairs):
        got = _chunk_pages(paged, r)
        assert _same_pages(got, resident[key])
        c, schema = ref_chunks[key]
        assert _same_pages(got, PageBlocks.from_pages(
            *chunk_device_pages(c, schema, 1), c.num_rows))


def test_nan_samples_survive_flush_and_drop_at_decode(tmp_path):
    """A NaN staleness marker is kept by the codec chunk (lossless), comes
    back from disk, and is dropped at decode as before the flush and as
    the reference's default lane drops it (ROADMAP §C.1)."""
    from filodb_tpu.core.record import IngestRecord, RecordContainer
    keys = machine_metrics_series(3)
    raws = []
    for b in range(10):
        c = RecordContainer()
        for s in range(b * 10, b * 10 + 10):
            for i, k in enumerate(keys):
                v = np.nan if (s + i) % 7 == 0 else float(s)
                c.add(IngestRecord(k, START * 1000 + s * 10_000, (v,)))
        raws.append(c.serialize())
    ms = open_local(str(tmp_path / "p"), config=CFG)
    _port_ingest(ms, raws)
    q = "count_over_time(heap_usage[20m])"
    live = _port_answer(ms, q, START + 990, 60, START + 990)
    ms.flush_all()
    ms.close()
    ms2 = open_local(str(tmp_path / "p"), config=CFG)
    restart(ms2, {0: _Log(raws)})
    again = _port_answer(ms2, q, START + 990, 60, START + 990)
    ref = _ref_store(tmp_path / "r")
    _ref_ingest(ref, raws)
    want = _ref_answer(ref, q, START + 990, 60, START + 990)
    for got in (again, live):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    assert (want[1][:, 0] < 100).all()


def test_histograms_through_flush_restart_and_quantile(tmp_path):
    """Histogram containers (tag 1 values) through the log, a partial
    flush and a restart: ``histogram_quantile`` equals the live store's
    answer bitwise and the reference's within its device-path tolerance."""
    raws = _hists()
    log = SegmentedFileLog(str(tmp_path / "wal"), segment_entries=7)
    for r in raws:
        log.append(BytesContainer(r))
    ms = open_local(str(tmp_path / "data"), config=CFG)
    _port_ingest(ms, raws[:15])
    ms.flush_all()
    _port_ingest(ms, raws, 15)
    for g in range(2):
        ms.shards[0].flush_group(g)
    qs = ["histogram_quantile(0.9, sum(rate(http_req_latency[5m])) by "
          "(_ns_))", "sum(rate(http_req_latency[5m])) by (instance)",
          "sum(rate(http_req_latency::sum[5m])) by (_ns_)"]
    t0, t1 = START + 300, START + 1190
    live = [_port_answer(ms, q, t0, 30, t1, engine) for q in qs
            for engine in ("mesh", "exec")]
    ms.close()
    ms2 = open_local(str(tmp_path / "data"), config=CFG)
    got = restart(ms2, {0: log})
    assert got["keys"] == 4
    after = [_port_answer(ms2, q, t0, 30, t1, engine) for q in qs
             for engine in ("mesh", "exec")]
    for a, b in zip(after, live):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    assert ms2.shards[0].odp_cache.tables[True].columns["pid"].size > 0
    ref = _ref_store(tmp_path / "ref")
    _ref_ingest(ref, raws)
    want = _ref_answer(ref, qs[0], t0, 30, t1)
    assert after[0][0] == want[0]
    np.testing.assert_allclose(after[0][1], want[1], rtol=5e-5, atol=1e-4,
                               equal_nan=True)


@pytest.mark.parametrize("include_buffer", [False, True])
def test_chunk_infos_match_the_reference(tmp_path, include_buffer):
    raws = _counters(n_series=5, n_samples=130)
    ms = MemStore(1, 0, config=CFG)
    _port_ingest(ms, raws)
    ref = TimeSeriesMemStore()
    ref.setup(DS, 0, RefConfig(max_chunk_size=50, groups_per_shard=4))
    _ref_ingest(ref, raws)
    sel = 'http_requests_total{job=~"job-[01]"}'
    t0, t1 = START * 1000 + 600_000, START * 1000 + 1_200_000
    want = RefService(ref, DS, 1, spread=0).chunk_infos(
        ref_parse(sel, RefParams(0, 0, 0)).raw.filters, t0, t1,
        include_buffer)
    got = QueryService(ms, device="cpu").chunk_infos(
        port_parse(sel, TimeStepParams(0, 0, 0)).raw.filters, t0, t1,
        include_buffer)
    assert len(want) >= 4
    assert got == want


def test_both_engines_answer_alike_after_a_restart(tmp_path):
    raws = _counters(n_series=9, n_samples=240)
    ms = _crash_cycle(str(tmp_path), raws)
    for q in ("sum(rate(http_requests_total[5m])) by (job)",
              "sum(count_over_time(http_requests_total[5m])) by (job)",
              "max_over_time(http_requests_total[10m])",
              "http_requests_total"):
        mesh = _port_answer(ms, q, START + 600, 60, START + 2390, "mesh")
        exe = _port_answer(ms, q, START + 600, 60, START + 2390, "exec")
        assert mesh[0] == exe[0] and len(mesh[0]) > 0
        np.testing.assert_array_equal(mesh[1], exe[1])


def test_columnar_and_log_ingest_share_a_store(tmp_path):
    """Columnar ingest has no log offset (it counts as -1): flushed, it
    checkpoints -1, so replay after a restart starts at the log's first
    container and the columnar samples come back from disk."""
    ms = open_local(str(tmp_path), config=CFG)
    labels = [{"_metric_": "heap_usage", "_ws_": "demo", "_ns_": "App-0",
               "instance": f"instance-{i}", "host": f"H{i % 4}"}
              for i in range(8)]
    ts = START * 1000 + np.arange(100)[None, :] * 10_000 + np.zeros((8, 1),
                                                                   np.int64)
    ms.ingest_series(labels, ts, np.tile(np.arange(100.0), (8, 1)),
                     schema="gauge")
    ms.flush_all()
    assert set(ms.meta_store.read_checkpoints(DS, 0).values()) == {-1}
    later = _raws(gauge_stream(machine_metrics_series(8), 60,
                               start_ms=(START + 1000) * 1000, batch=50))
    _port_ingest(ms, later)
    ms.close()
    ms2 = open_local(str(tmp_path), config=CFG)
    got = restart(ms2, {0: _Log(later)})
    assert got["keys"] == 8 and got["skipped"] == 0
    k, v = _port_answer(ms2, "count_over_time(heap_usage[30m])", START + 1590,
                        60, START + 1590)
    np.testing.assert_array_equal(v[:, 0], 160.0)


def test_odp_cache_bound_drops_and_pages_again(tmp_path):
    """Past ``max_chunks`` the cache drops its least recently used chunks
    before the next page-in, which reads them again: the answers stay
    those of the live store, on both engines."""
    raws = _counters(n_series=9, n_samples=240)
    ms = open_local(str(tmp_path), config=CFG)
    _port_ingest(ms, raws)
    q = "sum(rate(http_requests_total[5m])) by (job)"
    live = _port_answer(ms, q, START + 600, 60, START + 2390)
    ms.flush_all()
    ms.close()
    ms2 = open_local(str(tmp_path), config=CFG)
    restart(ms2, {0: _Log(raws)})
    cache = ms2.shards[0].odp_cache
    cache.max_chunks = 5
    for engine in ("mesh", "exec", "mesh"):
        got = _port_answer(ms2, q, START + 600, 60, START + 2390, engine)
        assert got[0] == live[0]
        np.testing.assert_array_equal(got[1], live[1])
    assert cache.chunks_paged == 3 * 45 and len(cache) == 45


def test_ingest_stream_flushes_round_robin_and_recover_stream_replays(
        tmp_path):
    """``ingest_stream`` flushes the next group every ``flush_stagger``
    containers; after a crash, ``recover_stream`` replays the in-memory log
    from the recovery start and yields its progress offsets; the answers
    are the live store's."""
    raws = _counters(n_series=8, n_samples=150, batch=24)
    log = InMemoryLog()
    for r in raws:
        log.append(BytesContainer(r))
    ms = open_local(str(tmp_path), config=CFG)
    ms.ingest_stream(0, log.read_from(0), flush_stagger=10)
    cps = ms.meta_store.read_checkpoints(DS, 0)
    assert sorted(cps) == [0, 1, 2, 3][:len(raws) // 10]
    q = "sum(rate(http_requests_total[5m])) by (job)"
    live = _port_answer(ms, q, START + 600, 60, START + 1490)
    ms.close()
    ms2 = open_local(str(tmp_path), config=CFG)
    ms2.recover_index(0)
    start = ms2.recovery_start_offset(0)
    progress = list(ms2.recover_stream(0, log.read_from(start),
                                       checkpoint_interval=5))
    assert progress[-1] == log.latest_offset == len(raws) - 1
    assert progress[:-1] == list(range(max(start, 0) + 4, len(raws), 5))
    got = _port_answer(ms2, q, START + 600, 60, START + 1490)
    assert got[0] == live[0]
    np.testing.assert_array_equal(got[1], live[1])


def test_segment_retention_and_offset_alignment(tmp_path):
    """``truncate_before`` deletes whole segments below an offset (the
    newest stays); ``align_after`` makes the next append's offset pass a
    checkpoint that a torn tail may have destroyed."""
    raws = _gauges(n_series=2, n_samples=20, batch=2)
    log = SegmentedFileLog(str(tmp_path), segment_entries=4)
    for r in raws:
        log.append(BytesContainer(r))
    assert len(os.listdir(tmp_path)) == 5
    assert log.truncate_before(9) == 2
    assert [sd.offset for sd in log.read_from(0)] == list(range(8, 20))
    log.align_after(30)
    assert log.append(BytesContainer(raws[0])) == 31
    assert [sd.offset for sd in log.read_from(19)] == [19, 31]


def test_histogram_scheme_change_within_one_container():
    """A histogram container in which one series changes its bucket scheme
    twice (5, then 10, then 5 buckets) among another series' records: the
    port seals where the reference seals, chunk for chunk (ids, rows, time
    ranges; bytes aside, ROADMAP §C.3), and keeps the samples in order."""
    from filodb_tpu.core.record import IngestRecord as RefRecord
    from filodb_tpu.core.record import RecordContainer as RefContainer

    a, b = histogram_series(2)
    les5 = np.array([0.1, 0.5, 1.0, 5.0, np.inf])
    les10 = np.concatenate([np.geomspace(0.01, 5, 9), [np.inf]])
    c = RefContainer()
    for t in range(12):
        les = les10 if 4 <= t < 8 else les5
        for k, sch in ((a, les), (b, les5)):
            counts = np.cumsum(np.arange(1, len(sch) + 1) * (t + 1))
            c.add(RefRecord(k, START * 1000 + t * 10_000,
                            (float(t), float(counts[-1]), (sch, counts))))
    raw = c.serialize()
    ms = MemStore(1, 0, config=CFG)
    ms.shards[0].ingest(log_stream([raw])[0])
    ref = TimeSeriesMemStore()
    ref.setup(DS, 0, RefConfig(max_chunk_size=50, groups_per_shard=4))
    _ref_ingest(ref, [raw])
    keys = ("chunkId", "numRows", "startTime", "endTime")
    sel = port_parse("http_req_latency", TimeStepParams(0, 0, 0)).raw.filters
    got = QueryService(ms, device="cpu").chunk_infos(sel, 0, 2**62, True)
    want = RefService(ref, DS, 1, spread=0).chunk_infos(
        ref_parse("http_req_latency", RefParams(0, 0, 0)).raw.filters, 0,
        2**62, True)
    assert [tuple(g[k] for k in keys) for g in got] == \
        [tuple(w[k] for k in keys) for w in want]
    assert [g["numRows"] for g in got] == [4, 4, 4, 12]
