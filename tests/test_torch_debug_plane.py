"""The debug plane of the port against the reference's.

The cases of ``tests/test_repair_debug.py::TestDebugPlane`` and
``::TestProfilerAndSources`` on the port: chunk infos, the traced
partitions of ``StoreConfig.trace_part_key_substrings`` and the
single-writer tripwire of ``assert_single_writer`` (``core/memstore/
shard.py``), a corrupt vector, the sampling profiler
(``utils/profiler.py``), the file sources (``coordinator/sources.py``)
and ``hist_to_prom_vectors``. Beside them:

- the seeded generators of ``testing/data.py`` give the reference's
  containers byte for byte;
- a traced partition logs the lines the reference's
  ``TracingTimeSeriesPartition`` logs for the same containers (the port's
  on ``filodb_tpu_torch.trace``): each sample with its values and whether
  it was kept, and each chunk sealed with its id, rows and codec bytes;
- tracing changes nothing that is stored: a traced shard writes the
  chunks an untraced one writes, byte for byte, where the traced
  partition was made by columnar ingest first, its containers hold
  out-of-order and repeated samples, and it is a histogram;
- records at or below their group's watermark are skipped before they
  are traced, and a shard restored from its index snapshot traces the
  same partitions.

Every test runs under a time limit of its own.
"""

from __future__ import annotations

import logging
import signal
import threading
import time

import numpy as np
import pytest

from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.store.config import StoreConfig as RefStoreConfig
from filodb_tpu.testing import data as ref_data
from filodb_tpu_torch.coordinator.ingestion import ingest_routed
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.memstore.shard import Shard
from filodb_tpu_torch.core.record import (
    IngestRecord,
    RecordContainer,
    SomeData,
)
from filodb_tpu_torch.core.store.api import InMemoryColumnStore
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.memory.chunk import Chunk
from filodb_tpu_torch.testing import data

START = 1_600_000_000
LIMIT_S = 120
TRACE = "filodb_tpu_torch.trace"
REF_TRACE = "filodb_tpu.trace"


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(*_):
        raise TimeoutError(f"over the test's {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _populated_store(n_series=6):
    ms = MemStore(2, 1, config=StoreConfig(max_chunk_size=100))
    keys = data.machine_metrics_series(n_series)
    ingest_routed(ms, data.gauge_stream(keys, 200, start_ms=START * 1000))
    ms.flush_all()
    return ms


def _lines(caplog, logger: str) -> tuple[list[str], list[str]]:
    """(ingest lines, chunk lines) a logger logged, in order."""
    msgs = [r.getMessage() for r in caplog.records if r.name == logger]
    return ([m for m in msgs if " ingest " in m],
            [m for m in msgs if " encoded chunk " in m])


class TestDebugPlane:
    def test_chunk_infos(self):
        ms = _populated_store()
        svc = QueryService(ms, device="cpu")
        infos = svc.chunk_infos(
            [ColumnFilter("_metric_", Equals("heap_usage"))], 0, 2**62)
        assert len(infos) >= 6
        assert {"chunkId", "numRows", "startTime", "numBytes"} <= set(
            infos[0].keys())

    def test_tracing_partition_logs(self, caplog):
        shard = Shard(0, StoreConfig(
            max_chunk_size=50, trace_part_key_substrings=("instance-1",)))
        keys = data.machine_metrics_series(2)
        with caplog.at_level(logging.INFO, logger=TRACE):
            for sd in data.gauge_stream(keys, 5):
                shard.ingest(sd)
        assert any("TRACE" in r.message for r in caplog.records)
        traced = [r for r in caplog.records if "instance-1" in r.getMessage()]
        assert len(traced) == 5

    def test_corrupt_vector_error(self):
        # the port's chunk raises the codec's ValueError where the
        # reference wraps it in CorruptVectorError
        good = Chunk(1, 2, 0, 1000, (b"\x01garbage-not-a-vector", b"\xff"))
        with pytest.raises(ValueError, match="codec"):
            good.decode_column(1)

    def test_single_writer_assert(self):
        shard = Shard(0, StoreConfig(assert_single_writer=True))
        keys = data.machine_metrics_series(1)
        stream = list(data.gauge_stream(keys, 2, batch=1))
        shard.ingest(stream[0])
        errs = []

        def other():
            try:
                shard.ingest(stream[1])
            except AssertionError as e:
                errs.append(e)

        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert errs
        # the owner goes on ingesting
        assert shard.ingest(stream[1]) == 1

    def test_single_writer_off_takes_any_thread(self):
        shard = Shard(0, StoreConfig())
        stream = list(data.gauge_stream(data.machine_metrics_series(1), 2,
                                        batch=1))
        shard.ingest(stream[0])
        t = threading.Thread(target=shard.ingest, args=(stream[1],))
        t.start()
        t.join()
        assert shard.stats.rows_ingested.value == 2


class TestProfilerAndSources:
    def test_simple_profiler_samples(self):
        from filodb_tpu_torch.utils.profiler import SimpleProfiler

        prof = SimpleProfiler(sample_interval_s=0.002).start()
        t0 = time.monotonic()
        x = 0
        while time.monotonic() - t0 < 0.15:
            x += sum(range(1000))
        report = prof.stop()
        assert report  # captured at least one hot frame

    def test_csv_stream_source(self, tmp_path):
        from filodb_tpu.coordinator.sources import csv_stream as ref_csv
        from filodb_tpu_torch.coordinator.sources import csv_stream

        p = tmp_path / "x.csv"
        p.write_text("\n".join(f"{1000 + i},{i}.5,host=h{i % 2}"
                               for i in range(25)))
        out = list(csv_stream(str(p), "csv_metric", batch=10))
        assert len(out) == 3
        total = sum(len(sd.container) for sd in out)
        assert total == 25
        rec = out[0].container.records[0]
        assert rec.part_key.metric == "csv_metric"
        assert [sd.container.serialize() for sd in out] == [
            sd.container.serialize()
            for sd in ref_csv(str(p), "csv_metric", batch=10)]

    def test_influx_file_stream(self, tmp_path):
        from filodb_tpu.coordinator.sources import (
            influx_file_stream as ref_influx,
        )
        from filodb_tpu_torch.coordinator.sources import influx_file_stream

        p = tmp_path / "x.influx"
        p.write_text("\n".join(
            f"m,host=h value={i} {(1000 + i) * 1_000_000}"
            for i in range(5)) + "\nnot a line\n")
        out = list(influx_file_stream(str(p)))
        assert sum(len(sd.container) for sd in out) == 5
        assert [sd.container.serialize() for sd in out] == [
            sd.container.serialize() for sd in ref_influx(str(p))]

    def test_hist_to_prom_vectors(self):
        from filodb_tpu_torch.query.exec.transformers import (
            InstantVectorFunctionMapper,
        )
        from filodb_tpu_torch.query.model import RangeVectorKey, StepMatrix

        m = StepMatrix([RangeVectorKey.of({"app": "a"})],
                       np.arange(6, dtype=float).reshape(1, 2, 3),
                       np.array([0, 1000]), les=np.array([1.0, 2.0, np.inf]))
        out = InstantVectorFunctionMapper("hist_to_prom_vectors").apply(m)
        assert out.num_series == 3
        les = sorted(k.label_map["le"] for k in out.keys)
        assert "+Inf" in les


GENERATORS = {
    "gauge": lambda d, seed: d.gauge_stream(
        d.machine_metrics_series(7, ns="App-3"), 9, start_ms=5_000,
        batch=8, seed=seed, start_offset=4),
    "counter": lambda d, seed: d.counter_stream(
        d.counter_series(5), 7, batch=6, seed=seed, reset_every=3,
        start_value=2.0**30),
    "histogram": lambda d, seed: d.histogram_stream(
        d.histogram_series(3, ws="w"), 6, interval_ms=15_000, batch=5,
        seed=seed),
    "histogram-les": lambda d, seed: d.histogram_stream(
        d.histogram_series(2), 4, batch=3, seed=seed,
        les=np.array([1.0, 10.0, np.inf])),
}


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_give_the_reference_containers(name, seed):
    got = list(GENERATORS[name](data, seed))
    want = list(GENERATORS[name](ref_data, seed))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.offset == w.offset
        assert g.container.serialize() == w.container.serialize()


def _port_pair(trace: tuple, **cfg) -> list[Shard]:
    """A traced and an untraced shard, each over its own in-memory column
    store."""
    return [Shard(0, StoreConfig(trace_part_key_substrings=t, **cfg),
                  column_store=InMemoryColumnStore()) for t in (trace, ())]


def _stored(shard: Shard) -> list:
    """Every chunk the shard writes at a flush of everything, by part
    key, in chunk-id order."""
    shard.flush_all(0)
    blobs = [shard.keys.blob(p) for p in range(shard.num_partitions)]
    rows = shard.column_store.read_chunk_rows("timeseries", 0, blobs, 0,
                                              2**62)
    return sorted((bytes(b), Chunk.deserialize(d).id, bytes(d))
                  for b, d in rows)


def _jumbled(keys, rng) -> list[SomeData]:
    """Containers of ``keys``' samples with out-of-order and repeated
    timestamps, a series' records spread over the containers."""
    out = []
    for off in range(4):
        c = RecordContainer()
        for _ in range(30):
            k = keys[int(rng.integers(len(keys)))]
            ts = int(rng.integers(20, 60)) * 10_000 + off * 200_000
            c.add(IngestRecord(k, ts, (float(rng.normal(50, 3)),)))
        out.append(SomeData(c, off))
    return out


def test_traced_samples_keep_their_order_against_the_pass():
    rng = np.random.default_rng(5)
    keys = data.machine_metrics_series(4)
    traced, plain = _port_pair(("instance-1", "instance-3"),
                               max_chunk_size=7)
    # instance-1 is made by columnar ingest first, so the pass never sees
    # it unlisted; instance-3 first comes in a container
    ts = np.arange(5, dtype=np.int64)[None, :].repeat(2, 0) * 10_000
    vals = rng.normal(50, 3, (2, 5))
    for sh in (traced, plain):
        sh.ingest_series(keys[:2], ts, vals, np.array([5, 3]))
    assert traced.traced[:2].tolist() == [False, True]
    for sd in _jumbled(keys, rng):
        kept = [sh.ingest(sd) for sh in (traced, plain)]
        assert kept[0] == kept[1]
    assert traced.traced[:4].tolist() == [False, True, False, True]
    assert traced.listed[:4].tolist() == [False, True, False, True]
    assert not plain.listed[:4].any()
    np.testing.assert_array_equal(traced.latest[:4], plain.latest[:4])
    assert _stored(traced) == _stored(plain)


def test_a_traced_histogram_stays_on_its_path(caplog):
    keys = data.histogram_series(3)
    traced, plain = _port_pair(("instance-2",), max_chunk_size=4)
    with caplog.at_level(logging.INFO, logger=TRACE):
        for sd in data.histogram_stream(keys, 9, batch=5, seed=3):
            assert traced.ingest(sd) == plain.ingest(sd)
        assert _stored(traced) == _stored(plain)
    assert traced.hist[:3].all() and traced.traced[:3].tolist() == [
        False, False, True]
    ingests, chunks = _lines(caplog, TRACE)
    assert len(ingests) == 9 and all("instance-2" in m for m in ingests)
    assert len(chunks) == 3  # 9 samples: two full chunks and the flush's


def _ref_shard(trace: tuple, **cfg):
    return TimeSeriesMemStore().setup("timeseries", 0, RefStoreConfig(
        trace_part_key_substrings=trace, **cfg))


@pytest.mark.parametrize("kind", ["gauge", "histogram"])
def test_trace_lines_are_the_reference_lines(kind, caplog):
    if kind == "gauge":
        def stream(d):
            return d.gauge_stream(d.machine_metrics_series(3), 12, batch=5,
                                  seed=2)
    else:
        def stream(d):
            return d.histogram_stream(d.histogram_series(3), 12, batch=5,
                                      seed=2)
    shard = Shard(0, StoreConfig(max_chunk_size=5,
                                 trace_part_key_substrings=("instance-1",)))
    ref = _ref_shard(("instance-1",), max_chunk_size=5)
    with caplog.at_level(logging.INFO):
        for sd in stream(data):
            shard.ingest(sd)
        for sd in stream(ref_data):
            ref.ingest(sd)
    got, want = _lines(caplog, TRACE), _lines(caplog, REF_TRACE)
    assert len(got[0]) == 12
    # the reference logs a chunk as it seals, between two samples; the
    # port logs a container's samples of a partition before the chunks
    # their append seals: each kind of line comes in the same order
    assert got == want


def test_out_of_order_samples_are_traced_as_dropped(caplog):
    key = data.machine_metrics_series(2)[1]
    c = RecordContainer()
    for ts in (30_000, 10_000, 30_000, 40_000):
        c.add(IngestRecord(key, ts, (1.5,)))
    shard = Shard(0, StoreConfig(trace_part_key_substrings=("instance-1",)))
    ref = _ref_shard(("instance-1",))
    with caplog.at_level(logging.INFO):
        assert shard.ingest(SomeData(c, 0)) == 2
        ref.ingest(SomeData(c_ref := _ref_container(c), 0))
    got, want = _lines(caplog, TRACE), _lines(caplog, REF_TRACE)
    assert [m.endswith("accepted=True") for m in got[0]] == [
        True, False, False, True]
    assert got == want
    assert len(c_ref.records) == 4


def _ref_container(c: RecordContainer):
    from filodb_tpu.core.record import RecordContainer as RefContainer

    return RefContainer.deserialize(c.serialize())


def test_records_below_the_watermark_are_not_traced(caplog):
    keys = data.machine_metrics_series(2)
    shard = Shard(0, StoreConfig(groups_per_shard=1,
                                 trace_part_key_substrings=("instance",)))
    stream = list(data.gauge_stream(keys, 6, batch=4))
    shard.group_watermarks[:] = stream[0].offset
    with caplog.at_level(logging.INFO, logger=TRACE):
        for sd in stream:
            shard.ingest(sd)
    ingests, _ = _lines(caplog, TRACE)
    assert shard.rows_skipped == 4
    assert len(ingests) == 12 - 4


def test_a_restored_shard_traces_the_same_partitions(tmp_path):
    from filodb_tpu_torch.core.store.localstore import (
        LocalDiskColumnStore,
        LocalDiskMetaStore,
    )

    cfg = StoreConfig(trace_part_key_substrings=("instance-2",))
    keys = data.machine_metrics_series(4)
    root = str(tmp_path)
    shard = Shard(0, cfg, column_store=LocalDiskColumnStore(root),
                  meta_store=LocalDiskMetaStore(root))
    for sd in data.gauge_stream(keys, 3):
        shard.ingest(sd)
    shard.flush_all(0)
    shard.snapshot_index()
    again = Shard(0, cfg, column_store=LocalDiskColumnStore(root),
                  meta_store=LocalDiskMetaStore(root))
    assert again.recover_index() == 4
    assert again.recovered_from == "snapshot"
    np.testing.assert_array_equal(again.traced[:4], shard.traced[:4])
    assert again.traced[:4].tolist() == [False, False, True, False]
    assert again.listed[:4].tolist() == [False, False, True, False]
