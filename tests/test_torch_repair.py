"""Port parity for the repair jobs (``filodb_tpu_torch/core/store/repair.py``)
and the column stores' split scans.

The cases of ``tests/test_repair_debug.py::TestRepairJobs``: the same
gauge stream flushed into a store of each package, then each package's
job over its own store; the stores' rows after the job are the
reference's (part keys, and chunks byte for byte). Then the split scans
the jobs fan out over: on the port's in-memory and local-disk stores the
splits are disjoint, their union is the full scan, each key lands in the
split the reference's store gives it, and a job over splits writes what
the job over one split writes.
"""

from __future__ import annotations

import pytest

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.core.filters import ColumnFilter as RefFilter
from filodb_tpu.core.filters import Equals as RefEquals
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.store import repair as ref_repair
from filodb_tpu.core.store.api import InMemoryColumnStore as RefColumnStore
from filodb_tpu.core.store.api import InMemoryMetaStore as RefMetaStore
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.core.store.localstore import (
    LocalDiskColumnStore as RefLocalStore,
)
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.coordinator.ingestion import route_container
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import RecordContainer, SomeData
from filodb_tpu_torch.core.store import repair
from filodb_tpu_torch.core.store.api import InMemoryColumnStore, split_of
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.core.store.localstore import (
    LocalDiskColumnStore,
    LocalDiskMetaStore,
)

DS = "timeseries"
START = 1_600_000_000
ITIME = 1_000   # the flush's ingestion time, alike on both sides
ALL = (0, 2**62)


def _stream():
    return list(gauge_stream(machine_metrics_series(6), 200,
                             start_ms=START * 1000))


def populated(port_cs=None):
    """(reference column store, port column store): six gauges of 200
    samples over two shards, flushed by each package's store."""
    rcs = RefColumnStore()
    rms = TimeSeriesMemStore(rcs, RefMetaStore())
    for s in range(2):
        rms.setup(DS, s, RefConfig(max_chunk_size=100))
    stream = _stream()
    ingest_routed(rms, DS, stream, 2, 1)
    for s in range(2):
        rms.shards_for(DS)[s].flush_all(ITIME)
    pms = MemStore(2, 1, column_store=port_cs or InMemoryColumnStore(),
                   config=StoreConfig(max_chunk_size=100))
    for sd in stream:
        cont = RecordContainer.deserialize(sd.container.serialize())
        for s, c in route_container(cont, 2, 1).items():
            pms.shards[s].ingest(SomeData(c, sd.offset))
    pms.flush_all(ITIME)
    return rcs, pms.column_store


def part_keys(cs, dataset=DS) -> list:
    """(shard, part key, start, end) rows of a store of either package,
    keys as their label tuples and schema."""
    return sorted((s, r.part_key.schema, tuple(r.part_key.labels),
                   r.start_time, r.end_time)
                  for s in range(2) for r in cs.scan_part_keys(dataset, s))


def port_chunks(cs, dataset=DS) -> set:
    return {(s, bytes(b), bytes(d)) for s in range(2) for b, d in
            cs.read_chunk_rows(dataset, s, [r.part_key.serialized for r in
                                            cs.scan_part_keys(dataset, s)],
                               *ALL)}


def ref_chunks(cs, keys_cs, dataset=DS) -> set:
    return {(s, r.part_key.serialized, c.serialize())
            for s in range(2) for r in keys_cs.scan_part_keys(dataset, s)
            for c in cs.read_chunks(dataset, s, r.part_key, *ALL)}


class TestRepairJobs:
    def test_chunk_copier(self):
        rsrc, psrc = populated()
        rdst, pdst = RefColumnStore(), InMemoryColumnStore()
        want = ref_repair.ChunkCopier(rsrc, rdst, DS, 2).run(*ALL)
        got = repair.ChunkCopier(psrc, pdst, DS, 2).run(*ALL)
        assert got == want
        assert got["partitions"] == 6 and got["chunks"] >= 6
        # the copies are the source's chunks, as the reference copies
        copied = {(s, bytes(b), bytes(d)) for s in range(2) for b, d in
                  pdst.read_chunk_rows(DS, s, [r.part_key.serialized for r in
                                               psrc.scan_part_keys(DS, s)],
                                       *ALL)}
        assert copied == port_chunks(psrc) == ref_chunks(rdst, rsrc)

    def test_partition_keys_copier(self):
        rsrc, psrc = populated()
        rdst, pdst = RefColumnStore(), InMemoryColumnStore()
        n = repair.PartitionKeysCopier(psrc, pdst, DS, 2).run()
        assert n == 6 == ref_repair.PartitionKeysCopier(rsrc, rdst, DS,
                                                        2).run()
        assert part_keys(pdst) == part_keys(rdst) == part_keys(psrc)

    def test_cardinality_buster(self):
        rcs, pcs = populated()
        busted = repair.CardinalityBuster(pcs, DS, 2).run(
            [ColumnFilter("instance", Equals("instance-0"))])
        assert busted == 1 == ref_repair.CardinalityBuster(rcs, DS, 2).run(
            [RefFilter("instance", RefEquals("instance-0"))])
        assert part_keys(pcs) == part_keys(rcs) and len(part_keys(pcs)) == 5
        assert port_chunks(pcs) == ref_chunks(rcs, rcs)
        assert all(dict(k[2])["instance"] != "instance-0"
                   for k in part_keys(pcs))

    def test_ds_index_job(self):
        rcs, pcs = populated()
        ds = "timeseries_ds_5m"
        n = repair.DSIndexJob(pcs, DS, ds, 2).run()
        assert n == 6 == ref_repair.DSIndexJob(rcs, DS, ds, 2).run()
        assert part_keys(pcs, ds) == part_keys(rcs, ds)
        assert {k[1] for k in part_keys(pcs, ds)} == {"ds-gauge"}


class TestSplitScans:
    @pytest.mark.parametrize("n_splits", [2, 3])
    def test_in_memory_splits_disjoint_and_complete(self, n_splits):
        _, cs = populated()
        for s in range(2):
            full = cs.scan_part_keys(DS, s)
            parts = [cs.scan_part_keys_split(DS, s, k, n_splits)
                     for k in range(n_splits)]
            for k, part in enumerate(parts):
                assert all(split_of(r.part_key.serialized, n_splits) == k
                           for r in part)
            assert sorted(r.part_key.serialized for p in parts for r in p) \
                == sorted(r.part_key.serialized for r in full)
            rows = cs.scan_chunk_rows_by_ingestion_time(DS, s, 0, 2**62)
            split_rows = [r for k in range(n_splits) for r in
                          cs.scan_chunk_rows_by_ingestion_time_split(
                              DS, s, 0, 2**62, k, n_splits)]
            assert sorted(map(tuple, split_rows)) == sorted(map(tuple, rows))

    def test_local_store_splits_are_the_references(self, tmp_path):
        root = str(tmp_path / "cs")
        _, cs = populated(LocalDiskColumnStore(root))
        LocalDiskMetaStore(root).close()
        ref = RefLocalStore(root)
        try:
            for s in range(2):
                for n in (2, 4):
                    seen = []
                    for k in range(n):
                        got = [r.part_key.serialized for r in
                               cs.scan_part_keys_split(DS, s, k, n)]
                        assert sorted(got) == sorted(
                            r.part_key.serialized for r in
                            ref.scan_part_keys_split(DS, s, k, n))
                        seen += got
                    assert sorted(seen) == sorted(
                        r.part_key.serialized
                        for r in cs.scan_part_keys(DS, s))
        finally:
            ref.close()
            cs.close()

    def test_copier_over_splits_writes_what_one_split_writes(self, tmp_path):
        _, src = populated(LocalDiskColumnStore(str(tmp_path / "src")))
        one, four = InMemoryColumnStore(), InMemoryColumnStore()
        a = repair.ChunkCopier(src, one, DS, 2).run(*ALL)
        b = repair.ChunkCopier(src, four, DS, 2, n_splits=4).run(*ALL)
        assert a == b
        keys = {s: [r.part_key.serialized for r in src.scan_part_keys(DS, s)]
                for s in range(2)}
        for s in range(2):
            assert sorted(map(tuple, one.read_chunk_rows(DS, s, keys[s],
                                                         *ALL))) == \
                sorted(map(tuple, four.read_chunk_rows(DS, s, keys[s],
                                                       *ALL)))
        src.close()
