"""Port parity for the object-store tier: CRC32C in host C++, FakeS3, the
segment format, write-behind upload with checkpoint ordering, recovery,
compaction and tombstones, the integrity tripwires, split scans, SigV4,
the factory, buckets either package wrote, the downsampler job over the
store, a cold tier lost to faults, and a node with ``store.backend =
"object"``.

The cases of ``tests/test_objectstore.py`` run against the port's row
API (``write_chunk_rows`` / ``read_chunk_rows`` of serialized chunks);
equal writes to both packages' stores give byte-equal objects (segments,
pyramids, manifests, checkpoints, the index snapshot), and either package
reads a bucket the other wrote. The repair jobs fan out over the buckets'
splits (``core/store/repair.py``).

A cold tier lost to transport faults raises in the port, never returns
wrong data; the reference answers the other tiers as a partial result,
through partial scatter-gather (ROADMAP A7, §C).
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.store import objectstore as ref_os
from filodb_tpu.core.store.api import PartKeyRecord as RefPKR
from filodb_tpu.core.store.localstore import _pk_blob
from filodb_tpu.memory.chunk import Chunk as RefChunk
from filodb_tpu.memory.chunk import encode_chunk as ref_encode_chunk
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as REF_SCHEMAS
from filodb_tpu.testing.fake_s3 import FakeS3 as RefS3
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import BytesContainer, SomeData
from filodb_tpu_torch.core.store import objectstore as osmod
from filodb_tpu_torch.core.store import pyramid as pyrmod
from filodb_tpu_torch.core.store.api import (
    PartKeyRecord,
    pk_from_blob,
    split_of,
)
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.core.store.objectstore import (
    CorruptSegmentError,
    ObjectStoreColumnStore,
    ObjectStoreError,
    ObjectStoreMetaStore,
    _canon_query,
    crc32c,
    open_object_store,
    parse_segment,
)
from filodb_tpu_torch.memory.chunk import Chunk
from filodb_tpu_torch.testing.fake_s3 import FakeS3, S3TransientError

DS = "timeseries"


def _pk(i: int) -> PartKey:
    return PartKey.create("gauge", {"_metric_": "heap_usage",
                                    "_ws_": "demo", "_ns_": f"app-{i}"})


def _chunk(cid: int, n: int = 10, t0: int = 1000) -> Chunk:
    """A chunk of raw vectors (not codec ones), as the reference's tests
    make them."""
    ts = np.arange(t0, t0 + n * 1000, 1000, dtype=np.int64)
    vals = np.arange(n, dtype=np.float64) + cid
    return Chunk(cid, n, int(ts[0]), int(ts[-1]),
                 (ts.tobytes(), vals.tobytes()))


def _write(cs, shard, pk, chunks, itime):
    cs.write_chunk_rows(DS, shard, [(pk.serialized, c.id, c.start_time,
                                     c.end_time, c.serialize())
                                    for c in chunks], itime)


def _read(cs, shard, pk) -> list[Chunk]:
    return [Chunk.deserialize(d) for _, d in
            cs.read_chunk_rows(DS, shard, [pk.serialized], 0, 2**62)]


def _mk(client=None, **kw) -> ObjectStoreColumnStore:
    return ObjectStoreColumnStore(client or FakeS3(), **kw)


# ---- CRC32C -------------------------------------------------------------------


class TestCrc32c:
    def test_reference_vector(self):
        # RFC 3720's check value
        assert crc32c(b"123456789") == 0xE3069283 \
            == ref_os.crc32c(b"123456789")

    def test_incremental(self):
        assert crc32c(b"6789", crc32c(b"12345")) == crc32c(b"123456789")

    @pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 15, 16, 17, 1000, 65537])
    def test_host_cpp_equals_the_references_python(self, n):
        data = np.random.default_rng(n).integers(0, 256, n,
                                                 dtype=np.uint8).tobytes()
        assert crc32c(data) == ref_os.crc32c(data)
        assert crc32c(data, 0x1234) == ref_os.crc32c(data, 0x1234)



# ---- FakeS3 ---------------------------------------------------------------------


class TestFakeS3:
    def test_put_get_range_list_delete(self):
        s3 = FakeS3()
        s3.put_object("a/b", b"hello world")
        assert s3.get_object("a/b") == b"hello world"
        assert s3.get_object("a/b", start=6, length=5) == b"world"
        s3.put_object("a/c", b"x")
        assert s3.list_objects("a/") == ["a/b", "a/c"]
        s3.delete_object("a/b")
        assert s3.list_objects("a/") == ["a/c"]
        with pytest.raises(KeyError):
            s3.get_object("a/b")

    def test_dir_backed_persists(self, tmp_path):
        FakeS3(root=str(tmp_path)).put_object("k", b"v")
        assert FakeS3(root=str(tmp_path)).get_object("k") == b"v"
        # and the reference's fake reads the port's directory
        assert RefS3(root=str(tmp_path)).get_object("k") == b"v"

    def test_fault_injection(self):
        s3 = FakeS3()
        s3.inject("put", times=2, exc=S3TransientError("boom"))
        with pytest.raises(S3TransientError):
            s3.put_object("k", b"v")
        with pytest.raises(S3TransientError):
            s3.put_object("k", b"v")
        s3.put_object("k", b"v")
        assert s3.get_object("k") == b"v"


# ---- the segment format, recovery, tombstones --------------------------------


class TestSegmentFormat:
    def test_roundtrip_and_manifest(self):
        cs = _mk()
        pk = _pk(0)
        chunks = [_chunk(1), _chunk(2, t0=20_000)]
        _write(cs, 0, pk, chunks, 111)
        cs.write_part_keys(DS, 0, [PartKeyRecord(pk, 1000, 29_000)])
        cs.flush()
        back = _read(cs, 0, pk)
        assert [c.id for c in back] == [1, 2]
        assert list(back[0].vectors) == list(chunks[0].vectors)
        man = json.loads(
            cs.client.get_object(f"filodb/{DS}/shard-0/manifest.json"))
        assert len(man["segments"]) >= 1
        seg_key = man["segments"][0]["key"]
        entries = parse_segment(cs.client.get_object(seg_key), seg_key)
        assert any(e[0] == "chunk" for e in entries)
        cs.close()

    def test_idempotent_rewrite_dedups(self):
        cs = _mk()
        pk = _pk(0)
        _write(cs, 0, pk, [_chunk(1)], 1)
        _write(cs, 0, pk, [_chunk(1)], 1)
        cs.flush()
        assert len(_read(cs, 0, pk)) == 1
        cs.close()

    def test_cold_recovery(self, tmp_path):
        s3root = str(tmp_path / "s3")
        cs = _mk(FakeS3(root=s3root))
        meta = ObjectStoreMetaStore(cs)
        pks = [_pk(i) for i in range(5)]
        for i, pk in enumerate(pks):
            _write(cs, 0, pk, [_chunk(i + 1)], i)
        cs.write_part_keys(DS, 0, [PartKeyRecord(pk, 1000, 10_000)
                                   for pk in pks])
        meta.write_checkpoint(DS, 0, 0, 42)
        cs.close()
        cs2 = _mk(FakeS3(root=s3root))
        meta2 = ObjectStoreMetaStore(cs2)
        assert {r.part_key for r in cs2.scan_part_keys(DS, 0)} == set(pks)
        for i, pk in enumerate(pks):
            assert [c.id for c in _read(cs2, 0, pk)] == [i + 1]
        assert meta2.read_checkpoints(DS, 0) == {0: 42}
        assert meta2.durable_checkpoints(DS, 0) == {0: 42}
        scanned = {b for b, _ in cs2.scan_chunk_rows_by_ingestion_time(
            DS, 0, 0, 3)}
        assert scanned == {pk.serialized for pk in pks[:3]}
        cs2.close()

    def test_delete_tombstone_durable(self, tmp_path):
        s3root = str(tmp_path / "s3")
        cs = _mk(FakeS3(root=s3root))
        pk0, pk1 = _pk(0), _pk(1)
        for pk in (pk0, pk1):
            _write(cs, 0, pk, [_chunk(1)], 1)
        cs.write_part_keys(DS, 0, [PartKeyRecord(pk0, 0, 1),
                                   PartKeyRecord(pk1, 0, 1)])
        cs.delete_part_keys(DS, 0, [pk0])
        cs.close()
        cs2 = _mk(FakeS3(root=s3root))
        assert [r.part_key for r in cs2.scan_part_keys(DS, 0)] == [pk1]
        assert _read(cs2, 0, pk0) == []
        cs2.close()

    def test_index_snapshot_roundtrip(self, tmp_path):
        s3root = str(tmp_path / "s3")
        cs = _mk(FakeS3(root=s3root))
        cs.write_index_snapshot(DS, 0, b"snapshot-bytes")
        cs.close()
        cs2 = _mk(FakeS3(root=s3root))
        assert cs2.read_index_snapshot(DS, 0) == b"snapshot-bytes"
        assert cs2.read_index_snapshot(DS, 1) is None
        cs2.close()


# ---- write-behind ------------------------------------------------------------------


class TestWriteBehind:
    def test_checkpoint_never_ahead_of_data(self):
        s3 = FakeS3()
        order = []
        real_put = s3.put_object

        def spy_put(key, data):
            order.append(key)
            real_put(key, data)

        s3.put_object = spy_put
        cs = _mk(s3)
        meta = ObjectStoreMetaStore(cs)
        _write(cs, 0, _pk(0), [_chunk(1)], 1)
        meta.write_checkpoint(DS, 0, 0, 99)
        cs.flush()
        seg_idx = [i for i, k in enumerate(order) if k.endswith(".seg")]
        ckpt_idx = [i for i, k in enumerate(order)
                    if k.endswith("checkpoints.json")]
        assert seg_idx and ckpt_idx
        assert max(seg_idx) < min(ckpt_idx)
        cs.close()

    def test_upload_retries_never_lose_acked_flush(self, tmp_path):
        s3 = FakeS3(root=str(tmp_path / "s3"))
        s3.inject("put", times=3, exc=S3TransientError("503"))
        cs = _mk(s3)
        pk = _pk(0)
        r0 = osmod.RETRIES.value
        _write(cs, 0, pk, [_chunk(1)], 1)
        cs.write_part_keys(DS, 0, [PartKeyRecord(pk, 1000, 10_000)])
        cs.flush()
        assert cs.upload_errors() == []
        cs.close()
        assert osmod.RETRIES.value >= r0 + 3
        cs2 = _mk(FakeS3(root=str(tmp_path / "s3")))
        assert len(_read(cs2, 0, pk)) == 1
        cs2.close()

    def test_fatal_upload_failure_parks_checkpoint_and_flush_raises(
            self, tmp_path):
        s3 = FakeS3(root=str(tmp_path / "s3"))
        s3.inject("put", times=1, exc=ObjectStoreError("403 AccessDenied"))
        cs = _mk(s3)
        meta = ObjectStoreMetaStore(cs)
        pk = _pk(0)
        _write(cs, 0, pk, [_chunk(1)], 1)
        meta.write_checkpoint(DS, 0, 0, 99)
        with pytest.raises(ObjectStoreError):
            cs.flush()
        assert cs.upload_errors()
        keys = s3.list_objects("")
        assert not any(k.endswith(".seg") for k in keys)
        assert not any(k.endswith("checkpoints.json") for k in keys)
        assert meta.durable_checkpoints(DS, 0) == {}
        with pytest.raises(ObjectStoreError):
            cs.close()
        cs2 = _mk(FakeS3(root=str(tmp_path / "s3")))
        assert ObjectStoreMetaStore(cs2).read_checkpoints(DS, 0) == {}
        assert _read(cs2, 0, pk) == []
        cs2.close()

    def test_fatal_failure_in_one_shard_spares_others(self):
        s3 = FakeS3()
        cs = _mk(s3)
        meta = ObjectStoreMetaStore(cs)
        pk = _pk(0)
        _write(cs, 0, pk, [_chunk(1)], 1)
        s3.inject("put", times=1, exc=ObjectStoreError("403"))
        meta.write_checkpoint(DS, 0, 0, 7)
        _write(cs, 1, pk, [_chunk(1)], 1)
        meta.write_checkpoint(DS, 1, 0, 8)
        with pytest.raises(ObjectStoreError):
            cs.flush()
        keys = s3.list_objects("")
        assert any("shard-1" in k and k.endswith("checkpoints.json")
                   for k in keys)
        assert not any("shard-0" in k and k.endswith("checkpoints.json")
                       for k in keys)

    def test_read_your_writes_before_upload(self):
        s3 = FakeS3(latency_s=0)
        cs = _mk(s3)
        pk = _pk(0)
        _write(cs, 0, pk, [_chunk(1)], 1)
        gets_before = s3.op_counts.get("get", 0)
        assert len(_read(cs, 0, pk)) == 1
        assert s3.op_counts.get("get", 0) == gets_before
        cs.close()

    def test_multipart_for_large_segments(self):
        s3 = FakeS3()
        cs = _mk(s3, segment_target_bytes=1 << 20,
                 multipart_threshold=64 * 1024)
        pk = _pk(0)
        big = [_chunk(i + 1, n=4000, t0=i * 10_000_000) for i in range(4)]
        _write(cs, 0, pk, big, 1)
        cs.flush()
        assert s3.op_counts.get("multipart", 0) >= 3
        assert [c.id for c in _read(cs, 0, pk)] == [1, 2, 3, 4]
        cs.close()

    def test_a_shard_flush_lands_its_segments_before_its_checkpoint(
            self, tmp_path):
        """The port's flush (chunks, part keys, then the checkpoint), run
        group by group on a flush thread: when a shard's checkpoint object
        lands, every chunk of the groups it names is in the bucket's
        segments already."""
        root = str(tmp_path / "s3")
        s3 = FakeS3(root=root, latency_s=0.002)
        seen = []
        real_put = s3.put_object

        def spy_put(key, data):
            if key.endswith("checkpoints.json"):
                have = set()
                for k in s3.list_objects(key.rsplit("/", 1)[0]):
                    if k.endswith(".seg"):
                        have |= {(e[1], e[2]) for e in parse_segment(
                            s3.get_object(k), k) if e[0] == "chunk"}
                seen.append((key, json.loads(data), have))
            real_put(key, data)

        s3.put_object = spy_put
        cs = _mk(s3, segment_target_bytes=2048)
        ms = MemStore(1, spread=0, column_store=cs,
                      meta_store=ObjectStoreMetaStore(cs),
                      config=StoreConfig(max_chunk_size=20,
                                         groups_per_shard=4))
        from test_torch_pyramids import _containers

        keys = [_ref_key(i) for i in range(24)]
        vals = np.arange(24 * 60, dtype=np.float64).reshape(24, 60)
        shard = ms.shards[0]
        for off, c in enumerate(_containers(keys, vals, 0, 60)):
            shard.ingest(SomeData(BytesContainer(c.serialize()), off))
        flusher = threading.Thread(target=lambda: [
            shard.flush_group(g, 5) for g in range(4)])
        flusher.start()
        flusher.join()
        cs.flush()
        col = shard._sealed.columns
        group_of = shard.group
        assert seen
        for key, doc, have in seen:
            for g in (int(x) for x in doc):
                pids = np.flatnonzero(group_of[:shard.num_partitions] == g)
                want = {(shard.keys[p].serialized, int(c)) for p, c in
                        zip(col["pid"].tolist(), col["cid"].tolist())
                        if p in set(pids.tolist())}
                assert want <= have, (key, g)
        cs.close()


# ---- the integrity tripwires -----------------------------------------------------


class TestIntegrityTripwire:
    def test_flipped_byte_raises_never_wrong_results(self):
        s3 = FakeS3()
        cs = _mk(s3)
        pk = _pk(0)
        _write(cs, 0, pk, [_chunk(1)], 1)
        cs.flush()
        seg_key = next(k for k in s3.list_objects("") if k.endswith(".seg"))
        s3.corrupt(seg_key, offset=len(s3.get_object(seg_key)) // 2)
        before = osmod.CORRUPT.value
        cs2 = _mk(s3)
        with pytest.raises(CorruptSegmentError):
            _read(cs2, 0, pk)
        assert osmod.CORRUPT.value > before
        cs2.close()
        cs.close()

    def test_corrupt_segment_fails_recovery_scan(self, tmp_path):
        s3 = FakeS3(root=str(tmp_path / "s3"))
        cs = _mk(s3)
        _write(cs, 0, _pk(0), [_chunk(1)], 1)
        cs.close()
        seg_key = next(k for k in s3.list_objects("") if k.endswith(".seg"))
        s3.corrupt(seg_key, offset=10)
        cs2 = _mk(FakeS3(root=str(tmp_path / "s3")))
        with pytest.raises(CorruptSegmentError):
            cs2.scan_part_keys(DS, 0)
        cs2.close()


# ---- compaction ------------------------------------------------------------------


class TestCompaction:
    def test_small_segments_merge_and_survive_recovery(self, tmp_path):
        s3 = FakeS3(root=str(tmp_path / "s3"))
        cs = _mk(s3, bucket_count=1, compact_min_segments=4,
                 auto_compact=False)
        pk = _pk(0)
        for i in range(8):
            _write(cs, 0, pk, [_chunk(i + 1)], i)
            cs.flush()
        segs_before = [k for k in s3.list_objects("") if k.endswith(".seg")]
        assert len(segs_before) == 8
        before = osmod.COMPACTIONS.value
        assert cs.compact(DS, 0) >= 1
        cs.flush()
        assert osmod.COMPACTIONS.value > before
        segs_after = [k for k in s3.list_objects("") if k.endswith(".seg")]
        assert len(segs_after) < len(segs_before)
        assert [c.id for c in _read(cs, 0, pk)] == list(range(1, 9))
        cs.close()
        cs2 = _mk(FakeS3(root=str(tmp_path / "s3")))
        assert [c.id for c in _read(cs2, 0, pk)] == list(range(1, 9))
        cs2.close()

    def test_stale_refs_after_compaction_swap_re_resolve(self):
        cs = _mk(bucket_count=1, auto_compact=False)
        pk = _pk(0)
        for i in range(4):
            _write(cs, 0, pk, [_chunk(i + 1)], i)
            cs.flush()
        st = cs._state(DS, 0)
        with cs._lock:
            stale = sorted(st.chunks[pk.serialized].values(),
                           key=lambda r: r.chunk_id)
        assert cs.compact(DS, 0) >= 1
        payloads = cs._fetch_refs(DS, 0, st, pk.serialized, stale)
        assert sorted(payloads) == [1, 2, 3, 4]
        cs.close()

    def test_compaction_drops_tombstoned_entries(self):
        s3 = FakeS3()
        cs = _mk(s3, bucket_count=1, auto_compact=False)
        pk0, pk1 = _pk(0), _pk(1)
        for pk in (pk0, pk1):
            _write(cs, 0, pk, [_chunk(1)], 1)
            cs.flush()
        cs.delete_part_keys(DS, 0, [pk0])
        cs.flush()
        cs.compact(DS, 0)
        cs.flush()
        live = set()
        for k in s3.list_objects(""):
            if k.endswith(".seg"):
                for e in parse_segment(s3.get_object(k), k):
                    live.add(e[1])
        assert pk0.serialized not in live
        assert pk1.serialized in live
        cs.close()


# ---- split scans -------------------------------------------------------------------


class TestSplitScans:
    def _fill(self, cs, n=32):
        pks = [_pk(i) for i in range(n)]
        for i, pk in enumerate(pks):
            _write(cs, 0, pk, [_chunk(1)], i)
        cs.write_part_keys(DS, 0, [PartKeyRecord(pk, 0, 1) for pk in pks])
        cs.flush()
        return pks

    @pytest.mark.parametrize("n_splits", [4, 3])
    def test_partition_disjoint_and_complete(self, n_splits):
        cs = _mk(bucket_count=8)
        pks = self._fill(cs)
        seen = []
        for s in range(n_splits):
            part = cs.scan_part_keys_split(DS, 0, s, n_splits)
            for r in part:
                assert split_of(r.part_key.serialized, n_splits) == s
            seen.extend(r.part_key for r in part)
        assert sorted(map(str, seen)) == sorted(map(str, pks))
        assert len(seen) == len(set(seen))
        full = {b for b, _ in cs.scan_chunk_rows_by_ingestion_time(
            DS, 0, 0, 2**62)}
        union = set()
        for s in range(n_splits):
            union |= {b for b, _ in cs.scan_chunk_rows_by_ingestion_time_split(
                DS, 0, 0, 2**62, s, n_splits)}
        assert union == full
        cs.close()

    def test_split_of_is_the_references(self):
        from filodb_tpu.core.store.remotestore import split_of as ref_split

        for i in range(50):
            blob = _pk(i).serialized
            for n in (1, 2, 3, 8):
                assert split_of(blob, n) == ref_split(blob, n)

    def test_restrict_to_split_skips_foreign_buckets(self, tmp_path):
        s3 = FakeS3(root=str(tmp_path / "s3"))
        cs = _mk(s3, bucket_count=8)
        self._fill(cs)
        cs.close()
        reader = _mk(FakeS3(root=str(tmp_path / "s3")), bucket_count=8)
        reader.restrict_to_split(0, 4)
        assert reader.scan_part_keys_split(DS, 0, 0, 4)
        for info in reader._states[(DS, 0)].segments.values():
            assert info.bucket % 4 == 0
        reader.close()

    def test_split_view_is_read_only(self, tmp_path):
        s3root = str(tmp_path / "s3")
        cs = _mk(FakeS3(root=s3root), bucket_count=8)
        self._fill(cs)
        cs.close()
        reader = _mk(FakeS3(root=s3root), bucket_count=8)
        reader.restrict_to_split(0, 4)
        pk = _pk(0)
        with pytest.raises(ObjectStoreError):
            _write(reader, 0, pk, [_chunk(9)], 9)
        with pytest.raises(ObjectStoreError):
            reader.write_part_keys(DS, 0, [PartKeyRecord(pk, 0, 1)])
        with pytest.raises(ObjectStoreError):
            reader.delete_part_keys(DS, 0, [pk])
        with pytest.raises(ObjectStoreError):
            reader.write_index_snapshot(DS, 0, b"x")
        with pytest.raises(ObjectStoreError):
            reader.truncate(DS)
        with pytest.raises(ObjectStoreError):
            reader.compact(DS, 0)
        with pytest.raises(ObjectStoreError):
            ObjectStoreMetaStore(reader).write_checkpoint(DS, 0, 0, 1)
        assert reader.scan_part_keys_split(DS, 0, 0, 4)
        reader.close()
        full = _mk(FakeS3(root=s3root), bucket_count=8)
        assert len(full.scan_part_keys(DS, 0)) == 32
        full.close()

    def test_repair_jobs_fan_out_over_splits(self):
        from filodb_tpu_torch.core.store.repair import PartitionKeysCopier

        src, dst = _mk(bucket_count=8), _mk(bucket_count=8)
        pks = self._fill(src)
        PartitionKeysCopier(src, dst, DS, num_shards=1, n_splits=4).run()
        dst.flush()
        assert {str(r.part_key) for r in dst.scan_part_keys(DS, 0)} == \
            {str(pk) for pk in pks}
        src.close()
        dst.close()


class TestConcurrency:
    def test_parallel_writers_one_shard(self):
        cs = _mk()
        pks = [_pk(i) for i in range(8)]

        def w(i):
            for j in range(5):
                _write(cs, 0, pks[i], [_chunk(j + 1)], j)

        threads = [threading.Thread(target=w, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cs.flush()
        for pk in pks:
            assert [c.id for c in _read(cs, 0, pk)] == [1, 2, 3, 4, 5]
        cs.close()


class TestSigV4:
    def test_canonical_query_sorted_and_slash_encoded(self):
        args = {"prefix": "demo/timeseries/shard-0/", "list-type": "2",
                "continuation-token": "a+b/c"}
        q = _canon_query(args)
        assert q == ("continuation-token=a%2Bb%2Fc&list-type=2"
                     "&prefix=demo%2Ftimeseries%2Fshard-0%2F")
        assert q == ref_os._canon_query(args)
        assert _canon_query({}) == "" and _canon_query(None) == ""

    def test_signed_list_uses_canonical_query(self, monkeypatch):
        from filodb_tpu_torch.core.store.objectstore import HttpS3Client

        client = HttpS3Client("http://s3.local", access_key="AK",
                              secret_key="SK")
        seen = []

        class _Resp:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def read(self):
                return (b"<ListBucketResult>"
                        b"<IsTruncated>false</IsTruncated>"
                        b"</ListBucketResult>")

        def fake_urlopen(req, timeout=None):
            seen.append(req)
            return _Resp()

        monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
        client.list_objects("bucket/demo/timeseries/")
        (req,) = seen
        assert req.full_url.endswith(
            "/bucket?list-type=2&prefix=demo%2Ftimeseries%2F")
        assert req.get_header("Authorization", "").startswith(
            "AWS4-HMAC-SHA256")


class TestFactory:
    def test_open_object_store_local_fake(self, tmp_path):
        cs, meta = open_object_store({"endpoint": None}, str(tmp_path))
        assert isinstance(cs, ObjectStoreColumnStore)
        assert isinstance(meta, ObjectStoreMetaStore)
        _write(cs, 0, _pk(0), [_chunk(1)], 1)
        cs.close()
        assert (tmp_path / "objectstore").exists()

    def test_open_object_store_http_endpoint(self, tmp_path):
        from filodb_tpu_torch.core.store.objectstore import HttpS3Client

        cs, meta = open_object_store(
            {"endpoint": "http://127.0.0.1:1", "bucket": "b"},
            str(tmp_path))
        assert isinstance(cs.client, HttpS3Client)
        cs.close()


# ---- byte equality and buckets either package wrote ----------------------------


def _real_chunks(i: int, n_chunks: int = 3, rows: int = 100):
    """Reference chunks of gauge values with their summaries."""
    rng = np.random.default_rng(i)
    out = []
    for c in range(n_chunks):
        t0 = 1_000_000 + c * 10_000 * rows
        ts = np.arange(t0, t0 + rows * 10_000, 10_000, dtype=np.int64)
        vals = np.round(rng.normal(50, 10, rows) * 8) / 8
        if i % 5 == 1:
            vals[3] = np.nan
        out.append(ref_encode_chunk(REF_SCHEMAS["gauge"], ts, [vals]))
    return out


def _ref_key(i: int) -> RefPartKey:
    return RefPartKey.create("gauge", {"_metric_": "heap_usage",
                                       "_ws_": "demo", "_ns_": f"app-{i}",
                                       "instance": f"i-{i}"})


def _equal_writes(rcs, pcs, n_keys=40, compact=False):
    """The same calls on both stores (either may be None): chunks of many
    keys (one call of the port's for a batch of them), part keys, a
    tombstone, checkpoints and an index snapshot."""
    stores = [s for s in (rcs, pcs) if s is not None]
    rmeta = ref_os.ObjectStoreMetaStore(rcs) if rcs is not None else None
    pmeta = ObjectStoreMetaStore(pcs) if pcs is not None else None
    keys = [_ref_key(i) for i in range(n_keys)]
    for lo in range(0, n_keys, 10):
        batch = keys[lo:lo + 10]
        rows = []
        for k in batch:
            chunks = _real_chunks(keys.index(k))
            if rcs is not None:
                rcs.write_chunks(DS, 0, k, chunks, 7)
            rows += [(_pk_blob(k), c.id, c.start_time, c.end_time,
                      c.serialize()) for c in chunks]
        if pcs is not None:
            pcs.write_chunk_rows(DS, 0, rows, 7)
            pcs.write_part_keys(DS, 0, [PartKeyRecord(
                pk_from_blob(_pk_blob(k)), 1_000_000, 4_000_000)
                for k in batch])
            pmeta.write_checkpoint(DS, 0, lo // 10, lo)
        if rcs is not None:
            rcs.write_part_keys(DS, 0, [RefPKR(k, 1_000_000, 4_000_000)
                                        for k in batch])
            rmeta.write_checkpoint(DS, 0, lo // 10, lo)
    if rcs is not None:
        rcs.delete_part_keys(DS, 0, [keys[3]])
    if pcs is not None:
        pcs.delete_part_keys(DS, 0, [pk_from_blob(_pk_blob(keys[3]))])
    for cs in stores:
        cs.write_index_snapshot(DS, 0, b"FIDX4-bytes")
        cs.flush()
    if compact:
        for cs in stores:
            cs.compact(DS, 0)
            cs.flush()
    return keys


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("compact", [False, True])
def test_equal_writes_give_byte_equal_objects(tmp_path, compact):
    rcs = ref_os.ObjectStoreColumnStore(RefS3(root=str(tmp_path / "r")),
                                        segment_target_bytes=16_384,
                                        auto_compact=False)
    pcs = ObjectStoreColumnStore(FakeS3(root=str(tmp_path / "p")),
                                 segment_target_bytes=16_384,
                                 auto_compact=False)
    _equal_writes(rcs, pcs, compact=compact)
    rcs.close()
    pcs.close()
    want, got = _tree(str(tmp_path / "r")), _tree(str(tmp_path / "p"))
    assert sorted(got) == sorted(want)
    kinds = {os.path.basename(k).split("-")[0].split(".")[0] for k in want}
    assert {"seg", "manifest", "checkpoints", "index"} <= kinds
    assert any(k.endswith(".pyr") for k in want)
    if compact:
        assert any("bkt-" in k for k in want)
    for k in want:
        assert got[k] == want[k], k


def test_the_port_reads_a_reference_bucket(tmp_path):
    rcs = ref_os.ObjectStoreColumnStore(RefS3(root=str(tmp_path / "b")),
                                        segment_target_bytes=16_384)
    keys = _equal_writes(rcs, None, compact=True)
    rcs.close()
    pcs = ObjectStoreColumnStore(FakeS3(root=str(tmp_path / "b")))
    ref2 = ref_os.ObjectStoreColumnStore(RefS3(root=str(tmp_path / "b")))
    assert sorted(str(r.part_key) for r in pcs.scan_part_keys(DS, 0)) \
        == sorted(str(r.part_key) for r in ref2.scan_part_keys(DS, 0))
    for k in keys:
        want = [c.serialize() for c in ref2.read_chunks(DS, 0, k, 0, 2**62)]
        got = [d for _, d in pcs.read_chunk_rows(DS, 0, [_pk_blob(k)], 0,
                                                 2**62)]
        assert got == want
    assert ObjectStoreMetaStore(pcs).read_checkpoints(DS, 0) \
        == ref_os.ObjectStoreMetaStore(ref2).read_checkpoints(DS, 0)
    assert pcs.read_index_snapshot(DS, 0) == b"FIDX4-bytes"
    _same_pyramids(pcs, ref2)
    pcs.close()
    ref2.close()


def test_the_reference_reads_a_port_bucket(tmp_path):
    pcs = ObjectStoreColumnStore(FakeS3(root=str(tmp_path / "b")),
                                 segment_target_bytes=16_384)
    keys = _equal_writes(None, pcs, compact=True)
    pcs.close()
    rcs = ref_os.ObjectStoreColumnStore(RefS3(root=str(tmp_path / "b")))
    pcs2 = ObjectStoreColumnStore(FakeS3(root=str(tmp_path / "b")))
    for k in keys:
        got = [c.serialize() for c in rcs.read_chunks(DS, 0, k, 0, 2**62)]
        want = [d for _, d in pcs2.read_chunk_rows(DS, 0, [_pk_blob(k)], 0,
                                                   2**62)]
        assert got == want
        if k != keys[3]:
            assert got == [c.serialize() for c in
                           _real_chunks(keys.index(k))]
    assert len(rcs.scan_part_keys(DS, 0)) == len(keys) - 1
    assert ref_os.ObjectStoreMetaStore(rcs).read_checkpoints(DS, 0) \
        == {0: 0, 1: 10, 2: 20, 3: 30}
    assert rcs.read_index_snapshot(DS, 0) == b"FIDX4-bytes"
    _same_pyramids(pcs2, rcs)
    rcs.close()
    pcs2.close()


def _same_pyramids(pcs, rcs):
    pseqs, pbk = pcs.pyramid_index(DS, 0)
    rseqs, rbk = rcs.pyramid_index(DS, 0)
    assert pseqs == rseqs and pbk == rbk and (pseqs or pbk)
    for seq in pseqs:
        a = pcs.read_segment_pyramid(DS, 0, seq)
        b = rcs.read_segment_pyramid(DS, 0, seq)
        assert a["entries"].keys() == b["entries"].keys()
        assert a["hll"].serialize() == b["hll"].serialize()
    for bkt in pbk:
        a = pcs.read_bucket_pyramid(DS, 0, bkt)
        b = rcs.read_bucket_pyramid(DS, 0, bkt)
        assert a["covers"] == b["covers"]
        assert a["topk"].serialize() == b["topk"].serialize()


def test_the_port_reads_reference_chunk_summaries_bitwise(tmp_path):
    """The port's pyramid of a reference segment's rows equals the one the
    reference wrote, byte for byte."""
    rcs = ref_os.ObjectStoreColumnStore(RefS3(root=str(tmp_path / "b")),
                                        segment_target_bytes=1 << 30)
    rows = []
    for i in range(12):
        k = _ref_key(i)
        chunks = _real_chunks(i)
        rcs.write_chunks(DS, 0, k, chunks, 1)
        rows += [(_pk_blob(k), c.id, c.serialize()) for c in chunks]
    rcs.flush()
    written = {rcs.client.get_object(k) for k in rcs.client.list_objects("")
               if k.endswith(".pyr")}
    by_bucket = {}
    for r in rows:
        by_bucket.setdefault(split_of(r[0], 8), []).append(r)
    built = {pyrmod.build_segment_pyramid(v) for v in by_bucket.values()}
    assert written and built == written
    rcs.close()


# ---- the downsampler job over the object store ---------------------------------


def test_catch_up_on_object_store(tmp_path):
    """Checkpoints and ds chunks survive a restart with new store instances,
    and the job fans out over the store's split scans; its ds chunks are
    the reference job's over the same bucket contents."""
    from filodb_tpu.core.downsample import DownsamplerJob as RefJob
    from filodb_tpu_torch.core.downsample import (
        DownsamplerJob,
        ds_dataset_name,
    )
    from test_torch_pyramids import _containers, _gauges, _values

    res = 300_000
    root = str(tmp_path / "s3")
    cs = _mk(FakeS3(root=root))
    meta = ObjectStoreMetaStore(cs)
    ms = MemStore(1, spread=0, column_store=cs, meta_store=meta,
                  config=StoreConfig(max_chunk_size=120, groups_per_shard=2))
    keys = _gauges()[:2]
    vals = _values(False, True)
    conts = _containers(keys, vals, 0, 240)

    def ingest(lo, hi, itime):
        for off, c in enumerate(conts[lo:hi], lo):
            ms.shards[0].ingest(SomeData(BytesContainer(c.serialize()), off))
        ms.shards[0].flush_all(itime)

    ingest(0, 120, 100)
    DownsamplerJob(cs, DS, 1, resolutions_ms=(res,),
                   meta_store=meta).catch_up(101)
    ingest(120, 240, 200)
    cs.close()  # a crash: the uploads drain, the process state goes
    cs2 = _mk(FakeS3(root=root))
    meta2 = ObjectStoreMetaStore(cs2)
    job = DownsamplerJob(cs2, DS, 1, resolutions_ms=(res,),
                         meta_store=meta2, n_splits=4)
    assert job.last_checkpoint(0) == 101
    s = job.catch_up(300)
    assert s["scanned_from"][0] == 101 and s["partitions"] == 2
    cs2.flush()
    ds_name = ds_dataset_name(DS, res)
    rows = cs2.scan_chunk_rows_by_ingestion_time(ds_name, 0, 0, 2**62)
    assert len({b for b, _ in rows}) == 2
    all_ts = np.concatenate([Chunk.deserialize(d).decode_column(0)
                             for _, d in rows])
    assert all_ts.min() < (1_600_000_000 + 1200) * 1000 <= all_ts.max()
    cs2.close()
    # the reference's job, run the same two times over the same raw bucket,
    # writes the same ds chunks
    rroot = str(tmp_path / "r")
    import shutil

    shutil.copytree(root, rroot)
    for f in _tree(rroot):
        if "_ds_" in f or "__dsckpt" in f:
            os.remove(os.path.join(rroot, f))
    rcs = ref_os.ObjectStoreColumnStore(RefS3(root=rroot))
    rmeta = ref_os.ObjectStoreMetaStore(rcs)
    RefJob(rcs, DS, 1, resolutions_ms=(res,), meta_store=rmeta).catch_up(101)
    RefJob(rcs, DS, 1, resolutions_ms=(res,), meta_store=rmeta,
           n_splits=4).catch_up(300)
    rcs.flush()
    cs3 = _mk(FakeS3(root=root))
    want = {(_pk_blob(pk), c.id): c.serialize() for pk, chs in
            rcs.scan_chunks_by_ingestion_time(ds_name, 0, 0, 2**62)
            for c in chs}
    got = {(b, int(np.frombuffer(d[:8], np.int64)[0])): d for b, d in
           cs3.scan_chunk_rows_by_ingestion_time(ds_name, 0, 0, 2**62)}
    assert got.keys() == want.keys() and got
    for k in want:
        a, b = Chunk.deserialize(got[k]), RefChunk.deserialize(want[k])
        for i in range(len(b.vectors)):
            np.testing.assert_array_equal(
                np.asarray(a.decode_column(i), np.float64).view(np.int64),
                np.asarray(b.decode_column(i), np.float64).view(np.int64))
    rcs.close()
    cs3.close()


def test_a_job_over_a_store_without_split_scans_takes_one_split(tmp_path):
    """The local store had no split scans, and a job over it raised for
    ``n_splits`` > 1; the base class's split scans filter the full scan
    now (ROADMAP A6.5), so four splits run there and write the ds chunks
    one split writes."""
    from filodb_tpu_torch.core.downsample import (
        DownsamplerJob,
        ds_dataset_name,
    )
    from filodb_tpu_torch.core.store.localstore import (
        LocalDiskColumnStore,
        LocalDiskMetaStore,
    )

    res = 300_000
    labels = [{"_metric_": "heap_usage", "_ws_": "demo", "_ns_": f"app-{i}"}
              for i in range(12)]
    ts = np.tile(1_600_000_000_000 + np.arange(200) * 10_000, (12, 1))
    vals = np.arange(12 * 200, dtype=np.float64).reshape(12, 200)
    out = {}
    for n in (1, 4):
        root = str(tmp_path / f"s{n}")
        ms = MemStore(1, 0, max_chunk_size=50,
                      column_store=LocalDiskColumnStore(root),
                      meta_store=LocalDiskMetaStore(root))
        ms.ingest_series(labels, ts, vals, schema="gauge")
        ms.flush_all(100)
        stats = DownsamplerJob(ms.column_store, DS, 1, resolutions_ms=(res,),
                               n_splits=n).run(0, 200)
        assert stats["partitions"] == 12
        out[n] = {(bytes(b), bytes(d)) for b, d in
                  ms.column_store.scan_chunk_rows_by_ingestion_time(
                      ds_dataset_name(DS, res), 0, 0, 2**62)}
        ms.close()
    assert out[1] == out[4] and len({b for b, _ in out[1]}) == 12


# ---- a cold tier under faults ----------------------------------------------------


class TestChaos:
    Q = ("max_over_time(heap_usage[10m])", 1_600_000_000 + 900, 300,
         1_600_000_000 + 5400)

    def test_objectstore_latency_slow_but_correct(self, tmp_path):
        from test_torch_pyramids import Env, _same_answer

        env = Env(tmp_path)
        env.read_pcs.client.latency_s = 0.01
        env.read_rcs.client.latency_s = 0.01
        _same_answer(env, *self.Q)

    def test_objectstore_fault_raises_never_wrong_data(self, tmp_path):
        """A cold tier lost to transport faults: since partial
        scatter-gather came, the port answers as the reference does, the
        other tiers' steps as a partial result whose warnings name the lost
        shards (until then it raised; ROADMAP §C); once the faults clear the
        same query answers as the reference, whole."""
        from filodb_tpu.testing.fake_s3 import (
            S3TransientError as RefS3TransientError,
        )
        from test_torch_pyramids import TOL, Env, _same_answer, _sorted

        env = Env(tmp_path)
        env.read_pcs.client.inject("get", times=100,
                                   exc=S3TransientError("injected outage"))
        env.read_rcs.client.inject("get", times=100,
                                   exc=RefS3TransientError("injected outage"))
        got = env.port_run(*self.Q)
        want, _ = env.ref_run(*self.Q)
        assert got.partial and want.partial
        lost = {w.split("(shards ")[1].split(")")[0] for w in got.warnings}
        assert lost == {w.split("(shards ")[1].split(")")[0]
                        for w in want.warnings}
        wk, wv = _sorted(want.result)
        gk, gv = _sorted(got.result.materialize())
        assert gk == wk
        np.testing.assert_allclose(gv, wv, **TOL)
        env.read_pcs.client.clear_faults()
        env.read_rcs.client.clear_faults()
        _same_answer(env, *self.Q)

    def test_corrupt_segment_errors_never_wrong_data(self, tmp_path):
        from test_torch_pyramids import Env

        env = Env(tmp_path)
        s3 = env.read_pcs.client
        for key in s3.list_objects(""):
            if key.endswith(".seg"):
                s3.corrupt(key, offset=len(s3.get_object(key)) // 2)
        with pytest.raises(CorruptSegmentError):
            env.port_run(*self.Q)


# ---- a node over the object store --------------------------------------------------


def test_a_node_over_the_object_store_answers_as_one_over_local_disk(
        tmp_path):
    """Nodes with ``store.backend`` ``object`` and ``local`` take the same
    containers through their logs, flush, and restart; the object-store
    node recovers from its bucket and both answer alike, before and after
    the restart."""
    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.core.record import RecordContainer
    from filodb_tpu_torch.coordinator.ingestion import route_container
    from filodb_tpu_torch.standalone import FiloServer
    from filodb_tpu_torch.testing.from_jax import boot
    from test_torch_pyramids import START, _containers, _gauges, _values

    base = {"node_name": "node-0",
            "datasets": {DS: {"num_shards": 2, "spread": 0,
                              "engine": "exec",
                              "store": {"max_chunk_size": 120,
                                        "groups_per_shard": 2,
                                        "flush_interval_ms": 3_600_000,
                                        "retention_ms": 2**60}}}}
    confs = {"object": {**base, "store": {"backend": "object"}},
             "local": base}
    conts = _containers(_gauges(), _values(False, True), 0, 300)
    q = ("sum(max_over_time(heap_usage[10m])) by (host)", START + 600, 300,
         START + 2900)

    def answer(srv):
        r = srv.services[DS].query_range(*q)
        m = r.result.materialize()
        keys = [str(k) for k in m.keys]
        order = np.argsort(keys)
        return [keys[i] for i in order], np.asarray(m.values)[order]

    def wait_caught_up(srv):
        deadline = time.monotonic() + 60
        for w in list(srv.node._workers.values()):
            while w.offset < w.log.latest_offset \
                    and time.monotonic() < deadline:
                time.sleep(0.05)

    out = {}
    for name, conf in confs.items():
        root = str(tmp_path / name)
        srv = boot(FiloServer, ServerConfig, conf, root, device="cpu")
        try:
            for cont in conts:
                port_cont = RecordContainer.deserialize(cont.serialize())
                for shard, sub in route_container(port_cont, 2, 0).items():
                    srv.logs[(DS, shard)].append(sub)
            wait_caught_up(srv)
            for s in range(2):
                srv.node.memstores[DS].shards[s].flush_all(1_000)
            before = answer(srv)
        finally:
            srv.shutdown()
        if name == "object":
            assert any(f.endswith(".seg") for f in _tree(
                os.path.join(root, "objectstore")))
        srv = boot(FiloServer, ServerConfig, conf, root, device="cpu")
        try:
            wait_caught_up(srv)
            after = answer(srv)
            if name == "object":
                assert isinstance(srv.column_store, ObjectStoreColumnStore)
                assert sum(len(srv.column_store.scan_part_keys(DS, s))
                           for s in range(2)) == 6
        finally:
            srv.shutdown()
        assert before[0] == after[0] and before[0]
        np.testing.assert_array_equal(before[1], after[1])
        out[name] = after
    assert out["object"][0] == out["local"][0]
    np.testing.assert_array_equal(out["object"][1], out["local"][1])


def test_the_scheduler_cuts_the_log_only_below_landed_checkpoints(tmp_path):
    """A scheduler tick over the object store flushes a group while its
    uploads stall: the checkpoint is read back at once, but the log is not
    cut below it until the checkpoint has landed in the bucket."""
    from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
    from filodb_tpu_torch.core.store.config import IngestionConfig
    from filodb_tpu_torch.kafka.log import SegmentedFileLog
    from test_torch_pyramids import _containers

    keys = [_ref_key(i) for i in range(8)]
    vals = np.arange(8 * 30, dtype=np.float64).reshape(8, 30)
    log = SegmentedFileLog(str(tmp_path / "wal"), segment_entries=8)
    for c in _containers(keys, vals, 0, 30):
        log.append(BytesContainer(c.serialize()))
    s3 = FakeS3(root=str(tmp_path / "s3"))
    gate = threading.Event()
    real_put = s3.put_object

    def stalled_put(key, data):
        gate.wait(60)
        real_put(key, data)

    s3.put_object = stalled_put
    cs = _mk(s3)
    node = Node("n", cs, ObjectStoreMetaStore(cs), flush_tick_s=3600)
    cluster = FilodbCluster()
    cluster.join(node)
    cfg = StoreConfig(max_chunk_size=10, groups_per_shard=1,
                      index_snapshot_interval_ms=0, retention_ms=2**60)
    cluster.setup_dataset(IngestionConfig(DS, num_shards=1, store=cfg),
                          {0: log}, 0)
    try:
        assert cluster.wait_active(DS, 10)
        sched = node._flusher
        sched._tick((DS, 0))
        assert node.meta_store.read_checkpoints(DS, 0) == {0: 29}
        assert node.meta_store.durable_checkpoints(DS, 0) == {}
        assert log.earliest_offset == 0 and (DS, 0) not in sched.truncated
        gate.set()
        cs.flush()
        assert node.meta_store.durable_checkpoints(DS, 0) == {0: 29}
        sched._tick((DS, 0))
        assert sched.truncated[(DS, 0)][0] == 30
        assert log.earliest_offset > 0
    finally:
        gate.set()
        cluster.stop()
        log.close()
        cs.close()


def test_a_node_registers_the_objectstore_metric_families():
    """The ``filodb_objectstore_*`` and ``filodb_pyramid_*`` families are
    on ``/metrics`` whatever the backend, as the reference's node
    registers them at import."""
    from filodb_tpu_torch import standalone  # noqa: F401
    from filodb_tpu_torch.utils.metrics import render_prometheus

    text = render_prometheus()
    for fam in ("filodb_objectstore_puts", "filodb_objectstore_gets",
                "filodb_objectstore_bytes_up", "filodb_objectstore_bytes_down",
                "filodb_objectstore_payload_bytes_down",
                "filodb_objectstore_retries", "filodb_objectstore_corrupt",
                "filodb_objectstore_queue_depth",
                "filodb_objectstore_oldest_task_age_seconds",
                "filodb_pyramid_objects_written", "filodb_pyramid_fallback"):
        assert fam in text, fam
