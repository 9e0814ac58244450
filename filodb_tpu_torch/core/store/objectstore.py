"""The object-store (S3-compatible) durable tier: segment objects and a
manifest.

Port of ``filodb_tpu/core/store/objectstore.py``, over the port's row API
(``core/store/api.py``: chunks travel as (part-key blob, chunk id, start,
end, serialized chunk) rows). The objects are the reference's byte for
byte, so either package reads a bucket the other wrote:

    {prefix}/{dataset}/shard-{N}/b{BB}/seg-{SEQ:08d}.seg   data segments
    {prefix}/{dataset}/shard-{N}/b{BB}/seg-{SEQ:08d}.pyr   segment pyramids
    {prefix}/{dataset}/shard-{N}/b{BB}/bkt-{SEQ:08d}.pyr   bucket pyramids
    {prefix}/{dataset}/shard-{N}/manifest.json             live segments
    {prefix}/{dataset}/shard-{N}/checkpoints.json          checkpoints
    {prefix}/{dataset}/shard-{N}/index.snap                index snapshot

``BB`` is the part key's bucket, ``split_of(blob, bucket_count)``: bucket
``b`` serves split ``b % n_splits`` wherever ``n_splits`` divides
``bucket_count``, so a split scan is a key-prefix scan, and
``restrict_to_split`` opens a view that never reads the other buckets.

Writes go behind, in checkpoint order. ``write_chunk_rows`` and
``write_part_keys`` append to an open segment a bucket in memory (reads
see them at once); a segment seals at ``segment_target_bytes`` or at a
checkpoint and joins one bounded FIFO queue shared with the meta store.
``write_checkpoint`` seals the shard's open segments and queues the
checkpoint behind them, so a checkpoint never becomes visible before the
data it covers: a crash mid-upload leaves it missing and the WAL replays
the gap. The node's flush scheduler cuts a shard's log only below its
checkpoints as uploaded (``durable_checkpoints``). The uploader retries
transient faults under ``RetryPolicy`` forever (a segment key is never
reused, so puts are idempotent) and uploads large segments in parts. A fatal failure (an S3 403, say)
poisons the shard: every task queued behind it is parked, and the next
``flush()`` or ``close()`` raises :class:`ObjectStoreError`.

``write_chunk_rows`` takes the rows of many part keys in one call; it
writes them as the reference's ``write_chunks`` would, called once a
part key in the order the keys first appear, so equal writes give equal
objects.

Every segment carries a CRC32C (Castagnoli) footer, checked on full
reads (recovery, compaction), and every chunk entry its own, checked on
ranged reads: a flipped byte raises :class:`CorruptSegmentError` and
counts in ``filodb_objectstore_corrupt``, never a wrong answer. CRC32C
runs in the host C++ library (``csrc/hostcodec.cpp``, ``fh_crc32c``);
the library failing to build raises.

A live migration's manifest is the object ``migration.json`` under the
shard's prefix, written synchronously (the phase's resume barrier).
``refresh_shard`` drops a shard's cached state that holds nothing
unuploaded, so a migration's destination re-reads the manifest the
source just uploaded; ``sync_shard`` is a follower's tail over the
bucket: the manifest again, and a GET for each segment it has not seen
(never for a shard this store writes).
"""

from __future__ import annotations

import collections
import ctypes
import io
import json
import queue
import struct
import threading
import time
import weakref

from filodb_tpu_torch import _build
from filodb_tpu_torch.core.store import pyramid
from filodb_tpu_torch.core.store.api import (
    ColumnStore,
    MetaStore,
    PartKeyRecord,
    pk_from_blob,
    split_of,
)
from filodb_tpu_torch.memory.chunk import Chunk, ensure_summary
from filodb_tpu_torch.utils.metrics import Counter, Gauge, GaugeFn
from filodb_tpu_torch.utils.resilience import FaultInjector, RetryPolicy
from filodb_tpu_torch.utils.tracing import span, traced_operation


_CRC_FN: list = []


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` continuing from ``crc`` (host C++). The call
    keeps the interpreter lock: it takes microseconds, and a thread that
    gives the lock up waits for it again behind the uploader's thread."""
    if not _CRC_FN:
        lib = ctypes.PyDLL(_build.host_library("hostcodec")._name)
        fn = lib.fh_crc32c
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int64
        _CRC_FN.append(fn)
    if not isinstance(data, bytes):
        data = bytes(data)
    return _CRC_FN[0](data, len(data), crc) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# errors and metrics

class CorruptSegmentError(Exception):
    """A segment or chunk entry failed its CRC32C check: the store refuses
    the bytes."""


class ObjectStoreError(Exception):
    """A non-transient object-store failure, surfaced to the caller."""


PUTS = Counter("filodb_objectstore_puts")
GETS = Counter("filodb_objectstore_gets")
BYTES_UP = Counter("filodb_objectstore_bytes_up")
BYTES_DOWN = Counter("filodb_objectstore_bytes_down")
# the chunk-payload part of BYTES_DOWN (ranged GETs only): the pyramid
# lane's zero-payload claim reads this counter
PAYLOAD_BYTES_DOWN = Counter(
    "filodb_objectstore_payload_bytes_down",
    help="bytes of chunk payload fetched via ranged GETs")
RETRIES = Counter("filodb_objectstore_retries")
COMPACTIONS = Counter("filodb_objectstore_compactions")
CORRUPT = Counter("filodb_objectstore_corrupt")
QUEUE_DEPTH = Gauge("filodb_objectstore_queue_depth")

_INSTANCES: "weakref.WeakSet" = weakref.WeakSet()


def _oldest_task_age() -> float:
    """Age of the oldest queued or in-flight upload across live stores (a
    wedged uploader shows as a ramp, where its depth stays flat)."""
    oldest = None
    for store in list(_INSTANCES):
        try:
            t0 = store._inflight_ts[0]
        except IndexError:
            continue
        if oldest is None or t0 < oldest:
            oldest = t0
    return 0.0 if oldest is None else max(0.0, time.time() - oldest)


OLDEST_TASK_AGE = GaugeFn(
    "filodb_objectstore_oldest_task_age_seconds", _oldest_task_age,
    help="age of the oldest queued-or-in-flight write-behind task")

# ---------------------------------------------------------------------------
# the segment format

# FSG2 chunk payloads carry the summary section; FSG1 segments (written
# before summaries) stay readable, and compaction backfills them
_MAGIC = b"FSG2"
_MAGIC_V1 = b"FSG1"
_FOOTER = struct.Struct("<BII")       # 0xFE, entry count, crc32c(body)
_FOOTER_MARK = 0xFE
_E_CHUNK, _E_PARTKEY, _E_DELETE = 1, 2, 3
_ENTRY = struct.Struct("<BI")          # type, part-key length
_CHUNK_HDR = struct.Struct("<qqqqqI")  # id, start, end, itime, upd, dlen
_PK_HDR = struct.Struct("<qqq")        # start, end, upd
_CRC = struct.Struct("<I")


class _ChunkRef:
    """Where one stored chunk's payload lives."""
    __slots__ = ("chunk_id", "start_time", "end_time", "ingestion_time",
                 "upd", "seq", "offset", "length", "crc")

    def __init__(self, chunk_id, start_time, end_time, ingestion_time,
                 upd, seq, offset, length, crc):
        self.chunk_id = chunk_id
        self.start_time = start_time
        self.end_time = end_time
        self.ingestion_time = ingestion_time
        self.upd = upd
        self.seq = seq          # segment sequence number
        self.offset = offset    # byte offset of the payload
        self.length = length
        self.crc = crc          # crc32c of the payload


class _OpenSegment:
    """An append-only segment of one bucket, in memory until sealed."""

    def __init__(self, seq: int, bucket: int):
        self.seq = seq
        self.bucket = bucket
        self.buf = io.BytesIO()
        self.buf.write(_MAGIC)
        self.entries = 0
        self.max_upd = 0
        # (blob, chunk id, serialized chunk) for the pyramid at seal
        self.pyr_rows: list[tuple[bytes, int, bytes]] = []

    def size(self) -> int:
        return self.buf.tell()

    def add_chunk(self, pk_blob: bytes, cid: int, start: int, end: int,
                  data: bytes, ingestion_time: int,
                  upd: int) -> tuple[int, int, int]:
        """Append a chunk entry → (payload offset, length, crc)."""
        crc = crc32c(data)
        b = self.buf
        b.write(_ENTRY.pack(_E_CHUNK, len(pk_blob)))
        b.write(pk_blob)
        b.write(_CHUNK_HDR.pack(cid, start, end, ingestion_time, upd,
                                len(data)))
        off = b.tell()
        b.write(data)
        b.write(_CRC.pack(crc))
        self.entries += 1
        self.max_upd = max(self.max_upd, upd)
        self.pyr_rows.append((pk_blob, cid, data))
        return off, len(data), crc

    def add_part_key(self, pk_blob: bytes, start: int, end: int,
                     upd: int) -> None:
        b = self.buf
        b.write(_ENTRY.pack(_E_PARTKEY, len(pk_blob)))
        b.write(pk_blob)
        b.write(_PK_HDR.pack(start, end, upd))
        self.entries += 1
        self.max_upd = max(self.max_upd, upd)

    def add_delete(self, pk_blob: bytes) -> None:
        self.buf.write(_ENTRY.pack(_E_DELETE, len(pk_blob)))
        self.buf.write(pk_blob)
        self.entries += 1

    def finish(self) -> bytes:
        body = self.buf.getvalue()
        return body + _FOOTER.pack(_FOOTER_MARK, self.entries, crc32c(body))


def parse_segment(data: bytes, key: str = "?") -> list:
    """Check the footer's CRC and list the entries: ``("chunk", blob, id,
    start, end, itime, upd, payload offset, length, crc, payload)``,
    ``("partkey", blob, start, end, upd)``, ``("delete", blob)``. Raises
    :class:`CorruptSegmentError` on any mismatch."""
    if len(data) < len(_MAGIC) + _FOOTER.size \
            or data[:4] not in (_MAGIC, _MAGIC_V1):
        CORRUPT.inc()
        raise CorruptSegmentError(f"{key}: bad magic/size")
    mark, count, crc = _FOOTER.unpack_from(data, len(data) - _FOOTER.size)
    body = data[:len(data) - _FOOTER.size]
    if mark != _FOOTER_MARK or crc32c(body) != crc:
        CORRUPT.inc()
        raise CorruptSegmentError(f"{key}: footer CRC32C mismatch")
    pos, seen = 4, 0
    out = []
    try:
        while pos < len(body):
            etype, pk_len = _ENTRY.unpack_from(body, pos)
            pos += _ENTRY.size
            pk_blob = bytes(body[pos:pos + pk_len])
            pos += pk_len
            if etype == _E_CHUNK:
                cid, st, et, itime, upd, dlen = _CHUNK_HDR.unpack_from(
                    body, pos)
                pos += _CHUNK_HDR.size
                off = pos
                payload = bytes(body[pos:pos + dlen])
                pos += dlen
                (ecrc,) = _CRC.unpack_from(body, pos)
                pos += 4
                out.append(("chunk", pk_blob, cid, st, et, itime, upd,
                            off, dlen, ecrc, payload))
            elif etype == _E_PARTKEY:
                st, et, upd = _PK_HDR.unpack_from(body, pos)
                pos += _PK_HDR.size
                out.append(("partkey", pk_blob, st, et, upd))
            elif etype == _E_DELETE:
                out.append(("delete", pk_blob))
            else:
                raise CorruptSegmentError(f"{key}: unknown entry {etype}")
            seen += 1
    except (struct.error, CorruptSegmentError) as e:
        CORRUPT.inc()
        raise CorruptSegmentError(f"{key}: truncated entry stream: {e}") \
            from None
    if seen != count:
        CORRUPT.inc()
        raise CorruptSegmentError(f"{key}: entry count {seen} != {count}")
    return out


class _SegmentInfo:
    __slots__ = ("seq", "bucket", "key", "size", "crc", "entries", "max_upd",
                 "uploaded")

    def __init__(self, seq, bucket, key, size, crc, entries, max_upd,
                 uploaded):
        self.seq = seq
        self.bucket = bucket
        self.key = key
        self.size = size
        self.crc = crc
        self.entries = entries
        self.max_upd = max_upd
        self.uploaded = uploaded

    @staticmethod
    def of(doc: dict) -> "_SegmentInfo":
        return _SegmentInfo(int(doc["seq"]), int(doc["bucket"]), doc["key"],
                            int(doc["size"]), int(doc["crc"]),
                            int(doc["entries"]), int(doc["max_upd"]), True)


class _ShardState:
    def __init__(self):
        self.parts: dict[bytes, list] = {}   # blob -> [start, end, upd, bkt]
        self.chunks: dict[bytes, dict[int, _ChunkRef]] = {}
        self.upd = 0
        self.next_seq = 1
        self.segments: dict[int, _SegmentInfo] = {}
        self.pending: dict[int, bytes] = {}       # seq -> sealed bytes
        self.open: dict[int, _OpenSegment] = {}   # bucket -> open segment
        self.checkpoints: dict[int, int] = {}
        self.loaded_checkpoints: dict[int, int] = {}
        # segment seqs with an uploaded pyramid beside them, and a bucket's
        # {"bucket", "seq", "key", "covers"}: in the manifest only once
        # their object is durable, so a reader that races an upload falls
        # back to the chunks
        self.seg_pyramids: set[int] = set()
        self.bucket_pyramids: dict[int, dict] = {}


_STOP = object()


class ObjectStoreColumnStore(ColumnStore):
    """A column store over immutable segment objects.

    ``client`` is anything with the :class:`~filodb_tpu_torch.testing.
    fake_s3.FakeS3` surface (put_object, get_object, list_objects,
    delete_object, optionally multipart)."""

    def __init__(self, client, bucket: str = "filodb", prefix: str = "",
                 segment_target_bytes: int = 1 << 20,
                 bucket_count: int = 8,
                 upload_queue_depth: int = 64,
                 compact_min_segments: int = 6,
                 multipart_threshold: int = 8 << 20,
                 auto_compact: bool = True,
                 retry_policy: RetryPolicy | None = None,
                 read_retry_policy: RetryPolicy | None = None):
        self.client = client
        self.bucket = bucket
        self.prefix = (prefix.strip("/") + "/") if prefix.strip("/") else ""
        self.segment_target_bytes = segment_target_bytes
        self.bucket_count = bucket_count
        self.compact_min_segments = compact_min_segments
        self.multipart_threshold = multipart_threshold
        self.auto_compact = auto_compact
        self.split_filter: tuple[int, int] | None = None
        # an upload never gives up on a transient fault: the policy paces
        # one round, ``_uploader_put`` loops rounds
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=5, base_backoff_s=0.05, max_backoff_s=2.0)
        self.read_retry_policy = read_retry_policy or RetryPolicy(
            max_attempts=3, base_backoff_s=0.02, max_backoff_s=0.5)
        self._lock = threading.RLock()
        self._states: dict[tuple[str, int], _ShardState] = {}
        self._queue: queue.Queue = queue.Queue(maxsize=upload_queue_depth)
        # tasks staged under _lock (their order fixed there), moved onto
        # the bounded queue outside it: the uploader takes _lock to mark a
        # task done, so blocking on a full queue under it would deadlock
        self._staged: collections.deque = collections.deque()
        self._stage_lock = threading.Lock()
        self._closed = False
        self._upload_errors: list[str] = []
        # shards whose upload failed fatally: what queued behind it parks
        self._failed: set[tuple[str, int]] = set()
        # enqueue times of queued and in-flight tasks, in queue order
        self._inflight_ts: collections.deque = collections.deque()
        # each shard's checkpoints as last uploaded (``durable_checkpoints``)
        self._durable: dict[tuple[str, int], dict[int, int]] = {}
        _INSTANCES.add(self)
        self._uploader = threading.Thread(target=self._upload_loop,
                                          name="objstore-uploader",
                                          daemon=True)
        self._uploader.start()

    # ------------------------------------------------------------ keys
    def _shard_prefix(self, dataset: str, shard: int) -> str:
        return f"{self.bucket}/{self.prefix}{dataset}/shard-{shard}/"

    def _seg_key(self, dataset: str, shard: int, bucket: int,
                 seq: int) -> str:
        return (self._shard_prefix(dataset, shard)
                + f"b{bucket:02d}/seg-{seq:08d}.seg")

    def _bucket_of(self, pk_blob: bytes) -> int:
        return split_of(pk_blob, self.bucket_count)

    def _bucket_in_split(self, bkt: int) -> bool:
        if self.split_filter is None:
            return True
        s, n = self.split_filter
        # a split count that does not divide the buckets loads them all
        return bkt % n == s if self.bucket_count % n == 0 else True

    def restrict_to_split(self, split: int, n_splits: int
                          ) -> "ObjectStoreColumnStore":
        """Make this fresh store a view of one split, before anything is
        loaded: segments of other buckets are never read. The view is
        read-only (a write would republish the manifest from the filtered
        segments and drop the others)."""
        with self._lock:
            if self._states:
                raise ObjectStoreError(
                    "restrict_to_split must run before first access")
            self.split_filter = (split, n_splits)
        return self

    def _require_writable(self, op: str) -> None:
        if self.split_filter is not None:
            raise ObjectStoreError(
                f"{op}: this store is a read-only split view — a write "
                "would republish the shard manifest from the filtered "
                "segment set and drop every foreign-bucket segment")

    # ------------------------------------------------------------ client io
    def _transient(self) -> tuple:
        return (ConnectionError, TimeoutError, OSError)

    def _put_raw(self, key: str, data: bytes) -> None:
        FaultInjector.fire("objectstore.put", key=key)
        if len(data) >= self.multipart_threshold and hasattr(
                self.client, "create_multipart"):
            upload_id = self.client.create_multipart(key)
            try:
                part, n = self.multipart_threshold, 1
                for off in range(0, len(data), part):
                    self.client.upload_part(key, upload_id, n,
                                            data[off:off + part])
                    n += 1
                self.client.complete_multipart(key, upload_id)
            except BaseException:
                try:
                    self.client.abort_multipart(key, upload_id)
                except Exception:
                    pass
                raise
        else:
            self.client.put_object(key, data)
        PUTS.inc()
        BYTES_UP.inc(len(data))

    def _get_raw(self, key: str, start=None, length=None) -> bytes:
        data = self.client.get_object(key, start, length)
        GETS.inc()
        BYTES_DOWN.inc(len(data))
        return data

    def _get(self, key: str, start=None, length=None) -> bytes:
        """A GET with bounded retries on transient faults."""
        return self.read_retry_policy.call(
            lambda: self._get_raw(key, start, length),
            retry_on=self._transient(),
            on_retry=lambda *a, **k: RETRIES.inc(),
            site="objectstore.get")

    # ------------------------------------------------------------ uploader
    def _submit(self, task) -> None:
        """Stage a task in order (the caller holds ``_lock``)."""
        self._staged.append(task)

    def _flush_staged(self) -> None:
        """Move the staged tasks onto the bounded queue in order (the
        caller does not hold ``_lock``: a full queue blocks)."""
        with self._stage_lock:
            while True:
                try:
                    task = self._staged.popleft()
                except IndexError:
                    return
                self._inflight_ts.append(time.time())
                self._queue.put(task)
                QUEUE_DEPTH.set(self._queue.qsize())

    def _upload_loop(self) -> None:
        while True:
            task = self._queue.get()
            QUEUE_DEPTH.set(self._queue.qsize())
            try:
                if task is _STOP:
                    return
                self._run_task(task)
            except Exception as e:
                # fatal: nothing landed; later tasks of the shard park
                self._upload_errors.append(f"{task[0]}: {e!r}")
                self._failed.add((task[1], task[2]))
            finally:
                if task is not _STOP:
                    try:
                        self._inflight_ts.popleft()
                    except IndexError:
                        pass
                self._queue.task_done()

    def _run_task(self, task) -> None:
        kind, dataset, shard = task[0], task[1], task[2]
        if (dataset, shard) in self._failed:
            # a checkpoint landing without the data it covers would make
            # replay skip the lost flush
            self._upload_errors.append(
                f"{kind} parked behind failed upload "
                f"({dataset}/shard-{shard})")
            return
        if kind == "pyramid":
            # derived data: its failure never poisons the shard, and its
            # seq registers only after its PUT lands
            seq, key, data = task[3], task[4], task[5]
            try:
                self._uploader_put(key, data)
                with self._lock:
                    st = self._states.get((dataset, shard))
                    if st is not None and seq in st.segments:
                        st.seg_pyramids.add(seq)
                self._put_manifest(dataset, shard)
            except Exception as e:
                self._upload_errors.append(f"pyramid: {e!r}")
        elif kind == "segment":
            seq, key, data = task[3], task[4], task[5]
            with traced_operation("objectstore", op="upload", shard=shard,
                                  nbytes=len(data)):
                self._uploader_put(key, data)
            with self._lock:
                st = self._states.get((dataset, shard))
                if st is not None:
                    seg = st.segments.get(seq)
                    if seg is not None:
                        seg.uploaded = True
                    st.pending.pop(seq, None)
            self._put_manifest(dataset, shard)
            if self.auto_compact:
                try:
                    self._maybe_compact(dataset, shard)
                except Exception as e:
                    # the old segments stay live: nothing is lost
                    self._upload_errors.append(f"compact: {e!r}")
        elif kind == "checkpoint":
            self._uploader_put(
                self._shard_prefix(dataset, shard) + "checkpoints.json",
                json.dumps(task[3]).encode())
            with self._lock:
                self._durable[(dataset, shard)] = dict(task[3])

    def _uploader_put(self, key: str, data: bytes) -> None:
        """Retry transient faults forever: an acknowledged flush must land
        (a segment key is never reused)."""
        while True:
            try:
                self.retry_policy.call(
                    lambda: self._put_raw(key, data),
                    retry_on=self._transient(),
                    on_retry=lambda *a, **k: RETRIES.inc(),
                    site="objectstore.put")
                return
            except self._transient():
                if self._closed:
                    raise
                RETRIES.inc()
                self.retry_policy.sleep(self.retry_policy.max_backoff_s)

    def _put_manifest(self, dataset: str, shard: int) -> None:
        self._require_writable("_put_manifest")
        with self._lock:
            st = self._states.get((dataset, shard))
            if st is None:
                return
            doc = {
                "version": 1,
                "next_seq": st.next_seq,
                "upd": st.upd,
                "segments": [
                    {"seq": s.seq, "bucket": s.bucket, "key": s.key,
                     "size": s.size, "crc": s.crc, "entries": s.entries,
                     "max_upd": s.max_upd}
                    for s in sorted(st.segments.values(),
                                    key=lambda s: s.seq)
                    if s.uploaded],
                "pyramids": sorted(
                    q for q in st.seg_pyramids
                    if q in st.segments and st.segments[q].uploaded),
                "bucket_pyramids": [st.bucket_pyramids[b]
                                    for b in sorted(st.bucket_pyramids)],
            }
        self._uploader_put(self._shard_prefix(dataset, shard)
                           + "manifest.json", json.dumps(doc).encode())

    # ------------------------------------------------------------ state
    def _state(self, dataset: str, shard: int) -> _ShardState:
        with self._lock:
            st = self._states.get((dataset, shard))
            if st is not None:
                return st
        # the cold load's GETs run outside the lock, so a recovery does not
        # stall other shards; of two racing loads the first one is kept
        st = self._load_state(dataset, shard)
        with self._lock:
            return self._states.setdefault((dataset, shard), st)

    def _load_state(self, dataset: str, shard: int) -> _ShardState:
        """Recovery: the manifest, then each live segment in full
        (CRC32C-checked), applied in seq order."""
        st = _ShardState()
        base = self._shard_prefix(dataset, shard)
        with span("objectstore", op="load", dataset=dataset, shard=shard):
            try:
                doc = json.loads(self._get(base + "manifest.json"))
            except KeyError:
                doc = None
            if doc:
                st.next_seq = int(doc.get("next_seq", 1))
                st.upd = int(doc.get("upd", 0))
                st.seg_pyramids = {int(q) for q in doc.get("pyramids", ())}
                st.bucket_pyramids = {
                    int(d["bucket"]): d
                    for d in doc.get("bucket_pyramids", ())}
                for s in doc.get("segments", ()):
                    info = _SegmentInfo.of(s)
                    st.segments[info.seq] = info
                for info in sorted(st.segments.values(),
                                   key=lambda s: s.seq):
                    if not self._bucket_in_split(info.bucket):
                        continue
                    data = self._get(info.key)
                    if crc32c(data[:-_FOOTER.size]) != info.crc:
                        CORRUPT.inc()
                        raise CorruptSegmentError(
                            f"{info.key}: manifest CRC mismatch")
                    self._apply_entries(st, info.seq,
                                        parse_segment(data, info.key))
                if self.split_filter is not None:
                    st.segments = {
                        q: s for q, s in st.segments.items()
                        if self._bucket_in_split(s.bucket)}
            try:
                st.checkpoints = {
                    int(g): int(o) for g, o in json.loads(
                        self._get(base + "checkpoints.json")).items()}
            except KeyError:
                pass
            st.loaded_checkpoints = dict(st.checkpoints)
        return st

    def _apply_entries(self, st: _ShardState, seq: int, entries) -> None:
        for e in entries:
            if e[0] == "chunk":
                _, blob, cid, t0, t1, itime, upd, off, dlen, crc, _ = e
                st.chunks.setdefault(blob, {})[cid] = _ChunkRef(
                    cid, t0, t1, itime, upd, seq, off, dlen, crc)
            elif e[0] == "partkey":
                _, blob, t0, t1, upd = e
                prev = st.parts.get(blob)
                if prev is not None:
                    t0 = min(prev[0], t0)
                st.parts[blob] = [t0, t1, upd, self._bucket_of(blob)]
            else:
                st.parts.pop(e[1], None)
                st.chunks.pop(e[1], None)

    def refresh_shard(self, dataset: str, shard: int) -> None:
        """Drop a shard's cached state, unless it holds open or pending
        segments, so the next access re-reads the manifest."""
        with self._lock:
            st = self._states.get((dataset, shard))
            if st is not None and not st.pending and not st.open:
                del self._states[(dataset, shard)]

    def sync_shard(self, dataset: str, shard: int) -> int:
        """Apply the segments the manifest lists and this view has not
        seen (a GET each); a shard with open or pending segments is the
        writer's and is skipped. Returns the segments applied."""
        with self._lock:
            st = self._states.get((dataset, shard))
            if st is not None and (st.pending or st.open):
                return 0
        if st is None:
            self._state(dataset, shard)  # the first load is the sync
            return 0
        base = self._shard_prefix(dataset, shard)
        try:
            doc = json.loads(self._get(base + "manifest.json"))
        except KeyError:
            return 0
        with self._lock:
            if st.pending or st.open:
                return 0  # became a writer since
            known = set(st.segments)
            st.next_seq = max(st.next_seq, int(doc.get("next_seq", 1)))
            st.upd = max(st.upd, int(doc.get("upd", 0)))
            st.seg_pyramids = {int(q) for q in doc.get("pyramids", ())}
            st.bucket_pyramids = {
                int(d["bucket"]): d
                for d in doc.get("bucket_pyramids", ())}
        applied = 0
        for s in sorted(doc.get("segments", ()),
                        key=lambda s: int(s["seq"])):
            if int(s["seq"]) in known:
                continue
            info = _SegmentInfo.of(s)
            if not self._bucket_in_split(info.bucket):
                continue
            data = self._get(info.key)
            if crc32c(data[:-_FOOTER.size]) != info.crc:
                CORRUPT.inc()
                raise CorruptSegmentError(
                    f"{info.key}: manifest CRC mismatch")
            entries = parse_segment(data, info.key)
            # two racing syncs may both apply a segment: entries upsert
            with self._lock:
                self._apply_entries(st, info.seq, entries)
                st.segments[info.seq] = info
            applied += 1
        return applied

    # -------------------------------------------------------- segment build
    def _open_for(self, st, bkt) -> _OpenSegment:
        seg = st.open.get(bkt)
        if seg is None:
            seg = st.open[bkt] = _OpenSegment(st.next_seq, bkt)
            st.next_seq += 1
        return seg

    def _seal(self, st, dataset, shard, bkt) -> None:
        """Seal one open segment and queue it (the caller holds the
        lock); its pyramid queues behind it."""
        seg = st.open.pop(bkt, None)
        if seg is None or seg.entries == 0:
            return
        data = seg.finish()
        key = self._seg_key(dataset, shard, bkt, seg.seq)
        st.segments[seg.seq] = _SegmentInfo(
            seg.seq, bkt, key, len(data), crc32c(data[:-_FOOTER.size]),
            seg.entries, seg.max_upd, False)
        st.pending[seg.seq] = data
        self._submit(("segment", dataset, shard, seg.seq, key, data))
        # an FSG1 writer (the legacy tests) writes no pyramids
        if _MAGIC == b"FSG2":
            pdata = pyramid.build_segment_pyramid(seg.pyr_rows)
            if pdata is not None:
                self._submit(("pyramid", dataset, shard, seg.seq,
                              key[:-4] + ".pyr", pdata))

    def _seal_all(self, st, dataset, shard) -> None:
        for bkt in list(st.open):
            self._seal(st, dataset, shard, bkt)

    # ------------------------------------------------------------- writes
    def initialize(self, dataset: str, num_shards: int) -> None:
        for s in range(num_shards):
            self._state(dataset, s)

    def write_chunk_rows(self, dataset, shard, rows, ingestion_time):
        self._require_writable("write_chunk_rows")
        by_key: dict[bytes, list] = {}
        for blob, cid, t0, t1, data in rows:
            by_key.setdefault(bytes(blob), []).append(
                (int(cid), int(t0), int(t1), data))
        with span("objectstore", op="write_chunks", shard=shard):
            st = self._state(dataset, shard)
            with self._lock:
                for blob, chunks in by_key.items():
                    self._write_chunks(st, dataset, shard, blob, chunks,
                                       ingestion_time)
            self._flush_staged()

    def _write_chunks(self, st, dataset, shard, blob, chunks,
                      ingestion_time) -> None:
        """One part key's chunks: the reference's ``write_chunks``."""
        bkt = self._bucket_of(blob)
        st.upd += 1
        upd = st.upd
        refs = st.chunks.setdefault(blob, {})
        seg = self._open_for(st, bkt)
        for cid, t0, t1, data in chunks:
            if cid in refs:  # a flush again: kept by id
                continue
            if not isinstance(data, bytes):
                data = bytes(data)
            off, dlen, crc = seg.add_chunk(blob, cid, t0, t1, data,
                                           ingestion_time, upd)
            refs[cid] = _ChunkRef(cid, t0, t1, ingestion_time, upd, seg.seq,
                                  off, dlen, crc)
        if seg.size() >= self.segment_target_bytes:
            self._seal(st, dataset, shard, bkt)

    def write_part_keys(self, dataset, shard, records):
        self._require_writable("write_part_keys")
        with span("objectstore", op="write_part_keys", shard=shard):
            st = self._state(dataset, shard)
            with self._lock:
                st.upd += 1
                upd = st.upd
                for r in records:
                    blob = r.part_key.serialized
                    bkt = self._bucket_of(blob)
                    start = r.start_time
                    prev = st.parts.get(blob)
                    if prev is not None:
                        start = min(prev[0], start)
                    st.parts[blob] = [start, r.end_time, upd, bkt]
                    seg = self._open_for(st, bkt)
                    seg.add_part_key(blob, start, r.end_time, upd)
                    if seg.size() >= self.segment_target_bytes:
                        self._seal(st, dataset, shard, bkt)
            self._flush_staged()

    def delete_part_keys(self, dataset, shard, part_keys):
        """Remove part keys and their chunks, with a durable tombstone
        each."""
        self._require_writable("delete_part_keys")
        st = self._state(dataset, shard)
        with self._lock:
            for pk in part_keys:
                blob = pk.serialized
                st.parts.pop(blob, None)
                st.chunks.pop(blob, None)
                self._open_for(st, self._bucket_of(blob)).add_delete(blob)
        self._flush_staged()

    def truncate(self, dataset):
        self._require_writable("truncate")
        self.flush()
        with self._lock:
            for key in [k for k in self._states if k[0] == dataset]:
                del self._states[key]
        for key in self.client.list_objects(
                f"{self.bucket}/{self.prefix}{dataset}/"):
            self.client.delete_object(key)

    # -------------------------------------------------------------- reads
    def _fetch_refs(self, dataset, shard, st, blob, refs) -> dict[int, bytes]:
        """One part key's payloads → {chunk id: bytes}: open and pending
        segments from memory, uploaded ones by ranged GETs (a segment's run
        coalesced into one where it is dense enough), each checked against
        its CRC32C."""
        out: dict[int, bytes] = {}
        for key, key_refs in self._resolve_refs(st, blob, refs, out).items():
            try:
                self._ranged_get(key, key_refs, out)
            except KeyError:
                # a compaction deleted the object after the refs were
                # taken: resolve them again against the fresh index
                for k, rs in self._resolve_refs(st, blob, key_refs,
                                                out).items():
                    self._ranged_get(k, rs, out)
        for ref in refs:
            data = out.get(ref.chunk_id)
            if data is None or len(data) != ref.length \
                    or crc32c(data) != ref.crc:
                CORRUPT.inc()
                raise CorruptSegmentError(
                    f"chunk {ref.chunk_id} in seg {ref.seq} "
                    f"({dataset}/shard-{shard}): payload CRC32C mismatch")
        return out

    def _resolve_refs(self, st, blob, refs, out) -> dict:
        """Under the lock: refs in pending or open segments go into ``out``
        from memory; the rest are grouped by their live object's key. A
        ref whose segment left the index (compacted after the caller took
        it) is resolved against the chunk index again."""
        groups: dict[str, list[_ChunkRef]] = {}
        with self._lock:
            open_by_seq = {o.seq: o for o in st.open.values()}
            live = st.chunks.get(blob, {})
            for ref in refs:
                if ref.chunk_id in out:
                    continue
                if ref.seq not in st.segments \
                        and ref.seq not in open_by_seq:
                    ref = live.get(ref.chunk_id) or ref
                data = st.pending.get(ref.seq)
                if data is None:
                    o = open_by_seq.get(ref.seq)
                    if o is not None:
                        data = o.buf.getvalue()
                if data is not None:
                    out[ref.chunk_id] = data[ref.offset:ref.offset
                                             + ref.length]
                elif ref.seq in st.segments:
                    groups.setdefault(st.segments[ref.seq].key,
                                      []).append(ref)
        return groups

    def _ranged_get(self, key: str, seq_refs: list[_ChunkRef],
                    out: dict[int, bytes]) -> None:
        seq_refs = sorted(seq_refs, key=lambda r: r.offset)
        lo = seq_refs[0].offset
        hi = max(r.offset + r.length for r in seq_refs)
        dense = sum(r.length for r in seq_refs)
        if hi - lo <= dense + 4096 * len(seq_refs):
            blob = self._get(key, lo, hi - lo)
            PAYLOAD_BYTES_DOWN.inc(hi - lo)
            for r in seq_refs:
                out[r.chunk_id] = blob[r.offset - lo:
                                       r.offset - lo + r.length]
        else:
            for r in seq_refs:
                out[r.chunk_id] = self._get(key, r.offset, r.length)
                PAYLOAD_BYTES_DOWN.inc(r.length)

    def read_chunk_rows(self, dataset, shard, blobs, start_time, end_time):
        """(blob, serialized chunk) of the chunks of ``blobs`` overlapping
        [start, end], a part key's in chunk-id order, fetched key by key as
        the reference's ``read_chunks``."""
        out = []
        with span("objectstore", op="read_chunks", shard=shard):
            st = self._state(dataset, shard)
            for blob in blobs:
                blob = bytes(blob)
                with self._lock:
                    refs = sorted(
                        (r for r in st.chunks.get(blob, {}).values()
                         if r.end_time >= start_time
                         and r.start_time <= end_time),
                        key=lambda r: r.chunk_id)
                if not refs:
                    continue
                payloads = self._fetch_refs(dataset, shard, st, blob, refs)
                out.extend((blob, payloads[r.chunk_id]) for r in refs)
        return out

    def read_chunks_by_id(self, dataset, shard, wanted) -> list:
        """The serialized chunks of ``wanted`` ((blob, chunk id) pairs; None
        for one the store does not hold), one ranged GET a chunk, as the
        reference's page-in of a single chunk reads it (its
        ``read_chunks`` over [start, start])."""
        st = self._state(dataset, shard)
        with self._lock:
            refs = [st.chunks.get(bytes(b), {}).get(int(c))
                    for b, c in wanted]

        def one(i):
            ref = refs[i]
            if ref is None:
                return None
            blob = bytes(wanted[i][0])
            return self._fetch_refs(dataset, shard, st, blob,
                                    [ref])[ref.chunk_id]

        return [one(i) for i in range(len(wanted))]

    # ------------------------------------------------------ pyramid reads
    def pyramid_refs(self, dataset, shard, pk_blob):
        """One part key's index for the pyramid lane: (its chunk refs by
        id, the seqs with a durable segment pyramid, its bucket's roll-up
        record or None)."""
        st = self._state(dataset, shard)
        with self._lock:
            refs = sorted(st.chunks.get(pk_blob, {}).values(),
                          key=lambda r: r.chunk_id)
            part = st.parts.get(pk_blob)
            bkt = part[3] if part is not None else self._bucket_of(pk_blob)
            return refs, frozenset(st.seg_pyramids), \
                st.bucket_pyramids.get(bkt)

    def _read_pyramid_object(self, key: str, parse) -> dict | None:
        try:
            data = self._get(key)
        except KeyError:
            return None   # raced a compaction's delete: demote a level
        pyramid.PYR_BYTES_DOWN.inc(len(data))
        try:
            return parse(data, key)
        except pyramid.PyramidParseError:
            CORRUPT.inc()
            return None   # derived data: a corrupt one only demotes

    def read_segment_pyramid(self, dataset, shard, seq) -> dict | None:
        st = self._state(dataset, shard)
        with self._lock:
            info = st.segments.get(seq)
            if seq not in st.seg_pyramids or info is None:
                return None
            key = info.key[:-4] + ".pyr"
        return self._read_pyramid_object(key, pyramid.parse_segment_pyramid)

    def read_bucket_pyramid(self, dataset, shard, bkt) -> dict | None:
        st = self._state(dataset, shard)
        with self._lock:
            bp = st.bucket_pyramids.get(bkt)
            if bp is None:
                return None
            key = bp["key"]
        return self._read_pyramid_object(key, pyramid.parse_bucket_pyramid)

    def pyramid_index(self, dataset, shard) -> tuple[list[int], dict]:
        """(the seqs with a pyramid, sorted; {bucket: roll-up record}) for
        the summary-only scans."""
        st = self._state(dataset, shard)
        with self._lock:
            return (sorted(q for q in st.seg_pyramids if q in st.segments),
                    dict(st.bucket_pyramids))

    def _records(self, items) -> list[PartKeyRecord]:
        return [PartKeyRecord(pk_from_blob(blob), v[0], v[1])
                for blob, v in items]

    def scan_part_keys(self, dataset, shard):
        st = self._state(dataset, shard)
        with self._lock:
            items = list(st.parts.items())
        return self._records(items)

    def scan_part_keys_split(self, dataset, shard, split, n_splits):
        """One token-range split of the part keys: the keys of the buckets
        that serve it where ``n_splits`` divides the bucket count, else
        those whose ``split_of`` is ``split``."""
        if n_splits <= 1:
            return self.scan_part_keys(dataset, shard)
        st = self._state(dataset, shard)
        with self._lock:
            items = list(st.parts.items())
        if self.bucket_count % n_splits == 0:
            items = [(b, v) for b, v in items if v[3] % n_splits == split]
        else:
            items = [(b, v) for b, v in items
                     if split_of(b, n_splits) == split]
        return self._records(items)

    def scan_part_keys_since(self, dataset, shard, pk_token):
        st = self._state(dataset, shard)
        with self._lock:
            items = [(b, v) for b, v in st.parts.items() if v[2] > pk_token]
        return self._records(items)

    def dataset_stats(self, dataset):
        """{series, bytes, segments} over the dataset's loaded shards (for
        ``status/tiers``): uploaded segments and sealed ones still
        pending."""
        series = nbytes = segments = 0
        with self._lock:
            for (ds, _shard), st in self._states.items():
                if ds != dataset:
                    continue
                series += len(st.parts)
                for seg in st.segments.values():
                    nbytes += seg.size
                    segments += 1
        return {"series": series, "bytes": nbytes, "segments": segments}

    def scan_chunk_rows_by_ingestion_time(self, dataset, shard, start, end):
        return self.scan_chunk_rows_by_ingestion_time_split(
            dataset, shard, start, end, 0, 1)

    def scan_chunk_rows_by_ingestion_time_split(self, dataset, shard, start,
                                                end, split, n_splits):
        """``scan_chunk_rows_by_ingestion_time`` of one token-range split
        (the downsampler job's unit of fan-out)."""
        st = self._state(dataset, shard)
        with self._lock:
            work = []
            for blob, refs in st.chunks.items():
                if n_splits > 1:
                    part = st.parts.get(blob)
                    bkt = part[3] if part is not None \
                        else self._bucket_of(blob)
                    if self.bucket_count % n_splits == 0:
                        if bkt % n_splits != split:
                            continue
                    elif split_of(blob, n_splits) != split:
                        continue
                sel = sorted((r for r in refs.values()
                              if start <= r.ingestion_time < end),
                             key=lambda r: r.chunk_id)
                if sel:
                    work.append((blob, sel))
        out = []
        for blob, sel in work:
            payloads = self._fetch_refs(dataset, shard, st, blob, sel)
            out.extend((blob, payloads[r.chunk_id]) for r in sel)
        return out

    def max_persisted_ts(self, dataset, shard):
        st = self._state(dataset, shard)
        with self._lock:
            return {blob: max(r.end_time for r in refs.values())
                    for blob, refs in st.chunks.items() if refs}

    def max_persisted_ts_since(self, dataset, shard, chunk_token):
        st = self._state(dataset, shard)
        with self._lock:
            out = {}
            for blob, refs in st.chunks.items():
                sel = [r.end_time for r in refs.values()
                       if r.upd > chunk_token]
                if sel:
                    out[blob] = max(sel)
            return out

    def update_tokens(self, dataset, shard):
        st = self._state(dataset, shard)
        with self._lock:
            return (st.upd, st.upd)

    # ----------------------------------------------------- index snapshots
    def write_index_snapshot(self, dataset, shard, data):
        self._require_writable("write_index_snapshot")
        key = self._shard_prefix(dataset, shard) + "index.snap"
        with span("objectstore", op="write_snapshot", shard=shard):
            # synchronous: a returned snapshot write is replay-barrier state
            self.retry_policy.call(
                lambda: self._put_raw(key, bytes(data)),
                retry_on=self._transient(),
                on_retry=lambda *a, **k: RETRIES.inc(),
                site="objectstore.put")

    def read_index_snapshot(self, dataset, shard):
        try:
            return self._get(self._shard_prefix(dataset, shard)
                             + "index.snap")
        except KeyError:
            return None

    # ------------------------------------------------- migration manifests
    # synchronous, not behind the uploader: a returned write is the
    # migration's resume barrier for its phase
    def write_migration_manifest(self, dataset, shard, data):
        self._require_writable("write_migration_manifest")
        key = self._shard_prefix(dataset, shard) + "migration.json"
        with span("objectstore", op="write_migration", shard=shard):
            self.retry_policy.call(
                lambda: self._put_raw(key, data),
                retry_on=self._transient(),
                on_retry=lambda *a, **k: RETRIES.inc(),
                site="objectstore.put")

    def read_migration_manifest(self, dataset, shard):
        try:
            return self._get(self._shard_prefix(dataset, shard)
                             + "migration.json")
        except KeyError:
            return None

    def delete_migration_manifest(self, dataset, shard):
        self._require_writable("delete_migration_manifest")
        try:
            self.client.delete_object(self._shard_prefix(dataset, shard)
                                      + "migration.json")
        except KeyError:
            pass

    # ---------------------------------------------------------- compaction
    def _maybe_compact(self, dataset: str, shard: int) -> None:
        """Compact the buckets with many small uploaded segments (on the
        uploader's thread, so in order with the uploads)."""
        with self._lock:
            st = self._states.get((dataset, shard))
            if st is None:
                return
            small: dict[int, int] = {}
            for s in st.segments.values():
                if s.uploaded and s.size < self.segment_target_bytes // 2:
                    small[s.bucket] = small.get(s.bucket, 0) + 1
            due = [b for b, n in small.items()
                   if n >= self.compact_min_segments]
        for b in due:
            self._compact_bucket(dataset, shard, b)

    def compact(self, dataset: str, shard: int) -> int:
        """Compact every bucket of the shard now; returns the segments
        removed."""
        self._require_writable("compact")
        st = self._state(dataset, shard)
        with self._lock:
            buckets = {s.bucket for s in st.segments.values() if s.uploaded}
            before = len(st.segments)
        for b in sorted(buckets):
            self._compact_bucket(dataset, shard, b)
        with self._lock:
            return before - len(self._state(dataset, shard).segments)

    def _compact_bucket(self, dataset: str, shard: int, bkt: int) -> None:
        """Merge a bucket's uploaded segments into one: read and check
        them, write again only the live entries (a part key's latest
        state, the chunks still indexed), upload the new segment and its
        pyramids, swap the manifest, delete the old objects."""
        with self._lock:
            st = self._states.get((dataset, shard))
            if st is None:
                return
            olds = sorted((s for s in st.segments.values()
                           if s.bucket == bkt and s.uploaded),
                          key=lambda s: s.seq)
            if len(olds) < 2:
                return
        with span("objectstore", op="compact", shard=shard, bucket=bkt):
            parsed = [(s, parse_segment(self._get(s.key), s.key))
                      for s in olds]
            with self._lock:
                st = self._states.get((dataset, shard))
                if st is None or any(s.seq not in st.segments
                                     for s, _ in parsed):
                    return  # compacted meanwhile
                # legacy inputs gaining pyramid coverage through this
                backfilled = sum(
                    1 for s, _ in parsed if s.seq not in st.seg_pyramids)
                new = _OpenSegment(st.next_seq, bkt)
                st.next_seq += 1
                moved: list[tuple[bytes, _ChunkRef]] = []
                emitted: set[bytes] = set()
                for s, entries in parsed:
                    for e in entries:
                        if e[0] == "chunk":
                            _, blob, cid, *_rest = e
                            ref = st.chunks.get(blob, {}).get(cid)
                            if ref is None or ref.seq != s.seq:
                                continue   # deleted or superseded
                            data = _with_summary(e[10])
                            off, dlen, crc = new.add_chunk(
                                blob, cid, ref.start_time, ref.end_time,
                                data, ref.ingestion_time, ref.upd)
                            moved.append((blob, _ChunkRef(
                                cid, ref.start_time, ref.end_time,
                                ref.ingestion_time, ref.upd, new.seq,
                                off, dlen, crc)))
                        elif e[0] == "partkey":
                            cur = st.parts.get(e[1])
                            if cur is None or e[1] in emitted:
                                continue
                            emitted.add(e[1])
                            new.add_part_key(e[1], cur[0], cur[1], cur[2])
                data = new.finish()
                key = self._seg_key(dataset, shard, bkt, new.seq)
                info = _SegmentInfo(
                    new.seq, bkt, key, len(data),
                    crc32c(data[:-_FOOTER.size]), new.entries,
                    new.max_upd, False)
            spyr = pyramid.build_segment_pyramid(new.pyr_rows)
            bpyr = pyramid.build_bucket_pyramid(new.pyr_rows, [new.seq])
            pkey = key[:-4] + ".pyr"
            bkey = self._shard_prefix(dataset, shard) \
                + f"b{bkt:02d}/bkt-{new.seq:08d}.pyr"
            # the replacement and its pyramids land before the swap (a
            # manifest never names an absent object); a pyramid's failure
            # only demotes readers
            self._uploader_put(key, data)
            info.uploaded = True
            spyr_ok = bpyr_ok = False
            try:
                if spyr is not None:
                    self._uploader_put(pkey, spyr)
                    spyr_ok = True
                if bpyr is not None:
                    self._uploader_put(bkey, bpyr)
                    bpyr_ok = True
            except Exception as e:
                self._upload_errors.append(f"pyramid: {e!r}")
            with self._lock:
                st.segments[info.seq] = info
                for blob, ref in moved:
                    live = st.chunks.get(blob, {})
                    if live.get(ref.chunk_id) is not None:
                        live[ref.chunk_id] = ref
                for s, _ in parsed:
                    st.segments.pop(s.seq, None)
                    st.seg_pyramids.discard(s.seq)
                if spyr_ok:
                    st.seg_pyramids.add(new.seq)
                old_bp = st.bucket_pyramids.pop(bkt, None)
                if bpyr_ok:
                    st.bucket_pyramids[bkt] = {
                        "bucket": bkt, "seq": new.seq, "key": bkey,
                        "covers": [new.seq]}
            self._put_manifest(dataset, shard)
            for s, _ in parsed:
                for k in (s.key, s.key[:-4] + ".pyr"):
                    try:
                        self.client.delete_object(k)
                    except Exception:
                        pass   # an orphan, in no manifest
            if old_bp is not None and old_bp.get("key") != bkey:
                try:
                    self.client.delete_object(old_bp["key"])
                except Exception:
                    pass
            if spyr_ok and backfilled:
                pyramid.PYR_BACKFILLED.inc(backfilled)
            COMPACTIONS.inc()

    # ------------------------------------------------------------ lifecycle
    def flush(self) -> None:
        """Seal every open segment and wait until everything staged so far
        is uploaded. Raises :class:`ObjectStoreError` where an upload
        failed fatally: a returned flush is the durability ack."""
        with self._lock:
            for (dataset, shard), st in self._states.items():
                self._seal_all(st, dataset, shard)
        self._flush_staged()
        self._queue.join()
        if self._failed:
            shards = ", ".join(f"{d}/shard-{s}"
                               for d, s in sorted(self._failed))
            raise ObjectStoreError(
                f"write-behind upload failed fatally for {shards}; "
                "flushed data is NOT durable: "
                + "; ".join(self._upload_errors[-3:]))

    def upload_errors(self) -> list[str]:
        return list(self._upload_errors)

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.flush()
        finally:
            # the uploader stops even when the flush raises: once closed,
            # ``_uploader_put`` re-raises instead of backing off forever
            self._closed = True
            self._queue.put(_STOP)
            self._uploader.join(timeout=30)


def _with_summary(payload: bytes) -> bytes:
    """A serialized chunk with its summary section: a chunk written
    without one (an FSG1 segment's) gains it, as the reference's
    compaction backfills it."""
    ch = Chunk.deserialize(payload)
    if ch.summary is not None:
        return payload
    ensure_summary(ch, backfill=True)
    return ch.serialize()


class HttpS3Client:
    """A path-style S3 REST client (stdlib only) with optional AWS SigV4
    signing: PUT, GET with a range, DELETE and ListObjectsV2. It offers no
    multipart (no ``create_multipart``), so the uploader sends single PUTs
    (S3 takes up to 5 GiB in one)."""

    def __init__(self, endpoint: str, access_key: str | None = None,
                 secret_key: str | None = None, region: str = "us-east-1",
                 timeout_s: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout_s = timeout_s

    def _sign(self, method: str, path: str, query: str, headers: dict,
              payload: bytes) -> dict:
        """``query`` is already canonical (:func:`_canon_query`): the same
        string goes into the signed request and the URL."""
        import datetime
        import hashlib
        import hmac
        import urllib.parse as up
        if not self.access_key:
            return headers
        now = datetime.datetime.now(datetime.timezone.utc)
        amzdate = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(payload).hexdigest()
        headers = dict(headers)
        headers["host"] = up.urlparse(self.endpoint).netloc
        headers["x-amz-date"] = amzdate
        headers["x-amz-content-sha256"] = payload_hash
        signed = sorted(k.lower() for k in headers)
        canonical_headers = "".join(
            f"{k}:{str(headers[_orig(headers, k)]).strip()}\n"
            for k in signed)
        canonical = "\n".join([
            method, up.quote(path), query, canonical_headers,
            ";".join(signed), payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amzdate, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])

        def _hmac(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        return headers

    def _request(self, method: str, key: str, params: dict | None = None,
                 data: bytes = b"", headers: dict | None = None) -> bytes:
        import urllib.error
        import urllib.request
        path = "/" + key
        query = _canon_query(params) if params else ""
        headers = self._sign(method, path, query, headers or {}, data)
        url = self.endpoint + path + ("?" + query if query else "")
        req = urllib.request.Request(url, data=data or None, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KeyError(key) from None
            if e.code in (500, 502, 503, 504, 429):
                raise ConnectionError(f"s3 {method} {key}: {e.code}") \
                    from None
            raise ObjectStoreError(
                f"s3 {method} {key}: {e.code} {e.reason}") from None
        except urllib.error.URLError as e:
            raise ConnectionError(f"s3 {method} {key}: {e.reason}") \
                from None

    def put_object(self, key: str, data: bytes) -> None:
        self._request("PUT", key, data=data)

    def get_object(self, key: str, start: int | None = None,
                   length: int | None = None) -> bytes:
        headers = {}
        if start is not None:
            end = "" if length is None else start + length - 1
            headers["Range"] = f"bytes={start}-{end}"
        return self._request("GET", key, headers=headers)

    def delete_object(self, key: str) -> None:
        try:
            self._request("DELETE", key)
        except KeyError:
            pass

    def list_objects(self, prefix: str = "") -> list[str]:
        import xml.etree.ElementTree as ET
        bucket, _, rest = prefix.partition("/")
        out: list[str] = []
        token = None
        while True:
            params = {"list-type": "2", "prefix": rest}
            if token:
                params["continuation-token"] = token
            root = ET.fromstring(self._request("GET", bucket,
                                               params=params))
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            for c in root.iter(f"{ns}Key"):
                out.append(f"{bucket}/{c.text}")
            trunc = root.findtext(f"{ns}IsTruncated") == "true"
            token = root.findtext(f"{ns}NextContinuationToken")
            if not trunc or not token:
                return out


def _canon_query(params: dict | None) -> str:
    """SigV4's canonical query string: keys and values percent-encoded
    with the RFC 3986 unreserved set only (``/`` becomes ``%2F``), pairs
    sorted by encoded key; valid as it is in the URL."""
    import urllib.parse as up
    if not params:
        return ""
    pairs = sorted((up.quote(str(k), safe=""), up.quote(str(v), safe=""))
                   for k, v in params.items())
    return "&".join(f"{k}={v}" for k, v in pairs)


def _orig(headers: dict, lower: str) -> str:
    for k in headers:
        if k.lower() == lower:
            return k
    return lower


def open_object_store(store_cfg: dict, data_dir: str
                      ) -> tuple[ObjectStoreColumnStore,
                                 "ObjectStoreMetaStore"]:
    """The object-store tier of a ``store`` config block: no endpoint (or
    a plain path) gives a directory-backed ``FakeS3`` (under ``data_dir``
    unless the path names one), ``http(s)://…`` a real S3-compatible
    service."""
    import os
    endpoint = store_cfg.get("endpoint")
    if endpoint and str(endpoint).startswith(("http://", "https://")):
        client = HttpS3Client(
            endpoint,
            access_key=store_cfg.get("access_key"),
            secret_key=store_cfg.get("secret_key"),
            region=store_cfg.get("region", "us-east-1"))
    else:
        from filodb_tpu_torch.testing.fake_s3 import FakeS3
        client = FakeS3(root=endpoint or os.path.join(data_dir,
                                                      "objectstore"))
    cs = ObjectStoreColumnStore(
        client,
        bucket=store_cfg.get("bucket", "filodb"),
        prefix=store_cfg.get("prefix", ""),
        segment_target_bytes=int(
            store_cfg.get("segment_target_bytes", 1 << 20)),
        bucket_count=int(store_cfg.get("bucket_count", 8)),
        upload_queue_depth=int(store_cfg.get("upload_queue_depth", 64)))
    return cs, ObjectStoreMetaStore(cs)


class ObjectStoreMetaStore(MetaStore):
    """Checkpoints in the same bucket, queued behind the data they cover:
    ``write_checkpoint`` seals the shard's open segments into the
    column store's upload queue, then queues the checkpoint object."""

    def __init__(self, column_store: ObjectStoreColumnStore):
        self.cs = column_store

    def write_checkpoint(self, dataset, shard, group, offset):
        cs = self.cs
        cs._require_writable("write_checkpoint")
        with span("objectstore", op="write_checkpoint", shard=shard):
            st = cs._state(dataset, shard)
            with cs._lock:
                cs._seal_all(st, dataset, shard)
                st.checkpoints[group] = offset
                # staged after the seals under the same lock: in FIFO order
                # the checkpoint object lands last
                cs._submit(("checkpoint", dataset, shard,
                            dict(st.checkpoints)))
            cs._flush_staged()

    def read_checkpoints(self, dataset, shard):
        st = self.cs._state(dataset, shard)
        with self.cs._lock:
            return dict(st.checkpoints)

    def durable_checkpoints(self, dataset, shard) -> dict[int, int]:
        """The checkpoints as they stand in the bucket: a log may be cut
        below these only (``read_checkpoints`` runs ahead of the upload).
        Recovery's are loaded from the bucket."""
        st = self.cs._state(dataset, shard)
        with self.cs._lock:
            return dict(self.cs._durable.get((dataset, shard),
                                             st.loaded_checkpoints))

    def close(self) -> None:
        pass   # the column store owns the lifecycle
