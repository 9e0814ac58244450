"""One shard of the store: partitions, their sealed chunks with device
pages, the write path to the column store, recovery, and the selection of
page blocks for a query.

Port of ``filodb_tpu/core/memstore/shard.py``: partition creation (ids in
creation order), columnar ingest (``ingest_series``: rounds of whole rows
of samples) and container ingest from the log (``ingest``: one C++ pass
over the records, ``native_shard.NativeShardCore``, the reference's native
ingest core), index lookup with the time-range predicate, and the
chunk selection of ``device_batch._query_chunks`` (resident and paged
chunks overlapping the range in chunk-id order, then the write buffer). A
sealed chunk keeps its device pages, encoded once at seal time (the
reference's ``StoreConfig.device_pages=True``), and its codec chunk until
its group flushes; the write buffers are encoded when a query first needs
them and kept until the shard next ingests.

A container from the log fires the ``shard.ingest`` fault site, and its
ingest and each group flush are traced operations (the slow-ingest
ring). Under a tenant quota (the governor's ``tenants`` block, applied at
construction) new series of a container are counted one at a time and
the records of one over its quota are dropped and counted
(``memstore_data_dropped``), as the reference's.

The part-key map (``PartKey.serialized`` → pid) is the C++ core's
(``self.core``). A container's scalar records are routed, deduplicated
and appended one sample at a time in C++, in container order; the pass
hands back to Python, and resumes at the same record, where it meets keys
the map lacks (their partitions are made here, under the tenant quotas,
through the evicted-key bloom) and where a buffer row it must append to is
full (the filled rows seal here). Histogram records are listed by the pass
and appended after the scalars, one bucket scheme at a time.

The write path, as the reference's: a partition belongs to flush group
``part_hash % groups_per_shard``. A container's records at or below their
group's watermark are skipped (replay after a restart).
``flush_group`` captures the checkpoint offset first, seals the group's
write buffers, writes its pending codec chunks and dirty part keys, then
the checkpoint. ``recover_index`` restores partitions from the part-key
table with their out-of-order floor at their largest persisted timestamp;
``setup_watermarks_for_recovery`` loads the checkpoints and returns where
replay starts. Columnar ingest has no log offset: it counts as offset -1,
checks no watermark and moves no offset, so one store takes both kinds.
``evict_partition_chunks`` drops flushed chunks from memory; a query pages
them back in (``core/memstore/odp.py``).

A node's ingest worker, its flush scheduler and the query threads share a
shard: ``lock`` (the reference's ``write_lock``) is taken where the
reference takes it, around ingest (container and columnar), seal, a group
flush, part-key writes, recovery, the index snapshot, page-in and chunk
eviction, and around each index lookup. A query's ``select_for_batch``
pages in and selects its page blocks under it, so they come from one
version of the shard; the page arrays it hands out are never written
again (a seal or a compaction makes new ones), so the pack that follows,
the upload and the kernels run without it.

Index snapshots (``snapshot_index``, ``core/memstore/index_snapshot.py``)
hold the partition registry, the index and the cardinality tree; a
restart restores one and then the part keys and chunk floors written
since its tokens, or on any failure falls back to the full part-key scan,
as the reference does. ``floor`` is each partition's largest persisted
timestamp (the snapshot's out-of-order floor).

``version`` moves on every change to what a selection sees: each ingest
call and each purge, as the reference's ``data_version`` moves, and each
seal, page-in, eviction and recovery besides; the query caches stamp with
it (a batch, a result extent past the horizon, a rendered response).
``max_ingested_ts`` is the largest timestamp ingested on either lane (-1
before any), the extent cache's horizon.

The memory bound (the reference's ``shard.py:765-926``): ``enforce_memory``
evicts flushed chunks, partitions of the oldest latest sample first, and
past that whole cold partitions (``evict_cold_partitions``);
``purge_expired`` drops partitions whose latest sample is older than
``retention_ms``. Both work on the per-pid arrays at once. A pid has a
``status``: live, evicted (a paged shell: its index entry stays with its
end time, its key goes into the evicted-key bloom ``evicted_keys``, its
chunks page back in through ``odp.py``) or gone (purged, or the old entry
of an evicted series that came back: a hole in every array, never reused).
A new key that hits the bloom takes its evicted pid's start time and dedup
floor, and the old pid becomes a hole (``_restore_evicted``). Every sealed
chunk carries its summary (``memory/chunk.py``; ``ChunkTable`` columns
``stats_*`` and ``sketch_*``), made at seal by the host codec and written
with the chunk at flush.

Each sealed chunk and each write buffer records whether float32 holds its
values exactly (``partition.exact_in_f32``). ``select_for_batch`` reads
those flags over a selection before it packs anything: where one fails,
it hands over the selection's float64 samples instead (``_samples``: the
codec chunks, held, paged in or read back from the column store, and
copies of the write buffers) for the host-decode lane
(``query/engine/batch.py``).

Two debug knobs of the store config, as the reference's. A partition
whose key string holds one of ``trace_part_key_substrings`` is traced:
the C++ pass lists its records (``listed``), they are appended here
through the same write buffers, and each sample and each chunk it seals
logs one line on the ``filodb_tpu_torch.trace`` logger in the
reference's ``TracingTimeSeriesPartition`` format. Under
``assert_single_writer`` the first thread that calls ``ingest`` owns the
shard, and a call from any other raises ``AssertionError``.

Histogram partitions (``ingest_histograms``) keep their own write buffers,
one per bucket count, their own chunk table and their own page tables: a
sealed chunk encodes one timestamp page plus one int page per bucket
(``HistPageBlocks``, as the reference's ``_hist_pages``) and a float32 XOR
value page of each of the schema's ``sum`` and ``count`` columns, beside
the bucket pages and over the same timestamp page. Each chunk records its
bucket scheme (``les``) as the partition held it at seal time. A column
selector (``h::sum``) selects those value pages as a scalar series
(``select_blocks(..., column="sum")``).

Partitions of the downsample tier's ``ds-gauge`` schema (``multi``) carry
K = 5 DOUBLE columns (min, max, sum, count, avg). Their records come
through containers (the C++ pass lists them, as it lists histogram
records) into buffers of their own, K float64 bit patterns a sample
(``multi_buffers``); a sealed chunk keeps one timestamp page and each
column's values (``MultiPageBlocks``: a column's float32 pages are
encoded when a selection first reads it), and each column's largest
finite |value| and float32 exactness, so a selector that reads one
column (``select_blocks(..., column="sum")``) takes the page lane or the
host-decode lane by that column's own flags.
"""

from __future__ import annotations

import logging
import struct
import threading
import time

import numpy as np

from filodb_tpu_torch.core.memstore import odp
from filodb_tpu_torch.core.memstore.cardinality import (
    CardinalityTracker,
    QuotaExceededError,
)
from filodb_tpu_torch.core.memstore.index import INGESTING, PartKeyIndex
from filodb_tpu_torch.core.memstore import native_shard
from filodb_tpu_torch.core.memstore.partition import (
    HIST_COLUMNS,
    MULTI_COLUMNS,
    MULTI_SCHEMA,
    ChunkTable,
    WriteBuffers,
    abs_max_finite,
    drop_out_of_order,
    encode_pages,
    exact_in_f32,
    expand,
    hist_slots,
    multi_columns,
    slot_columns,
)
from filodb_tpu_torch.core.partkey import PartKey, murmur3_32_many
from filodb_tpu_torch.core.record import (
    SCHEMA_NAMES,
    SomeData,
    parse_container,
)
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.core.store.api import (
    ColumnStore,
    InMemoryMetaStore,
    MetaStore,
    NullColumnStore,
    PartKeyRecord,
    pk_from_blob,
)
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.memory.chunk import (
    ChunkBytes,
    chunk_ids,
    encode_chunks,
    summarize,
)
from filodb_tpu_torch.query.engine.batch import Samples
from filodb_tpu_torch.query.engine.device_batch import (
    decode_packed,
    pack_blocks,
    to_device,
)
from filodb_tpu_torch.utils.bloom import BloomFilter
from filodb_tpu_torch.utils.metrics import Counter, Gauge, Histogram
from filodb_tpu_torch.utils.governor import (
    apply_tenant_quotas,
    record_tenant_drop,
)
from filodb_tpu_torch.utils.resilience import FaultInjector
from filodb_tpu_torch.utils.tracing import traced_operation

log = logging.getLogger(__name__)
trace_log = logging.getLogger("filodb_tpu_torch.trace")

_NCOL = len(HIST_COLUMNS)
_KCOL = len(MULTI_COLUMNS)
_NO_TS = np.iinfo(np.int64).max
# a pid's status
LIVE, EVICTED, GONE = 0, 1, 2


class KeyList:
    """A shard's part keys by pid and their ``PartKey.serialized`` blobs;
    a key a snapshot restored is made from its blob when first used (a
    restore creates no key object)."""

    def __init__(self, blobs: list[bytes] = ()):
        self._blobs = list(blobs)
        self._keys: list = [None] * len(self._blobs)

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        k = self._keys[i]
        if k is None:
            k = self._keys[i] = pk_from_blob(self._blobs[i])
        return k

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def blob(self, i: int) -> bytes:
        return self._blobs[i]

    def extend(self, keys) -> None:
        keys = list(keys)
        self._keys.extend(keys)
        self._blobs.extend(k.serialized for k in keys)

    def drop(self, pids) -> None:
        """Forget the keys of ``pids`` (holes)."""
        for p in np.asarray(pids).tolist():
            self._blobs[p] = b""
            self._keys[p] = None


class ShardStats:
    """The reference's shard metrics (``ShardStats``) of the ingest, flush
    and recovery paths, tagged {dataset, shard}, under its names."""

    def __init__(self, dataset: str, shard: int):
        tags = {"dataset": dataset, "shard": str(shard)}
        self.rows_ingested = Counter("memstore_rows_ingested", tags)
        self.rows_skipped = Counter("recovery_row_skipped", tags)
        self.partitions_created = Counter("memstore_partitions_created",
                                          tags)
        self.num_partitions = Gauge("num_partitions", tags)
        self.chunks_flushed = Counter("memstore_flushes_chunks_written", tags)
        self.flushes_done = Counter("memstore_flushes_success", tags)
        self.flushes_failed = Counter("memstore_flushes_failed", tags)
        self.dirty_keys_flushed = Counter(
            "memstore_index_num_dirty_keys_flushed", tags)
        self.flush_latency = Histogram("chunk_flush_task_latency_seconds",
                                       tags)
        self.offset_latest_in_mem = Gauge("shard_offset_latest_inmemory",
                                          tags)
        self.offset_flushed_latest = Gauge("shard_offset_flushed_latest",
                                           tags)
        self.offset_flushed_earliest = Gauge("shard_offset_flushed_earliest",
                                             tags)
        self.recovery_time_ms = Gauge("memstore_total_shard_recovery_time_ms",
                                      tags)
        self.index_recovery_partkeys = Counter(
            "memstore_index_recovery_partkeys_processed", tags)
        self.partitions_purged = Counter("memstore_partitions_purged", tags)
        self.purge_time_ms = Counter("memstore_partitions_purge_time_ms",
                                     tags)
        self.partitions_evicted = Counter("memstore_partitions_evicted",
                                          tags)
        self.chunkids_evicted = Counter("memstore_chunkids_evicted", tags)
        self.partitions_restored = Counter(
            "memstore_partitions_paged_restored", tags)
        self.eviction_stall_ns = Counter("memstore_eviction_stall_ns", tags)
        self.bloom_queries = Counter("evicted_pk_bloom_filter_queries", tags)
        self.bloom_fp = Counter("evicted_pk_bloom_filter_fp", tags)
        self.quota_dropped = Counter("memstore_data_dropped", tags)
        # what the seals encoded: samples and codec bytes (``Chunk.nbytes``)
        self.samples_encoded = Counter("memstore_samples_encoded", tags)
        self.encoded_bytes = Counter("memstore_encoded_bytes_allocated", tags)
        self.downsample_records = Counter(
            "memstore_downsample_records_created", tags)


class Shard:
    def __init__(self, shard_num: int, config: StoreConfig | None = None,
                 dataset: str = "timeseries",
                 column_store: ColumnStore | None = None,
                 meta_store: MetaStore | None = None):
        self.shard_num = shard_num
        self.config = config or StoreConfig()
        self.max_chunk_size = self.config.max_chunk_size
        self.dataset = dataset
        self.column_store = column_store or NullColumnStore()
        self.meta_store = meta_store or InMemoryMetaStore()
        self.index = PartKeyIndex()
        self.keys = KeyList()
        self.core = native_shard.NativeShardCore()  # blob → pid
        self.buffers = WriteBuffers(self.max_chunk_size)
        # per partition: latest timestamp (the out-of-order floor), next
        # chunk sequence, schema (index into SCHEMA_NAMES), flush group,
        # part key not yet written to the column store
        self.latest = np.zeros(0, np.int64)
        self._seq = np.zeros(0, np.int64)
        self.schema_of = np.zeros(0, np.int8)
        self.group = np.zeros(0, np.int64)
        self._dirty = np.zeros(0, bool)
        self.status = np.zeros(0, np.int8)  # LIVE, EVICTED or GONE
        self.hashes = np.zeros(0, np.uint32)  # part hash (murmur3 of key)
        # a chunk's largest finite |value|, and whether its pages hold its
        # values exactly (``exact_in_f32``)
        self._sealed = ChunkTable("vmax", "exact")
        self.version = 0
        self.max_ingested_ts = -1
        self._buffer_pages = None  # (version, buffer_pages() dict)
        self._buffer_meta_cache = None  # (version, buffer_meta() dict)
        # histogram partitions: a kind flag, the bucket count of each
        # one's write buffer and its current scheme (an index into
        # ``les_list``); buffers, chunks and pages of their own
        self.hist = np.zeros(0, bool)
        self._width = np.zeros(0, np.int64)
        self._les_id = np.zeros(0, np.int64)
        self.les_list: list[np.ndarray] = []
        self._les_index: dict[bytes, int] = {}
        self.hist_buffers: dict[int, WriteBuffers] = {}
        # each chunk's scheme, and the largest finite |value| of its sum and
        # count columns and whether its pages hold them exactly
        self._hist_sealed = ChunkTable("les", "vmax_sum", "vmax_count",
                                       "exact_sum", "exact_count",
                                       schema="prom-histogram")
        self._hist_buffer_pages = None  # (version, [per bucket count])
        self._hist_buffer_meta = None
        # multi-column (ds-gauge) partitions: buffers of K float64 bit
        # patterns a sample, and their chunks' per-column flags
        self.multi = np.zeros(0, bool)
        # hist | multi | traced: the C++ pass lists their records
        self.listed = np.zeros(0, bool)
        self._trace = tuple(self.config.trace_part_key_substrings)
        self.traced = np.zeros(0, bool)
        self._writer_thread: int | None = None  # assert_single_writer
        self.multi_buffers = WriteBuffers(self.max_chunk_size, _KCOL)
        self._multi_sealed = ChunkTable(
            *(f"vmax_{c}" for c in MULTI_COLUMNS),
            *(f"exact_{c}" for c in MULTI_COLUMNS), schema=MULTI_SCHEMA)
        self._multi_buffer_cache = {}  # "meta" / "pages" → (version, dict)
        # write path: per-group watermarks (replayed records at or below
        # are skipped), the highest log offset ingested, and the largest
        # persisted timestamp of each part key found at recovery, which
        # seeds the floor of a partition that replay creates
        self.group_watermarks = np.full(self.config.groups_per_shard, -1,
                                        np.int64)
        self._ingested_offset = -1
        self._last_flushed_group = -1
        self._persisted_floors: dict[bytes, int] = {}
        self.rows_skipped = 0  # replayed records below their watermark
        self.odp_cache = odp.DemandPagedChunkCache()
        self._earliest = None  # (version, earliest_in_memory())
        # each partition's largest persisted timestamp (-1: none known)
        self.floor = np.zeros(0, np.int64)
        self.lock = threading.Lock()
        self.stats = ShardStats(dataset, shard_num)
        self.recovered_from: str | None = None  # "snapshot" or "scan"
        self.cardinality = CardinalityTracker(shard_num)
        apply_tenant_quotas(self.cardinality)
        self.evicted_keys = BloomFilter(
            self.config.evicted_pk_bloom_filter_capacity)
        self._shells: dict[bytes, int] = {}  # evicted key blob → its pid
        # the streaming downsampler (``core/downsample``): a flush hands it
        # the partitions whose chunks it wrote
        self.downsampler = None
        # live partitions recovered with a persisted end time (``_reopen``)
        self._ended = np.zeros(0, np.int64)

    @property
    def num_partitions(self) -> int:
        return len(self.keys)

    def key_blobs(self, pids) -> list[bytes]:
        """``PartKey.serialized`` of partitions ``pids``."""
        return [self.keys.blob(p) for p in np.asarray(pids).tolist()]

    # ---- partitions --------------------------------------------------------

    def _grow(self, n: int) -> None:
        cap = len(self.latest)
        if n <= cap:
            return
        grow = max(n, 2 * cap, 1024) - cap

        def more(a, fill):
            return np.concatenate([a, np.full(grow, fill, a.dtype)])

        self.latest = more(self.latest, -1)
        self.floor = more(self.floor, -1)
        self._seq = more(self._seq, 0)
        self.schema_of = more(self.schema_of, 0)
        self.group = more(self.group, 0)
        self._dirty = more(self._dirty, False)
        self.hist = more(self.hist, False)
        self.multi = more(self.multi, False)
        self.listed = more(self.listed, False)
        self.traced = more(self.traced, False)
        self._width = more(self._width, 0)
        self._les_id = more(self._les_id, -1)
        self.status = more(self.status, LIVE)
        self.hashes = more(self.hashes, 0)

    def _create(self, keys: list[PartKey], first_ts: np.ndarray,
                counted: bool = False) -> np.ndarray:
        """New partitions of distinct new ``keys`` with their first sample
        times: ids in order, dirty, floors from the persisted ones
        (``counted``: the cardinality tree has counted them already)."""
        base = len(self.keys)
        n = base + len(keys)
        blobs = [k.serialized for k in keys]
        self._grow(n)
        self.keys.extend(keys)
        self.core.insert(blobs, np.arange(base, n))
        schema = np.array([SCHEMA_NAMES.index(k.schema) for k in keys],
                          np.int8)
        self.schema_of[base:n] = schema
        self.hist[base:n] = [SCHEMAS[k.schema].is_histogram for k in keys]
        self.multi[base:n] = [SCHEMAS[k.schema].is_multi for k in keys]
        if self._trace:
            self.traced[base:n] = [self._traces(k) for k in keys]
        self.listed[base:n] = self.hist[base:n] | self.multi[base:n] \
            | self.traced[base:n]
        self.hashes[base:n] = murmur3_32_many(blobs)
        self.group[base:n] = self.hashes[base:n].astype(np.int64) \
            % self.config.groups_per_shard
        self._dirty[base:n] = True
        if self._persisted_floors:
            self.floor[base:n] = [self._persisted_floors.get(b, -1)
                                  for b in blobs]
            self.latest[base:n] = self.floor[base:n]
        self.index.add_part_keys(base, [k.labels for k in keys],
                                 np.asarray(first_ts, np.int64))
        if not counted:
            self.cardinality.series_created_many(k.label_map for k in keys)
        self.stats.partitions_created.inc(len(keys))
        if self.evicted_keys.count:
            self._restore_evicted(np.arange(base, n), blobs)
        self.stats.num_partitions.set(len(self.index))
        return np.arange(base, n)

    def _traces(self, key: PartKey) -> bool:
        kstr = str(key)
        return any(sub in kstr for sub in self._trace)

    def _trace_samples(self, pids, ts, lens, values) -> None:
        """Log each sample of the traced partitions among ``pids`` (rows of
        ``ts`` [N, T] with ``lens``) before it is appended, accepted where
        it passes its partition's latest sample and every earlier one
        (``drop_out_of_order``); ``values(i, j)`` is the record's values
        tuple."""
        for i in np.flatnonzero(self.traced[pids]).tolist():
            pid = int(pids[i])
            floor = int(self.latest[pid])
            for j in range(int(lens[i])):
                t = int(ts[i, j])
                ok = t > floor
                floor = max(floor, t)
                trace_log.info(
                    "TRACE %s shard=%d ingest ts=%d values=%s accepted=%s",
                    self.keys[pid], self.shard_num, t, values(i, j), ok)

    def _trace_chunks(self, row: dict, codec) -> None:
        """Log each chunk a seal encoded for a traced partition."""
        for i in np.flatnonzero(self.traced[row["pid"]]).tolist():
            trace_log.info(
                "TRACE %s shard=%d encoded chunk id=%d rows=%d bytes=%d",
                self.keys[int(row["pid"][i])], self.shard_num,
                int(row["cid"][i]), int(row["rows"][i]),
                int(codec.nbytes[i]))

    def record_keys(self, pids) -> list[bytes]:
        """The record-form part keys of ``pids`` (the reference's
        ``part_key_blob``, the bloom's keys)."""
        from filodb_tpu_torch.core.memstore.index_snapshot import (
            record_keys,
        )

        pids = np.asarray(pids, np.int64)
        return record_keys(self.key_blobs(pids), self.schema_of[pids])

    def _restore_evicted(self, pids: np.ndarray, blobs: list[bytes]) -> None:
        """New partitions whose key hits the evicted-key bloom and belongs
        to an evicted pid take that pid's identity: its start time where
        earlier, its end time as their dedup floor; the old pid becomes a
        hole (the reference's ``_maybe_restore_evicted``)."""
        self.stats.bloom_queries.inc(len(pids))
        rec = self.record_keys(pids)
        hit = [i for i, r in enumerate(rec) if r in self.evicted_keys]
        old = np.array([self._shells.pop(blobs[i], -1) for i in hit],
                       np.int64)
        self.stats.bloom_fp.inc(int((old < 0).sum()))
        new = pids[np.array(hit, np.int64)[old >= 0]]
        old = old[old >= 0]
        if not len(new):
            return
        starts = np.minimum(self.index.start_times(old),
                            self.index.start_times(new))
        self.index.set_start_times(new, starts)
        ends = self.index.end_times(old)
        ended = ends < 2**62
        np.maximum.at(self.latest, new[ended], ends[ended])
        np.maximum.at(self.floor, new, self.floor[old])
        self._dirty[new] = True
        self._remove(old)
        self.stats.partitions_restored.inc(len(new))

    def _partitions_for(self, keys: list[PartKey],
                        first_ts: np.ndarray) -> np.ndarray:
        """Partition ids of distinct ``keys``, created where new."""
        pids = self.core.lookup([k.serialized for k in keys])
        new = np.flatnonzero(pids < 0)
        if len(new):
            pids[new] = self._create([keys[i] for i in new], first_ts[new])
        return pids

    def lookup_keys(self, blobs: list[bytes]) -> np.ndarray:
        """int64 pids of part-key blobs (``PartKey.serialized``), -1 where
        the shard has no live partition of one."""
        with self.lock:
            return self.core.lookup(blobs)

    def _new_partitions(self, blobs: list[bytes], ts: np.ndarray) -> None:
        """Partitions of distinct new keys (their first records' times
        ``ts``), in order. Under a tenant quota they are counted one at a
        time and a key over its quota gets none (its records are dropped
        and counted), as the reference drops them."""
        keys = [pk_from_blob(b) for b in blobs]
        counted = self.cardinality.has_quotas
        ok = np.ones(len(keys), bool)
        if counted:
            for i, k in enumerate(keys):
                try:
                    self.cardinality.series_created(k.label_map)
                except QuotaExceededError:
                    ok[i] = False
        if ok.any():
            self._create([k for k, o in zip(keys, ok) if o], ts[ok], counted)

    # ---- ingest ------------------------------------------------------------

    def ingest_series(self, keys: list[PartKey], ts: np.ndarray,
                      vals: np.ndarray, lens: np.ndarray) -> int:
        """Append series samples (row i: ``lens[i]`` samples of ``keys[i]``,
        distinct keys). Columnar ingest: no log offset, no watermark.
        Returns the samples kept."""
        if len(set(keys)) != len(keys):
            raise ValueError("one batch may hold each series once")
        if any(SCHEMAS[k.schema].is_multi for k in keys):
            raise ValueError(f"{MULTI_SCHEMA} samples carry {_KCOL} values: "
                             f"they come through containers")
        first = np.where(lens > 0, ts[:, 0], -1)
        with self.lock:
            kept = self._append(self._partitions_for(keys, first), ts, vals,
                                lens)
        self.stats.rows_ingested.inc(kept)
        return kept

    def _append(self, pids, ts, vals, lens) -> int:
        if self._trace:
            self._trace_samples(pids, ts, lens,
                                lambda i, j: (float(vals[i, j]),))
        ts, vals, lens = drop_out_of_order(ts, vals, lens, self.latest[pids])
        for sealed in self.buffers.append(pids, ts, vals, lens):
            self._add_chunks(*sealed)
        self._ingested(pids, ts, lens)
        return int(lens.sum())

    def _ingested(self, pids, ts, lens) -> None:
        """After an append: each partition's latest sample, the shard's
        largest ingested timestamp and its version."""
        has = lens > 0
        self.latest[pids[has]] = ts[has, np.maximum(lens[has] - 1, 0)]
        if has.any():
            self.max_ingested_ts = max(self.max_ingested_ts,
                                       int(self.latest[pids[has]].max()))
        self.version += 1
        self._reopen()

    def _note_ended(self) -> None:
        """Remember the live partitions whose index end time is a persisted
        one (after a recovery): the keys a downsampler job wrote end at
        their last period."""
        P = self.num_partitions
        ends = self.index.end_times(np.arange(P))
        self._ended = np.flatnonzero((ends != INGESTING)
                                     & (self.status[:P] == LIVE))

    def _reopen(self) -> None:
        """A partition recovered with a persisted end time that ingests a
        later sample is ingesting again: its end time goes back to
        ``INGESTING`` (a lookup past the old end finds it) and its key is
        written again at the next flush, as upstream FiloDB's ingest does;
        the reference keeps the old end (ROADMAP §C.10)."""
        e = self._ended
        if not len(e):
            return
        back = self.latest[e] > self.index.end_times(e)
        if back.any():
            pids = e[back]
            self.index.set_end_times(pids, np.full(len(pids), INGESTING))
            self._dirty[pids] = True
            self._ended = e[~back]

    def _scheme(self, les: np.ndarray) -> int:
        """Index of bucket scheme ``les`` in ``les_list``."""
        les = np.ascontiguousarray(les, np.float64)
        key = les.tobytes()
        lid = self._les_index.get(key)
        if lid is None:
            lid = self._les_index[key] = len(self.les_list)
            self.les_list.append(les)
        return lid

    def ingest_histograms(self, keys: list[PartKey], ts: np.ndarray,
                          slots: np.ndarray, lens: np.ndarray,
                          les: np.ndarray) -> int:
        """Append histogram samples: row i holds ``lens[i]`` samples of
        ``keys[i]`` (distinct keys), ``hist_slots`` int64 [N, T, B + 2]
        (cumulative bucket counts under bucket bounds ``les`` [B], then the
        sum and count). A series whose buffer holds another bucket count
        seals it first. Returns the samples kept."""
        if len(set(keys)) != len(keys):
            raise ValueError("one batch may hold each series once")
        first = np.where(lens > 0, ts[:, 0], -1)
        with self.lock:
            kept = self._append_hist(self._partitions_for(keys, first), ts,
                                     slots, lens, self._scheme(les))
        self.stats.rows_ingested.inc(kept)
        return kept

    def _append_hist(self, pids, ts, slots, lens, lid: int) -> int:
        B = slots.shape[2] - _NCOL
        if self._trace:
            cols = slot_columns(slots)
            les = self.les_list[lid]
            self._trace_samples(pids, ts, lens, lambda i, j: (
                float(cols[i, j, 0]), float(cols[i, j, 1]),
                (les, slots[i, j, :B].copy())))
        ts, slots, lens = drop_out_of_order(ts, slots, lens,
                                            self.latest[pids])
        act = pids[lens > 0]
        width = self._width[act]
        for old in np.unique(width[(width != B) & (width > 0)]):
            sealed = self.hist_buffers[int(old)].take(act[width == old])
            if len(sealed[0]):
                self._add_hist_chunks(*sealed)
        self._width[act] = B
        self._les_id[act] = lid
        buf = self.hist_buffers.get(B)
        if buf is None:
            buf = self.hist_buffers[B] = WriteBuffers(self.max_chunk_size,
                                                      B + _NCOL)
        for sealed in buf.append(pids, ts, slots, lens):
            self._add_hist_chunks(*sealed)
        self._ingested(pids, ts, lens)
        return int(lens.sum())

    def ingest(self, data: SomeData) -> int:
        """Ingest one container from the log at its offset: records at or
        below their group's watermark are skipped, and records of a schema
        the port does not know are dropped. Returns the samples kept."""
        FaultInjector.fire("shard.ingest", dataset=self.dataset,
                           shard=self.shard_num, offset=data.offset)
        if self.config.assert_single_writer:
            # the reference's single-writer tripwire
            # (``FiloSchedulers.assertThreadName``)
            tid = threading.get_ident()
            if self._writer_thread is None:
                self._writer_thread = tid
            elif self._writer_thread != tid:
                raise AssertionError(
                    f"shard {self.shard_num} ingested from thread {tid}, "
                    f"owner is {self._writer_thread}")
        raw = data.container.serialize()
        with traced_operation("ingest", dataset=self.dataset,
                              shard=self.shard_num), self.lock:
            kept, skipped = self._ingest_container(raw, data.offset)
        self.stats.rows_ingested.inc(kept)
        self.stats.rows_skipped.inc(skipped)
        return kept

    def _ingest_container(self, raw: bytes, offset: int) -> tuple[int, int]:
        """The C++ pass over a serialized container (``ic_ingest``): it
        stops where a key is new (partitions made, its records at or past
        that point whose key got none are dropped from then on), where a
        row it must append to is full (the filled rows seal, in pid order)
        and where no buffer row is free (more are reserved); each time it
        resumes at the same record. The records it lists follow:
        multi-column, traced scalar, then histogram ones."""
        buf, nrec = _container(raw)
        core, bufs = self.core, self.buffers
        c = core.start(buf, nrec, offset, self.group_watermarks)
        while True:
            bufs.cover(self.num_partitions)
            why = core.ingest(c, self.latest, self.listed, bufs)
            if why == native_shard.DONE:
                break
            if why == native_shard.MISS:
                _, ts, blobs = core.misses(c)
                self._new_partitions(blobs, ts)
                c.drop_from = c.rec
            elif why == native_shard.FULL:
                self._seal_full(c)
            else:
                bufs.reserve(bufs.used + 1)
        self._seal_full(c)
        kept = c.kept
        if c.kept:
            self.max_ingested_ts = max(self.max_ingested_ts, c.max_ts)
            self._reopen()
        if c.scalars:
            self.version += 1
        cols = None
        if c.n_drop:
            cols = parse_container(raw)
            for i in c.out[3][:c.n_drop].tolist():
                self.stats.quota_dropped.inc()
                record_tenant_drop(pk_from_blob(cols.keys[i]).label_map)
        if c.n_hist:
            recs, pids = c.out[1][:c.n_hist], c.out[2][:c.n_hist]
            multi, hist = self.multi[pids], self.hist[pids]
            if multi.any():
                kept += self._append_multi(*_by_series(
                    pids[multi], *_multi_records(raw, recs[multi])))
            if not (multi | hist).all():
                # traced scalar partitions: the pass appended none of
                # their records, so these keep their order
                cols = parse_container(raw) if cols is None else cols
                at = ~multi & ~hist
                kept += self._append(*_by_series(
                    pids[at], cols.ts[recs[at]], cols.dvals[recs[at], 0]))
            if hist.any():
                cols = parse_container(raw) if cols is None else cols
                kept += self._ingest_hist_records(cols, recs[hist],
                                                  pids[hist])
        self.rows_skipped += c.skipped
        self._ingested_offset = max(self._ingested_offset, offset)
        return kept, c.skipped

    def _seal_full(self, c) -> None:
        """Seal the rows the pass filled, in pid order."""
        if not c.n_full:
            return
        rows = c.out[0][:c.n_full]
        rows = rows[np.argsort(self.buffers.pid_of[rows], kind="stable")]
        c.n_full = 0
        sealed = self.buffers._take_rows(rows)
        if len(sealed[0]):
            self._add_chunks(*sealed)

    def _ingest_hist_records(self, cols, idx: np.ndarray,
                             pids: np.ndarray) -> int:
        """Histogram records ``idx`` (container order) of partitions
        ``pids``: appended one bucket scheme at a time, cut where a series'
        scheme changes so that its samples stay in order."""
        nb = cols.bucket_counts()[idx]
        lid = np.zeros(len(idx), np.int64)
        counts_of = {}
        for b in np.unique(nb).tolist():
            at = np.flatnonzero(nb == b)
            les, counts = cols.histograms(idx[at])
            uniq, inv = np.unique(les, axis=0, return_inverse=True)
            lid[at] = np.array([self._scheme(u) for u in uniq])[
                inv.reshape(-1)]
            counts_of[b] = counts, at
        order = np.argsort(pids, kind="stable")
        change = np.zeros(len(idx), bool)
        change[order[1:]] = (pids[order[1:]] == pids[order[:-1]]) \
            & (lid[order[1:]] != lid[order[:-1]])
        cuts = np.concatenate([[0], np.flatnonzero(change), [len(idx)]])
        counts = np.zeros((len(idx), int(nb.max(initial=0))), np.int64)
        for b, (c, at) in counts_of.items():
            counts[at, :b] = c
        kept = 0
        for a, e in zip(cuts[:-1], cuts[1:]):
            for scheme in np.unique(lid[a:e]).tolist():
                r = a + np.flatnonzero(lid[a:e] == scheme)
                B = len(self.les_list[scheme])
                slots = hist_slots(counts[r, :B][:, None, :],
                                   cols.dvals[idx[r], 0],
                                   cols.dvals[idx[r], 1])[:, 0, :]
                kept += self._append_hist(*_by_series(
                    pids[r], cols.ts[idx[r]], slots), scheme)
        return kept

    def _append_multi(self, pids, ts, vals, lens) -> int:
        """Append multi-column samples: ``vals`` float64 [N, T, K]."""
        if self._trace:
            self._trace_samples(pids, ts, lens, lambda i, j: tuple(
                float(v) for v in vals[i, j]))
        ts, vals, lens = drop_out_of_order(ts, vals, lens, self.latest[pids])
        slots = np.ascontiguousarray(vals, np.float64).view(np.int64)
        for sealed in self.multi_buffers.append(pids, ts, slots, lens):
            self._add_multi_chunks(*sealed)
        self._ingested(pids, ts, lens)
        return int(lens.sum())

    def seal(self, pids: np.ndarray) -> None:
        """Close the write buffers of ``pids`` into chunks now."""
        with self.lock:
            self._seal(np.asarray(pids, np.int64))

    def _seal(self, pids: np.ndarray) -> None:
        hist = self.hist[pids]
        multi = self.multi[pids]
        sealed_any = False
        if (~hist & ~multi).any():
            sealed = self.buffers.take(pids[~hist & ~multi])
            if len(sealed[0]):
                self._add_chunks(*sealed)
                sealed_any = True
        if multi.any():
            sealed = self.multi_buffers.take(pids[multi])
            if len(sealed[0]):
                self._add_multi_chunks(*sealed)
                sealed_any = True
        hpids = pids[hist]
        for B in np.unique(self._width[hpids]):
            if B > 0:
                sealed = self.hist_buffers[int(B)].take(
                    hpids[self._width[hpids] == B])
                if len(sealed[0]):
                    self._add_hist_chunks(*sealed)
                    sealed_any = True
        if sealed_any:
            self.version += 1

    def _add_chunks(self, pids, ts, vals, rows) -> None:
        pages, per = encode_pages(ts, vals, rows)
        row = self._chunk_row(pids, ts, rows)
        codec = encode_chunks(ts, vals[:, None, :], rows, row["cid"])
        self._count_encoded(codec, rows)
        if self._trace:
            self._trace_chunks(row, codec)
        stats, sketch = summarize(ts, vals, rows)
        self._sealed.add(pages, per, codec, **row,
                         vmax=abs_max_finite(vals, rows),
                         exact=exact_in_f32(vals, rows), stats_value=stats,
                         sketch_value=sketch)

    def _add_multi_chunks(self, pids, ts, slots, rows) -> None:
        """Seal multi-column buffers: the shared timestamp page and each
        column's values, codec chunks, summaries, and each column's
        largest finite |value| and exactness in float32."""
        pages, per = encode_pages(ts, slots, rows, multi=True)
        cols = multi_columns(slots)
        row = self._chunk_row(pids, ts, rows)
        codec = encode_chunks(ts, cols.transpose(0, 2, 1), rows, row["cid"])
        self._count_encoded(codec, rows)
        if self._trace:
            self._trace_chunks(row, codec)
        flags = {}
        for j, name in enumerate(MULTI_COLUMNS):
            v = np.ascontiguousarray(cols[..., j])
            flags[f"stats_{name}"], flags[f"sketch_{name}"] = summarize(
                ts, v, rows)
            flags[f"vmax_{name}"] = abs_max_finite(v, rows)
            flags[f"exact_{name}"] = exact_in_f32(v, rows)
        self._multi_sealed.add(pages, per, codec, **row, **flags)

    def _add_hist_chunks(self, pids, ts, slots, rows) -> None:
        """Seal histogram buffers: pages, codec chunks, each chunk's scheme
        as its partition holds it now, and its sum and count columns'
        largest finite |value| and exactness in float32 (the lane gate's
        inputs)."""
        pages, per = encode_pages(ts, slots, rows)
        cols = slot_columns(slots)
        row = self._chunk_row(pids, ts, rows)
        les = self._les_id[pids].copy()
        codec = encode_chunks(ts, cols.transpose(0, 2, 1), rows, row["cid"],
                              hist=slots, les=np.stack(
                                  [self.les_list[i] for i in les.tolist()]))
        self._count_encoded(codec, rows)
        if self._trace:
            self._trace_chunks(row, codec)
        summ = {}
        for j, name in enumerate(HIST_COLUMNS):
            summ[f"stats_{name}"], summ[f"sketch_{name}"] = summarize(
                ts, np.ascontiguousarray(cols[..., j]), rows)
        self._hist_sealed.add(pages, per, codec, **row, les=les,
                              vmax_sum=abs_max_finite(cols[..., 0], rows),
                              vmax_count=abs_max_finite(cols[..., 1], rows),
                              exact_sum=exact_in_f32(cols[..., 0], rows),
                              exact_count=exact_in_f32(cols[..., 1], rows),
                              **summ)

    def _count_encoded(self, codec, rows) -> None:
        self.stats.samples_encoded.inc(int(rows.sum()))
        self.stats.encoded_bytes.inc(int(codec.nbytes.sum()))

    def _chunk_row(self, pids, ts, rows) -> dict:
        """The columns every sealed chunk has; takes the next sequence
        number of each partition."""
        seq = self._seq[pids].copy()
        self._seq[pids] += 1
        last = ts[np.arange(len(rows)), np.maximum(rows - 1, 0)]
        t0 = ts[:, 0].copy()
        return dict(pid=pids, seq=seq, cid=chunk_ids(t0, seq), rows=rows,
                    t0=t0, t1=last)

    @property
    def chunks(self) -> dict:
        """Every resident sealed chunk, one entry per column (pid, seq,
        cid, blk0, nblk, rows, t0, t1, nbytes, vmax, ...)."""
        return _live_columns(self._sealed)

    @property
    def multi_chunks(self) -> dict:
        """Every resident sealed multi-column chunk (as ``chunks``, with
        each column's vmax and exact flag)."""
        return _live_columns(self._multi_sealed)

    def _tables_all(self) -> tuple:
        """The sealed chunk tables of every kind."""
        return (self._sealed, self._hist_sealed, self._multi_sealed)

    def _buffers_all(self) -> list:
        """The write buffers of every kind."""
        return [self.buffers, *self.hist_buffers.values(),
                self.multi_buffers]

    @property
    def hist_chunks(self) -> dict:
        """Every resident sealed histogram chunk (as ``chunks``, with les:
        its scheme's index in ``les_list``, vmax_sum, vmax_count)."""
        return _live_columns(self._hist_sealed)

    # ---- flush and recovery ------------------------------------------------

    @property
    def latest_offset(self) -> int:
        return self._ingested_offset

    def next_flush_group(self) -> int:
        """Round-robin group scheduling."""
        self._last_flushed_group = (self._last_flushed_group + 1) \
            % self.config.groups_per_shard
        return self._last_flushed_group

    def flush_group(self, group: int, ingestion_time: int | None = None
                    ) -> int:
        """Flush one group (the reference's ``doFlushSteps``), under the
        lock: seal its write buffers, write its pending chunks and dirty
        part keys, then its checkpoint. Returns the chunks written."""
        if ingestion_time is None:
            ingestion_time = int(time.time() * 1000)
        t0 = time.perf_counter()
        try:
            with traced_operation("flush", dataset=self.dataset,
                                  shard=self.shard_num, group=group), \
                    self.lock:
                written = self._flush_group(group, ingestion_time)
        except Exception:
            self.stats.flushes_failed.inc()
            raise
        st = self.stats
        st.chunks_flushed.inc(written)
        st.flushes_done.inc()
        st.flush_latency.observe(time.perf_counter() - t0)
        st.offset_latest_in_mem.set(self._ingested_offset)
        st.offset_flushed_latest.set(int(self.group_watermarks.max()))
        st.offset_flushed_earliest.set(int(self.group_watermarks.min()))
        return written

    def _flush_group(self, group: int, ingestion_time: int) -> int:
        # rows at or below this offset are in the buffers sealed below;
        # rows ingested later are replayed on recovery
        checkpoint = self._ingested_offset
        P = self.num_partitions
        mine = self.group[:P] == group
        pids = np.flatnonzero(mine)
        self._seal(pids)
        written = 0
        for table in self._tables_all():
            col = table.columns
            sel = np.flatnonzero(col["pending"] & mine[col["pid"]])
            if not len(sel):
                continue
            blobs = self.key_blobs(col["pid"][sel])
            sections = table.sections(sel)
            chunks = [bytes(c) + sec.tobytes() for c, sec in
                      zip(table.codec_rows(sel), sections)]
            rows = list(zip(blobs, col["cid"][sel].tolist(),
                            col["t0"][sel].tolist(), col["t1"][sel].tolist(),
                            chunks))
            self.column_store.write_chunk_rows(self.dataset, self.shard_num,
                                               rows, ingestion_time)
            if self.downsampler is not None and table is self._sealed:
                self._downsample_flushed(col["pid"][sel], col["t0"][sel],
                                         col["t1"][sel])
            table.flushed(sel)
            np.maximum.at(self.floor, col["pid"][sel], col["t1"][sel])
            written += len(sel)
        self._write_part_keys(pids)
        self.meta_store.write_checkpoint(self.dataset, self.shard_num, group,
                                         checkpoint)
        self.group_watermarks[group] = max(self.group_watermarks[group],
                                           checkpoint)
        return written

    def _downsample_flushed(self, pids, t0, t1) -> None:
        """Hand the streaming downsampler the partitions of the chunks a
        flush wrote, in pid order, each with its chunks' time span (the
        reference's ``on_flush`` a partition)."""
        uniq, inv = np.unique(pids, return_inverse=True)
        starts = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
        ends = np.full(len(uniq), np.iinfo(np.int64).min, np.int64)
        np.minimum.at(starts, inv, t0)
        np.maximum.at(ends, inv, t1)
        before = self.downsampler.records_created
        self.downsampler.on_flush(self, uniq, starts, ends)
        self.stats.downsample_records.inc(
            self.downsampler.records_created - before)

    def _write_part_keys(self, pids: np.ndarray) -> None:
        """Write the dirty part keys among ``pids`` (in pid order)."""
        dirty = pids[self._dirty[pids]]
        if not len(dirty):
            return
        starts = self.index.start_times(dirty)
        ends = self.index.end_times(dirty)
        self.column_store.write_part_keys(
            self.dataset, self.shard_num,
            [PartKeyRecord(self.keys[p], s, e) for p, s, e in
             zip(dirty.tolist(), starts.tolist(), ends.tolist())])
        self._dirty[dirty] = False
        self.stats.dirty_keys_flushed.inc(len(dirty))

    def flush_all(self, ingestion_time: int | None = None) -> int:
        """Flush every group. The dirty part keys of all groups go first,
        in pid order, so that a restart recovers the partitions in the
        order they were created (``recover_index`` reads them back in the
        order written), and a batch's rows, and so its sums, come out as
        before."""
        with self.lock:
            self._write_part_keys(np.arange(self.num_partitions))
        return sum(self.flush_group(g, ingestion_time)
                   for g in range(self.config.groups_per_shard))

    def setup_watermarks_for_recovery(self) -> int:
        """Load the groups' checkpoints as their watermarks; returns where
        replay starts: the smallest watermark, a group that never flushed
        counting as -1 (ROADMAP §C.4: the reference starts at the smallest
        checkpoint written and so never replays such a group's rows)."""
        cps = self.meta_store.read_checkpoints(self.dataset, self.shard_num)
        with self.lock:
            for g, off in cps.items():
                if g < len(self.group_watermarks):
                    self.group_watermarks[g] = off
            return int(self.group_watermarks.min())

    def recover_index(self) -> int:
        """Restore the index of an empty shard: from its index snapshot
        and the part keys and chunk floors written since the snapshot's
        tokens, or, without a snapshot or when its restore fails, from the
        full part-key scan (``_scan_part_keys``). Returns the partitions
        restored."""
        t0 = time.perf_counter()
        try:
            with self.lock:
                if not self.num_partitions:
                    snap = self.column_store.read_index_snapshot(
                        self.dataset, self.shard_num)
                    if snap:
                        try:
                            n = self._recover_from_snapshot(snap)
                            self.recovered_from = "snapshot"
                            return n
                        except Exception:
                            log.exception("index snapshot restore failed "
                                          "for %s/%d; falling back to the "
                                          "full part-key scan", self.dataset,
                                          self.shard_num)
                            self._reset_registry()
                self.recovered_from = "scan"
                return self._scan_part_keys()
        finally:
            self.stats.recovery_time_ms.set(
                (time.perf_counter() - t0) * 1000.0)

    def _scan_part_keys(self) -> int:
        """Restore partitions from the column store's part keys, in the
        order they were written (index only: their chunks stay on disk until
        a query pages them in), each with its out-of-order floor at its
        largest persisted timestamp. Returns the keys restored."""
        self._persisted_floors = self.column_store.max_persisted_ts(
            self.dataset, self.shard_num)
        recs = list(self.column_store.scan_part_keys(self.dataset,
                                                     self.shard_num))
        have = self.core.lookup([r.part_key.serialized for r in recs])
        recs = [r for r, p in zip(recs, have.tolist()) if p < 0]
        if not recs:
            return 0
        pids = self._create([r.part_key for r in recs],
                            np.array([r.start_time for r in recs], np.int64))
        self.index.set_end_times(pids, [r.end_time for r in recs])
        self._dirty[pids] = False
        self.version += 1
        self.stats.index_recovery_partkeys.inc(len(recs))
        self._note_ended()
        return len(recs)

    def _reset_registry(self) -> None:
        """Forget a partly restored registry (before the full scan)."""
        self.index = PartKeyIndex()
        self.keys = KeyList()
        self.core.clear()
        self.cardinality = CardinalityTracker(self.shard_num)
        apply_tenant_quotas(self.cardinality)
        for name in ("latest", "floor", "_seq", "schema_of", "group",
                     "_dirty", "hist", "multi", "listed", "traced",
                     "_width", "_les_id", "status", "hashes"):
            setattr(self, name, getattr(self, name)[:0])

    def _recover_from_snapshot(self, data: bytes) -> int:
        from filodb_tpu_torch.core.memstore.index_snapshot import (
            load_snapshot,
        )

        info = load_snapshot(self, data)
        # part keys created or updated after the snapshot
        recs = self.column_store.scan_part_keys_since(
            self.dataset, self.shard_num, info["pk_token"])
        have = self.core.lookup([r.part_key.serialized for r in recs])
        new = [r for r, p in zip(recs, have.tolist()) if p < 0]
        if new:
            pids = self._create([r.part_key for r in new],
                                np.array([r.start_time for r in new],
                                         np.int64))
            self._dirty[pids] = False
        if recs:
            pids = self.core.lookup([r.part_key.serialized for r in recs])
            self.index.set_end_times(pids, [r.end_time for r in recs])
        # chunk floors written after the snapshot; a partition that replay
        # creates takes its floor from them
        delta = self.column_store.max_persisted_ts_since(
            self.dataset, self.shard_num, info["chunk_token"])
        self._persisted_floors = delta
        pids = self.core.lookup(list(delta))
        ts = np.fromiter(delta.values(), np.int64, len(delta))[pids >= 0]
        pids = pids[pids >= 0]
        if len(pids):
            np.maximum.at(self.floor, pids, ts)
            np.maximum.at(self.latest, pids, ts)
        self.version += 1
        self.stats.index_recovery_partkeys.inc(len(new))
        self.stats.num_partitions.set(len(self.index))
        self._note_ended()
        return len(self.index)

    def restore_registry(self, snap: dict) -> None:
        """Load the partitions of a read index snapshot
        (``index_snapshot.read_snapshot``) into this empty shard, in pid
        order: keys, kinds, flush groups from the stored part hashes,
        floors, the index, the cardinality tree and the evicted-key bloom.
        A keyless entry is a hole, or, where its times say it was evicted,
        an evicted partition whose key is rebuilt from its postings."""
        from filodb_tpu_torch.core.memstore.index_snapshot import (
            rebuild_keys,
        )

        if self.num_partitions:
            raise ValueError("an index snapshot restores into an empty shard")
        blobs, n = list(snap["blobs"]), snap["n"]
        keyless = np.flatnonzero(np.fromiter((not b for b in blobs), bool, n))
        shells = keyless[np.asarray(snap["starts"])[keyless] != INGESTING]
        rebuilt = rebuild_keys(shells, snap["hashes"], snap["postings"])
        for p, b in rebuilt.items():
            blobs[p] = b
        self._grow(n)
        self.keys = KeyList(blobs)
        has_key = np.fromiter((bool(b) for b in blobs), bool, n)
        status = np.where(has_key, LIVE, GONE).astype(np.int8)
        status[list(rebuilt)] = EVICTED
        self.status[:n] = status
        self.core.clear()
        self.core.insert(blobs, np.arange(n), status == LIVE)
        self._shells = {blobs[p]: p for p in rebuilt}
        index_of = np.full(1 << 16, -1, np.int64)
        for i, name in enumerate(SCHEMA_NAMES):
            index_of[SCHEMAS[name].schema_id] = i
        schema = index_of[snap["schema_ids"]]
        schema[~has_key] = 0
        for p, b in rebuilt.items():
            schema[p] = SCHEMA_NAMES.index(b.split(b"\x00", 1)[0].decode())
        self.schema_of[:n] = schema
        self.hist[:n] = np.array([SCHEMAS[x].is_histogram
                                  for x in SCHEMA_NAMES])[schema]
        self.multi[:n] = np.array([SCHEMAS[x].is_multi
                                   for x in SCHEMA_NAMES])[schema]
        if self._trace:
            self.traced[:n] = [bool(b) and self._traces(pk_from_blob(b))
                               for b in blobs]
        self.listed[:n] = self.hist[:n] | self.multi[:n] | self.traced[:n]
        self.hashes[:n] = snap["hashes"]
        self.group[:n] = snap["hashes"].astype(np.int64) \
            % self.config.groups_per_shard
        self.floor[:n] = snap["floors"]
        self.latest[:n] = snap["floors"]
        self._dirty[:n] = False
        self.index.restore(snap["starts"], snap["ends"], snap["postings"])
        self.index.remove_part_keys(np.setdiff1d(keyless, list(rebuilt)))
        self.cardinality.load_state(snap["cardinality"])
        if snap["bloom"] is not None:
            self.evicted_keys = BloomFilter.from_state(snap["bloom"])

    def snapshot_index(self) -> int:
        """Write the index snapshot to the column store; returns its
        bytes. The tokens are taken first, so a restore replays everything
        written while the snapshot was made."""
        from filodb_tpu_torch.core.memstore.index_snapshot import (
            save_snapshot,
        )

        chunk_token, pk_token = self.column_store.update_tokens(
            self.dataset, self.shard_num)
        with self.lock:
            data = save_snapshot(self, chunk_token=chunk_token,
                                 pk_token=pk_token,
                                 snapshot_ms=int(time.time() * 1000))
        self.column_store.write_index_snapshot(self.dataset, self.shard_num,
                                               data)
        return len(data)

    def evict_partition_chunks(self, part_ids) -> int:
        """Drop the flushed resident chunks of ``part_ids`` (the partitions
        and their index entries stay; a query pages the chunks back in).
        Returns the chunks evicted."""
        with self.lock:
            return self._evict(part_ids)

    def _evict(self, part_ids, count: bool = True) -> int:
        mine = np.zeros(self.num_partitions, bool)
        mine[np.atleast_1d(np.asarray(part_ids, np.int64))] = True
        n = 0
        for table in self._tables_all():
            col = table.columns
            sel = np.flatnonzero(mine[col["pid"]] & ~col["pending"]
                                 & ~col["dead"])
            col["dead"][sel] = True
            n += len(sel)
            if 2 * int(col["dead"].sum()) > len(col["dead"]):
                table.compact()
        if n:
            self.version += 1
        if count:
            self.stats.chunkids_evicted.inc(n)
        return n

    # ---- the memory bound ----------------------------------------------------

    def chunk_bytes(self) -> int:
        """Codec bytes of the resident sealed chunks (``Chunk.nbytes``, the
        reference's measure)."""
        with self.lock:
            return self._chunk_bytes()

    def _chunk_bytes(self) -> int:
        return sum(int(t.columns["nbytes"][t.live()].sum())
                   for t in self._tables_all())

    def _unpersisted(self, pids: np.ndarray) -> np.ndarray:
        """bool [len(pids)]: which hold unsealed samples or unflushed
        chunks."""
        out = np.zeros(len(pids), bool)
        for b in self._buffers_all():
            out |= b.holding(pids)
        mine = np.zeros(self.num_partitions, bool)
        for table in self._tables_all():
            col = table.columns
            mine[col["pid"][col["pending"] & ~col["dead"]]] = True
        return out | mine[pids]

    def _release(self, pids: np.ndarray) -> None:
        """Free the write-buffer rows of ``pids``."""
        for b in self._buffers_all():
            b.free(pids)

    def _remove(self, pids: np.ndarray) -> None:
        """Make ``pids`` (live or evicted) holes: out of the index, the key
        maps, the write buffers, the chunk tables and the page cache."""
        live = pids[self.status[pids] == LIVE]
        self.cardinality.series_stopped_many(self.keys[p].label_map
                                             for p in live.tolist())
        # a series that came back holds its key under a new pid
        blobs = self.key_blobs(pids)
        self.core.erase(blobs, pids)
        for p, blob in zip(pids.tolist(), blobs):
            if self._shells.get(blob) == p:
                del self._shells[blob]
        self._release(pids)
        gone = np.zeros(self.num_partitions, bool)
        gone[pids] = True
        for table in (*self._tables_all(), *self.odp_cache.tables.values()):
            col = table.columns
            sel = gone[col["pid"]] & ~col["dead"]
            col["dead"][sel] = True
            col["pending"][sel] = False
        self.odp_cache.forget(pids)
        self.index.remove_part_keys(pids)
        self.keys.drop(pids)
        self.status[pids] = GONE
        self._dirty[pids] = False
        self.version += 1

    def remove_partitions(self, pids) -> None:
        """Make ``pids`` holes now (as a purge does, counting nothing)."""
        with self.lock:
            self._remove(np.asarray(pids, np.int64))

    def purge_expired(self, now_ms: int) -> int:
        """Drop every partition whose latest sample is older than
        ``now_ms - retention_ms`` (the reference's TTL purge); returns the
        partitions purged. Evicted partitions go too, by the latest sample
        they held (the reference walks partition objects, which an evicted
        pid lacks, and so never purges one: ROADMAP §C)."""
        cutoff = now_ms - self.config.retention_ms
        t0 = time.perf_counter()
        with self.lock:
            P = self.num_partitions
            lat = self.latest[:P]
            pids = np.flatnonzero((self.status[:P] != GONE) & (lat != -1)
                                  & (lat < cutoff))
            if len(pids):
                self._remove(pids)
        if len(pids):
            self.stats.partitions_purged.inc(len(pids))
            self.stats.purge_time_ms.inc(
                int((time.perf_counter() - t0) * 1000))
            self.stats.num_partitions.set(len(self.index))
        return len(pids)

    def _evict_partitions(self, pids: np.ndarray) -> int:
        """Evict the live ``pids`` that hold nothing unpersisted (after
        their flushed chunks go): keep their index entries with their end
        times, put their keys in the bloom, free the rest."""
        pids = pids[self.status[pids] == LIVE]
        self._evict(pids)
        pids = pids[~self._unpersisted(pids)]
        if not len(pids):
            return 0
        ends = self.index.end_times(pids)
        ends = np.where(ends < 2**62, ends, self.latest[pids])
        set_ = ends != -1
        self.index.set_end_times(pids[set_], ends[set_])
        for r in self.record_keys(pids):
            self.evicted_keys.add(r)
        blobs = self.key_blobs(pids)
        self.core.erase(blobs, pids)
        self._shells.update(zip(blobs, pids.tolist()))
        self._release(pids)
        self.cardinality.series_stopped_many(self.keys[p].label_map
                                             for p in pids.tolist())
        self.status[pids] = EVICTED
        self.version += 1
        self.stats.partitions_evicted.inc(len(pids))
        return len(pids)

    def evict_partition(self, part_id: int) -> bool:
        """Evict one partition whole (see ``_evict_partitions``); False
        where it is not live or holds unpersisted data."""
        with self.lock:
            return self._evict_partitions(np.array([part_id], np.int64)) == 1

    def evict_cold_partitions(self, max_evict: int, now_ms: int | None = None,
                              min_idle_ms: int = 0) -> int:
        """Evict up to ``max_evict`` fully persisted partitions, the oldest
        latest sample first (ties by pid, as the reference's sort breaks
        them); returns the partitions evicted. Every partition visited on
        the way loses its flushed chunks, as in the reference."""
        with self.lock:
            return self._evict_cold(max_evict, now_ms, min_idle_ms)

    def _evict_cold(self, max_evict: int, now_ms: int | None = None,
                    min_idle_ms: int = 0) -> int:
        P = self.num_partitions
        lat = self.latest[:P]
        cand = self.status[:P] == LIVE
        if now_ms is not None and min_idle_ms:
            cand &= ~((lat != -1) & (lat > now_ms - min_idle_ms))
        pids = np.flatnonzero(cand)
        pids = pids[np.lexsort((pids, np.where(lat[pids] != -1,
                                               lat[pids], 0)))]
        ok = np.flatnonzero(~self._unpersisted(pids))
        if max_evict <= 0:
            return 0
        if len(ok) >= max_evict:
            pids = pids[: ok[max_evict - 1] + 1]
        return self._evict_partitions(pids)

    def enforce_memory(self, budget_bytes: int | None = None) -> int:
        """Evict flushed chunks, partitions of the oldest latest sample
        first, until the resident chunks fit the budget (``shard_mem_mb``
        by default); if they still do not, evict whole cold partitions,
        ``max(len(index) // 20, 64)`` of them. Returns the chunks evicted
        in the first step (the reference's count)."""
        budget = budget_bytes if budget_bytes is not None \
            else self.config.shard_mem_mb * 1024 * 1024
        t0 = time.perf_counter()
        with self.lock:
            used = self._chunk_bytes()
            if used <= budget:
                return 0
            P = self.num_partitions
            pids = np.flatnonzero(self.status[:P] == LIVE)
            pids = pids[np.argsort(self.latest[pids], kind="stable")]
            freed = np.zeros(P, np.int64)
            for table in self._tables_all():
                col = table.columns
                sel = ~col["pending"] & ~col["dead"]
                np.add.at(freed, col["pid"][sel], col["nbytes"][sel])
            before = used - (np.cumsum(freed[pids]) - freed[pids])
            k = int(np.argmax(before <= budget)) if (before <= budget).any() \
                else len(pids)
            evicted = self._evict(pids[:k], count=False)
            used -= int(freed[pids[:k]].sum())
            if used > budget:
                self._evict_cold(max(len(self.index) // 20, 64))
        self.stats.eviction_stall_ns.inc(int((time.perf_counter() - t0)
                                             * 1e9))
        return evicted

    def earliest_in_memory(self) -> np.ndarray:
        """int64 [P]: each partition's earliest resident timestamp (its
        first live chunk's start, else its write buffer's first sample),
        -1 where memory holds none of it."""
        cached = self._earliest
        if cached is not None and cached[0] == self.version:
            return cached[1]
        e = np.full(self.num_partitions, _NO_TS, np.int64)
        for table in self._tables_all():
            col = table.columns
            live = ~col["dead"]
            np.minimum.at(e, col["pid"][live], col["t0"][live])
        for buf in self._buffers_all():
            rows = buf.occupied()
            pids = buf.pid_of[rows]
            e[pids] = np.minimum(e[pids], buf.ts[rows, 0])
        e[e == _NO_TS] = -1
        self._earliest = (self.version, e)
        return e

    def _page_in(self, pids, start, end) -> dict | None:
        """The paged chunks ``pids`` need for [start, end]
        (``odp.page_partitions``), or None (demand paging off, or nothing
        to page); the caller holds the lock."""
        if not self.config.demand_paging_enabled:
            return None
        return odp.page_partitions(self, pids, start, end, self.odp_cache)

    def select_for_batch(self, pids: np.ndarray, start: int, end: int,
                         hist: bool, column: str | None = None,
                         expect: int | None = None,
                         host: bool | None = None):
        """A query's page-in and selection under the lock, so both see one
        version of the shard: ``select_hist_blocks`` (``hist``: bucket
        counts, which the pages hold exactly), or for scalar values
        ``select_blocks`` of ``pids`` for [start, end] with the chunks
        paged in for them, or the host-decode lane's ``Samples``
        (``_samples``). The lane is the data's choice: the samples where
        the selected values are not exact in float32 (``host`` None), or
        as ``host`` says. Returns (that selection, the version it
        reflects): the version after the page-in when the shard is still
        at ``expect`` (the version its caller read before choosing
        ``pids``), else ``expect``, so a writer that came between the
        lookup and the selection leaves the batch stale at once."""
        with self.lock:
            same = expect is None or self.version == expect
            paged = self._page_in(pids, start, end)
            if hist:
                sel = self.select_hist_blocks(pids, start, end, paged)
            elif host or (host is None and not self.values_exact(
                    pids, start, end, column, paged)):
                sel = self._samples(pids, start, end, column, paged)
            else:
                sel = self.select_blocks(pids, start, end, column, paged)
            return sel, (self.version if same else expect)

    def chunk_infos(self, pids: np.ndarray, start: int, end: int,
                    include_buffer: bool = False) -> list[tuple]:
        """(pid, chunk id, rows, start, end, codec bytes) of the resident
        chunks of ``pids`` overlapping [start, end], by partition then
        chunk id, and with ``include_buffer`` each overlapping write buffer
        as the chunk it would seal into (id ``chunk_id(t0, 0xFFF)``, as the
        reference's transient buffer chunk)."""
        with self.lock:
            return self._chunk_infos(pids, start, end, include_buffer)

    def _chunk_infos(self, pids, start, end, include_buffer) -> list[tuple]:
        want = np.zeros(self.num_partitions, bool)
        want[pids] = True
        out = []
        for table in self._tables_all():
            col = table.columns
            sel = np.flatnonzero(want[col["pid"]] & ~col["dead"]
                                 & (col["t1"] >= start) & (col["t0"] <= end))
            out.extend(zip(*(col[n][sel].tolist() for n in
                             ("pid", "cid", "rows", "t0", "t1", "nbytes"))))
        for buf in (self._buffers_all() if include_buffer else []):
            rows = buf.occupied()
            n = buf.n[rows].astype(np.int64)
            t0, t1 = buf.ts[rows, 0], buf.ts[rows, n - 1]
            rows = rows[want[buf.pid_of[rows]] & (t1 >= start) & (t0 <= end)]
            if not len(rows):
                continue
            pids_b, n = buf.pid_of[rows], buf.n[rows].astype(np.int64)
            ts, vals = buf.ts[rows], buf.vals[rows]
            ids = chunk_ids(ts[:, 0], np.full(len(rows), 0xFFF))
            if buf is self.multi_buffers:
                codec = encode_chunks(ts, multi_columns(vals).transpose(
                    0, 2, 1), n, ids)
            elif vals.ndim == 3:
                codec = encode_chunks(
                    ts, slot_columns(vals).transpose(0, 2, 1), n, ids,
                    hist=vals, les=np.stack([self.les_list[i] for i in
                                             self._les_id[pids_b].tolist()]))
            else:
                codec = encode_chunks(ts, vals[:, None, :], n, ids)
            out.extend(zip(pids_b.tolist(), ids.tolist(), n.tolist(),
                           ts[:, 0].tolist(),
                           ts[np.arange(len(n)), n - 1].tolist(),
                           codec.nbytes.tolist()))
        return sorted(out)

    # ---- query -------------------------------------------------------------

    def lookup_partitions(self, filters, start: int, end: int) -> np.ndarray:
        with self.lock:
            return self.index.part_ids_from_filters(filters, start, end)

    def label_names(self) -> list[str]:
        with self.lock:
            return self.index.label_names()

    def label_values(self, label: str, filters=None) -> list[str]:
        with self.lock:
            return self.index.label_values(label, filters)

    @staticmethod
    def _buffer_meta(buffers: WriteBuffers, P: int, columns=None) -> dict:
        """Per-pid arrays over the shard's P partitions of the non-empty
        buffers of ``buffers``, cheap (no page is encoded): live, t0, t1,
        and the largest finite |value| and the float32 exactness
        (``exact_in_f32``) of the values, ``vmax`` and ``exact`` ([P, J]
        for slots whose J value columns ``columns`` reads: a histogram's
        sum and count, ``slot_columns``, or a multi-column schema's,
        ``multi_columns``); and the occupied rows and their pids."""
        rows = buffers.occupied()
        pids = buffers.pid_of[rows]
        n = buffers.n[rows]
        ncol = None if columns is None else \
            columns(buffers.vals[:0]).shape[-1]
        shape = (P,) if columns is None else (P, ncol)
        out = dict(rows=rows, pids=pids, live=np.zeros(P, bool),
                   t0=np.zeros(P, np.int64), t1=np.zeros(P, np.int64),
                   vmax=np.zeros(shape), exact=np.ones(shape, bool))
        if len(rows):
            out["live"][pids] = True
            out["t0"][pids] = buffers.ts[rows, 0]
            out["t1"][pids] = buffers.ts[rows, n - 1]
            vals = buffers.vals[rows]
            if columns is not None:
                cols = columns(vals)
                for j in range(ncol):
                    out["vmax"][pids, j] = abs_max_finite(cols[..., j], n)
                    out["exact"][pids, j] = exact_in_f32(cols[..., j], n)
            else:
                out["vmax"][pids] = abs_max_finite(vals, n)
                out["exact"][pids] = exact_in_f32(vals, n)
        return out

    def buffer_meta(self) -> dict:
        """``_buffer_meta`` of the scalar write buffers, made on first use
        after an ingest."""
        cached = self._buffer_meta_cache
        if cached is None or cached[0] != self.version:
            meta = self._buffer_meta(self.buffers, self.num_partitions)
            cached = self._buffer_meta_cache = (self.version, meta)
        return cached[1]

    def hist_buffer_meta(self) -> list[dict]:
        """``_buffer_meta`` of the histogram write buffers, one dict per
        bucket count, in ``hist_buffers`` order."""
        cached = self._hist_buffer_meta
        if cached is None or cached[0] != self.version:
            cached = self._hist_buffer_meta = (self.version, [
                self._buffer_meta(b, self.num_partitions, slot_columns)
                for b in self.hist_buffers.values()])
        return cached[1]

    def _buffer_table(self, buffers: WriteBuffers, meta: dict) -> dict:
        """``meta`` with the device pages of its buffers: pages, blk0 (-1
        for an empty buffer) and nblk per pid."""
        P = self.num_partitions
        pages, per = encode_pages(buffers.ts, buffers.vals, buffers.n,
                                  meta["rows"],
                                  multi=buffers is self.multi_buffers)
        out = dict(meta, pages=pages, blk0=np.full(P, -1, np.int64),
                   nblk=np.zeros(P, np.int64))
        if len(meta["rows"]):
            out["blk0"][meta["pids"]] = np.concatenate([[0],
                                                        np.cumsum(per)[:-1]])
            out["nblk"][meta["pids"]] = per
        return out

    def buffer_pages(self):
        """Device pages of every non-empty scalar write buffer, encoded on
        first use after an ingest: ``buffer_meta`` with the pages and per
        pid blk0 (-1 for an empty buffer) and nblk."""
        cached = self._buffer_pages
        if cached is None or cached[0] != self.version:
            cached = self._buffer_pages = (self.version, self._buffer_table(
                self.buffers, self.buffer_meta()))
        return cached[1]

    def hist_buffer_pages(self) -> list[dict]:
        """``buffer_pages`` of the histogram buffers, one dict per bucket
        count; ``vmax`` and ``exact`` [P, 2] are per column (sum,
        count)."""
        cached = self._hist_buffer_pages
        if cached is None or cached[0] != self.version:
            cached = self._hist_buffer_pages = (self.version, [
                self._buffer_table(b, m) for b, m in zip(
                    self.hist_buffers.values(), self.hist_buffer_meta())])
        return cached[1]

    def multi_buffer_meta(self) -> dict:
        """``_buffer_meta`` of the multi-column write buffers (``vmax``
        and ``exact`` [P, K])."""
        return self._multi_buffer("meta", lambda: self._buffer_meta(
            self.multi_buffers, self.num_partitions, multi_columns))

    def multi_buffer_pages(self) -> dict:
        """``buffer_pages`` of the multi-column write buffers."""
        return self._multi_buffer("pages", lambda: self._buffer_table(
            self.multi_buffers, self.multi_buffer_meta()))

    def _multi_buffer(self, what: str, make):
        cached = self._multi_buffer_cache.get(what)
        if cached is None or cached[0] != self.version:
            cached = self._multi_buffer_cache[what] = (self.version, make())
        return cached[1]

    def _row_of_pid(self, pids: np.ndarray) -> np.ndarray:
        """int64 [P]: each partition's index in ``pids``, -1 if absent."""
        row_of_pid = np.full(self.num_partitions, -1, np.int64)
        row_of_pid[pids] = np.arange(len(pids))
        return row_of_pid

    @staticmethod
    def _chunk_sel(row_of_pid, start, end, tables) -> list[np.ndarray]:
        """The rows of each of ``tables`` (pairs of a ChunkTable and the
        rows of it to consider, None for all live ones) whose chunks belong
        to a selected partition and overlap [start, end]."""
        sels = []
        for table, rows in tables:
            ch = table.columns
            cand = np.flatnonzero(~ch["dead"]) if rows is None else rows
            sels.append(cand[(row_of_pid[ch["pid"][cand]] >= 0)
                             & (ch["t1"][cand] >= start)
                             & (ch["t0"][cand] <= end)])
        return sels

    def _kind(self, pids: np.ndarray, column: str | None):
        """The chunk kind a scalar selection of ``column`` over ``pids``
        reads: False (the value column of scalar partitions), True (a
        histogram's sum or count column) or "multi" (a column of the
        multi-column schema)."""
        if column is None:
            return False
        return "multi" if len(pids) and self.multi[pids[0]] else True

    def _kind_columns(self, kind) -> tuple:
        return HIST_COLUMNS if kind is True else MULTI_COLUMNS

    def _tables(self, kind, paged) -> list:
        """(chunk table, rows) pairs a scalar selection of ``kind`` reads:
        the sealed chunks of the kind and the paged ones."""
        sealed = {False: self._sealed, True: self._hist_sealed,
                  "multi": self._multi_sealed}[kind]
        return [(sealed, None)] + ([] if paged is None else [paged[kind]])

    def _kind_buffers(self, kind, pages: bool) -> list:
        """The buffer tables (``pages``) or metas of ``kind``."""
        if kind is False:
            return [self.buffer_pages() if pages else self.buffer_meta()]
        if kind is True:
            return self.hist_buffer_pages() if pages \
                else self.hist_buffer_meta()
        return [self.multi_buffer_pages() if pages
                else self.multi_buffer_meta()]

    @staticmethod
    def _buffer_sel(buf: dict, pids, start, end) -> np.ndarray:
        """The partitions of ``pids`` whose buffer of the page table
        ``buf`` overlaps [start, end]."""
        return pids[buf["live"][pids] & (buf["t1"][pids] >= start)
                    & (buf["t0"][pids] <= end)]

    def _select(self, pids, start, end, tables, bufs,
                view=lambda pages: pages):
        """Page blocks of partitions ``pids`` (batch rows in that order)
        for [start, end]: the chunks of ``tables`` (``_chunk_sel``) that
        overlap the range, in chunk-id order, then the write buffer if it
        overlaps. → (tables, table_of, block_of, row_of) for the packer,
        the selected rows of each chunk table and each buffer table's
        selected pids."""
        row_of_pid = self._row_of_pid(pids)
        out_tables, table_of, block_of, row_of, keys = [], [], [], [], []
        sels = self._chunk_sel(row_of_pid, start, end, tables)
        for (table, _), sel in zip(tables, sels):
            ch = table.columns
            blocks = expand(ch["blk0"][sel], ch["nblk"][sel])
            offsets = np.asarray(table.offsets)
            seg = np.searchsorted(offsets, blocks, side="right") - 1
            table_of.append(seg + len(out_tables))
            out_tables.extend(view(p) for p in table.pages)
            block_of.append(blocks - offsets[seg])
            r = np.repeat(row_of_pid[ch["pid"][sel]], ch["nblk"][sel])
            row_of.append(r)
            keys.append((r, np.zeros(len(r)),
                         np.repeat(ch["cid"][sel], ch["nblk"][sel])))
        bsels = []
        for buf in bufs:
            bsel = self._buffer_sel(buf, pids, start, end)
            bsels.append(bsel)
            if len(bsel):
                blocks = expand(buf["blk0"][bsel], buf["nblk"][bsel])
                table_of.append(np.full(len(blocks), len(out_tables)))
                out_tables.append(view(buf["pages"]))
                block_of.append(blocks)
                r = np.repeat(row_of_pid[bsel], buf["nblk"][bsel])
                row_of.append(r)
                keys.append((r, np.ones(len(r)), np.zeros(len(r), np.int64)))
        row, late, cid = (np.concatenate(k) for k in zip(*keys))
        # by series, its chunks in chunk-id order and its buffer last; a
        # chunk's blocks keep their order
        order = np.lexsort((np.arange(len(row)), cid, late, row))
        return (out_tables, np.concatenate(table_of)[order],
                np.concatenate(block_of)[order], row[order], sels, bsels)

    def select_blocks(self, pids: np.ndarray, start: int, end: int,
                      column: str | None = None, paged=None):
        """Page blocks of scalar partitions ``pids`` (batch rows in that
        order) for [start, end], or with ``column`` (one of
        ``HIST_COLUMNS``) the value pages of that column of histogram
        partitions; ``paged`` adds the chunks a page-in selected
        (``odp.page_partitions``). Returns (tables, table_of, block_of,
        row_of) for ``device_batch.pack_blocks`` and (the largest |value|
        they hold, whether their pages hold every value exactly)."""
        kind = self._kind(pids, column)
        tables = self._tables(kind, paged)
        bufs = self._kind_buffers(kind, True)
        if kind is not False:
            j = self._kind_columns(kind).index(column)
            out, t_of, b_of, r_of, sels, bsels = self._select(
                pids, start, end, tables, bufs, lambda pages: pages.column(j))
        else:
            j = None
            out, t_of, b_of, r_of, sels, bsels = self._select(
                pids, start, end, tables, bufs)
        name = "vmax" if column is None else f"vmax_{column}"
        vmax = max([float(t.columns[name][s].max(initial=0.0))
                    for (t, _), s in zip(tables, sels)]
                   + [float((b["vmax"][bs] if j is None else b["vmax"][bs, j]
                             ).max(initial=0.0))
                      for b, bs in zip(bufs, bsels)])
        return out, t_of, b_of, r_of, (vmax, self.values_exact(
            pids, start, end, column, paged))

    def values_exact(self, pids, start, end, column=None,
                     paged=None) -> bool:
        """Whether the pages hold every value of the chunks (resident, and
        ``paged``) and write buffers of ``pids`` that overlap [start, end]
        exactly: the lane gate, read from the flags made at seal and on the
        buffers before anything is packed. The caller holds the lock."""
        kind = self._kind(pids, column)
        tables = self._tables(kind, paged)
        sels = self._chunk_sel(self._row_of_pid(pids), start, end, tables)
        suffix = "" if column is None else f"_{column}"
        if not all(t.columns["exact" + suffix][s].all()
                   for (t, _), s in zip(tables, sels)):
            return False
        if kind is False:
            buf = self.buffer_meta()
            return bool(buf["exact"][self._buffer_sel(buf, pids, start,
                                                      end)].all())
        j = self._kind_columns(kind).index(column)
        return all(bool(b["exact"][self._buffer_sel(b, pids, start, end),
                                   j].all())
                   for b in self._kind_buffers(kind, False))

    def codec_chunks(self, table, idx: np.ndarray) -> tuple[list, np.ndarray]:
        """The serialized codec chunks of chunks ``idx`` of ``table``: a
        list of (positions in ``idx``, their ``ChunkBytes``) groups, the
        held ones a codec buffer at a time and the flushed ones read back
        from the column store; and the positions of the chunks the store
        no longer holds. The caller holds the lock."""
        col = table.columns
        held = col["pending"][idx]
        batch = col["cbatch"][idx]
        out = []
        for b in np.unique(batch[held]).tolist():
            pos = np.flatnonzero(held & (batch == b))
            out.append((pos, table.codec[b].take(col["cidx"][idx[pos]])))
        pos = np.flatnonzero(~held)
        if not len(pos):
            return out, pos
        flushed = idx[pos]
        pids = np.unique(col["pid"][flushed])
        pid_of = dict(zip(self.key_blobs(pids), pids.tolist()))
        found = {}
        for blob, data in self.column_store.read_chunk_rows(
                self.dataset, self.shard_num, list(pid_of),
                int(col["t0"][flushed].min()), int(col["t1"][flushed].max())):
            cid = int(np.frombuffer(bytes(data[:8]), np.int64)[0])
            found.setdefault((pid_of[bytes(blob)], cid), bytes(data))
        want = list(zip(col["pid"][flushed].tolist(),
                        col["cid"][flushed].tolist()))
        have = np.array([w in found for w in want], bool)
        if have.any():
            out.append((pos[have], ChunkBytes.from_blobs(
                [found[w] for w, h in zip(want, have) if h])))
        return out, pos[~have]

    def _samples(self, pids, start, end, column, paged) -> Samples:
        """The host-decode lane's samples of ``pids`` for [start, end]
        (``query/engine/batch.py``): the codec chunks of the chunks
        ``select_blocks`` would select, and copies of the write buffers
        that overlap the range. A chunk that was flushed to a store that no
        longer holds it gives its page values. Rows are indices in
        ``pids``. The caller holds the lock."""
        row_of_pid = self._row_of_pid(pids)
        kind = self._kind(pids, column)
        tables = self._tables(kind, paged)
        hist = kind is not False
        out = Samples(SCHEMAS[{False: "gauge", True: "prom-histogram",
                               "multi": MULTI_SCHEMA}[kind]],
                      self._kind_columns(kind).index(column) if hist else 0)
        for (table, _), sel in zip(tables, self._chunk_sel(
                row_of_pid, start, end, tables)):
            col = table.columns
            groups, lost = self.codec_chunks(table, sel)
            for pos, cb in groups:
                out.codec.append((cb, row_of_pid[col["pid"][sel[pos]]],
                                  col["cid"][sel[pos]]))
            if len(lost):
                out.decoded.append(self._page_values(
                    table, sel[lost], row_of_pid, start, out.column
                    if hist else None))
        bufs = {False: [self.buffers], True: list(self.hist_buffers.values()),
                "multi": [self.multi_buffers]}[kind]
        for buf, meta in zip(bufs, self._kind_buffers(kind, False)):
            rows = buf.rows(self._buffer_sel(meta, pids, start, end))
            n = buf.n[rows].astype(np.int64)
            vals = buf.vals[rows]
            if hist:
                cols = slot_columns if kind is True else multi_columns
                vals = np.ascontiguousarray(cols(vals)[..., out.column])
            out.decoded.append((
                row_of_pid[buf.pid_of[rows]], np.ones(len(rows), np.int64),
                np.zeros(len(rows), np.int64), buf.ts[rows], vals,
                np.arange(buf.ts.shape[1])[None, :] < n[:, None]))
        return out

    def exact_samples(self, pids: np.ndarray, start: int, end: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The value samples of scalar partitions ``pids`` (all of one
        kind: plain, or all ``ds-gauge``, whose value column is ``avg``)
        in [start, end], float64 as ingested: (rows in ``pids``, ts, vals),
        by row then time, from the codec chunks (paged in as a query pages
        them) and the write buffers, as remote read serves them."""
        from filodb_tpu_torch.core.downsample.downsampler import (
            _decoded_parts,
            _flatten,
        )

        pids = np.asarray(pids, np.int64)
        column = None
        if len(pids) and self.multi[pids[0]]:
            schema = SCHEMAS[MULTI_SCHEMA].data
            column = schema.columns[schema.value_column].name
        with self.lock:
            paged = self._page_in(pids, start, end)
            samples = self._samples(pids, start, end, column, paged)
        parts = [_decoded_parts(r, cb, samples.schema)
                 for cb, r, _ in samples.codec] + samples.decoded
        return _flatten(parts, len(pids), start, end)

    @staticmethod
    def _page_values(table, idx, row_of_pid, start: int, j):
        """``Samples.decoded`` entries of chunks ``idx`` from their
        float32 pages (plain decode on the host): the values left of a
        chunk flushed to a store that no longer holds it."""
        col = table.columns
        blocks = expand(col["blk0"][idx], col["nblk"][idx])
        offsets = np.asarray(table.offsets)
        seg = np.searchsorted(offsets, blocks, side="right") - 1
        pages = [p if j is None else p.column(j) for p in table.pages]
        packed, _ = pack_blocks(pages, seg, blocks - offsets[seg],
                                np.repeat(np.arange(len(idx)),
                                          col["nblk"][idx]), len(idx), start)
        ts, vals, live = decode_packed(to_device(packed, "cpu"), plain=True)
        n = len(idx)
        return (row_of_pid[col["pid"][idx]], np.zeros(n, np.int64),
                col["cid"][idx], ts[:n].numpy().astype(np.int64) + start,
                vals[:n].numpy().astype(np.float64), live[:n].numpy())

    def select_hist_blocks(self, pids: np.ndarray, start: int, end: int,
                           paged=None):
        """Page blocks of histogram partitions ``pids`` for [start, end],
        as ``select_blocks`` (for ``device_batch.pack_hist_blocks``), and
        the bucket scheme of the first selected chunk or buffer, in batch
        order, that has the most buckets (the reference's ``les_out``)."""
        bufs = self.hist_buffer_pages()
        tables = [(self._hist_sealed, None)] + ([] if paged is None
                                                else [paged[True]])
        out, t_of, b_of, r_of, sels, bsels = self._select(
            pids, start, end, tables, bufs)
        row_of_pid = np.full(self.num_partitions, -1, np.int64)
        row_of_pid[pids] = np.arange(len(pids))
        bsel = np.concatenate(bsels) if bsels else np.zeros(0, np.int64)
        chs = [(t.columns, s) for (t, _), s in zip(tables, sels)]
        # entries in batch order: by row, a row's chunks by chunk id first
        row = np.concatenate([row_of_pid[c["pid"][s]] for c, s in chs]
                             + [row_of_pid[bsel]])
        late = np.concatenate([np.zeros(len(s)) for _, s in chs]
                              + [np.ones(len(bsel))])
        cid = np.concatenate([c["cid"][s] for c, s in chs]
                             + [np.zeros(len(bsel), np.int64)])
        lid = np.concatenate([c["les"][s] for c, s in chs]
                             + [self._les_id[bsel]])
        if not len(lid):
            return out, t_of, b_of, r_of, None
        lid = lid[np.lexsort((cid, late, row))]
        width = np.array([len(self.les_list[i]) for i in lid])
        return out, t_of, b_of, r_of, self.les_list[int(
            lid[np.argmax(width)])]


def _container(raw: bytes) -> tuple[np.ndarray, int]:
    """A serialized v2 container's bytes and record count; raises
    ``ValueError`` on a malformed one (then nothing is ingested)."""
    if not raw or raw[0] != 2:
        raise ValueError(f"container version {raw[0] if raw else None}: the "
                         f"port reads version 2 only")
    buf = np.frombuffer(raw, np.uint8)
    nrec = struct.unpack_from("<I", raw, 1)[0] if len(raw) >= 5 else -1
    if nrec < 0 or not native_shard.NativeShardCore.validate(buf, nrec):
        raise ValueError("malformed record container")
    return buf, nrec


def _live_columns(table: ChunkTable) -> dict:
    col = table.columns
    live = ~col["dead"]
    return {n: v[live] for n, v in col.items()}


def _by_series(pids: np.ndarray, ts: np.ndarray, vals: np.ndarray):
    """Records (in order) of partitions ``pids`` as one row a partition:
    (distinct pids, ts [N, T], vals [N, T, ...], lens), each row's samples
    in record order."""
    order = np.argsort(pids, kind="stable")
    sp = pids[order]
    uniq, first, lens = np.unique(sp, return_index=True, return_counts=True)
    pos = np.arange(len(sp)) - np.repeat(first, lens)
    row = np.repeat(np.arange(len(uniq)), lens)
    T = int(lens.max(initial=1))
    ts2 = np.zeros((len(uniq), T), np.int64)
    ts2[row, pos] = ts[order]
    vals2 = np.zeros((len(uniq), T) + vals.shape[1:], vals.dtype)
    vals2[row, pos] = vals[order]
    return uniq, ts2, vals2, lens.astype(np.int64)


def _multi_records(raw: bytes, recs: np.ndarray):
    """(ts [n], values float64 [n, K]) of the multi-column records
    ``recs`` of a serialized container, in container order."""
    cols = parse_container(raw, width=_KCOL)
    return cols.ts[recs], cols.dvals[recs]
