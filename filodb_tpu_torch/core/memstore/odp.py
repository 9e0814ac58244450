"""On-demand paging: pull flushed chunks back from the column store when a
query needs data that memory no longer holds.

Port of ``filodb_tpu/core/memstore/odp.py``. A partition needs paging when
its earliest resident sample is later than both the query start and its
index start time (its chunks were evicted, or it was restored index-only
after a restart). ``page_partitions`` reads the missing chunks of every
such partition of a batch in one column-store call, decodes them on the
host (``memory/chunk.py::decode_chunks``, the C++ codec), and encodes them
into device-page blocks with the encoders a sealed chunk uses
(``partition.encode_pages``): scalar pages, for histograms one int page
a bucket and the ``sum`` / ``count`` value pages, and for the multi-column
``ds-gauge`` schema the timestamp page and its five columns' values (a
column's float32 pages are encoded when a selection first reads it). A
paged chunk's pages are therefore the pages it had in memory, and those
of the reference's ``chunk_device_pages``.

A paged chunk keeps its summary (``memory/chunk.py``): read from the
chunk's ``SC01`` section where it has one, else made from the decoded
values (``chunk.read_summaries``); its codec chunk, which the host-decode
lane decodes again where float32 does not hold its values; and the flags
that say so (``exact*``, made from the decoded values as at seal). An
evicted partition (a paged shell) has nothing resident, so every query
over it pages its chunks in.

``DemandPagedChunkCache`` keeps the paged chunks of one shard as those
pages (a ``ChunkTable`` a kind), keyed (partition, chunk id), bounded as
the reference's cache is: ``max_chunks`` (10,000) a shard, the least
recently used dropped first. The bound is enforced before the next
page-in, so the chunks one query pages stay whole until its batch is
built (the reference's page-in likewise hands its caller every chunk it
read). It also remembers, per partition with nothing resident, the range
it covered, so a repeat inside it reads nothing from the store; an
eviction of any of the partition's chunks forgets it.
"""

from __future__ import annotations

import time
import weakref

import numpy as np

from filodb_tpu_torch.core.memstore.partition import (
    MULTI_COLUMNS,
    MULTI_SCHEMA,
    ChunkTable,
    abs_max_finite,
    encode_pages,
    exact_in_f32,
    hist_slots,
)
from filodb_tpu_torch.core.record import SCHEMA_NAMES
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.memory.chunk import (
    ChunkBytes,
    bucket_counts,
    decode_chunks,
    read_summaries,
)
from filodb_tpu_torch.utils.metrics import GaugeFn
from filodb_tpu_torch.utils.tracing import span

_NONE = np.iinfo(np.int64).max
# chunks decoded and encoded at once
_DECODE_CHUNKS = 65536


# chunks held across every live cache (every shard, raw and cold tiers),
# read at scrape time
_CACHES: "weakref.WeakSet[DemandPagedChunkCache]" = weakref.WeakSet()
odp_cache_chunks = GaugeFn("filodb_odp_cache_chunks",
                           lambda: sum(len(c) for c in list(_CACHES)))


def needs_paging(earliest_mem, index_start, query_start):
    """True where a partition's in-memory data does not reach back to the
    query start but the index says data exists there (elementwise)."""
    earliest_mem = np.asarray(earliest_mem)
    index_start = np.asarray(index_start)
    return np.where(earliest_mem == -1, index_start < 2**62,
                    (query_start < earliest_mem)
                    & (index_start < earliest_mem))


def _pair(pid: np.ndarray, cid: np.ndarray) -> np.ndarray:
    """(partition, chunk id) as one comparable value: a complex number,
    exact while both stay below 2^53 (chunk ids do until the year 2255)."""
    return np.asarray(pid, np.float64) + 1j * np.asarray(cid, np.float64)


class DemandPagedChunkCache:
    """Bounded per-shard cache of paged-in chunks (see the module)."""

    def __init__(self, max_chunks: int = 10_000):
        self.max_chunks = max_chunks
        self.tables = {False: ChunkTable("vmax", "exact", "used"),
                       True: ChunkTable("les", "vmax_sum", "vmax_count",
                                        "exact_sum", "exact_count", "used",
                                        schema="prom-histogram"),
                       "multi": ChunkTable(
                           *(f"vmax_{c}" for c in MULTI_COLUMNS),
                           *(f"exact_{c}" for c in MULTI_COLUMNS), "used",
                           schema=MULTI_SCHEMA)}
        self._cov = np.zeros((0, 2), np.int64)  # per pid: covered [lo, hi]
        self._tick = 0
        self.requests = 0      # partitions that needed paging
        self.range_hits = 0    # of them, served without a store read
        self.chunks_paged = 0  # chunks read, decoded and encoded
        self.bytes_read = 0    # their serialized bytes
        # host seconds spent reading the store, decoding chunks (C++) and
        # encoding their pages
        self.seconds = {"read": 0.0, "decode": 0.0, "encode": 0.0}
        _CACHES.add(self)

    def __len__(self) -> int:
        return sum(len(t.live()) for t in self.tables.values())

    def _coverage(self, P: int) -> np.ndarray:
        if len(self._cov) < P:
            self._cov = np.concatenate([self._cov, np.tile(
                [[_NONE, -_NONE]], (P - len(self._cov), 1))])
        return self._cov

    def _bound(self) -> None:
        """Drop the least recently used chunks past ``max_chunks`` and
        forget their partitions' covered ranges."""
        live = [(t, t.live()) for t in self.tables.values()]
        used = np.concatenate([t.columns["used"][rows] for t, rows in live])
        over = len(used) - self.max_chunks
        if over <= 0:
            return
        cut = np.sort(used)[over - 1]
        for t, rows in live:
            col = t.columns
            drop = rows[col["used"][rows] <= cut]
            col["dead"][drop] = True
            self._cov[col["pid"][drop]] = (_NONE, -_NONE)
            t.compact()

    def forget(self, pids: np.ndarray) -> None:
        """Forget the covered ranges of ``pids`` (purged or evicted)."""
        pids = pids[pids < len(self._cov)]
        self._cov[pids] = (_NONE, -_NONE)

    def _add(self, shard, pids: np.ndarray, cb: ChunkBytes) -> None:
        """Decode chunks ``cb`` of partitions ``pids`` and keep their
        pages."""
        schema = shard.schema_of[pids]
        for s in np.unique(schema).tolist():
            sch = SCHEMAS[SCHEMA_NAMES[s]]
            at = np.flatnonzero(schema == s)
            if sch.is_histogram:
                # one decode a bucket count
                nb = bucket_counts(cb.take(at), sch)
                groups = [at[nb == b] for b in np.unique(nb).tolist()]
            else:
                groups = [at]
            for g in groups:
                for a in range(0, len(g), _DECODE_CHUNKS):
                    part = g[a:a + _DECODE_CHUNKS]
                    t = time.perf_counter()
                    codec = cb.take(part)
                    d = decode_chunks(codec, sch)
                    summ = read_summaries(codec, sch, d)
                    self.seconds["decode"] += time.perf_counter() - t
                    self._add_decoded(shard, pids[part], d,
                                      "multi" if sch.is_multi
                                      else sch.is_histogram, summ, codec)

    def _add_decoded(self, shard, pids, d, hist, summ: dict,
                     codec: ChunkBytes) -> None:
        t = time.perf_counter()
        row = dict(pid=pids, seq=d.ids & 0xFFF, cid=d.ids, rows=d.rows,
                   t0=d.start, t1=d.end,
                   used=np.full(len(pids), self._tick, np.int64), **summ)
        if hist == "multi":
            slots = np.ascontiguousarray(d.dcols.transpose(0, 2, 1)).view(
                np.int64)
            pages, per = encode_pages(d.ts, slots, d.rows, multi=True)
            flags = {}
            for j, name in enumerate(MULTI_COLUMNS):
                flags[f"vmax_{name}"] = abs_max_finite(d.dcols[:, j], d.rows)
                flags[f"exact_{name}"] = exact_in_f32(d.dcols[:, j], d.rows)
            self.tables["multi"].add(pages, per, codec, **row, **flags)
        elif hist:
            slots = hist_slots(d.hist, d.dcols[:, 0], d.dcols[:, 1])
            pages, per = encode_pages(d.ts, slots, d.rows)
            uniq, inv = np.unique(d.les, axis=0, return_inverse=True)
            les = np.array([shard._scheme(u) for u in uniq],
                           np.int64)[inv.reshape(-1)]
            self.tables[True].add(
                pages, per, codec, **row, les=les,
                vmax_sum=abs_max_finite(d.dcols[:, 0], d.rows),
                vmax_count=abs_max_finite(d.dcols[:, 1], d.rows),
                exact_sum=exact_in_f32(d.dcols[:, 0], d.rows),
                exact_count=exact_in_f32(d.dcols[:, 1], d.rows))
        else:
            vals = d.dcols[:, 0]
            pages, per = encode_pages(d.ts, vals, d.rows)
            self.tables[False].add(pages, per, codec, **row,
                                   vmax=abs_max_finite(vals, d.rows),
                                   exact=exact_in_f32(vals, d.rows))
        self.chunks_paged += len(pids)
        self.seconds["encode"] += time.perf_counter() - t


def page_partitions(shard, pids: np.ndarray, start: int, end: int,
                    cache: DemandPagedChunkCache) -> dict | None:
    """Page in what partitions ``pids`` of ``shard`` need for [start, end]:
    → per kind (False: scalar, True: histogram, "multi") the cache's chunk
    table and
    the rows of it a batch selects (``Shard.select_blocks``'s ``paged``),
    or None when no partition needs paging. Reads the store once for the
    partitions the cache does not cover, and adds every chunk not resident
    and not cached; a page-in that adds chunks moves the shard's
    version. Traced as the reference's ``odp-page`` span."""
    with span("odp-page", shard=shard.shard_num):
        return _page_partitions(shard, pids, start, end, cache)


def _page_partitions(shard, pids, start: int, end: int,
                     cache: DemandPagedChunkCache) -> dict | None:
    pids = np.asarray(pids, np.int64)
    if not len(pids):
        return None
    need = needs_paging(shard.earliest_in_memory()[pids],
                        shard.index.start_times(pids), start)
    pids = pids[need]
    if not len(pids):
        return None
    cache._bound()
    cache._tick += 1
    cov = cache._coverage(shard.num_partitions)
    covered = (cov[pids, 0] <= start) & (end <= cov[pids, 1])
    cache.requests += len(pids)
    cache.range_hits += int(covered.sum())
    read = pids[~covered]
    if len(read):
        t = time.perf_counter()
        blobs = shard.key_blobs(read)
        rows = shard.column_store.read_chunk_rows(
            shard.dataset, shard.shard_num, blobs, start, end)
        cb = ChunkBytes.from_blobs([d for _, d in rows])
        cache.bytes_read += len(cb.buf)
        pid_of = dict(zip(blobs, read.tolist()))
        rpid = np.array([pid_of[b] for b, _ in rows], np.int64)
        cache.seconds["read"] += time.perf_counter() - t
        if rows:
            ids = cb.buf[cb.starts[:, None] + np.arange(8)].copy().view(
                np.int64)[:, 0]
            have = np.concatenate(
                [_pair(tab.columns["pid"][r], tab.columns["cid"][r])
                 for tab, r in _rows_of(read, shard, cache)])
            new = np.flatnonzero(~np.isin(_pair(rpid, ids), have))
            if len(new):
                cache._add(shard, rpid[new], cb.take(new))
                shard.version += 1
        resident = shard.earliest_in_memory()[read] != -1
        cov[read[~resident]] = (start, end)
    sel = {}
    for hist, t in cache.tables.items():
        col = t.columns
        mine = np.zeros(shard.num_partitions, bool)
        mine[pids] = True
        rows = np.flatnonzero(mine[col["pid"]] & ~col["dead"]
                              & (col["t1"] >= start) & (col["t0"] <= end))
        col["used"][rows] = cache._tick
        sel[hist] = (t, rows)
    return sel


def _rows_of(pids: np.ndarray, shard, cache):
    """(table, rows) of the resident and cached chunks of ``pids``."""
    want = np.zeros(shard.num_partitions, bool)
    want[pids] = True
    for t in (*shard._tables_all(), *cache.tables.values()):
        col = t.columns
        yield t, np.flatnonzero(want[col["pid"]] & ~col["dead"])
