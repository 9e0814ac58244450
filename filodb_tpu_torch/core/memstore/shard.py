"""One shard of the in-memory store: partitions, their sealed chunks with
device pages, and the selection of page blocks for a query.

Port of the parts of ``filodb_tpu/core/memstore/shard.py`` this slice runs:
partition creation (ids in creation order), columnar ingest, index lookup
with the time-range predicate, and the chunk selection of
``device_batch._query_chunks`` (chunks overlapping the range, then the
write buffer). A sealed chunk keeps its device pages, encoded once at seal
time (the reference's ``StoreConfig.device_pages=True``); the write buffers
are encoded when a query first needs them and kept until the shard next
ingests. NibblePack chunks, the WAL, flush and the column store are not
part of the port.

Histogram partitions (``ingest_histograms``) keep their own write buffers,
one per bucket count, their own chunk table and their own page tables: a
sealed chunk encodes one timestamp page plus one int page per bucket
(``HistPageBlocks``, as the reference's ``_hist_pages``) and a float32 XOR
value page of each of the schema's ``sum`` and ``count`` columns (the
reference's ``encode_f32_page`` of the column), beside the bucket pages and
over the same timestamp page. Each chunk records its bucket scheme
(``les``) as the partition held it at seal time. A column selector
(``h::sum``) selects those value pages as a scalar series
(``select_blocks(..., column="sum")``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from filodb_tpu_torch.core.memstore.index import PartKeyIndex
from filodb_tpu_torch.core.memstore.partition import (
    WriteBuffers,
    drop_out_of_order,
)
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.query.engine.device_batch import (
    HistPageBlocks,
    PageBlocks,
    chunk_blocks,
    hist_chunk_blocks,
)

# encode at most this many series' chunks per worker task, on this many
# threads (the card's host has 8 cores)
_ENCODE_ROWS = 4096
_ENCODE_WORKERS = 8
SCHEMA_NAMES = tuple(SCHEMAS)  # a partition's schema, by index
# the value columns a histogram sample carries beside its buckets
HIST_COLUMNS = ("sum", "count")
_NCOL = len(HIST_COLUMNS)


def hist_slots(counts: np.ndarray, sums, cnts) -> np.ndarray:
    """Histogram samples as one int64 [N, T, B + 2] array: the B cumulative
    bucket counts, then the float64 bit patterns of the sample's sum and
    count (NaN where not given), so that out-of-order drops and buffer
    appends move all three with their sample."""
    N, T = counts.shape[:2]
    cols = [np.full((N, T), np.nan) if c is None
            else np.asarray(c, np.float64).reshape(N, T)
            for c in (sums, cnts)]
    return np.concatenate([counts] + [np.ascontiguousarray(c).view(
        np.int64)[:, :, None] for c in cols], axis=2)


def slot_columns(slots: np.ndarray) -> np.ndarray:
    """The sum and count columns of histogram slots [..., B + 2] as float64
    [..., 2]."""
    return slots[..., -_NCOL:].view(np.float64)


def _abs_max_finite(vals: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Per row, the largest |value| among the first ``rows`` finite ones."""
    live = (np.arange(vals.shape[1])[None, :] < rows[:, None]) \
        & np.isfinite(vals)
    return np.where(live, np.abs(vals), 0.0).max(axis=1, initial=0.0)


def encode_chunks(ts: np.ndarray, vals: np.ndarray, rows: np.ndarray,
                  take: np.ndarray | None = None):
    """Device pages of many chunks (rows of samples, or of the rows
    ``take`` of the arrays): → (PageBlocks or HistPageBlocks, blocks a
    chunk). Values [C, T] give scalar pages, histogram slots [C, T, B + 2]
    (``hist_slots``) histogram pages. Large batches encode on a thread pool
    (numpy releases the interpreter lock inside its loops)."""
    n = len(rows) if take is None else len(take)
    hist = vals.ndim == 3
    step = max(1, _ENCODE_ROWS // (vals.shape[2] + 1)) if hist \
        else _ENCODE_ROWS
    spans = [(i, min(i + step, n)) for i in range(0, n, step)]

    def one(span):
        idx = slice(*span) if take is None else take[span[0]:span[1]]
        if hist:
            tb, cb, rb, per = hist_chunk_blocks(ts[idx], vals[idx],
                                                rows[idx])
            cols = cb[:, -_NCOL:].view(np.float64)
            return HistPageBlocks.encode(tb, cb[:, :-_NCOL], rb, cols), per
        tb, vb, rb, per = chunk_blocks(ts[idx], vals[idx], rows[idx])
        return PageBlocks.encode(tb, vb, rb), per

    if len(spans) > 1:
        with ThreadPoolExecutor(min(_ENCODE_WORKERS, len(spans))) as pool:
            parts = list(pool.map(one, spans))
    else:
        parts = [one(s) for s in spans]
    if not parts:
        return None, np.zeros(0, np.int64)
    table = HistPageBlocks if hist else PageBlocks
    return (table.concat([p for p, _ in parts]),
            np.concatenate([per for _, per in parts]))


def _expand(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Concatenated ranges first[i] .. first[i] + count[i] - 1."""
    count = count.astype(np.int64)
    before = np.cumsum(count) - count
    return np.repeat(first - before, count) + np.arange(int(count.sum()))


class ChunkTable:
    """Sealed chunks of one kind (scalar or histogram): their page tables,
    one a sealing, and one row a chunk in ``columns`` (pid, seq, blk0 and
    nblk: the chunk's blocks among all the tables' blocks, rows, t0, t1,
    and the kind's own columns ``extra``)."""

    def __init__(self, *extra: str):
        self.names = ("pid", "seq", "blk0", "nblk", "rows", "t0", "t1",
                      *extra)
        self.pages: list = []
        self.offsets: list[int] = [0]
        self._cols: list[dict] = []
        self._columns: dict | None = None

    def add(self, pages, per: np.ndarray, **cols) -> None:
        blk0 = self.offsets[-1] + np.concatenate([[0], np.cumsum(per)[:-1]])
        self.pages.append(pages)
        self.offsets.append(self.offsets[-1] + len(pages))
        self._cols.append(dict(blk0=blk0, nblk=per, **cols))
        self._columns = None

    @property
    def columns(self) -> dict:
        if self._columns is None:
            self._columns = {
                n: np.concatenate([c[n] for c in self._cols]) if self._cols
                else np.zeros(0, np.int64) for n in self.names}
        return self._columns


class Shard:
    def __init__(self, shard_num: int, max_chunk_size: int = 400):
        self.shard_num = shard_num
        self.max_chunk_size = max_chunk_size
        self.index = PartKeyIndex()
        self.keys: list[PartKey] = []
        self._by_key: dict[PartKey, int] = {}
        self.buffers = WriteBuffers(max_chunk_size)
        self.latest = np.zeros(0, np.int64)
        self.schema_of = np.zeros(0, np.int8)  # index into SCHEMA_NAMES
        self._seq = np.zeros(0, np.int64)  # next chunk sequence a partition
        self._sealed = ChunkTable("vmax")  # largest finite |value| a chunk
        self.version = 0
        self._buffer_pages = None  # (version, buffer_pages() dict)
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
        # count columns
        self._hist_sealed = ChunkTable("les", "vmax_sum", "vmax_count")
        self._hist_buffer_pages = None  # (version, [per bucket count])

    @property
    def num_partitions(self) -> int:
        return len(self.keys)

    # ---- ingest ------------------------------------------------------------

    def _partitions_for(self, keys: list[PartKey],
                        first_ts: np.ndarray) -> np.ndarray:
        pids = np.empty(len(keys), np.int64)
        new_keys, new_first = [], []
        for i, k in enumerate(keys):
            pid = self._by_key.get(k)
            if pid is None:
                pid = self._by_key[k] = len(self.keys) + len(new_keys)
                new_keys.append(k)
                new_first.append(first_ts[i])
            pids[i] = pid
        if new_keys:
            base = len(self.keys)
            self.keys.extend(new_keys)
            n = len(self.keys)
            if n > len(self.latest):
                grow = max(n, 2 * len(self.latest), 1024) - len(self.latest)
                self.latest = np.concatenate(
                    [self.latest, np.full(grow, -1, np.int64)])
                self._seq = np.concatenate(
                    [self._seq, np.zeros(grow, np.int64)])
                self.schema_of = np.concatenate(
                    [self.schema_of, np.zeros(grow, np.int8)])
                self.hist = np.concatenate([self.hist, np.zeros(grow, bool)])
                self._width = np.concatenate(
                    [self._width, np.zeros(grow, np.int64)])
                self._les_id = np.concatenate(
                    [self._les_id, np.full(grow, -1, np.int64)])
            self.schema_of[base:n] = [SCHEMA_NAMES.index(k.schema)
                                      for k in new_keys]
            self.index.add_part_keys(base, [k.labels for k in new_keys],
                                     np.asarray(new_first, np.int64))
        return pids

    def ingest(self, keys: list[PartKey], ts: np.ndarray, vals: np.ndarray,
               lens: np.ndarray) -> int:
        """Append series samples (row i: ``lens[i]`` samples of ``keys[i]``,
        distinct keys). Returns the samples kept."""
        if len(set(keys)) != len(keys):
            raise ValueError("one batch may hold each series once")
        first = np.where(lens > 0, ts[:, 0], -1)
        pids = self._partitions_for(keys, first)
        ts, vals, lens = drop_out_of_order(ts, vals, lens, self.latest[pids])
        for sealed in self.buffers.append(pids, ts, vals, lens):
            self._add_chunks(*sealed)
        has = lens > 0
        self.latest[pids[has]] = ts[has, np.maximum(lens[has] - 1, 0)]
        self.version += 1
        return int(lens.sum())

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
        B = slots.shape[2] - _NCOL
        first = np.where(lens > 0, ts[:, 0], -1)
        pids = self._partitions_for(keys, first)
        self.hist[pids] = True
        ts, slots, lens = drop_out_of_order(ts, slots, lens,
                                            self.latest[pids])
        act = pids[lens > 0]
        width = self._width[act]
        for old in np.unique(width[(width != B) & (width > 0)]):
            sealed = self.hist_buffers[int(old)].take(act[width == old])
            if len(sealed[0]):
                self._add_hist_chunks(*sealed)
        self._width[act] = B
        self._les_id[act] = self._scheme(les)
        buf = self.hist_buffers.get(B)
        if buf is None:
            buf = self.hist_buffers[B] = WriteBuffers(self.max_chunk_size,
                                                      B + _NCOL)
        for sealed in buf.append(pids, ts, slots, lens):
            self._add_hist_chunks(*sealed)
        has = lens > 0
        self.latest[pids[has]] = ts[has, np.maximum(lens[has] - 1, 0)]
        self.version += 1
        return int(lens.sum())

    def seal(self, pids: np.ndarray) -> None:
        """Close the write buffers of ``pids`` into chunks now."""
        pids = np.asarray(pids, np.int64)
        hist = self.hist[pids]
        if (~hist).any():
            sealed = self.buffers.take(pids[~hist])
            if len(sealed[0]):
                self._add_chunks(*sealed)
        hpids = pids[hist]
        for B in np.unique(self._width[hpids]):
            if B > 0:
                sealed = self.hist_buffers[int(B)].take(
                    hpids[self._width[hpids] == B])
                if len(sealed[0]):
                    self._add_hist_chunks(*sealed)
        self.version += 1

    def _add_chunks(self, pids, ts, vals, rows) -> None:
        pages, per = encode_chunks(ts, vals, rows)
        self._sealed.add(pages, per, **self._chunk_row(pids, ts, rows),
                         vmax=_abs_max_finite(vals, rows))

    def _add_hist_chunks(self, pids, ts, slots, rows) -> None:
        """Seal histogram buffers: pages, each chunk's scheme as its
        partition holds it now, and its sum and count columns' largest
        finite |value| (the precision gate's input)."""
        pages, per = encode_chunks(ts, slots, rows)
        cols = slot_columns(slots)
        self._hist_sealed.add(pages, per, **self._chunk_row(pids, ts, rows),
                              les=self._les_id[pids].copy(),
                              vmax_sum=_abs_max_finite(cols[..., 0], rows),
                              vmax_count=_abs_max_finite(cols[..., 1], rows))

    def _chunk_row(self, pids, ts, rows) -> dict:
        """The columns every sealed chunk has; takes the next sequence
        number of each partition."""
        seq = self._seq[pids].copy()
        self._seq[pids] += 1
        last = ts[np.arange(len(rows)), np.maximum(rows - 1, 0)]
        return dict(pid=pids, seq=seq, rows=rows, t0=ts[:, 0].copy(), t1=last)

    @property
    def chunks(self) -> dict:
        """Every sealed chunk, one entry per column (pid, seq, blk0, nblk,
        rows, t0, t1, vmax)."""
        return self._sealed.columns

    @property
    def hist_chunks(self) -> dict:
        """Every sealed histogram chunk (pid, seq, blk0, nblk, rows, t0, t1,
        les: its scheme's index in ``les_list``, vmax_sum, vmax_count)."""
        return self._hist_sealed.columns

    # ---- query -------------------------------------------------------------

    def lookup_partitions(self, filters, start: int, end: int) -> np.ndarray:
        return self.index.part_ids_from_filters(filters, start, end)

    @staticmethod
    def _buffer_table(buffers: WriteBuffers, P: int):
        """Device pages of the non-empty buffers, with per-pid arrays over
        the shard's P partitions (blk0 = -1 for an empty buffer, nblk, t0,
        t1); → (that dict, the buffers' occupied rows, their pids)."""
        rows = buffers.occupied()
        pids = buffers.pid_of[rows]
        pages, per = encode_chunks(buffers.ts, buffers.vals, buffers.n, rows)
        out = dict(pages=pages, blk0=np.full(P, -1, np.int64),
                   nblk=np.zeros(P, np.int64), t0=np.zeros(P, np.int64),
                   t1=np.zeros(P, np.int64))
        if len(rows):
            out["blk0"][pids] = np.concatenate([[0], np.cumsum(per)[:-1]])
            out["nblk"][pids] = per
            out["t0"][pids] = buffers.ts[rows, 0]
            out["t1"][pids] = buffers.ts[rows, buffers.n[rows] - 1]
        return out, rows, pids

    def buffer_pages(self):
        """Device pages of every non-empty scalar write buffer, encoded on
        first use after an ingest: a dict of the pages and of per-pid
        arrays (blk0 = -1 for an empty buffer, nblk, t0, t1, vmax)."""
        cached = self._buffer_pages
        if cached is not None and cached[0] == self.version:
            return cached[1]
        out, rows, pids = self._buffer_table(self.buffers,
                                             self.num_partitions)
        out["vmax"] = np.zeros(self.num_partitions)
        if len(rows):
            out["vmax"][pids] = _abs_max_finite(self.buffers.vals[rows],
                                                self.buffers.n[rows])
        self._buffer_pages = (self.version, out)
        return out

    def hist_buffer_pages(self) -> list[dict]:
        """``buffer_pages`` of the histogram buffers, one dict per bucket
        count; ``vmax`` [P, 2] is per column (sum, count)."""
        cached = self._hist_buffer_pages
        if cached is None or cached[0] != self.version:
            tables = []
            for b in self.hist_buffers.values():
                out, rows, pids = self._buffer_table(b, self.num_partitions)
                out["vmax"] = np.zeros((self.num_partitions, _NCOL))
                cols = slot_columns(b.vals[rows])
                for j in range(_NCOL):
                    out["vmax"][pids, j] = _abs_max_finite(cols[..., j],
                                                           b.n[rows])
                tables.append(out)
            cached = self._hist_buffer_pages = (self.version, tables)
        return cached[1]

    def _select(self, pids, start, end, sealed: ChunkTable, bufs,
                view=lambda pages: pages):
        """Page blocks of partitions ``pids`` (batch rows in that order)
        for [start, end]: chunks overlapping the range in sequence order,
        then the write buffer if it overlaps. → (tables, table_of,
        block_of, row_of) for the packer, the selected chunks' indices and
        each buffer table's selected pids."""
        row_of_pid = np.full(self.num_partitions, -1, np.int64)
        row_of_pid[pids] = np.arange(len(pids))
        ch = sealed.columns
        sel = np.flatnonzero((row_of_pid[ch["pid"]] >= 0)
                             & (ch["t1"] >= start) & (ch["t0"] <= end))
        sel = sel[np.lexsort((ch["seq"][sel], row_of_pid[ch["pid"][sel]]))]
        blocks = _expand(ch["blk0"][sel], ch["nblk"][sel])
        offsets = np.asarray(sealed.offsets)
        seg = np.searchsorted(offsets, blocks, side="right") - 1
        tables, table_of = [view(p) for p in sealed.pages], [seg]
        block_of = [blocks - offsets[seg]]
        row_of = [np.repeat(row_of_pid[ch["pid"][sel]], ch["nblk"][sel])]
        bsels = []
        for buf in bufs:
            bsel = pids[(buf["blk0"][pids] >= 0) & (buf["t1"][pids] >= start)
                        & (buf["t0"][pids] <= end)]
            bsels.append(bsel)
            if len(bsel):
                blocks = _expand(buf["blk0"][bsel], buf["nblk"][bsel])
                table_of.append(np.full(len(blocks), len(tables)))
                tables.append(view(buf["pages"]))
                block_of.append(blocks)
                row_of.append(np.repeat(row_of_pid[bsel], buf["nblk"][bsel]))
        row_of = np.concatenate(row_of)
        # chunk blocks come first and in sequence order: a stable sort by
        # row keeps each series' chunks in time order, its buffer last
        order = np.argsort(row_of, kind="stable")
        return (tables, np.concatenate(table_of)[order],
                np.concatenate(block_of)[order], row_of[order], sel, bsels)

    def select_blocks(self, pids: np.ndarray, start: int, end: int,
                      column: str | None = None):
        """Page blocks of scalar partitions ``pids`` (batch rows in that
        order) for [start, end], or with ``column`` (one of
        ``HIST_COLUMNS``) the value pages of that column of histogram
        partitions. Returns (tables, table_of, block_of, row_of, vmax) for
        ``device_batch.pack_blocks`` plus the largest |value| they hold."""
        if column is not None:
            j = HIST_COLUMNS.index(column)
            bufs = self.hist_buffer_pages()
            tables, t_of, b_of, r_of, sel, bsels = self._select(
                pids, start, end, self._hist_sealed, bufs,
                lambda pages: pages.column(j))
            vmax = max([float(self.hist_chunks[f"vmax_{column}"][sel].max(
                initial=0.0))] + [float(b["vmax"][bs, j].max(initial=0.0))
                                  for b, bs in zip(bufs, bsels)])
            return tables, t_of, b_of, r_of, vmax
        buf = self.buffer_pages()
        tables, t_of, b_of, r_of, sel, (bsel,) = self._select(
            pids, start, end, self._sealed, [buf])
        vmax = max(float(self.chunks["vmax"][sel].max(initial=0.0)),
                   float(buf["vmax"][bsel].max(initial=0.0)))
        return tables, t_of, b_of, r_of, vmax

    def select_hist_blocks(self, pids: np.ndarray, start: int, end: int):
        """Page blocks of histogram partitions ``pids`` for [start, end],
        as ``select_blocks`` (for ``device_batch.pack_hist_blocks``), and
        the bucket scheme of the first selected chunk or buffer, in batch
        order, that has the most buckets (the reference's ``les_out``)."""
        bufs = self.hist_buffer_pages()
        ch = self.hist_chunks
        tables, t_of, b_of, r_of, sel, bsels = self._select(
            pids, start, end, self._hist_sealed, bufs)
        row_of_pid = np.full(self.num_partitions, -1, np.int64)
        row_of_pid[pids] = np.arange(len(pids))
        bsel = np.concatenate(bsels) if bsels else np.zeros(0, np.int64)
        # entries in batch order: by row, a row's chunks by sequence first
        row = np.concatenate([row_of_pid[ch["pid"][sel]], row_of_pid[bsel]])
        late = np.concatenate([np.zeros(len(sel)), np.ones(len(bsel))])
        seq = np.concatenate([ch["seq"][sel], np.zeros(len(bsel))])
        lid = np.concatenate([ch["les"][sel], self._les_id[bsel]])
        if not len(lid):
            return tables, t_of, b_of, r_of, None
        lid = lid[np.lexsort((seq, late, row))]
        width = np.array([len(self.les_list[i]) for i in lid])
        return tables, t_of, b_of, r_of, self.les_list[int(
            lid[np.argmax(width)])]
