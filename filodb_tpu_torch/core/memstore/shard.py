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
part of this slice.
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
from filodb_tpu_torch.query.engine.device_batch import (
    PageBlocks,
    chunk_blocks,
)

# encode at most this many series' chunks per worker task, on this many
# threads (the card's host has 8 cores)
_ENCODE_ROWS = 4096
_ENCODE_WORKERS = 8


def _abs_max_finite(vals: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Per row, the largest |value| among the first ``rows`` finite ones."""
    live = (np.arange(vals.shape[1])[None, :] < rows[:, None]) \
        & np.isfinite(vals)
    return np.where(live, np.abs(vals), 0.0).max(axis=1, initial=0.0)


def encode_chunks(ts: np.ndarray, vals: np.ndarray, rows: np.ndarray):
    """Device pages of many chunks (rows of samples): → (PageBlocks, blocks
    a chunk). Large batches encode on a thread pool (numpy releases the
    interpreter lock inside its loops)."""
    spans = [(i, min(i + _ENCODE_ROWS, len(rows)))
             for i in range(0, len(rows), _ENCODE_ROWS)]

    def one(span):
        a, b = span
        tb, vb, rb, per = chunk_blocks(ts[a:b], vals[a:b], rows[a:b])
        return PageBlocks.encode(tb, vb, rb), per

    if len(spans) > 1:
        with ThreadPoolExecutor(min(_ENCODE_WORKERS, len(spans))) as pool:
            parts = list(pool.map(one, spans))
    else:
        parts = [one(s) for s in spans]
    if not parts:
        return None, np.zeros(0, np.int64)
    return (PageBlocks.concat([p for p, _ in parts]),
            np.concatenate([per for _, per in parts]))


def _expand(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Concatenated ranges first[i] .. first[i] + count[i] - 1."""
    count = count.astype(np.int64)
    before = np.cumsum(count) - count
    return np.repeat(first - before, count) + np.arange(int(count.sum()))


class Shard:
    def __init__(self, shard_num: int, max_chunk_size: int = 400):
        self.shard_num = shard_num
        self.max_chunk_size = max_chunk_size
        self.index = PartKeyIndex()
        self.keys: list[PartKey] = []
        self._by_key: dict[PartKey, int] = {}
        self.buffers = WriteBuffers(max_chunk_size)
        self.latest = np.zeros(0, np.int64)
        self._seq = np.zeros(0, np.int64)  # next chunk sequence a partition
        # sealed chunks: one row each, in page-table segments
        self._chunk_cols: list[dict] = []
        self._chunks: dict | None = None
        self.pages: list[PageBlocks] = []
        self._page_offsets: list[int] = [0]
        self.version = 0
        self._buffer_pages = None  # (version, buffer_pages() dict)

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
            self.buffers.grow(n)
            cap = len(self.buffers.n)
            self.latest = np.concatenate(
                [self.latest, np.full(cap - len(self.latest), -1, np.int64)])
            self._seq = np.concatenate(
                [self._seq, np.zeros(cap - len(self._seq), np.int64)])
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

    def seal(self, pids: np.ndarray) -> None:
        """Close the write buffers of ``pids`` into chunks now."""
        sealed = self.buffers.take(np.asarray(pids, np.int64))
        if len(sealed[0]):
            self._add_chunks(*sealed)
        self.version += 1

    def _add_chunks(self, pids, ts, vals, rows) -> None:
        pages, per = encode_chunks(ts, vals, rows)
        blk0 = self._page_offsets[-1] + np.concatenate(
            [[0], np.cumsum(per)[:-1]])
        self.pages.append(pages)
        self._page_offsets.append(self._page_offsets[-1] + len(pages))
        last = ts[np.arange(len(rows)), np.maximum(rows - 1, 0)]
        self._chunk_cols.append(dict(
            pid=pids, seq=self._seq[pids].copy(), blk0=blk0, nblk=per,
            rows=rows, t0=ts[:, 0].copy(), t1=last,
            vmax=_abs_max_finite(vals, rows)))
        self._seq[pids] += 1
        self._chunks = None

    @property
    def chunks(self) -> dict:
        """Every sealed chunk, one entry per column (pid, seq, blk0, nblk,
        rows, t0, t1, vmax)."""
        if self._chunks is None:
            names = ("pid", "seq", "blk0", "nblk", "rows", "t0", "t1",
                     "vmax")
            self._chunks = {
                n: np.concatenate([c[n] for c in self._chunk_cols])
                if self._chunk_cols else np.zeros(0, np.int64)
                for n in names}
        return self._chunks

    # ---- query -------------------------------------------------------------

    def lookup_partitions(self, filters, start: int, end: int) -> np.ndarray:
        return self.index.part_ids_from_filters(filters, start, end)

    def buffer_pages(self):
        """Device pages of every non-empty write buffer, encoded on first
        use after an ingest: a dict of the pages and of per-pid arrays
        (blk0 = -1 for an empty buffer, nblk, t0, t1, vmax)."""
        cached = self._buffer_pages
        if cached is not None and cached[0] == self.version:
            return cached[1]
        n = self.buffers.n[: self.num_partitions]
        pids = np.flatnonzero(n > 0)
        pages, per = encode_chunks(self.buffers.ts[pids],
                                   self.buffers.vals[pids], n[pids])
        P = self.num_partitions
        blk0 = np.full(P, -1, np.int64)
        nblk = np.zeros(P, np.int64)
        t0 = np.zeros(P, np.int64)
        t1 = np.zeros(P, np.int64)
        vmax = np.zeros(P)
        if len(pids):
            blk0[pids] = np.concatenate([[0], np.cumsum(per)[:-1]])
            nblk[pids] = per
            t0[pids] = self.buffers.ts[pids, 0]
            t1[pids] = self.buffers.ts[pids, n[pids] - 1]
            vmax[pids] = _abs_max_finite(self.buffers.vals[pids], n[pids])
        out = dict(pages=pages, blk0=blk0, nblk=nblk, t0=t0, t1=t1,
                   vmax=vmax)
        self._buffer_pages = (self.version, out)
        return out

    def select_blocks(self, pids: np.ndarray, start: int, end: int):
        """Page blocks of partitions ``pids`` (batch rows in that order)
        for [start, end]: chunks overlapping the range in sequence order,
        then the write buffer if it overlaps. Returns (tables, table_of,
        block_of, row_of, vmax) for ``device_batch.pack_blocks`` plus the
        largest |value| they hold."""
        row_of_pid = np.full(self.num_partitions, -1, np.int64)
        row_of_pid[pids] = np.arange(len(pids))
        ch = self.chunks
        sel = np.flatnonzero((row_of_pid[ch["pid"]] >= 0)
                             & (ch["t1"] >= start) & (ch["t0"] <= end))
        sel = sel[np.lexsort((ch["seq"][sel], row_of_pid[ch["pid"][sel]]))]
        blocks = _expand(ch["blk0"][sel], ch["nblk"][sel])
        seg = np.searchsorted(self._page_offsets, blocks, side="right") - 1
        table_of = [seg]
        block_of = [blocks - np.asarray(self._page_offsets)[seg]]
        row_of = [np.repeat(row_of_pid[ch["pid"][sel]], ch["nblk"][sel])]
        vmax = float(ch["vmax"][sel].max(initial=0.0))
        buf = self.buffer_pages()
        bsel = pids[(buf["blk0"][pids] >= 0) & (buf["t1"][pids] >= start)
                    & (buf["t0"][pids] <= end)]
        if len(bsel):
            blocks = _expand(buf["blk0"][bsel], buf["nblk"][bsel])
            table_of.append(np.full(len(blocks), len(self.pages)))
            block_of.append(blocks)
            row_of.append(np.repeat(row_of_pid[bsel], buf["nblk"][bsel]))
            vmax = max(vmax, float(buf["vmax"][bsel].max()))
        row_of = np.concatenate(row_of)
        # chunk blocks come first and in sequence order: a stable sort by
        # row keeps each series' chunks in time order, its buffer last
        order = np.argsort(row_of, kind="stable")
        tables = self.pages + [buf["pages"]]
        return (tables, np.concatenate(table_of)[order],
                np.concatenate(block_of)[order], row_of[order], vmax)
