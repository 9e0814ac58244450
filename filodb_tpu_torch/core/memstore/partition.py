"""Write buffers of a shard's partitions, and where chunks seal.

Port of the ingest rule of ``filodb_tpu/core/memstore/partition.py``
(``TimeSeriesPartition.ingest`` / ``switch_buffers``), columnar: the
buffers of a shard's partitions are rows of one [rows, max_chunk_size]
array pair, a row handed to a partition when it first appends. A batch of
series appends in a few rounds of one C++ call each
(``native_shard.append_round``), which writes only the new samples; the
container lane appends one record at a time in C++ into the same rows
(``native_shard.NativeShardCore.ingest``). ``WriteBuffers.append_plain``
is the numpy twin the tests hold them against.

Semantics kept from the reference:

- a sample whose timestamp is not after the partition's latest one is
  dropped (out-of-order or duplicate);
- a buffer seals into a chunk the moment it holds ``max_chunk_size``
  samples, so chunk boundaries (and so device pages) come out where the
  reference puts them;
- ``seal`` closes a partial buffer early (the reference's flush), which is
  how chunks of another length arise.

Histogram partitions keep their samples in buffers of their own, one per
bucket count: cumulative counts int64 [rows, max_chunk_size, B]
(``WriteBuffers(max_chunk_size, buckets=B)``), rows for the histograms of
that bucket count only. A series whose bucket count
changes seals its buffer first, as the reference's partition does
(``TimeSeriesPartition.ingest``); the shard decides that.

A sealed chunk lives in a ``ChunkTable``: its device pages (encoded once,
on a thread pool: ``encode_pages``) and, until its flush group is written
to the column store, its codec chunk (``memory/chunk.py``, encoded from
the same float64 rows: the pages hold float32 values, which cannot be
decoded back to what the store must keep). Each chunk also records
whether its pages hold its values exactly (``exact_in_f32``): a query over
chunks that do not reads their float64 values from the codec chunks (the
host-decode lane, ``query/engine/batch.py``). An evicted chunk is marked
dead and its pages go at the table's next compaction.
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch.core.memstore import native_shard
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.memory.chunk import (
    SKETCH_BUCKETS,
    STATS_WIDTH,
    ChunkBytes,
    encode_pool,
    summary_kinds,
    summary_sections,
)
from filodb_tpu_torch.query.engine.device_batch import (
    HistPageBlocks,
    MultiPageBlocks,
    PageBlocks,
    chunk_blocks,
    hist_chunk_blocks,
    multi_chunk_blocks,
)

# encode at most this many series' chunks per worker task, on the
# encoders' pool (``memory/chunk.py::encode_pool``, 8 threads: the card's
# host has 8 cores)
_ENCODE_ROWS = 4096
# the value columns a histogram sample carries beside its buckets
HIST_COLUMNS = ("sum", "count")
_NCOL = len(HIST_COLUMNS)
# the schema of several DOUBLE value columns (the downsample tier's), and
# its columns: its partitions keep their samples as K float64 bit
# patterns a sample (``WriteBuffers(max_chunk_size, buckets=K)``)
MULTI_SCHEMA = "ds-gauge"
MULTI_COLUMNS = tuple(c.name for c in SCHEMAS[MULTI_SCHEMA].data.columns[1:])


def _along(idx: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Sample indices [N, T'] shaped to gather along axis 1 of ``a``
    ([N, T] or [N, T, B])."""
    return idx.reshape(idx.shape + (1,) * (a.ndim - 2))


def drop_out_of_order(ts: np.ndarray, vals: np.ndarray, lens: np.ndarray,
                      latest: np.ndarray):
    """Keep, per row, the samples whose timestamp passes every earlier one
    and ``latest``; → (ts, vals, lens) with the kept samples moved left.
    ``vals`` is [N, T] or, for histograms, [N, T, B]."""
    T = ts.shape[1]
    live = np.arange(T)[None, :] < lens[:, None]
    floor = np.maximum.accumulate(np.where(live, ts, np.iinfo(np.int64).min),
                                  axis=1)
    prior = np.concatenate([latest[:, None], floor[:, :-1]], axis=1)
    keep = live & (ts > np.maximum(prior, latest[:, None]))
    if (keep == live).all():
        return ts, vals, lens
    order = np.argsort(~keep, axis=1, kind="stable")
    return (np.take_along_axis(ts, order, 1),
            np.take_along_axis(vals, _along(order, vals), 1), keep.sum(1))


class WriteBuffers:
    """Columnar write buffers of the partitions that have written to them:
    partition ``pid`` owns row ``slot[pid]`` (−1: none yet) of the arrays,
    ``n[row]`` unsealed samples in it; ``pid_of[row]`` maps back. Rows are
    handed out on a partition's first append, so a shard's histogram
    buffers hold rows for its histograms only, and its scalar buffers none
    for them. Values are float64 [rows, M], or with ``buckets`` B
    cumulative bucket counts int64 [rows, M, B]. A row that ``free``
    gives back (a purged or evicted partition's) goes to the next
    partition that needs one."""

    def __init__(self, max_chunk_size: int, buckets: int | None = None):
        self.max_chunk_size = max_chunk_size
        self.ts = np.zeros((0, max_chunk_size), np.int64)
        self.vals = np.zeros((0, max_chunk_size), np.float64) \
            if buckets is None \
            else np.zeros((0, max_chunk_size, buckets), np.int64)
        self.n = np.zeros(0, np.int32)
        self.slot = np.zeros(0, np.int64)
        self.pid_of = np.zeros(0, np.int64)
        self.used = 0
        self._free = np.zeros(0, np.int64)

    def cover(self, n_pids: int) -> None:
        """Grow ``slot`` to hold pids below ``n_pids``."""
        if n_pids > len(self.slot):
            grow = max(n_pids, 2 * len(self.slot), 1024) - len(self.slot)
            self.slot = np.concatenate([self.slot,
                                        np.full(grow, -1, np.int64)])

    def rows(self, pids: np.ndarray, create: bool = False) -> np.ndarray:
        """Rows of partitions ``pids`` (−1 where none); with ``create``,
        rows are handed out to those (distinct pids) that have none."""
        self.cover(int(pids.max(initial=-1)) + 1)
        rows = self.slot[pids]
        new = pids[rows < 0] if create else pids[:0]
        if len(new):
            reuse, self._free = self._free[:len(new)], self._free[len(new):]
            fresh = len(new) - len(reuse)
            self.reserve(self.used + fresh)
            got = np.concatenate([reuse, np.arange(self.used,
                                                   self.used + fresh)])
            self.used += fresh
            rows = rows.copy()
            rows[rows < 0] = self.slot[new] = got
            self.pid_of[got] = new
        return rows

    @property
    def free_rows(self) -> np.ndarray:
        """Rows given back, handed out first."""
        return self._free

    def handed_out(self, used: int, from_free: int) -> None:
        """The container pass handed out the first ``from_free`` free rows
        and fresh rows up to ``used``."""
        self.used = used
        self._free = self._free[from_free:]

    def free(self, pids: np.ndarray) -> None:
        """Drop the unsealed samples of ``pids`` and give their rows
        back."""
        rows = self.rows(np.asarray(pids, np.int64))
        have = rows >= 0
        rows = rows[have]
        self.n[rows] = 0
        self.slot[np.asarray(pids, np.int64)[have]] = -1
        self._free = np.concatenate([self._free, rows])

    def holding(self, pids: np.ndarray) -> np.ndarray:
        """bool [len(pids)]: which of ``pids`` hold unsealed samples."""
        rows = self.rows(np.asarray(pids, np.int64))
        out = rows >= 0
        out[out] = self.n[rows[out]] > 0
        return out

    def reserve(self, n_rows: int) -> None:
        """Room for ``n_rows`` rows in all (the container pass hands rows
        out of the free list and then ``used .. capacity - 1``)."""
        cap = len(self.n)
        if n_rows <= cap:
            return
        grow = max(n_rows, 2 * cap, 1024) - cap
        self.ts = np.concatenate([self.ts, np.zeros(
            (grow, self.max_chunk_size), np.int64)])
        self.vals = np.concatenate([self.vals, np.zeros(
            (grow,) + self.vals.shape[1:], self.vals.dtype)])
        self.n = np.concatenate([self.n, np.zeros(grow, np.int32)])
        self.pid_of = np.concatenate([self.pid_of,
                                      np.zeros(grow, np.int64)])

    def occupied(self) -> np.ndarray:
        """Rows that hold unsealed samples."""
        return np.flatnonzero(self.n[:self.used] > 0)

    def append(self, pids: np.ndarray, ts: np.ndarray, vals: np.ndarray,
               lens: np.ndarray):
        """Append ``lens[i]`` samples of row i to partition ``pids[i]``
        (distinct pids). Yields each batch of chunks sealed on the way, as
        (pids, ts [C, M], vals [C, M(, B)], rows [C]) in sealing order.
        Rounds of one C++ call write the new samples only; a round ends
        where rows fill, and those seal together."""
        rows = np.full(len(pids), -1, np.int64)
        live = lens > 0
        rows[live] = self.rows(pids[live], create=True)
        ts = np.ascontiguousarray(ts, np.int64)
        vals = np.ascontiguousarray(vals, self.vals.dtype)
        lens = np.ascontiguousarray(lens, np.int64)
        taken = np.zeros(len(pids), np.int64)
        full = np.empty(len(pids), np.int64)
        while True:
            nf = native_shard.append_round(self, rows, taken, lens, ts, vals,
                                           full)
            if not nf:
                return
            yield self._take_rows(full[:nf].copy())

    def append_plain(self, pids: np.ndarray, ts: np.ndarray,
                     vals: np.ndarray, lens: np.ndarray):
        """``append``'s numpy twin (the tests hold the C++ rounds against
        it): every round rewrites each touched row whole."""
        M = self.max_chunk_size
        T = ts.shape[1]
        rows = np.full(len(pids), -1, np.int64)
        live = lens > 0
        rows[live] = self.rows(pids[live], create=True)
        taken = np.zeros(len(pids), np.int64)
        lane = np.arange(M)[None, :]
        while True:
            rem = lens - taken
            act = np.flatnonzero(rem > 0)
            if not len(act):
                return
            r = rows[act]
            n0 = self.n[r].astype(np.int64)
            take = np.minimum(rem[act], M - n0)
            src = taken[act][:, None] + lane - n0[:, None]
            put = (lane >= n0[:, None]) & (lane < (n0 + take)[:, None])
            src = np.clip(src, 0, T - 1)
            self.ts[r] = np.where(put, np.take_along_axis(ts[act], src, 1),
                                  self.ts[r])
            self.vals[r] = np.where(
                _along(put, vals),
                np.take_along_axis(vals[act], _along(src, vals), 1),
                self.vals[r])
            self.n[r] = n0 + take
            taken[act] += take
            full = self.n[r] == M
            if full.any():
                yield self._take_rows(r[full])

    def take(self, pids: np.ndarray):
        """Seal the non-empty buffers of ``pids``: their contents, emptied,
        as (pids, ts, vals, rows)."""
        rows = self.rows(pids)
        return self._take_rows(rows[rows >= 0])

    def _take_rows(self, rows: np.ndarray):
        rows = rows[self.n[rows] > 0]
        out = (self.pid_of[rows], self.ts[rows].copy(),
               self.vals[rows].copy(), self.n[rows].copy())
        self.n[rows] = 0
        return out


def _empty(name: str) -> np.ndarray:
    """A column of an empty chunk table."""
    if name.startswith("stats_"):
        return np.zeros((0, STATS_WIDTH), np.float64)
    if name.startswith("sketch_"):
        return np.zeros((0, SKETCH_BUCKETS), np.uint16)
    boolean = name in ("dead", "pending") or name.startswith("exact")
    return np.zeros(0, bool if boolean else np.int64)


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


def multi_columns(slots: np.ndarray) -> np.ndarray:
    """The float64 columns [..., K] of multi-column slots (their bit
    patterns as int64)."""
    return np.ascontiguousarray(slots).view(np.float64)


def abs_max_finite(vals: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Per row, the largest |value| among the first ``rows`` finite ones."""
    live = (np.arange(vals.shape[1])[None, :] < rows[:, None]) \
        & np.isfinite(vals)
    return np.where(live, np.abs(vals), 0.0).max(axis=1, initial=0.0)


def exact_in_f32(vals: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Per row, whether each of the first ``rows`` values survives float64
    → float32 → float64: the pages then hold it exactly. NaN survives; a
    finite value past float32's range does not."""
    live = np.arange(vals.shape[1])[None, :] < rows[:, None]
    with np.errstate(over="ignore"):
        back = vals.astype(np.float32).astype(np.float64)
    return ((back == vals) | np.isnan(vals) | ~live).all(axis=1)


def encode_pages(ts: np.ndarray, vals: np.ndarray, rows: np.ndarray,
                 take: np.ndarray | None = None, multi: bool = False):
    """Device pages of many chunks (rows of samples, or of the rows
    ``take`` of the arrays): → (PageBlocks, HistPageBlocks or
    MultiPageBlocks, blocks a chunk). Values [C, T] give scalar pages,
    histogram slots [C, T, B + 2] (``hist_slots``) histogram pages, and
    with ``multi`` multi-column slots [C, T, K] multi-column pages. Large
    batches encode on a thread pool (numpy releases the interpreter lock
    inside its loops)."""
    n = len(rows) if take is None else len(take)
    if multi:
        if not n:
            return None, np.zeros(0, np.int64)
        idx = slice(None) if take is None else take
        tb, vb, rb, per = multi_chunk_blocks(ts[idx],
                                             multi_columns(vals[idx]),
                                             rows[idx])
        return MultiPageBlocks.encode(tb, vb, rb), per
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
        parts = list(encode_pool().map(one, spans))
    else:
        parts = [one(s) for s in spans]
    if not parts:
        return None, np.zeros(0, np.int64)
    table = HistPageBlocks if hist else PageBlocks
    return (table.concat([p for p, _ in parts]),
            np.concatenate([per for _, per in parts]))


def expand(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Concatenated ranges first[i] .. first[i] + count[i] - 1."""
    count = count.astype(np.int64)
    before = np.cumsum(count) - count
    return np.repeat(first - before, count) + np.arange(int(count.sum()))


class ChunkTable:
    """Chunks of one kind (scalar or histogram): their page tables, one a
    sealing, and one row a chunk in ``columns``: pid, seq, cid (the chunk
    id), blk0 and nblk (the chunk's blocks among all the tables' blocks),
    rows, t0, t1, nbytes (its codec vectors' length), dead (evicted: its
    pages go at the next ``compact``), cbatch, cidx and pending (its codec
    chunk, ``codec[cbatch]``'s chunk ``cidx``, is held: it awaits its
    flush, or was paged in; ``compact`` drops the codec buffers no kept
    chunk uses), the summary of each scalar column ``c`` of the kind's
    schema (``stats_c`` float64 [12] and ``sketch_c`` uint16 [64],
    ``memory/chunk.py``), and the kind's own columns ``extra``."""

    def __init__(self, *extra: str, schema: str = "gauge"):
        sch = SCHEMAS[schema]
        self.kinds = summary_kinds(sch)
        self.summarized = [c.name for c, k in zip(sch.data.columns,
                                                  self.kinds)
                           if k is not None]
        summ = [f"{p}_{c}" for c in self.summarized for p in ("stats",
                                                             "sketch")]
        self.names = ("pid", "seq", "cid", "blk0", "nblk", "rows", "t0", "t1",
                      "nbytes", "dead", "cbatch", "cidx", "pending", *summ,
                      *extra)
        self.pages: list = []
        self.offsets: list[int] = [0]
        self.codec: dict[int, ChunkBytes] = {}
        self._batches = 0
        self._cols: list[dict] = []
        self._columns: dict | None = None

    def add(self, pages, per: np.ndarray, codec: ChunkBytes | None,
            **cols) -> None:
        n = len(per)
        blk0 = self.offsets[-1] + np.cumsum(per) - per
        batch = -1
        if codec is not None:
            batch = self._batches
            self.codec[batch] = codec
            self._batches += 1
        self.pages.append(pages)
        self.offsets.append(self.offsets[-1] + len(pages))
        self._cols.append(dict(
            blk0=blk0.astype(np.int64), nblk=per, dead=np.zeros(n, bool),
            cbatch=np.full(n, batch, np.int64), cidx=np.arange(n),
            pending=np.full(n, codec is not None),
            nbytes=codec.nbytes if codec is not None
            else np.zeros(n, np.int64), **cols))
        self._columns = None

    @property
    def columns(self) -> dict:
        """Every chunk's columns; writable in place (dead, pending)."""
        if self._columns is None:
            self._columns = {
                n: np.concatenate([c[n] for c in self._cols]) if self._cols
                else _empty(n) for n in self.names}
            self._cols = [self._columns]
        return self._columns

    def live(self) -> np.ndarray:
        return np.flatnonzero(~self.columns["dead"])

    def codec_rows(self, idx: np.ndarray) -> list[memoryview]:
        """The serialized codec chunks of chunks ``idx`` (pending ones)."""
        col = self.columns
        return [self.codec[b].data(i) for b, i in
                zip(col["cbatch"][idx].tolist(), col["cidx"][idx].tolist())]

    def sections(self, idx: np.ndarray) -> np.ndarray:
        """The ``SC01`` summary sections of chunks ``idx``, uint8 [n, L]."""
        col = self.columns
        return summary_sections(
            self.kinds, [col[f"stats_{c}"][idx] for c in self.summarized],
            [col[f"sketch_{c}"][idx] for c in self.summarized])

    def flushed(self, idx: np.ndarray) -> None:
        """Chunks ``idx`` are in the column store: drop their codec chunks.
        A codec buffer goes when none of its chunks is pending, and is
        copied down to the pending ones once they hold under half of it."""
        col = self.columns
        col["pending"][idx] = False
        for b in np.unique(col["cbatch"][idx]).tolist():
            mine = np.flatnonzero((col["cbatch"] == b) & col["pending"])
            cb = self.codec[b]
            if not len(mine):
                del self.codec[b]
                continue
            keep = col["cidx"][mine]
            if 2 * int((cb.ends[keep] - cb.starts[keep]).sum()) \
                    < len(cb.buf):
                self.codec[b] = cb.take(keep).copy()
                col["cidx"][mine] = np.arange(len(mine))

    def compact(self) -> None:
        """Drop the dead chunks' rows and pages."""
        col = self.columns
        keep = np.flatnonzero(~col["dead"])
        if len(keep) == len(col["dead"]):
            return
        blocks = expand(col["blk0"][keep], col["nblk"][keep])
        offsets = np.asarray(self.offsets)
        seg = np.searchsorted(offsets, blocks, side="right") - 1
        parts = [self.pages[s].take(blocks[seg == s] - offsets[s])
                 for s in np.unique(seg).tolist()]
        self._columns = {n: col[n][keep] for n in self.names}
        self._cols = [self._columns]
        nblk = self._columns["nblk"]
        self._columns["blk0"] = (np.cumsum(nblk) - nblk).astype(np.int64)
        self.pages = [type(parts[0]).concat(parts)] if parts else []
        self.offsets = [0, int(nblk.sum())] if parts else [0]
        kept = set(np.unique(self._columns["cbatch"]).tolist())
        for b in [b for b in self.codec if b not in kept]:
            del self.codec[b]
