"""Write buffers of a shard's partitions, and where chunks seal.

Port of the ingest rule of ``filodb_tpu/core/memstore/partition.py``
(``TimeSeriesPartition.ingest`` / ``switch_buffers``), columnar: the
buffers of a shard's partitions are rows of one [rows, max_chunk_size]
array pair, a row handed to a partition when it first appends, and a batch
of series appends in a few vectorised rounds instead of one sample at a
time.

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
"""

from __future__ import annotations

import numpy as np


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
    cumulative bucket counts int64 [rows, M, B]."""

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

    def rows(self, pids: np.ndarray, create: bool = False) -> np.ndarray:
        """Rows of partitions ``pids`` (−1 where none); with ``create``,
        rows are handed out to those (distinct pids) that have none."""
        top = int(pids.max(initial=-1)) + 1
        if top > len(self.slot):
            grow = max(top, 2 * len(self.slot), 1024) - len(self.slot)
            self.slot = np.concatenate([self.slot,
                                        np.full(grow, -1, np.int64)])
        rows = self.slot[pids]
        new = pids[rows < 0] if create else pids[:0]
        if len(new):
            self._reserve(self.used + len(new))
            rows = rows.copy()
            rows[rows < 0] = self.slot[new] = np.arange(
                self.used, self.used + len(new))
            self.pid_of[self.used:self.used + len(new)] = new
            self.used += len(new)
        return rows

    def _reserve(self, n_rows: int) -> None:
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
        (pids, ts [C, M], vals [C, M(, B)], rows [C]) in sealing order."""
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
