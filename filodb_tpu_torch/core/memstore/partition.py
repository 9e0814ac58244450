"""Write buffers of a shard's partitions, and where chunks seal.

Port of the ingest rule of ``filodb_tpu/core/memstore/partition.py``
(``TimeSeriesPartition.ingest`` / ``switch_buffers``), columnar: the
buffers of every partition of a shard are rows of one [partitions,
max_chunk_size] array pair, and a batch of series appends in a few
vectorised rounds instead of one sample at a time.

Semantics kept from the reference:

- a sample whose timestamp is not after the partition's latest one is
  dropped (out-of-order or duplicate);
- a buffer seals into a chunk the moment it holds ``max_chunk_size``
  samples, so chunk boundaries (and so device pages) come out where the
  reference puts them;
- ``seal`` closes a partial buffer early (the reference's flush), which is
  how chunks of another length arise.
"""

from __future__ import annotations

import numpy as np


def drop_out_of_order(ts: np.ndarray, vals: np.ndarray, lens: np.ndarray,
                      latest: np.ndarray):
    """Keep, per row, the samples whose timestamp passes every earlier one
    and ``latest``; → (ts, vals, lens) with the kept samples moved left."""
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
            np.take_along_axis(vals, order, 1), keep.sum(1))


class WriteBuffers:
    """Columnar write buffers: row ``pid`` holds partition ``pid``'s
    unsealed samples, ``n[pid]`` of them."""

    def __init__(self, max_chunk_size: int):
        self.max_chunk_size = max_chunk_size
        self.ts = np.zeros((0, max_chunk_size), np.int64)
        self.vals = np.zeros((0, max_chunk_size), np.float64)
        self.n = np.zeros(0, np.int32)

    def grow(self, n_parts: int) -> None:
        cap = len(self.n)
        if n_parts <= cap:
            return
        new = max(n_parts, 2 * cap, 1024)
        M = self.max_chunk_size
        self.ts = np.concatenate([self.ts, np.zeros((new - cap, M),
                                                    np.int64)])
        self.vals = np.concatenate([self.vals, np.zeros((new - cap, M))])
        self.n = np.concatenate([self.n, np.zeros(new - cap, np.int32)])

    def append(self, pids: np.ndarray, ts: np.ndarray, vals: np.ndarray,
               lens: np.ndarray):
        """Append ``lens[i]`` samples of row i to partition ``pids[i]``
        (distinct pids). Yields each batch of chunks sealed on the way, as
        (pids, ts [C, M], vals [C, M], rows [C]) in sealing order."""
        M = self.max_chunk_size
        T = ts.shape[1]
        taken = np.zeros(len(pids), np.int64)
        lane = np.arange(M)[None, :]
        while True:
            rem = lens - taken
            act = np.flatnonzero(rem > 0)
            if not len(act):
                return
            p = pids[act]
            n0 = self.n[p].astype(np.int64)
            take = np.minimum(rem[act], M - n0)
            src = taken[act][:, None] + lane - n0[:, None]
            put = (lane >= n0[:, None]) & (lane < (n0 + take)[:, None])
            src = np.clip(src, 0, T - 1)
            self.ts[p] = np.where(put, np.take_along_axis(ts[act], src, 1),
                                  self.ts[p])
            self.vals[p] = np.where(put,
                                    np.take_along_axis(vals[act], src, 1),
                                    self.vals[p])
            self.n[p] = n0 + take
            taken[act] += take
            full = p[self.n[p] == M]
            if len(full):
                yield self.take(full)

    def take(self, pids: np.ndarray):
        """Seal the non-empty buffers of ``pids``: their contents, emptied."""
        pids = pids[self.n[pids] > 0]
        out = (pids, self.ts[pids].copy(), self.vals[pids].copy(),
               self.n[pids].copy())
        self.n[pids] = 0
        return out
