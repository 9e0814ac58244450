"""Part-key index of one shard: label filters → partition ids.

Port of the lookup half of ``filodb_tpu/core/memstore/index.py``
(``PartKeyIndex.part_ids_from_filters``, ``label_names`` and
``label_values``), for ``Equals``, ``NotEquals``,
``In``, ``EqualsRegex`` and ``NotEqualsRegex``, with the reference's
semantics: positive filters (equality, set membership, a regex that does
not match "") select partitions holding a matching value; the others are
evaluated against each value with an absent label read as "". The result
is the sorted ids whose [start, end] time range overlaps the query's.

Columnar instead of postings: each label keeps a value table and an int32
value id per partition (-1 = absent), so a filter is one vectorised
comparison over the shard's partitions and bulk ingest of a million keys
costs one dict lookup per label value.

A removed part key (``remove_part_keys``: a purged partition, or the old
entry of an evicted series that came back) leaves a hole: its pid is never
reused, holds no label, has both times at ``INGESTING`` as the reference's
tombstones do, and no lookup returns it. ``len`` counts the live entries.
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch.core.filters import (
    ColumnFilter,
    Equals,
    EqualsRegex,
    In,
)

INGESTING = 2**63 - 1  # end time of a partition still ingesting


class _LabelColumn:
    def __init__(self):
        self.values: list[str] = []
        self.ids: dict[str, int] = {}
        self.vid = np.full(0, -1, np.int32)

    def value_mask(self, match) -> np.ndarray:
        """bool [n_values + 1]: which value ids match, the last entry for
        an absent label (read as "")."""
        return np.array([match(v) for v in self.values] + [match("")], bool)


class PartKeyIndex:
    def __init__(self):
        self._labels: dict[str, _LabelColumn] = {}
        self._start = np.zeros(0, np.int64)
        self._end = np.zeros(0, np.int64)
        self._live = np.zeros(0, bool)
        self._n = 0
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def ram_bytes(self) -> int:
        """Approximate resident bytes of the index (``status/tsdb``'s
        ``indexRamBytes``): the time and liveness arrays, each label's
        value-id column and its values."""
        n = self._start.nbytes + self._end.nbytes + self._live.nbytes
        for col in self._labels.values():
            n += col.vid.nbytes + sum(64 + len(v) for v in col.values)
        return n

    def _grow(self, n: int) -> None:
        cap = len(self._start)
        if n <= cap:
            return
        new = max(n, 2 * cap, 1024)
        self._start = np.concatenate([self._start,
                                      np.full(new - cap, INGESTING)])
        self._end = np.concatenate([self._end, np.full(new - cap, INGESTING)])
        self._live = np.concatenate([self._live, np.zeros(new - cap, bool)])
        for col in self._labels.values():
            col.vid = np.concatenate([col.vid, np.full(new - cap, -1,
                                                       np.int32)])

    def add_part_keys(self, first_pid: int, label_sets: list,
                      start_times: np.ndarray) -> None:
        """Register partitions ``first_pid ..`` with their sorted label
        tuples and first sample times (end time: still ingesting)."""
        n = len(label_sets)
        if first_pid != self._n:
            raise ValueError("partition ids must be added in order")
        self._grow(first_pid + n)
        self._start[first_pid : first_pid + n] = start_times
        self._live[first_pid : first_pid + n] = True
        outs: dict[str, np.ndarray] = {}
        for i, labels in enumerate(label_sets):
            for k, v in labels:
                out = outs.get(k)
                if out is None:
                    out = outs[k] = np.full(n, -1, np.int32)
                    col = self._labels.get(k)
                    if col is None:
                        col = self._labels[k] = _LabelColumn()
                        col.vid = np.full(len(self._start), -1, np.int32)
                col = self._labels[k]
                vid = col.ids.get(v)
                if vid is None:
                    vid = col.ids[v] = len(col.values)
                    col.values.append(v)
                out[i] = vid
        for k, out in outs.items():
            self._labels[k].vid[first_pid : first_pid + n] = out
        self._n += n
        self._count += n

    def remove_part_keys(self, pids) -> None:
        """Remove partitions ``pids`` from the index for good (holes)."""
        pids = np.asarray(pids, np.int64)
        pids = pids[self._live[pids]]
        for col in self._labels.values():
            col.vid[pids] = -1
        self._start[pids] = INGESTING
        self._end[pids] = INGESTING
        self._live[pids] = False
        self._count -= len(pids)

    def pid_for_exact_key(self, labels, blob: bytes, blob_of,
                          exclude: int = -1) -> int | None:
        """A live pid other than ``exclude`` whose key has the sorted
        ``labels`` and the blob ``blob`` (``blob_of(pid)``), or None: the
        label equalities narrow the candidates and the blob rejects keys
        with more labels, as the reference's lookup does."""
        filters = [ColumnFilter(k, Equals(v)) for k, v in labels]
        for pid in self.part_ids_from_filters(filters, 0, INGESTING).tolist():
            if pid != exclude and blob_of(pid) == blob:
                return pid
        return None

    def start_times(self, pids: np.ndarray) -> np.ndarray:
        return self._start[pids]

    def end_times(self, pids: np.ndarray) -> np.ndarray:
        return self._end[pids]

    def set_end_times(self, pids: np.ndarray, end_times) -> None:
        self._end[pids] = end_times

    def set_start_times(self, pids: np.ndarray, start_times) -> None:
        self._start[pids] = start_times

    def _matches(self, f: ColumnFilter) -> np.ndarray:
        """bool [n]: partitions the filter keeps."""
        n = self._n
        col = self._labels.get(f.column)
        flt = f.filter
        positive = isinstance(flt, (Equals, In)) or (
            isinstance(flt, EqualsRegex) and not flt.matches(""))
        if col is None:
            # absent everywhere: only a filter matching "" keeps anything
            return np.full(n, not positive and flt.matches(""), bool)
        vid = col.vid[:n]
        if isinstance(flt, Equals):
            want = col.ids.get(flt.value)
            return vid == want if want is not None else np.zeros(n, bool)
        if isinstance(flt, In):
            want = [col.ids[v] for v in flt.values if v in col.ids]
            return np.isin(vid, want)
        table = col.value_mask(flt.matches)
        if positive:
            table[-1] = False
        return table[vid]  # vid -1 reads the absent entry

    def part_ids_from_filters(self, filters, start_time: int,
                              end_time: int) -> np.ndarray:
        keep = self._live[: self._n].copy()
        for f in filters:
            keep &= self._matches(f)
            if not keep.any():
                return np.zeros(0, np.int64)
        keep &= (self._start[: self._n] <= end_time) \
            & (self._end[: self._n] >= start_time)
        return np.flatnonzero(keep)

    def postings(self):
        """Yield (label, values, pids, counts) a label, labels sorted: the
        values some partition holds, sorted by their UTF-8 bytes, their
        partition ids value after value, each value's in order, and how
        many each value has, as the reference's index snapshot stores them
        (``FrozenLabel``)."""
        n = self._n
        for name in sorted(self._labels):
            col = self._labels[name]
            vid = col.vid[:n]
            pids = np.flatnonzero(vid >= 0)
            if not len(pids):
                continue
            enc = [v.encode() for v in col.values]
            order = sorted(range(len(enc)), key=enc.__getitem__)
            rank = np.empty(len(enc), np.int64)
            rank[order] = np.arange(len(enc))
            r = rank[vid[pids]]
            pids = pids[np.lexsort((pids, r))]
            counts = np.bincount(r, minlength=len(enc))  # by rank
            have = counts > 0
            yield (name, [enc[i] for i, h in zip(order, have) if h], pids,
                   counts[have])

    def restore(self, starts: np.ndarray, ends: np.ndarray,
                postings) -> None:
        """Load an empty index from ``starts`` / ``ends`` of n partitions
        and ``postings`` (label, value strings, pids, counts; as
        ``postings`` yields them)."""
        if self._n:
            raise ValueError("restore needs an empty index")
        n = len(starts)
        self._grow(n)
        self._start[:n] = starts
        self._end[:n] = ends
        # holes carry INGESTING start times (the reference's tombstones)
        self._live[:n] = np.asarray(starts) != INGESTING
        self._count = int(self._live[:n].sum())
        for name, values, pids, counts in postings:
            col = self._labels[name] = _LabelColumn()
            col.values = list(values)
            col.ids = {v: i for i, v in enumerate(col.values)}
            col.vid = np.full(len(self._start), -1, np.int32)
            col.vid[pids] = np.repeat(np.arange(len(values), dtype=np.int32),
                                      counts)
        self._n = n

    def label_names(self) -> list[str]:
        """The labels some partition holds, sorted."""
        return sorted(name for name, col in self._labels.items()
                      if (col.vid[: self._n] >= 0).any())

    def label_values(self, label: str, filters=None) -> list[str]:
        """The values of ``label`` among all partitions, or among those the
        filters select, sorted."""
        col = self._labels.get(label)
        if col is None:
            return []
        vid = col.vid[: self._n]
        if filters:
            vid = vid[self.part_ids_from_filters(filters, 0, INGESTING)]
        return sorted(col.values[i] for i in np.unique(vid[vid >= 0]))
