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
        self._n = 0

    def _grow(self, n: int) -> None:
        cap = len(self._start)
        if n <= cap:
            return
        new = max(n, 2 * cap, 1024)
        self._start = np.concatenate([self._start,
                                      np.full(new - cap, INGESTING)])
        self._end = np.concatenate([self._end, np.full(new - cap, INGESTING)])
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
        keep = np.ones(self._n, bool)
        for f in filters:
            keep &= self._matches(f)
            if not keep.any():
                return np.zeros(0, np.int64)
        keep &= (self._start[: self._n] <= end_time) \
            & (self._end[: self._n] >= start_time)
        return np.flatnonzero(keep)

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
