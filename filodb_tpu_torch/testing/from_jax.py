"""Carry the JAX package's store state into the port's ``MemStore``.

The caller reads each partition of a ``filodb_tpu`` store out as numpy
(labels, decoded timestamps and values, the row count of each sealed
chunk in order; samples past the last chunk are its write buffer) and hands
the list here, in the order the reference created the partitions. Each
series is re-ingested chunk by chunk, sealing where the reference sealed,
so both stores hold the same chunks and so the same device pages. A
histogram series carries one ``HistogramColumn`` (bucket bounds and
cumulative count rows) per chunk, and one more for its write buffer, so a
series whose bucket scheme changed keeps each chunk's own, and its ``sum``
and ``count`` columns. This module imports nothing of ``filodb_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.memory.codecs import HistogramColumn


@dataclass
class SeriesState:
    schema: str
    labels: dict
    ts: np.ndarray           # int64 [n], ascending
    vals: np.ndarray | None  # float64 [n]; None for a histogram series
    chunk_rows: list[int]    # rows of each sealed chunk, in time order
    # histogram series: the chunks' columns in order, then the buffer's;
    # and the sum and count columns float64 [n] (None: not carried)
    hist: list[HistogramColumn] | None = None
    sums: np.ndarray | None = None
    counts: np.ndarray | None = None


def ingest_states(memstore: MemStore, states: list[SeriesState]) -> None:
    for st in states:
        rows = list(st.chunk_rows)
        if sum(rows) < len(st.ts):
            rows.append(len(st.ts) - sum(rows))  # the write buffer
        a = 0
        for i, n in enumerate(rows):
            seg = slice(a, a + n)
            if st.hist is not None:
                memstore.ingest_histogram(
                    st.labels, st.ts[seg], st.hist[i].rows, st.hist[i].les,
                    None if st.sums is None else st.sums[seg],
                    None if st.counts is None else st.counts[seg])
            else:
                memstore.ingest(st.labels, st.ts[seg], st.vals[seg],
                                schema=st.schema)
            if i < len(st.chunk_rows):
                memstore.seal(st.labels, schema=st.schema)
            a += n
