"""Carry the JAX package's store state into the port's ``MemStore``.

The caller reads each partition of a ``filodb_tpu`` store out as numpy
(labels, decoded timestamps and values, the row count of each sealed
chunk in order; samples past the last chunk are its write buffer) and hands
the list here, in the order the reference created the partitions. Each
series is re-ingested chunk by chunk, sealing where the reference sealed,
so both stores hold the same chunks and so the same device pages. This
module imports nothing of ``filodb_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from filodb_tpu_torch.core.memstore.memstore import MemStore


@dataclass
class SeriesState:
    schema: str
    labels: dict
    ts: np.ndarray           # int64 [n], ascending
    vals: np.ndarray         # float64 [n]
    chunk_rows: list[int]    # rows of each sealed chunk, in time order


def ingest_states(memstore: MemStore, states: list[SeriesState]) -> None:
    for st in states:
        a = 0
        for rows in st.chunk_rows:
            memstore.ingest(st.labels, st.ts[a : a + rows],
                            st.vals[a : a + rows], schema=st.schema)
            memstore.seal(st.labels, schema=st.schema)
            a += rows
        if a < len(st.ts):
            memstore.ingest(st.labels, st.ts[a:], st.vals[a:],
                            schema=st.schema)
