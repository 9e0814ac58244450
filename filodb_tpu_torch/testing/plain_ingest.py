"""The container lane's numpy twin, which the tests hold the C++ ingest core
against (``core/memstore/native_shard.py``): the shard's container ingest
as it was before the core, records grouped per series with numpy
(``_by_series``), the out-of-order rule over whole rows
(``partition.drop_out_of_order``) and ``WriteBuffers.append_plain``,
which rewrites every touched buffer row whole.

``ingest_plain(shard, data)`` takes the place of ``shard.ingest(data)``;
``plain_appends()`` makes every ``WriteBuffers.append`` in its block the
numpy one (columnar ingest and histogram records included). Nothing on a
serving path reaches this module.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from filodb_tpu_torch.core.memstore.partition import WriteBuffers
from filodb_tpu_torch.core.memstore.shard import _by_series
from filodb_tpu_torch.core.record import SomeData, parse_container
from filodb_tpu_torch.core.store.api import pk_from_blob
from filodb_tpu_torch.utils.governor import record_tenant_drop


@contextmanager
def plain_appends():
    """``WriteBuffers.append`` is ``append_plain`` inside the block."""
    real = WriteBuffers.append
    WriteBuffers.append = WriteBuffers.append_plain
    try:
        yield
    finally:
        WriteBuffers.append = real


def ingest_plain(shard, data: SomeData) -> int:
    """``shard.ingest(data)`` through the numpy twins."""
    cols = parse_container(data.container.serialize())
    with plain_appends(), shard.lock:
        kept, skipped = _ingest_columns(shard, cols, data.offset)
    shard.stats.rows_ingested.inc(kept)
    shard.stats.rows_skipped.inc(skipped)
    return kept


def _ingest_columns(shard, cols, offset: int) -> tuple[int, int]:
    group = cols.part_hash.astype(np.int64) % shard.config.groups_per_shard
    below = offset <= shard.group_watermarks[group]
    skipped = int(below.sum())
    shard.rows_skipped += skipped
    idx = np.flatnonzero(~below & (cols.schema >= 0))
    kept = 0
    if len(idx):
        pids = _pids_of_blobs(shard, [cols.keys[i] for i in idx.tolist()],
                              cols.ts[idx])
        idx, pids = idx[pids >= 0], pids[pids >= 0]
        hist = shard.hist[pids]
        if (~hist).any():
            s = idx[~hist]
            kept += shard._append(*_by_series(pids[~hist], cols.ts[s],
                                              cols.dvals[s, 0]))
        if hist.any():
            kept += shard._ingest_hist_records(cols, idx[hist], pids[hist])
    shard._ingested_offset = max(shard._ingested_offset, offset)
    return kept, skipped


def _pids_of_blobs(shard, blobs: list[bytes], ts: np.ndarray) -> np.ndarray:
    """Partition ids of records' part-key blobs (repeats allowed; a new
    key's partition starts at its first record's time); the records of a
    key over its tenant quota get -1 and are counted dropped."""
    pids = shard.core.lookup(blobs)
    miss = np.flatnonzero(pids < 0)
    if len(miss):
        first: dict[bytes, int] = {}
        for i in miss.tolist():
            first.setdefault(blobs[i], i)
        at = np.array(list(first.values()), np.int64)
        shard._new_partitions(list(first), ts[at])
        pids[miss] = shard.core.lookup([blobs[i] for i in miss.tolist()])
        for i in np.flatnonzero(pids < 0).tolist():
            shard.stats.quota_dropped.inc()
            record_tenant_drop(pk_from_blob(blobs[i]).label_map)
    return pids
