"""The downsample read store: queries served from the column store.

Port of ``filodb_tpu/core/downsample/dsstore.py``. The reference's
``DownsampledTimeSeriesShard`` keeps a part-key index bootstrapped from the
persisted part keys and reads each partition's chunks from the column
store per query. The port's is a read-only ``Shard`` of the ds dataset
(``ReadOnlyShard``): its index is recovered from ``scan_part_keys`` (as a
restarted shard recovers its own), it ingests nothing, and every chunk a
query needs pages in through the shard's ``DemandPagedChunkCache``
(``core/memstore/odp.py``), so a leaf over it runs the page lane (B1-B4),
the host-decode lane, the batch cache and the budgets as over any shard.
The same class serves the cold raw tier (``query/federation.py``).

A read-only shard refreshes its index from the store on first use, and
with ``refresh_s`` again once that many seconds have passed (the cold
tier's periodic refresh; the reference's ds shard refreshes once). A
refresh that finds new part keys or moved end times forgets the ODP
ranges of the partitions it touched and moves ``data_version``, the
stamp a tiered planner folds into the extent cache's key
(``version_token``), and ``version``, which the batch cache reads.
"""

from __future__ import annotations

import time

import numpy as np

from filodb_tpu_torch.core.downsample.downsampler import ds_dataset_name
from filodb_tpu_torch.core.memstore.odp import DemandPagedChunkCache
from filodb_tpu_torch.core.memstore.shard import Shard
from filodb_tpu_torch.core.store.api import ColumnStore
from filodb_tpu_torch.core.store.config import StoreConfig

DOWNSAMPLE = "downsample"


class ReadOnlyShard(Shard):
    """A shard over a dataset's persisted part keys and chunks: no
    ingest, the index from the store, the chunks paged on demand. ``tier``
    names the tier it serves (the sidecar lane bypasses such shards)."""

    def __init__(self, shard_num: int, dataset: str,
                 column_store: ColumnStore, tier: str,
                 max_chunks: int = 10_000, refresh_s: float | None = None,
                 max_chunk_size: int = 400):
        super().__init__(shard_num, StoreConfig(
            max_chunk_size=max_chunk_size, demand_paging_enabled=True),
            dataset=dataset, column_store=column_store)
        self.tier = tier
        self.odp_cache = DemandPagedChunkCache(max_chunks=max_chunks)
        self.refresh_s = refresh_s
        self.data_version = 0
        self._refreshed_at: float | None = None

    def refresh_index(self) -> int:
        """Read the store's part keys: new ones become partitions, and every
        one's end time is the stored one. Returns the partitions added."""
        recs = self.column_store.scan_part_keys(self.dataset, self.shard_num)
        with self.lock:
            blobs = [r.part_key.serialized for r in recs]
            have = self.core.lookup(blobs)
            new = np.flatnonzero(have < 0)
            if len(new):
                pids = self._create([recs[i].part_key for i in new.tolist()],
                                    np.array([recs[i].start_time for i in
                                              new.tolist()], np.int64))
                self._dirty[pids] = False
            pids = self.core.lookup(blobs)
            ends = np.array([r.end_time for r in recs], np.int64)
            moved = self.index.end_times(pids) != ends
            moved[new] = True
            if moved.any():
                self.index.set_end_times(pids[moved], ends[moved])
                self.odp_cache.forget(pids[moved])
                self.version += 1
                self.data_version += 1
            self._refreshed_at = time.monotonic()
            return len(new)

    def _maybe_refresh(self) -> None:
        at = self._refreshed_at
        if at is None or (self.refresh_s is not None
                          and time.monotonic() - at > self.refresh_s):
            self.refresh_index()

    def lookup_partitions(self, filters, start: int, end: int) -> np.ndarray:
        self._maybe_refresh()
        return super().lookup_partitions(filters, start, end)

    def ingest(self, *args, **kwargs) -> int:
        raise TypeError(f"the {self.tier} tier's shards are read-only")

    ingest_series = ingest_histograms = ingest


class ReadOnlyStore:
    """A store-shaped facade over read-only shards for the exec layer: a
    leaf with ``store`` set reads ``store.shards[n]``."""

    def __init__(self, column_store: ColumnStore, dataset: str,
                 num_shards: int, tier: str, max_chunks: int = 10_000,
                 refresh_s: float | None = None):
        self.column_store = column_store
        self.dataset = dataset
        self.num_shards = num_shards
        self.tier = tier
        self.shards = [ReadOnlyShard(s, dataset, column_store, tier,
                                     max_chunks, refresh_s)
                       for s in range(num_shards)]

    @property
    def data_version(self) -> int:
        return sum(s.data_version for s in self.shards)

    def refresh(self) -> None:
        for s in self.shards:
            s._maybe_refresh()

    def refresh_index(self) -> int:
        return sum(s.refresh_index() for s in self.shards)

    @property
    def num_partitions(self) -> int:
        return sum(s.num_partitions for s in self.shards)


class DownsampledTimeSeriesStore(ReadOnlyStore):
    """The ds dataset of one resolution (``<dataset>_ds_<minutes>m``) as
    read-only shards; refreshed once, on first use, as the reference's."""

    def __init__(self, column_store: ColumnStore, dataset: str,
                 resolution_ms: int, num_shards: int,
                 max_chunks: int = 10_000):
        self.resolution_ms = resolution_ms
        self.ds_dataset = ds_dataset_name(dataset, resolution_ms)
        super().__init__(column_store, self.ds_dataset, num_shards,
                         DOWNSAMPLE, max_chunks)
