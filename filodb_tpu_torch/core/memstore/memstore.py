"""The in-memory store: shards, and series routed to them.

Port of ``filodb_tpu/core/memstore/memstore.py`` with the shard routing of
``filodb_tpu/coordinator/ingestion.py::route_container``: a series' shard
takes its upper bits from the hash of its shard-key labels (``_ws_``,
``_ns_``, ``_metric_``) and its low ``spread`` bits from the hash of its
whole part key, so one namespace's series land in 2^spread shards.

Ingest is columnar: ``ingest_series`` takes many series at once as label
maps plus [N, T] timestamp and value arrays, routes them with hashes
computed for all keys together, and appends per shard in vectorised
rounds; ``ingest_histograms`` does the same for ``prom-histogram`` series
with cumulative bucket counts [N, T, B] under one bucket scheme, and each
sample's ``sum`` and ``count`` (the schema's other two columns). It is host
code; the device sees only the sealed pages.

Durability (``TimeSeriesMemStore``'s streams): the store is built on a
column store and a meta store (in-memory ones by default;
``core/store/localstore.py`` for disk). ``ingest_stream`` ingests a shard's
containers from the log with a group flush every ``flush_stagger``
containers; ``flush_all`` flushes every group of every shard;
``recover_index`` and ``recovery_start_offset`` restore a restarted
store's partitions and watermarks, and ``recover_stream`` replays the log
from there.
"""

from __future__ import annotations

import time
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from filodb_tpu_torch.core.memstore.partition import hist_slots
from filodb_tpu_torch.core.memstore.shard import Shard
from filodb_tpu_torch.core.record import SomeData
from filodb_tpu_torch.core.store.api import (
    ColumnStore,
    InMemoryColumnStore,
    InMemoryMetaStore,
    MetaStore,
)
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.core.partkey import (
    PartKey,
    ingestion_shard,
    murmur3_32_many,
    shard_key_hash,
)
from filodb_tpu_torch.core.schemas import SCHEMAS

# series appended to the shards per round of ``ingest_series``
_INGEST_ROWS = 65536


class MemStore:
    """``num_shards`` shards of one dataset. ``max_chunk_size``, when given,
    overrides the config's."""

    def __init__(self, num_shards: int = 4, spread: int = 1,
                 max_chunk_size: int | None = None,
                 column_store: ColumnStore | None = None,
                 meta_store: MetaStore | None = None,
                 config: StoreConfig | None = None,
                 dataset: str = "timeseries"):
        if num_shards & (num_shards - 1):
            raise ValueError("num_shards must be a power of 2")
        self.num_shards = num_shards
        self.spread = spread
        config = config or StoreConfig()
        if max_chunk_size is not None:
            config = StoreConfig(**{**config.__dict__,
                                    "max_chunk_size": max_chunk_size})
        self.config = config
        self.dataset = dataset
        self.column_store = column_store or InMemoryColumnStore()
        self.meta_store = meta_store or InMemoryMetaStore()
        # open every shard's store connections here, before any flush
        # thread does
        self.column_store.initialize(dataset, num_shards)
        for s in range(num_shards):
            self.meta_store.read_checkpoints(dataset, s)
        self.shards = [Shard(s, config, dataset, self.column_store,
                             self.meta_store) for s in range(num_shards)]
        self._skh: dict[tuple, int] = {}

    @property
    def version(self) -> int:
        return sum(s.version for s in self.shards)

    def shard_of(self, keys: list[PartKey]) -> np.ndarray:
        """Owning shard of every key."""
        skh = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys):
            labels = k.label_map
            sk = tuple(labels.get(n, "") for n in
                       SCHEMAS[k.schema].part.shard_key_labels)
            h = self._skh.get(sk)
            if h is None:
                names = SCHEMAS[k.schema].part.shard_key_labels
                h = self._skh[sk] = shard_key_hash(dict(zip(names, sk)))
            skh[i] = h
        ph = murmur3_32_many([k.serialized for k in keys]).astype(np.int64)
        return ingestion_shard(skh, ph, self.num_shards, self.spread)

    def ingest_series(self, labels: list[dict], ts: np.ndarray,
                      vals: np.ndarray, lens: np.ndarray | None = None,
                      schema: str = "prom-counter") -> int:
        """Ingest N series: ``labels[i]`` (with ``_metric_``), timestamps
        int64 ms [N, T] (ascending) and values [N, T]; ``lens[i]`` of each
        row are samples (default: all T). Returns the samples kept."""
        if schema not in SCHEMAS or SCHEMAS[schema].is_histogram:
            raise ValueError(f"ingest_series takes a scalar schema, not "
                             f"{schema} (known: {sorted(SCHEMAS)}; "
                             f"histograms go through ingest_histograms)")
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        if ts.ndim != 2 or ts.shape != vals.shape or len(labels) != len(ts):
            raise ValueError("ingest_series takes N label maps and [N, T] "
                             "timestamps and values")
        return self._routed(labels, ts, vals, lens, schema,
                            lambda shard, *a: shard.ingest_series(*a))

    def ingest_histograms(self, labels: list[dict], ts: np.ndarray,
                          buckets: np.ndarray, les: np.ndarray,
                          lens: np.ndarray | None = None, sums=None,
                          counts=None) -> int:
        """Ingest N ``prom-histogram`` series: ``labels[i]`` (with
        ``_metric_``), timestamps int64 ms [N, T] (ascending), cumulative
        bucket counts int64 [N, T, B] under the bucket upper bounds ``les``
        float64 [B] (the last one +Inf), and each sample's sum and count,
        float64 [N, T] (NaN if not given: ``h::sum`` then selects no
        sample); ``lens[i]`` of each row are samples (default: all T).
        Returns the samples kept."""
        ts = np.asarray(ts, np.int64)
        buckets = np.asarray(buckets, np.int64)
        les = np.asarray(les, np.float64)
        if ts.ndim != 2 or buckets.shape[:2] != ts.shape \
                or buckets.ndim != 3 or len(labels) != len(ts) \
                or les.shape != buckets.shape[2:] \
                or any(c is not None and np.shape(c) != ts.shape
                       for c in (sums, counts)):
            raise ValueError("ingest_histograms takes N label maps, [N, T] "
                             "timestamps, [N, T, B] bucket counts, [B] "
                             "bucket bounds and [N, T] sums and counts")
        slots = hist_slots(buckets, sums, counts)
        return self._routed(labels, ts, slots, lens, "prom-histogram",
                            lambda shard, *a: shard.ingest_histograms(
                                *a, les))

    def _routed(self, labels, ts, vals, lens, schema: str, append) -> int:
        """Route rows to their shards and ``append(shard, keys, ts, vals,
        lens)`` each shard's rows, ``_INGEST_ROWS`` series a round."""
        lens = np.full(len(ts), ts.shape[1], np.int64) if lens is None \
            else np.asarray(lens, np.int64)
        kept = 0
        for a in range(0, len(labels), _INGEST_ROWS):
            b = min(a + _INGEST_ROWS, len(labels))
            keys = [PartKey.create(schema, lb) for lb in labels[a:b]]
            shard = self.shard_of(keys)
            for s in np.unique(shard):
                rows = np.flatnonzero(shard == s)
                kept += append(self.shards[int(s)], [keys[i] for i in rows],
                               ts[a:b][rows], vals[a:b][rows],
                               lens[a:b][rows])
        return kept

    def ingest(self, labels: dict, ts, vals,
               schema: str = "prom-counter") -> int:
        """Ingest one series' samples."""
        ts = np.asarray(ts, np.int64)[None, :]
        return self.ingest_series([labels], ts,
                                  np.asarray(vals, np.float64)[None, :],
                                  schema=schema)

    def ingest_histogram(self, labels: dict, ts, buckets, les, sums=None,
                         counts=None) -> int:
        """Ingest one histogram series' samples ([T], [T, B], [B], and the
        sums and counts [T])."""
        def row(c):
            return None if c is None else np.asarray(c, np.float64)[None, :]

        return self.ingest_histograms(
            [labels], np.asarray(ts, np.int64)[None, :],
            np.asarray(buckets, np.int64)[None, :], les, sums=row(sums),
            counts=row(counts))

    def seal(self, labels: dict, schema: str = "prom-counter") -> None:
        """Close one series' write buffer into a chunk now."""
        key = PartKey.create(schema, labels)
        shard = self.shards[int(self.shard_of([key])[0])]
        pid = shard.lookup_keys([key.serialized])
        if pid[0] >= 0:
            shard.seal(pid)

    # ---- the log, flush and recovery ---------------------------------------

    def ingest_stream(self, shard: int, stream: Iterable[SomeData],
                      flush_stagger: int | None = None) -> int:
        """Ingest a shard's containers from the log, flushing the next
        group (round robin) every ``flush_stagger`` containers. Returns the
        samples kept."""
        s = self.shards[shard]
        total = since = 0
        for data in stream:
            total += s.ingest(data)
            since += 1
            if flush_stagger and since >= flush_stagger:
                s.flush_group(s.next_flush_group())
                since = 0
        return total

    def recover_stream(self, shard: int, stream: Iterable[SomeData],
                       checkpoint_interval: int = 0) -> Iterator[int]:
        """Replay a shard's log from its recovery start, yielding the offset
        every ``checkpoint_interval`` containers and the latest at the
        end."""
        s = self.shards[shard]
        n = 0
        for data in stream:
            s.ingest(data)
            n += 1
            if checkpoint_interval and n % checkpoint_interval == 0:
                yield data.offset
        yield s.latest_offset

    def recover_index(self, shard: int) -> int:
        return self.shards[shard].recover_index()

    def recovery_start_offset(self, shard: int) -> int:
        return self.shards[shard].setup_watermarks_for_recovery()

    def flush_all(self, ingestion_time: int | None = None) -> int:
        """Flush every group of every shard, ``flush_task_parallelism``
        shards at once. Returns the chunks written."""
        now = int(time.time() * 1000) if ingestion_time is None \
            else ingestion_time
        with ThreadPoolExecutor(max(self.config.flush_task_parallelism,
                                    1)) as pool:
            return sum(pool.map(lambda s: s.flush_all(now), self.shards))

    def close(self) -> None:
        """Close the column store and the meta store."""
        self.column_store.close()
        self.meta_store.close()

    def label_names(self) -> list[str]:
        """Label names over every shard, sorted (the reference's
        ``TimeSeriesMemStore.label_names``)."""
        return sorted(set().union(*(s.label_names() for s in self.shards)))

    def label_values(self, label: str, filters=None) -> list[str]:
        """Values of ``label`` over every shard (among the partitions the
        filters select, if any), sorted."""
        return sorted(set().union(*(s.label_values(label, filters)
                                    for s in self.shards)))
