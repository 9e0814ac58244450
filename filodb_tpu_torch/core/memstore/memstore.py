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
with cumulative bucket counts [N, T, B] under one bucket scheme. It is host
code; the device sees only the sealed pages.
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch.core.memstore.shard import Shard
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
    def __init__(self, num_shards: int = 4, spread: int = 1,
                 max_chunk_size: int = 400):
        if num_shards & (num_shards - 1):
            raise ValueError("num_shards must be a power of 2")
        self.num_shards = num_shards
        self.spread = spread
        self.shards = [Shard(s, max_chunk_size) for s in range(num_shards)]
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
                            lambda shard, *a: shard.ingest(*a))

    def ingest_histograms(self, labels: list[dict], ts: np.ndarray,
                          buckets: np.ndarray, les: np.ndarray,
                          lens: np.ndarray | None = None) -> int:
        """Ingest N ``prom-histogram`` series: ``labels[i]`` (with
        ``_metric_``), timestamps int64 ms [N, T] (ascending), cumulative
        bucket counts int64 [N, T, B] under the bucket upper bounds ``les``
        float64 [B] (the last one +Inf); ``lens[i]`` of each row are samples
        (default: all T). Returns the samples kept."""
        ts = np.asarray(ts, np.int64)
        buckets = np.asarray(buckets, np.int64)
        les = np.asarray(les, np.float64)
        if ts.ndim != 2 or buckets.shape[:2] != ts.shape \
                or buckets.ndim != 3 or len(labels) != len(ts) \
                or les.shape != buckets.shape[2:]:
            raise ValueError("ingest_histograms takes N label maps, [N, T] "
                             "timestamps, [N, T, B] bucket counts and [B] "
                             "bucket bounds")
        return self._routed(labels, ts, buckets, lens, "prom-histogram",
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

    def ingest_histogram(self, labels: dict, ts, buckets, les) -> int:
        """Ingest one histogram series' samples ([T], [T, B], [B])."""
        return self.ingest_histograms(
            [labels], np.asarray(ts, np.int64)[None, :],
            np.asarray(buckets, np.int64)[None, :], les)

    def seal(self, labels: dict, schema: str = "prom-counter") -> None:
        """Close one series' write buffer into a chunk now."""
        key = PartKey.create(schema, labels)
        shard = self.shards[int(self.shard_of([key])[0])]
        pid = shard._by_key.get(key)
        if pid is not None:
            shard.seal(np.array([pid]))

    def label_names(self) -> list[str]:
        """Label names over every shard, sorted (the reference's
        ``TimeSeriesMemStore.label_names``)."""
        return sorted(set().union(*(s.index.label_names()
                                    for s in self.shards)))

    def label_values(self, label: str, filters=None) -> list[str]:
        """Values of ``label`` over every shard (among the partitions the
        filters select, if any), sorted."""
        return sorted(set().union(*(s.index.label_values(label, filters)
                                    for s in self.shards)))
