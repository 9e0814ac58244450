"""Column store and meta store: the interfaces and their in-memory forms.

Copy of the parts of ``filodb_tpu/core/store/api.py`` the port's write path
uses. A column store keeps serialized chunks and part keys per (dataset,
shard); a meta store keeps each flush group's checkpoint offset.

Chunks move in batches: ``write_chunk_rows`` / ``read_chunk_rows`` carry
the chunks of many part keys in one call, as a flush of a shard and a
page-in of a query need, where the reference's ``write_chunks`` /
``read_chunks`` take one part key: rows are (part-key blob, chunk id,
start, end, serialized chunk). Part keys travel as their blobs
(``PartKey.serialized``, the reference's ``_pk_blob``).

The downsampler's scan (``scan_chunk_rows_by_ingestion_time``) reads the
chunks written in an ingestion-time window [start, end), the reference's
``scan_chunks_by_ingestion_time``, as (part-key blob, serialized chunk)
rows, each partition's chunks in chunk-id order.

``split_of`` is the token-range split of a part key (crc32 of its blob),
the reference's ``remotestore.split_of``. The split scans
(``scan_part_keys_split``, ``scan_chunk_rows_by_ingestion_time_split``)
are the fan-out unit of the downsampler and repair jobs: the base class
filters the full scan, as the reference's does, and the object store's
buckets are its splits.

Index snapshots (``core/memstore/index_snapshot.py``): a column store
keeps one a shard (``write_index_snapshot`` / ``read_index_snapshot``)
and hands out write counters (``update_tokens``); a restore replays the
part keys and chunk floors written after them (``scan_part_keys_since``,
``max_persisted_ts_since``). The base class and the in-memory store keep
the reference's defaults: the "since" calls return everything, which a
restore applies idempotently.

A live migration's manifest (``coordinator/migration.py``) lives beside
the shard's data: ``write_`` / ``read_`` / ``delete_migration_manifest``.
The base class keeps it in a dict, as durable as the rest of an
in-memory store (the reference's ``:124-135``); the local-disk and
object stores persist it.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from dataclasses import dataclass

from filodb_tpu_torch.core.partkey import PartKey


@dataclass(frozen=True)
class PartKeyRecord:
    part_key: PartKey
    start_time: int
    end_time: int


def split_of(pk_blob: bytes, n_splits: int) -> int:
    """Token-range split of a part key (crc32 over its blob)."""
    return zlib.crc32(pk_blob) % n_splits if n_splits > 1 else 0


def pk_from_blob(blob: bytes) -> PartKey:
    """The part key of a blob (``PartKey.serialized``)."""
    blob = bytes(blob)
    parts = blob.split(b"\x00")
    labels = []
    for p in parts[1:]:
        k, v = p.split(b"\x01", 1)
        labels.append((k.decode(), v.decode()))
    pk = PartKey(parts[0].decode(), tuple(labels))
    pk.__dict__["serialized"] = blob  # the cached property: the same bytes
    return pk


class ColumnStore:
    """Durable store of encoded chunks and part keys, per (dataset, shard)."""

    def initialize(self, dataset: str, num_shards: int) -> None:
        raise NotImplementedError

    def write_chunk_rows(self, dataset: str, shard: int, rows: list,
                         ingestion_time: int) -> None:
        """Write chunks given as (part-key blob, chunk id, start, end,
        serialized chunk) rows; a chunk already stored is kept."""
        raise NotImplementedError

    def read_chunk_rows(self, dataset: str, shard: int, blobs: list[bytes],
                        start_time: int, end_time: int) -> list:
        """(part-key blob, serialized chunk) of the chunks of part keys
        ``blobs`` overlapping [start, end], in no particular order."""
        raise NotImplementedError

    def write_part_keys(self, dataset: str, shard: int,
                        records: list[PartKeyRecord]) -> None:
        raise NotImplementedError

    def scan_part_keys(self, dataset: str, shard: int) -> list[PartKeyRecord]:
        """Every part key of the shard, in the order first written."""
        raise NotImplementedError

    def scan_chunk_rows_by_ingestion_time(self, dataset: str, shard: int,
                                          start: int, end: int) -> list:
        """(part-key blob, serialized chunk) of every chunk whose
        ingestion time lies in [start, end), partition by partition, a
        partition's chunks in chunk-id order."""
        raise NotImplementedError

    def scan_part_keys_split(self, dataset: str, shard: int, split: int,
                             n_splits: int) -> list[PartKeyRecord]:
        """One token-range split of the part-key scan (``split_of``), for
        the jobs that fan out over splits; the default filters the full
        scan, the object store reads only the buckets of the split."""
        if n_splits <= 1:
            return self.scan_part_keys(dataset, shard)
        return [r for r in self.scan_part_keys(dataset, shard)
                if split_of(r.part_key.serialized, n_splits) == split]

    def scan_chunk_rows_by_ingestion_time_split(
            self, dataset: str, shard: int, start: int, end: int,
            split: int, n_splits: int) -> list:
        """One token-range split of ``scan_chunk_rows_by_ingestion_time``;
        the default filters the full scan."""
        rows = self.scan_chunk_rows_by_ingestion_time(dataset, shard, start,
                                                      end)
        if n_splits <= 1:
            return rows
        return [r for r in rows if split_of(bytes(r[0]), n_splits) == split]

    def delete_part_keys(self, dataset: str, shard: int,
                         part_keys: list[PartKey]) -> None:
        """Remove part keys and their chunks (the cardinality buster)."""
        raise NotImplementedError

    def max_persisted_ts(self, dataset: str, shard: int) -> dict[bytes, int]:
        """Largest persisted chunk end time per part-key blob: recovery
        seeds each partition's out-of-order floor with it, so WAL replay of
        rows flushed just before a crash is not written twice."""
        raise NotImplementedError

    def update_tokens(self, dataset: str, shard: int) -> tuple[int, int]:
        """(chunk token, part-key token): the write counters now."""
        return (-1, -1)

    def write_index_snapshot(self, dataset: str, shard: int,
                             data: bytes) -> None:
        """Keep a shard's index snapshot (replacing the last)."""

    def read_index_snapshot(self, dataset: str, shard: int) -> bytes | None:
        return None

    def scan_part_keys_since(self, dataset: str, shard: int,
                             pk_token: int) -> list[PartKeyRecord]:
        """The part keys written after ``pk_token``."""
        return self.scan_part_keys(dataset, shard)

    def max_persisted_ts_since(self, dataset: str, shard: int,
                               chunk_token: int) -> dict[bytes, int]:
        """``max_persisted_ts`` of the chunks written after
        ``chunk_token``."""
        return self.max_persisted_ts(dataset, shard)

    def write_migration_manifest(self, dataset: str, shard: int,
                                 data: bytes) -> None:
        if not hasattr(self, "_migration_manifests"):
            self._migration_manifests = {}
        self._migration_manifests[(dataset, shard)] = data

    def read_migration_manifest(self, dataset: str,
                                shard: int) -> bytes | None:
        return getattr(self, "_migration_manifests", {}).get(
            (dataset, shard))

    def delete_migration_manifest(self, dataset: str, shard: int) -> None:
        getattr(self, "_migration_manifests", {}).pop((dataset, shard),
                                                      None)

    def close(self) -> None:
        pass


class MetaStore:
    """Ingestion checkpoints: (dataset, shard, group) → offset."""

    def write_checkpoint(self, dataset: str, shard: int, group: int,
                         offset: int) -> None:
        raise NotImplementedError

    def read_checkpoints(self, dataset: str, shard: int) -> dict[int, int]:
        raise NotImplementedError

    # the cost model's learned estimates (``query/cost_model.py``), kept
    # beside the checkpoints so a restart keeps them; durable stores
    # override, the default keeps them in memory
    def write_cost_model(self, dataset: str, data: bytes) -> None:
        if not hasattr(self, "_cost_models"):
            self._cost_models = {}
        self._cost_models[dataset] = data

    def read_cost_model(self, dataset: str) -> bytes | None:
        return getattr(self, "_cost_models", {}).get(dataset)

    def close(self) -> None:
        pass


class NullColumnStore(ColumnStore):
    """Discards chunks (reference ``NullColumnStore``)."""

    def initialize(self, dataset, num_shards):
        pass

    def write_chunk_rows(self, dataset, shard, rows, ingestion_time):
        pass

    def read_chunk_rows(self, dataset, shard, blobs, start_time, end_time):
        return []

    def write_part_keys(self, dataset, shard, records):
        pass

    def scan_part_keys(self, dataset, shard):
        return []

    def scan_chunk_rows_by_ingestion_time(self, dataset, shard, start, end):
        return []

    def max_persisted_ts(self, dataset, shard):
        return {}


class InMemoryColumnStore(ColumnStore):
    """Keeps everything in process memory."""

    def __init__(self):
        # (dataset, shard) -> blob -> chunk id -> (start, end, data)
        self._chunks = defaultdict(lambda: defaultdict(dict))
        # (dataset, shard) -> blob -> [(ingestion time, chunk id)]
        self._ingested = defaultdict(lambda: defaultdict(list))
        self._part_keys: dict[tuple, dict[PartKey, PartKeyRecord]] = \
            defaultdict(dict)
        self._snapshots: dict[tuple, bytes] = {}

    def initialize(self, dataset, num_shards):
        pass

    def write_chunk_rows(self, dataset, shard, rows, ingestion_time):
        store = self._chunks[(dataset, shard)]
        index = self._ingested[(dataset, shard)]
        for blob, cid, st, et, data in rows:
            blob, cid = bytes(blob), int(cid)
            if cid not in store[blob]:
                store[blob][cid] = (st, et, bytes(data))
                index[blob].append((ingestion_time, cid))

    def scan_chunk_rows_by_ingestion_time(self, dataset, shard, start, end):
        store = self._chunks[(dataset, shard)]
        out = []
        for blob, entries in self._ingested[(dataset, shard)].items():
            ids = sorted({c for t, c in entries if start <= t < end})
            out.extend((blob, store[blob][c][2]) for c in ids)
        return out

    def read_chunk_rows(self, dataset, shard, blobs, start_time, end_time):
        store = self._chunks[(dataset, shard)]
        out = []
        for blob in sorted(set(blobs)):
            for cid in sorted(store.get(blob, ())):
                st, et, data = store[blob][cid]
                if et >= start_time and st <= end_time:
                    out.append((blob, data))
        return out

    def write_part_keys(self, dataset, shard, records):
        d = self._part_keys[(dataset, shard)]
        for r in records:
            prev = d.get(r.part_key)
            if prev is not None:
                r = PartKeyRecord(r.part_key,
                                  min(prev.start_time, r.start_time),
                                  r.end_time)
            d[r.part_key] = r

    def scan_part_keys(self, dataset, shard):
        return list(self._part_keys[(dataset, shard)].values())

    def delete_part_keys(self, dataset, shard, part_keys):
        for pk in part_keys:
            self._part_keys[(dataset, shard)].pop(pk, None)
            self._chunks[(dataset, shard)].pop(pk.serialized, None)
            self._ingested[(dataset, shard)].pop(pk.serialized, None)

    def max_persisted_ts(self, dataset, shard):
        return {blob: max(et for _, et, _ in chunks.values())
                for blob, chunks in self._chunks[(dataset, shard)].items()
                if chunks}

    def write_index_snapshot(self, dataset, shard, data):
        self._snapshots[(dataset, shard)] = bytes(data)

    def read_index_snapshot(self, dataset, shard):
        return self._snapshots.get((dataset, shard))

    def update_tokens(self, dataset, shard):
        # counts stand in for write counters, as the reference's in-memory
        # store counts (its "since" calls return everything)
        nchunks = sum(len(v) for v in self._chunks[(dataset, shard)].values())
        return (nchunks, len(self._part_keys[(dataset, shard)]))


class InMemoryMetaStore(MetaStore):
    def __init__(self):
        self._checkpoints: dict[tuple, dict[int, int]] = defaultdict(dict)

    def write_checkpoint(self, dataset, shard, group, offset):
        self._checkpoints[(dataset, shard)][group] = offset

    def read_checkpoints(self, dataset, shard):
        return dict(self._checkpoints[(dataset, shard)])
