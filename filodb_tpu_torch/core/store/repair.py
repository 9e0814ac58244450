"""Offline repair and migration jobs over column stores.

Port of ``filodb_tpu/core/store/repair.py`` (the reference's spark-jobs
repair plane, run as plain loops over the stores' scans) on the port's
row API (``core/store/api.py``: chunks travel as serialized rows):

- ``ChunkCopier``: copy the chunks ingested in a time window from one
  store to another (disaster recovery, migration).
- ``PartitionKeysCopier``: copy the part keys.
- ``CardinalityBuster``: delete the part keys (and their chunks) that
  match filters.
- ``DSIndexJob``: copy the raw dataset's part keys into a downsample
  dataset's key table under the ds schema.

Each job with ``n_splits`` fans its scans out over token-range splits
(``scan_part_keys_split``, ``scan_chunk_rows_by_ingestion_time_split``);
``run_split`` is the unit one parallel worker owns. A split's chunks go to
the target in one ``write_chunk_rows`` call a shard, which writes what the
reference's ``write_chunks`` called once a part key writes.
"""

from __future__ import annotations

from dataclasses import dataclass

from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.core.store.api import ColumnStore, PartKeyRecord
from filodb_tpu_torch.memory.chunk import chunk_header


@dataclass
class ChunkCopier:
    source: ColumnStore
    target: ColumnStore
    dataset: str
    num_shards: int
    n_splits: int = 1   # fan the scan out over token-range splits

    def run(self, ingestion_start: int, ingestion_end: int) -> dict:
        stats = {"partitions": 0, "chunks": 0}
        for shard in range(self.num_shards):
            for split in range(max(1, self.n_splits)):
                self._copy_split(shard, split, ingestion_start,
                                 ingestion_end, stats)
        return stats

    def run_split(self, split: int, ingestion_start: int,
                  ingestion_end: int) -> dict:
        """One split's work, over every shard."""
        stats = {"partitions": 0, "chunks": 0}
        for shard in range(self.num_shards):
            self._copy_split(shard, split, ingestion_start, ingestion_end,
                             stats)
        return stats

    def _copy_split(self, shard, split, t0, t1, stats):
        rows = []
        last = None
        for blob, data in self.source.scan_chunk_rows_by_ingestion_time_split(
                self.dataset, shard, t0, t1, split, max(1, self.n_splits)):
            blob, data = bytes(blob), bytes(data)
            if blob != last:  # a partition's chunks come together
                stats["partitions"] += 1
                last = blob
            cid, _, start, end = chunk_header(data)
            rows.append((blob, cid, start, end, data))
        if rows:
            self.target.write_chunk_rows(self.dataset, shard, rows, t1)
            stats["chunks"] += len(rows)
        return stats


@dataclass
class PartitionKeysCopier:
    source: ColumnStore
    target: ColumnStore
    dataset: str
    num_shards: int
    n_splits: int = 1   # fan the scan out over token-range splits

    def run(self) -> int:
        return sum(self.run_split(s) for s in range(max(1, self.n_splits)))

    def run_split(self, split: int) -> int:
        n = 0
        for shard in range(self.num_shards):
            recs = self.source.scan_part_keys_split(
                self.dataset, shard, split, max(1, self.n_splits))
            if recs:
                self.target.write_part_keys(self.dataset, shard, recs)
                n += len(recs)
        return n


@dataclass
class CardinalityBuster:
    """Delete the part keys that match every filter, and their chunks; a
    store without deletion raises ``NotImplementedError``."""

    store: ColumnStore
    dataset: str
    num_shards: int

    def run(self, filters: list[ColumnFilter]) -> int:
        busted = 0
        for shard in range(self.num_shards):
            victims = [
                rec for rec in self.store.scan_part_keys(self.dataset, shard)
                if all(f.filter.matches(rec.part_key.label_map.get(
                    f.column, "")) for f in filters)]
            if victims:
                self.store.delete_part_keys(self.dataset, shard,
                                            [v.part_key for v in victims])
                busted += len(victims)
        return busted


@dataclass
class DSIndexJob:
    """Copy the raw dataset's part keys into the downsample dataset's key
    table, each under its schema's ds schema."""

    store: ColumnStore
    dataset: str
    ds_dataset: str
    num_shards: int
    n_splits: int = 1   # fan the scan out over token-range splits

    def run(self) -> int:
        return sum(self.run_split(s) for s in range(max(1, self.n_splits)))

    def run_split(self, split: int) -> int:
        n = 0
        for shard in range(self.num_shards):
            recs = self.store.scan_part_keys_split(
                self.dataset, shard, split, max(1, self.n_splits))
            ds_recs = [PartKeyRecord(
                PartKey(_ds_schema_for(r.part_key.schema), r.part_key.labels),
                r.start_time, r.end_time) for r in recs]
            if ds_recs:
                self.store.write_part_keys(self.ds_dataset, shard, ds_recs)
                n += len(ds_recs)
        return n


def _ds_schema_for(schema: str) -> str:
    """A schema's ds schema (``ds-gauge`` for a gauge), else itself."""
    s = SCHEMAS.get(schema)
    return (s.data.downsample_schema if s is not None else None) or schema
