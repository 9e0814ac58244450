"""Store configuration: the fields of ``filodb_tpu/core/store/config.py``'s
``StoreConfig`` that the port's write path reads."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StoreConfig:
    max_chunk_size: int = 400           # samples a chunk
    groups_per_shard: int = 20          # flush groups (the reference's dev)
    # shards ``MemStore.flush_all`` flushes at once (each shard its own
    # sqlite file); a shard flushes its groups one after another
    flush_task_parallelism: int = 2
    # page flushed chunks in from the column store when a query reaches
    # past what memory holds
    demand_paging_enabled: bool = True
