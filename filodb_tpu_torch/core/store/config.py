"""Store and ingestion configuration.

Copy of ``filodb_tpu/core/store/config.py``'s ``StoreConfig`` and
``IngestionConfig``, with the fields the port reads; every field takes
any value. ``shard_mem_mb`` (the budget of a shard's resident chunks,
``Shard.enforce_memory``), ``retention_ms`` (``Shard.purge_expired``) and
``evicted_pk_bloom_filter_capacity`` (the evicted-key bloom); the flush
scheduler acts on the first two every tick. ``disk_ttl_ms`` acts on
nothing, in either package: the reference reads it only in its config
dataclass. ``max_query_matches`` is the exec leaf's limit of series a
shard matches (``QueryLimitExceeded``), as in the reference.
``trace_part_key_substrings`` logs every sample and sealed chunk of the
partitions whose key holds one of them, and ``assert_single_writer``
makes a shard's first ingesting thread its only one (``Shard.ingest``).
``native_ingest`` is accepted either way: the port's container ingest is
its host C++ scan (``core/record.py::parse_container``) whatever it says.
``device_pages`` is always on in the port (sealed chunks keep their
pages), so its reference default (off) and on are both accepted.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class StoreConfig:
    flush_interval_ms: int = 3_600_000  # a flush cycle of every group
    max_chunk_size: int = 400           # samples a chunk
    groups_per_shard: int = 20          # flush groups (the reference's dev)
    shard_mem_mb: int = 256
    disk_ttl_ms: int = 3 * 24 * 3_600_000
    retention_ms: int = 3 * 24 * 3_600_000
    # shards ``MemStore.flush_all`` flushes at once (each shard its own
    # sqlite file); a shard flushes its groups one after another
    flush_task_parallelism: int = 2
    # page flushed chunks in from the column store when a query reaches
    # past what memory holds
    demand_paging_enabled: bool = True
    max_query_matches: int = 250_000
    evicted_pk_bloom_filter_capacity: int = 50_000
    trace_part_key_substrings: tuple[str, ...] = ()
    assert_single_writer: bool = False
    device_pages: bool = False
    native_ingest: bool = True
    # write each shard's index snapshot this often (0: only on demand)
    index_snapshot_interval_ms: int = 600_000


@dataclass(frozen=True)
class IngestionConfig:
    dataset: str
    num_shards: int = 4
    min_num_nodes: int = 1
    source_factory: str = "in-proc"
    source_config: dict = field(default_factory=dict)
    store: StoreConfig = field(default_factory=StoreConfig)
    downsample: dict | None = None
