"""The seeded store of the multi-process mesh harness.

Port of ``filodb_tpu/testing/mesh_store.py``. Mesh worker processes
started with ``--seed filodb_tpu_torch.testing.mesh_store:build_store``
build exactly this store: every input is seeded and a record's shard
(``ingestion_shard``) hashes its content, so N processes hold the same
series and samples in each shard as the root, and as the reference's
``build_store`` (``tests/test_torch_multiproc_mesh.py`` holds them
equal). That is what lets the harness hold the workers' answers bitwise
against a single-process engine over the same store.
"""

from __future__ import annotations

DATASET = "timeseries"
NUM_SHARDS = 4
N_SERIES = 48
N_SAMPLES = 180
START_MS = 1_600_000_000_000
INTERVAL_MS = 10_000


def build_store():
    """A fully ingested ``MemStore``: ``N_SERIES`` counters routed over
    ``NUM_SHARDS`` shards at spread 0, with resets, so counter correction
    runs on both sides of the process boundary."""
    from filodb_tpu_torch.coordinator.ingestion import route_container
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.core.record import SomeData
    from filodb_tpu_torch.core.store.config import StoreConfig
    from filodb_tpu_torch.testing.data import counter_series, counter_stream

    ms = MemStore(NUM_SHARDS, spread=0, dataset=DATASET,
                  config=StoreConfig(max_chunk_size=100, groups_per_shard=4))
    keys = counter_series(N_SERIES)
    for data in counter_stream(keys, N_SAMPLES, start_ms=START_MS,
                               interval_ms=INTERVAL_MS, seed=7,
                               reset_every=60):
        for shard, sub in route_container(data.container, NUM_SHARDS,
                                          0).items():
            ms.shards[shard].ingest(SomeData(sub, data.offset))
    return ms
