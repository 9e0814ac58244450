"""Routing of records to their shards.

Port of ``filodb_tpu/coordinator/ingestion.py::route_container``: a
container's records split into a container a shard, each record to the
shard its part key routes to (``MemStore.shard_of``'s rule: the upper
bits from the shard-key hash, the low ``spread`` bits from the part hash),
records keeping their order within a shard. The shards come out in order
of their first record, as the reference's ``defaultdict`` fills them.
``ingest_routed`` ingests a stream of containers so, each shard's part
at the container's offset (the reference's gateway-equivalent path for
tests and the command line's ``importcsv``).
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch.core.partkey import ingestion_shard, murmur3_32_many
from filodb_tpu_torch.core.record import RecordContainer, SomeData

_SHARD_KEY = ("_ws_", "_ns_", "_metric_")


def route_container(container: RecordContainer, num_shards: int, spread: int,
                    shard_key_labels=_SHARD_KEY) -> dict[int, RecordContainer]:
    """Split one container into a container a shard."""
    recs = container.records
    if not recs:
        return {}
    keys = [r.part_key for r in recs]
    shard_h = _shard_key_hashes(keys, tuple(shard_key_labels))
    part_h = murmur3_32_many([k.serialized for k in keys]).astype(np.int64)
    shards = ingestion_shard(shard_h, part_h, num_shards, spread)
    out: dict[int, RecordContainer] = {}
    for rec, s in zip(recs, shards.tolist()):
        c = out.get(s)
        if c is None:
            c = out[s] = RecordContainer()
        c.records.append(rec)
    return out


def ingest_routed(memstore, stream) -> int:
    """Ingest a stream of ``SomeData``, each container's records routed to
    the store's shards (its ``num_shards`` and ``spread``). Returns the
    samples kept."""
    total = 0
    for data in stream:
        for shard, container in route_container(
                data.container, memstore.num_shards,
                memstore.spread).items():
            total += memstore.shards[shard].ingest(
                SomeData(container, data.offset))
    return total


def _shard_key_hashes(keys, labels: tuple) -> np.ndarray:
    """Shard-key hashes of ``keys``, one hash a distinct shard key."""
    memo: dict = {}
    out = np.empty(len(keys), np.int64)
    for i, k in enumerate(keys):
        lm = k.label_map
        sk = tuple(lm.get(n, "") for n in labels)
        h = memo.get(sk)
        if h is None:
            h = memo[sk] = k.shard_key_hash(labels)
        out[i] = h
    return out
