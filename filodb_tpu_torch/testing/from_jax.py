"""Carry the JAX package's store state into the port's ``MemStore``.

The caller reads each partition of a ``filodb_tpu`` store out as numpy
(labels, decoded timestamps and values, the row count of each sealed
chunk in order; samples past the last chunk are its write buffer) and hands
the list here, in the order the reference created the partitions. Each
series is re-ingested chunk by chunk, sealing where the reference sealed,
so both stores hold the same chunks and so the same device pages. A
histogram series carries one ``HistogramColumn`` (bucket bounds and
cumulative count rows) per chunk, and one more for its write buffer, so a
series whose bucket scheme changed keeps each chunk's own, and its ``sum``
and ``count`` columns. Each chunk's summary comes with it: the port makes
it at seal from the same values, bitwise the reference's.

A reference shard's holes (pids its purge or an identity restore left
without a partition) travel as states with ``gone`` set, in their place,
so the port's pids line up with the reference's; ``blooms`` carries each
shard's evicted-key bloom (its ``state()``).

The write path needs no carrying: both packages write the same bytes.
``log_stream`` wraps serialized containers (the reference's
``RecordContainer.serialize()``, or a log's entries) as the port ingests
them; ``open_local`` opens a local-disk store directory that either package
wrote; ``dataset_samples`` reads every chunk of a dataset under such a
directory, decoded (the downsample parity tests hold both packages' ds
chunks by it); ``restart`` runs the recovery of every shard of a store from its
logs, as a restarted node does. ``server_pair`` boots the reference's
``FiloServer`` and the port's over one config and shuts both down; the
caller hands in the reference's classes. This module imports nothing of
``filodb_tpu``.
"""

from __future__ import annotations

import json
import os
import socket
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer, SomeData
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.core.store.localstore import (
    LocalDiskColumnStore,
    LocalDiskMetaStore,
)
from filodb_tpu_torch.memory.codecs import HistogramColumn


@dataclass
class SeriesState:
    schema: str
    labels: dict
    ts: np.ndarray           # int64 [n], ascending
    vals: np.ndarray | None  # float64 [n]; None for a histogram series
    chunk_rows: list[int]    # rows of each sealed chunk, in time order
    # histogram series: the chunks' columns in order, then the buffer's;
    # and the sum and count columns float64 [n] (None: not carried)
    hist: list[HistogramColumn] | None = None
    sums: np.ndarray | None = None
    counts: np.ndarray | None = None
    gone: bool = False  # a hole: no partition under this pid any more


def ingest_states(memstore: MemStore, states: list[SeriesState],
                  blooms: dict | None = None) -> None:
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.utils.bloom import BloomFilter

    holes = []
    for st in states:
        if st.gone:
            # a partition in its place, removed below
            memstore.ingest(st.labels, [0], [0.0], schema=st.schema)
            holes.append(PartKey.create(st.schema, st.labels))
            continue
        rows = list(st.chunk_rows)
        if sum(rows) < len(st.ts):
            rows.append(len(st.ts) - sum(rows))  # the write buffer
        a = 0
        for i, n in enumerate(rows):
            seg = slice(a, a + n)
            if st.hist is not None:
                memstore.ingest_histogram(
                    st.labels, st.ts[seg], st.hist[i].rows, st.hist[i].les,
                    None if st.sums is None else st.sums[seg],
                    None if st.counts is None else st.counts[seg])
            else:
                memstore.ingest(st.labels, st.ts[seg], st.vals[seg],
                                schema=st.schema)
            if i < len(st.chunk_rows):
                memstore.seal(st.labels, schema=st.schema)
            a += n
    for key, s in zip(holes, memstore.shard_of(holes).tolist()
                      if holes else []):
        shard = memstore.shards[s]
        pid = shard.lookup_keys([key.serialized])
        assert pid[0] >= 0, f"no partition of {key}"
        shard.remove_partitions(pid)
    for s, state in (blooms or {}).items():
        memstore.shards[s].evicted_keys = BloomFilter.from_state(state)


def log_stream(raws: list[bytes], first_offset: int = 0) -> list[SomeData]:
    """Serialized containers as the log hands them to a shard, at
    consecutive offsets from ``first_offset``."""
    return [SomeData(BytesContainer(r), first_offset + i)
            for i, r in enumerate(raws)]


def open_local(root: str, num_shards: int = 1, spread: int = 0,
               config: StoreConfig | None = None,
               dataset: str = "timeseries") -> MemStore:
    """A store over the local-disk column and meta stores at ``root``
    (``<root>/<dataset>/shard-<n>.db``, as either package lays it out)."""
    return MemStore(num_shards, spread, column_store=LocalDiskColumnStore(
        root), meta_store=LocalDiskMetaStore(root), config=config,
        dataset=dataset)


def dataset_samples(root: str, dataset: str, num_shards: int) -> dict:
    """{(part-key blob, chunk id): (timestamps int64 [n], the DOUBLE
    columns' float64 bit patterns int64 [K, n])} of every chunk of the
    stored part keys of ``dataset`` under the local-disk directory
    ``root``, decoded by the port's codec."""
    from filodb_tpu_torch.core.schemas import SCHEMAS
    from filodb_tpu_torch.core.store.api import pk_from_blob
    from filodb_tpu_torch.memory.chunk import ChunkBytes, decode_chunks

    cs = LocalDiskColumnStore(root)
    out = {}
    try:
        for s in range(num_shards):
            blobs = [r.part_key.serialized
                     for r in cs.scan_part_keys(dataset, s)]
            for blob, data in cs.read_chunk_rows(dataset, s, blobs, 0,
                                                 2**62):
                d = decode_chunks(ChunkBytes.from_blobs([bytes(data)]),
                                  SCHEMAS[pk_from_blob(blob).schema])
                n = int(d.rows[0])
                out[(bytes(blob), int(d.ids[0]))] = (
                    d.ts[0, :n], d.dcols[0, :, :n].view(np.int64))
    finally:
        cs.close()
    return out


def restart(memstore: MemStore, logs: dict) -> dict:
    """Recover every shard of a freshly opened store: its index from the
    column store, its watermarks from the checkpoints, then its log (a
    ``ReplayLog`` a shard in ``logs``) from the recovery start. Returns
    the keys restored, the records replayed and the records skipped below
    a watermark, summed over the shards."""
    out = {"keys": 0, "records": 0, "skipped": 0}
    for s, log in logs.items():
        out["keys"] += memstore.recover_index(s)
        start = memstore.recovery_start_offset(s)
        before = memstore.shards[s].rows_skipped
        for sd in log.read_from(start):
            out["records"] += len(sd.container)
            memstore.shards[s].ingest(sd)
        out["skipped"] += memstore.shards[s].rows_skipped - before
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def boot(server_cls, config_cls, conf: dict, data_dir: str, **kw):
    """One ``FiloServer`` (either package's ``server_cls`` and its
    ``ServerConfig`` ``config_cls``) over ``conf`` with ``data_dir``, HTTP
    on a free port and the gateway on another; ``kw`` go to the server
    (the port's ``device``)."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, "server.json")
    with open(path, "w") as f:
        json.dump({**conf, "data_dir": data_dir, "http_port": 0}, f)
    cfg = config_cls.load(path)
    cfg.gateway_port = free_port()
    return server_cls(cfg, **kw).start()


@contextmanager
def server_pair(conf: dict, root: str, reference: tuple, device="cpu"):
    """The reference's server (``reference`` = its FiloServer and
    ServerConfig classes) under ``<root>/ref`` and the port's under
    ``<root>/port``, both over ``conf``; yields (reference, port) and
    shuts both down, the port's first."""
    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.standalone import FiloServer

    ref = boot(*reference, conf, os.path.join(root, "ref"))
    try:
        port = boot(FiloServer, ServerConfig, conf,
                    os.path.join(root, "port"), device=device)
        try:
            yield ref, port
        finally:
            port.shutdown()
    finally:
        ref.shutdown()
