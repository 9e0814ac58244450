"""The port's remote chunk store against the reference's.

The cases of ``tests/test_remote_store.py``, the ``TestRemoteStoreFaults``
cases of ``tests/test_fault_injection.py`` and the deployment matrix of
``tests/test_multiprocess.py`` on the port's copy
(``core/store/remotestore.py``):

- the protocol (chunks, part keys, the ingestion-time scan, the floors,
  the write tokens and the "since" scans, index snapshots, checkpoints,
  deletion, truncation, name checks), each case run with the server of
  one package and the client of the other as well as the port's with its
  own; chunk bytes read back are the bytes written, whichever client
  wrote them;
- scan splits: ``split_of`` equals the reference's over seeded blobs, a
  split scan is filtered on the server and partitions the key space, and
  the repair jobs fan out over it;
- a port store over the remote tier flushes, restarts from it and pages
  its chunks back, answering as a store that kept everything in memory;
  the downsampler job over it writes what a job over a local store
  writes;
- the pooled connection's stale-socket retry, the ``store.call`` fault
  site and the peer's breaker;
- what the wire does not carry stays in the client's process, as with
  the reference's client: migration manifests and the cost model;
- nodes: a port node with ``store_remote`` and ``wal_remote`` answers as
  the reference's node with the same config over the same gateway lines,
  before and after both restart on fresh directories; ``store_server_port``
  and ``wal_server_port`` serve a node's own stores and WAL; mesh workers
  beside ``wal_remote`` get the config the reference's node writes; and a
  cluster of a coordinator and a ``python -m filodb_tpu_torch.standalone``
  member found through Consul shares a chunk-store server and the
  coordinator's log server.

Every wait has a deadline and every socket a timeout.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from filodb_tpu import config as ref_config
from filodb_tpu import standalone as ref_standalone
from filodb_tpu.core.memstore.partition import TimeSeriesPartition
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu.core.store import remotestore as ref_rs
from filodb_tpu.core.store.api import PartKeyRecord as RefRecord
from filodb_tpu.core.store.localstore import _pk_blob, _pk_from_blob
from filodb_tpu.kafka import log_server as ref_ls
from filodb_tpu.memory.chunk import Chunk as RefChunk
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer
from filodb_tpu_torch.core.store import remotestore as port_rs
from filodb_tpu_torch.core.store.api import PartKeyRecord, pk_from_blob
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.core.store.localstore import LocalDiskColumnStore
from filodb_tpu_torch.core.store.repair import (
    ChunkCopier,
    PartitionKeysCopier,
)
from filodb_tpu_torch.kafka import log_server as port_ls
from filodb_tpu_torch.memory.chunk import chunk_header
from filodb_tpu_torch.standalone import FiloServer
from filodb_tpu_torch.testing.from_jax import boot, free_port, restart
from filodb_tpu_torch.utils import resilience
from filodb_tpu_torch.utils.resilience import (
    CircuitOpenError,
    FaultInjector,
    breaker_for,
    reset_breakers,
)
from test_torch_server import (
    N_SAMPLES,
    RANGE_QUERIES,
    START,
    _assert_same,
    _gateway_lines,
    _get,
    _send,
    _wait_ingested,
)

ROOT = Path(__file__).resolve().parent.parent
PKG = {"port": port_rs, "ref": ref_rs}
# (server's package, client's package)
COMBOS = [("port", "port"), ("port", "ref"), ("ref", "port")]
DS = "timeseries"


@pytest.fixture(autouse=True)
def _clean():
    FaultInjector.reset()
    reset_breakers()
    yield
    FaultInjector.reset()
    reset_breakers()
    resilience.reset()


class Client:
    """One package's column- and meta-store clients behind one surface
    of part-key blobs and chunk bytes."""

    def __init__(self, pkg, port: int):
        self.port_side = pkg is port_rs
        self.cs = pkg.RemoteColumnStore("127.0.0.1", port)
        self.meta = pkg.RemoteMetaStore("127.0.0.1", port)

    def close(self):
        self.cs.close()
        self.meta.close()

    def write(self, blob, raws, itime, ds="ds", shard=0):
        if self.port_side:
            self.cs.write_chunk_rows(ds, shard, [
                (blob, chunk_header(r)[0], chunk_header(r)[2],
                 chunk_header(r)[3], r) for r in raws], itime)
        else:
            self.cs.write_chunks(ds, shard, _pk_from_blob(blob),
                                 [RefChunk.deserialize(r) for r in raws],
                                 itime)

    def read(self, blob, st=0, et=2**62, ds="ds", shard=0) -> list[bytes]:
        if self.port_side:
            return [bytes(d) for _, d in
                    self.cs.read_chunk_rows(ds, shard, [blob], st, et)]
        return [c.serialize() for c in
                self.cs.read_chunks(ds, shard, _pk_from_blob(blob), st, et)]

    def write_pks(self, recs, ds="ds", shard=0):
        if self.port_side:
            self.cs.write_part_keys(ds, shard, [
                PartKeyRecord(pk_from_blob(b), st, et) for b, st, et in recs])
        else:
            self.cs.write_part_keys(ds, shard, [
                RefRecord(_pk_from_blob(b), st, et) for b, st, et in recs])

    def _rows(self, recs):
        if self.port_side:
            return [(r.part_key.serialized, r.start_time, r.end_time)
                    for r in recs]
        return [(_pk_blob(r.part_key), r.start_time, r.end_time)
                for r in recs]

    def scan_pks(self, ds="ds", shard=0):
        return self._rows(self.cs.scan_part_keys(ds, shard))

    def split(self, i, n, ds="ds", shard=0):
        return [b for b, _, _ in self._rows(
            self.cs.scan_part_keys_split(ds, shard, i, n))]

    def since(self, token, ds="ds", shard=0):
        return {b for b, _, _ in self._rows(
            self.cs.scan_part_keys_since(ds, shard, token))}

    def scan_ingest(self, t0, t1, ds="ds", shard=0):
        """[(blob, [chunk bytes])], a partition's chunks together."""
        if self.port_side:
            out = []
            for blob, data in self.cs.scan_chunk_rows_by_ingestion_time(
                    ds, shard, t0, t1):
                if not out or out[-1][0] != blob:
                    out.append((blob, []))
                out[-1][1].append(bytes(data))
            return out
        return [(_pk_blob(pk), [c.serialize() for c in chunks]) for pk, chunks
                in self.cs.scan_chunks_by_ingestion_time(ds, shard, t0, t1)]

    def max_ts(self, ds="ds", shard=0):
        d = self.cs.max_persisted_ts(ds, shard)
        return dict(d) if self.port_side else \
            {_pk_blob(k): v for k, v in d.items()}

    def delete(self, blobs, ds="ds", shard=0):
        keys = [pk_from_blob(b) if self.port_side else _pk_from_blob(b)
                for b in blobs]
        self.cs.delete_part_keys(ds, shard, keys)


@pytest.fixture(params=COMBOS, ids=lambda c: f"{c[0]}server-{c[1]}client")
def env(request, tmp_path):
    srv_pkg, cli_pkg = request.param
    srv = PKG[srv_pkg].ChunkStoreServer(root=str(tmp_path / "store")).start()
    cli = Client(PKG[cli_pkg], srv.port)
    yield srv_pkg, srv, cli
    cli.close()
    srv.shutdown()


@pytest.fixture(params=COMBOS[:2], ids=lambda c: f"portserver-{c[1]}client")
def port_env(request, tmp_path):
    srv = port_rs.ChunkStoreServer(root=str(tmp_path / "store")).start()
    cli = Client(PKG[request.param[1]], srv.port)
    yield "port", srv, cli
    cli.close()
    srv.shutdown()


def _blobs(n):
    return [_pk_blob(k) for k in machine_metrics_series(n)]


def _chunks_for(blob, n=100, chunk=50) -> list[bytes]:
    part = TimeSeriesPartition(0, _pk_from_blob(blob),
                               DEFAULT_SCHEMAS["gauge"], max_chunk_size=chunk)
    for i in range(n):
        part.ingest((START + i) * 1000, (float(i),))
    return [c.serialize() for c in part.make_flush_chunks()]


class TestProtocol:
    def test_chunks_round_trip(self, env):
        _, _, cli = env
        (blob,) = _blobs(1)
        raws = _chunks_for(blob)
        cli.write(blob, raws, 777)
        assert cli.read(blob) == raws
        # idempotent rewrite
        cli.write(blob, raws, 777)
        assert cli.read(blob) == raws

    def test_chunk_bytes_cross_the_packages(self, env):
        """What one package's client wrote, the other's reads back byte
        for byte."""
        _, srv, cli = env
        other = Client(port_rs if not cli.port_side else ref_rs, srv.port)
        try:
            a, b = _blobs(2)
            cli.write(a, _chunks_for(a), 5)
            other.write(b, _chunks_for(b, 70, 30), 6)
            assert other.read(a) == _chunks_for(a)
            assert cli.read(b) == _chunks_for(b, 70, 30)
        finally:
            other.close()

    def test_part_keys_upsert_and_scan(self, env):
        _, _, cli = env
        blobs = _blobs(5)
        cli.write_pks([(b, 100, 200) for b in blobs])
        cli.write_pks([(blobs[0], 150, 999)])
        recs = {b: (st, et) for b, st, et in cli.scan_pks()}
        assert len(recs) == 5
        assert recs[blobs[0]] == (100, 999)

    def test_ingestion_time_scan(self, env):
        _, _, cli = env
        (blob,) = _blobs(1)
        raws = _chunks_for(blob)
        cli.write(blob, raws, 500)
        got = cli.scan_ingest(0, 1000)
        assert got == [(blob, raws)]
        assert cli.scan_ingest(1000, 2000) == []

    def test_max_persisted_ts(self, env):
        _, _, cli = env
        (blob,) = _blobs(1)
        cli.write(blob, _chunks_for(blob), 1)
        assert cli.max_ts() == {blob: (START + 99) * 1000}

    def test_tokens_and_since_scans(self, env):
        _, _, cli = env
        blobs = _blobs(3)
        cli.write_pks([(blobs[0], 1, 2)])
        _, pt = cli.cs.update_tokens("ds", 0)
        cli.write_pks([(blobs[1], 3, 4), (blobs[2], 5, 6)])
        assert cli.since(pt) == {blobs[1], blobs[2]}

    def test_index_snapshot(self, env):
        _, _, cli = env
        assert cli.cs.read_index_snapshot("ds", 0) is None
        cli.cs.write_index_snapshot("ds", 0, b"snapshot-bytes")
        assert cli.cs.read_index_snapshot("ds", 0) == b"snapshot-bytes"

    def test_checkpoints(self, env):
        _, _, cli = env
        cli.meta.write_checkpoint("ds", 0, 0, 41)
        cli.meta.write_checkpoint("ds", 0, 1, 77)
        cli.meta.write_checkpoint("ds", 0, 0, 42)
        assert cli.meta.read_checkpoints("ds", 0) == {0: 42, 1: 77}

    def test_delete_part_keys(self, env):
        _, _, cli = env
        blobs = _blobs(2)
        for b in blobs:
            cli.write(b, _chunks_for(b), 1)
        cli.write_pks([(b, 1, 2) for b in blobs])
        cli.delete([blobs[0]])
        assert [b for b, _, _ in cli.scan_pks()] == [blobs[1]]
        assert cli.read(blobs[0]) == []

    def test_truncate(self, env):
        # either package's server over its local-disk store truncates when
        # either client asks (ROADMAP §C.19, closed)
        _, _, cli = env
        (blob,) = _blobs(1)
        cli.write(blob, _chunks_for(blob), 1)
        cli.cs.truncate("ds")
        assert cli.read(blob) == []

    def test_bad_dataset_name_rejected(self, env):
        _, _, cli = env
        err = port_rs.StoreOpError if cli.port_side else ref_rs.StoreOpError
        with pytest.raises(err):
            cli.scan_pks("../escape", 0)
        with pytest.raises(err):
            cli.scan_pks("ds", -4)


class TestScanSplits:
    def test_splits_partition_the_keyspace(self, env):
        _, _, cli = env
        blobs = _blobs(64)
        cli.write_pks([(b, 1, 2) for b in blobs])
        parts = [cli.split(i, 4) for i in range(4)]
        seen = [b for p in parts for b in p]
        assert len(seen) == len(set(seen)) == 64
        assert sum(1 for p in parts if p) >= 2

    def test_split_matches_local_default_impl(self, env, tmp_path):
        _, _, cli = env
        blobs = _blobs(32)
        cli.write_pks([(b, 1, 2) for b in blobs])
        local = LocalDiskColumnStore(str(tmp_path / "local"))
        try:
            local.write_part_keys("ds", 0, [
                PartKeyRecord(pk_from_blob(b), 1, 2) for b in blobs])
            for i in range(3):
                assert set(cli.split(i, 3)) == {
                    r.part_key.serialized
                    for r in local.scan_part_keys_split("ds", 0, i, 3)}
        finally:
            local.close()

    def test_parallel_split_scan_threads(self, port_env):
        """Against the port's server only: the reference's local-disk
        store reads its sqlite connection unlocked beside other threads
        (ROADMAP §C.14, mended in the port alone), so six scans at once
        fail there now and then, whatever the client."""
        _, _, cli = port_env
        cli.write_pks([(b, 1, 2) for b in _blobs(48)])
        with ThreadPoolExecutor(max_workers=6) as ex:
            parts = list(ex.map(lambda i: cli.split(i, 6), range(6)))
        assert sum(len(p) for p in parts) == 48


@pytest.mark.parametrize("seed", range(3))
def test_split_of_is_the_references(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        blob = rng.bytes(int(rng.integers(0, 64)))
        n = int(rng.integers(1, 17))
        assert port_rs.split_of(blob, n) == ref_rs.split_of(blob, n)
    # stable and spread, as the reference's test asks
    spread = {port_rs.split_of(f"k{i}".encode(), 8) for i in range(100)}
    assert len(spread) >= 6


def _frames(op: str) -> float:
    return port_rs.wire_counters(op)[0].value


class TestMemstoreOverRemote:
    """A port store over the remote tier: flush over the wire, a restart
    that recovers from it, chunks paged back; answers as a store that
    kept everything in memory."""

    @pytest.fixture(params=["port", "ref"])
    def server(self, request, tmp_path):
        srv = PKG[request.param].ChunkStoreServer(
            root=str(tmp_path / "store")).start()
        yield srv
        srv.shutdown()

    @staticmethod
    def _raws():
        keys = machine_metrics_series(8)
        return [sd.container.serialize() for sd in gauge_stream(
            keys, 150, start_ms=START * 1000, batch=50)]

    @staticmethod
    def _store(cs, meta):
        return MemStore(2, 1, column_store=cs, meta_store=meta,
                        config=StoreConfig(max_chunk_size=50,
                                           groups_per_shard=2))

    def test_flush_restart_and_page_through_remote(self, server):
        from filodb_tpu_torch.kafka.log import InMemoryLog

        raws = self._raws()
        plain = self._store(None, None)
        logs = {0: InMemoryLog(), 1: InMemoryLog()}
        for raw in raws:
            for s in range(2):
                logs[s].append(BytesContainer(raw))
        cs = port_rs.RemoteColumnStore("127.0.0.1", server.port)
        meta = port_rs.RemoteMetaStore("127.0.0.1", server.port)
        try:
            live = self._store(cs, meta)
            for s in range(2):
                for sd in logs[s].read_from(0):
                    live.shards[s].ingest(sd)
                    plain.shards[s].ingest(sd)
            writes = _frames("write_chunks")
            live.flush_all()
            assert _frames("write_chunks") > writes
            reads = _frames("read_chunks")
            back = self._store(cs, meta)
            out = restart(back, logs)
            assert out["keys"] == 16 and out["skipped"] > 0
            q = ('sum(count_over_time(heap_usage[1h]))', START + 100, 60,
                 START + 1500)
            got = QueryService(back, device="cpu").query_range(*q).result
            want = QueryService(plain, device="cpu").query_range(*q).result
            np.testing.assert_array_equal(got.values, want.values)
            assert float(np.nanmax(want.values)) > 0
            # the flushed chunks came back over the wire
            assert _frames("read_chunks") > reads
        finally:
            cs.close()
            meta.close()

    def test_repair_jobs_fan_out_over_server_side_splits(self, server):
        from filodb_tpu_torch.core.store.api import InMemoryColumnStore

        cs = port_rs.RemoteColumnStore("127.0.0.1", server.port)
        meta = port_rs.RemoteMetaStore("127.0.0.1", server.port)
        try:
            ms = self._store(cs, meta)
            for off, raw in enumerate(self._raws()):
                for s in range(2):
                    ms.shards[s].ingest(_data(raw, off))
            ms.flush_all()
            want = {(s, r.part_key.serialized) for s in range(2)
                    for r in cs.scan_part_keys(DS, s)}
            assert want
            dst = InMemoryColumnStore()
            scans = _frames("scan_pks")
            n = PartitionKeysCopier(cs, dst, DS, 2, n_splits=3).run()
            # one split scan a shard a split, filtered on the server
            assert _frames("scan_pks") - scans == 6
            assert n == len(want)
            assert {(s, r.part_key.serialized) for s in range(2)
                    for r in dst.scan_part_keys(DS, s)} == want
            stats = ChunkCopier(cs, dst, DS, 2, n_splits=3).run(0, 2**62)
            assert stats["partitions"] == len(want)
            for s in range(2):
                blobs = [r.part_key.serialized
                         for r in cs.scan_part_keys(DS, s)]
                assert sorted(dst.read_chunk_rows(DS, s, blobs, 0, 2**62)) \
                    == sorted(cs.read_chunk_rows(DS, s, blobs, 0, 2**62))
        finally:
            cs.close()
            meta.close()


    def test_downsampler_job_over_remote_equals_a_local_one(self, server):
        """The downsampler job over the remote tier, its ingestion-time
        scan fanned out over splits (filtered in the client, as the
        reference's wire carries no split for it), writes the ds chunks
        and part keys a job over an in-memory store writes, and keeps
        its watermark in the remote meta store."""
        from filodb_tpu_torch.core.downsample.downsampler import (
            DownsamplerJob,
            ds_dataset_name,
        )
        from filodb_tpu_torch.core.store.api import (
            InMemoryColumnStore,
            InMemoryMetaStore,
        )

        cs = port_rs.RemoteColumnStore("127.0.0.1", server.port)
        meta = port_rs.RemoteMetaStore("127.0.0.1", server.port)
        local_cs, local_meta = InMemoryColumnStore(), InMemoryMetaStore()
        try:
            stores = [self._store(cs, meta),
                      self._store(local_cs, local_meta)]
            for ms in stores:
                for off, raw in enumerate(self._raws()):
                    for s in range(2):
                        ms.shards[s].ingest(_data(raw, off))
                ms.flush_all(ingestion_time=1_000)
            scans = _frames("scan_ingest")
            stats = [DownsamplerJob(c, DS, 2, (300_000,), max_chunk_size=50,
                                    meta_store=m, n_splits=2)
                     .catch_up(2_000)
                     for c, m in ((cs, meta), (local_cs, local_meta))]
            # a scan a shard a split, each the full window on the wire
            assert _frames("scan_ingest") - scans == 4
            assert stats[0]["raw_chunks"] == stats[1]["raw_chunks"] > 0
            ds = ds_dataset_name(DS, 300_000)
            for s in range(2):
                keys = [sorted((r.part_key.serialized, r.start_time,
                                r.end_time)
                               for r in c.scan_part_keys(ds, s))
                        for c in (cs, local_cs)]
                assert keys[0] == keys[1] and keys[0]
                blobs = [k[0] for k in keys[0]]
                assert sorted(cs.read_chunk_rows(ds, s, blobs, 0, 2**62)) \
                    == sorted(local_cs.read_chunk_rows(ds, s, blobs, 0,
                                                       2**62))
                assert DownsamplerJob(cs, DS, 2, meta_store=meta) \
                    .last_checkpoint(s) == 2_000
        finally:
            cs.close()
            meta.close()


def _data(raw: bytes, offset: int = 0):
    from filodb_tpu_torch.core.record import SomeData
    return SomeData(BytesContainer(raw), offset)


class TestRemoteStoreFaults:
    @pytest.fixture(params=["port", "ref"])
    def store_env(self, request, tmp_path):
        srv = PKG[request.param].ChunkStoreServer(root=str(tmp_path)).start()
        yield srv
        srv.shutdown()

    def test_stale_pooled_socket_retries(self, store_env):
        conn = port_rs._RemoteConn("127.0.0.1", store_env.port)
        assert conn.call("ping") is True
        conn._sock.close()  # server restarted under us
        assert conn.call("ping") is True  # one retry on a fresh socket
        conn.close()

    def test_injected_fault_consumed_by_retry(self, store_env):
        conn = port_rs._RemoteConn("127.0.0.1", store_env.port)
        assert conn.call("ping") is True  # pool a socket first
        fault = FaultInjector.arm("store.call", error=ConnectionError,
                                  times=1)
        assert conn.call("ping") is True  # fault hits, fresh-socket retry
        assert fault.fired == 1
        conn.close()

    def test_persistent_failure_opens_breaker(self, store_env):
        resilience.configure(breaker_failure_threshold=2)
        conn = port_rs._RemoteConn("127.0.0.1", store_env.port)
        FaultInjector.arm("store.call", error=ConnectionError)
        for _ in range(2):
            with pytest.raises(ConnectionError):
                conn.call("ping")
        assert breaker_for(conn.peer).is_open
        with pytest.raises(CircuitOpenError):
            conn.call("ping")
        conn.close()


class TestWhatTheWireDoesNotCarry:
    """Migration manifests and the cost model's estimates stay in the
    client's process, as they do with the reference's client: a second
    client of the same server sees none of them."""

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_manifests_and_cost_models_stay_in_process(self, pkg, tmp_path):
        srv = PKG[pkg].ChunkStoreServer(root=str(tmp_path)).start()
        mod = PKG[pkg]
        a_cs = mod.RemoteColumnStore("127.0.0.1", srv.port)
        b_cs = mod.RemoteColumnStore("127.0.0.1", srv.port)
        a_meta = mod.RemoteMetaStore("127.0.0.1", srv.port)
        b_meta = mod.RemoteMetaStore("127.0.0.1", srv.port)
        try:
            a_cs.write_migration_manifest(DS, 3, b"manifest")
            assert a_cs.read_migration_manifest(DS, 3) == b"manifest"
            assert b_cs.read_migration_manifest(DS, 3) is None
            a_cs.delete_migration_manifest(DS, 3)
            assert a_cs.read_migration_manifest(DS, 3) is None
            a_meta.write_cost_model(DS, b"{}")
            assert a_meta.read_cost_model(DS) == b"{}"
            assert b_meta.read_cost_model(DS) is None
        finally:
            for c in (a_cs, b_cs, a_meta, b_meta):
                c.close()
            srv.shutdown()


# ---- nodes ------------------------------------------------------------------

REF = (ref_standalone.FiloServer, ref_config.ServerConfig)
NODE = {"node_name": "node-0",
        "datasets": {DS: {"num_shards": 2, "spread": 1,
                          "store": {"max_chunk_size": 100,
                                    "groups_per_shard": 2,
                                    "retention_ms": 2**60}}}}
NODE_QUERIES = RANGE_QUERIES[:4]


def _answers(srv) -> dict:
    out = {}
    for q in NODE_QUERIES:
        code, body = _get(srv.http.port, f"/promql/{DS}/api/v1/query_range",
                          query=q, start=START + 300,
                          end=START + 10 * N_SAMPLES, step=60)
        assert code == 200, body
        out[q] = body
    return out


def test_node_over_remote_tiers_answers_as_the_reference(tmp_path):
    """Each package's node over a log server and a chunk-store server of
    the other package, fed the same gateway lines: the same answers,
    and again after a flush and a restart of both on fresh data
    directories (everything then comes from the remote tiers)."""
    tiers = {}
    for side, pkg_rs, pkg_ls in (("port", ref_rs, ref_ls),
                                 ("ref", port_rs, port_ls)):
        tiers[side] = (
            pkg_ls.LogServer(str(tmp_path / f"{side}-broker")).start(),
            pkg_rs.ChunkStoreServer(root=str(tmp_path / f"{side}-tier"))
            .start())

    def conf(side):
        lsrv, csrv = tiers[side]
        return {**NODE, "wal_remote": f"127.0.0.1:{lsrv.port}",
                "store_remote": f"127.0.0.1:{csrv.port}"}

    lines = _gateway_lines()
    nodes = []
    try:
        for gen in range(2):
            ref = boot(*REF, conf("ref"), str(tmp_path / f"ref-{gen}"))
            nodes.append(ref)
            port = boot(FiloServer, ServerConfig, conf("port"),
                        str(tmp_path / f"port-{gen}"), device="cpu")
            nodes.append(port)
            assert isinstance(port.column_store, port_rs.RemoteColumnStore)
            assert all(isinstance(lg, port_ls.RemoteLog)
                       for lg in port.logs.values())
            if gen == 0:
                for srv in (ref, port):
                    _send(srv, lines)
            _wait_ingested((ref, port), 24 * N_SAMPLES)
            want, got = _answers(ref), _answers(port)
            for q in NODE_QUERIES:
                _assert_same(got[q], want[q], q)
            if gen == 0:
                ref.memstore.flush_all(DS)
                port.node.memstores[DS].flush_all()
            for srv in (port, ref):
                srv.shutdown()
                nodes.remove(srv)
        # the port's chunks are in the reference's server, readable by the
        # reference's client
        probe = ref_rs.RemoteColumnStore("127.0.0.1", tiers["port"][1].port)
        try:
            assert sum(len(probe.scan_part_keys(DS, s)) for s in range(2)) \
                == 24 * 2 + 6
        finally:
            probe.close()
    finally:
        for srv in nodes:
            srv.shutdown()
        for lsrv, csrv in tiers.values():
            lsrv.stop()
            csrv.shutdown()


def test_node_serves_its_stores_and_wal(tmp_path):
    """``store_server_port`` serves the node's own stores and
    ``wal_server_port`` its WAL directory, its own shards going through
    the log server; the reference's clients read both."""
    store_port, wal_port = free_port(), free_port()
    srv = boot(FiloServer, ServerConfig,
               {**NODE, "store_server_port": store_port,
                "wal_server_port": wal_port},
               str(tmp_path / "node"), device="cpu")
    try:
        assert srv.store_server.port == store_port
        assert srv.log_server.port == wal_port
        assert srv.config.wal_remote == f"127.0.0.1:{wal_port}"
        assert all(isinstance(lg, port_ls.RemoteLog)
                   for lg in srv.logs.values())
        _send(srv, _gateway_lines(n_series=8, n_samples=20))
        _wait_ingested((srv,), 8 * 20)
        srv.node.memstores[DS].flush_all()
        probe = ref_rs.RemoteColumnStore("127.0.0.1", store_port)
        meta = ref_rs.RemoteMetaStore("127.0.0.1", store_port)
        try:
            keys = [r.part_key for s in range(2)
                    for r in probe.scan_part_keys(DS, s)]
            assert len(keys) == 8 * 2 + 2
            assert all(meta.read_checkpoints(DS, s) for s in range(2))
        finally:
            probe.close()
            meta.close()
        offsets = [ref_ls.RemoteLog("127.0.0.1", wal_port, DS, s)
                   for s in range(2)]
        assert sum(lg.latest_offset + 1 for lg in offsets) > 0
        for lg in offsets:
            lg.close()
        # the files are the WAL directory's, in the reference's layout
        assert os.path.isdir(tmp_path / "node" / "wal" / DS / "shard-0")
    finally:
        srv.shutdown()


def test_mesh_workers_beside_a_remote_log_get_the_references_config(
        tmp_path, monkeypatch):
    """With ``wal_remote``, mesh workers are configured as the
    reference's node configures them: the node's data and WAL
    directories, which they tail, whatever the remote log holds."""
    from filodb_tpu.parallel import multiproc as ref_mp
    from filodb_tpu_torch.parallel import multiproc as port_mp

    def idle(mod):
        class Idle(mod.MeshWorkerSupervisor):
            def spawn(self):
                self.procs = []
                return self

            def wait_ready(self, timeout_s=0.0):
                raise TimeoutError("not spawned")

            def stop(self, grace_s=0.0):
                pass
        return Idle

    monkeypatch.setattr(ref_mp, "MeshWorkerSupervisor", idle(ref_mp))
    monkeypatch.setattr(port_mp, "MeshWorkerSupervisor", idle(port_mp))
    lsrv = port_ls.LogServer(str(tmp_path / "broker")).start()
    conf = {**NODE, "wal_remote": f"127.0.0.1:{lsrv.port}",
            "mesh_workers": {"enabled": True, "workers": 1,
                             "ready_timeout_s": 0.1}}
    got = {}
    try:
        for side, cls in (("ref", REF), ("port", (FiloServer, ServerConfig))):
            d = str(tmp_path / side)
            kw = {"device": "cpu"} if side == "port" else {}
            srv = boot(*cls, conf, d, **kw)
            try:
                with open(os.path.join(d, "mesh_worker_config.json")) as f:
                    got[side] = json.load(f)
                assert srv.mesh_supervisor is not None
            finally:
                srv.shutdown()
    finally:
        lsrv.stop()
    for side in ("ref", "port"):
        assert got[side]["data_dir"] == str(tmp_path / side)
        assert got[side]["wal_dir"] is None
        assert "wal_remote" not in got[side]
        assert list(got[side]["datasets"]) == [DS]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_deployment_matrix_consul_remote_store_networked_wal(tmp_path):
    """A coordinator and a member process found through Consul (no seed
    anywhere), one chunk-store server as both nodes' durable tier and the
    coordinator's log server as the WAL: no shared filesystem. Ingest
    crosses processes and the coordinator's flushed shards land in the
    remote tier."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_consul_discovery import FakeConsulAgent

    consul = FakeConsulAgent().start()
    tier = port_rs.ChunkStoreServer(root=str(tmp_path / "tier")).start()
    try:
        exec_port, wal_port = _free_port(), _free_port()
        coord_cfg = {
            "node_name": "coord", "data_dir": str(tmp_path / "coord"),
            "http_port": 0, "gateway_port": _free_port(),
            "executor_port": exec_port, "wal_server_port": wal_port,
            "store_remote": f"127.0.0.1:{tier.port}",
            "consul": {"host": "127.0.0.1", "port": consul.port,
                       "service": "filodb"},
            "datasets": {DS: {
                "num_shards": 4, "min_num_nodes": 2, "spread": 1,
                "store": {"max_chunk_size": 50, "groups_per_shard": 2,
                          "retention_ms": 2**60}}},
        }
        member_cfg = {**coord_cfg, "node_name": "member-1",
                      "data_dir": str(tmp_path / "member"),
                      "gateway_port": 0, "executor_port": 0,
                      "wal_server_port": 0,
                      "wal_remote": f"127.0.0.1:{wal_port}"}
        cfg_path = tmp_path / "coord.json"
        cfg_path.write_text(json.dumps(coord_cfg))
        member_path = tmp_path / "member.json"
        member_path.write_text(json.dumps(member_cfg))
        coord = FiloServer(ServerConfig.load(str(cfg_path)),
                           device="cpu").start()
        assert "coord" in consul.services
        member = subprocess.Popen(
            [sys.executable, "-m", "filodb_tpu_torch.standalone",
             "--config", str(member_path), "--device", "cpu"],
            cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            sm = coord.cluster.shard_managers[DS]
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if set(filter(None, sm.mapper.owners)) == \
                        {"coord", "member-1"}:
                    break
                assert member.poll() is None, member.stdout.read()[-3000:]
                time.sleep(0.2)
            assert set(filter(None, sm.mapper.owners)) == \
                {"coord", "member-1"}
            assert coord.cluster.wait_active(DS, 60)
            with socket.create_connection(
                    ("127.0.0.1", coord.gateway.port)) as s:
                for i in range(120):
                    for inst in range(8):
                        ts_ns = (START + i * 10) * 1_000_000_000
                        s.sendall(
                            f"matrix_metric,_ws_=demo,_ns_=App-{inst % 4},"
                            f"instance=i{inst} value={i} {ts_ns}\n".encode())
            count = 0.0
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                coord.gateway.sink.flush()
                code, body = _get(coord.http.port,
                                  f"/promql/{DS}/api/v1/query_range",
                                  query="count(matrix_metric)",
                                  start=START + 1000, end=START + 1000,
                                  step=60)
                res = json.loads(body)["data"]["result"] if code == 200 \
                    else []
                if res:
                    count = float(res[0]["values"][0][1])
                    if count == 8:
                        break
                time.sleep(0.3)
            assert count == 8.0
            flushed, expected = [], 0
            for sh, owner in enumerate(sm.mapper.owners):
                if owner == "coord":
                    shard = coord.node.memstores[DS].shards[sh]
                    shard.flush_all()
                    flushed.append(sh)
                    expected += shard.num_partitions
            assert flushed and expected >= 1
            probe = ref_rs.RemoteColumnStore("127.0.0.1", tier.port)
            try:
                tiered = sum(len(probe.scan_part_keys(DS, sh))
                             for sh in flushed)
            finally:
                probe.close()
            assert tiered >= expected
        finally:
            member.send_signal(signal.SIGTERM)
            try:
                member.wait(timeout=20)
            except subprocess.TimeoutExpired:
                member.kill()
                member.wait(timeout=10)
            coord.shutdown()
        assert "coord" not in consul.services
    finally:
        tier.shutdown()
        consul.stop()
