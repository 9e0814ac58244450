"""Networked ColumnStore: chunk-server + remote client behind the same API.

Copy of ``filodb_tpu/core/store/remotestore.py`` over the port's row
interface (``core/store/api.py``). The wire is the reference's message
set, so the port's ``RemoteColumnStore`` works against the reference's
``ChunkStoreServer`` and the reference's client against the port's
server; chunks travel as ``memory/chunk.py::Chunk.serialize`` bytes,
which both packages write alike.

The port's store takes the chunks of many part keys in one call
(``write_chunk_rows``, ``read_chunk_rows``); the wire carries one part
key a frame, as the reference's ``write_chunks`` / ``read_chunks`` do.
The client groups rows by part key and sends one call's requests on
one pooled connection, a few ahead of their answers; the server maps
each frame back onto its backing store's rows. Interfaces the wire does not carry behave as the
reference's remote store's do: migration manifests stay in the client's
process (``ColumnStore``'s dict) and the cost model's estimates in the
meta-store client's (``MetaStore``'s).

Scan splits: part keys hash (crc32 of the key blob, ``api.split_of``)
into ``n_splits`` token ranges; ``scan_part_keys_split`` filters
SERVER-side so parallel scan clients (downsampler, repair jobs) each pull
only their range, the reference's ``getScanSplits`` analog.

Protocol messages (typed wire codec, one request per frame):
    ("write_chunks", ds, shard, pk_blob, [chunk_bytes], ingestion_time)
    ("read_chunks",  ds, shard, pk_blob, start, end) -> ("ok", [bytes])
    ("write_pks",    ds, shard, [(pk_blob, st, et)])
    ("scan_pks",     ds, shard, split, n_splits) -> ("ok", [(blob, st, et)])
    ("scan_pks_since", ds, shard, token)
    ("scan_ingest",  ds, shard, start, end) -> ("ok", [(blob, [bytes])])
    ("max_ts", ds, shard) / ("max_ts_since", ds, shard, token)
    ("tokens", ds, shard) -> ("ok", (chunk_token, pk_token))
    ("delete_pks", ds, shard, [blobs]) | ("truncate", ds)
    ("write_snap", ds, shard, bytes) | ("read_snap", ds, shard)
    ("write_cp", ds, shard, group, off) | ("read_cps", ds, shard)
    ("initialize", ds, num_shards) | ("ping",)
"""

from __future__ import annotations

import logging
import re
import socket
import threading

from filodb_tpu_torch.coordinator.remote import (
    TRANSPORT_ERRORS,
    _recv_frame,
    _recv_msg,
    _send_msg,
    cluster_secret,
    make_authed_handler,
)
from filodb_tpu_torch.core.store.api import (
    ColumnStore,
    MetaStore,
    PartKeyRecord,
    pk_from_blob,
    split_of,
)
from filodb_tpu_torch.kafka.log_server import NoDelayTCPServer
from filodb_tpu_torch.memory.chunk import chunk_header
from filodb_tpu_torch.utils.metrics import get_counter
from filodb_tpu_torch.utils.resilience import FaultInjector, breaker_for

log = logging.getLogger(__name__)

_SAFE_NAME = re.compile(r"[A-Za-z0-9_.-]{1,128}\Z")

# one scan reply is materialized in memory before send; scans beyond this
# must use split scans (which is what the parallel jobs do anyway)
MAX_SCAN_ROWS = 200_000

# requests a connection sends ahead of their answers. No message is large
# both ways (chunks go out with a short answer, or come back for a short
# request), so neither end waits on the other's full buffer
_IN_FLIGHT = 16

# the client's requests and the bytes it sent and received, by message
# kind: what a flush, a recovery and a page-in cost on the wire
_WIRE: dict[str, tuple] = {}

__all__ = ["ChunkStoreServer", "RemoteColumnStore", "RemoteMetaStore",
           "StoreOpError", "split_of", "wire_counters", "MAX_SCAN_ROWS"]


def wire_counters(op: str, sent: int = 0, received: int = 0) -> tuple:
    """The (requests, bytes sent, bytes received) counters of ``op``,
    moved by one request of those sizes."""
    c = _WIRE.get(op)
    if c is None:
        tags = {"op": op}
        c = _WIRE[op] = (
            get_counter("filodb_remote_store_requests", tags),
            get_counter("filodb_remote_store_bytes_sent", tags),
            get_counter("filodb_remote_store_bytes_received", tags))
    if sent or received:
        c[0].inc()
        c[1].inc(sent)
        c[2].inc(received)
    return c


class StoreOpError(RuntimeError):
    """Deterministic server-side ('err', ...) reply — do not retry."""


def _validate_target(dataset, shard) -> str | None:
    if not isinstance(dataset, str) or not _SAFE_NAME.fullmatch(dataset) \
            or dataset in (".", ".."):
        return f"invalid dataset name {dataset!r}"
    if not isinstance(shard, int) or isinstance(shard, bool) or shard < 0 \
            or shard > 1_000_000:
        return f"invalid shard {shard!r}"
    return None


def _by_key(rows) -> list[tuple[bytes, list]]:
    """Rows of (blob, ...) grouped by blob, in first-seen order."""
    groups: dict[bytes, list] = {}
    for r in rows:
        groups.setdefault(bytes(r[0]), []).append(r)
    return list(groups.items())


class ChunkStoreServer:
    """Serves a ColumnStore + MetaStore over TCP (the database-server role).

    ``backing``/``meta`` default to the local-disk sqlite store rooted at
    ``root`` — the reference's directory layout, now reachable across
    hosts.
    """

    def __init__(self, root: str | None = None, host: str = "127.0.0.1",
                 port: int = 0, backing: ColumnStore | None = None,
                 meta: MetaStore | None = None, secret: str | None = None):
        if backing is None or meta is None:
            from filodb_tpu_torch.core.store.localstore import (
                LocalDiskColumnStore,
                LocalDiskMetaStore,
            )
            assert root is not None, "root required without explicit stores"
            backing = backing or LocalDiskColumnStore(root)
            meta = meta or LocalDiskMetaStore(root)
        self.store = backing
        self.meta = meta
        self.secret = secret if secret is not None else cluster_secret()
        Handler = make_authed_handler(lambda: self.secret, self._handle,
                                      "chunk store")

        self.server = NoDelayTCPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)

    def start(self) -> "ChunkStoreServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    # -- request handling --------------------------------------------------

    def _handle(self, msg):  # noqa: C901
        kind = msg[0]
        try:
            if kind == "ping":
                return ("pong",)
            if kind == "initialize":
                _, ds, num_shards = msg
                if not isinstance(ds, str) or not _SAFE_NAME.fullmatch(ds):
                    return ("err", f"invalid dataset name {ds!r}")
                self.store.initialize(ds, int(num_shards))
                return ("ok", True)
            if kind == "truncate":
                _, ds = msg
                if not isinstance(ds, str) or not _SAFE_NAME.fullmatch(ds):
                    return ("err", f"invalid dataset name {ds!r}")
                self.store.truncate(ds)
                return ("ok", True)
            bad = _validate_target(msg[1], msg[2])
            if bad is not None:
                return ("err", bad)
            _, ds, shard = msg[:3]
            rest = msg[3:]
            if kind == "write_chunks":
                pk_blob, chunk_bytes, itime = rest
                blob = bytes(pk_blob)
                rows = []
                for b in chunk_bytes:
                    cid, _, st, et = chunk_header(b)
                    rows.append((blob, cid, st, et, bytes(b)))
                self.store.write_chunk_rows(ds, shard, rows, int(itime))
                return ("ok", True)
            if kind == "read_chunks":
                pk_blob, st, et = rest
                rows = self.store.read_chunk_rows(ds, shard, [bytes(pk_blob)],
                                                  int(st), int(et))
                # the reference's stores answer in chunk-id order
                data = sorted((bytes(d) for _, d in rows),
                              key=lambda d: chunk_header(d)[0])
                return ("ok", data)
            if kind == "write_pks":
                (recs,) = rest
                self.store.write_part_keys(ds, shard, [
                    PartKeyRecord(pk_from_blob(b), int(st), int(et))
                    for b, st, et in recs])
                return ("ok", True)
            if kind in ("scan_pks", "scan_pks_since"):
                if kind == "scan_pks":
                    split, n_splits = rest
                    recs = self.store.scan_part_keys(ds, shard)
                    if n_splits and n_splits > 1:
                        recs = [r for r in recs
                                if split_of(r.part_key.serialized,
                                            n_splits) == split]
                else:
                    (token,) = rest
                    recs = self.store.scan_part_keys_since(ds, shard,
                                                           int(token))
                recs = recs[:MAX_SCAN_ROWS]
                return ("ok", [(r.part_key.serialized, r.start_time,
                                r.end_time) for r in recs])
            if kind == "scan_ingest":
                start, end = rest
                out = []
                for blob, rows in _by_key(
                        self.store.scan_chunk_rows_by_ingestion_time(
                            ds, shard, int(start), int(end))):
                    out.append((blob, [bytes(d) for _, d in rows]))
                    if len(out) >= MAX_SCAN_ROWS:
                        break
                return ("ok", out)
            if kind == "delete_pks":
                (blobs,) = rest
                self.store.delete_part_keys(
                    ds, shard, [pk_from_blob(b) for b in blobs])
                return ("ok", True)
            if kind in ("max_ts", "max_ts_since"):
                if kind == "max_ts":
                    d = self.store.max_persisted_ts(ds, shard)
                else:
                    d = self.store.max_persisted_ts_since(ds, shard,
                                                          int(rest[0]))
                return ("ok", [(bytes(b), ts) for b, ts in d.items()])
            if kind == "tokens":
                return ("ok", tuple(self.store.update_tokens(ds, shard)))
            if kind == "write_snap":
                (data,) = rest
                self.store.write_index_snapshot(ds, shard, data)
                return ("ok", True)
            if kind == "read_snap":
                return ("ok", self.store.read_index_snapshot(ds, shard))
            if kind == "write_cp":
                group, off = rest
                self.meta.write_checkpoint(ds, shard, int(group), int(off))
                return ("ok", True)
            if kind == "read_cps":
                return ("ok", list(self.meta.read_checkpoints(
                    ds, shard).items()))
            return ("err", f"unknown message {kind!r}")
        except StoreOpError as e:
            return ("err", str(e))
        except Exception as e:  # noqa: BLE001 — protocol boundary
            log.exception("chunk store op %s failed", kind)
            return ("err", f"{type(e).__name__}: {e}")


class _RemoteConn:
    """One pooled authed connection with reconnect-on-transport-error.

    A pooled socket may have gone stale since the previous op (server
    restart, idle timeout); the first transport failure on a pooled socket
    is therefore retried once on a fresh connection before surfacing. The
    peer's circuit breaker short-circuits calls while the store is down.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.peer = f"{host}:{port}"
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None

    def _conn_locked(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
            # the fd is owned-but-unpublished until self._sock = s; any
            # exception before that (setsockopt, auth) must close it
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                secret = cluster_secret()
                if secret is not None:
                    _send_msg(s, ("auth", secret))
                    if _recv_msg(s)[0] != "ok":
                        raise ConnectionError("chunk store auth rejected")
            except BaseException:
                try:
                    s.close()
                except OSError:
                    pass
                raise
            self._sock = s
        return self._sock

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _pipelined(self, msgs: list[tuple]) -> list:
        """``msgs`` on this connection with up to ``_IN_FLIGHT`` requests
        sent ahead of their answers (the server answers a connection's
        requests in order); the answers in order."""
        sock = self._conn_locked()
        out = []
        for i in range(0, len(msgs), _IN_FLIGHT):
            part = msgs[i:i + _IN_FLIGHT]
            sent = []
            for msg in part:
                FaultInjector.fire("store.call", host=self.host,
                                   port=self.port, op=msg[0])
                sent.append(_send_msg(sock, msg))
            for msg, n in zip(part, sent):
                resp, got = _recv_frame(sock)
                wire_counters(msg[0], n, got)
                out.append(resp)
        return out

    def call(self, *msg):
        return self.call_many([msg])[0]

    def call_many(self, msgs: list[tuple]) -> list:
        """Each request of ``msgs`` in turn on this connection, pipelined;
        their answers in order. Every request is idempotent, so a stale
        pooled socket's failure is retried once, whole, on a fresh one;
        a server's error answer raises once every answer is read."""
        breaker = breaker_for(self.peer)
        # same transport set as RemotePlanDispatcher (EOFError/ValueError
        # cover decode errors off a half-dead store); calling() guarantees
        # every admitted call — including a half-open probe — reports
        # exactly one breaker outcome even if an unexpected error escapes
        with breaker.calling(transport_errors=TRANSPORT_ERRORS):
            with self._lock:
                pooled = self._sock is not None
                try:
                    try:
                        resps = self._pipelined(msgs)
                    except TRANSPORT_ERRORS:
                        self._drop_locked()
                        if not pooled:
                            raise
                        # stale pooled socket: one retry on a fresh
                        # connection
                        resps = self._pipelined(msgs)
                except TRANSPORT_ERRORS:
                    self._drop_locked()
                    raise
        out = []
        for resp in resps:
            if resp[0] == "ok":
                out.append(resp[1])
            elif resp[0] == "pong":
                out.append(True)
            else:
                raise StoreOpError(f"chunk store op failed: {resp[1]}")
        return out

    def close(self) -> None:
        with self._lock:
            self._drop_locked()


class RemoteColumnStore(ColumnStore):
    """ColumnStore client over a ``ChunkStoreServer`` — the Cassandra-
    ColumnStore analog: remote durability with server-side scan splits."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 pool: int = 4):
        self._conns = [_RemoteConn(host, port, timeout) for _ in range(pool)]
        self._rr = 0

    def _calls(self, msgs: list[tuple]) -> list:
        """``msgs`` pipelined on the next pooled connection; the answers
        in order."""
        # round-robin over pooled connections: parallel split scans and
        # concurrent flush groups don't serialize on one socket
        self._rr = (self._rr + 1) % len(self._conns)
        return self._conns[self._rr].call_many(msgs)

    def _call(self, *msg):
        return self._calls([msg])[0]

    def initialize(self, dataset, num_shards):
        self._call("initialize", dataset, num_shards)

    def write_chunk_rows(self, dataset, shard, rows, ingestion_time):
        self._calls([("write_chunks", dataset, shard, blob,
                        [bytes(r[4]) for r in group], ingestion_time)
                       for blob, group in _by_key(rows)])

    def read_chunk_rows(self, dataset, shard, blobs, start_time, end_time):
        keys = sorted({bytes(b) for b in blobs})
        answers = self._calls([("read_chunks", dataset, shard, blob,
                                  start_time, end_time) for blob in keys])
        return [(blob, data) for blob, datas in zip(keys, answers)
                for data in datas]

    def write_part_keys(self, dataset, shard, records):
        self._call("write_pks", dataset, shard,
                   [(r.part_key.serialized, r.start_time, r.end_time)
                    for r in records])

    @staticmethod
    def _pks(rows):
        return [PartKeyRecord(pk_from_blob(b), st, et)
                for b, st, et in rows]

    def scan_part_keys(self, dataset, shard):
        return self._pks(self._call("scan_pks", dataset, shard, 0, 1))

    def scan_part_keys_split(self, dataset, shard, split, n_splits):
        """One token-range split, filtered server-side (``getScanSplits``)."""
        return self._pks(self._call("scan_pks", dataset, shard, split,
                                    n_splits))

    def scan_part_keys_since(self, dataset, shard, pk_token):
        return self._pks(self._call("scan_pks_since", dataset, shard,
                                    pk_token))

    def scan_chunk_rows_by_ingestion_time(self, dataset, shard, start, end):
        return [(bytes(blob), data)
                for blob, datas in self._call("scan_ingest", dataset, shard,
                                              start, end)
                for data in datas]

    def truncate(self, dataset):
        self._call("truncate", dataset)

    def delete_part_keys(self, dataset, shard, part_keys):
        self._call("delete_pks", dataset, shard,
                   [pk.serialized for pk in part_keys])

    def max_persisted_ts(self, dataset, shard):
        return {bytes(b): ts for b, ts in self._call("max_ts", dataset,
                                                     shard)}

    def max_persisted_ts_since(self, dataset, shard, chunk_token):
        return {bytes(b): ts
                for b, ts in self._call("max_ts_since", dataset, shard,
                                        chunk_token)}

    def update_tokens(self, dataset, shard):
        return tuple(self._call("tokens", dataset, shard))

    def write_index_snapshot(self, dataset, shard, data):
        self._call("write_snap", dataset, shard, bytes(data))

    def read_index_snapshot(self, dataset, shard):
        return self._call("read_snap", dataset, shard)

    def close(self):
        for c in self._conns:
            c.close()


class RemoteMetaStore(MetaStore):
    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._conn = _RemoteConn(host, port, timeout)

    def write_checkpoint(self, dataset, shard, group, offset):
        self._conn.call("write_cp", dataset, shard, group, offset)

    def read_checkpoints(self, dataset, shard):
        return dict(self._conn.call("read_cps", dataset, shard))

    def close(self):
        self._conn.close()
