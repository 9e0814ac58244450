"""Networked ingest log: the Kafka-contract transport.

Copy of ``filodb_tpu/kafka/log_server.py`` over the port's framed
transport (``coordinator/remote.py``): the same messages, so the port's
``RemoteLog`` reads a reference ``LogServer`` and the other way round.

Counterpart of the reference's Kafka ingestion path
(``kafka/src/main/scala/filodb/kafka/KafkaIngestionStream.scala:24,63``): one
log partition == one shard, messages are binary RecordContainer bytes, and
the gateway and shard owners talk to the log over the NETWORK — no shared
filesystem. ``LogServer`` fronts a directory of ``SegmentedFileLog``s (the
"broker"); ``RemoteLog`` implements the ``ReplayLog`` interface over the
framed, secret-authenticated transport shared with plan shipping
(``coordinator/remote.py``).

Protocol messages (typed wire codec):
    ("append", dataset, shard, container_bytes)      -> ("ok", offset)
    ("read",   dataset, shard, from_offset, max_n)   -> ("ok", [(off, bytes)])
    ("latest", dataset, shard)                       -> ("ok", offset)
    ("truncate", dataset, shard, before_offset)      -> ("ok", removed)
    ("align",  dataset, shard, offset)               -> ("ok", True)
"""

from __future__ import annotations

import logging
import os
import re
import socket
import socketserver
import threading

from filodb_tpu_torch.coordinator.remote import (
    _recv_msg,
    _send_msg,
    cluster_secret,
    make_authed_handler,
)
from filodb_tpu_torch.core.record import (
    BytesContainer,
    RecordContainer,
    SomeData,
)
from filodb_tpu_torch.kafka.log import ReplayLog, SegmentedFileLog

log = logging.getLogger(__name__)

# Dataset names come off the wire; they become path components under the
# broker root, so anything outside this alphabet (especially "/" and "..")
# is rejected before the filesystem is touched.
_SAFE_NAME = re.compile(r"[A-Za-z0-9_.-]{1,128}\Z")

# one read reply is materialized fully in memory before send; cap it so a
# single request can't make the broker slurp an entire shard log
MAX_READ_BATCH = 4096


class LogOpError(RuntimeError):
    """A server-side ('err', ...) reply — deterministic, not a transport
    failure. Callers that retry transport errors (ConnectionError/OSError)
    must NOT retry these forever: the server will keep answering the same
    way (corrupt log file, rejected name, oversized read...)."""


def _validate_target(dataset, shard) -> str | None:
    if not isinstance(dataset, str) or not _SAFE_NAME.fullmatch(dataset) \
            or dataset in (".", ".."):
        return f"invalid dataset name {dataset!r}"
    if not isinstance(shard, int) or isinstance(shard, bool) or shard < 0 \
            or shard > 1_000_000:
        return f"invalid shard {shard!r}"
    return None


class NoDelayTCPServer(socketserver.ThreadingTCPServer):
    """A threading server whose connections send without Nagle's delay:
    a reply goes out as two writes (its length, then its body), and a
    body held back until the header's ACK, which the peer delays, costs
    each request 40 ms."""

    allow_reuse_address = True

    def get_request(self):
        sock, addr = super().get_request()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock, addr


class LogServer:
    """Serves a WAL directory over TCP (the broker role)."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 segment_entries: int = 4096, fsync: bool = False,
                 secret: str | None = None):
        self.root = root
        self.secret = secret if secret is not None else cluster_secret()
        self._logs: dict[tuple[str, int], SegmentedFileLog] = {}
        self._lock = threading.Lock()
        self._segment_entries = segment_entries
        self._fsync = fsync
        Handler = make_authed_handler(lambda: self.secret, self._handle,
                                      "log server")

        self.server = NoDelayTCPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)

    def _log(self, dataset: str, shard: int) -> SegmentedFileLog:
        key = (dataset, shard)
        with self._lock:
            lg = self._logs.get(key)
            if lg is None:
                lg = SegmentedFileLog(
                    os.path.join(self.root, dataset, f"shard-{shard}"),
                    segment_entries=self._segment_entries,
                    fsync=self._fsync)
                self._logs[key] = lg
            return lg

    def _handle(self, msg):
        kind = msg[0]
        try:
            if kind == "ping":
                return ("pong",)
            if kind in ("append", "read", "latest", "truncate", "align"):
                bad = _validate_target(msg[1], msg[2])
                if bad is not None:
                    return ("err", bad)
            if kind == "append":
                _, dataset, shard, raw = msg
                off = self._log(dataset, shard).append(BytesContainer(raw))
                return ("ok", off)
            if kind == "read":
                _, dataset, shard, from_off, max_n = msg
                if not isinstance(from_off, int) or not isinstance(max_n, int):
                    return ("err", "invalid read parameters")
                max_n = min(max_n, MAX_READ_BATCH)
                if max_n <= 0:
                    return ("ok", [])
                out = []
                for sd in self._log(dataset, shard).read_from(from_off):
                    out.append((sd.offset, sd.container.serialize()))
                    if len(out) >= max_n:
                        break
                return ("ok", out)
            if kind == "latest":
                _, dataset, shard = msg
                return ("ok", self._log(dataset, shard).latest_offset)
            if kind == "truncate":
                _, dataset, shard, before = msg
                return ("ok",
                        self._log(dataset, shard).truncate_before(before))
            if kind == "align":
                _, dataset, shard, offset = msg
                self._log(dataset, shard).align_after(offset)
                return ("ok", True)
            return ("err", f"unknown message {kind!r}")
        except Exception as e:
            from filodb_tpu_torch.utils.metrics import get_counter
            topic = "?"
            if len(msg) >= 3 and isinstance(msg[1], str):
                topic = f"{msg[1]}/{msg[2]}"
            get_counter("filodb_log_server_errors",
                        {"op": str(kind), "topic": topic}).inc()
            log.exception("log op %s failed for topic %s", kind, topic)
            return ("err", repr(e))

    def start(self) -> "LogServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        with self._lock:
            for lg in self._logs.values():
                lg.close()
            self._logs.clear()


class RemoteLog(ReplayLog):
    """``ReplayLog`` over a ``LogServer`` — the KafkaIngestionStream analog:
    shard owners tail their partition, gateways produce to it, across
    hosts."""

    def __init__(self, host: str, port: int, dataset: str, shard: int,
                 timeout: float = 30.0, read_batch: int = 256):
        self.host = host
        self.port = port
        self.dataset = dataset
        self.shard = shard
        self.timeout = timeout
        # must not exceed the broker's reply cap: read_from detects end-of-
        # log by a short batch, so a client asking for more than the server
        # will ever send would mistake every capped reply for the end
        self.read_batch = min(read_batch, MAX_READ_BATCH)
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
                        raise ConnectionError("log server auth rejected")
            except BaseException:
                try:
                    s.close()
                except OSError:
                    pass
                raise
            self._sock = s
        return self._sock

    def _call(self, *msg):
        with self._lock:
            try:
                sock = self._conn_locked()
                _send_msg(sock, msg)
                resp = _recv_msg(sock)
            except (ConnectionError, OSError):
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                raise
        if resp[0] == "ok":
            return resp[1]
        if resp[0] == "pong":
            return True
        raise LogOpError(f"log op failed: {resp[1]}")

    def append(self, container: RecordContainer) -> int:
        return self._call("append", self.dataset, self.shard,
                          container.serialize())

    def read_from(self, offset: int):
        cur = max(offset, 0)
        while True:
            batch = self._call("read", self.dataset, self.shard, cur,
                               self.read_batch)
            for off, raw in batch:
                yield SomeData(BytesContainer(raw), off)
                cur = off + 1
            if len(batch) < self.read_batch:
                return

    @property
    def latest_offset(self) -> int:
        return self._call("latest", self.dataset, self.shard)

    def truncate_before(self, offset: int) -> int:
        return self._call("truncate", self.dataset, self.shard, offset)

    def align_after(self, offset: int) -> None:
        self._call("align", self.dataset, self.shard, offset)

    def ping(self) -> bool:
        try:
            return bool(self._call("ping"))
        except (ConnectionError, OSError, RuntimeError):
            return False

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
