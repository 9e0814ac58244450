"""Kafka wire-protocol client + ingestion adapter.

Copy of ``filodb_tpu/kafka/kafka_protocol.py``: the same bytes on the
wire (``tests/test_torch_kafka_protocol.py`` holds the codec against the
reference's and each package's client against the other's broker).

Counterpart of the reference's Kafka module
(``kafka/src/main/scala/filodb.kafka/KafkaIngestionStream.scala:24,63``):
shards consume an EXTERNAL Kafka broker — one topic partition per shard,
message values are binary RecordContainer bytes, Kafka offsets are the
ingestion offsets that flush-group checkpoints record.

This is a real wire-protocol implementation (not a fake transport): framed
requests with the v0/v1 header, ApiVersions/Metadata/ListOffsets/Fetch/
Produce at protocol version 0, and MessageSet v0 entries with CRC-checked
messages — the subset every Kafka broker since 0.8 speaks. No external
client library; the environment has no egress, so tests run against
``FakeKafkaBroker`` (same module), which implements the same wire format
server-side; pointing ``KafkaReplayLog`` at a real broker is a host:port
change.

``KafkaReplayLog`` adapts the protocol client to the ``ReplayLog`` SPI
(``kafka/log.py``) — the consumer SPI's second, external-broker
implementation beside ``RemoteLog``/``SegmentedFileLog``.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import zlib
from dataclasses import dataclass

from filodb_tpu_torch.core.record import (
    BytesContainer,
    RecordContainer,
    SomeData,
)
from filodb_tpu_torch.kafka.log import ReplayLog
from filodb_tpu_torch.kafka.log_server import LogOpError

log = logging.getLogger(__name__)

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_VERSIONS = 18

ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC = 3

_TS_LATEST = -1
_TS_EARLIEST = -2


# ---------------------------------------------------------------------------
# primitive codec


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def i8(self, v):
        self.parts.append(struct.pack(">b", v))
        return self

    def i16(self, v):
        self.parts.append(struct.pack(">h", v))
        return self

    def i32(self, v):
        self.parts.append(struct.pack(">i", v))
        return self

    def i64(self, v):
        self.parts.append(struct.pack(">q", v))
        return self

    def string(self, s: str | None):
        if s is None:
            return self.i16(-1)
        b = s.encode("utf-8")
        self.i16(len(b))
        self.parts.append(b)
        return self

    def bytes_(self, b: bytes | None):
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self.parts.append(b)
        return self

    def raw(self, b: bytes):
        self.parts.append(b)
        return self

    def done(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def i8(self):
        v = struct.unpack_from(">b", self.d, self.o)[0]
        self.o += 1
        return v

    def i16(self):
        v = struct.unpack_from(">h", self.d, self.o)[0]
        self.o += 2
        return v

    def i32(self):
        v = struct.unpack_from(">i", self.d, self.o)[0]
        self.o += 4
        return v

    def i64(self):
        v = struct.unpack_from(">q", self.d, self.o)[0]
        self.o += 8
        return v

    def string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        s = self.d[self.o : self.o + n].decode("utf-8")
        self.o += n
        return s

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        b = self.d[self.o : self.o + n]
        self.o += n
        return b

    def raw(self, n: int) -> bytes:
        b = self.d[self.o : self.o + n]
        self.o += n
        return b

    @property
    def remaining(self) -> int:
        return len(self.d) - self.o


# ---------------------------------------------------------------------------
# MessageSet v0


def encode_message(key: bytes | None, value: bytes | None) -> bytes:
    """One Message v0: crc | magic=0 | attributes=0 | key | value."""
    body = _Writer().i8(0).i8(0).bytes_(key).bytes_(value).done()
    return struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body


def encode_message_set(entries: list[tuple[int, bytes | None, bytes | None]]
                       ) -> bytes:
    """[(offset, key, value)] -> MessageSet v0 bytes."""
    w = _Writer()
    for off, key, value in entries:
        msg = encode_message(key, value)
        w.i64(off).i32(len(msg)).raw(msg)
    return w.done()


def decode_message_set(data: bytes) -> list[tuple[int, bytes | None,
                                                  bytes | None]]:
    """MessageSet v0 bytes -> [(offset, key, value)]; a trailing partial
    message (Kafka truncates at max_bytes) is ignored."""
    out = []
    r = _Reader(data)
    while r.remaining >= 12:
        off = r.i64()
        size = r.i32()
        if size < 14 or r.remaining < size:
            break  # partial trailing message
        msg = r.raw(size)
        (crc,) = struct.unpack_from(">I", msg, 0)
        body = msg[4:]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError(f"kafka message crc mismatch at offset {off}")
        mr = _Reader(body)
        magic = mr.i8()
        mr.i8()  # attributes (no compression support needed)
        if magic != 0:
            raise ValueError(f"unsupported message magic {magic}")
        key = mr.bytes_()
        value = mr.bytes_()
        out.append((off, key, value))
    return out


# ---------------------------------------------------------------------------
# client


class KafkaProtocolError(RuntimeError):
    def __init__(self, code: int, where: str):
        super().__init__(f"kafka error {code} in {where}")
        self.code = code


class KafkaProtocolClient:
    """Minimal blocking Kafka client: one broker connection, v0 APIs."""

    def __init__(self, host: str, port: int, client_id: str = "filodb",
                 timeout: float = 30.0):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._corr = 0
        self._lock = threading.Lock()

    # -- transport --

    def _conn_locked(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
            # the fd is owned-but-unpublished until self._sock = s
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except BaseException:
                try:
                    s.close()
                except OSError:
                    pass
                raise
            self._sock = s
        return self._sock

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _roundtrip(self, api_key: int, api_version: int, body: bytes
                   ) -> _Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = _Writer().i16(api_key).i16(api_version).i32(corr) \
                .string(self.client_id).done()
            frame = header + body
            try:
                sock = self._conn_locked()
                sock.sendall(struct.pack(">i", len(frame)) + frame)
                resp = self._read_frame(sock)
            except (ConnectionError, OSError):
                self.close()
                raise
        r = _Reader(resp)
        got_corr = r.i32()
        if got_corr != corr:
            # response-stream desync: transport-class failure (a fresh
            # connection may recover), not a deterministic server answer
            self.close()
            raise ConnectionError(
                f"correlation id mismatch {got_corr} != {corr}")
        return r

    @staticmethod
    def _read_frame(sock: socket.socket) -> bytes:
        head = b""
        while len(head) < 4:
            chunk = sock.recv(4 - len(head))
            if not chunk:
                raise ConnectionError("kafka broker closed connection")
            head += chunk
        (size,) = struct.unpack(">i", head)
        if size < 0 or size > 1 << 30:
            raise ConnectionError(f"bad kafka frame size {size}")
        buf = bytearray()
        while len(buf) < size:
            chunk = sock.recv(min(1 << 20, size - len(buf)))
            if not chunk:
                raise ConnectionError("kafka broker closed mid-frame")
            buf.extend(chunk)
        return bytes(buf)

    # -- APIs (all protocol version 0) --

    def api_versions(self) -> dict[int, tuple[int, int]]:
        r = self._roundtrip(API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise KafkaProtocolError(err, "api_versions")
        out = {}
        for _ in range(r.i32()):
            k, lo, hi = r.i16(), r.i16(), r.i16()
            out[k] = (lo, hi)
        return out

    def metadata(self, topics: list[str] | None = None):
        w = _Writer()
        topics = topics or []
        w.i32(len(topics))
        for t in topics:
            w.string(t)
        r = self._roundtrip(API_METADATA, 0, w.done())
        brokers = []
        for _ in range(r.i32()):
            node = r.i32()
            host = r.string()
            port = r.i32()
            brokers.append((node, host, port))
        out_topics = {}
        for _ in range(r.i32()):
            terr = r.i16()
            name = r.string()
            parts = {}
            for _ in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                replicas = [r.i32() for _ in range(r.i32())]
                isr = [r.i32() for _ in range(r.i32())]
                parts[pid] = {"error": perr, "leader": leader,
                              "replicas": replicas, "isr": isr}
            out_topics[name] = {"error": terr, "partitions": parts}
        return {"brokers": brokers, "topics": out_topics}

    def list_offsets(self, topic: str, partition: int,
                     timestamp: int = _TS_LATEST) -> int:
        """Earliest (-2) or latest (-1, = next offset to be assigned)."""
        w = _Writer().i32(-1).i32(1)
        w.string(topic).i32(1).i32(partition).i64(timestamp).i32(1)
        r = self._roundtrip(API_LIST_OFFSETS, 0, w.done())
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                offs = [r.i64() for _ in range(r.i32())]
                if err:
                    raise KafkaProtocolError(err, "list_offsets")
                return offs[0] if offs else 0
        raise ConnectionError("empty list_offsets response")

    def produce(self, topic: str, partition: int,
                entries: list[tuple[bytes | None, bytes]],
                acks: int = 1, timeout_ms: int = 10_000) -> int:
        """Append [(key, value)]; returns the base offset assigned."""
        mset = encode_message_set([(0, k, v) for k, v in entries])
        w = _Writer().i16(acks).i32(timeout_ms).i32(1)
        w.string(topic).i32(1).i32(partition).i32(len(mset)).raw(mset)
        r = self._roundtrip(API_PRODUCE, 0, w.done())
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                base = r.i64()
                if err:
                    raise KafkaProtocolError(err, "produce")
                return base
        raise ConnectionError("empty produce response")

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 100,
              min_bytes: int = 1) -> tuple[int, list]:
        """-> (high_watermark, [(offset, key, value)])."""
        w = _Writer().i32(-1).i32(max_wait_ms).i32(min_bytes).i32(1)
        w.string(topic).i32(1).i32(partition).i64(offset).i32(max_bytes)
        r = self._roundtrip(API_FETCH, 0, w.done())
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                hw = r.i64()
                mset = r.bytes_() or b""
                if err:
                    raise KafkaProtocolError(err, "fetch")
                return hw, decode_message_set(mset)
        raise ConnectionError("empty fetch response")


# ---------------------------------------------------------------------------
# ReplayLog adapter (the KafkaIngestionStream analog)


class KafkaReplayLog(ReplayLog):
    """One shard's ingest log backed by one Kafka topic partition.

    Mirrors the reference's stream contract
    (``KafkaIngestionStream.scala:63``): partition == shard, message value
    == RecordContainer bytes, Kafka offset == checkpointed ingest offset.
    """

    def __init__(self, host: str, port: int, topic: str, partition: int,
                 client_id: str = "filodb-ingest", fetch_bytes: int = 1 << 20):
        self.topic = topic
        self.partition = partition
        self.fetch_bytes = fetch_bytes
        # separate producer and consumer connections (as real Kafka
        # clients use): a fetch long-poll must not block appends behind
        # the shared per-connection lock
        self.client = KafkaProtocolClient(host, port, client_id)
        self._consumer = KafkaProtocolClient(host, port,
                                             client_id + "-consumer")

    def append(self, container: RecordContainer) -> int:
        try:
            return self.client.produce(self.topic, self.partition,
                                       [(None, container.serialize())])
        except KafkaProtocolError as e:
            raise LogOpError(f"kafka produce failed: {e}") from e

    def read_from(self, offset: int):
        cur = max(offset, 0)
        while True:
            try:
                hw, msgs = self._consumer.fetch(self.topic, self.partition,
                                                cur,
                                                max_bytes=self.fetch_bytes)
            except KafkaProtocolError as e:
                if e.code == ERR_OFFSET_OUT_OF_RANGE:
                    earliest = self._consumer.list_offsets(
                        self.topic, self.partition, _TS_EARLIEST)
                    if earliest > cur:
                        cur = earliest  # log head truncated past us
                        continue
                    return
                # deterministic broker answer (missing topic, ...) — the
                # ingest worker's LogOpError path must see it, not retry
                # it as a transport flap
                raise LogOpError(f"kafka fetch failed: {e}") from e
            except ValueError as e:  # corrupt message set (CRC)
                raise LogOpError(f"kafka fetch corrupt: {e}") from e
            if not msgs:
                return
            for off, _key, value in msgs:
                # cur advances for EVERY decoded message — a tombstone or
                # duplicate must not wedge the poll loop on one offset
                advanced = max(cur, off + 1)
                if off >= cur and value is not None:
                    yield SomeData(BytesContainer(value), off)
                cur = advanced

    @property
    def latest_offset(self) -> int:
        try:
            # Kafka "latest" is the NEXT offset; ReplayLog wants the last
            return self.client.list_offsets(self.topic, self.partition,
                                            _TS_LATEST) - 1
        except KafkaProtocolError as e:
            raise LogOpError(f"kafka list_offsets failed: {e}") from e

    def align_after(self, offset: int) -> None:
        """No-op: the broker assigns strictly increasing offsets and never
        reuses them, so checkpointed offsets cannot collide after a crash
        (the property SegmentedFileLog must enforce by rolling segments)."""

    def close(self) -> None:
        self.client.close()
        self._consumer.close()


# ---------------------------------------------------------------------------
# protocol-level fake broker (tests; no egress in this environment)


@dataclass
class _PartitionLog:
    entries: list  # [(key, value)]
    base: int = 0  # earliest retained offset


class FakeKafkaBroker:
    """In-process TCP server speaking the same v0 wire protocol.

    This is a PROTOCOL fake, not a transport fake: it parses real request
    frames and emits real responses (CRC'd MessageSet v0 and all), so the
    client code it validates works against an actual broker unchanged.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._logs: dict[tuple[str, int], _PartitionLog] = {}
        self._lock = threading.Lock()
        self._listen = socket.socket()
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(16)
        self.host, self.port = self._listen.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)

    def start(self) -> "FakeKafkaBroker":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listen.close()
        except OSError:
            pass

    def create_topic(self, topic: str, partitions: int) -> None:
        with self._lock:
            for p in range(partitions):
                self._logs.setdefault((topic, p), _PartitionLog([]))

    def truncate_before(self, topic: str, partition: int,
                        offset: int) -> None:
        """Simulate retention: drop entries below ``offset``."""
        with self._lock:
            lg = self._logs[(topic, partition)]
            drop = max(0, min(offset - lg.base, len(lg.entries)))
            lg.entries = lg.entries[drop:]
            lg.base += drop

    # -- server loop --

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listen.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                try:
                    frame = KafkaProtocolClient._read_frame(conn)
                except (ConnectionError, ValueError, OSError):
                    return
                r = _Reader(frame)
                api_key = r.i16()
                api_version = r.i16()
                corr = r.i32()
                r.string()  # client_id
                if api_version != 0:
                    return  # v0-only fake: drop the connection
                body = self._dispatch(api_key, r)
                if body is None:
                    return
                resp = struct.pack(">i", len(body) + 4) \
                    + struct.pack(">i", corr) + body
                conn.sendall(resp)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, api_key: int, r: _Reader) -> bytes | None:
        if api_key == API_VERSIONS:
            w = _Writer().i16(0).i32(4)
            for k in (API_PRODUCE, API_FETCH, API_LIST_OFFSETS,
                      API_METADATA):
                w.i16(k).i16(0).i16(0)
            return w.done()
        if api_key == API_METADATA:
            n = r.i32()
            asked = [r.string() for _ in range(n)]
            with self._lock:
                names = {t for t, _ in self._logs}
            if asked:
                names &= set(asked)
            w = _Writer().i32(1).i32(0).string(self.host).i32(self.port)
            w.i32(len(names))
            for t in sorted(names):
                with self._lock:
                    parts = sorted(p for tt, p in self._logs if tt == t)
                w.i16(0).string(t).i32(len(parts))
                for p in parts:
                    w.i16(0).i32(p).i32(0).i32(1).i32(0).i32(1).i32(0)
            return w.done()
        if api_key == API_LIST_OFFSETS:
            r.i32()  # replica
            w = _Writer()
            n_topics = r.i32()
            w.i32(n_topics)
            for _ in range(n_topics):
                topic = r.string()
                nparts = r.i32()
                w.string(topic).i32(nparts)
                for _ in range(nparts):
                    pid = r.i32()
                    ts = r.i64()
                    r.i32()  # max offsets
                    with self._lock:
                        lg = self._logs.get((topic, pid))
                    if lg is None:
                        w.i32(pid).i16(ERR_UNKNOWN_TOPIC).i32(0)
                        continue
                    off = lg.base if ts == _TS_EARLIEST \
                        else lg.base + len(lg.entries)
                    w.i32(pid).i16(0).i32(1).i64(off)
            return w.done()
        if api_key == API_PRODUCE:
            r.i16()  # acks
            r.i32()  # timeout
            w = _Writer()
            n_topics = r.i32()
            w.i32(n_topics)
            for _ in range(n_topics):
                topic = r.string()
                nparts = r.i32()
                w.string(topic).i32(nparts)
                for _ in range(nparts):
                    pid = r.i32()
                    size = r.i32()
                    mset = r.raw(size)
                    try:
                        msgs = decode_message_set(mset)
                    except ValueError:
                        w.i32(pid).i16(2).i64(-1)  # CORRUPT_MESSAGE
                        continue
                    with self._lock:
                        lg = self._logs.setdefault((topic, pid),
                                                   _PartitionLog([]))
                        base = lg.base + len(lg.entries)
                        for _off, key, value in msgs:
                            lg.entries.append((key, value))
                    w.i32(pid).i16(0).i64(base)
            return w.done()
        if api_key == API_FETCH:
            r.i32()  # replica
            r.i32()  # max_wait
            r.i32()  # min_bytes
            w = _Writer()
            n_topics = r.i32()
            w.i32(n_topics)
            for _ in range(n_topics):
                topic = r.string()
                nparts = r.i32()
                w.string(topic).i32(nparts)
                for _ in range(nparts):
                    pid = r.i32()
                    off = r.i64()
                    max_bytes = r.i32()
                    with self._lock:
                        lg = self._logs.get((topic, pid))
                        if lg is None:
                            w.i32(pid).i16(ERR_UNKNOWN_TOPIC).i64(-1).i32(0)
                            continue
                        hw = lg.base + len(lg.entries)
                        if off < lg.base or off > hw:
                            w.i32(pid).i16(ERR_OFFSET_OUT_OF_RANGE) \
                                .i64(hw).i32(0)
                            continue
                        sel = []
                        total = 0
                        for i in range(off - lg.base, len(lg.entries)):
                            key, value = lg.entries[i]
                            sel.append((lg.base + i, key, value))
                            total += 26 + len(key or b"") + len(value or b"")
                            if total >= max_bytes:
                                break
                    mset = encode_message_set(sel)
                    w.i32(pid).i16(0).i64(hw).i32(len(mset)).raw(mset)
            return w.done()
        return None  # unknown api: drop connection
