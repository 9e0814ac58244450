"""The framed TCP transport of the plan wire.

Port of the transport half of ``filodb_tpu/coordinator/remote.py``, the
part the multi-process mesh runtime rides (``coordinator/mesh_cluster.py``,
``parallel/multiproc.py``); the protocol is the reference's byte for byte,
so either package's client talks to the other's server:

- frames: a u32 length word, then one ``coordinator/wire.py`` value; the
  word's high bit flags a zlib payload. Frames of 4 KiB or more are
  compressed once the ``("hello", {"compress": True})`` exchange has
  agreed to it, and inflating is bounded by the frame cap.
- ``make_authed_handler``: a server's connection handler. With a
  ``FILODB_CLUSTER_SECRET`` the first frame must be ``("auth", secret)``
  (compared in constant time; frames before it are capped at 4 KiB),
  then the hello, then one response a request.
- ``RemotePlanDispatcher``: the client. Its sockets live in a process-wide
  pool, one checked out a call and back in after it, keyed by peer;
  ``_roundtrip`` is one request and its response, ``_drop_conn`` closes a
  peer's idle sockets, ``ping`` the liveness probe.
  Any transport error (``TRANSPORT_ERRORS``, a malformed frame among them)
  closes the socket it happened on.

Shipping exec plans (``PlanExecutorServer``, ``dispatch`` with partial
scatter-gather, aggregation pushdown and ``wireBytes``) comes with remote
plan dispatch (ROADMAP A7).
"""

from __future__ import annotations

import hmac
import logging
import os
import socket
import socketserver
import struct
import threading
import zlib

from filodb_tpu_torch.coordinator.wire import MAX_FRAME, decode, encode
from filodb_tpu_torch.query.exec.plan import PlanDispatcher
from filodb_tpu_torch.utils.metrics import GaugeFn, get_counter
from filodb_tpu_torch.utils.resilience import FaultInjector

log = logging.getLogger(__name__)

_FLAG_COMPRESSED = 0x8000_0000
WIRE_COMPRESS_MIN = 4096  # smaller frames are not worth the zlib cycles
WIRE_COMPRESS_LEVEL = 3
AUTH_FRAME_CAP = 4096  # frames before the auth are tiny

FRAMES_COMPRESSED = get_counter("filodb_wire_frames_compressed")
FRAMES_RAW = get_counter("filodb_wire_frames_raw")
COMPRESS_BYTES_IN = get_counter("filodb_wire_compress_bytes_in")
COMPRESS_BYTES_OUT = get_counter("filodb_wire_compress_bytes_out")
BYTES_SENT = get_counter("filodb_remote_bytes_sent")
BYTES_RECEIVED = get_counter("filodb_remote_bytes_received")

GaugeFn("filodb_wire_compression_ratio",
        lambda: (COMPRESS_BYTES_IN.value / COMPRESS_BYTES_OUT.value)
        if COMPRESS_BYTES_OUT.value else None)

# a peer's agreement to compression, (host, port) → bool: False once a
# peer refused the hello, so later dials skip it
_peer_caps: dict[tuple[str, int], bool] = {}

# transport failures that spoil a socket; a malformed frame (ValueError)
# spoils the stream as a reset does
TRANSPORT_ERRORS = (ConnectionError, OSError, EOFError, ValueError)


def cluster_secret() -> str | None:
    return os.environ.get("FILODB_CLUSTER_SECRET") or None


def make_authed_handler(get_secret, handle, log_label: str):
    """A ``socketserver`` handler class speaking the framed protocol:
    auth (where ``get_secret()`` gives a secret), the hello exchange, then
    ``handle(message) → response`` a frame."""

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            secret = get_secret()
            authed = secret is None
            compress = False  # this connection's, from its hello
            try:
                while True:
                    msg = _recv_msg(self.request,
                                    MAX_FRAME if authed else AUTH_FRAME_CAP)
                    if not authed:
                        if msg[0] == "auth" and len(msg) == 2 \
                                and isinstance(msg[1], str) \
                                and hmac.compare_digest(msg[1], secret):
                            authed = True
                            _send_msg(self.request, ("ok", True))
                            continue
                        _send_msg(self.request, ("err", "auth required"))
                        return
                    if msg[0] == "hello" and len(msg) == 2 \
                            and isinstance(msg[1], dict):
                        # the reply itself goes uncompressed: it is how the
                        # client learns that the server compresses
                        compress = bool(msg[1].get("compress"))
                        _send_msg(self.request,
                                  ("ok", {"compress": compress}))
                        continue
                    _send_msg(self.request, handle(msg), compress=compress)
            except (ConnectionError, EOFError, OSError):
                pass
            except Exception as e:  # pragma: no cover
                log.exception("%s request failed", log_label)
                try:
                    _send_msg(self.request, ("err", repr(e)))
                except Exception:  # noqa: BLE001 - the peer is gone
                    pass

    return Handler


def _send_msg(sock: socket.socket, obj, compress: bool = False) -> int:
    """Frame and send one message; returns the bytes written."""
    payload = encode(obj)
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame {len(payload)} exceeds cap {MAX_FRAME}")
    word = len(payload)
    if compress and len(payload) >= WIRE_COMPRESS_MIN:
        packed = zlib.compress(payload, WIRE_COMPRESS_LEVEL)
        if len(packed) < len(payload):
            COMPRESS_BYTES_IN.inc(len(payload))
            COMPRESS_BYTES_OUT.inc(len(packed))
            FRAMES_COMPRESSED.inc()
            payload = packed
            word = len(payload) | _FLAG_COMPRESSED
        else:  # incompressible: raw rather than a larger frame
            FRAMES_RAW.inc()
    else:
        FRAMES_RAW.inc()
    sock.sendall(struct.pack("<I", word))
    sock.sendall(payload)
    return 4 + len(payload)


def _recv_frame(sock: socket.socket, cap: int = MAX_FRAME):
    """One frame: (the decoded message, the bytes read)."""
    hdr = _recv_exact(sock, 4)
    (word,) = struct.unpack_from("<I", hdr)
    ln = word & ~_FLAG_COMPRESSED
    if ln > cap:
        raise ConnectionError(f"frame {ln} exceeds cap {cap}")
    payload = _recv_exact(sock, ln)
    if word & _FLAG_COMPRESSED:
        # bounded: what a frame inflates to obeys the same cap
        d = zlib.decompressobj()
        try:
            payload = d.decompress(payload, cap + 1)
        except zlib.error as e:
            raise ConnectionError(f"bad compressed frame: {e}") from e
        if len(payload) > cap or d.unconsumed_tail:
            raise ConnectionError(f"decompressed frame exceeds cap {cap}")
    return decode(payload), 4 + ln


def _recv_msg(sock: socket.socket, cap: int = MAX_FRAME):
    return _recv_frame(sock, cap)[0]


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes, read into one buffer (a frame may be a gigabyte)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


class _SocketPool:
    """The process's authed sockets, idle ones kept a peer: a call checks
    one out and back in, so threads that come and go reuse them. A socket
    that met a transport error is closed, never checked back in; past
    ``idle_cap`` idle sockets a peer, a returned one is closed."""

    def __init__(self, idle_cap: int = 8):
        self.idle_cap = idle_cap
        self._lock = threading.Lock()
        self._idle: dict[tuple[str, int], list[socket.socket]] = {}

    def checkout(self, key: tuple[str, int]) -> socket.socket | None:
        with self._lock:
            idle = self._idle.get(key)
            return idle.pop() if idle else None

    def checkin(self, key: tuple[str, int], sock: socket.socket) -> None:
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if len(idle) < self.idle_cap:
                idle.append(sock)
                return
        _close_quietly(sock)

    def drop(self, key: tuple[str, int]) -> None:
        """Close a peer's idle sockets."""
        with self._lock:
            idle = self._idle.pop(key, [])
        for s in idle:
            _close_quietly(s)

    def clear(self) -> None:
        with self._lock:
            all_idle = [s for conns in self._idle.values() for s in conns]
            self._idle.clear()
        for s in all_idle:
            _close_quietly(s)


def _close_quietly(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


_pool = _SocketPool()


def reset_pool() -> None:
    """Close every pooled socket (tests)."""
    _pool.clear()


class RemotePlanDispatcher(PlanDispatcher):
    """The framed transport's client of one peer: pooled sockets,
    ``_roundtrip`` and ``ping``. A stale pooled socket (the peer restarted)
    fails with a transport error and is closed; callers retry on a fresh
    one under the process retry policy."""

    __wire_fields__ = ("host", "port", "timeout")

    TRANSPORT_ERRORS = TRANSPORT_ERRORS
    # whether the hello asks the peer to compress its frames
    compress = True

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    @property
    def peer(self) -> str:
        return f"{self.host}:{self.port}"

    def _dial(self, timeout: float) -> socket.socket:
        FaultInjector.fire("remote.connect", host=self.host,
                           port=self.port)
        sock = socket.create_connection((self.host, self.port),
                                        timeout=timeout)
        # whatever raises before the socket is handed out must not leak it
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            secret = cluster_secret()
            if secret is not None:
                _send_msg(sock, ("auth", secret))
                resp = _recv_msg(sock)
                if resp[0] != "ok":
                    raise ConnectionError("cluster auth rejected")
            key = (self.host, self.port)
            if _peer_caps.get(key) is not False:
                # a peer without compression answers ("err", ...) and the
                # connection stays usable
                _send_msg(sock, ("hello", {"compress": self.compress}))
                resp = _recv_msg(sock)
                _peer_caps[key] = (resp[0] == "ok"
                                   and isinstance(resp[1], dict)
                                   and bool(resp[1].get("compress")))
        except BaseException:
            _close_quietly(sock)
            raise
        return sock

    def _drop_conn(self):
        _pool.drop((self.host, self.port))

    def _roundtrip(self, msg: tuple, timeout: float | None = None,
                   nbytes_out: list | None = None):
        """One request and its response on a pooled (or new) socket; a
        failure closes the socket, so the next attempt dials again.
        ``nbytes_out`` collects the call's bytes sent and received."""
        t = timeout if timeout is not None else self.timeout
        key = (self.host, self.port)
        sock = _pool.checkout(key)
        if sock is None:
            sock = self._dial(t)
        try:
            # this call's timeout: a short ping before must not bind it
            sock.settimeout(t)
            nsent = _send_msg(sock, msg,
                              compress=_peer_caps.get(key, False))
            resp, nrecv = _recv_frame(sock)
        except BaseException:
            # every way out closes the checked-out socket or returns it
            _close_quietly(sock)
            raise
        _pool.checkin(key, sock)
        BYTES_SENT.inc(nsent)
        BYTES_RECEIVED.inc(nrecv)
        if nbytes_out is not None:
            nbytes_out.append(nsent + nrecv)
        return resp

    def ping(self) -> bool:
        try:
            return self._roundtrip(("ping",))[0] == "pong"
        except self.TRANSPORT_ERRORS:
            return False
