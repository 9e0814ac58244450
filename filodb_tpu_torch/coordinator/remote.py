"""The framed TCP transport of the plan wire, and exec plans shipped
over it.

Port of ``filodb_tpu/coordinator/remote.py``. The multi-process mesh
runtime (``coordinator/mesh_cluster.py``, ``parallel/multiproc.py``) and
a cluster's nodes ride it; the protocol is the reference's byte for byte,
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

- ``PlanExecutorServer`` (the reference's ``:185-277``): a node's
  executor port. ``("execute", dataset, plan, qcontext)`` runs the
  shipped subtree under the governor's admission (an EXPENSIVE slot, the
  plan's tenant from its leaves' filters) and then under the lock of the
  dataset's ``QueryService``: the port's service answers one query at a
  time, and a node's store is never read from handler threads that
  nothing serializes (ROADMAP §C.14). It answers ``("ok",
  QueryResult)`` (values materialized to host float64; a sampled query's
  spans in ``spans``), ``("rejected", why, retry_after_s)`` for a shed,
  or ``("err", repr)``; ``extra_handlers`` take a node's control
  messages. A server given a bare store runs its plans on a service of
  its own (and so under that service's lock), on ``device``.
- ``RemotePlanDispatcher.dispatch`` (``:442-515``): under the peer's
  breaker (``calling``: an open peer raises ``CircuitOpenError`` without
  a dial, and only transport errors count against it), retried on a
  fresh socket under the retry policy and the query's deadline (each
  attempt's timeout is the deadline's remainder); it records the peer's
  latency, counts the call's bytes into the child's
  ``stats.wire_bytes``, grafts a sampled answer's spans under its
  ``dispatch`` span tagged with the peer, and re-raises a shed as
  ``QueryRejected``. ``call`` sends a control message.
"""

from __future__ import annotations

import hmac
import logging
import os
import socket
import socketserver
import struct
import threading
import time
import zlib

from filodb_tpu_torch.coordinator.wire import MAX_FRAME, decode, encode
from filodb_tpu_torch.query.exec.plan import ExecContext, PlanDispatcher
from filodb_tpu_torch.query.model import QueryContext, QueryResult, QueryStats
from filodb_tpu_torch.utils.metrics import GaugeFn, get_counter
from filodb_tpu_torch.utils.resilience import (
    FaultInjector,
    breaker_for,
    default_retry_policy,
    record_peer_latency,
)
from filodb_tpu_torch.utils.tracing import graft_spans, span, start_trace

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


class PlanExecutorServer:
    """A node's executor port (see the module's text). ``services`` maps a
    dataset to the ``QueryService`` whose lock its shipped plans run
    under; None serves control messages only.
    ``extra_handlers``: {kind: fn(*payload) → response}."""

    def __init__(self, services: dict | None, host: str = "127.0.0.1",
                 port: int = 0, extra_handlers: dict | None = None,
                 secret: str | None = None):
        self.services = services if services is not None else {}
        self.extra_handlers = extra_handlers or {}
        self.secret = secret if secret is not None else cluster_secret()
        Handler = make_authed_handler(lambda: self.secret, self._handle,
                                      "remote exec")

        conns: set = set()
        conns_lock = threading.Lock()
        self._conns, self._conns_lock = conns, conns_lock

        class Server(socketserver.ThreadingTCPServer):
            # a fixed executor port must rebind across fast restarts
            allow_reuse_address = True

            # the connections open, which ``stop`` closes: a stopped
            # node must not go on answering its peers' pooled sockets
            def process_request(self, request, client_address):
                with conns_lock:
                    conns.add(request)
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                with conns_lock:
                    conns.discard(request)
                super().shutdown_request(request)

        self.server = Server((host, port), Handler, bind_and_activate=True)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.address = (host, self.port)
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="plan-executor")

    def _handle(self, msg):
        kind = msg[0]
        if kind == "ping":
            return ("pong",)
        if kind == "execute":
            try:
                return self._execute(*msg[1:])
            except Exception as e:
                log.exception("plan execution failed")
                return ("err", repr(e))
        handler = self.extra_handlers.get(kind)
        if handler is not None:
            try:
                return ("ok", handler(*msg[1:]))
            except Exception as e:
                log.exception("control message %s failed", kind)
                return ("err", repr(e))
        return ("err", f"unknown message {kind!r}")

    def _execute(self, dataset: str, plan, qcontext):
        from filodb_tpu_torch.coordinator.query_service import plan_tenant
        from filodb_tpu_torch.utils.governor import (
            EXPENSIVE,
            QueryRejected,
            governor,
        )

        svc = self.services.get(dataset)
        if svc is None:
            raise KeyError(f"dataset {dataset!r} is not served here")
        qcontext = qcontext or QueryContext()
        tc = qcontext.trace
        sampled = tc is not None and tc.sampled
        t0 = time.perf_counter()
        try:
            with governor().admit(cost=EXPENSIVE, tenant=plan_tenant(plan)):
                waited = time.perf_counter() - t0
                with svc.lock:
                    ctx = ExecContext(
                        svc.memstore, QueryStats(engine="exec"), svc.device,
                        svc.batches, svc.gids, dataset=dataset,
                        qcontext=qcontext)
                    ctx.stats.admission_wait_s += waited
                    spans = []
                    if sampled:
                        # join the root's trace: the tree goes back in the
                        # answer, for the dispatcher to graft
                        with start_trace() as trace:
                            data = plan.execute(ctx).materialize()
                        spans = trace.as_dicts()
                    else:
                        data = plan.execute(ctx).materialize()
                    ctx.stats.settle_timings()
        except QueryRejected as e:
            return ("rejected", str(e), e.retry_after_s)
        return ("ok", QueryResult(data, ctx.stats, qcontext.query_id,
                                  partial=ctx.partial,
                                  warnings=list(ctx.warnings), spans=spans))

    def start(self) -> "PlanExecutorServer":
        self._thread.start()
        return self

    def stop(self):
        """Stop accepting, then close every open connection (a peer's
        next call on one fails as on a dead node's)."""
        self.server.shutdown()
        self.server.server_close()
        with self._conns_lock:
            open_conns = list(self._conns)
        for sock in open_conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


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
    ``_roundtrip``, ``ping``, ``dispatch`` and ``call``. A stale pooled
    socket (the peer restarted) fails with a transport error and is
    closed; callers retry on a fresh one under the process retry
    policy."""

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

    def dispatch(self, plan, ctx):
        """Ship ``plan`` to the peer and return its ``QueryResult`` (see
        the module's text)."""
        breaker = breaker_for(self.peer)
        deadline = ctx.deadline
        nbytes: list[int] = []

        def attempt():
            timeout = deadline.timeout(cap=self.timeout,
                                       what=f"dispatch to {self.peer}") \
                if deadline is not None else self.timeout
            FaultInjector.fire("remote.dispatch", host=self.host,
                               port=self.port)
            return self._roundtrip(
                ("execute", ctx.dataset, plan, ctx.qcontext), timeout,
                nbytes_out=nbytes)

        t0 = time.perf_counter()
        with span("dispatch", peer=self.peer) as dspan, \
                breaker.calling(transport_errors=self.TRANSPORT_ERRORS):
            resp = default_retry_policy().call(
                attempt, retry_on=self.TRANSPORT_ERRORS, deadline=deadline)
        record_peer_latency(self.peer, time.perf_counter() - t0)
        if resp[0] == "ok":
            result = resp[1]
            # on the child's own stats: the gather merges them, on its
            # thread
            result.stats.wire_bytes += sum(nbytes)
            if result.spans:
                graft_spans(result.spans, dspan, node=self.peer)
                result.spans = []
            return result
        if resp[0] == "rejected":
            # the peer's admission shed the query: overload, not a lost
            # child, so no gather takes it as partial
            from filodb_tpu_torch.utils.governor import QueryRejected

            raise QueryRejected(f"peer {self.peer} shed the query: "
                                f"{resp[1]}",
                                retry_after_s=resp[2] if len(resp) > 2
                                else 1.0)
        raise RuntimeError(f"remote execution failed on {self.peer}: "
                           f"{resp[1]}")

    def ping(self) -> bool:
        try:
            return self._roundtrip(("ping",))[0] == "pong"
        except self.TRANSPORT_ERRORS:
            return False

    def call(self, kind: str, *payload):
        """A control message's answer; a stale pooled socket retries on a
        fresh one under the retry policy."""
        resp = default_retry_policy().call(
            lambda: self._roundtrip((kind, *payload)),
            retry_on=self.TRANSPORT_ERRORS)
        if resp[0] == "ok":
            return resp[1]
        if resp[0] == "pong":
            return None
        raise RuntimeError(f"control call {kind} failed: {resp[1]}")
