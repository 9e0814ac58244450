"""The default HTTP front end: one thread, a selector event loop.

Port of ``filodb_tpu/http/fastserver.py``'s ``FastHttpServer``
(``http_impl: "fast"``, the reference's default): one thread owns every
socket, parses pipelined HTTP/1.1 requests with the same framing rules
(Content-Length only, duplicate lengths that differ and chunked bodies
refused, a header block over 1 MiB answered 431, a body over 10 MiB 413),
and answers in request order. Cold paths (metadata, admin, POST forms)
run inline through the shared ``HttpDispatcher``. A hot query (``query``
and ``query_range``) is looked up in the rendered-response cache as it
arrives (``http/server.py::ResponseCache``) and answered at once on a
hit; the misses of one readiness pass are evaluated as one
``query_range_many`` batch a service (``_run_hot_batch``), each rendered
as the dispatcher renders it, and stored. A query that fails gets its own
error response from its own exception (``return_errors``), as the
dispatcher maps it (``error_response``: a governor's shed and a passed
deadline answer 503 with ``Retry-After``); the others of its batch are
answered, and nothing is run twice. A pass's batch takes one admission
slot.
"""

from __future__ import annotations

import json
import logging
import selectors
import socket
import threading
from urllib.parse import parse_qs, urlparse

from filodb_tpu_torch.http import promjson
from filodb_tpu_torch.http.server import (
    JSON_CT,
    HttpDispatcher,
    ResponseCache,
    error_response,
    response_cache_key,
    service_version,
)

log = logging.getLogger(__name__)

_MAX_BUF = 1 << 20          # drop connections with >1MB of pending request
_MAX_BODY = 10 << 20
_STATUS = {200: b"200 OK", 400: b"400 Bad Request", 404: b"404 Not Found",
           413: b"413 Content Too Large", 422: b"422 Unprocessable Entity",
           429: b"429 Too Many Requests", 431: b"431 Headers Too Large",
           500: b"500 Internal Server Error", 501: b"501 Not Implemented",
           503: b"503 Service Unavailable"}


def _response_bytes(code: int, headers: dict, body: bytes,
                    close: bool) -> bytes:
    head = [b"HTTP/1.1 " + _STATUS.get(code, str(code).encode())]
    for k, v in headers.items():
        head.append(f"{k}: {v}".encode())
    head.append(b"Content-Length: " + str(len(body)).encode())
    if close:
        head.append(b"Connection: close")
    return b"\r\n".join(head) + b"\r\n\r\n" + body


class _Conn:
    __slots__ = ("sock", "inbuf", "out", "slots", "base", "close_after")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = b""
        self.out = b""
        # responses must leave in request order (HTTP/1.1 pipelining):
        # each parsed request claims an ABSOLUTE slot number; completed
        # prefix slots are shifted out by _flush, so ``base`` tracks the
        # absolute number of slots[0] (hot queries fill theirs after the
        # batch runs, by which time earlier slots may have flushed)
        self.slots: list[bytes | None] = []
        self.base = 0
        self.close_after = False

    def fill(self, slot: int, resp: bytes) -> None:
        i = slot - self.base
        if 0 <= i < len(self.slots):
            self.slots[i] = resp

    def is_last(self, slot: int) -> bool:
        return slot == self.base + len(self.slots) - 1


class _HotReq:
    __slots__ = ("conn", "slot", "svc", "kind", "params", "ckey", "version")

    def __init__(self, conn, slot, svc, kind, params):
        self.conn = conn
        self.slot = slot
        self.svc = svc
        self.kind = kind          # "range" | "instant"
        self.params = params      # (query, start, step, end)
        self.ckey = None          # its response-cache key and the version
        self.version = None       # it was looked up at (None: no cache)


class FastHttpServer:
    """The event-loop front end (``FiloHttpServer``'s constructor
    surface)."""

    def __init__(self, services: dict, host="127.0.0.1", port=8080,
                 cluster=None, reuse_port: bool = False,
                 response_cache: bool = True, rule_managers=None,
                 shard_maps=None):
        self.services = services
        self.cluster = cluster
        # a member's mirrors of the coordinator's map: dataset → a
        # callable giving its ``ShardMapper``
        self.shard_maps = shard_maps or {}
        # dataset -> RuleManager: /api/v1/rules and /api/v1/alerts
        self.rule_managers = rule_managers or {}
        self.response_cache = ResponseCache() if response_cache else None
        # the sizes of the hot batches run, in order (the last 1,024)
        self.batch_sizes: list[int] = []
        self.dispatcher = HttpDispatcher(self)
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._listen.bind((host, port))
        self._listen.listen(512)
        self._listen.setblocking(False)
        self.port = self._listen.getsockname()[1]
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._running = False
        self._thread: threading.Thread | None = None

    def batched(self, svc):
        """The dispatcher's query paths run on the service itself: the
        loop batches its hot queries a pass."""
        return svc

    def start(self) -> "FastHttpServer":
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fast-http")
        self._thread.start()
        return self

    def stop(self):
        if not self._running:
            return
        self._running = False
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=30)
        for key in list(self._sel.get_map().values()):
            if isinstance(key.data, _Conn):
                try:
                    key.data.sock.close()
                except OSError:
                    pass
        self._sel.close()
        self._listen.close()
        self._wake_r.close()
        self._wake_w.close()

    # -- event loop --

    def _loop(self):
        self._sel.register(self._listen, selectors.EVENT_READ, None)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        while self._running:
            hot: list[_HotReq] = []
            try:
                for key, mask in self._sel.select(timeout=1.0):
                    if key.data is None:
                        self._accept()
                    elif key.data == "wake":
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                    else:
                        conn: _Conn = key.data
                        if mask & selectors.EVENT_READ:
                            self._read(conn, hot)
                        if mask & selectors.EVENT_WRITE:
                            self._flush(conn)
                self._run_hot_batch(hot)
            except Exception:  # the loop outlives a handler's fault
                log.exception("event loop pass failed")
                for req in hot:
                    self._close(req.conn)

    def _accept(self):
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sel.register(sock, selectors.EVENT_READ, _Conn(sock))

    def _close(self, conn: _Conn):
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _read(self, conn: _Conn, hot: list[_HotReq]):
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        conn.inbuf += data
        self._parse_requests(conn, hot)
        self._flush(conn)

    def _reject(self, conn: _Conn, code: int, message: str):
        conn.slots.append(_response_bytes(
            code, {"Content-Type": JSON_CT},
            json.dumps(promjson.error_json(message)).encode(), True))
        conn.close_after = True
        conn.inbuf = b""

    def _parse_requests(self, conn: _Conn, hot: list[_HotReq]):
        while conn.inbuf and not conn.close_after:
            end = conn.inbuf.find(b"\r\n\r\n")
            if end < 0:
                if len(conn.inbuf) > _MAX_BUF:
                    self._reject(conn, 431, "headers too large")
                return
            lines = conn.inbuf[:end].split(b"\r\n")
            try:
                method, target, version = lines[0].split(b" ", 2)
            except ValueError:
                self._close(conn)
                return
            clen = 0
            seen_clen = None
            ctype = ""
            keep = version.strip() == b"HTTP/1.1"
            chunked = False
            for ln in lines[1:]:
                lower = ln.lower()
                if lower.startswith(b"transfer-encoding:"):
                    chunked = True
                elif lower.startswith(b"content-length:"):
                    try:
                        clen = int(ln.split(b":", 1)[1])
                    except ValueError:
                        self._close(conn)
                        return
                    if seen_clen is not None and seen_clen != clen:
                        self._close(conn)  # CL.CL request smuggling
                        return
                    seen_clen = clen
                elif lower.startswith(b"content-type:"):
                    ctype = ln.split(b":", 1)[1].strip().decode(
                        "latin-1", "replace")
                elif lower.startswith(b"connection:"):
                    v = lower.split(b":", 1)[1].strip()
                    keep = v != b"close" if keep else v == b"keep-alive"
            if chunked:
                self._reject(conn, 501, "Transfer-Encoding not supported")
                return
            if clen < 0:
                self._close(conn)
                return
            if clen > _MAX_BODY:
                self._reject(conn, 413, "request body too large")
                return
            total = end + 4 + clen
            if len(conn.inbuf) < total:
                return  # the body is still to come
            body = conn.inbuf[end + 4:total]
            conn.inbuf = conn.inbuf[total:]
            if not keep:
                conn.close_after = True
            slot = conn.base + len(conn.slots)
            conn.slots.append(None)
            path = target.decode("latin-1", "replace")
            req = self._classify_hot(conn, slot, method, path)
            if req is not None:
                cache = self.response_cache
                version = service_version(req.svc) if cache is not None \
                    else None
                if version is not None:
                    req.ckey = response_cache_key(req.svc, req.kind,
                                                  req.params)
                    req.version = version
                    hit = cache.get(req.ckey, req.version)
                    if hit is not None:
                        conn.fill(slot, _response_bytes(
                            200, {"Content-Type": JSON_CT}, hit,
                            conn.close_after and conn.is_last(slot)))
                        continue
                hot.append(req)
            else:
                code, headers, resp = self.dispatcher.handle(
                    method.decode("latin-1", "replace"), path, body, ctype)
                conn.fill(slot, _response_bytes(
                    code, headers, resp,
                    conn.close_after and conn.is_last(slot)))

    def _classify_hot(self, conn, slot, method: bytes, path: str):
        """A GET query or query_range of a known dataset with well-formed
        parameters; anything else goes through the dispatcher."""
        if method != b"GET" or not path.startswith("/promql/"):
            return None
        url = urlparse(path)
        parts = url.path.split("/")
        if len(parts) != 6 or parts[3] != "api" or parts[4] != "v1" \
                or parts[5] not in ("query_range", "query"):
            return None
        svc = self.services.get(parts[2])
        if svc is None:
            return None
        qs = parse_qs(url.query)
        if qs.get("stats", [""])[0] == "all":
            return None  # the full stats: the dispatcher renders them
        try:
            if parts[5] == "query_range":
                q, start, step, end = HttpDispatcher.range_params(qs)
                return _HotReq(conn, slot, svc, "range", (q, start, step, end))
            q, t = HttpDispatcher.instant_params(qs)
            return _HotReq(conn, slot, svc, "instant", (q, t, 0, t))
        except (KeyError, ValueError, IndexError):
            return None  # malformed: the dispatcher answers

    def _run_hot_batch(self, hot: list[_HotReq]) -> None:
        """The pass's hot queries, one ``query_range_many`` batch a
        service; each answer rendered, stored in the response cache and
        written to its slot."""
        by_svc: dict[int, list[_HotReq]] = {}
        for req in hot:
            by_svc.setdefault(req.svc.serial, []).append(req)
        for reqs in by_svc.values():
            self.batch_sizes = self.batch_sizes[-1023:] + [len(reqs)]
            results = reqs[0].svc.query_range_many(
                [r.params for r in reqs], return_errors=True)
            for req, result in zip(reqs, results):
                code, headers, body = self._run_single(req, result)
                if code == 200 and req.version is not None:
                    self.response_cache.put(req.ckey, req.version, body)
                req.conn.fill(req.slot, _response_bytes(
                    code, headers, body,
                    req.conn.close_after and req.conn.is_last(req.slot)))
                self._flush(req.conn)

    @staticmethod
    def _render(req: _HotReq, result) -> bytes:
        if req.kind == "range":
            return promjson.matrix_json_str(result).encode()
        return promjson.vector_json_str(result).encode()

    def _run_single(self, req: _HotReq, result) -> tuple[int, dict, bytes]:
        """The response to one hot query from its outcome, its answer or
        the exception it raised."""
        ct = {"Content-Type": JSON_CT}
        try:
            if isinstance(result, Exception):
                raise result
            return 200, ct, self._render(req, result)
        except Exception as e:  # noqa: BLE001 - every failure answers
            named = error_response(e)
            if named is not None:
                code, headers, body = named
                return code, {**ct, **headers}, json.dumps(body).encode()
            log.exception("hot query failed")
            return 500, ct, json.dumps(
                promjson.error_json(str(e), "internal")).encode()

    # -- writes --

    def _flush(self, conn: _Conn):
        # move contiguous completed slots into the out buffer
        done = 0
        for resp in conn.slots:
            if resp is None:
                break
            conn.out += resp
            done += 1
        if done:
            del conn.slots[:done]
            conn.base += done
        if not conn.out:
            if conn.close_after and not conn.slots:
                self._close(conn)
            return
        try:
            sent = conn.sock.send(conn.out)
            conn.out = conn.out[sent:]
        except (BlockingIOError, InterruptedError):
            sent = 0
        except OSError:
            self._close(conn)
            return
        try:
            if conn.out:
                self._sel.modify(conn.sock,
                                 selectors.EVENT_READ | selectors.EVENT_WRITE,
                                 conn)
            else:
                self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
                if conn.close_after and not conn.slots:
                    self._close(conn)
        except (KeyError, ValueError):
            pass
