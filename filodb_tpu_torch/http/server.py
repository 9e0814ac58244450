"""The HTTP API: the Prometheus query API and the node's admin routes.

Port of ``filodb_tpu/http/server.py``'s ``HttpDispatcher`` and
``FiloHttpServer``. Routes:

- ``GET /promql/{dataset}/api/v1/query_range?query=&start=&end=&step=``
- ``GET/POST /promql/{dataset}/api/v1/query?query=&time=`` (a form POST
  carries the parameters in its body)
- ``GET /promql/{dataset}/api/v1/series?match[]=&start=&end=``
- ``GET /promql/{dataset}/api/v1/labels``
- ``GET /promql/{dataset}/api/v1/label/{name}/values``
- ``GET /api/v1/cluster`` (datasets) and ``/api/v1/cluster/{dataset}/status``
- ``GET /__health``, ``GET /metrics`` (Prometheus exposition)

Status codes and error envelopes are the reference's: 400 for a parse
error or a bad parameter, 404 for an unknown dataset or route, 422 for a
query limit, 500 (``internal``) for anything else. Routes whose modules
are not ported answer 501: remote read, rules and alerts, ``status/*``
and ``debug/*`` (ROADMAP §A.11), the cluster's shard commands and
migration (ROADMAP §A.12). The reference's rendered-response cache and
governor admission are not ported yet (ROADMAP §A.11); a query runs on
its request's thread through its ``QueryService`` (one query at a time a
service). ``?stats=all`` renders the four basic stats (ROADMAP §C).

Two fronts share ``HttpDispatcher``: ``FiloHttpServer`` here (stdlib
threaded server, ``http_impl: "threaded"``) and
``http/fastserver.py::FastHttpServer`` (the default).
"""

from __future__ import annotations

import datetime as dt
import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from filodb_tpu_torch.http import promjson
from filodb_tpu_torch.promql.parser import (
    ParseError,
    TimeStepParams,
    parse_query,
)
from filodb_tpu_torch.query.model import QueryLimitExceeded
from filodb_tpu_torch.utils.metrics import render_prometheus

log = logging.getLogger(__name__)

JSON_CT = "application/json"

# routes of the reference whose modules the port does not have yet
_UNPORTED_ROUTES = {
    ("api", "v1", "rules"): "standing queries (ROADMAP §A.11)",
    ("api", "v1", "alerts"): "standing queries (ROADMAP §A.11)",
    ("api", "v1", "status"): "status introspection (ROADMAP §A.11)",
}
_UNPORTED_PROM = {
    "rules": "standing queries (ROADMAP §A.11)",
    "alerts": "standing queries (ROADMAP §A.11)",
    "debug": "query tracing (ROADMAP §A.11)",
    "read": "remote read (ROADMAP §A.11)",
}


def parse_time(s: str) -> float:
    """Unix seconds (float) or RFC 3339 (Grafana sends either)."""
    try:
        return float(s)
    except ValueError:
        return dt.datetime.fromisoformat(s.replace("Z", "+00:00")) \
            .timestamp()


class HttpDispatcher:
    """All routing and rendering, shared by both fronts. ``handle`` never
    raises: every outcome is a (status, headers, body) triple."""

    def __init__(self, app):
        self.app = app

    def handle(self, command: str, path: str, raw: bytes = b"",
               content_type: str = "") -> tuple[int, dict, bytes]:
        try:
            url = urlparse(path)
            qs = parse_qs(url.query)
            parts = [p for p in url.path.split("/") if p]
            if command == "POST":
                if parts[-1:] == ["read"]:
                    return self._unported(_UNPORTED_PROM["read"])
                if raw and "x-www-form-urlencoded" in content_type:
                    for k, v in parse_qs(raw.decode()).items():
                        qs.setdefault(k, v)
            return self._dispatch(parts, qs)
        except (ParseError, ValueError) as e:
            return self._json(400, promjson.error_json(str(e)))
        except QueryLimitExceeded as e:
            return self._json(422, promjson.error_json(str(e), "query_limit"))
        except Exception as e:  # noqa: BLE001 - every failure answers
            log.exception("request failed")
            return self._json(500, promjson.error_json(str(e), "internal"))

    @staticmethod
    def _json(code: int, payload,
              headers: dict | None = None) -> tuple[int, dict, bytes]:
        body = payload.encode() if isinstance(payload, str) \
            else json.dumps(payload).encode()
        return code, {"Content-Type": JSON_CT, **(headers or {})}, body

    def _unported(self, what: str):
        return self._json(501, promjson.error_json(
            f"{what}: not ported yet", "not_implemented"))

    def _dispatch(self, parts: list[str], qs: dict):
        if parts == ["__health"]:
            return self._json(200, {"status": "healthy"})
        if parts == ["metrics"]:
            return (200, {"Content-Type": "text/plain; version=0.0.4"},
                    render_prometheus().encode())
        if len(parts) >= 4 and parts[0] == "promql" \
                and parts[2] == "api" and parts[3] == "v1":
            svc = self.app.services.get(parts[1])
            if svc is None:
                return self._json(404, promjson.error_json(
                    f"unknown dataset {parts[1]}"))
            return self._prom_api(svc, parts[4:], qs)
        if len(parts) >= 3 and parts[:3] == ["api", "v1", "cluster"]:
            return self._cluster_api(parts[3:])
        if tuple(parts[:3]) in _UNPORTED_ROUTES:
            return self._unported(_UNPORTED_ROUTES[tuple(parts[:3])])
        return self._json(404, promjson.error_json("not found", "not_found"))

    # ---- the Prometheus API --------------------------------------------------

    @staticmethod
    def range_params(qs: dict) -> tuple[str, int, int, int]:
        """(query, start, step, end) of a query_range request."""
        return (qs["query"][0], int(parse_time(qs["start"][0])),
                int(float(qs.get("step", ["60"])[0])),
                int(parse_time(qs["end"][0])))

    @staticmethod
    def instant_params(qs: dict) -> tuple[str, int]:
        """(query, time) of an instant query; the server's clock when no
        time is given, as Prometheus does."""
        if "time" in qs:
            return qs["query"][0], int(parse_time(qs["time"][0]))
        return qs["query"][0], int(time.time())

    def _prom_api(self, svc, rest: list[str], qs: dict):
        if rest == ["query_range"]:
            r = svc.query_range(*self.range_params(qs))
            return self._json(200, promjson.matrix_json_str(r))
        if rest == ["query"]:
            query, t = self.instant_params(qs)
            r = svc.query_range(query, t, 0, t)
            return self._json(200, promjson.vector_json_str(r))
        if rest == ["series"]:
            start = int(parse_time(qs.get("start", ["0"])[0]))
            end = int(parse_time(qs.get("end", ["9999999999"])[0]))
            out = []
            for mtext in qs.get("match[]", []):
                plan = parse_query(mtext, TimeStepParams(start, 0, end))
                raw = getattr(plan, "raw", None)
                filters = raw.filters if raw is not None else ()
                for lm in svc.series(list(filters), start, end):
                    out.append({("__name__" if k == "_metric_" else k): v
                                for k, v in lm.items()})
            return self._json(200, {"status": "success", "data": out})
        if rest == ["labels"]:
            names = [("__name__" if n == "_metric_" else n)
                     for n in svc.label_names()]
            return self._json(200, {"status": "success", "data": names})
        if len(rest) == 3 and rest[0] == "label" and rest[2] == "values":
            label = unquote(rest[1])
            if label == "__name__":
                label = "_metric_"
            return self._json(200, {"status": "success",
                                    "data": svc.label_values(label)})
        if rest[:1] and rest[0] in _UNPORTED_PROM:
            return self._unported(_UNPORTED_PROM[rest[0]])
        return self._json(404, promjson.error_json("unknown endpoint"))

    # ---- cluster admin -------------------------------------------------------

    def _cluster_api(self, rest: list[str]):
        cluster = self.app.cluster
        if not rest:
            return self._json(200, {"status": "success",
                                    "data": list(self.app.services)})
        if len(rest) == 2 and rest[1] == "status":
            data = cluster.shard_statuses(rest[0]) if cluster is not None \
                else []
            return self._json(200, {"status": "success", "data": data})
        if len(rest) == 2 and rest[1] in ("startshards", "stopshards",
                                          "shardmap", "migrate"):
            return self._unported("shard commands and migration "
                                  "(ROADMAP §A.12)")
        return self._json(404, promjson.error_json("unknown cluster endpoint"))


class FiloHttpServer:
    """The threaded front end: one thread a connection, keep-alive."""

    def __init__(self, services: dict, host: str = "127.0.0.1",
                 port: int = 8080, cluster=None, reuse_port: bool = False):
        self.services = services
        self.cluster = cluster
        self.dispatcher = HttpDispatcher(self)
        cls = _ReusePortHTTPServer if reuse_port else ThreadingHTTPServer
        self.httpd = cls((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> "FiloHttpServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="http")
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


class _ReusePortHTTPServer(ThreadingHTTPServer):
    """SO_REUSEPORT: several server processes share one port."""

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def _make_handler(server: FiloHttpServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def do_GET(self):
            self._route()

        def do_POST(self):
            self._route()

        def _route(self):
            raw = b""
            if self.command == "POST":
                try:
                    ln = int(self.headers.get("Content-Length") or 0)
                    if ln < 0:
                        raise ValueError("negative Content-Length")
                except ValueError as e:
                    # an unreadable length desyncs the connection: answer
                    # 400 and close it
                    self.close_connection = True
                    self._send(400, {"Content-Type": JSON_CT}, json.dumps(
                        promjson.error_json(str(e))).encode())
                    return
                raw = self.rfile.read(ln) if ln else b""
            self._send(*server.dispatcher.handle(
                self.command, self.path, raw,
                self.headers.get("Content-Type", "")))

        def _send(self, code: int, headers: dict, body: bytes):
            self.send_response(code)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler
