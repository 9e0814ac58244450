"""FiloClient: programmatic client for a running server.

Copy of ``filodb_tpu/client.py``; either package's client talks to
either package's node. Counterpart of reference
``coordinator/src/main/scala/filodb.coordinator/client/Client.scala:106,126``
(``LocalClient``/``ClusterClient`` ask facades +
``QueryCommands``/``ClusterOps``): query and cluster operations against a
server's HTTP API. Results come back as parsed structures; range queries
can also be requested as numpy matrices.
"""

from __future__ import annotations

import http.client
import json
import urllib.parse
from dataclasses import dataclass, field

import numpy as np


class FiloClientError(RuntimeError):
    pass


@dataclass
class FiloClient:
    host: str = "127.0.0.1"
    port: int = 8080
    dataset: str = "timeseries"
    timeout_s: float = 60.0
    # persistent keep-alive connection (NOT thread-safe: share a client
    # across threads and requests interleave — use one client per thread,
    # as the serving benchmark and reference Client facades do)
    _conn: http.client.HTTPConnection | None = field(
        default=None, repr=False, compare=False)

    # -- http plumbing --

    def _request(self, path_qs: str) -> tuple[int, bytes]:
        """One GET over the cached keep-alive connection; reconnects once
        on a stale socket (server restarted / idle timeout)."""
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout_s)
            try:
                self._conn.request("GET", path_qs)
                resp = self._conn.getresponse()
                body = resp.read()
                if resp.will_close:
                    self._conn.close()
                    self._conn = None
                return resp.status, body
            except (http.client.HTTPException, ConnectionError, OSError):
                self._conn.close()
                self._conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _get(self, path: str, **params) -> dict:
        qs = urllib.parse.urlencode(params, doseq=True)
        status, raw = self._request(path + (f"?{qs}" if qs else ""))
        try:
            body = json.loads(raw)
        except Exception as e:
            if status >= 400:
                raise FiloClientError(f"HTTP {status}") from e
            raise
        if status >= 400:
            raise FiloClientError(
                body.get("error", str(body)) if isinstance(body, dict)
                else str(body))
        if isinstance(body, dict) and body.get("status") == "error":
            raise FiloClientError(body.get("error", "unknown error"))
        return body

    def _api(self, endpoint: str) -> str:
        return f"/promql/{self.dataset}/api/v1/{endpoint}"

    # -- queries --

    def query_range(self, promql: str, start: int, end: int,
                    step: int = 60) -> list[dict]:
        """Prom matrix result: [{"metric": {...}, "values": [[ts, v], ...]}]."""
        body = self._get(self._api("query_range"), query=promql, start=start,
                         end=end, step=step)
        return body["data"]["result"]

    def query_range_matrix(self, promql: str, start: int, end: int,
                           step: int = 60):
        """(labels list, values float[P, K] with NaN gaps, steps int64[K])."""
        result = self.query_range(promql, start, end, step)
        steps = np.arange(start, end + 1, step, dtype=np.int64)
        idx = {int(t): i for i, t in enumerate(steps)}
        values = np.full((len(result), len(steps)), np.nan)
        labels = []
        for i, series in enumerate(result):
            labels.append(series["metric"])
            for t, v in series["values"]:
                j = idx.get(int(float(t)))
                if j is not None:
                    values[i, j] = float(v)
        return labels, values, steps

    def query(self, promql: str, time: int) -> list[dict]:
        body = self._get(self._api("query"), query=promql, time=time)
        return body["data"]["result"]

    def series(self, match: str, start: int, end: int) -> list[dict]:
        return self._get(self._api("series"), **{"match[]": match},
                         start=start, end=end)["data"]

    def label_names(self) -> list[str]:
        return self._get(self._api("labels"))["data"]

    def label_values(self, label: str) -> list[str]:
        return self._get(self._api(f"label/{label}/values"))["data"]

    # -- cluster ops (reference ClusterOps) --

    def cluster_status(self) -> list[dict]:
        return self._get(f"/api/v1/cluster/{self.dataset}/status")["data"]

    def stop_shards(self, shards: list[int]) -> list[int]:
        return self._get(f"/api/v1/cluster/{self.dataset}/stopshards",
                         shards=",".join(map(str, shards)))["data"]

    def start_shards(self, shards: list[int], node: str | None = None
                     ) -> list[int]:
        params = {"shards": ",".join(map(str, shards))}
        if node:
            params["node"] = node
        return self._get(f"/api/v1/cluster/{self.dataset}/startshards",
                         **params)["data"]

    def health(self) -> bool:
        try:
            return self._get("/__health").get("status") == "healthy"
        except (FiloClientError, OSError):
            return False
