"""Remote HTTP exec: run a sub-query on another cluster through its
Prometheus API.

Port of ``filodb_tpu/query/exec/remote_exec.py`` (``PromQlRemoteExec``,
``:30-105``): cross-cluster federation and HA routing ship PromQL text,
not plans, to an endpoint's ``query_range``, under that endpoint's
circuit breaker and the query's ``Deadline``, with the ``promql.remote``
fault site; the JSON matrix comes back as a ``StepMatrix`` whose values
land on the context's device in float64, where the gather above it
(``StitchRvsExec``, a concat or a reduce) stitches them.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass

import numpy as np
import torch

from filodb_tpu_torch.query.exec.plan import ExecPlan
from filodb_tpu_torch.query.exec.transformers import steps_array
from filodb_tpu_torch.query.model import RangeVectorKey, StepMatrix
from filodb_tpu_torch.utils.resilience import (
    FaultInjector,
    RemoteQueryError,
    breaker_for,
)


@dataclass
class PromQlRemoteExec(ExecPlan):
    endpoint: str = ""        # e.g. http://host:port/promql/timeseries
    promql: str = ""
    start: int = 0            # ms
    step: int = 60_000
    end: int = 0
    timeout_s: float = 30.0   # cap; the query's Deadline shortens it

    def do_execute(self, ctx) -> StepMatrix:
        qs = urllib.parse.urlencode({
            "query": self.promql,
            "start": self.start // 1000,
            "end": self.end // 1000,
            "step": max(self.step // 1000, 1),
        })
        url = f"{self.endpoint}/api/v1/query_range?{qs}"
        # one outcome a call: a half-open probe never stays pending
        with breaker_for(self.endpoint).calling(
                transport_errors=(urllib.error.URLError, ConnectionError,
                                  OSError)) as outcome:
            deadline = getattr(ctx, "deadline", None)
            timeout = deadline.timeout(cap=self.timeout_s,
                                       what=f"remote exec {self.endpoint}") \
                if deadline is not None else self.timeout_s
            try:
                FaultInjector.fire("promql.remote", endpoint=self.endpoint)
                with urllib.request.urlopen(url, timeout=timeout) as r:
                    body = json.load(r)
            except urllib.error.HTTPError as e:
                # the remote answered: its transport is healthy
                outcome.success()
                raise RemoteQueryError(
                    f"remote query to {self.endpoint} failed: "
                    f"HTTP {e.code} {e.reason}") from e
            except json.JSONDecodeError as e:
                outcome.failure()
                raise RemoteQueryError(
                    f"remote query to {self.endpoint} returned malformed "
                    f"JSON: {e}") from e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                outcome.failure()
                reason = getattr(e, "reason", e)
                raise ConnectionError(
                    f"remote query to {self.endpoint} unreachable: "
                    f"{reason}") from e
        if body.get("status") != "success":
            raise RemoteQueryError(
                f"remote query to {self.endpoint} failed: {body}")
        data = self._from_matrix_json(body["data"])
        data.values = torch.from_numpy(data.values).to(ctx.device)
        return data

    def _from_matrix_json(self, data) -> StepMatrix:
        """The matrix as host float64, NaN where a step has no value."""
        steps = steps_array(self.start, self.step, self.end)
        idx = {int(t): i for i, t in enumerate(steps)}
        keys, rows = [], []
        for series in data.get("result", []):
            labels = {("_metric_" if k == "__name__" else k): v
                      for k, v in series.get("metric", {}).items()}
            row = np.full(len(steps), np.nan)
            for t, v in series.get("values", []):
                i = idx.get(int(round(float(t) * 1000)))
                if i is not None:
                    row[i] = float(v)
            keys.append(RangeVectorKey.of(labels))
            rows.append(row)
        values = np.stack(rows) if rows else np.zeros((0, len(steps)))
        return StepMatrix(keys, values, steps)

    def __repr__(self):
        return f"PromQlRemoteExec({self.endpoint!r}, {self.promql!r})"
