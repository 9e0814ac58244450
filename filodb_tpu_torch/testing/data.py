"""Seeded series and sample streams for tests, the mesh harness and the
operator's tools.

Copy of ``filodb_tpu/testing/data.py``: gauge (``machine_metrics_series``,
``gauge_stream``), counter and histogram (``histogram_series``,
``histogram_stream``) series and their container streams. The same seeds
give the same containers as the reference's, byte for byte
(``tests/test_torch_multiproc_mesh.py``, ``tests/test_torch_debug_plane.py``
hold them equal).
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import IngestRecord, RecordContainer, SomeData


def machine_metrics_series(n_series: int = 10, metric: str = "heap_usage",
                           ws: str = "demo", ns: str = "App-0") -> list[PartKey]:
    return [PartKey.create("gauge", {
        "_metric_": metric, "_ws_": ws, "_ns_": ns,
        "instance": f"instance-{i}", "host": f"H{i % 4}",
    }) for i in range(n_series)]


def counter_series(n_series: int = 10, metric: str = "http_requests_total",
                   ws: str = "demo", ns: str = "App-0") -> list[PartKey]:
    return [PartKey.create("prom-counter", {
        "_metric_": metric, "_ws_": ws, "_ns_": ns,
        "instance": f"instance-{i}", "job": f"job-{i % 3}",
    }) for i in range(n_series)]


def histogram_series(n_series: int = 4, metric: str = "http_req_latency",
                     ws: str = "demo", ns: str = "App-0") -> list[PartKey]:
    return [PartKey.create("prom-histogram", {
        "_metric_": metric, "_ws_": ws, "_ns_": ns, "instance": f"instance-{i}",
    }) for i in range(n_series)]


def gauge_stream(keys: list[PartKey], n_samples: int, start_ms: int = 0,
                 interval_ms: int = 10_000, batch: int = 100, seed: int = 0,
                 start_offset: int = 0):
    """Containers of gauge samples, a random walk a series, round-robin
    over the series; offsets count from ``start_offset``."""
    rng = np.random.default_rng(seed)
    values = {k: 50.0 + 30.0 * rng.random() for k in keys}
    container = RecordContainer()
    offset = start_offset
    for s in range(n_samples):
        ts = start_ms + s * interval_ms
        for k in keys:
            values[k] += rng.normal(0, 1.0)
            container.add(IngestRecord(k, ts, (values[k],)))
            if len(container) >= batch:
                yield SomeData(container, offset)
                offset += 1
                container = RecordContainer()
    if len(container):
        yield SomeData(container, offset)


def counter_stream(keys: list[PartKey], n_samples: int, start_ms: int = 0,
                   interval_ms: int = 10_000, batch: int = 100, seed: int = 0,
                   reset_every: int = 0, start_value: float = 0.0):
    """Containers of counter samples, round-robin over the series, with a
    reset every ``reset_every`` samples where it is set; ``start_value``
    is every counter's first magnitude."""
    rng = np.random.default_rng(seed)
    values = dict.fromkeys(keys, start_value)
    container = RecordContainer()
    offset = 0
    for s in range(n_samples):
        ts = start_ms + s * interval_ms
        for k in keys:
            if reset_every and s > 0 and s % reset_every == 0:
                values[k] = 0.0
            values[k] += float(rng.integers(0, 20))
            container.add(IngestRecord(k, ts, (values[k],)))
            if len(container) >= batch:
                yield SomeData(container, offset)
                offset += 1
                container = RecordContainer()
    if len(container):
        yield SomeData(container, offset)


DEFAULT_LES = np.array([0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                        np.inf])


def histogram_stream(keys, n_samples: int, start_ms: int = 0,
                     interval_ms: int = 10_000, batch: int = 100, seed: int = 0,
                     les: np.ndarray = DEFAULT_LES):
    """prom-histogram samples: (sum, count, (les, cumulative buckets))."""
    rng = np.random.default_rng(seed)
    nb = len(les)
    state = {k: np.zeros(nb, np.int64) for k in keys}
    sums = dict.fromkeys(keys, 0.0)
    container = RecordContainer()
    offset = 0
    for s in range(n_samples):
        ts = start_ms + s * interval_ms
        for k in keys:
            cum = np.cumsum(rng.integers(0, 5, nb))
            state[k] = state[k] + cum
            sums[k] += float(cum[-1]) * 0.2
            container.add(IngestRecord(
                k, ts, (sums[k], float(state[k][-1]), (les, state[k].copy()))))
            if len(container) >= batch:
                yield SomeData(container, offset)
                offset += 1
                container = RecordContainer()
    if len(container):
        yield SomeData(container, offset)
