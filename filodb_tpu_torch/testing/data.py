"""Seeded series and sample streams for tests and the mesh harness.

Copy of the parts of ``filodb_tpu/testing/data.py`` that
``testing/mesh_store.py`` needs (``counter_series``, ``counter_stream``):
the same seeds give the same containers as the reference's, record for
record (``tests/test_torch_multiproc_mesh.py`` holds them equal).
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import IngestRecord, RecordContainer, SomeData


def counter_series(n_series: int = 10, metric: str = "http_requests_total",
                   ws: str = "demo", ns: str = "App-0") -> list[PartKey]:
    return [PartKey.create("prom-counter", {
        "_metric_": metric, "_ws_": ws, "_ns_": ns,
        "instance": f"instance-{i}", "job": f"job-{i % 3}",
    }) for i in range(n_series)]


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
