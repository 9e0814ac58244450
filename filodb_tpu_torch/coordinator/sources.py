"""Ingestion stream sources.

Copy of ``filodb_tpu/coordinator/sources.py`` over the port's part keys
and records. Counterpart of reference ``IngestionStream(Factory)`` SPI
(``coordinator/src/main/scala/filodb.coordinator/IngestionStream.scala``)
and the ``CsvStream`` test source (``sources/CsvStream.scala:1-124``): a
source yields SomeData containers for one shard. The production source is a
``ReplayLog`` (``kafka/log.py``); these adapters turn external data into
container streams.
"""

from __future__ import annotations

import csv
from collections.abc import Iterator

from filodb_tpu_torch.core.partkey import METRIC_LABEL, PartKey
from filodb_tpu_torch.core.record import IngestRecord, RecordContainer, SomeData


def csv_stream(path: str, metric: str, schema: str = "gauge",
               batch: int = 100, default_labels: dict | None = None
               ) -> Iterator[SomeData]:
    """CSV rows → containers. Row format:
    ``timestamp_ms,value[,label=value,...]`` (reference CsvStream)."""
    container = RecordContainer()
    offset = 0
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts, value = int(row[0]), float(row[1])
            labels = {METRIC_LABEL: metric, **(default_labels or {})}
            for pair in row[2:]:
                k, v = pair.split("=", 1)
                labels[k] = v
            container.add(IngestRecord(PartKey.create(schema, labels), ts,
                                       (value,)))
            if len(container) >= batch:
                yield SomeData(container, offset)
                offset += 1
                container = RecordContainer()
    if len(container):
        yield SomeData(container, offset)


def influx_file_stream(path: str, default_labels: dict | None = None,
                       batch: int = 100) -> Iterator[SomeData]:
    """Influx line-protocol file → containers (gateway-format replay)."""
    from filodb_tpu_torch.gateway.influx import InfluxParseError, parse_influx_line

    container = RecordContainer()
    offset = 0
    with open(path) as f:
        for line in f:
            try:
                for rec in parse_influx_line(line, default_labels):
                    container.add(rec)
            except InfluxParseError:
                continue
            if len(container) >= batch:
                yield SomeData(container, offset)
                offset += 1
                container = RecordContainer()
    if len(container):
        yield SomeData(container, offset)
