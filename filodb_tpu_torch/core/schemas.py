"""Dataset schemas and column metadata.

Copy of ``filodb_tpu/core/schemas.py`` trimmed to the schemas the port
serves: ``gauge``, ``prom-counter`` and ``prom-histogram``. Column 0 is always
the timestamp; the value column of a counter schema carries ``is_counter``,
which turns on reset correction in ``rate``/``increase``/``delta``. A
histogram value column holds cumulative bucket counts per sample. The schema
id is the reference's (crc32 of the name and column types, 16 bits).
"""

from __future__ import annotations

import enum
import zlib
from dataclasses import dataclass, field


class ColumnType(enum.Enum):
    TIMESTAMP = "ts"
    DOUBLE = "double"
    HISTOGRAM = "hist"


@dataclass(frozen=True)
class Column:
    name: str
    ctype: ColumnType
    # detectDrops: counter columns get reset-correction in rate/increase
    is_counter: bool = False


@dataclass(frozen=True)
class DataSchema:
    """Column layout of a time series row. Column 0 is always the timestamp."""

    name: str
    columns: tuple[Column, ...]
    value_column: int  # index of the default value column for queries

    def __post_init__(self):
        if self.columns[0].ctype != ColumnType.TIMESTAMP:
            raise ValueError("column 0 must be the timestamp")


@dataclass(frozen=True)
class PartitionSchema:
    """Partition-key layout: which labels form the shard key."""

    shard_key_labels: tuple[str, ...] = ("_ws_", "_ns_", "_metric_")


@dataclass(frozen=True)
class Schema:
    data: DataSchema
    part: PartitionSchema = field(default_factory=PartitionSchema)

    @property
    def name(self) -> str:
        return self.data.name

    @property
    def is_counter(self) -> bool:
        return self.data.columns[self.data.value_column].is_counter

    @property
    def is_histogram(self) -> bool:
        return self.data.columns[self.data.value_column].ctype \
            == ColumnType.HISTOGRAM

    @property
    def schema_id(self) -> int:
        sig = self.data.name + "|" + ",".join(
            f"{c.name}:{c.ctype.value}" for c in self.data.columns)
        return zlib.crc32(sig.encode()) & 0xFFFF


def _mk(name, cols, value_column) -> Schema:
    return Schema(DataSchema(name, tuple(cols), value_column))


GAUGE = _mk(
    "gauge",
    [Column("timestamp", ColumnType.TIMESTAMP), Column("value", ColumnType.DOUBLE)],
    value_column=1,
)

PROM_COUNTER = _mk(
    "prom-counter",
    [Column("timestamp", ColumnType.TIMESTAMP),
     Column("value", ColumnType.DOUBLE, is_counter=True)],
    value_column=1,
)

PROM_HISTOGRAM = _mk(
    "prom-histogram",
    [Column("timestamp", ColumnType.TIMESTAMP),
     Column("sum", ColumnType.DOUBLE, is_counter=True),
     Column("count", ColumnType.DOUBLE, is_counter=True),
     Column("h", ColumnType.HISTOGRAM, is_counter=True)],
    value_column=3,
)

SCHEMAS = {s.name: s for s in (GAUGE, PROM_COUNTER, PROM_HISTOGRAM)}
