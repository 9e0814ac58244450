"""Dataset schemas and column metadata.

Copy of ``filodb_tpu/core/schemas.py`` trimmed to the two scalar schemas
this slice serves: ``gauge`` and ``prom-counter``. Column 0 is always the
timestamp; the value column of a counter schema carries ``is_counter``, which
turns on reset correction in ``rate``/``increase``/``delta``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class ColumnType(enum.Enum):
    TIMESTAMP = "ts"
    DOUBLE = "double"


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

SCHEMAS = {s.name: s for s in (GAUGE, PROM_COUNTER)}
