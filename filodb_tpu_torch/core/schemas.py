"""Dataset schemas and column metadata.

Copy of ``filodb_tpu/core/schemas.py``: ``gauge``, ``untyped`` (a gauge's
columns, no downsamplers), ``prom-counter``, ``prom-histogram`` and the
downsample schema ``ds-gauge`` (the timestamp and five DOUBLE rollup columns, ``min``,
``max``, ``sum``, ``count`` and ``avg``; its value column is ``avg``). Each
raw schema names its downsamplers and the schema its rollups take
(``ds_schema``): a gauge rolls up into ``ds-gauge``, a counter keeps its
last sample a period (``dLast``) in ``prom-counter``. Column 0 is always
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
    downsamplers: tuple[str, ...] = ()  # e.g. ("tTime(0)", "dMin(1)", ...)
    downsample_schema: str | None = None

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
    def is_multi(self) -> bool:
        """More than one DOUBLE value column and no histogram: the rollup
        schema ``ds-gauge``, whose selectors read one column by name."""
        return not self.is_histogram and sum(
            c.ctype == ColumnType.DOUBLE for c in self.data.columns) > 1

    @property
    def is_histogram(self) -> bool:
        return self.data.columns[self.data.value_column].ctype \
            == ColumnType.HISTOGRAM

    @property
    def schema_id(self) -> int:
        sig = self.data.name + "|" + ",".join(
            f"{c.name}:{c.ctype.value}" for c in self.data.columns)
        return zlib.crc32(sig.encode()) & 0xFFFF


def _mk(name, cols, value_column, downsamplers=(), ds_schema=None) -> Schema:
    return Schema(DataSchema(name, tuple(cols), value_column,
                             tuple(downsamplers), ds_schema))


GAUGE = _mk(
    "gauge",
    [Column("timestamp", ColumnType.TIMESTAMP), Column("value", ColumnType.DOUBLE)],
    value_column=1,
    downsamplers=["tTime(0)", "dMin(1)", "dMax(1)", "dSum(1)", "dCount(1)",
                  "dAvg(1)"],
    ds_schema="ds-gauge",
)

PROM_COUNTER = _mk(
    "prom-counter",
    [Column("timestamp", ColumnType.TIMESTAMP),
     Column("value", ColumnType.DOUBLE, is_counter=True)],
    value_column=1,
    downsamplers=["tTime(0)", "dLast(1)"],
    ds_schema="prom-counter",
)

PROM_HISTOGRAM = _mk(
    "prom-histogram",
    [Column("timestamp", ColumnType.TIMESTAMP),
     Column("sum", ColumnType.DOUBLE, is_counter=True),
     Column("count", ColumnType.DOUBLE, is_counter=True),
     Column("h", ColumnType.HISTOGRAM, is_counter=True)],
    value_column=3,
    downsamplers=["tTime(0)", "dLast(1)", "dLast(2)", "hLast(3)"],
    ds_schema="prom-histogram",
)

DS_GAUGE = _mk(
    "ds-gauge",
    [Column("timestamp", ColumnType.TIMESTAMP),
     Column("min", ColumnType.DOUBLE),
     Column("max", ColumnType.DOUBLE),
     Column("sum", ColumnType.DOUBLE),
     Column("count", ColumnType.DOUBLE),
     Column("avg", ColumnType.DOUBLE)],
    value_column=5,
)

UNTYPED = _mk(
    "untyped",
    [Column("timestamp", ColumnType.TIMESTAMP), Column("value", ColumnType.DOUBLE)],
    value_column=1,
)

# a schema's index in this order is its index in ``record.SCHEMA_NAMES``
# (``untyped`` last, so the indexes of the others stay as they were)
SCHEMAS = {s.name: s for s in (GAUGE, PROM_COUNTER, PROM_HISTOGRAM,
                               DS_GAUGE, UNTYPED)}
