"""Influx line protocol → ingestion records.

Copy of ``filodb_tpu/gateway/influx.py`` (the reference's histogram-aware
Influx conversion):

  measurement[,tag=v,...] field=value[,field2=v2,...] [timestamp_ns]

- single field ``value``        → gauge record, metric = measurement
- single field ``counter``      → prom-counter record
- histogram fields (numeric bucket bounds / ``+Inf`` with ``sum``/``count``)
  → one first-class prom-histogram record (the reference's histogram-aware
  Influx conversion)
- multiple generic fields       → one gauge series per field, metric =
  ``measurement_field``

Tags become labels; ``_ws_``/``_ns_`` default from the gateway config when
absent (reference gateway dataset conventions).

A line with no backslash and no double quote splits with ``str.split``,
which gives what the escape-aware scanners give there, at a fraction of
their cost (a scrape is hundreds of thousands of lines).
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch.core.partkey import METRIC_LABEL, PartKey
from filodb_tpu_torch.core.record import IngestRecord


class InfluxParseError(ValueError):
    pass


def _split_unescaped(s: str, sep: str) -> list[str]:
    out, cur, i = [], [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            cur.append(s[i + 1])
            i += 2
            continue
        if c == sep:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def _split_top(s: str) -> list[str]:
    """Split line into measurement+tags / fields / timestamp on unescaped,
    unquoted spaces."""
    parts, cur = [], []
    in_quote = False
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            cur.append(c)
            cur.append(s[i + 1])
            i += 2
            continue
        if c == '"':
            in_quote = not in_quote
            cur.append(c)
        elif c == " " and not in_quote:
            if cur:
                parts.append("".join(cur))
                cur = []
        else:
            cur.append(c)
        i += 1
    if cur:
        parts.append("".join(cur))
    return parts


def _parse_field_value(v: str) -> float:
    if v.endswith(("i", "u")):
        return float(int(v[:-1]))
    if v in ("t", "T", "true", "True"):
        return 1.0
    if v in ("f", "F", "false", "False"):
        return 0.0
    if v.startswith('"'):
        raise InfluxParseError("string field values are not ingestible")
    return float(v)


def parse_influx_line(line: str, default_labels: dict[str, str] | None = None,
                      now_ms: int | None = None) -> list[IngestRecord]:
    """Parse one line; returns the ingestion records it produces."""
    line = line.strip()
    if not line or line.startswith("#"):
        return []
    plain = "\\" not in line and '"' not in line
    parts = [p for p in line.split(" ") if p] if plain else _split_top(line)
    if len(parts) < 2:
        raise InfluxParseError(f"malformed line: {line!r}")
    meas_and_tags = parts[0].split(",") if plain \
        else _split_unescaped(parts[0], ",")
    measurement = meas_and_tags[0]
    labels: dict[str, str] = dict(default_labels or {})
    for tag in meas_and_tags[1:]:
        if "=" not in tag:
            raise InfluxParseError(f"malformed tag {tag!r}")
        k, v = tag.split("=", 1)
        labels[k] = v
    fields: dict[str, float] = {}
    for fkv in (parts[1].split(",") if plain
                else _split_unescaped(parts[1], ",")):
        if "=" not in fkv:
            raise InfluxParseError(f"malformed field {fkv!r}")
        k, v = fkv.split("=", 1)
        try:
            fields[k] = _parse_field_value(v)
        except InfluxParseError:
            continue  # skip string fields
    if len(parts) >= 3:
        ts_ms = int(int(parts[2]) // 1_000_000)  # ns → ms
    else:
        import time
        ts_ms = now_ms if now_ms is not None else int(time.time() * 1000)

    if not fields:
        return []

    # histogram detection: numeric bucket bounds (or +Inf) plus sum/count
    bucket_keys = []
    for k in fields:
        if k in ("sum", "count"):
            continue
        try:
            float(k.replace("+Inf", "inf"))
            bucket_keys.append(k)
        except ValueError:
            bucket_keys = []
            break
    if bucket_keys and "sum" in fields and "count" in fields:
        les = sorted((float(k.replace("+Inf", "inf")), k)
                     for k in bucket_keys)
        le_arr = np.array([le for le, _ in les])
        buckets = np.array([fields[k] for _, k in les], dtype=np.int64)
        key = PartKey.create("prom-histogram",
                             {**labels, METRIC_LABEL: measurement})
        return [IngestRecord(key, ts_ms,
                             (fields["sum"], fields["count"],
                              (le_arr, buckets)))]

    out = []
    if set(fields) == {"value"}:
        key = PartKey.create("gauge", {**labels, METRIC_LABEL: measurement})
        out.append(IngestRecord(key, ts_ms, (fields["value"],)))
    elif set(fields) == {"counter"}:
        key = PartKey.create("prom-counter",
                             {**labels, METRIC_LABEL: measurement})
        out.append(IngestRecord(key, ts_ms, (fields["counter"],)))
    else:
        for fname, fval in fields.items():
            key = PartKey.create(
                "gauge", {**labels, METRIC_LABEL: f"{measurement}_{fname}"})
            out.append(IngestRecord(key, ts_ms, (fval,)))
    return out
