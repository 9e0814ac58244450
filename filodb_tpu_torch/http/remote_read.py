"""Prometheus remote-read protocol support.

Counterpart of reference ``prometheus/src/main/proto/remote-storage.proto`` +
``PrometheusModel.toPromReadResponse`` (``query/PrometheusModel.scala:13-51``)
and the remote-read route in ``PrometheusApiRoute``.

The message schema is tiny, so the wire codec is implemented directly
(varint/length-delimited protobuf encoding) — no generated code needed:

  ReadRequest  { repeated Query queries = 1; }
  Query        { int64 start_timestamp_ms = 1; int64 end_timestamp_ms = 2;
                 repeated LabelMatcher matchers = 3; }
  LabelMatcher { enum Type { EQ NEQ RE NRE } type = 1;
                 string name = 2; string value = 3; }
  ReadResponse { repeated QueryResult results = 1; }
  QueryResult  { repeated TimeSeries timeseries = 1; }
  TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
  Label        { string name = 1; string value = 2; }
  Sample       { double value = 1; int64 timestamp = 2; }

Bodies are snappy-framed by Prometheus; when the snappy module is absent the
endpoint accepts/produces raw protobuf (clients can disable compression) and
reports 501 for snappy payloads.

Copy of ``filodb_tpu/http/remote_read.py`` (the codec byte for byte), with
``read_series``: a query's series from the port's shards, their samples
float64 as ingested (``Shard.exact_samples``, never the float32 pages).
"""

from __future__ import annotations

import struct

import numpy as np

from filodb_tpu_torch.core.filters import (
    ColumnFilter,
    Equals,
    EqualsRegex,
    NotEquals,
    NotEqualsRegex,
)
from filodb_tpu_torch.core.partkey import METRIC_LABEL

try:
    import snappy  # type: ignore

    HAVE_SNAPPY = True
except ImportError:  # pragma: no cover - env dependent
    snappy = None
    HAVE_SNAPPY = False


# ---- minimal protobuf wire codec ------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _iter_fields(data: bytes):
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
        elif wire == 1:
            val = data[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            val = data[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---- request decode --------------------------------------------------------

_MATCHER_TYPES = {0: Equals, 1: NotEquals, 2: EqualsRegex, 3: NotEqualsRegex}


def decode_read_request(data: bytes) -> list[dict]:
    """ReadRequest → [{start_ms, end_ms, filters}]."""
    queries = []
    for field, _, val in _iter_fields(data):
        if field == 1:
            queries.append(_decode_query(val))
    return queries


def _decode_query(data: bytes) -> dict:
    out = {"start_ms": 0, "end_ms": 0, "filters": []}
    for field, _, val in _iter_fields(data):
        if field == 1:
            out["start_ms"] = val if isinstance(val, int) else 0
        elif field == 2:
            out["end_ms"] = val if isinstance(val, int) else 0
        elif field == 3:
            out["filters"].append(_decode_matcher(val))
    return out


def _decode_matcher(data: bytes) -> ColumnFilter:
    mtype, name, value = 0, "", ""
    for field, _, val in _iter_fields(data):
        if field == 1:
            mtype = val
        elif field == 2:
            name = val.decode()
        elif field == 3:
            value = val.decode()
    if name == "__name__":
        name = METRIC_LABEL
    return ColumnFilter(name, _MATCHER_TYPES[mtype](value))


# ---- response encode -------------------------------------------------------

def encode_read_response(query_results: list) -> bytes:
    """Encode raw series into a ReadResponse.

    ``query_results``: one entry per request query, each a list of
    (labels: list[(name, value)], ts_ms int64[n], values float64[n]).
    Remote read returns RAW samples (the reference converts RangeVectors via
    ``toPromReadResponse``).
    """
    import math

    results = []
    for series_list in query_results:
        series_msgs = []
        for labels_kv, ts, vals in series_list:
            labels = b"".join(
                _ld(1, _ld(1, ("__name__" if k == METRIC_LABEL else k)
                           .encode()) + _ld(2, v.encode()))
                for k, v in labels_kv)
            samples = bytearray()
            for k in range(len(ts)):
                v = float(vals[k])
                if math.isnan(v):
                    continue
                body = (_key(1, 1) + struct.pack("<d", v)
                        + _key(2, 0) + _varint(int(ts[k])))
                samples += _ld(2, body)
            series_msgs.append(_ld(1, labels + bytes(samples)))
        results.append(_ld(1, b"".join(series_msgs)))
    return b"".join(results)


def read_series(memstore, query: dict) -> list:
    """The raw series of one decoded query over a port ``MemStore``, as
    ``encode_read_response`` takes them: (labels, ts, values) of every
    matching partition, shard by shard, in each shard's lookup order.
    Histograms are left out, as remote-read v1 has them."""
    start, end = query["start_ms"], query["end_ms"]
    out = []
    for shard in memstore.shards:
        pids = shard.lookup_partitions(query["filters"], start, end)
        pids = pids[~shard.hist[pids]]
        got = {}
        for multi in (False, True):
            sel = pids[shard.multi[pids] == multi]
            if not len(sel):
                continue
            row, ts, vals = shard.exact_samples(sel, start, end)
            bounds = np.searchsorted(row, np.arange(len(sel) + 1))
            for i, pid in enumerate(sel.tolist()):
                a, b = bounds[i], bounds[i + 1]
                got[pid] = (ts[a:b], vals[a:b])
        for pid in pids.tolist():
            out.append((list(shard.keys[pid].labels), *got[pid]))
    return out


def maybe_compress(data: bytes) -> bytes:
    return snappy.compress(data) if HAVE_SNAPPY else data


def maybe_decompress(data: bytes) -> bytes:
    if HAVE_SNAPPY:
        try:
            return snappy.decompress(data)
        except Exception:
            return data
    return data
