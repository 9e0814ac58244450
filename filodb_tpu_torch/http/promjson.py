"""Prometheus HTTP API JSON rendering of a query's answer.

Port of ``filodb_tpu/http/promjson.py``: ``matrix_json`` (a range query's
StepMatrix → the ``matrix`` body), ``vector_json`` (an instant query's
last step → the ``vector`` body) and ``scalar_json`` (a scalar
expression's last step); ``matrix_json_str`` and ``vector_json_str``, the
same bodies rendered straight to the JSON text the HTTP API sends (values
formatted in one vectorised pass); and ``error_json``, the error
envelope. NaN entries are gaps and are omitted;
a series with no sample at all is left out. A histogram matrix is
flattened into one series a bucket, labelled ``le``
(``StepMatrix.flatten_histograms``), as the reference renders first-class
histograms on the Prometheus wire.
"""

from __future__ import annotations

import json
import math

import numpy as np

from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.query.model import QueryResult
from filodb_tpu_torch.query.model import prom_float as _fmt


def _labels_json(key) -> dict:
    return {("__name__" if k == METRIC_LABEL else k): v
            for k, v in key.labels}


def _stats_json(result: QueryResult, full: bool = False) -> dict:
    """The four basic stats; with ``full`` (``?stats=all``) the counters
    the port keeps beside them (``wireBytes``: what remote children's
    dispatches sent and received; ``decodeMs``: the exec leaves' batch builds
    and the sidecar and pyramid lanes' folds; ``reduceMs``: the leaves'
    transformers and the aggregations), a federated query's per-tier buckets
    (``tiers``) and the pyramid lane's levels and bytes (``pyramid``)."""
    s = result.stats
    out = {"seriesScanned": s.series_scanned,
           "samplesScanned": s.samples_scanned,
           "resultSeries": s.result_series,
           "wallTimeMs": round(s.wall_time_s * 1000.0, 3)}
    if full:
        out.update({"chunksTouched": s.chunks_touched,
                    "cacheHits": s.cache_hits,
                    "cacheMisses": s.cache_misses,
                    "wireBytes": s.wire_bytes,
                    "admissionWaitMs": round(s.admission_wait_s * 1000.0,
                                             3),
                    "decodeMs": round(s.decode_s * 1000.0, 3),
                    "reduceMs": round(s.reduce_s * 1000.0, 3)})
        if s.tiers:
            out["tiers"] = {
                tier: {k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in bucket.items()}
                for tier, bucket in s.tiers.items()}
        if s.pyramid:
            out["pyramid"] = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in s.pyramid.items()}
    return out


def _partial_fields(result: QueryResult) -> dict:
    """``partial`` and ``warnings`` of an answer a budget degraded (the
    Prometheus API's ``warnings``); empty for a whole one."""
    out = {}
    if result.partial:
        out["partial"] = True
    if result.warnings:
        out["warnings"] = list(result.warnings)
    return out


def _partial_fields_str(result: QueryResult) -> str:
    """``_partial_fields`` as a leading-comma fragment, or ""."""
    fields = _partial_fields(result)
    if not fields:
        return ""
    return "," + json.dumps(fields, separators=(",", ":"))[1:-1]


def matrix_json(result: QueryResult) -> dict:
    m = result.result.materialize()
    if m.is_histogram:
        m = m.flatten_histograms()
    series = []
    for i, key in enumerate(m.keys):
        row = m.values[i]
        vals = [[m.steps_ms[k] / 1000.0, _fmt(row[k])]
                for k in range(m.num_steps) if not math.isnan(row[k])]
        if vals:
            series.append({"metric": _labels_json(key), "values": vals})
    return {"status": "success",
            "data": {"resultType": "matrix", "result": series},
            "queryStats": _stats_json(result), **_partial_fields(result)}


def vector_json(result: QueryResult) -> dict:
    """The last step of every series with a value there."""
    m = result.result.materialize()
    if m.is_histogram:
        m = m.flatten_histograms()
    out = []
    k = m.num_steps - 1
    for i, key in enumerate(m.keys):
        v = m.values[i, k] if m.num_steps else float("nan")
        if not math.isnan(v):
            out.append({"metric": _labels_json(key),
                        "value": [m.steps_ms[k] / 1000.0, _fmt(v)]})
    return {"status": "success",
            "data": {"resultType": "vector", "result": out},
            **_partial_fields(result)}


def scalar_json(result: QueryResult) -> dict:
    """A scalar expression's value at the last step."""
    m = result.result.materialize()
    k = m.num_steps - 1
    v = m.values[0, k] if m.num_series else float("nan")
    return {"status": "success",
            "data": {"resultType": "scalar",
                     "result": [m.steps_ms[k] / 1000.0, _fmt(v)]}}


def _labels_json_str(key) -> str:
    """A key's label object as JSON, kept on the key (keys repeat across
    queries)."""
    s = key.__dict__.get("_json_str")
    if s is None:
        s = json.dumps(_labels_json(key), separators=(",", ":"))
        object.__setattr__(key, "_json_str", s)
    return s


def _value_strings(vals: np.ndarray) -> np.ndarray:
    """Shortest round-trip strings of float64 values, vectorised (numpy's
    float formatting is Python's ``repr``), with the wire's specials."""
    sv = vals.astype("U24")
    if not np.isfinite(vals).all():
        sv = np.where(np.isposinf(vals), "+Inf", sv)
        sv = np.where(np.isneginf(vals), "-Inf", sv)
        sv = np.where(np.isnan(vals), "NaN", sv)
    return sv


def _stats_str(result: QueryResult, full: bool = False) -> str:
    return json.dumps(_stats_json(result, full), separators=(",", ":"))


def matrix_json_str(result: QueryResult, full_stats: bool = False) -> str:
    """The ``matrix`` body rendered straight to a JSON string, as the
    reference's HTTP front ends render it (``matrix_json_str``); it parses
    to ``matrix_json``'s object."""
    m = result.result.materialize()
    if m.is_histogram:
        m = m.flatten_histograms()
    vals = np.asarray(m.values, np.float64)
    ok = ~np.isnan(vals)
    sv = _value_strings(vals)
    ts_str = [repr(t / 1000.0) for t in np.asarray(m.steps_ms).tolist()]
    parts = []
    for i, key in enumerate(m.keys):
        idx = np.flatnonzero(ok[i])
        if not len(idx):
            continue
        row = sv[i]
        body = ",".join(f'[{ts_str[k]},"{row[k]}"]' for k in idx.tolist())
        parts.append('{"metric":%s,"values":[%s]}'
                     % (_labels_json_str(key), body))
    return ('{"status":"success","data":{"resultType":"matrix","result":[%s'
            ']},"queryStats":%s%s}' % (",".join(parts),
                                       _stats_str(result, full_stats),
                                       _partial_fields_str(result)))


def vector_json_str(result: QueryResult, with_stats: bool = False) -> str:
    """The ``vector`` body (the last step) rendered straight to a JSON
    string, as the reference's HTTP front ends render instant queries;
    ``with_stats`` (``?stats=all``) adds the full ``queryStats``."""
    stats = ',"queryStats":' + _stats_str(result, True) if with_stats \
        else ""
    m = result.result.materialize()
    if m.is_histogram:
        m = m.flatten_histograms()
    if not m.num_steps or not m.num_series:
        return ('{"status":"success","data":{"resultType":"vector",'
                '"result":[]}%s%s}' % (stats, _partial_fields_str(result)))
    k = m.num_steps - 1
    vals = np.asarray(m.values[:, k], np.float64)
    sv = _value_strings(vals)
    t = repr(float(m.steps_ms[k]) / 1000.0)
    parts = ['{"metric":%s,"value":[%s,"%s"]}'
             % (_labels_json_str(m.keys[i]), t, sv[i])
             for i in np.flatnonzero(~np.isnan(vals)).tolist()]
    return ('{"status":"success","data":{"resultType":"vector","result":'
            '[%s]}%s%s}' % (",".join(parts), stats,
                            _partial_fields_str(result)))


def error_json(message: str, error_type: str = "bad_data") -> dict:
    """The Prometheus API's error envelope."""
    return {"status": "error", "errorType": error_type, "error": message}
