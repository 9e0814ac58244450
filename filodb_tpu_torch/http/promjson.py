"""Prometheus HTTP API JSON rendering of a range query's answer.

Port of ``filodb_tpu/http/promjson.py::matrix_json``: StepMatrix → the
Prometheus ``matrix`` response body. NaN entries are gaps and are omitted;
a series with no sample at all is left out. A histogram matrix is
flattened into one series a bucket, labelled ``le``
(``StepMatrix.flatten_histograms``), as the reference renders first-class
histograms on the Prometheus wire.
"""

from __future__ import annotations

import math

from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.query.model import QueryResult
from filodb_tpu_torch.query.model import prom_float as _fmt


def _labels_json(key) -> dict:
    return {("__name__" if k == METRIC_LABEL else k): v
            for k, v in key.labels}


def _stats_json(result: QueryResult) -> dict:
    s = result.stats
    return {"seriesScanned": s.series_scanned,
            "samplesScanned": s.samples_scanned,
            "resultSeries": s.result_series,
            "wallTimeMs": round(s.wall_time_s * 1000.0, 3)}


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
            "queryStats": _stats_json(result)}
