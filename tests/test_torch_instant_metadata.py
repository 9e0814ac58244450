"""Port parity for instant queries and the metadata calls a Prometheus
client makes first: ``QueryService.query_instant`` (steps ``(t, 0, t)``),
``label_names``, ``label_values`` and ``series``, and the ``vector`` and
``scalar`` bodies of ``http.promjson``.

Stores: ``test_torch_slice``'s scalar series and ``test_torch_histograms``'
histograms. Instant answers are held against every reference lane
(``reference_lanes``) at ``rtol=2e-5, atol=1e-6`` (histograms at their
tests' ``rtol=5e-5, atol=1e-4``); the JSON bodies must be byte-equal to the
reference's ``vector_json`` / ``scalar_json`` (``json.dumps`` of both);
metadata must equal the reference ``QueryService``'s (``LabelNames`` /
``LabelValues`` through ``execute_logical``, and ``series``).
"""

import json

import numpy as np
import pytest

from filodb_tpu.http import promjson as ref_json
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query import logical as ref_lp
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.http import promjson
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.testing.from_jax import ingest_states
from test_torch_slice import (
    Q_END,
    Q_START,
    START_S,
    _build_stores,
    _series_specs,
    _sorted,
    reference_lanes,
)

M = "http_requests_total"
TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
HIST_TOL = dict(rtol=5e-5, atol=1e-4, equal_nan=True)
T = Q_START + 930  # an instant between samples
SCALAR_QUERIES = ("time()", "time() * 2 - 7", f"scalar(sum({M}))",
                  "scalar(nope)", "pi()")


@pytest.fixture(scope="module")
def services():
    ref, port = _build_stores(_series_specs(), 64)
    return (*reference_lanes(ref), QueryService(port, device="cpu"))


@pytest.fixture(scope="module")
def hist_services():
    import test_torch_histograms as th

    specs = th._hist_specs()
    ref = th._reference_store(specs, th._flat_specs(specs))
    port = MemStore(th.NUM_SHARDS, spread=1, max_chunk_size=th.CHUNK)
    ingest_states(port, th._states(ref))
    return (*reference_lanes(ref), QueryService(port, device="cpu"))


def _renderers(q):
    return (promjson.scalar_json, ref_json.scalar_json) \
        if q in SCALAR_QUERIES else (promjson.vector_json,
                                     ref_json.vector_json)


def _body_values(body):
    """(the body without its sample values, the values as floats)."""
    data = body["data"]["result"]
    if body["data"]["resultType"] == "scalar":
        return (body["data"]["resultType"], data[0]), [float(data[1])]
    return ([(s["metric"], s["value"][0]) for s in data],
            [float(s["value"][1]) for s in data])


def _instant(services, q, t=T, tol=TOL):
    """The port's instant answer against every reference lane's, and its
    body against the reference's: byte-equal where the values are, else
    equal but for the values, which agree within ``tol`` (B3 rates in
    float32 where exec computes in float64); returns the port's answer."""
    *refs, port = services
    got = port.query_instant(q, t)
    gk, gv = _sorted(got)
    assert got.result.num_steps == 1 and got.result.steps_ms[0] == t * 1000
    render, ref_render = _renderers(q)
    body = render(got)
    for svc in refs:
        want = svc.query_instant(q, t)
        want.result.materialize()
        wk, wv = _sorted(want)
        assert gk == wk, (q, svc.engine)
        if gk:
            np.testing.assert_allclose(gv, wv, err_msg=f"{q} {svc.engine}",
                                       **tol)
        want_body = ref_render(want)
        if gk and np.array_equal(gv, wv, equal_nan=True):
            assert json.dumps(body) == json.dumps(want_body), \
                (q, svc.engine)
        shape, vals = _body_values(body)
        want_shape, want_vals = _body_values(want_body)
        assert shape == want_shape, (q, svc.engine)
        np.testing.assert_allclose(vals, want_vals, **tol)
    return got


@pytest.mark.parametrize("q", [
    M, f"rate({M}[5m])", "queue_depth offset 30m", "time()", "nope",
    f"sum(rate({M}[5m])) by (job)", "scalar(nope)"])
def test_bodies_render_byte_equal_to_the_reference(services, q):
    """One answer (the reference exec's, NaN rows and all) rendered by
    both packages: ``vector_json`` / ``scalar_json`` give the same bytes."""
    from filodb_tpu_torch.query.model import (
        QueryResult,
        RangeVectorKey,
        StepMatrix,
    )

    exec0 = services[0]
    want = exec0.query_instant(q, T)
    m = want.result.materialize()
    mine = QueryResult(StepMatrix([RangeVectorKey(k.labels) for k in m.keys],
                                  np.array(m.values), m.steps_ms))
    render, ref_render = _renderers(q)
    assert json.dumps(render(mine)) == json.dumps(ref_render(want))


@pytest.mark.parametrize("q", [
    M, f'{M}{{job="job-1"}}', f"{M} offset 5m", "queue_depth",
    f"sum({M}) by (job)", f"sum(rate({M}[5m])) by (_ns_)",
    f"topk(2, rate({M}[5m]))", f"count_over_time(queue_depth[2m])",
    f"max_over_time(queue_depth[10m])", "absent(nope)",
    f'count_values("v", queue_depth % 5)', f"sort_desc(rate({M}[5m]))",
    f"{M} @ {T - 600}", f"max_over_time(sum(rate({M}[5m]))[10m:1m])",
    f"rate({M}[5m]) * time()", "vector(1) + 1",
])
def test_instant_vectors_match_the_reference(services, q):
    _instant(services, q)


@pytest.mark.parametrize("q", SCALAR_QUERIES)
def test_instant_scalars_match_the_reference(services, q):
    got = _instant(services, q)
    body = promjson.scalar_json(got)
    assert body["data"]["resultType"] == "scalar"
    assert body["data"]["result"][0] == T


def test_instant_selector_at_a_sample_and_past_the_data(services):
    """At the instant of the last data a bare selector answers every live
    series; past the staleness lookback every series is NaN, and the body
    holds none."""
    got = _instant(services, M, START_S + 1500)
    assert promjson.vector_json(got)["data"]["result"]
    late = _instant(services, M, START_S + 10_000)
    assert np.isnan(late.result.values).all()
    assert promjson.vector_json(late)["data"]["result"] == []


@pytest.mark.parametrize("q", [
    "histogram_quantile(0.9, sum(rate(lat[5m])) by (job))",
    "histogram_quantile(0.5, rate(lat[5m]))",
    "histogram_quantile(0.99, sum(rate(lat_bucket[5m])) by (le))",
    "sum(rate(lat[5m])) by (job)",
])
def test_instant_histogram_queries_match_the_reference(hist_services, q):
    got = _instant(hist_services, q, tol=HIST_TOL)
    body = promjson.vector_json(got)
    assert body["data"]["resultType"] == "vector" and body["data"]["result"]
    if q.startswith("sum"):  # a histogram matrix renders one series a bucket
        assert {s["metric"]["le"] for s in body["data"]["result"]} >= \
            {"+Inf"}


def test_vector_body_of_a_histogram_equals_the_reference(hist_services):
    exec0, *_, port = hist_services
    q = "sum(rate(lat[5m])) by (job)"
    got = promjson.vector_json(port.query_instant(q, T))
    want = exec0.query_instant(q, T)
    want.result.materialize()
    want = ref_json.vector_json(want)

    def rows(body):
        return sorted((tuple(sorted(s["metric"].items())), s["value"][0],
                       float(s["value"][1])) for s in body["data"]["result"])

    g, w = rows(got), rows(want)
    assert [r[:2] for r in g] == [r[:2] for r in w]
    np.testing.assert_allclose([r[2] for r in g], [r[2] for r in w],
                               **HIST_TOL)


# ---------------------------------------------------------------------------
# metadata


def _filters(q):
    """(port filters, reference filters) of a selector."""
    return (parse_query(q, TimeStepParams(Q_START, 0, Q_END)).raw.filters,
            ref_parse(q, RefParams(Q_START, 0, Q_END)).raw.filters)


def test_label_names_match_the_reference(services):
    exec0, *_, port = services
    want = [v for _, v in exec0.execute_logical(ref_lp.LabelNames()).result
            .meta]
    assert port.label_names() == want
    assert "_metric_" in want and "job" in want


@pytest.mark.parametrize("label,selector", [
    ("job", None), ("instance", None), ("_metric_", None), ("_ns_", None),
    ("nolabel", None), ("instance", f'{M}{{job="job-1"}}'),
    ("job", 'queue_depth{instance=~"instance-2.*"}'),
    ("_metric_", '{_ns_="App-1"}'), ("instance", 'nope{job="x"}'),
    ("job", f'{M}{{job!="job-0",_ns_="App-0"}}'),
])
def test_label_values_match_the_reference(services, label, selector):
    exec0, *_, port = services
    pf, rf = _filters(selector) if selector else ((), ())
    want = [v for _, v in exec0.execute_logical(
        ref_lp.LabelValues(label, tuple(rf))).result.meta]
    assert port.label_values(label, pf) == want


@pytest.mark.parametrize("selector,start,end", [
    (f'{M}{{job="job-1"}}', START_S, START_S + 3000),
    ('{_ns_="App-1"}', START_S, START_S + 3000),
    ('queue_depth{instance!~"instance-2[0-3]"}', START_S, START_S + 3000),
    (f"{M}", START_S + 10**6, START_S + 2 * 10**6),
    ('nope{job="x"}', START_S, START_S + 3000),
])
def test_series_match_the_reference(services, selector, start, end):
    exec0, *_, port = services
    pf, rf = _filters(selector)
    got = port.series(pf, start, end)
    assert got == exec0.series(list(rf), start, end)
    assert all("_metric_" in lm for lm in got)


def test_metadata_of_histograms_match_the_reference(hist_services):
    exec0, *_, port = hist_services
    assert port.label_names() == [v for _, v in exec0.execute_logical(
        ref_lp.LabelNames()).result.meta]
    pf, rf = _filters('lat{job="job-1"}')
    assert port.label_values("instance", pf) == [
        v for _, v in exec0.execute_logical(ref_lp.LabelValues(
            "instance", tuple(rf))).result.meta]
    assert port.series(pf, START_S, START_S + 3000) == \
        exec0.series(list(rf), START_S, START_S + 3000)
