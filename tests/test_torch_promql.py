"""Port parity for the PromQL the port serves over scalar series: every
range function under a set of aggregations, instant selectors, instant
functions, operators with a number, binary joins and set operators.

The store is ``test_torch_slice``'s (28 series, counters with resets and
gauges, 64-sample chunks), built once here. ``QueryService(port,
device="cpu")`` must equal the JAX ``QueryService`` on both its engines,
each lane named (``test_torch_slice.reference_lanes``): ``engine="exec"``
with ``FILODB_SIDECARS`` at 0 and at 1, and ``engine="mesh"`` (which falls
back to exec for the shapes it does not lower). Keys compare as sorted strings,
values with ``rtol=2e-5, atol=1e-6``, NaN equal; ``timestamp`` with
``atol=1e-3``.
"""

import re

import numpy as np
import pytest

from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.http.promjson import matrix_json
from test_torch_slice import (
    DS,
    NUM_SHARDS,
    Q_END,
    Q_START,
    Q_STEP,
    _build_stores,
    _series_specs,
    _sorted,
    reference_lanes,
)

TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
TS_TOL = dict(rtol=0, atol=1e-3, equal_nan=True)


@pytest.fixture(scope="module")
def stores():
    ref, port = _build_stores(_series_specs(), 64)
    return reference_lanes(ref), port


@pytest.fixture(scope="module", params=["mesh", "exec"])
def services(stores, request):
    """The reference lanes and the port on one of its two engines."""
    lanes, port = stores
    return (*lanes, QueryService(port, device="cpu", engine=request.param))


def _check(services, q, tol=TOL, expect_data=True):
    """Port against both reference engines; returns the port's answer."""
    *refs, port = services
    res = port.query_range(q, Q_START, Q_STEP, Q_END)
    got_keys, got = _sorted(res)
    if expect_data:
        assert len(got_keys) > 0 and np.isfinite(got).any(), q
    for svc in refs:
        r = svc.query_range(q, Q_START, Q_STEP, Q_END)
        r.result.materialize()
        want_keys, want = _sorted(r)
        assert got_keys == want_keys, (q, svc.engine)
        np.testing.assert_allclose(got, want, err_msg=f"{q} {svc.engine}",
                                   **tol)
    return res


RANGE_EXPRS = {
    "min_over_time": "min_over_time(queue_depth[5m])",
    "max_over_time": "max_over_time(http_requests_total[5m])",
    "stddev_over_time": "stddev_over_time(queue_depth[5m])",
    "stdvar_over_time": "stdvar_over_time(http_requests_total[5m])",
    "zscore": "zscore(queue_depth[5m])",
    "last_over_time": "last_over_time(http_requests_total[5m])",
    "timestamp": "timestamp(http_requests_total)",
    "present_over_time": "present_over_time(queue_depth[2m])",
    "changes": "changes(queue_depth[5m])",
    "resets": "resets(http_requests_total[10m])",
    "irate": "irate(http_requests_total[5m])",
    "idelta": "idelta(queue_depth[5m])",
    "deriv": "deriv(queue_depth[5m])",
    "predict_linear": "predict_linear(http_requests_total[5m], 600)",
    "quantile_over_time(0)": "quantile_over_time(0, queue_depth[5m])",
    "quantile_over_time(0.5)": "quantile_over_time(0.5, queue_depth[5m])",
    "quantile_over_time(0.9)":
        "quantile_over_time(0.9, http_requests_total[5m])",
    "quantile_over_time(1)": "quantile_over_time(1, queue_depth[5m])",
    "holt_winters": "holt_winters(queue_depth[5m], 0.5, 0.5)",
}
WRAPPERS = ("{}", "sum({}) by (job)", "max({}) by (instance)", "stddev({})",
            "stdvar({})", "group({})", "topk(2, {})", "bottomk(2, {})",
            "quantile(0.9, {})")

# the variance of epoch timestamps (~1.6e9 s) across series cancels
# E[x²] − E[x]² at a float64 ulp of 512: noise in both packages, left out
RANGE_CASES = [(n, w) for n in RANGE_EXPRS for w in WRAPPERS
               if not (n == "timestamp" and w.startswith("std"))]


@pytest.mark.parametrize("name,wrapper", RANGE_CASES)
def test_range_functions_match_both_reference_engines(services, name,
                                                      wrapper):
    q = wrapper.format(RANGE_EXPRS[name])
    # φ = 1 interpolates towards the +inf past a window's samples: NaN in
    # the reference (kernels.py::_quantile_impl), and so in the port
    _check(services, q, TS_TOL if name == "timestamp" else TOL,
           expect_data=name != "quantile_over_time(1)")


@pytest.mark.parametrize("q", [
    "http_requests_total",
    'http_requests_total{job="job-1"}',
    "sum(http_requests_total) by (job)",
    "http_requests_total offset 5m",
    "avg(queue_depth offset 3m) by (_ns_)",
    "topk(3, queue_depth)",
    "topk(1, queue_depth) by (job)",
    "quantile(0.5, http_requests_total) by (job)",
    "sum without (instance) (http_requests_total)",
])
def test_instant_selectors_match_both_reference_engines(services, q):
    res = _check(services, q)
    if "(" not in q:  # a bare selector keeps the metric label
        assert all(dict(k.labels).get("_metric_") == "http_requests_total"
                   for k in res.result.keys)
        body = matrix_json(res)
        assert {s["metric"]["__name__"] for s in body["data"]["result"]} \
            == {"http_requests_total"}


def test_metric_grouping_of_an_instant_selector_follows_exec(services):
    """``by (_metric_)`` over an instant selector: the exec engine groups
    on the kept metric label, the mesh engine drops it first (ROADMAP §C);
    the port answers as exec."""
    ref_exec, _, ref_mesh, port = services
    q = "sum(http_requests_total) by (_metric_)"
    got = port.query_range(q, Q_START, Q_STEP, Q_END).result
    want = ref_exec.query_range(q, Q_START, Q_STEP, Q_END).result
    mesh = ref_mesh.query_range(q, Q_START, Q_STEP, Q_END).result
    want.materialize()
    mesh.materialize()
    assert [str(k) for k in got.keys] == [str(k) for k in want.keys] \
        == ["{_metric_=http_requests_total}"]
    assert [str(k) for k in mesh.keys] == ["{}"]
    np.testing.assert_allclose(got.values, want.values, **TOL)


def test_all_nan_groups_are_kept_as_exec_keeps_them(services):
    """A plain aggregation keeps its all-NaN groups in the exec engine
    (``AggregateMapReduce``) and drops them in the mesh engine
    (``_apply_post`` compacts); ROADMAP §C. No 1 s window holds the two
    samples rate needs, so every group is NaN: the port answers as exec."""
    ref_exec, _, ref_mesh, port = services
    q = "sum(rate(queue_depth[1s])) by (instance)"
    got_keys, got = _sorted(port.query_range(q, Q_START, Q_STEP, Q_END))
    want = ref_exec.query_range(q, Q_START, Q_STEP, Q_END)
    want.result.materialize()
    want_keys, want_v = _sorted(want)
    assert got_keys == want_keys and len(got_keys) == 8
    assert np.isnan(got).all() and np.isnan(want_v).all()
    mesh = ref_mesh.query_range(q, Q_START, Q_STEP, Q_END).result
    assert mesh.materialize().num_series == 0


INSTANT_EXPRS = {
    **{f: f"{f}(queue_depth)" for f in ("abs", "ceil", "floor", "exp",
                                        "sgn", "deg", "rad")},
    **{f: f"{f}(http_requests_total)" for f in ("ln", "log2", "log10",
                                                "sqrt", "acosh")},
    **{f: f"{f}(queue_depth / 100)" for f in ("acos", "asin", "atanh")},
    **{f: f"{f}(queue_depth / 10)" for f in ("atan", "cos", "cosh", "sin",
                                             "sinh", "tan", "tanh",
                                             "asinh")},
    "round": "round(queue_depth / 8)",
    "round(to)": "round(queue_depth, 7)",
    "clamp": "clamp(queue_depth, 20, 30)",
    "clamp_min": "clamp_min(queue_depth, 5)",
    "clamp_max": "clamp_max(queue_depth, 5)",
    **{f: f"{f}(timestamp(http_requests_total))" for f in (
        "hour", "minute", "month", "year", "day_of_month", "day_of_week",
        "day_of_year", "days_in_month")},
    "over an aggregate": "abs(sum(delta(queue_depth[5m])) by (job))",
}


@pytest.mark.parametrize("name", INSTANT_EXPRS)
def test_instant_functions_match_both_reference_engines(services, name):
    res = _check(services, INSTANT_EXPRS[name])
    assert all("_metric_" not in dict(k.labels) for k in res.result.keys)


@pytest.mark.parametrize("q", [
    "sum(rate(http_requests_total[5m]) * 8) by (job)",
    "sum(abs(http_requests_total)) by (job)",
    "max(abs(deriv(queue_depth[5m]) * 2)) by (instance)",
    "count(3 < bool queue_depth) without (instance)",
])
def test_group_ids_under_mappers_are_built_once(services, q, monkeypatch):
    """Instant functions and operators under an aggregation hand on their
    leaf's cached metric-free keys, so repeated queries over unchanged data
    take the group ids from the engine's cache: one walk over the keys,
    not one a query."""
    from filodb_tpu_torch.query.exec.transformers import AggregateMapReduce

    walks = []
    group_ids = AggregateMapReduce.group_ids
    monkeypatch.setattr(AggregateMapReduce, "group_ids", lambda self, keys:
                        walks.append(len(keys)) or group_ids(self, keys))
    svc = QueryService(services[-1].memstore, device="cpu")
    first = _sorted(svc.query_range(q, Q_START, Q_STEP, Q_END))
    for _ in range(2):
        keys, vals = _sorted(svc.query_range(q, Q_START, Q_STEP, Q_END))
        assert keys == first[0]
        np.testing.assert_array_equal(vals, first[1])
    assert len(walks) == 1
    _check(services, q)


ARITHMETIC = ("+", "-", "*", "/", "%", "^", "atan2")
COMPARISONS = ("==", "!=", ">", "<", ">=", "<=")
SCALAR_CASES = [f"queue_depth {op} 3" for op in ARITHMETIC] \
    + [f"3 {op} queue_depth" for op in ARITHMETIC] \
    + [f"queue_depth {op} 3" for op in COMPARISONS] \
    + [f"queue_depth {op} bool 3" for op in COMPARISONS] \
    + [f"3 {op} queue_depth" for op in COMPARISONS] \
    + [f"3 {op} bool queue_depth" for op in COMPARISONS] \
    + ["sum(irate(http_requests_total[5m])) by (_ns_) * 60",
       "rate(http_requests_total[5m]) > 1",
       "2 * -max_over_time(queue_depth[5m])"]


@pytest.mark.parametrize("q", SCALAR_CASES)
def test_scalar_operators_match_both_reference_engines(services, q):
    _check(services, q)


JOIN_CASES = [
    # one-to-one on / ignoring
    "rate(http_requests_total[5m]) / on (instance) "
    "sum_over_time(http_requests_total[5m])",
    "rate(http_requests_total[5m]) - ignoring (job) "
    "irate(http_requests_total[5m])",
    "sum(rate(http_requests_total{job=\"job-1\"}[5m])) by (_ns_) "
    "/ sum(rate(http_requests_total[5m])) by (_ns_)",
    "sum(rate(http_requests_total[5m])) by (job) > bool on (job) "
    "sum(irate(http_requests_total[5m])) by (job)",
    "sum(rate(http_requests_total[5m])) by (job) > on (job) "
    "sum(irate(http_requests_total[5m])) by (job)",
    # group_left / group_right
    "sum(rate(http_requests_total[5m])) by (job, _ns_) * on (job) "
    "group_left (instance) "
    "max_over_time(queue_depth{instance=~\"instance-2[012]\"}[5m])",
    "max_over_time(queue_depth{instance=~\"instance-2[012]\"}[5m]) "
    "/ on (job) group_right sum(rate(http_requests_total[5m])) "
    "by (job, _ns_)",
    # set operators
    "rate(http_requests_total[5m]) and on (job) "
    "irate(http_requests_total{_ns_=\"App-1\"}[5m])",
    "queue_depth > 0 or queue_depth < -50",
    "rate(http_requests_total[5m]) unless on (job) "
    "rate(http_requests_total{job=\"job-1\"}[5m])",
    "queue_depth unless queue_depth > 10",
    "queue_depth{job=\"job-0\"} or queue_depth",
    "rate(http_requests_total[5m]) and ignoring (instance, job) "
    "irate(http_requests_total{job=\"job-2\"}[5m])",
]


@pytest.mark.parametrize("q", JOIN_CASES)
def test_binary_joins_match_both_reference_engines(services, q):
    _check(services, q)


@pytest.mark.parametrize("q", [
    "rate(http_requests_total[5m]) / on (job) "
    "rate(http_requests_total[5m])",
    "sum(rate(http_requests_total[5m])) by (job, _ns_) / on (job) "
    "sum(rate(http_requests_total[5m])) by (job)",
])
def test_many_to_many_raises_as_the_reference(services, q):
    ref_exec, *_, port = services
    with pytest.raises(ValueError) as want:
        ref_exec.query_range(q, Q_START, Q_STEP, Q_END)
    with pytest.raises(ValueError) as got:
        port.query_range(q, Q_START, Q_STEP, Q_END)
    assert type(got.value) is type(want.value)
    shape = r"multiple matches on (left|right) side for \{.*\} \(.*\)"
    assert re.fullmatch(shape, str(want.value))
    assert str(got.value) == str(want.value)
