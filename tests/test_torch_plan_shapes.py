"""Port parity for the plan shapes above and beside the leaves that the
exec engine answers: absent / absent_over_time, count_values, sort /
sort_desc, label_replace / label_join, limit, scalar plans (numbers,
``time()``, ``scalar(v)``, scalar arithmetic, ``vector(s)``), operators
with a per-step scalar, the ``@`` modifier and subqueries.

The store is ``test_torch_slice``'s (28 series, counters with resets and
gauges of staggered lengths, 64-sample chunks). The port on the CPU is held
against every reference lane (``reference_lanes``: exec with
``FILODB_SIDECARS`` at 0 and at 1, and mesh, which hands these shapes to
exec), keys and values at ``rtol=2e-5, atol=1e-6``, NaN equal. Where the
order of the series is part of the answer (sort, limit) the keys compare in
order; elsewhere sorted.
"""

import numpy as np
import pytest

from filodb_tpu.query import logical as ref_lp
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.parallel.mesh_engine import UnsupportedQuery
from filodb_tpu_torch.query import logical as port_lp
from test_torch_slice import (
    Q_END,
    Q_START,
    Q_STEP,
    _build_stores,
    _series_specs,
    _sorted,
    reference_lanes,
)

TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
M = "http_requests_total"
AT = Q_START + 900  # an @ time inside the data


@pytest.fixture(scope="module")
def stores():
    ref, port = _build_stores(_series_specs(), 64)
    return reference_lanes(ref), port


@pytest.fixture(scope="module", params=["mesh", "exec"])
def services(stores, request):
    """The reference lanes and the port on one of its two engines."""
    lanes, port = stores
    return (*lanes, QueryService(port, device="cpu", engine=request.param))


def _check(services, q, ordered=False, expect_rows=None):
    """The port against every reference lane; returns the port's answer."""
    *refs, port = services
    res = port.query_range(q, Q_START, Q_STEP, Q_END)
    got_keys, got = _sorted(res)
    if expect_rows is not None:
        assert len(got_keys) == expect_rows, q
    for svc in refs:
        r = svc.query_range(q, Q_START, Q_STEP, Q_END)
        r.result.materialize()
        if ordered:
            assert [str(k) for k in res.result.keys] == \
                [str(k) for k in r.result.keys], (q, svc.engine)
            np.testing.assert_allclose(res.result.values, r.result.values,
                                       err_msg=f"{q} {svc.engine}", **TOL)
            continue
        want_keys, want = _sorted(r)
        assert got_keys == want_keys, (q, svc.engine)
        if got_keys:  # an answer of no series may carry no steps
            assert got.shape == want.shape, (q, svc.engine)
            np.testing.assert_allclose(got, want,
                                       err_msg=f"{q} {svc.engine}", **TOL)
    return res


@pytest.mark.parametrize("q,rows", [
    ("absent(nope)", 1),
    ('absent(nope{job="job-1",_ns_=~"App.*",instance!="x"})', 1),
    (f"absent({M})", 0),                       # present at every step
    (f'absent({M}{{job="job-1"}} offset 30m)', 1),  # absent at the start
    (f'absent(sum(rate({M}[5m])) by (job))', 0),
    (f'absent_over_time({M}{{job="job-1"}}[5m])', 0),
    ('absent_over_time(nope{job="x"}[5m])', 1),
    (f'absent_over_time(queue_depth{{instance="instance-21"}}[10s])', None),
])
def test_absent_matches_exec(services, q, rows):
    res = _check(services, q, expect_rows=rows)
    if rows:
        assert set(np.unique(res.result.values[~np.isnan(
            res.result.values)])) <= {1.0}


def test_absent_labels_are_the_equality_filters(services):
    res = _check(services, 'absent(nope{job="job-1",_ns_=~"App.*"})')
    assert [dict(k.labels) for k in res.result.keys] == [{"job": "job-1"}]


@pytest.mark.parametrize("q", [
    f'count_values("r", round(rate({M}[5m])))',
    f'count_values("v", queue_depth)',
    f'count_values("v", queue_depth) by (job)',
    f'count_values("half", rate({M}[5m]) * 0 + 2.5)',
    f'count_values("job", queue_depth % 3) by (job)',
    f'count_values("v", -queue_depth / 4) without (instance)',
])
def test_count_values_matches_exec(services, q):
    _check(services, q)


def test_count_values_formats_values_as_exec(services):
    """An integral value is written as an integer; any other as the
    reference writes it, ``repr`` of a numpy float64 (so, under numpy 2,
    ``np.float64(2.5)``)."""
    res = _check(services, f'count_values("v", {M} * 0 + 2.5)')
    assert {dict(k.labels)["v"] for k in res.result.keys} == \
        {repr(np.float64(2.5))}
    res = _check(services, f'count_values("v", {M} * 0 - 3)')
    assert {dict(k.labels)["v"] for k in res.result.keys} == {"-3"}


@pytest.mark.parametrize("q", [
    f"sort({M})",                   # series that ended: NaN at the last step
    f"sort_desc({M})",
    f"sort(rate({M}[5m]))",
    f"sort_desc(sum(rate({M}[5m])) by (job))",
    "sort(queue_depth)",
    "sort_desc(queue_depth * 0)",   # ties keep the input order
    f"sort(topk(3, {M}))",
])
def test_sort_matches_exec_in_order(services, q):
    _check(services, q, ordered=True)


def test_sort_puts_nan_first_as_exec_does(services):
    res = _check(services, f"sort_desc({M})", ordered=True)
    last = res.result.values[:, -1]
    assert np.isnan(last[0]) and not np.isnan(last[-1])


@pytest.mark.parametrize("q", [
    f'label_replace({M}, "j", "$1", "job", "job-(.*)")',
    f'label_replace({M}, "job", "", "job", "job-1")',     # dst removed
    f'label_replace({M}, "x", "${{1}}-$2", "instance", "(ins)tance-(1.*)")',
    f'label_replace(rate({M}[5m]), "_ns_", "ns", "nolabel", "")',
    f'label_join({M}, "x", "-", "job", "instance")',
    f'label_join(sum(rate({M}[5m])) by (job, _ns_), "both", ",", "_ns_", '
    f'"job")',
])
def test_label_functions_match_exec(services, q):
    _check(services, q)


@pytest.mark.parametrize("q", [f"limit(3, {M})", f"limit(100, {M})",
                               f"limit(1, sum(rate({M}[5m])) by (job))",
                               f"limit(2, topk(4, {M}))"])
def test_limit_matches_exec_in_order(services, q):
    _check(services, q, ordered=True)


@pytest.mark.parametrize("q", [
    "time()", "time() - 60 * 2", "vector(time())", "vector(1) + 1",
    "vector(pi())", "hour()", "minute(vector(time()))", "2 * time() / 3",
    f"scalar(sum(rate({M}[5m])))",
    f"scalar({M})",                     # more than one series: NaN
    f'scalar({M}{{instance="instance-1"}})',
    "scalar(nope)",                     # no series: NaN
    f"scalar(sum({M})) * 2",
    f"time() - scalar(sum({M}))",
    f"vector(scalar(sum(queue_depth)))",
])
def test_scalar_plans_match_exec(services, q):
    _check(services, q, expect_rows=1)


def test_scalar_of_two_series_is_nan(services):
    res = _check(services, f"scalar(sum(rate({M}[5m])) by (_ns_))")
    assert np.isnan(res.result.values).all()


@pytest.mark.parametrize("q", [
    f"{M} * time()",
    f"time() - {M}",
    f"{M} > bool scalar(sum(queue_depth))",
    f"queue_depth < scalar(avg(queue_depth))",
    f"sum(rate({M}[5m])) by (job) / scalar(sum(rate({M}[5m])))",
    f"rate({M}[5m]) * (time() - 1600000000)",
    f"rate({M}[5m]) + scalar(nope)",
])
def test_operators_with_a_stepped_scalar_match_exec(services, q):
    _check(services, q)


@pytest.mark.parametrize("q", [
    f"rate({M}[5m] @ {AT})",
    f"rate({M}[5m] @ {AT} offset 2m)",
    f"rate({M}[5m] offset 2m @ {AT})",
    f"sum(rate({M}[5m] @ {AT})) by (job)",
    f"{M} @ {AT}",
    f"queue_depth @ {AT} offset 1m",
    f"max_over_time(queue_depth[10m] @ end())",
    f"increase({M}[10m] @ start())",
    f"count_over_time({M}[2m] @ {AT + 45})",
    f"{M} @ {Q_START - 3000}",          # before the data: no samples
])
def test_at_modifier_matches_exec(services, q):
    res = _check(services, q)
    v = res.result.values
    # every step answers what the @ time gives: one column repeated
    assert np.array_equal(np.isnan(v), np.isnan(v[:, :1]).repeat(
        v.shape[1], 1))


@pytest.mark.parametrize("q", [
    f"max_over_time(sum(rate({M}[5m])) by (_ns_)[30m:1m])",
    f"rate({M}[10m:])",                 # the query's step
    f"avg_over_time(queue_depth[10m:2m] offset 3m)",
    f"min_over_time(rate({M}[5m])[20m:30s])",
    f"quantile_over_time(0.5, rate({M}[5m])[20m:2m])",
    f"sum_over_time(sum(queue_depth)[5m:1m])",
    f"count_over_time(topk(2, queue_depth)[10m:1m])",
    f"deriv(sum(queue_depth) by (job)[15m:1m])",
    f"max_over_time(max_over_time({M}[5m])[10m:2m])",
    f"stddev_over_time(rate({M}[5m])[15m:1m])",
    f"last_over_time(rate({M}[5m])[7m:1m])",
])
def test_subqueries_match_exec(services, q):
    _check(services, q)


def test_top_level_subquery_matches_exec(services):
    """A ``TopLevelSubquery`` (the parser never builds one; a planner
    may): the inner plan over its own range and step."""
    from filodb_tpu.promql.parser import TimeStepParams as RefParams
    from filodb_tpu.promql.parser import parse_query as ref_parse
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query

    q = f"sum(rate({M}[5m])) by (job)"
    start, step, end = Q_START * 1000, 120_000, Q_END * 1000
    ref_plan = ref_lp.TopLevelSubquery(
        ref_parse(q, RefParams(Q_START, Q_STEP, Q_END)), start, step, end)
    port_plan = port_lp.TopLevelSubquery(
        parse_query(q, TimeStepParams(Q_START, Q_STEP, Q_END)), start, step,
        end)
    exec0, *_, port = services
    from filodb_tpu_torch.query.model import QueryStats

    got = port.mesh.execute(port.memstore, port_plan,
                            QueryStats()).materialize()
    want = exec0.execute_logical(ref_plan).result.materialize()
    assert got.num_steps == want.num_steps == 16
    gk, gv = _sorted(type("R", (), {"result": got}))
    wk, wv = _sorted(type("R", (), {"result": want}))
    assert gk == wk
    np.testing.assert_allclose(gv, wv, **TOL)


@pytest.mark.parametrize("q", ["http_requests_total::sum",
                               "rate(http_requests_total::count[5m])"])
def test_column_selectors_still_raise(services, q):
    """The mesh engine still raises for a column selector; the service
    hands it to the exec engine, which answers a scalar series' value
    column as the reference's exec engine does."""
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.model import QueryStats

    port = services[-1]
    plan = parse_query(q, TimeStepParams(Q_START, Q_STEP, Q_END))
    with pytest.raises(UnsupportedQuery):
        port.mesh.execute(port.memstore, plan, QueryStats())
    res = _check(services, q)
    assert res.stats.engine == "exec"
