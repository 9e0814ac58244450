"""NaN samples (Prometheus staleness markers) are dropped, as the
reference's default lanes drop them.

Prometheus writes a NaN sample when a scrape target disappears, so real
stores hold them. The reference filters them in host decode
(``filodb_tpu/query/engine/batch.py``), the lane of the mesh engine and of
exec under the default ``StoreConfig(device_pages=False)``, and its sidecar
folds skip them too. The port keeps its pages byte-equal and drops a NaN
sample at decode time: in the glue after B1/B2 (``fill_gaps``) and in B3.

The stores here are built with ``device_pages=False``; the port (on the
CPU, every kernel's plain version) is held against exec with
``FILODB_SIDECARS`` at 0 and at 1 and against mesh
(``test_torch_slice.reference_lanes``), at the tolerances of the existing
parity tests: ``rtol=2e-5, atol=1e-6`` with NaN equal, ``timestamp`` at
``atol=1e-3``.
"""

import numpy as np
import pytest
import torch

from test_torch_slice import (
    Q_END,
    Q_START,
    Q_STEP,
    START_S,
    _build_stores,
    _series_specs,
    _sorted,
    reference_lanes,
)
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.parallel.mesh_engine import UnsupportedQuery

TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
TS_TOL = dict(rtol=0, atol=1e-3, equal_nan=True)


def _check(services, q, start=Q_START, step=Q_STEP, end=Q_END, tol=TOL):
    """The port against every reference lane; returns the port's answer."""
    *refs, port = services
    res = port.query_range(q, start, step, end)
    got_keys, got = _sorted(res)
    for svc in refs:
        r = svc.query_range(q, start, step, end)
        r.result.materialize()
        want_keys, want = _sorted(r)
        assert got_keys == want_keys, (q, svc.engine)
        np.testing.assert_allclose(got, want, err_msg=f"{q} {svc.engine}",
                                   **tol)
    return res


# ---------------------------------------------------------------------------
# one gauge with four NaN samples


def _gauge_specs():
    """One gauge ``g``: 200 samples at 10 s, values ``arange(200) % 7``,
    samples 40, 41, 75 and 120 NaN; chunks of 64."""
    ts = START_S * 1000 + np.arange(200, dtype=np.int64) * 10_000
    vals = (np.arange(200) % 7).astype(np.float64)
    vals[[40, 41, 75, 120]] = np.nan
    return [("gauge", {"_metric_": "g", "_ws_": "demo", "_ns_": "App-0",
                       "instance": "instance-0", "job": "job-0"}, ts, vals)]


G_START, G_END = START_S + 300, START_S + 1500


@pytest.fixture(scope="module")
def gauge_services():
    ref, port = _build_stores(_gauge_specs(), 64, device_pages=False)
    return (*reference_lanes(ref), QueryService(port, device="cpu"))


def test_gauge_counts_and_selects_past_nan_samples(gauge_services):
    counts = _check(gauge_services, "count_over_time(g[2m])", G_START, 60,
                    G_END).result.values[0]
    np.testing.assert_array_equal(counts[:10],
                                  [12, 12, 10, 10, 12, 12, 12, 12, 11, 11])
    # step 15 (t = 1200 s) falls on sample 120, a NaN: the previous sample
    inst = _check(gauge_services, "g", G_START, 60, G_END).result.values[0]
    assert inst[15] == 119 % 7 == 0


GAUGE_FNS = (
    "sum_over_time", "avg_over_time", "count_over_time", "min_over_time",
    "max_over_time", "stddev_over_time", "stdvar_over_time",
    "last_over_time", "present_over_time", "changes", "resets", "deriv",
    "irate", "idelta", "rate", "increase", "delta", "zscore")


@pytest.mark.parametrize("fn", GAUGE_FNS)
def test_gauge_range_functions_drop_nan_samples(gauge_services, fn):
    res = _check(gauge_services, f"{fn}(g[2m])", G_START, 60, G_END)
    assert np.isfinite(res.result.values).any()


@pytest.mark.parametrize("q", [
    "timestamp(g)", "predict_linear(g[2m], 600)",
    "quantile_over_time(0.5, g[2m])", "holt_winters(g[2m], 0.5, 0.5)"])
def test_gauge_other_functions_drop_nan_samples(gauge_services, q):
    _check(gauge_services, q, G_START, 60, G_END,
           TS_TOL if q.startswith("timestamp") else TOL)


# ---------------------------------------------------------------------------
# the slice's store with runs of NaN samples in every other series


def _stale_specs():
    """``test_torch_slice._series_specs()`` with 6 NaN samples in every
    other series: a run of 3 and three single ones, at seeded places."""
    rng = np.random.default_rng(17)
    out = []
    for i, (schema, labels, ts, vals) in enumerate(_series_specs()):
        vals = vals.copy()
        if i % 2 == 0:
            a = int(rng.integers(5, len(vals) - 8))
            at = [a, a + 1, a + 2]
            while len(at) < 6:
                j = int(rng.integers(0, len(vals)))
                if j not in at:
                    at.append(j)
            vals[at] = np.nan
        out.append((schema, labels, ts, vals))
    return out


@pytest.fixture(scope="module")
def stale_services():
    ref, port = _build_stores(_stale_specs(), 64, device_pages=False)
    return (*reference_lanes(ref), QueryService(port, device="cpu"))


def test_pages_keep_nan_samples_and_decode_drops_them(stale_services):
    """The pages hold the NaN samples bit for bit; ``decode_packed`` marks
    exactly those lanes invalid."""
    from filodb_tpu_torch.parallel.mesh_engine import lower_plan
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.engine.device_batch import (
        BLOCK,
        decode_packed,
    )

    port = stale_services[-1]
    low = lower_plan(parse_query("rate(http_requests_total[5m])",
                                 TimeStepParams(START_S + 300, 60,
                                                START_S + 3000)))
    packed = port.mesh._batch(port.memstore, low).packed
    ts, vals, valid = decode_packed(packed)
    P, NB = packed[0].shape
    lane = torch.arange(NB * BLOCK) % BLOCK
    in_count = lane[None, :] < packed[8].repeat_interleave(BLOCK, 1)
    want = sum(int(np.isnan(v).sum()) for schema, _, _, v in _stale_specs()
               if schema == "prom-counter")
    assert int((in_count & torch.isnan(vals)).sum()) == want == 10 * 6
    assert torch.equal(valid, in_count & ~torch.isnan(vals))
    # a NaN lane takes the previous sample's timestamp, as a gap does
    assert bool((ts[:, 1:] >= ts[:, :-1]).all())


RANGE_EXPRS = {
    **{fn: f"{fn}(http_requests_total[5m])" for fn in (
        "rate", "increase", "sum_over_time", "count_over_time",
        "max_over_time", "stdvar_over_time", "last_over_time",
        "present_over_time", "resets", "irate")},
    **{fn: f"{fn}(queue_depth[5m])" for fn in (
        "delta", "avg_over_time", "min_over_time", "stddev_over_time",
        "zscore", "changes", "idelta", "deriv")},
    "timestamp": "timestamp(http_requests_total)",
    "predict_linear": "predict_linear(http_requests_total[5m], 600)",
    "quantile_over_time": "quantile_over_time(0.9, queue_depth[5m])",
    "holt_winters": "holt_winters(queue_depth[5m], 0.5, 0.5)",
}


@pytest.mark.parametrize("name", RANGE_EXPRS)
def test_range_functions_drop_nan_samples(stale_services, name):
    _check(stale_services, RANGE_EXPRS[name],
           tol=TS_TOL if name == "timestamp" else TOL)


@pytest.mark.parametrize("q", [
    "http_requests_total", "queue_depth", "queue_depth offset 3m",
    "sum(http_requests_total) by (job)"])
def test_instant_selectors_drop_nan_samples(stale_services, q):
    _check(stale_services, q)


AGGS = ("sum", "avg", "min", "max", "count", "group", "stddev", "stdvar",
        "topk(2, {})", "bottomk(2, {})", "quantile(0.9, {})")


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("inner", ["rate(http_requests_total[5m])",
                                   "queue_depth"])
def test_aggregations_drop_nan_samples(stale_services, agg, inner):
    q = agg.format(inner) if "{}" in agg else f"{agg}({inner}) by (job)"
    _check(stale_services, q)


def test_sum_rate_by_job_drops_nan_samples(stale_services):
    res = _check(stale_services,
                 "sum(rate(http_requests_total[5m])) by (job)")
    assert res.result.num_series == 3
    assert np.isfinite(res.result.values[:, 1:]).all()


def test_b3_plain_matches_fused_pallas_on_the_store(stale_services):
    """On NaN-free pages B3's plain version still equals the reference's
    Pallas kernel (interpret mode) at its own tolerance, over the packed
    batch of the slice's NaN-free counters."""
    import jax.numpy as jnp

    from filodb_tpu.query.engine.pallas_kernels import (
        fused_decode_rate_pallas,
    )
    from filodb_tpu_torch.parallel.mesh_engine import lower_plan
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.engine import cuda_kernels

    _, port = _build_stores(_series_specs(), 64)
    svc = QueryService(port, device="cpu")
    low = lower_plan(parse_query("rate(http_requests_total[5m])",
                                 TimeStepParams(Q_START, Q_STEP, Q_END)))
    batch = svc.mesh._batch(port, low)
    steps = np.arange(low.start, low.end + 1, low.step) \
        - low.chunk_range[0]
    steps = steps.astype(np.int32)
    got = cuda_kernels.fused_decode_rate_plain(
        batch.packed, torch.from_numpy(steps), low.window).numpy()
    ref_packed = tuple(jnp.asarray(a.numpy().view(np.uint32)
                                   if i in (3, 4, 7) else a.numpy())
                       for i, a in enumerate(batch.packed))
    want = np.asarray(fused_decode_rate_pallas(
        ref_packed, jnp.asarray(steps), jnp.asarray(np.int32(low.window)),
        kind="rate", counter=True, interpret=True))
    n = len(batch.keys)
    assert np.isfinite(want[:n]).any()
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-5, atol=1e-6,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# ranges past 2^31 ms from the batch start


def _month_specs(days: int):
    rng = np.random.default_rng(31)
    n = days * 24
    out = []
    for i in range(4):
        ts = START_S * 1000 + np.arange(n, dtype=np.int64) * 3_600_000
        vals = np.cumsum(rng.integers(0, 20, n)).astype(np.float64)
        out.append(("prom-counter", {
            "_metric_": "m", "_ws_": "demo", "_ns_": "App-0",
            "instance": f"instance-{i}", "job": f"job-{i % 2}"}, ts, vals))
    return out


MONTH_Q = "sum(rate(m[3h])) by (job)"


def test_ranges_past_2_31_ms_raise_as_exec_raises():
    """30 days at 1 h: relative ms steps pass 2^31. The port raises
    ``UnsupportedQuery``; reference exec over device pages raises
    ``OverflowError``. (The reference's host-decode lane, exec and mesh
    under ``device_pages=False``, answers but wraps: NaN at 412 of 1,440
    places and rates down to -4.6e16; ROADMAP §C.) The port is held to
    exec."""
    end = START_S + 30 * 86_400 - 3_600
    ref, port = _build_stores(_month_specs(30), 400)
    with pytest.raises(UnsupportedQuery, match="int32"):
        QueryService(port, device="cpu").query_range(MONTH_Q, START_S,
                                                     3_600, end)
    exec0, exec1, _ = reference_lanes(ref)
    for svc in (exec0, exec1):
        with pytest.raises(OverflowError):
            svc.query_range(MONTH_Q, START_S, 3_600, end)


def test_twenty_days_agree_with_both_engines():
    ref, port = _build_stores(_month_specs(20), 400, device_pages=False)
    services = (*reference_lanes(ref), QueryService(port, device="cpu"))
    res = _check(services, MONTH_Q, START_S, 3_600,
                 START_S + 20 * 86_400 - 3_600,
                 dict(rtol=0, atol=8e-8, equal_nan=True))
    assert res.result.num_steps == 480
    assert np.isfinite(res.result.values).mean() > 0.9


def test_samples_scanned_count_as_the_device_page_lane():
    """``samples_scanned`` counts the rows of the selected chunks, NaN
    samples and samples outside the range included, as exec over device
    pages counts them; the host-decode lane counts only the non-NaN
    samples inside the range (ROADMAP §C)."""
    q = "sum(rate(http_requests_total[5m])) by (job)"
    ref, port = _build_stores(_stale_specs(), 64)
    got = QueryService(port, device="cpu").query_range(q, Q_START, Q_STEP,
                                                       Q_END).stats
    exec0 = reference_lanes(ref)[0]
    want = exec0.query_range(q, Q_START, Q_STEP, Q_END).stats
    assert (got.samples_scanned, got.series_scanned) == \
        (want.samples_scanned, want.series_scanned)
    host_ref, _ = _build_stores(_stale_specs(), 64, device_pages=False)
    host = reference_lanes(host_ref)[0].query_range(q, Q_START, Q_STEP,
                                                    Q_END).stats
    assert host.samples_scanned < got.samples_scanned
