"""Port parity for the serving front end: spread overrides, batched
queries, the extent result cache and the rendered-response cache.

Stores are the slice suite's (``test_torch_slice``: the same counters and
gauges in a JAX store and in the port's ``MemStore``, 4 shards, spread 1)
and, for the live-ingest cases, gauges ingested into both packages here,
made with numpy from a seed. The port runs on the CPU.

- Spread overrides (A2): ``shards_for_filters`` equals the reference
  planner's over keys, overrides and per-query spreads; answers on each
  engine equal the reference's engine of the same name. An override
  narrower than the ingest spread prunes shards that hold the key's series
  on exec in both packages; mesh reads every shard in both.
- Batches: ``query_range_many`` equals the reference's for supported and
  unsupported members; each member equals its own ``query_range``
  (bitwise where B3 serves it, ``rtol=2e-5`` else); one batch a leaf
  signature; errors stand at their member's position.
- The extent cache: cold and warm answers equal the uncached port and the
  reference's exec engine, at the reference's own tolerance for splicing,
  ``rtol=2e-5, atol=1e-9``, NaN positions exact (``assert_equivalent``);
  the split math equals the reference's; the bypass list; live ingest
  invalidates the head only; the budget; the config forms; the valve.
- The response cache and the fast front end.
"""

import json
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.coordinator.planner import SingleClusterPlanner as RefPlanner
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.filters import ColumnFilter as RefFilter
from filodb_tpu.core.filters import Equals as RefEquals
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord, RecordContainer, SomeData
from filodb_tpu.core.store.config import StoreConfig
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query import result_cache as ref_rc
from filodb_tpu.query.model import PlannerParams as RefPlannerParams
from filodb_tpu.query.model import QueryContext as RefContext
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import (
    QueryBatcher,
    QueryService,
)
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.http import promjson
from filodb_tpu_torch.http.fastserver import FastHttpServer
from filodb_tpu_torch.http.server import response_cache_key
from filodb_tpu_torch.promql.parser import ParseError, TimeStepParams
from filodb_tpu_torch.promql.parser import parse_query as port_parse
from filodb_tpu_torch.query import result_cache as rc
from filodb_tpu_torch.query.model import PlannerParams, QueryContext
from filodb_tpu_torch.query.result_cache import (
    ResultCache,
    ResultCacheConfig,
    plan_signature,
    split_extents,
    splittable_grid,
)
from test_torch_slice import (
    CHUNK,
    DS,
    NUM_SHARDS,
    START_S,
    Valved,
    _build_stores,
    _series_specs,
    _sorted,
)

M = "http_requests_total"
STEP = 60
QS, QE = START_S + 610, START_S + 2990  # extent-unaligned
TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), CHUNK)


def _ref(store, engine="exec"):
    """A reference service at the decode lane (``FILODB_SIDECARS=0``)."""
    return Valved(RefService(store, DS, NUM_SHARDS, spread=1,
                             engine=engine), "0")


@pytest.fixture(scope="module")
def plain(stores):
    return QueryService(stores[1], device="cpu")


@pytest.fixture
def cached(stores):
    # 7-step extents with 5m windows: every extent seam falls inside some
    # series' window
    return QueryService(stores[1], device="cpu",
                        result_cache={"extent_steps": 7})


def _match(got, want, bitwise=False):
    """Keys equal; values bitwise, or within ``TOL``; NaN positions
    exact."""
    gk, gv = _sorted(got)
    wk, wv = _sorted(want)
    assert gk == wk and len(gk) > 0
    assert np.array_equal(np.isnan(gv), np.isnan(wv))
    if bitwise:
        assert np.array_equal(gv, wv, equal_nan=True)
    else:
        np.testing.assert_allclose(gv, wv, **TOL)


def assert_equivalent(direct, split):
    """The reference's test of a spliced answer: keys, grid and NaN
    positions equal, values within ``rtol=2e-5, atol=1e-9``."""
    m0, m1 = direct.result, split.result
    m0.materialize()
    i0 = {str(k): i for i, k in enumerate(m0.keys)}
    i1 = {str(k): i for i, k in enumerate(m1.keys)}
    assert set(i0) == set(i1)
    if m0.num_series:
        assert np.array_equal(m0.steps_ms, m1.steps_ms)
    for k, i in i0.items():
        a, b = np.asarray(m0.values[i]), np.asarray(m1.values[i1[k]])
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        assert np.allclose(a, b, rtol=2e-5, atol=1e-9, equal_nan=True), k


# ---- spread overrides (A2) ----------------------------------------------------

SK_LABELS = ("_ws_", "_ns_", "_metric_")


@pytest.mark.parametrize("spread", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("overrides", [None, {("demo", "App-0"): 2},
                                       {("demo", "App-1"): 0,
                                        ("demo", "App-0"): 1}])
def test_shards_for_filters_equals_the_reference(spread, overrides):
    ref = RefPlanner(DS, 8, 1, spread_overrides=overrides)
    port = SingleClusterPlanner(8, 1, spread_overrides=overrides)
    for ns in ("App-0", "App-1", "App-2"):
        for metric in (M, "queue_depth"):
            for labels in (SK_LABELS, SK_LABELS[:2]):
                vals = {"_ws_": "demo", "_ns_": ns, "_metric_": metric}
                want = ref.shards_for_filters(
                    [RefFilter(k, RefEquals(vals[k])) for k in labels],
                    spread)
                got = port.shards_for_filters(
                    [ColumnFilter(k, Equals(vals[k])) for k in labels],
                    spread)
                assert got == want, (ns, metric, labels)


SPREAD_CASES = [  # (per-key overrides, per-query spread)
    ({("demo", "App-0"): 2}, None),   # wider: every shard
    ({("demo", "App-0"): 0}, 2),      # the query's own beats the key's
    ({("demo", "App-0"): 0}, None),   # narrower than ingest: pruned
    (None, 0),                        # the query's own, narrower
]


@pytest.mark.parametrize("engine", ["exec", "mesh"])
@pytest.mark.parametrize("overrides,spread", SPREAD_CASES)
def test_spread_answers_equal_the_reference_engine_of_the_same_name(
        stores, engine, overrides, spread):
    ref_store, port_store = stores
    ref = RefService(ref_store, DS, NUM_SHARDS, spread=1, engine=engine)
    port = QueryService(port_store, device="cpu", engine=engine)
    ref.planner.spread_overrides = port.planner.spread_overrides = overrides
    q = f'rate({M}{{_ws_="demo",_ns_="App-0"}}[5m])'
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FILODB_SIDECARS", "0")
        want = ref.query_range(q, QS, STEP, QE, qcontext=RefContext(
            planner_params=RefPlannerParams(spread=spread)))
    got = port.query_range(q, QS, STEP, QE, qcontext=QueryContext(
        planner_params=PlannerParams(spread=spread)))
    want.result.materialize()
    _match(got, want)


def test_narrow_override_prunes_shards_that_hold_the_keys_series(stores):
    """Ingest writes App-0 at spread 1 (2 shards); an override of 0 reads
    one of them. The reference's exec engine answers the pruned set, and
    so does the port's; both mesh engines read every shard."""
    ref_store, port_store = stores
    q = f'rate({M}{{_ws_="demo",_ns_="App-0"}}[5m])'
    full = QueryService(port_store, device="cpu", engine="exec").query_range(
        q, QS, STEP, QE).result.num_series
    out = {}
    for engine in ("exec", "mesh"):
        ref = RefService(ref_store, DS, NUM_SHARDS, spread=1, engine=engine)
        port = QueryService(port_store, device="cpu", engine=engine)
        ref.planner.spread_overrides = port.planner.spread_overrides = \
            {("demo", "App-0"): 0}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FILODB_SIDECARS", "0")
            want = ref.query_range(q, QS, STEP, QE)
        got = port.query_range(q, QS, STEP, QE)
        want.result.materialize()
        _match(got, want)
        out[engine] = got.result.num_series
    assert 0 < out["exec"] < full == out["mesh"]


# ---- batches ------------------------------------------------------------------

BATCH = [
    (f"sum(rate({M}[5m])) by (job)", QS, STEP, QE),
    (f"sum(rate({M}[5m])) by (job)", QS + STEP, STEP, QE + STEP),
    (f"increase({M}[5m])", QS + 2 * STEP, STEP, QE),
    ("avg_over_time(queue_depth[2m])", QS, STEP, QE),
    ("avg_over_time(queue_depth[2m])", QS, STEP, QE),
    (f"{M}::sum", QS, STEP, QE),               # a column: exec
    (f"sum(rate({M}[5m])) by (job) / sum(rate({M}[5m] offset 1m)) by (job)",
     QS, STEP, QE),
]


def test_query_range_many_equals_the_reference(stores):
    ref_store, port_store = stores
    port = QueryService(port_store, device="cpu")
    ref = RefService(ref_store, DS, NUM_SHARDS, spread=1, engine="mesh")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FILODB_SIDECARS", "0")
        want = ref.query_range_many(BATCH)
    got = port.query_range_many(BATCH)
    for g, w in zip(got, want):
        w.result.materialize()
        _match(g, w)
    assert got[5].stats.engine == "exec" and got[0].stats.engine == "mesh"
    assert len({r.stats.wall_time_s for r in got}) == 1


@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_each_member_equals_its_single_query(stores, engine):
    """B3 serves rate and increase: those members are bitwise their single
    answers; the prefix-sum paths within ``rtol=2e-5``."""
    port = QueryService(stores[1], device="cpu", engine=engine)
    single = QueryService(stores[1], device="cpu", engine=engine)
    batch = BATCH if engine == "mesh" else BATCH[1:4]
    for q, got in zip(batch, port.query_range_many(batch)):
        _match(got, single.query_range(*q), bitwise="rate(" in q[0]
               or "increase(" in q[0])


def test_one_shared_batch_per_signature(stores):
    port = QueryService(stores[1], device="cpu")
    qs = [(f"sum(rate({M}[5m])) by (job)", QS + i * STEP, STEP,
           QE + i * STEP) for i in range(5)]
    qs += [("avg_over_time(queue_depth[2m])", QS + i * STEP, STEP, QE)
           for i in range(3)]
    out = port.query_range_many(qs)
    assert all(r.stats.engine == "mesh" for r in out)
    keys = [k for k, e in port.batches._entries.items() if k[0] == "mesh"]
    assert len(keys) == 2
    ranges = {k[2:] for k in keys}
    assert (QS * 1000 - 300_000, (QE + 4 * STEP) * 1000) in ranges
    assert (QS * 1000 - 120_000, QE * 1000) in ranges


def test_histogram_batch_under_max_goes_to_exec():
    """A histogram leaf under an aggregation other than sum leaves the
    mesh engine's batch for exec, as the reference's batch declines it;
    under sum the batch serves it."""
    store = MemStore(NUM_SHARDS, 1, max_chunk_size=64)
    rng = np.random.default_rng(3)
    les = np.array([0.1, 1.0, np.inf])
    for i in range(6):
        ts = START_S * 1000 + np.arange(200) * 10_000
        counts = np.cumsum(rng.integers(0, 5, (200, 3)), axis=0)
        store.ingest_histogram({"_metric_": "lat", "_ws_": "demo",
                                "_ns_": f"App-{i % 2}", "host": f"h{i}"},
                               ts, np.cumsum(counts, axis=1), les)
    svc = QueryService(store, device="cpu")
    qs = [("max(rate(lat[5m]))", QS, STEP, QE),
          ("sum(rate(lat[5m]))", QS, STEP, QE)]
    out = svc.query_range_many(qs)
    assert [r.stats.engine for r in out] == ["exec", "mesh"]
    for q, r in zip(qs, out):
        want = svc.query_range(*q)
        np.testing.assert_allclose(r.result.values, want.result.values,
                                   **TOL)


def test_poisoned_member_is_isolated(cached):
    good = ("avg_over_time(queue_depth[2m])", QS, STEP, QE)
    bad = ("sum(rate(queue_depth[5m])", QS, STEP, QE)  # unbalanced
    out = cached.query_range_many([good, bad, good], return_errors=True)
    assert isinstance(out[1], ParseError)
    assert not isinstance(out[0], Exception)
    _match(out[0], out[2], bitwise=True)


def test_engine_errors_stand_at_their_members_position(stores, monkeypatch):
    """A failure inside the batch is not turned into an exec run: it
    stands at its member's position, the others answer."""
    port = QueryService(stores[1], device="cpu")
    from filodb_tpu_torch.query.exec import transformers

    real = transformers.PeriodicSamplesMapper.eval_batch

    def eval_batch(self, batch, stats):
        if self.fn == "avg_over_time":
            raise RuntimeError("kernel failed")
        return real(self, batch, stats)

    monkeypatch.setattr(transformers.PeriodicSamplesMapper, "eval_batch",
                        eval_batch)
    qs = [BATCH[0], BATCH[3], BATCH[2]]
    out = port.query_range_many(qs, return_errors=True)
    assert isinstance(out[1], RuntimeError)
    assert out[0].stats.engine == out[2].stats.engine == "mesh"
    with pytest.raises(RuntimeError, match="kernel failed"):
        port.query_range_many(qs)


def test_batcher_surfaces_per_item_errors(cached):
    b = QueryBatcher(cached)
    try:
        r = b.query_range("avg_over_time(queue_depth[2m])", QS, STEP, QE)
        assert r.result.num_series > 0
        with pytest.raises(ParseError):
            b.query_range("sum(rate(queue_depth[5m])", QS, STEP, QE)
    finally:
        b.close()


def test_default_raise_behaviour(cached):
    with pytest.raises(ParseError):
        cached.query_range_many([("sum(rate(queue_depth[5m])", QS, STEP,
                                  QE)])
    with pytest.raises(ParseError):
        cached.query_range_many([BATCH[0], ("sum(rate(x[5m])", QS, STEP,
                                            QE)])


# ---- the extent cache -----------------------------------------------------------

CACHED_SHAPES = [
    f"sum(rate({M}[5m])) by (job)",
    f"increase({M}[5m])",
    "avg_over_time(queue_depth[3m])",
    "max_over_time(queue_depth[7m])",
    f"count(avg_over_time({M}[3m]))",
    f"sum(rate({M}[5m])) / sum(increase({M}[5m]))",
    "avg_over_time(queue_depth[3m]) * 2 + 1",
    "topk(3, avg_over_time(queue_depth[3m]))",
    "queue_depth",
]


@pytest.mark.parametrize("promql", CACHED_SHAPES)
def test_cold_and_warm_equal_the_single_shot(stores, plain, cached, promql):
    want = _ref(stores[0]).query_range(promql, QS, STEP, QE)
    direct = plain.query_range(promql, QS, STEP, QE)
    cold = cached.query_range(promql, QS, STEP, QE)
    warm = cached.query_range(promql, QS, STEP, QE)
    assert cold.stats.cache_misses > 0 and warm.stats.cache_misses == 0
    for got in (cold, warm):
        assert_equivalent(direct, got)
        assert_equivalent(want, got)


def test_seam_mid_lookback_window(plain, cached):
    q = f"sum(rate({M}[5m]))"
    for shift in (0, 1, 3, 5):
        s, e = QS + shift * 90, QS + 2000 + shift * 90
        assert_equivalent(plain.query_range(q, s, 90, e),
                          cached.query_range(q, s, 90, e))


def test_sliding_window_reuses_extents(plain, cached):
    q = "avg_over_time(queue_depth[3m])"
    cached.query_range(q, QS, STEP, QE - 600)
    h0, m0 = rc.cache_hits.value, rc.cache_misses.value
    slid = cached.query_range(q, QS + STEP, STEP, QE - 600 + STEP)
    assert_equivalent(plain.query_range(q, QS + STEP, STEP,
                                        QE - 600 + STEP), slid)
    n = len(split_extents((QS + STEP) * 1000, STEP * 1000,
                          (QE - 600 + STEP) * 1000, 7))
    assert (rc.cache_hits.value - h0, rc.cache_misses.value - m0) == (n, 0)
    p0 = rc.cache_partial_hits.value
    h1, m1 = rc.cache_hits.value, rc.cache_misses.value
    far = QE - 600 + 2 * 7 * STEP
    assert_equivalent(plain.query_range(q, QS, STEP, far),
                      cached.query_range(q, QS, STEP, far))
    assert rc.cache_hits.value - h1 >= 4
    assert 1 <= rc.cache_misses.value - m1 <= 3
    assert rc.cache_partial_hits.value == p0 + 1


def test_unaligned_starts_share_interior_extents(cached):
    q = f"sum(rate({M}[5m]))"
    cached.query_range(q, QS, STEP, QE)
    h0 = rc.cache_hits.value
    r = cached.query_range(q, QS + 7 * STEP, STEP, QE)
    assert rc.cache_hits.value > h0 and r.stats.cache_misses == 0


@pytest.mark.parametrize("start,total", [(s, t) for s in
                                         (0, 100, 419_000, 420_000)
                                         for t in (1, 7, 8, 50)])
def test_split_extents_equal_the_reference(start, total):
    end = start + (total - 1) * 60_000
    got = split_extents(start, 60_000, end, 7)
    assert got == ref_rc.split_extents(start, 60_000, end, 7)
    cover = np.concatenate([np.arange(a, b + 1, 60_000) for a, b in got])
    assert np.array_equal(cover, np.arange(start, end + 1, 60_000))


SPLIT_QUERIES = [
    f"sum(rate({M}[5m]))", "avg_over_time(queue_depth[3m]) * 2",
    f"rate({M}[5m]) / on (job) group_left sum(rate({M}[5m])) by (job)",
    "queue_depth offset 2m", "max_over_time(rate(queue_depth[1m])[10m:1m])",
    "absent_over_time(queue_depth[5m])", "sort(avg_over_time(queue_depth[3m]))",
    "limit(2, queue_depth)", f"avg_over_time(queue_depth[3m] @ {START_S + 500})",
    "queue_depth offset -1m", "vector(1)", "time()",
]


@pytest.mark.parametrize("q", SPLIT_QUERIES)
def test_splittable_grid_and_signature_equal_the_reference(q):
    """Both packages split (or bypass) the same PromQL alike, and their
    signatures tell the same queries apart."""
    def both(text, s, e):
        return (ref_parse(text, RefParams(s, STEP, e), 300_000),
                port_parse(text, TimeStepParams(s, STEP, e)))

    r1, p1 = both(q, QS, QE)
    r2, p2 = both(q, QS + 600, QE + 600)
    assert splittable_grid(p1) == ref_rc.splittable_grid(r1)
    assert (plan_signature(p1) == plan_signature(p2)) == \
        (ref_rc.plan_signature(r1) == ref_rc.plan_signature(r2))
    r3, p3 = both(q.replace("[3m]", "[4m]").replace("[5m]", "[6m]"), QS, QE)
    assert (plan_signature(p1) == plan_signature(p3)) == \
        (ref_rc.plan_signature(r1) == ref_rc.plan_signature(r3))


BYPASSED = [
    ("queue_depth", {"step": 0}),
    ("max_over_time(rate(queue_depth[1m])[10m:1m])", {}),
    ("absent_over_time(queue_depth[5m])", {}),
    ("absent(nope)", {}),
    ("sort(avg_over_time(queue_depth[3m]))", {}),
    ("limit(2, avg_over_time(queue_depth[3m]))", {}),
    (f"avg_over_time(queue_depth[3m] @ {START_S + 900})", {}),
    ("avg_over_time(queue_depth[3m] offset -1m)", {}),
    ("avg_over_time(queue_depth[3m])", {"spread": 1}),
    ("avg_over_time(queue_depth[3m])", {"shard_overrides": [0]}),
]


@pytest.mark.parametrize("q,how", BYPASSED, ids=lambda x: str(x)[:40])
def test_bypassed_queries_are_not_cached(stores, plain, q, how):
    svc = QueryService(stores[1], device="cpu",
                       result_cache={"extent_steps": 7})
    step = how.get("step", STEP)
    qc = QueryContext(planner_params=PlannerParams(
        spread=how.get("spread"), shard_overrides=how.get("shard_overrides")))
    end = QS if step == 0 else QE
    plan = port_parse(q, TimeStepParams(QS, step, end))
    assert svc.result_cache.execute(svc, plan, qc) is None
    got = svc.query_range(q, QS, step, end, qcontext=qc)
    assert len(svc.result_cache) == 0
    want = plain.query_range(q, QS, step, end, qcontext=qc)
    assert [str(k) for k in got.result.keys] == \
        [str(k) for k in want.result.keys]
    np.testing.assert_array_equal(got.result.values, want.result.values)


def _gauge_records(keys, n, seed=5):
    """``n`` samples at 10 s of a gauge a key, from numpy (the same values
    whatever ``n``: a later call continues the stream)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-50, 50, (len(keys), 2000)).astype(np.float64)
    ts = START_S * 1000 + np.arange(2000) * 10_000
    return ts[:n], vals[:, :n]


def _twin_gauges(n: int):
    """24 gauges in two namespaces (every shard non-empty, so the horizon
    is defined) in a JAX store and in the port's, ``n`` samples each."""
    keys = [{"_metric_": "heap_usage", "_ws_": "demo", "_ns_": f"App-{ns}",
             "host": f"h{i}"} for ns in (8, 9) for i in range(12)]
    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, StoreConfig(max_chunk_size=100, groups_per_shard=4,
                                     device_pages=True))
    port = MemStore(NUM_SHARDS, 1, max_chunk_size=100)
    twins = (ref, port, keys, [0])
    _ingest_to(twins, n)
    assert all(s.max_ingested_ts > 0 for s in port.shards)
    return twins


def _ingest_to(twins, n: int) -> None:
    """The samples past those already in, up to ``n`` a series."""
    ref, port, keys, done = twins
    ts, vals = _gauge_records(keys, n)
    a = done[0]
    stream = []
    for i, labels in enumerate(keys):
        c = RecordContainer()
        key = RefPartKey.create("gauge", labels)
        for t, v in zip(ts[a:], vals[i, a:]):
            c.add(IngestRecord(key, int(t), (float(v),)))
        stream.append(SomeData(c, i))
        port.ingest(labels, ts[a:], vals[i, a:], schema="gauge")
    ingest_routed(ref, DS, iter(stream), NUM_SHARDS, spread=1)
    done[0] = n


def test_live_ingest_invalidates_the_head_not_the_history():
    twins = _twin_gauges(360)
    ref, port = twins[:2]
    svc = QueryService(port, device="cpu", result_cache={"extent_steps": 7})
    q, qs, qe = "avg_over_time(heap_usage[3m])", START_S + 100, START_S + 3500
    first = svc.query_range(q, qs, STEP, qe)
    horizon = min(s.max_ingested_ts for s in port.shards) - 300_000
    stamped = [k for k, (stamp, _) in svc.result_cache._lru.items()
               if stamp is not None]
    assert [k[2] > horizon for k in svc.result_cache._lru] == \
        [k in stamped for k in svc.result_cache._lru]
    assert 0 < len(stamped) < first.stats.cache_misses
    _ingest_to(twins, 420)
    got = svc.query_range(q, qs, STEP, qe)
    assert got.stats.cache_misses == len(stamped)  # the head only
    assert_equivalent(QueryService(port, device="cpu").query_range(
        q, qs, STEP, qe), got)
    assert_equivalent(_ref(ref).query_range(q, qs, STEP, qe), got)


def test_immutable_extents_survive_version_bumps():
    twins = _twin_gauges(720)
    svc = QueryService(twins[1], device="cpu",
                       result_cache={"extent_steps": 7})
    q, qs, qe = "avg_over_time(heap_usage[3m])", START_S + 100, START_S + 3000
    svc.query_range(q, qs, STEP, qe)
    version = twins[1].version
    _ingest_to(twins, 740)
    assert twins[1].version > version
    h0 = rc.cache_hits.value
    r = svc.query_range(q, qs, STEP, qe)
    n = len(split_extents(qs * 1000, STEP * 1000, qe * 1000, 7))
    assert rc.cache_hits.value - h0 == n == r.stats.cache_hits
    assert_equivalent(_ref(twins[0]).query_range(q, qs, STEP, qe), r)


def test_eviction_respects_the_byte_budget(stores):
    svc = QueryService(stores[1], device="cpu",
                       result_cache={"extent_steps": 7, "max_bytes": 20_000})
    e0 = rc.cache_evictions.value
    for i in range(6):
        svc.query_range(f"avg_over_time(queue_depth[{i + 2}m])", QS, STEP,
                        QE)
    assert 0 < svc.result_cache.nbytes <= 20_000
    assert rc.cache_evictions.value > e0


def test_low_priority_entries_are_evicted_first(stores):
    m = QueryService(stores[1], device="cpu").query_range(
        "sum(queue_depth)", QS, STEP, QS + 10 * STEP).result
    cache = ResultCache(ResultCacheConfig(
        max_bytes=3 * rc._matrix_nbytes(m)))
    for i, cheap in enumerate((False, True, False, False)):
        cache._put(("k", i), None, m, cheap=cheap)
    kept = [k for k in cache._lru]
    assert ("k", 1) not in kept and ("k", 3) in kept


def test_config_forms():
    assert ResultCache.from_config(None) is None
    assert ResultCache.from_config(False) is None
    assert ResultCache.from_config({"enabled": False}) is None
    assert isinstance(ResultCache.from_config(True), ResultCache)
    c = ResultCache.from_config({"extent_steps": 5, "max_bytes": 123,
                                 "unknown": 1})
    assert (c.config.extent_steps, c.config.max_bytes) == (5, 123)
    assert ResultCache.from_config(
        ResultCacheConfig(extent_steps=9)).config.extent_steps == 9
    same = ResultCache()
    assert ResultCache.from_config(same) is same
    ref = ref_rc.ResultCacheConfig()
    assert ResultCacheConfig() == ResultCacheConfig(**vars(ref))


@pytest.mark.parametrize("populate,serve", [("1", "0"), ("0", "1")])
def test_signature_and_extents_ignore_the_sidecar_valve(
        stores, plain, cached, monkeypatch, populate, serve):
    sigs = set()
    for v in ("0", "1"):
        monkeypatch.setenv("FILODB_SIDECARS", v)
        sigs.add(plan_signature(port_parse(
            f"sum(rate({M}[5m]))", TimeStepParams(QS, STEP, QE))))
    assert len(sigs) == 1
    for q in (f"sum(rate({M}[5m]))", "max_over_time(queue_depth[7m])"):
        monkeypatch.setenv("FILODB_SIDECARS", populate)
        assert_equivalent(plain.query_range(q, QS, STEP, QE),
                          cached.query_range(q, QS, STEP, QE))
        monkeypatch.setenv("FILODB_SIDECARS", serve)
        warm = cached.query_range(q, QS, STEP, QE)
        assert warm.stats.cache_misses == 0
        assert_equivalent(plain.query_range(q, QS, STEP, QE), warm)


def test_batch_consults_the_extent_cache(stores, cached):
    out = cached.query_range_many(BATCH[:4])
    again = cached.query_range_many(BATCH[:4])
    for a, b in zip(out, again):
        assert b.stats.cache_misses == 0 and b.stats.cache_hits > 0
        _match(a, b, bitwise=True)
    ref = _ref(stores[0])
    for q, r in zip(BATCH[:4], again):
        want = ref.query_range(*q)
        want.result.materialize()
        _match(r, want)


# ---- the response cache and the fast front end -----------------------------------

def test_response_cache_key_names_the_service_by_its_serial(stores):
    a = QueryService(stores[1], device="cpu")
    b = QueryService(stores[1], device="cpu")
    assert a.serial != b.serial
    ka = response_cache_key(a, "range", ("q", 1, 2, 3))
    assert ka != response_cache_key(b, "range", ("q", 1, 2, 3))
    assert ka[0] == a.serial
    assert response_cache_key(a, "instant", ("q", 5, 0, 5)) == \
        (a.serial, "instant", "q", 5)


def _get(port: int, path: str, **params) -> tuple[int, bytes]:
    url = f"http://127.0.0.1:{port}{path}?" + "&".join(
        f"{k}={urllib.request.quote(str(v))}" for k, v in params.items())
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_response_cache_hits_until_a_row_is_ingested():
    twins = _twin_gauges(120)
    svc = QueryService(twins[1], device="cpu")
    srv = FastHttpServer({DS: svc}, port=0).start()
    try:
        path = f"/promql/{DS}/api/v1/query_range"
        params = dict(query="sum(heap_usage)", start=START_S + 100,
                      end=START_S + 1100, step=STEP)
        c1, b1 = _get(srv.port, path, **params)
        c2, b2 = _get(srv.port, path, **params)
        cache = srv.response_cache
        assert (c1, c2, b1, cache.hits, cache.misses) == (200, 200, b2, 1, 1)
        _ingest_to(twins, 121)
        c3, b3 = _get(srv.port, path, **params)
        assert (c3, cache.hits, cache.misses) == (200, 1, 2)
        assert json.loads(b3)["data"] == json.loads(
            promjson.matrix_json_str(svc.query_range(
                "sum(heap_usage)", START_S + 100, STEP, START_S + 1100)))[
            "data"]
    finally:
        srv.stop()


FRONT_QUERIES = [(f"sum(rate({M}[5m])) by (job)", QS + i * STEP, STEP,
                  QE + i * STEP) for i in range(4)] + [
    (f"rate({M}[5m])", QS, STEP, QE), (f"increase({M}[2m])", QS, STEP, QE),
    (f"sum(rate({M}[5m])) by (job)", QS, STEP, QE),
    (f"count(rate({M}[5m]))", QS, STEP, QE)]


def _range_path(q) -> str:
    return (f"/promql/{DS}/api/v1/query_range?"
            + urllib.parse.urlencode({"query": q[0], "start": q[1],
                                      "step": q[2], "end": q[3]}))


def test_fast_front_batches_concurrent_clients(stores):
    """8 concurrent clients and 8 requests pipelined on one connection get
    the single-query bodies' data, byte for byte (rate members: B3,
    bitwise, over one shared batch); the pipelined requests run as one
    hot batch of 8."""
    svc = QueryService(stores[1], device="cpu")
    single = QueryService(stores[1], device="cpu")
    want = [_data(promjson.matrix_json_str(single.query_range(*q)))
            for q in FRONT_QUERIES]
    srv = FastHttpServer({DS: svc}, port=0, response_cache=False).start()
    try:
        got = [None] * len(FRONT_QUERIES)

        def client(i):
            path, params = _split(_range_path(FRONT_QUERIES[i]))
            got[i] = _get(srv.port, path, **params)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(FRONT_QUERIES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [g[0] for g in got] == [200] * len(FRONT_QUERIES)
        assert [_data(g[1]) for g in got] == want
        srv.batch_sizes.clear()
        with socket.create_connection(("127.0.0.1", srv.port)) as s:
            s.sendall(b"".join(
                f"GET {_range_path(q)} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
                for q in FRONT_QUERIES))
            bodies = _read_responses(s, len(FRONT_QUERIES))
        assert [_data(b) for b in bodies] == want
        assert srv.batch_sizes == [len(FRONT_QUERIES)]
    finally:
        srv.stop()


def _data(body) -> str:
    """A body's ``data``, as rendered (its stats hold wall times)."""
    return json.dumps(json.loads(body)["data"])


def _split(path: str):
    p, _, query = path.partition("?")
    return p, dict(urllib.parse.parse_qsl(query))


def _read_responses(s, n: int) -> list[bytes]:
    buf, out = b"", []
    s.settimeout(120)
    while len(out) < n:
        head_end = buf.find(b"\r\n\r\n")
        if head_end >= 0:
            head = buf[:head_end].decode()
            ln = int(next(h.split(":")[1] for h in head.split("\r\n")
                          if h.lower().startswith("content-length")))
            if len(buf) >= head_end + 4 + ln:
                assert head.startswith("HTTP/1.1 200")
                out.append(buf[head_end + 4:head_end + 4 + ln])
                buf = buf[head_end + 4 + ln:]
                continue
        data = s.recv(1 << 16)
        assert data
        buf += data
    return out
