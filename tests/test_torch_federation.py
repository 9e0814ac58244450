"""Port parity for tier federation: ``route_tiers``, the cold raw tier over
the column store, ``TierExec`` and its per-tier stats, ``TieredPlanner``
with its service hooks, ``tier_status`` and the HTTP faces of a node.

The store is ``test_torch_downsample``'s (the same containers in both
packages' stores over local-disk directories, flushed, each package's
downsampler job run over its own directory). The timeline, seconds past
``START``: data covers [0, +6000); the memstore floor is at +4000 and
the raw floor at +2000, so a query over [+900, +5400] crosses both seams.

- ``route_tiers`` gives the reference's step ranges bit for bit, on the
  reference's cases and over a sweep of alignments;
- ``TieredPlanner`` gives the reference's plan shape (each tier's leaves,
  their data ranges and columns) and answers as it does within the parity
  tests' tolerance (``rtol=2e-5, atol=1e-6``), with the same tiers in
  ``QueryStats.tiers``;
- a plan that is not memstore-only never reaches the mesh engine, and is
  classed EXPENSIVE; a warm repeat through the extent cache pages no cold
  or ds chunk in; a refresh of a colder tier's index moves the cache's
  stamp;
- ``/api/v1/status/tiers`` gives the reference's routing fields, and a
  node booted from a config with ``downsample`` and ``federation``
  answers a three-tier query on both fronts.

The cases that need the object store (``TestChaos``, the pyramid cases,
``approx_*``) wait for it (ROADMAP A5).
"""

from __future__ import annotations

import json
import shutil
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import SingleClusterPlanner as RefPlanner
from filodb_tpu.coordinator.tiered_planner import (
    build_tiered_planner as ref_build_tiered,
)
from filodb_tpu.core.downsample import DownsampledTimeSeriesStore as RefDs
from filodb_tpu.core.store.localstore import LocalDiskColumnStore as RefCS
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query.exec.plan import ExecContext as RefCtx
from filodb_tpu.query.exec.plan import SelectRawPartitionsExec as RefLeaf
from filodb_tpu.query.federation import route_tiers as ref_route_tiers
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.tiered_planner import (
    TieredPlanner,
    build_tiered_planner,
)
from filodb_tpu_torch.core.downsample import DownsampledTimeSeriesStore
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.core.store.localstore import LocalDiskColumnStore
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query import federation
from filodb_tpu_torch.query.exec.plan import SelectRawPartitionsExec
from filodb_tpu_torch.query.federation import (
    DOWNSAMPLE,
    MEMSTORE,
    OBJECTSTORE,
    route_tiers,
)
from filodb_tpu_torch.utils.governor import EXPENSIVE
from test_torch_downsample import (
    CHUNK,
    DS,
    NUM_SHARDS,
    RES,
    START,
    TOL,
    _run_job,
    build_pair,
)

NOW = (START + 6000) * 1000
MEM_FLOOR = (START + 4000) * 1000
RAW_FLOOR = (START + 2000) * 1000
Q_SPAN = ("max_over_time(heap_usage[10m])", START + 900, 300, START + 5400)


# ---- routing ------------------------------------------------------------------

ROUTE_CASES = {
    "all_memstore": (100, 10, 200, 30, 50, 0),
    "all_objectstore": (100, 10, 200, 30, 10_000, 0),
    "all_downsample": (100, 10, 200, 30, 10_000, 5_000),
    "three_way_split": (0, 10, 100, 5, 50, 20),
    "exact_boundary_step_goes_to_newer_tier": (300, 100, 700, 200, 300, 0),
    "one_ms_deeper_floor": (300, 100, 700, 200, 301, 0),
    "lookback_satisfied_across_seams": (0, 10, 1000, 35, 500, 100),
    "mem_floor_clamped_to_raw_floor": (0, 10, 100, 0, 20, 50),
    "no_ds_tier_when_raw_floor_none": (0, 10, 100, 0, 50, None),
}


def _ranges(rs) -> list:
    return [(r.tier, r.start, r.end) for r in rs]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_tiers_matches_the_reference(case):
    args = ROUTE_CASES[case]
    assert _ranges(route_tiers(*args)) == _ranges(ref_route_tiers(*args))


def test_route_tiers_sweep_matches_the_reference():
    """Every alignment of step, lookback and floors: the same ranges, and
    each grid step in exactly one tier, oldest tier first."""
    start, end = 1000, 2000
    for step in (7, 10, 100):
        for lookback in (0, 3, step, 250):
            for mem_floor in (900, 1203, 1500, 2500):
                for raw_floor in (None, 800, 1100, 1490):
                    args = (start, step, end, lookback, mem_floor, raw_floor)
                    rs = route_tiers(*args)
                    assert _ranges(rs) == _ranges(ref_route_tiers(*args))
                    got = [t for r in rs
                           for t in range(r.start, r.end + 1, step)]
                    assert got == list(range(start, end + 1, step))
                    order = [r.tier for r in rs]
                    assert order == sorted(order, key=[
                        DOWNSAMPLE, OBJECTSTORE, MEMSTORE].index)


# ---- the environment ---------------------------------------------------------------


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Both stores, each package's ds job run over its own directory."""
    root = tmp_path_factory.mktemp("fed")
    ref, port = build_pair(root)
    for p in ("ref", "port"):
        _run_job(p, str(root / p), 5_000)
    return ref, port, root


def _ref_planner(root, with_ds=True, now=NOW):
    rcs = RefCS(str(root / "ref"))
    ds = RefPlanner(DS, NUM_SHARDS, 0, agg_pushdown="off",
                    store=RefDs(rcs, DS, RES, NUM_SHARDS)) if with_ds \
        else None
    return ref_build_tiered(
        RefPlanner(DS, NUM_SHARDS, 0, agg_pushdown="off"), rcs, DS,
        NUM_SHARDS, mem_retention_ms=NOW - MEM_FLOOR,
        raw_retention_ms=NOW - RAW_FLOOR if with_ds else None,
        ds_planner=ds, now_ms=lambda: now)


def _port_planner(root, with_ds=True, now=NOW, **kw):
    cs = LocalDiskColumnStore(str(root / "port"))
    ds = SingleClusterPlanner(NUM_SHARDS, 0, store=DownsampledTimeSeriesStore(
        cs, DS, RES, NUM_SHARDS)) if with_ds else None
    return build_tiered_planner(
        SingleClusterPlanner(NUM_SHARDS, 0), cs, DS, NUM_SHARDS,
        mem_retention_ms=NOW - MEM_FLOOR,
        raw_retention_ms=NOW - RAW_FLOOR if with_ds else None,
        ds_planner=ds, now_ms=lambda: now, **kw)


def _port_service(env, with_ds=True, engine="exec", **kw):
    svc = QueryService(env[1], device="cpu", engine=engine, **kw)
    svc.planner = _port_planner(env[2], with_ds)
    return svc


def _ref_run(env, planner, q, start, step, end):
    ep = planner.materialize(ref_parse(q, RefParams(start, step, end)))
    ctx = RefCtx(env[0], DS)
    m = ep.dispatcher.dispatch(ep, ctx).result
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order], m, ctx


def _port_run(svc, q, start, step, end):
    r = svc.query_range(q, start, step, end)
    m = r.result.materialize()
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order], m, r


FED_QUERIES = (
    "sum(rate(http_requests_total[15m]))",
    "sum(rate(http_requests_total[15m])) by (_ns_)",
    "sum(sum_over_time(heap_usage[15m])) by (job)",
    "avg(avg_over_time(heap_usage[15m]))",
    "max(max_over_time(heap_usage[15m])) by (_ns_)",
    "min_over_time(heap_usage[10m])",
    "count_over_time(heap_usage[15m])",
)


@pytest.mark.parametrize("q", FED_QUERIES)
def test_three_tier_answers_match_the_reference(env, q):
    args = (START + 1200, 300, START + 5400)
    keys, want, wm, ctx = _ref_run(env, _ref_planner(env[2]), q, *args)
    svc = _port_service(env)
    got_keys, got, gm, r = _port_run(svc, q, *args)
    assert got_keys == keys and keys
    np.testing.assert_array_equal(gm.steps_ms, wm.steps_ms)
    np.testing.assert_allclose(got, want, **TOL)
    assert set(r.stats.tiers) == set(ctx.stats.tiers) \
        == {MEMSTORE, OBJECTSTORE, DOWNSAMPLE}
    for tier, b in ctx.stats.tiers.items():
        assert r.stats.tiers[tier]["subqueries"] == b["subqueries"]
        assert r.stats.tiers[tier]["series"] == b["series"]
    assert r.stats.engine == "exec"


def _shape(plan, leaf_type, tier_of=lambda n: getattr(n, "tier", None)):
    """(top node kind, then a leaf's (tier, shard, data range, column) in
    tree order)."""
    out = []

    def walk(node, tier):
        tier = tier_of(node) or tier
        if isinstance(node, leaf_type):
            out.append((tier, node.shard, node.chunk_start, node.chunk_end,
                        node.value_column))
        for c in node.children():
            walk(c, tier)

    walk(plan, None)
    return type(plan).__name__, out


@pytest.mark.parametrize("q", FED_QUERIES[:4] + (Q_SPAN[0],))
@pytest.mark.parametrize("span", [(900, 5400), (4500, 5400), (900, 2400),
                                  (2100, 3900)])
def test_tiered_planner_gives_the_reference_plan_shape(env, q, span):
    """Each tier's leaves, their data ranges and columns, in order: the
    hot path without TierExec, one cold range without a stitch."""
    a, b = span
    want = _shape(_ref_planner(env[2]).materialize(
        ref_parse(q, RefParams(START + a, 300, START + b))), RefLeaf)
    port = _port_planner(env[2])
    got = _shape(port.materialize(parse_query(q, TimeStepParams(
        START + a, 300, START + b))), SelectRawPartitionsExec)
    assert got == want


def test_two_tier_answers_equal_the_all_raw_control(env):
    """Memstore and cold raw tiers read the same raw chunks: the federated
    answer equals the all-raw one bit for bit, and the reference's within
    the tolerance."""
    svc = _port_service(env, with_ds=False)
    keys, fed, _, r = _port_run(svc, *Q_SPAN)
    raw = QueryService(env[1], device="cpu", engine="exec")
    ckeys, ctl, _, _ = _port_run(raw, *Q_SPAN)
    assert keys == ckeys
    np.testing.assert_array_equal(fed, ctl)
    assert set(r.stats.tiers) == {OBJECTSTORE, MEMSTORE}
    rkeys, want, _, _ = _ref_run(env, _ref_planner(env[2], with_ds=False),
                                 *Q_SPAN)
    assert rkeys == keys
    np.testing.assert_allclose(fed, want, **TOL)


def test_cold_tier_reads_match_the_memstore(env):
    """All steps in the cold tier (a memory floor past the data): the
    answer of the raw chunks paged in from the column store equals the
    memstore's."""
    svc = QueryService(env[1], device="cpu", engine="exec")
    svc.planner = _port_planner(env[2], with_ds=False, now=NOW * 2)
    q = ("sum_over_time(heap_usage[10m])", START + 900, 300, START + 5400)
    keys, cold, _, r = _port_run(svc, *q)
    assert set(r.stats.tiers) == {OBJECTSTORE}
    raw = QueryService(env[1], device="cpu", engine="exec")
    ckeys, ctl, _, _ = _port_run(raw, *q)
    assert keys == ckeys
    np.testing.assert_array_equal(cold, ctl)


def test_odp_cache_serves_a_covered_repeat(env):
    svc = _port_service(env, with_ds=False)
    _port_run(svc, *Q_SPAN)
    cold = svc.planner.cold_planner.store
    paged = sum(s.odp_cache.chunks_paged for s in cold.shards)
    hits = sum(s.odp_cache.range_hits for s in cold.shards)
    svc.batches._entries.clear()  # the batches, not the paged chunks
    _port_run(svc, *Q_SPAN)
    assert sum(s.odp_cache.chunks_paged for s in cold.shards) == paged > 0
    assert sum(s.odp_cache.range_hits for s in cold.shards) > hits


def test_per_tier_stats_and_counters(env):
    svc = _port_service(env)
    q0 = federation.fed_queries.value
    subs = {t: c.value for t, c in federation._SUB_COUNTERS.items()}
    r = svc.query_range(*Q_SPAN)
    assert federation.fed_queries.value == q0 + 1
    for t, c in federation._SUB_COUNTERS.items():
        assert c.value == subs[t] + 1, t
    tiers = r.stats.tiers
    assert set(tiers) == {MEMSTORE, OBJECTSTORE, DOWNSAMPLE}
    for b in tiers.values():
        assert b["subqueries"] == 1 and b["series"] > 0 and b["wallMs"] > 0
    assert tiers[OBJECTSTORE]["chunks"] > 0 and tiers[OBJECTSTORE][
        "bytes"] > 0
    assert tiers[DOWNSAMPLE]["bytes"] > 0
    from filodb_tpu_torch.http.promjson import _stats_json
    doc = _stats_json(r, full=True)
    assert set(doc["tiers"]) == set(tiers)
    json.dumps(doc)


# ---- the service's hooks -------------------------------------------------------------


def test_cold_queries_are_classed_expensive(env):
    planner = _port_planner(env[2], with_ds=False)
    cold = parse_query("heap_usage", TimeStepParams(START + 900, 300,
                                                     START + 5400))
    hot = parse_query("heap_usage", TimeStepParams(START + 4500, 60,
                                                    START + 4500))
    assert planner.cost_hint(cold) == EXPENSIVE
    assert planner.cost_hint(hot) is None
    assert not planner.mem_only(cold) and planner.mem_only(hot)
    ref = _ref_planner(env[2], with_ds=False)
    assert ref.cost_hint(ref_parse("heap_usage", RefParams(
        START + 900, 300, START + 5400))) == EXPENSIVE
    svc = _port_service(env, with_ds=False)
    from filodb_tpu_torch.query.model import QueryContext
    assert svc._admission_class(cold, QueryContext()) == EXPENSIVE


@pytest.mark.parametrize("engine", ["mesh", "adaptive"])
def test_only_memstore_plans_reach_the_mesh_engine(env, engine):
    """The mesh engine reads the memstore alone: a plan that reads an
    older tier goes to exec with the tiers' answer; a memstore-only one
    takes the mesh engine."""
    svc = _port_service(env, engine=engine)
    exec_svc = _port_service(env)
    keys, got, _, r = _port_run(svc, *Q_SPAN)
    assert r.stats.engine == "exec" and "older tier" in r.stats.fallback
    assert set(r.stats.tiers) == {MEMSTORE, OBJECTSTORE, DOWNSAMPLE}
    ekeys, want, _, _ = _port_run(exec_svc, *Q_SPAN)
    assert keys == ekeys
    np.testing.assert_array_equal(got, want)
    hot = ("max_over_time(heap_usage[5m])", START + 4500, 300, START + 5400)
    _, _, _, r = _port_run(svc, *hot)
    assert r.stats.engine == "mesh" and not r.stats.tiers
    many = svc.query_range_many([Q_SPAN, hot])
    assert [m.stats.engine for m in many] == ["exec", "mesh"]


def test_warm_repeat_through_the_extent_cache_pages_nothing(env):
    svc = _port_service(env, result_cache={"enabled": True,
                                           "extent_steps": 8})
    r1 = svc.query_range(*Q_SPAN)
    stores = [svc.planner.cold_planner.store, svc.planner.ds_planner.store]

    def paged():
        return [(s.odp_cache.chunks_paged, s.odp_cache.bytes_read)
                for st in stores for s in st.shards]

    before = paged()
    assert any(c for c, _ in before)
    r2 = svc.query_range(*Q_SPAN)
    assert paged() == before
    assert r2.stats.cache_hits > 0 and r1.stats.cache_misses > 0
    np.testing.assert_array_equal(r2.result.materialize().values,
                                  r1.result.materialize().values)


def test_version_token_moves_on_tier_growth(env, tmp_path):
    """New part keys in a colder tier move the planner's token (the cold
    tier finds them at its next refresh, the ds tier at the refresh that
    follows a job's run), so the extent cache's settled extents re-key; a
    refresh that finds nothing new keeps it."""
    from filodb_tpu_torch.testing.from_jax import open_local

    root = tmp_path / "grow"
    shutil.copytree(env[2] / "port", root / "port")
    planner = _port_planner(root, refresh_s=0.0)
    t0 = planner.version_token()
    assert planner.version_token() == t0
    ms = open_local(str(root / "port"), NUM_SHARDS, 0,
                    StoreConfig(max_chunk_size=CHUNK, groups_per_shard=2))
    ts = (START + 6000 + 10 * np.arange(60, dtype=np.int64)) * 1000
    ms.ingest_series([{"_metric_": "heap_usage", "_ws_": "demo",
                       "_ns_": "App-0", "instance": "new", "host": "H9"}],
                     ts[None, :], np.ones((1, 60)), schema="gauge")
    ms.flush_all(9_000)
    t1 = planner.version_token()
    assert t1 > t0
    _run_job("port", str(root / "port"), 10_000)
    assert planner.version_token() == t1
    planner.ds_planner.store.refresh_index()
    assert planner.version_token() > t1


def test_timeless_plans_route_raw_and_one_cold_range_skips_the_stitch(env):
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals
    from filodb_tpu_torch.query import logical as lp

    planner = _port_planner(env[2], with_ds=False)
    raw = lp.RawSeries((ColumnFilter("_metric_", Equals("heap_usage")),),
                       START * 1000, (START + 6000) * 1000)
    assert "TierExec" not in planner.materialize(raw).tree_str()
    ep = planner.materialize(parse_query(
        Q_SPAN[0], TimeStepParams(START + 900, 300, START + 2400)))
    assert type(ep).__name__ == "TierExec" and ep.tier == OBJECTSTORE


# ---- HTTP and the node -------------------------------------------------------------------


def _get(port: int, path: str, **params):
    qs = urllib.parse.urlencode(params, doseq=True)
    url = f"http://127.0.0.1:{port}{path}" + (f"?{qs}" if qs else "")
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _routing(doc: dict) -> dict:
    """The routing fields of a dataset's tier status."""
    return {"federated": doc["federated"],
            "memFloorMs": doc.get("memFloorMs"),
            "rawFloorMs": doc.get("rawFloorMs"),
            "tiers": [(t["tier"], t["floorMs"], t["ceilMs"],
                       t.get("resolutionMs"), t["series"])
                      for t in doc["tiers"]]}


@pytest.mark.parametrize("front", ["threaded", "fast"])
def test_status_tiers_and_stats_all_on_both_fronts(env, front):
    from filodb_tpu.coordinator.query_service import QueryService as RefSvc
    from filodb_tpu_torch.http.fastserver import FastHttpServer
    from filodb_tpu_torch.http.server import FiloHttpServer

    svc = _port_service(env)
    ref_svc = RefSvc(env[0], DS, NUM_SHARDS, spread=0)
    ref_svc.planner = _ref_planner(env[2])
    cls = FastHttpServer if front == "fast" else FiloHttpServer
    srv = cls({DS: svc}, port=0).start()
    try:
        status, body = _get(srv.port, "/api/v1/status/tiers", dataset=DS)
        assert status == 200 and body["status"] == "success"
        want = federation.tier_status(DS, svc)
        assert body["data"][DS] == json.loads(json.dumps(want))
        from filodb_tpu.query.federation import tier_status as ref_status
        got = _routing(body["data"][DS])
        ref_doc = _routing(ref_status(DS, ref_svc))
        assert got["federated"] and got["memFloorMs"] == MEM_FLOOR \
            and got["rawFloorMs"] == RAW_FLOOR
        # the routing fields, the memstore's series aside (the reference
        # counts its cardinality tree's, the same series here)
        assert got == ref_doc
        q, a, step, b = Q_SPAN
        status, body = _get(srv.port, f"/promql/{DS}/api/v1/query_range",
                            query=q, start=a, step=step, end=b, stats="all")
        assert status == 200
        tiers = body["queryStats"]["tiers"]
        assert set(tiers) == {MEMSTORE, OBJECTSTORE, DOWNSAMPLE}
        status, plain = _get(srv.port, f"/promql/{DS}/api/v1/query_range",
                             query=q, start=a, step=step, end=b)
        assert "tiers" not in plain["queryStats"]
        assert plain["data"] == body["data"]
    finally:
        srv.stop()


NODE_CONF = {
    "node_name": "node-0",
    "datasets": {DS: {"num_shards": NUM_SHARDS, "spread": 0,
                      "engine": "mesh",
                      "store": {"max_chunk_size": CHUNK,
                                "groups_per_shard": 2,
                                "flush_interval_ms": 3_600_000,
                                "retention_ms": 2**60},
                      "downsample": {"resolutions_ms": [RES],
                                     "schedule_s": 3600,
                                     "raw_retention_ms": NOW - RAW_FLOOR}}},
    "federation": {"mem_retention_ms": NOW - MEM_FLOOR},
}


def _booted(server_cls, config_cls, root, conf, **kw):
    """A node over ``root`` (its column store already holding the raw
    chunks), its job's first run done, ``now`` pinned to the data's
    end."""
    from filodb_tpu_torch.testing.from_jax import boot

    srv = boot(server_cls, config_cls, conf, str(root), **kw)
    deadline = time.monotonic() + 60
    ckpt = f"{DS}__dsckpt"
    while time.monotonic() < deadline and not all(
            srv.meta_store.read_checkpoints(ckpt, s).get(0, 0) > 0
            for s in range(NUM_SHARDS)):
        time.sleep(0.1)
    svc = (srv.services if hasattr(srv, "services")
           else srv.http.services)[DS]
    svc.planner.now_ms = lambda: NOW
    ds = svc.planner.ds_planner.store
    if hasattr(ds, "refresh_index"):  # the port's: the job's output
        ds.refresh_index()
    return srv, svc


@pytest.mark.parametrize("front", ["fast", "threaded"])
def test_node_with_downsample_and_federation_answers_three_tiers(
        env, tmp_path, front):
    """Both packages' nodes over copies of one raw directory (the port's
    flush), booted from a config with ``downsample`` and
    ``federation.mem_retention_ms``: the job runs at boot, the planner is
    tiered, and a query over three tiers answers alike through HTTP."""
    from filodb_tpu import config as ref_config
    from filodb_tpu import standalone as ref_standalone
    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.standalone import FiloServer

    for p in ("ref", "port"):
        shutil.copytree(env[2] / "port" / DS,
                        tmp_path / p / "columnstore" / DS)
    conf = dict(NODE_CONF, http_impl=front)
    ref, _ = _booted(ref_standalone.FiloServer, ref_config.ServerConfig,
                     tmp_path / "ref", conf)
    try:
        port, svc = _booted(FiloServer, ServerConfig, tmp_path / "port",
                            conf, device="cpu")
        try:
            assert isinstance(svc.planner, TieredPlanner)
            q, a, step, b = ("sum(rate(http_requests_total[15m])) by "
                             "(_ns_)", START + 1200, 300, START + 5400)
            out = {}
            for name, srv in (("ref", ref), ("port", port)):
                status, body = _get(
                    srv.http.port, f"/promql/{DS}/api/v1/query_range",
                    query=q, start=a, step=step, end=b, stats="all")
                assert status == 200, body
                out[name] = body
                status, tiers = _get(srv.http.port, "/api/v1/status/tiers")
                assert status == 200 and tiers["data"][DS]["federated"]
            assert set(out["port"]["queryStats"]["tiers"]) == {
                MEMSTORE, OBJECTSTORE, DOWNSAMPLE}
            got = {json.dumps(r["metric"], sort_keys=True): r["values"]
                   for r in out["port"]["data"]["result"]}
            want = {json.dumps(r["metric"], sort_keys=True): r["values"]
                    for r in out["ref"]["data"]["result"]}
            assert got.keys() == want.keys() and got
            for k in want:
                assert [t for t, _ in got[k]] == [t for t, _ in want[k]]
                np.testing.assert_allclose([float(v) for _, v in got[k]],
                                           [float(v) for _, v in want[k]],
                                           **TOL)
        finally:
            port.shutdown()
    finally:
        ref.shutdown()


def test_streaming_rollups_reach_the_ds_planner(tmp_path):
    """A node with ``downsample.streaming``: the raw shards' flushes publish
    rollups into the co-sharded ds datasets, the scheduler's tick flushes
    them, and the downsample planner's leaves read them."""
    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.core.record import RecordContainer
    from filodb_tpu_torch.coordinator.ingestion import route_container
    from filodb_tpu_torch.core.downsample import ds_dataset_name
    from filodb_tpu_torch.standalone import FiloServer
    from filodb_tpu_torch.testing.from_jax import boot
    from test_torch_downsample import _containers

    conf = {"node_name": "node-0",
            "datasets": {DS: {"num_shards": NUM_SHARDS, "spread": 0,
                              "engine": "exec",
                              "store": {"max_chunk_size": CHUNK,
                                        "groups_per_shard": 2,
                                        "retention_ms": 2**60},
                              "downsample": {"resolutions_ms": [RES],
                                             "streaming": True,
                                             "schedule_s": 3600,
                                             "raw_retention_ms": 1}}}}
    srv = boot(FiloServer, ServerConfig, conf, str(tmp_path), device="cpu")
    try:
        for off, cont in enumerate(_containers(0, 360)):
            port_cont = RecordContainer.deserialize(cont.serialize())
            for shard, sub in route_container(port_cont, NUM_SHARDS,
                                              0).items():
                srv.logs[(DS, shard)].append(sub)
        node = srv.node
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and sum(
                node.memstores[DS].shards[s].latest_offset
                for s in range(NUM_SHARDS)) < 0:
            time.sleep(0.05)
        for w in list(node._workers.values()):
            while w.offset < w.log.latest_offset:
                time.sleep(0.05)
        name = ds_dataset_name(DS, RES)
        for s in range(NUM_SHARDS):
            node.memstores[DS].shards[s].flush_all(1_000)
        assert sum(node.memstores[name].shards[s].num_partitions
                   for s in range(NUM_SHARDS)) == 10
        for key in list(node._ds_shards):
            for _ in range(2):
                node._flusher.flush_ds(key)
        svc = srv.services[DS]
        r = svc.query_range("max_over_time(heap_usage[10m])", START + 900,
                            300, START + 2400)
        m = r.result.materialize()
        assert m.num_series == 6 and np.isfinite(np.asarray(m.values)).any()
        from filodb_tpu_torch.query.exec.plan import leaves

        tree = svc.planner.materialize(parse_query(
            "max_over_time(heap_usage[10m])",
            TimeStepParams(START + 900, 300, START + 2400)))
        assert {lf.dataset_name for lf in leaves(tree)} == {name}
    finally:
        srv.shutdown()
