"""The port's mesh engine over a (shard, time) mesh of local devices.

``MeshQueryEngine`` (through ``QueryService(mesh=...)``) over
``LocalMesh``es of CPU slots in the layouts 1×1, 4×1, 8×1, 2×2 and 4×2,
on the reference's own test stores (``tests/test_mesh_engine.py``: 24
counters, 24 gauges, 8 histograms; ``tests/test_mesh_sharded.py``: 37
series with uneven tails) carried into the port's ``MemStore`` chunk for
chunk, and the reference's query lists (offsets, the counter family,
``without``, per-series output, post-transforms, histogram shapes):

- against the reference's ``MeshQueryEngine`` on JAX's eight-device CPU
  mesh (a 4×2 mesh, ``tests/conftest.py``) at the reference's own
  tolerance, rtol 1e-6, atol 1e-9 (``tests/test_mesh_engine.py``);
- against the port's own one-slot engine: on shard-only layouts the
  per-series rows bit for bit and aggregates within rtol 1e-9, atol
  1e-12 (an aggregate's group partials add over ``shard`` in block
  order); on layouts with a time axis, where the split pipeline's float64
  combine stands in for B3's float32 kernel, within B3's tolerance
  against the float64 path (rtol 2e-5, atol 1e-6).

Each layout is a case of one parametrised test a query. Beside them:
``execute_many`` over a mesh, evicted chunks paged in, the ring variant,
the batch cache's per-card footprint, and the mesh counters' moves.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.parallel import mesh_engine
from filodb_tpu_torch.parallel.dist_query import LocalMesh
from filodb_tpu_torch.parallel.mesh_engine import make_query_mesh
from filodb_tpu_torch.query.engine.device_batch import MeshBatch
from filodb_tpu_torch.testing.from_jax import ingest_states
from test_mesh_engine import build_hist_store
from test_mesh_engine import build_store as build_store24
from test_mesh_sharded import build_store as build_store37
from test_torch_histograms import _states

DS = "timeseries"
NUM_SHARDS = 4
START = 1_600_000_000
LAYOUTS = {"1x1": (1, 1), "4x1": (4, 1), "8x1": (8, 1), "2x2": (2, 2),
           "4x2": (4, 2)}
REF_TOL = dict(rtol=1e-6, atol=1e-9)
AGG_TOL = dict(rtol=1e-9, atol=1e-12)
B3_TOL = dict(rtol=2e-5, atol=1e-6)

C = "http_requests_total"
G = "gauge_metric"
H = "http_req_latency"
COUNTER_QUERIES = (
    f"sum(rate({C}[5m]))",
    f"sum(rate({C}[5m])) by (_ns_)",
    f'sum(rate({C}{{_ns_="App-0"}}[2m])) by (instance)',
    f"sum(rate({C}[5m])) by (_metric_)",
    f"sum(rate({C}[5m] offset 2m))",
    f"sum(rate({C}[5m] offset 2m)) by (_ns_)",
    f"avg(increase({C}[5m]))",
    f"sum(delta({C}[5m]))",
    C,
    f'{C}{{_ns_="App-0"}}',
    f"rate({C}[5m])",
    f"max_over_time({C}[4m])",
    f"abs(sum(rate({C}[5m])) by (_ns_))",
    f"clamp_max(sum(rate({C}[5m])), 0.5)",
    f"sqrt(avg(rate({C}[5m])))",
    f"2 * sum(rate({C}[5m])) by (_ns_)",
    f"sum(rate({C}[5m])) by (_ns_) > 0.2",
    f"sum(rate({C}[5m])) by (_ns_) > bool 0.2",
    f"topk(2, rate({C}[5m]))",
    f"topk(2, sum(rate({C}[5m])) by (instance))",
)
GAUGE_QUERIES = (
    tuple(f"{agg}({fn}({G}[3m])) by (_ns_)"
          for fn in ("sum_over_time", "count_over_time", "avg_over_time",
                     "min_over_time", "max_over_time", "last_over_time")
          for agg in ("sum", "avg", "count", "min", "max"))
    + (f"sum(sum_over_time({G}[3m])) without (instance)",
       f"stddev(max_over_time({G}[3m])) by (_ns_)",
       f"stdvar(avg_over_time({G}[3m]))",
       f"group(last_over_time({G}[3m])) by (_ns_)",
       f"sum(present_over_time({G}[3m]))",
       f"avg(stddev_over_time({G}[3m])) by (_ns_)",
       f"max(stdvar_over_time({G}[3m]))"))
HIST_QUERIES = (
    f"histogram_quantile(0.9, sum(rate({H}[5m])))",
    f"histogram_quantile(0.5, sum(rate({H}[5m])) by (app))",
    f"sum(rate({H}[5m])) by (app)",
    f"rate({H}[5m])",
    f"histogram_quantile(0.99, sum(increase({H}[10m])))",
)
SHARDED_QUERIES = (
    ("counter37", f"sum(rate({C}[5m])) by (_ns_)"),
    ("counter37", f"rate({C}[5m])"),
    ("counter37", f"sum(increase({C}[5m])) by (instance)"),
    ("counter37", f"count(delta({C}[5m]))"),
    ("gauge37", f"sum(sum_over_time({G}[3m])) by (_ns_)"),
    ("gauge37", f"avg_over_time({G}[3m])"),
    ("gauge37", f"max(last_over_time({G}[3m]))"),
    ("gauge37", f"min(stddev_over_time({G}[3m])) by (_ns_)"),
)
CASES = ([("counter", q) for q in COUNTER_QUERIES]
         + [("gauge", q) for q in GAUGE_QUERIES]
         + [("hist", q) for q in HIST_QUERIES] + list(SHARDED_QUERIES))
RANGES = {"counter37": (START + 600, 60, START + 2800),
          "gauge37": (START + 600, 60, START + 2800)}
BUILDERS = {"counter": lambda: build_store24("counter"),
            "gauge": lambda: build_store24("gauge"),
            "hist": build_hist_store,
            "counter37": lambda: build_store37("counter"),
            "gauge37": lambda: build_store37("gauge")}


@functools.lru_cache(maxsize=None)
def _stores(name: str):
    """(the reference's store, the port's twin)."""
    ref = BUILDERS[name]()
    port = MemStore(NUM_SHARDS, spread=1, max_chunk_size=100)
    ingest_states(port, _states(ref))
    return ref, port


def cpu_mesh(layout: str) -> LocalMesh:
    ds, dt = LAYOUTS[layout]
    return make_query_mesh(devices=["cpu"] * (ds * dt), time_axis=dt)


def _range(store: str):
    return RANGES.get(store, (START + 600, 60, START + 1800))


def _sorted(m):
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys, kind="stable")
    return [keys[i] for i in order], np.asarray(m.values)[order]


@functools.lru_cache(maxsize=None)
def _reference(store: str, q: str):
    ref, _ = _stores(store)
    res = RefService(ref, DS, NUM_SHARDS, spread=1, engine="mesh") \
        .query_range(q, *_range(store)).result
    res.materialize()
    return _sorted(res)


def _port(store: str, q: str, mesh=None, **kw):
    _, port = _stores(store)
    res = QueryService(port, device="cpu" if mesh is None else None,
                       mesh=mesh, **kw).query_range(q, *_range(store))
    assert res.stats.engine == "mesh", res.stats.fallback
    res.result.materialize()
    return _sorted(res.result)


@functools.lru_cache(maxsize=None)
def _one_slot(store: str, q: str):
    return _port(store, q)


def _aggregated(q: str) -> bool:
    """Whether ``q`` aggregates series (else its rows are per series)."""
    return any(f"{a}(" in q for a in ("sum", "avg", "count", "min", "max",
                                      "stddev", "stdvar", "group"))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("store,q", CASES, ids=[f"{s}:{q}" for s, q in CASES])
def test_mesh_layout_matches_the_reference_and_one_slot(store, q, layout):
    got = _port(store, q, cpu_mesh(layout))
    want = _reference(store, q)
    assert got[0] == want[0]
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], equal_nan=True, **REF_TOL,
                               err_msg="against the reference's mesh")
    _same(got, _one_slot(store, q), layout, agg=_aggregated(q))


def _same(got, want, layout: str, agg: bool = True) -> None:
    assert got[0] == want[0]
    if LAYOUTS[layout][1] > 1:
        np.testing.assert_allclose(got[1], want[1], equal_nan=True, **B3_TOL)
    elif agg:
        np.testing.assert_allclose(got[1], want[1], equal_nan=True,
                                   **AGG_TOL)
    else:
        assert got[1].tobytes() == want[1].tobytes()


@pytest.mark.parametrize("layout", ["4x1", "8x1", "2x2", "4x2"])
def test_execute_many_over_a_mesh(layout):
    """Grids that share a leaf share one mesh batch; each answers as the
    one-slot engine's query."""
    _, port = _stores("counter")
    q = f"sum(rate({C}[5m])) by (_ns_)"
    ranges = [(START + 600 + 120 * i, 60, START + 1500 + 60 * i)
              for i in range(5)]
    svc = QueryService(port, mesh=cpu_mesh(layout))
    got = svc.query_range_many([(q, *r) for r in ranges]
                               + [(f"rate({C}[5m])", *ranges[0])])
    batches = svc.batches.batches("mesh")
    assert len(batches) == 1 and isinstance(batches[0], MeshBatch)
    one = QueryService(port, device="cpu")
    for r, g in zip(ranges, got):
        assert g.stats.engine == "mesh"
        _same(_sorted(g.result), _sorted(one.query_range(q, *r).result),
              layout)
    _same(_sorted(got[-1].result),
          _sorted(one.query_range(f"rate({C}[5m])", *ranges[0]).result),
          layout, agg=False)


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_the_mesh_pages_evicted_chunks_in(tmp_path, layout):
    """Partitions whose flushed chunks memory dropped page them back in
    before the mesh batch is cut, as the one-slot engine's do (the
    reference's ``TestMeshODP``)."""
    from filodb_tpu_torch.core.store.localstore import (
        LocalDiskColumnStore,
        LocalDiskMetaStore,
    )

    root = str(tmp_path)
    store = MemStore(1, 0, max_chunk_size=50,
                     column_store=LocalDiskColumnStore(root),
                     meta_store=LocalDiskMetaStore(root))
    rng = np.random.default_rng(5)
    ts = START * 1000 + np.arange(300) * 10_000
    for i in range(6):
        store.ingest({"_metric_": "heap_usage", "_ws_": "demo",
                      "_ns_": "App-0", "host": f"h{i}"}, ts,
                     np.round(rng.random(300) * 64) / 64)
    store.flush_all(ingestion_time=1)
    assert store.shards[0].evict_cold_partitions(max_evict=10**9) > 0
    q = "count_over_time(heap_usage[55m])"
    got = QueryService(store, mesh=cpu_mesh(layout)).query_range(
        q, START + 3000, 60, START + 3000)
    want = QueryService(store, device="cpu").query_range(
        q, START + 3000, 60, START + 3000)
    assert got.result.num_series == 6
    np.testing.assert_array_equal(np.asarray(got.result.values)[:, 0], 300.0)
    _same(_sorted(got.result), _sorted(want.result), layout, agg=False)


@pytest.mark.parametrize("layout", ["2x2", "4x2", "4x1"])
def test_the_ring_variant_answers_as_gather_and_the_reference(layout):
    """The ring passes each time block's combine state on instead of
    gathering the blocks: the same combine in the same order, so its
    answer is the gather form's bit for bit, and the reference's ring
    variant's within its tolerance."""
    from filodb_tpu.parallel.mesh_engine import \
        MeshQueryEngine as RefMeshEngine

    q = f"sum(rate({C}[5m])) by (_ns_)"
    ring = _port("counter", q, cpu_mesh(layout), variant="ring")
    gather = _port("counter", q, cpu_mesh(layout))
    assert ring[0] == gather[0]
    assert ring[1].tobytes() == gather[1].tobytes()
    ref, _ = _stores("counter")
    rsvc = RefService(ref, DS, NUM_SHARDS, spread=1, engine="mesh")
    rsvc.mesh_engine = RefMeshEngine(variant="ring")
    want = rsvc.query_range(q, *_range("counter")).result
    want.materialize()
    assert ring[0] == _sorted(want)[0]
    np.testing.assert_allclose(ring[1], _sorted(want)[1], equal_nan=True,
                               **REF_TOL)


def test_a_mesh_batch_counts_against_each_card_it_lies_on():
    """A batch's blocks count on their slots' devices; a budget too small
    for the blocks of one device drops the older entries first."""
    _, port = _stores("counter")
    svc = QueryService(port, mesh=cpu_mesh("4x1"))
    svc.query_range(f"sum(rate({C}[5m]))", *_range("counter"))
    (batch,) = svc.batches.batches("mesh")
    assert [b is not None for b in batch.blocks] == [True] * 4
    assert batch.rows == [(0, 6), (6, 12), (12, 18), (18, 24)]
    assert batch.footprint() == {torch.device("cpu"): batch.nbytes}
    assert batch.counts.tolist() == np.concatenate(
        [b.counts for b in batch.blocks]).tolist()
    assert svc.batches.used("cpu") == svc.batches.nbytes()
    svc.batches.budget = batch.nbytes + 1
    svc.query_range(f"sum(rate({C}[2m]))", *_range("counter"))
    assert svc.batches.used("cpu") <= svc.batches.budget


def test_the_default_mesh_is_every_card_and_one_slot_is_todays_engine():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_query_mesh()
    mesh = make_query_mesh(devices=["cpu"] * 8, time_axis=2)
    assert mesh.shape == (4, 2)
    assert make_query_mesh(n_devices=3, devices=["cpu"] * 8).shape == (3, 1)
    eng = QueryService(_stores("counter")[1], device="cpu").mesh
    assert len(eng.mesh) == 1 and eng.device == torch.device("cpu")
    assert eng._batch_key((), 0, 1) == ("mesh", "()", 0, 1)
    with pytest.raises(ValueError):
        mesh_engine.MeshQueryEngine(mesh=mesh, variant="tree")
    with pytest.raises(ValueError):
        make_query_mesh(devices=["cpu"] * 3, time_axis=4)


def test_layouts_of_one_device_share_a_cache_but_no_batch():
    """A 4×1 and a 2×2 over the same four slots keep a batch each in one
    ``BatchCache``, and the one-slot engine its own."""
    from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.engine.device_batch import BatchCache
    from filodb_tpu_torch.query.model import QueryStats

    _, port = _stores("counter")
    cache = BatchCache(torch.device("cpu"))
    plan = parse_query(f"sum(rate({C}[5m]))",
                       TimeStepParams(*_range("counter")))
    for mesh in (cpu_mesh("4x1"), cpu_mesh("2x2"), None):
        MeshQueryEngine(torch.device("cpu") if mesh is None else None,
                        cache, mesh=mesh).execute(port, plan, QueryStats())
    held = cache.batches("mesh")
    assert sorted(len(b.blocks) if isinstance(b, MeshBatch) else 1
                  for b in held) == [1, 2, 4]
