"""Port parity for the exec engine: the planner's plan tree, the exec
plans' answers, and the routing from the mesh engine.

- ``SingleClusterPlanner`` gives the reference planner's tree (two-phase
  pushdown off, as the reference's static arm is for in-process leaves)
  for every query of ``TREE_QUERIES`` at spread 0, 1 and 2 and with a time
  split: node kinds in tree order, each leaf's shard and data range, and
  each node's transformers.
- ``QueryService(port, engine="exec", device="cpu")`` answers as the
  reference's exec engine does, ``rtol=2e-5, atol=1e-6`` on the slice
  store (``test_torch_slice``; the promql, plan-shape and slice suites run
  their queries through both of the port's engines as well), a time split
  included; per-series answers are bitwise equal between the port's two
  engines, which launch the same kernels on the same series.
- Only ``UnsupportedQuery`` sends a plan from mesh to exec; the stats
  name the engine that answered and why mesh handed it on.
"""

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import SingleClusterPlanner as RefPlanner
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.exec.plan import SelectRawPartitionsExec, leaves
from filodb_tpu_torch.query.model import UnsupportedQuery
from test_torch_slice import (
    DS,
    NUM_SHARDS,
    Q_END,
    Q_START,
    Q_STEP,
    Valved,
    _build_stores,
    _series_specs,
    _sorted,
)

TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
M = "http_requests_total"
SK = '_ws_="demo",_ns_="App-0"'
TREE_QUERIES = (
    f"sum(rate({M}[5m])) by (job)",
    f"rate({M}{{{SK}}}[5m])",                       # prunes by shard key
    f"sum(count_over_time({M}{{{SK},job=\"job-1\"}}[5m]))",
    f"{M} offset 1m",
    f"sum_over_time(queue_depth[10m])",
    f"max_over_time(sum(rate({M}[5m])) by (_ns_)[30m:1m])",
    f"scalar(sum(rate({M}[5m])))",
    f"{M} * time()",
    "vector(1) + 1",
    "1 + 2 * 3",
    "time()",
    f"rate({M}[5m]) / on (job) group_left sum(rate({M}[5m])) by (job)",
    f"{M} and {M}{{job=\"job-1\"}}",
    f"absent(nope{{{SK}}})",
    f"topk(3, rate({M}[5m]))",
    f'label_replace(sort_desc(sum(rate({M}[5m])) by (job)), "j", "$1", '
    f'"job", "job-(.*)")',
    f"limit(2, {M})",
    "histogram_quantile(0.9, sum(rate(lat[5m])) by (le))",
    f"rate({M}[5m] @ {Q_END})",
    "lat::sum",
    f'count_values("v", {M})',
)


def _tree(plan, leaf_type) -> list:
    """(depth, node kind, (shard, data range) of a leaf, transformers) in
    tree order."""
    out = []

    def walk(node, depth):
        leaf = (node.shard, node.chunk_start, node.chunk_end) \
            if isinstance(node, leaf_type) else ()
        out.append((depth, type(node).__name__, leaf,
                    tuple(type(t).__name__ for t in node.transformers)))
        for c in node.children():
            walk(c, depth + 1)

    walk(plan, 0)
    return out


@pytest.mark.parametrize("split", [0, 600_000])
@pytest.mark.parametrize("spread", [0, 1, 2])
@pytest.mark.parametrize("q", TREE_QUERIES)
def test_planner_gives_the_reference_tree(q, spread, split):
    from filodb_tpu.query.exec.plan import (
        SelectRawPartitionsExec as RefLeaf,
    )

    ref = RefPlanner(DS, NUM_SHARDS, spread, time_split_ms=split,
                     agg_pushdown="off")
    port = SingleClusterPlanner(NUM_SHARDS, spread, time_split_ms=split)
    want = _tree(ref.materialize(ref_parse(
        q, RefParams(Q_START, Q_STEP, Q_END))), RefLeaf)
    got = _tree(port.materialize(parse_query(
        q, TimeStepParams(Q_START, Q_STEP, Q_END))), SelectRawPartitionsExec)
    assert got == want
    if split and "[" in q and not any(x in q for x in ("@", ":", "scalar(")):
        assert any(kind == "StitchRvsExec" for _, kind, _, _ in got), q


def test_full_shard_key_filters_prune_shards():
    port = SingleClusterPlanner(NUM_SHARDS, 1)
    plan = port.materialize(parse_query(f"rate({M}{{{SK}}}[5m])",
                                        TimeStepParams(Q_START, Q_STEP,
                                                       Q_END)))
    assert len({leaf.shard for leaf in leaves(plan)}) == 2
    wide = port.materialize(parse_query(f"rate({M}[5m])", TimeStepParams(
        Q_START, Q_STEP, Q_END)))
    assert [leaf.shard for leaf in leaves(wide)] == list(range(NUM_SHARDS))


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), 64)


@pytest.fixture(scope="module")
def engines(stores):
    ref, port = stores
    return (Valved(RefService(ref, DS, NUM_SHARDS, spread=1, engine="exec"),
                   "0"),
            QueryService(port, device="cpu", engine="exec"),
            QueryService(port, device="cpu"))


@pytest.mark.parametrize("q", [
    f"sum(rate({M}[5m])) by (job)",
    f"rate({M}{{{SK}}}[5m])",
    f"sum(count_over_time({M}[5m])) by (_ns_)",
    f"avg(delta(queue_depth[2m]))",
    f"{M}",
])
def test_time_split_stitches_as_exec(stores, q):
    """A 10-minute split of the 30-minute range: ``StitchRvsExec`` over
    three sub-plans, against the reference's exec engine split alike."""
    ref, port = stores
    svc = QueryService(port, device="cpu", engine="exec",
                       time_split_ms=600_000)
    want = Valved(RefService(ref, DS, NUM_SHARDS, spread=1, engine="exec",
                             time_split_ms=600_000), "0").query_range(
        q, Q_START, Q_STEP, Q_END)
    want.result.materialize()
    got = svc.query_range(q, Q_START, Q_STEP, Q_END)
    gk, gv = _sorted(got)
    wk, wv = _sorted(want)
    assert gk == wk and len(gk) > 0
    assert gv.shape == wv.shape == (len(gk), 31)
    np.testing.assert_allclose(gv, wv, **TOL)


@pytest.mark.parametrize("q", [
    f'rate({M}{{_ns_="App-0"}}[5m])',
    f"count_over_time({M}[5m])",
    f"max_over_time(queue_depth[5m])",
    f"{M}",
])
def test_engines_agree_bitwise_per_series(engines, q, monkeypatch):
    """The same kernel over the same series: the port's exec and mesh
    engines give the same bits (exec's decode lane: the sidecar lane folds
    summaries, ``tests/test_torch_sidecars.py``)."""
    monkeypatch.setenv("FILODB_SIDECARS", "0")
    _, exec_, mesh = engines
    a, b = exec_.query_range(q, Q_START, Q_STEP, Q_END), \
        mesh.query_range(q, Q_START, Q_STEP, Q_END)
    assert (a.stats.engine, b.stats.engine) == ("exec", "mesh")
    ak, av = _sorted(a)
    bk, bv = _sorted(b)
    assert ak == bk and len(ak) > 0
    np.testing.assert_array_equal(av, bv)


def test_only_unsupported_query_routes(engines, monkeypatch):
    ref, _, mesh = engines
    q = f"sum(rate({M}[5m])) by (job)"

    def unsupported(*a):
        raise UnsupportedQuery("not this one")

    monkeypatch.setattr(mesh.mesh, "execute", unsupported)
    res = mesh.query_range(q, Q_START, Q_STEP, Q_END)
    assert (res.stats.engine, res.stats.fallback) == ("exec", "not this one")
    want = ref.query_range(q, Q_START, Q_STEP, Q_END)
    want.result.materialize()
    np.testing.assert_allclose(_sorted(res)[1], _sorted(want)[1], **TOL)

    def broken(*a):
        raise RuntimeError("a fault in the mesh engine")

    monkeypatch.setattr(mesh.mesh, "execute", broken)
    with pytest.raises(RuntimeError, match="a fault in the mesh engine"):
        mesh.query_range(q, Q_START, Q_STEP, Q_END)


def test_stats_name_the_engine(engines):
    _, exec_, mesh = engines
    q = f"sum(rate({M}[5m])) by (job)"
    assert (mesh.query_range(q, Q_START, Q_STEP, Q_END).stats.engine,
            exec_.query_range(q, Q_START, Q_STEP, Q_END).stats.engine) == \
        ("mesh", "exec")
    res = mesh.query_range(f"{M}::sum", Q_START, Q_STEP, Q_END)
    assert res.stats.engine == "exec" and "RawSeries" in res.stats.fallback
    with pytest.raises(ValueError, match="engine"):
        QueryService(mesh.memstore, device="cpu", engine="fused")


def test_leaf_batches_are_cached_per_shard_until_it_ingests(stores,
                                                            monkeypatch):
    from filodb_tpu_torch.query.exec import plan as plan_mod

    monkeypatch.setenv("FILODB_SIDECARS", "0")  # the leaves' decode lane
    ref, port = stores
    built = []
    real = plan_mod.build_device_batch
    monkeypatch.setattr(plan_mod, "build_device_batch",
                        lambda sel, *a: built.append(sel[0][0].shard_num)
                        or real(sel, *a))
    svc = QueryService(port, device="cpu", engine="exec")
    q = f"sum(rate({M}[5m])) by (job)"
    first = svc.query_range(q, Q_START, Q_STEP, Q_END)
    assert sorted(built) == [0, 1, 2, 3]
    svc.query_range(q, Q_START, Q_STEP, Q_END)
    assert len(built) == 4
    # an empty ingest on one shard moves its version only
    port.shards[2].version += 1
    again = svc.query_range(q, Q_START, Q_STEP, Q_END)
    assert built[4:] == [2]
    np.testing.assert_array_equal(_sorted(first)[1], _sorted(again)[1])
    assert svc.batches.nbytes("exec") > 0


def test_both_engines_keep_batches_under_one_budget(stores, monkeypatch):
    """The mesh engine's batches and the exec leaves' live in the
    service's one ``BatchCache``: past its budget the least recently used
    batch goes first. (The window cache's entries count against the same
    budget; ``tests/test_torch_window_cache.py`` holds them to it, so it
    is off here, where the batches alone are weighed.)"""
    monkeypatch.setenv("FILODB_MESH_SPLIT", "0")
    _, port = stores
    mesh_q, exec_q = f"rate({M}[5m])", f"{M}::sum"   # a column: exec
    svc = QueryService(port, device="cpu")
    assert svc.query_range(mesh_q, Q_START, Q_STEP, Q_END).stats.engine \
        == "mesh"
    one = svc.batches.nbytes("mesh")
    assert svc.query_range(exec_q, Q_START, Q_STEP, Q_END).stats.engine \
        == "exec"
    assert one > 0 and svc.batches.nbytes() > one
    small = QueryService(port, device="cpu")
    small.batches.budget = one
    small.query_range(mesh_q, Q_START, Q_STEP, Q_END)
    assert small.batches.nbytes("mesh") == one
    small.query_range(exec_q, Q_START, Q_STEP, Q_END)
    assert small.batches.nbytes("mesh") == 0
    assert small.batches.nbytes() <= one \
        or len(small.batches.batches()) == 1


def test_a_batch_leaves_the_cache_when_its_owner_ingests(stores,
                                                         monkeypatch):
    """A mesh batch belongs to the store, an exec leaf's to its shard:
    once the owner's version moves, the next batch put drops it."""
    monkeypatch.setenv("FILODB_SIDECARS", "0")  # the leaves' decode lane
    _, port = stores
    svc = QueryService(port, device="cpu")
    svc.query_range(f"rate({M}[5m])", Q_START, Q_STEP, Q_END)
    assert svc.batches.nbytes("mesh") > 0
    port.shards[1].version += 1    # an empty ingest on one shard
    svc.query_range(f"{M}::sum", Q_START, Q_STEP, Q_END)
    assert svc.batches.nbytes("mesh") == 0
    assert len(svc.batches.batches("exec")) == NUM_SHARDS


def test_group_ids_live_with_their_service(stores):
    """Each service holds its group ids, which its two engines share; the
    oldest entry goes past the cap."""
    from filodb_tpu_torch.query.exec.transformers import (
        AggregateMapReduce,
        GroupIdCache,
    )

    _, port = stores
    a = QueryService(port, device="cpu")
    b = QueryService(port, device="cpu", engine="exec")
    assert a.mesh.gids is a.gids and a.gids is not b.gids
    q = f"sum(rate({M}[5m])) by (job)"
    a.query_range(q, Q_START, Q_STEP, Q_END)
    assert len(a.gids) == 1 and len(b.gids) == 0
    b.query_range(q, Q_START, Q_STEP, Q_END)
    assert len(b.gids) == NUM_SHARDS   # a key list a shard's leaf
    cache = GroupIdCache(cap=2)
    amr = AggregateMapReduce("sum", by=("job",))
    lists = [list(port.shards[i].keys[:3]) for i in range(3)]
    for keys in lists:
        cache.keys_group_ids(amr, [k.range_vector_key for k in keys],
                             torch.device("cpu"))
    assert len(cache) == 2


def test_a_shard_without_the_selector_answers_nothing(engines):
    """A leaf whose shard holds no matching series answers the empty
    matrix and skips its transformers, as the reference's leaf does; the
    other shards' series still answer."""
    ref, exec_, _ = engines
    q = f'sum(rate({M}{{instance="instance-1"}}[5m]))'
    got = exec_.query_range(q, Q_START, Q_STEP, Q_END)
    want = ref.query_range(q, Q_START, Q_STEP, Q_END)
    want.result.materialize()
    assert got.result.num_series == want.result.num_series == 1
    np.testing.assert_allclose(got.result.values, want.result.values, **TOL)


@pytest.mark.parametrize("q", [
    '{_ns_="App-1"}',
    'delta({job="job-1"}[5m])',
    'count({instance=~"instance-(1|2)."}) by (_metric_)',
])
def test_leaves_batch_each_schema_apart(engines, q):
    """A selector over counters and gauges: each leaf batches each schema
    apart, so delta corrects the counters' resets only, as the
    reference's exec engine does."""
    ref, exec_, _ = engines
    got = exec_.query_range(q, Q_START, Q_STEP, Q_END)
    want = ref.query_range(q, Q_START, Q_STEP, Q_END)
    want.result.materialize()
    gk, gv = _sorted(got)
    wk, wv = _sorted(want)
    assert gk == wk and len(gk) > 0
    if "delta" not in q:   # both schemas answer
        assert all(any(m in k for k in gk)
                   for m in ("http_requests_total", "queue_depth"))
    np.testing.assert_allclose(gv, wv, **TOL)
