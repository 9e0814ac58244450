"""Two-phase aggregation pushdown in the port, against its single-phase
form and against the reference (``tests/test_agg_pushdown.py``).

The port's exec engine answers every query of ``OP_QUERIES`` with the map
stage pushed into its leaves (``agg_pushdown="always"``) as it does
without (``"off"``), at the query's ``rtol`` (2e-5, 2e-3 for stddev and
stdvar, whose sums of squares cancel), and each answer at the same rtol
as the reference's exec engine's over the same containers. The plan
shapes under ``auto``, ``always`` and ``off`` are the reference
planner's; the pushed plan crosses the wire. Over TCP (a
``PlanExecutorServer`` a test) ``auto`` pushes, ships fewer bytes, and a
lost child degrades both forms to the same partial answer. The extent
cache answers both forms from one entry.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.testing.data import (
    counter_series,
    counter_stream,
    gauge_stream,
    histogram_series,
    histogram_stream,
    machine_metrics_series,
)
from filodb_tpu_torch.coordinator import planner as planner_mod
from filodb_tpu_torch.coordinator import remote as remote_mod
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.remote import (
    PlanExecutorServer,
    RemotePlanDispatcher,
    reset_pool,
)
from filodb_tpu_torch.coordinator.wire import decode, encode
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.exec import transformers as tf
from filodb_tpu_torch.query.exec.plan import (
    DistConcatExec,
    ReduceAggregateExec,
    SelectRawPartitionsExec,
)
from filodb_tpu_torch.utils.resilience import reset_breakers
from test_torch_remote_dispatch import (
    NUM_SHARDS,
    START,
    assert_same_answer,
    executor,
    port_store,
    ref_store,
    routed,
)

QS = START + 100
QE = START + 2000
STEP = 60

# every pushdown-capable op (by, without, ungrouped), the bypass ops, and
# shapes above the aggregate (``tests/test_agg_pushdown.py:108-131``)
OP_QUERIES = [
    ("sum(heap_usage)", 2e-5),
    ("sum(heap_usage) by (host)", 2e-5),
    ("sum(rate(http_requests_total[5m])) by (job)", 2e-5),
    ("sum(heap_usage) without (host)", 2e-5),
    ("avg(heap_usage) by (host)", 2e-5),
    ("avg(heap_usage)", 2e-5),
    ("count(heap_usage) without (host)", 2e-5),
    ("count(heap_usage)", 2e-5),
    ("min(heap_usage) by (host)", 2e-5),
    ("max(heap_usage)", 2e-5),
    ("group(heap_usage) by (host)", 2e-5),
    ("stddev(heap_usage) by (host)", 2e-3),
    ("stdvar(heap_usage)", 2e-3),
    ("topk(3, heap_usage)", 2e-5),
    ("topk(2, heap_usage) by (host)", 2e-5),
    ("bottomk(2, heap_usage) by (host)", 2e-5),
    ("quantile(0.9, heap_usage) by (host)", 2e-5),
    ('count_values("v", heap_usage)', 2e-5),
    ("sum(rate(http_req_latency[5m])) by (host)", 2e-5),
    ("histogram_quantile(0.9, sum(rate(http_req_latency[5m])))", 2e-5),
    ("abs(sum(heap_usage) by (host)) * 2", 2e-5),
]


def _streams():
    return [
        gauge_stream(machine_metrics_series(10, ns="App-2"), 240,
                     start_ms=START * 1000, interval_ms=10_000, seed=11),
        counter_stream(counter_series(6, ns="App-1"), 240,
                       start_ms=START * 1000, interval_ms=10_000, seed=3,
                       reset_every=100),
        histogram_stream(histogram_series(4), 240,
                         start_ms=START * 1000, interval_ms=10_000, seed=7),
    ]


CONFIG = dict(max_chunk_size=100, groups_per_shard=4)


@pytest.fixture(scope="module")
def raws():
    return routed(_streams())


@pytest.fixture(scope="module")
def store(raws):
    return port_store(raws, StoreConfig(**CONFIG))


@pytest.fixture(scope="module")
def ref(raws):
    return RefService(ref_store(raws, CONFIG), "timeseries", NUM_SHARDS,
                      spread=1)


@pytest.fixture(scope="module")
def svc(store):
    return QueryService(store, device="cpu", engine="exec")


def _query(svc, promql, mode):
    svc.planner.agg_pushdown = mode
    try:
        return svc.query_range(promql, QS, STEP, QE)
    finally:
        svc.planner.agg_pushdown = "auto"


class TestLocalEquivalence:
    @pytest.mark.parametrize("promql,rtol", OP_QUERIES)
    def test_pushed_matches_unpushed_and_the_reference(self, svc, ref,
                                                       promql, rtol):
        unpushed = _query(svc, promql, "off")
        pushed = _query(svc, promql, "always")
        assert_same_answer(pushed, unpushed, rtol)
        ref.planner.agg_pushdown = "off"
        want = ref.query_range(promql, QS, STEP, QE)
        assert_same_answer(pushed, want, rtol)
        assert_same_answer(unpushed, want, rtol)


class TestPlanShapes:
    def _materialize(self, mode, dispatcher_for_shard=None,
                     promql="sum(heap_usage) by (host)"):
        pl = SingleClusterPlanner(NUM_SHARDS, spread=1,
                                  dispatcher_for_shard=dispatcher_for_shard,
                                  agg_pushdown=mode)
        return pl.materialize(parse_query(promql,
                                          TimeStepParams(QS, STEP, QE)))

    def test_always_pushes_map_stage_into_leaves(self):
        ep = self._materialize("always")
        assert isinstance(ep, ReduceAggregateExec) and ep.pushdown
        assert len(ep.children_plans) == NUM_SHARDS
        for leaf in ep.children_plans:
            assert isinstance(leaf, SelectRawPartitionsExec)
            assert isinstance(leaf.transformers[-1],
                              tf.AggregatePartialMapper)

    def test_auto_all_local_bypasses(self):
        ep = self._materialize("auto")
        assert isinstance(ep, ReduceAggregateExec) and not ep.pushdown
        assert isinstance(ep.children_plans[0], DistConcatExec)

    def test_auto_remote_pushes(self):
        disp = RemotePlanDispatcher("127.0.0.1", 65000)
        assert self._materialize("auto", lambda s: disp).pushdown

    def test_off_never_pushes(self):
        disp = RemotePlanDispatcher("127.0.0.1", 65000)
        assert not self._materialize("off", lambda s: disp).pushdown

    @pytest.mark.parametrize("promql", [
        "quantile(0.9, heap_usage) by (host)",
        'count_values("v", heap_usage)',
    ])
    def test_bypass_ops_never_push(self, promql):
        ep = self._materialize("always", promql=promql)
        assert isinstance(ep, ReduceAggregateExec) and not ep.pushdown

    def test_decision_counters_move(self):
        a0 = planner_mod.PUSHDOWN_APPLIED.value
        b0 = planner_mod.PUSHDOWN_BYPASSED.value
        self._materialize("always")
        self._materialize("off")
        assert planner_mod.PUSHDOWN_APPLIED.value == a0 + 1
        assert planner_mod.PUSHDOWN_BYPASSED.value == b0 + 1

    def test_pushdown_plan_round_trips_on_wire(self):
        rt = decode(encode(self._materialize("always")))
        assert isinstance(rt, ReduceAggregateExec) and rt.pushdown
        mapper = rt.children_plans[0].transformers[-1]
        assert isinstance(mapper, tf.AggregatePartialMapper)
        assert (mapper.op, mapper.by) == ("sum", ("host",))

    def test_an_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="agg_pushdown"):
            self._materialize("sometimes")

    def test_the_pushdown_site_settles_with_the_query(self, svc):
        from filodb_tpu_torch.query import cost_model as cm

        model = cm.model_for(svc.dataset)
        before = cm._settled["pushdown"].value
        _query(svc, "sum(heap_usage) by (host)", "auto")
        assert cm._settled["pushdown"].value == before + 1
        assert model.samples("pushdown", "agg:sum:leaves4:local",
                             "local") >= 1


class TestRemoteDispatch:
    @pytest.fixture()
    def remote_svc(self, store):
        reset_breakers()
        reset_pool()
        srv = executor(store)
        disp = RemotePlanDispatcher("127.0.0.1", srv.port)
        svc = QueryService(store, device="cpu", engine="exec")
        svc.planner.dispatcher_for_shard = lambda s: disp
        yield svc
        srv.stop()
        reset_pool()

    @pytest.mark.parametrize("promql,rtol", [
        ("sum(heap_usage) by (host)", 2e-5),
        ("avg(rate(http_requests_total[5m])) by (job)", 2e-5),
        ("stddev(heap_usage)", 2e-3),
        ("topk(2, heap_usage) by (host)", 2e-5),
        ("sum(rate(http_req_latency[5m])) by (host)", 2e-5),
    ])
    def test_remote_pushdown_equivalence(self, remote_svc, ref, promql,
                                         rtol):
        unpushed = _query(remote_svc, promql, "off")
        pushed = _query(remote_svc, promql, "auto")  # remote: auto pushes
        assert_same_answer(pushed, unpushed, rtol)
        ref.planner.agg_pushdown = "off"
        assert_same_answer(pushed, ref.query_range(promql, QS, STEP, QE),
                           rtol)
        assert pushed.stats.wire_bytes > 0

    def test_pushdown_ships_fewer_bytes(self, remote_svc):
        def received(mode):
            before = remote_mod.BYTES_RECEIVED.value
            r = _query(remote_svc, "sum(heap_usage) by (host)", mode)
            return remote_mod.BYTES_RECEIVED.value - before, r

        (off, r_off), (on, r_on) = received("off"), received("auto")
        assert 0 < on < off
        assert 0 < r_on.stats.wire_bytes < r_off.stats.wire_bytes

    def test_lost_child_partial_equivalence(self, store):
        reset_breakers()
        reset_pool()
        srv = executor(store)
        live = RemotePlanDispatcher("127.0.0.1", srv.port)
        with socket.socket() as s:  # a port nothing listens on
            s.bind(("127.0.0.1", 0))
            dead_port = s.getsockname()[1]
        dead = RemotePlanDispatcher("127.0.0.1", dead_port, timeout=2.0)
        svc = QueryService(store, device="cpu", engine="exec")
        svc.planner.dispatcher_for_shard = \
            lambda sh: dead if sh == 3 else live
        try:
            unpushed = _query(svc, "sum(heap_usage) by (host)", "off")
            reset_breakers()
            pushed = _query(svc, "sum(heap_usage) by (host)", "auto")
        finally:
            srv.stop()
            reset_pool()
            reset_breakers()
        assert unpushed.partial and pushed.partial
        assert any("shards [3]" in w for w in pushed.warnings)
        assert any("shards [3]" in w for w in unpushed.warnings)
        assert_same_answer(unpushed, pushed, 2e-5)


    def test_a_root_kernel_that_fails_to_load_raises_never_partial(
            self, store, tmp_path, monkeypatch):
        """Two nodes, each owning one of the two shards that hold the
        query's series: the root runs its own leaf on the calling thread. A kernel library that
        does not load there fails the query, pushed or not; no partial
        answer of the member's half hides it (only a lost transport is
        partial)."""
        import threading

        from filodb_tpu_torch import _build

        # the decode lane, which launches B3 (summaries answer rate
        # without a kernel)
        monkeypatch.setenv("FILODB_SIDECARS", "0")
        reset_breakers()
        reset_pool()
        srv = executor(store)
        member = RemotePlanDispatcher("127.0.0.1", srv.port)
        promql = "sum(rate(http_requests_total[5m])) by (job)"
        root_shard, member_shard = [
            s for s, shard in enumerate(store.shards)
            if "http_requests_total" in shard.label_values("_metric_")]
        svc = QueryService(store, device="cpu", engine="exec")
        svc.planner.dispatcher_for_shard = \
            lambda sh: None if sh == root_shard else member
        bad = tmp_path / "libfused_rate.so"
        bad.write_bytes(b"not a shared object")
        root, plain = threading.get_ident(), tf.fused_decode_rate

        def launch(*args, **kw):
            if threading.get_ident() == root:  # the root's leaves load B3
                _build.bind("fused_rate", "fused_decode_rate", 19)
            return plain(*args, **kw)

        try:
            whole = _query(svc, promql, "auto")
            assert not whole.partial and whole.result.num_series > 0
            monkeypatch.setattr(_build, "_libs", {})
            monkeypatch.setattr(_build, "_target", lambda name: bad)
            monkeypatch.setattr(tf, "fused_decode_rate", launch)
            for mode in ("auto", "off"):
                with pytest.raises(RuntimeError, match="fused_rate"):
                    _query(svc, promql, mode)
        finally:
            srv.stop()
            reset_pool()
            reset_breakers()


class TestResultCacheAcrossPlanForms:
    def test_pushed_and_unpushed_hit_the_same_entries(self, store):
        from filodb_tpu_torch.query import result_cache as rc

        svc = QueryService(store, device="cpu", engine="exec",
                           result_cache={"extent_steps": 7})
        promql = "sum(rate(http_requests_total[5m])) by (job)"
        unpushed = _query(svc, promql, "off")
        hits = rc.cache_hits.value
        pushed = _query(svc, promql, "always")
        assert rc.cache_hits.value > hits
        assert_same_answer(unpushed, pushed, 2e-5)


def test_the_folder_holds_a_groups_rows_not_a_series():
    """Two children's partial rows fold into one row a group, and avg
    comes from its components in float64."""
    import torch

    from filodb_tpu_torch.query.model import RangeVectorKey, StepMatrix

    def child(vals, hosts):
        keys = [RangeVectorKey((("host", h), ("i", str(i))))
                for i, h in enumerate(hosts)]
        m = StepMatrix(keys, torch.tensor(vals, dtype=torch.float64),
                       np.arange(2, dtype=np.int64))
        return tf.AggregatePartialMapper("avg", (), ("host",)).apply(m)

    folder = tf.PartialAggregateFolder("avg", (), ("host",))
    folder.fold(child([[1.0, 2.0], [3.0, np.nan]], ["a", "b"]))
    folder.fold(child([[5.0, 6.0]], ["a"]))
    out = folder.finalize()
    got = {k.label_map["host"]: v.tolist()
           for k, v in zip(out.keys, out.values)}
    assert got == {"a": [3.0, 4.0], "b": [3.0, pytest.approx(np.nan,
                                                             nan_ok=True)]}
