"""Exec plans shipped between processes: the port's ``PlanExecutorServer``
and ``RemotePlanDispatcher.dispatch``, partial scatter-gather, the
breakers and retries on dispatch, and the distributed span tree.

Mirrors ``tests/test_fault_injection.py:106-245`` (a gather loses a child
below the threshold as a partial answer whose warning names its shards,
fails above it or with ``allow_partial`` off, never takes a deadline as
partial; an open breaker's peer is skipped without a dial; retries on a
stale pooled socket) and ``tests/test_tracing_distributed.py:84-175`` (one
span tree with node-tagged remote children; stats alike local and
remote, ``wire_bytes`` remote only). Plans cross between the packages'
executors in both directions, each answer equal to the executing
server's own. The stores are built from the reference's seeded
generators (``filodb_tpu/testing/data.py``), routed by the reference and
fed to both packages as the same container bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from filodb_tpu.coordinator import remote as ref_remote
from filodb_tpu.coordinator.ingestion import route_container as ref_route
from filodb_tpu.coordinator.planner import SingleClusterPlanner as RefPlanner
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.record import BytesContainer as RefBytes
from filodb_tpu.core.record import SomeData as RefSomeData
from filodb_tpu.core.store.config import StoreConfig as RefStoreConfig
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query.exec.plan import ExecContext as RefExecContext
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.remote import (
    PlanExecutorServer,
    RemotePlanDispatcher,
    _pool,
    reset_pool,
)
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer, SomeData
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.exec.plan import (
    ExecContext,
    SelectRawPartitionsExec,
    leaves,
    run_plan,
)
from filodb_tpu_torch.query.model import QueryResult, RangeVectorKey
from filodb_tpu_torch.utils import resilience, tracing
from filodb_tpu_torch.utils.governor import QueryRejected
from filodb_tpu_torch.utils.resilience import (
    CircuitOpenError,
    Deadline,
    DeadlineExceeded,
    FaultInjector,
    ResilienceConfig,
    breaker_for,
    reset_breakers,
)

START = 1_600_000_000
NUM_SHARDS = 4
DS = "timeseries"


# ---- stores of both packages from the same containers ----------------------


def routed(streams, num_shards: int = NUM_SHARDS,
           spread: int = 1) -> dict[int, list[bytes]]:
    """The reference's streams routed to shards as the gateway routes
    them, each shard's containers serialized, in order."""
    out: dict[int, list[bytes]] = {s: [] for s in range(num_shards)}
    for stream in streams:
        for sd in stream:
            for s, c in ref_route(sd.container, num_shards, spread).items():
                out[s].append(c.serialize())
    return out


def port_store(raws: dict, config: StoreConfig | None = None,
               spread: int = 1) -> MemStore:
    ms = MemStore(len(raws), spread, config=config, dataset=DS)
    for s, containers in raws.items():
        for off, raw in enumerate(containers):
            ms.shards[s].ingest(SomeData(BytesContainer(raw), off))
    return ms


def executor(store: MemStore, **kw) -> PlanExecutorServer:
    """A started executor port serving ``store`` through an exec service
    of its own, on the CPU."""
    svc = QueryService(store, device="cpu", engine="exec")
    return PlanExecutorServer({svc.dataset: svc}, **kw).start()


def ref_store(raws: dict, config: dict) -> TimeSeriesMemStore:
    ms = TimeSeriesMemStore()
    for s, containers in raws.items():
        ms.setup(DS, s, RefStoreConfig(**config))
        for off, raw in enumerate(containers):
            ms.ingest(DS, s, RefSomeData(RefBytes(raw), off))
    return ms


def _rows(result) -> dict:
    m = result.result if hasattr(result, "result") else result
    m.materialize()
    return {tuple(k.labels): np.asarray(m.values[i])
            for i, k in enumerate(m.keys)}


def assert_same_answer(got, want, rtol: float) -> None:
    """Two answers (``QueryResult`` or ``StepMatrix``, of either package)
    hold the same series, NaN where the other has NaN, equal at ``rtol``
    (atol 1e-9), whatever their row order."""
    a, b = _rows(got), _rows(want)
    assert set(a) == set(b), set(a) ^ set(b)
    for k, x in a.items():
        y = b[k]
        assert np.array_equal(np.isnan(x), np.isnan(y)), k
        np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-9,
                                   equal_nan=True, err_msg=str(k))


# ---- scatter-gather over four executors -------------------------------------


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _clean():
    FaultInjector.reset()
    reset_breakers()
    reset_pool()
    # fail fast: no backoff sleeps
    resilience.configure(retry_max_attempts=1, retry_base_backoff_s=0.0,
                         retry_max_backoff_s=0.0)
    yield
    FaultInjector.reset()
    reset_breakers()
    reset_pool()
    resilience._config.__dict__.update(ResilienceConfig().__dict__)


GAUGES = dict(max_chunk_size=60)


@pytest.fixture(scope="module")
def gauge_raws():
    return routed([gauge_stream(machine_metrics_series(8), 120,
                                start_ms=START * 1000)], spread=2)


@pytest.fixture(scope="module")
def gauge_store(gauge_raws):
    return port_store(gauge_raws, StoreConfig(**GAUGES), spread=2)


@pytest.fixture
def scatter_env(gauge_store):
    """Four executors (one a shard) over one store; the planner ships each
    shard's leaf to its own executor."""
    servers = [executor(gauge_store)
               for _ in range(NUM_SHARDS)]
    disps = {s: RemotePlanDispatcher("127.0.0.1", servers[s].port,
                                     timeout=2.0)
             for s in range(NUM_SHARDS)}
    planner = SingleClusterPlanner(NUM_SHARDS, spread=2,
                                   dispatcher_for_shard=lambda s: disps[s])
    yield servers, disps, planner
    for srv in servers:
        srv.stop()


def _materialize(planner):
    return planner.materialize(parse_query(
        "sum(heap_usage)", TimeStepParams(START + 300, 60, START + 1000)))


def _execute(ep, deadline=None):
    """(answer, context) of a root run in this process."""
    ctx = ExecContext(None, dataset=DS,
                      deadline=deadline or Deadline.after(30.0))
    return run_plan(ep, ctx), ctx


def _leaf():
    return SelectRawPartitionsExec(shard=0, filters=(), chunk_start=0,
                                   chunk_end=1)


class TestPartialScatterGather:
    def test_all_executors_up_is_complete(self, scatter_env, gauge_store):
        _, _, planner = scatter_env
        data, ctx = _execute(_materialize(planner))
        assert not ctx.partial and ctx.warnings == []
        assert data.num_series == 1
        local = QueryService(gauge_store, device="cpu", engine="exec")
        assert_same_answer(data, local.query_range(
            "sum(heap_usage)", START + 300, 60, START + 1000), 1e-12)

    def test_one_killed_executor_yields_partial(self, scatter_env):
        servers, _, planner = scatter_env
        servers[2].stop()  # shard 2's executor dies before the scatter
        data, ctx = _execute(_materialize(planner))
        assert ctx.partial and len(ctx.warnings) == 1
        assert "shards [2]" in ctx.warnings[0]
        assert data.num_series == 1  # 3 of 4 shards still answer

    def test_failures_above_threshold_fail_query(self, scatter_env):
        servers, _, planner = scatter_env
        for s in (0, 1, 3):
            servers[s].stop()  # 3 of 4 lost > the 0.5 threshold
        with pytest.raises(ConnectionError,
                           match="scatter-gather children failed"):
            _execute(_materialize(planner))

    def test_allow_partial_off_fails_on_first_loss(self, scatter_env):
        servers, _, planner = scatter_env
        servers[2].stop()
        resilience.configure(allow_partial=False)
        with pytest.raises((ConnectionError, OSError)):
            _execute(_materialize(planner))

    def test_the_querys_planner_params_override_the_config(self,
                                                          scatter_env):
        servers, _, planner = scatter_env
        servers[2].stop()
        ep = _materialize(planner)
        ctx = ExecContext(None, dataset=DS)
        ctx.qcontext.planner_params.allow_partial = False
        with pytest.raises((ConnectionError, OSError)):
            run_plan(ep, ctx)
        ctx = ExecContext(None, dataset=DS)
        ctx.qcontext.planner_params.max_partial_fraction = 0.1
        with pytest.raises(ConnectionError, match="partial threshold 0.1"):
            run_plan(ep, ctx)

    def test_injected_child_fault_names_shard(self, scatter_env):
        _, _, planner = scatter_env
        FaultInjector.arm("gather.child", error=ConnectionError, times=1,
                          match=lambda ctx: ctx["shards"] == [1])
        _, ctx = _execute(_materialize(planner))
        assert ctx.partial and "shards [1]" in ctx.warnings[0]

    def test_deadline_exceeded_is_never_partial(self, scatter_env):
        _, _, planner = scatter_env
        clk = FakeClock()
        # one slow child burns the whole deadline: the query fails with a
        # timeout, never a partial answer
        FaultInjector.arm("gather.child", delay_s=100.0, times=1,
                          sleep=clk.advance,
                          match=lambda ctx: ctx["shards"] == [0])
        with pytest.raises(DeadlineExceeded):
            _execute(_materialize(planner),
                     Deadline.after(30.0, clock=clk.now))

    def test_a_remote_error_is_never_partial(self, scatter_env):
        _, disps, planner = scatter_env
        ep = _materialize(planner)
        bad = leaves(ep)[2]
        bad.shard = 9  # the executor has no shard 9: its error stands
        with pytest.raises(RuntimeError, match="remote execution failed"):
            _execute(ep)


class TestBreakerIntegration:
    def test_open_breaker_peer_is_skipped(self, scatter_env):
        _, disps, planner = scatter_env
        breaker_for(disps[3].peer).force_open()
        _, ctx = _execute(_materialize(planner))
        assert ctx.partial
        assert "CircuitOpenError" in ctx.warnings[0]
        assert "shards [3]" in ctx.warnings[0]

    def test_repeated_failures_open_breaker(self, scatter_env):
        servers, disps, planner = scatter_env
        resilience.configure(breaker_failure_threshold=2)
        servers[1].stop()
        ep = _materialize(planner)
        _execute(ep)  # the peer's failure 1
        _execute(ep)  # failure 2: the breaker opens
        assert breaker_for(disps[1].peer).is_open
        fault = FaultInjector.arm("remote.dispatch")  # counts, no error
        _, ctx = _execute(ep)
        assert ctx.partial
        assert fault.fired == NUM_SHARDS - 1  # all but the open peer

    def test_dispatch_to_open_breaker_raises_without_dial(self):
        disp = RemotePlanDispatcher("127.0.0.1", 1)  # nothing listens
        breaker_for(disp.peer).force_open()
        connects = FaultInjector.arm("remote.connect")
        with pytest.raises(CircuitOpenError):
            disp.dispatch(_leaf(), ExecContext(None, dataset=DS))
        assert connects.fired == 0

    def test_deadline_expiry_is_not_a_breaker_failure(self):
        resilience.configure(breaker_failure_threshold=1)
        disp = RemotePlanDispatcher("127.0.0.1", 1)
        clk = FakeClock()
        ctx = ExecContext(None, dataset=DS,
                          deadline=Deadline.after(1.0, clock=clk.now))
        clk.advance(2.0)
        with pytest.raises(DeadlineExceeded):
            disp.dispatch(_leaf(), ctx)
        assert breaker_for(disp.peer).state == "closed"


class TestRetryBehavior:
    def test_retry_exhausts_budget_and_fails(self):
        resilience.configure(retry_max_attempts=3)
        before = resilience._retries_total.value
        fault = FaultInjector.arm("remote.dispatch", error=ConnectionError)
        disp = RemotePlanDispatcher("127.0.0.1", 1)
        with pytest.raises(ConnectionError):
            disp.dispatch(_leaf(), ExecContext(None, dataset=DS))
        assert fault.fired == 3  # the first attempt and 2 retries
        assert resilience._retries_total.value == before + 2

    def test_stale_pooled_socket_retries_on_fresh_connection(self,
                                                             scatter_env):
        _, disps, planner = scatter_env
        resilience.configure(retry_max_attempts=2)
        disp = disps[0]
        leaf = next(x for x in leaves(_materialize(planner))
                    if x.dispatcher is disp)
        assert disp.ping()  # pools a socket
        # the peer restarted: the pooled socket is dead, not yet noticed
        for sock in _pool._idle[(disp.host, disp.port)]:
            sock.close()
        result = disp.dispatch(leaf, ExecContext(None, dataset=DS))
        assert isinstance(result, QueryResult)
        assert result.result.num_series > 0 and result.stats.wire_bytes > 0


class TestExecutorServer:
    def test_a_shed_comes_back_as_query_rejected(self, gauge_store):
        """The executor admits under the governor: a full gate answers
        ``rejected``, which the dispatcher raises typed, and which no gather
        takes as a lost child."""
        from filodb_tpu_torch.utils import governor

        governor.configure(admission_capacity=1, max_queue_wait_s=0.01)
        srv = executor(gauge_store)
        try:
            with governor.governor().admit(cost=governor.EXPENSIVE):
                disp = RemotePlanDispatcher("127.0.0.1", srv.port)
                with pytest.raises(QueryRejected, match="shed"):
                    disp.dispatch(_leaf(), ExecContext(None, dataset=DS))
            assert breaker_for(disp.peer).state == "closed"
        finally:
            srv.stop()
            governor.reset()

    def test_plans_run_under_the_datasets_service_lock(self, gauge_store):
        """A shipped plan waits for the lock of its dataset's service: the
        port's service answers one query at a time (ROADMAP §C)."""
        import threading

        svc = QueryService(gauge_store, device="cpu", engine="exec")
        srv = PlanExecutorServer({DS: svc}).start()
        try:
            got = []
            disp = RemotePlanDispatcher("127.0.0.1", srv.port)
            leaf = leaves(_materialize(SingleClusterPlanner(
                NUM_SHARDS, spread=2)))[0]
            with svc.lock:
                t = threading.Thread(target=lambda: got.append(
                    disp.dispatch(leaf, ExecContext(None, dataset=DS))))
                t.start()
                t.join(0.5)
                assert t.is_alive() and not got  # waiting for the lock
            t.join(30)
            assert got and got[0].result.num_series > 0
        finally:
            srv.stop()

    def test_unknown_datasets_and_messages_answer_errors(self, gauge_store):
        srv = executor(gauge_store, extra_handlers={"echo": lambda x: x})
        try:
            disp = RemotePlanDispatcher("127.0.0.1", srv.port)
            assert disp.call("echo", 7) == 7
            with pytest.raises(RuntimeError, match="unknown message"):
                disp.call("nope")
            ctx = ExecContext(None, dataset="elsewhere")
            with pytest.raises(RuntimeError, match="not served here"):
                disp.dispatch(_leaf(), ctx)
        finally:
            srv.stop()


# ---- plans across the two packages -------------------------------------------


Q = "sum_over_time(heap_usage[5m])"


def _ref_leaf(dispatcher):
    ep = RefPlanner("timeseries", NUM_SHARDS, spread=2,
                    dispatcher_for_shard=lambda s: dispatcher).materialize(
        ref_parse(Q, RefParams(START + 300, 60, START + 1000)))
    return next(c for c in ep.children() if c.shard == 1)


def _port_leaf(dispatcher=None):
    ep = SingleClusterPlanner(
        NUM_SHARDS, spread=2,
        dispatcher_for_shard=lambda s: dispatcher).materialize(
        parse_query(Q, TimeStepParams(START + 300, 60, START + 1000)))
    return next(c for c in leaves(ep) if c.shard == 1)


def test_a_reference_plan_runs_on_the_ports_executor(gauge_store):
    srv = executor(gauge_store)
    try:
        disp = ref_remote.RemotePlanDispatcher("127.0.0.1", srv.port)
        got = disp.dispatch(_ref_leaf(disp), RefExecContext(None, DS))
        own = _port_leaf().execute(ExecContext(gauge_store, dataset=DS))
        assert got.result.num_series == own.num_series > 0
        assert _rows(got).keys() == _rows(own).keys()
        for k, v in _rows(got).items():
            assert v.tobytes() == _rows(own)[k].tobytes()
        assert got.stats.series_scanned > 0 and got.stats.wire_bytes > 0
    finally:
        srv.stop()
        ref_remote.reset_pool()


def test_a_port_plan_runs_on_the_references_executor(gauge_raws):
    store = ref_store(gauge_raws, GAUGES)
    srv = ref_remote.PlanExecutorServer(store).start()
    try:
        disp = RemotePlanDispatcher("127.0.0.1", srv.port)
        got = disp.dispatch(_port_leaf(disp), ExecContext(None, dataset=DS))
        own = _ref_leaf(None).execute(RefExecContext(store, DS))
        assert isinstance(got, QueryResult)
        assert all(isinstance(k, RangeVectorKey) for k in got.result.keys)
        own_rows = _rows(own)
        assert _rows(got).keys() == own_rows.keys() and own_rows
        for k, v in _rows(got).items():
            assert v.tobytes() == own_rows[k].tobytes()
        assert got.stats.wire_bytes > 0
    finally:
        srv.stop()


# ---- one span tree across the peers ------------------------------------------


PROMQL = 'sum(rate(heap_usage{_ns_="App-0"}[5m])) by (host)'


@pytest.fixture(autouse=True)
def _restore_tracing():
    prev = dataclasses.asdict(tracing.config())
    yield
    tracing.configure(**prev)
    tracing.flight_recorder().clear()


@pytest.fixture()
def two_peers(gauge_store):
    srv_a = executor(gauge_store)
    srv_b = executor(gauge_store)
    disp_a = RemotePlanDispatcher("127.0.0.1", srv_a.port)
    disp_b = RemotePlanDispatcher("127.0.0.1", srv_b.port)
    svc = QueryService(gauge_store, device="cpu", engine="exec")
    svc.planner.spread = 2
    svc.planner.dispatcher_for_shard = \
        lambda s: disp_a if s < NUM_SHARDS // 2 else disp_b
    yield svc, disp_a.peer, disp_b.peer
    srv_a.stop()
    srv_b.stop()


class TestDistributedSpanTree:
    def test_one_tree_with_node_tagged_remote_children(self, two_peers):
        svc, peer_a, peer_b = two_peers
        with tracing.start_trace() as trace:
            r = svc.query_range(PROMQL, START + 600, 60, START + 1000)
        spans = trace.as_dicts()
        dispatch = [s for s in spans if s["name"] == "dispatch"]
        assert len(dispatch) == NUM_SHARDS
        assert {s["tags"]["peer"] for s in dispatch} == {peer_a, peer_b}
        nodes = {s["tags"]["node"] for s in spans
                 if "node" in (s.get("tags") or {})}
        assert nodes == {peer_a, peer_b}
        assert {"scan", "decode", "reduce"} <= {s["name"] for s in spans}
        by_id = {s["span_id"]: s for s in spans}
        scans = [s for s in spans if s["name"] == "scan"]
        assert len(scans) == NUM_SHARDS
        for s in scans:
            ancestors, cur = [], s
            while cur.get("parent_id") and len(ancestors) < 32:
                cur = by_id[cur["parent_id"]]
                ancestors.append(cur["name"])
            assert "dispatch" in ancestors, (s, ancestors)
        assert r.stats.series_scanned > 0 and r.stats.samples_scanned > 0
        assert r.stats.wire_bytes > 0 and r.stats.decode_s > 0
        assert r.spans == []

    def test_stats_equivalence_local_vs_remote(self, gauge_store,
                                               two_peers):
        svc_remote, _, _ = two_peers
        svc_local = QueryService(gauge_store, device="cpu", engine="exec")
        svc_local.planner.spread = 2
        local = svc_local.query_range(PROMQL, START + 600, 60, START + 1000)
        remote = svc_remote.query_range(PROMQL, START + 600, 60,
                                        START + 1000)
        for f in ("series_scanned", "samples_scanned", "chunks_touched"):
            assert getattr(remote.stats, f) == getattr(local.stats, f), f
        assert local.stats.wire_bytes == 0 < remote.stats.wire_bytes
        assert_same_answer(remote, local, 2e-5)

    def test_unsampled_query_has_zero_spans(self, two_peers):
        svc, _, _ = two_peers
        tracing.configure(sample_rate=0.0, slow_query_threshold_ms=0.0)
        before = len(tracing.flight_recorder())
        r = svc.query_range(PROMQL, START + 600, 60, START + 1000)
        assert r.spans == [] and tracing.current_trace() is None
        assert len(tracing.flight_recorder()) == before
        assert r.stats.samples_scanned > 0

    def test_head_sampled_slow_query_lands_in_recorder(self, two_peers):
        svc, peer_a, peer_b = two_peers
        tracing.configure(sample_rate=1.0, slow_query_threshold_ms=0.001,
                          slowlog_capacity=16)
        tracing.flight_recorder().clear()
        svc.query_range(PROMQL, START + 600, 60, START + 1000)
        e = tracing.slow_queries()[0]
        assert e["kind"] == "query" and e["sampled"] is True
        assert e["query"] == PROMQL and e["dataset"] == DS
        assert e["stats"]["samples_scanned"] > 0
        assert {"parse", "dispatch", "scan"} <= {s["name"]
                                                 for s in e["spans"]}
        nodes = {s["tags"]["node"] for s in e["spans"]
                 if "node" in (s.get("tags") or {})}
        assert nodes == {peer_a, peer_b}


@pytest.mark.parametrize("fault", ["load", "build"])
def test_a_kernel_library_that_fails_raises_runtime_error(fault, tmp_path,
                                                         monkeypatch):
    """A library that does not load (a bad object) or build (an unusable
    build directory) raises ``RuntimeError`` naming it, never the
    ``OSError`` a gather takes for a lost transport."""
    from filodb_tpu_torch import _build

    monkeypatch.setattr(_build, "_libs", {})
    if fault == "load":
        bad = tmp_path / "libfused_rate.so"
        bad.write_bytes(b"not a shared object")
        monkeypatch.setattr(_build, "_target", lambda name: bad)
    else:
        (tmp_path / "file").write_text("")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "file" / "k")
    with pytest.raises(RuntimeError, match="fused_rate") as err:
        _build.library("fused_rate")
    assert isinstance(err.value.__cause__, OSError)
