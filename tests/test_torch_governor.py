"""Port parity for the governor: admission, budgets, memory-pressure
shedding, the 503 encodings, gateway shedding and tenant quotas.

- The reference's own cases (``tests/test_governor.py``) run on the port's
  ``utils/governor.py``: the admission gate, the watchdog's state machine.
- One scripted sequence of admissions, releases, state changes and
  watchdog samples goes through both packages' governors, which must
  admit, shed (with the same reasons) and move state alike.
- Through a service on the slice store (``test_torch_slice``: the same
  series in a JAX store and in the port's ``MemStore``): shed and
  recovery, the instant query under CRITICAL, the three budgets in both
  modes and the default budget, each against the reference's service of
  the same engine (``mesh`` and ``exec``).
- The 503 encodings on both fronts, gateway shedding under CRITICAL, and
  a tenant quota over one container ingested by both packages.
"""

import json
import threading
import time

import numpy as np
import pytest

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord, RecordContainer
from filodb_tpu.core.record import SomeData as RefSomeData
from filodb_tpu.core.store.config import StoreConfig as RefStoreConfig
from filodb_tpu.query.model import QueryContext as RefContext
from filodb_tpu.query.model import QueryLimitExceeded as RefLimitExceeded
from filodb_tpu.utils import governor as rgov
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer, SomeData
from filodb_tpu_torch.gateway import server as gw
from filodb_tpu_torch.gateway.influx import parse_influx_line
from filodb_tpu_torch.http.fastserver import _STATUS, FastHttpServer, _HotReq
from filodb_tpu_torch.http.server import HttpDispatcher, retry_after_headers
from filodb_tpu_torch.query.model import QueryContext, QueryLimitExceeded
from filodb_tpu_torch.utils import governor as gov
from filodb_tpu_torch.utils.metrics import render_prometheus
from filodb_tpu_torch.utils.resilience import Deadline, DeadlineExceeded
from test_torch_slice import (
    CHUNK,
    DS,
    NUM_SHARDS,
    Q_END,
    Q_START,
    Q_STEP,
    _build_stores,
    _series_specs,
    _sorted,
)

GAUGES = "queue_depth"


@pytest.fixture(autouse=True)
def fresh_governors():
    """Both packages' governors are process-global: isolate every test."""
    gov.reset()
    rgov.reset()
    yield
    gov.reset()
    rgov.reset()


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), CHUNK)


def _pair(stores, engine):
    ref, port = stores
    return (RefService(ref, DS, NUM_SHARDS, spread=1, engine=engine),
            QueryService(port, device="cpu", engine=engine))


def _hold_slot(g):
    """Occupy one admission slot from another thread until released."""
    held, release = threading.Event(), threading.Event()

    def occupant():
        with g.admit():
            held.set()
            release.wait(timeout=30)

    t = threading.Thread(target=occupant, daemon=True)
    t.start()
    assert held.wait(timeout=5)
    return release, t


# ---------------------------------------------------------------------------
# the reference's cases on the port


def test_admit_and_release():
    g = gov.governor()
    before = gov._admitted.value
    with g.admit():
        assert g.inflight == 1
    assert g.inflight == 0
    assert gov._admitted.value == before + 1


def test_waiter_admitted_when_slot_frees():
    gov.configure(admission_capacity=1)
    g = gov.governor()
    release, t = _hold_slot(g)
    got = threading.Event()

    def waiter():
        with g.admit():
            got.set()

    w = threading.Thread(target=waiter, daemon=True)
    w.start()
    time.sleep(0.1)
    assert not got.is_set()
    release.set()
    assert got.wait(timeout=5)
    t.join(timeout=5)
    w.join(timeout=5)
    assert g.inflight == 0


@pytest.mark.parametrize("case", ["deadline", "capacity", "queue_full"])
def test_sheds_with_the_reason(case):
    conf = {"deadline": dict(admission_capacity=1, retry_after_s=2.0),
            "capacity": dict(admission_capacity=1, max_queue_wait_s=0.2),
            "queue_full": dict(admission_capacity=1,
                               admission_queue_limit=0)}[case]
    gov.configure(**conf)
    g = gov.governor()
    release, t = _hold_slot(g)
    try:
        t0 = time.monotonic()
        with pytest.raises(gov.QueryRejected) as ei:
            with g.admit(deadline=Deadline.after(0.3)
                         if case == "deadline" else None):
                pass
        assert time.monotonic() - t0 < 2.0
        assert ei.value.reason == case
        assert gov._rejected[case].value >= 1
        if case == "deadline":
            assert ei.value.retry_after_s == 2.0
    finally:
        release.set()
        t.join(timeout=5)


def test_critical_sheds_expensive_admits_cheap():
    g = gov.governor()
    g.set_state(gov.CRITICAL)
    with pytest.raises(gov.QueryRejected) as ei:
        with g.admit(cost=gov.EXPENSIVE):
            pass
    assert ei.value.reason == "critical"
    with g.admit(cost=gov.CHEAP):
        assert g.inflight == 1


def test_degraded_capacity_shrinks():
    gov.configure(admission_capacity=8, degraded_capacity_factor=0.5)
    g = gov.governor()
    assert g.capacity() == 8
    before = gov._transitions[gov.DEGRADED].value
    assert g.set_state(gov.DEGRADED)
    assert g.capacity() == 4
    assert not g.set_state(gov.DEGRADED)
    assert gov._transitions[gov.DEGRADED].value == before + 1
    g.set_state(gov.OK)
    assert g.capacity() == 8


def test_watchdog_state_machine_and_sources():
    g = gov.governor()
    level = {"v": 0.1}
    fired = []
    w = gov.MemoryWatchdog(gov=g, interval_s=999.0)
    w.add_source("fake", lambda: level["v"])
    w.add_source("gone", lambda: None)
    w.add_source("broken", lambda: 1 / 0)
    w.on_degraded.append(fired.append)
    assert w.sample() == gov.OK
    level["v"] = 0.80
    assert w.sample() == gov.DEGRADED
    level["v"] = 0.95
    assert w.sample() == gov.CRITICAL
    assert fired == [gov.DEGRADED, gov.CRITICAL]
    level["v"] = 0.10
    assert w.sample() == gov.OK
    assert fired == [gov.DEGRADED, gov.CRITICAL]
    assert w.utilization() == pytest.approx(0.1)


def test_watchdog_thread_drives_state_and_stop_resets():
    g = gov.governor()
    w = gov.MemoryWatchdog(gov=g, interval_s=0.02)
    w.add_source("fake", lambda: 0.99)
    w.start()
    try:
        deadline = time.monotonic() + 5
        while g.state != gov.CRITICAL and time.monotonic() < deadline:
            time.sleep(0.02)
        assert g.state == gov.CRITICAL
    finally:
        w.stop()
    assert g.state == gov.OK


# ---------------------------------------------------------------------------
# one scripted sequence through both governors

SCRIPT = [
    ("acquire", gov.EXPENSIVE, "demo/App-0"),
    ("acquire", gov.EXPENSIVE, "demo/App-0"),   # tenant at max_inflight
    ("acquire", gov.RULES, ""),
    ("acquire", gov.RULES, ""),                 # rules at max_inflight
    ("acquire", gov.CHEAP, "demo/App-1"),       # capacity 3 reached
    ("acquire", gov.EXPENSIVE, ""),             # queue limit 0
    ("release", 2),
    ("sample", 0.8),                            # DEGRADED: capacity 1
    ("acquire", gov.RULES, ""),                 # rules shed outside OK
    ("acquire", gov.CHEAP, ""),                 # over degraded capacity
    ("release", 0),
    ("release", 4),
    ("sample", 0.95),                           # CRITICAL
    ("acquire", gov.EXPENSIVE, ""),
    ("acquire", gov.CHEAP, ""),
    ("sample", 0.1),                            # OK again
    ("acquire", gov.EXPENSIVE, "demo/App-0"),
]


def _run_script(mod) -> list:
    mod.configure(admission_capacity=3, admission_queue_limit=0,
                  rules_max_inflight=1, degraded_capacity_factor=0.34,
                  tenants={"demo/App-0": {"max_inflight": 1}})
    g = mod.governor()
    w = mod.MemoryWatchdog(gov=g, interval_s=999.0)
    level = {"v": 0.0}
    w.add_source("script", lambda: level["v"])
    held, out = {}, []
    for i, op in enumerate(SCRIPT):
        if op[0] == "acquire":
            _, cost, tenant = op
            key = mod.tenant_account_key(tenant)
            try:
                g._acquire(None, cost, key)
                held[i] = (key, cost)
                out.append(("admitted", g.inflight))
            except mod.QueryRejected as e:
                out.append(("shed", e.reason))
        elif op[0] == "release":
            key, cost = held.pop(op[1])
            g._release(key, cost)
            out.append(("released", g.inflight))
        else:
            level["v"] = op[1]
            out.append(("state", w.sample(), g.capacity()))
    return out


def test_a_scripted_sequence_admits_and_sheds_as_the_reference():
    got = _run_script(gov)
    want = _run_script(rgov)
    assert got == want
    assert ("shed", "tenant") in got and ("shed", "rules") in got \
        and ("shed", "critical") in got and ("shed", "queue_full") in got


# ---------------------------------------------------------------------------
# through a service, against the reference's service of the same engine


@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_query_shed_then_recovers(stores, engine):
    out = []
    for mod, svc in zip((rgov, gov), _pair(stores, engine)):
        mod.configure(admission_capacity=1, max_queue_wait_s=0.2,
                      retry_after_s=3.0)
        release, t = _hold_slot(mod.governor())
        try:
            with pytest.raises(mod.QueryRejected) as ei:
                svc.query_range(GAUGES, Q_START, Q_STEP, Q_END)
        finally:
            release.set()
            t.join(timeout=5)
        r = svc.query_range(GAUGES, Q_START, Q_STEP, Q_END)
        out.append((ei.value.retry_after_s, ei.value.reason,
                    r.result.num_series, r.partial))
    assert out[0] == out[1] and out[1][2] == 8


@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_instant_query_survives_critical(stores, engine):
    out = []
    for mod, svc in zip((rgov, gov), _pair(stores, engine)):
        mod.governor().set_state(mod.CRITICAL)
        with pytest.raises(mod.QueryRejected):
            svc.query_range(GAUGES, Q_START, Q_STEP, Q_END)
        out.append(svc.query_range(GAUGES, Q_END, 0, Q_END)
                   .result.num_series)
    assert out[0] == out[1] > 0


def _budgeted(mod, ctx_cls, **limits):
    qc = ctx_cls()
    qc.planner_params.budget = mod.QueryBudget(**limits)
    return qc


BUDGETS = {"samples": dict(max_samples_scanned=50),
           "bytes": None,  # 40 % of the whole answer's bytes
           "groups": dict(max_group_cardinality=3)}


@pytest.mark.parametrize("degrade", ["partial", "error"])
@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_budgets_degrade_as_the_reference(stores, engine, budget, degrade):
    """Each budget in each mode, on each engine, as the reference's
    service of that engine applies it: the samples budget in the exec
    leaves, the group cardinality at exec's aggregation, the result bytes
    on the answer (the reference's mesh engine checks only the last)."""
    q = f"sum({GAUGES}) by (instance)" if budget == "groups" else GAUGES
    ref_svc, port_svc = _pair(stores, engine)
    ref_svc.planner.agg_pushdown = "off"  # root-side aggregation
    outs = []
    for mod, ctx_cls, limit_exc, svc in (
            (rgov, RefContext, RefLimitExceeded, ref_svc),
            (gov, QueryContext, QueryLimitExceeded, port_svc)):
        full = svc.query_range(q, Q_START, Q_STEP, Q_END)
        full.result.materialize()
        limits = BUDGETS[budget] or dict(max_result_bytes=int(
            full.result.num_series * full.result.num_steps * 8 * 0.4))
        qc = _budgeted(mod, ctx_cls, degrade=degrade, **limits)
        breached = False
        try:
            r = svc.query_range(q, Q_START, Q_STEP, Q_END, qc)
            r.result.materialize()
            keys = {str(k) for k in r.result.keys}
            assert keys <= {str(k) for k in full.result.keys}
            outs.append((r.partial, any("budget" in w for w in r.warnings),
                         r.result.num_series))
        except limit_exc:
            breached = True
            outs.append(("raised",))
        assert breached == (degrade == "error" and outs[-1] == ("raised",))
    assert outs[0] == outs[1], (engine, budget, degrade)
    checked = budget == "bytes" or engine == "exec"
    if checked:
        assert outs[1][0] in (True, "raised")
        if degrade == "error":
            assert outs[1] == ("raised",)


def test_default_budget_from_config(stores):
    out = []
    for mod, svc in zip((rgov, gov), _pair(stores, "exec")):
        before = mod._budget_exceeded.value
        mod.configure(max_samples_scanned=50)
        r = svc.query_range(GAUGES, Q_START, Q_STEP, Q_END)
        assert mod._budget_exceeded.value > before
        assert mod.default_budget().max_samples_scanned == 50
        mod.configure(max_samples_scanned=0)
        assert mod.default_budget() is None
        r.result.materialize()
        out.append((r.partial, r.warnings, _sorted(r)[0]))
    assert out[0] == out[1] and out[1][0]


def test_partial_answer_renders_its_warning(stores):
    from filodb_tpu_torch.http import promjson
    _, svc = _pair(stores, "exec")
    r = svc.query_range(GAUGES, Q_START, Q_STEP, Q_END, _budgeted(
        gov, QueryContext, max_samples_scanned=50))
    for body in (promjson.matrix_json(r),
                 json.loads(promjson.matrix_json_str(r))):
        assert body["partial"] is True
        assert "budget" in body["warnings"][0]


# ---------------------------------------------------------------------------
# the fronts, the gateway, tenant quotas


class _RaisingSvc:
    serial = 1

    def __init__(self, exc):
        self.exc = exc

    def query_range(self, *a, **k):
        raise self.exc


class _FakeApp:
    def __init__(self, svc):
        self.services = {DS: svc}
        self.response_cache = None
        self.cluster = None

    def batched(self, svc):
        return svc


RANGE_URL = f"/promql/{DS}/api/v1/query_range?query=up&start=0&end=100&step=10"


def _threaded(exc):
    return HttpDispatcher(_FakeApp(_RaisingSvc(exc))).handle("GET", RANGE_URL)


def _fast(exc):
    fs = FastHttpServer.__new__(FastHttpServer)  # the encoder only
    req = _HotReq(None, 0, _RaisingSvc(exc), "range", ("up", 0, 10, 100))
    return fs._run_single(req, exc)


@pytest.mark.parametrize("front", [_threaded, _fast],
                         ids=["threaded", "fast"])
def test_shed_and_deadline_are_503_on_both_fronts(front):
    code, headers, body = front(gov.QueryRejected("shed", retry_after_s=2.4))
    assert (code, headers["Retry-After"], json.loads(body)["errorType"]) \
        == (503, "2", "unavailable")
    code, headers, body = front(DeadlineExceeded("too slow"))
    assert (code, json.loads(body)["errorType"]) == (503, "timeout")
    assert headers["Retry-After"] == "1"
    code, _, body = front(gov.QueryBudgetExceeded("over"))
    assert (code, json.loads(body)["errorType"]) == (422, "query_limit")
    assert 503 in _STATUS


def test_retry_after_rounding_and_default():
    assert retry_after_headers(0.2) == {"Retry-After": "1"}
    assert retry_after_headers(7.6) == {"Retry-After": "8"}
    gov.configure(retry_after_s=3.0)
    assert retry_after_headers() == {"Retry-After": "3"}


def _records(n, tag="h"):
    recs = []
    for i in range(n):
        recs.extend(parse_influx_line(f"heap_usage,host={tag}{i} value=1.0",
                                      {"_ws_": "demo", "_ns_": "App-0"},
                                      now_ms=1_600_000_000_000))
    return recs


def test_gateway_sheds_under_critical_instead_of_blocking():
    sink = gw.ContainerSink({}, num_shards=1, spread=0, flush_every=4,
                            max_pending=4)
    sink._pending.records.extend(_records(4))  # the buffer at its brim
    sink._flushing = True                       # a drain in flight
    gov.governor().set_state(gov.CRITICAL)
    before = gw.records_shed.value
    t0 = time.perf_counter()
    sink.add(_records(2, tag="x"))
    assert time.perf_counter() - t0 < 1.0       # shed, not the 5 s block
    assert gw.records_shed.value == before + 2
    assert "gateway_records_shed_total" in render_prometheus()


def test_a_tenant_quota_drops_as_the_reference_drops():
    """One container (8 new series of a capped namespace, 4 of another,
    three samples each) through one shard of each package, the quota set
    on the capped namespace: the same series are admitted, the same
    records dropped and counted."""
    c = RecordContainer()
    rng = np.random.default_rng(5)
    for t in range(3):
        for i in range(12):
            ns = "App-0" if i < 8 else "App-1"
            key = RefPartKey.create("gauge", {
                "_metric_": "heap_usage", "_ws_": "demo", "_ns_": ns,
                "host": f"h{i}"})
            c.add(IngestRecord(key, 1_600_000_000_000 + t * 10_000,
                               (float(rng.integers(0, 100)),)))
    ref = TimeSeriesMemStore()
    rshard = ref.setup("quota_ds", 0, RefStoreConfig(max_chunk_size=50))
    rshard.cardinality.set_quota(["demo", "App-0"], 3)
    rshard.ingest(RefSomeData(c, 0))
    port = MemStore(1, 0, max_chunk_size=50)
    pshard = port.shards[0]
    pshard.cardinality.set_quota(["demo", "App-0"], 3)
    pshard.ingest(SomeData(BytesContainer(c.serialize()), 0))
    for prefix in (["demo", "App-0"], ["demo", "App-1"], ["demo"]):
        assert pshard.cardinality.cardinality(prefix).active_ts == \
            rshard.cardinality.cardinality(prefix).active_ts, prefix
    assert pshard.cardinality.cardinality(["demo", "App-0"]).active_ts == 3
    assert pshard.stats.quota_dropped.value == \
        rshard.stats.quota_dropped.value == 15
    assert sorted(k.label_map["host"] for k in pshard.keys) == sorted(
        p.part_key.label_map["host"] for p in rshard.partitions)


def test_configured_tenant_quotas_apply_to_new_shards():
    gov.configure(tenants={"demo/App-0": {"max_series": 2}})
    shard = MemStore(1, 0, max_chunk_size=50).shards[0]
    assert shard.cardinality.has_quotas
    assert shard.cardinality.cardinality(["demo", "App-0"]).quota == 2
