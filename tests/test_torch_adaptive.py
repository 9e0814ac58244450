"""Port parity for the adaptive engine (``parallel/adaptive.py``).

The reference's ``tests/test_adaptive.py`` cases on the port: on the CPU
the device lane is the CPU, so no host lane is built and every call is
the device lane's, equal to ``engine="mesh"``; routing, warm-up and
shadow probes run with injected fake lanes, as the reference injects
them. ``execute_many`` answers as the reference's adaptive engine does on
the slice store (``test_torch_slice``), through ``query_range_many``.
Over a mesh of several CPU slots the ``single`` lane (a 1×1 engine on
the first slot) is built, serves a cold bucket, is shadowed and answers
as the device lane; over one slot it is not built.
"""

import time

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.parallel import adaptive as ref_adaptive
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.parallel import adaptive
from filodb_tpu_torch.parallel.adaptive import (
    AdaptiveQueryEngine,
    _bucket,
    _LaneCost,
)
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.query.model import QueryStats, StepMatrix
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

Q = "sum(rate(http_requests_total[5m])) by (job)"


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), CHUNK)


@pytest.fixture(autouse=True)
def fresh_models():
    cm.reset_models()
    yield
    cm.reset_models()


def test_one_lane_on_the_cpu_answers_as_mesh(stores):
    _, port = stores
    svc = QueryService(port, device="cpu", engine="adaptive")
    ref = QueryService(port, device="cpu", engine="mesh")
    a = svc.query_range(Q, Q_START, Q_STEP, Q_END)
    b = ref.query_range(Q, Q_START, Q_STEP, Q_END)
    np.testing.assert_array_equal(a.result.values, b.result.values)
    eng = svc.mesh
    assert isinstance(eng, AdaptiveQueryEngine)
    assert eng._host() is None and eng._lanes() == ["device"]
    assert eng.routed == {"device": 1, "single": 0, "host": 0}
    assert a.stats.engine == "mesh"


def test_the_default_engine_never_builds_a_host_lane(stores):
    _, port = stores
    svc = QueryService(port, device="cpu")
    svc.query_range(Q, Q_START, Q_STEP, Q_END)
    assert not isinstance(svc.mesh, AdaptiveQueryEngine)
    assert not hasattr(svc.mesh, "_host_engine")


def test_execute_many_answers_as_the_reference(stores):
    ref, port = stores
    qs = [(Q, Q_START + 60 * (i % 3), Q_STEP, Q_END) for i in range(5)] \
        + [("avg(avg_over_time(queue_depth[5m]))", Q_START, Q_STEP, Q_END)]
    got = QueryService(port, device="cpu",
                       engine="adaptive").query_range_many(qs)
    want = RefService(ref, DS, NUM_SHARDS, spread=1,
                      engine="adaptive").query_range_many(qs)
    mesh = QueryService(port, device="cpu").query_range_many(qs)
    for g, w, m in zip(got, want, mesh):
        w.result.materialize()
        assert _sorted(g)[0] == _sorted(w)[0] == _sorted(m)[0]
        np.testing.assert_allclose(_sorted(g)[1], _sorted(w)[1], rtol=2e-5,
                                   atol=1e-6, equal_nan=True)
        np.testing.assert_array_equal(g.result.values, m.result.values)


class _FakeLane:
    """Counts calls; answers empty matrices."""

    def __init__(self):
        self.calls = 0
        self.device = None

    def execute(self, memstore, plan, stats, deadline=None):
        self.calls += 1
        return StepMatrix.empty(np.array([0], np.int64))

    def execute_many(self, memstore, plans, stats_list, deadline=None):
        self.calls += 1
        return [StepMatrix.empty(np.array([0], np.int64)) for _ in plans]

    def supports(self, memstore, plan):
        return None


def _engine_with_lanes():
    eng = AdaptiveQueryEngine(torch.device("cpu"), dataset=DS)
    eng.device_engine = _FakeLane()
    eng._host_engine = _FakeLane()
    eng._host_checked = True
    eng._single_checked = True  # two lanes: device and host
    eng.sync_floor_s = 0.070
    return eng


def test_costs_are_learned_per_bucket():
    eng = _engine_with_lanes()
    eng._record("host", 1, 0.001)
    eng._record("device", 1, 0.070)
    assert eng._route(1) == "host"
    eng._record("host", 256, 0.256)
    eng._record("device", 256, 0.020)
    assert eng._route(256) == "device"
    assert eng.estimates() == {"device": {1: 0.070, 256: 0.020 / 256},
                               "host": {1: 0.001, 256: 0.001}}
    # mirrored into the cost model's "lane" site, as the reference's
    model = cm.model_for(DS)
    assert model.samples("lane", "b256", "device") == 1


def test_a_cold_bucket_prefers_the_host_lane():
    assert _engine_with_lanes()._route(1) == "host"


def test_warmup_sample_replaced_not_blended():
    for cls in (_LaneCost, ref_adaptive._LaneCost):
        c = cls()
        c.record(5.0)
        c.record(0.001)
        assert c.est == pytest.approx(0.001)
        c.record(0.002)
        assert 0.001 < c.est < 0.002


def test_buckets_are_the_references():
    for n in (1, 3, 4, 5, 16, 100, 1024, 5000):
        assert _bucket(n) == ref_adaptive._bucket(n)


def test_routing_decisions_equal_the_references():
    """One sequence of recorded costs: the same lane at every step."""
    rng = np.random.default_rng(11)
    eng = _engine_with_lanes()
    ref = ref_adaptive.AdaptiveQueryEngine.__new__(
        ref_adaptive.AdaptiveQueryEngine)
    ref._cost, ref._calls, ref._dataset = {}, 0, DS
    ref._lanes = lambda: ["device", "host"]
    for _ in range(200):
        lane = ("device", "host")[int(rng.integers(0, 2))]
        n = int(rng.integers(1, 300))
        secs = float(rng.random())
        eng._record(lane, n, secs)
        ref._record(lane, n, secs)
        k = int(rng.integers(1, 300))
        assert eng._route(k) == ref._route(k)


def test_served_lanes_are_counted_and_shadowed(stores):
    _, port = stores
    eng = _engine_with_lanes()
    plan = parse_query(Q, TimeStepParams(Q_START, Q_STEP, Q_END))
    before = adaptive._M_ROUTED["host"].value
    eng.execute(port, plan, QueryStats())
    assert eng.routed["host"] == 1
    assert adaptive._M_ROUTED["host"].value == before + 1
    deadline = time.time() + 5
    while eng.shadowed["device"] == 0 and time.time() < deadline:
        time.sleep(0.01)
    eng.drain()
    # the device estimate was missing: a shadow probe priced it
    assert eng.shadowed["device"] == 1
    assert eng._cost[("device", 1)].est is not None
    assert eng.device_engine.calls == 1


def test_a_real_host_lane_answers_as_the_device_lane(stores):
    """A host lane of the port's own mesh engine on the CPU (on the card
    this is the plain versions against the kernels): routed there, its
    answers equal mesh's."""
    from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine

    _, port = stores
    svc = QueryService(port, device="cpu", engine="adaptive")
    svc.mesh._host_engine = MeshQueryEngine(torch.device("cpu"),
                                            sidecars=True)
    svc.mesh._host_checked = True
    got = svc.query_range(Q, Q_START, Q_STEP, Q_END)  # cold: the host
    svc.mesh.drain()
    assert svc.mesh.routed["host"] == 1
    assert svc.mesh.shadowed["device"] == 1
    want = QueryService(port, device="cpu").query_range(Q, Q_START, Q_STEP,
                                                        Q_END)
    np.testing.assert_array_equal(got.result.values, want.result.values)


def _mesh_service(port, slots: int):
    from filodb_tpu_torch.parallel.mesh_engine import make_query_mesh

    return QueryService(port, engine="adaptive",
                        mesh=make_query_mesh(devices=["cpu"] * slots))


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_the_single_lane_is_built_over_several_slots(stores, slots):
    _, port = stores
    eng = _mesh_service(port, slots).mesh
    single = eng._single()
    assert (single is not None) == (slots > 1)
    assert eng._lanes() == (["device", "single"] if slots > 1
                            else ["device"])
    if single is not None:
        assert len(single.mesh) == 1
        assert single.device == eng.device_engine.device
        assert single.batches is eng.device_engine.batches


def test_the_single_lane_is_routed_shadowed_and_answers_as_the_mesh(stores):
    _, port = stores
    svc = _mesh_service(port, 4)
    eng = svc.mesh
    before = adaptive._M_ROUTED["single"].value
    got = svc.query_range(Q, Q_START, Q_STEP, Q_END)  # cold: single
    eng.drain()
    assert eng.routed["single"] == 1
    assert adaptive._M_ROUTED["single"].value == before + 1
    # the device lane's estimate was missing: a shadow probe priced it
    assert eng.shadowed["device"] == 1
    assert eng._cost[("device", 1)].est is not None
    eng._record("single", 1, 10.0)  # the mesh measured faster
    dev = svc.query_range(Q, Q_START, Q_STEP, Q_END)
    assert eng.routed["device"] == 1
    assert _sorted(got)[0] == _sorted(dev)[0]
    np.testing.assert_allclose(_sorted(got)[1], _sorted(dev)[1], rtol=1e-9,
                               atol=1e-12, equal_nan=True)
    one = QueryService(port, device="cpu").query_range(Q, Q_START, Q_STEP,
                                                       Q_END)
    np.testing.assert_array_equal(got.result.values, one.result.values)
