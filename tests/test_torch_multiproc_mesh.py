"""The multi-process mesh runtime of the port, against its single-process
engines and against the reference's runtime.

Every case of ``tests/test_multiproc_mesh.py`` runs here on the port:
the descriptor wire, bitwise equality with the port's one-device
single-process mesh engine for the four queries (real processes, real
TCP: two spawned workers on the CPU seeded with
``filodb_tpu_torch.testing.mesh_store:build_store``, 48 series over 4
shards), the exec path within ``rtol=1e-6, atol=1e-9``, the workers'
status, the service's routing, cold parity under ``FILODB_MULTIPROC=0``,
a lost worker falling back, and the supervisor's tiling. Each answer
also agrees with the reference's single-process mesh engine over the
reference's ``mesh_store`` within the port's mesh-parity tolerance,
``rtol=2e-5, atol=1e-6`` (``tests/test_torch_slice.py``); both
packages' ``build_store`` give the same series and samples in each shard,
from the same streams.

Across the packages, in thread on one secret: a port ``MeshWorker``
serves the reference's ``MeshWorkerClient``, a reference ``MeshWorker``
serves the port's client, and the reference's ``MeshClusterRuntime``
over two port workers answers as the port's runtime does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator import mesh_cluster as ref_mesh_cluster
from filodb_tpu.coordinator import remote as ref_remote
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.coordinator.wire import encode as ref_encode
from filodb_tpu.parallel import multiproc as ref_multiproc
from filodb_tpu.parallel.mesh_engine import MeshQueryEngine as RefEngine
from filodb_tpu.parallel.mesh_engine import make_query_mesh
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.testing import data as ref_data
from filodb_tpu.testing import mesh_store as ref_mesh_store
from filodb_tpu_torch.coordinator import remote
from filodb_tpu_torch.coordinator.mesh_cluster import (
    _M_PROC_DISPATCH,
    _M_PROC_FALLBACK,
    LoweredDescriptor,
    MeshClusterRuntime,
    MeshWorkerClient,
)
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.wire import decode, encode, registry
from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
from filodb_tpu_torch.parallel.multiproc import (
    MeshWorker,
    MeshWorkerSupervisor,
    _ShardSliceStore,
)
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.model import QueryStats
from filodb_tpu_torch.testing import data, mesh_store
from filodb_tpu_torch.utils import resilience

CPU = torch.device("cpu")
DS = mesh_store.DATASET
START = mesh_store.START_MS // 1000
A, STEP, B = START + 600, 60, START + 1500
PARAMS = TimeStepParams(A, STEP, B)
SEED = "filodb_tpu_torch.testing.mesh_store:build_store"
TOL = dict(rtol=2e-5, atol=1e-6)  # the port's mesh parity

QUERIES = [
    'sum(rate(http_requests_total[10m]))',
    'sum by (job) (rate(http_requests_total[5m]))',
    'sum(rate(http_requests_total{job="job-1"}[10m])) by (instance)',
    'avg(rate(http_requests_total[10m]))',
]


def _plan(query):
    return parse_query(query, PARAMS)


def _single(store, query):
    """The port's one-device single-process mesh engine's answer."""
    return MeshQueryEngine(CPU).execute(store, _plan(query),
                                        QueryStats()).materialize()


def _host(m):
    return m.materialize() if hasattr(m, "materialize") else m


def assert_bitwise(a, b):
    a, b = _host(a), _host(b)
    assert [str(k) for k in a.keys] == [str(k) for k in b.keys]
    np.testing.assert_array_equal(a.steps_ms, b.steps_ms)
    assert np.asarray(a.values).tobytes() == np.asarray(b.values).tobytes()


def assert_close(got, want, **tol):
    """Keys as sorted strings, values within ``tol`` (NaN equal)."""
    got, want = _host(got), _host(want)
    gk = [str(k) for k in got.keys]
    wk = [str(k) for k in want.keys]
    assert sorted(gk) == sorted(wk) and gk
    np.testing.assert_array_equal(got.steps_ms, want.steps_ms)
    np.testing.assert_allclose(np.asarray(got.values)[np.argsort(gk)],
                               np.asarray(want.values)[np.argsort(wk)],
                               equal_nan=True, **tol)


@pytest.fixture(scope="module")
def ref_store():
    return ref_mesh_store.build_store()


def _reference(ref_store, query):
    """The reference's one-device single-process mesh engine's answer."""
    eng = RefEngine(mesh=make_query_mesh(n_devices=1))
    return eng.execute(ref_store, ref_mesh_store.DATASET,
                       ref_parse(query, RefParams(A, STEP, B)))


# ---- the seeded store -----------------------------------------------------


def test_counter_stream_is_the_references():
    keys = data.counter_series(mesh_store.N_SERIES)
    want_keys = ref_data.counter_series(mesh_store.N_SERIES)
    assert [(k.schema, k.labels) for k in keys] == \
        [(k.schema, k.labels) for k in want_keys]
    got = list(data.counter_stream(keys, 70, start_ms=mesh_store.START_MS,
                                   seed=7, reset_every=60))
    want = list(ref_data.counter_stream(want_keys, 70,
                                        start_ms=mesh_store.START_MS,
                                        seed=7, reset_every=60))
    assert [d.offset for d in got] == [d.offset for d in want]
    assert [d.container.serialize() for d in got] == \
        [d.container.serialize() for d in want]


def test_build_store_holds_the_references_series_and_samples(ref_store):
    store = mesh_store.build_store()
    ref_shards = ref_store.shards_for(ref_mesh_store.DATASET)
    for mine, theirs in zip(store.shards, ref_shards):
        assert mine.latest_offset == theirs.latest_offset
        assert sorted(k.labels for k in mine.keys) == sorted(
            p.part_key.labels for p in theirs.partitions if p is not None)
    # every sample, through the instant selector at the sampling grid
    end = START + (mesh_store.N_SAMPLES - 1) * 10
    got = QueryService(store, device="cpu", engine="exec").query_range(
        "http_requests_total", START, 10, end).result
    want = RefService(ref_store, ref_mesh_store.DATASET,
                      ref_mesh_store.NUM_SHARDS, spread=0,
                      engine="exec").query_range(
        "http_requests_total", START, 10, end).result
    assert not np.isnan(got.values).any()
    assert_close(got, want, rtol=0, atol=0)


# ---- the descriptor on the wire (no processes) -------------------------------


class TestDescriptorWire:
    def _descriptor(self):
        low = MeshQueryEngine(CPU)._lower(_plan(QUERIES[1]))
        assert low is not None
        return LoweredDescriptor.from_lowered(low, DS), low

    def test_registered_on_the_wire(self):
        assert "LoweredDescriptor" in registry()
        assert "MeshWorkerClient" in registry()

    def test_roundtrip_is_identity(self):
        desc, _ = self._descriptor()
        back = decode(encode(desc))
        assert back == desc
        assert back.signature == desc.signature

    def test_to_lowered_reproduces_plan(self):
        desc, low = self._descriptor()
        assert decode(encode(desc)).to_lowered() == low

    def test_strip_agg_for_worker_execution(self):
        desc, _ = self._descriptor()
        w = decode(encode(desc)).to_lowered(strip_agg=True)
        assert w.agg is None and w.by == () and w.without == ()
        assert w.keep_metric and w.post == ()

    def test_the_references_descriptor_bytes(self):
        desc, _ = self._descriptor()
        ref = RefEngine(sidecars=True)._lower(
            ref_parse(QUERIES[1], RefParams(A, STEP, B)))
        want = ref_mesh_cluster.LoweredDescriptor.from_lowered(ref, DS)
        assert encode(desc) == ref_encode(want)


# ---- spawned workers: byte identity, routing, cold parity ---------------------


@pytest.fixture(scope="module")
def cluster():
    store = mesh_store.build_store()
    sup = MeshWorkerSupervisor(dataset=DS, num_shards=mesh_store.NUM_SHARDS,
                               workers=2, seed=SEED, device="cpu")
    sup.spawn()
    try:
        sup.wait_ready(timeout_s=120.0)
        rt = MeshClusterRuntime(store, DS, mesh_store.NUM_SHARDS,
                                sup.slices, device="cpu")
        yield store, sup, rt
        rt.shutdown()
    finally:
        sup.stop()


class TestMultiprocByteIdentity:
    @pytest.mark.parametrize("query", QUERIES)
    def test_matches_single_process_mesh(self, cluster, ref_store, query):
        store, _, rt = cluster
        got = rt.execute_plan(_plan(query))
        assert got is not None, f"multiproc fell back: {query}"
        assert_bitwise(got, _single(store, query))
        assert_close(got, _reference(ref_store, query), **TOL)

    def test_matches_exec_path(self, cluster, ref_store):
        store, _, rt = cluster
        exec_svc = QueryService(store, device="cpu", engine="exec")
        for query in QUERIES[:2]:
            got = rt.execute_plan(_plan(query))
            e = exec_svc.query_range(query, A, STEP, B).result
            assert_close(got, e, rtol=1e-6, atol=1e-9)
            assert_close(got, _reference(ref_store, query), **TOL)

    def test_worker_status_reports_slices(self, cluster):
        _, _, rt = cluster
        assert rt.execute_plan(_plan(QUERIES[0])) is not None  # warm both
        st = rt.status()
        assert len(st["workers"]) == 2
        ranges = sorted(tuple(w["shards"]) for w in st["workers"])
        assert ranges == [(0, 2), (2, 4)]
        for w in st["workers"]:
            assert w["reachable"]
            assert w["devices"] == 1
            assert w["device"] == "cpu"
            assert w["queries"] >= 1
            # the plain versions count no launches
            assert set(w["launches"]) == {"decode_ts_page",
                                          "decode_f32_page",
                                          "fused_decode_rate",
                                          "windowed_sum"}
        assert st["last_collective_s"] is not None

    def test_service_routes_through_multiproc(self, cluster, ref_store):
        store, _, rt = cluster
        svc = QueryService(store, device="cpu")
        ref = QueryService(store, device="cpu")
        svc.mesh_cluster = rt
        before = _M_PROC_DISPATCH["ok"].value
        for query in QUERIES:
            a = svc.query_range(query, A, STEP, B)
            assert a.stats.engine == "mesh-proc" and not a.partial
            assert_bitwise(a.result, _single(store, query))
            # the service's own engine: the same code over the same rows
            assert_bitwise(a.result, ref.query_range(query, A, STEP,
                                                     B).result)
            assert_close(a.result, _reference(ref_store, query), **TOL)
        assert _M_PROC_DISPATCH["ok"].value >= before + len(QUERIES)

    def test_disabled_env_cold_parity(self, cluster, monkeypatch):
        store, _, rt = cluster
        monkeypatch.setenv("FILODB_MULTIPROC", "0")
        before = _M_PROC_FALLBACK["disabled"].value
        assert rt.execute_plan(_plan(QUERIES[0])) is None
        assert _M_PROC_FALLBACK["disabled"].value == before + 1
        svc = QueryService(store, device="cpu")
        svc.mesh_cluster = rt
        ref = QueryService(store, device="cpu")
        got = svc.query_range(QUERIES[0], A, STEP, B)
        want = ref.query_range(QUERIES[0], A, STEP, B)
        assert got.stats.engine == "mesh"
        assert_bitwise(got.result, want.result)

    def test_tick_grids_and_other_shapes_fall_back(self, cluster):
        """A grid the sidecar lane takes, and a shape the runtime does not
        lower, fall back as ``unsupported``."""
        _, _, rt = cluster
        before = _M_PROC_FALLBACK["unsupported"].value
        tick = parse_query(QUERIES[0], TimeStepParams(B, 0, B))
        assert rt.execute_plan(tick) is None
        assert rt.execute_plan(_plan(
            "quantile(0.5, rate(http_requests_total[5m]))")) is None
        assert _M_PROC_FALLBACK["unsupported"].value == before + 2


# ---- chaos: a lost worker falls back, never wrong ------------------------------


def test_worker_loss_degrades_to_fallback(ref_store):
    store = mesh_store.build_store()
    sup = MeshWorkerSupervisor(dataset=DS, num_shards=mesh_store.NUM_SHARDS,
                               workers=2, seed=SEED, device="cpu")
    sup.spawn()
    try:
        sup.wait_ready(timeout_s=120.0)
        rt = MeshClusterRuntime(store, DS, mesh_store.NUM_SHARDS,
                                sup.slices, timeout=5.0, device="cpu")
        healthy = rt.execute_plan(_plan(QUERIES[0]))
        assert healthy is not None

        sup.procs[0].kill()
        sup.procs[0].wait(timeout=10)
        before = _M_PROC_FALLBACK["worker"].value
        assert rt.execute_plan(_plan(QUERIES[0])) is None
        assert _M_PROC_FALLBACK["worker"].value == before + 1

        svc = QueryService(store, device="cpu")
        svc.mesh_cluster = rt
        ref = QueryService(store, device="cpu")
        got = svc.query_range(QUERIES[0], A, STEP, B)
        want = ref.query_range(QUERIES[0], A, STEP, B)
        assert got.stats.engine == "mesh"
        assert_bitwise(got.result, want.result)
        assert_bitwise(got.result, healthy)
        assert_close(got.result, _reference(ref_store, QUERIES[0]), **TOL)
        rt.shutdown()
    finally:
        sup.stop()
        resilience.reset_breakers()


def test_supervisor_slices_tile_the_shard_space():
    sup = MeshWorkerSupervisor(dataset="timeseries", num_shards=10,
                               workers=3, seed=SEED)
    spans = [r for _, _, r in sup.slices]
    assert spans[0][0] == 0 and spans[-1][1] == 10
    for (a, b), (c, d) in zip(spans, spans[1:]):
        assert b == c and a < b
    with pytest.raises(ValueError):
        MeshClusterRuntime(None, "timeseries", 10,
                           [("h", 1, (0, 4)), ("h", 2, (5, 10))])


def test_a_worker_without_its_card_exits_and_wait_ready_raises():
    """A worker left to its default device on a machine without CUDA
    exits non-zero, and ``wait_ready`` says so; it never serves from the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sup = MeshWorkerSupervisor(dataset=DS, num_shards=4, workers=1,
                               seed=SEED).spawn()
    try:
        with pytest.raises(RuntimeError, match="exited with"):
            sup.wait_ready(timeout_s=120.0)
    finally:
        sup.stop()


# ---- across the packages, in thread -------------------------------------------


@pytest.fixture
def secret(monkeypatch):
    monkeypatch.setenv("FILODB_CLUSTER_SECRET", "mesh-secret")
    yield "mesh-secret"
    remote.reset_pool()
    ref_remote.reset_pool()
    resilience.reset_breakers()


def _port_workers(store):
    return [MeshWorker(_ShardSliceStore(store, DS, lo, hi), DS, (lo, hi),
                       device="cpu").start() for lo, hi in ((0, 2), (2, 4))]


def test_a_port_worker_serves_the_references_client(secret, ref_store):
    store = mesh_store.build_store()
    workers = _port_workers(store)
    try:
        assert workers[0].secret == secret
        low = RefEngine(sidecars=True)._lower(
            ref_parse(QUERIES[1], RefParams(A, STEP, B)))
        desc = ref_mesh_cluster.LoweredDescriptor.from_lowered(low, DS)
        parts = [ref_mesh_cluster.MeshWorkerClient(
            "127.0.0.1", w.port).exec_descriptors([desc]) for w in workers]
        # worker 0 owns every series (spread 0: one shard)
        got = parts[0]["results"][0]
        assert parts[1]["results"][0].keys == []
        assert parts[0]["offsets"] == {0: -1, 1: 86}
        rw = ref_multiproc.MeshWorker(
            ref_multiproc._ShardSliceStore(ref_store, DS, 0, 2), DS, (0, 2))
        try:
            want = rw._exec([desc])["results"][0]
        finally:
            rw.server.server_close()
        assert_close(got, want, **TOL)
        # the port's worker counts its series and samples as the
        # reference's
        assert parts[0]["series"] == mesh_store.N_SERIES
    finally:
        for w in workers:
            w.stop()


def test_a_reference_worker_serves_the_ports_client(secret, ref_store):
    store = mesh_store.build_store()
    ref_worker = ref_multiproc.MeshWorker(
        ref_multiproc._ShardSliceStore(ref_store, DS, 0, 4), DS, (0, 4)
    ).start()
    try:
        low = MeshQueryEngine(CPU)._lower(_plan(QUERIES[1]))
        desc = LoweredDescriptor.from_lowered(low, DS)
        part = MeshWorkerClient("127.0.0.1", ref_worker.port) \
            .exec_descriptors([desc])
        got = MeshQueryEngine(CPU).reduce_rows(
            low, part["results"][0].keys, part["results"][0].values,
            part["results"][0].steps_ms)
        assert_close(got, _single(store, QUERIES[1]), **TOL)
        # the port's runtime over the reference's worker
        rt = MeshClusterRuntime(store, DS, 4, [("127.0.0.1",
                                                ref_worker.port, (0, 4))],
                                device="cpu")
        for query in QUERIES:
            assert_close(rt.execute_plan(_plan(query)),
                         _single(store, query), **TOL)
        rt.shutdown()
    finally:
        ref_worker.stop()


def test_the_references_runtime_over_port_workers(secret, ref_store):
    store = mesh_store.build_store()
    workers = _port_workers(store)
    try:
        ref_rt = ref_mesh_cluster.MeshClusterRuntime(
            ref_store, DS, 4, [("127.0.0.1", w.port, w.shard_range)
                               for w in workers])
        port_rt = MeshClusterRuntime(store, DS, 4, [
            ("127.0.0.1", w.port, w.shard_range) for w in workers],
            device="cpu")
        for query in QUERIES:
            got = ref_rt.execute_plan(ref_parse(query,
                                                RefParams(A, STEP, B)))
            assert got is not None, query
            assert_close(got, port_rt.execute_plan(_plan(query)), **TOL)
        st = ref_rt.status()
        assert [w["reachable"] for w in st["workers"]] == [True, True]
        ref_rt.shutdown()
        port_rt.shutdown()
    finally:
        for w in workers:
            w.stop()


_DIST = """
import os, sys, torch
import torch.distributed as dist
from filodb_tpu_torch.parallel.multiproc import init_distributed
init_distributed(sys.argv[1], 2, int(sys.argv[2]))
t = torch.tensor([float(int(sys.argv[2]) + 1)])
dist.all_reduce(t)
print(dist.get_backend(), float(t))
dist.destroy_process_group()
"""


def test_init_distributed_is_gated_and_joins_a_gloo_group(monkeypatch):
    """Without ``FILODB_MESH_DISTRIBUTED=1`` it raises; with it, two
    processes on the CPU join one gloo group and all-reduce."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from filodb_tpu_torch.parallel.multiproc import _free_port, \
        init_distributed

    monkeypatch.delenv("FILODB_MESH_DISTRIBUTED", raising=False)
    with pytest.raises(RuntimeError, match="FILODB_MESH_DISTRIBUTED=1"):
        init_distributed("127.0.0.1:1", 2, 0)
    addr = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "FILODB_MESH_DISTRIBUTED": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    root = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", _DIST, addr, str(r)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["gloo", "3.0"], ["gloo", "3.0"]]
