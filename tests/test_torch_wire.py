"""The plan wire of the port against the reference's: the typed codec
(``coordinator/wire.py``), the framed transport (``coordinator/remote.py``)
and the circuit breakers (``utils/resilience.py``).

Equal objects of the shared classes (``LoweredDescriptor``,
``StepMatrix``, ``RangeVectorKey``, ``QueryStats``, the query context,
filters, part keys, the ``("execute", dataset, plan, qcontext)`` message
of a shipped leaf with its ``PeriodicSamplesMapper`` and
``AggregatePartialMapper``, ``EmptyResultExec``, and a ``QueryResult``
with its warnings and ``spans``) encode to the reference's bytes, and each package
decodes the other's frames: a port ``StepMatrix`` whose values are a
tensor with a deferred compaction goes on the wire as the reference's
materialized matrix. Frames cross between the packages' senders and
receivers raw and zlib-compressed; the auth exchange, the frame caps and
the bounded inflate hold; a breaker records exactly one outcome a call,
whatever thread makes it.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import zlib

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator import remote as ref_remote
from filodb_tpu.coordinator import wire as ref_wire
from filodb_tpu.coordinator.mesh_cluster import (
    LoweredDescriptor as RefDescriptor,
)
from filodb_tpu.core.filters import ColumnFilter as RefColumnFilter
from filodb_tpu.core.filters import Equals as RefEquals
from filodb_tpu.core.filters import EqualsRegex as RefEqualsRegex
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.query import model as ref_model
from filodb_tpu.utils.governor import QueryBudget as RefBudget
from filodb_tpu_torch.coordinator import remote, wire
from filodb_tpu_torch.coordinator.mesh_cluster import LoweredDescriptor
from filodb_tpu_torch.core.filters import ColumnFilter, Equals, EqualsRegex
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.query import model
from filodb_tpu_torch.utils import resilience
from filodb_tpu_torch.utils.governor import QueryBudget

LABELS = (("_metric_", "m"), ("_ns_", "App-0"), ("job", "job-1"))


def _filters(mod_cf, mod_eq, mod_re):
    return (mod_cf("_metric_", mod_eq("m")),
            mod_cf("job", mod_re("job-[12]")))


def _descriptors():
    kw = dict(dataset="timeseries", start=1_600_000_600_000, step=60_000,
              end=1_600_001_500_000, window=300_000, fn="rate", offset=0,
              agg="sum", by=("job",), without=(), keep_metric=False,
              post=(("instant", "abs", ()), ("scalarop", "*", 2.0, False,
                                              False)), shard_axis=2)
    return (LoweredDescriptor(filters=_filters(ColumnFilter, Equals,
                                               EqualsRegex), **kw),
            RefDescriptor(filters=_filters(RefColumnFilter, RefEquals,
                                           RefEqualsRegex), **kw))


def _matrices():
    rng = np.random.default_rng(3)
    vals = rng.random((3, 5))
    vals[1] = np.nan  # a row the deferred compaction drops
    keys = [LABELS, LABELS[:2], LABELS[1:]]
    steps = np.arange(5, dtype=np.int64) * 60_000
    port = model.StepMatrix([model.RangeVectorKey(k) for k in keys],
                            torch.from_numpy(vals.copy()), steps.copy())
    port.compact()  # deferred: the wire carries the settled rows
    ref = ref_model.StepMatrix(
        [ref_model.RangeVectorKey(keys[0]), ref_model.RangeVectorKey(keys[2])],
        vals[[0, 2]], steps.copy())
    return port, ref


def _stats():
    kw = dict(series_scanned=12, samples_scanned=3456, result_series=3,
              wall_time_s=0.25, chunks_touched=7, cache_hits=2,
              cache_misses=1, admission_wait_s=0.001, decode_s=0.02,
              reduce_s=0.003, sidecar_chunks=4,
              tiers={"memstore": {"series": 12}}, pyramid={"chunkNodes": 2})
    return model.QueryStats(**kw), ref_model.QueryStats(**kw)


def _contexts():
    kw = dict(query_id="q1", submit_time_ms=1_700_000_000_000, origin="rules")
    port = model.QueryContext(planner_params=model.PlannerParams(
        spread=1, budget=QueryBudget(max_samples_scanned=10)),
        trace=model.TraceContext("t", 3, True), **kw)
    ref = ref_model.QueryContext(planner_params=ref_model.PlannerParams(
        spread=1, budget=RefBudget(max_samples_scanned=10)),
        trace=ref_model.TraceContext("t", 3, True), **kw)
    return port, ref


def _execute_messages():
    """``("execute", dataset, leaf, qcontext)``: a leaf with its
    ``PeriodicSamplesMapper`` and an ``AggregatePartialMapper``, shipped by
    a ``RemotePlanDispatcher`` (its own dispatcher field)."""
    from filodb_tpu.query.exec import plan as ref_plan
    from filodb_tpu.query.exec import transformers as ref_tf
    from filodb_tpu_torch.query.exec import plan
    from filodb_tpu_torch.query.exec import transformers as tf

    out = []
    for p, t, r, cf, eq, rx in (
            (plan, tf, remote, ColumnFilter, Equals, EqualsRegex),
            (ref_plan, ref_tf, ref_remote, RefColumnFilter, RefEquals,
             RefEqualsRegex)):
        leaf = p.SelectRawPartitionsExec(
            shard=2, filters=_filters(cf, eq, rx),
            chunk_start=1_600_000_000_000, chunk_end=1_600_003_600_000,
            dispatcher=r.RemotePlanDispatcher("10.0.0.7", 9001, 12.5))
        leaf.add_transformer(t.PeriodicSamplesMapper(
            1_600_000_300_000, 60_000, 1_600_003_600_000, 300_000, "rate"))
        leaf.add_transformer(t.AggregatePartialMapper("avg", (), ("job",)))
        out.append(leaf)
    port_q, ref_q = _contexts()
    return ("execute", "timeseries", out[0], port_q), \
        ("execute", "timeseries", out[1], ref_q)


def _query_results():
    """A ``QueryResult`` as an executor answers a sampled query: a
    partial answer with warnings, its stats, and its span tree."""
    port_m, ref_m = _matrices()
    port_s, ref_s = _stats()
    spans = [{"name": "scan", "span_id": 4, "parent_id": 0, "depth": 0,
              "duration_ms": 1.5, "tags": {"shard": 2}},
             {"name": "decode", "span_id": 5, "parent_id": 4, "depth": 1,
              "duration_ms": 0.5, "tags": {}}]
    kw = dict(query_id="q1", partial=True,
              warnings=["partial result: child 3 (shards [3]) lost"],
              spans=spans)
    return (model.QueryResult(port_m, port_s, **kw),
            ref_model.QueryResult(ref_m, ref_s, **kw))


def _empty_result_plans():
    from filodb_tpu.query.exec import plan as ref_plan
    from filodb_tpu_torch.query.exec import plan

    return (plan.EmptyResultExec(start=1, step=60, end=600),
            ref_plan.EmptyResultExec(start=1, step=60, end=600))


PAIRS = {
    "execute_message": _execute_messages,
    "query_result": _query_results,
    "empty_result_exec": _empty_result_plans,
    "descriptor": _descriptors,
    "step_matrix": _matrices,
    "range_vector_key": lambda: (model.RangeVectorKey(LABELS),
                                 ref_model.RangeVectorKey(LABELS)),
    "query_stats": _stats,
    "query_context": _contexts,
    "part_key": lambda: (PartKey.create("prom-counter", dict(LABELS)),
                         RefPartKey.create("prom-counter", dict(LABELS))),
    "message": lambda: (("mesh_exec", [_descriptors()[0]], 2.5),
                        ("mesh_exec", [_descriptors()[1]], 2.5)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_equal_objects_encode_to_the_references_bytes(name):
    port, ref = PAIRS[name]()
    assert wire.encode(port) == ref_wire.encode(ref)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_each_package_decodes_the_others_frames(name):
    port, ref = PAIRS[name]()
    from_ref = wire.decode(ref_wire.encode(ref))
    from_port = ref_wire.decode(wire.encode(port))
    # decoded, each encodes back to the same bytes in its own package
    assert wire.encode(from_ref) == ref_wire.encode(ref)
    assert ref_wire.encode(from_port) == ref_wire.encode(ref)
    assert type(from_ref).__module__.startswith(("filodb_tpu_torch",
                                                 "builtins"))


def test_the_senders_matrix_stays_on_the_device():
    port, _ = _matrices()
    wire.encode(port)
    assert isinstance(port.values, torch.Tensor) and port.pending_compact


def test_unregistered_classes_and_bad_frames_are_refused():
    class NotOnTheWire:
        pass

    with pytest.raises(TypeError, match="not wire-serializable"):
        wire.encode(NotOnTheWire())
    data = wire.encode(_stats()[0])
    with pytest.raises(ValueError, match="truncated"):
        wire.decode(data[:-3])
    with pytest.raises(ValueError, match="unknown wire class"):
        wire.decode(b"O" + struct.pack("<I", 4) + b"Evil" +
                    struct.pack("<H", 0))
    with pytest.raises(ValueError, match="trailing"):
        wire.decode(data + b"N")


# ---- frames across the packages ------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("direction", ["port→ref", "ref→port"])
def test_frames_cross_between_the_packages(direction, compress):
    port, ref = _matrices()
    big_port = ("ok", {"results": [port] * 300})
    big_ref = ("ok", {"results": [ref] * 300})
    a, b = socket.socketpair()
    try:
        if direction == "port→ref":
            sent = remote._send_msg(a, big_port, compress=compress)
            msg, got = ref_remote._recv_frame(b)
            want = ref_wire.encode(big_ref)
            assert ref_wire.encode(msg) == want
        else:
            sent = ref_remote._send_msg(a, big_ref, compress=compress)
            msg, got = remote._recv_frame(b)
            assert wire.encode(msg) == ref_wire.encode(big_ref)
        assert got == sent
        raw = len(ref_wire.encode(big_ref)) + 4
        assert (sent < raw) == compress
    finally:
        a.close()
        b.close()


def test_the_inflate_is_bounded_by_the_cap():
    a, b = socket.socketpair()
    try:
        payload = zlib.compress(b"N" * 100_000)
        a.sendall(struct.pack("<I", len(payload) | 0x8000_0000) + payload)
        with pytest.raises(ConnectionError, match="exceeds cap"):
            remote._recv_frame(b, cap=4096)
        a.sendall(struct.pack("<I", 10_000))
        with pytest.raises(ConnectionError, match="exceeds cap"):
            remote._recv_frame(b, cap=4096)
    finally:
        a.close()
        b.close()


class _Server:
    """A framed server of either package's handler, in thread."""

    def __init__(self, make_handler, secret):
        handler = make_handler(lambda: secret, self._handle, "test")

        class S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True

        self.server = S(("127.0.0.1", 0), handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @staticmethod
    def _handle(msg):
        return ("pong",) if msg[0] == "ping" else ("ok", msg[1:])

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_auth_hello_and_pooled_roundtrips_across_packages(server_pkg,
                                                          monkeypatch):
    monkeypatch.setenv("FILODB_CLUSTER_SECRET", "s3cret")
    make = remote.make_authed_handler if server_pkg == "port" \
        else ref_remote.make_authed_handler
    srv = _Server(make, "s3cret")
    try:
        cli = remote.RemotePlanDispatcher("127.0.0.1", srv.port, timeout=5)
        assert cli.ping()
        port, _ = _matrices()
        resp = cli._roundtrip(("echo", [port] * 200))
        assert resp[0] == "ok"
        assert resp[1][0][0].keys == list(port.materialize().keys)
        # one pooled socket a peer, reused across calls
        assert len(remote._pool._idle[("127.0.0.1", srv.port)]) == 1
        assert remote._peer_caps[("127.0.0.1", srv.port)] is True
        # the reference's client on the same server and secret
        ref_cli = ref_remote.RemotePlanDispatcher("127.0.0.1", srv.port,
                                                  timeout=5)
        assert ref_cli.ping()
        monkeypatch.setenv("FILODB_CLUSTER_SECRET", "wrong")
        cli._drop_conn()
        assert not cli.ping()  # auth rejected: the transport fails
    finally:
        remote.reset_pool()
        ref_remote.reset_pool()
        srv.stop()


# ---- circuit breakers ---------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_opens_probes_and_closes():
    clock = _Clock()
    b = resilience.CircuitBreaker("peer", failure_threshold=2,
                                  reset_timeout_s=10, clock=clock)
    for _ in range(2):
        with pytest.raises(ConnectionError):
            with b.calling():
                raise ConnectionError("down")
    assert b.state == resilience.OPEN
    with pytest.raises(resilience.CircuitOpenError):
        with b.calling():
            pass
    clock.t = 10.0
    assert b.state == resilience.HALF_OPEN
    assert b.allow() and not b.allow()  # one probe at a time
    b.cancel_probe()
    with b.calling():
        pass
    assert b.state == resilience.CLOSED


def test_a_deadline_or_another_error_gives_no_verdict():
    clock = _Clock()
    b = resilience.CircuitBreaker("peer", failure_threshold=1,
                                  reset_timeout_s=1, clock=clock)
    with pytest.raises(resilience.DeadlineExceeded):
        with b.calling(transport_errors=(ConnectionError, OSError,
                                         TimeoutError)):
            raise resilience.DeadlineExceeded("late")
    with pytest.raises(KeyError):
        with b.calling():
            raise KeyError("bug")
    assert b.state == resilience.CLOSED
    b.force_open()
    clock.t = 1.0
    with pytest.raises(KeyError):
        with b.calling():  # the probe, released without a verdict
            raise KeyError("bug")
    assert b.allow()  # the slot is free again


def test_one_outcome_a_call_from_many_threads():
    b = resilience.CircuitBreaker("peer", failure_threshold=10_000)
    calls = 400

    def run(i):
        try:
            with b.calling() as out:
                if i % 2:
                    out.success()  # recorded first: the exit adds none
                    raise ConnectionError("after its answer")
        except ConnectionError:
            pass

    threads = [threading.Thread(target=run, args=(i,)) for i in range(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert b._failures == 0 and b.state == resilience.CLOSED


def test_breakers_are_one_a_peer_from_the_config():
    resilience.reset_breakers()
    try:
        resilience.configure(breaker_failure_threshold=3,
                             breaker_reset_s=2.5, retry_max_attempts=4)
        b = resilience.breaker_for("h:1")
        assert b is resilience.breaker_for("h:1")
        assert (b.failure_threshold, b.reset_timeout_s) == (3, 2.5)
        assert resilience.default_retry_policy().max_attempts == 4
        # partial scatter-gather's keys are acted on since remote plan
        # dispatch came (until then they raised, naming ROADMAP A7)
        cfg = resilience.configure(allow_partial=False,
                                   partial_max_fraction=0.25)
        assert (cfg.allow_partial, cfg.partial_max_fraction) == (False, 0.25)
        resilience.record_peer_latency("h:1", 1.0)
        resilience.record_peer_latency("h:1", 2.0)
        assert resilience.peer_latency("h:1") == pytest.approx(1.3)
    finally:
        resilience.reset()
        resilience.reset_breakers()
        resilience.reset_peer_latency()


# ---- the key-list memos: the same bytes, once ---------------------------------


def test_encoded_key_lists_splice_their_bytes_and_decode_once():
    keys = [model.RangeVectorKey((("_metric_", "m"), ("instance", f"i-{i}")))
            for i in range(wire._MEMO_MIN + 5)]
    m = model.StepMatrix(keys, np.arange(len(keys) * 3, dtype=np.float32)
                         .reshape(-1, 3), np.arange(3, dtype=np.int64))
    plain = wire.encode(m)
    spliced = model.StepMatrix(wire.encoded(keys), m.values, m.steps_ms)
    assert wire.encoded(keys) is spliced.keys  # made once a list object
    assert wire.encode(spliced) == plain
    ref = ref_wire.decode(wire.encode(spliced))
    assert [k.labels for k in ref.keys] == [k.labels for k in keys]
    # a second frame of the same keys hands out the first's list
    a, b = wire.decode(plain), wire.decode(bytearray(wire.encode(spliced)))
    assert a.keys == keys and b.keys is a.keys
    assert a.values.dtype == np.float32
    other = [model.RangeVectorKey((("_metric_", "n"),) + k.labels[1:])
             for k in keys]
    c = wire.decode(wire.encode(model.StepMatrix(other, m.values,
                                                 m.steps_ms)))
    assert c.keys == other and c.keys is not a.keys


def test_the_frame_cap_takes_a_million_series_answer():
    """Two workers over a million series answer 500,000 × 121 float32
    windows each and their keys: past the reference's 256 MiB cap, inside
    the port's, which the length word's compression bit bounds."""
    assert ref_wire.MAX_FRAME == 256 * 1024 * 1024
    assert 500_000 * 121 * 4 + 500_000 * 190 > ref_wire.MAX_FRAME
    assert wire.MAX_FRAME == (1 << 31) - 1


def test_migration_manifest_crosses_the_wire():
    """ROADMAP §C.25: a migration manifest, registered on both packages'
    wires, encodes to the reference's bytes and each package decodes the
    other's frame into its own class with the same fields."""
    from filodb_tpu.coordinator.migration import (
        MigrationManifest as RefManifest,
    )
    from filodb_tpu_torch.coordinator.migration import MigrationManifest

    args = ("timeseries", 3, "node-a", "node-b", "catchup", 5, 10, 20)
    ours, theirs = MigrationManifest(*args), RefManifest(*args)
    assert wire.encode(ours) == ref_wire.encode(theirs)
    back = wire.decode(ref_wire.encode(theirs))
    assert isinstance(back, MigrationManifest)
    assert back.to_bytes() == ours.to_bytes()
    assert ref_wire.decode(wire.encode(ours)).to_bytes() \
        == theirs.to_bytes()
