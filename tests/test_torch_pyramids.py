"""Port parity for the aggregate pyramids and the pyramid lane: cold-tier
leaves over the object store folded from stored segment and bucket
summaries, and the approximate lane's sketches.

The same containers (gauges of six instances, or counters of four, 600
samples at 10 s, values made from a seed with numpy) go into the JAX
package's store and the port's, each over an object store of its own on a
directory-backed fake S3, flushed in one or two rounds (two give a bucket
of several segments, which compaction merges). A fresh reader store over
each bucket then serves a tiered planner whose memstore floor is at +4000
s, so the steps whose windows reach below it go to the cold tier. For
each case the port's answer equals the reference lane's within the
parity tests' tolerance, and its pyramid attribution (the nodes of each
level, the decode nodes, the payload bytes) equals the reference's:

- an aligned interior scan pages no payload (0 bytes, as the reference
  asserts); a window over every chunk folds one segment node a series,
  after compaction one bucket node; a grid off the seams decodes only
  the edge chunks, on the device by B1/B2;
- mode ``1`` and mode ``decode`` answer bitwise alike over the eligible
  functions, and both equal the lane off;
- legacy FSG1 segments serve through the payload fallback until
  compaction backfills their pyramids, and a pyramid deleted under a
  reader demotes it without an error;
- ``quantile_over_time`` is served from sketches only under
  ``FILODB_SIDECAR_APPROX=1``, and ``approx_topk`` /
  ``approx_cardinality`` read no payload;
- the cold tier's bucket in ``QueryStats.tiers`` carries the lane's keys,
  and ``?stats=all`` renders them.

The edge chunks decode from float32 pages, so the gauges' values are
multiples of 1/64 (float32 holds them); a last case holds values float32
does not hold, where the lane bypasses at the edges (ROADMAP §C) and the
decode lane answers as the reference.
"""

from __future__ import annotations

import glob
import json
import os
from unittest import mock

import numpy as np
import pytest

import filodb_tpu.core.store.objectstore as ref_osmod
from filodb_tpu.coordinator.ingestion import route_container as ref_route
from filodb_tpu.coordinator.planner import SingleClusterPlanner as RefPlanner
from filodb_tpu.coordinator.tiered_planner import (
    build_tiered_planner as ref_build_tiered,
)
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord as RefRecord
from filodb_tpu.core.record import RecordContainer as RefContainer
from filodb_tpu.core.record import SomeData as RefSomeData
from filodb_tpu.core.store.api import InMemoryMetaStore as RefMeta
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.core.store.objectstore import (
    ObjectStoreColumnStore as RefOS,
)
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query.exec.plan import ExecContext as RefCtx
from filodb_tpu.testing.fake_s3 import FakeS3 as RefS3
from filodb_tpu.utils.resilience import RetryPolicy as RefRetry
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.tiered_planner import build_tiered_planner
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer, SomeData
from filodb_tpu_torch.core.store import objectstore as osmod
from filodb_tpu_torch.core.store import pyramid as pyrmod
from filodb_tpu_torch.core.store.api import InMemoryMetaStore
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.core.store.objectstore import ObjectStoreColumnStore
from filodb_tpu_torch.query.federation import OBJECTSTORE
from filodb_tpu_torch.testing.fake_s3 import FakeS3
from filodb_tpu_torch.utils.resilience import RetryPolicy

DS = "timeseries"
START = 1_600_000_000
N = 600
NOW = (START + 6000) * 1000
MEM_FLOOR = (START + 4000) * 1000  # steps reaching below this go cold
TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
# with one 600-sample flush every series has 5 chunks of 120 samples,
# ending at +1190, +2390, +3590, +4790, +5990 s: a grid on chunk ends whose
# window reaches before the first sample touches interior nodes only
ALIGNED = (START + 1190, 1200, START + 3590)


def _gauges():
    return [RefPartKey.create("gauge", {
        "_metric_": "heap_usage", "_ws_": "demo", "_ns_": "App-0",
        "instance": f"instance-{i}", "host": f"H{i % 4}"}) for i in range(6)]


def _counters():
    return [RefPartKey.create("prom-counter", {
        "_metric_": "http_requests_total", "_ws_": "demo", "_ns_": "App-0",
        "instance": f"instance-{i}", "job": f"job-{i % 3}"})
        for i in range(4)]


def _values(counter: bool, exact: bool, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if counter:
        c = np.cumsum(rng.integers(0, 20, (4, N)), axis=1).astype(float)
        c[1, 300:] -= c[1, 299]  # a reset
        return c
    g = 50.0 + 30.0 * rng.random((6, 1)) + np.cumsum(
        rng.normal(0, 1.0, (6, N)), axis=1)
    return np.round(g * 64) / 64 if exact else g


def _containers(keys, vals, lo, hi) -> list:
    out = []
    for s in range(lo, hi):
        cont = RefContainer()
        t = (START + 10 * s) * 1000
        for i, k in enumerate(keys):
            cont.add(RefRecord(k, t, (float(vals[i, s]),)))
        out.append(cont)
    return out


class Env:
    """Both packages' writers and readers over buckets of their own."""

    def __init__(self, root, flushes=1, compact=False, counter=False,
                 exact=True):
        self.root = root
        self.ref_root, self.port_root = str(root / "ref"), str(root / "port")
        self.rcs = RefOS(RefS3(root=self.ref_root))
        self.ref = TimeSeriesMemStore(self.rcs, RefMeta())
        for s in range(2):
            self.ref.setup(DS, s, RefConfig(max_chunk_size=120,
                                            groups_per_shard=2))
        self.pcs = ObjectStoreColumnStore(FakeS3(root=self.port_root))
        self.port = MemStore(2, spread=0, column_store=self.pcs,
                             meta_store=InMemoryMetaStore(),
                             config=StoreConfig(max_chunk_size=120,
                                                groups_per_shard=2))
        keys = _counters() if counter else _gauges()
        vals = _values(counter, exact)
        per = N // flushes
        off = 0
        for f in range(flushes):
            for cont in _containers(keys, vals, f * per, (f + 1) * per):
                for shard, sub in ref_route(cont, 2, 0).items():
                    self.ref.ingest(DS, shard, RefSomeData(sub, off))
                    self.port.shards[shard].ingest(SomeData(
                        BytesContainer(sub.serialize()), off))
                off += 1
            self.ref.flush_all(DS)
            self.port.flush_all()
            self.rcs.flush()
            self.pcs.flush()
        if compact:
            for s in range(2):
                self.rcs.compact(DS, s)
                self.pcs.compact(DS, s)
            self.rcs.flush()
            self.pcs.flush()
        self.open_readers()

    def open_readers(self):
        self.read_rcs = RefOS(RefS3(root=self.ref_root),
                              read_retry_policy=RefRetry(
                                  max_attempts=2, base_backoff_s=0.01,
                                  max_backoff_s=0.05))
        self.read_pcs = ObjectStoreColumnStore(
            FakeS3(root=self.port_root), read_retry_policy=RetryPolicy(
                max_attempts=2, base_backoff_s=0.01, max_backoff_s=0.05))
        self.ref_planner = ref_build_tiered(
            RefPlanner(DS, 2, spread=0), self.read_rcs, DS, 2,
            mem_retention_ms=NOW - MEM_FLOOR, raw_retention_ms=None,
            ds_planner=None, now_ms=lambda: NOW)
        self.svc = QueryService(self.port, device="cpu", engine="exec")
        self.svc.planner = build_tiered_planner(
            SingleClusterPlanner(2, 0), self.read_pcs, DS, 2,
            mem_retention_ms=NOW - MEM_FLOOR, raw_retention_ms=None,
            ds_planner=None, now_ms=lambda: NOW)

    @property
    def cold(self):
        return self.svc.planner.cold_planner.store

    def ref_run(self, q, start, step, end, planner=None):
        plan = ref_parse(q, RefParams(start, step, end))
        ep = (planner or self.ref_planner).materialize(plan)
        ctx = RefCtx(self.ref, DS)
        r = ep.dispatcher.dispatch(ep, ctx)
        return r, ctx

    def port_run(self, q, start, step, end):
        return self.svc.query_range(q, start, step, end)


def _sorted(m):
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order]


def _same_answer(env, q, start, step, end, tol=TOL):
    """Both packages' answers and stats; the port's equals the reference's
    within ``tol``, and neither is partial."""
    ref_payload0 = ref_osmod.PAYLOAD_BYTES_DOWN.value
    rr, rctx = env.ref_run(q, start, step, end)
    ref_payload = ref_osmod.PAYLOAD_BYTES_DOWN.value - ref_payload0
    payload0 = osmod.PAYLOAD_BYTES_DOWN.value
    got = env.port_run(q, start, step, end)
    payload = osmod.PAYLOAD_BYTES_DOWN.value - payload0
    assert not rr.partial and not got.partial
    wk, want = _sorted(rr.result)
    gk, gv = _sorted(got.result.materialize())
    assert gk == wk and wk
    np.testing.assert_allclose(gv, want, **tol, err_msg=q)
    return got, rctx, payload, ref_payload


def _same_pyramid_stats(got, rctx):
    for key in ("bucketNodes", "segmentNodes", "chunkNodes", "decodeNodes",
                "payloadBytes"):
        assert got.stats.pyramid.get(key, 0) \
            == rctx.stats.pyramid.get(key, 0), key


@pytest.fixture(scope="module")
def one_flush(tmp_path_factory):
    return Env(tmp_path_factory.mktemp("pyr1"))


@pytest.fixture(scope="module")
def compacted(tmp_path_factory):
    return Env(tmp_path_factory.mktemp("pyr2"), flushes=2, compact=True)


@pytest.fixture(autouse=True)
def _clean_valves(monkeypatch):
    for v in ("FILODB_SIDECARS", "FILODB_SIDECAR_APPROX"):
        monkeypatch.delenv(v, raising=False)


# ---- the objects --------------------------------------------------------------


def test_equal_flushes_give_byte_equal_pyramids(one_flush):
    """The pyramid objects each package wrote for its own flush of the same
    series parse to the same entries, rows and sketches bit for bit (the
    segments' chunk order follows each package's flush order, so the
    objects are compared by content: ``test_torch_objectstore`` holds
    equal writes to byte-equal objects)."""
    env = one_flush

    def entries(root):
        out = {}
        for f in glob.glob(os.path.join(root, "**", "seg-*.pyr"),
                           recursive=True):
            p = pyrmod.parse_segment_pyramid(open(f, "rb").read())
            for k, e in p["entries"].items():
                out[k] = (e["cids"].tobytes(), e["rows"].tobytes(),
                          e["row"].tobytes(), e["sketch"].tobytes())
        return out

    want = entries(env.ref_root)
    assert want and entries(env.port_root) == want


# ---- zero payload, levels, seams ---------------------------------------------


def test_interior_scan_pages_zero_chunk_payload_bytes(one_flush):
    got, rctx, payload, ref_payload = _same_answer(
        one_flush, "sum_over_time(heap_usage[4000s])", *ALIGNED)
    assert payload == ref_payload == 0
    _same_pyramid_stats(got, rctx)
    p = got.stats.pyramid
    assert p["payloadBytes"] == 0 and p.get("decodeNodes", 0) == 0
    assert p.get("chunkNodes", 0) + p.get("segmentNodes", 0) > 0
    assert p["pyramidBytes"] > 0


def test_full_segment_window_folds_segment_nodes(one_flush):
    one_flush.cold.clear_caches()
    got, rctx, payload, _ = _same_answer(
        one_flush, "sum_over_time(heap_usage[6100s])", START + 5990, 300,
        START + 5990)
    assert payload == 0
    _same_pyramid_stats(got, rctx)
    assert got.stats.pyramid["segmentNodes"] == 6  # one a series
    assert got.stats.pyramid.get("chunkNodes", 0) == 0


def test_bucket_nodes_after_compaction(compacted):
    got, rctx, payload, _ = _same_answer(
        compacted, "sum_over_time(heap_usage[6100s])", START + 5990, 300,
        START + 5990)
    assert payload == 0
    _same_pyramid_stats(got, rctx)
    assert got.stats.pyramid["bucketNodes"] == 6
    assert got.stats.pyramid.get("segmentNodes", 0) == 0


@pytest.mark.parametrize("q", [
    "sum_over_time(heap_usage[40m])",
    "max_over_time(heap_usage[25m])",
    "avg_over_time(heap_usage[1h])",
])
def test_seam_windows_decode_only_edges(tmp_path, q):
    """Off the seams the lane still serves, paying only the edge chunks;
    it pages the reference's payload bytes and decode nodes."""
    env = Env(tmp_path)
    got, rctx, payload, ref_payload = _same_answer(
        env, q, START + 1000, 700, START + 3500)
    assert payload == ref_payload > 0
    _same_pyramid_stats(got, rctx)
    assert got.stats.pyramid["decodeNodes"] > 0
    assert got.stats.pyramid["chunkNodes"] > 0


def test_seam_windows_after_compaction(compacted):
    compacted.cold.clear_caches()
    got, rctx, payload, ref_payload = _same_answer(
        compacted, "min_over_time(heap_usage[50m])", START + 1000, 900,
        START + 3800)
    assert payload == ref_payload
    _same_pyramid_stats(got, rctx)


# ---- provenance parity ------------------------------------------------------------

GAUGE_FNS = [
    "sum_over_time", "avg_over_time", "min_over_time", "max_over_time",
    "count_over_time", "stddev_over_time", "stdvar_over_time",
    "last_over_time", "present_over_time", "changes", "resets", "delta",
]


def _sweep(env, q, monkeypatch):
    """Mode 1 and mode decode bitwise alike, both equal to the lane off
    and to the reference's."""
    span = (START + 900, 300, START + 3500)
    outs = {}
    for mode in ("1", "decode"):
        monkeypatch.setenv("FILODB_SIDECARS", mode)
        env.cold.clear_caches()
        got = env.port_run(q, *span)
        assert got.stats.pyramid, (q, mode)
        outs[mode] = _sorted(got.result.materialize())
    monkeypatch.setenv("FILODB_SIDECARS", "0")
    env.cold.clear_caches()
    off = _sorted(env.port_run(q, *span).result.materialize())
    monkeypatch.delenv("FILODB_SIDECARS")
    (ka, a), (kb, b) = outs["1"], outs["decode"]
    assert ka == kb == off[0]
    assert a.tobytes() == b.tobytes(), q
    np.testing.assert_allclose(a, off[1], **TOL, err_msg=q)
    rr, _ = env.ref_run(q, *span)
    wk, want = _sorted(rr.result)
    assert wk == ka
    np.testing.assert_allclose(a, want, **TOL, err_msg=q)


@pytest.mark.parametrize("fn", GAUGE_FNS)
def test_gauge_fn_sweep_bitwise(one_flush, fn, monkeypatch):
    _sweep(one_flush, f"{fn}(heap_usage[25m])", monkeypatch)


@pytest.fixture(scope="module")
def counters(tmp_path_factory):
    return Env(tmp_path_factory.mktemp("pyrc"), counter=True)


@pytest.mark.parametrize("fn", ["rate", "increase"])
def test_counter_rate_increase_bitwise(counters, fn, monkeypatch):
    _sweep(counters, f"{fn}(http_requests_total[25m])", monkeypatch)


# ---- legacy segments and the read race --------------------------------------------


def test_fsg1_segments_serve_via_fallback_then_backfill(tmp_path):
    """Legacy FSG1 segments (no pyramids) serve through the payload
    fallback; compaction backfills their pyramids, and a fresh reader then
    folds bucket nodes with no payload, as the reference's."""
    with mock.patch.object(ref_osmod, "_MAGIC", b"FSG1"), \
            mock.patch.object(osmod, "_MAGIC", b"FSG1"):
        env = Env(tmp_path, flushes=2)
    assert not glob.glob(str(tmp_path / "**" / "*.pyr"), recursive=True)
    fb0 = pyrmod.PYR_FALLBACK.value
    got, rctx, payload, ref_payload = _same_answer(
        env, "max_over_time(heap_usage[4000s])", *ALIGNED)
    assert pyrmod.PYR_FALLBACK.value > fb0
    assert payload == ref_payload
    _same_pyramid_stats(got, rctx)
    assert got.stats.pyramid["decodeNodes"] > 0
    bf0 = pyrmod.PYR_BACKFILLED.value
    removed = sum(env.pcs.compact(DS, s) for s in range(2))
    for s in range(2):
        env.rcs.compact(DS, s)
    env.pcs.flush()
    env.rcs.flush()
    assert removed > 0 and pyrmod.PYR_BACKFILLED.value > bf0
    assert glob.glob(os.path.join(env.port_root, "**", "*.pyr"),
                     recursive=True)
    env.open_readers()
    got, rctx, payload, _ = _same_answer(
        env, "max_over_time(heap_usage[6100s])", START + 5990, 300,
        START + 5990)
    assert payload == 0
    _same_pyramid_stats(got, rctx)
    assert got.stats.pyramid["bucketNodes"] == 6


def test_read_race_missing_pyramid_objects_never_error(tmp_path):
    """The manifest names pyramids a compaction already deleted: the
    reader demotes to the chunk fallback and stays exact."""
    env = Env(tmp_path)
    for root in (env.ref_root, env.port_root):
        pyrs = glob.glob(os.path.join(root, "**", "*.pyr"), recursive=True)
        assert pyrs
        for f in pyrs:
            os.remove(f)
    fb0 = pyrmod.PYR_FALLBACK.value
    got, rctx, payload, ref_payload = _same_answer(
        env, "sum_over_time(heap_usage[4000s])", *ALIGNED)
    assert pyrmod.PYR_FALLBACK.value > fb0
    assert payload == ref_payload
    _same_pyramid_stats(got, rctx)
    assert not got.warnings


# ---- the approximate lane --------------------------------------------------------


def test_quantile_served_from_sketches_within_bounds(one_flush, monkeypatch):
    q = "quantile_over_time(0.9,heap_usage[4000s])"
    ctl, _ = one_flush.ref_run(q, *ALIGNED, planner=RefPlanner(DS, 2,
                                                              spread=0))
    monkeypatch.setenv("FILODB_SIDECAR_APPROX", "1")
    one_flush.cold.clear_caches()
    got = one_flush.port_run(q, *ALIGNED)
    assert got.stats.pyramid
    gk, gv = _sorted(got.result.materialize())
    wk, want = _sorted(ctl.result)
    assert gk == wk
    ratio = gv / want
    assert np.isfinite(ratio).all()
    assert (ratio >= 0.45).all() and (ratio <= 2.2).all()
    # the reference's approximate answer, bucket for bucket
    with mock.patch.dict(os.environ, {"FILODB_SIDECAR_APPROX": "1"}):
        rr, _ = one_flush.ref_run(q, *ALIGNED)
    np.testing.assert_array_equal(gv, _sorted(rr.result)[1])


def test_quantile_exact_without_declared_approx(one_flush):
    q = "quantile_over_time(0.9,heap_usage[4000s])"
    got, rctx, _, _ = _same_answer(one_flush, q, *ALIGNED,
                                   tol=dict(rtol=1e-9, equal_nan=True))
    assert not got.stats.pyramid and not rctx.stats.pyramid


def test_topk_and_cardinality_summary_only(compacted, monkeypatch):
    store = compacted.cold
    with pytest.raises(RuntimeError, match="FILODB_SIDECAR_APPROX"):
        store.approx_topk(3)
    with pytest.raises(RuntimeError, match="FILODB_SIDECAR_APPROX"):
        store.approx_cardinality()
    monkeypatch.setenv("FILODB_SIDECAR_APPROX", "1")
    payload0 = osmod.PAYLOAD_BYTES_DOWN.value
    top = store.approx_topk(10)
    card = store.approx_cardinality()
    assert osmod.PAYLOAD_BYTES_DOWN.value == payload0
    ref_store = compacted.ref_planner.cold_planner.store
    want = ref_store.approx_topk(10)
    assert top == want
    assert card == ref_store.approx_cardinality()
    ctl, _ = compacted.ref_run("max_over_time(heap_usage[6100s])",
                               START + 5990, 300, START + 5990,
                               planner=RefPlanner(DS, 2, spread=0))
    truth = {k.label_map["instance"]: float(ctl.result.values[i, -1])
             for i, k in enumerate(ctl.result.keys)}
    assert len(top) == 6
    assert {e["labels"]["instance"]: e["value"] for e in top} \
        == pytest.approx(truth)
    assert abs(card - 6) / 6 < 0.10


# ---- attribution ------------------------------------------------------------------


def test_tier_buckets_and_promjson_pyramid_keys(one_flush):
    from filodb_tpu_torch.http.promjson import matrix_json_str

    one_flush.cold.clear_caches()
    got, rctx, _, _ = _same_answer(
        one_flush, "sum_over_time(heap_usage[4000s])", *ALIGNED)
    p = got.stats.pyramid
    for k in ("segmentNodes", "chunkNodes", "decodeNodes", "pyramidBytes",
              "payloadBytes"):
        assert k in p, k
    tier = got.stats.tiers[OBJECTSTORE]
    assert tier["pyramidBytes"] == p["pyramidBytes"]
    assert tier["payloadBytes"] == p["payloadBytes"]
    assert set(tier) == set(rctx.stats.tiers[OBJECTSTORE])
    full = json.loads(matrix_json_str(got, full_stats=True))
    assert full["queryStats"]["pyramid"]["payloadBytes"] == 0
    brief = json.loads(matrix_json_str(got, full_stats=False))
    assert "pyramid" not in brief["queryStats"]


def test_values_float32_does_not_hold_bypass_at_the_edges(tmp_path):
    """Gauges float32 does not hold: an aligned scan still folds (no edge),
    a seam window bypasses at its edge chunks to the decode lane, and both
    answer as the reference."""
    env = Env(tmp_path, exact=False)
    got, rctx, payload, _ = _same_answer(
        env, "sum_over_time(heap_usage[4000s])", *ALIGNED)
    assert payload == 0 and got.stats.pyramid
    _same_pyramid_stats(got, rctx)
    got, _, _, _ = _same_answer(env, "sum_over_time(heap_usage[40m])",
                                START + 1000, 700, START + 3500)
    assert got.stats.sidecar_bypassed.get(
        "values float32 does not hold", 0) > 0


def test_tier_status_counts_the_buckets_segments(one_flush):
    """``status/tiers``' cold tier over an object store reports its series,
    bytes and segments, as the reference's does."""
    got = one_flush.cold.tier_stats()
    want = one_flush.ref_planner.cold_planner.store.tier_stats()
    assert got["series"] == want["series"] == 6
    assert got["segments"] > 0 and got["bytes"] > 0
    assert want["segments"] > 0 and want["bytes"] > 0
