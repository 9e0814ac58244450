"""The port's chunk summaries and sidecar lane against the JAX package's
(``tests/test_sidecars.py``):

- the summary fold: the host codec's ``summarize`` and the port's
  ``summarize_values`` bitwise equal to the reference's, NaN samples,
  resets, all-NaN chunks and signed zeros included; merged segments equal
  to the whole series; the sketch quantile's bounds;
- the ``SC01`` section byte-equal both ways, summaries made again from
  every codec bitwise the stored ones, and the summaries a shard seals
  into its chunk table and writes at flush;
- the lane: every eligible function at one step, two steps and a wider
  grid, the port's exec engine at ``FILODB_SIDECARS=1`` against the
  reference's exec at 1 (rtol 2e-5, atol 1e-9, the reference's own
  tolerance), ``decode`` bitwise equal to ``1``, ``0`` against the
  reference at 0; the bypasses counted; the approximate quantile; the
  mesh engine handing grids of at most two steps to the lane and keeping
  wider ones.

The series are the reference test's shapes (gauges, counters with resets
every 120 samples, gauges with NaN every 7th sample) with values exact in
float32, since the port's edge chunks and write buffers decode from
float32 device pages.
"""

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.record import IngestRecord, RecordContainer
from filodb_tpu.core.record import SomeData as RefSomeData
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.memory import chunk as rchunk
from filodb_tpu.query.engine import sidecar_lane as ref_lane
from filodb_tpu.query.engine.aggregations import sketch_quantile as ref_sq
from filodb_tpu.testing.data import counter_series, machine_metrics_series
from filodb_tpu_torch.coordinator.ingestion import route_container
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import RecordContainer as PortContainer
from filodb_tpu_torch.core.record import SomeData
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.memory import chunk as pchunk
from filodb_tpu_torch.query.engine import sidecar_lane

NUM_SHARDS = 4
START = 1_600_000_000
INTERVAL = 10_000
N_SAMPLES = 400
QS, QE = START + 2000, START + 3950

GAUGE_FNS = ["count_over_time", "sum_over_time", "avg_over_time",
             "min_over_time", "max_over_time", "stddev_over_time",
             "stdvar_over_time", "last_over_time", "present_over_time",
             "changes", "zscore", "timestamp"]
COUNTER_FNS = ["rate", "increase", "delta", "resets"]


# ---------------------------------------------------------------- fixtures

def _stream(keys, values):
    """Containers of 100 records, sample after sample over ``keys``;
    ``values`` [n_samples, n_keys]."""
    container, offset, out = RecordContainer(), 0, []
    for s in range(values.shape[0]):
        for j, k in enumerate(keys):
            container.add(IngestRecord(k, START * 1000 + s * INTERVAL,
                                       (float(values[s, j]),)))
            if len(container) >= 100:
                out.append(RefSomeData(container, offset))
                offset += 1
                container = RecordContainer()
    if len(container):
        out.append(RefSomeData(container, offset))
    return out


def _streams():
    rng = np.random.default_rng(11)
    gauges = np.round((40.0 + rng.normal(0, 3.0, (N_SAMPLES, 6))) * 64) / 64
    counts = np.cumsum(rng.integers(0, 20, (N_SAMPLES, 4)), 0).astype(float)
    for r in (120, 240, 360):  # genuine resets
        counts[r:] -= counts[r] - rng.integers(0, 5, 4)
    spotty = np.round((40.0 + rng.normal(0, 3.0, (N_SAMPLES, 3))) * 64) / 64
    s, j = np.meshgrid(np.arange(N_SAMPLES), np.arange(3), indexing="ij")
    spotty[(s + j) % 7 == 0] = np.nan
    return [
        _stream(machine_metrics_series(6), gauges),
        _stream(counter_series(4), counts),
        _stream(machine_metrics_series(3, metric="spotty_gauge",
                                       ns="App-3"), spotty),
    ]


@pytest.fixture(autouse=True)
def _cold_port_cost_models():
    """Every test starts with the port's cost models cold, as
    ``tests/conftest.py`` starts the reference's: the models are
    process-global, and one warmed by an earlier test file on the same
    worker would pick the sidecar site's arm here."""
    from filodb_tpu_torch.query import cost_model

    cost_model.reset_models()
    yield
    cost_model.reset_models()


@pytest.fixture(scope="module")
def stores():
    """The same containers in a reference store and in the port's, 4
    shards, spread 1, chunks of 50: every window spans several sealed
    chunks and the write buffer."""
    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup("timeseries", s, RefConfig(max_chunk_size=50,
                                             groups_per_shard=4))
    port = MemStore(NUM_SHARDS, 1, config=StoreConfig(max_chunk_size=50,
                                                      groups_per_shard=4))
    for stream in _streams():
        ingest_routed(ref, "timeseries", stream, NUM_SHARDS, spread=1)
        for sd in stream:
            raw = PortContainer.deserialize(sd.container.serialize())
            for shard, c in route_container(raw, NUM_SHARDS, 1).items():
                port.shards[shard].ingest(SomeData(c, sd.offset))
    return ref, port


@pytest.fixture(scope="module")
def services(stores):
    ref, port = stores
    return (RefService(ref, "timeseries", NUM_SHARDS, spread=1,
                       engine="exec"),
            QueryService(port, device="cpu", engine="exec"))


def _q(svc, monkeypatch, mode, promql, qs=QS, qe=QE, step=60):
    monkeypatch.setenv("FILODB_SIDECARS", mode)
    return svc.query_range(promql, qs, step, qe)


def _by_key(result):
    m = result.result
    return {str(k): np.asarray(m.values[i], np.float64)
            for i, k in enumerate(m.keys)}


def assert_same(a, b, bitwise: bool, rtol: float = 2e-5):
    ka, kb = _by_key(a), _by_key(b)
    assert set(ka) == set(kb)
    for k, va in ka.items():
        vb = kb[k]
        if bitwise:
            assert va.tobytes() == vb.tobytes(), k
        else:
            na, nb = np.isnan(va), np.isnan(vb)
            assert np.array_equal(na, nb), k
            np.testing.assert_allclose(va[~na], vb[~nb], rtol=rtol,
                                       atol=1e-9, err_msg=k)


# ---------------------------------------------------------- summary algebra

def _bits(cs):
    return cs.stats.tobytes(), cs.sketch.tobytes()


def test_stats_exclude_nan_and_track_resets():
    ts = np.arange(1000, 11000, 1000, dtype=np.int64)
    vals = np.array([5.0, np.nan, 7.0, 3.0, 3.0, np.nan, 9.0, 2.0, 2.0, 4.0])
    cs = pchunk.summarize_values(ts, vals)
    st = cs.stats
    assert st[pchunk.S_COUNT] == 8 and st[pchunk.S_RESETS] == 2
    assert st[pchunk.S_CORR] == 16.0 and st[pchunk.S_CHANGES] == 5
    assert _bits(cs) == _bits(rchunk.summarize_values(ts, vals))
    stats, sketch = pchunk.summarize(ts[None], vals[None], np.array([10]))
    assert stats[0].tobytes() == cs.stats.tobytes()
    assert sketch[0].tobytes() == cs.sketch.tobytes()


def test_empty_and_all_nan():
    ts = np.array([1, 2, 3], dtype=np.int64)
    for vals in (np.array([], np.float64), np.full(3, np.nan)):
        t = ts[:len(vals)]
        cs = pchunk.summarize_values(t, vals)
        assert cs.stats[pchunk.S_COUNT] == 0
        assert np.isnan(cs.stats[pchunk.S_MIN:pchunk.S_LAST_VAL + 1]).all()
        assert _bits(cs) == _bits(rchunk.summarize_values(t, vals))
    stats, sketch = pchunk.summarize(np.zeros((1, 3), np.int64),
                                     np.full((1, 3), np.nan), np.array([3]))
    assert stats[0].tobytes() == rchunk.summarize_values(
        ts, np.full(3, np.nan)).stats.tobytes()
    assert sketch.sum() == 0


@pytest.mark.parametrize("case", ["random", "nan", "resets", "all_nan",
                                  "signed_zeros", "infinities", "one_row",
                                  "tiny"])
def test_the_host_codec_summaries_are_the_reference_bits(case):
    """``summarize`` (host C++, many chunks a call) against the reference's
    ``summarize_values`` chunk by chunk, bit for bit."""
    rng = np.random.default_rng(hash(case) % 2**32)
    C, M = 64, 50
    ts = np.cumsum(rng.integers(1, 2000, (C, M)), 1)
    vals = rng.normal(0, 100, (C, M))
    rows = rng.integers(1, M + 1, C)
    if case == "nan":
        vals[rng.random((C, M)) < 0.2] = np.nan
    elif case == "resets":
        vals = np.cumsum(rng.integers(0, 9, (C, M)), 1).astype(float)
        vals[:, 25:] -= vals[:, 25:26] - 1
    elif case == "all_nan":
        vals[::2] = np.nan
    elif case == "signed_zeros":
        vals = rng.choice([-0.0, 0.0, 1.0, -1.0], (C, M))
    elif case == "infinities":
        vals[:, ::5] = np.inf
        vals[:, 1::7] = -np.inf
    elif case == "one_row":
        rows[:] = 1
    elif case == "tiny":
        vals = vals * 1e-310  # subnormals
    stats, sketch = pchunk.summarize(ts, vals, rows)
    for c in range(C):
        want = rchunk.summarize_values(ts[c, :rows[c]], vals[c, :rows[c]])
        assert stats[c].tobytes() == want.stats.tobytes(), c
        assert sketch[c].tobytes() == want.sketch.tobytes(), c


def test_merge_matches_whole_series_bitwise():
    """Splitting a series anywhere and merging the halves' stats gives the
    whole series' stats, a reset on the split included."""
    rng = np.random.default_rng(17)
    n = 60
    ts = np.arange(n, dtype=np.int64) * 1000 + 1000
    vals = np.cumsum(rng.integers(0, 9, n).astype(np.float64))
    vals[37:] -= vals[37]
    whole = pchunk.summarize_values(ts, vals).stats
    for cut in (1, 20, 37, 59):
        a = torch.from_numpy(pchunk.summarize_values(ts[:cut],
                                                     vals[:cut]).stats[None])
        b = torch.from_numpy(pchunk.summarize_values(ts[cut:],
                                                     vals[cut:]).stats[None])
        merged = sidecar_lane.merge(a, b).numpy()[0]
        assert merged.tobytes() == whole.tobytes(), cut
        assert merged.tobytes() == ref_lane._merge_vec(
            a.numpy(), b.numpy())[0].tobytes()


def test_sketch_quantile_bounds():
    sk = np.zeros(pchunk.SKETCH_BUCKETS, np.int64)
    sk[40] = 10
    assert sidecar_lane.sketch_quantile(-0.1, sk) == -np.inf
    assert sidecar_lane.sketch_quantile(1.1, sk) == np.inf
    for q in (0.0, 0.5, 0.9, 1.0):
        assert sidecar_lane.sketch_quantile(q, sk) == ref_sq(q, sk)


# ------------------------------------------------------------ chunk format

TS = np.arange(1000, 51000, 1000, dtype=np.int64)
GAUGE, RGAUGE = SCHEMAS["gauge"], DEFAULT_SCHEMAS["gauge"]


def test_the_summary_section_is_byte_equal_both_ways():
    vals = np.sin(np.arange(50)) * 100
    port = pchunk.encode_chunk(GAUGE, TS, [vals], 3, with_summary=True)
    ref = rchunk.encode_chunk(RGAUGE, TS, [vals], 3)
    assert port.serialize() == ref.serialize()
    back = pchunk.Chunk.deserialize(ref.serialize())
    assert back.summary[0] is None
    assert back.summary[1].stats.tobytes() == ref.summary[1].stats.tobytes()
    assert np.array_equal(back.summary[1].sketch, ref.summary[1].sketch)
    assert back.vectors == ref.vectors
    assert rchunk.Chunk.deserialize(port.serialize()).summary[1].stats \
        .tobytes() == ref.summary[1].stats.tobytes()
    # without it: the layout older readers know, summary None
    old = pchunk.encode_chunk(GAUGE, TS, [vals], 3)
    assert old.serialize() == port.serialize()[:len(old.serialize())]
    assert pchunk.Chunk.deserialize(old.serialize()).summary is None


@pytest.mark.parametrize("codec,vals", [
    ("const", np.full(50, 42.5)),
    ("xor-double", np.sin(np.arange(50)) * 100 + 7),
    ("nan-bearing", np.where(np.arange(50) % 7 == 0, np.nan,
                             np.arange(50, dtype=np.float64))),
])
def test_recompute_matches_stored_bitwise(codec, vals):
    stored = pchunk.encode_chunk(GAUGE, TS, [vals], with_summary=True)
    bare = pchunk.Chunk.deserialize(pchunk.encode_chunk(
        GAUGE, TS, [vals]).serialize())
    again = pchunk.ensure_summary(bare)
    assert again[1].stats.tobytes() == stored.summary[1].stats.tobytes()
    assert np.array_equal(again[1].sketch, stored.summary[1].sketch)
    assert again[1].stats.tobytes() == rchunk.ensure_summary(
        rchunk.Chunk.deserialize(bare.serialize()))[1].stats.tobytes()


def test_ensure_summary_memoizes_and_tolerates_garbage():
    ch = pchunk.Chunk(1, 10, 0, 9, (b"\x99garbage", b"\x98junk"))
    assert pchunk.ensure_summary(ch) is None
    good = pchunk.encode_chunk(GAUGE, TS, [np.arange(50, dtype=np.float64)])
    s1 = pchunk.ensure_summary(good)
    assert s1 is not None and pchunk.ensure_summary(good) is s1


def test_sealed_chunks_carry_their_summaries_and_flush_them(tmp_path):
    """A shard seals each chunk with its summary (bitwise the reference's
    for the same samples), writes it in the chunk's section at flush, and
    a page-in reads it back."""
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.testing.from_jax import open_local

    ms = open_local(str(tmp_path), config=StoreConfig(max_chunk_size=50))
    shard = ms.shards[0]
    key = PartKey.create("prom-counter", {"_metric_": "c", "i": "0"})
    vals = np.cumsum(np.arange(120) % 7).astype(float)
    vals[60:] -= 30.0
    vals[7] = np.nan
    shard.ingest_series([key], TS[None, :1].repeat(1, 0) + np.arange(
        120)[None] * 1000, vals[None], np.array([120]))
    shard.seal(np.array([0]))
    ch = shard.chunks
    ts = 1000 + np.arange(120) * 1000
    for i, (a, b) in enumerate(((0, 50), (50, 100), (100, 120))):
        want = rchunk.summarize_values(ts[a:b], vals[a:b])
        assert ch["stats_value"][i].tobytes() == want.stats.tobytes()
        assert ch["sketch_value"][i].tobytes() == want.sketch.tobytes()
    shard.flush_all()
    rows = ms.column_store.read_chunk_rows("timeseries", 0,
                                           [key.serialized], 0, 2**62)
    for (_, data), i in zip(rows, range(3)):
        got = rchunk.Chunk.deserialize(bytes(data)).summary[1]
        assert got.stats.tobytes() == ch["stats_value"][i].tobytes()
    shard.evict_partition_chunks([0])
    shard.select_for_batch(np.array([0]), 0, 2**40, False)
    paged = shard.odp_cache.tables[False].columns
    assert paged["stats_value"].tobytes() == ch["stats_value"].tobytes()
    ms.close()


# --------------------------------------------------- lane query equivalence

def _sweep(services, monkeypatch, promql, qs=QS, qe=QE, step=60,
           present=True):
    """The port at 1 served from summaries, bitwise equal to the port at
    ``decode``, and within the reference's tolerance of the reference's
    exec at 1; the port at 0 against the reference at 0."""
    ref, port = services
    served = sidecar_lane.SIDECAR_SERVED.value
    p1 = _q(port, monkeypatch, "1", promql, qs, qe, step)
    assert sidecar_lane.SIDECAR_SERVED.value > served, promql
    assert (p1.result.num_series > 0) == present
    pd = _q(port, monkeypatch, "decode", promql, qs, qe, step)
    assert_same(p1, pd, bitwise=True)
    assert_same(p1, _q(ref, monkeypatch, "1", promql, qs, qe, step),
                bitwise=False)
    assert_same(_q(port, monkeypatch, "0", promql, qs, qe, step),
                _q(ref, monkeypatch, "0", promql, qs, qe, step),
                bitwise=False)
    return p1


GRIDS = {"one_step": (QE, QE), "two_steps": (QE - 60, QE), "wide": (QS, QE)}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("fn", GAUGE_FNS)
def test_gauge_functions(services, monkeypatch, fn, grid):
    _sweep(services, monkeypatch, f"{fn}(heap_usage[30m])", *GRIDS[grid])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("fn", COUNTER_FNS)
def test_counter_functions_with_genuine_resets(stores, services,
                                               monkeypatch, fn, grid):
    port = stores[1]
    assert sum(float(s.chunks["stats_value"][:, pchunk.S_RESETS].sum())
               for s in port.shards) > 0
    _sweep(services, monkeypatch, f"{fn}(http_requests_total[30m])",
           *GRIDS[grid])


@pytest.mark.parametrize("grid", GRIDS)
def test_absent_over_time_and_the_instant_selector(services, monkeypatch,
                                                   grid):
    _sweep(services, monkeypatch, "heap_usage", *GRIDS[grid])
    # present series: absent answers nothing, from the lane too
    _sweep(services, monkeypatch, "absent_over_time(heap_usage[30m])",
           *GRIDS[grid], present=False)


def test_nan_bearing_series(services, monkeypatch):
    for fn in ("avg_over_time", "count_over_time", "max_over_time",
               "changes"):
        _sweep(services, monkeypatch, f"{fn}(spotty_gauge[30m])")


def test_aggregations_and_grouping(services, monkeypatch):
    for q in ("sum(rate(http_requests_total[20m]))",
              "avg by (host) (sum_over_time(heap_usage[25m]))",
              "max(max_over_time(heap_usage[30m]))"):
        _sweep(services, monkeypatch, q)


def test_windows_cover_multiple_chunks(services, monkeypatch):
    r1 = _sweep(services, monkeypatch, "sum_over_time(heap_usage[30m])")
    assert r1.stats.sidecar_chunks >= 3
    assert r1.stats.chunks_touched >= r1.stats.sidecar_chunks
    assert r1.stats.samples_scanned > 0


def test_query_stats_count_as_the_reference_lane(services, monkeypatch):
    """samples_scanned is the samples the windows account for, as the
    reference's lane counts them."""
    ref, port = services
    q = ("avg_over_time(heap_usage[30m])", START + 2500, 60, START + 3800)
    p1 = _q(port, monkeypatch, "1", q[0], q[1], q[3], q[2])
    r1 = _q(ref, monkeypatch, "1", q[0], q[1], q[3], q[2])
    assert p1.stats.samples_scanned == r1.stats.samples_scanned
    assert p1.stats.sidecar_chunks == r1.stats.sidecar_chunks
    assert p1.stats.chunks_touched == r1.stats.chunks_touched
    p0 = _q(port, monkeypatch, "0", q[0], q[1], q[3], q[2])
    assert p0.stats.sidecar_chunks == 0


# ------------------------------------------------------ valve and bypasses

def test_valve_off_never_serves(services, monkeypatch):
    served = sidecar_lane.SIDECAR_SERVED.value
    r = _q(services[1], monkeypatch, "0", "sum_over_time(heap_usage[10m])")
    assert r.result.num_series > 0
    assert sidecar_lane.SIDECAR_SERVED.value == served


@pytest.mark.parametrize("promql", [
    "quantile_over_time(0.9, heap_usage[10m])",   # not eligible
    f"sum_over_time(heap_usage[10m] @ {QE})",     # an @ pin
])
def test_a_bypass_is_counted_and_answers_as_the_decode_lane(
        services, monkeypatch, promql):
    monkeypatch.delenv("FILODB_SIDECAR_APPROX", raising=False)
    port = services[1]
    bypassed = sidecar_lane.SIDECAR_BYPASSED.value
    served = sidecar_lane.SIDECAR_SERVED.value
    got = _q(port, monkeypatch, "1", promql)
    assert sidecar_lane.SIDECAR_BYPASSED.value > bypassed
    assert sidecar_lane.SIDECAR_SERVED.value == served
    assert_same(got, _q(port, monkeypatch, "0", promql), bitwise=True)


def test_the_sealed_gate_bypasses_past_its_partition_windows(
        services, monkeypatch):
    monkeypatch.setenv("FILODB_SIDECAR_SEALED_GATE", "4")
    bypassed = sidecar_lane.SIDECAR_BYPASSED.value
    _q(services[1], monkeypatch, "1", "sum_over_time(heap_usage[30m])")
    assert sidecar_lane.SIDECAR_BYPASSED.value > bypassed


def test_histograms_and_paged_partitions_bypass(tmp_path, monkeypatch):
    """A histogram column and a partition whose flushed chunks memory no
    longer holds (demand paging) go to the decode lane, counted."""
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.testing.from_jax import open_local

    ms = open_local(str(tmp_path), config=StoreConfig(max_chunk_size=50))
    key = PartKey.create("gauge", {"_metric_": "g", "i": "0"})
    ts = (1000 + np.arange(200) * 1000)[None]
    ms.shards[0].ingest_series([key], ts, np.arange(200.0)[None],
                               np.array([200]))
    ms.ingest_histogram({"_metric_": "h", "i": "0"}, ts[0, :60],
                        np.cumsum(np.ones((60, 3), np.int64), 0),
                        np.array([1.0, 2.0, np.inf]))
    svc = QueryService(ms, device="cpu", engine="exec")
    for q in ("rate(h[1m])", "sum_over_time(g[1m])"):
        if q.startswith("sum"):
            ms.flush_all()
            ms.shards[0].evict_partition_chunks([0])
        bypassed = sidecar_lane.SIDECAR_BYPASSED.value
        got = _q(svc, monkeypatch, "1", q, 100, 180, 10)
        assert sidecar_lane.SIDECAR_BYPASSED.value == bypassed + 1, q
        assert_same(got, _q(svc, monkeypatch, "0", q, 100, 180, 10),
                    bitwise=True)
    ms.close()


def test_quantile_served_only_under_declared_approx(services, monkeypatch):
    ref, port = services
    monkeypatch.setenv("FILODB_SIDECAR_APPROX", "1")
    q = "quantile_over_time(0.9, heap_usage[30m])"
    served = sidecar_lane.SIDECAR_SERVED.value
    got = _q(port, monkeypatch, "1", q, QS, QS + 1000)
    assert sidecar_lane.SIDECAR_SERVED.value > served
    # float32-exact values: the same sketches, the same answers
    assert_same(got, _q(ref, monkeypatch, "1", q, QS, QS + 1000),
                bitwise=False, rtol=0)
    exact = _by_key(_q(port, monkeypatch, "0", q, QS, QS + 1000))
    for k, a in _by_key(got).items():
        b = exact[k]
        both = ~np.isnan(a) & ~np.isnan(b) & (b > 0)
        assert np.all(a[both] <= b[both] * 2.0 + 1e-9)
        assert np.all(a[both] >= b[both] * 0.25 - 1e-9)


# -------------------------------------------------------- mesh delegation

@pytest.mark.parametrize("mode,engine_k1", [("1", "exec"), ("0", "mesh")])
def test_mesh_hands_two_step_grids_to_the_lane(stores, monkeypatch, mode,
                                               engine_k1):
    svc = QueryService(stores[1], device="cpu")
    monkeypatch.setenv("FILODB_SIDECARS", mode)
    one = svc.query_range("sum(rate(http_requests_total[5m]))", QE, 60, QE)
    two = svc.query_range("sum(rate(http_requests_total[5m]))", QE - 60, 60,
                          QE)
    wide = svc.query_range("sum(rate(http_requests_total[5m]))", QE - 1920,
                           60, QE)
    assert one.stats.engine == two.stats.engine == engine_k1
    if engine_k1 == "exec":
        assert one.stats.fallback.startswith("sidecar delegation")
    assert wide.stats.engine == "mesh"
    np.testing.assert_allclose(np.asarray(one.result.values)[:, -1],
                               np.asarray(wide.result.values)[:, -1],
                               rtol=2e-5)
    # an engine built directly does not delegate
    from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
    assert not MeshQueryEngine(torch.device("cpu")).sidecars
