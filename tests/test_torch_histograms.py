"""Port parity for first-class histograms: ``prom-histogram`` ingest,
bucket pages, ``assemble_hist``, per-bucket range functions and
aggregations, ``histogram_quantile`` (native and over ``le``-labelled
series) and Prom JSON.

The same series, made with numpy from a seed, go into a JAX store (device
pages on, 4 shards, spread 1, 64-sample chunks) and, through
``testing.from_jax``, into the port's ``MemStore`` chunk for chunk. Pages
are compared byte for byte, ``assemble_hist`` bit for bit in float64
against ``_assemble_hist``, and ``query_range`` against both reference
engines, each lane named (``engine="exec"`` over device pages with
``FILODB_SIDECARS`` at 0 and at 1 — histogram columns bypass the sidecar
folds, the ``le`` counters do not — and ``engine="mesh"``, which serves
histograms under no aggregation or ``sum`` and hands the rest to exec) at
the reference's tolerance for its device path, ``rtol=5e-5, atol=1e-4``
(``tests/test_device_path.py:116``).

Metrics of the store:

- ``lat``: cumulative bucket counts of ``DefBuckets``-like bounds (10
  buckets), series of staggered lengths; one series resets every bucket,
  one resets a single bucket, one stops counting (windows of zero total);
- ``lat_small``: per-scrape bucket counts that do not accumulate, for the
  moment-based functions (stddev, zscore, deriv), whose E[x²] − E[x]² form
  cancels at large cumulative counts in both packages alike;
- ``lat_mixed``: series of 10 and of 5 buckets in one selection (the
  shorter zero-padded);
- ``lat_switch``: a series changing scheme mid-series (5 buckets, then 10),
  which seals a chunk where the reference's partition seals it, beside one
  of 10 buckets. The mesh engine cannot read it (``read_samples``
  concatenates rows of both widths and raises; ROADMAP §C), so it is held
  against exec;
- ``lat_bucket``: the classic Prometheus form, ``prom-counter`` series with
  an ``le`` label, one group with non-monotonic buckets.
"""

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord, RecordContainer, SomeData
from filodb_tpu.core.store.config import StoreConfig
from filodb_tpu.http.promjson import matrix_json as ref_matrix_json
from filodb_tpu.promql.parser import ParseError as RefParseError
from filodb_tpu.query.engine import device_batch as ref_db
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.http.promjson import matrix_json
from filodb_tpu_torch.memory.codecs import HistogramColumn
from filodb_tpu_torch.parallel.mesh_engine import UnsupportedQuery, lower_plan
from filodb_tpu_torch.promql.parser import ParseError, TimeStepParams
from filodb_tpu_torch.promql.parser import parse_query as port_parse
from filodb_tpu_torch.query.engine import device_batch as port_db
from filodb_tpu_torch.testing.from_jax import SeriesState, ingest_states
from test_torch_slice import reference_lanes

DS = "timeseries"
NUM_SHARDS = 4
CHUNK = 64
START_S = 1_600_000_000
Q_START, Q_STEP, Q_END = START_S + 600, 60, START_S + 2400
TOL = dict(rtol=5e-5, atol=1e-4, equal_nan=True)
LES10 = np.array([0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, np.inf])
LES5 = np.array([0.1, 0.5, 1.0, 5.0, np.inf])


def _le(x: float) -> str:
    return "+Inf" if np.isinf(x) else repr(float(x))


def _hist_specs():
    """(labels, ts [n], [(les, counts [n_i, B_i]), ...] covering ts)."""
    rng = np.random.default_rng(17)
    specs = []

    def jittered(n):
        return (START_S * 1000 + np.arange(n) * 10_000
                + rng.integers(-500, 501, n)).astype(np.int64)

    for i in range(12):
        n = int(rng.integers(150, 300))
        per = np.cumsum(rng.integers(0, 5, (n, 10)), axis=1)
        counts = np.cumsum(per, axis=0)
        if i == 0:                       # every bucket resets
            counts[n // 2:] -= counts[n // 2] - per[n // 2]
        if i == 1:                       # one bucket resets
            counts[n // 3:, 3] -= counts[n // 3, 3]
        if i == 2:                       # stops counting: zero totals
            counts[n // 2:] = counts[n // 2]
        specs.append(({"_metric_": "lat", "_ws_": "demo",
                       "_ns_": f"App-{i % 2}", "instance": f"instance-{i}",
                       "job": f"job-{i % 3}"}, jittered(n), [(LES10, counts)]))
    for i in range(6):
        n = int(rng.integers(150, 250))
        counts = np.cumsum(rng.integers(0, 6, (n, 10)), axis=1)
        specs.append(({"_metric_": "lat_small", "_ws_": "demo",
                       "_ns_": "App-0", "instance": f"instance-{i}",
                       "job": f"job-{i % 2}"}, jittered(n), [(LES10, counts)]))
    for i in range(8):
        n = int(rng.integers(180, 260))
        les = LES10 if i % 2 else LES5
        counts = np.cumsum(np.cumsum(rng.integers(0, 4, (n, len(les))),
                                     axis=1), axis=0)
        segs = [(les, counts)]
        metric = "lat_mixed" if i < 6 else "lat_switch"
        if i == 6:                       # 5 buckets, then 10 from sample 90
            more = np.cumsum(np.cumsum(rng.integers(0, 4, (n - 90, 10)),
                                       axis=1), axis=0)
            segs = [(LES5, counts[:90]), (LES10, more)]
        specs.append(({"_metric_": metric, "_ws_": "demo",
                       "_ns_": "App-1", "instance": f"instance-{i}",
                       "job": f"job-{i % 2}"}, jittered(n), segs))
    return specs


def _flat_specs(hist_specs):
    """``lat_bucket{le=...}`` prom-counter series from the first four
    ``lat`` series; in the fourth, buckets 4 and 5 are swapped
    (non-monotonic)."""
    out = []
    for labels, ts, [(les, counts)] in hist_specs[:4]:
        c = counts.astype(np.float64)
        if labels["instance"] == "instance-3":
            c[:, [4, 5]] = c[:, [5, 4]]
        for b, le in enumerate(les):
            out.append(({**labels, "_metric_": "lat_bucket", "le": _le(le)},
                        ts, c[:, b]))
    return out


def _reference_store(hist_specs, flat_specs):
    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, StoreConfig(max_chunk_size=CHUNK, groups_per_shard=2,
                                     device_pages=True))
    stream = []
    for labels, ts, segs in hist_specs:
        key = RefPartKey.create("prom-histogram", labels)
        c, a = RecordContainer(), 0
        for les, counts in segs:
            for row in counts:
                c.add(IngestRecord(key, int(ts[a]), (
                    0.2 * float(row[-1]), float(row[-1]),
                    (les, row.astype(np.int64)))))
                a += 1
        stream.append(SomeData(c, len(stream)))
    for labels, ts, vals in flat_specs:
        key = RefPartKey.create("prom-counter", labels)
        c = RecordContainer()
        for t, v in zip(ts, vals):
            c.add(IngestRecord(key, int(t), (float(v),)))
        stream.append(SomeData(c, len(stream)))
    ingest_routed(ref, DS, iter(stream), NUM_SHARDS, spread=1)
    return ref


def _states(ref):
    """Every reference partition as a ``SeriesState``, chunk for chunk."""
    states = []
    for shard in ref.shards_for(DS):
        for p in shard.partitions:
            b = p._buf
            ts = np.concatenate([c.decode_column(0) for c in p.chunks]
                                + [b.ts[: b.n]])
            rows = [c.num_rows for c in p.chunks]
            if p.schema.name == "prom-histogram":
                hist = [c.decode_column(3) for c in p.chunks]
                hist = [HistogramColumn(h.les, h.rows) for h in hist]
                if b.n:
                    hist.append(HistogramColumn(p.bucket_les,
                                                b.cols[2][: b.n]))
                states.append(SeriesState(p.schema.name, p.part_key.label_map,
                                          ts, None, rows, hist))
            else:
                vals = np.concatenate([np.asarray(c.decode_column(1))
                                       for c in p.chunks]
                                      + [b.cols[0][: b.n]])
                states.append(SeriesState(p.schema.name, p.part_key.label_map,
                                          ts, vals, rows))
    return states


@pytest.fixture(scope="module")
def stores():
    specs = _hist_specs()
    ref = _reference_store(specs, _flat_specs(specs))
    port = MemStore(NUM_SHARDS, spread=1, max_chunk_size=CHUNK)
    ingest_states(port, _states(ref))
    return ref, port


@pytest.fixture(scope="module")
def services(stores):
    ref, port = stores
    exec0, exec1, mesh = reference_lanes(ref)
    return {"exec": exec0, "exec1": exec1, "mesh": mesh,
            "port": QueryService(port, device="cpu")}


def _sorted(m):
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order]


def _check(services, q, engines=("exec", "exec1", "mesh"), finite=True):
    """The port's answer against each named reference engine."""
    res = services["port"].query_range(q, Q_START, Q_STEP, Q_END)
    got_keys, got = _sorted(res.result)
    assert len(got_keys) > 0 and (np.isfinite(got).any() or not finite), q
    for name in engines:
        r = services[name].query_range(q, Q_START, Q_STEP, Q_END)
        r.result.materialize()
        want_keys, want = _sorted(r.result)
        assert got_keys == want_keys, (q, name)
        assert got.shape == want.shape, (q, name)
        np.testing.assert_allclose(got, want, err_msg=f"{q} {name}", **TOL)
    return res


# ---------------------------------------------------------------------------
# schema, ingest, pages


def test_schema_is_the_reference_schema():
    from filodb_tpu.core.schemas import PROM_HISTOGRAM as REF
    from filodb_tpu_torch.core.schemas import SCHEMAS

    port = SCHEMAS["prom-histogram"]
    assert port.schema_id == REF.schema_id
    assert port.data.value_column == REF.data.value_column == 3
    assert [(c.name, c.ctype.value, c.is_counter)
            for c in port.data.columns] == \
        [(c.name, c.ctype.value, c.is_counter) for c in REF.data.columns]
    assert port.is_histogram and port.is_counter


@pytest.mark.parametrize("B", [1, 10, 64])
@pytest.mark.parametrize("big", [False, True])
def test_bucket_pages_byte_equal(B, big):
    """One chunk's pages against ``_hist_pages``: the timestamp page and
    one int page a bucket (int64 bases, counts past 2^31 with ``big``)."""
    rng = np.random.default_rng(B)
    n = 300
    ts = (START_S * 1000 + np.arange(n) * 10_000
          + rng.integers(-500, 501, n)).astype(np.int64)
    counts = np.cumsum(np.cumsum(rng.integers(0, 7, (n, B)), axis=1), axis=0)
    if big:
        counts += 3 * 2**31 + rng.integers(0, 2**20, B)
    else:  # a reset (a residual past 32 bits would not encode at 2^31)
        counts[n // 2:, B // 2] -= counts[n // 2, B // 2]
    les = np.arange(1, B + 1, dtype=np.float64)
    _, _, want_ts, want_b = ref_db._hist_pages(ts, les, counts)
    tb, cb, rows, per = port_db.hist_chunk_blocks(ts[None], counts[None],
                                                  np.array([n]))
    got = port_db.HistPageBlocks.encode(tb, cb, rows)
    assert per.tolist() == [want_ts.num_blocks]
    for name in ("bases", "slopes", "widths", "words"):
        assert getattr(got, f"ts_{name}").tobytes() \
            == getattr(want_ts, name).tobytes()
        for b, page in enumerate(want_b):
            a = getattr(got, f"b_{name}")[:, b]
            w = getattr(page, name)
            assert a.dtype == w.dtype and a.tobytes() == w.tobytes(), \
                (name, b)
    assert got.b_bases.dtype == np.int64


def test_port_seals_like_the_reference(stores):
    ref, port = stores
    for rs, ps in zip(ref.shards_for(DS), port.shards):
        assert [p.part_key.labels for p in rs.partitions] == \
            [k.labels for k in ps.keys]
        hist = [p for p in rs.partitions if p.schema.name == "prom-histogram"]
        assert len(ps.hist_chunks["pid"]) == sum(len(p.chunks) for p in hist)


def test_direct_ingest_seals_like_the_reference(stores):
    """Histograms ingested straight into the port, all series at once and
    the scheme change as a second call, seal where the reference seals:
    at 64 samples, and where a series' bucket count changes."""
    ref, _ = stores
    port = MemStore(NUM_SHARDS, spread=1, max_chunk_size=CHUNK)
    specs = [s for s in _hist_specs()]
    for les in (LES10, LES5):
        sel = [(lb, ts, segs[0][1]) for lb, ts, segs in specs
               if segs[0][0] is les]
        T = max(len(c) for _, _, c in sel)
        ts = np.zeros((len(sel), T), np.int64)
        counts = np.zeros((len(sel), T, len(les)), np.int64)
        lens = np.array([len(c) for _, _, c in sel])
        for i, (_, t, c) in enumerate(sel):
            ts[i, : lens[i]], counts[i, : lens[i]] = t[: lens[i]], c
        port.ingest_histograms([lb for lb, _, _ in sel], ts, counts, les,
                               lens)
    for lb, ts, segs in specs:
        if len(segs) > 1:
            port.ingest_histogram(lb, ts[len(segs[0][1]):], segs[1][1],
                                  segs[1][0])
    for rs, ps in zip(ref.shards_for(DS), port.shards):
        want = sorted((p.part_key.labels, c.num_rows,
                       len(c.decode_column(3).les))
                      for p in rs.partitions for c in p.chunks
                      if p.schema.name == "prom-histogram")
        ch = ps.hist_chunks
        got = sorted((ps.keys[pid].labels, int(n), len(ps.les_list[lid]))
                     for pid, n, lid in zip(ch["pid"], ch["rows"],
                                            ch["les"]))
        assert got == want


def test_ingest_drops_out_of_order_samples_as_the_reference():
    port = MemStore(1, spread=0, max_chunk_size=CHUNK)
    lb = {"_metric_": "lat", "_ws_": "demo", "_ns_": "App-0"}
    counts = np.cumsum(np.ones((5, 3), np.int64), axis=0)
    assert port.ingest_histogram(lb, [10, 20, 20, 15, 30], counts,
                                 LES10[-3:]) == 3
    assert port.ingest_histogram(lb, [25, 40], counts[:2], LES10[-3:]) == 1
    shard = port.shards[0]
    buf = shard.hist_buffers[3]
    (row,) = buf.rows(np.array([0]))
    assert buf.n[row] == 4
    np.testing.assert_array_equal(buf.ts[row, :4], [10, 20, 30, 40])
    np.testing.assert_array_equal(buf.vals[row, :4, 0], [1, 2, 5, 2])


def test_write_buffers_hold_rows_of_their_own_kind_only():
    """One histogram in a store of many scalar series takes one row of the
    buffer of its bucket count (which holds the minimum 1,024 rows), and
    the scalar buffers take none for it; its scheme change takes a row in
    the other count's buffer, and seals the first."""
    port = MemStore(1, spread=0, max_chunk_size=CHUNK)
    n = 3000
    ts = START_S * 1000 + np.arange(10, dtype=np.int64) * 10_000
    for part in range(2):
        labels = [{"_metric_": "c", "_ws_": "demo", "_ns_": "App-0",
                   "instance": f"instance-{part}-{i}"} for i in range(n)]
        port.ingest_series(labels, np.tile(ts, (n, 1)),
                           np.ones((n, len(ts))))
        if part == 0:
            lb = {"_metric_": "lat", "_ws_": "demo", "_ns_": "App-0"}
            port.ingest_histogram(lb, ts, np.ones((10, 3), np.int64),
                                  LES10[-3:])
    shard = port.shards[0]
    assert shard.num_partitions == 2 * n + 1
    assert shard.buffers.used == 2 * n
    assert shard.buffers.n[:2 * n].sum() == 2 * n * len(ts)
    buf3 = shard.hist_buffers[3]
    assert (buf3.used, len(buf3.n), buf3.vals.shape) == (1, 1024,
                                                          (1024, CHUNK, 3))
    port.ingest_histogram(lb, ts + 100_000, np.ones((10, 5), np.int64),
                          LES5)
    buf5 = shard.hist_buffers[5]
    assert (buf3.used, buf3.n[0], buf5.used, buf5.n[0]) == (1, 0, 1, 10)
    assert shard.hist_chunks["rows"].tolist() == [10]
    assert shard.buffers.used == 2 * n


# ---------------------------------------------------------------------------
# assemble_hist against _assemble_hist


@pytest.mark.parametrize("metric", ["lat", "lat_mixed", "lat_switch",
                                    "lat_small"])
def test_assemble_hist_bitwise_equal_to_reference(stores, metric,
                                                  monkeypatch):
    """The reference's packed arrays (captured where
    ``_build_hist_device_batch`` hands them to ``_assemble_hist``) equal
    the port's, bucket axis moved, byte for byte; ``assemble_hist``'s
    (ts, counts, valid) equal ``_assemble_hist``'s bit for bit in
    float64. ``lat_mixed`` packs 5- and 10-bucket series and a scheme
    change into one batch, ``lat_switch`` a scheme change; write buffers
    are included."""
    from filodb_tpu.promql.parser import TimeStepParams as RefParams
    from filodb_tpu.promql.parser import parse_query as ref_parse
    from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine

    ref, port = stores
    q = f"rate({metric}[5m])"
    low = lower_plan(port_parse(q, TimeStepParams(Q_START, Q_STEP, Q_END)))
    start, end = low.chunk_range
    filters = list(ref_parse(q, RefParams(Q_START, Q_STEP,
                                          Q_END)).raw.filters)
    parts = [shard.partition(pid) for shard in ref.shards_for(DS)
             for pid in shard.lookup_partitions(filters, start, end)]
    captured = []
    original = ref_db._assemble_hist

    def capture(*args):
        captured.append([np.asarray(a) for a in args])
        return original(*args)

    monkeypatch.setattr(ref_db, "_assemble_hist", capture)
    want = ref_db.build_device_batch(parts, start, end)
    eng = MeshQueryEngine(torch.device("cpu"))
    batch = eng._batch(port, low)
    assert [str(k) for k in batch.keys] == \
        [str(p.part_key.range_vector_key) for p in parts]
    np.testing.assert_array_equal(batch.les, want.les)
    np.testing.assert_array_equal(batch.counts, want.counts[: len(parts)])
    packed = [t.numpy() for t in batch.packed]
    for i in (4, 5, 6, 7):  # bucket fields: [P, B, NB(, 128)] -> [P, NB, B]
        packed[i] = np.moveaxis(packed[i], 1, 2)
    for got, ref_arr in zip(packed, captured[0][:9]):
        assert got.tobytes() == ref_arr.view(got.dtype).tobytes()
    ts, counts, valid = port_db.assemble_hist(batch.packed, end - start)
    assert torch.equal(ts, torch.from_numpy(np.asarray(want.ts_dev)))
    assert torch.equal(valid, torch.from_numpy(np.asarray(want.valid_dev)))
    got_v = counts.permute(0, 2, 1).numpy()
    want_v = np.asarray(want.vals_dev)
    assert got_v.dtype == want_v.dtype == np.float64
    assert got_v.tobytes() == np.ascontiguousarray(want_v).tobytes()


# ---------------------------------------------------------------------------
# PromQL parity

RANGE_FNS = ("rate", "increase", "delta", "irate", "idelta", "resets",
             "changes", "sum_over_time", "avg_over_time", "count_over_time",
             "min_over_time", "max_over_time", "last_over_time",
             "present_over_time")


@pytest.mark.parametrize("fn", RANGE_FNS)
@pytest.mark.parametrize("metric", ["lat", "lat_mixed", "lat_switch"])
def test_range_functions_match_the_reference_engines(services, fn, metric):
    engines = ("exec", "exec1") if metric == "lat_switch" \
        else ("exec", "exec1", "mesh")
    res = _check(services, f"{fn}({metric}[5m])", engines)
    m = res.result
    assert m.is_histogram and m.les is not None
    assert m.values.shape[2] == len(m.les) == 10


def test_mesh_cannot_read_a_scheme_change(services):
    """The disagreement of ROADMAP §C: mesh raises where exec answers."""
    with pytest.raises(ValueError, match="concatenation axis"):
        services["mesh"].query_range("sum(rate(lat_switch[5m]))", Q_START,
                                     Q_STEP, Q_END)
    _check(services, "sum(rate(lat_switch[5m]))", ("exec", "exec1"))


@pytest.mark.parametrize("fn", ["stddev_over_time", "stdvar_over_time",
                                "zscore", "deriv"])
def test_moment_functions_match_both_reference_engines(services, fn):
    _check(services, f"{fn}(lat_small[5m])")


@pytest.mark.parametrize("q", [
    "lat", "lat_mixed offset 3m", 'lat{job="job-1"}', "sum(lat) by (job)",
    "histogram_quantile(0.5, lat)"])
def test_instant_selector_matches_both_reference_engines(services, q):
    res = _check(services, q)
    if q == "lat":
        assert all(dict(k.labels)["_metric_"] == "lat"
                   for k in res.result.keys)


@pytest.mark.parametrize("agg", ["sum", "avg", "min", "max", "count",
                                 "group", "stddev", "stdvar"])
@pytest.mark.parametrize("grouping", ["", " by (job)", " without (instance)"])
def test_aggregations_per_bucket_match_both_reference_engines(services, agg,
                                                              grouping):
    res = _check(services, f"{agg}(rate(lat[5m])){grouping}")
    assert res.result.is_histogram


@pytest.mark.parametrize("phi", ["0", "0.5", "0.9", "0.99", "1", "2"])
@pytest.mark.parametrize("inner", [
    "sum(rate(lat[5m])) by (job)", "rate(lat[5m])",
    "sum(increase(lat_mixed[10m])) by (job)"])
def test_histogram_quantile_matches_both_reference_engines(services, phi,
                                                           inner):
    res = _check(services, f"histogram_quantile({phi}, {inner})",
                 finite=phi != "2")
    assert not res.result.is_histogram and res.result.les is None
    if phi == "2":
        assert np.isposinf(res.result.values).all()


def test_zero_totals_give_nan(services):
    """instance-2 stops counting halfway: its windows of zero rate total
    are NaN, in the port as in the reference."""
    res = _check(services,
                 'histogram_quantile(0.9, rate(lat{instance="instance-2"}'
                 '[5m]))')
    v = res.result.values[0]
    assert np.isnan(v).any() and np.isfinite(v).any()


def test_reset_in_one_bucket_is_corrected_per_bucket(services):
    """instance-1's bucket 3 resets alone: its rate stays positive, the
    other buckets are untouched."""
    res = _check(services, 'rate(lat{instance="instance-1"}[5m])')
    assert (res.result.values[0][np.isfinite(res.result.values[0])]
            >= 0).all()


def test_histogram_max_quantile_matches_both_reference_engines(services):
    _check(services,
           "histogram_max_quantile(0.9, sum(rate(lat[5m])) by (_ns_))")


@pytest.mark.parametrize("phi", [-1.0, 0.0, 0.25, 0.5, 0.9, 0.99, 1.0, 2.0])
def test_histogram_quantile_module_parity(phi):
    """The port's ``histogram_quantile`` against the reference's on bucket
    rows with zero totals, NaN totals, non-monotonic buckets and ranks in
    the top bucket; φ outside [0, 1] included (a negative literal does not
    parse in either package, so φ = -1 is held here)."""
    import jax.numpy as jnp

    from filodb_tpu.query.engine.aggregations import histogram_quantile as ref
    from filodb_tpu_torch.query.engine.aggregations import histogram_quantile

    rng = np.random.default_rng(5)
    h = np.cumsum(rng.integers(0, 4, (40, 7, 10)), axis=2).astype(np.float64)
    h[0] = 0.0
    h[1, :, -1] = np.nan
    h[2, :, 3] += 50.0
    h[3, :, -1] += 1000.0
    got = histogram_quantile(phi, torch.from_numpy(h),
                             torch.from_numpy(LES10)).numpy()
    want = np.asarray(ref(phi, jnp.asarray(h), jnp.asarray(LES10)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


def test_negative_phi_does_not_parse_in_either_package():
    from filodb_tpu.promql.parser import TimeStepParams as RefParams
    from filodb_tpu.promql.parser import parse_query as ref_parse

    q = "histogram_quantile(-1, rate(lat[5m]))"
    with pytest.raises(RefParseError):
        ref_parse(q, RefParams(Q_START, Q_STEP, Q_END))
    with pytest.raises(ParseError):
        port_parse(q, TimeStepParams(Q_START, Q_STEP, Q_END))


@pytest.mark.parametrize("q", [
    "abs(rate(lat[5m]))", "sqrt(sum(rate(lat[5m])) by (job))",
    "clamp_max(rate(lat[5m]), 3)", "round(rate(lat[5m]), 0.5)",
    "hist_to_prom_vectors(lat)",
    "histogram_quantile(0.9, sum(rate(lat[5m])) by (job)) * 1000",
    "sum(histogram_quantile(0.9, rate(lat[5m]))) by (job)"])
def test_instant_functions_match_both_reference_engines(services, q):
    res = _check(services, q)
    if res.result.is_histogram:
        np.testing.assert_array_equal(res.result.les, LES10)


@pytest.mark.parametrize("q", ["rate(lat[5m]) * 2", "10 - rate(lat[5m])",
                               "rate(lat[5m]) > 1",
                               "sum(rate(lat[5m])) by (job) / 60"])
def test_operators_with_a_number_match_the_mesh_engine(services, q):
    """Exec fails to broadcast its stepped scalar against a histogram
    matrix; mesh answers element-wise (ROADMAP §C): the port answers as
    mesh, keeping ``les``."""
    with pytest.raises(ValueError):
        services["exec"].query_range(q, Q_START, Q_STEP, Q_END)
    res = _check(services, q, engines=("mesh",))
    np.testing.assert_array_equal(res.result.les, LES10)


@pytest.mark.parametrize("q", [
    "histogram_quantile(0.9, sum(rate(lat_bucket[5m])) by (le, job))",
    "histogram_quantile(0.5, rate(lat_bucket[5m]))",
    "histogram_quantile(0.99, sum(rate(lat_bucket[5m])) by (le))",
    "histogram_quantile(0.9, sum(increase(lat_bucket[10m])) by (le, "
    "instance))"])
def test_le_form_matches_both_reference_engines(services, q):
    """The classic form over ``le``-labelled counters, non-monotonic
    buckets (instance-3) smoothed by a running max as the reference does."""
    _check(services, q)


def test_le_form_equals_the_native_form(services):
    """The same buckets as ``le`` series and as a native histogram give
    the same quantiles (instance-3, whose flat buckets are shuffled, is
    left out)."""
    port = services["port"]
    flat = port.query_range(
        "histogram_quantile(0.9, sum(rate(lat_bucket{instance=~"
        "\"instance-[012]\"}[5m])) by (le, instance))",
        Q_START, Q_STEP, Q_END).result
    native = port.query_range(
        "histogram_quantile(0.9, sum(rate(lat{instance=~\"instance-[012]\"}"
        "[5m])) by (instance))", Q_START, Q_STEP, Q_END).result
    fk, fv = _sorted(flat)
    nk, nv = _sorted(native)
    assert fk == nk
    # the bucket counters' rates run in float32 (B3 on float32 pages)
    np.testing.assert_allclose(fv, nv, rtol=1e-5, equal_nan=True)


def test_prom_json_flattens_like_the_reference(services):
    q = "sum(rate(lat[5m])) by (job)"
    got = matrix_json(services["port"].query_range(q, Q_START, Q_STEP,
                                                   Q_END))
    r = services["exec"].query_range(q, Q_START, Q_STEP, Q_END)
    r.result.materialize()
    want = ref_matrix_json(r)

    def series(body):
        return sorted((tuple(sorted(s["metric"].items())), s["values"])
                      for s in body["data"]["result"])

    g, w = series(got), series(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    assert len(g) == 3 * 10
    assert {dict(k)["le"] for k, _ in g} == {_le(x) for x in LES10}
    for (_, gv), (_, wv) in zip(g, w):
        assert [t for t, _ in gv] == [t for t, _ in wv]
        np.testing.assert_allclose([float(v) for _, v in gv],
                                   [float(v) for _, v in wv], **TOL)


@pytest.mark.parametrize("q", [
    "topk(2, rate(lat[5m]))", "bottomk(2, rate(lat[5m]))",
    "quantile(0.5, rate(lat[5m]))", 'count_values("v", rate(lat[5m]))',
    "quantile_over_time(0.5, lat[5m])", "holt_winters(lat[5m], 0.5, 0.5)",
    "sort(rate(lat[5m]))"])
def test_shapes_the_reference_fails_raise(services, q):
    with pytest.raises((ValueError, TypeError)):
        services["exec"].query_range(q, Q_START, Q_STEP, Q_END)
    with pytest.raises(UnsupportedQuery):
        services["port"].query_range(q, Q_START, Q_STEP, Q_END)


@pytest.mark.parametrize("q", [
    "lat::sum", "rate(lat::count[5m])", "sum(rate(lat::sum[5m]))",
    "timestamp(lat)", "predict_linear(lat[5m], 600)",
    "rate(lat[5m]) / on (instance) rate(lat[5m])",
    "rate(lat[5m]) and rate(lat[5m])",
    '{_ns_="App-0",instance="instance-0"}'])
def test_shapes_left_out_raise(services, q):
    """Shapes the reference answers and the port leaves out (ROADMAP §A):
    column selectors, timestamp and predict_linear over a histogram (the
    reference answers relative seconds and drops the horizon), joins with
    a histogram side, and a selector matching histograms and scalars."""
    with pytest.raises(UnsupportedQuery):
        services["port"].query_range(q, Q_START, Q_STEP, Q_END)
