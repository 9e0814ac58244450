"""The C++ ingest core (``csrc/ingestcore.cpp``, ``core/memstore/
native_shard.py``) on the CPU, built with ``g++``.

- The container lane through the core leaves a shard in the state the
  numpy twin leaves it in (``testing/plain_ingest.py``: records grouped per
  series, whole-row appends) after the same containers and the same
  flushes, evictions, purges and restores: keys and pids, the map, the
  write buffers' samples, ``latest``, the sealed chunks (scalar and
  histogram, by partition and sequence), ``rows_skipped``,
  ``quota_dropped``, ``version``, ``max_ingested_ts`` and the ingested
  offset. One parametrised test over the cases the core must get right,
  and one hypothesis property over random containers.
- ``WriteBuffers.append`` (rounds of one C++ call) against its numpy twin.
- Parity with the reference: the same container bytes into the JAX
  package's ``TimeSeriesShard`` at its defaults (its native core on) and
  into the port: rows, partitions, skipped records and the answers of two
  queries on every reference lane and both of the port's engines.
- The port's buffer fold against the reference's ``shard_buf_fold``
  (``NativeShardCore.buf_fold``) on the same samples, bitwise, with NaN
  and counter resets; a buffer whose timestamps run backwards is flagged
  where the reference's Python fold refuses it; and the sidecar lane at
  the end of the range (buffers only) against the reference's, values
  float32 does not hold among them.
"""

import itertools
import struct
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore import native_shard
from filodb_tpu_torch.core.memstore.index_snapshot import (
    read_snapshot,
    save_snapshot,
)
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.memstore.partition import WriteBuffers
from filodb_tpu_torch.core.memstore.shard import Shard
from filodb_tpu_torch.core.partkey import PartKey, murmur3_32
from filodb_tpu_torch.core.record import (
    BytesContainer,
    IngestRecord,
    RecordContainer,
    SomeData,
)
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.testing.plain_ingest import ingest_plain

M = 8            # samples a chunk
GROUPS = 4
T0 = 1_600_000_000_000
LES = (np.array([0.1, 1.0, np.inf]), np.array([0.1, 0.5, 1.0, np.inf]))
_names = itertools.count()


def key(i: int, metric: str = "m", schema: str = "prom-counter",
        ws: str = "w") -> PartKey:
    return PartKey.create(schema, {"_metric_": metric, "_ws_": ws,
                                   "_ns_": f"ns-{i % 3}",
                                   "instance": f"i-{i}", "job": f"j-{i % 2}"})


def hkey(i: int) -> PartKey:
    return key(i, "lat", "prom-histogram")


def container(records) -> bytes:
    """Serialized container of (key, ts, values) records."""
    c = RecordContainer()
    for k, t, v in records:
        c.add(IngestRecord(k, int(t), v))
    return c.serialize()


def hist_value(les: np.ndarray, t: int) -> tuple:
    counts = np.cumsum(np.arange(1, len(les) + 1) * (t // 10_000 % 7 + 1))
    return (float(counts[-1]) * 0.5, float(counts[-1]),
            (les, counts.astype(np.int64)))


def with_schema_id(raw: bytes, records, sid: int) -> bytes:
    """``raw`` with the schema id of records ``records`` set to ``sid``."""
    out = bytearray(raw)
    off = 5
    for r in range(struct.unpack_from("<I", raw, 1)[0]):
        (n,) = struct.unpack_from("<I", raw, off)
        if r in records:
            struct.pack_into("<H", out, off + 4 + 12, sid)
        off += 4 + n
    return bytes(out)


def pair(**cfg) -> tuple[Shard, Shard]:
    """Two empty shards alike: one for the core, one for the twin (their
    metrics apart)."""
    conf = StoreConfig(max_chunk_size=M, groups_per_shard=GROUPS, **cfg)
    n = next(_names)
    return (Shard(0, conf, dataset=f"core-{n}"),
            Shard(0, conf, dataset=f"plain-{n}"))


def run(steps, shards=None, **cfg) -> tuple[Shard, Shard]:
    """Apply ``steps`` to a core shard and a twin shard: ("ingest", raw,
    offset) through ``Shard.ingest`` and ``ingest_plain``, or (method,
    *args) called on both."""
    core, plain = shards or pair(**cfg)
    for step in steps:
        if step[0] == "ingest":
            data = SomeData(BytesContainer(step[1]), step[2])
            assert core.ingest(data) == ingest_plain(plain, data)
        else:
            for sh in (core, plain):
                getattr(sh, step[0])(*step[1:])
    return core, plain


def _buffer_rows(sh: Shard, buf: WriteBuffers) -> dict:
    P = sh.num_partitions
    buf.cover(P)
    out = {}
    for p in range(P):
        r = buf.slot[p]
        if r >= 0 and buf.n[r]:
            n = int(buf.n[r])
            out[p] = (buf.ts[r, :n].tolist(), buf.vals[r, :n].tobytes())
    return out


def _chunks(table) -> list:
    col = table.columns
    live = np.flatnonzero(~col["dead"])
    live = live[np.lexsort((col["seq"][live], col["pid"][live]))]
    names = [n for n in table.names
             if n not in ("blk0", "cbatch", "cidx", "dead")]
    held = live[col["pending"][live]]
    codec = dict(zip(held.tolist(), (bytes(c) for c in
                                     table.codec_rows(held))))
    return [(tuple(np.asarray(col[n][i]).tobytes() for n in names),
             codec.get(i)) for i in live.tolist()]


def state(sh: Shard) -> dict:
    P = sh.num_partitions
    blobs = [sh.keys.blob(p) for p in range(P)]
    return {
        "keys": blobs, "status": sh.status[:P].tolist(),
        "map": sh.core.lookup(blobs).tolist(), "mapped": len(sh.core),
        "latest": sh.latest[:P].tolist(), "floor": sh.floor[:P].tolist(),
        "hist": sh.hist[:P].tolist(), "les": sh._les_id[:P].tolist(),
        "buffers": _buffer_rows(sh, sh.buffers),
        "hist_buffers": {b: _buffer_rows(sh, buf)
                         for b, buf in sh.hist_buffers.items()},
        "chunks": _chunks(sh._sealed), "hist_chunks": _chunks(sh._hist_sealed),
        "rows_skipped": sh.rows_skipped,
        "stats": (sh.stats.rows_ingested.value, sh.stats.rows_skipped.value,
                  sh.stats.quota_dropped.value,
                  sh.stats.partitions_created.value,
                  sh.stats.partitions_restored.value),
        "version": sh.version, "max_ts": sh.max_ingested_ts,
        "offset": sh.latest_offset,
        "starts": sh.index.start_times(np.arange(P)).tolist(),
        "shells": sorted(sh._shells.items()),
    }


def same(core: Shard, plain: Shard) -> None:
    a, b = state(core), state(plain)
    for k in a:
        assert a[k] == b[k], k


# ------------------------------------------------------------ the cases


def scrapes(n_series: int, n_scrapes: int, first_offset: int = 0,
            t0: int = T0, seed: int = 0):
    """A scrape a container: every series' sample at t0 + 10 s k."""
    rng = np.random.default_rng(seed)
    keys = [key(i) for i in range(n_series)]
    vals = np.cumsum(rng.integers(0, 20, (n_scrapes, n_series)), axis=0)
    out = []
    for k in range(n_scrapes):
        ts = t0 + 10_000 * k + rng.integers(-500, 501, n_series)
        out.append(("ingest", container(
            (keys[i], ts[i], (float(vals[k, i]),))
            for i in rng.permutation(n_series)), first_offset + k))
    return out


def case_scrapes():
    return scrapes(30, 3 * M + 2)


def case_out_of_order():
    rng = np.random.default_rng(1)
    keys = [key(i) for i in range(6)]
    steps = []
    for c in range(6):
        recs = [(keys[rng.integers(0, 6)],
                 T0 + 1_000 * int(rng.integers(0, 40)) + 20_000 * c,
                 (float(rng.integers(0, 50)),)) for _ in range(40)]
        recs += recs[:5]  # repeated timestamps
        steps.append(("ingest", container(recs), c))
    return steps


def case_past_m():
    k0, k1 = key(0), key(1)
    recs = [(k0, T0 + 1_000 * t, (float(t),)) for t in range(3 * M + 3)]
    recs.insert(4, (k1, T0, (1.0,)))
    recs.insert(M + 1, (k1, T0 + 5, (2.0,)))
    return [("ingest", container(recs), 0),
            ("ingest", container([(k0, T0 + 1_000 * (4 * M + t), (1.0,))
                                  for t in range(M)]), 1)]


def case_watermark():
    return [("ingest", container((key(i), T0 + 10_000 * o, (float(o),))
                                 for i in range(12)), o)
            for o in range(8)]


def case_unknown_schema():
    steps = scrapes(10, 4)
    return [(s[0], with_schema_id(s[1], {1, 4, 7}, 0x1234), s[2])
            for s in steps]


def case_histograms():
    steps = []
    for c in range(2 * M + 2):
        t = T0 + 10_000 * c
        recs = [(key(i), t, (float(c * i),)) for i in range(4)]
        recs += [(hkey(i), t, hist_value(LES[int(c > M and i == 1)], t))
                 for i in range(3)]
        rng = np.random.default_rng(c)
        steps.append(("ingest", container(recs[j] for j in
                                          rng.permutation(len(recs))), c))
    return steps


def case_quotas():
    k = [key(i, ws="t") for i in range(10)]
    first = [(k[i], T0, (1.0,)) for i in range(3)]
    mid = [(k[0], T0 + 10_000, (2.0,)), (k[5], T0 + 10_000, (1.0,)),
           (k[6], T0 + 10_000, (1.0,)), (k[1], T0 + 10_000, (2.0,)),
           (k[7], T0 + 10_000, (1.0,)), (k[5], T0 + 20_000, (2.0,)),
           (k[8], T0 + 10_000, (1.0,)), (k[7], T0 + 20_000, (2.0,))]
    return [("ingest", container(first), 0), ("ingest", container(mid), 1)]


def case_evicted_back():
    steps = scrapes(10, M + 3)
    steps += [("flush_all", 0), ("evict_cold_partitions", 4)]
    steps += scrapes(12, 3, first_offset=100, t0=T0 + 10_000 * (M + 5))
    return steps


def case_purge_recreate():
    steps = scrapes(8, M + 2)
    steps += [("purge_expired", T0 + 10_000 * (M + 3)
               + StoreConfig().retention_ms)]
    steps += scrapes(8, 3, first_offset=50, t0=T0 + 10_000 * (M + 4))
    return steps


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES) + ["snapshot_restore"])
def test_the_core_lane_equals_the_plain_twin(case):
    if case == "snapshot_restore":
        src, _ = run(scrapes(20, M + 4))
        src.flush_all(0)
        snap = read_snapshot(save_snapshot(src))
        core, plain = pair()
        for sh in (core, plain):
            sh.restore_registry(snap)
        core, plain = run(scrapes(24, 4, first_offset=30,
                                  t0=T0 + 10_000 * (M + 2)), (core, plain))
    else:
        cfg = {}
        core, plain = pair()
        if case == "watermark":
            for sh in (core, plain):
                sh.group_watermarks[:] = [2, 5, -1, 3]
        if case == "quotas":
            for sh in (core, plain):
                sh.cardinality.set_quota(["t"], 5)
        core, plain = run(CASES[case](), (core, plain), **cfg)
    same(core, plain)
    if case == "watermark":
        assert core.rows_skipped > 0
    if case == "quotas":
        assert core.stats.quota_dropped.value == 3
    if case == "unknown_schema":
        assert core.stats.rows_ingested.value == 4 * 10 - 12
    if case == "evicted_back":
        assert core.stats.partitions_restored.value == 4
    if case == "past_m":
        assert len(core.chunks["pid"]) >= 4
    if case == "histograms":
        assert len(core.hist_chunks["pid"]) and len(core.hist_buffers) == 2


@settings(max_examples=40, deadline=None)
@given(st.lists(st.lists(st.tuples(st.integers(0, 7), st.integers(0, 30),
                                   st.integers(-3, 3)), max_size=40),
                min_size=1, max_size=6),
       st.lists(st.integers(-1, 4), min_size=GROUPS, max_size=GROUPS))
def test_random_containers_leave_the_twin_state(containers, watermarks):
    """Keys 0-6 are counters, key 7 a gauge of another schema id where its
    value is 0 (unknown); timestamps repeat and run backwards."""
    core, plain = pair()
    for sh in (core, plain):
        sh.group_watermarks[:] = watermarks
    steps = []
    for off, recs in enumerate(containers):
        raw = container((key(k, schema="gauge" if k == 7 else
                             "prom-counter"), T0 + 1_000 * t, (float(v),))
                        for k, t, v in recs)
        odd = {i for i, (k, _, v) in enumerate(recs) if k == 7 and v == 0}
        steps.append(("ingest", with_schema_id(raw, odd, 0xBEEF), off))
    run(steps, (core, plain))
    same(core, plain)


@pytest.mark.parametrize("buckets", [None, 3])
def test_append_rounds_equal_the_numpy_twin(buckets):
    rng = np.random.default_rng(5)
    a, b = (WriteBuffers(M, buckets) for _ in range(2))
    for _ in range(6):
        pids = rng.choice(40, 12, replace=False)
        lens = rng.integers(0, 3 * M, 12)
        T = int(lens.max()) + 1
        ts = rng.integers(0, 10**6, (12, T))
        vals = rng.random((12, T)) if buckets is None \
            else rng.integers(0, 99, (12, T, buckets))
        got = list(a.append(pids, ts, vals, lens))
        want = list(b.append_plain(pids, ts, vals, lens))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
    for x in ("n", "slot", "pid_of"):
        np.testing.assert_array_equal(getattr(a, x), getattr(b, x))
    live = np.arange(M)[None, :] < a.n[:, None]
    np.testing.assert_array_equal(a.ts[live], b.ts[live])
    np.testing.assert_array_equal(a.vals[live], b.vals[live])


def test_the_map_erases_only_its_own_pid_and_loads_in_bulk():
    blobs = [key(i).serialized for i in range(50)]
    core = native_shard.NativeShardCore()
    core.insert(blobs, np.arange(50) * 3)
    core.erase(blobs[:10], np.arange(10) * 3 + (np.arange(10) % 2))
    want = np.arange(50) * 3
    want[:10:2] = -1
    np.testing.assert_array_equal(core.lookup(blobs), want)
    assert len(core) == 45
    core.insert(blobs, np.arange(50), np.arange(50) % 2 == 0)
    assert core.lookup([blobs[1], blobs[2], b"nope"]).tolist() == [3, 2, -1]


def test_a_record_whose_part_hash_is_wrong_finds_its_key():
    """The pass probes by the record's part hash (murmur3 of the key, as
    ``core/partkey.py`` makes it), then by the key's own hash."""
    core, plain = pair()
    raw = container((key(i), T0, (1.0,)) for i in range(4))
    run([("ingest", raw, 0)], (core, plain))
    bad = bytearray(container((key(i), T0 + 10_000, (2.0,))
                              for i in range(4)))
    struct.pack_into("<I", bad, 5 + 4, 12345)  # the first record's hash
    run([("ingest", bytes(bad), 1)], (core, plain))
    same(core, plain)
    assert core.num_partitions == 4 and core.stats.rows_ingested.value == 8
    assert core.lookup_keys([key(0).serialized]).tolist() == [0]
    assert key(0).part_hash == murmur3_32(key(0).serialized)


def test_a_malformed_container_ingests_nothing():
    core, _ = pair()
    raw = container((key(i), T0, (1.0,)) for i in range(3))
    with pytest.raises(ValueError):
        core.ingest(SomeData(BytesContainer(raw[:-3]), 0))
    assert core.num_partitions == 0 and core.version == 0


def test_a_query_that_waited_for_an_ingest_reads_its_partitions():
    """The mesh engine's kind check looks a selector up on each shard and
    reads the shard's per-pid kinds for the pids it got: an ingest that
    the lookup waited for (the node's gateway feeding while a query runs)
    grows those arrays, and the kinds must be read from the grown ones."""
    store = MemStore(1, spread=0, max_chunk_size=M)
    shard = store.shards[0]
    lookup = shard.lookup_partitions

    def racing(*args):
        if sys._getframe(1).f_code.co_name == "_kind":
            shard.lookup_partitions = lookup
            raw = container((key(i), T0 + 10_000 * t, (float(t),))
                            for t in range(30) for i in range(5))
            shard.ingest(SomeData(BytesContainer(raw), 0))
        return lookup(*args)

    shard.lookup_partitions = racing
    svc = QueryService(store, device="cpu")
    q = ("sum(count_over_time(m[10m]))", T0 // 1000 + 100, 10,
         T0 // 1000 + 290)
    first = svc.query_range(*q)
    assert shard.lookup_partitions is lookup  # the ingest ran in _kind
    assert first.stats.engine == "mesh"
    assert svc.query_range(*q).result.values[0, -1] == 5 * 30


# ------------------------------------------------- parity with the reference

DS = "timeseries"
NUM_SHARDS = 4
Q_END_S = T0 // 1000 + 590


@pytest.fixture(scope="module")
def ref_and_port():
    """The same routed containers (scrapes of 40 counters, 60 at 10 s,
    then a replay of ten of them under watermarks) into the JAX package's
    store at its defaults and into the port."""
    from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu.core.record import BytesContainer as RefBytes
    from filodb_tpu.core.record import SomeData as RefData
    from filodb_tpu.core.store.config import StoreConfig as RefConfig

    ref = TimeSeriesMemStore()
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, RefConfig(max_chunk_size=16, groups_per_shard=2))
    port = MemStore(NUM_SHARDS, spread=1, config=StoreConfig(
        max_chunk_size=16, groups_per_shard=2))
    assert all(s._native_core is not None for s in ref.shards_for(DS))
    keys = [key(i) for i in range(40)]
    shard_of = port.shard_of(keys)
    rng = np.random.default_rng(11)
    vals = np.cumsum(rng.integers(0, 20, (60, 40)), axis=0).astype(float)
    vals[30:, 5] -= vals[30, 5]  # a reset
    rows = {"ref": 0, "port": 0}
    stream = []
    for k in range(60):
        ts = T0 + 10_000 * k + rng.integers(-500, 501, 40)
        for s in range(NUM_SHARDS):
            mine = np.flatnonzero(shard_of == s)
            stream.append((s, container((keys[i], ts[i], (vals[k, i],))
                                        for i in mine)))
    for off, (s, raw) in enumerate(stream):
        rows["ref"] += ref.shards_for(DS)[s].ingest(RefData(RefBytes(raw),
                                                            off))
        rows["port"] += port.shards[s].ingest(SomeData(BytesContainer(raw),
                                                       off))
    for s in range(NUM_SHARDS):
        rs = ref.shards_for(DS)[s]
        rs.group_watermarks[:] = [len(stream), -1]
        rs._native_core.set_watermark(0, len(stream))
        port.shards[s].group_watermarks[:] = [len(stream), -1]
    for off, (s, raw) in enumerate(stream[-10:], len(stream) - 10):
        rows["ref"] += ref.shards_for(DS)[s].ingest(RefData(RefBytes(raw),
                                                            off))
        rows["port"] += port.shards[s].ingest(SomeData(BytesContainer(raw),
                                                       off))
    return ref, port, rows


def test_rows_partitions_and_skips_agree_with_the_reference(ref_and_port):
    ref, port, rows = ref_and_port
    assert rows["ref"] == rows["port"] == 40 * 60
    for rs, ps in zip(ref.shards_for(DS), port.shards):
        assert len(rs.partitions) == ps.num_partitions
        assert [p.part_key.labels for p in rs.partitions] == \
            [k.labels for k in ps.keys]
        assert rs.stats.rows_skipped.value == ps.rows_skipped
        assert (rs.data_version > 0) == (ps.version > 0)
    assert sum(s.rows_skipped for s in port.shards) > 0


@pytest.mark.parametrize("q", ["sum(rate(m[5m])) by (_ns_)",
                               "sum(count_over_time(m[5m])) by (job)"])
def test_answers_agree_with_the_reference(ref_and_port, q):
    from test_torch_slice import _sorted, reference_lanes

    ref, port, _ = ref_and_port
    start = T0 // 1000 + 300
    for engine in ("mesh", "exec"):
        got = QueryService(port, device="cpu", engine=engine).query_range(
            q, start, 30, Q_END_S)
        gk, gv = _sorted(got)
        assert len(gk) and np.isfinite(gv).any()
        for svc in reference_lanes(ref):
            want = svc.query_range(q, start, 30, Q_END_S)
            want.result.materialize()
            wk, wv = _sorted(want)
            assert gk == wk, (q, engine, svc.engine)
            np.testing.assert_allclose(gv, wv, rtol=2e-5, atol=1e-6,
                                       equal_nan=True,
                                       err_msg=f"{q} {engine} {svc.engine}")


# --------------------------------------------------------- the buffer fold


def _fold_case(nan: bool):
    """Counters with NaN samples and resets, ingested alike into the
    reference's C++ core and a port shard: (reference core, its pids,
    port shard, its pids, windows)."""
    from filodb_tpu.core.memstore.native_shard import (
        NativeShardCore as RefCore,
    )
    from filodb_tpu.core.memstore.native_shard import part_key_blob
    from filodb_tpu.core.partkey import PartKey as RefKey

    rng = np.random.default_rng(3)
    ref = RefCore(M, GROUPS)
    port, _ = pair()
    keys = [key(i) for i in range(9)]
    for c in range(2 * M + 3):
        v = rng.integers(0, 9, 9).astype(float) + 0.1 * c
        v[rng.random(9) < 0.3] = 0.0  # resets
        if nan:
            v[rng.random(9) < 0.2] = np.nan
        raw = container((keys[i], T0 + 10_000 * c + 7 * i, (v[i],))
                        for i in range(9) if (c + i) % 4)
        assert ref.ingest(raw, c) == port.ingest(SomeData(BytesContainer(raw),
                                                          c))
    ref_pids = np.array([ref.lookup(part_key_blob(RefKey(k.schema,
                                                         k.labels)))
                         for k in keys], np.int32)
    pids = port.lookup_keys([k.serialized for k in keys])
    ends = T0 + 10_000 * np.arange(M, 2 * M + 6, 2)
    return ref, ref_pids, port, pids, ends - 60_000, ends


@pytest.mark.parametrize("nan", [False, True])
def test_the_fold_is_the_references_bitwise(nan):
    ref, ref_pids, port, pids, t0s, t1s = _fold_case(nan)
    want, wflags = ref.buf_fold(ref_pids, t0s, t1s, 0)
    got, flags = native_shard.buf_fold(port.buffers, pids, t0s, t1s,
                                       port._sealed.columns,
                                       port.num_partitions)
    np.testing.assert_array_equal(flags, wflags)
    assert (flags & 2).any() and not (flags & 1).any()
    assert got.tobytes() == want.tobytes()
    assert np.isnan(got).any() and (got[..., 9] > 0).any()  # resets


def test_a_buffer_out_of_time_order_is_flagged_as_the_reference_refuses():
    from types import SimpleNamespace

    from filodb_tpu.query.engine import sidecar_lane as ref_lane

    buf = WriteBuffers(M)
    list(buf.append(np.array([0, 1]), np.array([[5, 9, 12], [5, 9, 12]]),
                    np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]]),
                    np.array([3, 3])))
    buf.ts[buf.slot[1], 1] = 3  # runs backwards
    _, flags = native_shard.buf_fold(buf, np.array([0, 1]),
                                     np.array([0]), np.array([20]))
    assert flags.tolist() == [0, 1]
    for row, refused in ((buf.slot[0], False), (buf.slot[1], True)):
        part = SimpleNamespace(_buf=SimpleNamespace(
            n=3, ts=buf.ts[row].copy(), cols=[buf.vals[row].copy()]))
        try:
            ref_lane._buf_rows_python(part, 1, np.array([0]), np.array([20]))
            assert not refused
        except ref_lane._Bypass:
            assert refused


@pytest.mark.parametrize("big", [False, True])
def test_the_sidecar_lane_folds_buffers_as_the_reference(big, monkeypatch):
    """Instant queries at the end of the range read the write buffers only
    (no chunk sealed in the window): the lane folds them in float64, values
    float32 does not hold included, and answers as the reference's sidecar
    lane over its host-decode store."""
    from filodb_tpu.coordinator.query_service import QueryService as Ref
    from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu.core.record import BytesContainer as RefBytes
    from filodb_tpu.core.record import SomeData as RefData
    from filodb_tpu.core.store.config import StoreConfig as RefConfig

    from filodb_tpu_torch.query.engine import sidecar_lane

    monkeypatch.setenv("FILODB_SIDECARS", "1")
    ref = TimeSeriesMemStore()
    ref.setup(DS, 0, RefConfig(max_chunk_size=64))
    port = MemStore(1, spread=0, max_chunk_size=64)
    rng = np.random.default_rng(2)
    keys = [key(i) for i in range(12)]
    base = 1e12 if big else 0.0
    vals = base + np.cumsum(rng.integers(0, 1_000, (50, 12)), axis=0) \
        + (0.37 if big else 0.0)
    for c in range(50):
        raw = container((keys[i], T0 + 10_000 * c + i, (vals[c, i],))
                        for i in range(12))
        ref.shards_for(DS)[0].ingest(RefData(RefBytes(raw), c))
        port.shards[0].ingest(SomeData(BytesContainer(raw), c))
    t = (T0 + 10_000 * 49) // 1000 + 1
    ref_svc = Ref(ref, DS, 1, spread=0, engine="exec")
    svc = QueryService(port, device="cpu", engine="exec")
    for q in ("sum(rate(m[5m])) by (job)", "sum(max_over_time(m[2m]))",
              "sum(changes(m[5m])) by (_ns_)"):
        served = sidecar_lane.SIDECAR_SERVED.value
        got = svc.query_instant(q, t)
        assert sidecar_lane.SIDECAR_SERVED.value > served, q
        assert not got.stats.sidecar_bypassed and not got.stats.host_lane
        want = ref_svc.query_instant(q, t)
        want.result.materialize()
        gk = [str(k) for k in got.result.keys]
        wk = [str(k) for k in want.result.keys]
        assert sorted(gk) == sorted(wk), q
        gv = np.asarray(got.result.values)[np.argsort(gk)]
        wv = np.asarray(want.result.values)[np.argsort(wk)]
        np.testing.assert_allclose(gv, wv, rtol=1e-12, err_msg=q)
