"""Port parity for the downsampling plane: the rollups, the ds records of a
partition, the batch job with its checkpoints, the ds store, the streaming
downsampler and ``LongTimeRangePlanner``.

One set of containers (gauges whose decimal values float32 does not hold,
a few NaN samples among them, and integer counters with a reset, over two
namespaces and two shards) goes into the JAX package's store and the
port's, each over a local-disk directory of its own, flushed at one
ingestion time and then, for the second half of the samples, at a later
one. Then:

- ``downsample_samples`` and the port's many-partition rollup equal the
  reference's bit for bit, and so do the ds records of every partition
  (``downsample_partition``) for ``prom-counter`` (``dLast``) and
  ``ds-gauge`` (min, max, sum, count, avg);
- the job of either package writes ds chunks and part keys that the other
  reads with the same samples, bit for bit, and either resumes from the
  other's ``__dsckpt`` checkpoint, scanning exactly the window not done;
- queries over the ds store and through ``LongTimeRangePlanner`` answer
  as the reference's within the parity tests' tolerance (``rtol=2e-5,
  atol=1e-6``: the page lane's float32 values, or the host-decode lane's
  float64 ones where float32 does not hold a column), and the planner
  gives the reference's plan tree, boundary cases included.
"""

from __future__ import annotations

import shutil
import struct

import numpy as np
import pytest

from filodb_tpu.coordinator.ingestion import route_container as ref_route
from filodb_tpu.coordinator.longtime_planner import (
    LongTimeRangePlanner as RefLongTime,
)
from filodb_tpu.coordinator.longtime_planner import (
    rewrite_for_downsample as ref_rewrite,
)
from filodb_tpu.coordinator.planner import SingleClusterPlanner as RefPlanner
from filodb_tpu.core.downsample import DownsampledTimeSeriesStore as RefDs
from filodb_tpu.core.downsample import DownsamplerJob as RefJob
from filodb_tpu.core.downsample import ShardDownsampler as RefShardDs
from filodb_tpu.core.downsample import downsample_partition as ref_ds_part
from filodb_tpu.core.downsample.downsampler import (
    downsample_samples as ref_samples,
)
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord as RefRecord
from filodb_tpu.core.record import RecordContainer as RefContainer
from filodb_tpu.core.record import SomeData as RefSomeData
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.core.store.localstore import LocalDiskColumnStore as RefCS
from filodb_tpu.core.store.localstore import LocalDiskMetaStore as RefMeta
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query.exec.plan import ExecContext as RefCtx
from filodb_tpu.query.exec.plan import SelectRawPartitionsExec as RefLeaf
from filodb_tpu_torch.coordinator.longtime_planner import (
    LongTimeRangePlanner,
    rewrite_for_downsample,
)
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.downsample import (
    DownsampledTimeSeriesStore,
    DownsamplerJob,
    ShardDownsampler,
    downsample_partition,
    downsample_samples,
    ds_dataset_name,
)
from filodb_tpu_torch.core.downsample.downsampler import _rollup
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import (
    BytesContainer,
    IngestRecord,
    RecordContainer,
    SomeData,
)
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.memory.chunk import decode_chunks
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.exec.plan import SelectRawPartitionsExec
from filodb_tpu_torch.testing.from_jax import dataset_samples, open_local

DS = "timeseries"
NUM_SHARDS = 2
CHUNK = 120
START = 1_600_000_000          # s
N = 600                        # samples a series, 10 s apart: [0, +6000 s)
HALF = 360                     # the first flush holds samples [0, HALF)
T_FIRST, T_SECOND = 1_000, 2_000   # the two flushes' ingestion times
RES = 300_000
RESOLUTIONS = (RES, 3_600_000)
TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
NOW = (START + 6000) * 1000
EARLIEST_RAW = (START + 3000) * 1000


def _keys():
    gauges = [RefPartKey.create("gauge", {
        "_metric_": "heap_usage", "_ws_": "demo", "_ns_": f"App-{i % 2}",
        "instance": f"instance-{i}", "host": f"H{i % 4}"}) for i in range(6)]
    counters = [RefPartKey.create("prom-counter", {
        "_metric_": "http_requests_total", "_ws_": "demo",
        "_ns_": f"App-{i % 2}", "instance": f"instance-{i}",
        "job": f"job-{i % 3}"}) for i in range(4)]
    return gauges, counters


def _values(seed: int = 7):
    """Gauge values [6, N] (random walks of decimals, NaN at a few
    samples) and counter values [4, N] (integer increments, a reset)."""
    rng = np.random.default_rng(seed)
    g = 50.0 + 30.0 * rng.random((6, 1)) + np.cumsum(
        rng.normal(0, 1.0, (6, N)), axis=1)
    g[1, [17, 18, 250]] = np.nan
    c = np.cumsum(rng.integers(0, 20, (4, N)), axis=1).astype(np.float64)
    c[2, 400:] -= c[2, 399]
    return g, c


def _containers(lo: int, hi: int) -> list:
    """Scrapes ``lo .. hi - 1``, one reference container a scrape."""
    gauges, counters = _keys()
    g, c = _values()
    out = []
    for s in range(lo, hi):
        cont = RefContainer()
        t = (START + 10 * s) * 1000
        for i, k in enumerate(gauges):
            cont.add(RefRecord(k, t, (float(g[i, s]),)))
        for i, k in enumerate(counters):
            cont.add(RefRecord(k, t, (float(c[i, s]),)))
        out.append(cont)
    return out


def _ingest(ref, port, conts, first_offset: int) -> None:
    for off, cont in enumerate(conts, first_offset):
        for shard, sub in ref_route(cont, NUM_SHARDS, 0).items():
            ref.ingest(DS, shard, RefSomeData(sub, off))
            port.shards[shard].ingest(SomeData(
                BytesContainer(sub.serialize()), off))


def _flush(ref, port, ingestion_time: int) -> None:
    for s in range(NUM_SHARDS):
        ref.get_shard(DS, s).flush_all(ingestion_time)
        port.shards[s].flush_all(ingestion_time)


def build_pair(root) -> tuple:
    """The reference's store over ``<root>/ref`` and the port's over
    ``<root>/port``, the same containers in both, flushed at ``T_FIRST``
    (samples before ``HALF``) and ``T_SECOND`` (the rest)."""
    rcs, rmeta = RefCS(str(root / "ref")), RefMeta(str(root / "ref"))
    ref = TimeSeriesMemStore(rcs, rmeta)
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, RefConfig(max_chunk_size=CHUNK, groups_per_shard=2))
        rmeta.read_checkpoints(DS, s)  # open it before a flush thread
    port = open_local(str(root / "port"), NUM_SHARDS, 0,
                      StoreConfig(max_chunk_size=CHUNK, groups_per_shard=2))
    _ingest(ref, port, _containers(0, HALF), 0)
    _flush(ref, port, T_FIRST)
    _ingest(ref, port, _containers(HALF, N), HALF)
    _flush(ref, port, T_SECOND)
    return ref, port


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    return build_pair(root), root


@pytest.fixture(scope="module")
def pair(pair_root):
    return pair_root[0]


def _copy_dir(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float64).view(np.int64)


# ---- rollups ------------------------------------------------------------------

SAMPLE_CASES = {
    "basic": (np.arange(0, 600_000, 10_000, dtype=np.int64),
              np.arange(60, dtype=np.float64)),
    "irregular": (np.array([100, 299_000, 300_000, 900_001], np.int64),
                  np.array([1.0, 2.0, 3.0, 4.0])),
    "nan": (np.arange(0, 3_000_000, 7_000, dtype=np.int64),
            np.where(np.arange(429) % 37 == 5, np.nan,
                     np.random.default_rng(3).normal(0, 1e6, 429))),
}


@pytest.mark.parametrize("case", SAMPLE_CASES)
def test_downsample_samples_bitwise(case):
    ts, vals = SAMPLE_CASES[case]
    for got, want in zip(downsample_samples(ts, vals, RES),
                         ref_samples(ts, vals, RES)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_rollup_of_many_partitions_is_each_partitions_own():
    """One ``reduceat`` over many partitions gives, period by period, what
    the reference's ``downsample_samples`` gives each partition alone."""
    rng = np.random.default_rng(11)
    rows, ts, vals = [], [], []
    for r in range(40):
        n = int(rng.integers(1, 900))
        t = np.sort(rng.choice(10_000_000, n, replace=False)).astype(np.int64)
        v = rng.normal(0, 10.0 ** rng.integers(0, 8), n)
        v[rng.random(n) < 0.02] = np.nan
        rows.append(np.full(n, r))
        ts.append(t)
        vals.append(v)
    roll = _rollup(np.concatenate(rows), np.concatenate(ts),
                   np.concatenate(vals), RES)
    for r in range(40):
        mine = roll.row == r
        want = ref_samples(ts[r], vals[r], RES)
        got = (roll.ts[mine], roll.mins[mine], roll.maxs[mine],
               roll.sums[mine], roll.counts[mine], roll.avgs[mine],
               roll.lasts[mine])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))


def test_samples_of_overlapping_chunks_sort_as_the_references():
    """Chunks of one partition that overlap in time (and a write buffer
    after them): the samples come out as the reference's ``read_samples``
    lays them out, concatenated in chunk-id order then sorted by time,
    stably, before the rollup."""
    from filodb_tpu_torch.core.downsample.downsampler import _flatten

    rng = np.random.default_rng(4)
    parts, want = [], {}
    for r in range(3):
        cids = np.sort(rng.choice(1000, 3, replace=False))
        ts = np.sort(rng.integers(0, 50, (3, 8)), axis=1)
        vals = rng.normal(0, 1, (3, 8))
        live = np.ones((3, 8), bool)
        live[2, 5:] = False
        order = np.argsort(cids)  # the reference's chunks by id
        cat_t = np.concatenate([ts[i][live[i]] for i in order])
        cat_v = np.concatenate([vals[i][live[i]] for i in order])
        o = np.argsort(cat_t, kind="stable")
        want[r] = (cat_t[o], cat_v[o])
        parts.append((np.full(3, r), np.zeros(3, np.int64), cids, ts, vals,
                      live))
    row, t, v = _flatten(parts[::-1], 3, 0, 2**62)
    for r in range(3):
        np.testing.assert_array_equal(t[row == r], want[r][0])
        np.testing.assert_array_equal(v[row == r], want[r][1])


def _rec_bits(r) -> tuple:
    return (r.part_key.schema, tuple(r.part_key.labels), int(r.timestamp),
            tuple(struct.pack("<d", float(v)) for v in r.values))


WINDOWS = {"all": (0, 2**62),
           "middle": ((START + 1234) * 1000, (START + 4321) * 1000)}


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("res", RESOLUTIONS)
def test_ds_records_of_every_partition_bitwise(pair, res, window):
    """``downsample_partition`` over the port's shard gives the reference's
    records over its partition: schema, labels, period timestamp and each
    value's bits (a counter's last sample; a gauge's min, max, sum, count
    and avg, NaN where a period holds a NaN sample)."""
    ref, port = pair
    start, end = WINDOWS[window]
    n = 0
    for s in range(NUM_SHARDS):
        for part in ref.get_shard(DS, s).partitions:
            if part is None:
                continue
            want = [_rec_bits(r) for r in ref_ds_part(part, res, start, end)]
            shard = port.shards[s]
            pid = int(shard.lookup_keys([part.part_key.serialized])[0])
            got = [_rec_bits(r) for r in
                   downsample_partition(shard, pid, res, start, end)]
            assert got == want, part.part_key
            n += len(want)
    assert n > 0


# ---- the batch job ----------------------------------------------------------------


def _ds_samples(root: str, res: int) -> dict:
    return dataset_samples(root, ds_dataset_name(DS, res), NUM_SHARDS)


def _ds_part_keys(root: str, res: int) -> list:
    from filodb_tpu_torch.core.store.localstore import LocalDiskColumnStore

    cs = LocalDiskColumnStore(root)
    try:
        return [[(r.part_key.serialized, r.start_time, r.end_time)
                 for r in cs.scan_part_keys(ds_dataset_name(DS, res), s)]
                for s in range(NUM_SHARDS)]
    finally:
        cs.close()


def _assert_same_ds(a: str, b: str) -> None:
    for res in RESOLUTIONS:
        sa, sb = _ds_samples(a, res), _ds_samples(b, res)
        assert sa.keys() == sb.keys() and sa
        for k in sa:
            np.testing.assert_array_equal(sa[k][0], sb[k][0])
            np.testing.assert_array_equal(sa[k][1], sb[k][1])
        assert _ds_part_keys(a, res) == _ds_part_keys(b, res)


def _run_job(package: str, root: str, now_ms: int) -> dict:
    if package == "ref":
        cs, meta = RefCS(root), RefMeta(root)
        job = RefJob(cs, DS, NUM_SHARDS, RESOLUTIONS, max_chunk_size=CHUNK,
                     meta_store=meta)
    else:
        from filodb_tpu_torch.core.store.localstore import (
            LocalDiskColumnStore,
            LocalDiskMetaStore,
        )
        cs, meta = LocalDiskColumnStore(root), LocalDiskMetaStore(root)
        job = DownsamplerJob(cs, DS, NUM_SHARDS, RESOLUTIONS,
                             max_chunk_size=CHUNK, meta_store=meta)
    try:
        return job.catch_up(now_ms)
    finally:
        cs.close()
        meta.close()


@pytest.fixture(scope="module")
def raw_dirs(pair_root):
    """The two packages' raw directories after both flushes (the stores
    of ``pair`` keep their connections; the jobs run on copies)."""
    return {p: str(pair_root[1] / p) for p in ("ref", "port")}


@pytest.mark.parametrize("reader", ["ref", "port"])
def test_raw_directories_hold_the_same_chunks(raw_dirs, reader):
    """Both packages flushed the same raw chunks: the port's job over
    either directory writes the same ds chunks."""
    from filodb_tpu_torch.core.store.localstore import LocalDiskColumnStore

    cs = LocalDiskColumnStore(raw_dirs[reader])
    try:
        rows = cs.scan_chunk_rows_by_ingestion_time(DS, 0, 0, 2**62)
        assert rows and all(len(r) == 2 for r in rows)
        # a partition's chunks come in chunk-id order
        ids = [(bytes(b), int(np.frombuffer(bytes(d[:8]), np.int64)[0]))
               for b, d in rows]
        assert ids == sorted(ids)
    finally:
        cs.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_job_writes_the_same_ds_chunks(raw_dirs, writer, tmp_path):
    """The port's job and the reference's, each over a copy of ``writer``'s
    raw directory, write the same ds chunks (samples bit for bit, chunk
    ids, part keys in order) and report the same counts."""
    a = _copy_dir(raw_dirs[writer], tmp_path / "a")
    b = _copy_dir(raw_dirs[writer], tmp_path / "b")
    got = _run_job("port", a, 5_000)
    want = _run_job("ref", b, 5_000)
    for k in ("partitions", "ds_chunks", "ds_samples", "scanned_from"):
        assert got[k] == want[k], k
    _assert_same_ds(a, b)


@pytest.mark.parametrize("order", [("ref", "port"), ("port", "ref")])
def test_job_resumes_from_the_other_packages_checkpoint(raw_dirs, order,
                                                        tmp_path):
    """A job that catches up to between the two flushes, then one of the
    other package: the second scans from the first's checkpoint (the
    second flush's window only), and the ds chunks equal those of one
    package doing both runs."""
    first, second = order
    mixed = _copy_dir(raw_dirs["port"], tmp_path / "mixed")
    alone = _copy_dir(raw_dirs["port"], tmp_path / "alone")
    s1 = _run_job(first, mixed, 1_500)
    assert s1["scanned_from"] == {0: 0, 1: 0}
    s2 = _run_job(second, mixed, 5_000)
    assert s2["scanned_from"] == {0: 1_500, 1: 1_500}
    # only the second flush's chunks were read
    assert 0 < s2["ds_samples"] < s1["ds_samples"] + s2["ds_samples"]
    _run_job(first, alone, 1_500)
    again = _run_job(first, alone, 5_000)
    assert again["ds_samples"] == s2["ds_samples"]
    _assert_same_ds(mixed, alone)
    # a third run finds nothing new: the checkpoint holds
    s3 = _run_job(second, mixed, 6_000)
    assert s3["ds_samples"] == 0 and s3["scanned_from"] == {0: 5_000,
                                                            1: 5_000}


@pytest.fixture(scope="module")
def ds_dirs(raw_dirs, tmp_path_factory):
    """Each package's raw directory with its own job's ds chunks."""
    base = tmp_path_factory.mktemp("dsdirs")
    out = {}
    for p in ("ref", "port"):
        out[p] = _copy_dir(raw_dirs[p], base / p)
        _run_job(p, out[p], 5_000)
    return out


def _port_store(root: str):
    return open_local(root, NUM_SHARDS, 0,
                      StoreConfig(max_chunk_size=CHUNK, groups_per_shard=2))


@pytest.mark.parametrize("col", ["min", "max", "sum", "count", "avg"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_ds_store_reads_the_other_packages_chunks(ds_dirs, writer, col):
    """The reference's ``DownsampledTimeSeriesStore`` and the port's read
    ``writer``'s ds chunks: the same partitions, and a column's samples as
    the reference's ``PagedReadablePartition.read_samples`` gives them,
    bit for bit (the port's read is its page-in and host decode)."""
    root = ds_dirs[writer]
    ref_ds = RefDs(RefCS(root), DS, RES, NUM_SHARDS)
    port_ds = DownsampledTimeSeriesStore(_port_store(root).column_store, DS,
                                         RES, NUM_SHARDS)
    from filodb_tpu.core.filters import ColumnFilter, Equals
    from filodb_tpu_torch.core.filters import ColumnFilter as PF
    from filodb_tpu_torch.core.filters import Equals as PE

    for s in range(NUM_SHARDS):
        rs = ref_ds.get_shard(DS, s)
        pids = rs.lookup_partitions(
            [ColumnFilter("_metric_", Equals("heap_usage"))], 0, 2**62)
        ps = port_ds.shards[s]
        ppids = ps.lookup_partitions([PF("_metric_", PE("heap_usage"))], 0,
                                     2**62)
        assert len(pids) == len(ppids)
        for pid in pids:
            part = rs.partition(pid)
            ci = [c.name for c in part.schema.data.columns].index(col)
            ts, vals = part.read_samples(0, 2**62, ci)
            mine = int(ps.lookup_keys([part.part_key.serialized])[0])
            with ps.lock:
                got = ps._samples(np.array([mine]), 0, 2**62, col,
                                  ps._page_in(np.array([mine]), 0, 2**62))
            (cb, _, _), = got.codec
            d = decode_chunks(cb, SCHEMAS["ds-gauge"])
            live = np.arange(d.ts.shape[1])[None, :] < d.rows[:, None]
            np.testing.assert_array_equal(d.ts[live], ts)
            np.testing.assert_array_equal(_bits(d.dcols[:, got.column][live]),
                                          _bits(vals))


# ---- queries ----------------------------------------------------------------------

DS_QUERIES = (
    "max_over_time(heap_usage[10m])",
    "min_over_time(heap_usage[10m])",
    "sum(sum_over_time(heap_usage[15m])) by (host)",
    "count_over_time(heap_usage[15m])",
    "avg(avg_over_time(heap_usage[15m]))",
    "sum(rate(http_requests_total[15m])) by (job)",
    "heap_usage::max",
    "max(max_over_time(heap_usage[15m])) by (_ns_)",
)


def _ref_answer(ms, planner, q, start, step, end):
    plan = ref_parse(q, RefParams(start, step, end))
    ep = planner.materialize(plan)
    m = ep.dispatcher.dispatch(ep, RefCtx(ms, DS)).result
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order], m.steps_ms


def _port_answer(svc, q, start, step, end):
    r = svc.query_range(q, start, step, end)
    m = r.result.materialize()
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return ([keys[i] for i in order], np.asarray(m.values)[order],
            np.asarray(m.steps_ms), r)


def _planners(root: str, raw_retention_ms: int):
    """(reference service store and long-time planner, port service with
    its long-time planner) over the raw and ds data under ``root``."""
    rcs = RefCS(root)
    ref_ms = TimeSeriesMemStore(rcs, RefMeta(root))
    for s in range(NUM_SHARDS):
        ref_ms.setup(DS, s, RefConfig(max_chunk_size=CHUNK,
                                      groups_per_shard=2))
        ref_ms.get_shard(DS, s).recover_index()
    ref_ds = RefDs(rcs, DS, RES, NUM_SHARDS)
    ref_planner = RefLongTime(
        RefPlanner(DS, NUM_SHARDS, 0, agg_pushdown="off"),
        RefPlanner(DS, NUM_SHARDS, 0, store=ref_ds, agg_pushdown="off"),
        raw_retention_ms, now_ms=lambda: NOW)
    port_ms = _port_store(root)
    for s in range(NUM_SHARDS):
        port_ms.recover_index(s)
    svc = QueryService(port_ms, device="cpu", engine="exec")
    port_ds = DownsampledTimeSeriesStore(port_ms.column_store, DS, RES,
                                         NUM_SHARDS)
    svc.planner = LongTimeRangePlanner(
        svc.planner, SingleClusterPlanner(NUM_SHARDS, 0, store=port_ds),
        raw_retention_ms, now_ms=lambda: NOW)
    return (ref_ms, ref_planner), svc


@pytest.fixture(scope="module", params=["ref", "port"])
def longtime(ds_dirs, request):
    """Both packages' long-time planners over ``writer``'s directory,
    raw retention from ``EARLIEST_RAW``."""
    return _planners(ds_dirs[request.param], NOW - EARLIEST_RAW)


@pytest.mark.parametrize("q", DS_QUERIES)
def test_all_downsample_answers_match_the_reference(longtime, q):
    (ref_ms, ref_planner), svc = longtime
    args = (START + 900, 300, START + 2400)
    keys, want, steps = _ref_answer(ref_ms, ref_planner, q, *args)
    got_keys, got, got_steps, r = _port_answer(svc, q, *args)
    assert got_keys == keys and len(keys)
    np.testing.assert_array_equal(got_steps, steps)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).any()
    assert r.stats.engine == "exec"


@pytest.mark.parametrize("q", DS_QUERIES[:6])
def test_straddling_answers_match_the_reference(longtime, q):
    """A range across raw retention: the ds part up to the first step
    whose window lies in raw data, the raw part from there, stitched."""
    (ref_ms, ref_planner), svc = longtime
    args = (START + 900, 300, START + 5400)
    keys, want, steps = _ref_answer(ref_ms, ref_planner, q, *args)
    got_keys, got, got_steps, _ = _port_answer(svc, q, *args)
    assert got_keys == keys
    np.testing.assert_array_equal(got_steps, steps)
    np.testing.assert_allclose(got, want, **TOL)


def _tree(plan, leaf_type) -> list:
    """(depth, node kind, a leaf's shard, data range, column and whether it
    reads another store, transformers) in tree order."""
    out = []

    def walk(node, depth):
        leaf = (node.shard, node.chunk_start, node.chunk_end,
                node.value_column, node.store is not None) \
            if isinstance(node, leaf_type) else ()
        out.append((depth, type(node).__name__, leaf,
                    tuple(type(t).__name__ for t in node.transformers)))
        for c in node.children():
            walk(c, depth + 1)

    walk(plan, 0)
    return out


PLAN_CASES = {
    # (query, start, step, end) in seconds past START
    "all_raw": ("max_over_time(heap_usage[5m])", 4000, 300, 5000),
    "all_downsample": ("max_over_time(heap_usage[10m])", 900, 300, 2400),
    "straddling": ("max_over_time(heap_usage[10m])", 900, 300, 5400),
    "exact_boundary_stays_all_raw": ("max_over_time(heap_usage[10m])",
                                     3600, 300, 5000),
    "one_step_before_boundary_stitches": ("max_over_time(heap_usage[10m])",
                                          3300, 300, 5000),
    "avg_nested_under_aggregate": ("sum(avg_over_time(heap_usage[10m]))",
                                   900, 300, 2400),
    "avg_under_binary_join": ("avg_over_time(heap_usage[10m]) / "
                              "avg_over_time(heap_usage[10m])",
                              900, 300, 3900),
    "count_rewrite": ("sum(count_over_time(heap_usage[15m])) by (host)",
                      900, 60, 3700),
}


@pytest.mark.parametrize("case", PLAN_CASES)
def test_longtime_planner_gives_the_reference_tree(case):
    q, a, step, b = PLAN_CASES[case]
    ref = RefLongTime(RefPlanner(DS, NUM_SHARDS, 0, agg_pushdown="off"),
                      RefPlanner(DS, NUM_SHARDS, 0, store=object(),
                                 agg_pushdown="off"),
                      NOW - EARLIEST_RAW, now_ms=lambda: NOW)
    port = LongTimeRangePlanner(SingleClusterPlanner(NUM_SHARDS, 0),
                                SingleClusterPlanner(NUM_SHARDS, 0,
                                                     store=object()),
                                NOW - EARLIEST_RAW, now_ms=lambda: NOW)
    want = _tree(ref.materialize(ref_parse(q, RefParams(
        START + a, step, START + b))), RefLeaf)
    got = _tree(port.materialize(parse_query(q, TimeStepParams(
        START + a, step, START + b))), SelectRawPartitionsExec)
    assert got == want
    plan = parse_query(q, TimeStepParams(START + a, step, START + b))
    ref_plan = ref_parse(q, RefParams(START + a, step, START + b))
    assert port.mem_only(plan) == ref.mem_only(ref_plan)
    assert port.cost_hint(plan) == ref.cost_hint(ref_plan)


@pytest.mark.parametrize("q", [PLAN_CASES["avg_nested_under_aggregate"][0],
                               PLAN_CASES["avg_under_binary_join"][0],
                               "max(min_over_time(heap_usage::max[5m]))"])
def test_rewrite_for_downsample_matches_the_reference(q):
    """The rewrite of every windowing node in the tree: the columns and
    functions it reads, node for node."""
    def shape(p, lp):
        import dataclasses

        if isinstance(p, lp.PeriodicSeriesWithWindowing):
            return ("w", p.function, p.raw.column)
        if isinstance(p, lp.BinaryJoin):
            return ("j", p.op, shape(p.lhs, lp), shape(p.rhs, lp))
        kids = [shape(getattr(p, f.name), lp) for f in dataclasses.fields(p)
                if isinstance(getattr(p, f.name), lp.LogicalPlan)]
        return (type(p).__name__, *kids)

    from filodb_tpu.query import logical as ref_lp
    from filodb_tpu_torch.query import logical as port_lp

    args = (START + 900, 300, START + 2400)
    want = shape(ref_rewrite(ref_parse(q, RefParams(*args))), ref_lp)
    got = shape(rewrite_for_downsample(parse_query(q, TimeStepParams(
        *args))), port_lp)
    assert got == want


# ---- the streaming downsampler ------------------------------------------------------


def test_streaming_downsampler_publishes_the_reference_records(tmp_path):
    """A flush hands the downsampler its flushed partitions: the records
    published a resolution are the reference's ``on_flush`` records, bit
    for bit."""
    rcs, rmeta = RefCS(str(tmp_path / "r")), RefMeta(str(tmp_path / "r"))
    ref = TimeSeriesMemStore(rcs, rmeta)
    for s in range(NUM_SHARDS):
        ref.setup(DS, s, RefConfig(max_chunk_size=CHUNK, groups_per_shard=2))
        rmeta.read_checkpoints(DS, s)
    port = open_local(str(tmp_path / "p"), NUM_SHARDS, 0,
                      StoreConfig(max_chunk_size=CHUNK, groups_per_shard=2))
    got, want = {}, {}
    for s in range(NUM_SHARDS):
        ref.get_shard(DS, s).downsampler = RefShardDs(
            RESOLUTIONS, lambda res, c, s=s: want.setdefault(
                (s, res), []).extend(c.records))
        port.shards[s].downsampler = ShardDownsampler(
            RESOLUTIONS, lambda res, c, s=s: got.setdefault(
                (s, res), []).extend(c.records))
    _ingest(ref, port, _containers(0, 250), 0)
    _flush(ref, port, T_FIRST)
    _ingest(ref, port, _containers(250, 400), 250)
    _flush(ref, port, T_SECOND)
    assert got.keys() == want.keys() and got
    for k in want:
        # the reference flushes a shard's groups side by side, so only a
        # partition's records keep their order
        assert sorted(_rec_bits(r) for r in got[k]) == \
            sorted(_rec_bits(r) for r in want[k]), k
    assert sum(port.shards[s].stats.downsample_records.value
               for s in range(NUM_SHARDS)) == sum(map(len, got.values()))


def _ds_container(keys, ts, vals) -> RecordContainer:
    c = RecordContainer()
    for k, t, v in zip(keys, ts, vals):
        c.add(IngestRecord(k, int(t), tuple(float(x) for x in v)))
    return c


def test_ds_gauge_records_ingest_seal_flush_and_read_back(tmp_path):
    """``ds-gauge`` records through containers: five columns a sample in
    buffers of their own, sealed into chunks whose codec columns, after a
    flush and a restart (the chunks paged back in), read back bit for bit,
    each column on its own; the columns float32 holds take the page lane,
    the others the host-decode lane."""
    import torch

    from filodb_tpu_torch.core.filters import ColumnFilter, Equals
    from filodb_tpu_torch.query.engine.device_batch import (
        build_device_batch,
        decode_packed,
    )

    rng = np.random.default_rng(5)
    keys = [PartKey.create("ds-gauge", {"_metric_": "load", "_ws_": "w",
                                         "_ns_": "n", "host": f"h{i}"})
            for i in range(3)]
    T = 150
    ts = (START * 1000 + 300_000 * np.arange(T)).astype(np.int64)
    vals = np.zeros((3, T, 5))
    vals[..., 0] = np.round(rng.normal(0, 10, (3, T)))       # min: exact
    vals[..., 1] = vals[..., 0] + 5                           # max: exact
    vals[..., 2] = rng.normal(0, 10, (3, T))                  # sum: decimal
    vals[..., 3] = 30.0                                       # count: exact
    vals[..., 4] = vals[..., 2] / 30.0                        # avg: decimal
    root = str(tmp_path / "d")
    ms = open_local(root, 1, 0, StoreConfig(max_chunk_size=64,
                                            groups_per_shard=1))
    recs = [(k, ts[j], vals[i, j]) for j in range(T)
            for i, k in enumerate(keys)]
    for a in range(0, len(recs), 100):
        part = recs[a:a + 100]
        ms.shards[0].ingest(SomeData(_ds_container(
            [r[0] for r in part], [r[1] for r in part],
            [r[2] for r in part]), a // 100))
    shard = ms.shards[0]
    assert shard.multi[:3].all() and len(shard.multi_chunks["pid"]) == 6
    ms.flush_all(10)

    def read(store, col):
        sh = store.shards[0]
        pids = sh.lookup_partitions([ColumnFilter("_metric_",
                                                  Equals("load"))], 0, 2**62)
        return build_device_batch([(sh, pids)], 0, 2**62,
                                  torch.device("cpu"), col)

    again = open_local(root, 1, 0, StoreConfig(max_chunk_size=64,
                                               groups_per_shard=1))
    again.recover_index(0)
    for j, col in enumerate(("min", "max", "sum", "count", "avg")):
        for store in (ms, again):
            b = read(store, col)
            host = type(b).__name__ == "SeriesBatch"
            assert host == (col in ("sum", "avg")), col
            if host:
                got = b.vals.numpy()[:, :T]
                np.testing.assert_array_equal(_bits(got),
                                              _bits(vals[..., j]))
            else:
                _, got, live = decode_packed(b.packed, plain=True)
                assert int(b.counts.sum()) == 3 * T
                for i in range(3):
                    np.testing.assert_array_equal(
                        got[i][live[i]].numpy(),
                        vals[i, :, j].astype(np.float32))


def test_sidecar_lane_bypasses_downsample_leaves(ds_dirs):
    """A leaf over the downsample store takes the decode path and counts
    its bypass: the ds shard's partitions are no warm memory partitions."""
    _, svc = _planners(ds_dirs["port"], NOW - EARLIEST_RAW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FILODB_SIDECARS", "1")
        r = svc.query_range("sum_over_time(heap_usage[10m])", START + 900,
                            300, START + 2400)
    assert r.stats.sidecar_bypassed.get("cold partitions", 0) >= 1
    assert not r.stats.sidecar_chunks


def test_raw_and_ds_batches_never_share_a_cache_entry(ds_dirs):
    """The same selector, range and column over the raw store and the ds
    store (counters keep their schema in the ds tier) are two batch-cache
    entries, each owned by its shard: the answers differ as raw and ds
    data differ, in either order of the queries."""
    root = ds_dirs["port"]
    (_, _), svc = _planners(root, NOW - EARLIEST_RAW)
    raw = svc.planner.raw_planner
    ds = svc.planner.ds_planner
    q = "rate(http_requests_total[10m])"
    args = (START + 900, 300, START + 2400)
    answers = {}
    for name in ("raw", "ds", "raw"):
        svc.planner = raw if name == "raw" else ds
        plan = rewrite_for_downsample(parse_query(q, TimeStepParams(*args)))
        answers.setdefault(name, []).append(
            np.asarray(svc.execute_logical(plan).result.materialize().values))
    np.testing.assert_array_equal(answers["raw"][0], answers["raw"][1])
    assert answers["raw"][0].shape == answers["ds"][0].shape
    assert not np.array_equal(answers["raw"][0], answers["ds"][0],
                              equal_nan=True)
    keys = [k for k in svc.batches._entries if k[0] == "exec"]
    assert {k[1] for k in keys} == {DS, ds_dataset_name(DS, RES)}


# ---- faults of the reference the port does not share (ROADMAP §C) ---------------


def test_rollups_after_a_jobs_part_keys_are_found(ds_dirs, tmp_path):
    """ROADMAP §C.10: a streaming ds shard recovers the part keys the job
    wrote, which end at their last period; rollups ingested after that
    must be found by a lookup past the old end. The reference keeps the
    recovered end time and misses them; the port reopens the partition
    (its end back to ingesting, its key dirty)."""
    from filodb_tpu.core.filters import ColumnFilter as RefFilter
    from filodb_tpu.core.filters import Equals as RefEquals
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals

    root = _copy_dir(ds_dirs["port"], tmp_path / "d")
    name = ds_dataset_name(DS, RES)
    gauges, _ = _keys()
    later = (START + 7000) * 1000
    recs = [RefRecord(RefPartKey("ds-gauge", k.labels), later,
                      (1.0, 2.0, 3.0, 2.0, 1.5)) for k in gauges]
    ref = TimeSeriesMemStore(RefCS(root), RefMeta(root))
    port = open_local(root, NUM_SHARDS, 0, StoreConfig(
        max_chunk_size=CHUNK, groups_per_shard=2), dataset=name)
    found = {"ref": 0, "port": 0}
    for s in range(NUM_SHARDS):
        ref.setup(name, s, RefConfig(max_chunk_size=CHUNK,
                                     groups_per_shard=2))
        rs = ref.get_shard(name, s)
        rs.recover_index()
        port.recover_index(s)
        mine = RefContainer()
        have = port.shards[s].lookup_keys([r.part_key.serialized
                                           for r in recs])
        for r, pid in zip(recs, have.tolist()):
            if pid >= 0:  # the shard whose ds key the job wrote
                mine.add(r)
        if not len(mine):
            continue
        ref.ingest(name, s, RefSomeData(mine, 1))
        port.shards[s].ingest(SomeData(BytesContainer(mine.serialize()), 1))
        found["ref"] += len(rs.lookup_partitions(
            [RefFilter("_metric_", RefEquals("heap_usage"))], later, later))
        found["port"] += len(port.shards[s].lookup_partitions(
            [ColumnFilter("_metric_", Equals("heap_usage"))], later, later))
    assert found["port"] == len(gauges)
    assert found["ref"] == 0  # the fault the port does not share


def test_a_ds_store_sees_the_jobs_later_output_after_a_refresh(raw_dirs,
                                                               tmp_path):
    """ROADMAP §C.11: the reference's ds store loads its index on first use
    and never again, so a store queried before the job's first run never
    sees its output; the port's node refreshes its ds store after each
    run (``FiloServer._run_job``), and a refresh moves the store's
    version."""
    from filodb_tpu.core.filters import ColumnFilter as RefFilter
    from filodb_tpu.core.filters import Equals as RefEquals
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals

    root = _copy_dir(raw_dirs["port"], tmp_path / "d")
    ref_ds = RefDs(RefCS(root), DS, RES, NUM_SHARDS)
    port_ds = DownsampledTimeSeriesStore(_port_store(root).column_store, DS,
                                         RES, NUM_SHARDS)
    f_ref = [RefFilter("_metric_", RefEquals("heap_usage"))]
    f_port = [ColumnFilter("_metric_", Equals("heap_usage"))]

    def count():
        return (sum(len(ref_ds.get_shard(DS, s).lookup_partitions(
                    f_ref, 0, 2**62)) for s in range(NUM_SHARDS)),
                sum(len(port_ds.shards[s].lookup_partitions(f_port, 0,
                                                            2**62))
                    for s in range(NUM_SHARDS)))

    assert count() == (0, 0)
    _run_job("port", root, 5_000)
    v = port_ds.data_version
    port_ds.refresh_index()
    assert count() == (0, 6) and port_ds.data_version > v
