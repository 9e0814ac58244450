"""The port stands alone: importing ``filodb_tpu_torch`` and answering a
query loads neither JAX nor any module of the JAX package. Checked in a
fresh interpreter, because this test process imports JAX for every test;
there both are blocked (an import of either raises), and the port's
modules, histograms, absent, count_values, sort, label functions, limit,
scalars, @, subqueries, instant queries, the metadata calls, the exec
engine and its planner (``query/exec/plan.py``,
``coordinator/planner.py``) and the histogram columns it serves included,
import and answer all the same; and so do the write path's modules (the
host codec, chunks, containers, the column stores, the WAL, on-demand
paging), through a flush, a restart and a paged query, and the
host-decode lane, through a query over load averages with two decimals;
and the node's
(configuration, cluster, gateway, HTTP fronts, index snapshots, metrics),
through a ``FiloServer(device="cpu")`` fed by its gateway and queried
over HTTP; and the query control plane's (tracing, resilience, the
governor, the cost model and the adaptive planner, the adaptive engine),
through that node with the governor, resilience, cost-model and tracing
blocks set away from their defaults and acted on; and the C++ ingest core
(``core/memstore/native_shard.py``), through a container ingested into a
shard, after which the process's ``/proc/self/maps`` holds the port's own
``libingestcore`` and no library under the JAX package's ``native/``; and
long retention's (the downsampler job, the ds store, the cold tier, the
tiered planner and ``TierExec``), through a query over three tiers; and
the object-store tier's (``objectstore``, ``pyramid``, ``sketches``,
``fake_s3``, the pyramid lane), through a flush to a bucket, a cold query
the pyramid lane serves and the approximate sketches; and the standing
queries' (``rules``, ``utils/selfmon``, ``utils/racecheck``,
``http/remote_read``, ``core/store/repair``), through a rule tick over the
store, a self-monitor tick, a remote read and the repair jobs' split
scans over a local-disk store; and the multi-process mesh runtime's
(``parallel/multiproc``, ``coordinator/{mesh_cluster,remote,wire}``),
through a query answered by two in-thread mesh workers and by a spawned
worker process. The spawned worker's seed callable, run inside the
worker, exits it where ``jax`` or ``filodb_tpu`` is loaded and blocks
both for the rest of its life, so a worker that loaded either never
answers: the check needs no field of the worker's protocol.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json, sys
sys.modules["jax"] = None         # any import of these now raises
sys.modules["filodb_tpu"] = None
import numpy as np
import filodb_tpu_torch
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.http.promjson import matrix_json
from filodb_tpu_torch.memory import codecs
from filodb_tpu_torch.query.engine import instantfns
from filodb_tpu_torch.query.exec import binaryjoin, plan, transformers
from filodb_tpu_torch.coordinator import planner
from filodb_tpu_torch.testing import from_jax

store = MemStore(num_shards=4, spread=1, max_chunk_size=64)
rng = np.random.default_rng(0)
n, T = 12, 150
ts = 1_600_000_000_000 + np.arange(T) * 10_000 + rng.integers(-500, 501, (n, T))
vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
labels = [{"_metric_": "http_requests_total", "_ws_": "demo",
           "_ns_": f"App-{i % 2}", "instance": f"i-{i}", "job": f"job-{i % 3}"}
          for i in range(n)]
store.ingest_series(labels, ts, vals)
svc = QueryService(store, device="cpu")
body = matrix_json(svc.query_range(
    "sum(rate(http_requests_total[5m])) by (_ns_)",
    1_600_000_600, 60, 1_600_001_400))
joined = svc.query_range(
    "abs(topk(2, max_over_time(http_requests_total[5m]))) / on (instance) "
    "(http_requests_total * 2) or quantile(0.5, http_requests_total)",
    1_600_000_600, 60, 1_600_001_400)
les = np.array([0.1, 1.0, np.inf])
hist = np.cumsum(np.cumsum(rng.integers(0, 4, (n, T, 3)), axis=2), axis=1)
store.ingest_histograms([{**lb, "_metric_": "lat"} for lb in labels], ts,
                        hist, les, sums=0.25 * hist[:, :, -1],
                        counts=hist[:, :, -1].astype(float))
ex = QueryService(store, device="cpu", engine="exec")
exec_rows = ex.query_range("sum(rate(http_requests_total[5m])) by (_ns_)",
                           1_600_000_600, 60, 1_600_001_400).result.num_series
mean = svc.query_range("sum(rate(lat::sum[5m])) by (_ns_) / "
                       "sum(rate(lat::count[5m])) by (_ns_)",
                       1_600_000_600, 60, 1_600_001_400)
flat = matrix_json(svc.query_range("sum(rate(lat[5m])) by (_ns_)",
                                   1_600_000_600, 60, 1_600_001_400))
quant = svc.query_range("histogram_quantile(0.9, sum(rate(lat[5m])) by (job))",
                        1_600_000_600, 60, 1_600_001_400)
from filodb_tpu_torch.http.promjson import scalar_json, vector_json
shapes = {}
for q in ('absent(nope{job="x"})', 'count_values("v", http_requests_total % 3)',
          "sort_desc(rate(http_requests_total[5m]))",
          'label_replace(http_requests_total, "j", "$1", "job", "job-(.*)")',
          "limit(2, http_requests_total)", "http_requests_total * time()",
          "scalar(sum(rate(http_requests_total[5m])))", "vector(1) + 1",
          "sum(rate(http_requests_total[5m] @ 1600001000)) by (_ns_)",
          "max_over_time(sum(rate(http_requests_total[5m])) by (_ns_)[10m:1m])"):
    shapes[q] = svc.query_range(q, 1_600_000_600, 60, 1_600_001_400) \
        .result.num_series
inst = vector_json(svc.query_instant("sum(rate(http_requests_total[5m])) "
                                     "by (_ns_)", 1_600_001_400))
scal = scalar_json(svc.query_instant("time()", 1_600_001_400))
store.ingest_series([{**lb, "_metric_": "load1"} for lb in labels], ts,
                    np.round(rng.random((n, T)) * 64, 2), schema="gauge")
host = svc.query_range("sum(idelta(load1[5m])) by (_ns_)", 1_600_000_600,
                       60, 1_600_001_400)
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
app0 = parse_query('lat{_ns_="App-0"}', TimeStepParams(0, 0, 0)).raw.filters
meta = {"names": svc.label_names(), "jobs": svc.label_values("job"),
        "series": len(svc.series(app0, 1_600_000_000, 1_600_002_000))}
import tempfile
from filodb_tpu_torch.core import record
from filodb_tpu_torch.core.memstore import odp
from filodb_tpu_torch.core.store import api, config, localstore
from filodb_tpu_torch.kafka import log as wal
from filodb_tpu_torch.memory import chunk, nibblepack
from filodb_tpu_torch.testing.from_jax import open_local, restart
root = tempfile.mkdtemp()
disk = open_local(root, num_shards=4, spread=1)
disk.ingest_series(labels, ts, vals)
disk.flush_all()
logs = {s: wal.SegmentedFileLog(f"{root}/wal-{s}") for s in range(4)}
for s, sh in enumerate(disk.shards):
    c = record.RecordContainer()
    for k in sh.keys:
        c.add(record.IngestRecord(k, int(ts.max()) + 10_000, (1e6,)))
    sh.ingest(record.SomeData(c, logs[s].append(c)))
disk.close()
again = open_local(root, num_shards=4, spread=1)
durable = restart(again, logs)
paged = QueryService(again, device="cpu").query_range(
    "sum(count_over_time(http_requests_total[30m])) by (_ns_)",
    1_600_001_500, 60, 1_600_001_510)
durable["rows"] = paged.result.num_series
durable["paged"] = sum(sh.odp_cache.chunks_paged for sh in again.shards)
from filodb_tpu_torch.query.engine import sidecar_lane
from filodb_tpu_torch.utils import bloom
served = sidecar_lane.SIDECAR_SERVED.value
tick = svc.query_instant("sum(count_over_time(http_requests_total[5m]))",
                         1_600_001_400)
bounded = open_local(tempfile.mkdtemp(), num_shards=1, spread=0)
bounded.ingest_series(labels[:4], ts[:4], vals[:4])
bounded.flush_all()
memory = {"sidecar": [tick.stats.engine,
                      sidecar_lane.SIDECAR_SERVED.value - served],
          "evicted": bounded.shards[0].evict_cold_partitions(3),
          "purged": bounded.shards[0].purge_expired(2_000_000_000_000),
          "bloom": bounded.shards[0].evicted_keys.count}
bounded.close()
import socket, time, urllib.request
from filodb_tpu_torch import config as server_config
from filodb_tpu_torch import standalone
from filodb_tpu_torch.coordinator import cluster, ingestion, shardmapper
from filodb_tpu_torch.core.memstore import cardinality, index_snapshot
from filodb_tpu_torch.gateway import influx, server as gateway_server
from filodb_tpu_torch.http import fastserver, server as http_server
from filodb_tpu_torch.utils import metrics
node_root = tempfile.mkdtemp()
from filodb_tpu_torch.coordinator import adaptive_planner
from filodb_tpu_torch.parallel import adaptive
from filodb_tpu_torch.query import cost_model
from filodb_tpu_torch.utils import governor, resilience, tracing
adaptive_rows = QueryService(store, device="cpu", engine="adaptive") \
    .query_range("sum(rate(http_requests_total[5m])) by (_ns_)",
                 1_600_000_600, 60, 1_600_001_400).result.num_series
srv = from_jax.boot(standalone.FiloServer, server_config.ServerConfig,
                    {"datasets": {"timeseries": {"num_shards": 2}},
                     "governor": {"admission_capacity": 4},
                     "resilience": {"query_timeout_s": 5.0},
                     "cost_model": {"min_samples": 2},
                     "tracing": {"sample_rate": 1.0,
                                 "slow_query_threshold_ms": 1e-6}},
                    node_root, device="cpu")
with socket.create_connection(("127.0.0.1", srv.gateway.port)) as s:
    s.sendall("".join(f"up,_ws_=w,_ns_=n,i=i{i % 3} value={i} "
                      f"{(1_600_000_000 + 10 * i) * 10**9}\n"
                      for i in range(30)).encode())
node = {"statuses": None, "rows": 0, "snapshot": 0}
for _ in range(300):
    srv.gateway.sink.flush()
    url = (f"http://127.0.0.1:{srv.http.port}/promql/timeseries/api/v1/"
           "query?query=sum(count_over_time(up[1h]))&time=1600000300")
    res = json.loads(urllib.request.urlopen(url).read())["data"]["result"]
    if res and float(res[0]["value"][1]) == 30:
        node["rows"] = 30
        break
    time.sleep(0.05)
node["statuses"] = [e["status"] for e in
                    srv.cluster.shard_statuses("timeseries")]
node["snapshot"] = sum(int(sh.snapshot_index() > 0) for sh in
                       srv.node.memstores["timeseries"].shards)
api = f"http://127.0.0.1:{srv.http.port}/promql/timeseries/api/v1/debug/"
slow = json.loads(urllib.request.urlopen(api + "slow_queries").read())
costs = json.loads(urllib.request.urlopen(api + "costmodel").read())
control = [governor.config().admission_capacity,
           resilience.config().query_timeout_s,
           cost_model.model_for("timeseries").min_samples,
           tracing.config().sample_rate,
           bool(slow["data"]["slow_queries"][0]["spans"]),
           costs["data"]["min_samples"], srv.watchdog is not None]
srv.shutdown()
import os
control.append(os.path.exists(f"{node_root}/columnstore/timeseries/"
                              "costmodel.json"))
control.append(governor.governor().state)
from filodb_tpu_torch.core.memstore import native_shard
from filodb_tpu_torch.core.memstore.shard import Shard
core_shard = Shard(0)
c = record.RecordContainer()
for k in sh.keys:
    c.add(record.IngestRecord(k, int(ts.max()) + 20_000, (2e6,)))
core = [core_shard.ingest(record.SomeData(
    record.BytesContainer(c.serialize()), 0)), core_shard.num_partitions,
    int(core_shard.lookup_keys([sh.keys[0].serialized])[0]),
    isinstance(core_shard.core, native_shard.NativeShardCore)]
libs = {line.split()[-1] for line in open("/proc/self/maps")
        if line.rstrip().endswith(".so")}
core.append(sorted(p for p in libs if "/native/" in p
                   or "filodb_native" in p))
core.append(any("libingestcore" in p for p in libs))
# long retention: the job over a local-disk store, then counters and a
# ds-gauge column over three tiers through the tiered planner
import tempfile
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.tiered_planner import build_tiered_planner
from filodb_tpu_torch.core.downsample import (
    DownsampledTimeSeriesStore, DownsamplerJob)
lt = from_jax.open_local(tempfile.mkdtemp(), 2, 1)
T2 = 720
ts2 = 1_600_000_000_000 + np.arange(T2) * 10_000
lt.ingest_series(labels, np.tile(ts2, (n, 1)),
                 np.cumsum(rng.integers(0, 20, (n, T2)), axis=1).astype(float))
lt.ingest_series([{**lb, "_metric_": "load"} for lb in labels],
                 np.tile(ts2, (n, 1)), rng.normal(5, 1, (n, T2)),
                 schema="gauge")
lt.flush_all(1_000)
job = DownsamplerJob(lt.column_store, lt.dataset, 2,
                     meta_store=lt.meta_store).catch_up(2_000)
end2 = 1_600_000_000_000 + T2 * 10_000
tsvc = QueryService(lt, device="cpu")
tsvc.planner = build_tiered_planner(
    SingleClusterPlanner(2, 1), lt.column_store, lt.dataset, 2, 1,
    mem_retention_ms=1_800_000, raw_retention_ms=3_600_000,
    ds_planner=SingleClusterPlanner(2, 1, store=DownsampledTimeSeriesStore(
        lt.column_store, lt.dataset, 300_000, 2)), now_ms=lambda: end2)
longterm = []
for q in ("sum(rate(http_requests_total[10m])) by (_ns_)",
          "avg(avg_over_time(load[10m]))"):
    r = tsvc.query_range(q, end2 // 1000 - 7200, 60, end2 // 1000)
    longterm.append([r.stats.engine, sorted(r.stats.tiers),
                     r.result.num_series])
longterm.append(job["ds_chunks"] > 0)
# the object-store tier: a flush to a directory-backed fake S3, a cold
# query the pyramid lane serves, the approximate sketches
import os
from filodb_tpu_torch.core.store import objectstore, pyramid
from filodb_tpu_torch.core.store.api import InMemoryMetaStore
from filodb_tpu_torch.memory import sketches
from filodb_tpu_torch.query.engine import pyramid_lane
from filodb_tpu_torch.testing import fake_s3
os_root = tempfile.mkdtemp()
ocs, _ = objectstore.open_object_store({"endpoint": os_root}, os_root)
ost = MemStore(2, spread=1, column_store=ocs, meta_store=InMemoryMetaStore())
ost.ingest_series([{**lb, "_metric_": "load"} for lb in labels],
                  np.tile(ts2, (n, 1)),
                  np.round(rng.normal(5, 1, (n, T2)) * 64) / 64,
                  schema="gauge")
ost.flush_all(1_000)
ocs.flush()
osvc = QueryService(ost, device="cpu", engine="exec")
osvc.planner = build_tiered_planner(
    SingleClusterPlanner(2, 1), objectstore.ObjectStoreColumnStore(
        fake_s3.FakeS3(root=os_root)), ost.dataset, 2, 1,
    mem_retention_ms=1_800_000, now_ms=lambda: end2)
r = osvc.query_range("max_over_time(load[3h])", end2 // 1000 - 1810, 60,
                     end2 // 1000 - 1810)
os.environ["FILODB_SIDECAR_APPROX"] = "1"
cold = osvc.planner.cold_planner.store
objrows = [sorted(r.stats.tiers), r.result.num_series,
           r.stats.pyramid.get("chunkNodes", 0)
           + r.stats.pyramid.get("segmentNodes", 0) > 0,
           len(cold.approx_topk(3)), round(cold.approx_cardinality()),
           objectstore.crc32c(b"123456789")]
del os.environ["FILODB_SIDECAR_APPROX"]
ocs.close()
# standing queries: a recording rule and an alert over the store, the
# self-monitor's registry into a store of its own, remote read, repair
from filodb_tpu_torch.core.store.api import InMemoryColumnStore
from filodb_tpu_torch.core.store import repair
from filodb_tpu_torch.http import remote_read
from filodb_tpu_torch.rules import (AlertingRule, MemstoreSink, RecordingRule,
                                    RuleGroup, RuleManager, notify)
from filodb_tpu_torch.utils import racecheck, selfmon
group = RuleGroup("g", 60_000, "timeseries", (
    RecordingRule("ns:rate", "sum(rate(http_requests_total[5m])) by (_ns_)"),
    AlertingRule("Busy", "sum(rate(http_requests_total[5m])) > 0")))
mgr = RuleManager(svc, MemstoreSink(store, "timeseries", 4, 1), [group],
                  ooo_allowance_ms=0)
evaluated = mgr.tick()
meta_store = MemStore(1, 0)
mon = selfmon.MetaMonitor(MemstoreSink(meta_store, "_meta", 1, 0))
cpy = InMemoryColumnStore()
disk2 = open_local(tempfile.mkdtemp(), num_shards=4, spread=1)
disk2.ingest_series(labels, ts, vals)
disk2.flush_all(1_000)
read = remote_read.read_series(store, {
    "start_ms": 0, "end_ms": 2**62,
    "filters": parse_query("http_requests_total", TimeStepParams(0, 0, 0))
    .raw.filters})
standing = [evaluated, len(mgr.alerts_snapshot()), mon.tick() > 0,
            meta_store.shards[0].num_partitions > 0, len(read),
            len(remote_read.encode_read_response([read])) > 0,
            repair.PartitionKeysCopier(disk2.column_store, cpy, "timeseries",
                                       4, n_splits=2).run(),
            repair.ChunkCopier(disk2.column_store, cpy, "timeseries", 4,
                               n_splits=2).run(0, 2**62)["partitions"]]
disk2.close()

import os
from filodb_tpu_torch.coordinator.mesh_cluster import (
    _M_PROC_DISPATCH, MeshClusterRuntime)
from filodb_tpu_torch.parallel.multiproc import (
    MeshWorker, MeshWorkerSupervisor, _ShardSliceStore)
from filodb_tpu_torch.testing import mesh_store
mq = "sum(rate(http_requests_total[5m])) by (_ns_)"
ws = [MeshWorker(_ShardSliceStore(store, "timeseries", lo, lo + 2),
                 "timeseries", (lo, lo + 2), device="cpu").start()
      for lo in (0, 2)]
rt = MeshClusterRuntime(store, "timeseries", 4, [
    ("127.0.0.1", w.port, w.shard_range) for w in ws], device="cpu")
routed = QueryService(store, device="cpu")
routed.mesh_cluster = rt
ok0 = _M_PROC_DISPATCH["ok"].value
a = routed.query_range(mq, 1_600_000_600, 60, 1_600_001_400)
b = svc.query_range(mq, 1_600_000_600, 60, 1_600_001_400)
in_thread = [a.stats.engine, a.result.values.tobytes()
             == b.result.values.tobytes(), _M_PROC_DISPATCH["ok"].value - ok0]
rt.shutdown()
for w in ws:
    w.stop()
guard = tempfile.mkdtemp()
with open(f"{guard}/mesh_guard.py", "w") as f:
    f.write(
        "import sys\n"
        "def build():\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "           ('jax', 'filodb_tpu')]\n"
        "    if bad:\n"
        "        raise SystemExit(f'mesh worker loaded {bad}')\n"
        "    sys.modules['jax'] = None\n"
        "    sys.modules['filodb_tpu'] = None\n"
        "    from filodb_tpu_torch.testing import mesh_store\n"
        "    return mesh_store.build_store()\n")
mstore = mesh_store.build_store()
sup = MeshWorkerSupervisor("timeseries", 4, 1, seed="mesh_guard:build",
                           device="cpu", env={"PYTHONPATH": os.pathsep.join(
                               [guard, os.getcwd()])}).spawn()
try:
    sup.wait_ready(timeout_s=120)
    prt = MeshClusterRuntime(mstore, "timeseries", 4, sup.slices,
                             device="cpu")
    mplan = parse_query("sum(rate(http_requests_total[10m])) by (job)",
                        TimeStepParams(1_600_000_600, 60, 1_600_001_500))
    got = prt.execute_plan(mplan)
    want = QueryService(mstore, device="cpu").execute_logical(mplan)
    spawned = [got is not None and got.materialize().values.tobytes()
               == want.result.values.tobytes(), sup.alive(),
               prt.status()["workers"][0]["device"]]
    prt.shutdown()
finally:
    sup.stop()

loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith("jax.")
                     or m == "filodb_tpu" or m.startswith("filodb_tpu.")))
print(json.dumps({"series": len(body["data"]["result"]),
                  "joined": joined.result.num_series,
                  "buckets": len(flat["data"]["result"]),
                  "quantiles": quant.result.num_series, "shapes": shapes,
                  "instant": len(inst["data"]["result"]),
                  "scalar": scal["data"]["result"], "meta": meta,
                  "exec": exec_rows, "durable": durable, "node": node,
                  "memory": memory, "control": control,
                  "adaptive": adaptive_rows, "core": core,
                  "longterm": longterm, "objectstore": objrows,
                  "standing": standing, "multiproc": [in_thread, spawned],
                  "host": [host.stats.host_lane, host.result.num_series],
                  "mean": [mean.stats.engine, mean.result.num_series,
                           float(np.nanmax(mean.result.values))],
                  "loaded": loaded}))
"""


def test_port_loads_no_jax_and_no_reference_module():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["series"] == 2
    assert res["joined"] > 0
    assert res["buckets"] == 2 * 3
    assert res["quantiles"] == 3
    assert res["shapes"] == {
        'absent(nope{job="x"})': 1,
        'count_values("v", http_requests_total % 3)': 3,
        "sort_desc(rate(http_requests_total[5m]))": 12,
        'label_replace(http_requests_total, "j", "$1", "job", "job-(.*)")':
            12,
        "limit(2, http_requests_total)": 2,
        "http_requests_total * time()": 12,
        "scalar(sum(rate(http_requests_total[5m])))": 1,
        "vector(1) + 1": 1,
        "sum(rate(http_requests_total[5m] @ 1600001000)) by (_ns_)": 2,
        "max_over_time(sum(rate(http_requests_total[5m])) by (_ns_)"
        "[10m:1m])": 2}
    assert res["instant"] == 2
    assert res["scalar"] == [1_600_001_400.0, "1600001400.0"]
    assert res["meta"] == {
        "names": ["_metric_", "_ns_", "_ws_", "instance", "job"],
        "jobs": ["job-0", "job-1", "job-2"], "series": 6}
    assert res["exec"] == 2
    assert res["mean"] == ["exec", 2, 0.25]
    assert res["host"] == [1, 2]  # one host-decode lane batch, mesh
    assert res["durable"] == {"keys": 12, "records": 12, "skipped": 0,
                              "rows": 2, "paged": 12}
    assert res["node"] == {"statuses": ["active", "active"], "rows": 30,
                           "snapshot": 2}
    assert res["memory"] == {"sidecar": ["exec", 4], "evicted": 3,
                             "purged": 4, "bloom": 3}
    assert res["control"] == [4, 5.0, 2, 1.0, True, 2, True, True, "ok"]
    assert res["adaptive"] == 2
    n = res["core"][1]
    assert res["core"] == [n, n, 0, True, [], True] and n > 0
    tiers = ["downsample", "memstore", "objectstore"]
    assert res["longterm"] == [["exec", tiers, 2], ["exec", tiers, 1], True]
    assert res["objectstore"] == [["objectstore"], 12, True, 3, 12,
                                  0xE3069283]
    # one step of two rules, the alert active, the self-monitor's series,
    # 12 series read back, 12 part keys and the 12 partitions' chunks
    # copied over two splits
    assert res["standing"] == [2, 1, True, True, 12, True, 12, 12]
    # the runtime answered bitwise as the single-process engine, in
    # thread and from a spawned worker that loaded neither package
    assert res["multiproc"] == [["mesh-proc", True, 1],
                                [True, [True], "cpu"]]
    assert res["loaded"] == []
