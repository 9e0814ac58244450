"""The port's node against the JAX package's: configuration, the Influx
parser and gateway, the metrics exposition, the HTTP API of both servers
over the same gateway input, and each server serving a directory the
other wrote.

The port runs on the CPU (``device="cpu"``); the reference server boots
on CPU JAX, as ``tests/test_standalone.py`` boots it. Every server binds
free ports and is shut down by its test, waits carry deadlines. Values
compare within ``tests/test_torch_slice.py``'s tolerance (``rtol=2e-5,
atol=1e-6``); labels, series order, status codes and error envelopes are
compared exactly. ``queryStats`` (wall time, engine counters) is left out
of the comparison.
"""

import dataclasses
import json
import math
import re
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from filodb_tpu import config as ref_config
from filodb_tpu import standalone as ref_standalone
from filodb_tpu.coordinator.ingestion import route_container as ref_route
from filodb_tpu.core.record import RecordContainer as RefContainer
from filodb_tpu.gateway import influx as ref_influx
from filodb_tpu.gateway.server import ContainerSink as RefSink
from filodb_tpu.kafka.log import InMemoryLog as RefMemLog
from filodb_tpu.utils import metrics as ref_metrics
from filodb_tpu_torch import config as port_config
from filodb_tpu_torch.coordinator.ingestion import route_container
from filodb_tpu_torch.core.record import RecordContainer
from filodb_tpu_torch.gateway import influx as port_influx
from filodb_tpu_torch.gateway.server import ContainerSink
from filodb_tpu_torch.kafka.log import InMemoryLog
from filodb_tpu_torch.standalone import FiloServer
from filodb_tpu_torch.testing.from_jax import boot, server_pair
from filodb_tpu_torch.utils import metrics as port_metrics

ROOT = Path(__file__).resolve().parent.parent
REF = (ref_standalone.FiloServer, ref_config.ServerConfig)
DS = "timeseries"
START = 1_600_000_000
N_SAMPLES = 150  # 10 s apart: chunks of 100 seal, buffers hold the rest
TOL = dict(rtol=2e-5, atol=1e-6)
SMALL = {"node_name": "node-0",
         "datasets": {DS: {"num_shards": 2, "spread": 1,
                           "store": {"max_chunk_size": 100,
                                     "groups_per_shard": 2}}}}

# ---- configuration -----------------------------------------------------------

CONFIG_FIELDS = ("node_name", "data_dir", "wal_dir", "wal_fsync", "http_port",
                 "http_reuse_port", "http_impl", "http_response_cache",
                 "gateway_port", "executor_port", "seeds", "enable_failover",
                 "wal_remote", "wal_kafka", "wal_server_port", "consul",
                 "store_remote", "store_server_port", "spreads", "downsample",
                 "engines", "resilience", "result_cache", "governor",
                 "cost_model", "store", "migration", "mesh_workers",
                 "replication", "rules", "tracing", "selfmon", "federation")
STORE_FIELDS = tuple(f.name for f in dataclasses.fields(
    port_config.StoreConfig))


def _config_file(tmp_path) -> str:
    path = tmp_path / "server.json"
    path.write_text(json.dumps({
        "node_name": "n1", "data_dir": str(tmp_path / "d"), "http_port": 0,
        "gateway_port": 0, "wal_fsync": True,
        "datasets": {"prometheus": {
            "num_shards": 8, "spread": 2, "engine": "exec",
            "store": {"max_chunk_size": 120, "groups_per_shard": 3,
                      "flush_interval_ms": 60_000,
                      "index_snapshot_interval_ms": 5_000,
                      "demand_paging_enabled": False}}}}))
    return str(path)


@pytest.mark.parametrize("which", ["conf/server.json", "test file"])
def test_config_loads_the_same_fields(which, tmp_path):
    path = str(ROOT / which) if which != "test file" \
        else _config_file(tmp_path)
    ref = ref_config.ServerConfig.load(path)
    port = port_config.ServerConfig.load(path)
    for name in CONFIG_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert list(port.datasets) == list(ref.datasets)
    for ds, ing in port.datasets.items():
        want = ref.datasets[ds]
        for name in ("dataset", "num_shards", "min_num_nodes",
                     "source_factory", "source_config", "downsample"):
            assert getattr(ing, name) == getattr(want, name), name
        for name in STORE_FIELDS:
            assert getattr(ing.store, name) == getattr(want.store, name), name
    port.check_supported()


UNSUPPORTED = [
    {"seeds": ["127.0.0.1:9999"]},
    {"consul": {"host": "127.0.0.1"}},
    {"enable_failover": True},
    {"migration": {"auto_rebalance": True}},
    {"replication": {"n_replicas": 1}},
    {"wal_remote": "127.0.0.1:9092"},
    {"wal_kafka": "127.0.0.1:9092"},
    {"wal_server_port": 9093},
    {"store_remote": "127.0.0.1:9094"},
    {"store_server_port": 9095},
    {"resilience": {"allow_partial": False}},
    {"mesh_workers": {"enabled": True}, "store": {"backend": "object"}},
]

# blocks the port acts on since its control plane came (and, since long
# retention came, ``downsample`` and ``federation``; since the object
# store came, ``store.backend``; since the standing queries came,
# ``rules.groups`` and ``selfmon.enabled``; since the multi-process mesh
# runtime came, ``mesh_workers`` and the retry and breaker keys of
# ``resilience``); until then ``test_unsupported_options_raise`` held that
# each of them raised
ACTED_ON = [
    {"store": {"backend": "object"}},
    {"datasets": {DS: {"downsample": {"resolutions_ms": [300000]}}}},
    {"federation": {"mem_retention_ms": 60000}},
    {"governor": {"max_samples_scanned": 100}},
    {"governor": {"max_result_bytes": 100}},
    {"governor": {"max_group_cardinality": 100}},
    {"governor": {"tenants": {"demo": {"max_series": 10}}}},
    {"governor": {"admission_capacity": 4}},
    {"resilience": {"query_timeout_s": 5.0}},
    {"cost_model": {"min_samples": 2}},
    {"tracing": {"sample_rate": 1.0}},
    {"rules": {"groups": [{"name": "g", "interval": "60s", "rules": []}]}},
    {"selfmon": {"enabled": True}},
    {"mesh_workers": {"enabled": True}},
    {"resilience": {"retry_max_attempts": 5}},
]


@pytest.mark.parametrize("override", UNSUPPORTED,
                         ids=lambda o: json.dumps(o)[:60])
def test_unsupported_options_raise(override, tmp_path):
    path = tmp_path / "server.json"
    path.write_text(json.dumps(override))
    cfg = port_config.ServerConfig.load(str(path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.check_supported()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FiloServer(cfg, device="cpu")


@pytest.mark.parametrize("override", ACTED_ON,
                         ids=lambda o: json.dumps(o)[:60])
def test_control_plane_blocks_are_acted_on(override, tmp_path):
    """A node applies the governor, resilience, cost-model and tracing
    blocks to the port's process-wide modules, as the reference's node
    applies them."""
    from filodb_tpu_torch.query import cost_model
    from filodb_tpu_torch.utils import governor, resilience, tracing

    path = tmp_path / "server.json"
    path.write_text(json.dumps({**SMALL, **override,
                                "data_dir": str(tmp_path / "d"),
                                "http_port": 0}))
    cfg = port_config.ServerConfig.load(str(path))
    cfg.check_supported()
    srv = FiloServer(cfg, device="cpu").start()
    try:
        (block, kv), = override.items()
        (key, value), = kv.items()
        if block == "store":
            from filodb_tpu_torch.core.store.objectstore import (
                ObjectStoreColumnStore,
            )
            assert isinstance(srv.column_store, ObjectStoreColumnStore)
            return
        if block == "rules":
            # one rule manager over the first dataset's groups
            assert [g.name for g in srv.rule_managers[DS].groups] == ["g"]
            return
        if block == "mesh_workers":
            # two worker processes on the node's device, the runtime on
            # the dataset's service
            from filodb_tpu_torch.coordinator.mesh_cluster import (
                MeshClusterRuntime,
            )
            rt = srv.services[DS].mesh_cluster
            assert isinstance(rt, MeshClusterRuntime)
            assert srv.mesh_supervisor.alive() == [True, True]
            assert [w["reachable"] for w in rt.status()["workers"]] == \
                [True, True]
            return
        if block == "selfmon":
            # the _meta dataset after the user's, its sampler and the
            # default alert group over it
            assert list(srv.services)[-1] == "_meta"
            assert srv.selfmon is not None
            assert [g.name for g in srv.rule_managers["_meta"].groups] \
                == ["selfmon_default"]
            return
        if block in ("datasets", "federation"):
            # the long-time planner over the raw one, or the tiered one
            from filodb_tpu_torch.coordinator.longtime_planner import (
                LongTimeRangePlanner,
            )
            from filodb_tpu_torch.coordinator.tiered_planner import (
                TieredPlanner,
            )
            want = LongTimeRangePlanner if block == "datasets" \
                else TieredPlanner
            assert isinstance(srv.services[DS].planner, want)
            return
        got = {"governor": lambda: getattr(governor.config(), key),
               "resilience": lambda: getattr(resilience.config(), key),
               "tracing": lambda: getattr(tracing.config(), key),
               "cost_model": lambda: getattr(cost_model.model_for(DS),
                                             key)}[block]()
        assert got == value
        assert srv.watchdog is not None
    finally:
        srv.shutdown()
        governor.reset()
        resilience.reset()
        tracing.configure()
        cost_model.reset_models()
    assert governor.governor().state == governor.OK


@pytest.mark.parametrize("override", [{"result_cache": {"enabled": False}},
                                      {"http_response_cache": False}],
                         ids=lambda o: json.dumps(o)[:60])
def test_cache_switches_are_acted_on(override, tmp_path):
    """The two serving caches are on at their defaults, as the reference's
    node has them, and each block turns its own off: the extent cache of
    every dataset's service, the response cache of the front."""
    path = tmp_path / "server.json"
    path.write_text(json.dumps({**SMALL, **override,
                                "data_dir": str(tmp_path / "d"),
                                "http_port": 0}))
    cfg = port_config.ServerConfig.load(str(path))
    cfg.check_supported()
    ref = ref_config.ServerConfig.load(str(path))
    assert (cfg.result_cache, cfg.http_response_cache) == \
        (ref.result_cache, ref.http_response_cache)
    srv = FiloServer(cfg, device="cpu").start()
    try:
        result_cache = "result_cache" not in override
        assert (srv.services[DS].result_cache is not None) == result_cache
        assert (srv.http.response_cache is not None) == \
            ("http_response_cache" not in override)
    finally:
        srv.shutdown()
    default = port_config.ServerConfig.load(None)
    default.data_dir, default.http_port = str(tmp_path / "d0"), 0
    srv = FiloServer(default, device="cpu").start()
    try:
        rc = srv.services[DS].result_cache
        assert rc is not None and rc.config.extent_steps == 32
        assert srv.http.response_cache is not None
    finally:
        srv.shutdown()


def _store_with(field: str, value, tmp_path):
    """A one-shard store under the dataset config a server.json setting
    ``field`` loads, with 8 gauges of 200 samples at 10 s from t = 0
    ingested and flushed."""
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.core.partkey import PartKey

    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "server.json"
    path.write_text(json.dumps({"datasets": {DS: {"store": {
        field: value, "max_chunk_size": 50}}}}))
    cfg = port_config.ServerConfig.load(str(path))
    cfg.check_supported()
    FiloServer(cfg, device="cpu")  # boots with it
    store = cfg.datasets[DS].store
    assert getattr(store, field) == value
    ms = MemStore(1, 0, config=store)
    keys = [PartKey.create("gauge", {"_metric_": "g", "host": f"h{i}"})
            for i in range(8)]
    ts = np.tile(np.arange(200, dtype=np.int64) * 10_000, (8, 1))
    ms.shards[0].ingest_series(keys, ts, np.ones((8, 200)),
                               np.full(8, 200))
    ms.shards[0].flush_all()
    return ms.shards[0]


def test_retention_ms_is_accepted_and_purges(tmp_path):
    shard = _store_with("retention_ms", 1000, tmp_path)
    assert shard.purge_expired(now_ms=1_990_000 + 1000) == 0
    assert shard.purge_expired(now_ms=1_990_000 + 1001) == 8


def test_shard_mem_mb_is_accepted_and_bounds_the_chunks(tmp_path):
    shard = _store_with("shard_mem_mb", 0, tmp_path)
    assert shard.chunk_bytes() > 0
    assert shard.enforce_memory() == 32  # every flushed chunk
    assert shard.chunk_bytes() == 0


def test_the_bloom_capacity_is_accepted_and_sizes_the_filter(tmp_path):
    from filodb_tpu_torch.utils.bloom import BloomFilter

    shard = _store_with("evicted_pk_bloom_filter_capacity", 9, tmp_path)
    assert shard.evicted_keys.state() == BloomFilter(9).state()
    assert shard.evict_cold_partitions(8) == 8
    assert shard.evicted_keys.count == 8


def test_disk_ttl_ms_is_accepted_and_changes_nothing(tmp_path):
    """The reference reads ``disk_ttl_ms`` only in its config dataclass:
    a tick does the same with it as without."""
    from filodb_tpu_torch.coordinator.cluster import shard_tick

    ttl = _store_with("disk_ttl_ms", 1000, tmp_path / "a")
    default = _store_with("max_chunk_size", 50, tmp_path / "b")
    for shard in (ttl, default):
        assert shard_tick(shard, now_ms=2_000_000) == {
            "flushed": 0, "evicted": 0, "purged": 0}
        assert shard.chunk_bytes() == default.chunk_bytes()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_server_needs_the_card_unless_cpu_is_asked(tmp_path):
    cfg = port_config.ServerConfig.load(None)
    cfg.data_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FiloServer(cfg)


# ---- Influx lines ------------------------------------------------------------

def _records(recs):
    out = []
    for r in recs:
        vals = []
        for v in r.values:
            if isinstance(v, tuple):
                vals.append((np.asarray(v[0]).tolist(),
                             np.asarray(v[1]).tolist()))
            else:
                vals.append("NaN" if math.isnan(v) else v)
        out.append((r.part_key.schema, r.part_key.labels, r.timestamp,
                    tuple(vals)))
    return out


def _parse_both(line, defaults=None):
    got = want = None
    try:
        want = ("ok", _records(ref_influx.parse_influx_line(
            line, defaults, now_ms=123)))
    except ValueError as e:
        want = ("error", type(e).__name__, str(e))
    try:
        got = ("ok", _records(port_influx.parse_influx_line(
            line, defaults, now_ms=123)))
    except ValueError as e:
        got = ("error", type(e).__name__, str(e))
    return got, want


LINES = [
    "cpu,host=h1,_ws_=demo,_ns_=App-0 value=1.5 1600000000000000000",
    "reqs,host=h1 counter=7i 1600000000000000000",
    "disk,host=h1 used=3,free=4u 1600000000000000000",
    "flag,host=h1 value=t 1600000000000000000",
    "flag2,host=h1 value=False",
    'weird\\ name,ho\\,st=a\\=b value=2 1600000000000000000',
    'msg,host=a text="hello world",value=3 1600000000000000000',
    'only_str,host=a text="x y"',
    "lat,host=h1 0.1=1,0.5=3,+Inf=5,sum=2.5,count=5 1600000000000000000",
    "lat2,host=h1 1=1,2=2,+Inf=3,count=3 1600000000000000000",
    "# a comment",
    "",
    "nofields",
    "bad,tag value=1",
    "badfield,host=a value 1",
    "badnum,host=a value=abc 1",
    "badts,host=a value=1 notanumber",
]


@pytest.mark.parametrize("line", LINES)
def test_influx_lines_parse_as_the_reference_does(line):
    got, want = _parse_both(line, {"_ws_": "default", "_ns_": "default"})
    assert got == want


_TOKEN = st.text(st.sampled_from(list("ab=, \\\"xy1.+")), min_size=1,
                 max_size=6)
_FIELD_VALUE = st.one_of(
    st.integers(-10**6, 10**6).map(str),
    st.integers(0, 10**6).map(lambda i: f"{i}i"),
    st.floats(allow_nan=False, allow_infinity=False, width=32).map(repr),
    st.sampled_from(["t", "F", "true", '"s"', "1e3", "+Inf", "nan"]))


@settings(max_examples=300, deadline=None)
@given(meas=_TOKEN, tags=st.lists(st.tuples(_TOKEN, _TOKEN), max_size=3),
       fields=st.lists(st.tuples(st.one_of(
           _TOKEN, st.sampled_from(["value", "counter", "sum", "count",
                                    "0.5", "+Inf", "1"])), _FIELD_VALUE),
           min_size=1, max_size=4),
       ts=st.one_of(st.none(), st.integers(0, 2 * 10**18).map(str)))
def test_influx_parser_matches_the_reference_on_escapes_and_fields(
        meas, tags, fields, ts):
    line = ",".join([meas] + [f"{k}={v}" for k, v in tags]) + " " + \
        ",".join(f"{k}={v}" for k, v in fields) + ("" if ts is None
                                                   else f" {ts}")
    got, want = _parse_both(line)
    assert got == want


# ---- routing and the gateway -------------------------------------------------

def _gateway_lines(n_series=24, n_samples=N_SAMPLES, start=START,
                   seed=0) -> list[str]:
    """Counters, gauges and histograms in three namespaces (so both shard
    groups hold data), ``n_samples`` scrapes 10 s apart."""
    rng = np.random.default_rng(seed)
    reqs = np.cumsum(rng.integers(0, 20, (n_series, n_samples)), axis=1)
    cpu = 50 + np.round(rng.normal(0, 5, (n_series, n_samples)), 3)
    obs = np.cumsum(rng.integers(0, 4, (n_series // 4, n_samples, 3)),
                    axis=1)
    lines = []
    for t in range(n_samples):
        ns = (start + 10 * t) * 10**9 + 1_000_000 * (t % 7)
        for i in range(n_series):
            tags = f"_ws_=demo,_ns_=App-{i % 3},instance=i-{i},job=job-{i % 4}"
            lines.append(f"reqs_total,{tags} counter={reqs[i, t]} {ns}")
            lines.append(f"cpu,{tags} value={cpu[i, t]} {ns}")
        for i in range(n_series // 4):
            b = np.cumsum(obs[i, t])
            lines.append(f"lat,_ws_=demo,_ns_=App-{i % 3},instance=i-{i} "
                         f"0.1={b[0]},1={b[1]},+Inf={b[2]},"
                         f"sum={0.3 * b[2]},count={b[2]} {ns}")
    return lines


def test_route_container_matches_the_reference():
    lines = _gateway_lines(n_series=40, n_samples=2)
    for num_shards, spread in ((2, 1), (8, 2), (4, 0)):
        want = ref_route(_container(RefContainer, ref_influx, lines),
                         num_shards, spread)
        got = route_container(_container(RecordContainer, port_influx,
                                         lines), num_shards, spread)
        assert list(got) == list(want)
        for s in want:
            assert got[s].serialize() == want[s].serialize()


def _container(cls, influx, lines):
    c = cls()
    for ln in lines:
        for r in influx.parse_influx_line(ln, {"_ws_": "default",
                                               "_ns_": "default"}):
            c.add(r)
    return c


def _sink_containers(sink_cls, log_cls, influx, lines, num_shards=4,
                     spread=1):
    logs = {s: log_cls() for s in range(num_shards)}
    sink = sink_cls(logs, num_shards, spread, flush_every=64,
                    max_pending=256)
    defaults = {"_ws_": "default", "_ns_": "default"}
    for ln in lines:
        recs = influx.parse_influx_line(ln, defaults, now_ms=0)
        if recs:
            sink.add(recs)
    sink.flush()
    return {s: [sd.container.serialize() for sd in lg.read_from(0)]
            for s, lg in logs.items()}


def test_gateway_containers_are_byte_equal_shard_by_shard():
    lines = _gateway_lines(n_series=16, n_samples=12)
    want = _sink_containers(RefSink, RefMemLog, ref_influx, lines)
    got = _sink_containers(ContainerSink, InMemoryLog, port_influx, lines)
    assert sum(len(v) for v in got.values()) > 4
    assert got == want


def test_metrics_exposition_matches_the_reference():
    tag = f"t{time.monotonic_ns()}"

    def families(mod):
        c = mod.Counter(f"{tag}_lines", {"shard": "1", "ds": 'a"b'})
        c.inc(3)
        g = mod.Gauge(f"{tag}_depth", help="queue depth")
        g.set(2.5)
        mod.GaugeFn(f"{tag}_lag", lambda: 7, {"shard": "0"})
        mod.GaugeFn(f"{tag}_gone", lambda: None)
        h = mod.Histogram(f"{tag}_seconds", {"shard": "0"})
        for v in (0.003, 0.2, 7.0, 30.0):
            h.observe(v)
        return [ln for ln in mod.render_prometheus().splitlines()
                if tag in ln]

    got, want = families(port_metrics), families(ref_metrics)
    assert got == want and len(got) > 20


# ---- the HTTP API ------------------------------------------------------------

def _get(port, path, **q):
    url = f"http://127.0.0.1:{port}{path}"
    if q:
        url += "?" + urllib.parse.urlencode(q, doseq=True)
    return _open(urllib.request.Request(url))


def _post(port, path, **form):
    data = urllib.parse.urlencode(form).encode()
    return _open(urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/x-www-form-urlencoded"}))


def _open(req):
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _send(srv, lines):
    with socket.create_connection(("127.0.0.1", srv.gateway.port)) as s:
        s.sendall(("\n".join(lines) + "\n").encode())


def _drained(srv) -> bool:
    workers = list(srv.node._workers.values())
    return bool(workers) and all(w.offset >= w.log.latest_offset
                                 for w in workers)


def _wait_ingested(servers, n_samples, timeout=60.0, sel="reqs_total"):
    """Wait (with a deadline) until every server's workers reached the end
    of its logs and its store counts ``n_samples`` samples of ``sel``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for srv in servers:
            srv.gateway.sink.flush()
        if all(_drained(srv) and _count_samples(srv, sel) == n_samples
               for srv in servers):
            return
        time.sleep(0.2)
    raise AssertionError("the servers did not ingest the lines in time")


def _count_samples(srv, sel: str) -> float:
    code, body = _get(srv.http.port, f"/promql/{DS}/api/v1/query",
                      query=f"sum(count_over_time({sel}[1d]))",
                      time=START + 10 * N_SAMPLES)
    res = json.loads(body)["data"]["result"] if code == 200 else []
    return float(res[0]["value"][1]) if res else 0.0


def _assert_same(got: bytes, want: bytes, what: str) -> None:
    g, w = json.loads(got), json.loads(want)
    g.pop("queryStats", None)
    w.pop("queryStats", None)
    _close(g, w, what)


def _close(g, w, what):
    if isinstance(w, dict):
        assert isinstance(g, dict) and list(g) == list(w), what
        for k in w:
            _close(g[k], w[k], f"{what}.{k}")
    elif isinstance(w, list):
        assert isinstance(g, list) and len(g) == len(w), what
        for i, (a, b) in enumerate(zip(g, w)):
            _close(a, b, f"{what}[{i}]")
    elif isinstance(w, str) and isinstance(g, str) and _is_num(w) \
            and _is_num(g):
        a, b = float(g), float(w)
        assert (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=TOL["rtol"], abs_tol=TOL["atol"]), (what, g, w)
    elif isinstance(w, float):
        assert math.isclose(g, w, rel_tol=1e-12), (what, g, w)
    else:
        assert g == w, (what, g, w)


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


RANGE_QUERIES = (
    "sum(rate(reqs_total[5m])) by (_ns_)",
    "count_over_time(reqs_total[5m])",
    "sum(count_over_time(cpu[5m])) by (job)",
    "avg(cpu) by (_ns_)",
    'max_over_time(cpu{_ns_="App-1"}[2m])',
    "sum(rate(lat[5m])) by (_ns_)",
    "histogram_quantile(0.9, sum(rate(lat[5m])) by (_ns_))",
    "sum(lat::sum) by (_ns_)",
)
INSTANT_QUERIES = ("sum(cpu) by (job)", "rate(reqs_total[5m])",
                   'lat{_ns_="App-0"}', "time()")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    lines = _gateway_lines()
    with server_pair(SMALL, str(tmp_path_factory.mktemp("pair")),
                     REF) as (ref, port):
        for srv in (ref, port):
            _send(srv, lines)
        _wait_ingested((ref, port), 24 * N_SAMPLES)
        yield ref, port


@pytest.mark.parametrize("query", RANGE_QUERIES)
def test_query_range_answers_as_the_reference(pair, query):
    ref, port = pair
    q = dict(query=query, start=START + 300, end=START + 10 * N_SAMPLES,
             step=60)
    (gc, gb), (wc, wb) = (_get(s.http.port, f"/promql/{DS}/api/v1/"
                               "query_range", **q) for s in (port, ref))
    assert gc == wc == 200
    assert json.loads(wb)["data"]["result"], query
    _assert_same(gb, wb, query)


@pytest.mark.parametrize("query", INSTANT_QUERIES)
@pytest.mark.parametrize("method", ["GET", "POST"])
def test_instant_query_answers_as_the_reference(pair, query, method):
    ref, port = pair
    q = dict(query=query, time=START + 10 * N_SAMPLES - 25)
    call = _get if method == "GET" else _post
    (gc, gb), (wc, wb) = (call(s.http.port, f"/promql/{DS}/api/v1/query",
                               **q) for s in (port, ref))
    assert gc == wc == 200
    _assert_same(gb, wb, query)


@pytest.mark.parametrize("path,params", [
    ("series", {"match[]": ['reqs_total{_ns_="App-0"}', "lat"],
                "start": START, "end": START + 3600}),
    ("series", {"match[]": ['cpu{job="job-1"}']}),
    ("labels", {}),
    ("label/_ns_/values", {}),
    ("label/__name__/values", {}),
    ("label/nope/values", {}),
])
def test_metadata_answers_as_the_reference(pair, path, params):
    ref, port = pair
    (gc, gb), (wc, wb) = (_get(s.http.port, f"/promql/{DS}/api/v1/{path}",
                               **params) for s in (port, ref))
    assert gc == wc == 200
    assert json.loads(gb) == json.loads(wb)


@pytest.mark.parametrize("path,params,code", [
    (f"/promql/{DS}/api/v1/query_range",
     {"query": "sum(rate(reqs_total[5m])", "start": START, "end": START + 60,
      "step": 60}, 400),
    (f"/promql/{DS}/api/v1/query", {"query": "foo{", "time": START}, 400),
    (f"/promql/{DS}/api/v1/query_range",
     {"query": "reqs_total", "start": "soon", "end": START}, 400),
    ("/promql/nope/api/v1/query", {"query": "cpu", "time": START}, 404),
    (f"/promql/{DS}/api/v1/nope", {}, 404),
    ("/nope", {}, 404),
    ("/api/v1/cluster/x/nope", {}, 404),
])
def test_error_envelopes_match_the_reference(pair, path, params, code):
    ref, port = pair
    (gc, gb), (wc, wb) = (_get(s.http.port, path, **params)
                          for s in (port, ref))
    assert gc == wc == code
    assert json.loads(gb) == json.loads(wb)


@pytest.mark.parametrize("path", ["/__health", f"/api/v1/cluster/{DS}/status",
                                  "/api/v1/cluster"])
def test_admin_routes_answer_as_the_reference(pair, path):
    ref, port = pair
    (gc, gb), (wc, wb) = (_get(s.http.port, path) for s in (port, ref))
    assert gc == wc == 200
    assert json.loads(gb) == json.loads(wb)


def test_metrics_route_exposes_the_node_families(pair):
    _, port = pair
    code, body = _get(port.http.port, "/metrics")
    text = body.decode()
    assert code == 200
    for fam in ("gateway_lines_parsed_total", "memstore_rows_ingested_total",
                "filodb_ingest_offset_lag", "chunk_flush_task_latency_seconds",
                "memstore_total_shard_recovery_time_ms"):
        assert f"# TYPE {fam} " in text, fam


def test_query_limit_answers_422_as_the_reference(tmp_path):
    conf = {"datasets": {DS: {"num_shards": 2, "spread": 1, "engine": "exec",
                              "store": {"max_chunk_size": 100,
                                        "groups_per_shard": 2,
                                        "max_query_matches": 3}}}}
    lines = _gateway_lines(n_series=12, n_samples=3)
    with server_pair(conf, str(tmp_path), REF) as (ref, port):
        for srv in (ref, port):
            _send(srv, lines)
        _wait_ingested((ref, port), 3, sel='reqs_total{instance="i-0"}')
        q = dict(query="sum(cpu)", time=START + 20)
        (gc, gb), (wc, wb) = (_get(s.http.port, f"/promql/{DS}/api/v1/query",
                                   **q) for s in (port, ref))
        assert gc == wc == 422
        assert json.loads(gb)["errorType"] == json.loads(wb)["errorType"] \
            == "query_limit"


@pytest.mark.parametrize("impl", ["fast", "threaded"])
def test_both_fronts_serve_pipelined_requests_in_order(tmp_path, impl):
    conf = {**SMALL, "http_impl": impl}
    srv = boot(FiloServer, port_config.ServerConfig, conf, str(tmp_path),
               device="cpu")
    try:
        reqs = [f"GET /__health HTTP/1.1\r\nHost: x\r\n\r\n",
                f"GET /promql/{DS}/api/v1/labels HTTP/1.1\r\nHost: x\r\n\r\n",
                "GET /nope HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"]
        with socket.create_connection(("127.0.0.1", srv.http.port),
                                      timeout=30) as s:
            s.sendall("".join(reqs).encode())
            data = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        codes = [int(c) for c in re.findall(rb"HTTP/1\.1 (\d{3}) ", data)]
        assert codes == [200, 200, 404]
    finally:
        srv.shutdown()


def test_fast_front_refuses_chunked_bodies(tmp_path):
    srv = boot(FiloServer, port_config.ServerConfig, SMALL, str(tmp_path),
               device="cpu")
    try:
        with socket.create_connection(("127.0.0.1", srv.http.port),
                                      timeout=30) as s:
            s.sendall(b"POST /promql/x/api/v1/query HTTP/1.1\r\n"
                      b"Transfer-Encoding: chunked\r\n\r\n")
            assert s.recv(65536).startswith(b"HTTP/1.1 501")
    finally:
        srv.shutdown()


# ---- restart across packages -------------------------------------------------

def _flush_reference(srv):
    for shard in srv.memstore.shards_for(DS):
        shard.flush_all()


def _flush_port(srv):
    srv.node.memstores[DS].flush_all()


@pytest.mark.parametrize("writer,flush", [
    ("reference", False), ("reference", True), ("port", False),
    ("port", True)])
def test_each_server_serves_a_directory_the_other_wrote(tmp_path, writer,
                                                        flush):
    """Mirrors ``tests/test_standalone.py::test_restart_recovers_from_wal``:
    one package's server takes gateway lines (and, with ``flush``, writes
    every group to the column store) and shuts down; the other boots on the
    same directory and answers the same."""
    lines = [f"mem_usage,_ws_=demo,_ns_=App-{i % 2},host=h{i % 3} "
             f"value={i} {(START + i * 10) * 10**9}" for i in range(50)]
    conf = {**SMALL, "node_name": "node-0"}
    data_dir = str(tmp_path / "data")
    first = (REF, {}) if writer == "reference" \
        else ((FiloServer, port_config.ServerConfig), {"device": "cpu"})
    second = ((FiloServer, port_config.ServerConfig), {"device": "cpu"}) \
        if writer == "reference" else (REF, {})
    srv = boot(*first[0], conf, data_dir, **first[1])
    try:
        _send(srv, lines)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            srv.gateway.sink.flush()
            if _drained(srv) and sum(
                    w.log.latest_offset + 1
                    for w in srv.node._workers.values()) > 0:
                break
            time.sleep(0.1)
        if flush:
            (_flush_reference if writer == "reference" else _flush_port)(srv)
        before = _get(srv.http.port, f"/promql/{DS}/api/v1/query_range",
                      query="sum(count_over_time(mem_usage[10m])) by (_ns_)",
                      start=START + 500, end=START + 500, step=60)[1]
    finally:
        srv.shutdown()
    srv2 = boot(*second[0], conf, data_dir, **second[1])
    try:
        deadline = time.monotonic() + 30
        after = None
        while time.monotonic() < deadline:
            code, after = _get(
                srv2.http.port, f"/promql/{DS}/api/v1/query_range",
                query="sum(count_over_time(mem_usage[10m])) by (_ns_)",
                start=START + 500, end=START + 500, step=60)
            res = json.loads(after)["data"]["result"]
            if code == 200 and sum(float(r["values"][0][1])
                                   for r in res) == 50:
                break
            time.sleep(0.1)
        _assert_same(after, before, "after the restart")
        assert sum(float(r["values"][0][1]) for r in
                   json.loads(after)["data"]["result"]) == 50
    finally:
        srv2.shutdown()

