"""The port's command line and client against the reference's.

The cases of ``tests/test_standalone.py::TestCli`` and ``TestTopkCard``
(``importcsv``, ``promql``, ``list``, ``decodechunks``, ``topkcard``),
``tests/test_federation.py``'s ``tiers`` cases, ``tests/test_http.py::
TestFiloClient`` and ``tests/test_full_stack.py`` (the client), on the
port's ``cli.py`` and ``client.py`` with ``--device cpu``. Beside them:

- one CSV imported by each package's CLI into a directory of its own:
  over either directory every embedded command of the port prints what
  the reference's prints, and across the two directories the same lines
  (in the order of each writer's part-key scan); over one directory
  ``promql``'s data is the reference's bitwise, across the two the rows
  agree to 1e-12 (a sum adds its series in each writer's partition
  order);
- every HTTP command of both CLIs against a port node and a reference
  node (federated, over an object store, with a downsample job and the
  slow-query log on) fed the same gateway lines: the same output apart
  from the times in it (the tiers' floors, ``promql``'s ``wallTimeMs``),
  the index's resident bytes (the two packages' indexes are other
  structures), and for ``lag`` only the pair's own rule groups (the
  watermark lags come from each package's process-global registry);
  ``/api/v1/status/tiers`` gives the downsample tier's bytes as the
  reference's (ROADMAP §C.21, closed);
- ``promql --stats`` reports the seconds and the launches, and the
  client reads either package's node alike;
- ROADMAP §C.20, closed: over a federated node, a rule with an
  operator between a vector and a per-step scalar evaluates in both
  packages and writes the same series; §C.22, closed: a query range
  from the lines' time to now at a step of 30 days answers what the
  reference answers.

Every test runs under a time limit of its own, every wait has a
deadline.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import signal
import socket
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from filodb_tpu import config as ref_config
from filodb_tpu import standalone as ref_standalone
from filodb_tpu.cli import main as ref_main
from filodb_tpu.client import FiloClient as RefClient
from filodb_tpu.utils import tracing as ref_tracing
from filodb_tpu_torch.cli import main as port_main
from filodb_tpu_torch.client import FiloClient, FiloClientError
from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.coordinator.ingestion import ingest_routed
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.http.fastserver import FastHttpServer
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.standalone import FiloServer
from filodb_tpu_torch.testing.data import counter_series, counter_stream
from filodb_tpu_torch.testing.from_jax import free_port, server_pair
from filodb_tpu_torch.utils import tracing as port_tracing

START = 1_600_000_000
LIMIT_S = 240
REF = (ref_standalone.FiloServer, ref_config.ServerConfig)


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(*_):
        raise TimeoutError(f"over the test's {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def run(main, argv: list[str]) -> tuple[int, str]:
    """(exit code, standard output) of one CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc or 0, buf.getvalue()


def port_cli(argv: list[str]) -> tuple[int, str]:
    return run(port_main, ["--device", "cpu", *argv])


def _deadline(pred, timeout_s: float, what: str):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"{what} within {timeout_s} s")


# --------------------------------------------------------------------------
# embedded mode

class TestCli:
    def test_importcsv_and_promql(self, tmp_path):
        csv_path = tmp_path / "data.csv"
        csv_path.write_text("\n".join(
            f"{(START + i * 10) * 1000},{i * 1.5},host=h1,_ws_=demo,"
            f"_ns_=App-0" for i in range(100)))
        data_dir = str(tmp_path / "clidata")
        rc, out = port_cli(["--data-dir", data_dir, "--num-shards", "2",
                            "importcsv", str(csv_path), "--metric",
                            "cli_metric"])
        assert rc == 0 and "imported 100 samples" in out
        rc, out = port_cli(["--data-dir", data_dir, "--num-shards", "2",
                            "promql", "max_over_time(cli_metric[20m])",
                            "--start", str(START + 990),
                            "--end", str(START + 990)])
        body = json.loads(out)
        assert body["data"]["result"]
        assert float(body["data"]["result"][0]["values"][0][1]) == 99 * 1.5
        rc, out = port_cli(["--data-dir", data_dir, "--num-shards", "2",
                            "list"])
        assert "total partitions: 1" in out
        rc, out = port_cli(["--data-dir", data_dir, "--num-shards", "2",
                            "decodechunks", "--verbose"])
        assert "chunks" in out

    def test_topkcard(self, tmp_path):
        csv_path = tmp_path / "d.csv"
        csv_path.write_text("\n".join(
            f"{(START + i * 10) * 1000},{i},host=h{i % 3},_ws_=demo,"
            f"_ns_=App-0" for i in range(30)))
        data_dir = str(tmp_path / "cd")
        port_cli(["--data-dir", data_dir, "--num-shards", "2", "importcsv",
                  str(csv_path), "--metric", "card_metric"])
        rc, out = port_cli(["--data-dir", data_dir, "--num-shards", "2",
                            "topkcard", "--prefix", "demo"])
        assert "App-0" in out and "series=3" in out

    def test_promql_stats_on_stderr(self, tmp_path, capsys):
        csv_path = tmp_path / "s.csv"
        csv_path.write_text("\n".join(
            f"{(START + i * 10) * 1000},{i},host=h{i % 2},_ws_=demo,"
            f"_ns_=App-0" for i in range(60)))
        data_dir = str(tmp_path / "st")
        port_cli(["--data-dir", data_dir, "importcsv", str(csv_path),
                  "--metric", "m"])
        capsys.readouterr()
        assert port_main(["--device", "cpu", "--data-dir", data_dir,
                          "promql", "sum(rate(m[5m]))", "--start",
                          str(START + 300), "--end", str(START + 590),
                          "--stats"]) is None
        out, err = capsys.readouterr()
        assert json.loads(out)["data"]["result"]
        stats = json.loads(err.strip().splitlines()[-1])
        assert set(stats) == {"index_recovery_s", "page_in_s", "answer_s",
                              "launches"}
        assert stats["index_recovery_s"] >= 0 and stats["answer_s"] > 0
        # the plain versions on the CPU count no launches
        assert set(stats["launches"].values()) == {0}


CSV_ROWS = 600


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """One CSV of gauges in two namespaces, imported by each package's CLI
    into a directory of its own: {"ref": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("csv")
    path = root / "rows.csv"
    rng = np.random.default_rng(7)
    rows = [f"# {CSV_ROWS} rows"]
    for i in range(CSV_ROWS):
        rows.append(f"{(START + (i // 6) * 10) * 1000},"
                    f"{float(rng.normal(40, 5))!r},host=h{i % 3},"
                    f"_ws_=demo,_ns_=App-{i % 2}")
    path.write_text("\n".join(rows) + "\n")
    dirs = {}
    for name, call in (("ref", lambda a: run(ref_main, a)),
                       ("port", port_cli)):
        dirs[name] = str(root / name)
        rc, out = call(["--data-dir", dirs[name], "importcsv", str(path),
                        "--metric", "csv_metric"])
        assert rc == 0 and f"imported {CSV_ROWS} samples" in out
    return dirs


def _hex_key() -> str:
    from filodb_tpu_torch.core.partkey import PartKey

    return PartKey.create("gauge", {
        "_metric_": "csv_metric", "_ws_": "demo", "_ns_": "App-1",
        "host": "h1"}).serialized.hex()


EMBEDDED = {
    "list": ["list"],
    "list-limit": ["list", "--limit", "1"],
    "indexnames": ["indexnames"],
    "labelvalues": ["labelvalues", "host"],
    "topkcard": ["topkcard", "--prefix", "demo"],
    "topkcard-ns": ["topkcard", "--prefix", "demo/App-1", "-k", "1"],
    "decodechunks": ["decodechunks", "--verbose", "--filter", "App-1"],
    "validate": ["validate"],
    "promfilter": ["promfilter-to-partkey",
                   'csv_metric{_ws_="demo",_ns_="App-1",host="h1"}',
                   "--lookup"],
    "promfilter-regex": ["promfilter-to-partkey", 'csv_metric{host=~"h."}'],
    "partkey-as-string": ["partkey-as-string", _hex_key()],
    "partkey-bad": ["partkey-as-string", "zz"],
}


@pytest.mark.parametrize("name", sorted(EMBEDDED))
def test_embedded_commands_match_the_reference(imported, name):
    argv = EMBEDDED[name]
    outs = {}
    for cli, main in (("ref", lambda a: run(ref_main, a)),
                      ("port", port_cli)):
        for d in ("ref", "port"):
            outs[(cli, d)] = main(["--data-dir", imported[d], *argv])
    want = outs[("ref", "ref")]
    assert want[1] or name.endswith("bad") or name == "promfilter-regex"
    for d in ("ref", "port"):
        # either CLI over one directory: the same output
        assert outs[("port", d)] == outs[("ref", d)], d
    # the two directories hold the same part keys and chunks; a shard's
    # part-key scan order is the writer's (the reference writes a shard's
    # keys group by group, the port in partition order), so across them
    # the lines agree as a multiset
    if name != "list-limit":
        assert sorted(outs[("ref", "port")][1].splitlines()) == \
            sorted(want[1].splitlines())


PROMQL = ("sum(rate(csv_metric[5m])) by (_ns_)",
          "max_over_time(csv_metric[2m])",
          'avg(csv_metric{_ns_="App-1"}) by (host)')


@pytest.mark.parametrize("q", PROMQL)
def test_promql_matches_the_reference(imported, q):
    """Each CLI's ``promql`` over each directory: the same data, bitwise
    (the reference's timing stats aside)."""
    argv = ["promql", q, "--start", str(START + 300), "--end",
            str(START + 990), "--step", "30"]
    datas = {}
    for cli, main in (("ref", lambda a: run(ref_main, a)),
                      ("port", port_cli)):
        for d in ("ref", "port"):
            rc, out = main(["--data-dir", imported[d], *argv])
            assert rc == 0
            datas[(cli, d)] = json.loads(out)["data"]
    assert datas[("ref", "ref")]["result"]
    for d in ("ref", "port"):
        assert datas[("port", d)] == datas[("ref", d)], d
    # across the directories the rows come in each writer's partition
    # order, and a sum adds its series in that order: the same rows, the
    # values to the last bits
    rows = {d: sorted((json.dumps(r["metric"], sort_keys=True), r["values"])
                      for r in datas[("ref", d)]["result"]) for d in imported}
    assert [k for k, _ in rows["ref"]] == [k for k, _ in rows["port"]]
    for (_, a), (_, b) in zip(rows["ref"], rows["port"]):
        assert [t for t, _ in a] == [t for t, _ in b]
        np.testing.assert_allclose([float(v) for _, v in a],
                                   [float(v) for _, v in b], rtol=1e-12)


def test_init_matches_the_reference(tmp_path):
    outs = []
    for name, main in (("ref", lambda a: run(ref_main, a)),
                       ("port", port_cli)):
        outs.append(main(["--data-dir", str(tmp_path / name),
                          "--num-shards", "2", "init"]))
        assert sorted(p.name for p in (tmp_path / name / "columnstore" /
                                       "timeseries").glob("*.db")) == [
            "shard-0.db", "shard-1.db"]
    assert outs[0] == outs[1]


def test_object_store_backend(tmp_path):
    """``--store object`` imports into and reads the object-store tier."""
    path = tmp_path / "o.csv"
    path.write_text("\n".join(
        f"{(START + i * 10) * 1000},{i},host=h{i % 2},_ws_=demo,_ns_=App-0"
        for i in range(40)))
    base = ["--data-dir", str(tmp_path / "d"), "--store", "object",
            "--num-shards", "2"]
    rc, out = port_cli([*base, "importcsv", str(path), "--metric", "om"])
    assert rc == 0 and "imported 40 samples" in out
    got = port_cli([*base, "list"])
    assert "total partitions: 2" in got[1]
    assert got == run(ref_main, [*base, "list"])


# --------------------------------------------------------------------------
# remote mode against nodes

PAIR_CONF = {
    "datasets": {"timeseries": {
        "num_shards": 2, "spread": 1,
        "store": {"flush_interval_ms": 2000, "groups_per_shard": 2,
                  "retention_ms": 2**60},
        "downsample": {"resolutions_ms": [300000], "schedule_s": 3600,
                       "raw_retention_ms": 2**50}}},
    "store": {"backend": "object"},
    "federation": {"mem_retention_ms": 60000},
    "tracing": {"sample_rate": 1.0, "slow_query_threshold_ms": 0.001,
                "slowlog_capacity": 8, "slow_ingest_threshold_ms": 0},
}
# the rule groups the pair's nodes run (none): ``lag`` is compared on them
PAIR_GROUPS = {g["name"] for g in PAIR_CONF.get("rules", {}).get(
    "groups", [])}
PAIR_LINES = "".join(
    f"up,_ws_=w,_ns_=n{i % 2},i=i{i % 3} value={i} "
    f"{(START + 10 * (i // 6)) * 10**9}\n" for i in range(360))
PAIR_QUERY = "sum(rate(up[5m])) by (_ns_)"


def _flushed(srv) -> bool:
    """Every shard of the node ingested its log and flushed every group
    since (the cold tiers serve the lines' old timestamps). Reads no
    query, so no cached answer predates the lines."""
    srv.gateway.sink.flush()
    workers = [(k[1], w) for k, w in list(srv.node._workers.items())
               if k[0] == "timeseries"]
    return len(workers) == 2 and all(
        0 <= w.offset == w.log.latest_offset
        and min(srv.meta_store.read_checkpoints("timeseries", shard)
                .values(), default=-1) >= w.offset
        for shard, w in workers)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A reference node and a port node over the same config, fed the same
    gateway lines and flushed."""
    root = str(tmp_path_factory.mktemp("pair"))
    with server_pair(PAIR_CONF, root, REF) as (ref, port):
        # each package's ingest ring is process-global: what a test before
        # this one recorded in the process is not the pair's
        ref_tracing.ingest_recorder().clear()
        port_tracing.ingest_recorder().clear()
        for srv in (ref, port):
            with socket.create_connection(("127.0.0.1",
                                           srv.gateway.port)) as s:
                s.sendall(PAIR_LINES.encode())
        for srv in (ref, port):
            _deadline(lambda: _flushed(srv), 60,
                      "gateway lines ingested and flushed")
            # the slow-query log and the cost model see one query each
            FiloClient(port=srv.http.port).query_range(
                PAIR_QUERY, START + 300, START + 590, 60)
        yield ref, port


_TIME = re.compile(r"-?\d{12,}")


def _keys(doc, path="") -> set:
    """Every key path of a JSON document (list items share a path)."""
    if isinstance(doc, dict):
        return {path} | set().union(*(_keys(v, f"{path}/{k}")
                                      for k, v in doc.items()))
    if isinstance(doc, list):
        return {path} | set().union(*(_keys(v, f"{path}[]") for v in doc))
    return {path}


def _normal(cmd: str, out: str) -> str:
    """Output with what differs by design masked (see the module)."""
    if cmd in TELEMETRY:
        # each package's engine keeps its own caches, cost sites and stage
        # stats: the table's first line is held, its numbers masked (the
        # JSON forms: ``test_http_telemetry_json_has_the_reference_keys``)
        return re.sub(r"\d+", "#", " ".join(out.splitlines()[0].split()))
    if cmd == "status":
        # the index's resident bytes: SHARD SERIES INDEX_RAM ENC CHUNKS
        out = re.sub(r"^(\s+\d+\s+\d+\s+)\d+(\s)", r"\1#\2", out,
                     flags=re.M)
    if cmd == "shardmap":
        # a shard's watermark is a log offset (as ``lag``'s)
        out = re.sub(r"^(\s+\d+\s+\S+\s+\S+\s+)-?\d+", r"\1#", out,
                     flags=re.M)
    if cmd == "lag":
        # both packages read a rule group's watermark lag from their
        # process-global metrics registry, so a group that another test
        # of the process registered shows on a node that runs no rules:
        # only the pair's own groups are compared
        out = _own_rule_groups(out)
        # wall-clock lags; log offsets count the gateway's containers,
        # whose cut follows its flush timer
        out = re.sub(r"\d+(\.\d+)?", "#", out)
    if cmd == "tiers":
        out = _TIME.sub("#", out)
        # the object store's segments and bytes follow the flush timer
        out = re.sub(r"^(objectstore\s+\d+\s+)\d+(\s+segments=)\d+",
                     r"\1#\2#", out, flags=re.M)
        out = re.sub(r'("bytes": )\d+(,\n\s+"segments": )\d+',
                     r"\1#\2#", out)
        out = re.sub(r" +", " ", out)
    return out


def _own_rule_groups(out: str) -> str:
    """``lag``'s output (text or JSON) without the rule groups that are
    not the pair's nodes' own (``PAIR_GROUPS``)."""
    try:
        doc = json.loads(out)
    except ValueError:
        return "".join(
            line for line in out.splitlines(keepends=True)
            if not (m := re.match(r"rules\[(.*)\]: ", line))
            or m.group(1) in PAIR_GROUPS)
    lags = {g: v for g, v in doc.pop("rulesWatermarkLagSeconds",
                                     {}).items() if g in PAIR_GROUPS}
    if lags:  # a node without rule groups gives no such key
        doc["rulesWatermarkLagSeconds"] = lags
    return json.dumps(doc, indent=2) + "\n"


TELEMETRY = ("meshstat", "coststats", "slowlog")


HTTP = {
    "status": ["status"],
    "status-k": ["status", "-k", "1"],
    "tiers": ["tiers"],
    "tiers-json": ["tiers", "--json"],
    "meshstat": ["meshstat"],
    "lag": ["lag"],
    "lag-json": ["lag", "--json"],
    "shardmap": ["shardmap"],
    "replicacheck": ["replicacheck"],
    "rules": ["rules"],
    "slowlog": ["slowlog"],
    "coststats": ["coststats"],
}


def _host_run(pair, argv) -> dict:
    outs = {}
    for (who, srv), main in zip((("ref", pair[0]), ("port", pair[1])),
                                (ref_main, port_main)):
        rc, out = run(main, ["--host", f"127.0.0.1:{srv.http.port}",
                             "--dataset", "timeseries", *argv])
        assert rc == 0 and out.strip(), who
        outs[who] = out
    return outs


@pytest.mark.parametrize("name", sorted(HTTP))
def test_http_commands_match_the_reference(pair, name):
    argv = HTTP[name]
    outs = _host_run(pair, argv)
    assert _normal(argv[0], outs["port"]) == _normal(argv[0], outs["ref"])


@pytest.mark.parametrize("argv", [["meshstat", "--json"],
                                  ["coststats", "--json"],
                                  ["slowlog", "--json", "--limit", "1"]],
                         ids=lambda a: a[0])
def test_http_telemetry_json_has_the_reference_keys(pair, argv):
    """The engines' telemetry as JSON: every key the reference's node
    gives, the port's gives (a span's tags aside: each engine tags its
    own stages; the port's mesh engine adds its kernel launches)."""
    outs = _host_run(pair, argv)
    want = {k for k in _keys(json.loads(outs["ref"])) if "/tags/" not in k}
    assert want <= _keys(json.loads(outs["port"]))


def test_tiers_pins_the_null_downsample_bytes(pair):
    """ROADMAP §C.21, closed: the port's tier map gives the downsample
    tier's bytes as the reference's does (the object store's count under
    the ds dataset's name; it was null in the port)."""
    docs = []
    for srv in pair:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.http.port}"
                                    "/api/v1/status/tiers") as r:
            docs.append({t["tier"]: t for t in json.load(r)["data"][
                "timeseries"]["tiers"]})
    assert isinstance(docs[0]["downsample"]["bytes"], int)
    assert docs[1]["downsample"]["bytes"] == docs[0]["downsample"]["bytes"]


def test_promql_host_matches_the_reference(pair):
    argv = ["promql", PAIR_QUERY, "--start", str(START + 300), "--end",
            str(START + 590), "--step", "60"]
    bodies = []
    for srv, main in zip(pair, (ref_main, port_main)):
        rc, out = run(main, ["--host", f"127.0.0.1:{srv.http.port}",
                             "--dataset", "timeseries", *argv])
        assert rc == 0
        bodies.append(json.loads(out))
    assert bodies[0]["status"] == bodies[1]["status"] == "success"
    assert bodies[1]["data"] == bodies[0]["data"]
    assert bodies[0]["data"]["result"]


def test_cli_tiers(pair):
    rc, out = port_cli(["--host", f"127.0.0.1:{pair[1].http.port}",
                        "--dataset", "timeseries", "tiers"])
    assert not rc
    assert "federated=True" in out
    for tier in ("memstore", "objectstore", "downsample"):
        assert tier in out
    rc, out = port_cli(["--host", f"127.0.0.1:{pair[1].http.port}",
                        "--dataset", "timeseries", "tiers", "--json"])
    assert not rc and json.loads(out)["federated"] is True
    rc, out = port_cli(["--host", f"127.0.0.1:{pair[1].http.port}",
                        "--dataset", "nope", "tiers"])
    assert rc == 1 and "unknown dataset nope" in out


def _written(srv, who: str, metric: str):
    """(keys, steps, values) of ``metric`` in the node's own memstore,
    read past the tiers (a rule writes its series there)."""
    from filodb_tpu.coordinator.query_service import \
        QueryService as RefService

    if who == "port":
        svc = QueryService(srv.services["timeseries"].memstore, device="cpu")
    else:
        svc = RefService(srv.memstore, "timeseries", 2, spread=1)
    m = svc.query_range(metric, START, 10, START + 600).result
    order = np.argsort([str(k) for k in m.keys])
    vals = np.asarray(m.values.cpu() if hasattr(m.values, "cpu")
                      else m.values)
    return ([str(m.keys[i]) for i in order], np.asarray(m.steps_ms),
            vals[order])


def test_scalar_operator_over_federation_pins_c20(pair, tmp_path):
    """ROADMAP §C.20, closed: over a federated node, a rule whose
    expression puts an operator between a vector and a per-step scalar
    (``-1``) evaluates in both packages, and the series the two rules
    write agree. At each tick the cold tier's index has not loaded the
    flushed lines yet (it refreshes every 60 s), so the vector is a
    tier's empty matrix, which the port met with the scalar's K steps
    and raised on; it is the empty vector, and neither rule writes a
    sample. Over the pair's nodes the same expression answers the lines
    alike."""
    from filodb_tpu_torch.testing.from_jax import boot

    conf = dict(PAIR_CONF, rules={"tick_s": 0.2, "groups": [{
        "name": "g", "interval": "60s",
        "rules": [{"record": "r:up", "expr": "sum(up) > -1",
                   "labels": {"_ws_": "w", "_ns_": "r"}}]}]})
    # the last evaluation at or below the horizon, the lines' newest time
    # less the out-of-order allowance (300 s), on the group's 60 s grid
    last_eval_ms = (START + 590 - 300) // 60 * 60 * 1000
    health, written = {}, {}
    for who, cls, cfg, kw in (("port", FiloServer, ServerConfig,
                               {"device": "cpu"}), ("ref", *REF, {})):
        srv = boot(cls, cfg, conf, str(tmp_path / who), **kw)
        try:
            # the first half of the lines flushed before the second moves
            # the rules' horizon past them, so the ticks read them from
            # the cold tier
            lines = PAIR_LINES.splitlines(keepends=True)
            for part in (lines[:180], lines[180:]):
                with socket.create_connection(("127.0.0.1",
                                               srv.gateway.port)) as s:
                    s.sendall("".join(part).encode())
                _deadline(lambda: _flushed(srv), 60,
                          f"{who}'s lines ingested and flushed")
            seen = []

            def settled():
                srv.gateway.sink.flush()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.http.port}/api/v1/rules",
                        timeout=30) as r:
                    group = json.load(r)["data"]["groups"][0]
                rule = group["rules"][0]
                if rule["health"] == "err":
                    return rule
                # ticks over every line
                seen.append(group.get("watermark"))
                return rule if (seen[-1] or 0) >= last_eval_ms else None

            health[who] = _deadline(settled, 60, f"{who}'s rule evaluated")
            written[who] = _written(srv, who, "r:up")
        finally:
            srv.shutdown()
    assert health["ref"]["health"] == "ok"
    assert health["port"]["health"] == "ok", health["port"].get("lastError")
    (pk, ps, pv), (rk, rs, rv) = written["port"], written["ref"]
    assert pk == rk
    if pk:  # an empty answer's grid is each engine's own
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pv, rv)
    # over the pair's flushed nodes the expression answers the lines
    bodies = []
    for srv in pair:
        url = (f"http://127.0.0.1:{srv.http.port}/promql/timeseries/api/v1/"
               "query_range?" + urllib.parse.urlencode({
                   "query": "sum(up) > -1", "start": START + 300,
                   "end": START + 590, "step": 60}))
        with urllib.request.urlopen(url, timeout=60) as r:
            bodies.append(json.load(r)["data"]["result"])
    assert bodies[0] and bodies[1] == bodies[0]


def test_range_past_every_tier_pins_c22(pair):
    """ROADMAP §C.22, closed: a range from the lines' time to now at a step
    of 30 days (one step on the lines, the rest past them). The extent
    cache widens the grid to whole extents, years wide, and the cold
    tier's pyramid lane decoded its edge chunks with timestamps relative
    to the leaf's start in int32 ms, which wrapped, so the port answered
    no series; both now answer the first step, the same whole result."""
    rows = []
    end = int(time.time())
    for srv in pair:
        url = (f"http://127.0.0.1:{srv.http.port}/promql/timeseries/api/v1/"
               "query_range?" + urllib.parse.urlencode({
                   "query": "sum(up)", "start": START + 300,
                   "end": end, "step": 86400 * 30}))
        with urllib.request.urlopen(url, timeout=60) as r:
            rows.append(json.load(r)["data"]["result"])
    assert rows[0] and rows[0][0]["values"][0][0] == START + 300
    assert rows[1] == rows[0]


def test_clients_read_either_node_alike(pair):
    answers = []
    for srv in pair:
        for cls in (RefClient, FiloClient):
            c = cls(port=srv.http.port)
            labels, values, steps = c.query_range_matrix(
                PAIR_QUERY, START + 300, START + 590, 60)
            answers.append((sorted(c.label_names()), c.label_values("i"),
                            labels, values.tolist(), steps.tolist(),
                            c.cluster_status()))
    for a in answers[1:]:
        assert a[:5] == answers[0][:5]
    # both packages' nodes report the same shards, ACTIVE
    assert [s["status"] for s in answers[0][5]] == \
        [s["status"] for s in answers[2][5]]


# --------------------------------------------------------------------------
# the client

@pytest.fixture(params=["threaded", "fast"])
def server(request):
    ms = MemStore(4, 1, config=StoreConfig(max_chunk_size=100))
    keys = counter_series(5, metric="http_requests_total")
    ingest_routed(ms, counter_stream(keys, 400, start_ms=START * 1000))
    svc = QueryService(ms, device="cpu")
    cls = FastHttpServer if request.param == "fast" else FiloHttpServer
    srv = cls({"timeseries": svc}, port=0).start()
    yield srv
    srv.stop()


class TestFiloClient:
    def test_client_round_trip(self, server):
        c = FiloClient(port=server.port)
        assert c.health()
        result = c.query_range('sum(rate(http_requests_total[5m]))',
                               START + 600, START + 1800, 60)
        assert len(result) == 1 and result[0]["values"]
        labels, values, steps = c.query_range_matrix(
            'rate(http_requests_total[5m])', START + 600, START + 1800, 60)
        assert values.shape == (5, 21)
        assert np.isfinite(values).all()
        assert c.label_values("job") == ["job-0", "job-1", "job-2"]
        assert "instance" in c.label_names()
        assert len(c.series("http_requests_total", START, START + 4000)) == 5
        inst = c.query("http_requests_total", START + 1000)
        assert len(inst) == 5
        with pytest.raises(FiloClientError):
            c.query_range("((bad", START, START + 60, 60)

    def test_health_of_nothing_is_false(self):
        assert not FiloClient(port=free_port(), timeout_s=2).health()


def test_full_stack_client(tmp_path):
    """A port node with everything on: gateway ingest, the WAL, the flush
    scheduler, streaming downsampling; read through the client, then a
    restart's recovery."""
    p = tmp_path / "server.json"
    p.write_text(json.dumps({
        "node_name": "full-stack", "data_dir": str(tmp_path / "data"),
        "http_port": 0, "gateway_port": free_port(),
        "datasets": {"timeseries": {
            "num_shards": 2, "spread": 1,
            "store": {"max_chunk_size": 60, "groups_per_shard": 2,
                      "flush_interval_ms": 400, "device_pages": True,
                      "retention_ms": 10**15},
            "downsample": {"streaming": True, "resolutions_ms": [300000],
                           "schedule_s": 3600,
                           "raw_retention_ms": 10**15}}}}))
    srv = FiloServer(ServerConfig.load(str(p)), device="cpu").start()
    try:
        client = FiloClient(port=srv.http.port)
        assert client.health()
        with socket.create_connection(("127.0.0.1",
                                       srv.gateway.port)) as s:
            for i in range(240):
                ts_ns = (START + i * 10) * 1_000_000_000
                s.sendall("".join(
                    f"cpu,host=h{h},_ws_=demo,_ns_=full "
                    f"value={40 + h + (i % 5)} {ts_ns}\n"
                    f"reqs,host=h{h},_ws_=demo,_ns_=full "
                    f"counter={i * (h + 2)} {ts_ns}\n"
                    for h in range(6)).encode())

        def six():
            srv.gateway.sink.flush()
            res = client.query_range("count(cpu)", START + 2390,
                                     START + 2390, 60)
            return res and float(res[0]["values"][0][1]) == 6

        _deadline(six, 30, "gauges ingested")
        labels, values, steps = client.query_range_matrix(
            "sum(rate(reqs[5m]))", START + 600, START + 2300, 60)
        assert values.shape[0] == 1
        finite = values[np.isfinite(values)]
        # sum of per-host slopes: sum((h+2)/10) = 2.7/sec
        np.testing.assert_allclose(np.median(finite), 2.7, rtol=0.05)
        _deadline(lambda: sum(
            len(srv.column_store.scan_part_keys("timeseries", s))
            for s in range(2)) >= 12, 30, "part keys flushed")
        assert len(client.query("topk(2, cpu)", START + 2390)) == 2
    finally:
        srv.shutdown()
    srv2 = FiloServer(ServerConfig.load(str(p)), device="cpu").start()
    try:
        client = FiloClient(port=srv2.http.port)

        def recovered():
            res = client.query_range("count_over_time(cpu[40m])",
                                     START + 2395, START + 2395, 60)
            return res and sum(float(s["values"][0][1])
                               for s in res) == 6 * 240

        _deadline(recovered, 30, "recovery of every sample")
    finally:
        srv2.shutdown()
