"""Port parity for self-monitoring (``filodb_tpu_torch/utils/selfmon.py``)
and the ingest-side status routes.

The cases of ``tests/test_selfmon.py``: the registry sampler gives the
reference's samples for the same families, the ``MetaMonitor`` writes one
container a tick and never raises, the freshness stamps sample, pop and
stay bounded as the reference's, the exposition escapes and counts its
scrape errors, ``status/tsdb`` and ``status/ingest`` answer on both HTTP
fronts with the reference's keys and, for the same ingest, the
reference's cardinalities (the reference's CLI renders them), and a
node with ``selfmon.enabled`` writes its registry into ``_meta``, where
the shipped ``selfmon_default`` group fires ``FilodbIngestLagHigh``
under an injected ingest stall and resolves once it clears.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.request

import pytest

from filodb_tpu.config import ServerConfig as RefServerConfig
from filodb_tpu.kafka.log import InMemoryLog as RefLog
from filodb_tpu.standalone import FiloServer as RefServer
from filodb_tpu.utils import metrics as ref_metrics
from filodb_tpu.utils import selfmon as ref_selfmon
from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.core.record import RecordContainer
from filodb_tpu_torch.kafka.log import InMemoryLog
from filodb_tpu_torch.standalone import FiloServer
from filodb_tpu_torch.testing.from_jax import free_port, server_pair
from filodb_tpu_torch.utils import metrics as metrics_mod
from filodb_tpu_torch.utils import selfmon as selfmon_mod
from filodb_tpu_torch.utils.metrics import Gauge, GaugeFn, render_prometheus
from filodb_tpu_torch.utils.resilience import FaultInjector
from filodb_tpu_torch.utils.selfmon import (
    E2EStamps,
    MetaMonitor,
    registry_samples,
)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        assert r.status == 200
        return json.load(r)


def _ut_samples(mod, base: dict, prefix: str, **kw) -> list:
    """A package's registry samples of the families named ``prefix*``."""
    return sorted(((sorted(lb.items()), v) for lb, v in
                   mod.registry_samples(base, **kw)
                   if lb[METRIC_LABEL].startswith(prefix)),
                  key=lambda e: e[0])


# ---- the registry sampler ------------------------------------------------------


class TestRegistrySamples:
    def test_families_follow_exposition_naming(self):
        for m in (metrics_mod, ref_metrics):
            m.Counter("selfmon_pt_ctr").inc(3)
            m.Gauge("selfmon_pt_gauge").set(7.5)
            m.Histogram("selfmon_pt_hist", bounds=(1.0, 5.0)).observe(2.0)
        for kw in ({}, {"include_buckets": True}):
            assert _ut_samples(selfmon_mod, {"node": "n1"}, "selfmon_pt_",
                               **kw) == \
                _ut_samples(ref_selfmon, {"node": "n1"}, "selfmon_pt_", **kw)
        out = {dict(lb)[METRIC_LABEL]: v for lb, v in
               _ut_samples(selfmon_mod, {}, "selfmon_pt_")}
        assert out == {"selfmon_pt_ctr_total": 3.0, "selfmon_pt_gauge": 7.5,
                       "selfmon_pt_hist_count": 1.0,
                       "selfmon_pt_hist_sum": 2.0}
        buck = [dict(lb) for lb, _ in _ut_samples(
            selfmon_mod, {}, "selfmon_pt_hist_bucket", include_buckets=True)]
        assert {lb["le"] for lb in buck} == {"1.0", "5.0"}

    def test_base_labels_win_on_collision(self):
        for m in (metrics_mod, ref_metrics):
            m.Counter("selfmon_pt_clash", {"node": "from_tag"}).inc()
        hits = _ut_samples(selfmon_mod, {"node": "base"}, "selfmon_pt_clash")
        assert hits == _ut_samples(ref_selfmon, {"node": "base"},
                                   "selfmon_pt_clash")
        labels = dict(hits[0][0])
        assert labels["node"] == "base"
        assert labels["exported_node"] == "from_tag"

    def test_none_and_nan_gaugefns_are_skipped(self):
        GaugeFn("selfmon_pt_none", lambda: None)
        GaugeFn("selfmon_pt_boom", lambda: 1 / 0)
        names = {labels[METRIC_LABEL] for labels, _ in registry_samples({})}
        assert "selfmon_pt_none" not in names
        assert "selfmon_pt_boom" not in names   # NaN would poison _meta


class TestMetaMonitor:
    def test_tick_writes_one_container(self):
        written = []

        class Sink:
            def write(self, cont):
                written.append(cont)
                return len(cont), {}

        mon = MetaMonitor(Sink(), node="nX", instance="nX:1")
        t0 = selfmon_mod.TICKS.value
        n = mon.tick()
        assert n > 0 and len(written) == 1 and len(written[0]) == n
        assert selfmon_mod.TICKS.value == t0 + 1
        assert selfmon_mod.SERIES.value == float(n)
        rec = written[0].records[0]
        assert rec.part_key.schema == "gauge"
        assert {"_ws_": "_system", "_ns_": "selfmon", "node": "nX",
                "instance": "nX:1"}.items() <= rec.part_key.label_map.items()

    def test_tick_error_is_counted_not_raised(self):
        class BadSink:
            def write(self, cont):
                raise RuntimeError("sink down")

        e0 = selfmon_mod.ERRORS.value
        assert MetaMonitor(BadSink()).tick() == 0
        assert selfmon_mod.ERRORS.value == e0 + 1


# ---- freshness stamps and lag ---------------------------------------------------


class TestE2EStamps:
    def test_sampling_and_observe(self):
        for mod in (selfmon_mod, ref_selfmon):
            st = mod.E2EStamps(sample_every=2, max_pending=4)
            for off in (1, 2, 3, 4, 5, 6):
                st.maybe_stamp("ds", 0, off)
            assert [o for o, _ in st._pending[("ds", 0)]] == [1, 3, 5]
            c0 = mod.INGEST_E2E.count
            st.observe("ds", 0, 4)  # pops 1 and 3
            assert mod.INGEST_E2E.count == c0 + 2
            assert [o for o, _ in st._pending[("ds", 0)]] == [5]
            st.observe("ds", 0, 10)
            assert mod.INGEST_E2E.count == c0 + 3
        assert selfmon_mod.INGEST_E2E.bounds == ref_selfmon.INGEST_E2E.bounds

    def test_pending_is_bounded(self):
        st = E2EStamps(sample_every=1, max_pending=3)
        for off in range(10):
            st.maybe_stamp("ds", 1, off)
        assert [o for o, _ in st._pending[("ds", 1)]] == [7, 8, 9]

    def test_offset_lag_clamped_at_zero(self):
        for lg in (InMemoryLog(), RefLog()):
            assert lg.offset_lag(-1) == 0
            c = RecordContainer()
            first = lg.append(c)
            last = lg.append(c)
            assert lg.offset_lag(first - 1) == last - first + 1
            assert lg.offset_lag(last) == 0
            assert lg.offset_lag(last + 5) == 0


# ---- exposition hardening -------------------------------------------------------


class TestExpositionHardening:
    def test_label_values_escaped(self):
        Gauge("selfmon_pt_esc", {"path": 'a\\b"c\nd'}).set(1.0)
        line = next(ln for ln in render_prometheus().splitlines()
                    if ln.startswith("selfmon_pt_esc{"))
        assert 'path="a\\\\b\\"c\\nd"' in line
        assert "\n" not in line

    def test_broken_gaugefn_counted_and_rendered_nan(self):
        GaugeFn("selfmon_pt_broken", lambda: [][1])
        s0 = metrics_mod.SCRAPE_ERRORS.value
        text = render_prometheus()
        assert metrics_mod.SCRAPE_ERRORS.value > s0
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("selfmon_pt_broken"))
        assert line.endswith("nan")
        assert "filodb_metric_scrape_errors_total" in text


# ---- status routes on both fronts ------------------------------------------------


class TestStatusRoutes:
    @pytest.fixture(params=["fast", "threaded"])
    def servers(self, request, tmp_path):
        conf = {"node_name": "status-node", "http_impl": request.param,
                "datasets": {"timeseries": {
                    "num_shards": 2, "spread": 1,
                    "store": {"max_chunk_size": 50, "groups_per_shard": 2}}}}
        with server_pair(conf, str(tmp_path),
                         (RefServer, RefServerConfig)) as both:
            yield both

    @staticmethod
    def _ingest(srv, shards, start: int, n: int = 80) -> None:
        with socket.create_connection(("127.0.0.1", srv.gateway.port)) as s:
            for i in range(n):
                s.sendall(f"status_metric,host=h{i % 4},_ws_=demo,"
                          f"_ns_=App-0 value={i} "
                          f"{(start + i) * 1_000_000_000}\n".encode())
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            srv.gateway.sink.flush()
            if sum(sh.stats.rows_ingested.value for sh in shards()) >= n \
                    and all(sh.latest_offset >= lg.latest_offset
                            for sh, lg in zip(shards(), srv.logs.values())):
                return
            time.sleep(0.1)
        raise AssertionError("ingest never completed")

    def test_status_tsdb_and_ingest(self, servers, capsys):
        ref, port = servers
        start = int(time.time())
        self._ingest(ref, lambda: ref.memstore.shards_for("timeseries"),
                     start)
        self._ingest(port, lambda: port.node.memstores["timeseries"].shards,
                     start)
        tsdb = _get(port.http.port, "/api/v1/status/tsdb")
        want = _get(ref.http.port, "/api/v1/status/tsdb")
        assert tsdb["status"] == "success" and "timeseries" in tsdb["data"]
        d, w = tsdb["data"]["timeseries"], want["data"]["timeseries"]
        assert d["headStats"] == w["headStats"]
        assert d["headStats"]["numShards"] == 2
        assert d["headStats"]["numSeries"] >= 4
        assert d["seriesCountByMetricName"] == w["seriesCountByMetricName"]
        assert d["labelValueCountByLabelName"] \
            == w["labelValueCountByLabelName"]
        assert [set(sh) for sh in d["shards"]] == \
            [set(sh) for sh in w["shards"]]
        for sh, ws in zip(d["shards"], w["shards"]):
            for k in ("shard", "numSeries", "totalSeries", "samplesEncoded",
                      "chunksFlushed", "partitionsEvicted"):
                assert sh[k] == ws[k], k
        by_metric = {e["name"]: e for e in d["seriesCountByMetricName"]}
        assert by_metric["status_metric"]["value"] >= 4
        assert "host" in {e["name"] for e in d["labelValueCountByLabelName"]}

        ing = _get(port.http.port, "/api/v1/status/ingest")
        ref_ing = _get(ref.http.port, "/api/v1/status/ingest")
        assert ing["status"] == "success"
        assert set(ing["data"]) == set(ref_ing["data"])
        di = ing["data"]["datasets"]["timeseries"]
        for sh, ws in zip(di["shards"],
                          ref_ing["data"]["datasets"]["timeseries"]["shards"]):
            assert set(sh) == set(ws)
            assert sh["ingestedOffset"] >= 0
            assert sh["offsetLag"] == 0
            assert sh["ingestLagSeconds"] is not None
            assert sh["maxIngestedTs"] == ws["maxIngestedTs"]
        assert set(ing["data"]["objectstore"]) == \
            {"queueDepth", "oldestTaskAgeSeconds"}

        one = _get(port.http.port,
                   "/api/v1/status/tsdb?dataset=timeseries&topk=1")
        assert list(one["data"]) == ["timeseries"]
        assert len(one["data"]["timeseries"]["seriesCountByMetricName"]) <= 1

        # the reference's operator CLI renders both views of the port
        from filodb_tpu.cli import main as cli_main

        cli_main(["--host", f"127.0.0.1:{port.http.port}", "status"])
        assert "status_metric" in capsys.readouterr().out
        cli_main(["--host", f"127.0.0.1:{port.http.port}", "lag"])
        out = capsys.readouterr().out
        assert "timeseries" in out and "OFF_LAG" in out


# ---- the whole loop --------------------------------------------------------------


class TestSelfMonE2E:
    CONF = {
        "node_name": "selfmon-node",
        "rules": {"tick_s": 0.2},
        "selfmon": {"enabled": True, "interval_s": 0.25,
                    "lag_alert_threshold_s": 3.0, "lag_alert_for": "0s",
                    "alert_interval": "1s"},
        "datasets": {"timeseries": {
            "num_shards": 1, "spread": 0,
            "store": {"max_chunk_size": 50, "groups_per_shard": 2}}},
    }

    @pytest.fixture
    def server(self, tmp_path):
        FaultInjector.reset()
        # earlier tests' shards may still answer the families the shipped
        # alerts aggregate, with old high-water marks: drop them, this
        # node's shards register theirs at start
        with metrics_mod._lock:
            for key in [k for k, m in metrics_mod._registry.items()
                        if m.name in ("filodb_ingest_lag_seconds",
                                      "filodb_ingest_offset_lag",
                                      "filodb_ingest_checkpoint_lag",
                                      "filodb_breaker_state")]:
                del metrics_mod._registry[key]
        path = tmp_path / "server.json"
        path.write_text(json.dumps({**self.CONF,
                                    "data_dir": str(tmp_path / "data"),
                                    "http_port": 0}))
        cfg = ServerConfig.load(str(path))
        cfg.gateway_port = free_port()
        srv = FiloServer(cfg, device="cpu").start()
        yield srv
        FaultInjector.reset()
        srv.shutdown()

    def test_meta_loop_alert_fires_and_resolves(self, server):
        srv = server
        assert list(srv.config.datasets) == ["timeseries", "_meta"]
        # the shipped group is the reference's
        assert FiloServer._default_meta_alerts(self.CONF["selfmon"]) \
            == RefServer._default_meta_alerts(self.CONF["selfmon"])
        stop = threading.Event()

        def writer():
            with socket.create_connection(("127.0.0.1",
                                           srv.gateway.port)) as s:
                i = 0
                while not stop.is_set():
                    ts_ns = int(time.time() * 1e9)
                    s.sendall(f"live_metric,host=h{i % 3},_ws_=demo,"
                              f"_ns_=App-0 value={i} {ts_ns}\n".encode())
                    i += 1
                    time.sleep(0.05)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        try:
            deadline = time.monotonic() + 30
            result = []
            while time.monotonic() < deadline:
                srv.gateway.sink.flush()
                now = int(time.time())
                result = _get(srv.http.port,
                              "/promql/_meta/api/v1/query_range?"
                              "query=filodb_selfmon_ticks_total"
                              f"&start={now - 60}&end={now}&step=5"
                              )["data"]["result"]
                if result and result[0]["values"]:
                    break
                time.sleep(0.3)
            assert result, "_meta never became queryable"
            assert result[0]["metric"]["_ns_"] == "selfmon"
            groups = _get(srv.http.port, "/api/v1/rules")["data"]["groups"]
            assert any(g["name"] == "selfmon_default" for g in groups)

            # stall the user dataset's ingest, not _meta's
            FaultInjector.arm(
                "shard.ingest", delay_s=6.0, times=2,
                match=lambda ctx: ctx.get("dataset") != "_meta")

            def firing():
                alerts = _get(srv.http.port,
                              "/api/v1/alerts")["data"]["alerts"]
                return [a for a in alerts if a["state"] == "firing"
                        and a["labels"]["alertname"]
                        == "FilodbIngestLagHigh"]

            deadline = time.monotonic() + 45
            fired = []
            while time.monotonic() < deadline and not fired:
                srv.gateway.sink.flush()
                fired = firing()
                time.sleep(0.4)
            assert fired, "lag alert never fired under injected stall"
            assert fired[0]["labels"]["severity"] == "warning"

            deadline = time.monotonic() + 90
            while time.monotonic() < deadline and firing():
                assert wt.is_alive(), "writer thread died mid-test"
                srv.gateway.sink.flush()
                time.sleep(0.4)
            assert not firing(), "lag alert never resolved after stall"
        finally:
            stop.set()
            wt.join(timeout=5)

        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.http.port}/metrics") as r:
            text = r.read().decode()
        e2e = [ln for ln in text.splitlines()
               if ln.startswith("filodb_ingest_e2e_seconds_count")]
        assert e2e and float(e2e[0].rsplit(" ", 1)[1]) >= 1
        ing = _get(srv.http.port, "/api/v1/status/ingest")
        assert {"timeseries", "_meta"} <= set(ing["data"]["datasets"])
        assert "selfmon_default" in ing["data"]["rulesWatermarkLagSeconds"]
