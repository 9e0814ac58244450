"""The HA and federation planners, ``PromQlRemoteExec`` and ``to_promql``
of the port.

Mirrors ``tests/test_ha_planners.py`` on the CPU:

- ``to_promql`` renders every plan of the reference's ``CASES``
  (``:38-56``) and of the port's query sweeps (``test_torch_slice.py``'s
  functions under its aggregations, ``test_torch_promql.py``'s range
  functions, scalar operations and joins) to the reference's string, and
  the string parses back to the same plan;
- the planners' cases (``:79-237``): no failure stays local, a failure
  window goes to a replica's HTTP API and is stitched on the card, the
  regex shard-key fan-out (pushed down for ``sum``, not for ``avg``),
  the single- and multi-partition routes;
- the port's ``HighAvailabilityPlanner`` and the reference's, each
  pointed at the *other* package's HTTP server as its replica cluster,
  give each other's answers at the reference's ``rtol=1e-6``.
"""

from __future__ import annotations

import numpy as np
import pytest

from filodb_tpu.coordinator.ha_planner import (
    HighAvailabilityPlanner as RefHAPlanner,
)
from filodb_tpu.coordinator.ha_planner import (
    StaticFailureProvider as RefFailures,
)
from filodb_tpu.coordinator.ha_planner import TimeRange as RefTimeRange
from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.store.config import StoreConfig as RefStoreConfig
from filodb_tpu.http.server import FiloHttpServer as RefHttpServer
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query.exec.plan import ExecContext as RefExecContext
from filodb_tpu.query.logical_parser import to_promql as ref_to_promql
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.coordinator.ha_planner import (
    HighAvailabilityPlanner,
    MultiPartitionPlanner,
    PartitionLocationProvider,
    ShardKeyRegexPlanner,
    SinglePartitionPlanner,
    StaticFailureProvider,
    TimeRange,
    _replace_shard_keys,
)
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
from filodb_tpu_torch.query.exec.plan import (
    ExecContext,
    StitchRvsExec,
    run_plan,
)
from filodb_tpu_torch.query.exec.remote_exec import PromQlRemoteExec
from filodb_tpu_torch.query.logical_parser import to_promql
from filodb_tpu_torch.query.model import QueryStats
from test_torch_promql import JOIN_CASES, RANGE_CASES, RANGE_EXPRS, SCALAR_CASES
from test_torch_remote_dispatch import port_store, routed
from test_torch_slice import AGGS, FNS

START = 1_600_000_000
DS = "timeseries"

CASES = [
    'heap_usage{_ws_="demo",_ns_="App-1"}',
    'rate(http_requests_total{_ws_="d",_ns_="n"}[5m])',
    'sum(rate(m[5m]))',
    'sum by (job) (rate(m[1m]))',
    'topk(5, sum by (app) (rate(cpu[1m])))',
    'histogram_quantile(0.99, sum(rate(lat[5m])) by (le))',
    '(sum(rate(a[1m])) / sum(rate(b[1m])))',
    'quantile_over_time(0.9, m[10m])',
    'predict_linear(m[30m], 3600)',
    'absent(m{job="x"})',
    'label_replace(m, "d", "$1", "s", "(.*)")',
    'max_over_time(rate(m[1m])[30m:1m])',
    'scalar(sum(m))',
    'vector(5)',
    '(m > bool 5)',
    '(a and b)',
    'count_values("version", build_info)',
]


def _sweep() -> list[str]:
    out = []
    for fn in FNS:
        window = "2m" if fn == "avg_over_time" else "5m"
        metric = "queue_depth" if fn == "delta" else "http_requests_total"
        out += [agg.format(f"{fn}({metric}[{window}])") for agg in AGGS]
    out += [w.format(RANGE_EXPRS[n]) for n, w in RANGE_CASES]
    return out + list(SCALAR_CASES) + list(JOIN_CASES)


SWEEP = _sweep()


class TestToPromql:
    @pytest.mark.parametrize("query", CASES + SWEEP)
    def test_renders_the_reference_string(self, query):
        ours = parse_query(query, TimeStepParams(START, 60, START + 3600))
        theirs = ref_parse(query, RefParams(START, 60, START + 3600))
        text = to_promql(ours)
        assert text == ref_to_promql(theirs)
        # the text parses back to the same plan
        assert parse_query(text, TimeStepParams(START, 60,
                                                START + 3600)) == ours

    def test_sweep_is_wide(self):
        assert len(SWEEP) >= 89


# ---- the planners over one store ------------------------------------------------


def _raws(nss):
    return routed([gauge_stream(machine_metrics_series(6, ns=ns), 400,
                                start_ms=START * 1000) for ns in nss])


def _service(nss=("App-1",)) -> QueryService:
    return QueryService(port_store(_raws(nss),
                                   config=None), device="cpu",
                        engine="exec")


def _ref_service(nss=("App-1",)) -> RefService:
    ms = TimeSeriesMemStore()
    for s in range(4):
        ms.setup(DS, s, RefStoreConfig(max_chunk_size=100))
    for ns in nss:
        ingest_routed(ms, DS, gauge_stream(machine_metrics_series(6, ns=ns),
                                           400, start_ms=START * 1000), 4, 1)
    return RefService(ms, DS, 4, spread=1)


def _run(svc: QueryService, tree):
    ctx = ExecContext(svc.memstore, QueryStats(engine="exec"), svc.device,
                      dataset=DS)
    data = run_plan(tree, ctx)
    data.materialize()
    return data


class TestHighAvailabilityPlanner:
    def test_no_failures_stays_local(self):
        svc = _service()
        planner = HighAvailabilityPlanner(
            DS, svc.planner, StaticFailureProvider([]),
            "http://127.0.0.1:1/promql/timeseries")
        ep = planner.materialize(parse_query(
            "sum(heap_usage)", TimeStepParams(START, 60, START + 1200)))
        assert not isinstance(ep, StitchRvsExec)
        assert _run(svc, ep).num_series == 1

    def test_failure_routes_to_replica(self):
        replica = _service()
        http = FiloHttpServer({DS: replica}, port=0).start()
        try:
            local = _service()
            planner = HighAvailabilityPlanner(
                DS, local.planner,
                StaticFailureProvider([TimeRange((START + 600) * 1000,
                                                 (START + 1200) * 1000)]),
                f"http://127.0.0.1:{http.port}/promql/{DS}")
            q = 'sum(sum_over_time(heap_usage{_ws_="demo",_ns_="App-1"}[2m]))'
            ep = planner.materialize(parse_query(
                q, TimeStepParams(START + 300, 60, START + 2400)))
            assert isinstance(ep, StitchRvsExec)
            assert "PromQlRemoteExec" in ep.tree_str()
            got = _run(local, ep)
            direct = local.query_range(q, START + 300, 60,
                                       START + 2400).result
            assert got.num_steps == direct.num_steps
            np.testing.assert_allclose(np.asarray(got.values),
                                       direct.values, rtol=1e-6,
                                       equal_nan=True)
        finally:
            http.stop()

    def test_remote_answer_lands_on_the_context_device(self):
        replica = _service()
        http = FiloHttpServer({DS: replica}, port=0).start()
        try:
            ex = PromQlRemoteExec(
                endpoint=f"http://127.0.0.1:{http.port}/promql/{DS}",
                promql="sum(heap_usage)", start=(START + 300) * 1000,
                step=60_000, end=(START + 900) * 1000)
            ctx = ExecContext(replica.memstore, dataset=DS)
            m = ex.execute(ctx)
            import torch

            assert isinstance(m.values, torch.Tensor)
            assert m.values.dtype == torch.float64
            assert m.values.device == ctx.device
            assert m.num_series == 1 and m.num_steps == 11
        finally:
            http.stop()

    def test_unreachable_replica_raises_connection_error(self):
        ex = PromQlRemoteExec(endpoint="http://127.0.0.1:1/promql/x",
                              promql="m", start=0, step=60_000, end=60_000,
                              timeout_s=2.0)
        with pytest.raises(ConnectionError):
            ex.execute(ExecContext(None, dataset=DS))


class TestAcrossPackages:
    """Each package's HA planner with the other package's HTTP server as
    its replica cluster."""

    Q = 'sum(sum_over_time(heap_usage{_ws_="demo",_ns_="App-1"}[2m]))'
    FAIL = ((START + 600) * 1000, (START + 1200) * 1000)

    def test_port_planner_over_the_reference_server(self):
        ref = _ref_service()
        http = RefHttpServer({DS: ref}, port=0).start()
        try:
            local = _service()
            planner = HighAvailabilityPlanner(
                DS, local.planner, StaticFailureProvider([TimeRange(
                    *self.FAIL)]), f"http://127.0.0.1:{http.port}/promql/{DS}")
            got = _run(local, planner.materialize(parse_query(
                self.Q, TimeStepParams(START + 300, 60, START + 2400))))
            want = ref.query_range(self.Q, START + 300, 60,
                                   START + 2400).result
            want.materialize()
            np.testing.assert_allclose(np.asarray(got.values), want.values,
                                       rtol=1e-6, equal_nan=True)
        finally:
            http.stop()

    def test_reference_planner_over_the_port_server(self):
        port = _service()
        http = FiloHttpServer({DS: port}, port=0).start()
        try:
            ref = _ref_service()
            planner = RefHAPlanner(
                DS, ref.planner, RefFailures([RefTimeRange(*self.FAIL)]),
                f"http://127.0.0.1:{http.port}/promql/{DS}")
            ep = planner.materialize(ref_parse(
                self.Q, RefParams(START + 300, 60, START + 2400)))
            got = ep.dispatcher.dispatch(ep, RefExecContext(ref.memstore,
                                                            DS)).result
            got.materialize()
            want = port.query_range(self.Q, START + 300, 60,
                                    START + 2400).result
            np.testing.assert_allclose(got.values, np.asarray(want.values),
                                       rtol=1e-6, equal_nan=True)
        finally:
            http.stop()


class TestShardKeyRegexPlanner:
    NS3 = ["App-0", "App-1", "App-2"]

    @staticmethod
    def _matcher(n):
        return lambda filters: [{"_ws_": "demo", "_ns_": f"App-{i}"}
                                for i in range(n)]

    def test_fanout_sum(self):
        svc = _service(self.NS3)
        planner = ShardKeyRegexPlanner(svc.planner, self._matcher(3))
        ep = planner.materialize(parse_query(
            'sum(heap_usage{_ws_="demo",_ns_=~"App.*"})',
            TimeStepParams(START + 300, 300, START + 900)))
        got = _run(svc, ep)
        assert got.num_series == 1
        direct = svc.query_range('sum({__name__="heap_usage"})',
                                 START + 300, 300, START + 900).result
        np.testing.assert_allclose(np.asarray(got.values), direct.values,
                                   rtol=1e-9)

    def test_fanout_avg_not_pushed_down(self):
        svc = _service(self.NS3[:2])
        planner = ShardKeyRegexPlanner(svc.planner, self._matcher(2))
        ep = planner.materialize(parse_query(
            'avg(heap_usage{_ws_="demo",_ns_=~"App.*"})',
            TimeStepParams(START + 300, 300, START + 900)))
        direct = svc.query_range('avg({__name__="heap_usage"})',
                                 START + 300, 300, START + 900).result
        np.testing.assert_allclose(np.asarray(_run(svc, ep).values),
                                   direct.values, rtol=1e-9)

    def test_fanout_count_sums_the_partial_counts(self):
        svc = _service(self.NS3)
        planner = ShardKeyRegexPlanner(svc.planner, self._matcher(3))
        ep = planner.materialize(parse_query(
            'count(heap_usage{_ws_="demo",_ns_=~"App.*"})',
            TimeStepParams(START + 300, 300, START + 900)))
        np.testing.assert_array_equal(np.asarray(_run(svc, ep).values),
                                      18.0)

    def test_no_regex_passthrough(self):
        svc = _service()
        planner = ShardKeyRegexPlanner(svc.planner, lambda f: [])
        ep = planner.materialize(parse_query(
            'sum(heap_usage{_ws_="demo",_ns_="App-1"})',
            TimeStepParams(START + 300, 300, START + 900)))
        assert _run(svc, ep).num_series == 1

    def test_replace_shard_keys_rewrites_every_leaf(self):
        plan = parse_query('sum(rate(m{_ws_="demo",_ns_=~"App.*"}[5m]))',
                           TimeStepParams(START, 60, START + 600))
        out = _replace_shard_keys(plan, {"_ns_": "App-7"}, ("_ws_", "_ns_"))
        assert to_promql(out) == \
            'sum(rate(m{_ws_="demo",_ns_="App-7"}[5m]))'


class TestSingleAndMultiPartition:
    def test_single_partition_selector(self):
        chosen = []

        class Probe(SingleClusterPlanner):
            def materialize(self, plan, q=None):
                chosen.append(self.dataset)
                return super().materialize(plan, q)

        planner = SinglePartitionPlanner(
            planners={"raw": Probe(4, 1, dataset=DS),
                      "ds": Probe(4, 1, dataset="other")},
            select=lambda plan: "raw", default="raw")
        planner.materialize(parse_query(
            "heap_usage", TimeStepParams(START, 300, START + 600)))
        assert chosen == [DS]

    @staticmethod
    def _locator(partition: str, endpoint: str):
        class Loc(PartitionLocationProvider):
            def partition_of(self, shard_key):
                return partition

            def endpoint_of(self, part):
                return endpoint

        return Loc()

    def test_multipartition_local(self):
        svc = _service()
        planner = MultiPartitionPlanner(
            self._locator("local", "http://nowhere"), "local", svc.planner)
        ep = planner.materialize(parse_query(
            'sum(heap_usage{_ws_="demo",_ns_="App-1"})',
            TimeStepParams(START, 300, START + 600)))
        assert _run(svc, ep).num_series == 1

    def test_multipartition_remote_plan(self):
        svc = _service()
        planner = MultiPartitionPlanner(
            self._locator("other", "http://replica:8080/promql/timeseries"),
            "local", svc.planner)
        ep = planner.materialize(parse_query(
            'sum(heap_usage{_ws_="demo",_ns_="App-1"})',
            TimeStepParams(START, 300, START + 600)))
        assert isinstance(ep, PromQlRemoteExec)
        assert ep.promql == 'sum(heap_usage{_ws_="demo",_ns_="App-1"})'
        assert ep.endpoint == "http://replica:8080/promql/timeseries"
