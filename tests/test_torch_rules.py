"""Port parity for the standing queries: recording rules and alerts.

The cases of ``tests/test_rules.py``, each run on both packages at once:
the reference's ``RuleManager`` over its ``QueryService`` and the port's
over its own (``filodb_tpu_torch/rules``), over the same store data (the
reference's gauge stream, its containers ingested into both stores) and
with the same rule groups. Every tick evaluates as many (rule, step)
pairs on both sides; the recorded series agree within the reference's
tolerance (``rtol=2e-5, atol=1e-9``, ``tests/test_rules.py:120-128``),
and the watermarks, alert states, transitions, ``ALERTS`` /
``ALERTS_FOR_STATE`` samples, cache floors and catch-up counters are
equal. The port's own contract is held as the reference's tests hold
theirs: recorded equals polled, idle ticks cost nothing, a restart
resumes at the durable watermark, a kill at any point leaves no gap and
no double write, the governor sheds rule ticks, tenant quotas apply, and
a node with a ``rules`` block surfaces them over HTTP.
"""

from __future__ import annotations

import json
import math
import socket
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from filodb_tpu.coordinator.ingestion import ingest_routed
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord as RefRecord
from filodb_tpu.core.record import RecordContainer as RefContainer
from filodb_tpu.core.store.config import StoreConfig as RefConfig
from filodb_tpu.rules import AlertingRule as RefAlerting
from filodb_tpu.rules import MemstoreSink as RefSink
from filodb_tpu.rules import RecordingRule as RefRecording
from filodb_tpu.rules import RuleGroup as RefGroup
from filodb_tpu.rules import RuleManager as RefManager
from filodb_tpu.rules import load_groups as ref_load_groups
from filodb_tpu.rules import manager as ref_mgr_mod
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu.utils import governor as ref_gov
from filodb_tpu.utils import lockcheck
from filodb_tpu.utils.resilience import FaultInjector as RefFaults
from filodb_tpu_torch.coordinator.ingestion import route_container
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import IngestRecord, RecordContainer
from filodb_tpu_torch.core.record import SomeData
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.rules import (
    AlertingRule,
    MemstoreSink,
    RecordingRule,
    RuleGroup,
    RuleManager,
    load_groups,
)
from filodb_tpu_torch.rules import manager as mgr_mod
from filodb_tpu_torch.utils import governor as gov
from filodb_tpu_torch.utils.resilience import FaultInjector

NUM_SHARDS = 4
START = 1_600_000_000          # epoch s (not on the 60 s grid)
INTERVAL = 10_000              # ingest cadence, ms
GROUP_MS = 60_000              # rule-group interval, ms
FIRST_STEP = (START * 1000 // GROUP_MS + 1) * GROUP_MS
RTOL, ATOL = 2e-5, 1e-9        # tests/test_rules.py:120-128
CACHE = {"extent_steps": 8, "ooo_allowance_ms": 0}

HEAP_EXPR = "avg_over_time(heap_usage[3m])"


# ---- the two packages side by side -------------------------------------------


def _ref_group(g: RuleGroup) -> RefGroup:
    """The reference's copy of a port rule group."""
    rules = tuple(
        RefRecording(record=r.record, expr=r.expr, labels=r.labels)
        if isinstance(r, RecordingRule) else
        RefAlerting(alert=r.alert, expr=r.expr, for_ms=r.for_ms,
                    labels=r.labels, annotations=r.annotations)
        for r in g.rules)
    return RefGroup(name=g.name, interval_ms=g.interval_ms,
                    dataset=g.dataset, rules=rules)


class Pair:
    """One store of each package over the same data, a service each (the
    extent cache on, no out-of-order allowance), and a rule manager each
    over a ``MemstoreSink``."""

    def __init__(self, num_shards: int = NUM_SHARDS, spread: int = 1):
        self.num_shards, self.spread = num_shards, spread
        rms = TimeSeriesMemStore()
        for s in range(num_shards):
            rms.setup("timeseries", s, RefConfig(max_chunk_size=100,
                                                 groups_per_shard=4))
        pms = MemStore(num_shards, spread, config=StoreConfig(
            max_chunk_size=100, groups_per_shard=4))
        self.ref = SimpleNamespace(
            ms=rms, svc=RefService(rms, "timeseries", num_shards,
                                   spread=spread, result_cache=CACHE),
            sink=RefSink(rms, "timeseries", num_shards, spread=spread),
            mgr=None)
        self.port = SimpleNamespace(
            ms=pms, svc=QueryService(pms, device="cpu", result_cache=CACHE),
            sink=MemstoreSink(pms, "timeseries", num_shards, spread=spread),
            mgr=None)
        self.groups: list[RuleGroup] = []

    def sides(self):
        return (self.ref, self.port)

    # -- data --

    def ingest_stream(self, stream) -> None:
        """Reference containers into both stores, routed to their shards at
        the stream's offsets."""
        stream = list(stream)
        ingest_routed(self.ref.ms, "timeseries", stream, self.num_shards,
                      self.spread)
        for sd in stream:
            cont = RecordContainer.deserialize(sd.container.serialize())
            for s, c in route_container(cont, self.num_shards,
                                        self.spread).items():
                self.port.ms.shards[s].ingest(SomeData(c, sd.offset))

    def extend(self, keys, n_samples: int) -> None:
        """Ingest to ``n_samples`` a series: the deterministic stream from
        the start, whose re-sent prefix both stores drop as out of order."""
        self.ingest_stream(gauge_stream(keys, n_samples,
                                        start_ms=START * 1000,
                                        interval_ms=INTERVAL, seed=11))

    def ingest_temp(self, values_by_index) -> None:
        """A single gauge series through each side's sink."""
        labels = {"_ws_": "demo", "_ns_": "App-0", "_metric_": "temp",
                  "host": "h1"}
        ref, port = RefContainer(), RecordContainer()
        for i, v in values_by_index:
            t = START * 1000 + i * INTERVAL
            ref.add(RefRecord(RefPartKey.create("gauge", labels), t, (v,)))
            port.add(IngestRecord(PartKey.create("gauge", labels), t, (v,)))
        self.ref.sink.write(ref)
        self.port.sink.write(port)

    # -- managers --

    def managers(self, groups: list[RuleGroup], **kw) -> "Pair":
        """A fresh manager a side (a restart keeps the stores)."""
        self.groups = list(groups)
        self.ref.mgr = RefManager(self.ref.svc, self.ref.sink,
                                  [_ref_group(g) for g in groups],
                                  ooo_allowance_ms=0, **kw)
        self.port.mgr = RuleManager(self.port.svc, self.port.sink, groups,
                                    ooo_allowance_ms=0, **kw)
        return self

    def tick(self) -> int:
        n_ref, n_port = self.ref.mgr.tick(), self.port.mgr.tick()
        assert n_port == n_ref
        return n_port

    def drain(self, limit: int = 20) -> int:
        total = 0
        for _ in range(limit):
            n = self.tick()
            if n == 0:
                self.assert_states_equal()
                return total
            total += n
        raise AssertionError("tick never converged")

    def last_step(self, group: str) -> int:
        wm = self.port.mgr._state[group].last_step
        assert wm == self.ref.mgr._state[group].last_step
        return wm

    def assert_states_equal(self) -> None:
        """Watermarks, visible steps, alert states and the cache floor."""
        for g in self.groups:
            ref, port = (self.ref.mgr._state[g.name],
                         self.port.mgr._state[g.name])
            assert port.last_step == ref.last_step, g.name
            assert port.visible_step == ref.visible_step, g.name
            assert port.last_error == ref.last_error, g.name
            assert set(port.alert_states) == set(ref.alert_states)
            for rule, states in port.alert_states.items():
                want = ref.alert_states[rule]
                assert set(states) == set(want), rule
                for k, st in states.items():
                    assert st.active_since_ms == want[k].active_since_ms
                    assert st.firing == want[k].firing
                    assert st.value == pytest.approx(
                        want[k].value, rel=RTOL, abs=ATOL, nan_ok=True)
        assert self.port.svc.rules_horizon_floor() \
            == self.ref.svc.rules_horizon_floor()
        snap = [{k: v for k, v in a.items() if k != "value"}
                for a in self.port.mgr.alerts_snapshot()]
        assert snap == [{k: v for k, v in a.items() if k != "value"}
                        for a in self.ref.mgr.alerts_snapshot()]

    def query(self, promql: str, start_s: int, step_s: int, end_s: int):
        """(reference, port) answers of a fresh service each (no cache)."""
        ref = RefService(self.ref.ms, "timeseries", self.num_shards,
                         spread=self.spread)
        port = QueryService(self.port.ms, device="cpu")
        return (ref.query_range(promql, start_s, step_s, end_s),
                port.query_range(promql, start_s, step_s, end_s))


def build(n_samples: int, num_shards: int = NUM_SHARDS):
    """Gauge data in two namespaces (one shard key reaches 2^spread shards;
    two cover four)."""
    pair = Pair(num_shards)
    keys = (machine_metrics_series(8, ns="App-0")
            + machine_metrics_series(8, ns="App-1"))
    pair.extend(keys, n_samples)
    return pair, keys


def alert_pair(for_ms: int = 120_000) -> Pair:
    pair = Pair(1, spread=0)
    return pair.managers([RuleGroup(
        name="alerts", interval_ms=GROUP_MS, dataset="timeseries",
        rules=(AlertingRule(alert="TempHigh", expr="avg(temp) > 0.5",
                            for_ms=for_ms,
                            annotations=(("summary", "too hot"),)),))])


def rec_group(name="heap", expr=HEAP_EXPR, record="ns:heap:avg"):
    return RuleGroup(name=name, interval_ms=GROUP_MS, dataset="timeseries",
                     rules=(RecordingRule(record=record, expr=expr),))


def series_rows(res) -> dict:
    """A range answer's rows by (namespace, instance)."""
    m = res.result
    out = {}
    for i, key in enumerate(m.keys):
        labels = dict(key.labels)
        out[(labels.get("_ns_"), labels.get("instance"))] = \
            np.asarray(m.values)[i]
    return out


def assert_rows_equivalent(a, b) -> None:
    p, r = series_rows(a), series_rows(b)
    assert set(p) == set(r) and p
    for k in p:
        assert np.array_equal(np.isnan(p[k]), np.isnan(r[k])), k
        np.testing.assert_allclose(p[k], r[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=str(k))


def assert_recorded(pair: Pair, record: str, expr: str, start_ms: int,
                    end_ms: int) -> None:
    """The recorded series equal the expression polled over the recorded
    steps on each side, and the reference's recorded series."""
    ref_rec, port_rec = pair.query(record, start_ms // 1000, 60,
                                   end_ms // 1000)
    _, port_poll = pair.query(expr, start_ms // 1000, 60, end_ms // 1000)
    assert_rows_equivalent(port_poll, port_rec)
    assert_rows_equivalent(ref_rec, port_rec)


def recorded_counts(pair: Pair, record: str, start_ms: int, end_ms: int):
    """``count_over_time(record[60s])`` on each side, equal, as floats."""
    ref, port = pair.query(f"count_over_time({record}[60s])",
                           start_ms // 1000, 60, end_ms // 1000)
    vals = np.asarray(port.result.values, dtype=float)
    np.testing.assert_array_equal(
        np.sort(vals, axis=0), np.sort(np.asarray(ref.result.values,
                                                  dtype=float), axis=0))
    return vals


# ---- recorded equals polled ----------------------------------------------------


class TestPollEquivalence:
    def test_recorded_equals_polled(self):
        pair, keys = build(30)
        pair.managers([rec_group()])
        assert pair.tick() == 1      # fresh start: exactly one step
        wm0 = pair.last_step("heap")
        assert wm0 % GROUP_MS == 0
        pair.extend(keys, 240)
        pair.drain()
        wm = pair.last_step("heap")
        assert wm > wm0
        assert_recorded(pair, "ns:heap:avg", HEAP_EXPR, wm0, wm)

    def test_recorded_series_carry_source_and_rule_labels(self):
        pair, keys = build(60)
        g = RuleGroup(name="lbl", interval_ms=GROUP_MS, dataset="timeseries",
                      rules=(RecordingRule(
                          record="ns:heap:max",
                          expr="max_over_time(heap_usage[2m])",
                          labels=(("tier", "gold"),)),))
        pair.managers([g]).drain()
        wm = pair.last_step("lbl")
        ref, port = pair.query('ns:heap:max{tier="gold"}',
                               FIRST_STEP // 1000, 60, wm // 1000)
        assert port.result.num_series == len(keys)
        assert sorted(k.labels for k in port.result.keys) == \
            sorted(k.labels for k in ref.result.keys)
        for key in port.result.keys:
            labels = dict(key.labels)
            assert labels["tier"] == "gold"
            assert labels["_ws_"] == "demo"        # inherited, not default
            assert labels["_ns_"] in ("App-0", "App-1")
            assert "instance" in labels
        assert_rows_equivalent(ref, port)


# ---- incrementality and the cache floor ----------------------------------------


class TestIncrementality:
    def test_idle_ticks_cost_zero(self):
        pair, _ = build(30)
        pair.managers([rec_group()])
        c0 = mgr_mod.rules_steps_evaluated.value
        r0 = ref_mgr_mod.rules_steps_evaluated.value
        assert pair.tick() == 1
        for _ in range(3):
            assert pair.tick() == 0
        assert mgr_mod.rules_steps_evaluated.value - c0 == 1 \
            == ref_mgr_mod.rules_steps_evaluated.value - r0
        pair.assert_states_equal()

    def test_cost_proportional_to_new_steps_only(self):
        pair, keys = build(30)
        pair.managers([rec_group()])
        pair.tick()
        wm = pair.last_step("heap")
        pair.extend(keys, 120)
        horizon = min(s.max_ingested_ts for s in pair.port.ms.shards)
        assert horizon == min(s.max_ingested_ts for s in
                              pair.ref.ms.shards_for("timeseries"))
        expected = (horizon // GROUP_MS * GROUP_MS - wm) // GROUP_MS
        assert expected > 1
        c0 = mgr_mod.rules_steps_evaluated.value
        assert pair.tick() == expected
        assert mgr_mod.rules_steps_evaluated.value == c0 + expected
        assert pair.tick() == 0
        pair.assert_states_equal()

    def test_catchup_cap_skips_and_counts(self):
        pair, keys = build(30)
        pair.managers([rec_group()], max_catchup_steps=4)
        pair.tick()
        wm0 = pair.last_step("heap")
        s0 = mgr_mod.rules_steps_skipped.value
        r0 = ref_mgr_mod.rules_steps_skipped.value
        pair.extend(keys, 480)       # ~70 new steps, far over the cap
        assert pair.tick() == 4
        skipped = mgr_mod.rules_steps_skipped.value - s0
        assert skipped > 0
        assert skipped == ref_mgr_mod.rules_steps_skipped.value - r0
        assert pair.last_step("heap") > wm0
        pair.assert_states_equal()

    def test_horizon_floor_tracks_watermark(self):
        pair, _ = build(60)
        pair.managers([rec_group()])
        assert pair.port.svc.rules_horizon_floor() < 0
        assert pair.port.svc.rules_horizon_floor() \
            == pair.ref.svc.rules_horizon_floor()
        pair.drain()
        assert pair.port.svc.rules_horizon_floor() == pair.last_step("heap")

    def test_horizon_floor_reads_never_block_on_state_lock(self):
        import threading

        pair, _ = build(60)
        pair.managers([rec_group()]).drain()
        expect = pair.last_step("heap")
        mgr = pair.port.mgr
        acquired, release = threading.Event(), threading.Event()

        def hold():
            with mgr._lock:
                acquired.set()
                release.wait(5)

        t = threading.Thread(target=hold, daemon=True)
        t.start()
        assert acquired.wait(5)
        try:
            assert pair.port.svc.rules_horizon_floor() == expect
        finally:
            release.set()
            t.join()

    def test_unrecovered_floor_bounded_not_sentinel(self):
        pair, _ = build(60)
        pair.managers([rec_group()], max_catchup_steps=4)

        def boom(*a, **kw):
            raise RuntimeError("recovery unavailable")

        for side in pair.sides():
            side.mgr._recover = boom
        f0 = mgr_mod.rules_eval_failures.value
        assert pair.tick() == 0
        assert mgr_mod.rules_eval_failures.value == f0 + 1
        horizon = min(s.max_ingested_ts for s in pair.port.ms.shards)
        assert pair.port.svc.rules_horizon_floor() \
            == horizon - 5 * GROUP_MS == pair.ref.svc.rules_horizon_floor()
        assert mgr_mod.rules_unrecovered_groups.value == 1
        for side in pair.sides():
            del side.mgr._recover
        pair.drain()
        assert pair.last_step("heap") > horizon - 5 * GROUP_MS
        assert mgr_mod.rules_unrecovered_groups.value == 0


# ---- alerts --------------------------------------------------------------------


def hot_after_cold(pair: Pair):
    """Cold 10 min, a tick (fresh start), hot 10 min, catch up: (t0, wm),
    the first step that sees the hot data and the watermark."""
    pair.ingest_temp([(i, 0.0) for i in range(60)])
    pair.tick()
    pair.ingest_temp([(i, 1.0) for i in range(60, 120)])
    pair.drain()
    hot_ms = START * 1000 + 60 * INTERVAL
    t0 = (hot_ms + GROUP_MS - 1) // GROUP_MS * GROUP_MS
    return t0, pair.last_step("alerts")


class TestAlerting:
    def test_pending_to_firing_with_for_hysteresis(self):
        pair = alert_pair()
        tr0 = mgr_mod.alerts_transitions.value
        rt0 = ref_mgr_mod.alerts_transitions.value
        t0, wm = hot_after_cold(pair)
        snap = pair.port.mgr.alerts_snapshot()
        assert len(snap) == 1
        a = snap[0]
        assert a["state"] == "firing" and a["activeAt"] == t0 / 1000.0
        assert a["labels"]["alertname"] == "TempHigh"
        assert a["annotations"] == {"summary": "too hot"}
        assert a["value"] == pair.ref.mgr.alerts_snapshot()[0]["value"]
        # the synthetic series: pending until for: elapses, firing on
        for q in ('ALERTS{alertstate="pending"}', 'ALERTS{alertstate="firing"}',
                  'ALERTS_FOR_STATE{alertname="TempHigh"}'):
            ref, port = pair.query(q, t0 // 1000, 60, wm // 1000)
            assert [k.labels for k in port.result.keys] == \
                [k.labels for k in ref.result.keys]
            np.testing.assert_array_equal(np.asarray(port.result.values),
                                          np.asarray(ref.result.values))
        _, pend = pair.query('ALERTS{alertstate="pending"}', t0 // 1000, 60,
                             wm // 1000)
        _, fire = pair.query('ALERTS{alertstate="firing"}', t0 // 1000, 60,
                             wm // 1000)
        pv, fv = (np.asarray(r.result.values)[0] for r in (pend, fire))
        assert not math.isnan(pv[0]) and not math.isnan(pv[1])
        assert math.isnan(fv[0]) and math.isnan(fv[1])
        assert not np.isnan(fv[2:]).any()
        _, fs = pair.query('ALERTS_FOR_STATE{alertname="TempHigh"}',
                           t0 // 1000, 60, wm // 1000)
        np.testing.assert_array_equal(
            np.asarray(fs.result.values)[0],
            np.arange(0, (wm - t0) // 1000 + 1, 60, dtype=float))
        tr = mgr_mod.alerts_transitions.value - tr0
        assert tr >= 2 and tr == ref_mgr_mod.alerts_transitions.value - rt0
        assert mgr_mod.alerts_firing.value >= 1

    def test_recovery_resumes_firing_state(self):
        pair = alert_pair()
        t0, _ = hot_after_cold(pair)
        orig = dict(pair.port.mgr._state["alerts"].alert_states["TempHigh"])
        assert orig
        pair.managers(pair.groups)   # restart: fresh managers, same stores
        assert pair.tick() == 0      # nothing evaluated again
        pair.assert_states_equal()
        rec = pair.port.mgr._state["alerts"].alert_states["TempHigh"]
        assert set(rec) == set(orig)
        for k in orig:
            assert rec[k].active_since_ms == orig[k].active_since_ms == t0
            assert rec[k].firing and orig[k].firing

    def test_transitions_counted_only_on_commit(self):
        pair = alert_pair(for_ms=0)
        pair.ingest_temp([(i, 0.0) for i in range(30)])
        pair.tick()
        pair.ingest_temp([(i, 1.0) for i in range(30, 90)])
        tr0 = mgr_mod.alerts_transitions.value
        try:
            RefFaults.arm("rules.write", error=ConnectionError, times=1)
            FaultInjector.arm("rules.write", error=ConnectionError, times=1)
            assert pair.tick() == 0
            assert mgr_mod.alerts_transitions.value == tr0
        finally:
            RefFaults.reset()
            FaultInjector.reset()
        pair.drain()
        assert mgr_mod.alerts_transitions.value == tr0 + 2

    def test_recovery_scoped_to_group(self):
        pair = Pair(1, spread=0)

        def grp(name, expr):
            return RuleGroup(name=name, interval_ms=GROUP_MS,
                             dataset="timeseries",
                             rules=(AlertingRule(alert="TempHigh", expr=expr,
                                                 for_ms=0),))

        groups = [grp("hot", "avg(temp) > 0.5"), grp("cold", "avg(temp) > 2")]
        pair.managers(groups)
        pair.ingest_temp([(i, 1.0) for i in range(120)])
        pair.drain()
        hot = set(pair.port.mgr._state["hot"].alert_states["TempHigh"])
        assert hot
        assert not pair.port.mgr._state["cold"].alert_states.get("TempHigh")
        pair.managers(groups)
        assert pair.tick() == 0
        pair.assert_states_equal()
        assert set(pair.port.mgr._state["hot"].alert_states["TempHigh"]) \
            == hot
        assert not pair.port.mgr._state["cold"].alert_states.get("TempHigh")

    def test_alert_deactivates_when_condition_clears(self):
        pair = alert_pair(for_ms=0)
        pair.ingest_temp([(i, 0.0) for i in range(30)])
        pair.tick()
        pair.ingest_temp([(i, 1.0) for i in range(30, 60)])
        pair.drain()
        assert pair.port.mgr.alerts_snapshot()
        pair.ingest_temp([(i, 0.0) for i in range(60, 120)])
        pair.drain()
        assert pair.port.mgr.alerts_snapshot() == []
        wm = pair.last_step("alerts")
        ref, port = pair.query('ALERTS{alertstate="firing"}',
                               FIRST_STEP // 1000, 60, wm // 1000)
        assert port.result.num_series == 1
        assert not np.isnan(np.asarray(port.result.values)).all()
        np.testing.assert_array_equal(np.asarray(port.result.values),
                                      np.asarray(ref.result.values))


# ---- restart -------------------------------------------------------------------


class TestRestartRecovery:
    def test_no_double_write_no_gap(self):
        pair, keys = build(30)
        pair.managers([rec_group()])
        pair.tick()
        pair.extend(keys, 180)
        pair.drain()
        wm = pair.last_step("heap")

        def cells():
            vals = np.asarray(pair.query("ns:heap:avg", FIRST_STEP // 1000,
                                         60, wm // 1000)[1].result.values)
            return int((~np.isnan(vals)).sum())

        before = cells()
        assert before > 0
        pair.managers([rec_group()])
        assert pair.tick() == 0
        assert pair.last_step("heap") == wm
        assert cells() == before
        vals = recorded_counts(pair, "ns:heap:avg", wm - 4 * GROUP_MS, wm)
        assert vals.size and np.all(vals[~np.isnan(vals)] == 1.0)


# ---- kill points ---------------------------------------------------------------


def two_rule_group():
    return RuleGroup(
        name="pair", interval_ms=GROUP_MS, dataset="timeseries",
        rules=(RecordingRule(record="ns:a", expr=HEAP_EXPR),
               RecordingRule(record="ns:b",
                             expr="max_over_time(heap_usage[3m])")))


class TestChaos:
    @pytest.fixture(autouse=True)
    def _clean(self):
        # the reference's lock-order checker over the whole matrix: the
        # retried paths of both managers never block under a checked lock
        # or take locks in conflicting orders
        RefFaults.reset()
        FaultInjector.reset()
        with lockcheck.session():
            yield
            vs = lockcheck.violations()
        RefFaults.reset()
        FaultInjector.reset()
        assert vs == [], [v.render() for v in vs]

    def test_kill_at_eval_holds_watermark(self):
        pair, keys = build(30)
        pair.managers([rec_group()])
        pair.tick()
        wm = pair.last_step("heap")
        pair.extend(keys, 90)
        f0 = mgr_mod.rules_eval_failures.value
        RefFaults.arm("rules.eval", error=ConnectionError, times=1)
        FaultInjector.arm("rules.eval", error=ConnectionError, times=1)
        assert pair.tick() == 0
        assert mgr_mod.rules_eval_failures.value == f0 + 1
        assert pair.last_step("heap") == wm
        assert pair.tick() > 0      # the same window, retried
        assert pair.last_step("heap") > wm
        pair.assert_states_equal()

    def test_kill_mid_group_write_then_retry_dedups(self):
        # the second rule's write fails: the first rule's outputs land, the
        # watermark does not; the retry writes the first rule's again (the
        # shards drop them at ts <= latest) and completes the second
        pair, keys = build(30)
        pair.managers([two_rule_group()])
        pair.tick()
        wm = pair.last_step("pair")
        pair.extend(keys, 90)
        only_b = {"match": lambda ctx: ctx.get("rule") == "ns:b"}
        RefFaults.arm("rules.write", error=ConnectionError, **only_b)
        FaultInjector.arm("rules.write", error=ConnectionError, **only_b)
        assert pair.tick() == 0
        assert pair.last_step("pair") == wm
        RefFaults.reset()
        FaultInjector.reset()
        pair.drain()
        wm2 = pair.last_step("pair")
        assert wm2 > wm
        for rec, expr in (("ns:a", HEAP_EXPR),
                          ("ns:b", "max_over_time(heap_usage[3m])")):
            assert_recorded(pair, rec, expr, wm + GROUP_MS, wm2)
            vals = recorded_counts(pair, rec, wm + GROUP_MS, wm2)
            assert vals.size and np.all(vals[~np.isnan(vals)] == 1.0), rec

    def test_kill_between_outputs_and_commit_record(self):
        pair, keys = build(30)
        pair.managers([rec_group()])
        pair.tick()
        pair.extend(keys, 90)
        wm = pair.last_step("heap")
        for side in pair.sides():
            orig = side.sink.write
            fired = {"n": 0}

            def flaky(cont, orig=orig, fired=fired):
                names = {r.part_key.label_map.get("_metric_")
                         for r in cont.records}
                if "FILODB_RULES_WATERMARK" in names and not fired["n"]:
                    fired["n"] = 1
                    raise ConnectionError("crash before commit record")
                return orig(cont)

            side.mgr.sink.write = flaky
        assert pair.tick() == 0
        assert pair.last_step("heap") == wm
        pair.managers([rec_group()])   # durable state only
        assert pair.drain() > 0
        wm2 = pair.last_step("heap")
        vals = recorded_counts(pair, "ns:heap:avg", wm + GROUP_MS, wm2)
        assert vals.size and np.all(vals[~np.isnan(vals)] == 1.0)
        assert not np.isnan(vals).any()


# ---- the governor --------------------------------------------------------------


@pytest.fixture
def governors():
    gov.reset()
    ref_gov.reset()
    yield
    gov.reset()
    ref_gov.reset()


class TestGovernorIntegration:
    def test_shed_under_pressure_then_catchup_no_gap(self, governors):
        pair, keys = build(30)
        pair.managers([rec_group()])
        pair.tick()
        wm = pair.last_step("heap")
        pair.extend(keys, 90)
        gov.governor().set_state(gov.DEGRADED)
        ref_gov.governor().set_state(ref_gov.DEGRADED)
        s0 = mgr_mod.rules_evals_shed.value
        assert pair.tick() == 0
        assert mgr_mod.rules_evals_shed.value == s0 + 1
        assert pair.last_step("heap") == wm
        assert "shed" in pair.port.mgr._state["heap"].last_error
        gov.governor().set_state(gov.OK)
        ref_gov.governor().set_state(ref_gov.OK)
        pair.drain()
        wm2 = pair.last_step("heap")
        assert wm2 > wm
        vals = recorded_counts(pair, "ns:heap:avg", wm + GROUP_MS, wm2)
        assert vals.size and not np.isnan(vals).any()

    def test_rules_cost_class_never_queues(self, governors):
        for g_mod in (gov, ref_gov):
            g = g_mod.ResourceGovernor(g_mod.GovernorConfig(
                rules_max_inflight=1))
            with g.admit(cost=g_mod.RULES):
                with pytest.raises(g_mod.QueryRejected) as ei:
                    with g.admit(cost=g_mod.RULES):
                        pass
                assert ei.value.reason == "rules"
                with g.admit(cost=g_mod.EXPENSIVE):
                    pass
            with g.admit(cost=g_mod.RULES):
                pass

    def test_rules_shed_when_capacity_contended(self, governors):
        for g_mod in (gov, ref_gov):
            g = g_mod.ResourceGovernor(g_mod.GovernorConfig(
                admission_capacity=1))
            with g.admit(cost=g_mod.EXPENSIVE):
                with pytest.raises(g_mod.QueryRejected) as ei:
                    with g.admit(cost=g_mod.RULES):
                        pass
                assert ei.value.reason == "rules"


class TestTenantQuota:
    def test_rule_outputs_respect_cardinality_quota(self, governors):
        from filodb_tpu.utils.metrics import get_counter as ref_counter
        from filodb_tpu_torch.utils.metrics import get_counter

        # quotas before the shards are made (applied at construction)
        for g_mod in (gov, ref_gov):
            g_mod.configure(tenants={"demo/App-0": {"max_series": 10}})
        pair = Pair(1, spread=0)
        pair.ingest_stream(gauge_stream(
            machine_metrics_series(8, ns="App-0"), 60, start_ms=START * 1000,
            interval_ms=INTERVAL, seed=11))
        pair.managers([rec_group()])
        shard = pair.port.ms.shards[0]
        ref_shard = pair.ref.ms.shards_for("timeseries")[0]
        d0, r0 = (shard.stats.quota_dropped.value,
                  ref_shard.stats.quota_dropped.value)
        t0 = get_counter("filodb_tenant_ingest_dropped",
                         {"tenant": "demo/App-0"}).value
        pair.drain()
        # 8 sources fit the quota of 10; the 8 outputs do not
        dropped = shard.stats.quota_dropped.value - d0
        assert dropped > 0
        assert dropped == ref_shard.stats.quota_dropped.value - r0
        assert get_counter("filodb_tenant_ingest_dropped",
                           {"tenant": "demo/App-0"}).value - t0 == dropped
        assert ref_counter("filodb_tenant_ingest_dropped",
                           {"tenant": "demo/App-0"}).value > 0
        assert shard.cardinality.cardinality(["demo", "App-0"]).active_ts \
            == 10 == ref_shard.cardinality.cardinality(
                ["demo", "App-0"]).active_ts


# ---- the response cache --------------------------------------------------------


class TestResponseCacheIntegration:
    def test_rule_writes_bump_service_version(self):
        from filodb_tpu_torch.http.server import service_version

        pair, _ = build(60)
        v0 = service_version(pair.port.svc)
        pair.managers([rec_group()])
        assert pair.drain() > 0
        assert service_version(pair.port.svc) > v0

    def test_serial_zero_is_not_id_fallback(self):
        from filodb_tpu.http.server import response_cache_key as ref_key
        from filodb_tpu_torch.http.server import response_cache_key

        class Svc:
            serial = 0

        key = response_cache_key(Svc(), "range", ("q", 1, 2, 3))
        assert key[0] == 0 == ref_key(Svc(), "range", ("q", 1, 2, 3))[0]


# ---- a node with a rules block -------------------------------------------------


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        assert r.status == 200
        return json.load(r)


class TestStandaloneE2E:
    """Both packages' nodes over one config with a ``rules`` block, fed the
    same lines: the outputs ride the logs (``LogSink``) and come back as
    series, and both serve the groups and the alerts over HTTP."""

    CONF = {
        "node_name": "rules-node",
        "rules": {
            "tick_s": 0.2,
            "groups": [{
                "name": "std", "interval": "60s",
                "rules": [
                    {"record": "job:scrape:sum",
                     "expr": "sum(scrape_metric)"},
                    {"alert": "ScrapeAlive", "expr": "avg(scrape_metric) > -1",
                     "annotations": {"summary": "scrape data flows"}},
                ]}]},
        "datasets": {"timeseries": {
            "num_shards": 2, "spread": 1,
            "store": {"max_chunk_size": 50, "groups_per_shard": 2}}},
    }

    @pytest.fixture
    def servers(self, tmp_path):
        from filodb_tpu.config import ServerConfig as RefServerConfig
        from filodb_tpu.standalone import FiloServer as RefServer
        from filodb_tpu_torch.testing.from_jax import server_pair

        with server_pair(self.CONF, str(tmp_path),
                         (RefServer, RefServerConfig)) as both:
            yield both

    @staticmethod
    def _feed(srv) -> None:
        lines = "".join(f"scrape_metric,host=h{i % 5},_ws_=demo,"
                        f"_ns_=App-0 value={i} "
                        f"{(START + i * 10) * 1_000_000_000}\n"
                        for i in range(150))
        with socket.create_connection(("127.0.0.1", srv.gateway.port)) as s:
            s.sendall(lines.encode())

    @staticmethod
    def _settled(srv, deadline: float) -> dict:
        """The group's payload once its watermark has reached the end of
        the data (the last whole step 300 s behind the newest sample)."""
        last = ((START + 149 * 10) * 1000 - 300_000) // GROUP_MS * GROUP_MS
        doc = None
        while time.monotonic() < deadline:
            srv.gateway.sink.flush()
            doc = _get(srv.http.port, "/api/v1/rules")
            groups = doc["data"]["groups"]
            if groups and groups[0]["watermark"] == last:
                return groups[0]
            time.sleep(0.2)
        raise AssertionError(f"the group never reached {last}: {doc}")

    def test_rules_evaluate_and_surface_over_http(self, servers, capsys):
        ref, port = servers
        for srv in servers:
            self._feed(srv)
        deadline = time.monotonic() + 60
        g_ref, g = self._settled(ref, deadline), self._settled(port, deadline)
        assert g["name"] == "std" and g["watermark"] == g_ref["watermark"]
        assert {r["name"]: r["type"] for r in g["rules"]} == \
            {"job:scrape:sum": "recording", "ScrapeAlive": "alerting"}
        assert all(r["health"] == "ok" for r in g["rules"])
        volatile = ("evaluationTime", "lastEvaluation", "alerts")
        assert [{k: v for k, v in r.items() if k not in volatile}
                for r in g["rules"]] == \
            [{k: v for k, v in r.items() if k not in volatile}
             for r in g_ref["rules"]]
        ds = _get(port.http.port, "/promql/timeseries/api/v1/rules")
        assert ds["data"]["groups"][0]["name"] == "std"

        # the recorded output, a series like any other, over HTTP: the
        # steps both nodes evaluated hold the same sums
        wm = g["watermark"] // 1000
        path = (f"/promql/timeseries/api/v1/query_range?query=job:scrape:sum"
                f"&start={wm - 300}&end={wm}&step=60")
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            got = _get(port.http.port, path)["data"]["result"]
            if got and got[0]["values"]:
                break
            time.sleep(0.2)
        want = dict(_get(ref.http.port, path)["data"]["result"][0]["values"])
        assert got and got[0]["values"]
        for t, v in got[0]["values"]:
            if t in want:
                assert float(v) == pytest.approx(float(want[t]), rel=RTOL)

        alerts = _get(port.http.port, "/api/v1/alerts")["data"]["alerts"]
        assert [a for a in alerts if a["state"] == "firing"
                and a["labels"]["alertname"] == "ScrapeAlive"], alerts
        assert alerts[0]["annotations"] == {"summary": "scrape data flows"}
        ref_alerts = _get(ref.http.port, "/api/v1/alerts")["data"]["alerts"]
        assert [(a["labels"], a["state"]) for a in alerts] == \
            [(a["labels"], a["state"]) for a in ref_alerts]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port.http.port}/metrics") as r:
            text = r.read().decode()
        assert "filodb_rules_evals_total" in text
        assert "filodb_alerts_firing" in text

        # the reference's operator CLI renders the port's groups and alerts
        from filodb_tpu.cli import main as cli_main

        cli_main(["--host", f"127.0.0.1:{port.http.port}", "rules"])
        out = capsys.readouterr().out
        assert "group std" in out and "job:scrape:sum" in out
        assert "ScrapeAlive" in out and "firing" in out

    def test_threaded_front_accepts_rule_managers(self):
        from filodb_tpu_torch.http.server import FiloHttpServer

        srv = FiloHttpServer({}, port=0, rule_managers={}).start()
        try:
            assert _get(srv.port, "/api/v1/rules") == \
                {"status": "success", "data": {"groups": []}}
            assert _get(srv.port, "/api/v1/alerts") == \
                {"status": "success", "data": {"alerts": []}}
        finally:
            srv.stop()


# ---- the rule model ------------------------------------------------------------


class TestModelValidation:
    def test_load_groups_happy_path(self):
        block = {"groups": [
            {"name": "g1", "interval": "2m", "rules": [
                {"record": "job:x:avg", "expr": "avg(x)",
                 "labels": {"team": "core"}},
                {"alert": "XHigh", "expr": "avg(x) > 1", "for": "5m",
                 "annotations": {"summary": "x too high"}},
            ]}]}
        groups = load_groups(block, "timeseries")
        assert [_ref_group(g) for g in groups] == \
            ref_load_groups(block, "timeseries")
        g = groups[0]
        assert g.interval_ms == 120_000 and g.dataset == "timeseries"
        rec, al = g.rules
        assert isinstance(rec, RecordingRule)
        assert dict(rec.labels) == {"team": "core"}
        assert isinstance(al, AlertingRule) and al.for_ms == 300_000

    @pytest.mark.parametrize("block", [
        {"groups": [{"name": "g", "rules": [{"expr": "x"}]}]},
        {"groups": [{"name": "g", "rules": [
            {"record": "a", "alert": "b", "expr": "x"}]}]},
        {"groups": [{"name": "g", "rules": [
            {"record": "1bad", "expr": "x"}]}]},
        {"groups": [{"name": "g", "rules": [
            {"record": "a::b", "expr": "x"}]}]},
        {"groups": [{"name": "g", "rules": [
            {"record": "ALERTS", "expr": "x"}]}]},
        {"groups": [{"name": "g", "rules": [
            {"record": "a", "expr": "x", "for": "5m"}]}]},
        {"groups": [{"name": "g", "rules": [
            {"alert": "A", "expr": "x", "labels": {"alertstate": "no"}}]}]},
        {"groups": [{"name": "g", "rules": [
            {"alert": "A", "expr": "x", "labels": {"_group_": "no"}}]}]},
        {"groups": [{"name": 'g"x', "rules": []}]},
        {"groups": [{"name": "g", "rules": [
            {"alert": 'A{bad="l"}', "expr": "x"}]}]},
        {"groups": [{"name": "g", "interval": "500ms", "rules": []}]},
        {"groups": [{"name": "g", "rules": []}, {"name": "g", "rules": []}]},
        {"groups": [{"name": "g", "rules": [
            {"record": "a", "expr": "x"}, {"record": "a", "expr": "y"}]}]},
    ])
    def test_load_groups_rejects(self, block):
        with pytest.raises(ValueError) as port_err:
            load_groups(block, "timeseries")
        with pytest.raises(ValueError) as ref_err:
            ref_load_groups(block, "timeseries")
        assert str(port_err.value) == str(ref_err.value)
