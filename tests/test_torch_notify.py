"""Port parity for the alert notifier (``filodb_tpu_torch/rules/notify.py``).

The cases of ``tests/test_notify.py``, run on both packages: the same
events through the reference's ``WebhookNotifier`` and the port's POST
the same bodies, byte for byte; retries, failures, the bounded queue's
drops and the ``rules.notify`` fault site count alike; and wired into
each package's ``RuleManager`` (``test_torch_rules.Pair``) the alert
lifecycle notifies the same transitions once, never a discarded stage.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

from filodb_tpu.rules import WebhookNotifier as RefNotifier
from filodb_tpu.rules import notify as ref_notify
from filodb_tpu.utils.resilience import FaultInjector as RefFaults
from filodb_tpu.utils.resilience import RetryPolicy as RefRetry
from filodb_tpu_torch.rules import AlertingRule, RuleGroup, WebhookNotifier
from filodb_tpu_torch.rules import notify
from filodb_tpu_torch.utils.resilience import FaultInjector, RetryPolicy

from test_torch_rules import GROUP_MS, Pair

# each side: its notifier class, retry policy, notify module, faults
SIDES = {"ref": (RefNotifier, RefRetry, ref_notify, RefFaults),
         "port": (WebhookNotifier, RetryPolicy, notify, FaultInjector)}


def make_notifier(side: str, post, max_attempts: int = 2, **kw):
    cls, policy, _, _ = SIDES[side]
    kw.setdefault("retry_policy", policy(
        max_attempts=max_attempts, base_backoff_s=0.0, max_backoff_s=0.0,
        sleep=lambda s: None))
    return cls("http://127.0.0.1:9/hook", post=post, **kw)


def wait_for(pred, timeout_s: float = 5.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached in time")


def sample_events(side: str):
    key = (("alertname", "TempHigh"), ("host", "h1"))
    return SIDES[side][2].events_from_transitions(
        "alerts", (("summary", "too hot"),),
        [(key, notify.PENDING, 0.9, 1000, 1000),
         (key, notify.FIRING, 1.2, 1000, 61000)])


def bodies(events_of) -> dict:
    """{side: [posted bodies]} of each side's notifier fed
    ``events_of(side)`` and closed."""
    out = {}
    for side in SIDES:
        posts = []
        n = make_notifier(side, posts.append)
        assert n.submit(events_of(side))
        n.close()
        out[side] = posts
    return out


class TestWebhookNotifier:
    def test_posts_alertmanager_style_batch(self):
        got = bodies(sample_events)
        assert got["port"] == got["ref"] and len(got["port"]) == 1
        body = json.loads(got["port"][0])
        assert body["version"] == "4" and len(body["alerts"]) == 2
        pend, fire = body["alerts"]
        assert pend["state"] == "pending" and pend["status"] == "firing"
        assert fire["state"] == "firing"
        assert pend["labels"] == {"alertname": "TempHigh", "host": "h1"}
        assert pend["annotations"] == {"summary": "too hot"}
        assert fire["startsAt"] == 1.0 and fire["evaluatedAt"] == 61.0

    def test_resolved_maps_to_resolved_status(self):
        key = (("alertname", "TempHigh"),)
        got = bodies(lambda side: SIDES[side][2].events_from_transitions(
            "alerts", (), [(key, notify.RESOLVED, 1.2, 1000, 121000)]))
        assert got["port"] == got["ref"]
        assert json.loads(got["port"][0])["alerts"][0]["status"] \
            == "resolved"

    def test_retry_then_success(self):
        for side, (_, _, mod, _) in SIDES.items():
            calls = []

            def flaky(body, calls=calls):
                calls.append(body)
                if len(calls) == 1:
                    raise ConnectionError("transient")

            before = mod.notifications_sent.value
            n = make_notifier(side, flaky, max_attempts=3)
            n.submit(sample_events(side))
            n.close()
            assert len(calls) == 2 and calls[0] == calls[1]
            assert mod.notifications_sent.value == before + 2, side

    def test_exhausted_retries_count_failures(self):
        def down(body):
            raise ConnectionError("refused")

        for side, (_, _, mod, _) in SIDES.items():
            before = mod.notification_failures.value
            n = make_notifier(side, down)
            n.submit(sample_events(side))
            n.close()
            assert mod.notification_failures.value == before + 2, side

    def test_full_queue_drops_and_counts(self):
        for side, (_, _, mod, _) in SIDES.items():
            release = threading.Event()
            before = mod.notifications_dropped.value
            n = make_notifier(side, lambda b, r=release: r.wait(5.0),
                              queue_depth=1)
            evs = sample_events(side)
            n.submit(evs)                    # the worker takes it, blocks
            wait_for(lambda: n._q.empty())
            assert n.submit(evs)             # fills the queue
            assert not n.submit(evs)         # bounded: dropped, not blocked
            assert mod.notifications_dropped.value == before + 2, side
            release.set()
            n.close()

    def test_submit_empty_is_noop(self):
        for side in SIDES:
            n = make_notifier(side, lambda b: pytest.fail("no POST"))
            assert n.submit([])
            n.close()

    def test_fault_injection_site(self):
        for side, (_, _, mod, faults) in SIDES.items():
            before = mod.notification_failures.value
            n = make_notifier(side, lambda b: None)
            try:
                faults.arm("rules.notify", error=ConnectionError, times=1)
                n.submit(sample_events(side))
                n.close()
            finally:
                faults.reset()
            # fired before the retry loop: the whole batch fails
            assert mod.notification_failures.value == before + 2, side


class TestManagerIntegration:
    def make(self, for_ms: int = 0):
        """A 1-shard ``Pair`` whose managers notify into a list a side."""
        posts = {"ref": [], "port": []}
        pair = Pair(1, spread=0)
        g = RuleGroup(
            name="alerts", interval_ms=GROUP_MS, dataset="timeseries",
            rules=(AlertingRule(alert="TempHigh", expr="avg(temp) > 0.5",
                                for_ms=for_ms,
                                annotations=(("summary", "too hot"),)),))
        pair.managers([g])
        for side, ns in (("ref", pair.ref), ("port", pair.port)):
            ns.mgr._notifier = make_notifier(side, posts[side].append)
        return pair, posts

    @staticmethod
    def states(posts: list) -> list:
        return [a["state"] for body in posts
                for a in json.loads(body)["alerts"]]

    def test_lifecycle_notifies_pending_firing_resolved(self):
        pair, posts = self.make(for_ms=120_000)
        pair.ingest_temp([(i, 0.0) for i in range(60)])
        pair.tick()
        pair.ingest_temp([(i, 1.0) for i in range(60, 120)])
        pair.drain()
        pair.ingest_temp([(i, 0.0) for i in range(120, 180)])
        pair.drain()
        for ns in (pair.ref, pair.port):
            ns.mgr.stop()            # closes the notifier, drains its queue
        assert posts["port"] == posts["ref"]
        assert self.states(posts["port"]) == ["pending", "firing",
                                              "resolved"]
        al = json.loads(posts["port"][0])["alerts"][0]
        assert al["labels"]["alertname"] == "TempHigh"
        assert al["annotations"] == {"summary": "too hot"}

    def test_discarded_stage_does_not_notify(self):
        pair, posts = self.make()
        pair.ingest_temp([(i, 0.0) for i in range(30)])
        pair.tick()
        pair.ingest_temp([(i, 1.0) for i in range(30, 90)])
        try:
            for _, _, _, faults in SIDES.values():
                faults.arm("rules.write", error=ConnectionError, times=1)
            assert pair.tick() == 0
        finally:
            for _, _, _, faults in SIDES.values():
                faults.reset()
        pair.drain()
        for ns in (pair.ref, pair.port):
            ns.mgr.stop()
        assert posts["port"] == posts["ref"]
        # for: 0 → pending and firing commit in one evaluation
        assert self.states(posts["port"]) == ["pending", "firing"]

    def test_no_notifier_is_fine(self):
        pair = Pair(1, spread=0)
        pair.managers([RuleGroup(
            name="alerts", interval_ms=GROUP_MS, dataset="timeseries",
            rules=(AlertingRule(alert="TempHigh", expr="avg(temp) > 0.5",
                                for_ms=0),))])
        pair.ingest_temp([(i, 1.0) for i in range(60)])
        pair.drain()
        pair.port.mgr.stop()
        pair.ref.mgr.stop()
        assert pair.port.mgr.alerts_snapshot()
