"""Alert notification egress: webhook POST on alert state transitions.

The RuleManager's group commit produces :class:`AlertEvent` records
(pending / firing / resolved). :class:`WebhookNotifier` ships them to an
Alertmanager-style webhook — asynchronously, through a bounded queue and
a single daemon worker, so the hand-off from the evaluation thread is a
non-blocking ``put_nowait``. The blocking POST (plus
:class:`~filodb_tpu_torch.utils.resilience.RetryPolicy` backoff) happens
only on the worker thread, never under the manager's state or eval lock.

Delivery semantics: at-most-once. A full queue drops the batch and
counts ``filodb_alerts_notifications_dropped_total`` (alerts state
itself is durable in the alert series; notifications are a best-effort
side channel, the reference's Alertmanager-push posture). Exhausted
retries count ``filodb_alerts_notification_failures_total``.

Copy of ``filodb_tpu/rules/notify.py``: the same bodies byte for byte
(``json.dumps`` of the same payloads) and the ``rules.notify`` fault site
before each POST.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import urllib.request
from dataclasses import dataclass

from filodb_tpu_torch.utils.metrics import Counter
from filodb_tpu_torch.utils.resilience import FaultInjector, RetryPolicy

log = logging.getLogger("filodb.rules.notify")

notifications_sent = Counter("filodb_alerts_notifications")
notification_failures = Counter("filodb_alerts_notification_failures")
notifications_dropped = Counter("filodb_alerts_notifications_dropped")

PENDING, FIRING, RESOLVED = "pending", "firing", "resolved"


@dataclass(frozen=True)
class AlertEvent:
    """One alert state transition, as committed by a group tick."""

    group: str
    alertname: str
    state: str                    # pending | firing | resolved
    labels: tuple                 # sorted ((k, v), ...) incl. alertname
    annotations: tuple            # ((k, v), ...) from the rule
    value: float                  # rule value at the transition step
    active_since_ms: int          # when the alert became active
    ts_ms: int                    # evaluation step of the transition

    def payload(self) -> dict:
        """Alertmanager-webhook-style single-alert body."""
        return {
            "status": ("resolved" if self.state == RESOLVED
                       else "firing"),
            "labels": dict(self.labels),
            "annotations": dict(self.annotations),
            "startsAt": self.active_since_ms / 1000.0,
            "value": self.value,
            "state": self.state,
            "group": self.group,
            "evaluatedAt": self.ts_ms / 1000.0,
        }


@dataclass
class _Batch:
    events: list


class WebhookNotifier:
    """Bounded-queue webhook shipper with retrying daemon worker.

    ``post`` is injectable for tests (defaults to a urllib POST with
    ``timeout_s``); the retry policy's ``sleep`` is injectable through
    :class:`RetryPolicy` itself, so no test waits on the wall clock.
    """

    def __init__(self, url: str, timeout_s: float = 5.0,
                 retry_policy: RetryPolicy | None = None,
                 queue_depth: int = 256, post=None):
        self.url = url
        self.timeout_s = timeout_s
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=4, base_backoff_s=0.1, max_backoff_s=2.0)
        self._post = post or self._http_post
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run,
                                        name="alert-notifier",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------- producer
    def submit(self, events: list[AlertEvent]) -> bool:
        """Enqueue a transition batch. NON-BLOCKING by contract: the
        caller is the rules evaluation thread and must never wait on
        notification egress. Returns False (and counts drops) when the
        queue is full."""
        if not events:
            return True
        try:
            self._q.put_nowait(_Batch(list(events)))
            return True
        except queue.Full:
            notifications_dropped.inc(len(events))
            log.warning("alert notifier queue full; dropped %d "
                        "event(s)", len(events))
            return False

    # -------------------------------------------------------- worker
    def _http_post(self, body: bytes) -> None:
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            if r.status >= 300:
                raise ConnectionError(
                    f"webhook returned HTTP {r.status}")

    def _ship(self, batch: _Batch) -> None:
        body = json.dumps({
            "version": "4",
            "alerts": [e.payload() for e in batch.events],
        }).encode()
        FaultInjector.fire("rules.notify", url=self.url,
                           count=len(batch.events))
        self.retry_policy.call(
            lambda: self._post(body),
            retry_on=(ConnectionError, OSError, TimeoutError),
            site="rules.notify")
        notifications_sent.inc(len(batch.events))

    def _run(self) -> None:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            try:
                self._ship(batch)
            except Exception:
                notification_failures.inc(len(batch.events))
                log.warning("alert notification delivery failed "
                            "(%d event(s))", len(batch.events),
                            exc_info=True)
            finally:
                self._q.task_done()

    def close(self, timeout_s: float = 2.0) -> None:
        """Stop the worker after draining what's already queued."""
        self._q.put(None)
        self._worker.join(timeout=timeout_s)


def events_from_transitions(group: str, rule_annotations: tuple,
                            changes: list) -> list[AlertEvent]:
    """Build events from ``(labels_key, state, value, active_since, ts)``
    tuples staged by the alert state machine."""
    return [AlertEvent(group=group,
                       alertname=dict(k).get("alertname", ""),
                       state=state, labels=k,
                       annotations=rule_annotations,
                       value=value, active_since_ms=since, ts_ms=ts)
            for k, state, value, since, ts in changes]
