"""A query's deadline, retries, circuit breakers, the resilience config
and fault injection.

Port of ``filodb_tpu/utils/resilience.py``:

- :class:`Deadline` — one a query (``QueryService``), carried on the exec
  engine's ``ExecContext`` and handed to the mesh engine; leaves, gathers
  and batches check it at their boundaries (never a kernel) and raise
  :class:`DeadlineExceeded`, which both HTTP fronts answer 503 ``timeout``.
- :class:`ResilienceConfig` with ``config``/``configure``: the node reads
  ``query_timeout_s``, the framed transport its retry and breaker keys.
  The keys that only partial scatter-gather reads belong to remote plan
  dispatch (ROADMAP A7): ``configure`` raises ``NotImplementedError``
  naming it where one of them is set away from its default.
- :class:`RetryPolicy` and ``default_retry_policy``: exponential backoff
  with jitter under a sleep budget (the object store's uploads and reads,
  the framed transport's round trips).
- :class:`CircuitBreaker`, one a peer (``breaker_for``): closed, open,
  half-open; ``calling`` admits one call and records exactly one outcome
  for it, whatever thread makes it. ``record_peer_latency`` keeps each
  peer's EWMA round trip.
- :class:`FaultInjector` — named fault sites that tests arm (the shard's
  ``shard.ingest``, the object store's ``objectstore.put``).
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from filodb_tpu_torch.utils.metrics import Gauge, get_counter


class DeadlineExceeded(TimeoutError):
    """The query's deadline expired (the reference's query timeout)."""


class CircuitOpenError(ConnectionError):
    """The peer's circuit breaker is open: the call was skipped without
    dialing. A ``ConnectionError``, so a skipped peer is handled as a lost
    one."""


class RemoteQueryError(RuntimeError):
    """A remote endpoint answered with an error (tagged with the endpoint,
    not a raw transport traceback)."""


@dataclass
class Deadline:
    """An absolute per-query deadline on an injectable monotonic clock."""

    deadline_s: float  # absolute instant on ``clock``
    clock: "callable" = time.monotonic

    @classmethod
    def after(cls, timeout_s: float, clock=time.monotonic) -> "Deadline":
        return cls(clock() + timeout_s, clock)

    def remaining(self) -> float:
        return self.deadline_s - self.clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def timeout(self, cap: float | None = None, what: str = "") -> float:
        """Remaining seconds, optionally capped; raises
        :class:`DeadlineExceeded` when nothing remains."""
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExceeded(
                f"query deadline exceeded{' before ' + what if what else ''}"
                f" ({-rem:.3f}s past)")
        return min(rem, cap) if cap is not None else rem

    def check(self, what: str = "") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"query deadline exceeded{' in ' + what if what else ''}")


def check(deadline: "Deadline | None", what: str) -> None:
    """``deadline.check(what)`` where a deadline is given."""
    if deadline is not None:
        deadline.check(what)


_retries_total = get_counter("filodb_query_retries")


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter under a total-sleep budget.
    ``sleep`` and ``rng`` are injectable, so tests never wait on the
    clock."""

    max_attempts: int = 3
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5          # fraction of the backoff randomized
    budget_s: float | None = None  # cap on total sleep across attempts
    sleep: "callable" = time.sleep
    rng: "callable" = random.random

    def backoff(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = min(self.base_backoff_s * (self.multiplier ** (attempt - 1)),
                  self.max_backoff_s)
        return raw * (1.0 - self.jitter + self.jitter * self.rng())

    def call(self, fn, retry_on: tuple = (ConnectionError, OSError),
             deadline: Deadline | None = None, on_retry=None, site: str = ""):
        """Run ``fn`` with retries; they stop when the attempts or the
        sleep budget run out, or when the deadline cannot cover the next
        backoff."""
        slept = 0.0
        attempt = 1
        while True:
            try:
                return fn()
            except retry_on as e:
                if isinstance(e, (CircuitOpenError, DeadlineExceeded)):
                    raise  # never retry a skip or a timeout
                delay = self.backoff(attempt)
                if attempt >= self.max_attempts \
                        or (self.budget_s is not None
                            and slept + delay > self.budget_s) \
                        or (deadline is not None
                            and deadline.remaining() <= delay):
                    raise
                _retries_total.inc()
                if on_retry is not None:
                    on_retry(attempt, e)
                self.sleep(delay)
                slept += delay
                attempt += 1


CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """A peer's closed / open / half-open breaker.

    Closed: calls flow; ``failure_threshold`` failures in a row open it.
    Open: calls are skipped (:class:`CircuitOpenError`) until
    ``reset_timeout_s`` has passed, then one probe is admitted (half-open).
    Half-open: the probe's success closes the breaker, its failure opens
    it again for another ``reset_timeout_s``.
    """

    def __init__(self, key: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 10.0, clock=time.monotonic):
        self.key = key
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False
        self._gauge = Gauge("filodb_breaker_state", {"peer": key})

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state_locked()

    def _effective_state_locked(self) -> str:
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.reset_timeout_s:
            self._state = HALF_OPEN
            self._probing = False
            self._gauge.set(_STATE_VALUE[HALF_OPEN])
        return self._state

    @property
    def is_open(self) -> bool:
        return self.state == OPEN

    def allow(self) -> bool:
        """Whether a call may go now; half-open admits one probe until it
        reports back."""
        with self._lock:
            st = self._effective_state_locked()
            if st == CLOSED:
                return True
            if st == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def guard(self) -> None:
        if not self.allow():
            raise CircuitOpenError(
                f"circuit breaker open for peer {self.key}")

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._state = CLOSED
                self._gauge.set(_STATE_VALUE[CLOSED])

    def force_open(self) -> None:
        """Open now (a failure detector declared the peer down)."""
        with self._lock:
            self._state = OPEN
            self._opened_at = self.clock()
            self._probing = False
            self._gauge.set(_STATE_VALUE[OPEN])

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN \
                    or self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = self.clock()
                self._gauge.set(_STATE_VALUE[OPEN])

    def cancel_probe(self) -> None:
        """The admitted call gave no verdict on the transport (its deadline
        ran out before it dialed): free the half-open probe slot, or the
        breaker would stay half-open for good."""
        with self._lock:
            self._probing = False

    @contextmanager
    def calling(self, transport_errors: tuple = (ConnectionError, OSError)):
        """Admit one call (``guard``) and record exactly one outcome on
        every way out: success on a clean exit, failure on a
        ``transport_errors`` exception (not on :class:`CircuitOpenError`
        or :class:`DeadlineExceeded`, which say nothing of the peer), and
        a released probe on any other. The yielded handle lets the body
        record an outcome first; the first recorded wins."""
        self.guard()
        outcome = _BreakerOutcome(self)
        try:
            yield outcome
        except transport_errors as e:
            if not isinstance(e, (CircuitOpenError, DeadlineExceeded)):
                outcome.failure()
            raise
        else:
            outcome.success()
        finally:
            outcome.release()


class _BreakerOutcome:
    """The one-shot outcome of a call admitted by ``calling``."""

    def __init__(self, breaker: CircuitBreaker):
        self._breaker = breaker
        self._done = False

    def success(self) -> None:
        if not self._done:
            self._done = True
            self._breaker.record_success()

    def failure(self) -> None:
        if not self._done:
            self._done = True
            self._breaker.record_failure()

    def release(self) -> None:
        if not self._done:
            self._done = True
            self._breaker.cancel_probe()


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(key: str, **defaults) -> CircuitBreaker:
    """The process's breaker of a peer (one a peer, shared by every client
    that talks to it), made from the config's breaker keys."""
    with _breakers_lock:
        b = _breakers.get(key)
        if b is None:
            cfg = dict(config().breaker_defaults)
            cfg.update(defaults)
            b = _breakers[key] = CircuitBreaker(key, **cfg)
        return b


def reset_breakers() -> None:
    """Drop every breaker's state (tests)."""
    with _breakers_lock:
        _breakers.clear()


_peer_latency: dict[str, float] = {}
_peer_latency_lock = threading.Lock()
PEER_LATENCY_ALPHA = 0.3  # weight of the newest sample


def record_peer_latency(key: str, seconds: float) -> None:
    """Fold one round trip into the peer's EWMA (keys as the breakers')."""
    with _peer_latency_lock:
        prev = _peer_latency.get(key)
        _peer_latency[key] = seconds if prev is None else \
            prev + PEER_LATENCY_ALPHA * (seconds - prev)


def peer_latency(key: str) -> float | None:
    """The peer's EWMA round trip; None before any."""
    with _peer_latency_lock:
        return _peer_latency.get(key)


def reset_peer_latency() -> None:
    """Drop every estimate (tests)."""
    with _peer_latency_lock:
        _peer_latency.clear()


@dataclass
class ResilienceConfig:
    query_timeout_s: float = 30.0
    retry_max_attempts: int = 2        # one retry on a fresh socket
    retry_base_backoff_s: float = 0.02
    retry_max_backoff_s: float = 1.0
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 10.0
    partial_max_fraction: float = 0.5  # children a gather may lose
    allow_partial: bool = True

    @property
    def breaker_defaults(self) -> dict:
        return {"failure_threshold": self.breaker_failure_threshold,
                "reset_timeout_s": self.breaker_reset_s}


# keys that only partial scatter-gather reads: not ported
_REMOTE_ONLY = ("partial_max_fraction", "allow_partial")
_REMOTE_WHY = "remote plan dispatch and its partial scatter-gather " \
    "(ROADMAP A7)"

_config = ResilienceConfig()


def config() -> ResilienceConfig:
    return _config


def check_supported(block: dict) -> None:
    """Raise ``NotImplementedError`` where ``block`` sets a key that only
    remote plan dispatch reads away from its default (ROADMAP A7)."""
    defaults = ResilienceConfig()
    for k in _REMOTE_ONLY:
        if k in block and block[k] != getattr(defaults, k):
            raise NotImplementedError(f"resilience.{k}={block[k]!r}: "
                                      f"{_REMOTE_WHY}")


def configure(**kw) -> ResilienceConfig:
    """Apply the ``resilience`` block (``check_supported`` first)."""
    check_supported(kw)
    for k, v in kw.items():
        if hasattr(_config, k):
            setattr(_config, k, v)
    return _config


def default_retry_policy(**kw) -> RetryPolicy:
    """A policy from the config's retry keys, ``kw`` overriding them."""
    c = _config
    base = dict(max_attempts=c.retry_max_attempts,
                base_backoff_s=c.retry_base_backoff_s,
                max_backoff_s=c.retry_max_backoff_s)
    base.update(kw)
    return RetryPolicy(**base)


def reset() -> None:
    """The default config (tests)."""
    _config.__dict__.update(ResilienceConfig().__dict__)


@dataclass
class Fault:
    """One armed fault: raise ``error`` and/or delay, ``times`` times, at a
    named site, where ``match`` (over the site's context) allows."""

    error: "BaseException | type | None" = None
    delay_s: float = 0.0
    times: int | None = None      # None = unlimited
    match: "callable | None" = None
    sleep: "callable" = time.sleep
    fired: int = 0

    def _applies(self, ctx: dict) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        return self.match is None or bool(self.match(ctx))


class FaultInjector:
    """Process-global registry of named fault sites. The port fires
    ``shard.ingest`` (ctx: dataset, shard, offset) before a container is
    ingested, ``objectstore.put`` (ctx: key) before an object-store
    upload, ``remote.connect`` (ctx: host, port) before a framed dial and
    ``meshproc.exec`` (ctx: host, port) before a mesh worker's call; a
    site that nothing armed costs one dict test."""

    _faults: dict[str, list[Fault]] = {}
    _lock = threading.Lock()

    @classmethod
    def arm(cls, site: str, error=None, delay_s: float = 0.0,
            times: int | None = None, match=None,
            sleep=time.sleep) -> Fault:
        f = Fault(error=error, delay_s=delay_s, times=times, match=match,
                  sleep=sleep)
        with cls._lock:
            cls._faults.setdefault(site, []).append(f)
        return f

    @classmethod
    def fire(cls, site: str, **ctx) -> None:
        if not cls._faults:  # nothing armed anywhere
            return
        with cls._lock:
            faults = list(cls._faults.get(site, ()))
        for f in faults:
            if not f._applies(ctx):
                continue
            f.fired += 1
            if f.delay_s:
                f.sleep(f.delay_s)
            if f.error is not None:
                err = f.error
                if isinstance(err, type):
                    err = err(f"fault injected at {site}")
                raise err

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._faults.clear()

    @classmethod
    def armed(cls) -> bool:
        return bool(cls._faults)
