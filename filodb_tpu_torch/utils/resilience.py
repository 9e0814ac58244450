"""A query's deadline, the resilience config and fault injection.

Port of the single-node part of ``filodb_tpu/utils/resilience.py``:

- :class:`Deadline` — one a query (``QueryService``), carried on the exec
  engine's ``ExecContext`` and handed to the mesh engine; leaves, gathers
  and batches check it at their boundaries (never a kernel) and raise
  :class:`DeadlineExceeded`, which both HTTP fronts answer 503 ``timeout``.
- :class:`ResilienceConfig` with ``config``/``configure``: the node reads
  ``query_timeout_s``. The keys that only the circuit breakers, the retry
  policy and partial scatter-gather read belong to remote dispatch
  (ROADMAP A7): ``configure`` raises ``NotImplementedError`` naming it
  where one of them is set away from its default.
- :class:`RetryPolicy` and ``default_retry_policy``: exponential backoff
  with jitter under a sleep budget (the object store's uploads and reads).
- :class:`FaultInjector` — named fault sites that tests arm (the shard's
  ``shard.ingest``, the object store's ``objectstore.put``).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, fields

from filodb_tpu_torch.utils.metrics import get_counter


class DeadlineExceeded(TimeoutError):
    """The query's deadline expired (the reference's query timeout)."""


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
                if isinstance(e, DeadlineExceeded):
                    raise  # never retry a timeout
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


@dataclass
class ResilienceConfig:
    query_timeout_s: float = 30.0
    retry_max_attempts: int = 2
    retry_base_backoff_s: float = 0.02
    retry_max_backoff_s: float = 1.0
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 10.0
    partial_max_fraction: float = 0.5
    allow_partial: bool = True


# keys that only remote dispatch reads (breakers, retries, partial
# scatter-gather): not ported
_REMOTE_ONLY = tuple(f.name for f in fields(ResilienceConfig)
                     if f.name != "query_timeout_s")
_REMOTE_WHY = "remote dispatch, its circuit breakers and retries (ROADMAP A7)"

_config = ResilienceConfig()


def config() -> ResilienceConfig:
    return _config


def check_supported(block: dict) -> None:
    """Raise ``NotImplementedError`` where ``block`` sets a key that only
    remote dispatch reads away from its default (ROADMAP A7)."""
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
    ingested and ``objectstore.put`` (ctx: key) before an object-store
    upload; a site that nothing armed costs one dict test."""

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
