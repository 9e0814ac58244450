"""In-process metrics registry and its Prometheus text exposition.

Copy of ``filodb_tpu/utils/metrics.py``: ``Counter``, ``Gauge``,
``GaugeFn`` (computed at scrape time), ``Histogram`` and
``render_prometheus``, in the reference's exposition format (a counter
family is ``<name>_total``; ``# HELP`` and ``# TYPE`` a family; a
histogram's ``_bucket`` series with ``le``, then ``_count`` and ``_sum``).
The port registers the families of the node: the gateway's, the ingest
workers', the flush scheduler's, each shard's ingest, flush and recovery
counters, and the governor's, the cost model's and tracing's. Updates take a per-metric lock: the gateway, the ingest
workers, the scheduler and the HTTP threads update them side by side.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict

log = logging.getLogger(__name__)

_registry: dict[str, "Metric"] = {}
_lock = threading.Lock()
# GaugeFn callbacks whose first failure was logged (one line a callback)
_scrape_error_logged: set[str] = set()


def _key(name: str, tags: dict | None) -> str:
    t = ",".join(f"{k}={v}" for k, v in sorted((tags or {}).items()))
    return f"{name}{{{t}}}"


class Metric:
    def __init__(self, name: str, tags: dict[str, str] | None = None,
                 help: str | None = None):
        self.name = name
        self.tags = tags or {}
        self.help = help or name
        self._mlock = threading.Lock()
        with _lock:
            _registry[_key(name, self.tags)] = self


class Counter(Metric):
    def __init__(self, name: str, tags: dict[str, str] | None = None,
                 help: str | None = None):
        super().__init__(name, tags, help)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._mlock:
            self.value += n


class Gauge(Metric):
    def __init__(self, name: str, tags: dict[str, str] | None = None,
                 help: str | None = None):
        super().__init__(name, tags, help)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._mlock:
            self.value = v


class GaugeFn(Metric):
    """A gauge computed at scrape time by ``fn``; ``None`` from it drops
    the series from the exposition (its subject is gone)."""

    def __init__(self, name: str, fn, tags: dict[str, str] | None = None,
                 help: str | None = None):
        super().__init__(name, tags, help)
        self.fn = fn

    @property
    def value(self) -> float | None:
        try:
            v = self.fn()
            return None if v is None else float(v)
        except Exception:
            SCRAPE_ERRORS.inc()
            key = _key(self.name, self.tags)
            with _lock:
                first = key not in _scrape_error_logged
                _scrape_error_logged.add(key)
            if first:
                log.warning("metric scrape callback failed: %s", key,
                            exc_info=True)
            return float("nan")


class Histogram(Metric):
    """Fixed bucket bounds (default: latency seconds)."""

    BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
              1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str, tags: dict[str, str] | None = None,
                 bounds: tuple | None = None, help: str | None = None):
        super().__init__(name, tags, help)
        self.bounds = tuple(bounds) if bounds is not None else self.BOUNDS
        self.buckets = defaultdict(int)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        with self._mlock:
            self.count += 1
            self.sum += v
            for b in self.bounds:
                if v <= b:
                    self.buckets[b] += 1

    def time(self):
        return _Timer(self)


class _Timer:
    def __init__(self, hist: Histogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0)


SCRAPE_ERRORS = Counter("filodb_metric_scrape_errors")


def get_counter(name: str, tags: dict[str, str] | None = None,
                help: str | None = None) -> Counter:
    """The registered counter of (name, tags), created if new: a call
    site that counts errors needs no instance of its own."""
    with _lock:
        m = _registry.get(_key(name, tags))
    if isinstance(m, Counter):
        return m
    return Counter(name, tags, help)


def get_gauge(name: str, tags: dict[str, str] | None = None,
              help: str | None = None) -> Gauge:
    """The registered gauge of (name, tags), created if new: dynamically
    tagged series (a tenant's) keep their live value."""
    with _lock:
        m = _registry.get(_key(name, tags))
    if isinstance(m, Gauge):
        return m
    return Gauge(name, tags, help)


def escape_label_value(v) -> str:
    """Exposition label-value escaping (backslash, quote, newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def render_prometheus() -> str:
    """Every metric in the Prometheus text format, grouped by family."""
    with _lock:
        metrics = list(_registry.values())
    families: dict[tuple[str, str], list[Metric]] = {}
    for m in metrics:
        if isinstance(m, Counter):
            fam = (f"{m.name}_total", "counter")
        elif isinstance(m, (Gauge, GaugeFn)):
            fam = (m.name, "gauge")
        elif isinstance(m, Histogram):
            fam = (m.name, "histogram")
        else:
            continue
        families.setdefault(fam, []).append(m)
    lines = []
    for (fam, typ), members in families.items():
        help_text = " ".join(str(members[0].help).split())
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} {typ}")
        for m in members:
            tagstr = ",".join(f'{k}="{escape_label_value(v)}"'
                              for k, v in sorted(m.tags.items()))
            tagstr = f"{{{tagstr}}}" if tagstr else ""
            if isinstance(m, Counter):
                lines.append(f"{m.name}_total{tagstr} {m.value}")
            elif isinstance(m, (Gauge, GaugeFn)):
                v = m.value
                if v is None:
                    continue
                lines.append(f"{m.name}{tagstr} {v}")
            else:
                for b in m.bounds:
                    t = (tagstr[:-1] + f',le="{b}"}}' if tagstr
                         else f'{{le="{b}"}}')
                    lines.append(f"{m.name}_bucket{t} {m.buckets.get(b, 0)}")
                t = tagstr[:-1] + ',le="+Inf"}' if tagstr else '{le="+Inf"}'
                lines.append(f"{m.name}_bucket{t} {m.count}")
                lines.append(f"{m.name}_count{tagstr} {m.count}")
                lines.append(f"{m.name}_sum{tagstr} {m.sum}")
    return "\n".join(lines) + "\n"
