"""Span tracing, per-query stage metrics and the slow-query flight
recorder.

Copy of ``filodb_tpu/utils/tracing.py`` (the reference's Kamon spans
around plan execution, ``ExecPlan.scala:101``, and ``startODPSpan``):
nested, timed spans collected a query, in process.

- :func:`span` records a span where a trace is active on this thread and
  costs one attribute lookup otherwise; :func:`activate` adopts a trace on
  another thread; :func:`start_trace` starts one.
- :func:`traced_query` head-samples a query at ``sample_rate`` and
  tail-captures any query slower than ``slow_query_threshold_ms`` into a
  bounded ring (:class:`FlightRecorder`), read by
  ``/promql/{ds}/api/v1/debug/slow_queries``; ``debug/trace`` runs one
  query traced. :func:`record_slow` records the members of a batch.
- :func:`traced_operation` traces background work (gateway drains, shard
  ingests, flushes); the ingest kinds land in their own ring
  (:func:`slow_ingest`, read by ``/api/v1/status/ingest``).
- Completed query traces feed ``filodb_query_stage_seconds{stage}``.

Stage names are the reference's (``parse``, ``plan-materialize``,
``exec-dispatch``, ``mesh-execute``, ``scan``, ``decode``, ``reduce``,
``odp-page``, ``cache``). On the card a span closes on the host's clock;
the service synchronizes the device inside ``mesh-execute`` and
``exec-dispatch`` only when a trace is active, so an unsampled query
pays no synchronization (:func:`device_span`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from filodb_tpu_torch.utils.metrics import Histogram, get_counter

_local = threading.local()
_span_ids = itertools.count(1)

# ---------------------------------------------------------------------------
# configuration

@dataclass
class TracingConfig:
    sample_rate: float = 0.0            # head-sampling fraction [0, 1]
    slow_query_threshold_ms: float = 500.0  # tail capture; 0 disables
    slowlog_capacity: int = 128         # flight-recorder ring size
    slow_ingest_threshold_ms: float = 250.0  # ingest-ring capture; 0 off
    ingest_slowlog_capacity: int = 128  # ingest flight-recorder ring size


_config = TracingConfig()


def configure(**overrides) -> TracingConfig:
    """Apply tracing config at boot (``config.py`` "tracing" block)."""
    global _config
    _config = TracingConfig(**overrides)
    _recorder.resize(_config.slowlog_capacity)
    _ingest_recorder.resize(_config.ingest_slowlog_capacity)
    return _config


def config() -> TracingConfig:
    return _config


def should_sample(trace_id: str, rate: float | None = None) -> bool:
    """Deterministic head-sampling verdict for a trace id: the same id
    always samples the same way at a given rate, so retries and tests are
    reproducible across processes."""
    r = _config.sample_rate if rate is None else rate
    if r <= 0.0:
        return False
    if r >= 1.0:
        return True
    h = int.from_bytes(
        hashlib.blake2b(trace_id.encode(), digest_size=8).digest(), "big")
    return (h % 10_000) < int(r * 10_000)


# ---------------------------------------------------------------------------
# spans

@dataclass
class Span:
    name: str
    start_s: float
    duration_s: float = 0.0
    depth: int = 0
    tags: dict = field(default_factory=dict)
    span_id: int = 0
    parent_id: int = 0

    def as_dict(self) -> dict:
        d = {"name": self.name, "depth": self.depth,
             "duration_ms": round(self.duration_s * 1000, 3),
             "span_id": self.span_id, "parent_id": self.parent_id}
        if self.tags:
            d["tags"] = {k: v for k, v in self.tags.items()}
        return d


@dataclass
class Trace:
    spans: list[Span] = field(default_factory=list)
    _depth: int = 0  # legacy field; per-thread depth now lives in _local
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def as_dicts(self) -> list[dict]:
        with self._lock:
            return [s.as_dict() for s in self.spans]

    def find(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]


def current_trace() -> Trace | None:
    return getattr(_local, "trace", None)


def current_span() -> Span | None:
    """Innermost span open on this thread (the adopted parent when none)."""
    stack = getattr(_local, "stack", None)
    if stack:
        return stack[-1]
    return getattr(_local, "base", None)


def _push_state(trace, base):
    prev = (getattr(_local, "trace", None), getattr(_local, "stack", None),
            getattr(_local, "base", None))
    _local.trace, _local.stack, _local.base = trace, [], base
    return prev


def _pop_state(prev):
    _local.trace, _local.stack, _local.base = prev


@contextmanager
def start_trace():
    """Activate tracing on this thread for the duration of the block."""
    trace = Trace()
    prev = _push_state(trace, None)
    try:
        yield trace
    finally:
        _pop_state(prev)


@contextmanager
def activate(trace: Trace, parent: Span | None = None):
    """Adopt an existing trace on this thread (gather-worker handoff).
    New root-level spans opened here parent under ``parent``. A no-op when
    the trace is already active on this thread."""
    if getattr(_local, "trace", None) is trace:
        yield trace
        return
    prev = _push_state(trace, parent)
    try:
        yield trace
    finally:
        _pop_state(prev)


@contextmanager
def span(name: str, **tags):
    """Record a nested span if a trace is active; otherwise free."""
    trace = getattr(_local, "trace", None)
    if trace is None:
        yield None
        return
    stack = _local.stack
    parent = stack[-1] if stack else getattr(_local, "base", None)
    s = Span(name, time.perf_counter(),
             depth=parent.depth + 1 if parent is not None else 0,
             tags=tags, span_id=next(_span_ids),
             parent_id=parent.span_id if parent is not None else 0)
    with trace._lock:
        trace.spans.append(s)
    stack.append(s)
    try:
        yield s
    finally:
        stack.pop()
        s.duration_s = time.perf_counter() - s.start_s


def tag(key: str, value) -> None:
    """Attach a tag to the innermost span open on this thread, if tracing."""
    if getattr(_local, "trace", None) is None:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].tags[key] = value


def graft_spans(span_dicts: list, parent: Span | None = None,
                **extra_tags) -> None:
    """Append a remote span tree (a list of ``Span.as_dict()`` dicts, as
    shipped in ``QueryResult.spans``) to the current trace under ``parent``.
    Top-level remote spans get ``extra_tags`` (e.g. ``node="host:port"``).
    Span ids are remapped to this process's id space so parent links stay
    unambiguous when several peers graft concurrently."""
    trace = getattr(_local, "trace", None)
    if trace is None or not span_dicts:
        return
    base_depth = parent.depth + 1 if parent is not None else 0
    base_parent = parent.span_id if parent is not None else 0
    remap: dict[int, int] = {}
    spans = []
    for d in span_dicts:
        if not isinstance(d, dict) or "name" not in d:
            continue
        sid = next(_span_ids)
        old = d.get("span_id", 0)
        if old:
            remap[old] = sid
        pid = remap.get(d.get("parent_id", 0), 0)
        tags = dict(d.get("tags") or {})
        if not pid:
            pid = base_parent
            tags.update(extra_tags)
        spans.append(Span(d["name"], 0.0,
                          duration_s=float(d.get("duration_ms", 0.0)) / 1000,
                          depth=base_depth + int(d.get("depth", 0)),
                          tags=tags, span_id=sid, parent_id=pid))
    with trace._lock:
        trace.spans.extend(spans)


# ---------------------------------------------------------------------------
# per-stage histograms derived from spans

_STAGES = ("parse", "plan-materialize", "exec-dispatch", "dispatch",
           "mesh-execute", "scan", "decode", "reduce", "odp-page", "cache")
_stage_hists = {}
for _s in _STAGES:
    _stage_hists[_s] = Histogram("filodb_query_stage_seconds",
                                 tags={"stage": _s},
                                 help="query stage latency derived from "
                                      "trace spans")
del _s

_sampled = get_counter("filodb_queries_sampled")
_recorded = get_counter("filodb_slow_queries_recorded")
_ingest_recorded = get_counter("filodb_ingest_slow_recorded")


def observe_stage_times(spans: list[Span]) -> None:
    """Feed ``filodb_query_stage_seconds{stage=...}`` from a completed
    trace. Only whitelisted stage names are observed, bounding label
    cardinality against arbitrary exec-plan class names."""
    for s in spans:
        h = _stage_hists.get(s.name)
        if h is not None:
            h.observe(s.duration_s)


# ---------------------------------------------------------------------------
# flight recorder

class FlightRecorder:
    """Bounded ring buffer of slow/sampled query and operation records."""

    def __init__(self, capacity: int = 128):
        self._rlock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))

    def record(self, entry: dict) -> None:
        with self._rlock:
            self._ring.append(entry)

    def snapshot(self) -> list[dict]:
        with self._rlock:
            return list(self._ring)

    def resize(self, capacity: int) -> None:
        with self._rlock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    def clear(self) -> None:
        with self._rlock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._rlock:
            return len(self._ring)


_recorder = FlightRecorder()

# Separate ring for the ingest pipeline (gateway drain, shard ingest,
# flush, object-store upload): ingest stalls must stay visible even while
# a slow-query storm is churning the query ring, and vice versa.
_ingest_recorder = FlightRecorder()

# traced_operation kinds that belong to the ingest pipeline and therefore
# record into the ingest ring under slow_ingest_threshold_ms
_INGEST_KINDS = frozenset({"gateway", "ingest", "flush", "objectstore"})


def flight_recorder() -> FlightRecorder:
    return _recorder


def ingest_recorder() -> FlightRecorder:
    return _ingest_recorder


def slow_queries(limit: int = 0) -> list[dict]:
    """Flight-recorder entries, newest first."""
    entries = list(reversed(_recorder.snapshot()))
    return entries[:limit] if limit and limit > 0 else entries


def slow_ingest(limit: int = 0) -> list[dict]:
    """Ingest flight-recorder entries, newest first."""
    entries = list(reversed(_ingest_recorder.snapshot()))
    return entries[:limit] if limit and limit > 0 else entries


class _QueryRecord:
    """Handle yielded by :func:`traced_query`; call :meth:`observe` with the
    QueryResult so its stats land in the flight-recorder entry."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None

    def observe(self, result) -> None:
        self.result = result


def _stats_dict(result) -> dict:
    stats = getattr(result, "stats", None)
    if stats is None:
        return {}
    try:
        return dataclasses.asdict(stats)
    except TypeError:
        return {}


def _finish_query(rec, trace, start_idx, t0, sampled, info) -> None:
    cfg = _config
    duration_ms = (time.perf_counter() - t0) * 1000
    section = []
    if trace is not None:
        with trace._lock:
            section = list(trace.spans[start_idx:])
        observe_stage_times(section)
    if cfg.slow_query_threshold_ms <= 0 \
            or duration_ms <= cfg.slow_query_threshold_ms:
        return
    entry = {"kind": "query", "when": time.time(),
             "duration_ms": round(duration_ms, 3), "sampled": sampled}
    entry.update(info)
    entry["stats"] = _stats_dict(rec.result)
    entry["spans"] = [s.as_dict() for s in section]
    _recorder.record(entry)
    _recorded.inc()


@contextmanager
def traced_query(qcontext, **info):
    """Per-query tracing for the query-service entry points.

    Joins an already-active trace (debug endpoint, rules tick) or head-
    samples a fresh one at ``sample_rate``; either way the ``qcontext``
    gets a sampled ``TraceContext`` so remote executors ship their span
    trees back. On exit, feeds stage histograms and tail-captures slow
    queries into the flight recorder (unsampled slow queries record stats
    with an empty span list — set ``sample_rate`` to 1.0 to retain full
    trees for every slow query)."""
    from filodb_tpu_torch.query.model import TraceContext
    rec = _QueryRecord()
    t0 = time.perf_counter()
    outer = getattr(_local, "trace", None)
    if outer is not None:
        if getattr(qcontext, "trace", None) is None:
            qcontext.trace = TraceContext(trace_id=qcontext.query_id,
                                          sampled=True)
        start_idx = len(outer.spans)
        try:
            yield rec
        finally:
            _finish_query(rec, outer, start_idx, t0, True, info)
        return
    if should_sample(qcontext.query_id):
        _sampled.inc()
        qcontext.trace = TraceContext(trace_id=qcontext.query_id,
                                      sampled=True)
        with start_trace() as trace:
            try:
                yield rec
            finally:
                _finish_query(rec, trace, 0, t0, True, info)
    else:
        try:
            yield rec
        finally:
            _finish_query(rec, None, 0, t0, False, info)


def record_slow(kind: str, duration_ms: float, spans: list | None = None,
                stats: dict | None = None, **info) -> None:
    """Record an already-measured slow item (batched query paths that
    cannot wrap :func:`traced_query` around each query)."""
    cfg = _config
    if cfg.slow_query_threshold_ms <= 0 \
            or duration_ms <= cfg.slow_query_threshold_ms:
        return
    entry = {"kind": kind, "when": time.time(),
             "duration_ms": round(duration_ms, 3),
             "sampled": bool(spans)}
    entry.update(info)
    entry["stats"] = stats or {}
    entry["spans"] = spans or []
    _recorder.record(entry)
    _recorded.inc()


@contextmanager
def traced_operation(kind: str, **tags):
    """Trace a background operation (rules tick, gateway drain, shard
    ingest, flush, objectstore upload, migration phase). Operations are
    low-frequency, so they always trace. Slow runs land in a flight
    recorder: ingest-pipeline kinds (``_INGEST_KINDS``) over
    ``slow_ingest_threshold_ms`` go to the ingest ring, everything else
    over ``slow_query_threshold_ms`` to the query ring — so an ingest
    stall stays visible through a slow-query storm and vice versa."""
    if getattr(_local, "trace", None) is not None:
        with span(kind, **tags) as s:
            yield s
        return
    t0 = time.perf_counter()
    with start_trace() as trace:
        with span(kind, **tags) as s:
            yield s
    duration_ms = (time.perf_counter() - t0) * 1000
    cfg = _config
    if kind in _INGEST_KINDS:
        recorder, threshold, counter = (
            _ingest_recorder, cfg.slow_ingest_threshold_ms,
            _ingest_recorded)
    else:
        recorder, threshold, counter = (
            _recorder, cfg.slow_query_threshold_ms, _recorded)
    if threshold > 0 and duration_ms > threshold:
        entry = {"kind": kind, "when": time.time(),
                 "duration_ms": round(duration_ms, 3), "sampled": True}
        entry.update(tags)
        entry["spans"] = trace.as_dicts()
        recorder.record(entry)
        counter.inc()


@contextmanager
def device_span(name: str, device, **tags):
    """``span`` whose duration includes the work queued on ``device``: it
    synchronizes a CUDA device before it closes, and only where a trace is
    active on this thread, so an unsampled query pays nothing."""
    if getattr(_local, "trace", None) is None:
        yield None
        return
    with span(name, **tags) as s:
        yield s
        if getattr(device, "type", "cpu") == "cuda":
            import torch
            torch.cuda.synchronize(device)
