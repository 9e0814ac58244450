"""Self-monitoring: the node's own metric registry as a first-class dataset.

Counterpart of the reference's "monitor FiloDB with a TSDB" deployment
pattern (``PAPER.md``: production FiloDB clusters are watched by pointing a
time-series database at FiloDB's Kamon metrics) — here the node points at
itself.  :class:`MetaMonitor` samples the in-process metric registry
(``utils/metrics.py``) every N seconds, converts each family to gauge
series tagged with node/instance labels, and writes them through the
*normal* ingest path (a rules-style sink: WAL ``LogSink`` in standalone,
``MemstoreSink`` in tests) into a dedicated ``_meta`` dataset.  PromQL,
the result cache, and standing rules/alerts then work over the system's
own telemetry with zero special cases — the default alert group in
``standalone.py`` (ingest lag, breaker open) evaluates against ``_meta``
like any user rule group.

Also home to the end-to-end freshness probe: gateways stamp a sampled
subset of outgoing containers (:class:`E2EStamps`), and the shard-side
ingest worker observes wall-clock deltas into ``filodb_ingest_e2e_seconds``
once the stamped offset is actually queryable in the shard.

Copy of ``filodb_tpu/utils/selfmon.py``. The port's hooks are the
reference's: the gateway's ``ContainerSink`` stamps
(``gateway/server.py``), the node's ingest worker observes
(``coordinator/cluster.py``), and ``standalone.FiloServer`` runs the
``MetaMonitor`` over a ``LogSink`` into ``_meta``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from filodb_tpu_torch.core.partkey import METRIC_LABEL, PartKey
from filodb_tpu_torch.core.record import IngestRecord, RecordContainer
from filodb_tpu_torch.utils import metrics
from filodb_tpu_torch.utils.metrics import Counter, Gauge, GaugeFn, Histogram

log = logging.getLogger("filodb.selfmon")

TICKS = Counter("filodb_selfmon_ticks")
ERRORS = Counter("filodb_selfmon_errors")
SAMPLES = Counter("filodb_selfmon_samples")
SERIES = Gauge("filodb_selfmon_series")
TICK_SECONDS = Histogram("filodb_selfmon_tick_seconds")

# end-to-end ingest freshness: gateway-stamp wall time -> queryable in shard
INGEST_E2E = Histogram(
    "filodb_ingest_e2e_seconds",
    bounds=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
            10.0, 30.0, 60.0),
    help="gateway-stamped record to queryable-in-shard, sampled")


def registry_samples(base_labels: dict[str, str],
                     include_buckets: bool = False):
    """Convert the live metric registry to ``(labels, value)`` gauge samples.

    Families follow exposition naming (counters get ``_total``, histograms
    contribute ``_count``/``_sum`` and optionally per-``le`` buckets).
    ``base_labels`` (node/instance/shard-key labels) win on collision: a
    metric tag that would shadow one is remapped to ``exported_<key>``,
    Prometheus-federation style.  ``GaugeFn`` callbacks returning ``None``
    (subject torn down) or NaN (broken callback) are skipped — a NaN
    sample would poison range aggregations over ``_meta``.
    """
    with metrics._lock:
        members = list(metrics._registry.values())
    out = []

    def emit(name: str, tags: dict, value: float) -> None:
        labels = dict(base_labels)
        labels[METRIC_LABEL] = name
        for k, v in tags.items():
            if k in labels:
                k = "exported_" + k
            labels[k] = str(v)
        out.append((labels, float(value)))

    for m in members:
        if isinstance(m, Counter):
            emit(m.name + "_total", m.tags, m.value)
        elif isinstance(m, Histogram):
            emit(m.name + "_count", m.tags, m.count)
            emit(m.name + "_sum", m.tags, m.sum)
            if include_buckets:
                for b in m.bounds:
                    emit(m.name + "_bucket", {**m.tags, "le": str(b)},
                         m.buckets.get(b, 0))
        elif isinstance(m, (Gauge, GaugeFn)):
            v = m.value
            if v is None or v != v:
                continue
            emit(m.name, m.tags, v)
    return out


class MetaMonitor:
    """Background sampler feeding the ``_meta`` dataset.

    ``sink`` is a rules-style sink (``rules.manager.LogSink`` /
    ``MemstoreSink``): ``write(container) -> (count, offsets)``.  Using the
    same sink abstraction as recording rules means ``_meta`` rides the WAL,
    replay, and checkpoint machinery unchanged.
    """

    def __init__(self, sink, interval_s: float = 15.0, *,
                 node: str = "node0", instance: str = "filodb",
                 dataset: str = "_meta", include_buckets: bool = False,
                 workspace: str = "_system", namespace: str = "selfmon"):
        self.sink = sink
        self.interval_s = max(0.05, float(interval_s))
        self.dataset = dataset
        self.include_buckets = include_buckets
        self.base_labels = {"_ws_": workspace, "_ns_": namespace,
                            "node": node, "instance": instance}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run,
                                        name="filodb-selfmon", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        # first tick immediately so tests (and freshly booted nodes) see
        # _meta series without waiting a full interval
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.interval_s)

    # -- one sample pass ---------------------------------------------------

    def tick(self) -> int:
        """Sample the registry once and write one container to the sink.
        Returns the number of series written (0 on error — selfmon must
        never take down the node it is watching)."""
        with TICK_SECONDS.time():
            try:
                ts_ms = int(time.time() * 1000)
                samples = registry_samples(self.base_labels,
                                           self.include_buckets)
                cont = RecordContainer()
                for labels, v in samples:
                    cont.add(IngestRecord(PartKey.create("gauge", labels),
                                          ts_ms, (v,)))
                if len(cont):
                    self.sink.write(cont)
                TICKS.inc()
                SAMPLES.inc(len(samples))
                SERIES.set(float(len(samples)))
                return len(samples)
            except Exception:
                ERRORS.inc()
                log.warning("selfmon tick failed", exc_info=True)
                return 0


class E2EStamps:
    """Sampled gateway->shard freshness stamps.

    The gateway stamps every Nth drained container per (dataset, shard)
    with its wall-clock send time keyed by log offset; the shard-side
    ingest worker calls :meth:`observe` after committing an offset, which
    pops every stamp at-or-below it and records the wall-clock delta into
    ``filodb_ingest_e2e_seconds``.  Bounded deques keep an ingest stall
    from accumulating stamps without limit (oldest stamps drop first —
    under a stall the *surviving* samples still show the tail latency).
    """

    def __init__(self, sample_every: int = 32, max_pending: int = 256):
        self.sample_every = max(1, int(sample_every))
        self.max_pending = max_pending
        self._lock = threading.Lock()
        self._counts: dict[tuple, int] = {}
        self._pending: dict[tuple, deque] = {}

    def maybe_stamp(self, dataset: str, shard: int, offset: int) -> None:
        key = (dataset, shard)
        with self._lock:
            n = self._counts.get(key, 0)
            self._counts[key] = n + 1
            if n % self.sample_every:
                return
            dq = self._pending.get(key)
            if dq is None:
                dq = self._pending[key] = deque(maxlen=self.max_pending)
            dq.append((offset, time.time()))

    def observe(self, dataset: str, shard: int, offset: int) -> None:
        key = (dataset, shard)
        now = time.time()
        deltas = []
        with self._lock:
            dq = self._pending.get(key)
            if not dq:
                return
            while dq and dq[0][0] <= offset:
                _, t0 = dq.popleft()
                deltas.append(now - t0)
        for d in deltas:
            INGEST_E2E.observe(max(0.0, d))


# process-wide stamp tracker shared by gateway (producer side) and the
# cluster ingest workers (consumer side)
STAMPS = E2EStamps()
