"""The gateway: Influx line protocol over TCP in, shard-routed logs out.

Port of ``filodb_tpu/gateway/server.py``: lines arrive over TCP (one
record a line), are parsed (``gateway/influx.py``), routed to their shards
by part key (``coordinator/ingestion.py::route_container``, the rule the
shards route by), batched a shard and appended to the shards' logs, which
the ingest workers tail.

``ContainerSink`` has the reference's bounded, explicit backpressure: one
drain in flight at a time (appends keep each shard's record order);
producers keep batching into the pending container while it drains, and
once ``max_pending`` records wait, ``add`` blocks its producer (TCP then
pushes back on the client) until the drain completes. Waits show as the
``gateway_backpressure_*`` metrics. Under the governor's CRITICAL state
(memory pressure, ``utils/governor.py``) a producer that would block sheds
its records instead, counted in ``gateway_records_shed``, and the client
retries once the pressure clears, as the reference's sink does. Each
drain is a ``traced_operation("gateway")``: a slow one lands in the
slow-ingest ring, and every Nth container it appends a shard is stamped
for the end-to-end freshness histogram (``utils/selfmon.py::STAMPS``,
keyed by the sink's ``dataset``).
"""

from __future__ import annotations

import logging
import socketserver
import threading
import time
import weakref

from filodb_tpu_torch.coordinator.ingestion import route_container
from filodb_tpu_torch.core.record import RecordContainer
from filodb_tpu_torch.gateway.influx import InfluxParseError, parse_influx_line
from filodb_tpu_torch.kafka.log import ReplayLog
from filodb_tpu_torch.utils import governor as governor_mod
from filodb_tpu_torch.utils.metrics import Counter, GaugeFn, Histogram
from filodb_tpu_torch.utils.selfmon import STAMPS
from filodb_tpu_torch.utils.tracing import traced_operation

log = logging.getLogger(__name__)

lines_parsed = Counter("gateway_lines_parsed")
lines_failed = Counter("gateway_lines_failed")
backpressure_waits = Counter("gateway_backpressure_waits")
backpressure_seconds = Histogram("gateway_backpressure_seconds")
# records dropped under the governor's CRITICAL state instead of blocking
records_shed = Counter("gateway_records_shed")


class ContainerSink:
    """Batches records a shard and appends them to the shard logs (the
    reference's ``KafkaContainerSink``)."""

    def __init__(self, logs: dict[int, ReplayLog], num_shards: int,
                 spread: int = 1, flush_every: int = 512,
                 max_pending: int = 16384, dataset: str = "prometheus"):
        self.logs = logs
        self.num_shards = num_shards
        self.spread = spread
        self.dataset = dataset  # keys the sampled freshness stamps
        self.flush_every = flush_every
        self.max_pending = max(max_pending, flush_every)
        self._pending = RecordContainer()
        self._cond = threading.Condition(threading.Lock())
        self._flushing = False
        ref = weakref.ref(self)
        GaugeFn("gateway_queue_depth",
                lambda: (len(s._pending) if (s := ref()) is not None
                         else None))

    def add(self, records) -> None:
        records = list(records)
        t0 = None
        while True:
            batch = None
            inserted = False
            with self._cond:
                if len(self._pending) < self.max_pending:
                    self._pending.records.extend(records)
                    inserted = True
                    if len(self._pending) >= self.flush_every \
                            and not self._flushing:
                        batch = self._take()
                elif not self._flushing:
                    # full and nobody draining: this producer drains, then
                    # retries its own insert
                    batch = self._take()
                else:
                    # full while a drain is in flight. Under CRITICAL,
                    # blocking would hold the records while memory is the
                    # scarce resource: shed them, the client retries
                    if governor_mod.governor().state == governor_mod.CRITICAL:
                        records_shed.inc(len(records))
                        if t0 is not None:
                            backpressure_seconds.observe(
                                time.perf_counter() - t0)
                        return
                    # else block (TCP pushes the pressure back)
                    if t0 is None:
                        t0 = time.perf_counter()
                        backpressure_waits.inc()
                    self._cond.wait(timeout=5.0)
            if batch is not None:
                self._drain(batch)
            if inserted:
                if t0 is not None:
                    backpressure_seconds.observe(time.perf_counter() - t0)
                return

    def _take(self) -> RecordContainer:
        """The pending batch, now being drained (caller holds the lock)."""
        batch = self._pending
        self._pending = RecordContainer()
        self._flushing = True
        return batch

    def flush(self) -> None:
        """Drain until nothing is pending."""
        while True:
            with self._cond:
                while self._flushing:
                    self._cond.wait(timeout=5.0)
                if not len(self._pending):
                    return
                batch = self._take()
            self._drain(batch)

    def _drain(self, batch: RecordContainer) -> None:
        """Append owned batches to the shard logs outside the lock (parsing
        threads keep batching meanwhile), then take a pending batch that
        crossed ``flush_every`` during the drain."""
        while batch is not None:
            try:
                with traced_operation("gateway", op="drain",
                                      records=len(batch)):
                    for shard, cont in route_container(
                            batch, self.num_shards, self.spread).items():
                        off = self.logs[shard].append(cont)
                        # every Nth container is stamped; the shard's
                        # ingest worker observes it (utils/selfmon.py)
                        STAMPS.maybe_stamp(self.dataset, shard, off)
            finally:
                with self._cond:
                    self._flushing = False
                    self._cond.notify_all()
            batch = None
            with self._cond:
                if len(self._pending) >= self.flush_every \
                        and not self._flushing:
                    batch = self._take()


class GatewayServer:
    """Influx lines over TCP into a ``ContainerSink``; a connection's
    records are flushed when it closes."""

    def __init__(self, sink: ContainerSink,
                 default_labels: dict[str, str] | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.sink = sink
        self.default_labels = default_labels or {"_ws_": "default",
                                                 "_ns_": "default"}
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    try:
                        recs = parse_influx_line(
                            raw.decode("utf-8", "replace"),
                            outer.default_labels,
                            now_ms=int(time.time() * 1000))
                        if recs:
                            outer.sink.add(recs)
                            lines_parsed.inc()
                    except (InfluxParseError, ValueError):
                        lines_failed.inc()
                outer.sink.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Server((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="gateway")

    def start(self) -> "GatewayServer":
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10)
