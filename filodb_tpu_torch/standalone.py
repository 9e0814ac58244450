"""FiloServer: the standalone node.

Port of ``filodb_tpu/standalone.py`` for one node in the coordinator role:
local-disk column and meta stores at ``<data_dir>/columnstore``, a
``SegmentedFileLog`` a shard at ``<wal_dir or data_dir/wal>/<dataset>/
shard-<n>`` (the reference's layout, so either package's server serves a
directory the other wrote), the cluster with this node (each shard
recovered, then replayed and tailed by its ingest worker; the flush
scheduler), a ``QueryService`` a dataset on the card with the extent
cache of ``result_cache``, the HTTP API (``http_impl``: ``fast``, the
default, or ``threaded``) with the rendered-response cache unless
``http_response_cache`` is false and, with a ``gateway_port``, the Influx
gateway into the first dataset's logs.

The node's control plane, as the reference's: the ``resilience``,
``governor`` and ``tracing`` blocks configure their process-wide modules
at construction (before any shard is made, so tenant quotas apply to
every shard); each dataset's cost model loads its persisted estimates at
boot and saves them at shutdown (``coordinator/adaptive_planner.py``,
``<data_dir>/columnstore/<dataset>/costmodel.json``); a ``MemoryWatchdog``
samples the result caches' bytes against their budgets, evicts the caches
when the node leaves OK, and stops (back to OK) at shutdown. The
reference's second source, the write-buffer pools, has no counterpart:
the port's write buffers are columnar arrays without a pool (ROADMAP §C).

It runs on the CUDA card; ``device="cpu"`` runs every kernel's plain
version on the CPU, as the tests do. Without a card it raises; nothing
carries on on the CPU unasked. Options the port lacks raise at
construction (``ServerConfig.check_supported``).

    python -m filodb_tpu_torch.standalone --config conf/server.json
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time
import weakref

from filodb_tpu_torch.config import NOT_ACTED_ON, ServerConfig
from filodb_tpu_torch.coordinator import adaptive_planner
from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
from filodb_tpu_torch.core.store.localstore import (
    LocalDiskColumnStore,
    LocalDiskMetaStore,
)
from filodb_tpu_torch.device import resolve
from filodb_tpu_torch.gateway.server import ContainerSink, GatewayServer
from filodb_tpu_torch.http.fastserver import FastHttpServer
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.kafka.log import SegmentedFileLog
from filodb_tpu_torch.utils import governor, resilience, tracing

log = logging.getLogger(__name__)


class FiloServer:
    def __init__(self, config: ServerConfig, device=None):
        config.check_supported()
        self.config = config
        resilience.configure(**config.resilience)
        governor.configure(**config.governor)
        tracing.configure(**config.tracing)
        self.device = resolve(device)
        os.makedirs(config.data_dir, exist_ok=True)
        root = os.path.join(config.data_dir, "columnstore")
        self.column_store = LocalDiskColumnStore(root)
        self.meta_store = LocalDiskMetaStore(root)
        self.node = Node(config.node_name, self.column_store, self.meta_store)
        self.cluster = FilodbCluster()
        self.logs: dict[tuple[str, int], SegmentedFileLog] = {}
        self.services: dict = {}
        self.http = None
        self.gateway: GatewayServer | None = None
        self.watchdog: governor.MemoryWatchdog | None = None

    def _wal_path(self, dataset: str, shard: int) -> str:
        root = self.config.wal_dir or os.path.join(self.config.data_dir,
                                                   "wal")
        return os.path.join(root, dataset, f"shard-{shard}")

    def _shard_log(self, dataset: str, shard: int) -> SegmentedFileLog:
        key = (dataset, shard)
        if key not in self.logs:
            self.logs[key] = SegmentedFileLog(self._wal_path(dataset, shard),
                                              fsync=self.config.wal_fsync)
        return self.logs[key]

    def start(self) -> "FiloServer":
        cfg = self.config
        log.info("options accepted at their defaults and not acted on yet "
                 "(ROADMAP §C): %s", ", ".join(NOT_ACTED_ON))
        self.cluster.join(self.node)
        for name, ing in cfg.datasets.items():
            logs = {s: self._shard_log(name, s)
                    for s in range(ing.num_shards)}
            self.cluster.setup_dataset(ing, logs, cfg.spreads.get(name, 1))
            self.services[name] = self.cluster.query_service(
                name, engine=cfg.engines.get(name, "mesh"),
                device=self.device, result_cache=cfg.result_cache)
            # learned cost estimates, before any query is admitted
            adaptive_planner.install(name, self.meta_store, cfg.cost_model)
        self.watchdog = self._watchdog().start()
        http_cls = FastHttpServer if cfg.http_impl == "fast" \
            else FiloHttpServer
        self.http = http_cls(self.services, port=cfg.http_port,
                             cluster=self.cluster,
                             reuse_port=cfg.http_reuse_port,
                             response_cache=cfg.http_response_cache).start()
        if cfg.gateway_port:
            first = next(iter(cfg.datasets.values()))
            sink = ContainerSink(
                {s: self._shard_log(first.dataset, s)
                 for s in range(first.num_shards)},
                first.num_shards, cfg.spreads.get(first.dataset, 1))
            self.gateway = GatewayServer(sink, port=cfg.gateway_port).start()
        log.info("FiloServer up: http=%d gateway=%s device=%s",
                 self.http.port,
                 self.gateway.port if self.gateway else "off", self.device)
        return self

    def _watchdog(self) -> governor.MemoryWatchdog:
        """The memory watchdog over the result caches' bytes; leaving OK
        evicts them. Tenant series gauges sum the node's shards."""
        wd = governor.MemoryWatchdog()
        for name, svc in self.services.items():
            if svc.result_cache is None:
                continue
            ref = weakref.ref(svc.result_cache)

            def fraction(ref=ref):
                rc = ref()
                return None if rc is None \
                    else rc.nbytes / max(1, rc.config.max_bytes)

            wd.add_source(f"result_cache.{name}", fraction)

        def evict_caches(_state):
            for svc in self.services.values():
                if svc.result_cache is not None:
                    svc.result_cache.clear()

        wd.on_degraded.append(evict_caches)
        governor.register_tenant_series_gauges(
            lambda: [sh for svc in self.services.values()
                     for sh in svc.memstore.shards])
        return wd

    def shutdown(self):
        """Stop the watchdog (the governor back to OK), the fronts, the
        workers and the scheduler, save the cost models, then close the
        logs and the stores."""
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.http is not None:
            self.http.stop()
        if self.gateway is not None:
            self.gateway.stop()
        self.cluster.stop()
        for lg in self.logs.values():
            lg.close()
        for name in self.config.datasets:
            adaptive_planner.persist(name, self.meta_store)
        self.column_store.close()
        self.meta_store.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="filodb_tpu_torch standalone "
                                 "server")
    ap.add_argument("--config", help="server config JSON", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = FiloServer(ServerConfig.load(args.config),
                        device=args.device).start()
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.5)
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
