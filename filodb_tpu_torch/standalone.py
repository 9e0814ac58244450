"""FiloServer: the standalone node.

Port of ``filodb_tpu/standalone.py`` for one node in the coordinator role:
local-disk column and meta stores at ``<data_dir>/columnstore``, or with
``store.backend = "object"`` the object-store tier
(``core/store/objectstore.py::open_object_store``: a directory-backed
``FakeS3`` under ``<data_dir>/objectstore`` or the ``store.endpoint``
path, or an S3 service at an ``http(s)://`` endpoint), a
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

Long retention, as the reference's node wires it: a dataset's
``downsample`` block starts the downsampler job's thread (``catch_up``
every ``schedule_s``, its checkpoints in the meta store, the ds store's
index refreshed after each run) and puts a ``LongTimeRangePlanner`` over
the raw planner and a downsample planner, whose leaves read a
``DownsampledTimeSeriesStore`` of the smallest resolution, or with
``streaming`` the node's co-sharded ds dataset of it. Then
``federation.mem_retention_ms`` wraps whatever planner a dataset has in a
``TieredPlanner`` (memstore, the cold raw tier over the column store, and
the downsample tier where there is one).

The multi-process mesh runtime, as the reference's node boots it:
``mesh_workers.enabled`` spawns ``workers`` mesh worker processes
(``parallel/multiproc.py``) on this node's device, each a contiguous
slice of the dataset's shards (``mesh_workers.dataset``, the first one
by default), writes their config to ``<data_dir>/
mesh_worker_config.json`` (they recover from this node's stores and tail
its WAL read-only; ``mesh_workers.seed`` hands them a seed callable
instead), waits ``ready_timeout_s`` for them and boots degraded where
they are late (every query falls back until they answer), and puts a
``MeshClusterRuntime`` on the dataset's service. Shutdown stops the
workers.

Standing queries and self-monitoring, as the reference's node wires them:
``rules.groups`` starts one ``RuleManager`` a dataset (``rules/``), its
outputs written through the shards' logs, ticking once the dataset's
shards have replayed their logs, with a ``WebhookNotifier`` where
``rules.notify.webhook_url`` is set; ``selfmon.enabled`` adds the
``_meta`` dataset after the user's, a ``MetaMonitor`` that writes the
node's metric registry there every ``interval_s`` and, unless
``default_alerts`` is false, the ``selfmon_default`` alert group over it.
Shutdown stops both before the logs close.

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
import threading
import time
import weakref

from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.coordinator import adaptive_planner
from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
from filodb_tpu_torch.core.store.config import IngestionConfig, StoreConfig
from filodb_tpu_torch.core.store.localstore import (
    LocalDiskColumnStore,
    LocalDiskMetaStore,
)
# imported whatever the backend, so the filodb_objectstore_* metric
# families are registered at boot, as the reference's node registers them
from filodb_tpu_torch.core.store.objectstore import open_object_store
from filodb_tpu_torch.device import resolve
from filodb_tpu_torch.gateway.server import ContainerSink, GatewayServer
from filodb_tpu_torch.http.fastserver import FastHttpServer
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.kafka.log import SegmentedFileLog
# imported whatever the config, so the filodb_rules_* and filodb_alerts_*
# families are registered at boot, as the reference's node registers them
from filodb_tpu_torch.rules import LogSink, RuleManager, load_groups
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
        if config.store.get("backend") == "object":
            self.column_store, self.meta_store = open_object_store(
                config.store, config.data_dir)
        else:
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
        self.rule_managers: dict[str, RuleManager] = {}
        self.selfmon = None
        self.mesh_supervisor = None  # the mesh worker processes
        self.mesh_runtime = None     # the root's descriptor router
        self._ds_threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._setup_meta_dataset()

    def _setup_meta_dataset(self) -> None:
        """The ``_meta`` self-monitoring dataset, where ``selfmon`` is
        enabled: appended after the user's datasets, since the gateway
        and the rules' default dataset take the first one."""
        sm_cfg = self.config.selfmon or {}
        if not sm_cfg.get("enabled") or "_meta" in self.config.datasets:
            return
        self.config.datasets["_meta"] = IngestionConfig(
            dataset="_meta", num_shards=int(sm_cfg.get("num_shards", 1)),
            min_num_nodes=1, store=StoreConfig(groups_per_shard=4))
        self.config.spreads["_meta"] = 0

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
        if cfg.downsample:
            self._setup_downsampling()
        # federation wraps the planner a dataset has by now: raw only, or
        # raw and downsample
        self._setup_federation()
        self._start_mesh_workers()
        self.watchdog = self._watchdog().start()
        self._setup_rules()
        if (cfg.selfmon or {}).get("enabled"):
            self._start_selfmon()
        http_cls = FastHttpServer if cfg.http_impl == "fast" \
            else FiloHttpServer
        self.http = http_cls(self.services, port=cfg.http_port,
                             cluster=self.cluster,
                             reuse_port=cfg.http_reuse_port,
                             response_cache=cfg.http_response_cache,
                             rule_managers=self.rule_managers).start()
        if cfg.gateway_port:
            first = next(iter(cfg.datasets.values()))
            sink = ContainerSink(
                {s: self._shard_log(first.dataset, s)
                 for s in range(first.num_shards)},
                first.num_shards, cfg.spreads.get(first.dataset, 1),
                dataset=first.dataset)
            self.gateway = GatewayServer(sink, port=cfg.gateway_port).start()
        log.info("FiloServer up: http=%d gateway=%s device=%s",
                 self.http.port,
                 self.gateway.port if self.gateway else "off", self.device)
        return self

    def _start_mesh_workers(self) -> None:
        """Spawn the mesh workers and attach the runtime to the dataset's
        service (see the module's text)."""
        import dataclasses
        import json

        cfg = self.config
        mw = dict(cfg.mesh_workers or {})
        if not mw.get("enabled") or not self.services:
            return
        ds = mw.get("dataset") or next(iter(cfg.datasets))
        if ds not in self.services:
            log.warning("mesh_workers.dataset %r not served here; "
                        "multi-process mesh disabled", ds)
            return
        ing = cfg.datasets[ds]
        seed = mw.get("seed") or None
        config_path = None
        if not seed:
            config_path = os.path.join(cfg.data_dir,
                                       "mesh_worker_config.json")
            with open(config_path, "w") as f:
                json.dump({"data_dir": cfg.data_dir, "wal_dir": cfg.wal_dir,
                           "datasets": {ds: {
                               "num_shards": ing.num_shards,
                               "store": dataclasses.asdict(ing.store)}}}, f)
        from filodb_tpu_torch.coordinator.mesh_cluster import (
            MeshClusterRuntime,
        )
        from filodb_tpu_torch.parallel.multiproc import MeshWorkerSupervisor

        sup = MeshWorkerSupervisor(
            dataset=ds, num_shards=ing.num_shards,
            workers=int(mw.get("workers", 2)),
            base_port=int(mw.get("base_port", 0)),
            config_path=config_path, seed=seed,
            device=self.device.type).spawn()
        self.mesh_supervisor = sup
        try:
            sup.wait_ready(timeout_s=float(mw.get("ready_timeout_s",
                                                  120.0)))
        except (TimeoutError, RuntimeError) as e:
            log.warning("mesh workers not ready (%s); serving through the "
                        "single-process engines until they are", e)
        self.mesh_runtime = MeshClusterRuntime(
            self.services[ds].memstore, ds, ing.num_shards,
            sup.addresses(), timeout=float(mw.get("timeout_s", 30.0)),
            device=self.device)
        self.services[ds].mesh_cluster = self.mesh_runtime

    def _setup_rules(self) -> None:
        """One ``RuleManager`` a dataset with rule groups (the user's, and
        with ``selfmon`` its default alert group over ``_meta``), writing
        its outputs through the shards' logs (``LogSink``), ticking every
        ``rules.tick_s`` once the dataset's shards are ACTIVE: a tick during
        the logs' replay would read a horizon of the part replayed so far
        and start a group below its durable watermark (ROADMAP §C)."""
        cfg = self.config
        rules_cfg = dict(cfg.rules or {})
        sm_cfg = cfg.selfmon or {}
        groups_cfg = list(rules_cfg.get("groups") or [])
        if sm_cfg.get("enabled") and sm_cfg.get("default_alerts", True):
            groups_cfg.append(self._default_meta_alerts(sm_cfg))
        if not groups_cfg:
            return
        rules_cfg["groups"] = groups_cfg
        by_ds: dict[str, list] = {}
        for grp in load_groups(rules_cfg, next(iter(cfg.datasets))):
            by_ds.setdefault(grp.dataset, []).append(grp)
        notify_cfg = rules_cfg.get("notify", {}) or {}
        for ds, grps in by_ds.items():
            ing = cfg.datasets[ds]
            sink = LogSink({s: self._shard_log(ds, s)
                            for s in range(ing.num_shards)},
                           ing.num_shards, cfg.spreads.get(ds, 1))
            # _meta holds only samples stamped at tick time: the default
            # five-minute out-of-order allowance would hold its alerts
            # that far behind the ingest clock
            ooo = (int(sm_cfg.get("ooo_allowance_ms", 2_000))
                   if ds == "_meta" else None)
            mgr = self.rule_managers[ds] = RuleManager(
                self.services[ds], sink, grps, ooo_allowance_ms=ooo,
                max_catchup_steps=int(rules_cfg.get("max_catchup_steps",
                                                    512)),
                notifier=self._build_notifier(notify_cfg))
            t = threading.Thread(
                target=self._start_when_active, daemon=True,
                name=f"rules-start-{ds}",
                args=(ds, mgr, float(rules_cfg.get("tick_s", 1.0))))
            t.start()
            self._ds_threads.append(t)

    def _start_when_active(self, dataset: str, mgr: RuleManager,
                           tick_s: float) -> None:
        """Start ``mgr``'s ticks once every shard of ``dataset`` is ACTIVE
        (a manager stopped meanwhile starts a thread that ends at once)."""
        while not self._stop.is_set():
            if self.cluster.wait_active(dataset, timeout=1.0):
                mgr.start(tick_s)
                return

    def _start_selfmon(self) -> None:
        """The ``MetaMonitor``: the node's metric registry into ``_meta``
        every ``selfmon.interval_s``, through its shards' logs."""
        from filodb_tpu_torch.utils.selfmon import MetaMonitor

        cfg, sm_cfg = self.config, self.config.selfmon
        ing = cfg.datasets["_meta"]
        sink = LogSink({s: self._shard_log("_meta", s)
                        for s in range(ing.num_shards)},
                       ing.num_shards, cfg.spreads.get("_meta", 0))
        self.selfmon = MetaMonitor(
            sink, interval_s=float(sm_cfg.get("interval_s", 15.0)),
            node=cfg.node_name,
            instance=f"{cfg.node_name}:{cfg.http_port}",
            include_buckets=bool(sm_cfg.get("include_buckets", False)))
        self.selfmon.start()

    @staticmethod
    def _build_notifier(notify_cfg: dict):
        """The webhook notifier of alert transitions; None without a
        ``webhook_url``."""
        url = notify_cfg.get("webhook_url")
        if not url:
            return None
        from filodb_tpu_torch.rules.notify import WebhookNotifier
        from filodb_tpu_torch.utils.resilience import RetryPolicy

        return WebhookNotifier(
            url, timeout_s=float(notify_cfg.get("timeout_s", 5.0)),
            retry_policy=RetryPolicy(
                max_attempts=int(notify_cfg.get("max_attempts", 4)),
                base_backoff_s=0.1, max_backoff_s=2.0),
            queue_depth=int(notify_cfg.get("queue_depth", 256)))

    @staticmethod
    def _default_meta_alerts(sm_cfg: dict) -> dict:
        """The shipped alert group over ``_meta``: shard ingest lag, and a
        circuit breaker open (no series on one node, so never active)."""
        thr = float(sm_cfg.get("lag_alert_threshold_s", 60.0))
        return {
            "name": "selfmon_default",
            "dataset": "_meta",
            "interval": sm_cfg.get("alert_interval", "5s"),
            "rules": [
                {"alert": "FilodbIngestLagHigh",
                 "expr": f"max(filodb_ingest_lag_seconds) > {thr}",
                 "for": sm_cfg.get("lag_alert_for", "30s"),
                 "labels": {"severity": "warning"},
                 "annotations": {"summary":
                                 "shard ingest lag above threshold"}},
                {"alert": "FilodbBreakerOpen",
                 "expr": "max(filodb_breaker_state) >= 2",
                 "for": "0s",
                 "labels": {"severity": "warning"},
                 "annotations": {"summary":
                                 "a circuit breaker to a peer is open"}},
            ],
        }

    def _setup_downsampling(self) -> None:
        """Each dataset's downsampler job thread and long-time planner."""
        from filodb_tpu_torch.coordinator.longtime_planner import (
            LongTimeRangePlanner,
        )
        from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
        from filodb_tpu_torch.core.downsample import (
            DownsampledTimeSeriesStore,
            DownsamplerJob,
            ds_dataset_name,
        )
        from filodb_tpu_torch.core.downsample.downsampler import (
            DEFAULT_RESOLUTIONS_MS,
        )

        cfg = self.config
        for dataset, ds_cfg in cfg.downsample.items():
            ing = cfg.datasets[dataset]
            resolutions = tuple(ds_cfg.get("resolutions_ms",
                                           DEFAULT_RESOLUTIONS_MS))
            spread = cfg.spreads.get(dataset, 1)
            job = DownsamplerJob(
                self.column_store, dataset, ing.num_shards, resolutions,
                max_chunk_size=ing.store.max_chunk_size,
                meta_store=self.meta_store)
            name = ds_dataset_name(dataset, min(resolutions))
            if ds_cfg.get("streaming"):
                ds_store = self.node.memstores[name]
            else:
                ds_store = DownsampledTimeSeriesStore(
                    self.column_store, dataset, min(resolutions),
                    ing.num_shards)
            t = threading.Thread(
                target=self._run_job, daemon=True,
                name=f"downsampler-{dataset}",
                args=(job, ds_cfg.get("schedule_s", 6 * 3600),
                      None if ds_cfg.get("streaming") else ds_store))
            t.start()
            self._ds_threads.append(t)
            svc = self.services[dataset]
            svc.planner = LongTimeRangePlanner(
                svc.planner, SingleClusterPlanner(
                    ing.num_shards, spread, store=ds_store,
                    dataset_name_override=name),
                ds_cfg.get("raw_retention_ms", ing.store.retention_ms))

    def _run_job(self, job, schedule_s: float, ds_store) -> None:
        """The job's thread: ``catch_up`` to now, then (without streaming)
        the ds store's index refresh, every ``schedule_s`` until
        shutdown. A failed run is logged and the next one retries from
        the checkpoint."""
        while not self._stop.is_set():
            try:
                job.catch_up(int(time.time() * 1000))
                if ds_store is not None:
                    ds_store.refresh_index()
            except Exception:
                log.exception("downsampler job of %s failed", job.dataset)
            self._stop.wait(schedule_s)

    def _setup_federation(self) -> None:
        """A tiered planner over each dataset's planner, where
        ``federation`` is enabled with a ``mem_retention_ms``."""
        from filodb_tpu_torch.coordinator.longtime_planner import (
            LongTimeRangePlanner,
        )
        from filodb_tpu_torch.coordinator.tiered_planner import (
            build_tiered_planner,
        )

        fed = self.config.federation or {}
        if not fed.get("enabled", True) or not fed.get("mem_retention_ms"):
            return
        for dataset, svc in self.services.items():
            if dataset.startswith("_"):
                continue  # _meta stays in the memstore
            ing = self.config.datasets[dataset]
            raw_planner, ds_planner, raw_retention = svc.planner, None, None
            if isinstance(svc.planner, LongTimeRangePlanner):
                raw_planner = svc.planner.raw_planner
                ds_planner = svc.planner.ds_planner
                raw_retention = svc.planner.raw_retention_ms
            svc.planner = build_tiered_planner(
                raw_planner, self.column_store, dataset, ing.num_shards,
                self.config.spreads.get(dataset, 1),
                mem_retention_ms=int(fed["mem_retention_ms"]),
                raw_retention_ms=raw_retention, ds_planner=ds_planner,
                odp_max_chunks=int(fed.get("odp_max_chunks", 10_000)),
                refresh_s=float(fed.get("refresh_s", 60.0)))
            log.info("federation: %s routed across memstore%s/objectstore "
                     "(mem floor %d ms)", dataset,
                     "/downsample" if ds_planner is not None else "",
                     fed["mem_retention_ms"])

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
        """Stop the self-monitor and the rule managers (before the logs
        they write close), the watchdog (the governor back to OK), the
        fronts, the workers and the scheduler, save the cost models, then
        close the logs and the stores."""
        self._stop.set()
        if self.selfmon is not None:
            self.selfmon.stop()
        for mgr in self.rule_managers.values():
            mgr.stop()
        for t in self._ds_threads:
            t.join(timeout=30)
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.http is not None:
            self.http.stop()
        if self.gateway is not None:
            self.gateway.stop()
        if self.mesh_runtime is not None:
            self.mesh_runtime.shutdown()
        if self.mesh_supervisor is not None:
            self.mesh_supervisor.stop()
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
