"""FiloServer: the standalone node.

Port of ``filodb_tpu/standalone.py``: local-disk column and meta stores at ``<data_dir>/columnstore``, or with
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

A cluster, as the reference's node forms one (``:238-470``): every node
serves its executor port (``executor_port``, 0: any free port;
``coordinator/remote.py::PlanExecutorServer``), which runs exec plans
shipped to it under its dataset services' locks and takes the control
messages ``start_shard``, ``stop_shard``, ``shard_status``,
``shard_events``, ``prepare_handoff``, ``shard_offset``,
``migration_status``, ``join`` and ``role`` (and ``kernel_launches``,
the port's: this process's kernel launch counts, zeroed on request, for
a smoke run that counts every node's). Without ``seeds`` the node is the
coordinator: it joins its own cluster, sets up the datasets (shards
assigned by ``min_num_nodes``), serves queries whose leaves go to the
shards' owners, polls remote members' shard statuses on its heartbeat
and runs the failure detector (a member that stops answering leaves;
its shards go to in-sync followers, or are reassigned, recovered from
this node's store and replayed from the shared logs). Its ``migration``
block sets ``auto_rebalance`` (a join levels the shard counts by live
migrations, and the watchdog going CRITICAL sheds a shard of this node's
by one), the catch-up's ``lag_threshold`` and ``catchup_timeout_s``;
its ``replication`` block ``n_replicas`` followers a shard on the
in-process members, ``in_sync_lag``, ``hedge_s`` and
``durable_sync_s``. With ``seeds`` the node is a member: it joins the
first seed that answers, takes the shards the coordinator assigns
(``start_shard``), executes the plans shipped to it on its device, and
mirrors the coordinator's map (``ShardUpdateSubscriber``, polled every
second) for ``/api/v1/cluster/{dataset}/status``; like the reference's
member it serves no query API, rules, downsampling, federation,
self-monitoring or mesh workers. Nodes of one cluster share the logs'
directory (``wal_dir``).

The remote tiers, as the reference's node wires them (``:55-81,
118-129, 316-326``): ``store_remote`` ("host:port") puts the column and
meta stores behind a chunk-store server (``core/store/remotestore.py``);
``store_server_port`` serves this node's own stores on that port.
``wal_kafka`` makes each shard's log a Kafka broker's topic partition
(``kafka/kafka_protocol.py``), else ``wal_remote`` a log server's
(``kafka/log_server.py``); ``wal_server_port`` serves this node's WAL
directory as a log server, and its own shards then go through it too.
Every reader and writer of a shard's log (the ingest worker, a
follower's tail, the gateway, the rules' and the self-monitor's sinks)
takes it from ``_shard_log``. Mesh workers tail the WAL directory
whatever these keys say, as the reference's do: beside a log server in
another process they find no records (``wal_server_port`` on this node
serves that directory, so there they do).

Discovery and failover, as the reference's node does them
(``:342-392, 748-800``): with ``consul`` the node registers its executor
port with the agent first, then, without ``seeds``, joins a discovered
node that answers ``role`` as the coordinator (or a member naming one),
or else the lowest (host, port) forms the cluster and the others join
it; shutdown deregisters. With ``enable_failover`` every node registers
in ``<wal_dir>/members.txt`` (``MemberRegistry``); a member pings the
coordinator every 0.25 s and, after three misses, the first name among
the members still answering promotes itself: a cluster of its own with
the running members adopted as they are, the dead coordinator's shards
assigned to the survivors (below ``min_num_nodes`` if need be), the
query API served, the registry's coordinator line its own.

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

``FILODB_PROFILER`` set starts the sampling profiler
(``utils/profiler.py``) at ``start``, as the reference's node does. When
``main`` stops and the profiler or either checker of the package's
switches (``FILODB_LOCKCHECK``, ``FILODB_RACECHECK``) is on, it prints
one JSON line, ``{"debug_report": {"lockcheck": [...], "racecheck":
[...], "profiler": [...]}}``: each violation rendered, and the
profiler's top frames.

It runs on the CUDA cards: the mesh engines spread each leaf over a
``make_query_mesh()`` of every visible card (1×1 on a host of one), the
rest runs on the first; ``device="cuda:N"`` pins every engine to that
card, and ``device="cpu"`` runs every kernel's plain version on the CPU,
as the tests do. Without a card it raises; nothing carries on on the CPU
unasked. Options the port lacks raise at
construction (``ServerConfig.check_supported``).

    python -m filodb_tpu_torch.standalone --config conf/server.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time
import weakref

from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.coordinator import adaptive_planner
from filodb_tpu_torch.coordinator.bootstrap import (
    RemoteNodeHandle,
    ShardUpdateSubscriber,
    poll_remote_statuses,
)
from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.remote import (
    PlanExecutorServer,
    RemotePlanDispatcher,
)
from filodb_tpu_torch.coordinator.shardmapper import ShardManager, ShardStatus
from filodb_tpu_torch.core.store.config import IngestionConfig, StoreConfig
from filodb_tpu_torch.core.store.localstore import (
    LocalDiskColumnStore,
    LocalDiskMetaStore,
)
# imported whatever the backend, so the filodb_objectstore_* metric
# families are registered at boot, as the reference's node registers them
from filodb_tpu_torch.core.store.objectstore import open_object_store
from filodb_tpu_torch.core.store.remotestore import (
    ChunkStoreServer,
    RemoteColumnStore,
    RemoteMetaStore,
)
from filodb_tpu_torch.device import resolve
from filodb_tpu_torch.parallel.mesh_engine import make_query_mesh
from filodb_tpu_torch.gateway.server import ContainerSink, GatewayServer
from filodb_tpu_torch.http.fastserver import FastHttpServer
from filodb_tpu_torch.http.server import FiloHttpServer
from filodb_tpu_torch.kafka.kafka_protocol import KafkaReplayLog
from filodb_tpu_torch.kafka.log import ReplayLog, SegmentedFileLog
from filodb_tpu_torch.kafka.log_server import LogServer, RemoteLog
# imported whatever the config, so the filodb_rules_* and filodb_alerts_*
# families are registered at boot, as the reference's node registers them
from filodb_tpu_torch.rules import LogSink, RuleManager, load_groups
from filodb_tpu_torch.utils import (
    governor,
    lockcheck,
    racecheck,
    resilience,
    tracing,
)
from filodb_tpu_torch.utils.profiler import SimpleProfiler

log = logging.getLogger(__name__)


class FiloServer:
    def __init__(self, config: ServerConfig, device=None):
        config.check_supported()
        self.config = config
        resilience.configure(**config.resilience)
        governor.configure(**config.governor)
        tracing.configure(**config.tracing)
        self.device = resolve(device)
        # the mesh engines' (shard, time) mesh: every visible card unless
        # a device is named (``cuda:N``: that card alone; ``cpu``: one CPU
        # slot); with one card it is 1×1, the one-card engine
        self.mesh = make_query_mesh() if device is None else None
        os.makedirs(config.data_dir, exist_ok=True)
        self.store_server = None     # the chunk-store server's role
        self.log_server = None       # the log broker's role
        if config.store_remote:
            # the durable tier behind a chunk-store server
            host, port = config.store_remote.rsplit(":", 1)
            self.column_store = RemoteColumnStore(host, int(port))
            self.meta_store = RemoteMetaStore(host, int(port))
        else:
            if config.store.get("backend") == "object":
                self.column_store, self.meta_store = open_object_store(
                    config.store, config.data_dir)
            else:
                root = os.path.join(config.data_dir, "columnstore")
                self.column_store = LocalDiskColumnStore(root)
                self.meta_store = LocalDiskMetaStore(root)
            if config.store_server_port:
                self.store_server = ChunkStoreServer(
                    host="0.0.0.0", port=config.store_server_port,
                    backing=self.column_store, meta=self.meta_store).start()
        self.node = Node(config.node_name, self.column_store, self.meta_store)
        self.cluster = FilodbCluster()
        self.logs: dict[tuple[str, int], ReplayLog] = {}
        self.services: dict = {}
        self.http = None
        self.gateway: GatewayServer | None = None
        self.watchdog: governor.MemoryWatchdog | None = None
        self.rule_managers: dict[str, RuleManager] = {}
        self.selfmon = None
        self.mesh_supervisor = None  # the mesh worker processes
        self.mesh_runtime = None     # the root's descriptor router
        self.executor = None         # the executor port's server
        self.is_coordinator = not config.seeds
        self._coord_addr = None      # a member's coordinator
        self.shard_subscribers: dict = {}  # a member's map mirrors
        self._consul = None          # the Consul agent registered with
        self._ds_threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self.profiler: SimpleProfiler | None = None
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

    def _shard_log(self, dataset: str, shard: int) -> ReplayLog:
        """The shard's log, one a shard for every reader and writer of
        this node: a Kafka broker's topic partition (``wal_kafka``), a log
        server's (``wal_remote``), else the file log in the WAL
        directory."""
        key = (dataset, shard)
        if key not in self.logs:
            if self.config.wal_kafka:
                host, port = self.config.wal_kafka.rsplit(":", 1)
                self.logs[key] = KafkaReplayLog(host, int(port), dataset,
                                                shard)
            elif self.config.wal_remote:
                host, port = self.config.wal_remote.rsplit(":", 1)
                self.logs[key] = RemoteLog(host, int(port), dataset, shard)
            else:
                self.logs[key] = SegmentedFileLog(
                    self._wal_path(dataset, shard),
                    fsync=self.config.wal_fsync)
        return self.logs[key]

    def start(self) -> "FiloServer":
        cfg = self.config
        if cfg.wal_server_port:
            # the broker's role: this node's WAL directory over TCP, and
            # its own shards through the server too (one owner a file)
            self.log_server = LogServer(
                cfg.wal_dir or os.path.join(cfg.data_dir, "wal"),
                port=cfg.wal_server_port).start()
            if not cfg.wal_remote:
                cfg.wal_remote = f"127.0.0.1:{self.log_server.port}"
        # the services the executor port runs shipped plans on: the
        # coordinator's query services, a member's exec-only ones
        executed: dict = {}
        self.executor = PlanExecutorServer(
            executed, port=cfg.executor_port, extra_handlers={
                "start_shard": self._handle_start_shard,
                "stop_shard": self._handle_stop_shard,
                "shard_status": self._handle_shard_status,
                "shard_events": self._handle_shard_events,
                "prepare_handoff": self._handle_prepare_handoff,
                "shard_offset": self._handle_shard_offset,
                "migration_status": self._handle_migration_status,
                "join": self._handle_join,
                "role": self._handle_role,
                "kernel_launches": self._handle_kernel_launches,
            }).start()
        self.node.executor_port = self.executor.port
        if cfg.consul:
            self._consul_bootstrap()
        self.is_coordinator = not cfg.seeds
        if cfg.seeds:
            self._start_member(executed)
        else:
            self._start_coordinator()
            executed.update(self.services)
        self.watchdog = self._watchdog().start()
        if os.environ.get("FILODB_PROFILER"):
            # the reference's SimpleProfiler, started from FiloServer.start
            self.profiler = SimpleProfiler().start()
        http_cls = FastHttpServer if cfg.http_impl == "fast" \
            else FiloHttpServer
        self.http = http_cls(self.services, port=cfg.http_port,
                             cluster=self.cluster if self.is_coordinator
                             else None,
                             reuse_port=cfg.http_reuse_port,
                             response_cache=cfg.http_response_cache,
                             rule_managers=self.rule_managers,
                             shard_maps={
                                 name: (lambda s=sub: s.mapper)
                                 for name, sub in
                                 self.shard_subscribers.items()}).start()
        if cfg.gateway_port:
            first = next(iter(cfg.datasets.values()))
            sink = ContainerSink(
                {s: self._shard_log(first.dataset, s)
                 for s in range(first.num_shards)},
                first.num_shards, cfg.spreads.get(first.dataset, 1),
                dataset=first.dataset)
            self.gateway = GatewayServer(sink, port=cfg.gateway_port).start()
        if cfg.enable_failover:
            self._setup_failover()
        log.info("FiloServer up: http=%d executor=%d gateway=%s role=%s "
                 "device=%s", self.http.port, self.executor.port,
                 self.gateway.port if self.gateway else "off",
                 "coordinator" if self.is_coordinator else "member",
                 self.device)
        return self

    def _start_coordinator(self) -> None:
        """The coordinator's role: its own node first, the datasets and
        their services, remote members' statuses on the heartbeat, the
        failure detector, then the planes only a coordinator runs."""
        cfg = self.config
        mig = cfg.migration or {}
        self.cluster.auto_rebalance = bool(mig.get("auto_rebalance", False))
        self.cluster.migration_lag_threshold = int(mig.get("lag_threshold",
                                                           0))
        self.cluster.migration_catchup_timeout_s = float(
            mig.get("catchup_timeout_s", 30.0))
        rep = cfg.replication or {}
        self.cluster.replication = int(rep.get("n_replicas", 0))
        self.cluster.replica_in_sync_lag = int(rep.get("in_sync_lag", 0))
        self.cluster.replica_hedge_s = float(rep.get("hedge_s", 0.05))
        self.cluster.replica_durable_sync_s = float(
            rep.get("durable_sync_s", 5.0))
        self.cluster.join(self.node)
        for name, ing in cfg.datasets.items():
            logs = {s: self._shard_log(name, s)
                    for s in range(ing.num_shards)}
            self.cluster.setup_dataset(ing, logs, cfg.spreads.get(name, 1))
            self.services[name] = self.cluster.query_service(
                name, engine=cfg.engines.get(name, "mesh"),
                device=self.device, result_cache=cfg.result_cache,
                mesh=self.mesh)
            self.cluster.on_heartbeat.append(
                lambda n=name: poll_remote_statuses(self.cluster, n))
            # learned cost estimates, before any query is admitted
            adaptive_planner.install(name, self.meta_store, cfg.cost_model)
        self.cluster.start_failure_detector()
        if cfg.downsample:
            self._setup_downsampling()
        # federation wraps the planner a dataset has by now: raw only, or
        # raw and downsample
        self._setup_federation()
        self._start_mesh_workers()
        self._setup_rules()
        if (cfg.selfmon or {}).get("enabled"):
            self._start_selfmon()

    def _start_member(self, executed: dict) -> None:
        """The member's role: an exec service a dataset for shipped plans,
        a join at the first seed that answers (the coordinator assigns
        shards back through ``start_shard``), then a mirror of its map a
        dataset, polled every second."""
        cfg = self.config
        for name, ing in cfg.datasets.items():
            executed[name] = QueryService(
                self.node.setup_dataset(ing, cfg.spreads.get(name, 1)),
                device=self.device, engine="exec")
        for seed in cfg.seeds:
            host, port = seed.rsplit(":", 1)
            try:
                RemotePlanDispatcher(host, int(port)).call(
                    "join", cfg.node_name, self.node.host,
                    self.executor.port)
            except (ConnectionError, OSError, RuntimeError) as e:
                log.warning("seed %s unreachable: %s", seed, e)
                continue
            self._coord_addr = (host, int(port))
            break
        else:
            raise RuntimeError(f"could not join any seed of {cfg.seeds}")
        coord = RemotePlanDispatcher(*self._coord_addr)
        for name, ing in cfg.datasets.items():
            self.shard_subscribers[name] = ShardUpdateSubscriber(
                name, ing.num_shards, coord)
        t = threading.Thread(target=self._poll_shard_maps, daemon=True,
                             name="shard-updates")
        t.start()
        self._ds_threads.append(t)

    def _poll_shard_maps(self) -> None:
        while not self._stop.wait(1.0):
            for sub in self.shard_subscribers.values():
                try:
                    sub.poll()
                except Exception:  # noqa: BLE001 - the next poll retries
                    log.debug("shard-update poll failed", exc_info=True)

    # -- control messages (the reference's ``standalone.py:238-312``) --

    def _handle_start_shard(self, dataset: str, shard: int):
        self.node.start_shard(dataset, shard, self.config.datasets[dataset],
                              self._shard_log(dataset, shard))
        return True

    def _handle_stop_shard(self, dataset: str, shard: int):
        self.node.stop_shard(dataset, shard)
        return True

    def _handle_prepare_handoff(self, dataset: str, shard: int):
        """A migration's source: flush, drain and snapshot the shard;
        its latest offset."""
        return self.node.prepare_handoff(dataset, shard)

    def _handle_shard_offset(self, dataset: str, shard: int):
        return self.node.shard_offset(dataset, shard)

    def _handle_migration_status(self, dataset: str):
        """The coordinator's migrations in flight of ``dataset``."""
        return [m.snapshot() for (d, _s), m in
                list(self.cluster.migrations.items()) if d == dataset]

    def _handle_shard_status(self, dataset: str):
        return [(s, "active" if w.caught_up.is_set() else "recovery")
                for (d, s), w in list(self.node._workers.items())
                if d == dataset]

    def _handle_shard_events(self, dataset: str, since_seq: int,
                             epoch: str | None = None):
        """The coordinator's sequenced shard events for a member's mirror,
        as the reference's 6-tuples (replica sets included)."""
        sm = self.cluster.shard_managers.get(dataset)
        if sm is None:
            return ([], since_seq, False, epoch)
        events, seq, resynced, ep = sm.events_since(since_seq, epoch)
        return ([(e.shard, e.status.name, e.node, e.progress, e.replica,
                  e.watermark) for e in events], seq, resynced, ep)

    def _handle_role(self):
        if self.is_coordinator:
            return ("coordinator", None, None)
        if self._coord_addr is not None:
            return ("member", *self._coord_addr)
        return ("undecided", None, None)

    def _handle_join(self, name: str, host: str, control_port: int):
        """A member joined: assignment (which calls back to the member)
        runs off the handler's thread, so the reply does not wait for the
        member's own start."""

        def do_join():
            try:
                self.cluster.join(RemoteNodeHandle(name, host,
                                                   control_port))
            except Exception:
                log.exception("join of %s failed", name)

        threading.Thread(target=do_join, daemon=True,
                         name=f"join-{name}").start()
        return True

    @staticmethod
    def _handle_kernel_launches(reset: bool = False) -> dict:
        from filodb_tpu_torch import _build

        out = dict(_build.LAUNCHES)
        if reset:
            _build.reset_counts()
        return out

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
        if self.is_coordinator and self.cluster.auto_rebalance:
            # CRITICAL sheds a whole shard to a peer by a live migration,
            # off the watchdog's thread (a migration blocks through its
            # catch-up)
            cluster, me = self.cluster, self.config.node_name

            def shed_on_pressure(state):
                if state != "critical" or len(cluster.nodes) < 2:
                    return
                threading.Thread(target=lambda: cluster.shed_load(me),
                                 daemon=True, name="shed-load").start()

            wd.on_degraded.append(shed_on_pressure)
        governor.register_tenant_series_gauges(
            lambda: [sh for svc in self.services.values()
                     for sh in svc.memstore.shards])
        return wd

    # -- discovery (the reference's ``:342-392``) --

    def _consul_bootstrap(self) -> None:
        """Register with the Consul agent; without seeds, join an
        established cluster a discovered node names, or else the lowest
        (host, port) forms it and the others join it."""
        from filodb_tpu_torch.coordinator.bootstrap import ConsulDiscovery

        cfg = self.config
        self._consul = ConsulDiscovery(
            host=cfg.consul.get("host", "127.0.0.1"),
            port=int(cfg.consul.get("port", 8500)),
            service_name=cfg.consul.get("service", "filodb"))
        adv = cfg.consul.get("advertise", "127.0.0.1")
        me = (adv, self.executor.port)
        try:
            self._consul.register(cfg.node_name, adv, self.executor.port)
        except OSError as e:
            log.warning("consul register failed: %s", e)
        if cfg.seeds:
            return
        others = sorted(t for t in self._consul.discover() if tuple(t) != me)
        coord = None
        for h, p in others:
            try:
                role, ch, cp = RemotePlanDispatcher(h, p).call("role")
            except (ConnectionError, OSError, RuntimeError):
                continue
            if role == "coordinator":
                coord = (h, p)
                break
            if role == "member" and ch:
                coord = (ch, cp)
                break
        if coord is not None:
            cfg.seeds = [f"{coord[0]}:{coord[1]}"]
        elif others and min(others) < me:
            cfg.seeds = [f"{h}:{p}" for h, p in others]
        log.info("consul discovery: role=%s seeds=%s",
                 "member" if cfg.seeds else "coordinator", cfg.seeds)

    # -- coordinator failover (the reference's ``:748-800``) --

    def _registry(self):
        from filodb_tpu_torch.coordinator.bootstrap import MemberRegistry

        root = self.config.wal_dir or os.path.join(self.config.data_dir,
                                                   "wal")
        return MemberRegistry(os.path.join(root, "members.txt"))

    def _setup_failover(self) -> None:
        role = "coord" if self.is_coordinator else "member"
        self._registry().register(role, self.config.node_name,
                                  self.node.host, self.executor.port)
        if role == "member":
            t = threading.Thread(target=self._failover_watch, daemon=True,
                                 name="failover-watch")
            t.start()
            self._ds_threads.append(t)

    def _failover_watch(self, interval_s: float = 0.25) -> None:
        """Ping the coordinator; after three misses the first name among
        the members that answer promotes itself."""
        from filodb_tpu_torch.coordinator.bootstrap import alive_members

        reg = self._registry()
        misses = 0
        while not self._stop.wait(interval_s):
            coord = reg.current_coordinator()
            if coord == self.config.node_name:
                return
            entry = reg.members().get(coord)
            if entry is not None and RemotePlanDispatcher(
                    entry[1], entry[2], timeout=1.0).ping():
                misses = 0
                continue
            misses += 1
            if misses < 3:
                continue
            alive = alive_members(reg)
            alive.pop(coord, None)
            if alive and min(alive) == self.config.node_name:
                log.warning("coordinator %s down; promoting self", coord)
                try:
                    self._promote(alive)
                except Exception:
                    log.exception("promotion failed")
                return
            misses = 0  # another member promotes; keep watching

    def _promote(self, alive: dict) -> None:
        """Become the coordinator: a cluster of this node and the running
        members (their shards adopted as they run), the dead
        coordinator's shards assigned to the survivors, the query API
        served, the registry's coordinator line this node's."""
        cfg = self.config
        cluster = FilodbCluster()
        cluster.join(self.node)
        for name, (host, port) in alive.items():
            if name != cfg.node_name:
                cluster.nodes[name] = RemoteNodeHandle(name, host, port)
        for dataset, ing in cfg.datasets.items():
            spread = cfg.spreads.get(dataset, 1)
            cluster.configs[dataset] = ing
            cluster.spreads[dataset] = spread
            for shard in range(ing.num_shards):
                cluster.logs[(dataset, shard)] = self._shard_log(dataset,
                                                                 shard)
            # availability over balance: the survivors take the shards
            # even below min_num_nodes until members join
            sm = cluster.shard_managers[dataset] = ShardManager(
                dataset, ing.num_shards,
                min(ing.min_num_nodes, len(cluster.nodes)))
            for name, node in cluster.nodes.items():
                if name == cfg.node_name:
                    statuses = self._handle_shard_status(dataset)
                else:
                    try:
                        statuses = node.shard_status(dataset)
                    except (ConnectionError, OSError, RuntimeError):
                        statuses = []
                for shard, st in statuses:
                    sm.adopt(shard, name, ShardStatus.ACTIVE
                             if st == "active" else ShardStatus.RECOVERY)
            for ev in sm.rebalance():
                cluster._on_event(dataset, ev)
            self.services[dataset] = cluster.query_service(
                dataset, engine=cfg.engines.get(dataset, "mesh"),
                device=self.device, result_cache=cfg.result_cache,
                mesh=self.mesh)
            cluster.on_heartbeat.append(
                lambda n=dataset: poll_remote_statuses(cluster, n))
        self.cluster = cluster
        if self.http is not None:
            self.http.cluster = cluster
        cluster.start_failure_detector()
        self._registry().register("coord", cfg.node_name, self.node.host,
                                  self.executor.port)
        # last, as the reference: a reader that sees the flag sees the
        # registry name this node (§C.18)
        self.is_coordinator = True

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
        if self.executor is not None:
            self.executor.stop()
        self.cluster.stop()
        self.node.kill()
        for lg in self.logs.values():
            lg.close()
        if self.log_server is not None:
            self.log_server.stop()
        if self._consul is not None:
            try:
                self._consul.deregister(self.config.node_name)
            except OSError:
                pass
        for name in self.config.datasets:
            adaptive_planner.persist(name, self.meta_store)
        if self.store_server is not None:
            self.store_server.shutdown()
        self.column_store.close()
        self.meta_store.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="filodb_tpu_torch standalone "
                                 "server")
    ap.add_argument("--config", help="server config JSON", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda:N (that card alone) or cpu; by default the "
                    "query engines spread over every visible card")
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
    report = debug_report(server)
    if report is not None:
        print(json.dumps({"debug_report": report}), flush=True)
    return 0


def debug_report(server: FiloServer, top_n: int = 20) -> dict | None:
    """The checkers' violations and the profiler's top frames, or None
    where neither checker is installed and no profiler runs."""
    if server.profiler is None and not lockcheck.installed() \
            and not racecheck.installed():
        return None
    frames = []
    if server.profiler is not None:
        frames = server.profiler.stop().splitlines()[:top_n]
    return {"lockcheck": [v.render() for v in lockcheck.violations()],
            "racecheck": [v.render() for v in racecheck.violations()],
            "profiler": frames}


if __name__ == "__main__":
    sys.exit(main())
