"""One node: its shards' lifecycle, ingest workers and flush scheduler.

Port of the single-node part of ``filodb_tpu/coordinator/cluster.py``:

- ``Node.start_shard``: recover the shard's index (its snapshot and the
  delta since, or the full part-key scan), load its group watermarks,
  align the log past the largest checkpoint (a torn tail never hands out
  a checkpointed offset again), then start its ``_IngestWorker``, which
  replays the log from the recovery start and then tails it. The shard is
  RECOVERY until the replay reaches the log's end, then ACTIVE; a record
  that fails to ingest stops the worker and surfaces ERROR.
- ``_FlushScheduler``: one thread a node; each tick runs ``shard_tick``
  on every shard (flush the next group, round robin; hold the resident
  chunks to ``shard_mem_mb``; purge past ``retention_ms``, in the
  reference's order), truncates the shard's log below its smallest group
  watermark (over the object store, its smallest landed checkpoint: the
  upload goes behind), and writes the shard's index snapshot every
  ``index_snapshot_interval_ms``. A tick comes every ``flush_interval /
  groups`` (between 0.5 and 300 s).
- ``FilodbCluster`` (the reference's ``filodb_tpu/coordinator/
  cluster.py:521-553, 730-772, 786-888``): ``join`` and ``leave`` of any
  number of members, in-process nodes (``Node``) or members in other
  processes (``coordinator/bootstrap.py::RemoteNodeHandle``; a joining
  remote member's breaker closes; a leaving one's is forced open, so
  queries skip it without a dial), ``setup_dataset`` (shards assigned by ``ShardManager`` and
  started on their node), the failure detector (``start_failure_detector``:
  a heartbeat every ``heartbeat_interval_s``; a member not ``alive`` for
  ``failure_threshold`` beats leaves, its shards go DOWN and to the
  members left, which recover them from the store and replay them from
  the shared logs; each beat also reassigns rate-limited shards and runs
  ``on_heartbeat``), ``query_service``, ``shard_statuses``,
  ``wait_active`` and ``stop``.
- ``query_service``'s planner ships each leaf to its shard's owner
  (``dispatcher_for_shard``): a shard of the service's own node (the
  first member, the coordinator's) runs in-process on the root's context
  and batch cache, as before a cluster existed (the reference wraps its
  own node in a ``NodeDispatcher`` too, ROADMAP §C); another in-process
  node's through ``NodeDispatcher`` (``:53-68``), which runs it against
  that node's store under that node's lock, on the caller's device; a
  remote member's through ``RemotePlanDispatcher`` to its executor port.
  The service's mesh engines and caches serve only while every shard is
  the service's node's (``QueryService.shards_local``). A shard with
  in-sync followers reads through a ``ReplicaDispatcher`` over its
  leader and them (each in-process node behind a ``NodeDispatcher``
  under its own breaker), and the service's ``shard_status_fn`` names the
  shards in RECOVERY or HANDOFF, and those whose leader is down and a
  follower serves, for the answers' warnings.
- High availability (the reference's ``:212-270, 501-514, 531-537, 584,
  606-726``): ``replication`` followers a shard on other in-process
  members (``ensure_replicas``, every heartbeat: followers of dead nodes
  or of their own shards pruned, new ones on the least-loaded members;
  ``coordinator/replication.py``); a member's loss promotes in-sync
  followers, and ``Node.promote_shard`` starts the ingest worker at the
  follower's applied offset, with no store read; ``migrate_shard`` moves
  a shard between members through ``coordinator/migration.py``
  (``Node.prepare_handoff`` on the source, ``shard_offset`` both sides),
  ``resume_migration`` continues one from its manifest, and with
  ``auto_rebalance`` a join levels the shard counts by migrations
  (``maybe_rebalance``), as ``shed_load`` sheds a pressured node's.

The port's node holds a ``MemStore`` a dataset (the reference's one
``TimeSeriesMemStore`` holds every dataset), created by ``setup_dataset``
with the dataset's spread. A dataset whose ``downsample`` block sets
``streaming`` gets, beside each of its shards, the shard of each ds
dataset (``<dataset>_ds_<minutes>m``, a ``MemStore`` of its own with the
raw shard's chunk size and ``ds_retention_ms``, five times the raw
retention by default); the raw shard's flush publishes its rollups there
(``core/downsample/downsampler.py::ShardDownsampler``), and the flush
scheduler flushes those shards on its tick, as the reference's does. A
stopped shard's image stays in its node's store (the reference's tears
it down; ROADMAP §C).

A ``read_only`` node is a mesh worker's view of a node another process
runs (``parallel/multiproc.py::_tail_shards``): it recovers its shards
from that node's stores and tails its logs opened read-only
(``SegmentedFileLog(read_only=True)``), and starts no flush scheduler:
flushes, checkpoints and the logs' retention stay the owner's.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from dataclasses import dataclass, field

from filodb_tpu_torch.coordinator.migration import (
    MigrationError,
    ShardMigration,
)
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.coordinator.replication import (
    ReplicaCandidate,
    ReplicaDispatcher,
    ReplicaSyncer,
)
from filodb_tpu_torch.coordinator.shardmapper import ShardManager, ShardStatus
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.store.api import (
    ColumnStore,
    InMemoryColumnStore,
    InMemoryMetaStore,
    MetaStore,
)
from filodb_tpu_torch.core.store.config import IngestionConfig
from filodb_tpu_torch.kafka.log import ReplayLog
from filodb_tpu_torch.query.engine.device_batch import BatchCache
from filodb_tpu_torch.query.exec.plan import ExecContext, PlanDispatcher
from filodb_tpu_torch.query.model import QueryResult, QueryStats
from filodb_tpu_torch.utils.metrics import GaugeFn, get_counter
from filodb_tpu_torch.utils.resilience import FaultInjector, breaker_for
from filodb_tpu_torch.utils.selfmon import STAMPS

log = logging.getLogger(__name__)


class NodeDispatcher(PlanDispatcher):
    """Runs a plan against another in-process node's store (the
    reference's ``NodeDispatcher``, standing in for the remote dispatcher
    where nodes share a process): under that node's lock, on the caller's
    device, with the node's own batch cache and stats. A node that is not
    ``alive`` raises ``ConnectionError``, a lost child to a gather. No
    wire fields: it fails at encode rather than losing its node."""

    def __init__(self, node: "Node"):
        self.node = node

    def dispatch(self, plan, ctx):
        FaultInjector.fire("node.dispatch", node=self.node.name)
        if not self.node.alive:
            raise ConnectionError(f"node {self.node.name} is down")
        with self.node.query_lock:
            ctx2 = ExecContext(self.node.memstores[ctx.dataset],
                               QueryStats(engine="exec"), ctx.device,
                               self.node.batch_cache(ctx.device),
                               deadline=ctx.deadline, dataset=ctx.dataset,
                               qcontext=ctx.qcontext)
            data = plan.execute(ctx2)
        return QueryResult(data, ctx2.stats, ctx.qcontext.query_id,
                           partial=ctx2.partial,
                           warnings=list(ctx2.warnings))


@dataclass
class Node:
    """One member: a store a dataset over its column and meta stores, an
    ingest worker a shard it owns, and its flush scheduler."""

    name: str
    column_store: ColumnStore = field(default_factory=InMemoryColumnStore)
    meta_store: MetaStore = field(default_factory=InMemoryMetaStore)
    alive: bool = True
    flush_tick_s: float | None = None  # override the scheduler's cadence
    read_only: bool = False  # a tailer of another process's node
    memstores: dict = field(default_factory=dict)  # dataset → MemStore
    # (dataset, shard) → {"keys", "index_s", "start_offset"}
    recovery: dict = field(default_factory=dict)
    _workers: dict = field(default_factory=dict)  # (dataset, shard) → worker
    _flusher: object = None
    # (ds dataset, shard) of the streaming rollups the scheduler flushes
    _ds_shards: list = field(default_factory=list)
    executor_port: int | None = None  # where a PlanExecutorServer fronts it
    host: str = "127.0.0.1"
    # plans other nodes hand this one run one at a time, against its own
    # batches (``NodeDispatcher``)
    query_lock: object = field(default_factory=threading.RLock)
    _batches: dict = field(default_factory=dict)  # device → BatchCache

    def batch_cache(self, device) -> BatchCache:
        key = str(device)
        if key not in self._batches:
            self._batches[key] = BatchCache(device)
        return self._batches[key]

    def owned_shards(self, dataset: str) -> list[int]:
        """The shards of ``dataset`` this node ingests, sorted."""
        return sorted(s for d, s in self._workers if d == dataset)

    def stop_shard(self, dataset: str, shard: int) -> None:
        w = self._workers.pop((dataset, shard), None)
        if w is not None:
            w.stop()

    def setup_dataset(self, config: IngestionConfig,
                      spread: int = 1) -> MemStore:
        ms = self.memstores.get(config.dataset)
        if ms is None:
            ms = self.memstores[config.dataset] = MemStore(
                config.num_shards, spread, column_store=self.column_store,
                meta_store=self.meta_store, config=config.store,
                dataset=config.dataset)
        return ms

    def start_shard(self, dataset: str, shard: int, config: IngestionConfig,
                    shard_log: ReplayLog, on_status=None) -> None:
        """Recover the shard, then replay and tail its log (the reference's
        ``IngestionActor.start``)."""
        key = (dataset, shard)
        if key in self._workers:
            return
        # a migration's destination may hold a view of the shard's durable
        # state from before the source's upload: read it again
        refresh = getattr(self.column_store, "refresh_shard", None)
        if callable(refresh) and not self.read_only:
            refresh(dataset, shard)
        s = self.setup_dataset(config).shards[shard]
        t0 = time.perf_counter()
        keys = s.recover_index()
        index_s = time.perf_counter() - t0
        start_offset = s.setup_watermarks_for_recovery()
        shard_log.align_after(int(s.group_watermarks.max()))
        self.recovery[key] = {"keys": keys, "index_s": index_s,
                              "start_offset": start_offset}
        ds_cfg = config.downsample or {}
        if ds_cfg.get("streaming"):
            self._setup_streaming_downsample(config, shard, s, ds_cfg)
        if on_status:
            on_status(shard, ShardStatus.RECOVERY, 0)
        worker = _IngestWorker(self, s, shard_log, start_offset, on_status)
        self._workers[key] = worker
        worker.start()
        _register_lag_gauges(dataset, shard, s, shard_log, worker)
        if self._flusher is None and not self.read_only:
            self._flusher = _FlushScheduler(self, self.flush_tick_s)
            self._flusher.start()

    def _setup_streaming_downsample(self, config: IngestionConfig,
                                    shard: int, raw_shard,
                                    ds_cfg: dict) -> None:
        """The ds datasets' shards beside raw shard ``shard``, recovered
        from the store, and the raw shard's downsampler publishing into
        them (offsets from a counter of its own: a ds shard's flush
        watermarks never skip a later batch of rollups)."""
        import itertools

        from filodb_tpu_torch.core.downsample.downsampler import (
            DEFAULT_RESOLUTIONS_MS,
            ShardDownsampler,
            ds_dataset_name,
        )
        from filodb_tpu_torch.core.record import SomeData
        from filodb_tpu_torch.core.store.config import StoreConfig

        resolutions = tuple(ds_cfg.get("resolutions_ms",
                                       DEFAULT_RESOLUTIONS_MS))
        retention = ds_cfg.get("ds_retention_ms",
                               raw_shard.config.retention_ms * 5)
        for res in resolutions:
            name = ds_dataset_name(config.dataset, res)
            ms = self.memstores.get(name)
            if ms is None:
                ms = self.memstores[name] = MemStore(
                    config.num_shards, column_store=self.column_store,
                    meta_store=self.meta_store, dataset=name,
                    config=StoreConfig(
                        max_chunk_size=raw_shard.config.max_chunk_size,
                        retention_ms=retention))
            ms.shards[shard].recover_index()
            self._ds_shards.append((name, shard))
        seq = itertools.count(1)

        def publish(res, container, _ds=config.dataset, _shard=shard):
            self.memstores[ds_dataset_name(_ds, res)].shards[_shard].ingest(
                SomeData(container, next(seq)))

        raw_shard.downsampler = ShardDownsampler(resolutions, publish)

    def promote_shard(self, dataset: str, shard: int,
                      config: IngestionConfig, shard_log: ReplayLog,
                      start_offset: int, on_status=None) -> None:
        """A follower made leader: its image is warm (index recovered when
        it began to follow, the log applied through ``start_offset``), so
        the ingest worker starts there, with no store read, no index
        recovery and no watermark pass, and the shard joins the flush
        schedule."""
        key = (dataset, shard)
        if key in self._workers:
            return
        s = self.setup_dataset(config).shards[shard]
        self.recovery[key] = {"keys": s.num_partitions, "index_s": 0.0,
                              "start_offset": start_offset,
                              "promoted": True}
        worker = _IngestWorker(self, s, shard_log, start_offset, on_status)
        self._workers[key] = worker
        worker.start()
        _register_lag_gauges(dataset, shard, s, shard_log, worker)
        if self._flusher is None and not self.read_only:
            self._flusher = _FlushScheduler(self, self.flush_tick_s)
            self._flusher.start()

    def prepare_handoff(self, dataset: str, shard: int) -> int:
        """A migration's source in SYNCING: every group flushed, the
        store's uploads drained (raises if one failed), the index
        snapshot written. Returns the shard's latest ingested offset."""
        s = self.memstores[dataset].shards[shard]
        s.flush_all()
        FaultInjector.fire("migration.sync.upload", node=self.name,
                           dataset=dataset, shard=shard)
        flush = getattr(self.column_store, "flush", None)
        if callable(flush):
            flush()
        FaultInjector.fire("migration.sync.checkpoint.before",
                           node=self.name, dataset=dataset, shard=shard)
        s.snapshot_index()
        FaultInjector.fire("migration.sync.checkpoint.after",
                           node=self.name, dataset=dataset, shard=shard)
        return s.latest_offset

    def shard_offset(self, dataset: str, shard: int) -> int:
        """The log offset the shard covers here (-1: none): the larger of
        its latest ingested offset and its smallest group watermark (a
        shard recovered with nothing to replay still covers what every
        group flushed)."""
        ms = self.memstores.get(dataset)
        if ms is None:
            return -1
        s = ms.shards[shard]
        return max(s.latest_offset, int(s.group_watermarks.min()))

    def kill(self) -> None:
        """Stop every worker and the scheduler (process death or
        shutdown)."""
        self.alive = False
        for w in list(self._workers.values()):
            w.stop()
        self._workers.clear()
        if self._flusher is not None:
            self._flusher.stop()
            self._flusher = None


def _register_lag_gauges(dataset: str, shard: int, s, shard_log,
                         worker) -> None:
    """The freshness gauges of one shard (the wall clock past its newest
    sample, and its log's offset and checkpoint lags), computed at scrape
    time over weak references (a stopped shard's series drop out)."""
    tags = {"dataset": dataset, "shard": str(shard)}
    get_counter("filodb_ingest_errors", tags)
    log_ref, worker_ref, shard_ref = (weakref.ref(shard_log),
                                      weakref.ref(worker), weakref.ref(s))

    def offset_lag():
        lg, w = log_ref(), worker_ref()
        return None if lg is None or w is None else lg.offset_lag(w.offset)

    def checkpoint_lag():
        lg, sh = log_ref(), shard_ref()
        return None if lg is None or sh is None else lg.offset_lag(
            int(sh.group_watermarks.min()))

    def ingest_lag():
        # wall clock past the shard's newest sample; None (no series)
        # before its first ingest, as the reference's shard gauge
        sh = shard_ref()
        return None if sh is None or sh.max_ingested_ts < 0 \
            else max(0.0, time.time() - sh.max_ingested_ts / 1000.0)

    GaugeFn("filodb_ingest_lag_seconds", ingest_lag, tags)
    GaugeFn("filodb_ingest_offset_lag", offset_lag, tags,
            help="log records appended but not yet ingested")
    GaugeFn("filodb_ingest_checkpoint_lag", checkpoint_lag, tags,
            help="log records past the lowest group checkpoint")


def shard_tick(shard, now_ms: int | None = None) -> dict:
    """A flush-scheduler tick's work on one shard, in the reference's order
    (``filodb_tpu/coordinator/cluster.py:307-312``): flush the next group,
    hold the resident chunks to ``shard_mem_mb``, purge past
    ``retention_ms``. → {flushed, evicted, purged}: chunks written,
    chunks evicted by the budget's first step, partitions purged."""
    if now_ms is None:
        now_ms = int(time.time() * 1000)
    flushed = shard.flush_group(shard.next_flush_group())
    evicted = shard.enforce_memory()
    purged = shard.purge_expired(now_ms)
    return {"flushed": flushed, "evicted": evicted, "purged": purged}


class _FlushScheduler(threading.Thread):
    """A node's flush scheduler (the reference's time-staggered
    ``createFlushTasks``): see the module. ``truncated`` holds each
    shard's last (offset truncated before, segments removed) and
    ``snapshots`` its (snapshots written, bytes of the last)."""

    def __init__(self, node: Node, tick_s: float | None = None):
        super().__init__(daemon=True, name=f"flush-{node.name}")
        self.node = node
        self.tick_s = tick_s
        self._stop_ev = threading.Event()
        self._last_snapshot: dict[tuple[str, int], float] = {}
        self.truncated: dict[tuple[str, int], tuple[int, int]] = {}
        self.snapshots: dict[tuple[str, int], tuple[int, int]] = {}

    def run(self):
        while not self._stop_ev.wait(self._next_tick()):
            if not self.node.alive:
                return
            for key in list(self.node._workers):
                try:
                    self._tick(key)
                except Exception:
                    get_counter("filodb_flush_errors",
                                {"dataset": key[0],
                                 "shard": str(key[1])}).inc()
                    log.exception("scheduled flush failed for %s/%d on "
                                  "node %s", key[0], key[1], self.node.name)
            # the streaming rollups flush on the same cadence
            for key in list(self.node._ds_shards):
                try:
                    self.flush_ds(key)
                except Exception:
                    get_counter("filodb_flush_errors",
                                {"dataset": key[0],
                                 "shard": str(key[1])}).inc()
                    log.exception("ds flush failed for %s/%d on node %s",
                                  key[0], key[1], self.node.name)

    def flush_ds(self, key) -> int:
        """Flush the next group of a streaming ds dataset's shard."""
        ds = self.node.memstores[key[0]].shards[key[1]]
        return ds.flush_group(ds.next_flush_group())

    def _tick(self, key) -> None:
        dataset, shard_num = key
        ms = self.node.memstores.get(dataset)
        if ms is None:
            return
        shard = ms.shards[shard_num]
        shard_tick(shard)
        # the log below the smallest watermark is persisted, and replay
        # skips it; over a write-behind store, below the smallest one that
        # has landed (ROADMAP §C)
        w = self.node._workers.get(key)
        wm = int(shard.group_watermarks.min())
        durable = getattr(shard.meta_store, "durable_checkpoints", None)
        if durable is not None:
            landed = durable(dataset, shard_num)
            wm = min([wm] + [landed.get(g, -1) for g in
                             range(len(shard.group_watermarks))])
        if w is not None and wm >= 0 and hasattr(w.log, "truncate_before"):
            self.truncated[key] = (wm + 1, w.log.truncate_before(wm + 1))
        interval = shard.config.index_snapshot_interval_ms
        if interval:
            now = time.time()
            # the first interval counts from first sight
            last = self._last_snapshot.setdefault(key, now)
            if now - last >= interval / 1000.0:
                nbytes = shard.snapshot_index()
                self._last_snapshot[key] = now
                self.snapshots[key] = (self.snapshots.get(key, (0, 0))[0]
                                       + 1, nbytes)

    def _next_tick(self) -> float:
        if self.tick_s is not None:
            return self.tick_s
        interval, groups = 3_600.0, 20
        for dataset, shard_num in list(self.node._workers):
            ms = self.node.memstores.get(dataset)
            if ms is not None:
                cfg = ms.shards[shard_num].config
                interval = cfg.flush_interval_ms / 1000.0
                groups = cfg.groups_per_shard
                break
        return max(min(interval / max(groups, 1), 300.0), 0.5)

    def stop(self):
        self._stop_ev.set()
        if self.is_alive() and threading.current_thread() is not self:
            self.join(timeout=30)


class _IngestWorker(threading.Thread):
    """A shard's ingest thread: replay from the recovery offset, then
    tail (the reference's single writer a shard). ``replay_s`` is the
    time to the log's end at start; ``caught_up`` is set there."""

    def __init__(self, node: Node, shard, log_: ReplayLog, start_offset: int,
                 on_status=None, poll_interval: float = 0.01):
        super().__init__(daemon=True,
                         name=f"ingest-{shard.dataset}-{shard.shard_num}")
        self.node = node
        self.shard = shard
        self.log = log_
        self.offset = start_offset
        self.on_status = on_status
        self.poll_interval = poll_interval
        self._stop_ev = threading.Event()
        self.caught_up = threading.Event()
        self.replay_s = None
        self.records_replayed = 0
        self.failed: BaseException | None = None

    def run(self):
        t0 = time.perf_counter()
        while not self._stop_ev.is_set() and self.node.alive:
            progressed = False
            try:
                for sd in self.log.read_from(self.offset + 1):
                    if self._stop_ev.is_set() or not self.node.alive:
                        return
                    if not self._ingest(sd):
                        return
                    self.offset = sd.offset
                    progressed = True
                    # the gateway's freshness stamps at or below this
                    # offset are now queryable in the shard
                    STAMPS.observe(self.shard.dataset, self.shard.shard_num,
                                   sd.offset)
            except (ConnectionError, OSError, RuntimeError):
                # a log read failed: retry from the last ingested offset
                log.warning("shard %s/%d log read failed; retrying",
                            self.shard.dataset, self.shard.shard_num,
                            exc_info=True)
                time.sleep(min(self.poll_interval * 100, 1.0))
                continue
            if not self.caught_up.is_set():
                self.replay_s = time.perf_counter() - t0
                self.caught_up.set()
                if self.on_status:
                    self.on_status(self.shard.shard_num, ShardStatus.ACTIVE,
                                   100)
            if not progressed:
                time.sleep(self.poll_interval)

    def _ingest(self, sd) -> bool:
        """Ingest one container; a failure (a poison record) stops the
        worker and surfaces ERROR."""
        try:
            self.shard.ingest(sd)
        except Exception as e:
            self.failed = e
            get_counter("filodb_ingest_errors",
                        {"dataset": self.shard.dataset,
                         "shard": str(self.shard.shard_num)}).inc()
            log.exception("shard %s/%d ingest failed at offset %d; stopping "
                          "worker", self.shard.dataset, self.shard.shard_num,
                          sd.offset)
            if self.on_status:
                self.on_status(self.shard.shard_num, ShardStatus.ERROR, 0)
            return False
        if not self.caught_up.is_set():
            self.records_replayed += len(sd.container)
        return True

    def stop(self):
        self._stop_ev.set()
        if self.is_alive() and threading.current_thread() is not self:
            self.join(timeout=30)


@dataclass
class FilodbCluster:
    """Membership, shard managers, dataset setup and failure detection."""

    nodes: dict = field(default_factory=dict)  # name → Node or a handle
    shard_managers: dict[str, ShardManager] = field(default_factory=dict)
    configs: dict[str, IngestionConfig] = field(default_factory=dict)
    spreads: dict[str, int] = field(default_factory=dict)
    logs: dict[tuple[str, int], ReplayLog] = field(default_factory=dict)
    heartbeat_interval_s: float = 0.05
    # beats a member may miss before it is declared down
    failure_threshold: int = 3
    on_heartbeat: list = field(default_factory=list)  # called every beat
    # live migrations in flight, (dataset, shard) → ShardMigration; with
    # auto_rebalance a join levels the shard counts (``migration`` block)
    migrations: dict = field(default_factory=dict)
    auto_rebalance: bool = False
    migration_lag_threshold: int = 0
    migration_catchup_timeout_s: float = 30.0
    # followers a shard on other in-process members (``replication``
    # block; 0: none)
    replication: int = 0
    replica_in_sync_lag: int = 0    # the largest lag still IN_SYNC
    replica_hedge_s: float = 0.05   # a replica read's hedge timer
    replica_durable_sync_s: float = 5.0  # a follower's segment sync
    # (dataset, shard, node) → ReplicaSyncer
    replica_syncers: dict = field(default_factory=dict)
    _hb_misses: dict = field(default_factory=dict)
    _hb_thread: threading.Thread | None = None
    _stop_hb: threading.Event = field(default_factory=threading.Event)

    def join(self, node) -> None:
        self.nodes[node.name] = node
        if not isinstance(node, Node) and node.executor_port:
            # a (re)joining remote member starts with its breaker closed
            breaker_for(f"{node.host}:{node.executor_port}").record_success()
        for dataset, sm in self.shard_managers.items():
            if isinstance(node, Node):
                node.setup_dataset(self.configs[dataset],
                                   self.spreads[dataset])
            for ev in sm.add_member(node.name):
                self._on_event(dataset, ev)
        if self.auto_rebalance and self.shard_managers:
            # level the counts onto the joiner, off the caller's thread (a
            # handoff blocks through its catch-up)
            threading.Thread(
                target=lambda: [self.maybe_rebalance(d)
                                for d in list(self.shard_managers)],
                daemon=True, name=f"rebalance-{node.name}").start()

    def leave(self, name: str) -> None:
        """A member gone: its breaker forced open (queries skip it without
        a dial), its workers stopped, its shards DOWN and reassigned."""
        node = self.nodes.pop(name, None)
        if node is not None:
            if not isinstance(node, Node) and node.executor_port:
                breaker_for(f"{node.host}:{node.executor_port}").force_open()
            node.kill()
        for dataset, sm in self.shard_managers.items():
            for ev in sm.remove_member(name):
                self._on_event(dataset, ev)

    def setup_dataset(self, config: IngestionConfig,
                      logs: dict[int, ReplayLog], spread: int = 1) -> None:
        """Register a dataset with its shards' logs; its shards are
        assigned to the members and started there."""
        dataset = config.dataset
        self.configs[dataset] = config
        self.spreads[dataset] = spread
        for shard, log_ in logs.items():
            self.logs[(dataset, shard)] = log_
        sm = self.shard_managers[dataset] = ShardManager(
            dataset, config.num_shards, config.min_num_nodes)
        for name, node in list(self.nodes.items()):
            if isinstance(node, Node):
                node.setup_dataset(config, spread)
            for ev in sm.add_member(name):
                self._on_event(dataset, ev)

    def _on_event(self, dataset: str, ev) -> None:
        if ev.replica:
            # a follower leaving a set stops its syncer; upserts are the
            # syncers' own reports
            if ev.node and ev.status in (ShardStatus.STOPPED,
                                         ShardStatus.DOWN,
                                         ShardStatus.UNASSIGNED):
                sy = self.replica_syncers.pop((dataset, ev.shard, ev.node),
                                              None)
                if sy is not None:
                    sy.stop()
            return
        if ev.status == ShardStatus.ACTIVE and ev.node and \
                (dataset, ev.shard, ev.node) in self.replica_syncers:
            # the promotion's flip names a node that follows the shard:
            # its warm image goes to the ingest path
            sy = self.replica_syncers.pop((dataset, ev.shard, ev.node))
            self.nodes[ev.node].promote_shard(
                dataset, ev.shard, self.configs[dataset],
                self.logs[(dataset, ev.shard)], sy.promote(),
                self._status_cb(dataset, ev.node))
            return
        if ev.status == ShardStatus.ASSIGNED and ev.node:
            self.nodes[ev.node].start_shard(
                dataset, ev.shard, self.configs[dataset],
                self.logs.get((dataset, ev.shard)),
                self._status_cb(dataset, ev.node))

    def _status_cb(self, dataset: str, node: str):
        sm = self.shard_managers[dataset]

        def on_status(shard, status, progress, _node=node):
            if status == ShardStatus.ACTIVE:
                sm.shard_active(shard, _node)
            elif status == ShardStatus.RECOVERY:
                sm.shard_recovery(shard, _node, progress)
            elif status == ShardStatus.ERROR:
                sm.shard_error(shard, _node)

        return on_status

    # -- continuous replication --

    def ensure_replicas(self, dataset: str) -> None:
        """Bring each shard's follower set toward ``replication``: prune
        the followers of dead nodes, of their own shards and with a dead
        tail, then start followers on the least-loaded live in-process
        members. Idempotent; every heartbeat runs it."""
        if not self.replication:
            return
        sm = self.shard_managers.get(dataset)
        if sm is None:
            return
        for shard in range(sm.num_shards):
            owner = sm.mapper.node_for(shard)
            for name in list(sm.mapper.replicas_of(shard)):
                node = self.nodes.get(name)
                sy = self.replica_syncers.get((dataset, shard, name))
                dead_tail = (sy is not None and sy._tail is not None
                             and not sy._tail.is_alive())
                if node is None or not node.alive or name == owner \
                        or dead_tail:
                    sy = self.replica_syncers.pop((dataset, shard, name),
                                                  None)
                    if sy is not None:
                        sy.stop()
                    sm.drop_replica(shard, name)
            if owner is None:
                continue  # a DOWN shard's followers tail on as they are
            # syncers still bootstrapping are not in the map yet
            have = set(sm.mapper.replicas_of(shard))
            have |= {n for (d, s, n) in self.replica_syncers
                     if d == dataset and s == shard}
            need = self.replication - len(have)
            if need <= 0:
                continue
            cands = [n for n, nd in self.nodes.items()
                     if isinstance(nd, Node) and nd.alive and n != owner
                     and n not in have]
            # a member's load counts the followers it is still
            # bootstrapping: counted from the map alone, every member ties
            # at 0 in a pass that fills many shards, the order of joins
            # decides, and a rejoined member gets no slot (§C.17)
            cands.sort(key=lambda n: len(
                set(sm.mapper.follower_shards(n))
                | {s for (d, s, m) in self.replica_syncers
                   if d == dataset and m == n}))
            for name in cands[:need]:
                sy = ReplicaSyncer(
                    self.nodes[name], dataset, shard,
                    self.configs[dataset], self.logs[(dataset, shard)],
                    sm, in_sync_lag=self.replica_in_sync_lag,
                    spread=self.spreads[dataset],
                    durable_sync_interval_s=self.replica_durable_sync_s)
                self.replica_syncers[(dataset, shard, name)] = sy
                sy.start()

    # -- live migration and rebalancing --

    def _migration_store(self):
        """The shared column store the manifests live in: an in-process
        member's (every member's store is over one durable tier)."""
        for node in self.nodes.values():
            if isinstance(node, Node):
                return node.column_store
        raise MigrationError("no in-process column store for the "
                             "migration manifest; pass store= explicitly")

    def migrate_shard(self, dataset: str, shard: int, dest: str,
                      store=None, **kw) -> ShardMigration:
        """Move a shard from its owner to ``dest`` (blocks until DONE; a
        thread runs it under live traffic)."""
        sm = self.shard_managers[dataset]
        source = sm.mapper.node_for(shard)
        if source is None:
            raise MigrationError(f"shard {shard} has no owner to migrate "
                                 "from")
        kw.setdefault("lag_threshold", self.migration_lag_threshold)
        kw.setdefault("catchup_timeout_s", self.migration_catchup_timeout_s)
        mig = ShardMigration(self, store or self._migration_store(),
                             dataset, shard, source, dest, **kw)
        self.migrations[(dataset, shard)] = mig
        try:
            return mig.run()
        finally:
            if mig.phase in ("done", "aborted"):
                self.migrations.pop((dataset, shard), None)

    def resume_migration(self, dataset: str, shard: int, store=None,
                         **kw) -> ShardMigration | None:
        """Continue a migration whose run crashed, from its manifest
        (None: no migration in flight)."""
        return ShardMigration.resume(self, store or self._migration_store(),
                                     dataset, shard, **kw)

    def maybe_rebalance(self, dataset: str, overloaded: str | None = None,
                        min_imbalance: int = 2) -> list[ShardMigration]:
        """Run the planned rebalance moves, one migration at a time."""
        sm = self.shard_managers.get(dataset)
        if sm is None:
            return []
        done = []
        for shard, src, dst in sm.plan_rebalance(overloaded, min_imbalance):
            if (dataset, shard) in self.migrations:
                continue
            try:
                done.append(self.migrate_shard(dataset, shard, dst))
            except Exception:
                get_counter("filodb_shard_migration_errors",
                            {"dataset": dataset}).inc()
                log.exception("rebalance migration of %s/%d %s -> %s "
                              "failed", dataset, shard, src, dst)
                break
        return done

    def shed_load(self, node_name: str) -> list[ShardMigration]:
        """Move one shard a dataset off a pressured node, counts level or
        not (the memory watchdog's CRITICAL)."""
        out = []
        for dataset in list(self.shard_managers):
            out += self.maybe_rebalance(dataset, overloaded=node_name,
                                        min_imbalance=1)
        return out

    # -- failure detection --

    def start_failure_detector(self) -> None:
        """The heartbeat thread (the reference's stand-in for Akka's
        phi-accrual detector)."""
        if self._hb_thread is not None:
            return
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True,
                                           name="heartbeat")
        self._hb_thread.start()

    def _hb_loop(self) -> None:
        while not self._stop_hb.wait(self.heartbeat_interval_s):
            self.heartbeat()

    def heartbeat(self) -> None:
        """One beat: members not alive for ``failure_threshold`` beats
        leave; rate-limited shards are reassigned; the follower sets
        converge; ``on_heartbeat`` runs."""
        for name, node in list(self.nodes.items()):
            if node.alive:
                self._hb_misses[name] = 0
                continue
            misses = self._hb_misses.get(name, 0) + 1
            self._hb_misses[name] = misses
            if misses >= self.failure_threshold:
                log.warning("failure detector: node %s down (%d missed "
                            "heartbeats)", name, misses)
                self.leave(name)
                self._hb_misses.pop(name, None)
        for dataset, sm in list(self.shard_managers.items()):
            for ev in sm.check_deferred():
                try:
                    self._on_event(dataset, ev)
                except Exception:
                    get_counter("filodb_heartbeat_errors").inc()
                    log.exception("deferred reassignment of %s/%d failed",
                                  dataset, ev.shard)
            try:
                self.ensure_replicas(dataset)
            except Exception:
                get_counter("filodb_heartbeat_errors").inc()
                log.exception("replica convergence for %s failed", dataset)
        for cb in list(self.on_heartbeat):
            try:
                cb()
            except Exception:
                get_counter("filodb_heartbeat_errors").inc()
                log.exception("heartbeat callback %s failed",
                              getattr(cb, "__name__", repr(cb)))

    def stop(self):
        self._stop_hb.set()
        if self._hb_thread is not None \
                and self._hb_thread is not threading.current_thread():
            self._hb_thread.join(timeout=5)
        for sy in list(self.replica_syncers.values()):
            sy.stop()
        self.replica_syncers.clear()
        for node in list(self.nodes.values()):
            node.kill()

    # -- queries --

    def home_node(self) -> "Node":
        """The node whose store a service reads in-process: the first
        in-process member (a standalone server's own)."""
        for node in self.nodes.values():
            if isinstance(node, Node):
                return node
        raise RuntimeError("no in-process member to serve queries from")

    def dispatcher_for(self, dataset: str, home: "Node"):
        """shard → the dispatcher of its owner (None: ``home``'s, in
        process), or a ``ReplicaDispatcher`` over its owner and in-sync
        followers where it has any."""
        sm = self.shard_managers[dataset]

        def candidate(name: str, follower: bool = False
                      ) -> ReplicaCandidate:
            node = self.nodes[name]
            if isinstance(node, Node):
                return ReplicaCandidate(name, NodeDispatcher(node),
                                        follower=follower, guard=True)
            from filodb_tpu_torch.coordinator.remote import (
                RemotePlanDispatcher,
            )

            # the remote dispatcher guards itself under its peer's breaker
            d = RemotePlanDispatcher(node.host, node.executor_port)
            return ReplicaCandidate(d.peer, d, follower=follower,
                                    guard=False)

        def dispatcher_for_shard(shard: int):
            # the followers before the owner: a promotion writes the new
            # owner, then drops it from the set, so this order never sees
            # a dead owner and no follower mid-flip
            followers = [n for n in sm.mapper.in_sync_followers(shard)
                         if n in self.nodes]
            owner = sm.mapper.node_for(shard)
            followers = [n for n in followers if n != owner]
            if not followers:
                node = self.nodes.get(owner) if owner is not None else None
                if node is None:
                    raise RuntimeError(f"shard {shard} unassigned")
                return None if node is home \
                    else candidate(owner).dispatcher
            cands = [candidate(owner)] if owner in self.nodes else []
            cands += [candidate(n, follower=True) for n in followers]
            return ReplicaDispatcher(shard, cands,
                                     hedge_timeout_s=self.replica_hedge_s)

        return dispatcher_for_shard

    def shard_status_fn(self, dataset: str):
        """() → [(shard, what)] of the shards an answer may lag: RECOVERY
        or HANDOFF, or ACTIVE on a leader that is down (its node gone,
        not ``alive``, or a remote one's breaker open) while a follower
        serves it."""
        sm = self.shard_managers[dataset]

        def statuses():
            out = []
            for s in range(sm.num_shards):
                st = sm.mapper.statuses[s]
                if st in (ShardStatus.RECOVERY, ShardStatus.HANDOFF):
                    out.append((s, st.name.lower()))
                    continue
                if st != ShardStatus.ACTIVE:
                    continue
                followers = sm.mapper.in_sync_followers(s)
                if not followers:
                    continue
                owner = sm.mapper.node_for(s)
                node = self.nodes.get(owner) if owner else None
                if node is None:
                    unhealthy = True
                elif isinstance(node, Node):
                    unhealthy = not node.alive
                else:
                    unhealthy = breaker_for(
                        f"{node.host}:{node.executor_port}").is_open
                if unhealthy:
                    out.append((s, f"served by follower {followers[0]}"))
            return out

        return statuses

    def query_service(self, dataset: str, engine: str = "mesh",
                      device=None, result_cache=None,
                      mesh=None) -> QueryService:
        """A query service over the home node's store of ``dataset``
        (engine ``"mesh"`` by default, as the standalone server boots it;
        the extent cache of ``result_cache``, off by default; its mesh
        engines over ``mesh`` where given), whose leaves go to the nodes
        that own their shards (see the module's text)."""
        home = self.home_node()
        sm = self.shard_managers[dataset]
        svc = QueryService(home.memstores[dataset],
                           device=device if mesh is None else None,
                           engine=engine, result_cache=result_cache,
                           mesh=mesh)
        svc.planner.dispatcher_for_shard = self.dispatcher_for(dataset, home)
        svc.shards_local_fn = lambda: all(o == home.name
                                          for o in sm.mapper.owners)
        svc.shard_status_fn = self.shard_status_fn(dataset)
        return svc

    def shard_statuses(self, dataset: str) -> list[dict]:
        sm = self.shard_managers.get(dataset)
        return sm.mapper.snapshot() if sm else []

    def wait_active(self, dataset: str, timeout: float = 10.0) -> bool:
        """Wait until every shard is ACTIVE (its replay done)."""
        sm = self.shard_managers[dataset]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(st == ShardStatus.ACTIVE for st in sm.mapper.statuses):
                return True
            time.sleep(0.01)
        return False
