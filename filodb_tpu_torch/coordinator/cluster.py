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
- ``FilodbCluster``: ``join``, ``setup_dataset`` (shards assigned by
  ``ShardManager`` and started on their node), ``query_service``,
  ``shard_statuses``, ``wait_active`` and ``stop``.

The port's node holds a ``MemStore`` a dataset (the reference's one
``TimeSeriesMemStore`` holds every dataset), created by ``setup_dataset``
with the dataset's spread. A dataset whose ``downsample`` block sets
``streaming`` gets, beside each of its shards, the shard of each ds
dataset (``<dataset>_ds_<minutes>m``, a ``MemStore`` of its own with the
raw shard's chunk size and ``ds_retention_ms``, five times the raw
retention by default); the raw shard's flush publishes its rollups there
(``core/downsample/downsampler.py::ShardDownsampler``), and the flush
scheduler flushes those shards on its tick, as the reference's does.
One node only: failure detection, migration, replication and remote
dispatch wait for ROADMAP §A.12, and a second member raises.

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

from filodb_tpu_torch.coordinator.query_service import QueryService
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
from filodb_tpu_torch.utils.metrics import GaugeFn, get_counter
from filodb_tpu_torch.utils.selfmon import STAMPS

log = logging.getLogger(__name__)

_ONE_NODE = ("a cluster of more than one node is not ported "
             "(ROADMAP §A.12)")


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
    """Membership, shard managers and dataset setup of one node."""

    nodes: dict[str, Node] = field(default_factory=dict)
    shard_managers: dict[str, ShardManager] = field(default_factory=dict)
    configs: dict[str, IngestionConfig] = field(default_factory=dict)
    spreads: dict[str, int] = field(default_factory=dict)
    logs: dict[tuple[str, int], ReplayLog] = field(default_factory=dict)

    def join(self, node: Node) -> None:
        if self.nodes and node.name not in self.nodes:
            raise NotImplementedError(_ONE_NODE)
        self.nodes[node.name] = node
        for dataset, sm in self.shard_managers.items():
            node.setup_dataset(self.configs[dataset], self.spreads[dataset])
            for ev in sm.add_member(node.name):
                self._on_event(dataset, ev)

    def setup_dataset(self, config: IngestionConfig,
                      logs: dict[int, ReplayLog], spread: int = 1) -> None:
        """Register a dataset with its shards' logs; its shards are
        assigned to the member and started there."""
        dataset = config.dataset
        self.configs[dataset] = config
        self.spreads[dataset] = spread
        for shard, log_ in logs.items():
            self.logs[(dataset, shard)] = log_
        sm = self.shard_managers[dataset] = ShardManager(
            dataset, config.num_shards, config.min_num_nodes)
        for name, node in self.nodes.items():
            node.setup_dataset(config, spread)
            for ev in sm.add_member(name):
                self._on_event(dataset, ev)

    def _on_event(self, dataset: str, ev) -> None:
        if ev.status == ShardStatus.ASSIGNED and ev.node:
            self.nodes[ev.node].start_shard(
                dataset, ev.shard, self.configs[dataset],
                self.logs[(dataset, ev.shard)],
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

    def stop(self):
        for node in list(self.nodes.values()):
            node.kill()

    def query_service(self, dataset: str, engine: str = "mesh",
                      device=None, result_cache=None) -> QueryService:
        """A query service over the dataset's store on the node (engine
        ``"mesh"`` by default, as the standalone server boots it; the
        extent cache of ``result_cache``, off by default)."""
        node = next(iter(self.nodes.values()))
        return QueryService(node.memstores[dataset], device=device,
                            engine=engine, result_cache=result_cache)

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
