"""Live shard migration: a crash-safe handoff of a shard between nodes.

Port of ``filodb_tpu/coordinator/migration.py`` (``:1-35, 61-355``). A
migration is a resumable state machine over the durable tier and the
shard's group watermarks:

    PLANNED → SYNCING → CATCHUP → FLIPPING → DONE        (or ABORTED)

- **PLANNED**: the manifest (dataset, shard, source, dest, phase) is
  written beside the shard's data in the column store, the reference's
  bytes, so a coordinator of either package resumes or aborts the
  other's migration.
- **SYNCING**: the source flushes every group, drains the store's
  uploads and snapshots the index (``Node.prepare_handoff``).
- **CATCHUP**: the destination recovers from the store and replays the
  log's tail from its group watermarks (``start_shard`` without status
  callbacks) until its covered offset is within ``lag_threshold`` of the
  source's; the map shows ``HANDOFF`` and the source serves.
- **FLIPPING**: one sequenced event moves owner and status to the
  destination; the source lingers ``source_linger_s`` for queries in
  flight, then stops the shard.

Each phase is recorded before its work, which is idempotent, so a crash
inside it resumes at it. Every transition fires a ``FaultInjector`` site
of ``KILL_POINTS``. The ``filodb_shard_migration_*`` metrics carry the
reference's names.
"""

from __future__ import annotations

import json
import logging
import time

from filodb_tpu_torch.coordinator.shardmapper import ShardStatus
from filodb_tpu_torch.utils import racecheck
from filodb_tpu_torch.utils.metrics import Counter, Gauge, Histogram
from filodb_tpu_torch.utils.resilience import FaultInjector
from filodb_tpu_torch.utils.tracing import traced_operation

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# phases

PLANNED, SYNCING, CATCHUP, FLIPPING, DONE, ABORTED = (
    "planned", "syncing", "catchup", "flipping", "done", "aborted")
PHASES = (PLANNED, SYNCING, CATCHUP, FLIPPING, DONE, ABORTED)
_PHASE_VALUE = {p: i for i, p in enumerate(PHASES)}

# named kill-points, one per state transition; chaos tests arm errors here
# (``FaultInjector.arm(site, RuntimeError)``) to simulate a process kill at
# that exact point, then resume from the persisted manifest
KILL_POINTS = (
    "migration.plan",                    # manifest persisted, nothing moved
    "migration.sync.upload",             # during segment upload (staged,
                                         # write-behind not yet drained)
    "migration.sync.checkpoint.before",  # uploads durable, index snapshot
                                         # (the recovery barrier) not yet
    "migration.sync.checkpoint.after",   # snapshot durable, phase record not
    "migration.catchup",                 # destination replaying the tail
    "migration.flip.before",             # mid-flip: HANDOFF still on source
    "migration.flip.after",              # flipped: source not yet torn down
)

# ---------------------------------------------------------------------------
# metrics — pre-created at import so the scrape families render before any
# migration runs

_started = Counter("filodb_shard_migrations_started")
_completed = Counter("filodb_shard_migrations_completed")
_aborted = Counter("filodb_shard_migrations_aborted")
_resumed = Counter("filodb_shard_migrations_resumed")
_active_gauge = Gauge("filodb_shard_migration_active")
_phase_gauge = Gauge("filodb_shard_migration_phase")
_lag_gauge = Gauge("filodb_shard_migration_lag")
_seconds = Histogram("filodb_shard_migration_seconds")


class MigrationError(RuntimeError):
    """Migration could not make progress (catch-up timeout, lost node)."""


# ---------------------------------------------------------------------------
# manifest


class MigrationManifest:
    """Durable migration record; JSON next to the shard's data. Registered
    on the wire so control-plane callers (``migration_status``) receive it
    typed."""

    __wire_fields__ = ("dataset", "shard", "source", "dest", "phase",
                       "lag_threshold", "started_ms", "updated_ms")

    def __init__(self, dataset: str = "", shard: int = 0, source: str = "",
                 dest: str = "", phase: str = PLANNED,
                 lag_threshold: int = 0, started_ms: int = 0,
                 updated_ms: int = 0):
        self.dataset = dataset
        self.shard = shard
        self.source = source
        self.dest = dest
        self.phase = phase
        self.lag_threshold = lag_threshold
        self.started_ms = started_ms
        self.updated_ms = updated_ms
        # phase transitions are written by the migration's thread and read
        # by control-plane status calls on other threads
        racecheck.register(
            self, f"MigrationManifest[{dataset}/{shard}]")

    def to_bytes(self) -> bytes:
        return json.dumps({k: getattr(self, k)
                           for k in self.__wire_fields__}).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "MigrationManifest":
        doc = json.loads(raw.decode())
        return cls(**{k: doc[k] for k in cls.__wire_fields__ if k in doc})

    def __eq__(self, other):
        return isinstance(other, MigrationManifest) and all(
            getattr(self, k) == getattr(other, k)
            for k in self.__wire_fields__)

    def __repr__(self):
        return (f"MigrationManifest({self.dataset}/{self.shard} "
                f"{self.source}->{self.dest} {self.phase})")


# ---------------------------------------------------------------------------
# the state machine


class ShardMigration:
    """One shard's move from ``source`` to ``dest``, driven to completion by
    :meth:`run` (or :meth:`resume` after a crash, or :meth:`abort`).

    ``cluster`` is duck-typed: it provides ``shard_managers``, ``nodes``,
    ``configs`` and ``logs`` (``FilodbCluster`` in-process; the standalone
    coordinator's cluster over control RPC via ``RemoteNodeHandle``).
    ``store`` is the shared :class:`ColumnStore` holding the shard's durable
    data — the manifest lives beside it.
    """

    def __init__(self, cluster, store, dataset: str, shard: int,
                 source: str, dest: str, lag_threshold: int = 0,
                 catchup_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.01,
                 source_linger_s: float = 0.05):
        if source == dest:
            raise ValueError("migration source and destination are the "
                             "same node")
        self.cluster = cluster
        self.store = store
        self.dataset = dataset
        self.shard = shard
        self.source = source
        self.dest = dest
        self.lag_threshold = lag_threshold
        self.catchup_timeout_s = catchup_timeout_s
        self.poll_interval_s = poll_interval_s
        self.source_linger_s = source_linger_s
        self.phase = PLANNED
        self.started_ms = int(time.time() * 1000)
        self.lag = -1
        racecheck.register(self, f"ShardMigration[{dataset}/{shard}]")

    # -- plumbing ---------------------------------------------------------

    @property
    def sm(self):
        return self.cluster.shard_managers[self.dataset]

    def _node(self, name: str):
        node = self.cluster.nodes.get(name)
        if node is None or not getattr(node, "alive", True):
            raise MigrationError(f"node {name} unavailable for migration "
                                 f"of {self.dataset}/{self.shard}")
        return node

    def _ctx(self) -> dict:
        return {"dataset": self.dataset, "shard": self.shard,
                "source": self.source, "dest": self.dest,
                "phase": self.phase}

    def manifest(self) -> MigrationManifest:
        return MigrationManifest(self.dataset, self.shard, self.source,
                                 self.dest, self.phase, self.lag_threshold,
                                 self.started_ms, int(time.time() * 1000))

    def _persist(self, phase: str) -> None:
        """Durably record the phase BEFORE doing its work: a crash inside
        the phase resumes at (and re-runs) it — every phase's work is
        idempotent (chunk writes dedup by id, checkpoints are monotonic,
        the flip event is a plain re-publish)."""
        self.phase = phase
        _phase_gauge.set(_PHASE_VALUE[phase])
        self.store.write_migration_manifest(self.dataset, self.shard,
                                            self.manifest().to_bytes())

    # -- lifecycle --------------------------------------------------------

    def run(self) -> "ShardMigration":
        """Drive the migration to DONE. Raises on an injected kill or a
        lost node, leaving the durable manifest behind for
        :meth:`resume`/:meth:`abort`."""
        t0 = time.monotonic()
        _started.inc()
        _active_gauge.set(_active_gauge.value + 1)
        try:
            if self.phase == PLANNED:
                self._persist(PLANNED)
                FaultInjector.fire("migration.plan", **self._ctx())
                self._persist(SYNCING)
            if self.phase == SYNCING:
                with traced_operation("migration", phase="sync",
                                      shard=self.shard, dataset=self.dataset):
                    self._sync()
                self._persist(CATCHUP)
            if self.phase == CATCHUP:
                with traced_operation("migration", phase="catchup",
                                      shard=self.shard, dataset=self.dataset):
                    self._catchup()
                self._persist(FLIPPING)
            if self.phase == FLIPPING:
                with traced_operation("migration", phase="flip",
                                      shard=self.shard, dataset=self.dataset):
                    self._flip()
            _completed.inc()
            _seconds.observe(time.monotonic() - t0)
            log.info("migration %s/%d %s -> %s complete", self.dataset,
                     self.shard, self.source, self.dest)
            return self
        finally:
            _active_gauge.set(max(0.0, _active_gauge.value - 1))

    def _sync(self) -> None:
        """Source: flush + upload sealed segments, snapshot the index."""
        # the HANDOFF queryability rule: the source keeps owning and
        # serving the shard for the whole sync + catch-up window
        self.sm.begin_handoff(self.shard, self.source)
        src = self._node(self.source)
        src.prepare_handoff(self.dataset, self.shard)

    def _catchup(self) -> None:
        """Destination: cold-recover from segments + index snapshot, then
        replay the ingest tail from the per-group watermarks until its lag
        behind the (still-ingesting) source is ≤ the threshold."""
        # resume path: a restarted coordinator adopted the shard as plain
        # ACTIVE-on-source; restore the HANDOFF marker (idempotent)
        if self.sm.mapper.statuses[self.shard] != ShardStatus.HANDOFF:
            self.sm.begin_handoff(self.shard, self.source)
        dest = self._node(self.dest)
        # no on_status: recovery progress must NOT reach the shard manager
        # — the map stays HANDOFF-on-source until the atomic flip
        dest.start_shard(self.dataset, self.shard,
                         self.cluster.configs[self.dataset],
                         self.cluster.logs[(self.dataset, self.shard)],
                         on_status=None)
        deadline = time.monotonic() + self.catchup_timeout_s
        while True:
            FaultInjector.fire("migration.catchup", **self._ctx())
            src_off = self._node(self.source).shard_offset(self.dataset,
                                                           self.shard)
            dst_off = dest.shard_offset(self.dataset, self.shard)
            self.lag = max(0, src_off - dst_off)
            _lag_gauge.set(self.lag)
            if dst_off >= src_off - self.lag_threshold:
                return
            if time.monotonic() > deadline:
                raise MigrationError(
                    f"catch-up timed out for {self.dataset}/{self.shard}: "
                    f"dest offset {dst_off} behind source {src_off} "
                    f"(threshold {self.lag_threshold})")
            time.sleep(self.poll_interval_s)

    def _flip(self) -> None:
        """Atomic shard-map flip, then tear down the source."""
        FaultInjector.fire("migration.flip.before", **self._ctx())
        self.sm.complete_handoff(self.shard, self.dest)
        FaultInjector.fire("migration.flip.after", **self._ctx())
        # in-flight queries may have resolved routing before the flip;
        # linger so they drain against a live source (a late straggler
        # hitting a torn-down shard degrades to a flagged-partial result,
        # never a wrong one)
        if self.source_linger_s:
            time.sleep(self.source_linger_s)
        try:
            self._node(self.source).stop_shard(self.dataset, self.shard)
        except MigrationError:
            pass  # source died after the flip: nothing left to tear down
        self._persist(DONE)
        self.store.delete_migration_manifest(self.dataset, self.shard)

    def abort(self) -> "ShardMigration":
        """Roll back cleanly: the source resumes sole ownership, the
        destination's partial recovery is torn down, the manifest is
        cleared. Safe from any pre-DONE phase."""
        if self.phase == DONE:
            return self
        try:
            dest = self.cluster.nodes.get(self.dest)
            if dest is not None and getattr(dest, "alive", True):
                dest.stop_shard(self.dataset, self.shard)
        except Exception:
            log.exception("migration abort: destination teardown failed")
        if self.phase in (SYNCING, CATCHUP, FLIPPING):
            self.sm.abort_handoff(self.shard, self.source)
        self.phase = ABORTED
        _phase_gauge.set(_PHASE_VALUE[ABORTED])
        _aborted.inc()
        self.store.delete_migration_manifest(self.dataset, self.shard)
        log.warning("migration %s/%d %s -> %s aborted", self.dataset,
                    self.shard, self.source, self.dest)
        return self

    # -- crash recovery ---------------------------------------------------

    @classmethod
    def resume(cls, cluster, store, dataset: str, shard: int,
               **kw) -> "ShardMigration | None":
        """Reload the durable manifest and continue from the recorded
        phase. Returns None when no migration is in flight. The resumed
        run re-executes the interrupted phase from its start — all phase
        work is idempotent."""
        raw = store.read_migration_manifest(dataset, shard)
        if raw is None:
            return None
        m = MigrationManifest.from_bytes(raw)
        if m.phase in (DONE, ABORTED):
            store.delete_migration_manifest(dataset, shard)
            return None
        mig = cls(cluster, store, dataset, shard, m.source, m.dest,
                  lag_threshold=m.lag_threshold, **kw)
        mig.started_ms = m.started_ms
        mig.phase = SYNCING if m.phase == PLANNED else m.phase
        _resumed.inc()
        log.info("resuming migration %s/%d %s -> %s at phase %s", dataset,
                 shard, m.source, m.dest, mig.phase)
        return mig.run()

    def snapshot(self) -> dict:
        return {"dataset": self.dataset, "shard": self.shard,
                "source": self.source, "dest": self.dest,
                "phase": self.phase, "lag": self.lag}
