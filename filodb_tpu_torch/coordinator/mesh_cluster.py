"""The multi-process mesh runtime, root side.

Port of ``filodb_tpu/coordinator/mesh_cluster.py``. The root lowers a
plan once (``MeshQueryEngine._lower``) and ships a
:class:`LoweredDescriptor` over the framed plan wire
(``coordinator/remote.py``) to N mesh worker processes
(``parallel/multiproc.py``), each owning a contiguous slice of the shard
space. A worker evaluates the agg-stripped leaf on its card and answers
its per-series ``[P_local, K]`` windows with full keys and its shards'
offsets. The root then

- checks staleness: every worker's shard offsets at least the root's,
  read before the dispatch;
- concatenates the blocks in shard order, which is the single-process
  engine's global part order (shard, then partition);
- runs the single-process engine's own aggregation and post-transform
  code over them on the root's device (``MeshQueryEngine.reduce_rows``),

so the answer is bitwise the single-process engine's. Every worker call
runs under its peer's circuit breaker with timeouts from the query's
deadline. A lost worker, an open breaker, a stale slice, a shape the
runtime does not take or a histogram leaf make ``execute_plan`` return
None, and ``QueryService`` falls through to the single-process engines
inside the same admission. A worker's admission shed propagates as
``QueryRejected`` (503 and ``Retry-After``): overload is a healthy peer's
verdict. ``FILODB_MULTIPROC=0`` turns routing off.

Outcomes are counted under ``filodb_mesh_proc_dispatch{outcome}`` and
``filodb_mesh_proc_fallback{reason}``, workers seen reachable in
``filodb_mesh_proc_workers``, and the root's gather and reduce in
``filodb_mesh_proc_collective_seconds``; the families are registered at
import.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from filodb_tpu_torch.coordinator.remote import RemotePlanDispatcher
from filodb_tpu_torch.utils.metrics import Gauge, Histogram, get_counter
from filodb_tpu_torch.utils.resilience import (
    CircuitOpenError,
    FaultInjector,
    breaker_for,
    default_retry_policy,
    record_peer_latency,
)
from filodb_tpu_torch.utils.tracing import span

log = logging.getLogger(__name__)

_M_PROC_DISPATCH = {o: get_counter("filodb_mesh_proc_dispatch",
                                   {"outcome": o},
                                   help="multi-process mesh dispatches by "
                                   "outcome")
                    for o in ("ok", "fallback", "rejected")}
_M_PROC_FALLBACK = {r: get_counter("filodb_mesh_proc_fallback",
                                   {"reason": r},
                                   help="multi-process dispatches that fell "
                                   "back to the single-process engines")
                    for r in ("disabled", "unsupported", "histogram",
                              "worker", "stale")}
_M_PROC_WORKERS = Gauge("filodb_mesh_proc_workers",
                        help="mesh worker processes last seen reachable")
_M_PROC_COLLECTIVE = Histogram(
    "filodb_mesh_proc_collective_seconds",
    help="root-side cross-process reduce latency (gather + group reduce)")


@dataclass(frozen=True)
class LoweredDescriptor:
    """A lowered mesh query as it goes from the root to a worker: the plan
    signature (selector filters, range function, window, offset,
    grouping, post-transforms), the step grid and the mesh-axis
    assignment (``shard_axis`` worker slices × ``time_axis`` devices, one
    a process). Workers run the agg-stripped form (``to_lowered(
    strip_agg=True)``); grouping and post-transforms stay on the root."""

    dataset: str
    filters: tuple
    start: int
    step: int
    end: int
    window: int
    fn: str
    offset: int
    agg: str | None
    by: tuple
    without: tuple
    keep_metric: bool
    post: tuple = ()
    shard_axis: int = 1
    time_axis: int = 1

    @classmethod
    def from_lowered(cls, low, dataset: str,
                     shard_axis: int = 1) -> "LoweredDescriptor":
        return cls(dataset=dataset, filters=tuple(low.filters),
                   start=low.start, step=low.step, end=low.end,
                   window=low.window, fn=low.fn, offset=low.offset,
                   agg=low.agg, by=tuple(low.by),
                   without=tuple(low.without),
                   keep_metric=low.keep_metric, post=tuple(low.post),
                   shard_axis=shard_axis, time_axis=1)

    def to_lowered(self, strip_agg: bool = False):
        from filodb_tpu_torch.parallel.mesh_engine import MeshLowered

        if strip_agg:
            # a worker's half: per-series rows with full keys, no
            # aggregation and no post-transforms
            return MeshLowered(self.filters, self.start, self.step,
                               self.end, self.window, self.fn, self.offset,
                               None, (), (), True, ())
        return MeshLowered(self.filters, self.start, self.step, self.end,
                           self.window, self.fn, self.offset, self.agg,
                           tuple(self.by), tuple(self.without),
                           self.keep_metric, tuple(self.post))

    @property
    def signature(self):
        """A worker's cache key of the descriptor (the grid excluded)."""
        return (self.dataset, self.filters, self.window, self.fn,
                self.offset, self.step)


class MeshWorkerClient(RemotePlanDispatcher):
    """The root's client of one mesh worker: descriptor execution and
    status on the pooled, authed plan wire (a dispatcher subclass, so it
    is registered on the wire). Its hello asks for uncompressed frames: a
    worker's answer is mostly float windows, which zlib hardly shrinks,
    and at a million series its seconds would stand in every query."""

    compress = False

    def exec_descriptors(self, descs: list, deadline=None):
        """Run descriptors on the worker's slice; returns its result dict.
        Raises ``QueryRejected`` where the worker's admission shed the
        query, and a transport error or ``CircuitOpenError`` where the
        worker is unavailable."""
        breaker = breaker_for(self.peer)

        def attempt():
            timeout = deadline.timeout(cap=self.timeout,
                                       what=f"mesh exec on {self.peer}") \
                if deadline is not None else self.timeout
            FaultInjector.fire("meshproc.exec", host=self.host,
                               port=self.port)
            # the remaining budget bounds the worker's admission wait
            return self._roundtrip(("mesh_exec", list(descs), timeout),
                                   timeout)

        t0 = time.perf_counter()
        with span("mesh-proc-exec", peer=self.peer), \
                breaker.calling(transport_errors=self.TRANSPORT_ERRORS):
            resp = default_retry_policy().call(
                attempt, retry_on=self.TRANSPORT_ERRORS, deadline=deadline)
        record_peer_latency(self.peer, time.perf_counter() - t0)
        if resp[0] == "ok":
            return resp[1]
        if resp[0] == "rejected":
            from filodb_tpu_torch.utils.governor import QueryRejected
            retry_after = resp[2] if len(resp) > 2 else 1.0
            raise QueryRejected(
                f"mesh worker {self.peer} shed the query: {resp[1]}",
                retry_after_s=retry_after)
        raise RuntimeError(f"mesh exec failed on {self.peer}: {resp[1]}")

    def status(self, timeout_s: float = 2.0) -> dict:
        """The worker's status on a short timeout, outside the query
        path's retries and breaker."""
        resp = self._roundtrip(("mesh_status",), timeout_s)
        if resp[0] == "ok":
            return resp[1]
        raise RuntimeError(f"mesh status failed on {self.peer}: {resp[1]}")


class MeshClusterRuntime:
    """Routes lowered queries across the worker processes and reduces
    their slices on ``device`` (the root's card unless the caller names
    another). ``workers`` lists ``(host, port, (shard_lo, shard_hi))``,
    whose half-open ranges tile ``[0, num_shards)`` in order."""

    def __init__(self, memstore, dataset: str, num_shards: int,
                 workers: list, timeout: float = 30.0, device=None):
        lo_seen = 0
        self.workers = []
        for host, port, (lo, hi) in workers:
            if lo != lo_seen:
                raise ValueError(
                    f"worker shard slices must tile [0, {num_shards}) "
                    f"contiguously; got [{lo}, {hi}) after {lo_seen}")
            lo_seen = hi
            self.workers.append((MeshWorkerClient(host, port,
                                                  timeout=timeout),
                                 (lo, hi)))
        if lo_seen != num_shards:
            raise ValueError(f"worker slices cover [0, {lo_seen}), "
                             f"need [0, {num_shards})")
        from filodb_tpu_torch.device import resolve
        from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine

        self.memstore = memstore
        self.dataset = dataset
        self.num_shards = num_shards
        self.timeout = timeout
        self.device = resolve(device)
        # plan recognition (``sidecars``: the tick-shaped grids the
        # single-process path hands the sidecar lane are declined here
        # too) and the root's reduce
        self.engine = MeshQueryEngine(self.device, sidecars=True)
        self.last_collective_s: float | None = None
        self._lock = threading.Lock()
        # the workers' key lists (the same objects while their batches
        # live, the wire's decode memo) → their concatenation and its
        # metric-free form: a warm query rebuilds neither
        self._keys: dict = {}
        _M_PROC_WORKERS.set(len(self.workers))

    def enabled(self) -> bool:
        return bool(self.workers) \
            and os.environ.get("FILODB_MULTIPROC", "1") != "0"

    @staticmethod
    def _fallback(reason: str) -> None:
        _M_PROC_FALLBACK[reason].inc()
        _M_PROC_DISPATCH["fallback"].inc()

    def execute_plan(self, plan, deadline=None, stats=None):
        """``plan`` across the workers; None: fall back to the
        single-process engines (the caller stays in its admission)."""
        if not self.enabled():
            self._fallback("disabled")
            return None
        low = self.engine._lower(plan)
        if low is None:
            self._fallback("unsupported")
            return None
        return self.execute_lowered(low, deadline=deadline, stats=stats)

    def execute_lowered(self, low, deadline=None, stats=None):
        """One lowered query scattered to every slice and reduced; None
        where a worker is unavailable or stale or the shape is declined;
        ``QueryRejected`` propagates."""
        if not self.enabled():
            self._fallback("disabled")
            return None
        desc = LoweredDescriptor.from_lowered(low, self.dataset,
                                              shard_axis=len(self.workers))
        # the root's offsets before the dispatch: a worker that tailed at
        # least this far saw everything the root would scan now
        root_off = {s.shard_num: s.latest_offset
                    for s in self.memstore.shards} \
            if self.memstore is not None else {}
        from filodb_tpu_torch.utils.governor import QueryRejected

        outs: list = [None] * len(self.workers)
        errs: list = [None] * len(self.workers)

        def run(i, cli):
            try:
                outs[i] = cli.exec_descriptors([desc], deadline)
            except Exception as e:  # noqa: BLE001 - classified below
                errs[i] = e

        threads = [threading.Thread(target=run, args=(i, cli), daemon=True,
                                    name=f"meshproc-{cli.peer}")
                   for i, (cli, _) in enumerate(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errs:
            if isinstance(e, QueryRejected):
                _M_PROC_DISPATCH["rejected"].inc()
                raise e
        bad = [e for e in errs if e is not None]
        if bad:
            for e in bad:
                if not isinstance(e, (CircuitOpenError, RuntimeError,
                                      *MeshWorkerClient.TRANSPORT_ERRORS)):
                    raise e  # the deadline, a fault of the code
            log.warning("mesh worker slice unavailable, falling back: %s",
                        bad[0])
            self._fallback("worker")
            return None
        _M_PROC_WORKERS.set(len(self.workers))
        for (_, (lo, hi)), part in zip(self.workers, outs):
            offs = part.get("offsets", {})
            for s in range(lo, hi):
                if offs.get(s, -1) < root_off.get(s, 0):
                    self._fallback("stale")
                    return None
        mats = [part["results"][0] for part in outs]
        if any(m is None for m in mats):
            self._fallback("unsupported")
            return None
        if any(m.les is not None for m in mats):
            # a histogram leaf: the combine carries no buckets yet
            self._fallback("histogram")
            return None
        if stats is not None:
            for part in outs:
                stats.series_scanned += int(part.get("series", 0))
                stats.samples_scanned += int(part.get("samples", 0))
        t0 = time.perf_counter()
        result = self._reduce(low, mats)
        dt = time.perf_counter() - t0
        self.last_collective_s = dt
        _M_PROC_COLLECTIVE.observe(dt)
        _M_PROC_DISPATCH["ok"].inc()
        return result

    def _reduce(self, low, mats):
        """The root's reduce over the workers' blocks in shard order: the
        single-process engine's own code over the same rows."""
        from filodb_tpu_torch.query.exec.transformers import steps_array

        steps_ms = steps_array(low.start, low.step, low.end)
        K = len(steps_ms)
        blocks: list = []
        for m in mats:
            # a worker's windows come in their own dtype (float32 from B3
            # and B4): the reduce converts them as the single-process
            # engine converts its own
            v = np.asarray(m.values)
            blocks.append(v if v.size else v.reshape(0, K))
        if len({b.dtype for b in blocks}) > 1:
            blocks = [b.astype(np.float64) for b in blocks]
        vals = np.concatenate(blocks, axis=0) if len(blocks) > 1 \
            else blocks[0]
        with self._lock:
            lists = tuple(m.keys for m in mats)
            hit = self._keys.get(tuple(map(id, lists)))
            if hit is None or any(a is not b for a, b in zip(hit[0], lists)):
                keys = [k for m in mats for k in m.keys]
                hit = (lists, keys, [k.drop_metric() for k in keys])
                if len(self._keys) >= 8:
                    self._keys.pop(next(iter(self._keys)))
                self._keys[tuple(map(id, lists))] = hit
            return self.engine.reduce_rows(low, hit[1], vals, steps_ms,
                                           dropped=hit[2])

    def status(self) -> dict:
        """Each worker's slice, breaker, devices, caches and launches, and
        the last collective's seconds (``/api/v1/status/mesh``)."""
        workers = []
        reachable = 0
        for cli, (lo, hi) in self.workers:
            entry = {"peer": cli.peer, "shards": [lo, hi],
                     "breaker": breaker_for(cli.peer).state}
            try:
                entry.update(cli.status())
                entry["reachable"] = True
                reachable += 1
            except MeshWorkerClient.TRANSPORT_ERRORS as e:
                entry["reachable"] = False
                entry["error"] = str(e)
            workers.append(entry)
        _M_PROC_WORKERS.set(reachable)
        return {"dataset": self.dataset, "num_shards": self.num_shards,
                "enabled": self.enabled(), "workers": workers,
                "last_collective_s": self.last_collective_s}

    def shutdown(self) -> None:
        """Drop the pooled worker connections (the supervisor owns the
        processes)."""
        for cli, _ in self.workers:
            cli._drop_conn()
