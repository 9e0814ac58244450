"""The adaptive engine: the mesh engine on the card (or on a mesh of local
devices), a single-device lane and a host lane, cost-routed by batch size.

Port of ``filodb_tpu/parallel/adaptive.py``
(``QueryService(engine="adaptive")``; the default engine stays ``mesh``,
which never builds a host lane). A query's latency on the card is a
synchronization floor plus the device's work; a small scan can answer
sooner on the host, and one that a mesh's blocks and combines cost more
than they save, on one device. The engine keeps its lanes behind the mesh
engine's interface and routes each call to the lane measured faster for
its batch-size bucket:

- ``device``: the port's ``MeshQueryEngine`` on the card or over the
  service's ``mesh`` (``variant`` its time combine), with the service's
  batch and group-id caches;
- ``single``: where that mesh spans more than one slot, a 1×1 engine on
  its first slot, built on first use beside it (it shares the caches; a
  batch's key names its layout), as the reference's one-device mesh;
- ``host``: the same engine on ``torch.device("cpu")``, which runs every
  kernel's plain version, as the reference's host lane runs the same
  programs on the CPU backend. It is built on first use when the device
  lane is not the CPU; a build that fails raises (the reference logs and
  goes on without the lane; ROADMAP §C). Tests inject one (``host_lane``).

Routing, as the reference's: an estimate of seconds a query a (lane,
bucket), an EWMA whose first two samples replace; a cold bucket is served
by the host lane, else by the single-device lane; the others are probed
by shadow traffic on a
background worker (a copy of a served batch, never a client's wait) when
its estimate is missing, and once every ``SHADOW_EVERY`` calls (then
rotating through them). Every
sample is mirrored into the cost model's ``lane`` site, which takes over
the pick once it is warm on every lane (a persisted model). A lane's time
includes the device→host copy of its answers. Counted in
``filodb_mesh_routed{lane}``, ``routed`` and ``shadowed``.

A shadow probe runs under the service's lock (``lock``), so it never
overlaps a query on the caches the device lane shares with exec.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

import torch

from filodb_tpu_torch.parallel.mesh_engine import MeshQueryEngine
from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.query.model import QueryStats, StepMatrix
from filodb_tpu_torch.utils.metrics import get_counter

log = logging.getLogger(__name__)

_BUCKETS = (1, 4, 16, 64, 256, 1024)
_M_ROUTED = {la: get_counter("filodb_mesh_routed", {"lane": la},
                             help="adaptive engine lane routing decisions")
             for la in ("device", "single", "host")}


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def measure_sync_floor(device: torch.device, tries: int = 3) -> float:
    """Median seconds of a trivial launch and its synchronization on
    ``device``: the floor a blocking query pays there."""
    x = torch.zeros(8, device=device)
    (x + 1.0).sum().item()  # outside the timing: the first launch
    samples = []
    for _ in range(tries):
        t0 = time.perf_counter()
        x + 1.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


class _LaneCost:
    """Warmup-aware EWMA: the first two samples replace outright."""

    __slots__ = ("est", "n")

    def __init__(self):
        self.est = None
        self.n = 0

    def record(self, per_q: float, alpha: float = 0.3) -> None:
        self.n += 1
        if self.est is None or self.n <= 2:
            self.est = per_q
        else:
            self.est += alpha * (per_q - self.est)


class AdaptiveQueryEngine:
    """The mesh engine's interface (``supports``, ``execute``,
    ``execute_many``; anything else is the device lane's) over two
    lanes."""

    SHADOW_EVERY = 32  # probe the other lane once in this many calls

    def __init__(self, device: torch.device | None = None, batches=None,
                 gids=None, sidecars: bool = False, dataset: str = "",
                 lock=None, host_lane=None, mesh=None,
                 variant: str = "gather"):
        self.device_engine = MeshQueryEngine(device, batches, gids,
                                             sidecars=sidecars, mesh=mesh,
                                             variant=variant)
        self._host_engine = host_lane
        self._host_checked = host_lane is not None
        self._single_engine = None
        self._single_checked = False
        self._cost: dict[tuple, _LaneCost] = {}
        self._calls = 0
        self._dataset = dataset
        self._lock = lock if lock is not None else threading.RLock()
        self.sync_floor_s: float | None = None
        self.routed = {"device": 0, "single": 0, "host": 0}
        self.shadowed = {"device": 0, "single": 0, "host": 0}
        self._shadow_q: queue.Queue | None = None
        self._shadow_thread = None
        self._pending = 0  # shadow probes queued or running

    def __getattr__(self, name):
        # the device lane's caches and helpers (``batches``,
        # ``window_cache``, ``_batch``, ...)
        if name == "device_engine":
            raise AttributeError(name)
        return getattr(self.device_engine, name)

    # ---- lanes ---------------------------------------------------------------

    def _host(self) -> MeshQueryEngine | None:
        """The host lane, built on first use where the device lane is not
        the CPU already."""
        if not self._host_checked:
            self._host_checked = True
            dev = self.device_engine.device
            if dev.type != "cpu":
                self._host_engine = MeshQueryEngine(
                    torch.device("cpu"), sidecars=self.device_engine.sidecars)
                self.sync_floor_s = measure_sync_floor(dev)
                log.info("adaptive engine: host lane up, device sync floor "
                         "%.3f ms", self.sync_floor_s * 1e3)
        return self._host_engine

    def _single(self) -> MeshQueryEngine | None:
        """The single-device lane, built on first use where the device
        lane's mesh spans more than one slot: a 1×1 engine on its first
        slot, sharing its caches."""
        if not self._single_checked:
            self._single_checked = True
            dev = self.device_engine
            if len(dev.mesh) > 1:
                self._single_engine = MeshQueryEngine(
                    dev.device, dev.batches, dev.gids, sidecars=dev.sidecars,
                    variant=dev.variant)
                log.info("adaptive engine: single-device lane up on %s",
                         dev.device)
        return self._single_engine

    def _lanes(self) -> list[str]:
        lanes = ["device"]
        if self._single() is not None:
            lanes.append("single")
        if self._host() is not None:
            lanes.append("host")
        return lanes

    def _engine_for(self, lane: str):
        return {"device": self.device_engine, "single": self._single_engine,
                "host": self._host_engine}[lane]

    def _cost_of(self, lane: str, b: int) -> _LaneCost:
        c = self._cost.get((lane, b))
        if c is None:
            c = self._cost[(lane, b)] = _LaneCost()
        return c

    def estimates(self) -> dict:
        """{lane: {bucket: seconds a query}} of the warm estimates."""
        out: dict = {}
        for (lane, b), c in sorted(self._cost.items()):
            if c.est is not None:
                out.setdefault(lane, {})[b] = c.est
        return out

    def _route(self, n_queries: int) -> str:
        lanes = self._lanes()
        if len(lanes) == 1:
            return "device"
        b = _bucket(n_queries)
        self._calls += 1
        known = {la: self._cost_of(la, b).est for la in lanes
                 if self._cost_of(la, b).est is not None}
        if not known:
            # cold: the cheapest dispatch (the host, else one device, which
            # pays no mesh's blocks and combines); shadows price the rest
            return "host" if "host" in lanes else "single"
        return min(known, key=known.get)

    def _record(self, lane: str, n_queries: int, secs: float) -> None:
        per_q = secs / max(n_queries, 1)
        b = _bucket(n_queries)
        self._cost_of(lane, b).record(per_q)
        cm.model_for(self._dataset).observe("lane", f"b{b}", lane, per_q)

    def _shared_decision(self, lane: str, n_queries: int):
        """The local router's pick is the ``lane`` site's static arm; a
        model warm on every lane picks its predicted-cheapest."""
        lanes = self._lanes()
        if len(lanes) == 1:
            return lane, None, None
        model = cm.model_for(self._dataset)
        d = model.decide("lane", f"b{_bucket(n_queries)}", tuple(lanes),
                         static_arm=lane)
        return d.arm, d, model

    # ---- shadow probes ---------------------------------------------------------

    def _ensure_shadow_worker(self) -> None:
        if self._shadow_thread is not None:
            return
        self._shadow_q = queue.Queue(maxsize=1)

        def run():
            while True:
                lane, plans, memstore = self._shadow_q.get()
                try:
                    with self._lock:
                        t0 = time.perf_counter()
                        outs = self._engine_for(lane).execute_many(
                            memstore, plans, [QueryStats() for _ in plans])
                        done = _materialized(outs)
                        if done:
                            self._record(lane, done,
                                         time.perf_counter() - t0)
                            self.shadowed[lane] += 1
                except Exception:  # noqa: BLE001 - off the serving path
                    log.exception("shadow probe failed (%s)", lane)
                finally:
                    self._pending -= 1

        self._shadow_thread = threading.Thread(target=run, daemon=True,
                                               name="adaptive-shadow")
        self._shadow_thread.start()

    def _maybe_shadow(self, served: str, plans: list, memstore) -> None:
        """Copy a served batch onto the other lane, off the serving path,
        where that lane's estimate is missing or on schedule; a probe
        already in flight drops this one."""
        others = [la for la in self._lanes() if la != served]
        if not others:
            return
        b = _bucket(len(plans))
        missing = [la for la in others if self._cost_of(la, b).est is None]
        if missing:
            other = missing[0]
        elif self._calls % self.SHADOW_EVERY == 0:
            other = others[(self._calls // self.SHADOW_EVERY) % len(others)]
        else:
            return
        self._ensure_shadow_worker()
        try:
            self._pending += 1
            self._shadow_q.put_nowait((other, list(plans), memstore))
        except queue.Full:
            self._pending -= 1

    def drain(self, timeout_s: float = 60.0) -> None:
        """Wait until no shadow probe is queued or running (tests, and the
        smoke's counts)."""
        t_end = time.monotonic() + timeout_s
        while self._pending > 0 and time.monotonic() < t_end:
            time.sleep(0.01)

    # ---- execution -------------------------------------------------------------

    def supports(self, memstore, plan) -> str | None:
        return self.device_engine.supports(memstore, plan)

    def execute(self, memstore, plan, stats: QueryStats,
                deadline=None) -> StepMatrix:
        lane, d, model = self._shared_decision(self._route(1), 1)
        t0 = time.perf_counter()
        out = self._engine_for(lane).execute(memstore, plan, stats, deadline)
        out.materialize()  # the lane's cost includes the copy to the host
        dt = time.perf_counter() - t0
        self._record(lane, 1, dt)
        if d is not None:
            model.record_actual(d, dt, observe=False)
        self._served(lane)
        self._maybe_shadow(lane, [plan], memstore)
        return out

    def execute_many(self, memstore, plans: list,
                     stats_list: list[QueryStats], deadline=None) -> list:
        lane, d, model = self._shared_decision(self._route(len(plans)),
                                               len(plans))
        t0 = time.perf_counter()
        outs = self._engine_for(lane).execute_many(memstore, plans,
                                                   stats_list, deadline)
        done = _materialized(outs)
        if done:
            dt = time.perf_counter() - t0
            self._record(lane, done, dt)
            if d is not None:
                model.record_actual(d, dt / done, observe=False)
            self._served(lane)
            self._maybe_shadow(lane, plans, memstore)
        return outs

    def _served(self, lane: str) -> None:
        self.routed[lane] += 1
        _M_ROUTED[lane].inc()


def _materialized(outs: list) -> int:
    """Bring the answers of a lane's batch to the host; their number."""
    done = [o for o in outs if isinstance(o, StepMatrix)]
    for o in done:
        o.materialize()
    return len(done)
