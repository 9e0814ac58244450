"""Mesh worker processes: the per-process half of the multi-process mesh.

Port of ``filodb_tpu/parallel/multiproc.py``. Each worker owns a
contiguous slice of a dataset's shards and runs the agg-stripped
``LoweredDescriptor`` (``coordinator/mesh_cluster.py``) through its own
``MeshQueryEngine`` on its own card: its batches and window cache stay on
that card, so a warm worker's query is one window evaluation over its
rows (or none, from the window cache); the combine is the root's.

Two ways to own data:

- ``--config worker.json``: the worker recovers its shards from the
  node's column and meta stores and tails the node's WAL read-only
  (``_tail_shards``: ``Node.start_shard`` over a ``SegmentedFileLog(
  read_only=True)``, the node that appends owning flushes, checkpoints
  and retention). Right after an ingest it lags, which the root's
  staleness gate turns into a fallback.
- ``--seed module:callable``: the harness. The callable returns an
  ingested ``MemStore`` (seeded, and a record's shard hashes its content,
  so every process builds the same data) and ``_ShardSliceStore`` limits
  it to the slice. A callable may read the worker's ``--shards`` from
  ``sys.argv`` to ingest only the series routed there.

A worker runs on the card (``--device cuda``, the default) and exits
non-zero where it cannot reach CUDA, so ``wait_ready`` raises; nothing
carries on on the CPU unasked. ``--device cpu`` runs the plain versions,
as the tests do. ``mesh_status`` reports the worker's kernel launches
beside its programs. ``init_distributed`` is ``torch.distributed``'s
``init_process_group`` (NCCL on cards, gloo on the CPU), gated by
``FILODB_MESH_DISTRIBUTED=1`` as the reference gates its multi-host
runtime; the runtime itself needs only the plan wire.

    python -m filodb_tpu_torch.parallel.multiproc --dataset timeseries \\
        --shards 0:2 --num-shards 4 \\
        --seed filodb_tpu_torch.testing.mesh_store:build_store
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time

import torch

log = logging.getLogger(__name__)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, local_device_ids=None) -> None:
    """Join a ``torch.distributed`` process group over ``num_processes``
    processes (``coordinator_address`` as ``host:port``), NCCL where this
    process has a card (``local_device_ids[0]`` of it, else its rank's),
    gloo on the CPU. The runtime never needs it (the plan wire carries
    everything), so it runs only with ``FILODB_MESH_DISTRIBUTED=1``."""
    if os.environ.get("FILODB_MESH_DISTRIBUTED") != "1":
        raise RuntimeError(
            "set FILODB_MESH_DISTRIBUTED=1 to initialize the multi-process "
            "device runtime (the mesh workers run without it)")
    import torch.distributed as dist

    cuda = torch.cuda.is_available()
    if cuda:
        dev = (local_device_ids or [process_id])[0]
        torch.cuda.set_device(dev % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


class _ShardSliceStore:
    """A ``MemStore`` seen through an owned shard range: ``shards`` (and
    the ``version`` over them) are the slice's, the rest the store's."""

    def __init__(self, inner, dataset: str, lo: int, hi: int):
        # ``dataset``: the reference's signature (its store holds many);
        # a port ``MemStore`` holds one
        self._inner = inner
        self.shards = [s for s in inner.shards if lo <= s.shard_num < hi]

    @property
    def version(self) -> int:
        return sum(s.version for s in self.shards)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class MeshWorker:
    """One mesh worker: the framed control server (the transport's auth
    and hello) and a one-device engine over the owned slice."""

    def __init__(self, memstore, dataset: str, shard_range: tuple,
                 host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None, device=None):
        from filodb_tpu_torch.coordinator.remote import (
            cluster_secret,
            make_authed_handler,
        )
        from filodb_tpu_torch.device import resolve

        self.memstore = memstore
        self.dataset = dataset
        self.shard_range = shard_range
        self.device = resolve(device)
        self.secret = secret if secret is not None else cluster_secret()
        self._engine = None
        self._engine_lock = threading.Lock()
        self.queries = 0
        self.last_exec_s: float | None = None
        Handler = make_authed_handler(lambda: self.secret, self._handle,
                                      "mesh worker")

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True

        self.server = Server((host, port), Handler, bind_and_activate=True)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.address = (host, self.port)
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True,
                                        name=f"mesh-worker-{self.port}")

    def engine(self):
        """The one-device engine, made at the first query."""
        with self._engine_lock:
            if self._engine is None:
                from filodb_tpu_torch.parallel.mesh_engine import (
                    MeshQueryEngine,
                )
                self._engine = MeshQueryEngine(self.device)
            return self._engine

    # ---- protocol --------------------------------------------------------

    def _handle(self, msg):
        kind = msg[0]
        if kind == "ping":
            return ("pong",)
        if kind == "mesh_status":
            try:
                return ("ok", self._status())
            except Exception as e:  # noqa: BLE001 - answered to the root
                log.exception("mesh status failed")
                return ("err", repr(e))
        if kind == "mesh_exec":
            descs = msg[1]
            budget_s = msg[2] if len(msg) > 2 else None
            try:
                from filodb_tpu_torch.coordinator.query_service import (
                    plan_tenant,
                )
                from filodb_tpu_torch.utils.governor import (
                    EXPENSIVE,
                    QueryRejected,
                    governor,
                )
                from filodb_tpu_torch.utils.resilience import Deadline

                dl = Deadline.after(budget_s) if budget_s else None
                try:
                    # the admission gate of every query: a shed is a typed
                    # verdict the root raises as 503 and Retry-After
                    with governor().admit(deadline=dl, cost=EXPENSIVE,
                                          tenant=plan_tenant(descs[0])):
                        return ("ok", self._exec(descs))
                except QueryRejected as e:
                    return ("rejected", str(e), e.retry_after_s)
            except Exception as e:  # noqa: BLE001 - answered to the root
                log.exception("mesh exec failed")
                return ("err", repr(e))
        return ("err", f"unknown message {kind!r}")

    def _exec(self, descs) -> dict:
        from filodb_tpu_torch.query.model import QueryStats

        eng = self.engine()
        stats = QueryStats()
        t0 = time.perf_counter()
        results = []
        for desc in descs:
            low = desc.to_lowered(strip_agg=True)
            out = eng.execute_lowered_many([low], self.memstore, stats)[0]
            if out is not None:
                results.append(_on_host(out))
            else:
                results.append(None)
        self.queries += len(descs)
        self.last_exec_s = time.perf_counter() - t0
        offsets = {s.shard_num: s.latest_offset
                   for s in self.memstore.shards}
        return {"results": results, "offsets": offsets,
                "series": stats.series_scanned,
                "samples": stats.samples_scanned}

    def _status(self) -> dict:
        from filodb_tpu_torch import _build

        lo, hi = self.shard_range
        info = {"dataset": self.dataset, "shards": [lo, hi],
                "queries": self.queries, "last_exec_s": self.last_exec_s,
                "pid": os.getpid(), "device": str(self.device),
                "offsets": {s.shard_num: s.latest_offset
                            for s in self.memstore.shards}}
        eng = self._engine  # caches only once a query warmed them
        if eng is not None:
            entries, nbytes = eng.window_cache
            info["devices"] = 1
            info["descriptor_cache"] = len(eng.batches.batches("mesh"))
            info["caches"] = {"batch": len(eng.batches.batches("mesh")),
                              "programs": sum(1 for n in _build._libs
                                              if n in _build.SOURCES),
                              "eval": entries}
            info["device_bytes"] = eng.batch_bytes + nbytes
        else:
            info["devices"] = 0
            info["descriptor_cache"] = 0
            info["caches"] = {}
            info["device_bytes"] = 0
        # this process's kernel launches since it started
        info["launches"] = dict(_build.LAUNCHES)
        return info

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "MeshWorker":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _on_host(m):
    """A worker's answer ready for the wire: its values in host numpy in
    their own dtype (B3's and B4's float32 windows cross as they are, half
    the bytes, exactly the numbers the root would convert), and its keys,
    the batch's list, with their wire bytes made once a batch."""
    from filodb_tpu_torch.coordinator.wire import encoded

    m.settle()
    if isinstance(m.values, torch.Tensor):
        v = m.values.detach().cpu()
        m.values = (v if v.dtype in (torch.float32, torch.float64)
                    else v.to(torch.float64)).numpy()
    m.keys = encoded(m.keys)
    return m


def _load_seed(spec: str):
    """``module:callable`` → the callable's result (an ingested store)."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"--seed must be module:callable, got {spec!r}")
    obj = importlib.import_module(mod_name)
    for part in fn_name.split("."):
        obj = getattr(obj, part)
    return obj()


def _tail_shards(cfg, dataset: str, lo: int, hi: int):
    """Recover the owned shards from the node's stores, then tail the
    node's WAL read-only (the node appends, flushes and truncates)."""
    from filodb_tpu_torch.coordinator.cluster import Node
    from filodb_tpu_torch.core.store.localstore import (
        LocalDiskColumnStore,
        LocalDiskMetaStore,
    )
    from filodb_tpu_torch.kafka.log import SegmentedFileLog

    root = os.path.join(cfg.data_dir, "columnstore")
    node = Node(name=f"mesh-worker-{lo}-{hi}",
                column_store=LocalDiskColumnStore(root),
                meta_store=LocalDiskMetaStore(root), read_only=True)
    ing = cfg.datasets[dataset]
    wal = cfg.wal_dir or os.path.join(cfg.data_dir, "wal")
    for shard in range(lo, hi):
        node.start_shard(dataset, shard, ing, SegmentedFileLog(
            os.path.join(wal, dataset, f"shard-{shard}"), read_only=True))
    store = _ShardSliceStore(node.setup_dataset(ing, 0), dataset, lo, hi)
    return store, node


def worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m filodb_tpu_torch.parallel.multiproc",
        description="filodb_tpu_torch mesh worker process (one mesh slice)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--shards", required=True,
                    help="owned shard slice, lo:hi (half-open)")
    ap.add_argument("--num-shards", type=int, default=0,
                    help="global shard count (validation only)")
    ap.add_argument("--config", default=None,
                    help="worker config JSON: recover and tail the node's "
                    "stores and WAL")
    ap.add_argument("--seed", default=None,
                    help="module:callable returning an ingested MemStore "
                    "(harness)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    lo_s, _, hi_s = args.shards.partition(":")
    lo, hi = int(lo_s), int(hi_s)
    if args.num_shards and not (0 <= lo < hi <= args.num_shards):
        raise SystemExit(f"shard slice {lo}:{hi} outside "
                         f"[0, {args.num_shards})")
    from filodb_tpu_torch.device import resolve

    device = resolve(args.device)  # raises without a card, unless cpu
    node = None
    if args.seed:
        store = _ShardSliceStore(_load_seed(args.seed), args.dataset, lo, hi)
    elif args.config:
        from filodb_tpu_torch.config import ServerConfig

        cfg = ServerConfig.load(args.config)
        store, node = _tail_shards(cfg, args.dataset, lo, hi)
    else:
        raise SystemExit("one of --seed / --config is required")
    worker = MeshWorker(store, args.dataset, (lo, hi), host=args.host,
                        port=args.port, device=device).start()
    log.info("mesh worker serving %s[%d:%d) on %s:%d (%s)", args.dataset,
             lo, hi, args.host, worker.port, device)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        worker.stop()
        if node is not None:
            node.kill()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MeshWorkerSupervisor:
    """Spawns and stops the N worker processes of a multi-process mesh,
    one contiguous near-equal shard slice each. ``device`` goes to every
    worker (``--device``; None: the card)."""

    def __init__(self, dataset: str, num_shards: int, workers: int,
                 base_port: int = 0, host: str = "127.0.0.1",
                 config_path: str | None = None, seed: str | None = None,
                 env: dict | None = None, python: str | None = None,
                 device: str | None = None):
        if workers < 1:
            raise ValueError("need at least one mesh worker")
        self.dataset = dataset
        self.num_shards = num_shards
        self.host = host
        self.config_path = config_path
        self.seed = seed
        self.device = device
        self.env = dict(env or {})
        self.python = python or sys.executable
        bounds = [round(i * num_shards / workers)
                  for i in range(workers + 1)]
        ports = [base_port + i if base_port else _free_port()
                 for i in range(workers)]
        self.slices = [(host, ports[i], (bounds[i], bounds[i + 1]))
                       for i in range(workers)]
        self.procs: list[subprocess.Popen] = []

    def spawn(self) -> "MeshWorkerSupervisor":
        env = {**os.environ, **self.env}
        # the workers import this package wherever the caller runs from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        for host, port, (lo, hi) in self.slices:
            cmd = [self.python, "-m", "filodb_tpu_torch.parallel.multiproc",
                   "--host", host, "--port", str(port),
                   "--dataset", self.dataset,
                   "--shards", f"{lo}:{hi}",
                   "--num-shards", str(self.num_shards)]
            if self.device is not None:
                cmd += ["--device", str(self.device)]
            if self.seed:
                cmd += ["--seed", self.seed]
            elif self.config_path:
                cmd += ["--config", self.config_path]
            else:
                raise ValueError("supervisor needs seed or config_path")
            self.procs.append(subprocess.Popen(cmd, env=env))
        return self

    def addresses(self) -> list:
        return list(self.slices)

    def alive(self) -> list:
        return [p.poll() is None for p in self.procs]

    def wait_ready(self, timeout_s: float = 120.0) -> None:
        """Wait until every worker answers a ping; raises where one exits
        first (a worker without its card exits non-zero) or the time runs
        out."""
        from filodb_tpu_torch.coordinator.mesh_cluster import MeshWorkerClient

        deadline = time.monotonic() + timeout_s
        for (host, port, _), proc in zip(self.slices, self.procs):
            cli = MeshWorkerClient(host, port, timeout=2.0)
            while not cli.ping():
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"mesh worker {host}:{port} exited with "
                        f"{proc.returncode} before becoming ready")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mesh worker {host}:{port} not ready after "
                        f"{timeout_s}s")
                time.sleep(0.1)

    def stop(self, grace_s: float = 5.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + grace_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(worker_main())
