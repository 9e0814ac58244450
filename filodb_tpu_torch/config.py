"""Server and dataset configuration.

Copy of ``filodb_tpu/config.py``: ``DEFAULTS`` (the reference's, value
for value), ``ServerConfig`` with its fields and ``ServerConfig.load``
(defaults, then the JSON file merged over them, then the per-dataset
blocks into ``IngestionConfig``\\ s), so one file loads to the same values
in both packages.

The port boots a single coordinator node (``standalone.py``). Options
whose modules it does not have yet raise ``NotImplementedError`` naming
their ROADMAP item when set away from their default (``UNPORTED``, and
the ``resilience`` keys of partial scatter-gather). ``result_cache``,
``http_response_cache``, ``governor``, ``resilience`` (the query
timeout, the retry policy and the circuit breakers), ``cost_model``,
``tracing``, ``mesh_workers`` (the multi-process mesh runtime), a
dataset's
``downsample`` block (the job, its streaming form and the long-time
planner), ``federation`` (the tiered planner, with ``mem_retention_ms``
set), ``store`` (``backend``: ``local`` sqlite, or ``object`` for the
S3-compatible tier with its endpoint, bucket, prefix, credentials and
segment, bucket and queue sizes), ``rules`` (groups, tick, catch-up cap
and the webhook notifier) and ``selfmon`` (the ``_meta`` dataset, its
sampler and the default alert group) are acted on, in any form the
reference takes;
a dataset's ``engine`` is ``mesh``, ``adaptive`` or ``exec``.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field

from filodb_tpu_torch.core.store.config import IngestionConfig, StoreConfig
from filodb_tpu_torch.utils import resilience as resilience_mod

ENGINES = ("mesh", "adaptive", "exec")

DEFAULTS = {
    "node_name": "node-0",
    "data_dir": "./filodb-data",
    "wal_dir": None,
    "wal_fsync": False,
    "wal_server_port": 0,
    "wal_remote": None,
    "wal_kafka": None,
    "consul": None,
    "store_server_port": 0,
    "store_remote": None,
    "http_port": 8080,
    "gateway_port": 0,
    "executor_port": 0,
    "seeds": [],
    "enable_failover": False,
    "resilience": {
        "query_timeout_s": 30.0,
        "retry_max_attempts": 2,
        "breaker_failure_threshold": 5,
        "breaker_reset_s": 10.0,
        "allow_partial": True,
        "partial_max_fraction": 0.5,
    },
    "result_cache": {
        "enabled": True,
        "extent_steps": 32,
        "max_bytes": 256 * 1024 * 1024,
        "ooo_allowance_ms": 300_000,
    },
    "governor": {
        "admission_capacity": 32,
        "admission_queue_limit": 128,
        "max_queue_wait_s": 5.0,
        "retry_after_s": 1.0,
        "degraded_capacity_factor": 0.5,
        "degraded_threshold": 0.75,
        "critical_threshold": 0.92,
        "watchdog_interval_s": 0.5,
        "max_samples_scanned": 0,
        "max_result_bytes": 0,
        "max_group_cardinality": 0,
        "budget_degrade": "partial",
        "rules_max_inflight": 2,
        "tenants": {},
    },
    "cost_model": {
        "min_samples": 8,
        "max_signatures": 4096,
        "reservoir": 64,
        "cheap_threshold_s": 0.05,
    },
    "tracing": {
        "sample_rate": 0.0,
        "slow_query_threshold_ms": 500.0,
        "slowlog_capacity": 128,
        "slow_ingest_threshold_ms": 250.0,
        "ingest_slowlog_capacity": 128,
    },
    "selfmon": {
        "enabled": False,
        "interval_s": 15.0,
        "num_shards": 1,
        "include_buckets": False,
        "ooo_allowance_ms": 2_000,
        "default_alerts": True,
        "lag_alert_threshold_s": 60.0,
        "lag_alert_for": "30s",
        "alert_interval": "5s",
    },
    "migration": {
        "auto_rebalance": False,
        "lag_threshold": 0,
        "catchup_timeout_s": 30.0,
    },
    # the multi-process mesh runtime (``parallel/multiproc.py``,
    # ``coordinator/mesh_cluster.py``): N worker processes on the card, each
    # a contiguous slice of one dataset's shards; the node reduces their
    # windows and falls back to its own engines when a slice is unavailable
    "mesh_workers": {
        "enabled": False,
        "workers": 2,
        "base_port": 0,
        "dataset": None,
        "timeout_s": 30.0,
        "ready_timeout_s": 120.0,
        "seed": None,
    },
    "replication": {
        "n_replicas": 0,
        "in_sync_lag": 0,
        "hedge_s": 0.05,
        "durable_sync_s": 5.0,
    },
    "rules": {
        "tick_s": 1.0,
        "max_catchup_steps": 512,
        "groups": [],
        "notify": {
            "webhook_url": None,
            "timeout_s": 5.0,
            "max_attempts": 4,
            "queue_depth": 256,
        },
    },
    "federation": {
        "enabled": True,
        "mem_retention_ms": None,
        "odp_max_chunks": 10_000,
        "refresh_s": 60.0,
    },
    "store": {
        "backend": "local",
        "endpoint": None,
        "bucket": "filodb",
        "prefix": "",
        "access_key": None,
        "secret_key": None,
        "region": "us-east-1",
        "upload_queue_depth": 64,
        "segment_target_bytes": 1 << 20,
        "bucket_count": 8,
    },
    "datasets": {
        "timeseries": {
            "num_shards": 4,
            "min_num_nodes": 1,
            "spread": 1,
            "engine": "mesh",
            "store": {
                "flush_interval_ms": 3_600_000,
                "max_chunk_size": 400,
                "groups_per_shard": 20,
                "retention_ms": 3 * 24 * 3_600_000,
            },
        }
    },
}

# option → why it raises set away from its default: its module is not
# ported (the ROADMAP item that ports it)
UNPORTED = {
    "seeds": "cluster membership beyond one node (ROADMAP §A.12)",
    "consul": "seed discovery (ROADMAP §A.12)",
    "enable_failover": "coordinator failover (ROADMAP §A.12)",
    "migration": "live shard migration (ROADMAP §A.12)",
    "replication": "shard replication (ROADMAP §A.12)",
    "wal_remote": "the networked log (ROADMAP §A.12)",
    "wal_kafka": "the Kafka log (ROADMAP §A.12)",
    "wal_server_port": "the log server (ROADMAP §A.12)",
    "store_remote": "the remote column store (ROADMAP §A.12)",
    "store_server_port": "the column-store server (ROADMAP §A.12)",
}


@dataclass
class ServerConfig:
    node_name: str = "node-0"
    data_dir: str = "./filodb-data"
    wal_dir: str | None = None
    wal_fsync: bool = False
    wal_server_port: int = 0
    wal_remote: str | None = None
    wal_kafka: str | None = None
    consul: dict | None = None
    store_server_port: int = 0
    store_remote: str | None = None
    http_port: int = 8080
    http_reuse_port: bool = False
    http_impl: str = "fast"  # "fast" event loop | "threaded" stdlib server
    http_response_cache: bool = True
    gateway_port: int = 0
    executor_port: int = 0
    seeds: list[str] = field(default_factory=list)
    enable_failover: bool = False
    datasets: dict[str, IngestionConfig] = field(default_factory=dict)
    spreads: dict[str, int] = field(default_factory=dict)
    downsample: dict[str, dict] = field(default_factory=dict)
    engines: dict[str, str] = field(default_factory=dict)
    resilience: dict = field(default_factory=dict)
    result_cache: dict = field(default_factory=dict)
    governor: dict = field(default_factory=dict)
    cost_model: dict = field(default_factory=dict)
    store: dict = field(default_factory=dict)
    migration: dict = field(default_factory=dict)
    mesh_workers: dict = field(default_factory=dict)
    replication: dict = field(default_factory=dict)
    rules: dict = field(default_factory=dict)
    tracing: dict = field(default_factory=dict)
    selfmon: dict = field(default_factory=dict)
    federation: dict = field(default_factory=dict)

    @staticmethod
    def load(path: str | None = None) -> "ServerConfig":
        cfg = copy.deepcopy(DEFAULTS)
        if path:
            with open(path) as f:
                _deep_merge(cfg, json.load(f))
        datasets, spreads, downsample, engines = {}, {}, {}, {}
        for name, d in cfg["datasets"].items():
            if d.get("downsample"):
                downsample[name] = d["downsample"]
            store = StoreConfig(**{k: v for k, v in d.get("store", {}).items()
                                   if k in StoreConfig.__dataclass_fields__})
            datasets[name] = IngestionConfig(
                dataset=name, num_shards=d.get("num_shards", 4),
                min_num_nodes=d.get("min_num_nodes", 1), store=store,
                downsample=d.get("downsample"))
            spreads[name] = d.get("spread", 1)
            engines[name] = d.get("engine", "mesh")
        return ServerConfig(
            node_name=cfg["node_name"], data_dir=cfg["data_dir"],
            wal_dir=cfg.get("wal_dir"),
            wal_fsync=cfg.get("wal_fsync", False),
            wal_server_port=cfg.get("wal_server_port", 0),
            wal_remote=cfg.get("wal_remote"),
            wal_kafka=cfg.get("wal_kafka"),
            consul=cfg.get("consul"),
            store_server_port=cfg.get("store_server_port", 0),
            store_remote=cfg.get("store_remote"),
            http_port=cfg["http_port"],
            http_reuse_port=cfg.get("http_reuse_port", False),
            http_impl=cfg.get("http_impl", "fast"),
            http_response_cache=cfg.get("http_response_cache", True),
            gateway_port=cfg["gateway_port"],
            executor_port=cfg["executor_port"], seeds=cfg["seeds"],
            enable_failover=cfg.get("enable_failover", False),
            datasets=datasets, spreads=spreads, downsample=downsample,
            engines=engines, resilience=cfg.get("resilience", {}),
            result_cache=cfg.get("result_cache", {}),
            governor=cfg.get("governor", {}),
            cost_model=cfg.get("cost_model", {}),
            store=cfg.get("store", {}),
            migration=cfg.get("migration", {}),
            mesh_workers=cfg.get("mesh_workers", {}),
            replication=cfg.get("replication", {}),
            rules=cfg.get("rules", {}),
            tracing=cfg.get("tracing", {}),
            selfmon=cfg.get("selfmon", {}),
            federation=cfg.get("federation", {}))

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for an option the port does not
        have, set away from its default (``UNPORTED``,
        ``StoreConfig.check_supported``), or an unknown front end or
        engine."""
        for opt, why in UNPORTED.items():
            if _get(self, opt) != _default(opt):
                raise NotImplementedError(
                    f"{opt}={_get(self, opt)!r}: {why}")
        resilience_mod.check_supported(self.resilience)
        if (self.mesh_workers or {}).get("enabled") \
                and self.store.get("backend", "local") != "local" \
                and not (self.mesh_workers or {}).get("seed"):
            raise NotImplementedError(
                "mesh_workers over store.backend="
                f"{self.store.get('backend')!r}: the workers recover from "
                "the local-disk stores only (ROADMAP §A.12)")
        if self.http_impl not in ("fast", "threaded"):
            raise ValueError(f"http_impl {self.http_impl!r}: fast or "
                             f"threaded")
        for name, ing in self.datasets.items():
            ing.store.check_supported()
            if self.engines.get(name, "mesh") not in ENGINES:
                raise ValueError(f"dataset {name}: engine "
                                 f"{self.engines[name]!r}: one of "
                                 f"{', '.join(ENGINES)}")


def _get(cfg: ServerConfig, opt: str):
    head, _, rest = opt.partition(".")
    v = getattr(cfg, head)
    return v.get(rest, _default(opt)) if rest else v


def _default(opt: str):
    head, _, rest = opt.partition(".")
    return DEFAULTS[head][rest] if rest else DEFAULTS[head]


def _deep_merge(base: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v
