"""Query result model.

Port of ``filodb_tpu/query/model.py`` (``RangeVectorKey``, ``StepMatrix``,
``QueryStats``, ``QueryResult``, ``PlannerParams``, ``QueryContext``,
``TraceContext``): a
batch of series keys plus a dense
[P, K] value matrix over shared step timestamps, NaN marking "no sample";
a histogram matrix holds [P, K, B] values under bucket bounds ``les`` [B].
The engine hands values over as a torch tensor on its device;
``materialize`` applies any compaction deferred while they lived on the
device (on the device, so only kept rows cross to the host) and brings them
to host numpy (float64).

On the plan wire (``coordinator/wire.py``) each of these classes carries
the reference's fields, in its order (``__wire_fields__``): a
``StepMatrix`` goes materialized, its values in host numpy, and the
port's own fields stay behind, so both packages decode each other's
frames and equal objects encode to the same bytes.

``QueryStats.timed`` times a stage into ``decode_s`` or ``reduce_s``: on
the host's clock where the work runs on the CPU; on the card between two
CUDA events recorded on the current stream, read by ``settle_timings``
once the answer has been copied to the host (a copy that waits for the
stream anyway), so timing adds no synchronization of its own.
"""

from __future__ import annotations

import math
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from filodb_tpu_torch.core.partkey import METRIC_LABEL


class QueryLimitExceeded(RuntimeError):
    """A query over a size limit (``StoreConfig.max_query_matches``); the
    HTTP API answers 422, as the reference does."""


class UnsupportedQuery(ValueError):
    """A plan shape the port does not serve, or one that the reference's
    exec engine raises on. Under ``QueryService(engine="mesh")`` it is also
    the mesh engine's signal to hand the plan to the exec engine."""


def prom_float(v: float) -> str:
    """A float as the Prometheus wire writes it (``+Inf``, ``NaN``)."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


@dataclass(frozen=True)
class RangeVectorKey:
    """Series identity: a frozen, sorted label set."""

    labels: tuple[tuple[str, str], ...]

    @staticmethod
    def of(labels: dict[str, str]) -> "RangeVectorKey":
        return RangeVectorKey(tuple(sorted(labels.items())))

    @property
    def label_map(self) -> dict[str, str]:
        return dict(self.labels)

    def without(self, names) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple((k, v) for k, v in self.labels
                                    if k not in ns))

    def only(self, names) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple((k, v) for k, v in self.labels if k in ns))

    def drop_metric(self) -> "RangeVectorKey":
        return self.without((METRIC_LABEL,))

    def __str__(self) -> str:
        return "{" + ",".join(f"{k}={v}" for k, v in self.labels) + "}"


@dataclass
class StepMatrix:
    """Series sharing step timestamps: values [P, K], or [P, K, B] with
    bucket bounds ``les`` for a histogram matrix (numpy after
    ``materialize``, possibly a device tensor before)."""

    __wire_fields__ = ("keys", "values", "steps_ms", "les")

    keys: list[RangeVectorKey]
    values: "np.ndarray | torch.Tensor"
    steps_ms: np.ndarray  # int64 [K] epoch millis
    pending_compact: bool = False
    # ``keys`` with the metric label dropped, where known: a leaf hands over
    # its batch's cached list, so mappers above it keep one keys list (and
    # the group ids the engine caches for it) across queries
    dropped_keys: list | None = None
    les: np.ndarray | None = None  # [B] bucket upper bounds (histograms)
    # the key lists ``concat`` joined, in order, while the rows still are
    # theirs: group ids are cached per such list (``GroupIdCache.of``)
    key_parts: list | None = None

    @property
    def is_histogram(self) -> bool:
        return self.values.ndim == 3

    @property
    def num_series(self) -> int:
        return len(self.keys)

    @property
    def num_steps(self) -> int:
        return len(self.steps_ms)

    @staticmethod
    def empty(steps_ms: np.ndarray | None = None) -> "StepMatrix":
        steps = steps_ms if steps_ms is not None else np.array([], np.int64)
        return StepMatrix([], np.zeros((0, len(steps))), steps)

    def compact(self) -> "StepMatrix":
        """Drop series with no sample at all, when next settled (``settle``,
        ``materialize``), so values on the device cost no host sync here."""
        self.pending_compact = True
        return self

    def derive(self, keys, values) -> "StepMatrix":
        """A result whose rows still correspond 1:1 to this matrix's rows:
        deferred compaction carries over and is decided on the new values;
        bucket bounds carry over to values that still have a bucket axis."""
        return StepMatrix(keys, values, self.steps_ms, self.pending_compact,
                          les=self.les if values.ndim == 3 else None,
                          key_parts=self.key_parts if keys is self.keys
                          else None)

    def derive_without_metric(self, values) -> "StepMatrix":
        """``derive`` with the metric label dropped from every key; the
        dropped keys are built at most once a matrix and handed on."""
        if self.dropped_keys is None:
            self.dropped_keys = [k.drop_metric() for k in self.keys]
        out = self.derive(self.dropped_keys, values)
        out.dropped_keys = self.dropped_keys
        return out

    @staticmethod
    def concat(parts: list["StepMatrix"]) -> "StepMatrix":
        """The rows of ``parts`` in order (the first part's bucket bounds).
        Parts of different shapes, a histogram beside scalar series or
        histograms of different bucket counts, do not concatenate, as the
        reference's do not: that raises ``UnsupportedQuery``."""
        parts = [p for p in parts if p.num_series > 0]
        if len(parts) <= 1:
            return parts[0] if parts else StepMatrix.empty()
        shapes = {tuple(p.values.shape[1:]) for p in parts}
        if len(shapes) > 1:
            raise UnsupportedQuery(
                f"series of shapes {sorted(shapes)} do not concatenate (the "
                f"reference's exec engine raises too)")
        dev = torch.as_tensor(parts[0].values).device
        values = torch.cat([torch.as_tensor(p.values).to(dev, torch.float64)
                            for p in parts])
        keys = []
        for p in parts:
            keys.extend(p.keys)
        return StepMatrix(keys, values,
                          parts[0].steps_ms,
                          any(p.pending_compact for p in parts),
                          les=parts[0].les,
                          key_parts=[kp for p in parts
                                     for kp in (p.key_parts or [p.keys])])

    def settle(self) -> "StepMatrix":
        """Apply deferred compaction now, in place (on the device for device
        values: one host sync for the rows kept). Row-regrouping consumers
        (aggregations, joins) settle first, as the reference's compacted
        host matrices reach them. A histogram row is kept where its last
        bucket has a sample, as the reference's ``_keep_mask``."""
        if not self.pending_compact:
            return self
        self.pending_compact = False
        v = torch.as_tensor(self.values)
        last = v[:, :, -1] if v.dim() == 3 else v
        kept = (~torch.isnan(last).all(1)).nonzero().squeeze(1)
        if kept.numel() < self.num_series:
            self.keys = [self.keys[i] for i in kept.tolist()]
            self.values = v[kept]
            self.dropped_keys = None
            self.key_parts = None
        return self

    def flatten_histograms(self) -> "StepMatrix":
        """[P, K, B] histogram matrix → host [P·B, K], one series a bucket
        labelled ``le`` (bucket b of series i is row i·B + b; without
        ``les``, ``le`` counts the buckets 0, 1, … as the reference
        does)."""
        self.materialize()
        B = self.values.shape[2]
        les = self.les if self.les is not None else np.arange(B)
        le = [prom_float(float(x)) for x in les]
        keys = [RangeVectorKey.of({**k.label_map, "le": s})
                for k in self.keys for s in le]
        rows = np.ascontiguousarray(self.values.transpose(0, 2, 1)).reshape(
            -1, self.num_steps)
        return StepMatrix(keys, rows, self.steps_ms)

    def materialize(self) -> "StepMatrix":
        """Host float64 values, after any deferred compaction (applied on
        the device, so dropped rows never cross to the host)."""
        self.settle()
        if isinstance(self.values, torch.Tensor):
            self.values = self.values.detach().to("cpu", torch.float64) \
                .numpy()
        return self


@dataclass
class QueryStats:
    __wire_fields__ = ("series_scanned", "samples_scanned", "result_series",
                       "wall_time_s", "cpu_prep_s", "device_time_s",
                       "chunks_touched", "cache_hits", "cache_misses",
                       "wire_bytes", "admission_wait_s", "decode_s",
                       "reduce_s", "sidecar_chunks", "tiers", "pyramid")

    series_scanned: int = 0
    samples_scanned: int = 0
    result_series: int = 0
    wall_time_s: float = 0.0
    # leaves whose magnitudes failed the float32 gate and ran in float64
    precise_lane: int = 0
    # batches whose values float32 does not hold, evaluated over float64
    # values decoded from the codec chunks (the host-decode lane)
    host_lane: int = 0
    engine: str = ""    # the engine that answered: "mesh" or "exec"
    fallback: str = ""  # why mesh handed the plan to exec (its message)
    # the sidecar lane's: chunks consulted, of them folded from summaries
    chunks_touched: int = 0
    sidecar_chunks: int = 0
    # the sidecar lane's bypasses of this query: reason → leaves
    sidecar_bypassed: dict = field(default_factory=dict)
    # the extent result cache's: extents served from it, and evaluated
    cache_hits: int = 0
    cache_misses: int = 0
    # seconds the query waited in the governor's admission queue
    admission_wait_s: float = 0.0
    # a federated query's attribution by retention tier
    # (``query/federation.py::TierExec``): tier → {subqueries, series,
    # samples, chunks, bytes, decodeMs, wallMs}; empty otherwise
    tiers: dict = field(default_factory=dict)
    # the pyramid lane's attribution (``query/engine/pyramid_lane.py``):
    # {bucketNodes, segmentNodes, chunkNodes, decodeNodes, pyramidBytes,
    # payloadBytes} of its cold-tier folds; empty otherwise
    pyramid: dict = field(default_factory=dict)
    # seconds of the exec leaves' scans and the sidecar and pyramid lanes'
    # folds (decode), and of the transformers and aggregations (reduce)
    decode_s: float = 0.0
    reduce_s: float = 0.0
    # the reference's fields the port does not fill yet: carried on the
    # wire (``wire_bytes`` is remote plan dispatch's, ROADMAP A7)
    cpu_prep_s: float = 0.0
    device_time_s: float = 0.0
    wire_bytes: int = 0
    # (field, start, end) CUDA events of stages timed on the card, not yet
    # read (``settle_timings``)
    _timings: list = field(default_factory=list, repr=False, compare=False)

    @contextmanager
    def timed(self, name: str, device):
        """Add the enclosed stage's seconds to ``name`` (``decode_s`` or
        ``reduce_s``) where it completes (a stage that raises, such as a
        lane's bypass, adds nothing, as the reference counts): host clock
        on the CPU, CUDA events on the card."""
        if getattr(device, "type", "cpu") != "cuda":
            t0 = time.perf_counter()
            yield
            setattr(self, name, getattr(self, name) + time.perf_counter() - t0)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._timings.append((name, start, end))

    def settle_timings(self) -> None:
        """Read the stages timed on the card into their fields: called
        after the answer's device→host copy, when the events have passed
        (an answer that never left the card waits on its last event)."""
        for name, start, end in self._timings:
            end.synchronize()
            setattr(self, name,
                    getattr(self, name) + start.elapsed_time(end) / 1000.0)
        self._timings.clear()

    def merge_counts(self, other: "QueryStats") -> None:
        """Fold a sub-query's counts into these (the extent cache folds
        each evaluated extent's); ``wall_time_s`` and ``result_series``
        stay the caller's."""
        for name in ("series_scanned", "samples_scanned", "precise_lane",
                     "host_lane", "chunks_touched", "sidecar_chunks",
                     "cache_hits", "cache_misses", "admission_wait_s",
                     "decode_s", "reduce_s"):
            setattr(self, name, getattr(self, name) + getattr(other, name))
        self._timings.extend(other._timings)
        for reason, n in other.sidecar_bypassed.items():
            self.sidecar_bypassed[reason] = \
                self.sidecar_bypassed.get(reason, 0) + n
        for tier, bucket in other.tiers.items():
            mine = self.tiers.setdefault(tier, {})
            for k, v in bucket.items():
                mine[k] = mine.get(k, 0) + v
        for k, v in other.pyramid.items():
            self.pyramid[k] = self.pyramid.get(k, 0) + v


@dataclass
class TraceContext:
    """A query's trace, set by ``tracing.traced_query`` where the query is
    sampled or joins an active trace."""

    trace_id: str = ""
    parent_span_id: int = 0
    sampled: bool = False


@dataclass
class QueryResult:
    result: StepMatrix
    stats: QueryStats = field(default_factory=QueryStats)
    query_id: str = ""
    # a budget in ``degrade="partial"`` stopped the query: what it has,
    # flagged, with the budget's warning (the Prom JSON renders both)
    partial: bool = False
    warnings: list[str] = field(default_factory=list)


@dataclass
class PlannerParams:
    """The reference's ``PlannerParams``, the fields the port reads (and,
    for the wire, the partial scatter-gather ones it does not yet)."""

    __wire_fields__ = ("spread", "sample_limit", "enforce_sample_limit",
                       "shard_overrides", "process_failure",
                       "allow_partial", "max_partial_fraction", "budget")

    # per-query spread: over the planner's per-shard-key overrides and
    # its default (None: not set)
    spread: "int | None" = None
    # result samples (series × steps) above which a query raises
    # ``QueryLimitExceeded``, where ``enforce_sample_limit``
    sample_limit: int = 1_000_000
    enforce_sample_limit: bool = True
    # shard overrides: neither package's planner reads them; the extent
    # cache bypasses a query that sets them, as the reference's does
    shard_overrides: "list[int] | None" = None
    # the query's scan budget (``utils.governor.QueryBudget``); None: the
    # service attaches the governor's default (none unless configured)
    budget: "object | None" = None
    # partial scatter-gather's (remote plan dispatch, ROADMAP A7): carried
    # on the wire, read by nothing yet
    process_failure: bool = True
    allow_partial: "bool | None" = None
    max_partial_fraction: "float | None" = None


@dataclass
class QueryContext:
    """The reference's ``QueryContext``, the fields the port reads."""

    __wire_fields__ = ("query_id", "submit_time_ms", "origin",
                       "planner_params", "trace")

    query_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    origin: str = ""  # who asked: "" (a user), "rules", ...
    planner_params: PlannerParams = field(default_factory=PlannerParams)
    # set by ``tracing.traced_query`` where the query is traced
    trace: "TraceContext | None" = None
    submit_time_ms: int = field(
        default_factory=lambda: int(time.time() * 1000))


def enforce_limits(data: StepMatrix, qcontext: QueryContext) -> None:
    """Raise ``QueryLimitExceeded`` where ``data`` (materialized) holds
    more samples than the query's ``sample_limit`` (1,000,000 by default,
    as the reference's)."""
    pp = qcontext.planner_params
    limit = pp.sample_limit
    if pp.enforce_sample_limit and data.num_series * data.num_steps > limit:
        raise QueryLimitExceeded(
            f"result samples {data.num_series * data.num_steps} > limit "
            f"{limit}")
