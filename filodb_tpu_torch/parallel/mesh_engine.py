"""The one-GPU query engine: a PromQL range plan lowered onto the kernels.

Port of ``filodb_tpu/parallel/mesh_engine.py`` for the plan family of its
core lowering (``_lower_plan`` / ``_lower_periodic``)::

    agg?( range_fn( selector[w] offset o ) ) by/without (labels)

with ``range_fn`` one of rate, increase, delta, sum_over_time,
count_over_time, avg_over_time and ``agg`` one of sum, avg, min, max,
count or none. Any other plan raises ``UnsupportedQuery`` naming its shape;
nothing answers it some other way.

A query selects partitions shard by shard, packs their page blocks
(``device_batch.pack_blocks``) and uploads the packed pages only. On the
card:

- rate / increase / delta run kernel B3 straight from the packed pages;
- sum / count / avg_over_time decode through B1 and B2 (``assemble``) and
  sum windows with B4, over the values and over the validity mask;
- the group reduce is plain torch (``aggregations.aggregate``).

Precision gate (the reference's ``F32_SAFE_MAX``): float32 keeps window
differences exact only below 2^20, so a rate / increase / delta leaf whose
selected chunks hold a larger |value| runs the plain ``range_eval_masked``
in float64 on the card instead of B3, and ``QueryStats.precise_lane``
counts it.

Uploaded batches are cached per (selector, data range) until the store
ingests again, as the reference's mesh engine caches placed batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.device import EXACT_DTYPE
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.engine.aggregations import AGG_OPS, aggregate
from filodb_tpu_torch.query.engine.cuda_kernels import (
    TS_PAD,
    fused_decode_rate,
    steps_in_flight,
    windowed_sum,
)
from filodb_tpu_torch.query.engine.device_batch import (
    BLOCK,
    assemble,
    pack_blocks,
    to_device,
)
from filodb_tpu_torch.query.engine.kernels import RANGE_FNS, range_eval_masked
from filodb_tpu_torch.query.model import QueryStats, StepMatrix

F32_SAFE_MAX = float(1 << 20)
RATE_FNS = ("rate", "increase", "delta")
# samples decoded at once on the B4 path: bounds the decoded [rows, S]
# temporaries (about 25 bytes a sample) whatever the series' length
_DECODE_SAMPLES = 1 << 27
# uploaded batches kept (each up to ~9 GB at a million series)
_BATCH_CACHE_CAP = 4


def decode_rows(S: int) -> int:
    """Series decoded at once on the B4 path for rows of S samples."""
    return max(1, _DECODE_SAMPLES // max(S, 1))


class UnsupportedQuery(ValueError):
    """A plan shape this slice of the port does not serve."""


@dataclass(frozen=True)
class Lowered:
    filters: tuple
    start: int
    step: int
    end: int
    window: int
    fn: str
    offset: int
    agg: str | None = None
    by: tuple = ()
    without: tuple = ()

    @property
    def chunk_range(self) -> tuple[int, int]:
        return (self.start - self.window - self.offset,
                self.end - self.offset)


def _shape(plan) -> str:
    name = type(plan).__name__
    detail = getattr(plan, "function", None) or getattr(plan, "op", None)
    return f"{name}({detail})" if detail else name


def lower_plan(plan) -> Lowered:
    """Recognize the slice's plan family, or raise ``UnsupportedQuery``."""
    if isinstance(plan, lp.Aggregate):
        if plan.op not in AGG_OPS or plan.params:
            raise UnsupportedQuery(
                f"aggregation {plan.op}"
                f"{'(' + ', '.join(map(str, plan.params)) + ')' if plan.params else ''}"
                f" is not served by this slice (served: {', '.join(AGG_OPS)})")
        inner = _lower_periodic(plan.vector)
        return Lowered(*inner[:7], plan.op, tuple(plan.by),
                       tuple(plan.without))
    return Lowered(*_lower_periodic(plan))


def _lower_periodic(plan) -> tuple:
    if not isinstance(plan, lp.PeriodicSeriesWithWindowing):
        raise UnsupportedQuery(
            f"plan shape {_shape(plan)} is not served by this slice: it "
            f"serves agg(range_fn(selector[w] offset o)) by/without (...) "
            f"with range_fn in {', '.join(RANGE_FNS)}")
    if plan.function not in RANGE_FNS or plan.params:
        raise UnsupportedQuery(
            f"range function {plan.function} is not served by this slice "
            f"(served: {', '.join(RANGE_FNS)})")
    if plan.at_ms is not None:
        raise UnsupportedQuery("the @ modifier is not served by this slice")
    raw = plan.raw
    if not isinstance(raw, lp.RawSeries) or raw.column is not None:
        raise UnsupportedQuery(
            f"range function over {_shape(raw)} is not served by this slice")
    # the parser records the selector offset on both nodes: one value
    return (tuple(raw.filters), plan.start, plan.step, plan.end,
            plan.window, plan.function, plan.offset or raw.offset)


def steps_array(start: int, step: int, end: int) -> np.ndarray:
    """Step timestamps [start, end] inclusive (epoch ms)."""
    if step <= 0:
        return np.array([end], dtype=np.int64)
    return np.arange(start, end + 1, step, dtype=np.int64)


@dataclass
class _Batch:
    version: int
    keys: list            # RangeVectorKey per series (metric kept)
    packed: tuple | None  # device tensors, [P, NB(, 128)]
    counts: np.ndarray    # valid samples a series
    vmax: float           # largest finite |value| in the selected pages
    is_counter: bool
    nbytes: int = 0
    _out_keys: list | None = None

    @property
    def out_keys(self) -> list:
        """Series keys of a range function's output (metric dropped)."""
        if self._out_keys is None:
            self._out_keys = [k.drop_metric() for k in self.keys]
        return self._out_keys


class MeshQueryEngine:
    """Runs lowered plans on one device; caches uploaded batches and group
    ids across queries over unchanged data."""

    def __init__(self, device: torch.device):
        self.device = device
        self._batches: dict[tuple, _Batch] = {}
        self._groups: dict[tuple, tuple] = {}

    # ---- selection and upload ----------------------------------------------

    def _batch(self, memstore, low: Lowered) -> _Batch:
        lo_ms, hi_ms = low.chunk_range
        key = (str(low.filters), lo_ms, hi_ms)
        version = memstore.version
        hit = self._batches.get(key)
        if hit is not None and hit.version == version:
            return hit
        tables, table_of, block_of, row_of = [], [], [], []
        keys, vmax = [], 0.0
        for shard in memstore.shards:
            pids = shard.lookup_partitions(list(low.filters), lo_ms, hi_ms)
            if not len(pids):
                continue
            tabs, t_of, b_of, r_of, vm = shard.select_blocks(pids, lo_ms,
                                                             hi_ms)
            table_of.append(t_of + len(tables))
            tables.extend(tabs)
            block_of.append(b_of)
            row_of.append(r_of + len(keys))
            keys.extend(shard.keys[p] for p in pids)
            vmax = max(vmax, vm)
        if not keys:
            batch = _Batch(version, [], None, np.zeros(0, np.int32), 0.0,
                           False)
        else:
            packed, counts = pack_blocks(
                tables, np.concatenate(table_of), np.concatenate(block_of),
                np.concatenate(row_of), len(keys), lo_ms)
            dev = to_device(packed, self.device)
            batch = _Batch(version, [k.range_vector_key for k in keys], dev,
                           counts[: len(keys)], vmax,
                           SCHEMAS[keys[0].schema].is_counter,
                           sum(a.numel() * 4 for a in dev))
        if len(self._batches) >= _BATCH_CACHE_CAP:
            self._batches.pop(next(iter(self._batches)))
        self._batches[key] = batch
        return batch

    # ---- evaluation --------------------------------------------------------

    def _eval(self, batch: _Batch, low: Lowered, steps: torch.Tensor,
              flight: int, stats: QueryStats) -> torch.Tensor:
        """Per-series results [n_series, K] on the device; ``flight`` is
        ``steps_in_flight`` of the steps, taken on the host."""
        n = len(batch.keys)
        packed = batch.packed
        lo_ms, hi_ms = low.chunk_range
        if low.fn in RATE_FNS:
            counter = low.fn != "delta" or batch.is_counter
            if batch.vmax < F32_SAFE_MAX:
                out = fused_decode_rate(packed, steps, low.window, low.fn,
                                        counter, in_flight=flight)
                return out[:n]
            stats.precise_lane += 1
            ts, vals, valid = assemble(packed, hi_ms - lo_ms)
            return range_eval_masked(low.fn, ts, vals, valid, steps,
                                     low.window, counter=counter,
                                     dtype=EXACT_DTYPE)[:n]
        outs = []
        rows = decode_rows(packed[0].shape[1] * BLOCK)
        for a in range(0, n, rows):
            b = min(a + rows, n)
            part = tuple(t[a:b] for t in packed)
            ts, vals, valid = assemble(part, hi_ms - lo_ms)
            ts = torch.where(valid, ts, TS_PAD).contiguous()
            cnt = windowed_sum(ts, valid.to(torch.float32), steps,
                               low.window, flight)
            nan = torch.tensor(float("nan"), device=cnt.device)
            if low.fn == "count_over_time":
                outs.append(torch.where(cnt > 0, cnt, nan))
                continue
            s = windowed_sum(ts, torch.where(valid, vals, 0.0).contiguous(),
                             steps, low.window, flight)
            if low.fn == "avg_over_time":
                s = s / cnt.clamp(min=1.0)
            outs.append(torch.where(cnt > 0, s, nan))
        return torch.cat(outs)

    @property
    def batch_bytes(self) -> int:
        """Device bytes of the packed pages the engine holds."""
        return sum(b.nbytes for b in self._batches.values())

    def _group_ids(self, batch: _Batch, low: Lowered):
        key = (id(batch), batch.version, low.by, low.without)
        hit = self._groups.get(key)
        if hit is not None and hit[0] is batch:
            return hit[1], hit[2]
        # first-occurrence order, metric label dropped first
        uniq: dict = {}
        gids = np.empty(len(batch.keys), np.int64)
        for i, k in enumerate(batch.keys):
            base = k.drop_metric()
            gk = base.without(low.without) if low.without \
                else base.only(low.by)
            gids[i] = uniq.setdefault(gk, len(uniq))
        out = (batch, torch.from_numpy(gids).to(self.device), list(uniq))
        if len(self._groups) >= 16:
            self._groups.pop(next(iter(self._groups)))
        self._groups[key] = out
        return out[1], out[2]

    def execute(self, memstore, plan, stats: QueryStats) -> StepMatrix:
        low = lower_plan(plan)
        steps_ms = steps_array(low.start, low.step, low.end)
        batch = self._batch(memstore, low)
        if not batch.keys:
            return StepMatrix.empty(steps_ms)
        stats.series_scanned += len(batch.keys)
        stats.samples_scanned += int(batch.counts.sum())
        rel = (steps_ms - low.offset - low.chunk_range[0])
        if rel.size and (rel.min() < -2**31 or rel.max() >= 2**31 - 1):
            raise UnsupportedQuery("query range too long for int32 ms steps")
        host_steps = torch.from_numpy(rel.astype(np.int32))
        flight = steps_in_flight(host_steps, low.window)
        res = self._eval(batch, low, host_steps.to(self.device), flight,
                         stats)
        if low.agg is None:
            return StepMatrix(list(batch.out_keys), res, steps_ms)
        gids, gkeys = self._group_ids(batch, low)
        out = aggregate(low.agg, res, gids, len(gkeys))
        return StepMatrix(gkeys, out, steps_ms, pending_compact=True)

