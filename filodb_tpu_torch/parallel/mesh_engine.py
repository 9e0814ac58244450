"""The one-GPU query engine: PromQL plans over scalar series on the card.

Port of ``filodb_tpu/parallel/mesh_engine.py`` and, for the plans that
engine hands to the exec engine, of the exec engine's transformers. A leaf
is lowered (``lower_plan``) from

    range_fn(selector[w] offset o)   every range function of
                                     ``query/engine/kernels.py`` plus
                                     quantile_over_time and holt_winters
    selector offset o                the instant selector: the last sample
                                     within the staleness lookback

(either at the query's steps, or once at an ``@`` time and repeated
across them) and ``execute`` walks everything above the leaves:
aggregations (sum, avg, min, max, count, group, stddev, stdvar, topk,
bottomk, quantile, count_values), instant functions, absent, sort,
label_replace / label_join, limit, operators with a number or a per-step
scalar, binary joins and set operators of two vectors, scalar plans
(numbers, ``time()``, ``scalar(v)``, scalar arithmetic, ``vector(s)``)
and subqueries, whose range function runs over the inner matrix's steps
as samples. Any other plan raises ``UnsupportedQuery`` naming its shape;
nothing answers it some other way.

A query selects partitions shard by shard, packs their page blocks
(``device_batch.pack_blocks``) and uploads the packed pages only. On the
card:

- rate / increase / delta run kernel B3 straight from the packed pages;
- every other range function and the instant selector decode through B1
  and B2 (``assemble``) in chunks of rows; sum / count / avg /
  present_over_time sum windows with B4 over the values and the validity
  mask, the rest run the plain ``range_eval_masked`` family in float64;
- aggregations, instant functions and operators are plain torch on the
  card (``query/exec``); joins match labels on the host.

Histograms: a selector that matches ``prom-histogram`` series packs their
timestamp blocks and one int block a bucket (``pack_hist_blocks``), B at
the batch's widest scheme. Every range function of ``HIST_FNS`` and the
instant selector decode a chunk of series through B1 (timestamps once, then
every bucket block in one launch) and run ``range_eval_masked`` in float64
on the [series, B, S] bucket rows, each bucket its own counter, as the
reference's exec engine does over ``_assemble_hist``. Above the leaf a
histogram matrix is [P, K, B]: sum … stdvar aggregate per bucket,
``histogram_quantile`` / ``histogram_max_quantile`` interpolate on the
card, instant functions and operators with a number are element-wise.
``histogram_quantile`` over ``le``-labelled scalar series (the classic
Prometheus form) groups the bucket series on the host and interpolates on
the card. Other histogram shapes raise ``UnsupportedQuery``.

Precision gate (the reference's ``F32_SAFE_MAX``): float32 keeps window
differences exact only below 2^20, so a rate / increase / delta leaf whose
selected chunks hold a larger |value| runs the plain ``range_eval_masked``
in float64 on the card instead of B3, and ``QueryStats.precise_lane``
counts it.

Uploaded batches are cached per (selector, data range) until the store
ingests again, as the reference's mesh engine caches placed batches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.device import EXACT_DTYPE
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.engine.aggregations import AGG_OPS
from filodb_tpu_torch.query.engine.cuda_kernels import (
    TS_PAD,
    fused_decode_rate,
    steps_in_flight,
    windowed_sum,
)
from filodb_tpu_torch.query.engine.device_batch import (
    BLOCK,
    assemble,
    assemble_hist,
    pack_blocks,
    pack_hist_blocks,
    to_device,
)
from filodb_tpu_torch.query.engine.instantfns import INSTANT_FNS
from filodb_tpu_torch.query.engine.kernels import (
    RANGE_FNS,
    RATE_FNS,
    holt_winters_masked,
    quantile_over_time_masked,
    range_eval_masked,
)
from filodb_tpu_torch.query.exec.binaryjoin import (
    SET_OPS,
    binary_join,
    set_operator,
)
from filodb_tpu_torch.query.engine.instantfns import apply_binary_op
from filodb_tpu_torch.query.exec.transformers import (
    AbsentFunctionMapper,
    AggregateMapReduce,
    InstantVectorFunctionMapper,
    LimitFunctionMapper,
    MiscellaneousFunctionMapper,
    ScalarOperationMapper,
    SortFunctionMapper,
    steps_array,
    tensor_of,
)
from filodb_tpu_torch.query.model import (
    QueryStats,
    RangeVectorKey,
    StepMatrix,
)

F32_SAFE_MAX = float(1 << 20)
# range functions whose windows B4 sums (values and validity)
WINDOW_SUM_FNS = ("sum_over_time", "count_over_time", "avg_over_time",
                  "present_over_time")
# every range function a leaf serves, with its number of parameters
SERVED_FNS = {**{f: 0 for f in RANGE_FNS}, "predict_linear": 1,
              "quantile_over_time": 1, "holt_winters": 2}
# range functions a histogram leaf serves: the reference's per-bucket
# ``range_eval_masked`` answers these; it also answers timestamp (in
# seconds from the batch start, not epoch seconds) and predict_linear
# (with its horizon dropped), which the port leaves out (ROADMAP §A)
HIST_FNS = tuple(f for f in RANGE_FNS
                 if f not in ("timestamp", "predict_linear"))
HIST_INSTANT_FNS = ("histogram_quantile", "histogram_max_quantile",
                    "hist_to_prom_vectors")
STALENESS_MS = 300_000  # the instant selector's default lookback
_RANK_AGGS = ("topk", "bottomk", "quantile")  # one scalar parameter
_SCALAR_PLANS = (lp.ScalarFixedDoublePlan, lp.ScalarTimeBasedPlan,
                 lp.ScalarVaryingDoublePlan, lp.ScalarBinaryOperation)
# working set of a decode chunk: the decoded rows plus the temporaries of
# the function evaluated on them stay near this whatever the row length
_DECODE_BYTES = 25 << 27
_QUANTILE_BLOCK = 16  # steps a quantile_over_time sort takes at once
# uploaded batches kept (each up to ~9 GB at a million series)
_BATCH_CACHE_CAP = 4


def decode_rows(S: int, fn: str = "count_over_time") -> int:
    """Series decoded at once for rows of S samples, from the bytes a
    sample of ``fn``'s working set takes: about 25 on the B4 path, about 96
    for the float64 temporaries of ``range_eval_masked``, plus 4 a level of
    min/max's float32 sparse table and 21 a step of quantile_over_time's
    block sort (float32 keys, int64 indices, mask)."""
    if fn in WINDOW_SUM_FNS:
        per = 25
    elif fn in ("min_over_time", "max_over_time"):
        per = 96 + 4 * max(S.bit_length(), 1)
    elif fn == "quantile_over_time":
        per = 96 + 21 * _QUANTILE_BLOCK
    else:
        per = 96
    return max(1, _DECODE_BYTES // (per * max(S, 1)))


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
    params: tuple = ()
    keep_metric: bool = False  # the instant selector keeps the metric
    at_ms: int | None = None   # @: every step evaluates at this time

    @property
    def chunk_range(self) -> tuple[int, int]:
        lo, hi = (self.start, self.end) if self.at_ms is None \
            else (self.at_ms, self.at_ms)
        return lo - self.window - self.offset, hi - self.offset


def _shape(plan) -> str:
    name = type(plan).__name__
    detail = getattr(plan, "function", None) or getattr(plan, "op", None)
    return f"{name}({detail})" if detail else name


def _is_number(x) -> bool:
    return isinstance(x, (int, float))


def _raw_selector(plan) -> lp.RawSeries:
    raw = plan.raw
    if not isinstance(raw, lp.RawSeries) or raw.column is not None:
        raise UnsupportedQuery(
            f"{_shape(plan)} over {_shape(raw)} is not served by this slice")
    return raw


def lower_plan(plan) -> Lowered:
    """Lower a leaf (a range function or an instant selector over a raw
    selector), or raise ``UnsupportedQuery``; ``execute`` evaluates what
    stands above the leaves."""
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        if SERVED_FNS.get(plan.function) != len(plan.params) \
                or not all(_is_number(p) for p in plan.params):
            raise UnsupportedQuery(
                f"range function {plan.function}"
                f"{tuple(plan.params) if plan.params else ''} is not "
                f"served by this slice (served: {', '.join(SERVED_FNS)})")
        raw = _raw_selector(plan)
        # the parser records the selector offset on both nodes: one value
        return Lowered(tuple(raw.filters), plan.start, plan.step, plan.end,
                       plan.window, plan.function, plan.offset or raw.offset,
                       tuple(float(p) for p in plan.params),
                       at_ms=plan.at_ms)
    if isinstance(plan, lp.PeriodicSeries):
        raw = _raw_selector(plan)
        return Lowered(tuple(raw.filters), plan.start, plan.step, plan.end,
                       raw.lookback or STALENESS_MS, "last_sample",
                       plan.offset or raw.offset, keep_metric=True,
                       at_ms=plan.at_ms)
    raise UnsupportedQuery(
        f"plan shape {_shape(plan)} is not served by this slice: it serves "
        f"range functions and instant selectors, the plans above them and "
        f"scalar plans")


def retime(plan, start: int, step: int, end: int):
    """``plan`` evaluated over [start, end] at ``step`` (the reference
    planner's ``_retime``, for subqueries)."""
    if isinstance(plan, (lp.PeriodicSeries, lp.PeriodicSeriesWithWindowing)):
        raw = dataclasses.replace(plan.raw, range_start=start, range_end=end)
        return dataclasses.replace(plan, raw=raw, start=start, step=step,
                                   end=end)
    if isinstance(plan, (lp.SubqueryWithWindowing, lp.ScalarFixedDoublePlan,
                         lp.ScalarTimeBasedPlan, lp.ScalarBinaryOperation)):
        return dataclasses.replace(plan, start=start, step=step, end=end)
    if dataclasses.is_dataclass(plan):
        changes = {f.name: retime(getattr(plan, f.name), start, step, end)
                   for f in dataclasses.fields(plan)
                   if isinstance(getattr(plan, f.name), lp.LogicalPlan)}
        if changes:
            return dataclasses.replace(plan, **changes)
    return plan


def _matrix_fn(fn: str, params: tuple, ts, vals, valid, steps,
               window: int) -> torch.Tensor:
    """A range function over an evaluated matrix's rows (a subquery's
    inner steps as samples), in float64 on the device."""
    if fn == "quantile_over_time":
        return quantile_over_time_masked(params[0], ts, vals, valid, steps,
                                         window, _QUANTILE_BLOCK,
                                         dtype=EXACT_DTYPE)
    if fn == "holt_winters":
        return holt_winters_masked(*params, ts, vals, valid, steps, window,
                                   dtype=EXACT_DTYPE)
    return range_eval_masked(fn, ts, vals, valid, steps, window,
                             extra=params[0] if params else 0.0,
                             dtype=EXACT_DTYPE)


def _int32_steps(rel: np.ndarray) -> torch.Tensor:
    if rel.size and (rel.min() < -2**31 or rel.max() >= 2**31 - 1):
        raise UnsupportedQuery("query range too long for int32 ms steps")
    return torch.from_numpy(rel.astype(np.int32))


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
    les: np.ndarray | None = None  # bucket bounds of a histogram batch

    @property
    def out_keys(self) -> list:
        """Series keys of a range function's output (metric dropped)."""
        if self._out_keys is None:
            self._out_keys = [k.drop_metric() for k in self.keys]
        return self._out_keys


def _decoded_fn(low: Lowered, ts, vals, valid, steps: torch.Tensor,
                flight: int) -> torch.Tensor:
    """A non-rate range function on one decoded chunk, [rows, K]."""
    if low.fn in WINDOW_SUM_FNS:
        ts = torch.where(valid, ts, TS_PAD).contiguous()
        cnt = windowed_sum(ts, valid.to(torch.float32), steps, low.window,
                           flight)
        nan = torch.tensor(float("nan"), device=cnt.device)
        if low.fn == "count_over_time":
            return torch.where(cnt > 0, cnt, nan)
        if low.fn == "present_over_time":
            return torch.where(cnt > 0, 1.0, nan)
        s = windowed_sum(ts, torch.where(valid, vals, 0.0).contiguous(),
                         steps, low.window, flight)
        if low.fn == "avg_over_time":
            s = s / cnt.clamp(min=1.0)
        return torch.where(cnt > 0, s, nan)
    if low.fn == "quantile_over_time":
        return quantile_over_time_masked(low.params[0], ts, vals, valid,
                                         steps, low.window, _QUANTILE_BLOCK,
                                         dtype=EXACT_DTYPE)
    if low.fn == "holt_winters":
        return holt_winters_masked(*low.params, ts, vals, valid, steps,
                                   low.window, dtype=EXACT_DTYPE)
    return range_eval_masked(low.fn, ts, vals, valid, steps, low.window,
                             extra=low.params[0] if low.params else 0.0,
                             dtype=EXACT_DTYPE)


class MeshQueryEngine:
    """Runs plans on one device; caches uploaded batches and group ids
    across queries over unchanged data."""

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
        selected = [(shard, shard.lookup_partitions(list(low.filters), lo_ms,
                                                   hi_ms))
                    for shard in memstore.shards]
        selected = [(sh, pids) for sh, pids in selected if len(pids)]
        kind = np.concatenate([sh.hist[pids] for sh, pids in selected]) \
            if selected else np.zeros(0, bool)
        hist = bool(kind.all()) and len(kind) > 0
        if kind.any() and not hist:
            raise UnsupportedQuery(
                f"selector {low.filters} matches both histogram and scalar "
                f"series, which this slice does not serve in one leaf")
        tables, table_of, block_of, row_of = [], [], [], []
        keys, vmax, les = [], 0.0, None
        for shard, pids in selected:
            if hist:
                tabs, t_of, b_of, r_of, sl = shard.select_hist_blocks(
                    pids, lo_ms, hi_ms)
                # the first scheme of the most buckets, in batch order
                if sl is not None and (les is None or len(sl) > len(les)):
                    les = sl
            else:
                tabs, t_of, b_of, r_of, vm = shard.select_blocks(pids, lo_ms,
                                                                 hi_ms)
                vmax = max(vmax, vm)
            table_of.append(t_of + len(tables))
            tables.extend(tabs)
            block_of.append(b_of)
            row_of.append(r_of + len(keys))
            keys.extend(shard.keys[p] for p in pids)
        if not keys:
            batch = _Batch(version, [], None, np.zeros(0, np.int32), 0.0,
                           False)
        else:
            entries = (tables, np.concatenate(table_of),
                       np.concatenate(block_of), np.concatenate(row_of),
                       len(keys), lo_ms)
            if hist:
                les = les if les is not None else np.array([np.inf])
                packed, counts = pack_hist_blocks(*entries, len(les))
            else:
                packed, counts = pack_blocks(*entries)
            dev = to_device(packed, self.device)
            batch = _Batch(version, [k.range_vector_key for k in keys], dev,
                           counts[: len(keys)], vmax,
                           SCHEMAS[keys[0].schema].is_counter,
                           sum(a.numel() * a.element_size() for a in dev),
                           les=les)
        if len(self._batches) >= _BATCH_CACHE_CAP:
            self._batches.pop(next(iter(self._batches)))
        self._batches[key] = batch
        return batch

    # ---- leaves ------------------------------------------------------------

    def _eval(self, batch: _Batch, low: Lowered, steps: torch.Tensor,
              flight: int, stats: QueryStats) -> torch.Tensor:
        """Per-series results [n_series, K] on the device; ``flight`` is
        ``steps_in_flight`` of the steps, taken on the host."""
        if batch.les is not None:
            return self._eval_hist(batch, low, steps)
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
        rows = decode_rows(packed[0].shape[1] * BLOCK, low.fn)
        for a in range(0, n, rows):
            part = tuple(t[a : min(a + rows, n)] for t in packed)
            ts, vals, valid = assemble(part, hi_ms - lo_ms)
            outs.append(_decoded_fn(low, ts, vals, valid, steps, flight))
        out = torch.cat(outs)
        if low.fn == "timestamp":
            # seconds relative to the batch base → epoch seconds, in float64
            out = out + lo_ms / 1000.0
        return out

    def _eval_hist(self, batch: _Batch, low: Lowered,
                   steps: torch.Tensor) -> torch.Tensor:
        """A histogram leaf, [n_series, K, B]: chunks of series decoded
        (B1 on timestamps, then on every bucket block) and evaluated in
        float64 per bucket row; ``decode_rows`` counts series × B rows."""
        n = len(batch.keys)
        lo_ms, hi_ms = low.chunk_range
        B = len(batch.les)
        rows = max(1, decode_rows(batch.packed[0].shape[1] * BLOCK, low.fn)
                   // B)
        outs = []
        for a in range(0, n, rows):
            part = tuple(t[a : min(a + rows, n)] for t in batch.packed)
            ts, counts, valid = assemble_hist(part, hi_ms - lo_ms)
            outs.append(range_eval_masked(low.fn, ts, counts, valid, steps,
                                          low.window,
                                          counter=batch.is_counter,
                                          dtype=EXACT_DTYPE))
        return torch.cat(outs).transpose(1, 2)

    @property
    def batch_bytes(self) -> int:
        """Device bytes of the packed pages the engine holds."""
        return sum(b.nbytes for b in self._batches.values())

    def _leaf(self, memstore, low: Lowered, stats: QueryStats) -> StepMatrix:
        """A leaf at its steps; under ``@`` it is evaluated once, at the
        ``@`` time, and the column repeats across the steps (each of the
        reference's steps computes the same)."""
        steps_ms = steps_array(low.start, low.step, low.end)
        batch = self._batch(memstore, low)
        if not batch.keys:
            return StepMatrix.empty(steps_ms)
        if batch.les is not None and low.fn not in HIST_FNS:
            raise UnsupportedQuery(
                f"range function {low.fn} over a histogram is not served by "
                f"this slice (served: {', '.join(HIST_FNS)})")
        stats.series_scanned += len(batch.keys)
        stats.samples_scanned += int(batch.counts.sum())
        eval_ms = steps_ms if low.at_ms is None \
            else np.array([low.at_ms], np.int64)
        host_steps = _int32_steps(eval_ms - low.offset - low.chunk_range[0])
        flight = steps_in_flight(host_steps, low.window)
        res = self._eval(batch, low, host_steps.to(self.device), flight,
                         stats)
        if low.at_ms is not None:
            res = res.expand(res.shape[0], len(steps_ms), *res.shape[2:])
        return StepMatrix(batch.keys if low.keep_metric else batch.out_keys,
                          res, steps_ms, dropped_keys=batch.out_keys,
                          les=batch.les)

    # ---- the plan above the leaves ------------------------------------------

    def _group_ids(self, keys: list, amr: AggregateMapReduce):
        """``amr.group_ids(keys)`` with the ids on the device, cached per
        keys list: a cached batch hands out the same list every query, and
        instant functions and operators above it hand on its metric-free
        list (``StepMatrix.derive_without_metric``)."""
        key = (id(keys), amr.by, amr.without)
        hit = self._groups.get(key)
        if hit is not None and hit[0] is keys:
            return hit[1]
        gids, gkeys = amr.group_ids(keys)
        out = (torch.from_numpy(gids).to(self.device), gkeys)
        if len(self._groups) >= 16:
            self._groups.pop(next(iter(self._groups)))
        self._groups[key] = (keys, out)
        return out

    def _aggregation(self, plan: lp.Aggregate) -> AggregateMapReduce:
        params = tuple(plan.params)
        if not (plan.op in AGG_OPS and not params
                or plan.op in _RANK_AGGS and len(params) == 1
                and _is_number(params[0])
                or plan.op == "count_values" and len(params) == 1
                and isinstance(params[0], str)):
            raise UnsupportedQuery(
                f"aggregation {plan.op}"
                f"{'(' + ', '.join(map(str, params)) + ')' if params else ''}"
                f" is not served by this slice (served: "
                f"{', '.join(AGG_OPS + _RANK_AGGS)}, the last three with a "
                f"number, and count_values with a label)")
        return AggregateMapReduce(plan.op, params, tuple(plan.by),
                                  tuple(plan.without))

    # ---- scalars and subqueries ----------------------------------------------

    def _scalar(self, memstore, plan, stats: QueryStats):
        """A scalar plan → (values float64 [K] on the device, steps_ms),
        as the reference's scalar execs compute them."""
        if isinstance(plan, lp.ScalarVaryingDoublePlan):
            data = self.execute(memstore, plan.vector, stats).settle()
            if data.is_histogram:
                raise UnsupportedQuery("scalar() of a histogram is not "
                                       "served by this slice")
            if data.num_series == 0:
                return torch.full((data.num_steps,), float("nan"),
                                  dtype=EXACT_DTYPE, device=self.device), \
                    data.steps_ms
            v = tensor_of(data, self.device)
            present = ~torch.isnan(v)
            one = torch.where(present, v, 0.0).sum(0)
            return torch.where(present.sum(0) == 1, one, float("nan")), \
                data.steps_ms
        steps = steps_array(plan.start, plan.step or 1000, plan.end)
        if isinstance(plan, lp.ScalarFixedDoublePlan):
            return torch.full((len(steps),), float(plan.value),
                              dtype=EXACT_DTYPE, device=self.device), steps
        if isinstance(plan, lp.ScalarTimeBasedPlan):
            if plan.function != "time":
                raise ValueError(f"unknown scalar generator {plan.function}")
            return torch.from_numpy(steps / 1000.0).to(self.device), steps

        def side(x):
            if _is_number(x):
                return torch.full((len(steps),), float(x), dtype=EXACT_DTYPE,
                                  device=self.device)
            return self._scalar(memstore, x, stats)[0]

        return apply_binary_op(plan.op, side(plan.lhs), side(plan.rhs)), steps

    def _subquery(self, memstore, plan: lp.SubqueryWithWindowing,
                  stats: QueryStats) -> StepMatrix:
        """A range function over a subquery: the inner plan at the
        sub-step over the window before the first step (its start aligned
        down to a multiple of the sub-step, as the reference planner
        aligns it), then the function over the inner steps as samples,
        NaN entries dropped, on the device."""
        if SERVED_FNS.get(plan.function) != len(plan.params):
            raise UnsupportedQuery(
                f"range function {plan.function} over a subquery is not "
                f"served by this slice")
        sub_step = plan.subquery_step or 60_000
        inner_start = plan.start - plan.subquery_window - plan.offset
        inner_start = (inner_start // sub_step) * sub_step
        inner = self.execute(memstore, retime(
            plan.inner, inner_start, sub_step, plan.end - plan.offset),
            stats).settle()
        steps_ms = steps_array(plan.start, plan.step, plan.end)
        if inner.num_series == 0:
            return StepMatrix.empty(steps_ms)
        if inner.is_histogram:
            raise UnsupportedQuery("a subquery over a histogram is not "
                                   "served by this slice")
        vals = tensor_of(inner, self.device)
        base = int(inner.steps_ms[0])
        ts = _int32_steps(inner.steps_ms - base).to(self.device)
        ts = ts[None, :].expand(vals.shape[0], -1).contiguous()
        steps = _int32_steps(steps_ms - plan.offset - base).to(self.device)
        out = _matrix_fn(plan.function, tuple(plan.params), ts, vals,
                         ~torch.isnan(vals), steps, plan.subquery_window)
        if plan.function == "timestamp":
            out = out + base / 1000.0
        return StepMatrix([k.drop_metric() for k in inner.keys], out,
                          steps_ms)

    @staticmethod
    def _scalar_matrix(values: torch.Tensor, steps_ms) -> StepMatrix:
        """A scalar as the one-series, label-free matrix the reference's
        scalar execs answer."""
        return StepMatrix([RangeVectorKey(())], values[None, :], steps_ms)

    def _vector(self, memstore, plan, stats: QueryStats,
                what: str) -> StepMatrix:
        """``plan``'s matrix, which must not be a histogram for ``what``."""
        data = self.execute(memstore, plan, stats)
        if data.is_histogram:
            raise UnsupportedQuery(f"{what} over a histogram is not served "
                                   f"by this slice")
        return data

    def execute(self, memstore, plan, stats: QueryStats) -> StepMatrix:
        """Evaluate ``plan``: the one place that walks a plan tree."""
        if isinstance(plan, lp.Aggregate):
            amr = self._aggregation(plan)
            data = self.execute(memstore, plan.vector, stats).settle()
            if data.is_histogram and amr.op not in AGG_OPS:
                raise UnsupportedQuery(
                    f"aggregation {amr.op} over a histogram is not served by "
                    f"this slice (served per bucket: {', '.join(AGG_OPS)})")
            return amr.apply(data, self._group_ids(data.keys, amr))
        if isinstance(plan, lp.ApplyInstantFunction):
            if plan.function not in INSTANT_FNS + HIST_INSTANT_FNS \
                    or not all(_is_number(a) for a in plan.args):
                raise UnsupportedQuery(
                    f"instant function {plan.function} is not served by "
                    f"this slice (served: "
                    f"{', '.join(INSTANT_FNS + HIST_INSTANT_FNS)}, with "
                    f"number arguments)")
            return InstantVectorFunctionMapper(plan.function, tuple(
                plan.args)).apply(self.execute(memstore, plan.vector, stats))
        if isinstance(plan, lp.ScalarVectorBinaryOperation):
            if isinstance(plan.scalar, lp.ScalarFixedDoublePlan) \
                    or _is_number(plan.scalar):
                sc = float(getattr(plan.scalar, "value", plan.scalar))
                data = self.execute(memstore, plan.vector, stats)
            else:
                data = self._vector(memstore, plan.vector, stats,
                                    f"operator {plan.op} with a "
                                    f"{_shape(plan.scalar)} scalar")
                sc = self._scalar(memstore, plan.scalar, stats)[0]
            return ScalarOperationMapper(
                plan.op, sc, plan.scalar_is_lhs, plan.bool_mode).apply(data)
        if isinstance(plan, _SCALAR_PLANS):
            return self._scalar_matrix(*self._scalar(memstore, plan, stats))
        if isinstance(plan, lp.VectorPlan):
            return self._scalar_matrix(*self._scalar(memstore, plan.scalar,
                                                     stats))
        if isinstance(plan, lp.ApplyAbsentFunction):
            return AbsentFunctionMapper(
                plan.filters, plan.start, plan.step or 1000, plan.end,
                self.device).apply(self._vector(memstore, plan.vector, stats,
                                                "absent"))
        if isinstance(plan, lp.ApplySortFunction):
            return SortFunctionMapper(plan.descending).apply(
                self._vector(memstore, plan.vector, stats, "sort"))
        if isinstance(plan, lp.ApplyMiscellaneousFunction):
            return MiscellaneousFunctionMapper(plan.function, tuple(
                plan.args)).apply(self.execute(memstore, plan.vector, stats))
        if isinstance(plan, lp.ApplyLimitFunction):
            return LimitFunctionMapper(plan.limit).apply(
                self.execute(memstore, plan.vector, stats))
        if isinstance(plan, lp.SubqueryWithWindowing):
            return self._subquery(memstore, plan, stats)
        if isinstance(plan, lp.TopLevelSubquery):
            return self.execute(memstore, retime(plan.inner, plan.start,
                                                 plan.step, plan.end), stats)
        if isinstance(plan, lp.BinaryJoin):
            lhs = self.execute(memstore, plan.lhs, stats)
            rhs = self.execute(memstore, plan.rhs, stats)
            if lhs.is_histogram or rhs.is_histogram:
                raise UnsupportedQuery(
                    f"operator {plan.op} with a histogram side is not served "
                    f"by this slice")
            if plan.op in SET_OPS:
                return set_operator(lhs, rhs, plan.op, plan.on,
                                    plan.ignoring)
            return binary_join(lhs, rhs, plan.op, plan.cardinality, plan.on,
                               plan.ignoring, plan.include, plan.bool_mode)
        return self._leaf(memstore, lower_plan(plan), stats)
