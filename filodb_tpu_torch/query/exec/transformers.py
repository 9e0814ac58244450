"""Per-plan stages over series batches and ``StepMatrix`` batches.

Trimmed port of ``filodb_tpu/query/exec/transformers.py``. Every stage is
a ``RangeVectorTransformer`` with the reference's ``apply(StepMatrix)``:

- ``PeriodicSamplesMapper``, the leaf's windowing stage: ``eval_batch``
  evaluates a range function (or the instant selector's last sample)
  over a ``DeviceBatch`` at every step on the card; ``apply`` evaluates it
  over an evaluated matrix, a subquery's steps as samples. Both engines
  evaluate their leaves through it, so both launch the same kernels
  through the same code:

  - rate / increase / delta run kernel B3 straight from the packed pages,
    unless the precision gate (``F32_SAFE_MAX``, the reference's) sends the
    batch through the plain float64 ``range_eval_masked`` (its values are
    exact in float32, so that is the reference's float64 answer);
  - every other range function and the instant selector decode through B1
    and B2 (``assemble``) in chunks of ``decode_rows``; sum / count / avg /
    present_over_time sum windows with B4, the rest run the float64
    ``range_eval_masked`` family;
  - a batch whose values float32 does not hold exactly is the host-decode
    lane's ``SeriesBatch`` (the lane gate of
    ``device_batch.build_device_batch``): float64 values decoded from the
    codec chunks, evaluated as the reference's default lane evaluates them
    (``range_eval`` in float64 on the device; the delta family over
    ``delta_arrays``: rate, increase and irate reset-corrected, delta on
    counters, idelta and deriv rebased only);
  - a histogram batch decodes through B1 (``assemble_hist``) and runs
    ``range_eval_masked`` per bucket. As the reference's exec engine
    computes them, ``timestamp(h)`` is in seconds from the batch start (the
    histogram branch returns before the epoch rebase) and
    ``predict_linear(h[w], t)`` drops its horizon;

- ``AggregateMapReduce`` (every aggregation of ``aggregations.py``: sum …
  stdvar, topk / bottomk, quantile, count_values; sum … stdvar also per
  bucket over a histogram matrix), with its group ids cached per keys list
  (``GroupIdCache``, one a service);
- ``InstantVectorFunctionMapper`` (with ``histogram_quantile`` /
  ``histogram_max_quantile`` over a histogram matrix or ``le``-labelled
  bucket series, and ``hist_to_prom_vectors``), ``ScalarOperationMapper``
  (a number, or a per-step scalar), ``MiscellaneousFunctionMapper``
  (label_replace, label_join), ``SortFunctionMapper``,
  ``AbsentFunctionMapper`` and ``LimitFunctionMapper``.

Values stay torch tensors on the device that holds them; keys are handled
on the host. Output keys drop the metric label exactly where the
reference's do.

A histogram matrix's values are [P, K, B]. Aggregations flatten the buckets
into the group axis, group id g·B + b, as the reference's mesh engine does,
so each bucket reduces as a series of its own; instant functions and
operators are element-wise and keep ``les``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np
import torch

from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.device import EXACT_DTYPE
from filodb_tpu_torch.core.filters import Equals
from filodb_tpu_torch.query.engine.aggregations import (
    AGG_OPS,
    aggregate,
    count_values,
    histogram_quantile,
    quantile_across,
    topk_mask,
)
from filodb_tpu_torch.query.engine.batch import SeriesBatch
from filodb_tpu_torch.query.engine.cuda_kernels import (
    TS_PAD,
    fused_decode_rate,
    steps_in_flight,
    windowed_sum,
)
from filodb_tpu_torch.query.engine.device_batch import (
    BLOCK,
    DeviceBatch,
    assemble,
    assemble_hist,
)
from filodb_tpu_torch.query.engine.instantfns import (
    COMPARISON_OPS,
    apply_binary_op,
    apply_instant_fn,
)
from filodb_tpu_torch.query.engine.kernels import (
    RANGE_FNS,
    RATE_FNS,
    counts_valid,
    holt_winters_masked,
    quantile_over_time_masked,
    range_eval,
    range_eval_masked,
)
from filodb_tpu_torch.query.model import (
    QueryStats,
    RangeVectorKey,
    StepMatrix,
    UnsupportedQuery,
)

F32_SAFE_MAX = float(1 << 20)
STALENESS_MS = 300_000  # the instant selector's lookback
# range functions whose windows B4 sums (values and validity)
WINDOW_SUM_FNS = ("sum_over_time", "count_over_time", "avg_over_time",
                  "present_over_time")
# every range function a leaf serves, with its number of parameters
SERVED_FNS = {**{f: 0 for f in RANGE_FNS}, "predict_linear": 1,
              "quantile_over_time": 1, "holt_winters": 2}
# working set of a decode chunk: the decoded rows plus the temporaries of
# the function evaluated on them stay near this whatever the row length
_DECODE_BYTES = 25 << 27
_QUANTILE_BLOCK = 16  # steps a quantile_over_time sort takes at once
# the host-decode lane evaluates these over ``SeriesBatch.delta_arrays``
DELTA_FNS = ("rate", "increase", "delta", "irate", "idelta", "deriv")


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


def steps_array(start: int, step: int, end: int) -> np.ndarray:
    """Step timestamps [start, end] inclusive (epoch ms)."""
    if step <= 0:
        return np.array([end], dtype=np.int64)
    return np.arange(start, end + 1, step, dtype=np.int64)


def int32_steps(rel: np.ndarray) -> torch.Tensor:
    """Steps in ms relative to a batch start, as the kernels take them."""
    if rel.size and (rel.min() < -2**31 or rel.max() >= 2**31 - 1):
        raise UnsupportedQuery("query range too long for int32 ms steps")
    return torch.from_numpy(rel.astype(np.int32))


def tensor_of(m: StepMatrix, device: torch.device | None = None
              ) -> torch.Tensor:
    """A matrix's values as a float64 tensor (on ``device`` if given)."""
    v = torch.as_tensor(m.values)
    return v.to(device=device if device is not None else v.device,
                dtype=EXACT_DTYPE)


def decoded_fn(fn: str, params: tuple, window: int, ts, vals, valid,
               steps: torch.Tensor, flight: int) -> torch.Tensor:
    """A non-rate range function on one decoded chunk, [rows, K]: B4 for
    the window sums, else the float64 ``range_eval_masked`` family."""
    if fn in WINDOW_SUM_FNS:
        ts = torch.where(valid, ts, TS_PAD).contiguous()
        cnt = windowed_sum(ts, valid.to(torch.float32), steps, window,
                           flight)
        nan = torch.tensor(float("nan"), device=cnt.device)
        if fn == "count_over_time":
            return torch.where(cnt > 0, cnt, nan)
        if fn == "present_over_time":
            return torch.where(cnt > 0, 1.0, nan)
        s = windowed_sum(ts, torch.where(valid, vals, 0.0).contiguous(),
                         steps, window, flight)
        if fn == "avg_over_time":
            s = s / cnt.clamp(min=1.0)
        return torch.where(cnt > 0, s, nan)
    return matrix_fn(fn, params, ts, vals, valid, steps, window)


def matrix_fn(fn: str, params: tuple, ts, vals, valid, steps,
              window: int) -> torch.Tensor:
    """A range function in float64 on the device over decoded rows, or
    over an evaluated matrix's rows (a subquery's steps as samples)."""
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


class RangeVectorTransformer:
    """A stage that maps one ``StepMatrix`` to another."""

    def apply(self, data: StepMatrix) -> StepMatrix:  # pragma: no cover
        raise NotImplementedError


@dataclass
class PeriodicSamplesMapper(RangeVectorTransformer):
    """The leaf's windowing stage (reference ``PeriodicSamplesMapper``): a
    range function, or with ``function`` None the instant selector's last
    sample within the staleness lookback, at each step of [start, end]; at
    the ``@`` time for every step if ``at_ms`` is set."""

    start: int
    step: int
    end: int
    window: int = 0
    function: str | None = None
    params: tuple = ()
    offset: int = 0
    at_ms: int | None = None
    # the reference's fields, carried on the plan wire; no planner of
    # either package sets them
    is_counter: bool = False
    keep_metric: bool = False

    @property
    def fn(self) -> str:
        return self.function or "last_sample"

    @property
    def span(self) -> int:
        return self.window if self.function else STALENESS_MS

    def _served(self, what: str) -> None:
        if SERVED_FNS.get(self.fn) != len(self.params) \
                or not all(isinstance(p, (int, float)) for p in self.params):
            raise UnsupportedQuery(
                f"range function {self.fn}"
                f"{tuple(self.params) if self.params else ''} over {what} is "
                f"not served (served: {', '.join(SERVED_FNS)})")

    def eval_batch(self, batch: DeviceBatch | SeriesBatch,
                   stats: QueryStats) -> StepMatrix:
        """The stage over a batch of packed pages on the card, or over a
        host-decode lane batch."""
        steps_ms = steps_array(self.start, self.step, self.end)
        if not batch.keys:
            return StepMatrix.empty(steps_ms)
        hist = batch.les is not None
        self._served("a histogram" if hist else "a selector")
        if hist and self.fn not in RANGE_FNS:
            raise UnsupportedQuery(
                f"range function {self.fn} over a histogram is not served "
                f"(the reference's exec engine raises)")
        eval_ms = steps_ms if self.at_ms is None \
            else np.array([self.at_ms], np.int64)
        host_steps = int32_steps(eval_ms - self.offset - batch.base)
        if isinstance(batch, SeriesBatch):
            stats.host_lane += 1
            res = self._eval_host(batch, host_steps.to(batch.device))
        else:
            flight = steps_in_flight(host_steps, self.span)
            steps = host_steps.to(batch.packed[0].device)
            res = self._eval_hist(batch, steps) if hist \
                else self._eval(batch, steps, flight, stats)
        if self.at_ms is not None:
            res = res.expand(res.shape[0], len(steps_ms), *res.shape[2:])
        return StepMatrix(batch.keys if self.function is None
                          else batch.out_keys, res, steps_ms,
                          dropped_keys=batch.out_keys, les=batch.les)

    def _eval(self, batch: DeviceBatch, steps: torch.Tensor, flight: int,
              stats: QueryStats) -> torch.Tensor:
        """Per-series results [n_series, K]; ``flight`` is
        ``steps_in_flight`` of the steps, taken on the host."""
        n = len(batch.keys)
        packed = batch.packed
        fn, params, window = self.fn, tuple(self.params), self.span
        range_len = batch.end - batch.base
        if fn in RATE_FNS:
            counter = fn != "delta" or batch.is_counter
            if batch.vmax < F32_SAFE_MAX:
                out = fused_decode_rate(packed, steps, window, fn, counter,
                                        in_flight=flight)
                return out[:n]
            stats.precise_lane += 1
            ts, vals, valid = assemble(packed, range_len)
            return range_eval_masked(fn, ts, vals, valid, steps, window,
                                     counter=counter,
                                     dtype=EXACT_DTYPE)[:n]
        outs = []
        rows = decode_rows(packed[0].shape[1] * BLOCK, fn)
        for a in range(0, n, rows):
            part = tuple(t[a : min(a + rows, n)] for t in packed)
            ts, vals, valid = assemble(part, range_len)
            outs.append(decoded_fn(fn, params, window, ts, vals, valid,
                                   steps, flight))
        out = torch.cat(outs)
        if fn == "timestamp":
            # seconds relative to the batch base → epoch seconds, in float64
            out = out + batch.base / 1000.0
        return out

    def _eval_host(self, batch: SeriesBatch,
                   steps: torch.Tensor) -> torch.Tensor:
        """A host-decode lane batch, [n_series, K], in float64 on the
        batch's device, in chunks of ``decode_rows`` series: the
        reference's counts-form branch. The delta family reads
        ``delta_arrays`` (reset-corrected for rate, increase and irate and
        for delta on counters; rebased only for idelta and deriv), rate and
        increase the raw values too; every other function the raw
        values."""
        fn, params, window = self.fn, tuple(self.params), self.span
        pre = fn in DELTA_FNS
        if pre:
            corrected = fn in ("rate", "increase", "irate") \
                or (fn == "delta" and batch.is_counter)
            ts, vals, counts, raw = batch.delta_arrays(corrected)
            if fn not in ("rate", "increase"):
                raw = None  # only the extrapolation clamp reads it
        else:
            (ts, vals, counts), raw = batch.device_arrays(), None
        n = len(batch.keys)
        outs = []
        rows = decode_rows(ts.shape[1], fn)
        for a in range(0, n, rows):
            part = slice(a, min(a + rows, n))
            if fn in ("quantile_over_time", "holt_winters"):
                outs.append(matrix_fn(fn, params, ts[part], vals[part],
                                      counts_valid(ts[part], counts[part]),
                                      steps, window))
                continue
            outs.append(range_eval(
                fn, ts[part], vals[part], counts[part], steps, window,
                extra=params[0] if params else 0.0,
                counter=batch.is_counter, dtype=EXACT_DTYPE,
                pre_corrected=pre, raw=None if raw is None else raw[part]))
        out = torch.cat(outs)
        if fn == "timestamp":
            out = out + batch.base / 1000.0
        return out

    def _eval_hist(self, batch: DeviceBatch,
                   steps: torch.Tensor) -> torch.Tensor:
        """A histogram leaf, [n_series, K, B]: chunks of series decoded
        (B1 on timestamps, then on every bucket block) and evaluated in
        float64 per bucket row; ``decode_rows`` counts series × B rows.
        No parameter reaches the function and no epoch rebase follows, as
        in the reference's per-bucket branch."""
        n = len(batch.keys)
        B = len(batch.les)
        rows = max(1, decode_rows(batch.packed[0].shape[1] * BLOCK, self.fn)
                   // B)
        outs = []
        for a in range(0, n, rows):
            part = tuple(t[a : min(a + rows, n)] for t in batch.packed)
            ts, counts, valid = assemble_hist(part, batch.end - batch.base)
            outs.append(range_eval_masked(self.fn, ts, counts, valid, steps,
                                          self.span,
                                          counter=batch.is_counter,
                                          dtype=EXACT_DTYPE))
        return torch.cat(outs).transpose(1, 2)

    def apply(self, data: StepMatrix) -> StepMatrix:
        """The stage over an evaluated matrix (a subquery): the inner steps
        act as samples, NaN entries dropped, on the device."""
        steps_ms = steps_array(self.start, self.step, self.end)
        data.settle()
        if data.num_series == 0:
            return StepMatrix.empty(steps_ms)
        if data.is_histogram:
            raise UnsupportedQuery("a subquery over a histogram is not served "
                                   "(the reference's exec engine raises)")
        self._served("a subquery")
        vals = tensor_of(data)
        base = int(data.steps_ms[0])
        ts = int32_steps(data.steps_ms - base).to(vals.device)
        ts = ts[None, :].expand(vals.shape[0], -1).contiguous()
        steps = int32_steps(steps_ms - self.offset - base).to(vals.device)
        out = matrix_fn(self.fn, tuple(self.params), ts, vals,
                        ~torch.isnan(vals), steps, self.window)
        if self.fn == "timestamp":
            out = out + base / 1000.0
        return StepMatrix([k.drop_metric() for k in data.keys], out,
                          steps_ms)


class GroupIdCache:
    """Group ids of aggregations, on the card, per keys list object: a
    cached batch hands out the same list every query, and instant
    functions and operators above it hand on its metric-free list
    (``StepMatrix.derive_without_metric``). A service holds one for its
    engines; the oldest of its ``cap`` entries goes first."""

    def __init__(self, cap: int = 16):
        self.cap = cap
        self._entries: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def keys_group_ids(self, amr: "AggregateMapReduce", keys: list,
                       device: torch.device):
        """``amr.group_ids(keys)`` with the ids on ``device``."""
        ck = (id(keys), amr.by, amr.without, str(device))
        hit = self._entries.get(ck)
        if hit is not None and hit[0] is keys:
            return hit[1]
        gids, gkeys = amr.group_ids(keys)
        out = (torch.from_numpy(gids).to(device), gkeys)
        if len(self._entries) >= self.cap:
            self._entries.pop(next(iter(self._entries)))
        self._entries[ck] = (keys, out)
        return out

    def of(self, amr: "AggregateMapReduce", data: StepMatrix):
        """(group id per series on the values' device, group keys) of
        ``data``. Over rows that ``StepMatrix.concat`` joined from several
        key lists (an exec engine's per-shard leaves), each list's ids are
        cached and only its distinct group keys are mapped to the joint
        ids, in first occurrence order as over the joined keys."""
        device = torch.as_tensor(data.values).device
        parts = data.key_parts or [data.keys]
        if len(parts) == 1:
            return self.keys_group_ids(amr, parts[0], device)
        uniq: dict[RangeVectorKey, int] = {}
        gids = []
        for keys in parts:
            g, gkeys = self.keys_group_ids(amr, keys, device)
            joint = torch.tensor([uniq.setdefault(k, len(uniq))
                                  for k in gkeys],
                                 dtype=torch.int64, device=device)
            gids.append(joint[g])
        return torch.cat(gids), list(uniq)


@dataclass
class AggregateMapReduce(RangeVectorTransformer):
    """Label-grouped aggregation (reference ``AggregateMapReduce``)."""

    op: str
    params: tuple = ()
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()

    def group_ids(self, keys: list[RangeVectorKey]):
        """(group id per series, group keys in first-occurrence order);
        ``by`` keeps the labels it names (the metric too, if named),
        ``without`` drops them and the metric."""
        if not (self.by or self.without):
            return np.zeros(len(keys), np.int64), [RangeVectorKey(())]
        uniq: dict[RangeVectorKey, int] = {}
        gids = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys):
            gk = k.only(self.by) if self.by \
                else k.without(self.without).drop_metric()
            gids[i] = uniq.setdefault(gk, len(uniq))
        return gids, list(uniq)

    def apply(self, data: StepMatrix, groups=None) -> StepMatrix:
        """``groups`` is ``group_ids(data.keys)`` where the caller has it."""
        data.settle()
        if data.num_series == 0:
            return data
        if data.is_histogram and self.op not in AGG_OPS:
            raise UnsupportedQuery(
                f"aggregation {self.op} over a histogram is not served (the "
                f"reference fails on it; served per bucket: "
                f"{', '.join(AGG_OPS)})")
        gids, out_keys = groups if groups is not None \
            else self.group_ids(data.keys)
        v = tensor_of(data)
        g = torch.as_tensor(gids).to(v.device)
        G = len(out_keys)
        if self.op in AGG_OPS and data.is_histogram:
            P, K, B = v.shape
            rows = v.transpose(1, 2).reshape(P * B, K)
            gb = (g[:, None] * B + torch.arange(B, device=v.device)).reshape(-1)
            out = aggregate(self.op, rows, gb, G * B)
            return StepMatrix(out_keys, out.view(G, B, K).transpose(1, 2),
                              data.steps_ms, les=data.les)
        if self.op in AGG_OPS:
            return StepMatrix(out_keys, aggregate(self.op, v, g, G),
                              data.steps_ms)
        if self.op in ("topk", "bottomk"):
            mask = topk_mask(v, g, G, int(self.params[0]),
                             self.op == "bottomk")
            return StepMatrix(list(data.keys), torch.where(mask, v, math.nan),
                              data.steps_ms).compact()
        if self.op == "quantile":
            return StepMatrix(out_keys, quantile_across(
                float(self.params[0]), v, g, G), data.steps_ms)
        if self.op == "count_values":
            label = str(self.params[0])
            pg, pv, counts = count_values(v, g)
            keys = [RangeVectorKey(tuple(sorted(
                list(out_keys[gi].labels) + [(label, _fmt_value(val))])))
                for gi, val in zip(pg.tolist(), pv.tolist())]
            return StepMatrix(keys, counts, data.steps_ms)
        raise ValueError(f"unknown aggregation {self.op}")


def _fmt_value(v: float) -> str:
    """count_values' label value, as the reference writes it: an integral
    value as an integer, any other as ``repr`` of the numpy float64 that
    ``np.unique`` hands it (``np.float64(2.5)`` under numpy 2)."""
    if v == int(v):
        return str(int(v))
    return repr(np.float64(v))


# ---------------------------------------------------------------------------
# two-phase aggregation pushdown (the reference's
# ``filodb_tpu/query/exec/transformers.py:333-460``): a map stage on each
# child, the fold at the root

# the label that carries a partial's component ("sum", "sumsq", "count")
# from the map stage to the root; never a series' own label
AGG_PART_LABEL = "__agg_part__"

# the aggregations whose partials fold exactly at the root; quantile and
# count_values need every series at once and take the gathering path
AGG_PUSHDOWN_OPS = frozenset((
    "sum", "min", "max", "count", "avg", "group", "stddev", "stdvar",
    "topk", "bottomk"))
AGG_PUSHDOWN_BYPASS = frozenset(("quantile", "count_values"))

_COMPONENTS = {"avg": ("sum", "count"),
               "stddev": ("sum", "sumsq", "count"),
               "stdvar": ("sum", "sumsq", "count")}


def _grouped(op: str, v: torch.Tensor, g: torch.Tensor,
             G: int) -> torch.Tensor:
    """``aggregate`` of [P, K] rows, or of a histogram's [P, K, B] rows
    bucket by bucket (group id g·B + b)."""
    if v.dim() == 3:
        P, K, B = v.shape
        rows = v.transpose(1, 2).reshape(P * B, K)
        gb = (g[:, None] * B + torch.arange(B, device=v.device)).reshape(-1)
        return aggregate(op, rows, gb, G * B).view(G, B, K).transpose(1, 2)
    return aggregate(op, v, g, G)


def _part_key(gk: RangeVectorKey, comp: str) -> RangeVectorKey:
    return RangeVectorKey(tuple(sorted(gk.labels + ((AGG_PART_LABEL,
                                                     comp),))))


@dataclass
class AggregatePartialMapper(RangeVectorTransformer):
    """The map stage of two-phase aggregation, on the child's card: one
    partial row a group instead of one row a series. sum, min, max,
    count and group give their own aggregate (a count folds as a sum at
    the root); avg gives (sum, count) and stddev / stdvar (sum, sum of
    squares, count), rows tagged ``AGG_PART_LABEL``; topk / bottomk give
    the child's k candidates a group, exact after the root ranks their
    union (each step's global top k is among the children's)."""

    op: str
    params: tuple = ()
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()

    def bind(self, ctx) -> None:
        self._ctx = ctx

    def apply(self, data: StepMatrix) -> StepMatrix:
        data.settle()
        if data.num_series == 0:
            return data
        amr = AggregateMapReduce(self.op, self.params, self.by, self.without)
        ctx = getattr(self, "_ctx", None)
        groups = ctx.gids.of(amr, data) if ctx is not None \
            else amr.group_ids(data.keys)
        comps = _COMPONENTS.get(self.op)
        if comps is None:
            if self.op not in AGG_PUSHDOWN_OPS:
                raise ValueError(f"aggregation {self.op!r} is not "
                                 f"pushdown-capable")
            return amr.apply(data, groups)
        gids, out_keys = groups
        v = tensor_of(data).to(EXACT_DTYPE)
        g = torch.as_tensor(gids).to(v.device)
        parts, keys = [], []
        for comp in comps:
            parts.append(_grouped("sum", v * v, g, len(out_keys))
                         if comp == "sumsq"
                         else _grouped(comp, v, g, len(out_keys)))
            keys.extend(_part_key(gk, comp) for gk in out_keys)
        return StepMatrix(keys, torch.cat(parts), data.steps_ms,
                          les=data.les)


def _reduce_by_key(m: StepMatrix, op: str) -> StepMatrix:
    """Rows of equal keys combined by ``op`` (partials' group labels are
    reduced already, so a group is a whole key)."""
    uniq: dict[RangeVectorKey, int] = {}
    gids = [uniq.setdefault(k, len(uniq)) for k in m.keys]
    if len(uniq) == m.num_series:
        return m
    v = tensor_of(m)
    g = torch.tensor(gids, dtype=torch.int64, device=v.device)
    return StepMatrix(list(uniq), _grouped(op, v, g, len(uniq)),
                      m.steps_ms, les=m.les)


def _split_components(m: StepMatrix, comps: tuple[str, ...]):
    """Partial rows → (group keys, one [G, K(, B)] tensor a component,
    rows aligned)."""
    rows: dict[str, dict[RangeVectorKey, int]] = {c: {} for c in comps}
    for i, k in enumerate(m.keys):
        lm = dict(k.labels)
        comp = lm.pop(AGG_PART_LABEL, None)
        if comp not in rows:
            raise ValueError(f"partial aggregate row lacks a valid "
                             f"{AGG_PART_LABEL} component: {k}")
        rows[comp][RangeVectorKey(tuple(sorted(lm.items())))] = i
    keys = list(rows[comps[0]])
    v = tensor_of(m)
    out = []
    for c in comps:
        if set(rows[c]) != set(keys):
            raise ValueError("misaligned partial aggregate components")
        idx = torch.tensor([rows[c][k] for k in keys], dtype=torch.int64,
                           device=v.device)
        out.append(v[idx].to(EXACT_DTYPE))
    return keys, out


class PartialAggregateFolder:
    """The root of two-phase aggregation: folds each child's partial rows
    as they come, on the root's card (the gather moved remote rows there),
    so it holds a group's rows, never a series'; ``finalize`` makes avg,
    stddev and stdvar from their components, in float64."""

    # how partial rows combine across children, by the query's op
    _COMBINE = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
                "group": "group", "avg": "sum", "stddev": "sum",
                "stdvar": "sum"}

    def __init__(self, op: str, params=(), by=(), without=()):
        self.op = op
        self.params = params
        self.by = by
        self.without = without
        self._acc: StepMatrix | None = None

    def fold(self, m: StepMatrix) -> None:
        if m is None:
            return
        m.settle()
        if m.num_series == 0:
            return
        if self._acc is None:
            self._acc = m
            return
        both = StepMatrix.concat([self._acc, m])
        if self.op in ("topk", "bottomk"):
            # the candidates' union ranked again: at most k a group stay
            self._acc = AggregateMapReduce(
                self.op, self.params, self.by, self.without).apply(
                    both).settle()
        else:
            self._acc = _reduce_by_key(both, self._COMBINE[self.op])

    def finalize(self) -> StepMatrix:
        acc = self._acc
        if acc is None:
            return StepMatrix.empty()
        comps = _COMPONENTS.get(self.op)
        if comps is None:
            return acc
        keys, parts = _split_components(acc, comps)
        cnt = parts[-1]
        has = torch.nan_to_num(cnt) > 0
        if self.op == "avg":
            out = torch.where(has, parts[0] / cnt, math.nan)
        else:
            s, s2 = parts[0], parts[1]
            mean = s / cnt
            var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
            out = torch.where(has, var if self.op == "stdvar"
                              else torch.sqrt(var), math.nan)
        return StepMatrix(keys, out, acc.steps_ms, les=acc.les)


@dataclass
class InstantVectorFunctionMapper(RangeVectorTransformer):
    function: str
    args: tuple = ()

    def apply(self, data: StepMatrix) -> StepMatrix:
        if self.function == "hist_to_prom_vectors":
            return data.flatten_histograms() if data.is_histogram else data
        if self.function in ("histogram_quantile", "histogram_max_quantile"):
            q = float(self.args[0])
            if data.is_histogram:
                les = torch.from_numpy(np.asarray(data.les, np.float64))
                out = histogram_quantile(q, tensor_of(data), les)
                return data.derive([k.drop_metric() for k in data.keys], out)
            return bucket_quantile(q, data)
        out = apply_instant_fn(self.function, tensor_of(data),
                               tuple(float(a) for a in self.args))
        return data.derive_without_metric(out)


def bucket_quantile(q: float, data: StepMatrix) -> StepMatrix:
    """histogram_quantile over ``le``-labelled bucket series (reference
    ``InstantVectorFunctionMapper._bucket_quantile``): series group by
    their labels but ``le`` and the metric, buckets sort by bound, counts
    are made monotonic across buckets (NaN as 0, a running max), and the
    groups of one bucket scheme take one quantile call on the device. The
    grouping is host work on the keys."""
    data.settle()
    groups: dict[RangeVectorKey, list[tuple[float, int]]] = {}
    for i, k in enumerate(data.keys):
        le = k.label_map.get("le")
        if le is not None:
            gk = k.without(("le", METRIC_LABEL))
            groups.setdefault(gk, []).append((float(le), i))
    if not groups:
        return StepMatrix.empty(data.steps_ms)
    by_les: dict[tuple, list] = {}
    for gk, buckets in groups.items():
        buckets.sort()
        by_les.setdefault(tuple(b[0] for b in buckets), []).append(
            (gk, [b[1] for b in buckets]))
    v = tensor_of(data)
    out_keys, outs = [], []
    for les, members in by_les.items():
        idx = torch.tensor([rows for _, rows in members], device=v.device)
        h = torch.cummax(torch.nan_to_num(v[idx], nan=0.0), 1).values
        outs.append(histogram_quantile(q, h.transpose(1, 2),
                                       torch.tensor(les, dtype=EXACT_DTYPE)))
        out_keys.extend(gk for gk, _ in members)
    return StepMatrix(out_keys, torch.cat(outs), data.steps_ms)


@dataclass
class ScalarOperationMapper(RangeVectorTransformer):
    """vector-scalar binary operation (reference ``ScalarOperationMapper``):
    ``scalar`` is a number, or a per-step scalar, a tensor [K] (``time()``,
    ``scalar(v)``, scalar arithmetic), which applies to step k of every
    series."""

    op: str
    scalar: "float | torch.Tensor"
    scalar_is_lhs: bool = True
    bool_mode: bool = False

    def apply(self, data: StepMatrix) -> StepMatrix:
        v = tensor_of(data)
        if v.numel() == 0:
            # no series: the empty vector (a tier's [0, 0] matrix cannot
            # take a per-step scalar's K steps), as the reference returns
            return data.derive_without_metric(v)
        if isinstance(self.scalar, torch.Tensor):
            if self.scalar.dim() != 1 or data.is_histogram:
                raise UnsupportedQuery(
                    f"operator {self.op} between a per-step scalar and a "
                    f"histogram is not served (the reference's exec engine "
                    f"raises)")
            sc = self.scalar.to(v)[None, :].expand_as(v)
        else:
            sc = torch.full_like(v, float(self.scalar))
        lhs, rhs = (sc, v) if self.scalar_is_lhs else (v, sc)
        if self.op in COMPARISON_OPS and not self.bool_mode:
            # comparison filtering keeps the vector's sample values
            cond = apply_binary_op(self.op, lhs, rhs, bool_mode=True) == 1.0
            out = torch.where(cond, v, math.nan)
        else:
            out = apply_binary_op(self.op, lhs, rhs, self.bool_mode)
        return data.derive_without_metric(out)


@dataclass
class MiscellaneousFunctionMapper(RangeVectorTransformer):
    """label_replace / label_join (reference
    ``MiscellaneousFunctionMapper``): keys change on the host, values pass
    through."""

    function: str
    args: tuple = ()

    def apply(self, data: StepMatrix) -> StepMatrix:
        keys = []
        if self.function == "label_replace":
            dst, repl, src, regex = self.args[:4]
            pat = re.compile(f"^(?:{regex})$")
            repl = _dollar_to_backslash(repl)
            for k in data.keys:
                lm = k.label_map
                m = pat.match(lm.get(src, ""))
                if m:
                    val = m.expand(repl)
                    if val:
                        lm[dst] = val
                    else:
                        lm.pop(dst, None)
                keys.append(RangeVectorKey.of(lm))
        elif self.function == "label_join":
            dst, sep, *srcs = self.args
            for k in data.keys:
                lm = k.label_map
                lm[dst] = sep.join(lm.get(s, "") for s in srcs)
                keys.append(RangeVectorKey.of(lm))
        else:
            raise ValueError(f"unknown misc function {self.function}")
        return data.derive(keys, data.values)


def _dollar_to_backslash(repl: str) -> str:
    """PromQL's ``$1`` / ``${1}`` → Python's ``\\1``."""
    return re.sub(r"\$(\d+|\{\w+\})",
                  lambda m: "\\" + m.group(1).strip("{}"), repl)


@dataclass
class SortFunctionMapper(RangeVectorTransformer):
    """sort / sort_desc (reference ``SortFunctionMapper``): series ordered
    by their value at the last step, stably; NaN reads as -inf for sort and
    +inf for sort_desc (both first), an infinity as the largest finite
    value (``nan_to_num``)."""

    descending: bool = False

    def apply(self, data: StepMatrix) -> StepMatrix:
        data.settle()
        if data.num_series == 0:
            return data
        if data.is_histogram:
            raise UnsupportedQuery("sort of a histogram is not served (the "
                                   "reference fails on it)")
        v = tensor_of(data)
        last = torch.nan_to_num(v[:, -1], nan=math.inf if self.descending
                                else -math.inf)
        order = torch.argsort(-last if self.descending else last,
                              stable=True)
        return data.derive([data.keys[i] for i in order.tolist()],
                           v[order])


@dataclass
class AbsentFunctionMapper(RangeVectorTransformer):
    """absent / absent_over_time (reference ``AbsentFunctionMapper``): one
    series, labelled by the selector's ``Equals`` filters other than the
    metric, that is 1 at the steps where no input series has a value, or
    no series when every step has one."""

    filters: tuple = ()
    start: int = 0
    step: int = 1000
    end: int = 0
    device: torch.device | None = None  # where an answer of no input goes

    def bind(self, ctx) -> None:
        """Take the exec context's device for an answer of no input."""
        if self.device is None:
            self.device = ctx.device

    def apply(self, data: StepMatrix) -> StepMatrix:
        steps = steps_array(self.start, self.step, self.end)
        data.settle()
        if data.num_series == 0:
            out = torch.ones((1, len(steps)), dtype=EXACT_DTYPE,
                             device=self.device)
        else:
            v = tensor_of(data)
            out = torch.where(torch.isnan(v).all(0, keepdim=True), 1.0,
                              math.nan)
        if bool(torch.isnan(out).all()):
            return StepMatrix.empty(steps)
        labels = {f.column: f.filter.value for f in self.filters
                  if isinstance(f.filter, Equals)
                  and f.column != METRIC_LABEL}
        return StepMatrix([RangeVectorKey.of(labels)], out, steps)


@dataclass
class LimitFunctionMapper(RangeVectorTransformer):
    """FiloDB's limit (reference ``LimitFunctionMapper``): the first
    ``limit`` series."""

    limit: int = 1000

    def apply(self, data: StepMatrix) -> StepMatrix:
        data.settle()
        if data.num_series <= self.limit:
            return data
        return data.derive(data.keys[: self.limit],
                           torch.as_tensor(data.values)[: self.limit])
