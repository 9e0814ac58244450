"""Per-plan stages over ``StepMatrix`` batches.

Trimmed port of ``filodb_tpu/query/exec/transformers.py``:
``steps_array``, ``AggregateMapReduce`` (every aggregation of
``aggregations.py``: sum … stdvar, topk / bottomk, quantile; sum … stdvar
also per bucket over a histogram matrix), ``InstantVectorFunctionMapper``
(with ``histogram_quantile`` / ``histogram_max_quantile`` over a histogram
matrix or ``le``-labelled bucket series, and ``hist_to_prom_vectors``) and
``ScalarOperationMapper`` for a fixed scalar. Values stay torch tensors on
the device that holds them; keys are handled on the host. Output keys drop
the metric label exactly where the reference's do.

A histogram matrix's values are [P, K, B]. Aggregations flatten the buckets
into the group axis, group id g·B + b, as the reference's mesh engine does,
so each bucket reduces as a series of its own; instant functions and
operators are element-wise and keep ``les``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.device import EXACT_DTYPE
from filodb_tpu_torch.query.engine.aggregations import (
    AGG_OPS,
    aggregate,
    histogram_quantile,
    quantile_across,
    topk_mask,
)
from filodb_tpu_torch.query.engine.instantfns import (
    COMPARISON_OPS,
    apply_binary_op,
    apply_instant_fn,
)
from filodb_tpu_torch.query.model import RangeVectorKey, StepMatrix


def steps_array(start: int, step: int, end: int) -> np.ndarray:
    """Step timestamps [start, end] inclusive (epoch ms)."""
    if step <= 0:
        return np.array([end], dtype=np.int64)
    return np.arange(start, end + 1, step, dtype=np.int64)


def tensor_of(m: StepMatrix, device: torch.device | None = None
              ) -> torch.Tensor:
    """A matrix's values as a float64 tensor (on ``device`` if given)."""
    v = torch.as_tensor(m.values)
    return v.to(device=device if device is not None else v.device,
                dtype=EXACT_DTYPE)


@dataclass
class AggregateMapReduce:
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
        raise ValueError(f"unknown aggregation {self.op}")


@dataclass
class InstantVectorFunctionMapper:
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
class ScalarOperationMapper:
    """vector-scalar binary operation (reference ``ScalarOperationMapper``)
    for a fixed scalar."""

    op: str
    scalar: float
    scalar_is_lhs: bool = True
    bool_mode: bool = False

    def apply(self, data: StepMatrix) -> StepMatrix:
        v = tensor_of(data)
        sc = torch.full_like(v, float(self.scalar))
        lhs, rhs = (sc, v) if self.scalar_is_lhs else (v, sc)
        if self.op in COMPARISON_OPS and not self.bool_mode:
            # comparison filtering keeps the vector's sample values
            cond = apply_binary_op(self.op, lhs, rhs, bool_mode=True) == 1.0
            out = torch.where(cond, v, math.nan)
        else:
            out = apply_binary_op(self.op, lhs, rhs, self.bool_mode)
        return data.derive_without_metric(out)
