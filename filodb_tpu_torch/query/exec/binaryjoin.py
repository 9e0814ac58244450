"""Binary joins and set operators of two step matrices.

Port of ``filodb_tpu/query/exec/binaryjoin.py``: ``binary_join`` (label
matching one-to-one, group_left, group_right, ``on`` / ``ignoring``,
``bool``) and ``set_operator`` (and / or / unless) as functions of two
``StepMatrix``es, which the mesh engine calls, and the exec plans
``BinaryJoinExec`` and ``SetOperatorExec`` over them. Labels match on the
host, as in the reference; the value operation runs on the device that
holds the values. Results are compacted as the reference's are.

Either side may be a histogram, [P, K, B] values: two histograms join or
set-operate bucket by bucket, and the answer drops ``les``, as the
reference's exec engine answers them. A histogram against scalar series
raises ``UnsupportedQuery`` wherever the reference's values would have to
broadcast (and raise there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from filodb_tpu_torch.core.partkey import METRIC_LABEL
from filodb_tpu_torch.query.engine.instantfns import (
    COMPARISON_OPS,
    apply_binary_op,
)
from filodb_tpu_torch.query.exec.plan import (
    ExecContext,
    NonLeafExecPlan,
    run_plan,
)
from filodb_tpu_torch.query.exec.transformers import tensor_of
from filodb_tpu_torch.query.model import (
    RangeVectorKey,
    StepMatrix,
    UnsupportedQuery,
)

SET_OPS = ("and", "or", "unless")


def _join_key(key: RangeVectorKey, on, ignoring) -> RangeVectorKey:
    if on is not None:
        return key.only(on)
    return key.without(tuple(ignoring) + (METRIC_LABEL,))


def _device(*ms: StepMatrix) -> torch.device:
    for m in ms:
        if isinstance(m.values, torch.Tensor):
            return m.values.device
    return torch.device("cpu")


def _steps(lhs: StepMatrix, rhs: StepMatrix) -> np.ndarray:
    return lhs.steps_ms if lhs.num_steps else rhs.steps_ms


def _same_kind(a, b, op: str) -> None:
    """Values ``a`` and ``b`` both of a histogram, or both of scalar
    series."""
    if a.ndim != b.ndim:
        raise UnsupportedQuery(
            f"operator {op} between a histogram and scalar series is not "
            f"served (the reference's exec engine raises)")


def _result_key(cardinality: str, on, ignoring, include,
                many_key: RangeVectorKey,
                one_key: RangeVectorKey) -> RangeVectorKey:
    if cardinality == "one-to-one":
        return _join_key(many_key, on, ignoring)
    # group_left / group_right: the "many" side's labels (metric dropped)
    # plus the include labels copied from the "one" side
    lm = many_key.without((METRIC_LABEL,)).label_map
    one_lm = one_key.label_map
    for lbl in include:
        if lbl in one_lm:
            lm[lbl] = one_lm[lbl]
        else:
            lm.pop(lbl, None)
    return RangeVectorKey.of(lm)


def binary_join(lhs: StepMatrix, rhs: StepMatrix, op: str,
                cardinality: str = "one-to-one", on=None, ignoring=(),
                include=(), bool_mode: bool = False) -> StepMatrix:
    """``lhs op rhs`` between vectors; raises ``ValueError`` on the
    many-to-many matches the reference refuses, with its message."""
    lhs.settle()
    rhs.settle()
    steps = _steps(lhs, rhs)
    if lhs.num_series == 0 or rhs.num_series == 0:
        return StepMatrix.empty(steps)
    flipped = cardinality == "one-to-many"  # group_right
    many, one = (rhs, lhs) if flipped else (lhs, rhs)
    one_index: dict[RangeVectorKey, int] = {}
    for i, k in enumerate(one.keys):
        jk = _join_key(k, on, ignoring)
        if jk in one_index:
            side = "right" if not flipped else "left"
            raise ValueError(f"multiple matches on {side} side for {jk} "
                             f"(many-to-many not allowed for {op})")
        one_index[jk] = i
    if cardinality == "one-to-one":
        seen: set[RangeVectorKey] = set()
        for k in many.keys:
            jk = _join_key(k, on, ignoring)
            if jk in seen:
                raise ValueError(f"multiple matches on left side for {jk} "
                                 f"(use group_left/group_right)")
            seen.add(jk)
    many_idx, one_idx, out_keys = [], [], []
    for i, k in enumerate(many.keys):
        j = one_index.get(_join_key(k, on, ignoring))
        if j is None:
            continue
        many_idx.append(i)
        one_idx.append(j)
        out_keys.append(_result_key(cardinality, on, ignoring, include, k,
                                    one.keys[j]))
    if not many_idx:
        return StepMatrix.empty(steps)
    _same_kind(lhs.values, rhs.values, op)
    dev = _device(lhs, rhs)
    mv = tensor_of(many, dev)[torch.tensor(many_idx, device=dev)]
    ov = tensor_of(one, dev)[torch.tensor(one_idx, device=dev)]
    l_v, r_v = (ov, mv) if flipped else (mv, ov)
    if op in COMPARISON_OPS and not bool_mode:
        cond = apply_binary_op(op, l_v, r_v, bool_mode=True) == 1.0
        out = torch.where(cond, mv, math.nan)
    else:
        out = apply_binary_op(op, l_v, r_v, bool_mode)
    return StepMatrix(out_keys, out, steps).compact()


def _presence(m: StepMatrix, on, ignoring, dev):
    """Per join key of ``m``: its index, and [G, K] (or [G, K, B] over a
    histogram) whether any of the key's series has a sample there."""
    index: dict[RangeVectorKey, int] = {}
    gids = [index.setdefault(_join_key(k, on, ignoring), len(index))
            for k in m.keys]
    v = tensor_of(m, dev)
    present = torch.zeros((len(index),) + tuple(v.shape[1:]),
                          dtype=torch.int32, device=dev).index_add_(
        0, torch.tensor(gids, dtype=torch.int64, device=dev),
        (~torch.isnan(v)).to(torch.int32)) > 0
    return index, present


def _masked(m: StepMatrix, other_index, other_present, on, ignoring, dev,
            keep_where_present: bool, op: str):
    """(``m``'s values NaN where the matching key of the other side is
    absent (``keep_where_present``) or present, the rows that match)."""
    rows, groups = [], []
    for i, k in enumerate(m.keys):
        g = other_index.get(_join_key(k, on, ignoring))
        if g is not None:
            rows.append(i)
            groups.append(g)
    v = tensor_of(m, dev)
    hit = torch.zeros_like(v, dtype=torch.bool)
    if rows:
        _same_kind(v, other_present, op)
        hit[torch.tensor(rows, dtype=torch.int64, device=dev)] = \
            other_present[torch.tensor(groups, dtype=torch.int64, device=dev)]
    return torch.where(hit if keep_where_present else ~hit, v, math.nan), rows


def set_operator(lhs: StepMatrix, rhs: StepMatrix, op: str, on=None,
                 ignoring=()) -> StepMatrix:
    """and / or / unless, per step: ``and`` keeps lhs samples where a
    matching rhs series has one at the step, ``unless`` where none has,
    ``or`` adds rhs samples at steps where no matching lhs series has
    one."""
    if op not in SET_OPS:
        raise ValueError(f"unknown set op {op}")
    lhs.settle()
    rhs.settle()
    steps = _steps(lhs, rhs)
    dev = _device(lhs, rhs)
    if op == "or":
        if lhs.num_series and rhs.num_series:
            _same_kind(lhs.values, rhs.values, op)
        l_index, l_present = _presence(lhs, on, ignoring, dev)
        r_vals, _ = _masked(rhs, l_index, l_present, on, ignoring, dev,
                            False, op)
        out = StepMatrix.concat([lhs, StepMatrix(list(rhs.keys), r_vals,
                                                 steps)])
        if not out.num_series:
            return StepMatrix.empty(steps)
        return StepMatrix(out.keys, out.values, steps).compact()
    r_index, r_present = _presence(rhs, on, ignoring, dev)
    vals, rows = _masked(lhs, r_index, r_present, on, ignoring, dev,
                         op == "and", op)
    if op == "and":
        keys = [lhs.keys[i] for i in rows]
        vals = vals[torch.tensor(rows, dtype=torch.int64, device=dev)]
    else:
        keys = list(lhs.keys)
    if not keys:
        return StepMatrix.empty(steps)
    return StepMatrix(keys, vals, steps).compact()


# ---------------------------------------------------------------------------
# exec plans


@dataclass
class BinaryJoinExec(NonLeafExecPlan):
    """``lhs op rhs`` of the two sides' plans (reference
    ``BinaryJoinExec``)."""

    lhs_plans: list = field(default_factory=list)
    rhs_plans: list = field(default_factory=list)
    op: str = "+"
    cardinality: str = "one-to-one"
    on: tuple[str, ...] | None = None
    ignoring: tuple[str, ...] = ()
    include: tuple[str, ...] = ()
    bool_mode: bool = False

    def children(self):
        return self.lhs_plans + self.rhs_plans

    def do_execute(self, ctx: ExecContext) -> StepMatrix:
        lhs, rhs = _sides(self, ctx)
        return binary_join(lhs, rhs, self.op, self.cardinality, self.on,
                           self.ignoring, self.include, self.bool_mode)

    def __repr__(self):
        return (f"BinaryJoinExec(op={self.op}, card={self.cardinality}, "
                f"on={self.on}, ignoring={self.ignoring})")


@dataclass
class SetOperatorExec(NonLeafExecPlan):
    """and / or / unless of the two sides' plans (reference
    ``SetOperatorExec``)."""

    lhs_plans: list = field(default_factory=list)
    rhs_plans: list = field(default_factory=list)
    op: str = "and"
    on: tuple[str, ...] | None = None
    ignoring: tuple[str, ...] = ()

    def children(self):
        return self.lhs_plans + self.rhs_plans

    def do_execute(self, ctx: ExecContext) -> StepMatrix:
        lhs, rhs = _sides(self, ctx)
        return set_operator(lhs, rhs, self.op, self.on, self.ignoring)

    def __repr__(self):
        return f"SetOperatorExec(op={self.op})"


def _sides(plan, ctx: ExecContext) -> tuple[StepMatrix, StepMatrix]:
    return tuple(StepMatrix.concat([run_plan(p, ctx) for p in plans])
                 for plans in (plan.lhs_plans, plan.rhs_plans))
