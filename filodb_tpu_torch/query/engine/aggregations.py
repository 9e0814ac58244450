"""Aggregation across series by group id.

Port of ``filodb_tpu/query/engine/aggregations.py::aggregate`` for sum,
avg, min, max and count: [P, K] per-series results → [G, K] per group, NaN
excluded from every operation and NaN where a group has no sample at a
step. Plain PyTorch (``index_add_`` / ``scatter_reduce_``); the reference
uses XLA segment reductions here, not a Pallas kernel. Sums accumulate in
float64, the reference's dtype under x64.
"""

from __future__ import annotations

import torch

from filodb_tpu_torch.device import EXACT_DTYPE

AGG_OPS = ("sum", "avg", "min", "max", "count")


def aggregate(op: str, values: torch.Tensor, group_ids: torch.Tensor,
              num_groups: int) -> torch.Tensor:
    if op not in AGG_OPS:
        raise ValueError(f"aggregation {op} is not in this slice")
    values = values.to(EXACT_DTYPE)
    K = values.shape[1]
    present = ~torch.isnan(values)
    gids = group_ids.to(device=values.device, dtype=torch.int64)
    zeros = torch.zeros((num_groups, K), dtype=EXACT_DTYPE,
                        device=values.device)
    cnt = zeros.clone().index_add_(0, gids, present.to(EXACT_DTYPE))
    nan = torch.tensor(float("nan"), dtype=EXACT_DTYPE,
                       device=values.device)
    if op == "count":
        return torch.where(cnt > 0, cnt, nan)
    if op in ("sum", "avg"):
        s = zeros.clone().index_add_(0, gids,
                                     torch.where(present, values, 0.0))
        if op == "sum":
            return torch.where(cnt > 0, s, nan)
        return torch.where(cnt > 0, s / cnt.clamp(min=1.0), nan)
    fill = float("inf") if op == "min" else float("-inf")
    m = torch.full((num_groups, K), fill, dtype=EXACT_DTYPE,
                   device=values.device)
    m.scatter_reduce_(0, gids[:, None].expand(-1, K),
                      torch.where(present, values, fill),
                      reduce="amin" if op == "min" else "amax")
    return torch.where(cnt > 0, m, nan)
