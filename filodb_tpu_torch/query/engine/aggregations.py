"""Aggregation across series by group id.

Port of ``filodb_tpu/query/engine/aggregations.py``: ``aggregate`` (sum,
avg, min, max, count, group, stddev, stdvar: [P, K] per-series results →
[G, K] per group), ``topk_mask`` (topk / bottomk), ``quantile_across`` and
``histogram_quantile`` (Prometheus' bucket interpolation over [..., B]
cumulative bucket values); and ``count_values``, the device half of the
exec engine's host branch of ``AggregateMapReduce``.
NaN is excluded from every operation; a group with no sample at a step is
NaN there. Plain PyTorch (``index_add_`` / ``scatter_reduce_`` / stable
sorts); the reference uses XLA segment reductions here, not a Pallas
kernel. Everything accumulates in float64, the reference's dtype under x64.
"""

from __future__ import annotations

import torch

from filodb_tpu_torch.device import EXACT_DTYPE

AGG_OPS = ("sum", "avg", "min", "max", "count", "group", "stddev", "stdvar")


def _nan(values: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float("nan"), dtype=EXACT_DTYPE, device=values.device)


def aggregate(op: str, values: torch.Tensor, group_ids: torch.Tensor,
              num_groups: int) -> torch.Tensor:
    if op not in AGG_OPS:
        raise ValueError(f"unknown aggregation {op}")
    values = values.to(EXACT_DTYPE)
    K = values.shape[1]
    present = ~torch.isnan(values)
    zeroed = torch.where(present, values, 0.0)
    gids = group_ids.to(device=values.device, dtype=torch.int64)
    zeros = torch.zeros((num_groups, K), dtype=EXACT_DTYPE,
                        device=values.device)
    cnt = zeros.clone().index_add_(0, gids, present.to(EXACT_DTYPE))
    nan = _nan(values)
    if op == "count":
        return torch.where(cnt > 0, cnt, nan)
    if op == "group":
        return torch.where(cnt > 0, 1.0, nan).to(EXACT_DTYPE)
    if op in ("sum", "avg", "stddev", "stdvar"):
        s = zeros.clone().index_add_(0, gids, zeroed)
        if op == "sum":
            return torch.where(cnt > 0, s, nan)
        mean = s / cnt.clamp(min=1.0)
        if op == "avg":
            return torch.where(cnt > 0, mean, nan)
        s2 = zeros.clone().index_add_(0, gids, zeroed * zeroed)
        var = (s2 / cnt.clamp(min=1.0) - mean * mean).clamp(min=0.0)
        if op == "stdvar":
            return torch.where(cnt > 0, var, nan)
        return torch.where(cnt > 0, torch.sqrt(var), nan)
    fill = float("inf") if op == "min" else float("-inf")
    m = torch.full((num_groups, K), fill, dtype=EXACT_DTYPE,
                   device=values.device)
    m.scatter_reduce_(0, gids[:, None].expand(-1, K),
                      torch.where(present, values, fill),
                      reduce="amin" if op == "min" else "amax")
    return torch.where(cnt > 0, m, nan)


def _group_order(keyed: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Per step (column), the series ordered by group, then by ``keyed``
    ascending, then by series index: two stable sorts of each step."""
    by_value = torch.sort(keyed.T.contiguous(), dim=1, stable=True).indices
    by_group = torch.sort(gids[by_value], dim=1, stable=True).indices
    return torch.gather(by_value, 1, by_group)  # [K, P]


def topk_mask(values: torch.Tensor, group_ids: torch.Tensor,
              num_groups: int, k: int, bottom: bool = False) -> torch.Tensor:
    """Boolean [P, K] mask of each group's top (bottom) k series per step,
    as the reference ranks them: by value with NaN last, ties to the lowest
    series index (``lax.top_k``), then non-finite picks dropped (so a +inf
    takes a place of k and is not returned)."""
    v = values.to(EXACT_DTYPE)
    P, K = v.shape
    gids = group_ids.to(device=v.device, dtype=torch.int64)
    finite = torch.isfinite(v)
    # an ascending stable sort of -v is v descending, equal values in
    # index order
    keyed = torch.where(torch.isnan(v), float("inf"), v if bottom else -v)
    order = _group_order(keyed, gids)
    sizes = torch.bincount(gids, minlength=num_groups)
    first = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(P, device=v.device)[None, :] - first[gids[order]]
    take = (rank < k) & torch.gather(finite.T, 1, order)
    mask = torch.zeros((K, P), dtype=torch.bool, device=v.device)
    return mask.scatter_(1, order, take).T


def quantile_across(q: float, values: torch.Tensor, group_ids: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """φ-quantile across the series of each group, per step, by the
    reference's rule: the group's present values sorted, then every other
    row as +inf, interpolated at q·(n−1) between positions i0 and
    min(i0 + 1, P − 1)."""
    v = values.to(EXACT_DTYPE)
    P, K = v.shape
    gids = group_ids.to(device=v.device, dtype=torch.int64)
    present = ~torch.isnan(v)
    keyed = torch.where(present, v, float("inf"))
    srt = torch.gather(keyed.T, 1, _group_order(keyed, gids))  # [K, P]
    sizes = torch.bincount(gids, minlength=num_groups)
    first = torch.cumsum(sizes, 0) - sizes                      # [G]
    n = torch.zeros((num_groups, K), dtype=EXACT_DTYPE, device=v.device) \
        .index_add_(0, gids, present.to(EXACT_DTYPE))           # [G, K]
    pos = q * (n - 1.0).clamp(min=0.0)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0
    inf = torch.tensor(float("inf"), dtype=EXACT_DTYPE, device=v.device)

    def at(i):  # a group's i-th smallest; past its rows, +inf
        col = (first[:, None] + i.clamp(max=P - 1)).clamp(max=P - 1)
        got = torch.gather(srt, 1, col.T.contiguous()).T
        return torch.where(i < sizes[:, None], got, inf)

    a, b = at(i0), at((i0 + 1).clamp(max=P - 1))
    return torch.where(n > 0, a + (b - a) * frac, _nan(v))


def histogram_quantile(q: float, buckets: torch.Tensor,
                       les: torch.Tensor) -> torch.Tensor:
    """φ-quantile of cumulative bucket values [..., B] (e.g. per-bucket
    rates) with upper bounds ``les`` [B] (last +Inf) → [...], as the
    reference computes it: linear interpolation inside the first bucket
    whose count reaches q·total; the top bucket answers the second-highest
    bound; NaN where the total is 0 or NaN; -inf for q < 0, +inf for
    q > 1."""
    h = buckets.to(EXACT_DTYPE)
    les = les.to(device=h.device, dtype=EXACT_DTYPE)
    B = h.shape[-1]
    total = h[..., B - 1]
    rank = q * total
    ge = h >= rank[..., None]
    # the first bucket reaching the rank (jnp.argmax of the mask: 0 when
    # none does)
    lane = torch.arange(B, device=h.device)
    idx = torch.where(ge, lane, B).amin(-1)
    idx = torch.where(idx < B, idx, 0)
    below = (idx - 1).clamp(min=0)
    cum_hi = torch.gather(h, -1, idx[..., None])[..., 0]
    cum_lo = torch.where(idx > 0, torch.gather(h, -1, below[..., None])[..., 0],
                         0.0)
    le_hi = les[idx]
    le_lo = torch.where(idx > 0, les[below], 0.0)
    frac = (rank - cum_lo) / (cum_hi - cum_lo).clamp(min=1e-30)
    val = le_lo + (le_hi - le_lo) * frac
    val = torch.where(idx >= B - 1, les[max(B - 2, 0)], val)
    nan = _nan(h)
    val = torch.where(total > 0, val, nan)
    val = torch.where(torch.isnan(total), nan, val)
    if q < 0 or q > 1:
        return torch.full_like(val, float("-inf") if q < 0 else float("inf"))
    return val


def count_values(values: torch.Tensor, group_ids: torch.Tensor):
    """count_values over [P, K] values: → (group id [n], value [n]) of the
    n distinct (group, value) pairs among the non-NaN entries, ordered by
    group, then value, and their counts at each step [n, K] (NaN where a
    pair does not occur), as the reference's ``np.unique`` over (group,
    value, step) triples gives them. On the device: the distinct values
    (one ``torch.unique``) number the values in order, and one
    ``torch.unique`` over the int64 keys (group, value number, step)
    counts the triples."""
    v = values.to(EXACT_DTYPE)
    P, K = v.shape
    present = ~torch.isnan(v)
    gids = group_ids.to(device=v.device, dtype=torch.int64)
    g = gids[:, None].expand(P, K)[present]
    s = torch.arange(K, device=v.device)[None, :].expand(P, K)[present]
    uniq_v, vid = torch.unique(v[present], return_inverse=True)
    nv = max(uniq_v.numel(), 1)
    if (int(gids.max()) + 1 if P else 1) * nv * K >= 2**62:
        raise ValueError("count_values: too many distinct values to key")
    triples, counts = torch.unique((g * nv + vid) * K + s,
                                   return_counts=True)
    pairs, row_of = torch.unique(triples // K, return_inverse=True)
    out = torch.full((pairs.numel(), K), float("nan"), dtype=EXACT_DTYPE,
                     device=v.device)
    out[row_of, triples % K] = counts.to(EXACT_DTYPE)
    return pairs // nv, uniq_v[pairs % nv], out
