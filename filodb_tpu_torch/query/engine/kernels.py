"""Range functions over a masked series batch, in plain PyTorch.

Port of ``filodb_tpu/query/engine/kernels.py::range_eval_masked``
(``_range_impl``) for the six range functions of this slice: ``rate``,
``increase``, ``delta``, ``sum_over_time``, ``count_over_time`` and
``avg_over_time``. Same formulation: window bounds by binary search over
sorted timestamps, windowed sums and counts as differences of exclusive
prefix sums, first/last valid samples through prev/next-valid index maps,
counter-reset correction as a cumulative sum of dropped previous values,
and Prometheus ``extrapolatedRate``.

It runs in the dtype the caller names: float32 as the plain version of the
fused kernel B3 (``cuda_kernels.fused_decode_rate_plain``), float64 as the
precise lane the engine's precision gate falls back to on the card.

``ts`` int32 [P, S] relative ms, non-decreasing (gap positions carry the
previous real timestamp); ``vals`` [P, S]; ``valid`` bool [P, S];
``steps`` int32 [K]; ``window`` int ms. Returns [P, K], NaN = no result.
"""

from __future__ import annotations

import torch

RANGE_FNS = ("rate", "increase", "delta", "sum_over_time",
             "count_over_time", "avg_over_time")


def _eprefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis: [..., S] → [..., S+1]."""
    return torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(x, -1)], -1)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division: PyTorch's CUDA kernels multiply by the
    reciprocal when the divisor is a Python scalar, which rounds
    differently from the hand-written kernel's division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def window_bounds(ts: torch.Tensor, steps: torch.Tensor, window: int):
    """[lo, hi) sample bounds of (t-w, t] per series and step."""
    P = ts.shape[0]
    t = steps.to(ts.dtype)[None, :].expand(P, -1).contiguous()
    hi = torch.searchsorted(ts.contiguous(), t, right=True)
    lo = torch.searchsorted(ts.contiguous(), t - window, right=True)
    return lo, hi


def _counter_corrected(v: torch.Tensor, valid: torch.Tensor,
                       pv: torch.Tensor) -> torch.Tensor:
    """Values plus the cumulative reset correction; comparisons are against
    the previous VALID sample (prev-valid index map ``pv``)."""
    pv_prev = torch.cat([torch.full_like(pv[:, :1], -1), pv[:, :-1]], 1)
    prev = torch.gather(v, 1, pv_prev.clamp(min=0))
    dropped = (v < prev) & valid & (pv_prev >= 0)
    return v + torch.cumsum(torch.where(dropped, prev, 0.0), 1)


def range_eval_masked(fn: str, ts: torch.Tensor, vals: torch.Tensor,
                      valid: torch.Tensor, steps: torch.Tensor, window: int,
                      counter: bool = False,
                      dtype: torch.dtype = torch.float64) -> torch.Tensor:
    if fn not in RANGE_FNS:
        raise ValueError(f"range function {fn} is not in this slice")
    vals = vals.to(dtype)
    v = torch.where(valid, vals, 0.0)
    S = ts.shape[1]
    lo, hi = window_bounds(ts, steps, window)
    vcount = _eprefix(valid.to(dtype))
    n = torch.gather(vcount, 1, hi) - torch.gather(vcount, 1, lo)
    has1 = n >= 1
    nan = torch.tensor(float("nan"), dtype=dtype, device=ts.device)

    if fn == "count_over_time":
        return torch.where(has1, n, nan)
    if fn in ("sum_over_time", "avg_over_time"):
        csum = _eprefix(v)
        s = torch.gather(csum, 1, hi) - torch.gather(csum, 1, lo)
        if fn == "avg_over_time":
            return torch.where(has1, s / n.clamp(min=1.0), nan)
        return torch.where(has1, s, nan)

    # rate / increase / delta
    sidx = torch.arange(S, dtype=torch.int64, device=ts.device)[None, :]
    pv = torch.cummax(torch.where(valid, sidx, -1), 1).values
    nv = torch.flip(torch.cummin(torch.flip(torch.where(valid, sidx, S), [1]),
                                 1).values, [1])
    first_idx = torch.gather(nv, 1, lo.clamp(max=S - 1)).clamp(0, S - 1)
    last_idx = torch.gather(pv, 1, (hi - 1).clamp(min=0)).clamp(0, S - 1)
    if counter or fn in ("rate", "increase"):
        cv = torch.where(valid, _counter_corrected(v, valid, pv), 0.0)
    else:
        cv = v
    v_first = torch.gather(cv, 1, first_idx)
    v_last = torch.gather(cv, 1, last_idx)
    raw_first = torch.gather(v, 1, first_idx)
    # durations are differenced in integer ms, then divided: one rounding
    # (the reference divides each time by 1000 first, which in float32
    # costs an ulp of the absolute time in every duration)
    t_first = torch.gather(ts, 1, first_idx).to(torch.int64)
    t_last = torch.gather(ts, 1, last_idx).to(torch.int64)
    result = v_last - v_first
    st = steps.to(device=ts.device, dtype=torch.int64)[None, :]
    sampled = _div((t_last - t_first).to(dtype), 1000.0)
    avg_dur = sampled / (n - 1.0).clamp(min=1.0)
    dur_start = _div((t_first - (st - window)).to(dtype), 1000.0)
    dur_end = _div((st - t_last).to(dtype), 1000.0)
    if fn in ("rate", "increase"):
        inf = torch.tensor(float("inf"), dtype=dtype, device=ts.device)
        dur_to_zero = torch.where(result > 0,
                                  sampled * raw_first / result.clamp(min=1e-30),
                                  inf)
        dur_start = torch.minimum(dur_start, dur_to_zero)
    threshold = avg_dur * 1.1
    extend = sampled
    extend = extend + torch.where(dur_start < threshold, dur_start,
                                  avg_dur / 2.0)
    extend = extend + torch.where(dur_end < threshold, dur_end, avg_dur / 2.0)
    factor = extend / sampled.clamp(min=1e-10)
    result = result * factor
    if fn == "rate":
        win_s = _div(torch.tensor(float(window), dtype=dtype), 1000.0)
        result = _div(result, win_s.item())
    return torch.where(n >= 2, result, nan)
