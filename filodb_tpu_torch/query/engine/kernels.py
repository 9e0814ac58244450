"""Range functions over a masked series batch, in plain PyTorch.

Port of ``filodb_tpu/query/engine/kernels.py`` (``range_eval_masked`` /
``_range_impl``, ``_linreg``, the sparse table ``_build_sparse`` /
``_rmq``, ``quantile_over_time_masked`` and ``holt_winters_masked``). Same
formulation: window bounds by binary search over sorted timestamps,
windowed sums and counts as differences of exclusive prefix sums,
first/last valid samples through prev/next-valid index maps (the rows have
interior gaps), min/max by a sparse-table range query, counter-reset
correction as a cumulative sum of dropped previous values, and Prometheus
``extrapolatedRate``.

It runs in the dtype the caller names: float32 as the plain version of the
fused kernel B3 (``cuda_kernels.fused_decode_rate_plain``), float64 for
every function the engine evaluates on decoded chunks and for the precise
lane its precision gate falls back to.

``range_eval`` is the counts form of the host-decode lane's batches (the
first ``counts`` samples of a row valid). Over those batches' values,
which float32 does not hold, the prefix sums of values add in the
reference's order (``_scan``), so that the functions that cancel agree
with the reference's; over the page lane's exact values the order moves
no bit that matters, and one ``torch.cumsum`` is faster on the card.

``ts`` int32 [P, S] relative ms, non-decreasing (gap positions carry the
previous real timestamp); ``vals`` [P, S]; ``valid`` bool [P, S];
``steps`` int32 [K]; ``window`` int ms. Returns [P, K], NaN = no result.
``range_eval_masked`` also takes histogram rows, ``vals`` [P, B, S] under
their series' ``ts`` and ``valid`` [P, S], and returns [P, B, K]: window
bounds and valid-sample maps are computed once a series and gathered for
its B bucket rows through expanded index views (the reference vmaps the
whole function over the bucket axis), so each bucket is its own counter.
"""

from __future__ import annotations

import torch

RATE_FNS = ("rate", "increase", "delta")
RANGE_FNS = (
    "sum_over_time", "avg_over_time", "count_over_time", "min_over_time",
    "max_over_time", "stddev_over_time", "stdvar_over_time",
    "last_over_time", "present_over_time", "changes", "resets", "deriv",
    "irate", "idelta", "rate", "increase", "delta", "last_sample",
    "timestamp", "zscore", "predict_linear",
)
# functions that gather a window's last valid sample, and of those the
# ones that gather its first too
_LAST_FNS = ("zscore", "last_over_time", "last_sample", "timestamp",
             "changes", "resets", "irate", "idelta") + RATE_FNS
_FIRST_FNS = ("changes", "resets") + RATE_FNS


_SCAN_TILE = 16


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, one element after another
    as ``np.cumsum`` adds: the sum runs along an outer axis, which PyTorch
    scans sequentially on the CPU and on CUDA alike."""
    return torch.cumsum(x.movedim(-1, 0).contiguous(), 0).movedim(0, -1)


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, added in the order the
    reference's ``jnp.cumsum`` adds on the CPU (XLA rewrites the
    cumulative reduce-window into tiles of 16: a running sum inside each
    tile, plus the prefix of the tile totals, scanned the same way). In
    float64 over values that float32 does not hold, the windowed moments
    (stddev, stdvar, zscore) cancel E[x²] − E[x]², so their last bits, and
    at large magnitudes their leading ones, follow the order of the sums."""
    S = x.shape[-1]
    if S <= _SCAN_TILE:
        return running_sum(x)
    nt = -(-S // _SCAN_TILE)
    pad = torch.zeros((*x.shape[:-1], nt * _SCAN_TILE - S), dtype=x.dtype,
                      device=x.device)
    inner = _scan(torch.cat([x, pad], -1).reshape(*x.shape[:-1], nt,
                                                   _SCAN_TILE))
    outer = _scan(inner[..., -1])
    before = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                       -1)
    return (inner + before[..., None]).reshape(*x.shape[:-1], -1)[..., :S]


def _minus_square(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x − m², rounded once where it cancels, as the reference's XLA
    contracts it into a fused multiply-add: m² = p + e exactly (Dekker's
    product, one operation at a time, so on any device), and x − p is
    exact where x and p lie within a factor of two (Sterbenz). Over values
    float32 does not hold, E[x²] − mean² cancels, and the rounding of mean²
    would otherwise reach its leading digits."""
    p = m * m
    # Veltkamp's split into two halves of the mantissa: 2^27 + 1 splits a
    # float64, 2^12 + 1 a float32
    c = m * (134217729.0 if m.dtype == torch.float64 else 4097.0)
    hi = c - (c - m)
    lo = m - hi
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    return (x - p) - e


def _eprefix(x: torch.Tensor, ordered: bool = False) -> torch.Tensor:
    """Exclusive prefix sum along the last axis: [..., S] → [..., S+1];
    ``ordered``: added in the reference's order (``_scan``)."""
    return torch.cat([torch.zeros_like(x[..., :1]),
                      _scan(x) if ordered else torch.cumsum(x, -1)], -1)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division: PyTorch's CUDA kernels multiply by the
    reciprocal when the divisor is a Python scalar, which rounds
    differently from the hand-written kernel's division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the sample axis; an index of one row a series
    ([P, 1, K]) serves every bucket row of ``x`` [P, B, S]."""
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], idx.shape[-1]))


def window_bounds(ts: torch.Tensor, steps: torch.Tensor, window: int):
    """[lo, hi) sample bounds of (t-w, t] per series and step."""
    t = steps.to(ts.dtype).expand(*ts.shape[:-1], -1).contiguous()
    hi = torch.searchsorted(ts.contiguous(), t, right=True)
    lo = torch.searchsorted(ts.contiguous(), t - window, right=True)
    return lo, hi


def _prev_valid_value(v: torch.Tensor, pv: torch.Tensor):
    """(previous valid value, it exists) per position, skipping gaps
    through the prev-valid index map ``pv``."""
    pv_prev = torch.cat([torch.full_like(pv[..., :1], -1), pv[..., :-1]],
                        -1)
    return _gather(v, pv_prev.clamp(min=0)), pv_prev >= 0


def _counter_corrected(v: torch.Tensor, valid: torch.Tensor,
                       pv: torch.Tensor) -> torch.Tensor:
    """Values plus the cumulative reset correction; comparisons are against
    the previous VALID sample."""
    prev, prev_ok = _prev_valid_value(v, pv)
    dropped = (v < prev) & valid & prev_ok
    return v + torch.cumsum(torch.where(dropped, prev, 0.0), -1)


def _floor_log2(w: torch.Tensor) -> torch.Tensor:
    """floor(log2 w) for integer w >= 1, exactly (the reference's
    ``31 - clz``): frexp's exponent of the float64 value, exact below 2^53."""
    return (torch.frexp(w.to(torch.float64)).exponent - 1).to(torch.int64)


def _range_minmax(vals: torch.Tensor, valid: torch.Tensor, lo, hi,
                  is_min: bool) -> torch.Tensor:
    """Sparse-table range min/max over [lo, hi), in ``vals``'s own dtype
    (the float32 page values: casting the answer is exact). Levels fill one
    preallocated [L, P, S] table in place."""
    P, S = vals.shape
    ident = float("inf") if is_min else float("-inf")
    op = torch.minimum if is_min else torch.maximum
    levels = max(S.bit_length(), 1)
    table = torch.empty((levels, P, S), dtype=vals.dtype, device=vals.device)
    table[0] = torch.where(valid, vals, ident)
    for j in range(1, levels):
        half = 1 << (j - 1)
        prev, cur = table[j - 1], table[j]
        cur[:, : S - half] = op(prev[:, : S - half], prev[:, half:])
        cur[:, S - half:] = prev[:, S - half:]  # op(x, identity) = x
    w = hi - lo
    j = _floor_log2(w.clamp(min=1))
    p = torch.arange(P, device=vals.device)[:, None]
    a = table[j, p, lo.clamp(max=S - 1)]
    b = table[j, p, (hi - 2 ** j).clamp(0, S - 1)]
    nan = torch.tensor(float("nan"), dtype=vals.dtype, device=vals.device)
    return torch.where(w > 0, op(a, b), nan)


def _linreg(ts, v, valid, lo, hi, steps, dtype, slope_only: bool,
            horizon_s: float = 0.0, ordered: bool = False) -> torch.Tensor:
    """Least-squares slope / prediction over each window (deriv,
    predict_linear), time centred at the step."""
    t_s = torch.where(valid, ts, 0).to(dtype) / 1000.0
    zero = torch.zeros((), dtype=dtype, device=ts.device)

    def window_sum(x):
        c = _eprefix(x, ordered)
        return _gather(c, hi) - _gather(c, lo)

    n = window_sum(valid.to(dtype))
    St = window_sum(torch.where(valid, t_s, zero))
    Sv = window_sum(v)
    Stt = window_sum(torch.where(valid, t_s * t_s, zero))
    Stv = window_sum(torch.where(valid, t_s * v, zero))
    c = steps.to(device=ts.device, dtype=dtype)[None, :] / 1000.0
    St_c = St - n * c
    Stt_c = Stt - 2.0 * c * St + n * c * c
    Stv_c = Stv - c * Sv
    denom = n * Stt_c - St_c * St_c
    slope = (n * Stv_c - St_c * Sv) / torch.where(denom == 0, 1.0, denom)
    ok = (n >= 2) & (denom != 0)
    nan = torch.tensor(float("nan"), dtype=dtype, device=ts.device)
    if slope_only:
        return torch.where(ok, slope, nan)
    intercept = (Sv - slope * St_c) / n.clamp(min=1.0)
    return torch.where(ok, intercept + slope * horizon_s, nan)


def range_eval_masked(fn: str, ts: torch.Tensor, vals: torch.Tensor,
                      valid: torch.Tensor, steps: torch.Tensor, window: int,
                      extra: float = 0.0, counter: bool = False,
                      dtype: torch.dtype = torch.float64,
                      pre_corrected: bool = False,
                      raw: torch.Tensor | None = None,
                      ordered: bool = False) -> torch.Tensor:
    """One range function at every step of every series (of every bucket
    row, for ``vals`` [P, B, S]); ``extra`` is predict_linear's horizon in
    seconds. ``pre_corrected``: rate / increase / delta take ``vals`` as
    already corrected (and rebased, ``batch.SeriesBatch.delta_host``), and
    ``raw`` [P, S], the values before that, gives the raw first sample of
    each window that the extrapolation clamp of rate and increase reads
    (the reference's ``range_eval``). ``ordered``: the prefix sums of
    values add in the reference's order (``_scan``)."""
    if fn not in RANGE_FNS:
        raise ValueError(f"unknown range function {fn}")
    if vals.dim() == 3:
        out = _range_eval(fn, ts[:, None, :], vals, valid[:, None, :], steps,
                          window, extra, counter, dtype)
        return out.expand(*vals.shape[:2], out.shape[-1])
    return _range_eval(fn, ts, vals, valid, steps, window, extra, counter,
                       dtype, pre_corrected, raw, ordered)


def counts_valid(ts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The counts form's validity: the first ``counts[p]`` samples of each
    row (the reference's ``_valid_mask``)."""
    S = ts.shape[-1]
    return torch.arange(S, device=ts.device)[None, :] < counts[:, None]


def range_eval(fn: str, ts: torch.Tensor, vals: torch.Tensor,
               counts: torch.Tensor, steps: torch.Tensor, window: int,
               extra: float = 0.0, counter: bool = False,
               dtype: torch.dtype = torch.float64,
               pre_corrected: bool = False,
               raw: torch.Tensor | None = None) -> torch.Tensor:
    """``range_eval_masked`` over rows whose first ``counts`` samples are
    valid (the host-decode lane's batches), its prefix sums of values
    added in the reference's order."""
    return range_eval_masked(fn, ts, vals, counts_valid(ts, counts), steps,
                             window, extra, counter, dtype, pre_corrected,
                             raw, ordered=True)


def _range_eval(fn, ts, vals, valid, steps, window, extra, counter, dtype,
                pre_corrected=False, raw=None, ordered=False):
    raw_vals = vals
    vals = vals.to(dtype)
    v = torch.where(valid, vals, 0.0)
    S = ts.shape[-1]
    lo, hi = window_bounds(ts, steps, window)
    vcount = _eprefix(valid.to(dtype))
    n = _gather(vcount, hi) - _gather(vcount, lo)
    has1 = n >= 1
    nan = torch.tensor(float("nan"), dtype=dtype, device=ts.device)
    if fn in _LAST_FNS:
        sidx = torch.arange(S, dtype=torch.int64, device=ts.device)
        pv = torch.cummax(torch.where(valid, sidx, -1), -1).values
        last_idx = _gather(pv, (hi - 1).clamp(min=0)).clamp(0, S - 1)
    if fn in _FIRST_FNS:
        nv = torch.flip(torch.cummin(torch.flip(
            torch.where(valid, sidx, S), [-1]), -1).values, [-1])
        first_idx = _gather(nv, lo.clamp(max=S - 1)).clamp(0, S - 1)

    if fn == "count_over_time":
        return torch.where(has1, n, nan)
    if fn == "present_over_time":
        return torch.where(has1, 1.0, nan).to(dtype)
    if fn in ("sum_over_time", "avg_over_time"):
        csum = _eprefix(v, ordered)
        s = _gather(csum, hi) - _gather(csum, lo)
        if fn == "avg_over_time":
            return torch.where(has1, s / n.clamp(min=1.0), nan)
        return torch.where(has1, s, nan)
    if fn in ("stddev_over_time", "stdvar_over_time", "zscore"):
        csum, csum2 = _eprefix(v, ordered), _eprefix(v * v, ordered)
        s = _gather(csum, hi) - _gather(csum, lo)
        s2 = _gather(csum2, hi) - _gather(csum2, lo)
        mean = s / n.clamp(min=1.0)
        var = _minus_square(s2 / n.clamp(min=1.0), mean).clamp(min=0.0)
        if fn == "stdvar_over_time":
            return torch.where(has1, var, nan)
        sd = torch.sqrt(var)
        if fn == "stddev_over_time":
            return torch.where(has1, sd, nan)
        return torch.where(has1, (_gather(v, last_idx) - mean) / sd, nan)
    if fn in ("min_over_time", "max_over_time"):
        if raw_vals.dim() == 3:  # bucket rows: one sparse table of P·B
            P, B = raw_vals.shape[:2]

            def rows(x):
                return x.expand(P, B, x.shape[-1]).reshape(P * B, -1)

            out = _range_minmax(rows(raw_vals), rows(valid), rows(lo),
                                rows(hi), fn == "min_over_time"
                                ).reshape(P, B, -1)
        else:
            out = _range_minmax(raw_vals, valid, lo, hi,
                                fn == "min_over_time")
        return torch.where(has1, out.to(dtype), nan)
    if fn == "timestamp":
        return torch.where(has1, _gather(ts, last_idx).to(dtype) / 1000.0,
                           nan)
    if fn in ("last_over_time", "last_sample"):
        return torch.where(has1, _gather(v, last_idx), nan)
    if fn in ("changes", "resets"):
        prev, prev_ok = _prev_valid_value(v, pv)
        moved = (v != prev) if fn == "changes" else (v < prev)
        cind = _eprefix((moved & valid & prev_ok).to(dtype))
        # indicators whose predecessor is in the window too: (first, hi)
        start = torch.minimum(first_idx + 1, hi)
        return torch.where(has1, _gather(cind, hi) - _gather(cind, start),
                           nan)
    if fn in ("irate", "idelta"):
        i1 = last_idx
        i0 = _gather(pv, (i1 - 1).clamp(min=0)).clamp(0, S - 1)
        v1, v0 = _gather(v, i1), _gather(v, i0)
        dv = v1 - v0
        if fn == "irate":
            t1 = _gather(ts, i1).to(dtype)
            t0 = _gather(ts, i0).to(dtype)
            dv = torch.where(v1 < v0, v1, dv)  # reset: rate from 0
            dv = dv / ((t1 - t0) / 1000.0).clamp(min=1e-10)
        return torch.where(n >= 2, dv, nan)
    if fn in ("deriv", "predict_linear"):
        return _linreg(ts, v, valid, lo, hi, steps, dtype,
                       fn == "deriv", float(extra), ordered)

    # rate / increase / delta
    if not pre_corrected and (counter or fn in ("rate", "increase")):
        cv = torch.where(valid, _counter_corrected(v, valid, pv), 0.0)
    else:
        cv = v
    v_first = _gather(cv, first_idx)
    v_last = _gather(cv, last_idx)
    raw_first = _gather(v if raw is None else
                        torch.where(valid, raw.to(dtype), 0.0), first_idx)
    # durations are differenced in integer ms, then divided: one rounding
    # (the reference divides each time by 1000 first, which in float32
    # costs an ulp of the absolute time in every duration)
    t_first = _gather(ts, first_idx).to(torch.int64)
    t_last = _gather(ts, last_idx).to(torch.int64)
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


def quantile_over_time_masked(q: float, ts: torch.Tensor, vals: torch.Tensor,
                              valid: torch.Tensor, steps: torch.Tensor,
                              window: int, block: int = 16,
                              dtype: torch.dtype = torch.float64
                              ) -> torch.Tensor:
    """φ-quantile of each window: a masked sort of [P, block, S] per block
    of steps. The sort runs in ``vals``'s own dtype (same order as after
    the exact cast); the interpolation in ``dtype``."""
    lo, hi = window_bounds(ts, steps, window)
    vcount = _eprefix(valid.to(dtype))
    P, S = ts.shape
    K = steps.shape[0]
    s_idx = torch.arange(S, device=ts.device)[None, None, :]
    inf = torch.tensor(float("inf"), dtype=vals.dtype, device=ts.device)
    nan = torch.tensor(float("nan"), dtype=dtype, device=ts.device)
    outs = []
    for b in range(0, K, block):
        lo_b, hi_b = lo[:, b : b + block], hi[:, b : b + block]
        in_win = (s_idx >= lo_b[:, :, None]) & (s_idx < hi_b[:, :, None])
        srt = torch.sort(torch.where(in_win & valid[:, None, :],
                                     vals[:, None, :], inf), dim=-1).values
        n = _gather(vcount, hi_b) - _gather(vcount, lo_b)
        pos = q * (n - 1.0).clamp(min=0.0)
        i0 = torch.floor(pos).to(torch.int64)
        frac = pos - i0
        a = torch.gather(srt, 2, i0[:, :, None])[:, :, 0].to(dtype)
        bv = torch.gather(srt, 2, (i0 + 1).clamp(max=S - 1)[:, :, None]
                          )[:, :, 0].to(dtype)
        outs.append(torch.where(n > 0, a + (bv - a) * frac, nan))
    return torch.cat(outs, 1) if outs else \
        torch.empty((P, 0), dtype=dtype, device=ts.device)


def holt_winters_masked(sf: float, tf: float, ts: torch.Tensor,
                        vals: torch.Tensor, valid: torch.Tensor,
                        steps: torch.Tensor, window: int,
                        dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Holt's double exponential smoothing over each window: a scan over
    the S samples carrying (level, trend, count) per series and step."""
    vals = vals.to(dtype)
    lo, hi = window_bounds(ts, steps, window)
    P, K = lo.shape
    level = torch.zeros((P, K), dtype=dtype, device=ts.device)
    trend = torch.zeros_like(level)
    cnt = torch.zeros((P, K), dtype=torch.int32, device=ts.device)
    for i in range(ts.shape[1]):
        in_win = (lo <= i) & (hi > i) & valid[:, i : i + 1]
        x = vals[:, i : i + 1]
        sm_level = sf * x + (1 - sf) * (level + trend)
        sm_trend = tf * (sm_level - level) + (1 - tf) * trend
        nl = torch.where(cnt <= 1, x, sm_level)
        nt = torch.where(cnt == 0, 0.0,
                         torch.where(cnt == 1, x - level, sm_trend))
        level = torch.where(in_win, nl, level)
        trend = torch.where(in_win, nt, trend)
        cnt = torch.where(in_win, cnt + 1, cnt)
    nan = torch.tensor(float("nan"), dtype=dtype, device=ts.device)
    return torch.where(cnt >= 2, level, nan)
