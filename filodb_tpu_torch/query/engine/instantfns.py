"""Instant (elementwise) functions and scalar/vector binary operators.

Port of ``filodb_tpu/query/engine/instantfns.py`` (``apply_instant_fn``,
``apply_binary_op`` and the calendar helpers): elementwise torch ops on
[P, K] step matrices, run on whatever device holds them. Two places where
torch and ``jnp`` differ are pinned to the reference: ``sign`` keeps NaN,
and float → int64 casts of the calendar functions follow XLA (NaN → 0,
saturating), so ``month(NaN)`` is 1 as in the reference. ``round`` rounds
half to even in both.
"""

from __future__ import annotations

import math

import torch

_I64_MAX = 2**63 - 1
TRIG_FNS = ("sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
            "tanh", "asinh", "acosh", "atanh")
CALENDAR_FNS = ("hour", "minute", "month", "year", "day_of_month",
                "day_of_week", "day_of_year", "days_in_month")
_UNARY = {"abs": torch.abs, "ceil": torch.ceil, "floor": torch.floor,
          "exp": torch.exp, "ln": torch.log, "log2": torch.log2,
          "log10": torch.log10, "sqrt": torch.sqrt, "deg": torch.rad2deg,
          "degrees": torch.rad2deg, "rad": torch.deg2rad,
          "radians": torch.deg2rad,
          **{f: getattr(torch, f) for f in TRIG_FNS}}
INSTANT_FNS = tuple(_UNARY) + ("round", "clamp_min", "clamp_max", "clamp",
                               "sgn") + CALENDAR_FNS


def _fdiv(x: torch.Tensor, d) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _xla_int64(x: torch.Tensor) -> torch.Tensor:
    """float64 → int64 as XLA converts: NaN → 0, out of range saturates."""
    hi, lo = x >= 2.0**63, x < -(2.0**63)
    i = torch.where(torch.isnan(x) | hi | lo, 0.0, x).to(torch.int64)
    i = torch.where(hi, _I64_MAX, i)
    return torch.where(lo, -_I64_MAX - 1, i)


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    thirty_one = torch.isin(m, torch.tensor([1, 3, 5, 7, 8, 10, 12],
                                            device=m.device))
    thirty = torch.isin(m, torch.tensor([4, 6, 9, 11], device=m.device))
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    feb = torch.where(leap, 29.0, 28.0)
    return torch.where(thirty_one, 31.0, torch.where(thirty, 30.0, feb))


def _civil_from_epoch_days(z: torch.Tensor):
    """Epoch days → (year, month, day), Howard Hinnant's algorithm."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: int, d: int) -> torch.Tensor:
    y = y - 1 if m <= 2 else y
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m - 3 if m > 2 else m + 9
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def apply_instant_fn(fn: str, values: torch.Tensor,
                     params: tuple = ()) -> torch.Tensor:
    """values [P, K] → [P, K]; the calendar functions read the values as
    epoch seconds."""
    v = values
    if fn in _UNARY:
        return _UNARY[fn](v)
    if fn == "round":
        nearest = params[0] if params else 1.0
        return torch.round(v / nearest) * nearest
    if fn == "clamp_min":
        return torch.clamp(v, min=params[0])
    if fn == "clamp_max":
        return torch.clamp(v, max=params[0])
    if fn == "clamp":
        return torch.clamp(v, params[0], params[1])
    if fn == "sgn":
        return torch.where(torch.isnan(v), v, torch.sign(v))
    if fn in CALENDAR_FNS:
        days = _fdiv(v, 86400.0)
        secs_of_day = v - days * 86400.0
        if fn == "hour":
            return _fdiv(secs_of_day, 3600.0)
        if fn == "minute":
            return _fdiv(torch.remainder(secs_of_day, 3600.0), 60.0)
        if fn == "day_of_week":
            return torch.remainder(days + 4, 7)  # epoch day 0: Thursday
        y, m, d = _civil_from_epoch_days(_xla_int64(days))
        if fn == "year":
            return y.to(v.dtype)
        if fn == "month":
            return m.to(v.dtype)
        if fn == "day_of_month":
            return d.to(v.dtype)
        if fn == "days_in_month":
            return _days_in_month(y, m).to(v.dtype)
        return (days - _days_from_civil(y, 1, 1) + 1).to(v.dtype)
    raise ValueError(f"unknown instant function {fn}")


_COMPARISONS = {"==": torch.eq, "!=": torch.ne, ">": torch.gt,
                "<": torch.lt, ">=": torch.ge, "<=": torch.le}
COMPARISON_OPS = tuple(_COMPARISONS)
_ARITHMETIC = {"+": torch.add, "-": torch.sub, "*": torch.mul,
               "/": torch.div, "%": torch.fmod, "^": torch.pow,
               "atan2": torch.atan2}
BINARY_OPS = tuple(_ARITHMETIC) + COMPARISON_OPS


def apply_binary_op(op: str, lhs: torch.Tensor, rhs: torch.Tensor,
                    bool_mode: bool = False) -> torch.Tensor:
    """Arithmetic or comparison on aligned tensors. A comparison without
    ``bool`` keeps lhs where true and NaN where false; with ``bool`` it is
    1.0 / 0.0 (NaN where either side is NaN)."""
    if op in _ARITHMETIC:
        return _ARITHMETIC[op](lhs, rhs)
    if op not in _COMPARISONS:
        raise ValueError(f"unknown binary operator {op}")
    c = _COMPARISONS[op](lhs, rhs)
    both = ~torch.isnan(lhs) & ~torch.isnan(rhs)
    nan = torch.tensor(math.nan, dtype=lhs.dtype, device=lhs.device)
    if bool_mode:
        return torch.where(both, c.to(lhs.dtype), nan)
    return torch.where(c & both, lhs, nan)
