"""Wrappers of the hand-written window kernels B3 and B4, with their plain
versions beside them.

Counterpart of ``filodb_tpu/query/engine/pallas_kernels.py``:

- ``fused_decode_rate`` (B3, ``csrc/fused_rate.cu``) ↔
  ``fused_decode_rate_pallas``: packed device pages → per-series windowed
  rate / increase / delta, decode and counter correction inside the kernel;
- ``windowed_sum`` (B4, ``csrc/windowed_sum.cu``) ↔ ``windowed_sum_pallas``:
  sum over (t-w, t] for every series and step, 0.0 for an empty window.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel, or raises. Both kernels stream a series
through one warp and hold only the steps in flight in shared memory (see
``steps_in_flight``); that count is their one limit, and it takes any query
of up to 11,000 steps whatever its window.
"""

from __future__ import annotations

import torch

from filodb_tpu_torch import _build
from filodb_tpu_torch.device import KERNEL_DTYPE
from filodb_tpu_torch.memory.device_pages import BLOCK
from filodb_tpu_torch.query.engine.device_batch import decode_packed
from filodb_tpu_torch.query.engine.kernels import range_eval_masked

TS_PAD = 2**31 - 1
KINDS = {"rate": 0, "increase": 1, "delta": 2}
_WARP = 32  # a kernel takes a warp's 32 steps at a time: ring slots >= 32


def _check_packed(packed) -> None:
    if len(packed) != 9:
        raise ValueError("packed pages are 9 arrays (see pack_series_pages)")
    P, NB = packed[0].shape
    dev = packed[0].device
    for i, a in enumerate(packed):
        want = (P, NB, BLOCK) if i in (3, 7) else (P, NB)
        if a.dtype != torch.int32 or tuple(a.shape) != want:
            raise ValueError(f"packed[{i}] must be int32 {want}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError("packed arrays must be contiguous, on one device")


def _check_steps(steps: torch.Tensor, device: torch.device) -> None:
    if steps.dtype != torch.int32 or steps.dim() != 1 \
            or steps.device != device or not steps.is_contiguous():
        raise ValueError("steps must be contiguous int32 [K] on the data's "
                         "device")


def steps_in_flight(steps: torch.Tensor, window: int) -> int:
    """The most steps whose t falls in one interval [x, x + window): the
    windows a streaming kernel holds open at once. Raises ``ValueError``
    unless the steps are non-decreasing (one host sync)."""
    if steps.numel() == 0:
        return 0
    s = steps.to(torch.int64)
    ends = torch.searchsorted(s, s + int(window))
    most = (ends - torch.arange(s.numel(), device=s.device)).max()
    unsorted = (s[1:] < s[:-1]).any()
    most, unsorted = torch.stack([most, unsorted.to(torch.int64)]).tolist()
    if unsorted:
        raise ValueError("the window kernels take non-decreasing steps")
    return int(most)


def _ring_slots(lib: str, entry: str, steps: torch.Tensor, window: int,
                in_flight: int | None) -> int:
    """Slots of a kernel's per-warp ring of steps in flight, or
    ``ValueError`` past what one CTA's shared memory holds."""
    need = steps_in_flight(steps, window) if in_flight is None \
        else int(in_flight)
    limit = _build.constant(lib, f"{entry}_max_in_flight")
    if need > limit:
        raise ValueError(
            f"{need} steps in flight (steps whose t lies within one "
            f"{window} ms window) exceed the {entry} kernel's limit of "
            f"{limit}")
    return max(_WARP, need)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# ---------------------------------------------------------------------------
# B3: fused decode -> counter correction -> window


def fused_decode_rate_plain(packed, steps: torch.Tensor, window: int,
                            kind: str = "rate",
                            counter: bool = True) -> torch.Tensor:
    ts, vals, valid = decode_packed(packed, plain=True)
    return range_eval_masked(kind, ts, vals, valid, steps, window,
                             counter=counter, dtype=KERNEL_DTYPE)


def fused_decode_rate(packed, steps: torch.Tensor, window: int,
                      kind: str = "rate", counter: bool = True,
                      in_flight: int | None = None) -> torch.Tensor:
    """B3: packed [P, NB, ...] pages (int32 tensors, u32 bits where the
    reference has uint32) → f32 [P, K], NaN where a window holds < 2
    samples. ``counter`` turns on reset correction (rate and increase
    always correct, as the reference's kernels do). On the card the steps
    must be non-decreasing; ``in_flight`` is ``steps_in_flight(steps,
    window)`` where the caller has it from host steps, which saves the
    wrapper a host sync."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {tuple(KINDS)}")
    _check_packed(packed)
    dev = packed[0].device
    _check_steps(steps, dev)
    counter = counter or kind in ("rate", "increase")
    if dev.type == "cpu":
        return fused_decode_rate_plain(packed, steps, window, kind, counter)
    P, NB = packed[0].shape
    if not _aligned(packed[3], packed[7]):
        raise ValueError("packed word arrays must be 16-byte aligned")
    R = _ring_slots("fused_rate", "fused_decode_rate", steps, window,
                    in_flight)
    K = steps.shape[0]
    out = torch.empty((P, K), dtype=torch.float32, device=dev)
    fn = _build.bind("fused_rate", "fused_decode_rate", 19)
    # the launch and its cudaFuncSetAttribute act on the current device
    with torch.cuda.device(dev):
        _build.check("fused_rate", fn(
            *(a.data_ptr() for a in packed), steps.data_ptr(), K,
            int(window), P, NB, KINDS[kind], int(counter), R,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    _build.count("fused_decode_rate")
    return out


# ---------------------------------------------------------------------------
# B4: windowed sum


def windowed_sum_plain(ts: torch.Tensor, vals: torch.Tensor,
                       steps: torch.Tensor, window: int) -> torch.Tensor:
    """The kernel's algorithm in plain torch, adding each window's samples
    one at a time in sample order from 0.0 (the kernel's summation order)."""
    P, S = ts.shape
    key = torch.cummax(torch.where(ts == TS_PAD, -(2**31), ts), 1).values
    t = steps[None, :].expand(P, -1).contiguous()
    t0 = t - window
    lo = torch.searchsorted(key, t0, right=True)
    hi = torch.searchsorted(key, t, right=True)
    acc = torch.zeros((P, steps.shape[0]), dtype=torch.float32,
                      device=ts.device)
    span = int((hi - lo).max()) if acc.numel() else 0
    for j in range(span):
        idx = lo + j
        at = idx.clamp(max=S - 1)
        g_ts = torch.gather(ts, 1, at)
        take = (idx < hi) & (g_ts > t0) & (g_ts <= t)
        acc = torch.where(take, acc + torch.gather(vals, 1, at), acc)
    return acc


def windowed_sum(ts: torch.Tensor, vals: torch.Tensor, steps: torch.Tensor,
                 window: int, in_flight: int | None = None) -> torch.Tensor:
    """B4: ts int32 [P, S] (TS_PAD in padded lanes; the other timestamps
    non-decreasing along each row), vals f32 [P, S] → f32 [P, K], the sum
    over (t-w, t]; 0.0 for an empty window. Steps and ``in_flight`` as for
    ``fused_decode_rate``."""
    if ts.dtype != torch.int32 or vals.dtype != torch.float32 \
            or ts.dim() != 2 or ts.shape != vals.shape:
        raise ValueError("windowed_sum takes int32 ts and float32 vals of "
                         "one shape [P, S]")
    if ts.device != vals.device or not ts.is_contiguous() \
            or not vals.is_contiguous():
        raise ValueError("ts and vals must be contiguous, on one device")
    _check_steps(steps, ts.device)
    if ts.device.type == "cpu":
        return windowed_sum_plain(ts, vals, steps, window)
    P, S = ts.shape
    R = _ring_slots("windowed_sum", "windowed_sum", steps, window,
                    in_flight)
    vec = S % 4 == 0 and _aligned(ts, vals)
    K = steps.shape[0]
    out = torch.empty((P, K), dtype=torch.float32, device=ts.device)
    fn = _build.bind("windowed_sum", "windowed_sum", 11)
    # the launch and its cudaFuncSetAttribute act on the current device
    with torch.cuda.device(ts.device):
        _build.check("windowed_sum", fn(
            ts.data_ptr(), vals.data_ptr(), steps.data_ptr(), K,
            int(window), P, S, R, int(vec), out.data_ptr(),
            torch.cuda.current_stream(ts.device).cuda_stream))
    _build.count("windowed_sum")
    return out
