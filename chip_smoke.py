#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``filodb_tpu_torch`` end to end at a real deployment's size and
checks it, phase by phase; any failed phase exits non-zero:

1. build the four CUDA kernels from ``filodb_tpu_torch/csrc`` (nvcc, sm_90a);
2. ingest ``--series`` prom-counter series of ``http_requests_total``
   (labels ``_ws_``, ``_ns_`` over 100 namespaces, ``instance``, ``job``),
   ``--samples`` samples each at 10 s with ±500 ms scrape jitter, counter
   increments 0-19 and a reset in about 5 % of series, into 4 shards,
   spread 1, 400-sample chunks (``conf/server.json``);
3. the main path: launch counts set to 0, then ``QueryService.query_range``
   over the whole 2 h at a 60 s step for four queries (cold once, then warm
   repeats), counts read back; every kernel must have launched;
4. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it, with its time, its plain version's time,
   its bound and (for B4) a PyTorch yardstick; and the time of each part
   of one count_over_time decode chunk (B1, B2, ``assemble``'s glue, the
   pad select and cast, B4);
5. answers: the main results have the expected shape and finite values,
   agree with the plain path, and a small store answers the same on the
   card as on the CPU, for the four queries and one query of every other
   family the port serves (``FAMILY_QUERIES``);
6. long ranges: a second store of ``--long-series`` series with
   ``--long-samples`` samples each (48 h at 10 s, so NB = 256 blocks and
   S = 32,768 samples a series), queried over the 48 h at a 60 s step
   (K = 2,881) with ``sum(rate[5m]) by (_ns_)``, ``sum(count_over_time[5m])
   by (job)`` and ``increase[1h]``; B3 and B4 must launch, match their plain
   versions on the card, and the answers must agree with the plain path;
7. the rest of PromQL on the phase-2 store (not ingested again): launch
   counts set to 0, then ``PROMQL_QUERIES`` (instant selectors, min/max and
   stddev over time, topk, irate times a number, quantile_over_time, a
   one-to-one join) and ``MAPPED_QUERIES`` (aggregations over an operator
   or an instant function) cold once and warm three times, counts and peak
   device memory read back; B1/B2 and B3 must have launched; the answers'
   shapes, finiteness, the join against its two sides and each mapped
   query against its plain form are checked; max_over_time's and the
   instant selector's answers are held against plain decode plus the
   float64 function, with B1 and B2 bitwise against their plain versions
   on every chunk the engine cuts, and the join's two sides against B3's
   plain version; a warm time of every range function and the instant
   selector over one namespace (``PER_FUNCTION``); and the time of each
   part of one engine-sized decode chunk of max_over_time and of the
   instant selector (B1, B2, ``assemble``'s glue, the float64 function);
8. first-class histograms on a store of their own: ``--hist-series``
   ``prom-histogram`` series of ``http_req_latency`` (labels as phase 2's)
   with the 12 bucket bounds of Prometheus' ``DefBuckets`` and +Inf, 720
   samples at 10 s, per-scrape observations spread over the buckets and a
   reset of every bucket in about 5 % of series, and the series of
   App-0..App-9 again as ``le``-labelled prom-counter series on a second
   store; launch counts set to 0, then ``HIST_QUERIES`` (histogram_quantile
   over a per-bucket sum of rates, per series, a histogram matrix, over
   increase) and the flat form against its native twin, cold once and warm
   seven times (``HIST_WARM``: p50, min and max), counts and peak device
   memory read back; B1 and B3 must
   have launched; shapes, finite values and the ``le`` series of Prom JSON
   are checked, the flat answer must equal the native one (rtol 1e-5),
   and the first query must equal plain decode plus the float64 per-bucket
   rate, sum and quantile, with B1 bitwise against its plain version on
   the timestamp and bucket blocks of every chunk the engine cuts; a split
   of one engine-sized chunk (B1 on timestamps, B1 on buckets, the glue,
   the rate, the aggregation, the quantile), each part timed by CUDA
   events (median of 5 rounds) and by a ``torch.profiler`` trace's device
   time; and B1's time against its bound on a chunk's bucket blocks.

Its last two lines are a JSON object with the kernels' numbers and
``{"ok": true, "device": {...}}``. Run it from the repository root:
``python3 chip_smoke.py``. Without CUDA it exits with code 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
T0_MS = 1_700_000_000_000
LONG_QUERIES = (
    ("sum(rate(http_requests_total[5m])) by (_ns_)", "rate", 300_000),
    ("sum(count_over_time(http_requests_total[5m])) by (job)",
     "count_over_time", 300_000),
    ("increase(http_requests_total[1h])", "increase", 3_600_000),
)
QUERIES = (
    ("sum(rate(http_requests_total[5m])) by (_ns_)", "rate"),
    ("increase(http_requests_total[5m])", "increase"),
    ('avg(avg_over_time(http_requests_total{_ns_="App-0"}[2m]))',
     "avg_over_time"),
    ("sum(count_over_time(http_requests_total[5m])) by (job)",
     "count_over_time"),
)

M = "http_requests_total"
# one query of every family the port serves beyond QUERIES: each range
# function, the instant selector, each aggregation, instant functions,
# operators with a number, a join and the set operators
FAMILY_QUERIES = tuple(f"{fn}({M}[5m])" for fn in (
    "min_over_time", "max_over_time", "stddev_over_time", "stdvar_over_time",
    "zscore", "last_over_time", "present_over_time", "changes", "resets",
    "irate", "idelta", "deriv", "sum_over_time", "delta")) + (
    f"timestamp({M})", f"predict_linear({M}[5m], 600)",
    f"quantile_over_time(0.9, {M}[5m])", f"holt_winters({M}[5m], 0.5, 0.5)",
    M, f"{M} offset 5m", f"sum({M}) by (job)", f"group({M}) by (_ns_)",
    f"stddev(rate({M}[5m])) by (job)", f"stdvar(irate({M}[5m]))",
    f"topk(3, rate({M}[5m]))", f"bottomk(2, {M}) by (job)",
    f"quantile(0.9, rate({M}[5m])) by (job)",
    f"abs(deriv({M}[5m]))", f"month(timestamp({M}))", f"{M} % 7 > bool 3",
    f"2 ^ (irate({M}[5m]) / 2)",
    f"sum(rate({M}[5m])) by (_ns_) / on (_ns_) sum(rate({M}[5m] offset 1m)) "
    f"by (_ns_)",
    f"rate({M}[5m]) * on (job) group_left sum(rate({M}[5m])) by (job)",
    f"rate({M}[5m]) > 1 and on (job) {M}{{_ns_=\"App-1\"}}",
    f"irate({M}[5m]) > 1 or rate({M}[5m])",
    f"{M} unless {M} > 5000",
)
# every range function and the instant selector over one namespace's
# 10 k series (phase 7: a warm time for each new path)
_APP0 = f'{M}{{_ns_="App-0"}}'
PER_FUNCTION = {
    **{fn: f"{fn}({_APP0}[5m])" for fn in (
        "min_over_time", "max_over_time", "stddev_over_time",
        "stdvar_over_time", "zscore", "last_over_time", "present_over_time",
        "changes", "resets", "irate", "idelta", "deriv")},
    "predict_linear": f"predict_linear({_APP0}[5m], 600)",
    "quantile_over_time": f"quantile_over_time(0.5, {_APP0}[5m])",
    "holt_winters": f"holt_winters({_APP0}[5m], 0.5, 0.5)",
    "timestamp": f"timestamp({_APP0})",
    "instant selector": _APP0,
}
# the new phase's full-width queries (phase 7)
PROMQL_QUERIES = (
    f"sum({M}) by (job)",
    f'{M}{{_ns_="App-0"}}',
    f"max(max_over_time({M}[5m])) by (_ns_)",
    f"avg(stddev_over_time({M}[5m])) by (job)",
    f"topk(10, rate({M}[5m]))",
    f"sum(irate({M}[5m])) by (_ns_) * 60",
    f'quantile_over_time(0.9, {M}{{_ns_="App-0"}}[5m])',
    f'sum(rate({M}{{job="job-0"}}[5m])) by (_ns_) / sum(rate({M}[5m])) '
    f"by (_ns_)",
)
END_S = T0_MS // 1000 + 7200  # the end of the stores' 2 h
# the plan shapes of phase 9, at full width on the phase-2 store (and on
# phase 5's small store, card against CPU)
PLAN_SHAPES = (
    f'absent({M}{{job="none"}})',
    f"absent_over_time({_APP0}[5m])",
    f'count_values("r", round(rate({M}[5m])))',
    f"sort_desc(sum(rate({M}[5m])) by (_ns_))",
    f'label_replace(sum(rate({M}[5m])) by (job), "j", "$1", "job", '
    f'"job-(.*)")',
    f"limit(100, {_APP0})",
    f"{_APP0} * time()",
    f"scalar(sum(rate({M}[5m])))",
    "vector(1) + 1",
    f"sum(rate({M}[5m] @ {END_S})) by (_ns_)",
    f"max_over_time(sum(rate({M}[5m])) by (_ns_)[30m:1m])",
)
# instant queries of phase 9, at the end of the 2 h
INSTANT_QUERIES = (f"sum(rate({M}[5m])) by (_ns_)", _APP0)
# aggregations over an operator or an instant function (phase 7), each with
# the query it must equal times a factor: their group ids come from the
# leaf's cached keys, so a warm one costs about what its plain form does
MAPPED_QUERIES = (
    (f"sum(rate({M}[5m]) * 8) by (job)", f"sum(rate({M}[5m])) by (job)", 8.0),
    (f"sum(abs({M})) by (job)", PROMQL_QUERIES[0], 1.0),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_series(rng, a: int, b: int, samples: int,
                stale_every: int | None = None):
    """Series a..b-1: labels, jittered timestamps, counters with resets,
    and stale markers: in about 2 % of series (or in every
    ``stale_every``-th), one run of 3-6 NaN samples at a random place, a
    scrape target that vanished and came back."""
    n = b - a
    labels = [{"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": f"App-{i % 100}", "instance": f"instance-{i}",
               "job": f"job-{i % 10}"} for i in range(a, b)]
    ts = (T0_MS + np.arange(samples, dtype=np.int64)[None, :] * 10_000
          + rng.integers(-500, 501, (n, samples)))
    vals = np.cumsum(rng.integers(0, 20, (n, samples)), axis=1).astype(
        np.float64)
    reset = np.flatnonzero(rng.random(n) < 0.05)
    at = rng.integers(1, samples, len(reset))
    for r, k in zip(reset, at):
        vals[r, k:] -= vals[r, k]
    stale = np.flatnonzero(rng.random(n) < 0.02) if stale_every is None \
        else np.arange(0, n, stale_every)
    at = rng.integers(30, samples - 6, len(stale))  # after the first 5 min
    run = rng.integers(3, 7, len(stale))
    for r, k, m in zip(stale, at, run):
        vals[r, k : k + m] = np.nan
    return labels, ts, vals


def ingest(store, series: int, samples: int, seed: int,
           stale_every: int | None = None) -> int:
    rng = np.random.default_rng(seed)
    kept = 0
    step = 65536
    for a in range(0, series, step):
        kept += store.ingest_series(*make_series(
            rng, a, min(a + step, series), samples, stale_every))
    return kept


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_time_ms(fn, reps: int) -> float | None:
    """Mean device time of ``fn`` a call over ``reps`` calls, from a
    ``torch.profiler`` trace: the device time of every kernel and copy it
    launched, without the host's gaps between launches. None where the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0
             for e in prof.key_averages())
    return us / 1000.0 / reps if us > 0 else None


def split_times(parts: dict, reps: int, rounds: int) -> dict:
    """Per part of a split: the median over ``rounds`` of ``cuda_time_ms``
    (host launch gaps included), the spread of those rounds, and the
    profiler's device time."""
    out = {}
    for name, f in parts.items():
        ev = sorted(cuda_time_ms(f, reps) for _ in range(rounds))
        out[name] = {"events_ms": float(np.median(ev)),
                     "events_min_ms": ev[0], "events_max_ms": ev[-1],
                     "device_ms": device_time_ms(f, reps)}
    return out


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1000.0


def compare(got, want, rtol: float, atol: float, bitwise: bool = False):
    """(max_abs_err, ok): NaN positions must agree."""
    import torch

    if bitwise:
        a = got.contiguous().view(torch.int32)
        b = want.contiguous().view(torch.int32)
        diff = (got.double() - want.double()).abs()
        diff = diff[torch.isfinite(diff)]
        err = float(diff.max()) if diff.numel() else 0.0
        return err, bool(torch.equal(a, b))
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    both = ~nan_g & ~nan_w
    g, w = got[both].double(), want[both].double()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.equal(nan_g, nan_w)) and bool(
        ((g - w).abs() <= atol + rtol * w.abs()).all())
    return err, ok


# Operations each kernel does on its data, counted from the .cu bodies
# (loop control and address arithmetic left out). The card's table gives no
# integer rate, so integer operations are charged at the float32 rate.
# common.cuh unpack_field: w==0 test, lane*w, >>5, &31, wi+1 and its clamp
# (3), funnelshift, w>=32, 1<<w, -1, select, &.
UNPACK_OPS = 13
# common.cuh unpack_four, per lane (four fields): 4j*w, &31, four funnel
# shifts, 2w and 3w, field 0's & (1), field 1's shift and & (2), field 2's
# compare, subtract, three selects, shift and & (7), field 3's two
# compares, two subtracts, three selects, shift and & (9).
UNPACK_FOUR_OPS = 1 + 1 + 4 + 2 + 1 + 2 + 7 + 9
# decode_pages.cu, per lane of a block: the width mask (w==0, w>=32, 1<<w,
# -1, two selects), unpack_four, then per field B1: unzigzag (>>, &,
# negate, ^), slope*i, +; B2: <<, select, ^ first, and tz>=32 once.
WIDTH_MASK_OPS = 6
B1_OPS_BLOCK = 32 * (WIDTH_MASK_OPS + UNPACK_FOUR_OPS + 4 * 6)
B2_OPS_BLOCK = 32 * (WIDTH_MASK_OPS + UNPACK_FOUR_OPS + 1 + 4 * 3)
# fused_rate.cu, per sample: valid test, two unpacks, unzigzag (4),
# base+slope*lane+resid (3), float decode (4), four selects, scans at eight
# operations a sample, counter correction (5) and v+cv. (This is the count
# of the kernel that held a series in one CTA with four scans; the
# streaming kernel's two warp scans and carries do no fewer, so it stays.)
B3_OPS_SAMPLE = 1 + 2 * UNPACK_OPS + 4 + 3 + 4 + 4 + 4 * 2 + 6
# per step: t-w, window count from the two ordinals (2), extrapolatedRate
# (34), plus 5 an iteration of each of the two binary searches, which run
# over the 128 keys of the block the stream is in.
B3_OPS_STEP = 1 + 2 + 34
# windowed_sum.cu: per sample the pad test and select and the scan (2);
# per step t-w and the two searches over one 128-sample chunk; per window
# sample one +, since a sorted chunk's samples in [lo, hi) skip the mask
# (this run's timestamps are sorted; an unsorted chunk adds two compares
# and an &&).
B4_OPS_SAMPLE, B4_OPS_STEP, B4_OPS_WINDOW_SAMPLE = 4, 1, 1
SEARCH_OPS = 5
SEARCH_KEYS = 128  # keys a binary search of B3 and B4 runs over


def search_iters(S: int) -> int:
    """Iterations of common.cuh upper_bound over S keys."""
    return S.bit_length()


def word_bytes(widths) -> int:
    """Bytes of packed words the blocks' widths need: 4*w words a block."""
    return 16 * int(widths.long().sum())


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_cases(part) -> tuple:
    """B1 and B2 on one decode chunk of packed rows, as ``assemble`` calls
    them: (name, TPU kernel replaced, kernel, plain version, bytes,
    operations) each. Bytes are the per-block scalars, the words the widths
    need and the output."""
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.query.engine.device_batch import BLOCK

    sl, tw = part[1].reshape(-1), part[2].reshape(-1)
    tw_words = part[3].reshape(-1, BLOCK)
    vf, vs, vw = (part[i].reshape(-1) for i in (4, 5, 6))
    vw_words = part[7].reshape(-1, BLOCK)
    nb = tw.numel()
    return (
        ("decode_ts_page", "filodb_tpu/memory/device_pages.py:262",
         lambda: dp.decode_ts_blocks(sl, tw, tw_words),
         lambda: dp.decode_ts_blocks_plain(sl, tw, tw_words),
         nb * (8 + 512) + word_bytes(tw), nb * B1_OPS_BLOCK),
        ("decode_f32_page", "filodb_tpu/memory/device_pages.py:307",
         lambda: dp.decode_f32_blocks(vf, vs, vw, vw_words),
         lambda: dp.decode_f32_blocks_plain(vf, vs, vw, vw_words),
         nb * (12 + 512) + word_bytes(vw), nb * B2_OPS_BLOCK),
    )


def over_time_split(part, range_len: int, steps, window: int, flight: int,
                    reps: int) -> dict:
    """CUDA-event ms of each part of one count_over_time decode chunk, in
    the order ``mesh_engine`` runs them, and of the whole chunk."""
    import torch

    from filodb_tpu_torch.query.engine import cuda_kernels as ck
    from filodb_tpu_torch.query.engine.device_batch import fill_gaps

    (_, _, b1, *_), (_, _, b2, *_) = decode_cases(part)
    nan = torch.tensor(float("nan"), device=part[0].device)

    def glue(off, vals):  # assemble after B1/B2: base add, validity,
        ts, _, valid = fill_gaps(part[0], part[8], off, vals)  # cummax
        return ts, valid & (ts >= 0) & (ts <= range_len)  # and range

    def pad_cast(ts, valid):
        return (torch.where(valid, ts, ck.TS_PAD).contiguous(),
                valid.to(torch.float32))

    def b4(ts, ones):
        return ck.windowed_sum(ts, ones, steps, window, flight)

    def nan_select(cnt):
        return torch.where(cnt > 0, cnt, nan)

    off, vals = b1(), b2()
    ts, valid = glue(off, vals)
    padded, ones = pad_cast(ts, valid)
    cnt = b4(padded, ones)
    parts = {"B1": b1, "B2": b2,
             "assemble_glue": lambda: glue(off, vals),
             "pad_cast": lambda: pad_cast(ts, valid),
             "B4": lambda: b4(padded, ones),
             "nan_select": lambda: nan_select(cnt)}
    out = {k: cuda_time_ms(f, reps) for k, f in parts.items()}
    out["sum_of_parts"] = sum(out.values())
    out["chunk"] = cuda_time_ms(
        lambda: nan_select(b4(*pad_cast(*glue(b1(), b2())))), reps)
    out["rows"], out["S"] = int(ts.shape[0]), int(ts.shape[1])
    return out


def check_kernels(svc, reps: int) -> list[dict]:
    """Phase 4: each kernel at the main path's shapes, against its plain
    version on the same inputs."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.parallel.mesh_engine import decode_rows
    from filodb_tpu_torch.query.engine import cuda_kernels as ck
    from filodb_tpu_torch.query.engine.device_batch import (
        BLOCK,
        assemble,
    )

    eng = svc.engine
    big = max(eng._batches.values(), key=lambda b: len(b.keys))
    packed = big.packed
    P, NB = packed[0].shape
    n_series = len(big.keys)
    K = 121
    steps = torch.arange(300_000, 300_000 + K * 60_000, 60_000,
                         dtype=torch.int32, device=svc.device)
    window = 300_000
    flight = ck.steps_in_flight(steps.cpu(), window)  # as the engine does
    saved = dict(_build.LAUNCHES)
    out = []

    # B1 / B2 on one decode chunk of the B4 path, as assemble calls them
    rows = min(decode_rows(NB * BLOCK), n_series)
    part = tuple(t[:rows] for t in packed)
    nb = rows * NB
    for name, repl, run, plain, nbytes, ops in decode_cases(part):
        got, want = run(), plain()
        err, ok = compare(got, want, 0, 0, bitwise=True)
        if not ok:
            raise AssertionError(f"{name} differs from its plain version")
        b, by = bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda",
                        source="filodb_tpu_torch/csrc/decode_pages.cu",
                        replaces=repl, shape=f"{nb} blocks",
                        tolerance="bitwise", max_abs_err=err,
                        ms=cuda_time_ms(run, reps),
                        plain_ms=wall_ms(plain), bound_ms=b, bound_by=by,
                        library_ms=None, bound_bytes=nbytes, bound_ops=ops))
        log(f"  {name}: {nb} blocks bitwise equal to plain")

    # B3 on the whole batch of the rate query
    got = ck.fused_decode_rate(packed, steps, window, "rate", True)
    want = plain_b3(packed, steps, window, "rate")
    err, ok = compare(got, want, 1e-6, 1e-6)
    if not ok:
        raise AssertionError(f"fused_decode_rate off by {err}")
    # bytes: the seven per-block scalar arrays, the words the ts and value
    # widths need, the steps and the output; operations on valid samples
    nbytes = (sum(packed[i].numel() * 4 for i in (0, 1, 2, 4, 5, 6, 8))
              + word_bytes(packed[2]) + word_bytes(packed[6])
              + K * 4 + P * K * 4)
    ops = (int(packed[8].long().sum()) * B3_OPS_SAMPLE
           + P * K * (B3_OPS_STEP
                      + 2 * SEARCH_OPS * search_iters(SEARCH_KEYS)))
    b, by = bound_ms(nbytes, ops)
    out.append(dict(
        name="fused_decode_rate", route="cuda",
        source="filodb_tpu_torch/csrc/fused_rate.cu",
        replaces="filodb_tpu/query/engine/pallas_kernels.py:231",
        shape=f"P={P} NB={NB} K={K}", tolerance="rtol 1e-6, atol 1e-6",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ck.fused_decode_rate(
            packed, steps, window, "rate", True, flight), reps),
        plain_ms=wall_ms(lambda: plain_b3(packed, steps, window, "rate")),
        bound_ms=b, bound_by=by, library_ms=None, bound_bytes=nbytes,
        bound_ops=ops))
    log(f"  fused_decode_rate: P={P} NB={NB} K={K}, max abs err {err:g} "
        f"(tolerance rtol 1e-6 atol 1e-6)")
    rate_plain = want[:n_series]

    # B4 on one decode chunk, as the avg/count_over_time leaves call it
    ts, vals, valid = assemble(part, 7_500_000)
    ts = torch.where(valid, ts, ck.TS_PAD).contiguous()
    v0 = torch.where(valid, vals, 0.0).contiguous()
    got = ck.windowed_sum(ts, v0, steps, window)
    want = ck.windowed_sum_plain(ts, v0, steps, window)
    err, ok = compare(got, want, 0, 0, bitwise=True)
    if not ok:
        raise AssertionError("windowed_sum differs from its plain version")

    def window_bounds():
        key = torch.cummax(torch.where(ts == ck.TS_PAD, -(2**31), ts),
                           1).values
        t = steps[None, :].expand(rows, -1).contiguous()
        return (torch.searchsorted(key, t - window, right=True),
                torch.searchsorted(key, t, right=True))

    def library():
        # nearest PyTorch yardstick: prefix sums + searchsorted + gathers
        csum = torch.nn.functional.pad(torch.cumsum(v0, 1), (1, 0))
        lo, hi = window_bounds()
        return csum.gather(1, hi) - csum.gather(1, lo)

    S = ts.shape[1]
    lo, hi = window_bounds()
    nbytes = rows * S * 8 + K * 4 + rows * K * 4
    ops = (rows * S * B4_OPS_SAMPLE
           + rows * K * (B4_OPS_STEP
                         + 2 * SEARCH_OPS * search_iters(SEARCH_KEYS))
           + int((hi - lo).sum()) * B4_OPS_WINDOW_SAMPLE)
    b, by = bound_ms(nbytes, ops)
    out.append(dict(
        name="windowed_sum", route="cuda",
        source="filodb_tpu_torch/csrc/windowed_sum.cu",
        replaces="filodb_tpu/query/engine/pallas_kernels.py:49",
        shape=f"P={rows} S={S} K={K}", tolerance="bitwise (same order)",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ck.windowed_sum(ts, v0, steps, window,
                                                flight), reps),
        plain_ms=wall_ms(lambda: ck.windowed_sum_plain(ts, v0, steps,
                                                       window)),
        bound_ms=b, bound_by=by, library_ms=cuda_time_ms(library, reps),
        library_call="cumsum + cummax + searchsorted + gather",
        bound_bytes=nbytes, bound_ops=ops))
    log(f"  windowed_sum: P={rows} S={S} K={K} bitwise equal to plain")
    split = over_time_split(part, 7_500_000, steps, window, flight, reps)
    log(f"  over_time chunk split (ms, CUDA events): {json.dumps(split)}")
    _build.LAUNCHES.update(saved)  # comparison launches are not counted
    return out, rate_plain


def plain_b3(packed, steps, window: int, kind: str):
    """B3's plain version over a batch, in row chunks of 2^26 samples."""
    import torch

    from filodb_tpu_torch.query.engine import cuda_kernels as ck

    P, NB = packed[0].shape
    rows = max(1, 2**26 // (NB * 128))
    return torch.cat([ck.fused_decode_rate_plain(
        tuple(t[a : a + rows] for t in packed), steps, window, kind, True)
        for a in range(0, P, rows)])


def lowered(eng, q: str, start: int, end: int):
    """(the lowered leaf of query ``q``, the engine's aggregation above it
    or None), as the engine ``eng`` evaluates them."""
    from filodb_tpu_torch.parallel.mesh_engine import lower_plan
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query import logical as lp

    plan = parse_query(q, TimeStepParams(start, 60, end))
    if not isinstance(plan, lp.Aggregate):
        return lower_plan(plan), None
    return lower_plan(plan.vector), eng._aggregation(plan)


def leaf_steps(low):
    """A lowered leaf's steps as the engine hands them to the card: int32
    ms relative to the start of its data range, on the host."""
    import torch

    from filodb_tpu_torch.query.exec.transformers import steps_array

    rel = steps_array(low.start, low.step, low.end) - low.offset \
        - low.chunk_range[0]
    return torch.from_numpy(rel.astype(np.int32))


def agrees_with_plain(svc, q: str, start: int, end: int, got,
                      per_series) -> bool:
    """A query's answer against the plain per-series results [n, K],
    aggregated as the engine aggregates them."""
    from filodb_tpu_torch.query.engine.aggregations import aggregate

    eng = svc.engine
    low, amr = lowered(eng, q, start, end)
    batch = eng._batch(svc.memstore, low)
    leaf_keys = batch.keys if low.keep_metric else batch.out_keys
    if amr is None:
        want, keys = per_series.cpu().double().numpy(), leaf_keys
    else:
        gids, keys = eng._group_ids(leaf_keys, amr)
        want = aggregate(amr.op, per_series, gids, len(keys)).cpu().numpy()
    order = {str(k): i for i, k in enumerate(keys)}
    idx = [order[str(k)] for k in got.keys]
    return got.values.shape[1] == want.shape[1] and np.allclose(
        got.values, want[idx], rtol=1e-5, atol=1e-6, equal_nan=True)


def long_range(dev, args, reps: int) -> dict:
    """Phase 6: 48 h series through B3 and B4 (NB = 256, K = 2,881)."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.parallel.mesh_engine import decode_rows
    from filodb_tpu_torch.query.engine import cuda_kernels as ck
    from filodb_tpu_torch.query.engine.device_batch import BLOCK, assemble

    t = t_phase = time.perf_counter()
    store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    kept = ingest(store, args.long_series, args.long_samples, args.seed + 2)
    log(f"phase 6: long ranges: {args.long_series} series x "
        f"{args.long_samples} samples ({kept} samples), ingest "
        f"{time.perf_counter() - t:.1f} s on the host")
    svc = QueryService(store, device=dev)
    start = T0_MS // 1000
    end = start + args.long_samples * 10
    _build.reset_counts()
    results = {}
    for q, _, _ in LONG_QUERIES:
        t = time.perf_counter()
        results[q] = svc.query_range(q, start, 60, end)
        cold = (time.perf_counter() - t) * 1000.0
        t = time.perf_counter()
        r = svc.query_range(q, start, 60, end)
        warm = (time.perf_counter() - t) * 1000.0
        log(f"  {q}: cold {cold:.1f} ms, warm {warm:.2f} ms, "
            f"{r.result.num_series} x {r.result.num_steps}")
    launches = dict(_build.LAUNCHES)
    log(f"  launches in the phase: {launches}")
    if dev.type == "cuda" and not (launches["fused_decode_rate"]
                                   and launches["windowed_sum"]):
        raise AssertionError("long ranges did not run through B3 and B4")

    eng = svc.engine
    steps_ms = np.arange(start * 1000, end * 1000 + 1, 60_000)
    K = len(steps_ms)
    out = {"series": args.long_series, "samples": args.long_samples,
           "K": K, "kernels": []}
    for q, fn, w in LONG_QUERIES:
        low, _ = lowered(eng, q, start, end)
        batch = eng._batch(store, low)
        packed = batch.packed
        P, NB = packed[0].shape
        n = len(batch.keys)
        host = torch.from_numpy((steps_ms - low.chunk_range[0]).astype(
            np.int32))
        flight = ck.steps_in_flight(host, w)
        steps = host.to(dev)
        if fn in ("rate", "increase"):
            def run():
                return ck.fused_decode_rate(packed, steps, w, fn, True,
                                            flight)
            got, want = run(), plain_b3(packed, steps, w, fn)
            err, ok = compare(got, want, 1e-6, 1e-6)
            per_series = want[:n]
            name, shape, tol = ("fused_decode_rate", f"P={P} NB={NB} K={K}",
                                "rtol 1e-6, atol 1e-6")
        else:
            rows = min(decode_rows(NB * BLOCK), n)
            cnts, ok, err = [], True, 0.0
            for a in range(0, n, rows):
                ts, vals, valid = assemble(tuple(t[a : a + rows]
                                                 for t in packed),
                                           low.chunk_range[1]
                                           - low.chunk_range[0])
                ts = torch.where(valid, ts, ck.TS_PAD).contiguous()
                ones = valid.to(torch.float32)
                got = ck.windowed_sum(ts, ones, steps, w)
                want = ck.windowed_sum_plain(ts, ones, steps, w)
                e, same = compare(got, want, 0, 0, bitwise=True)
                ok, err = ok and same, max(err, e)
                cnts.append(torch.where(want > 0, want, float("nan")))
                if a == 0:
                    def run(ts=ts, ones=ones):
                        return ck.windowed_sum(ts, ones, steps, w, flight)
                    shape = f"P={ts.shape[0]} S={ts.shape[1]} K={K}"
            per_series = torch.cat(cnts)
            name, tol = "windowed_sum", "bitwise (same order)"
        if not ok:
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"{q} (max abs err {err})")
        if not agrees_with_plain(svc, q, start, end, results[q].result,
                                 per_series):
            raise AssertionError(f"{q} disagrees with the plain path")
        ms = cuda_time_ms(run, reps)
        out["kernels"].append(dict(name=name, query=q, shape=shape,
                                   tolerance=tol, max_abs_err=err, ms=ms))
        log(f"  {name} on {q}: {shape}, {ms:.4f} ms, max abs err {err:g} "
            f"({tol}); answer equal to the plain path")
    _build.LAUNCHES.update(launches)  # comparison launches are not counted
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 6 took {out['seconds']:.1f} s")
    return out


def small_store_check(seed: int, dev) -> None:
    """The same small store answers the same on the card and on the CPU."""
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.core.memstore.memstore import MemStore

    store = MemStore(4, 1, 400)
    ingest(store, 256, 720, seed + 1, stale_every=2)
    gpu, cpu = QueryService(store, dev), QueryService(store, device="cpu")
    queries = [q for q, _ in QUERIES] + list(FAMILY_QUERIES) \
        + list(PLAN_SHAPES)
    for q in queries:
        a = gpu.query_range(q, T0_MS // 1000, 60, END_S)
        b = cpu.query_range(q, T0_MS // 1000, 60, END_S)
        ka = [str(k) for k in a.result.keys]
        kb = [str(k) for k in b.result.keys]
        if ka != kb or not np.allclose(a.result.values, b.result.values,
                                       rtol=2e-5, atol=1e-6,
                                       equal_nan=True):
            raise AssertionError(f"card and CPU disagree on {q}")
    log(f"  small store (stale markers in every other series): card and "
        f"CPU answers agree on {len(queries)} queries (rtol 2e-5, atol "
        f"1e-6)")


def decoded_against_plain(svc, q: str, start: int, end: int, got) -> dict:
    """Query ``q`` (an aggregation of one leaf that runs in float64 on
    decoded rows) against the plain path, chunk by chunk as the engine
    cuts its batch (``decode_rows``, the last chunk short): B1 and B2 must
    equal their plain versions bit for bit on every chunk, and the answer
    must equal plain decode plus the float64 function, aggregated as the
    engine aggregates."""
    import torch

    from filodb_tpu_torch.device import EXACT_DTYPE
    from filodb_tpu_torch.parallel.mesh_engine import decode_rows
    from filodb_tpu_torch.query.engine.device_batch import BLOCK, fill_gaps
    from filodb_tpu_torch.query.engine.kernels import range_eval_masked

    low, _ = lowered(svc.engine, q, start, end)
    batch = svc.engine._batch(svc.memstore, low)
    n = len(batch.keys)
    rows = min(decode_rows(batch.packed[0].shape[1] * BLOCK, low.fn), n)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    outs = []
    for a in range(0, n, rows):
        part = tuple(t[a : min(a + rows, n)] for t in batch.packed)
        (n1, _, b1, p1, *_), (n2, _, b2, p2, *_) = decode_cases(part)
        off, vals = p1(), p2()
        for name, run, want in ((n1, b1, off), (n2, b2, vals)):
            if not compare(run(), want, 0, 0, bitwise=True)[1]:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"on rows {a}.. of {q}")
        ts, v, valid = fill_gaps(part[0], part[8], off, vals)
        valid = valid & (ts >= 0) & (ts <= hi_ms - lo_ms)
        outs.append(range_eval_masked(low.fn, ts, v, valid, steps,
                                      low.window, dtype=EXACT_DTYPE))
    if not agrees_with_plain(svc, q, start, end, got, torch.cat(outs)):
        raise AssertionError(f"{q} disagrees with plain decode and the "
                             f"float64 function")
    chunks = -(-n // rows)
    return {"series": n, "rows": rows, "chunks": chunks,
            "last_rows": n - (chunks - 1) * rows}


def rate_against_plain(svc, q: str, start: int, end: int, got) -> dict:
    """Query ``q`` (an aggregation of one rate leaf) against the plain path:
    B3 must match its plain version on the leaf's batch, and the answer the
    plain rates aggregated as the engine aggregates."""
    from filodb_tpu_torch.query.engine import cuda_kernels as ck

    low, _ = lowered(svc.engine, q, start, end)
    batch = svc.engine._batch(svc.memstore, low)
    host = leaf_steps(low)
    steps = host.to(svc.device)
    got_b3 = ck.fused_decode_rate(batch.packed, steps, low.window, low.fn,
                                  True, ck.steps_in_flight(host, low.window))
    want = plain_b3(batch.packed, steps, low.window, low.fn)
    err, ok = compare(got_b3, want, 1e-6, 1e-6)
    if not ok:
        raise AssertionError(f"fused_decode_rate off by {err} on {q}")
    if not agrees_with_plain(svc, q, start, end, got, want[:len(batch.keys)]):
        raise AssertionError(f"{q} disagrees with the plain path")
    P, NB = batch.packed[0].shape
    return {"shape": f"P={P} NB={NB} K={steps.numel()}", "max_abs_err": err}


def decoded_split(svc, low, rows: int, reps: int) -> dict:
    """CUDA-event ms of each part of one decode chunk of ``rows`` series
    of a lowered leaf that runs in float64 on decoded rows: B1, B2,
    ``assemble``'s glue, the function, and the whole chunk."""
    from filodb_tpu_torch.parallel.mesh_engine import _decoded_fn
    from filodb_tpu_torch.query.engine.device_batch import fill_gaps

    batch = svc.engine._batch(svc.memstore, low)
    part = tuple(t[:rows] for t in batch.packed)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    (_, _, b1, *_), (_, _, b2, *_) = decode_cases(part)

    def glue(off, vals):
        ts, v, valid = fill_gaps(part[0], part[8], off, vals)
        return ts, v, valid & (ts >= 0) & (ts <= hi_ms - lo_ms)

    def fn(ts, v, valid):
        return _decoded_fn(low, ts, v, valid, steps, 0)

    off, vals = b1(), b2()
    decoded = glue(off, vals)
    parts = {"B1": b1, "B2": b2, "assemble_glue": lambda: glue(off, vals),
             low.fn: lambda: fn(*decoded)}
    out = {k: cuda_time_ms(f, reps) for k, f in parts.items()}
    out["sum_of_parts"] = sum(out.values())
    out["chunk"] = cuda_time_ms(lambda: fn(*glue(b1(), b2())), reps)
    out["rows"], out["S"] = int(part[0].shape[0]), int(decoded[0].shape[1])
    return out


def promql_phase(svc, args) -> dict:
    """Phase 7: the rest of PromQL on the phase-2 store, at full width."""
    import torch

    from filodb_tpu_torch import _build

    t_phase = time.perf_counter()
    start, end = T0_MS // 1000, T0_MS // 1000 + 7200
    log("phase 7: the rest of PromQL on the phase-2 store (query_range, "
        "2 h at 60 s):")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    results, timings = {}, []
    for q in PROMQL_QUERIES + tuple(m for m, _, _ in MAPPED_QUERIES):
        t = time.perf_counter()
        r = svc.query_range(q, start, 60, end)
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            r = svc.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        results[q] = r.result
        timings.append(dict(query=q, cold_ms=cold,
                            warm_p50_ms=float(np.median(warm)),
                            rows=r.result.num_series))
        log(f"  {q}: cold {cold:.1f} ms, warm p50 {np.median(warm):.2f} "
            f"ms, {r.result.num_series} rows")
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the phase: {launches}; peak device memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated)")
    if svc.device.type == "cuda" and not (
            launches["decode_ts_page"] and launches["decode_f32_page"]
            and launches["fused_decode_rate"]):
        raise AssertionError("phase 7 did not run through B1/B2 and B3")

    # answers: shapes, finite where data exist, the join against its sides
    n_ns, n_job = min(100, args.series), min(10, args.series)
    app0 = len(range(0, args.series, 100))
    want_shape = {PROMQL_QUERIES[0]: (n_job, 121),
                  PROMQL_QUERIES[1]: (app0, 121),
                  PROMQL_QUERIES[2]: (n_ns, 121),
                  PROMQL_QUERIES[3]: (n_job, 121),
                  PROMQL_QUERIES[5]: (n_ns, 121),
                  PROMQL_QUERIES[6]: (app0, 121)}
    for q, shape in want_shape.items():
        v = results[q].values
        if v.shape != shape or not np.isfinite(v[:, 1:]).all():
            raise AssertionError(f"{q}: shape {v.shape}, want {shape}, "
                                 f"finite after the first step")
    if not all(dict(k.labels).get("_metric_") == M
               for k in results[PROMQL_QUERIES[1]].keys):
        raise AssertionError("the bare selector lost its metric label")
    top = results[PROMQL_QUERIES[4]].values
    if not (np.isfinite(top[:, 1:]).sum(0) == min(10, args.series)).all():
        raise AssertionError("topk(10) does not give 10 series a step")
    q8 = PROMQL_QUERIES[7]
    lhs_q, rhs_q = q8.split(" / ")
    lhs = svc.query_range(lhs_q, start, 60, end).result
    rhs = svc.query_range(rhs_q, start, 60, end).result
    by_ns = {str(k): i for i, k in enumerate(rhs.keys)}
    quot = lhs.values / rhs.values[[by_ns[str(k)] for k in lhs.keys]]
    got = results[q8]
    order = {str(k): i for i, k in enumerate(got.keys)}
    if sorted(order) != sorted(str(k) for k in lhs.keys) \
            or len(order) != min(10, args.series) \
            or not np.allclose(got.values[[order[str(k)] for k in lhs.keys]],
                               quot, rtol=1e-12, atol=0, equal_nan=True):
        raise AssertionError("the join differs from the quotient of its "
                             "sides")
    for q, base, factor in MAPPED_QUERIES:
        base_r = svc.query_range(base, start, 60, end).result
        if [str(k) for k in results[q].keys] != [str(k) for k in base_r.keys] \
                or not np.allclose(results[q].values, factor * base_r.values,
                                   rtol=1e-12, atol=0, equal_nan=True):
            raise AssertionError(f"{q} differs from {factor} x {base}")
    log(f"  answers: shapes, finite values, topk's 10 a step, the bare "
        f"selector's metric label, the join ({len(order)} namespaces, "
        f"equal to its sides' quotient) and the aggregations over an "
        f"operator or function (equal to their plain forms) checked")

    # against the plain path at the shapes the engine gave the kernels
    plain = {q: decoded_against_plain(svc, q, start, end, results[q])
             for q in (PROMQL_QUERIES[2], PROMQL_QUERIES[0])}
    for q, r in plain.items():
        log(f"  {q}: B1 and B2 bitwise equal to plain on {r['chunks']} "
            f"chunks of {r['rows']} rows (last {r['last_rows']}); answer "
            f"equal to plain decode + float64 function (rtol 1e-5)")
    for side, r in ((lhs_q, lhs), (rhs_q, rhs)):
        plain[side] = rate_against_plain(svc, side, start, end, r)
        log(f"  {side}: B3 at {plain[side]['shape']} max abs err "
            f"{plain[side]['max_abs_err']:g} (rtol 1e-6, atol 1e-6); answer "
            f"equal to the plain path (rtol 1e-5)")

    per_fn = {}
    for name, q in PER_FUNCTION.items():
        svc.query_range(q, start, 60, end)
        per_fn[name] = wall_ms(lambda: svc.query_range(q, start, 60, end))
    log(f"  warm ms a function over App-0's {app0} series: "
        f"{json.dumps(per_fn)}")

    splits = {}
    for q in (PROMQL_QUERIES[2], PROMQL_QUERIES[0]):
        low, _ = lowered(svc.engine, q, start, end)
        split = decoded_split(svc, low, plain[q]["rows"], reps=5)
        splits[low.fn] = split
        log(f"  {low.fn} chunk split at the engine's rows (ms, CUDA "
            f"events): {json.dumps(split)}")
    # the checks' and the split's launches are not counted
    _build.LAUNCHES.update(launches)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 7 took {seconds:.1f} s")
    return {"queries": timings, "launches": launches,
            "peak_bytes": int(peak), "plain_checks": plain,
            "per_function_ms": per_fn, "splits": splits, "seconds": seconds}


def plan_shapes_phase(svc, args) -> dict:
    """Phase 9: the plan shapes beside the leaves, instant queries and the
    metadata calls, on the phase-2 store at full width."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.http.promjson import scalar_json, vector_json
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query

    t_phase = time.perf_counter()
    start, end = T0_MS // 1000, END_S
    log("phase 9: plan shapes, instant queries and metadata on the phase-2 "
        "store:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    app0 = parse_query(_APP0, TimeStepParams(start, 0, end)).raw.filters
    calls = {q: (lambda q=q: svc.query_range(q, start, 60, end).result)
             for q in PLAN_SHAPES}
    calls.update({f"instant {q}": (lambda q=q: svc.query_instant(q, end))
                  for q in INSTANT_QUERIES})
    calls.update({"label_names()": svc.label_names,
                  'label_values("_ns_")': lambda: svc.label_values("_ns_"),
                  'label_values("instance")':
                      lambda: svc.label_values("instance"),
                  'series({_ns_="App-0"})':
                      lambda: svc.series(app0, start, end)})
    results, timings = {}, []
    for name, call in calls.items():
        t = time.perf_counter()
        results[name] = call()
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            results[name] = call()
            warm.append((time.perf_counter() - t) * 1000.0)
        timings.append(dict(query=name, cold_ms=cold,
                            warm_p50_ms=float(np.median(warm))))
        log(f"  {name}: cold {cold:.1f} ms, warm p50 "
            f"{np.median(warm):.2f} ms")
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the phase: {launches}; peak device memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated)")
    if svc.device.type == "cuda" and not (
            launches["decode_ts_page"] and launches["decode_f32_page"]
            and launches["fused_decode_rate"]):
        raise AssertionError("phase 9 did not run through B1/B2 and B3")

    # answers: shapes and finite values
    n_app0 = len(range(0, args.series, 100))
    n_ns, n_job = min(100, args.series), min(10, args.series)
    (absent, absent_ot, cvals, srt, lrep, lim, times, scal, vec, at,
     sub) = (results[q] for q in PLAN_SHAPES)

    def need(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 9: {what}")

    need(absent.values.shape == (1, 121) and (absent.values == 1).all()
         and absent.keys[0].labels == (("job", "none"),), "absent")
    need(absent_ot.num_series == 0, "absent_over_time of a present series")
    count = svc.query_range(f"count(round(rate({M}[5m])))", start, 60,
                            end).result.values[0]
    need(np.array_equal(np.nansum(cvals.values, 0)[1:], count[1:])
         and all(dict(k.labels)["r"].lstrip("-").isdigit()
                 for k in cvals.keys), "count_values against count")
    last = srt.values[:, -1]
    need(srt.values.shape == (n_ns, 121) and (np.diff(last) <= 0).all(),
         "sort_desc order")
    need(lrep.values.shape == (n_job, 121) and all(
        dict(k.labels)["j"] == dict(k.labels)["job"][4:] for k in lrep.keys),
        "label_replace")
    need(lim.values.shape == (min(100, n_app0), 121), "limit")
    plain = svc.query_range(_APP0, start, 60, end).result
    need([str(k) for k in times.keys] == [str(k.drop_metric())
                                          for k in plain.keys]
         and np.allclose(times.values, plain.values * (
             np.arange(start, end + 1, 60.0)[None, :]), rtol=1e-12,
             equal_nan=True) and np.isfinite(times.values[:, 1:]).all(),
         "an instant selector times time()")
    need(scal.values.shape == (1, 121) and np.isfinite(scal.values[0, 1:])
         .all(), "scalar()")
    need((vec.values == 2).all() and vec.values.shape == (1, 121),
         "vector(1) + 1")
    rng_q = svc.query_range(f"sum(rate({M}[5m])) by (_ns_)", start, 60,
                            end).result
    col = {str(k): rng_q.values[i, -1] for i, k in enumerate(rng_q.keys)}
    want_at = np.array([col[str(k)] for k in at.keys])[:, None]
    need(at.values.shape == (n_ns, 121) and np.allclose(
        at.values, want_at, rtol=1e-6, atol=1e-9), "@ against the range "
         "query's column at the end")
    # the subquery against the float64 function over the inner matrix
    inner_start = (start * 1000 - 1_800_000) // 60_000 * 60_000
    inner = svc.query_range(f"sum(rate({M}[5m])) by (_ns_)",
                            inner_start // 1000, 60, end).result
    steps = np.arange(start, end + 1, 60) * 1000
    in_win = (inner.steps_ms[None, :] > steps[:, None] - 1_800_000) \
        & (inner.steps_ms[None, :] <= steps[:, None])
    vals = np.where(np.isnan(inner.values), -np.inf, inner.values)
    want = np.where(in_win[None], vals[:, None, :], -np.inf).max(2)
    want[want == -np.inf] = np.nan
    order = {str(k): i for i, k in enumerate(inner.keys)}
    want = want[[order[str(k)] for k in sub.keys]]
    need(sub.values.shape == (n_ns, 121)
         and np.isfinite(sub.values[:, 1:]).all()
         and np.allclose(sub.values, want, rtol=1e-12, atol=0,
                         equal_nan=True),
         "the subquery against the float64 max over its inner matrix")
    inst_agg, inst_sel = (results[f"instant {q}"] for q in INSTANT_QUERIES)
    body = vector_json(inst_agg)
    need(inst_agg.result.values.shape == (n_ns, 1)
         and len(body["data"]["result"]) == n_ns and np.allclose(
             inst_agg.result.values[:, 0],
             [col[str(k)] for k in inst_agg.result.keys], rtol=1e-6),
         "instant sum(rate) against the range query's last step")
    need(inst_sel.result.values.shape == (n_app0, 1)
         and np.isfinite(inst_sel.result.values).all(), "instant selector")
    need(scalar_json(svc.query_instant("time()", end))["data"]["result"]
         == [float(end), repr(float(end))], "scalar_json of time()")
    need(results["label_names()"] == ["_metric_", "_ns_", "_ws_",
                                      "instance", "job"], "label_names")
    need(len(results['label_values("_ns_")']) == n_ns, "label_values(_ns_)")
    n_inst = len(results['label_values("instance")'])
    need(n_inst == args.series, "label_values(instance)")
    need(len(results['series({_ns_="App-0"})']) == n_app0, "series")
    log(f"  answers: absent, count_values (its counts summing to count()), "
        f"sort_desc's order, label_replace, limit, time(), scalar, vector, "
        f"@ (equal to the range query's column at the end, rtol 1e-6), the "
        f"subquery (equal to the float64 max over its inner matrix, rtol "
        f"1e-12), the instant queries and the metadata ({n_inst} "
        f"instances) checked")
    _build.LAUNCHES.update(launches)  # the checks' launches are not counted
    seconds = time.perf_counter() - t_phase
    log(f"  phase 9 took {seconds:.1f} s")
    return {"queries": timings, "launches": launches,
            "peak_bytes": int(peak), "seconds": seconds}


# phase 8: first-class histograms. Bucket bounds: Prometheus client_golang's
# DefBuckets (seconds) and +Inf; per-scrape observations a bucket are drawn
# uniformly from 0 to ``_OBS_HIGH``, a latency distribution peaking at
# 100-250 ms.
DEF_BUCKETS = np.array([0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                        5.0, 10.0, np.inf])
_OBS_HIGH = np.array([1, 1, 2, 3, 5, 8, 5, 3, 2, 1, 1, 1])
H = "http_req_latency"
HIST_QUERIES = (
    f"histogram_quantile(0.99, sum(rate({H}[5m])) by (_ns_))",
    f'histogram_quantile(0.9, rate({H}{{_ns_="App-0"}}[5m]))',
    f"sum(rate({H}[5m])) by (job)",
    f"histogram_quantile(0.5, sum(increase({H}[10m])) by (job))",
)
# the flat form: the series of App-0..App-9 again as prom-counter bucket
# series with an ``le`` label, and the native query over the same ones
FLAT_QUERY = (f"histogram_quantile(0.99, sum(rate({H}_bucket"
              f'{{_ns_=~"App-[0-9]"}}[5m])) by (le, _ns_))')
FLAT_NATIVE = (f'histogram_quantile(0.99, sum(rate({H}{{_ns_=~"App-[0-9]"}}'
               f"[5m])) by (_ns_))")
_HIST_BLOCK = 10_000  # series generated and ingested at once
HIST_WARM = 7  # warm runs of each phase-8 query


def make_hist_series(rng, a: int, b: int, samples: int):
    """Histogram series a..b-1: labels, jittered timestamps, cumulative
    bucket counts int64 [n, samples, 12] with a reset of every bucket in
    about 5 % of series."""
    n = b - a
    labels = [{"_metric_": H, "_ws_": "demo", "_ns_": f"App-{i % 100}",
               "instance": f"instance-{i}", "job": f"job-{i % 10}"}
              for i in range(a, b)]
    ts = (T0_MS + np.arange(samples, dtype=np.int64)[None, :] * 10_000
          + rng.integers(-500, 501, (n, samples)))
    obs = rng.integers(0, _OBS_HIGH + 1, (n, samples, len(_OBS_HIGH)),
                       dtype=np.int32)
    counts = np.cumsum(np.cumsum(obs, axis=2, dtype=np.int64), axis=1)
    reset = np.flatnonzero(rng.random(n) < 0.05)
    at = rng.integers(1, samples, len(reset))
    for r, k in zip(reset, at):
        counts[r, k:] -= counts[r, k]
    return labels, ts, counts


def _fmt_le(le: float) -> str:
    return "+Inf" if np.isinf(le) else repr(float(le))


def hist_leaf(eng, q: str, start: int, end: int):
    """(lowered leaf, aggregation or None) of a query of the form
    [histogram_quantile(φ,] [agg(] range_fn(selector[w]) [)] [)]."""
    from filodb_tpu_torch.parallel.mesh_engine import lower_plan
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query import logical as lp

    plan = parse_query(q, TimeStepParams(start, 60, end))
    if isinstance(plan, lp.ApplyInstantFunction):
        plan = plan.vector
    if isinstance(plan, lp.Aggregate):
        return lower_plan(plan.vector), eng._aggregation(plan)
    return lower_plan(plan), None


def hist_against_plain(svc, q: str, start: int, end: int, got) -> dict:
    """Query ``q`` (histogram_quantile over a per-bucket aggregation of one
    rate leaf) against the plain path, chunk by chunk as the engine cuts
    its batch: B1 must equal its plain version bit for bit on the timestamp
    blocks and on the bucket blocks of every chunk, and the answer must
    equal plain decode + float64 ``range_eval_masked`` per bucket, the
    per-bucket sum and the plain quantile."""
    import torch

    from filodb_tpu_torch.device import EXACT_DTYPE
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.parallel.mesh_engine import decode_rows
    from filodb_tpu_torch.query.engine.aggregations import (
        aggregate,
        histogram_quantile,
    )
    from filodb_tpu_torch.query.engine.device_batch import (
        BLOCK,
        assemble_hist,
    )
    from filodb_tpu_torch.query.engine.kernels import range_eval_masked

    eng = svc.engine
    low, amr = hist_leaf(eng, q, start, end)
    batch = eng._batch(svc.memstore, low)
    n, B = len(batch.keys), len(batch.les)
    NB = batch.packed[0].shape[1]
    rows = min(max(1, decode_rows(NB * BLOCK, low.fn) // B), n)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    outs = []
    for a in range(0, n, rows):
        part = tuple(t[a : min(a + rows, n)] for t in batch.packed)
        for name, (sl, w, wd) in (("timestamp", part[1:4]),
                                  ("bucket", part[5:8])):
            args = (sl.reshape(-1), w.reshape(-1), wd.reshape(-1, BLOCK))
            if not compare(dp.decode_ts_blocks(*args),
                           dp.decode_ts_blocks_plain(*args), 0, 0,
                           bitwise=True)[1]:
                raise AssertionError(f"B1 differs from its plain version on "
                                     f"the {name} blocks of rows {a}.. of "
                                     f"{q}")
        ts, counts, valid = assemble_hist(part, hi_ms - lo_ms, plain=True)
        outs.append(range_eval_masked(low.fn, ts, counts, valid, steps,
                                      low.window, counter=True,
                                      dtype=EXACT_DTYPE))
    per_series = torch.cat(outs)                             # [n, B, K]
    K = per_series.shape[2]
    gids, gkeys = eng._group_ids(batch.out_keys, amr)
    G = len(gkeys)
    gb = (gids[:, None] * B + torch.arange(B, device=gids.device)).reshape(-1)
    summed = aggregate("sum", per_series.reshape(n * B, K), gb, G * B)
    phi = float(q.split("(")[1].split(",")[0])
    want = histogram_quantile(phi, summed.view(G, B, K).transpose(1, 2),
                              torch.from_numpy(batch.les)).cpu().numpy()
    order = {str(k): i for i, k in enumerate(gkeys)}
    idx = [order[str(k)] for k in got.keys]
    if got.values.shape != want.shape or not np.allclose(
            got.values, want[idx], rtol=1e-9, atol=0, equal_nan=True):
        raise AssertionError(f"{q} disagrees with the plain path")
    chunks = -(-n // rows)
    return {"series": n, "buckets": B, "rows": rows, "chunks": chunks,
            "last_rows": n - (chunks - 1) * rows}


def hist_split(svc, q: str, start: int, end: int, rows: int,
               reps: int) -> dict:
    """Times of each part of one engine-sized chunk of the histogram rate
    leaf of ``q`` (``split_times``: CUDA events, median of 5 rounds, and
    profiler device time): B1 on the timestamp blocks, B1 on the bucket
    blocks, the glue (gap fill, range mask, int64 base add in float64), the
    per-bucket float64 rate, the per-bucket sum of the chunk's rows and the
    quantile; and the whole chunk (decode to rate)."""
    import torch

    from filodb_tpu_torch.device import EXACT_DTYPE
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.query.engine.aggregations import (
        aggregate,
        histogram_quantile,
    )
    from filodb_tpu_torch.query.engine.device_batch import BLOCK, fill_hist
    from filodb_tpu_torch.query.engine.kernels import range_eval_masked

    eng = svc.engine
    low, amr = hist_leaf(eng, q, start, end)
    batch = eng._batch(svc.memstore, low)
    part = tuple(t[:rows] for t in batch.packed)
    B = len(batch.les)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    les = torch.from_numpy(batch.les)

    def b1_ts():
        return dp.decode_ts_blocks(part[1].reshape(-1), part[2].reshape(-1),
                                   part[3].reshape(-1, BLOCK))

    def b1_buckets():
        return dp.decode_ts_blocks(part[5].reshape(-1), part[6].reshape(-1),
                                   part[7].reshape(-1, BLOCK))

    def glue(ts_off, b_off):
        return fill_hist(part[0], part[8], part[4], ts_off, b_off,
                         hi_ms - lo_ms)

    def rate(ts, counts, valid):
        return range_eval_masked(low.fn, ts, counts, valid, steps,
                                 low.window, counter=True, dtype=EXACT_DTYPE)

    gids, gkeys = eng._group_ids(batch.out_keys, amr)
    G, K = len(gkeys), steps.numel()
    gb = (gids[:rows, None] * B
          + torch.arange(B, device=gids.device)).reshape(-1)

    def agg(per):
        return aggregate("sum", per.reshape(rows * B, K), gb, G * B) \
            .view(G, B, K).transpose(1, 2)

    ts_off, b_off = b1_ts(), b1_buckets()
    decoded = glue(ts_off, b_off)
    per = rate(*decoded)
    summed = agg(per)
    phi = float(q.split("(")[1].split(",")[0])
    parts = {"B1_timestamps": b1_ts, "B1_buckets": b1_buckets,
             "glue": lambda: glue(ts_off, b_off),
             "rate": lambda: rate(*decoded), "aggregation": lambda: agg(per),
             "quantile": lambda: histogram_quantile(phi, summed, les),
             "chunk": lambda: rate(*glue(b1_ts(), b1_buckets()))}
    out = split_times(parts, reps, rounds=5)
    for kind in ("events_ms", "device_ms"):
        if all(out[k][kind] is not None for k in parts):
            out[f"sum_of_parts_{kind}"] = sum(out[k][kind] for k in parts
                                              if k != "chunk")
    out["rows"], out["buckets"], out["S"] = rows, B, int(decoded[0].shape[1])
    return out


def b1_bucket_case(svc, q: str, start: int, end: int, rows: int,
                   reps: int) -> dict:
    """B1 on the bucket blocks of one engine-sized chunk: time, plain
    time, and its byte bound at that shape (per-block slope and width, the
    4·w words each width needs, the int32 output)."""
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.query.engine.device_batch import BLOCK

    batch = svc.engine._batch(svc.memstore, hist_leaf(svc.engine, q, start,
                                                      end)[0])
    part = tuple(t[:rows] for t in batch.packed)
    args = (part[5].reshape(-1), part[6].reshape(-1),
            part[7].reshape(-1, BLOCK))
    nb = args[1].numel()
    nbytes = nb * (8 + 512) + word_bytes(args[1])
    b, by = bound_ms(nbytes, nb * B1_OPS_BLOCK)
    return {"blocks": nb, "ms": cuda_time_ms(lambda: dp.decode_ts_blocks(
        *args), reps), "plain_ms": wall_ms(lambda: dp.decode_ts_blocks_plain(
            *args)), "bound_ms": b, "bound_by": by, "bound_bytes": nbytes}


def histogram_phase(dev, args, reps: int) -> dict:
    """Phase 8: first-class histograms at full width, and the flat form."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.http.promjson import matrix_json

    t_phase = t = time.perf_counter()
    N, samples = args.hist_series, args.samples
    store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    kept, flat_parts = 0, []
    for a in range(0, N, _HIST_BLOCK):
        rng = np.random.default_rng([args.seed, 8, a])
        labels, ts, counts = make_hist_series(rng, a, min(a + _HIST_BLOCK, N),
                                              samples)
        kept += store.ingest_histograms(labels, ts, counts, DEF_BUCKETS)
        sel = [j for j, lb in enumerate(labels) if int(lb["_ns_"][4:]) < 10]
        flat_parts.append(([labels[j] for j in sel], ts[sel], counts[sel]))
    ingest_s = time.perf_counter() - t
    chunks = sum(len(s.hist_chunks["pid"]) for s in store.shards)
    log(f"phase 8: histograms: {N} series x {samples} samples x "
        f"{len(DEF_BUCKETS)} buckets ({kept} samples, {chunks} sealed "
        f"chunks), ingest {ingest_s:.1f} s on the host")
    # the flat form on a second store: App-0..App-9 as le-labelled counters
    t = time.perf_counter()
    flat_store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    lbs = [{**lb, "_metric_": f"{H}_bucket", "le": _fmt_le(le)}
           for part in flat_parts for lb in part[0] for le in DEF_BUCKETS]
    fts = np.concatenate([np.repeat(p[1], len(DEF_BUCKETS), axis=0)
                          for p in flat_parts])
    fvals = np.concatenate([p[2].transpose(0, 2, 1).reshape(-1, samples)
                            for p in flat_parts]).astype(np.float64)
    del flat_parts
    flat_store.ingest_series(lbs, fts, fvals)
    flat_s = time.perf_counter() - t
    log(f"  flat form: {len(lbs)} prom-counter series {H}_bucket{{le=...}} "
        f"of App-0..App-9, ingest {flat_s:.1f} s on the host")

    svc = QueryService(store, device=dev)
    flat_svc = QueryService(flat_store, device=dev)
    start, end = T0_MS // 1000, T0_MS // 1000 + 7200
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    results, timings = {}, []
    for s, q in [(svc, q) for q in HIST_QUERIES] \
            + [(flat_svc, FLAT_QUERY), (svc, FLAT_NATIVE)]:
        t = time.perf_counter()
        r = s.query_range(q, start, 60, end)
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(HIST_WARM):
            t = time.perf_counter()
            r = s.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        results[q] = r
        timings.append(dict(query=q, cold_ms=cold,
                            warm_p50_ms=float(np.median(warm)),
                            warm_ms=warm, rows=r.result.num_series))
        log(f"  {q}: cold {cold:.1f} ms, warm p50 {np.median(warm):.2f} "
            f"ms (min {min(warm):.2f}, max {max(warm):.2f} of {HIST_WARM}), "
            f"{r.result.num_series} rows")
    launches = dict(_build.LAUNCHES)
    packed = svc.engine.batch_bytes
    log(f"  launches in the phase: {launches}; packed pages on the card "
        f"{packed / 1e9:.2f} GB (histograms) and "
        f"{flat_svc.engine.batch_bytes / 1e9:.2f} GB (the flat form)")
    if dev.type == "cuda" and not (launches["decode_ts_page"]
                                   and launches["fused_decode_rate"]):
        raise AssertionError("phase 8 did not run through B1 (histograms) "
                             "and B3 (the flat form)")

    # answers: shapes, finite values after the first step, Prom JSON, the
    # flat form against the native one
    qa, qb, qc, qd = HIST_QUERIES
    n_ns, n_job = min(100, N), min(10, N)
    app0 = len(range(0, N, 100))
    for q, shape in ((qa, (n_ns, 121)), (qb, (app0, 121)),
                     (qc, (n_job, 121, 12)), (qd, (n_job, 121))):
        v = results[q].result.values
        if v.shape != shape or not np.isfinite(v[:, 1:]).all():
            raise AssertionError(f"{q}: shape {v.shape}, want {shape}, "
                                 f"finite after the first step")
    body = matrix_json(results[qc])
    les = {s["metric"]["le"] for s in body["data"]["result"]}
    if len(body["data"]["result"]) != n_job * 12 \
            or les != {_fmt_le(x) for x in DEF_BUCKETS}:
        raise AssertionError("sum(rate) by (job): bad Prometheus body")
    fr, nr = results[FLAT_QUERY].result, results[FLAT_NATIVE].result
    fk = {str(k): i for i, k in enumerate(fr.keys)}
    if sorted(fk) != sorted(str(k) for k in nr.keys) or not np.allclose(
            fr.values[[fk[str(k)] for k in nr.keys]], nr.values, rtol=1e-5,
            atol=0, equal_nan=True):
        raise AssertionError("the le form disagrees with the native form")
    plain = hist_against_plain(svc, qa, start, end, results[qa].result)
    log(f"  answers: shapes and finite values checked; {qc} renders "
        f"{n_job} x 12 le series; the le form equals the native form at "
        f"rtol 1e-5 over {len(nr.keys)} namespaces. {qa}: B1 bitwise equal "
        f"to plain on the timestamp and bucket blocks of {plain['chunks']} "
        f"chunks of {plain['rows']} series x 12 buckets (last "
        f"{plain['last_rows']}); answer equal to plain decode + float64 "
        f"rate + sum + quantile (rtol 1e-9)")
    split = hist_split(svc, qa, start, end, plain["rows"], reps)
    log(f"  {qa} chunk split at the engine's rows (ms: CUDA events, median "
        f"of 5 rounds, and profiler device time): {json.dumps(split)}")
    b1 = b1_bucket_case(svc, qa, start, end, plain["rows"], reps)
    log(f"  B1 on one chunk's bucket blocks: {json.dumps(b1)}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 1e9:.2f} GB (max_memory_allocated)")
    _build.LAUNCHES.update(launches)  # the checks' launches are not counted
    seconds = time.perf_counter() - t_phase
    log(f"  phase 8 took {seconds:.1f} s")
    return {"series": N, "buckets": len(DEF_BUCKETS), "samples": samples,
            "ingest_s": ingest_s, "flat_series": len(lbs),
            "flat_ingest_s": flat_s, "packed_bytes": int(packed),
            "queries": timings, "launches": launches, "plain_check": plain,
            "split": split, "b1_buckets": b1, "peak_bytes": int(peak),
            "seconds": seconds}


def run(dev, args):
    """Phases 2-5 on ``dev``; returns the kernels' numbers and the
    phase-2 store's service (phase 7 queries it again)."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.http.promjson import matrix_json
    from filodb_tpu_torch.query.engine.aggregations import aggregate

    t = time.perf_counter()
    store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    kept = ingest(store, args.series, args.samples, args.seed)
    chunks = sum(len(s.chunks["pid"]) for s in store.shards)
    log(f"phase 2: ingest: {args.series} series, {kept} samples, {chunks} "
        f"sealed chunks, {time.perf_counter() - t:.1f} s on the host")

    svc = QueryService(store, device=dev)
    start, end = T0_MS // 1000, T0_MS // 1000 + 7200
    _build.reset_counts()
    results, timings = {}, []
    for q, _ in QUERIES:
        t = time.perf_counter()
        r = svc.query_range(q, start, 60, end)
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            r = svc.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        results[q] = r
        timings.append((q, cold, float(np.median(warm)), r.result.num_series))
    launches = dict(_build.LAUNCHES)
    log("phase 3: main path (query_range, 2 h at 60 s):")
    for q, cold, p50, rows in timings:
        log(f"  {q}: cold {cold:.1f} ms, warm p50 {p50:.2f} ms, {rows} rows")
    log(f"  launches on the main path: {launches}; packed pages on the card: "
        f"{svc.engine.batch_bytes / 1e9:.2f} GB")
    missing = [k for k, v in launches.items() if v == 0]
    if missing and dev.type == "cuda":
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    log("phase 4: kernels against their plain versions on the card")
    kernels, rate_plain = check_kernels(svc, reps=10)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    log("phase 5: answers")
    q0 = QUERIES[0][0]
    r = results[q0].result
    n_ns = min(100, args.series)
    if r.values.shape != (n_ns, 121) \
            or not np.isfinite(r.values[:, 1:]).all():
        raise AssertionError(f"sum(rate) by (_ns_): shape {r.values.shape}")
    eng = svc.engine
    batch = max(eng._batches.values(), key=lambda b: len(b.keys))
    gids, gkeys = eng._group_ids(batch.out_keys,
                                 lowered(eng, q0, start, end)[1])
    plain = aggregate("sum", rate_plain, gids, len(gkeys)).cpu().numpy()
    order = {str(k): i for i, k in enumerate(gkeys)}
    idx = [order[str(k)] for k in r.keys]
    if not np.allclose(r.values, plain[idx], rtol=1e-5, atol=1e-6,
                       equal_nan=True):
        raise AssertionError("sum(rate) by (_ns_) disagrees with the plain "
                             "path on the card")
    body = matrix_json(results[QUERIES[3][0]])
    if body["status"] != "success" \
            or len(body["data"]["result"]) != min(10, args.series):
        raise AssertionError("count_over_time by job: bad Prometheus body")
    log(f"  sum(rate) by (_ns_): {n_ns} x 121 finite, equal to the plain "
        f"path (rtol 1e-5)")
    small_store_check(args.seed, dev)
    return kernels, svc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--series", type=int, default=1_000_000)
    ap.add_argument("--samples", type=int, default=720)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--long-series", type=int, default=4096)
    ap.add_argument("--long-samples", type=int, default=17_280)
    ap.add_argument("--hist-series", type=int, default=100_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "filodb_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the repository root (filodb_tpu_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from filodb_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    log(f"phase 1: build: {_build.build_all():.1f} s (nvcc, sm_90a, one "
        f"process a source)")
    kernels, svc = run(torch.device("cuda"), args)
    torch.cuda.empty_cache()
    longs = long_range(torch.device("cuda"), args, reps=3)
    print(json.dumps({"long_range": longs}))
    torch.cuda.empty_cache()
    promql = promql_phase(svc, args)
    print(json.dumps({"promql": promql}))
    shapes = plan_shapes_phase(svc, args)
    print(json.dumps({"plan_shapes": shapes}))
    del svc
    torch.cuda.empty_cache()
    hist = histogram_phase(torch.device("cuda"), args, reps=5)
    print(json.dumps({"histograms": hist}))
    for kern in kernels:
        kern["launches_phase7"] = promql["launches"][kern["name"]]
        kern["launches_phase8"] = hist["launches"][kern["name"]]
        kern["launches_phase9"] = shapes["launches"][kern["name"]]
    print(smi[0] if smi else "nvidia-smi: no output")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys},
         **{k: v for k, v in kern.items() if k not in keys}}
        for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
