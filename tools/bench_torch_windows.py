#!/usr/bin/env python3
"""Time the kernels of ``filodb_tpu_torch`` on a CUDA card at the shapes of
``chip_smoke.py``'s main path, without its minutes of host ingest: B1 and
B2 (page decode) on one decode chunk, B3 (fused decode -> rate) and B4
(windowed sum).

A few thousand distinct series (``chip_smoke.make_series``: 720 samples at
10 s, counters with resets) are ingested and packed as the engine packs
them; their packed rows are then tiled to ``--series`` rows on the card.
Each kernel is timed with CUDA events (mean of ``--reps`` launches after a
warm-up). B1 and B2 run on the first 2^17-row decode chunk of the tiled
batch (1,048,576 blocks at NB = 8), as ``mesh_engine`` cuts it, and are
checked bitwise against their plain versions on that whole chunk; B3 and
B4 are checked against theirs on the distinct rows.

    python3 tools/bench_torch_windows.py [--series 1048576] [--reps 20]

Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--series", type=int, default=1 << 20)
    ap.add_argument("--distinct", type=int, default=4096)
    ap.add_argument("--samples", type=int, default=720)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_windows: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.query.exec.transformers import decode_rows
    from filodb_tpu_torch.query.engine import cuda_kernels as ck
    from filodb_tpu_torch.query.engine.device_batch import BLOCK, assemble

    _build.build_all()
    dev = torch.device("cuda")
    store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    cs.ingest(store, args.distinct, args.samples, 0)
    svc = QueryService(store, device=dev)
    start = cs.T0_MS // 1000
    end = start + args.samples * 10
    q = "sum(rate(http_requests_total[5m])) by (_ns_)"
    low, _ = cs.lowered(svc.mesh, q, start, end)
    small = svc.mesh._batch(store, low).packed
    reps = -(-args.series // small[0].shape[0])
    packed = tuple(t.repeat((reps,) + (1,) * (t.dim() - 1))[: args.series]
                   .contiguous() for t in small)
    P, NB = packed[0].shape
    window = 300_000
    host = torch.from_numpy((np.arange(start * 1000, end * 1000 + 1, 60_000)
                             - low.chunk_range[0]).astype(np.int32))
    K = host.numel()
    flight = ck.steps_in_flight(host, window)
    steps = host.to(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows = min(decode_rows(NB * BLOCK), P)
    part = tuple(t[:rows] for t in packed)
    report = {"card": smi, **bench_decode(cs, part, args.reps)}

    got = ck.fused_decode_rate(small, steps, window, "rate", True, flight)
    want = ck.fused_decode_rate_plain(small, steps, window, "rate", True)
    err_b3, ok_b3 = cs.compare(got, want, 1e-6, 1e-6)
    b3 = cs.cuda_time_ms(lambda: ck.fused_decode_rate(
        packed, steps, window, "rate", True, flight), args.reps)
    ts, vals, valid = assemble(part, low.chunk_range[1] - low.chunk_range[0])
    ts = torch.where(valid, ts, ck.TS_PAD).contiguous()
    v0 = torch.where(valid, vals, 0.0).contiguous()
    n = small[0].shape[0]
    _, ok_b4 = cs.compare(ck.windowed_sum(ts[:n], v0[:n], steps, window,
                                          flight),
                          ck.windowed_sum_plain(ts[:n], v0[:n], steps,
                                                window), 0, 0, bitwise=True)
    b4 = cs.cuda_time_ms(lambda: ck.windowed_sum(ts, v0, steps, window,
                                                 flight), args.reps)
    report["fused_decode_rate"] = {
        "shape": f"P={P} NB={NB} K={K}", "ms": b3, "max_abs_err": err_b3,
        "matches_plain": ok_b3}
    report["windowed_sum"] = {"shape": f"P={rows} S={ts.shape[1]} K={K}",
                              "ms": b4, "bitwise_plain": ok_b4}
    print(json.dumps(report))
    ok = ok_b3 and ok_b4 and all(report[k]["bitwise_plain"] for k in
                                 ("decode_ts_page", "decode_f32_page"))
    return 0 if ok else 1


def bench_decode(cs, part, reps: int) -> dict:
    """B1 and B2 on one decode chunk: ms, bound and share, and a bitwise
    check against the plain versions on the whole chunk."""
    from filodb_tpu_torch import _build

    log = _build.BUILD_DIR / "decode_pages.log"
    out = {"decode_ptxas": [ln.strip() for ln in log.read_text().splitlines()
                            if "registers" in ln] if log.exists() else []}
    for name, _, run, plain, nbytes, ops in cs.decode_cases(part):
        got = run()
        _, same = cs.compare(got, plain(), 0, 0, bitwise=True)
        ms = cs.cuda_time_ms(run, reps)
        bound, by = cs.bound_ms(nbytes, ops)
        out[name] = {"blocks": part[0].numel(), "ms": ms, "bound_ms": bound,
                     "bound_by": by, "share_of_bound": bound / ms,
                     "bitwise_plain": same}
    # what the card's stores alone take: one PyTorch fill of an output of
    # the same size (512 bytes a block, nothing read)
    out["write_only_fill_ms"] = cs.cuda_time_ms(lambda: got.fill_(0), reps)
    return out


if __name__ == "__main__":
    sys.exit(main())
