#!/usr/bin/env python3
"""Time the float64 prefix sums of the range functions on a CUDA card, in
the two orders ``kernels.range_eval_masked`` adds them: ``ordered`` (the
host-decode lane's: as the JAX package's ``jnp.cumsum`` adds, tiles of 16,
a running sum inside each, then the prefix of the tile totals) and one
``torch.cumsum`` (the page lane's); alone and in the functions that take
them, over one decode chunk of the page lane's shape (23,405 rows of
1,024 samples, K = 121, a 5 m window at 10 s) and over the host-decode
lane's 100,000 rows of 720 samples: ``stddev_over_time`` (two prefix sums
of values), ``max_over_time`` and ``rate`` (none: they show the rest of
the function's cost).

Each is the mean of ``--reps`` calls by CUDA events after a warm-up.

    python3 tools/bench_torch_prefix.py [--reps 20]

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

SHAPES = (("page_chunk", 23_405, 1_024), ("host_batch", 100_000, 720))


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_prefix: CUDA is not available", file=sys.stderr)
        return 2
    from filodb_tpu_torch.query.engine import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, P, S in SHAPES:
        ts = (torch.arange(S, device=dev, dtype=torch.int32) * 10_000
              ).expand(P, S).contiguous()
        vals = 1e5 + torch.rand((P, S), generator=gen, device=dev,
                                dtype=torch.float64)
        counts = torch.full((P,), S, dtype=torch.int32, device=dev)
        valid = kernels.counts_valid(ts, counts)
        steps = torch.arange(300_000, S * 10_000, (S * 10_000 - 300_000)
                             // 120, device=dev, dtype=torch.int32)[:121]

        def fn_case(fn, ordered):
            return lambda: kernels.range_eval_masked(
                fn, ts, vals, valid, steps, 300_000, counter=True,
                ordered=ordered)

        rec = {}
        for case in ("prefix", "stddev_over_time", "max_over_time", "rate"):
            times = {}
            for ordered in (True, False):
                fn = (lambda o=ordered: kernels._eprefix(vals, o)) \
                    if case == "prefix" else fn_case(case, ordered)
                times["ordered_ms" if ordered else "cumsum_ms"] = cuda_ms(
                    fn, args.reps)
            rec[case] = times
        out[name] = {"rows": P, "samples": S, **rec}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "prefix": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
