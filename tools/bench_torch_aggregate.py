#!/usr/bin/env python3
"""Time the port's group sums on a CUDA card at the main path's shapes,
beside the ``index_add_`` they replaced, and count how often each gives
other bits for the same input.

``aggregations.group_sum`` adds each group's rows in runs of 64, level by
level (``embedding_bag`` in sum mode), so its result does not depend on
the card's scheduling; ``index_add_`` adds with atomics. Shapes, float64
values in [0, 2) (rates) with a NaN-free layout as the engine zeroes NaN:

- ``sum(rate) by (_ns_)`` of phase 3: 1,048,576 rows x 121 steps into 100
  groups;
- ``sum(count_over_time) by (job)``: the same rows into 10 groups;
- the histogram SLO query of phase 8: 1,200,000 bucket rows (100,000
  series x 12 buckets) x 121 steps into 1,200 groups.

Each is timed by CUDA events (mean of ``--reps`` calls after a warm-up)
and by the host clock around a synchronised call (median), and run
``--runs`` times to count results that differ bitwise from the first.

    python3 tools/bench_torch_aggregate.py [--reps 20] [--runs 10]

Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = (("sum_rate_by_ns", 1 << 20, 121, 100),
          ("sum_count_by_job", 1 << 20, 121, 10),
          ("hist_slo_by_ns_bucket", 1_200_000, 121, 1_200))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_aggregate: CUDA is not available", file=sys.stderr)
        return 2
    from filodb_tpu_torch.query.engine.aggregations import group_sum

    dev = torch.device("cuda")

    def index_add(v, g, G):
        return torch.zeros((G, v.shape[1]), dtype=v.dtype,
                           device=v.device).index_add_(0, g, v)

    out = {"device": torch.cuda.get_device_name(0), "shapes": []}
    for name, P, K, G in SHAPES:
        rng = np.random.default_rng(P + G)
        v = torch.from_numpy(2.0 * rng.random((P, K))).to(dev)
        g = torch.from_numpy(rng.integers(0, G, P)).to(dev)
        row = {"shape": name, "rows": P, "steps": K, "groups": G}
        for label, fn in (("group_sum", group_sum),
                          ("index_add", index_add)):
            first = fn(v, g, G)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn(v, g, G)
            stop.record()
            torch.cuda.synchronize()
            host, differ = [], 0
            for _ in range(args.runs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(v, g, G)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1000.0)
                differ += not torch.equal(r, first)
            row[label] = {"events_ms": start.elapsed_time(stop) / args.reps,
                          "host_ms_p50": float(np.median(host)),
                          "runs_differing_bitwise": differ,
                          "runs": args.runs}
        want = index_add(v.cpu(), g.cpu(), G)
        row["max_rel_err_vs_cpu"] = float(((group_sum(v, g, G).cpu() - want)
                                           .abs() / want.abs()).max())
        out["shapes"].append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out["nvidia_smi"] = smi
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
