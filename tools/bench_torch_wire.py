"""Host seconds of the mesh runtime's wire at a worker's answer size.

One worker's answer of the multi-process mesh at ``--series`` series
(500,000: a million over two workers) and ``--steps`` steps (121: 2 h at
60 s): float32 windows [series, steps] and a full key each, shaped as
``chip_smoke.py``'s series. Times, on this host, best of ``--repeats``:

- ``encode``: the answer through ``wire.encode``, its keys encoded item by
  item, and with them spliced from ``wire.encoded`` (made once a batch);
- ``zlib``: level-3 compression of the frame, and the ratio, which is why
  the mesh worker client asks for uncompressed frames;
- ``decode``: the frame through ``wire.decode`` on the general path (the
  key fast path and the memo off), on the key fast path with the memo
  cleared (a cold query), and with the memo holding the keys (warm);
- ``root``: the root's per-query key work without its memo: the metric
  dropped from twice ``--series`` keys and their group ids under ``by
  (job)``.

    python3 tools/bench_torch_wire.py [--series 500000] [--steps 121]

Prints one JSON object. CPU only: no card is touched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def best(fn, repeats: int) -> float:
    out = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return min(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--series", type=int, default=500_000)
    ap.add_argument("--steps", type=int, default=121)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from filodb_tpu_torch.coordinator import wire
    from filodb_tpu_torch.query.exec.transformers import AggregateMapReduce
    from filodb_tpu_torch.query.model import RangeVectorKey, StepMatrix

    n, k = args.series, args.steps
    keys = [RangeVectorKey((("_metric_", "http_requests_total"),
                            ("_ns_", f"App-{i % 100}"), ("_ws_", "demo"),
                            ("instance", f"instance-{i}"),
                            ("job", f"job-{i % 10}"))) for i in range(n)]
    rng = np.random.default_rng(0)
    values = rng.random((n, k), dtype=np.float32)
    steps = np.arange(k, dtype=np.int64) * 60_000
    plain = StepMatrix(keys, values, steps)
    out = {"series": n, "steps": k, "cpus": os.cpu_count()}

    t = time.perf_counter()
    spliced = StepMatrix(wire.encoded(keys), values, steps)
    out["encoded_once_s"] = time.perf_counter() - t
    frame = wire.encode(plain)
    assert wire.encode(spliced) == frame
    out["frame_bytes"] = len(frame)
    out["values_bytes"] = values.nbytes
    out["encode_s"] = best(lambda: wire.encode(plain), args.repeats)
    out["encode_spliced_s"] = best(lambda: wire.encode(spliced),
                                   args.repeats)
    t = time.perf_counter()
    packed = zlib.compress(frame, 3)
    out["zlib_s"] = time.perf_counter() - t
    out["zlib_ratio"] = len(frame) / len(packed)

    head, memo_min = wire._RVK_HEAD, wire._MEMO_MIN
    wire._RVK_HEAD, wire._MEMO_MIN = b"\xff", 1 << 62
    try:
        out["decode_general_s"] = best(lambda: wire.decode(frame), 1)
    finally:
        wire._RVK_HEAD, wire._MEMO_MIN = head, memo_min

    def cold():
        wire._decoded.clear()
        return wire.decode(frame)

    out["decode_cold_s"] = best(cold, args.repeats)
    out["decode_warm_s"] = best(lambda: wire.decode(frame), args.repeats)

    both = keys + keys
    t = time.perf_counter()
    dropped = [x.drop_metric() for x in both]
    out["root_drop_metric_s"] = time.perf_counter() - t
    t = time.perf_counter()
    AggregateMapReduce("sum", (), ("job",), ()).group_ids(dropped)
    out["root_group_ids_s"] = time.perf_counter() - t
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
