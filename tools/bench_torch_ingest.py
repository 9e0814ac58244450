"""Host time of the scalar store's ingest and of its first (cold) query.

Builds the store of ``chip_smoke.py``'s phase 2 (``--series``
``http_requests_total`` counters × ``--samples`` at 10 s, 4 shards, chunks
of 400) and times, on the host clock:

- ``ingest_s``: ``MemStore.ingest_series`` of the whole store;
- ``encode_s``: encoding every shard's write buffers into device pages,
  the first part of a store's first query;
- ``cold_ms``: the first ``sum(rate(m[5m])) by (_ns_)`` after that
  (selection, packing, upload, kernels);
- ``warm_p50_ms``: each phase-3 query of ``chip_smoke.py``, p50 of
  ``--repeats`` after one cold run.

It prints one JSON line. The code it times is host code; on a card it also
builds the kernels first (``--device cuda``, the default). To compare two
trees, copy this file into the other tree's ``tools/`` and run it from
each tree's root in one call, in the order A B B A:

    python3 tools/bench_torch_ingest.py --series 250000
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--series", type=int, default=250_000)
    ap.add_argument("--samples", type=int, default=720)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.core.memstore.memstore import MemStore

    dev = torch.device(args.device)
    if dev.type == "cuda":
        _build.build_all()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t = time.perf_counter()
    store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    chip_smoke.ingest(store, args.series, args.samples, args.seed)
    ingest_s = time.perf_counter() - t
    t = time.perf_counter()
    for shard in store.shards:
        shard.buffer_pages()
    encode_s = time.perf_counter() - t

    svc = QueryService(store, device=dev)
    start = chip_smoke.T0_MS // 1000
    end = start + 7200
    out = {"tree": str(ROOT), "series": args.series, "ingest_s": ingest_s,
           "encode_s": encode_s, "warm_p50_ms": {}}
    for i, (q, _) in enumerate(chip_smoke.QUERIES):
        sync()
        t = time.perf_counter()
        svc.query_range(q, start, 60, end)
        sync()
        if i == 0:
            out["cold_ms"] = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            svc.query_range(q, start, 60, end)
            sync()
            warm.append((time.perf_counter() - t) * 1000.0)
        out["warm_p50_ms"][q] = float(np.median(warm))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
