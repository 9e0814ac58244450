"""Tier federation: one query across the memstore, cold raw chunks and
the downsample tier.

Port of ``filodb_tpu/query/federation.py``:

- ``route_tiers`` cuts a query grid into per-tier step ranges at step
  boundaries: every step goes to the newest tier whose data floor covers
  its whole lookback window, so no step is answered twice or dropped at a
  seam.
- ``ColdTierStore`` is a store-shaped facade over the raw dataset's
  persisted chunks: read-only shards (``core/downsample/dsstore.py``:
  the index from ``scan_part_keys``, refreshed every ``refresh_s``; the
  chunks paged on demand through each shard's ODP cache of
  ``odp_max_chunks``), read by leaves through their ``store``, as the
  downsample store is. Over an object store each shard has a pyramid
  cache (``core/store/pyramid.py``), which the pyramid lane folds
  (``query/engine/pyramid_lane.py``), and the store answers
  ``approx_topk`` and ``approx_cardinality`` from the pyramids' footer
  sketches alone, under ``FILODB_SIDECAR_APPROX=1``; over the local store
  it has no pyramids, and the reference's cold tier bypasses them there
  too.
- ``TierExec`` runs one tier's exec subtree under a ``tier`` span with
  stats of its own and folds them into the query's twice: merged, and
  into ``QueryStats.tiers[tier]`` (subqueries, series, samples, chunks
  and bytes paged in from the column store, their decode and encode ms,
  wall ms; the pyramid lane's level and byte counts). Bytes from an
  object store are what it downloaded (``BYTES_DOWN``), as the
  reference's buckets count them; from a local store, the ODP caches'
  reads.
- A cold tier's leaves lost to a transport fault (the transport's error
  after the read retries) make the answer partial, the other tiers'
  steps with a warning naming the lost shards, through partial
  scatter-gather (``query/exec/plan.py``), as the reference's; an
  ``ObjectStoreError`` or a corrupt segment raises.
- ``tier_status``: the retention tiers of a dataset's service, for
  ``GET /api/v1/status/tiers`` on both fronts.

The planner that composes them is ``coordinator/tiered_planner.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from filodb_tpu_torch.core.downsample.dsstore import ReadOnlyStore
from filodb_tpu_torch.core.store.api import pk_from_blob
from filodb_tpu_torch.core.store.objectstore import (
    BYTES_DOWN,
    ObjectStoreColumnStore,
)
from filodb_tpu_torch.core.store.pyramid import make_pyramid_cache
from filodb_tpu_torch.memory.sketches import HLLSketch, TopKSketch
from filodb_tpu_torch.query.exec.plan import (
    ExecContext,
    NonLeafExecPlan,
    leaves,
)
from filodb_tpu_torch.query.model import QueryStats, StepMatrix
from filodb_tpu_torch.utils.metrics import Counter
from filodb_tpu_torch.utils.tracing import span, tag

MEMSTORE = "memstore"
OBJECTSTORE = "objectstore"
DOWNSAMPLE = "downsample"

fed_queries = Counter("filodb_federation_queries")
_SUB_COUNTERS = {t: Counter("filodb_federation_subqueries", {"tier": t})
                 for t in (MEMSTORE, OBJECTSTORE, DOWNSAMPLE)}


# ---------------------------------------------------------------------------
# tier routing

@dataclass(frozen=True)
class TierRange:
    """One tier's slice of a query grid: step instants ``start, start +
    step, ..., end`` (both inclusive, ms)."""

    tier: str
    start: int
    end: int


def _first_covered_step(start: int, step: int, end: int, lookback: int,
                        floor: int) -> int:
    """The first grid instant whose whole lookback window lies at or above
    ``floor``; ``end + step`` (or past it) when none does."""
    b = start
    while b - lookback < floor and b <= end:
        b += step
    return b


def route_tiers(start: int, step: int, end: int, lookback: int,
                mem_floor: int, raw_floor: int | None) -> list[TierRange]:
    """A query grid as per-tier step ranges, oldest tier first: disjoint,
    adjacent, covering every step. ``raw_floor`` is the earliest raw
    data (None: no downsample tier, the cold tier reaches to the start);
    a ``mem_floor`` below it is raised to it."""
    step = max(step, 1)
    if raw_floor is not None and mem_floor < raw_floor:
        mem_floor = raw_floor
    b_mem = _first_covered_step(start, step, end, lookback, mem_floor)
    b_os = start if raw_floor is None else \
        _first_covered_step(start, step, end, lookback, raw_floor)
    out = []
    if b_os > start:
        out.append(TierRange(DOWNSAMPLE, start, b_os - step))
    if b_mem > b_os:
        out.append(TierRange(OBJECTSTORE, b_os, b_mem - step))
    if b_mem <= end:
        out.append(TierRange(MEMSTORE, b_mem, end))
    return out


# ---------------------------------------------------------------------------
# the cold tier: raw history on the column store

class ColdTierStore(ReadOnlyStore):
    """The raw dataset's persisted part keys and chunks as read-only
    shards, each with its own ODP cache (``odp_max_chunks``) and its index
    refreshed every ``refresh_s`` seconds."""

    def __init__(self, column_store, dataset: str, num_shards: int,
                 odp_max_chunks: int = 10_000, refresh_s: float = 60.0):
        super().__init__(column_store, dataset, num_shards, OBJECTSTORE,
                         max_chunks=odp_max_chunks, refresh_s=refresh_s)
        # None where the store publishes no pyramids: the lane bypasses
        for sh in self.shards:
            sh.pyramids = make_pyramid_cache(column_store, dataset,
                                             sh.shard_num)

    def tier_stats(self) -> dict:
        """{series, bytes, segments} for the status route; bytes and
        segments where the store can say them (the object store), else
        None, as the reference's."""
        self.refresh()
        out = {"series": self.num_partitions, "bytes": None,
               "segments": None}
        stats = getattr(self.column_store, "dataset_stats", None)
        if stats is not None:
            st = stats(self.dataset)
            out["bytes"], out["segments"] = st["bytes"], st["segments"]
        return out

    def clear_caches(self) -> None:
        """Drop the ODP and pyramid caches (a cold read again)."""
        for sh in self.shards:
            with sh.lock:
                for t in sh.odp_cache.tables.values():
                    t.columns["dead"][:] = True
                    t.compact()
                sh.odp_cache.forget(np.arange(sh.num_partitions))
                sh.version += 1
                if sh.pyramids is not None:
                    sh.pyramids.clear()

    # ------------------------------------------------------ the approx lane
    def _merged_sketches(self) -> tuple[TopKSketch, HLLSketch]:
        """(top-k, HLL) merged over every shard's pyramid footers: bucket
        pyramids where there are, segment pyramids for the seqs no bucket
        covers; no payload is read."""
        topk = TopKSketch(capacity=256)
        hll = HLLSketch()
        for sh in self.shards:
            if sh.pyramids is None:
                raise RuntimeError(
                    "approximate scans need a pyramid-publishing "
                    "backend (ObjectStoreColumnStore)")
            seqs, buckets = self.column_store.pyramid_index(self.dataset,
                                                            sh.shard_num)
            covered: set[int] = set()
            for bkt, rec in buckets.items():
                bp = sh.pyramids.bucket(int(bkt), int(rec["seq"]))
                if bp is None:
                    continue
                covered.update(int(q) for q in bp["covers"])
                topk.merge(bp["topk"])
                hll.merge(bp["hll"])
            for seq in seqs:
                if seq in covered:
                    continue
                sp = sh.pyramids.segment(seq)
                if sp is not None:
                    topk.merge(sp["topk"])
                    hll.merge(sp["hll"])
        return topk, hll

    def approx_topk(self, k: int = 10) -> list[dict]:
        """``topk(k)`` of the per-series maxima over the whole cold
        history, from the pyramids alone; declared approximate, so served
        only under ``FILODB_SIDECAR_APPROX=1``."""
        from filodb_tpu_torch.query.engine.sidecar_lane import approx_enabled

        if not approx_enabled():
            raise RuntimeError("approx_topk requires FILODB_SIDECAR_APPROX=1")
        self.refresh()
        topk, _ = self._merged_sketches()
        return [{"labels": pk_from_blob(blob).label_map, "value": v}
                for blob, v in topk.top(k)]

    def approx_cardinality(self) -> float:
        """The HyperLogLog estimate of the cold history's series (standard
        error about 3.25 %), under the same declaration as
        :meth:`approx_topk`."""
        from filodb_tpu_torch.query.engine.sidecar_lane import approx_enabled

        if not approx_enabled():
            raise RuntimeError(
                "approx_cardinality requires FILODB_SIDECAR_APPROX=1")
        self.refresh()
        return self._merged_sketches()[1].estimate()


# ---------------------------------------------------------------------------
# per-tier execution and attribution

def _tier_bucket() -> dict:
    return {"subqueries": 0, "series": 0, "samples": 0, "chunks": 0,
            "bytes": 0, "decodeMs": 0.0, "wallMs": 0.0}


def _paging(stores) -> tuple[int, int, float]:
    """(chunks paged, bytes read, decode and encode seconds) summed over
    the ODP caches of ``stores``' shards; bytes from an object store are
    its downloads (``BYTES_DOWN``), counted once."""
    chunks = nbytes = 0
    secs = 0.0
    objects = False
    for store in stores:
        local = not isinstance(getattr(store, "column_store", None),
                               ObjectStoreColumnStore)
        objects = objects or not local
        for sh in store.shards:
            c = sh.odp_cache
            chunks += c.chunks_paged
            nbytes += c.bytes_read if local else 0
            secs += c.seconds["decode"] + c.seconds["encode"]
    return chunks, nbytes + (BYTES_DOWN.value if objects else 0), secs


@dataclass
class TierExec(NonLeafExecPlan):
    """One tier's exec subtree, run with stats of its own under a ``tier``
    span; its counts fold into the query's and into
    ``QueryStats.tiers[tier]``."""

    tier: str = ""

    def do_execute(self, ctx: ExecContext) -> StepMatrix:
        sub = ExecContext(ctx.memstore, QueryStats(), ctx.device,
                          ctx.batches, ctx.gids, deadline=ctx.deadline,
                          budget=ctx.budget)
        _SUB_COUNTERS.get(self.tier, fed_queries).inc()
        stores = list({id(s): s for s in (
            ctx.memstore if leaf.store is None else leaf.store
            for c in self.children_plans for leaf in leaves(c))}.values())
        before = _paging(stores)
        t0 = time.perf_counter()
        with span("tier", tier=self.tier):
            mats = self.gather(sub)
            tag("series", sub.stats.series_scanned)
        wall_s = time.perf_counter() - t0
        chunks, nbytes, secs = (a - b for a, b in zip(_paging(stores),
                                                      before))
        ctx.partial = ctx.partial or sub.partial
        for w in sub.warnings:
            if w not in ctx.warnings:
                ctx.warnings.append(w)
        ctx.stats.merge_counts(sub.stats)
        b = ctx.stats.tiers.setdefault(self.tier, _tier_bucket())
        b["subqueries"] += 1
        b["series"] += sub.stats.series_scanned
        b["samples"] += sub.stats.samples_scanned
        b["chunks"] += chunks + sub.stats.chunks_touched
        b["bytes"] += nbytes
        b["decodeMs"] += secs * 1000.0
        b["wallMs"] += wall_s * 1000.0
        # the pyramid lane's levels, so ``?stats=all`` shows which served
        for k, v in sub.stats.pyramid.items():
            b[k] = b.get(k, 0) + v
        return mats[0] if mats else StepMatrix.empty()

    def __repr__(self):
        return f"TierExec({self.tier})"


# ---------------------------------------------------------------------------
# status (both HTTP fronts)

def tier_status(name: str, svc) -> dict:
    """A dataset's retention tiers: the floors, and each tier's series and
    bytes. A service without a tiered planner reports the memstore only."""
    mem_series = sum(sh.cardinality.cardinality([]).active_ts
                     for sh in svc.memstore.shards)
    mem_bytes = sum(sh.chunk_bytes() for sh in svc.memstore.shards)
    mem_tier = {"tier": MEMSTORE, "series": mem_series, "bytes": mem_bytes,
                "floorMs": None, "ceilMs": None}
    tiers: list = []
    out = {"federated": False, "tiers": tiers}
    detail = getattr(svc.planner, "tier_detail", None)
    if detail is not None:
        d = detail()
        out["federated"] = True
        out["memFloorMs"] = d["memFloorMs"]
        out["rawFloorMs"] = d["rawFloorMs"]
        mem_tier["floorMs"] = d["memFloorMs"]
        tiers.extend(d["tiers"])
    tiers.append(mem_tier)
    return out
