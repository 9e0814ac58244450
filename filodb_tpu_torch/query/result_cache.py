"""The extent result cache: a range query split at step-aligned extents.

Port of ``filodb_tpu/query/result_cache.py``. A range query's step grid is
split at absolute extent boundaries (multiples of ``extent_steps`` steps),
each extent is evaluated as a sub-query of its own over its full aligned
grid, and each extent's answer is kept under the plan's signature (the
plan with its evaluation range blanked) and the extent's bounds. A
sub-query keeps its plan's window, lookback and offset, and the planner
and the mesh engine widen its data range by them, so range functions are
exact at the seams. The extents a query misses are evaluated together
(``QueryService._execute_many_uncached``: on the mesh engine one batch a
leaf over their union range, so one page-in); the reference evaluates
them one after another (ROADMAP §C).

An extent that ends at or before the store's mutable horizon (the least
over the shards of ``Shard.max_ingested_ts``, less ``ooo_allowance_ms``,
and no later than the service's ``rules_horizon_floor`` where a rule
manager publishes one) cannot change under further ingest: it is kept
with no stamp. An extent
past it carries the store's version, read before it is evaluated, and is
evaluated again once the store moved. A dashboard that refreshes after a
scrape so evaluates its head extent only.

Splicing preserves the answer, not its bits: a step evaluated over another
extent's batch sees another block layout, and the prefix-sum paths may
differ in the last ulp (B3 reads only a window's own samples and does
not). A series absent from an extent fills with NaN, as the single query
has it there.

Bypassed wholesale, as in the reference: instant queries (step 0),
subqueries, ``absent``/``absent_over_time``, ``sort``/``limit``, ``@``,
negative offsets, metadata plans, a bare raw selector, queries with a
per-query spread or shard overrides (they change what is read). The
reference also bypasses a service whose store lacks some of its
dataset's shards, whose ingest the local versions would not see; a port
store holds every shard of its dataset (one node). An extent
answered partial (a budget in ``degrade="partial"``) is neither kept nor
spliced: the query is evaluated whole, as the reference surrenders it.
Admission is the cost model's ``cache`` site, as the reference's: each
evaluated extent's recompute time settles under its signature class, and
an extent predicted to recompute in under 2 ms is admitted at low
priority and goes first under byte pressure (a cold model keeps every
extent, ``"keep"``). The port evaluates the missing extents together, so
each one settles the batch's wall time over their number.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np

from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.model import (
    QueryContext,
    QueryResult,
    QueryStats,
    StepMatrix,
    enforce_limits,
)
from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.utils.metrics import Gauge, get_counter
from filodb_tpu_torch.utils.tracing import span

# an extent predicted to recompute faster than this is admitted at low
# priority (the reference's ``_CHEAP_RECOMPUTE_S``)
_CHEAP_RECOMPUTE_S = 0.002

cache_hits = get_counter("filodb_result_cache_hits",
                         help="result extents served from the cache")
cache_misses = get_counter("filodb_result_cache_misses",
                           help="result extents evaluated")
cache_partial_hits = get_counter(
    "filodb_result_cache_partial_hits",
    help="queries served partly from the cache")
cache_evictions = get_counter("filodb_result_cache_evictions",
                              help="result extents evicted by the budget")
cache_bytes = Gauge("filodb_result_cache_bytes",
                    help="bytes of the result extents kept")


@dataclasses.dataclass
class ResultCacheConfig:
    """The ``result_cache`` config block (``config.DEFAULTS``)."""

    enabled: bool = True
    # extent length in steps: a dashboard that moves one step a refresh
    # evaluates its head extent, and at most one edge extent
    extent_steps: int = 32
    # bytes of the kept matrices (least recently used go first beyond it)
    max_bytes: int = 256 * 1024 * 1024
    # how far behind the largest ingested timestamp a sample may still
    # arrive; extents that end before (that - allowance) are immutable
    ooo_allowance_ms: int = 300_000

    @staticmethod
    def from_dict(d: dict) -> "ResultCacheConfig":
        known = {f.name for f in dataclasses.fields(ResultCacheConfig)}
        return ResultCacheConfig(**{k: v for k, v in d.items() if k in known})


# plan nodes that make a query unsplittable: subqueries sample their inner
# plan on a grid of their own, absent() decides over the whole range,
# sort and limit order or cut series over the whole range
_BYPASS_NODES = (
    lp.SubqueryWithWindowing,
    lp.TopLevelSubquery,
    lp.ApplyAbsentFunction,
    lp.ApplySortFunction,
    lp.ApplyLimitFunction,
    lp.RawChunkMeta,
    lp.LabelValues,
    lp.LabelNames,
    lp.SeriesKeysByFilters,
)


def _children(p):
    """The plans directly under ``p``."""
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, lp.LogicalPlan):
            yield v
        elif isinstance(v, tuple):
            yield from (x for x in v if isinstance(x, lp.LogicalPlan))


def splittable_grid(plan: lp.LogicalPlan) -> tuple[int, int, int] | None:
    """The one (start, step, end) grid every periodic node of ``plan``
    evaluates on, or None where the plan bypasses the cache."""
    grids = []

    def walk(p) -> bool:
        if isinstance(p, _BYPASS_NODES) or isinstance(p, lp.RawSeries):
            return False  # a bare selector answers raw samples, no grid
        if isinstance(p, (lp.PeriodicSeries, lp.PeriodicSeriesWithWindowing)):
            if p.at_ms is not None or p.offset < 0 or p.raw.offset < 0 \
                    or p.step <= 0 or p.end < p.start:
                return False
            grids.append((p.start, p.step, p.end))
            return True
        return not dataclasses.is_dataclass(p) \
            or all(walk(c) for c in _children(p))

    if not walk(plan) or not grids or any(g != grids[0] for g in grids):
        return None
    return grids[0]


def retime_extent(plan: lp.LogicalPlan, start: int, end: int):
    """``plan`` on the [start, end] grid of an extent: periodic nodes keep
    their step, window, lookback and offset, only the range moves. With
    ``start == end == 0`` it is the plan's signature."""
    if isinstance(plan, (lp.PeriodicSeries, lp.PeriodicSeriesWithWindowing)):
        raw = dataclasses.replace(plan.raw, range_start=start, range_end=end)
        return dataclasses.replace(plan, raw=raw, start=start, end=end)
    if not dataclasses.is_dataclass(plan):
        return plan
    changes = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name in ("start", "end") and isinstance(v, int):
            changes[f.name] = start if f.name == "start" else end
        elif isinstance(v, lp.LogicalPlan):
            changes[f.name] = retime_extent(v, start, end)
        elif isinstance(v, tuple) and any(isinstance(x, lp.LogicalPlan)
                                          for x in v):
            changes[f.name] = tuple(
                retime_extent(x, start, end) if isinstance(x, lp.LogicalPlan)
                else x for x in v)
    return dataclasses.replace(plan, **changes) if changes else plan


def plan_signature(plan: lp.LogicalPlan):
    """The plan with its evaluation range blanked (hashable): selectors,
    functions, windows, offsets and the step remain."""
    return retime_extent(plan, 0, 0)


def split_extents(start: int, step: int, end: int, extent_steps: int
                  ) -> list[tuple[int, int]]:
    """The grid {start + k·step ≤ end} cut at absolute multiples of
    ``extent_steps · step``, as [(first step, last step)] an extent. The
    boundaries do not follow ``start``, so a window sliding one step a
    refresh keeps hitting the same interior extents."""
    extent_ms = extent_steps * step
    last = start + ((end - start) // step) * step
    out = []
    cur = start
    while cur <= last:
        bound = (cur // extent_ms + 1) * extent_ms  # exclusive
        ext_last = min(cur + ((bound - 1 - cur) // step) * step, last)
        out.append((cur, ext_last))
        cur = ext_last + step
    return out


def _matrix_nbytes(m: StepMatrix) -> int:
    n = int(m.values.nbytes) + int(m.steps_ms.nbytes)
    if m.les is not None:
        n += int(np.asarray(m.les).nbytes)
    # label tuples are shared: a flat charge a key
    return n + 64 * len(m.keys) + 256


class ResultCache:
    """A byte-budgeted LRU of extents: (signature, full extent start, full
    extent end) → (stamp, host StepMatrix over the full aligned extent).
    ``stamp`` is None for an immutable extent and the store's version for
    one past the horizon. ``execute`` copies values out when it merges, so
    a kept matrix is never handed to a caller."""

    def __init__(self, config: ResultCacheConfig | None = None):
        self.config = config or ResultCacheConfig()
        self._lru: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._cheap: set = set()  # keys admitted at low priority

    @staticmethod
    def from_config(cfg) -> "ResultCache | None":
        """A cache from a ``result_cache`` block (a dict, a
        ``ResultCacheConfig``, True, or a cache, handed back); None where
        it is off (None, False, ``enabled: False``)."""
        if cfg is None or cfg is False:
            return None
        if isinstance(cfg, ResultCache):
            return cfg
        if isinstance(cfg, ResultCacheConfig):
            conf = cfg
        elif isinstance(cfg, dict):
            conf = ResultCacheConfig.from_dict(cfg)
        elif cfg is True:
            conf = ResultCacheConfig()
        else:
            raise TypeError(f"bad result_cache config: {cfg!r}")
        return ResultCache(conf) if conf.enabled else None

    # ---- the LRU -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def _get(self, key: tuple, stamp: int | None) -> StepMatrix | None:
        with self._lock:
            entry = self._lru.get(key)
            if entry is None or entry[0] != stamp:
                return None
            self._lru.move_to_end(key)
            return entry[1]

    def _put(self, key: tuple, stamp: int | None, m: StepMatrix,
             cheap: bool = False) -> None:
        nb = _matrix_nbytes(m)
        if nb > self.config.max_bytes:
            return  # larger than the whole budget
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= _matrix_nbytes(old[1])
            self._cheap.discard(key)
            self._lru[key] = (stamp, m)
            self._bytes += nb
            if cheap:
                self._cheap.add(key)
            while self._bytes > self.config.max_bytes and self._lru:
                # the oldest low-priority entry first, then the oldest
                ev_key = next((k for k in self._lru if k in self._cheap),
                              None) if self._cheap else None
                if ev_key is None:
                    ev_key, (_, ev) = self._lru.popitem(last=False)
                else:
                    _, ev = self._lru.pop(ev_key)
                self._cheap.discard(ev_key)
                self._bytes -= _matrix_nbytes(ev)
                cache_evictions.inc()
            cache_bytes.set(self._bytes)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._cheap.clear()
            self._bytes = 0
            cache_bytes.set(0)

    # ---- split, evaluate, merge -----------------------------------------------

    def execute(self, svc, plan: lp.LogicalPlan,
                qcontext: QueryContext | None = None) -> QueryResult | None:
        """``plan``'s answer from its extents (host values), or None where
        it bypasses the cache and the caller evaluates it whole."""
        qcontext = qcontext or QueryContext()
        pp = qcontext.planner_params
        if pp.shard_overrides or pp.spread is not None:
            return None  # they change what is read
        grid = splittable_grid(plan)
        if grid is None:
            return None
        shards = svc.memstore.shards
        start, step, end = grid
        extents = split_extents(start, step, end, self.config.extent_steps)
        # the version before the head extent is evaluated: a row ingested
        # meanwhile leaves the stored stamp behind, so the entry misses
        version = sum(s.version for s in shards)
        horizon = min(s.max_ingested_ts for s in shards) \
            - self.config.ooo_allowance_ms
        # the standing queries' floor (``rules/manager.py``): rule outputs
        # land at or below the ingest horizon, so an extent past the last
        # step the rules have visibly written keeps a version stamp
        floor = getattr(svc, "rules_horizon_floor", None)
        if floor is not None:
            horizon = min(horizon, floor() if callable(floor) else floor)
        sig = plan_signature(plan)
        # a tiered planner's colder tiers: the signature stays the same
        # whichever tier serves an extent, but their index versions join
        # it, so settled extents do not outlive a change of the tiers
        tok = getattr(svc.planner, "version_token", None)
        if tok is not None:
            sig = (sig, tok())
        extent_ms = self.config.extent_steps * step
        t0 = time.perf_counter()
        full, missing = [], []
        for es, ee in extents:
            # the full aligned extent [fs, fe], in the query's step phase,
            # is evaluated and kept; [es, ee] is sliced out of it
            lo = (es // extent_ms) * extent_ms
            fs = lo + ((start - lo) % step)
            fe = fs + ((lo + extent_ms - 1 - fs) // step) * step
            key = (sig, fs, fe)
            stamp = None if fe <= horizon else version
            m = self._get(key, stamp)
            full.append((es, ee, fs, m))
            if m is None:
                missing.append((len(full) - 1, key, stamp))
        # the missing extents are evaluated together: one batch a leaf over
        # their union range, one page-in (one after another, each extent's
        # page-in would evict the last one's pages past the page cache's
        # bound and read them again)
        stats = QueryStats()
        misses = len(missing)
        hits = len(extents) - misses
        with span("cache", extents=len(extents)) as sp:
            t_eval = time.perf_counter()
            answers = svc._execute_many_uncached(
                [retime_extent(plan, full[i][2], key[2])
                 for i, key, _ in missing],
                QueryContext(planner_params=pp, origin=qcontext.origin))
            each_s = (time.perf_counter() - t_eval) / max(misses, 1)
            for r in answers:
                if isinstance(r, Exception):
                    raise r
                if r.partial or r.warnings:
                    # a degraded extent is neither kept nor spliced
                    cache_misses.inc(misses)
                    cache_hits.inc(hits)
                    return svc._execute_uncached(plan, qcontext)
            model = cm.model_for(svc.dataset)
            for (i, key, stamp), r in zip(missing, answers):
                # admission priority by recompute cost: the "cache" site
                d = model.classify("cache", sig, _CHEAP_RECOMPUTE_S,
                                   below_arm="cheap", above_arm="keep",
                                   static_arm="keep")
                model.record_actual(d, each_s)
                self._put(key, stamp, r.result, cheap=d.arm == "cheap")
                full[i] = full[i][:3] + (r.result,)
                stats.merge_counts(r.stats)
            parts = [(es, ee, _slice_steps(m, fs, step, es, ee))
                     for es, ee, fs, m in full]
            cache_hits.inc(hits)
            cache_misses.inc(misses)
            if 0 < hits < len(extents):
                cache_partial_hits.inc()
            merged = _merge_extents(parts, step)
            if sp is not None:
                sp.tags.update(hits=hits, misses=misses, bytes=self._bytes)
        if merged is None:
            # histogram buckets that differ between extents: evaluate whole
            return svc._execute_uncached(plan, qcontext)
        enforce_limits(merged, qcontext)
        stats.cache_hits += hits
        stats.cache_misses += misses
        stats.result_series = merged.num_series
        stats.wall_time_s = time.perf_counter() - t0
        return QueryResult(merged, stats, qcontext.query_id)


def _slice_steps(m: StepMatrix, fs: int, step: int, es: int, ee: int
                 ) -> StepMatrix:
    """A full extent's matrix cut to the steps [es, ee]. Rows left without
    a sample go, as the single query compacts them away (a per-step
    selective function, topk, can keep a series only outside them)."""
    if m.num_series == 0:
        return m
    i0 = (es - fs) // step
    i1 = (ee - fs) // step
    if i0 == 0 and i1 == len(m.steps_ms) - 1:
        return m
    vals = m.values[:, i0:i1 + 1]
    keep = ~np.all(np.isnan(vals), axis=tuple(range(1, vals.ndim)))
    keys = m.keys
    if not keep.all():
        vals = vals[keep]
        keys = [k for k, kp in zip(keys, keep) if kp]
    return StepMatrix(keys, vals, m.steps_ms[i0:i1 + 1], les=m.les)


def _merge_extents(parts: list[tuple[int, int, StepMatrix]], step: int
                   ) -> StepMatrix | None:
    """The extents' matrices spliced onto one grid, series aligned by key
    (NaN where an extent lacks one); None where histogram bucket bounds
    differ between extents, or histograms meet scalar series."""
    if len(parts) == 1:
        _, _, m = parts[0]
        return StepMatrix(list(m.keys), np.array(m.values),
                          np.array(m.steps_ms), les=m.les)
    key_index: dict = {}
    order: list = []
    les = None
    nbuckets = 0
    for _, _, m in parts:
        if m.keys != order:
            for k in m.keys:
                if k not in key_index:
                    key_index[k] = len(order)
                    order.append(k)
        if m.num_series and m.is_histogram:
            if les is None:
                les, nbuckets = m.les, m.values.shape[2]
            elif m.les is None or not np.array_equal(np.asarray(m.les),
                                                     np.asarray(les)):
                return None
    steps = np.concatenate([np.arange(es, ee + 1, step, dtype=np.int64)
                            for es, ee, _ in parts])
    if not order:
        return StepMatrix.empty()
    shape = (len(order), len(steps)) + ((nbuckets,) if nbuckets else ())
    out = np.full(shape, np.nan)
    off = 0
    for es, ee, m in parts:
        k = (ee - es) // step + 1
        if m.num_series:
            if bool(nbuckets) != m.is_histogram:
                return None
            if m.keys == order:
                out[:, off:off + k] = m.values
            else:
                rows = np.fromiter((key_index[key] for key in m.keys),
                                   np.intp, len(m.keys))
                out[rows, off:off + k] = m.values
        off += k
    return StepMatrix(order, out, steps, les=les)
