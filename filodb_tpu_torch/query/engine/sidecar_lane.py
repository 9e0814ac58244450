"""The sidecar lane: range functions folded from chunk summaries instead of
decoded samples.

Port of ``filodb_tpu/query/engine/sidecar_lane.py``. Every sealed chunk
carries the summary of its values (``memory/chunk.py``: count, sum, sum
of squares, min, max, first and last sample, resets with their
correction, changes, and a log2 sketch), made at seal. For a window
(t - w, t] the lane splits each partition's data into

    [left-edge chunk] [interior chunks ...] [right-edge chunk] [write buffer]

folds the interior chunks from their summaries, decodes only the edge
chunks and the write buffer, and merges the segments with Prometheus
counter-reset carry across their boundaries; the merged stats feed
closed-form formulas that mirror the kernels' range functions. Anything
whose exactness the lane cannot keep bypasses to the decode lane and counts
in ``filodb_sidecar_bypassed``: an ineligible function, parameters, an ``@``
pin, histogram columns, the rollup schema's columns, a leaf over a
downsample or cold-tier shard (``tier``: its partitions are not warm
memory partitions; a cold tier over a store that publishes pyramids goes
to the pyramid lane, ``pyramid_lane.py``, the others bypass as the
reference's do), a partition that needs demand paging
(an evicted one among them), chunks out of time order, a write buffer
that does not follow its chunks, a query with a scan budget (the decode
lane counts its samples), and a fold the cost model's ``sidecar`` site
sends to decode.
That site's static arm is the reference's geometry gate
(``FILODB_SIDECAR_SEALED_GATE``; 0 or less always folds, the override);
once the model has settled times for both arms of a partition-window
class it takes the cheaper (``query/cost_model.py``).
``quantile_over_time`` is served from the sketches only under
``FILODB_SIDECAR_APPROX=1``.

The port's idiom: the interior folds, the merges and the formulas are
float64 torch ops on the service's device. The interior stats are the
shard's summary columns, uploaded with the chunk spans and the keys as a
bundle kept in the service's ``BatchCache`` under the shard's version, as
a batch is. The write buffers fold on the host in float64, every window of
every partition in one C++ call (``native_shard.buf_fold``, the
reference's ``shard_buf_fold``), which also says which partitions have a
sealed chunk in the windows (the static gate's count) and whether a
buffer's timestamps run backwards (a bypass); their stats are uploaded and
merged after the chunks'. The edge chunks are decoded from their device
pages by B1/B2 (``device_batch.decode_packed``), so their values are the
pages' float32 ones, as in the port's page lane: where an edge chunk's
values do not survive float32 (``partition.exact_in_f32``) the leaf
bypasses to the host-decode lane, which reads them in float64, and so
does one past ``F32_SAFE_MAX``, where the page lane takes its float64
gate; a buffer folds exactly whatever its values. Every bypass counts in
``filodb_sidecar_bypassed`` and, with its reason, in the query's
``QueryStats.sidecar_bypassed``. A leaf's fold runs under the shard's
lock, so it reads one version of the chunk table and the buffers.

The valve ``FILODB_SIDECARS``: ``1`` (default) folds the stored summaries;
``decode`` makes every interior summary again from the chunk's codec
vectors (held until its flush, read back from the column store after it),
bitwise the stored one, so its answers are bitwise those of ``1``; ``0``
turns the lane off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from filodb_tpu_torch.core.memstore.native_shard import (
    buf_fold,
    sealed_overlap,
)
from filodb_tpu_torch.core.memstore.odp import needs_paging
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.memory.chunk import (
    SKETCH_BUCKETS,
    STATS_WIDTH,
    S_CHANGES,
    S_CORR,
    S_COUNT,
    S_FIRST_TS,
    S_FIRST_VAL,
    S_LAST_TS,
    S_LAST_VAL,
    S_MAX,
    S_MIN,
    S_RESETS,
    S_SUM,
    S_SUMSQ,
    decode_chunks,
    sketch_values,
    summarize,
)
from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.query.engine.device_batch import (
    decode_packed,
    pack_blocks,
    to_device,
)
from filodb_tpu_torch.utils.metrics import Counter

SIDECAR_SERVED = Counter(
    "filodb_sidecar_served",
    help="leaf evaluations served from chunk aggregate sidecars")
SIDECAR_BYPASSED = Counter(
    "filodb_sidecar_bypassed",
    help="eligible-path evaluations that fell back to the decode lane")

# functions whose (t-w, t] evaluation is exact over the summary algebra
ELIGIBLE_FNS = frozenset((
    "count_over_time", "sum_over_time", "avg_over_time", "min_over_time",
    "max_over_time", "stddev_over_time", "stdvar_over_time", "zscore",
    "last_over_time", "present_over_time", "absent_over_time", "changes",
    "resets", "rate", "increase", "delta", "last_sample", "timestamp",
))

# below this many sealed partition-windows the lane serves whatever the
# chunks' geometry; above it, only where each partition-window skips this
# many interior samples (the reference's static arm)
_SEALED_FREE_PART_WINDOWS = 512
_SEALED_MIN_SKIPPED_SAMPLES = 1024
# (partition, window) pairs an edge or buffer fold takes at once
_FOLD_PAIRS = 1 << 16


def mode() -> str:
    """``1`` serve, ``decode`` make the summaries again, ``0`` off."""
    v = os.environ.get("FILODB_SIDECARS", "1").strip().lower()
    if v in ("0", "off", "false"):
        return "0"
    if v == "decode":
        return "decode"
    return "1"


def approx_enabled() -> bool:
    return os.environ.get("FILODB_SIDECAR_APPROX", "0") == "1"


def _sealed_gate() -> int:
    """Sealed partition-windows past which the fold is not tried; 0 always
    serves."""
    try:
        return int(os.environ.get("FILODB_SIDECAR_SEALED_GATE", "65536"))
    except ValueError:
        return 65536


def covers_fn(fn: str) -> bool:
    """Would the lane serve this range function (mesh's routing check)?"""
    if mode() == "0":
        return False
    return fn in ELIGIBLE_FNS or (
        fn == "quantile_over_time" and approx_enabled())


class _Bypass(Exception):
    """Exactness cannot be kept: the decode lane serves the leaf. Its
    argument is the reason ``QueryStats.sidecar_bypassed`` counts."""


# ---------------------------------------------------------------------------
# the bundle of a leaf's sealed chunks (cached under the shard's version)


@dataclass
class SidecarBundle:
    """The kept (non-empty) sealed chunks of a leaf's partitions of one
    schema, by partition then time: their rows in the shard's chunk table,
    each one's partition (its index in the leaf's list), the offsets of
    each partition's run, their stats [C, 12] (float64, on the device),
    valid-sample spans and sketches, and the partitions' keys (a bundle
    lives as long as the shard's version, which every ingest moves)."""

    rows: np.ndarray
    part: np.ndarray
    offs: np.ndarray
    stats: torch.Tensor
    starts: np.ndarray
    ends: np.ndarray
    sketch: np.ndarray
    keys: list             # RangeVectorKey a partition (metric kept)
    version: int = 0
    nbytes: int = 0
    _out_keys: list | None = None

    @property
    def out_keys(self) -> list:
        """The keys with the metric dropped, one list for the bundle's
        life, so the aggregations' group ids stay cached."""
        if self._out_keys is None:
            self._out_keys = [k.drop_metric() for k in self.keys]
        return self._out_keys


def _bundle(shard, pids: np.ndarray, decode_mode: bool,
            device: torch.device, version: int, base: int) -> SidecarBundle:
    table = shard._sealed
    col = table.columns
    row_of = np.full(shard.num_partitions, -1, np.int64)
    row_of[pids] = np.arange(len(pids))
    live = np.flatnonzero(~col["dead"] & (row_of[col["pid"]] >= 0))
    live = live[np.lexsort((col["cid"][live], row_of[col["pid"][live]]))]
    stats = col["stats_value"][live]
    sketch = col["sketch_value"][live]
    if decode_mode:
        stats, sketch = _decoded_summaries(shard, table, live)
    keep = stats[:, S_COUNT] > 0
    rows = live[keep]
    part = row_of[col["pid"][rows]]
    st = stats[keep]
    starts = st[:, S_FIRST_TS].astype(np.int64)
    ends = st[:, S_LAST_TS].astype(np.int64)
    # time-ordered, non-overlapping valid spans within each partition
    same = part[1:] == part[:-1]
    if (same & ((starts[1:] <= starts[:-1]) | (starts[1:] <= ends[:-1]))
            ).any():
        raise _Bypass("chunks out of time order")
    offs = np.zeros(len(pids) + 1, np.int64)
    np.cumsum(np.bincount(part, minlength=len(pids)), out=offs[1:])
    t = torch.from_numpy(np.ascontiguousarray(st)).to(device)
    keys = [shard.keys[p].range_vector_key for p in pids.tolist()]
    return SidecarBundle(rows, part, offs, t, starts, ends, sketch[keep],
                         keys, version, t.numel() * 8)


def _decoded_summaries(shard, table, idx: np.ndarray):
    """The summaries of chunks ``idx`` made again from their codec
    vectors: held until the flush, read back from the column store
    after it (``Shard.codec_chunks``)."""
    groups, lost = shard.codec_chunks(table, idx)
    if len(lost):
        raise _Bypass("a flushed chunk the store no longer holds")
    stats = np.zeros((len(idx), STATS_WIDTH))
    sketch = np.zeros((len(idx), SKETCH_BUCKETS), np.uint16)
    for pos, cb in groups:
        d = decode_chunks(cb, SCHEMAS["gauge"])
        stats[pos], sketch[pos] = summarize(d.ts, d.dcols[:, 0], d.rows)
    return stats, sketch


# ---------------------------------------------------------------------------
# folds on the device


def _empty_stats(n: int, device) -> torch.Tensor:
    out = torch.zeros((n, STATS_WIDTH), dtype=torch.float64, device=device)
    out[:, S_MIN:S_LAST_VAL + 1] = float("nan")
    return out


def fold_rows(ts: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
              base: int = 0) -> torch.Tensor:
    """Stats [R, 12] of the samples ``mask`` keeps in each row of
    (ts, vals float64) [R, L], in row order; timestamps are ``ts + base``
    (epoch ms; ``base`` a number, or a float64 tensor [R] of each row's)."""
    R, L = vals.shape
    dev = vals.device
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=dev)
    out = torch.zeros((R, STATS_WIDTH), dtype=torch.float64, device=dev)
    cnt = mask.sum(1)
    have = cnt > 0
    v0 = torch.where(mask, vals, torch.zeros_like(vals))
    out[:, S_COUNT] = cnt.to(torch.float64)
    out[:, S_SUM] = v0.sum(1)
    out[:, S_SUMSQ] = (v0 * v0).sum(1)
    inf = torch.full_like(vals, float("inf"))
    out[:, S_MIN] = torch.where(mask, vals, inf).amin(1)
    out[:, S_MAX] = torch.where(mask, vals, -inf).amax(1)
    idx = torch.arange(L, device=dev).expand(R, L)
    last_at = torch.cummax(torch.where(mask, idx, torch.full_like(idx, -1)),
                           1).values
    first = torch.where(mask, idx, torch.full_like(idx, L)).amin(1)
    last = last_at[:, -1]
    fi = first.clamp(max=L - 1)[:, None]
    li = last.clamp(min=0)[:, None]
    out[:, S_FIRST_TS] = ts.gather(1, fi)[:, 0].to(torch.float64) + base
    out[:, S_FIRST_VAL] = vals.gather(1, fi)[:, 0]
    out[:, S_LAST_TS] = ts.gather(1, li)[:, 0].to(torch.float64) + base
    out[:, S_LAST_VAL] = vals.gather(1, li)[:, 0]
    prev_at = torch.cat([torch.full((R, 1), -1, dtype=idx.dtype, device=dev),
                         last_at[:, :-1]], 1)
    pair = mask & (prev_at >= 0)
    prev = vals.gather(1, prev_at.clamp(min=0))
    drop = pair & (vals < prev)
    out[:, S_RESETS] = drop.sum(1).to(torch.float64)
    out[:, S_CORR] = torch.where(drop, prev, torch.zeros_like(prev)).sum(1)
    out[:, S_CHANGES] = (pair & (vals != prev)).sum(1).to(torch.float64)
    out[:, S_MIN:S_LAST_VAL + 1] = torch.where(
        have[:, None], out[:, S_MIN:S_LAST_VAL + 1], nan)
    return out


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stats [N, 12] of two segments consecutive in time, merged; a drop
    from A's last sample to B's first counts as a reset with correction
    A.last, as the kernels compare each sample with the previous valid
    one."""
    an = a[:, S_COUNT] > 0
    bn = b[:, S_COUNT] > 0
    bdrop = (b[:, S_FIRST_VAL] < a[:, S_LAST_VAL]).to(torch.float64)
    bchg = (b[:, S_FIRST_VAL] != a[:, S_LAST_VAL]).to(torch.float64)
    r = a.clone()
    r[:, S_COUNT] = a[:, S_COUNT] + b[:, S_COUNT]
    r[:, S_SUM] = a[:, S_SUM] + b[:, S_SUM]
    r[:, S_SUMSQ] = a[:, S_SUMSQ] + b[:, S_SUMSQ]
    r[:, S_MIN] = torch.minimum(a[:, S_MIN], b[:, S_MIN])
    r[:, S_MAX] = torch.maximum(a[:, S_MAX], b[:, S_MAX])
    r[:, S_LAST_TS] = b[:, S_LAST_TS]
    r[:, S_LAST_VAL] = b[:, S_LAST_VAL]
    r[:, S_RESETS] = a[:, S_RESETS] + bdrop + b[:, S_RESETS]
    r[:, S_CORR] = (a[:, S_CORR] + bdrop * a[:, S_LAST_VAL]) + b[:, S_CORR]
    r[:, S_CHANGES] = a[:, S_CHANGES] + bchg + b[:, S_CHANGES]
    both = (an & bn)[:, None]
    only_b = (~an & bn)[:, None]
    return torch.where(both, r, torch.where(only_b, b, a))


def _prefix(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def _interior(b: SidecarBundle, t0s: np.ndarray, t1s: np.ndarray,
              device) -> tuple:
    """Merged stats [S, W, 12] of each partition's interior chunk run per
    window, and the run bounds (i0, i1) and overlap bounds (o0, o1),
    partition-local, [S, W] on the host."""
    S, W = len(b.offs) - 1, len(t0s)
    out, i0, i1, o0, o1 = interior_pairs(
        b.stats, b.part, b.starts, b.ends, b.offs,
        np.repeat(np.arange(S, dtype=np.int64), W), np.tile(t0s, S),
        np.tile(t1s, S), device)
    return (out.reshape(S, W, STATS_WIDTH), i0.reshape(S, W),
            i1.reshape(S, W), o0.reshape(S, W), o1.reshape(S, W))


def interior_pairs(st: torch.Tensor, part: np.ndarray, starts: np.ndarray,
                   ends: np.ndarray, offs: np.ndarray, g: np.ndarray,
                   t0: np.ndarray, t1: np.ndarray, device) -> tuple:
    """The interior fold of N (group, window) pairs: rows ``st`` [C, 12]
    (on the device) in groups by ``part`` (group ``k``'s rows
    ``offs[k]:offs[k + 1]``, in time order, valid spans ``starts``,
    ``ends``); pair ``i`` is group ``g[i]`` over (t0[i], t1[i]]. → merged
    stats [N, 12] of the rows wholly inside each window, and the bounds
    (i0, i1) of that run and (o0, o1) of the overlapping rows,
    group-local, [N] on the host."""
    N = len(g)
    lo = min(int(starts.min(initial=0)), int(t0.min(initial=0)))
    hi = max(int(ends.max(initial=0)), int(t1.max(initial=0)))
    span = np.int64(hi - lo + 2)
    ks = part * span + (starts - lo)
    ke = part * span + (ends - lo)
    q0 = g * span + (t0 - lo)
    q1 = g * span + (t1 - lo)
    first = offs[g]
    i0 = np.searchsorted(ks, q0, side="right") - first
    i1 = np.searchsorted(ke, q1, side="right") - first
    i1 = np.maximum(i1, i0)
    o0 = np.searchsorted(ke, q0, side="right") - first
    o1 = np.searchsorted(ks, q1, side="right") - first
    A = torch.from_numpy(first + i0).to(device)
    B = torch.from_numpy(first + i1).to(device)
    have = B > A
    out = _empty_stats(N, device)
    for slot in (S_COUNT, S_SUM, S_SUMSQ, S_RESETS, S_CORR, S_CHANGES):
        p = _prefix(st[:, slot])
        out[:, slot] = p[B] - p[A]
    C = st.shape[0]
    if C > 1:
        same = torch.from_numpy(part[1:] == part[:-1]).to(device)
        drop = same & (st[1:, S_FIRST_VAL] < st[:-1, S_LAST_VAL])
        chg = same & (st[1:, S_FIRST_VAL] != st[:-1, S_LAST_VAL])
        # boundaries between consecutive rows both inside [A, B)
        bl = A.clamp(max=C - 1)
        bh = torch.maximum(B - 1, bl).clamp(max=C - 1)
        for slot, x in ((S_RESETS, drop.to(torch.float64)),
                        (S_CORR, torch.where(drop, st[:-1, S_LAST_VAL],
                                             st.new_zeros(C - 1))),
                        (S_CHANGES, chg.to(torch.float64))):
            p = _prefix(x)
            out[:, slot] += p[bh] - p[bl]
    if C:
        fi = torch.minimum(A, B - 1).clamp(0, C - 1)
        li = (B - 1).clamp(0, C - 1)
        for slot, at in ((S_FIRST_TS, fi), (S_FIRST_VAL, fi),
                         (S_LAST_TS, li), (S_LAST_VAL, li)):
            out[:, slot] = st[at, slot]
        n = B - A
        run = torch.repeat_interleave(torch.arange(N, device=device), n)
        at = torch.repeat_interleave(A - torch.cumsum(n, 0) + n, n) \
            + torch.arange(int(n.sum()), device=device)
        for slot, red in ((S_MIN, "amin"), (S_MAX, "amax")):
            out[:, slot] = out[:, slot].scatter_reduce(
                0, run, st[at, slot], red, include_self=False)
    nanrow = _empty_stats(1, device)
    out = torch.where(have[:, None], out, nanrow)
    return out, i0, i1, o0, o1


class _Segments:
    """Chunks of a leaf (its edge chunks), rows ``chunk_rows`` of ``table``
    (the shard's sealed chunks, or its ODP cache's), packed as the rows of
    one batch on the device; ``fold`` decodes the rows it needs by B1/B2
    (values the pages' float32), each row's timestamps relative to its own
    first block (``base[row]``; ``base`` is the fallback of a row with
    none)."""

    def __init__(self, shard, chunk_rows: np.ndarray, base: int, device,
                 table=None):
        sealed = shard._sealed if table is None else table
        col = sealed.columns
        offsets = np.asarray(sealed.offsets)
        tables = list(sealed.pages)
        blocks = _expand(col["blk0"][chunk_rows], col["nblk"][chunk_rows])
        seg = np.searchsorted(offsets, blocks, side="right") - 1
        table_of = [seg]
        block_of = [blocks - offsets[seg]]
        row_of = [np.repeat(np.arange(len(chunk_rows)),
                            col["nblk"][chunk_rows])]
        self.device = device
        self.n_rows = len(chunk_rows)
        # each row's timestamps are relative to its own first block: the
        # rows of a leaf's edges can lie further apart than int32 ms hold
        # (a grid of 30-day steps), a chunk's samples cannot
        self.base = np.full(self.n_rows, base, np.int64)
        self.packed = None
        self.nbytes = 0
        if self.n_rows:
            ent_tab, ent_blk = table_of[0], block_of[0]
            ent_row = row_of[0]
            first = np.full(self.n_rows, np.iinfo(np.int64).max)
            for t, tab in enumerate(tables):
                sel = ent_tab == t
                np.minimum.at(first, ent_row[sel], np.asarray(
                    tab.ts_bases, np.int64)[ent_blk[sel]])
            self.base = np.where(first == np.iinfo(np.int64).max, base,
                                 first)
            packed, _ = pack_blocks(tables, ent_tab, ent_blk, ent_row,
                                    self.n_rows, self.base)
            self.packed = to_device(packed, device)
            self.nbytes = sum(t.numel() * t.element_size()
                              for t in self.packed)

    def host_rows(self):
        """(ts epoch ms int64, vals float64, valid) [R, L] of every row,
        on the host."""
        if not self.n_rows:
            z = np.zeros((0, 1))
            return z.astype(np.int64), z, z.astype(bool)
        n = self.n_rows  # the packed rows past them are padding
        ts, vals, valid = (x[:n] for x in decode_packed(self.packed))
        return (ts.cpu().numpy().astype(np.int64) + self.base[:, None],
                vals.cpu().numpy().astype(np.float64), valid.cpu().numpy())

    def fold(self, rows: np.ndarray, t0s: np.ndarray,
             t1s: np.ndarray) -> torch.Tensor:
        """Stats [len(rows), 12] of segment row ``rows[i]`` over the window
        (t0s[i], t1s[i]] (epoch ms)."""
        dev = self.device
        if not len(rows):
            return _empty_stats(0, dev)
        outs = []
        for a in range(0, len(rows), _FOLD_PAIRS):
            rr = rows[a:a + _FOLD_PAIRS]
            r = torch.from_numpy(rr).to(dev)
            ts, vals, valid = decode_packed(tuple(t[r] for t in self.packed))
            base = self.base[rr]
            t0 = torch.from_numpy(t0s[a:a + _FOLD_PAIRS] - base).to(
                dev)[:, None]
            t1 = torch.from_numpy(t1s[a:a + _FOLD_PAIRS] - base).to(
                dev)[:, None]
            mask = valid & (ts > t0) & (ts <= t1)
            outs.append(fold_rows(ts, vals.to(torch.float64), mask,
                                  torch.from_numpy(base).to(
                                      dev, torch.float64)))
        return torch.cat(outs)


def _expand(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    count = count.astype(np.int64)
    before = np.cumsum(count) - count
    return np.repeat(first - before, count) + np.arange(int(count.sum()))


# ---------------------------------------------------------------------------
# range-function formulas (the kernels' ``_range_impl``, in float64)


def formula(fn: str, st: torch.Tensor, steps_ms: torch.Tensor,
            window_ms: int, counter: bool) -> torch.Tensor:
    """Values [..., W] of ``fn`` from merged stats [..., W, 12] at the
    absolute eval steps ``steps_ms`` [W] (float64). Divisors are device
    tensors: on the card PyTorch divides by a Python number as a multiply
    by its reciprocal, a rounding off the reference's, which the rate
    family's extrapolation thresholds can turn into a different branch."""
    n = st[..., S_COUNT]
    k1000 = torch.tensor(1000.0, dtype=torch.float64, device=st.device)
    has1 = n >= 1
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=st.device)
    one = torch.ones_like(n)

    def gate(x, ok=has1):
        return torch.where(ok, x, nan)

    if fn == "count_over_time":
        return gate(n)
    if fn == "present_over_time":
        return gate(one)
    if fn == "absent_over_time":
        return torch.where(has1, nan, one)
    if fn == "sum_over_time":
        return gate(st[..., S_SUM])
    if fn == "avg_over_time":
        return gate(st[..., S_SUM] / torch.clamp(n, min=1.0))
    if fn in ("stddev_over_time", "stdvar_over_time", "zscore"):
        mean = st[..., S_SUM] / torch.clamp(n, min=1.0)
        var = torch.clamp(st[..., S_SUMSQ] / torch.clamp(n, min=1.0)
                          - mean * mean, min=0.0)
        if fn == "stdvar_over_time":
            return gate(var)
        sd = torch.sqrt(var)
        if fn == "stddev_over_time":
            return gate(sd)
        return gate((st[..., S_LAST_VAL] - mean) / sd)
    if fn == "min_over_time":
        return gate(st[..., S_MIN])
    if fn == "max_over_time":
        return gate(st[..., S_MAX])
    if fn in ("last_over_time", "last_sample"):
        return gate(st[..., S_LAST_VAL])
    if fn == "timestamp":
        return gate(st[..., S_LAST_TS] / k1000)
    if fn == "changes":
        return gate(st[..., S_CHANGES])
    if fn == "resets":
        return gate(st[..., S_RESETS])
    if fn in ("rate", "increase", "delta"):
        corrected = counter or fn in ("rate", "increase")
        raw_first = st[..., S_FIRST_VAL]
        v_last = st[..., S_LAST_VAL]
        if corrected:
            v_last = v_last + st[..., S_CORR]
        result = v_last - raw_first
        t_first = st[..., S_FIRST_TS] / k1000
        t_last = st[..., S_LAST_TS] / k1000
        range_start = (steps_ms - window_ms) / k1000
        range_end = steps_ms / k1000
        sampled = t_last - t_first
        avg_dur = sampled / torch.clamp(n - 1.0, min=1.0)
        dur_start = t_first - range_start
        dur_end = range_end - t_last
        if fn in ("rate", "increase"):
            dur_to_zero = torch.where(
                result > 0, sampled * raw_first
                / torch.clamp(result, min=1e-30),
                torch.full_like(result, float("inf")))
            dur_start = torch.minimum(dur_start, dur_to_zero)
        threshold = avg_dur * 1.1
        extend = sampled \
            + torch.where(dur_start < threshold, dur_start, avg_dur / 2.0) \
            + torch.where(dur_end < threshold, dur_end, avg_dur / 2.0)
        result = result * (extend / torch.clamp(sampled, min=1e-10))
        if fn == "rate":
            result = result / torch.tensor(window_ms / 1000.0,
                                           dtype=torch.float64,
                                           device=st.device)
        return gate(result, n >= 2)
    raise _Bypass(f"no formula for {fn}")


# ---------------------------------------------------------------------------
# the leaf's entry point


def try_execute(leaf, ctx, shard, pids: np.ndarray, version: int):
    """The leaf's windowing stage served from summaries: a ``StepMatrix``
    (the leaf applies its other transformers), or None for the decode
    lane. ``pids`` are the leaf's partitions, looked up at ``version``."""
    from filodb_tpu_torch.query.exec.transformers import PeriodicSamplesMapper

    m = mode()
    if m == "0":
        return None
    psm = leaf.transformers[0] if leaf.transformers else None
    if not isinstance(psm, PeriodicSamplesMapper):
        return None
    fn = psm.fn
    approx = approx_enabled()
    try:
        if fn not in ELIGIBLE_FNS \
                and not (fn == "quantile_over_time" and approx):
            raise _Bypass("ineligible function")
        if psm.at_ms is not None:
            raise _Bypass("@")
        if psm.params and fn != "quantile_over_time":
            raise _Bypass("parameters")
        if ctx.budget is not None:
            raise _Bypass("a scan budget")  # the decode lane counts it
        # the shard's chunk table and write buffers are read as of one
        # version: an ingest or an eviction waits for the fold; the whole
        # fold (edge decodes and summary reads, or the pyramid lane's) is
        # this lane's decode stage
        with shard.lock, ctx.stats.timed("decode_s", ctx.device):
            return _execute(leaf, ctx, shard, pids, version, psm, fn,
                            m == "decode")
    except _Bypass as e:
        SIDECAR_BYPASSED.inc()
        why = ctx.stats.sidecar_bypassed
        why[e.args[0]] = why.get(e.args[0], 0) + 1
        # the decode lane serves the leaf now: a pending decision whose
        # arm did not run settles under "decode", its prediction dropped
        cm.CostModel.relabel_deferred(ctx, "sidecar", "decode")
        cm.CostModel.relabel_deferred(ctx, "pyramid", "decode")
        return None


def _execute(leaf, ctx, shard, pids, version, psm, fn, decode_mode):
    from filodb_tpu_torch.query.exec.plan import _by_schema
    from filodb_tpu_torch.query.exec.transformers import steps_array
    from filodb_tpu_torch.query.model import StepMatrix

    if not len(pids):
        # the decode lane answers the empty matrix
        raise _Bypass("no partition")
    if getattr(shard, "tier", None) is not None:
        # a downsample or cold-tier shard: its partitions hold no chunk
        # in memory and no summary to fold, and its chunks page in; a cold
        # tier over a store that publishes pyramids folds those instead
        from filodb_tpu_torch.query.engine import pyramid_lane

        return pyramid_lane.execute_cold(leaf, ctx, shard, pids, psm, fn,
                                         decode_mode)
    if shard.hist[pids].any():
        raise _Bypass("histogram columns")
    if shard.multi[pids].any():
        raise _Bypass("rollup columns")  # the lane folds value columns
    if (shard.status[pids] != 0).any():
        raise _Bypass("evicted partitions")  # paged shells
    if shard.config.demand_paging_enabled and needs_paging(
            shard.earliest_in_memory()[pids], shard.index.start_times(pids),
            leaf.chunk_start).any():
        raise _Bypass("demand paging")  # memory does not reach back
    steps = steps_array(psm.start, psm.step, psm.end)
    eval_steps = (steps - psm.offset).astype(np.int64)
    window = int(psm.span)
    # the decode lane reads samples in [chunk_start, chunk_end] only
    t1s = np.minimum(eval_steps, int(leaf.chunk_end))
    t0s = np.maximum(eval_steps - window, int(leaf.chunk_start) - 1)
    dev = ctx.device
    mats, acc = [], {"samples": 0.0, "sidecar": 0, "decoded": 0}
    for s, spids in _by_schema(shard, pids):
        if fn != "quantile_over_time":
            # which partitions have a sealed chunk in the windows (the
            # static gate's count), then the write buffers' fold
            sealed = sealed_overlap(shard._sealed.columns, spids, t0s, t1s,
                                    shard.num_partitions)
            if not _sealed_arm(shard, spids, sealed, t0s, t1s, ctx):
                raise _Bypass("static gate")  # decode amortizes better
            folded, flags = buf_fold(shard.buffers, spids, t0s, t1s)
            if (flags & 1).any():
                raise _Bypass("a write buffer out of time order")
        key = ("sidecar", shard.dataset, shard.shard_num, s, str(leaf.filters),
               leaf.chunk_start, leaf.chunk_end, decode_mode)
        bundle = ctx.batches.get(key, shard, spids)
        if bundle is None:
            bundle = _bundle(shard, spids, decode_mode, dev, version,
                             leaf.chunk_start)
            ctx.batches.put(key, shard, spids, bundle)
        counter = SCHEMAS[_schema_name(s)].is_counter
        if fn == "quantile_over_time":
            out = _quantile(ctx, shard, spids, bundle, float(psm.params[0]),
                            t0s, t1s, leaf.chunk_start, dev, acc)
        else:
            # without a sealed chunk in the windows (flag bit 1) the
            # buffers' fold is all of every window, as the reference's
            st = _group_stats(shard, spids, bundle, folded, t0s, t1s,
                              leaf.chunk_start, dev, acc) if sealed.any() \
                else torch.from_numpy(folded).to(dev)
            acc["samples"] += float(st[..., S_COUNT].sum())
            out = formula(fn, st, torch.from_numpy(
                eval_steps.astype(np.float64)).to(dev), window, counter)
        mats.append(StepMatrix(
            bundle.keys if psm.function is None else bundle.out_keys, out,
            steps, dropped_keys=bundle.out_keys))
    data = StepMatrix.concat(mats) if len(mats) > 1 else mats[0]
    # samples_scanned counts the samples each window accounts for (interior
    # samples are folded, never decoded); chunks_touched every chunk
    # consulted, of which sidecar_chunks were folded from their summaries
    ctx.stats.samples_scanned += int(acc["samples"])
    ctx.stats.sidecar_chunks += acc["sidecar"]
    ctx.stats.chunks_touched += acc["sidecar"] + acc["decoded"]
    SIDECAR_SERVED.inc()
    return data


def _schema_name(s: int) -> str:
    from filodb_tpu_torch.core.record import SCHEMA_NAMES

    return SCHEMA_NAMES[s]


def _sealed_fold_pays(shard, pids: np.ndarray, overlap: np.ndarray,
                      t0s: np.ndarray, t1s: np.ndarray) -> tuple[bool, int]:
    """The reference's static decision, taken from the chunk table before
    anything is built, and the sealed partitions it counted (``overlap``:
    which of ``pids`` have a live chunk in the windows,
    ``native_shard.sealed_overlap``): serve below the free count of sealed
    partition-windows, bypass past the gate, and in between only where a
    window skips enough interior samples, judged from the first
    overlapping partition's first eight chunks."""
    col = shard._sealed.columns
    W = len(t0s)
    n_sealed = int(overlap.sum())
    gate = _sealed_gate()
    if n_sealed == 0 or gate <= 0:
        return True, n_sealed
    if n_sealed * W > gate:
        return False, n_sealed
    if n_sealed * W <= _SEALED_FREE_PART_WINDOWS:
        return True, n_sealed
    first = np.flatnonzero((col["pid"] == pids[np.argmax(overlap)])
                           & ~col["dead"])
    first = first[np.argsort(col["cid"][first])][:8]
    spans = col["t1"][first] - col["t0"][first]
    ok = spans > 0
    if not ok.any():
        return False, n_sealed
    span = float(np.median(spans[ok]))
    density = float(np.median(col["rows"][first])) / span
    skipped = max(0.0, float((t1s - t0s).max()) - 2.0 * span) * density
    return skipped >= _SEALED_MIN_SKIPPED_SAMPLES, n_sealed


def _sealed_arm(shard, pids: np.ndarray, overlap: np.ndarray,
                t0s: np.ndarray, t1s: np.ndarray, ctx) -> bool:
    """Fold against decode as the cost model's ``sidecar`` site decides
    (the reference's ``_sealed_arm``): the static decision
    (``_sealed_fold_pays``) is the static arm; once the model has settled
    wall times for both arms of this partition-window class, the
    predicted-cheaper arm wins. ``FILODB_SIDECAR_SEALED_GATE<=0`` stays
    the override that always folds. The decision defers onto ``ctx``; the
    leaf settles it with its evaluation's wall time."""
    static_serve, n_sealed = _sealed_fold_pays(shard, pids, overlap, t0s,
                                               t1s)
    if n_sealed == 0:
        return True  # nothing sealed: the fold reads the buffers only
    model = cm.model_for(ctx.dataset)
    d = model.decide(
        "sidecar", f"fold:pw{cm.bucket(n_sealed * len(t0s))}",
        ("sidecar", "decode"),
        static_arm="sidecar" if static_serve else "decode",
        override="sidecar" if _sealed_gate() <= 0 else None)
    model.defer(ctx, d)
    return d.arm == "sidecar"


def _decodable(shard, rows: np.ndarray, table=None) -> None:
    """Bypass unless the device pages hold the values of chunks ``rows``
    of ``table`` (the sealed chunks by default) exactly (float32, below
    ``F32_SAFE_MAX``): the lane decodes them by B1/B2."""
    from filodb_tpu_torch.query.exec.transformers import F32_SAFE_MAX

    col = (shard._sealed if table is None else table).columns
    if not col["exact"][rows].all():
        raise _Bypass("values float32 does not hold")
    if float(col["vmax"][rows].max(initial=0.0)) >= F32_SAFE_MAX:
        raise _Bypass("past F32_SAFE_MAX")


def _group_stats(shard, pids, b: SidecarBundle, folded: np.ndarray, t0s,
                 t1s, base: int, dev, acc) -> torch.Tensor:
    """Merged stats [P, W, 12] of one schema's partitions: the edge chunks
    decoded, the interior from the summaries, and the write buffers'
    fold ``folded`` [P, W, 12]."""
    P, W = len(pids), len(t0s)
    interior, i0, i1, o0, o1 = _interior(b, t0s, t1s, dev)
    Cs = np.diff(b.offs)[:, None]
    left = np.where(o0 < i0, o0, -1)
    re = o1 - 1
    right = np.where((re >= i1) & (re >= 0) & (re < Cs) & (re != left), re,
                     -1)
    # the edge chunks, packed for this query's windows
    edges = np.unique(np.concatenate([(b.offs[:-1, None] + e)[e >= 0]
                                      for e in (left, right)]))
    _decodable(shard, b.rows[edges])
    segs = _Segments(shard, b.rows[edges], base, dev)
    seg_of_edge = np.full(len(b.rows), -1, np.int64)
    seg_of_edge[edges] = np.arange(len(edges))

    def edge_stats(e):
        out = _empty_stats(P * W, dev)
        sw = np.flatnonzero((e >= 0).ravel())
        if len(sw):
            rows = seg_of_edge[(b.offs[:-1, None] + e).ravel()[sw]]
            out[torch.from_numpy(sw).to(dev)] = segs.fold(
                rows, np.tile(t0s, P)[sw], np.tile(t1s, P)[sw])
        return out

    pre = merge(merge(edge_stats(left), interior.reshape(P * W, -1)),
                edge_stats(right))
    bufs = torch.from_numpy(folded.reshape(P * W, STATS_WIDTH)).to(dev)
    both = (pre[:, S_COUNT] > 0) & (bufs[:, S_COUNT] > 0)
    if bool((both & (bufs[:, S_FIRST_TS] <= pre[:, S_LAST_TS])).any()):
        raise _Bypass("out of order across the seal")
    acc["sidecar"] += int((i1 - i0).sum())
    acc["decoded"] += len(edges)
    return merge(pre, bufs).reshape(P, W, STATS_WIDTH)


def _quantile(ctx, shard, pids, b: SidecarBundle, q: float, t0s, t1s,
              base: int, dev, acc) -> torch.Tensor:
    """Approximate quantile_over_time [P, W] from the sketches: interior
    chunks give their stored sketch, edge chunks and the write buffer the
    sketch of their window's values (the pages' float32 ones)."""
    P, W = len(pids), len(t0s)
    gate = _sealed_gate()
    # the sketch merge's fold against decode, at the same site
    model = cm.model_for(ctx.dataset)
    d = model.decide(
        "sidecar", f"quantile:pw{cm.bucket(P * W)}", ("sidecar", "decode"),
        static_arm="decode" if gate > 0 and P * W > gate else "sidecar",
        override="sidecar" if gate <= 0 else None)
    model.defer(ctx, d)
    if d.arm != "sidecar":
        raise _Bypass("static gate")  # a per-window sketch merge
    _, i0, i1, _, _ = _interior(b, t0s, t1s, dev)
    Cs = np.diff(b.offs)
    _decodable(shard, b.rows)
    chunk_rows = _Segments(shard, b.rows, base, dev).host_rows()
    # the write buffers' float64 samples
    bufs = shard.buffers
    bufs.cover(shard.num_partitions)
    slot = bufs.slot[pids]
    held = np.flatnonzero(slot >= 0)
    held = held[bufs.n[slot[held]] > 0]
    n = bufs.n[slot[held]]
    buf_rows = (bufs.ts[slot[held]], bufs.vals[slot[held]],
                np.arange(bufs.max_chunk_size)[None, :] < n[:, None])
    L = max(chunk_rows[0].shape[1], buf_rows[0].shape[1])

    def padded(x, fill):
        return np.pad(x, ((0, 0), (0, L - x.shape[1])),
                      constant_values=fill)

    ts, vals, valid = (np.concatenate([padded(c, f), padded(r, f)])
                       for c, r, f in zip(chunk_rows, buf_rows, (0, 0, False)))
    out = np.full((P, W), np.nan)
    samples = 0
    brow = dict(zip(held.tolist(),
                    range(len(b.rows), len(b.rows) + len(held))))
    for i in range(P):
        for k in range(W):
            a = b.offs[i]
            sk = b.sketch[a + i0[i, k]:a + i1[i, k]].astype(np.int64).sum(0) \
                if i1[i, k] > i0[i, k] else np.zeros(SKETCH_BUCKETS, np.int64)
            total = int(b.stats[a + i0[i, k]:a + i1[i, k], S_COUNT].sum())
            rows = [a + c for c in range(Cs[i])
                    if not i0[i, k] <= c < i1[i, k]]
            if i in brow:
                rows.append(brow[i])
            for r in rows:
                m = valid[r] & (ts[r] > t0s[k]) & (ts[r] <= t1s[k])
                sk += sketch_values(vals[r][m]).astype(np.int64)
                total += int(m.sum())
            if total:
                out[i, k] = sketch_quantile(q, sk)
            samples += total
    acc["samples"] += float(samples)
    return torch.from_numpy(out).to(dev)


def _sketch_bucket_value(b: int) -> float:
    """The representative value of sketch bucket ``b``: the geometric
    middle of its power-of-two span."""
    if b == 32:
        return 0.0
    if b > 32:
        return float(2.0 ** (b - 33 - 16) * 1.5)
    return float(-(2.0 ** (31 - b - 16) * 1.5))


def sketch_quantile(q: float, sketch: np.ndarray) -> float:
    """The ``q`` quantile of a merged sketch: the representative of the
    bucket where the cumulative count passes rank ``q * (total - 1)``."""
    if q < 0:
        return -np.inf
    if q > 1:
        return np.inf
    counts = np.asarray(sketch, np.float64)
    total = counts.sum()
    if total <= 0:
        return np.nan
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, q * (total - 1), side="right"))
    return _sketch_bucket_value(min(b, len(counts) - 1))
