"""Packed device pages of a series batch, and their assembly on the card.

Port of ``filodb_tpu/query/engine/device_batch.py``: ``pack_series_pages``
lays the page blocks of each selected series side by side in dense
[P, NB, ...] arrays (P and NB padded to powers of two), and ``assemble`` is
the torch form of ``_assemble``: decode every block through kernels B1 and
B2, add the block base, mark validity from ``blk_counts`` and drop NaN
samples (staleness markers, which the reference's host decode filters), give
gaps the previous real timestamp (``torch.cummax``) and apply the
query-range mask.

Packing is vectorised: page blocks live in ``PageBlocks`` tables (one per
shard for sealed chunks, one for the encoded write buffers), and a batch is
a list of block ids per series, gathered with numpy. ``pack_series_pages``
keeps the reference's signature (per-series lists of
``(ts_page, val_page, nrows)``) on top of the same packer; the tests hold
its output byte-equal to the reference's.

Histograms (``_hist_pages`` / ``_build_hist_device_batch`` /
``_assemble_hist`` of the reference): a block carries its timestamp block
and one int block per bucket, encoded as timestamp pages are (cumulative
counts suit the sloped-line predictor), with int64 bases. ``HistPageBlocks``
holds such blocks; ``pack_hist_blocks`` lays a batch out with the buckets
ahead of the blocks, [P, B, NB, ...], so that B1 decodes every bucket block
of a chunk in one launch and its output is already rows of (series,
bucket), [P·B, S]. ``assemble_hist`` decodes each series' timestamp blocks
once (B1), every bucket block (B1 again), and adds the int64 bases in
float64: cumulative counts pass 2^24 within days, which float32 would lose.
Series of a shorter bucket scheme are zero-padded up to the batch's widest.

``build_device_batch`` is the one place that selects, packs and uploads a
batch: the mesh engine calls it with every shard's partitions, an exec
leaf with one shard's partitions of one schema. It is also the lane gate:
where the selected values float32 does not hold, the batch is the
host-decode lane's float64 ``batch.SeriesBatch`` instead. ``BatchCache``
keeps both engines' batches under one budget of device memory. A column selector
(``h::sum``) reads the named column of the partitions' schema, or its
value column where the schema has no such column, as the reference's
``SelectRawPartitionsExec._value_col_index`` does; the rollup schema
``ds-gauge`` keeps its five columns beside each other on one timestamp
page (``MultiPageBlocks``), and a batch packs the one column it reads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from filodb_tpu_torch.core.schemas import SCHEMAS, Column, ColumnType
from filodb_tpu_torch.memory.device_pages import (
    BLOCK,
    WORDS_PER_BLOCK_MAX,
    decode_f32_blocks,
    decode_f32_blocks_plain,
    decode_ts_blocks,
    decode_ts_blocks_plain,
    encode_f32_blocks,
    encode_ts_blocks,
    u32_as_i32,
)
from filodb_tpu_torch.query.engine.batch import (
    Samples,
    SeriesBatch,
    build_batch,
)
from filodb_tpu_torch.query.model import UnsupportedQuery

TS_GAP_MIN = -(2**31) + 2


def _pow2(n: int, floor: int = 1) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


@dataclass
class PageBlocks:
    """A table of encoded page blocks, a timestamp and a value block per
    row, with the number of valid samples in each."""

    ts_bases: np.ndarray    # int64 [B]
    ts_slopes: np.ndarray   # int32 [B]
    ts_widths: np.ndarray   # int32 [B]
    ts_words: np.ndarray    # uint32 [B, 128]
    v_firsts: np.ndarray    # uint32 [B]
    v_shifts: np.ndarray    # int32 [B]
    v_widths: np.ndarray    # int32 [B]
    v_words: np.ndarray     # uint32 [B, 128]
    rows: np.ndarray        # int32 [B]

    def __len__(self) -> int:
        return len(self.rows)

    @staticmethod
    def encode(ts: np.ndarray, vals: np.ndarray,
               rows: np.ndarray) -> "PageBlocks":
        """Encode blocks of timestamps int64 [B, 128] and values [B, 128]
        (lanes past ``rows`` ignored)."""
        return PageBlocks(*encode_ts_blocks(ts, rows),
                          *encode_f32_blocks(vals.astype(np.float32), rows),
                          np.asarray(rows, np.int32))

    @staticmethod
    def concat(parts: list["PageBlocks"]) -> "PageBlocks":
        return PageBlocks(*(np.concatenate([getattr(p, f.name) for p in parts])
                            for f in fields(PageBlocks)))

    def take(self, idx: np.ndarray) -> "PageBlocks":
        return PageBlocks(*(getattr(self, f.name)[idx]
                            for f in fields(PageBlocks)))

    @staticmethod
    def from_pages(ts_page, val_page, nrows: int) -> "PageBlocks":
        nb = ts_page.num_blocks
        rows = np.clip(nrows - np.arange(nb) * BLOCK, 0, BLOCK)
        return PageBlocks(ts_page.bases, ts_page.slopes, ts_page.widths,
                          ts_page.words, val_page.bases, val_page.slopes,
                          val_page.widths, val_page.words,
                          rows.astype(np.int32))


def chunk_blocks(ts: np.ndarray, vals: np.ndarray, n: np.ndarray):
    """Cut rows of samples (ts int64 [C, T], vals [C, T], ``n[c]`` valid)
    into page blocks: → (ts blocks [B, 128], val blocks, rows [B], blocks a
    row [C]). A row of n samples gives max(ceil(n/128), 1) blocks, as
    ``encode_ts_page`` cuts a column."""
    C, T = ts.shape
    nbw = max(-(-T // BLOCK), 1)
    pad = nbw * BLOCK - T
    if pad:
        ts = np.pad(ts, ((0, 0), (0, pad)))
        vals = np.pad(vals, ((0, 0), (0, pad)))
    per = np.maximum(-(-np.asarray(n, np.int64) // BLOCK), 1)
    keep = (np.arange(nbw)[None, :] < per[:, None]).ravel()
    rows = np.clip(np.asarray(n, np.int64)[:, None]
                   - np.arange(nbw)[None, :] * BLOCK, 0, BLOCK).ravel()
    return (ts.reshape(-1, BLOCK)[keep], vals.reshape(-1, BLOCK)[keep],
            rows[keep].astype(np.int32), per)


def _layout(row_of: np.ndarray, n_rows: int):
    """(P, NB, the slot of each entry in its row) of a dense batch whose
    entries are ordered by row: P and NB padded to powers of two."""
    P = _pow2(n_rows, 4)
    per_row = np.bincount(row_of, minlength=n_rows) if len(row_of) \
        else np.zeros(n_rows, np.int64)
    NB = _pow2(max(int(per_row.max(initial=0)), 1))
    first = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    return P, NB, np.arange(len(row_of)) - first[row_of]


def pack_blocks(tables: list[PageBlocks], table_of: np.ndarray,
                block_of: np.ndarray, row_of: np.ndarray, n_rows: int,
                start: int):
    """Gather page blocks into the dense batch layout.

    Entry j (ordered by row, then by time) puts block ``block_of[j]`` of
    ``tables[table_of[j]]`` into the next slot of row ``row_of[j]``.
    Returns the nine [P, NB(, 128)] arrays in ``_assemble``'s parameter
    order, with timestamps rebased to ``start`` (a number, or an int64
    array [n_rows] of each row's), and the valid-sample count of each
    row."""
    P, NB, slot = _layout(row_of, n_rows)
    rel_bases = np.zeros((P, NB), np.int32)
    ts_slopes = np.zeros((P, NB), np.int32)
    ts_widths = np.zeros((P, NB), np.int32)
    ts_words = np.zeros((P, NB, WORDS_PER_BLOCK_MAX), np.uint32)
    v_firsts = np.zeros((P, NB), np.uint32)
    v_shifts = np.zeros((P, NB), np.int32)
    v_widths = np.zeros((P, NB), np.int32)
    v_words = np.zeros((P, NB, WORDS_PER_BLOCK_MAX), np.uint32)
    blk_counts = np.zeros((P, NB), np.int32)
    counts = np.zeros(P, np.int64)
    for t, tab in enumerate(tables):
        sel = np.flatnonzero(table_of == t)
        if not len(sel):
            continue
        r, s, b = row_of[sel], slot[sel], block_of[sel]
        rel_bases[r, s] = (tab.ts_bases[b] - (
            start if np.ndim(start) == 0 else start[r])).astype(np.int32)
        ts_slopes[r, s] = tab.ts_slopes[b]
        ts_widths[r, s] = tab.ts_widths[b]
        ts_words[r, s] = tab.ts_words[b]
        v_firsts[r, s] = tab.v_firsts[b]
        v_shifts[r, s] = tab.v_shifts[b]
        v_widths[r, s] = tab.v_widths[b]
        v_words[r, s] = tab.v_words[b]
        blk_counts[r, s] = tab.rows[b]
        counts += np.bincount(r, tab.rows[b], P).astype(np.int64)
    packed = (rel_bases, ts_slopes, ts_widths, ts_words, v_firsts, v_shifts,
              v_widths, v_words, blk_counts)
    return packed, counts.astype(np.int32)


@dataclass
class HistPageBlocks:
    """A table of histogram page blocks of one bucket count B: a timestamp
    block, B bucket blocks (int pages, int64 bases) and a value block of
    each of the schema's ``sum`` and ``count`` columns (float32 XOR pages)
    a row. The two value columns share the row's timestamp block."""

    ts_bases: np.ndarray    # int64 [nb]
    ts_slopes: np.ndarray   # int32 [nb]
    ts_widths: np.ndarray   # int32 [nb]
    ts_words: np.ndarray    # uint32 [nb, 128]
    b_bases: np.ndarray     # int64 [nb, B]
    b_slopes: np.ndarray    # int32 [nb, B]
    b_widths: np.ndarray    # int32 [nb, B]
    b_words: np.ndarray     # uint32 [nb, B, 128]
    rows: np.ndarray        # int32 [nb]
    # the sum (0) and count (1) columns
    c_firsts: np.ndarray    # uint32 [nb, 2]
    c_shifts: np.ndarray    # int32 [nb, 2]
    c_widths: np.ndarray    # int32 [nb, 2]
    c_words: np.ndarray     # uint32 [nb, 2, 128]

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def buckets(self) -> int:
        return self.b_bases.shape[1]

    @staticmethod
    def encode(ts: np.ndarray, counts: np.ndarray, rows: np.ndarray,
               columns: np.ndarray | None = None) -> "HistPageBlocks":
        """Encode blocks of timestamps int64 [nb, 128], cumulative bucket
        counts int64 [nb, B, 128] and the sum and count columns float64
        [nb, 2, 128] (NaN where not given; lanes past ``rows`` ignored)."""
        nb, B = counts.shape[:2]
        bb, bs, bw, bwd = encode_ts_blocks(counts.reshape(nb * B, BLOCK),
                                           np.repeat(rows, B))
        if columns is None:
            columns = np.full((nb, 2, BLOCK), np.nan)
        # lanes past a block's rows hold whatever the buffer held: zero
        live = np.arange(BLOCK)[None, None, :] < np.asarray(rows)[:, None,
                                                                  None]
        cf, cs, cw, cwd = encode_f32_blocks(
            np.where(live, columns, 0.0).reshape(nb * 2, BLOCK).astype(
                np.float32), np.repeat(rows, 2))
        return HistPageBlocks(*encode_ts_blocks(ts, rows),
                              bb.reshape(nb, B), bs.reshape(nb, B),
                              bw.reshape(nb, B), bwd.reshape(nb, B, BLOCK),
                              np.asarray(rows, np.int32),
                              cf.reshape(nb, 2), cs.reshape(nb, 2),
                              cw.reshape(nb, 2), cwd.reshape(nb, 2, BLOCK))

    def column(self, j: int) -> PageBlocks:
        """The blocks of value column ``j`` (0: sum, 1: count) as scalar
        page blocks over the shared timestamp blocks."""
        return PageBlocks(self.ts_bases, self.ts_slopes, self.ts_widths,
                          self.ts_words, self.c_firsts[:, j],
                          self.c_shifts[:, j], self.c_widths[:, j],
                          self.c_words[:, j], self.rows)

    @staticmethod
    def concat(parts: list["HistPageBlocks"]) -> "HistPageBlocks":
        return HistPageBlocks(*(
            np.concatenate([getattr(p, f.name) for p in parts])
            for f in fields(HistPageBlocks)))

    def take(self, idx: np.ndarray) -> "HistPageBlocks":
        return HistPageBlocks(*(getattr(self, f.name)[idx]
                                for f in fields(HistPageBlocks)))


class MultiPageBlocks:
    """A table of page blocks of a schema with K DOUBLE value columns
    (``ds-gauge``'s min, max, sum, count and avg): a timestamp block a
    row, shared by the columns, and each column's float64 values. A
    column's float32 XOR blocks are encoded the first time a selection
    reads it (``column``) and kept, so a page-in encodes only the columns
    queries read."""

    def __init__(self, ts_bases, ts_slopes, ts_widths, ts_words,
                 vals: np.ndarray, rows: np.ndarray, enc: dict | None = None):
        self.ts_bases, self.ts_slopes = ts_bases, ts_slopes
        self.ts_widths, self.ts_words = ts_widths, ts_words
        self.vals = vals  # float64 [nb, K, 128]
        self.rows = rows  # int32 [nb]
        self._enc = enc or {}  # column → (firsts, shifts, widths, words)

    def __len__(self) -> int:
        return len(self.rows)

    @staticmethod
    def encode(ts: np.ndarray, vals: np.ndarray,
               rows: np.ndarray) -> "MultiPageBlocks":
        """Blocks of timestamps int64 [nb, 128] and values float64 [nb, K,
        128] (lanes past ``rows`` ignored)."""
        live = np.arange(BLOCK)[None, None, :] < np.asarray(rows)[:, None,
                                                                  None]
        return MultiPageBlocks(*encode_ts_blocks(ts, rows),
                               np.where(live, vals, 0.0),
                               np.asarray(rows, np.int32))

    def column(self, j: int) -> PageBlocks:
        """Column ``j``'s blocks as scalar page blocks over the shared
        timestamp blocks."""
        enc = self._enc.get(j)
        if enc is None:
            enc = self._enc[j] = encode_f32_blocks(
                np.ascontiguousarray(self.vals[:, j]).astype(np.float32),
                self.rows)
        return PageBlocks(self.ts_bases, self.ts_slopes, self.ts_widths,
                          self.ts_words, *enc, self.rows)

    @staticmethod
    def concat(parts: list["MultiPageBlocks"]) -> "MultiPageBlocks":
        common = set.intersection(*(set(p._enc) for p in parts))
        return MultiPageBlocks(
            *(np.concatenate([getattr(p, n) for p in parts]) for n in
              ("ts_bases", "ts_slopes", "ts_widths", "ts_words", "vals",
               "rows")),
            {j: tuple(np.concatenate([p._enc[j][i] for p in parts])
                      for i in range(4)) for j in common})

    def take(self, idx: np.ndarray) -> "MultiPageBlocks":
        return MultiPageBlocks(
            *(getattr(self, n)[idx] for n in
              ("ts_bases", "ts_slopes", "ts_widths", "ts_words", "vals",
               "rows")),
            {j: tuple(a[idx] for a in e) for j, e in self._enc.items()})


def multi_chunk_blocks(ts: np.ndarray, cols: np.ndarray, n: np.ndarray):
    """``chunk_blocks`` for rows of K value columns: ts int64 [C, T], cols
    float64 [C, T, K], ``n[c]`` valid → (ts blocks [B, 128], value blocks
    [B, K, 128], rows [B], blocks a row [C])."""
    tb, _, rb, per = chunk_blocks(ts, cols[..., 0], n)
    vb = np.stack([chunk_blocks(ts, cols[..., j], n)[1]
                   for j in range(cols.shape[2])], axis=1)
    return tb, vb, rb, per


def hist_chunk_blocks(ts: np.ndarray, counts: np.ndarray, n: np.ndarray):
    """``chunk_blocks`` for histogram rows: ts int64 [C, T], per-sample
    slots int64 [C, T, B] (cumulative counts), ``n[c]`` valid → (ts blocks
    [nb, 128], slot blocks [nb, B, 128], rows [nb], blocks a row [C])."""
    C, T, B = counts.shape
    tb, _, rows, per = chunk_blocks(ts, ts, n)
    nbw = max(-(-T // BLOCK), 1)
    pad = nbw * BLOCK - T
    c = np.pad(counts, ((0, 0), (0, pad), (0, 0))) if pad else counts
    keep = (np.arange(nbw)[None, :] < per[:, None]).ravel()
    # [C, T, B] -> [C, nbw, B, 128]: a block's buckets side by side
    blocks = c.reshape(C, nbw, BLOCK, B).transpose(0, 1, 3, 2)
    return tb, blocks.reshape(C * nbw, B, BLOCK)[keep], rows, per


def pack_series_pages(per_series, start: int):
    """Reference signature: per-series lists of ``(ts_page, val_page,
    nrows)`` → (packed arrays, counts)."""
    tables, row_of = [], []
    for i, entries in enumerate(per_series):
        for tsp, vp, nrows in entries:
            tables.append(PageBlocks.from_pages(tsp, vp, nrows))
            row_of.append(np.full(tsp.num_blocks, i))
    if not tables:
        return pack_blocks([], np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.int64), len(per_series), start)
    table = PageBlocks.concat(tables)
    row = np.concatenate(row_of).astype(np.int64)
    return pack_blocks([table], np.zeros(len(table), np.int64),
                       np.arange(len(table)), row, len(per_series), start)


def pack_hist_blocks(tables: list[HistPageBlocks], table_of: np.ndarray,
                     block_of: np.ndarray, row_of: np.ndarray, n_rows: int,
                     start: int, buckets: int):
    """``pack_blocks`` for histogram blocks: the nine arrays of
    ``assemble_hist`` (ts fields [P, NB(, 128)], bucket fields [P, B, NB(,
    128)] with int64 bases, block counts [P, NB]) and the valid-sample
    count of each row. Tables of fewer than ``buckets`` buckets fill the
    first slots; the rest stay zero (the reference's padding)."""
    P, NB, slot = _layout(row_of, n_rows)
    B = buckets
    rel_bases = np.zeros((P, NB), np.int32)
    ts_slopes = np.zeros((P, NB), np.int32)
    ts_widths = np.zeros((P, NB), np.int32)
    ts_words = np.zeros((P, NB, WORDS_PER_BLOCK_MAX), np.uint32)
    b_bases = np.zeros((P, B, NB), np.int64)
    b_slopes = np.zeros((P, B, NB), np.int32)
    b_widths = np.zeros((P, B, NB), np.int32)
    b_words = np.zeros((P, B, NB, WORDS_PER_BLOCK_MAX), np.uint32)
    blk_counts = np.zeros((P, NB), np.int32)
    counts = np.zeros(P, np.int64)
    for t, tab in enumerate(tables):
        sel = np.flatnonzero(table_of == t)
        if not len(sel):
            continue
        r, s, b = row_of[sel], slot[sel], block_of[sel]
        Bt = tab.buckets
        rel_bases[r, s] = (tab.ts_bases[b] - (
            start if np.ndim(start) == 0 else start[r])).astype(np.int32)
        ts_slopes[r, s] = tab.ts_slopes[b]
        ts_widths[r, s] = tab.ts_widths[b]
        ts_words[r, s] = tab.ts_words[b]
        b_bases[r, :Bt, s] = tab.b_bases[b]
        b_slopes[r, :Bt, s] = tab.b_slopes[b]
        b_widths[r, :Bt, s] = tab.b_widths[b]
        b_words[r, :Bt, s] = tab.b_words[b]
        blk_counts[r, s] = tab.rows[b]
        counts += np.bincount(r, tab.rows[b], P).astype(np.int64)
    packed = (rel_bases, ts_slopes, ts_widths, ts_words, b_bases, b_slopes,
              b_widths, b_words, blk_counts)
    return packed, counts.astype(np.int32)


def to_device(packed, device: torch.device):
    """Numpy packed arrays → tensors on ``device``: int32 (u32 bits kept),
    int64 bases as int64."""
    out = []
    for a in packed:
        t = u32_as_i32(a) if a.dtype == np.uint32 else torch.from_numpy(a)
        out.append(t.to(device))
    return tuple(out)


def decode_packed(packed, plain: bool = False):
    """Decode packed pages → (ts, vals, valid) [P, NB*128]: ts relative to
    the batch base, gaps given the previous real timestamp (leading gaps
    ``TS_GAP_MIN``). ``plain`` uses B1/B2's plain versions on any device."""
    (rel_bases, ts_slopes, ts_widths, ts_words, v_firsts, v_shifts,
     v_widths, v_words, blk_counts) = packed
    dec_ts = decode_ts_blocks_plain if plain else decode_ts_blocks
    dec_f32 = decode_f32_blocks_plain if plain else decode_f32_blocks
    off = dec_ts(ts_slopes.reshape(-1), ts_widths.reshape(-1),
                 ts_words.reshape(-1, BLOCK))
    vals = dec_f32(v_firsts.reshape(-1), v_shifts.reshape(-1),
                   v_widths.reshape(-1), v_words.reshape(-1, BLOCK))
    return fill_gaps(rel_bases, blk_counts, off, vals)


def fill_gaps(rel_bases, blk_counts, off, vals):
    """The torch glue after B1/B2: per-block offsets [P*NB, 128] and values
    → (ts, vals, valid) [P, NB*128]. A lane is valid below its block's
    count and where its value is not NaN: a NaN sample (a Prometheus
    staleness marker) is dropped, as the reference's host decode drops it.
    ts = base + offset on valid lanes and the running max over the row, so
    gaps (NaN samples among them) take the previous real timestamp.
    Integer offsets (``fill_hist`` passes timestamps as values) hold no
    NaN."""
    P, NB = rel_bases.shape
    lane = torch.arange(BLOCK, dtype=torch.int32, device=off.device)
    valid = (lane[None, :] < blk_counts.reshape(-1, 1)) & (vals == vals)
    ts = torch.where(valid, rel_bases.reshape(-1, 1) + off, TS_GAP_MIN)
    S = NB * BLOCK
    ts = torch.cummax(ts.reshape(P, S), 1).values
    return ts, vals.reshape(P, S), valid.reshape(P, S)


def assemble(packed, range_len: int):
    """Torch ``_assemble``: decoded (kernels B1 and B2), gap-filled
    (ts, vals, valid) with validity restricted to the query range
    [0, range_len]."""
    ts, vals, valid = decode_packed(packed)
    valid = valid & (ts >= 0) & (ts <= range_len)
    return ts, vals, valid


def fill_hist(rel_bases, blk_counts, b_bases, ts_off, b_off,
              range_len: int):
    """The torch glue after B1 for histograms: timestamp offsets [P*NB,
    128] → (ts, valid) [P, S] as ``fill_gaps`` and the query range give
    them; bucket offsets [P*B*NB, 128] plus each block's int64 base, both
    exact in float64 → cumulative counts [P, B, S]."""
    ts, _, valid = fill_gaps(rel_bases, blk_counts, ts_off, ts_off)
    valid = valid & (ts >= 0) & (ts <= range_len)
    P, B, NB = b_bases.shape
    counts = b_off.to(torch.float64)
    counts += b_bases.to(torch.float64).reshape(-1, 1)
    return ts, counts.reshape(P, B, NB * BLOCK), valid


def assemble_hist(packed, range_len: int, plain: bool = False):
    """Torch ``_assemble_hist``: (ts [P, S], counts float64 [P, B, S], valid
    [P, S]) from ``pack_hist_blocks`` arrays. B1 decodes each series'
    timestamp blocks once and every bucket block in one launch; each
    series' timestamp row serves its B bucket rows. Bucket lanes past a
    block's count decode as the reference decodes them (the block's line),
    masked by ``valid``. ``plain`` uses B1's plain version on any device."""
    (rel_bases, ts_slopes, ts_widths, ts_words, b_bases, b_slopes, b_widths,
     b_words, blk_counts) = packed
    dec = decode_ts_blocks_plain if plain else decode_ts_blocks
    ts_off = dec(ts_slopes.reshape(-1), ts_widths.reshape(-1),
                 ts_words.reshape(-1, BLOCK))
    b_off = dec(b_slopes.reshape(-1), b_widths.reshape(-1),
                b_words.reshape(-1, BLOCK))
    return fill_hist(rel_bases, blk_counts, b_bases, ts_off, b_off,
                     range_len)


# ---------------------------------------------------------------------------
# a selection's batch on the card


@dataclass
class DeviceBatch:
    """The packed pages of selected series on the card (the reference's
    ``DeviceSeriesBatch`` holds them decoded; here the kernels decode them
    where they are used): batch rows in selection order, timestamps
    relative to ``base``."""

    keys: list               # RangeVectorKey per series (metric kept)
    packed: tuple | None     # device tensors, [P, NB(, 128)]
    counts: np.ndarray       # valid samples a series
    vmax: float              # largest finite |value| in the selected pages
    is_counter: bool         # the read column is a counter
    base: int                # ms: the selected data range [base, end]
    end: int
    les: np.ndarray | None = None  # bucket bounds of a histogram batch
    nbytes: int = 0
    _out_keys: list | None = None
    version: int = 0  # the owner's version the batch is valid at

    @property
    def out_keys(self) -> list:
        """Series keys of a range function's output (metric dropped)."""
        if self._out_keys is None:
            self._out_keys = [k.drop_metric() for k in self.keys]
        return self._out_keys


def read_column(schema: str, column: str | None) -> Column:
    """The column a selector reads in ``schema``: the one named
    ``column`` if the schema has it, else the value column. The timestamp
    column is no value: the reference's exec engine raises on it."""
    data = SCHEMAS[schema].data
    idx = next((i for i, c in enumerate(data.columns) if c.name == column),
               data.value_column)
    if idx == 0:
        raise UnsupportedQuery(f"the {column} column of {schema} holds no "
                               f"values (the reference's exec engine "
                               f"raises too)")
    return data.columns[idx]


MIXED_KINDS = ("the selector matches both histogram and scalar series, "
               "which one batch does not hold")
MIXED_MULTI = ("the selector matches both rollup (ds-gauge) and other "
               "series, which one batch does not hold")


def build_device_batch(selected, start: int, end: int, device: torch.device,
                       column: str | None = None, versions=None,
                       blocks: list | None = None):
    """Select, pack and upload the pages of ``selected``, a list of
    (shard, partition ids), for [start, end]; rows follow that order. All
    partitions are histograms or none are; a histogram batch reads the
    bucket pages, or with ``column`` ``sum`` / ``count`` that column's
    value pages as scalar series. Partitions whose flushed chunks memory
    no longer holds page them in first (``core/memstore/odp.py``), as the
    reference's engines do before they build a batch; a cached batch is
    served without paging. Each shard pages in and selects under its lock
    (``Shard.select_for_batch``); the pack and the upload run without
    it. ``versions``, each shard's version read before its partitions
    were looked up, give the batch's ``version`` (their sum, moved on by
    this build's own page-ins): the owner's version it is valid at.

    The lane gate: where any shard's selected values are not exact in
    float32, every shard hands over its float64 samples instead and the
    batch is the host-decode lane's ``SeriesBatch`` (``batch.py``); the
    gate is per batch, as the reference's mesh gate is.

    ``blocks``, a device a block (a mesh's shard rows): the selection is
    cut into that many contiguous row blocks of ceil(P / blocks) rows (the
    last ones shorter or empty, as ``dist_query.pad_for_mesh`` cuts the
    reference's rows), each packed and uploaded to its device, and the
    answer is a ``MeshBatch`` of them. Every block takes the lane and the
    ``vmax`` of the whole selection, so a row is evaluated as it is in
    one batch."""
    if versions is None:
        versions = [None] * len(selected)
    version = sum(v for v in versions if v is not None)
    picked = [(sh, np.asarray(p, np.int64), v)
              for (sh, p), v in zip(selected, versions) if len(p)]
    selected = [(sh, p) for sh, p, _ in picked]
    if not selected:
        return DeviceBatch([], None, np.zeros(0, np.int32), 0.0, False,
                           start, end, version=version)
    if blocks is not None:
        device = blocks[0]
    kind = np.concatenate([sh.hist[p] for sh, p in selected])
    if kind.any() and not kind.all():
        raise UnsupportedQuery(MIXED_KINDS)
    multi = np.concatenate([sh.multi[p] for sh, p in selected])
    if multi.any() and not multi.all():
        raise UnsupportedQuery(MIXED_MULTI)
    sh0, p0 = selected[0]
    col = read_column(sh0.keys[p0[0]].schema, column)
    hist = col.ctype == ColumnType.HISTOGRAM
    # a histogram's sum or count column, or a column of the rollup schema
    sub = col.name if (kind.all() and not hist) or multi.all() else None
    t0 = time.perf_counter()
    sels, host = [], False
    for shard, pids, v in picked:
        sel, now = shard.select_for_batch(pids, start, end, hist, sub,
                                          expect=v, host=host or None)
        host = host or isinstance(sel, Samples)
        sels.append((sel, now))
    if host:
        # an earlier shard's selection was exact: it hands over its
        # samples too, at the version its selection saw
        sels = [(sel, now) if isinstance(sel, Samples)
                else shard.select_for_batch(pids, start, end, False, sub,
                                            expect=now, host=True)
                for (sel, now), (shard, pids, _) in zip(sels, picked)]
    for (_, now), (_, _, v) in zip(sels, picked):
        if v is not None:
            version += now - v
    keys = [shard.keys[p] for shard, pids, _ in picked for p in pids]
    if host:
        firsts = np.cumsum([0] + [len(p) for _, p, _ in picked])
        select_s = time.perf_counter() - t0
        ts, vals, counts, seconds = build_batch(
            [(int(f), sel) for f, (sel, _) in zip(firsts, sels)], len(keys),
            start, end, device)
        whole = SeriesBatch([k.range_vector_key for k in keys], ts, vals,
                            counts, col.is_counter, start, end, version,
                            seconds={"select": select_s, **seconds})
        if blocks is None:
            return whole
        return MeshBatch.of(whole, [
            SeriesBatch(whole.keys[a:b], ts[a:b].to(dev), vals[a:b].to(dev),
                        counts[a:b], col.is_counter, start, end, version)
            if b > a else None
            for (a, b), dev in zip(_row_blocks(len(keys), len(blocks)),
                                   blocks)], blocks)
    tables, table_of, block_of, row_of = [], [], [], []
    vmax, les, n = 0.0, None, 0
    for ((tabs, t_of, b_of, r_of, x), _), (_, pids, _) in zip(sels, picked):
        if hist:
            # the first scheme of the most buckets, in batch order
            if x is not None and (les is None or len(x) > len(les)):
                les = x
        else:
            vmax = max(vmax, x[0])
        table_of.append(t_of + len(tables))
        tables.extend(tabs)
        block_of.append(b_of)
        row_of.append(r_of + n)
        n += len(pids)
    table_of, block_of, row_of = (np.concatenate(x) for x in
                                  (table_of, block_of, row_of))
    if hist:
        les = les if les is not None else np.array([np.inf])
    rvks = [k.range_vector_key for k in keys]

    def upload(a: int, b: int, device) -> DeviceBatch:
        """Rows [a, b) of the selection, packed on ``device``."""
        sel = slice(None) if (a, b) == (0, len(keys)) \
            else (row_of >= a) & (row_of < b)
        entries = (tables, table_of[sel], block_of[sel], row_of[sel] - a,
                   b - a, start)
        if hist:
            packed, counts = pack_hist_blocks(*entries, len(les))
        else:
            packed, counts = pack_blocks(*entries)
        dev = to_device(packed, device)
        return DeviceBatch(rvks[a:b], dev, counts[: b - a], vmax,
                           col.is_counter, start, end,
                           les if hist else None,
                           sum(t.numel() * t.element_size() for t in dev),
                           version=version)

    if blocks is None:
        return upload(0, len(keys), device)
    parts = [upload(a, b, dev) if b > a else None for (a, b), dev in
             zip(_row_blocks(len(keys), len(blocks)), blocks)]
    return MeshBatch(rvks, np.concatenate([b.counts for b in parts
                                           if b is not None]),
                     parts, list(blocks), les if hist else None,
                     col.is_counter, start, end, version)


def _row_blocks(P: int, n: int) -> list[tuple[int, int]]:
    """[a, b) of each of ``n`` contiguous blocks of ceil(P / n) rows."""
    per = -(-P // n)
    return [(min(i * per, P), min((i + 1) * per, P)) for i in range(n)]


@dataclass
class MeshBatch:
    """A selection's batch cut into contiguous row blocks (``blocks``: a
    ``DeviceBatch`` or ``SeriesBatch`` each, None for an empty one), each
    on its own device (``devices``), for the shard rows of a mesh; the
    keys and counts are the whole selection's, in row order."""

    keys: list
    counts: np.ndarray
    blocks: list
    devices: list
    les: np.ndarray | None
    is_counter: bool
    base: int
    end: int
    version: int = 0
    _out_keys: list | None = None

    @staticmethod
    def of(whole, blocks: list, devices: list) -> "MeshBatch":
        """The blocks of ``whole``, a batch of the whole selection."""
        return MeshBatch(whole.keys, whole.counts, blocks, list(devices),
                         whole.les, whole.is_counter, whole.base, whole.end,
                         whole.version)

    @property
    def out_keys(self) -> list:
        """Series keys of a range function's output (metric dropped)."""
        if self._out_keys is None:
            self._out_keys = [k.drop_metric() for k in self.keys]
        return self._out_keys

    @property
    def rows(self) -> list[tuple[int, int]]:
        """[a, b) of each block."""
        return _row_blocks(len(self.keys), len(self.blocks))

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.blocks if b is not None)

    def footprint(self) -> dict:
        """Device → bytes of the blocks on it."""
        out: dict = {}
        for b, dev in zip(self.blocks, self.devices):
            if b is not None:
                key = device_key(dev)
                out[key] = out.get(key, 0) + b.nbytes
        return out


def device_key(device) -> torch.device:
    """``device`` with its index (a card named without one is the current
    card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _budget(device: torch.device) -> int:
    """Half of a card's memory; 4 GiB on the CPU."""
    return torch.cuda.get_device_properties(device).total_memory // 2 \
        if device.type == "cuda" else 1 << 32


def compact_rows(ts: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor):
    """Decoded rows (``assemble``'s ts, vals, valid [P, S]) with each
    row's valid samples moved to a prefix, as ``dist_query``'s programs
    take them: → (ts int32 [P, S] with ``TS_PAD`` past the samples, vals
    [P, S] zero past them, counts int64 [P])."""
    from filodb_tpu_torch.query.engine.batch import TS_PAD

    P, S = ts.shape
    at = torch.where(valid, torch.cumsum(valid, 1) - 1, S)
    ts_c = torch.full((P, S + 1), TS_PAD, dtype=torch.int32,
                      device=ts.device)
    vals_c = torch.zeros((P, S + 1), dtype=vals.dtype, device=vals.device)
    ts_c.scatter_(1, at, ts.to(torch.int32))
    vals_c.scatter_(1, at, vals)
    return ts_c[:, :S], vals_c[:, :S], valid.sum(1)


class BatchCache:
    """Uploaded batches of both engines under one budget of device bytes
    a card (half its memory), least recently used dropped first: a mesh
    batch's blocks count against the cards they lie on.
    A batch is kept until its owner, the store (mesh) or a shard (exec
    leaf), ingests again: it is found by its key, its owner (the same
    object: a shard of a downsample or cold tier shares its number with a
    raw one), its owner's version and, where given, its partition ids,
    which are compared, not hashed (a shard's may number 10^5). ``put`` takes the batch's ``version``, not
    the owner's version after the build: a writer that ingests between a
    lookup and its selection moves the owner past it, so the batch is not
    served as that newer version."""

    def __init__(self, device: torch.device):
        self.device = device_key(device)
        self.budget = _budget(self.device)
        # key → (owner, owner's version, pids, batch), least recent first
        self._entries: dict = {}

    def get(self, key, owner, pids: np.ndarray | None = None):
        hit = self._entries.get(key)
        if hit is None or hit[0] is not owner or hit[1] != owner.version \
                or (pids is not None and not np.array_equal(hit[2], pids)):
            return None
        self._entries[key] = self._entries.pop(key)
        return hit[3]

    def _footprint(self, batch) -> dict:
        """Device → bytes of an entry: a ``MeshBatch``'s blocks each on
        its slot's card, anything else on its own device (by default the
        cache's)."""
        f = getattr(batch, "footprint", None)
        if f is not None:
            return f()
        dev = getattr(batch, "device", None)
        return {self.device if dev is None else device_key(dev):
                batch.nbytes}

    def budget_of(self, device) -> int:
        """The byte budget of ``device``: ``budget`` for the cache's own,
        half of any other card."""
        device = device_key(device)
        return self.budget if device == self.device else _budget(device)

    def used(self, device) -> int:
        """Device bytes of the entries held on ``device``."""
        device = device_key(device)
        return sum(self._footprint(e[3]).get(device, 0)
                   for e in self._entries.values())

    def put(self, key, owner, pids, batch: DeviceBatch) -> None:
        """Keep ``batch``, dropping the least recently used entries until
        each card it lies on has room for its bytes there."""
        self._entries.pop(key, None)
        for k in [k for k, (o, v, _, _) in self._entries.items()
                  if o.version != v]:
            del self._entries[k]
        need = self._footprint(batch)
        while self._entries and any(self.used(d) + n > self.budget_of(d)
                                    for d, n in need.items()):
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (owner, batch.version, pids, batch)

    def clear(self) -> None:
        """Drop every batch (the next query of each leaf is cold)."""
        self._entries.clear()

    def batches(self, engine: str | None = None) -> list[DeviceBatch]:
        """The batches held, of one engine (a key's first item) or all."""
        return [e[3] for k, e in self._entries.items()
                if engine is None or k[0] == engine]

    def nbytes(self, engine: str | None = None) -> int:
        """Device bytes of the packed pages held."""
        return sum(b.nbytes for b in self.batches(engine))
