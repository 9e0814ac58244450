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
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

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
    order, with timestamps rebased to ``start``, and the valid-sample count
    of each row."""
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
        rel_bases[r, s] = (tab.ts_bases[b] - start).astype(np.int32)
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
    block and B bucket blocks (int pages, int64 bases) a row."""

    ts_bases: np.ndarray    # int64 [nb]
    ts_slopes: np.ndarray   # int32 [nb]
    ts_widths: np.ndarray   # int32 [nb]
    ts_words: np.ndarray    # uint32 [nb, 128]
    b_bases: np.ndarray     # int64 [nb, B]
    b_slopes: np.ndarray    # int32 [nb, B]
    b_widths: np.ndarray    # int32 [nb, B]
    b_words: np.ndarray     # uint32 [nb, B, 128]
    rows: np.ndarray        # int32 [nb]

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def buckets(self) -> int:
        return self.b_bases.shape[1]

    @staticmethod
    def encode(ts: np.ndarray, counts: np.ndarray,
               rows: np.ndarray) -> "HistPageBlocks":
        """Encode blocks of timestamps int64 [nb, 128] and cumulative bucket
        counts int64 [nb, B, 128] (lanes past ``rows`` ignored)."""
        nb, B = counts.shape[:2]
        bb, bs, bw, bwd = encode_ts_blocks(counts.reshape(nb * B, BLOCK),
                                           np.repeat(rows, B))
        return HistPageBlocks(*encode_ts_blocks(ts, rows),
                              bb.reshape(nb, B), bs.reshape(nb, B),
                              bw.reshape(nb, B), bwd.reshape(nb, B, BLOCK),
                              np.asarray(rows, np.int32))

    @staticmethod
    def concat(parts: list["HistPageBlocks"]) -> "HistPageBlocks":
        return HistPageBlocks(*(
            np.concatenate([getattr(p, f.name) for p in parts])
            for f in fields(HistPageBlocks)))


def hist_chunk_blocks(ts: np.ndarray, counts: np.ndarray, n: np.ndarray):
    """``chunk_blocks`` for histogram rows: ts int64 [C, T], cumulative
    counts int64 [C, T, B], ``n[c]`` valid → (ts blocks [nb, 128], count
    blocks [nb, B, 128], rows [nb], blocks a row [C])."""
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
        rel_bases[r, s] = (tab.ts_bases[b] - start).astype(np.int32)
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
