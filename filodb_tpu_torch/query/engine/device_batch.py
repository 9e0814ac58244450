"""Packed device pages of a series batch, and their assembly on the card.

Port of ``filodb_tpu/query/engine/device_batch.py``: ``pack_series_pages``
lays the page blocks of each selected series side by side in dense
[P, NB, ...] arrays (P and NB padded to powers of two), and ``assemble`` is
the torch form of ``_assemble``: decode every block through kernels B1 and
B2, add the block base, mark validity from ``blk_counts``, give gaps the
previous real timestamp (``torch.cummax``) and apply the query-range mask.

Packing is vectorised: page blocks live in ``PageBlocks`` tables (one per
shard for sealed chunks, one for the encoded write buffers), and a batch is
a list of block ids per series, gathered with numpy. ``pack_series_pages``
keeps the reference's signature (per-series lists of
``(ts_page, val_page, nrows)``) on top of the same packer; the tests hold
its output byte-equal to the reference's.
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


def pack_blocks(tables: list[PageBlocks], table_of: np.ndarray,
                block_of: np.ndarray, row_of: np.ndarray, n_rows: int,
                start: int):
    """Gather page blocks into the dense batch layout.

    Entry j (ordered by row, then by time) puts block ``block_of[j]`` of
    ``tables[table_of[j]]`` into the next slot of row ``row_of[j]``.
    Returns the nine [P, NB(, 128)] arrays in ``_assemble``'s parameter
    order, with timestamps rebased to ``start``, and the valid-sample count
    of each row."""
    P = _pow2(n_rows, 4)
    per_row = np.bincount(row_of, minlength=n_rows) if len(row_of) \
        else np.zeros(n_rows, np.int64)
    NB = _pow2(max(int(per_row.max(initial=0)), 1))
    first = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    slot = np.arange(len(row_of)) - first[row_of]
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


def to_device(packed, device: torch.device):
    """Numpy packed arrays → int32 tensors on ``device`` (u32 bits kept)."""
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
    → (ts, vals, valid) [P, NB*128], ts = base + offset on valid lanes and
    the running max over the row (gaps take the previous real timestamp)."""
    P, NB = rel_bases.shape
    lane = torch.arange(BLOCK, dtype=torch.int32, device=off.device)
    valid = lane[None, :] < blk_counts.reshape(-1, 1)
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
