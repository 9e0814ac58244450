"""Aggregate pyramids: the summary objects of a segment and of a bucket.

Port of ``filodb_tpu/core/store/pyramid.py``; the objects are the
reference's byte for byte. At seal and at compaction the object store
rolls the chunk summaries of what it wrote up into

    seg-XXXXXXXX.pyr   one merged row and sketch a (part key, column),
                       plus the chunk rows (in chunk-id order), so a
                       reader can descend a level without a payload
    bkt-XXXXXXXX.pyr   one merged row a (part key, column) over a whole
                       compacted bucket (``covers``: the segment seqs)

with a footer of population sketches a object (top-k of per-series
maxima, an HLL of part keys: ``memory/sketches.py``), which make
``approx_topk`` and ``approx_cardinality`` summary-only scans.

The port's store holds chunks as serialized rows, not ``Chunk`` objects:
a row's summaries are read back from its ``SC01`` section
(``Chunk.deserialize``), or made from its decoded vectors where it has
none (``ensure_summary``), bitwise what the reference's seal stored.

Pyramid objects are derived data: a missing, corrupt or raced one
demotes its reader a level (bucket, segment, chunk rows, payload).
Every merged row is ``merge_rows_seq``, a strict left fold over the
chunk rows with samples in chunk-id order, so a reader that folds the
decoded payloads again gets the stored row bit for bit. Pyramids carry a
zlib CRC32 footer of their own; this module does not import the store.
"""

from __future__ import annotations

import struct
import time
import zlib

import numpy as np

from filodb_tpu_torch.memory.chunk import (
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
    SKETCH_BUCKETS,
    STATS_WIDTH,
    Chunk,
    ensure_summary,
)
from filodb_tpu_torch.memory.sketches import HLLSketch, TopKSketch, _hash64
from filodb_tpu_torch.utils.metrics import Counter

PYR_WRITTEN_SEG = Counter("filodb_pyramid_objects_written",
                          {"level": "segment"},
                          help="segment pyramid objects written")
PYR_WRITTEN_BKT = Counter("filodb_pyramid_objects_written",
                          {"level": "bucket"},
                          help="bucket pyramid objects written")
PYR_BACKFILLED = Counter(
    "filodb_pyramid_backfilled",
    help="legacy segments that gained pyramid coverage via compaction")
PYR_SERVED = Counter(
    "filodb_pyramid_served",
    help="cold-tier leaf evaluations served from pyramid aggregates")
PYR_FALLBACK = Counter(
    "filodb_pyramid_fallback",
    help="pyramid reads demoted to chunk-payload fallback")
PYR_NODES_BUCKET = Counter("filodb_pyramid_nodes", {"level": "bucket"})
PYR_NODES_SEGMENT = Counter("filodb_pyramid_nodes", {"level": "segment"})
PYR_NODES_CHUNK = Counter("filodb_pyramid_nodes", {"level": "chunk"})
PYR_NODES_DECODE = Counter("filodb_pyramid_nodes", {"level": "decode"})
PYR_BYTES_DOWN = Counter(
    "filodb_pyramid_bytes_down",
    help="bytes of pyramid objects fetched from the object store")

_MAGIC_SEG = b"FPY1"
_MAGIC_BKT = b"FPB1"
_ENT_HDR = struct.Struct("<HBBI")  # pk_len, col, flags, n_chunk_rows
_F_SKETCH = 1


# ---------------------------------------------------------------------------
# the merge (the scalar form of the sidecar lane's ``merge``)

def _merge_row(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Two stats rows with samples, consecutive in time, merged, with the
    counter-reset carry at their boundary."""
    out = a.copy()
    out[S_COUNT] = a[S_COUNT] + b[S_COUNT]
    out[S_SUM] = a[S_SUM] + b[S_SUM]
    out[S_SUMSQ] = a[S_SUMSQ] + b[S_SUMSQ]
    out[S_MIN] = min(a[S_MIN], b[S_MIN])
    out[S_MAX] = max(a[S_MAX], b[S_MAX])
    out[S_LAST_TS] = b[S_LAST_TS]
    out[S_LAST_VAL] = b[S_LAST_VAL]
    bdrop = b[S_FIRST_VAL] < a[S_LAST_VAL]
    out[S_RESETS] = a[S_RESETS] + bdrop + b[S_RESETS]
    out[S_CORR] = (a[S_CORR] + (a[S_LAST_VAL] if bdrop else 0.0)) \
        + b[S_CORR]
    out[S_CHANGES] = a[S_CHANGES] \
        + (b[S_FIRST_VAL] != a[S_LAST_VAL]) + b[S_CHANGES]
    return out


def merge_rows_seq(rows) -> np.ndarray | None:
    """Strict left fold of ``_merge_row`` over the rows with samples (in
    chunk-id order); None where no row has one. Writer and decode mode
    run this same fold."""
    acc = None
    for r in rows:
        if r[S_COUNT] <= 0:
            continue
        acc = r.copy() if acc is None else _merge_row(acc, r)
    return acc


def _rows_ordered(rows: np.ndarray) -> bool:
    """The rows with samples (chunk-id order) are in time order and their
    valid spans do not overlap: the fold's exactness condition."""
    live = rows[rows[:, S_COUNT] > 0]
    if len(live) < 2:
        return True
    starts = live[:, S_FIRST_TS]
    ends = live[:, S_LAST_TS]
    return not (np.any(np.diff(starts) <= 0)
                or np.any(starts[1:] <= ends[:-1]))


# ---------------------------------------------------------------------------
# build (the store's seal and compaction hand over what they wrote)

def _collect(pyr_rows, value_col: int = 1):
    """Per (part-key blob, column): chunk ids, their stats rows, the
    merged row and sketch, in chunk-id order, from ``(blob, chunk id,
    serialized chunk)`` rows. A (key, column) whose chunks do not all have
    a summary of the column, or whose chunks overlap, is left out: readers
    fall back to payloads there."""
    groups: dict[tuple[bytes, int], dict] = {}
    n_chunks: dict[bytes, int] = {}
    for pk_blob, _cid, data in pyr_rows:
        n_chunks[pk_blob] = n_chunks.get(pk_blob, 0) + 1
        ch = Chunk.deserialize(data)
        summary = ensure_summary(ch)
        ncols = len(summary) if summary is not None else 0
        for col in range(1, ncols):
            cs = summary[col]
            if cs is None:
                continue
            g = groups.setdefault((pk_blob, col),
                                  {"cids": [], "rows": [], "sketches": []})
            g["cids"].append(ch.id)
            g["rows"].append(cs.stats)
            g["sketches"].append(cs.sketch)
    out = {}
    for (pk_blob, col), g in groups.items():
        if len(g["cids"]) != n_chunks[pk_blob]:
            continue
        order = np.argsort(np.asarray(g["cids"], np.int64), kind="stable")
        cids = np.asarray(g["cids"], np.int64)[order]
        rows = np.vstack([g["rows"][i] for i in order])
        sketches = [g["sketches"][i] for i in order]
        if not _rows_ordered(rows):
            continue
        merged = merge_rows_seq(rows)
        if merged is None:
            continue
        sk = None
        if all(s is not None for s in sketches):
            sk = np.zeros(SKETCH_BUCKETS, np.int64)
            for s, row in zip(sketches, rows):
                if row[S_COUNT] > 0:
                    sk += s.astype(np.int64)
        out[(pk_blob, col)] = (cids, rows, merged, sk)
    return out


def _footer_sketches(entries, value_col: int = 1) -> tuple:
    """(top-k over the value column's per-series maxima, HLL over the part
    keys) of one pyramid object."""
    topk = TopKSketch(capacity=64)
    hll = HLLSketch()
    for (pk_blob, col), (_cids, _rows, merged, _sk) in entries.items():
        if col != value_col:
            continue
        hll.update_hashes(np.array([_hash64(pk_blob)], np.uint64))
        topk.update(pk_blob, float(merged[S_MAX]))
    return topk, hll


def _pack_entries(entries, with_chunk_rows: bool) -> list[bytes]:
    parts = [struct.pack("<I", len(entries))]
    for (pk_blob, col) in sorted(entries):
        cids, rows, merged, sk = entries[(pk_blob, col)]
        flags = _F_SKETCH if sk is not None else 0
        parts.append(_ENT_HDR.pack(len(pk_blob), col, flags, len(cids)))
        parts.append(pk_blob)
        parts.append(cids.astype("<i8").tobytes())
        if with_chunk_rows:
            parts.append(rows.astype("<f8").tobytes())
        parts.append(merged.astype("<f8").tobytes())
        if sk is not None:
            parts.append(sk.astype("<i8").tobytes())
    return parts


def _pack_footer(topk: TopKSketch, hll: HLLSketch) -> list[bytes]:
    tb = topk.serialize()
    return [struct.pack("<I", len(tb)), tb, hll.serialize()]


def build_segment_pyramid(pyr_rows, value_col: int = 1) -> bytes | None:
    """One segment's pyramid object from its ``(blob, chunk id, serialized
    chunk)`` rows; None where nothing has a summary."""
    entries = _collect(pyr_rows, value_col)
    if not entries:
        return None
    topk, hll = _footer_sketches(entries, value_col)
    body = b"".join([_MAGIC_SEG] + _pack_entries(entries, True)
                    + _pack_footer(topk, hll))
    PYR_WRITTEN_SEG.inc()
    return body + struct.pack("<I", zlib.crc32(body))


def build_bucket_pyramid(pyr_rows, covers, value_col: int = 1
                         ) -> bytes | None:
    """A bucket's pyramid object over segment seqs ``covers`` (compaction
    leaves a bucket one segment, so its merged rows are that segment's;
    stored without the chunk rows)."""
    entries = _collect(pyr_rows, value_col)
    if not entries:
        return None
    topk, hll = _footer_sketches(entries, value_col)
    head = [_MAGIC_BKT, struct.pack("<I", len(covers)),
            np.asarray(sorted(covers), "<i8").tobytes()]
    body = b"".join(head + _pack_entries(entries, False)
                    + _pack_footer(topk, hll))
    PYR_WRITTEN_BKT.inc()
    return body + struct.pack("<I", zlib.crc32(body))


# ---------------------------------------------------------------------------
# parse (the reader's side)

class PyramidParseError(Exception):
    """A pyramid object failed its CRC or its structure: readers demote a
    level, the query does not fail."""


def _parse_common(data: bytes, magic: bytes, key: str):
    if len(data) < len(magic) + 4 or data[:4] != magic:
        raise PyramidParseError(f"{key}: bad magic/size")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    body = data[:-4]
    if zlib.crc32(body) != crc:
        raise PyramidParseError(f"{key}: CRC32 mismatch")
    return body


def _unpack_entries(body: bytes, off: int, with_chunk_rows: bool):
    (n_entries,) = struct.unpack_from("<I", body, off)
    off += 4
    entries: dict[tuple[bytes, int], dict] = {}
    for _ in range(n_entries):
        pk_len, col, flags, n = _ENT_HDR.unpack_from(body, off)
        off += _ENT_HDR.size
        pk_blob = bytes(body[off:off + pk_len])
        off += pk_len
        cids = np.frombuffer(body, "<i8", n, off).copy()
        off += 8 * n
        rows = None
        if with_chunk_rows:
            rows = np.frombuffer(body, "<f8", n * STATS_WIDTH,
                                 off).reshape(n, STATS_WIDTH).copy()
            off += 8 * n * STATS_WIDTH
        merged = np.frombuffer(body, "<f8", STATS_WIDTH, off).copy()
        off += 8 * STATS_WIDTH
        sk = None
        if flags & _F_SKETCH:
            sk = np.frombuffer(body, "<i8", SKETCH_BUCKETS, off).copy()
            off += 8 * SKETCH_BUCKETS
        entries[(pk_blob, int(col))] = {
            "cids": cids, "rows": rows, "row": merged, "sketch": sk}
    return entries, off


def _unpack_footer(body: bytes, off: int):
    (tlen,) = struct.unpack_from("<I", body, off)
    off += 4
    topk, _ = TopKSketch.deserialize(body[off:off + tlen])
    off += tlen
    hll, _ = HLLSketch.deserialize(body, off)
    return topk, hll


def parse_segment_pyramid(data: bytes, key: str = "?") -> dict:
    """{"entries": {(blob, col): {cids, rows, row, sketch}}, "topk",
    "hll"}; raises :class:`PyramidParseError`."""
    body = _parse_common(data, _MAGIC_SEG, key)
    try:
        entries, off = _unpack_entries(body, 4, True)
        topk, hll = _unpack_footer(body, off)
    except (struct.error, ValueError) as e:
        raise PyramidParseError(f"{key}: truncated: {e}") from None
    return {"entries": entries, "topk": topk, "hll": hll}


def parse_bucket_pyramid(data: bytes, key: str = "?") -> dict:
    """As :func:`parse_segment_pyramid`, with ``covers`` (the segment seqs
    the bucket row summarizes) and no chunk rows."""
    body = _parse_common(data, _MAGIC_BKT, key)
    try:
        (n_cov,) = struct.unpack_from("<I", body, 4)
        off = 8
        covers = [int(c) for c in np.frombuffer(body, "<i8", n_cov, off)]
        off += 8 * n_cov
        entries, off = _unpack_entries(body, off, False)
        topk, hll = _unpack_footer(body, off)
    except (struct.error, ValueError) as e:
        raise PyramidParseError(f"{key}: truncated: {e}") from None
    return {"entries": entries, "topk": topk, "hll": hll,
            "covers": covers}


# ---------------------------------------------------------------------------
# a shard's read-through cache

_NEG_TTL_S = 5.0


class ShardPyramidCache:
    """Read-through cache of one shard's pyramid objects. Parsed objects
    are kept for good (a pyramid key is never rewritten in place); a miss
    (not uploaded yet, mid-backfill) is remembered for a few seconds, so a
    read race heals itself."""

    def __init__(self, store, dataset: str, shard: int):
        self.store = store
        self.dataset = dataset
        self.shard = shard
        self._segs: dict[int, dict] = {}
        self._buckets: dict[tuple, dict] = {}
        self._neg: dict = {}
        # the pyramid lane folds these into QueryStats.cache_hits/misses
        self.hits = 0
        self.misses = 0

    def _negative(self, key) -> bool:
        t = self._neg.get(key)
        return t is not None and time.monotonic() - t < _NEG_TTL_S

    def refs(self, pk_blob: bytes):
        return self.store.pyramid_refs(self.dataset, self.shard, pk_blob)

    def segment(self, seq: int) -> dict | None:
        p = self._segs.get(seq)
        if p is not None:
            self.hits += 1
            return p
        if self._negative(("s", seq)):
            return None
        self.misses += 1
        p = self.store.read_segment_pyramid(self.dataset, self.shard, seq)
        if p is None:
            self._neg[("s", seq)] = time.monotonic()
            return None
        self._segs[seq] = p
        return p

    def bucket(self, bkt: int, seq: int) -> dict | None:
        """``seq``: the segment seq the bucket pyramid was written under
        (compaction writes a bucket's object under a new one)."""
        p = self._buckets.get((bkt, seq))
        if p is not None:
            self.hits += 1
            return p
        if self._negative(("b", bkt, seq)):
            return None
        self.misses += 1
        p = self.store.read_bucket_pyramid(self.dataset, self.shard, bkt)
        if p is None:
            self._neg[("b", bkt, seq)] = time.monotonic()
            return None
        self._buckets[(bkt, seq)] = p
        return p

    def clear(self) -> None:
        self._segs.clear()
        self._buckets.clear()
        self._neg.clear()


def make_pyramid_cache(store, dataset: str, shard: int
                       ) -> ShardPyramidCache | None:
    """A pyramid cache where the store publishes pyramids
    (``ObjectStoreColumnStore``); None for the others, whose cold leaves
    then bypass to paging."""
    if not hasattr(store, "read_segment_pyramid"):
        return None
    return ShardPyramidCache(store, dataset, shard)
