"""Chunks: the immutable, compressed rows of one partition that the column
store keeps, and their aggregate summaries.

Copy of ``filodb_tpu/memory/chunk.py``: a chunk is one encoded vector per
data column plus its id, row count and time range; ``chunk_id`` sorts by
start time. Each scalar column may carry a summary (``ColumnSummary``: the
twelve stats slots and the log2 sketch of ``summarize_values``), written
as the trailing ``SC01`` section of ``Chunk.serialize`` and read back by
``Chunk.deserialize``; a chunk without one serializes in the layout the
reference's older readers know. ``ensure_summary`` makes a missing summary
from the decoded vectors. The sidecar lane
(``query/engine/sidecar_lane.py``) folds windows from them.

Besides the per-chunk form, ``encode_chunks`` seals and ``decode_chunks``
reads many chunks in one call of the host C++ codec: timestamp and value
arrays in, the serialized chunks out as one byte buffer with offsets
(``ChunkBytes``), and back. A flush of a million series is about two
million chunks; the batched form is what makes that a few calls.
``summarize`` makes the summaries of many chunks in one call of the same
codec, bitwise those of ``summarize_values``; ``summary_sections`` writes
their ``SC01`` sections and ``read_summaries`` reads them back.
"""

from __future__ import annotations

import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from filodb_tpu_torch import _build
from filodb_tpu_torch.core.schemas import ColumnType, Schema
from filodb_tpu_torch.memory import codecs
from filodb_tpu_torch.utils.metrics import Counter

_HEAD = struct.Struct("<qIqqI")  # id, rows, start, end, vector count
# chunks a host codec call takes, and threads it runs on
_BATCH = 4096
_WORKERS = 8


# ---------------------------------------------------------------------------
# aggregate summaries
#
# Per scalar column, twelve float64 slots made once at seal time, every sum
# accumulated left to right (np.cumsum's order), so a summary made again
# from the decoded vector is bitwise the stored one (the codecs are
# lossless): count, sum, sum of squares, min, max, first ts and value, last
# ts and value (of the non-NaN samples), resets (drops v[i] < v[i-1] over
# the non-NaN sequence), corr (the sum of the value before each drop) and
# changes (v[i] != v[i-1]); and a log2 sketch of uint16[64].

STATS_WIDTH = 12
(S_COUNT, S_SUM, S_SUMSQ, S_MIN, S_MAX, S_FIRST_TS, S_FIRST_VAL, S_LAST_TS,
 S_LAST_VAL, S_RESETS, S_CORR, S_CHANGES) = range(STATS_WIDTH)
SKETCH_BUCKETS = 64
SC_MAGIC = b"SC01"

# chunks whose summary was made after the fact: a compaction rewriting a
# segment written without summaries (``ensure_summary(backfill=True)``)
SIDECAR_BACKFILLED = Counter(
    "filodb_sidecar_backfilled",
    help="chunk summaries computed after seal (old segments, native seals)")


@dataclass(frozen=True, eq=False)
class ColumnSummary:
    """The summary of one scalar column of a chunk."""

    stats: np.ndarray  # float64 [STATS_WIDTH]
    sketch: np.ndarray | None = None  # uint16 [SKETCH_BUCKETS]


def sketch_values(vals: np.ndarray) -> np.ndarray:
    """Symmetric log2 histogram: bucket 32 zero, 33..63 positive magnitudes
    by exponent (clipped), 31..1 negative ones mirrored."""
    sk = np.zeros(SKETCH_BUCKETS, np.uint16)
    if vals.size == 0:
        return sk
    _, e = np.frexp(vals)
    mag = np.clip(e - 1 + 16, 0, 30)
    b = np.where(vals == 0, 32, np.where(vals > 0, 33 + mag, 31 - mag))
    np.add.at(sk, b.astype(np.int64), 1)
    return sk


def summarize_values(ts: np.ndarray, vals: np.ndarray,
                     with_sketch: bool = True) -> ColumnSummary:
    """The summary of one column of one chunk (or any slice of it); NaN
    samples are left out, as the decode lane drops them."""
    vals = np.asarray(vals, np.float64)
    ts = np.asarray(ts, np.int64)
    stats = np.zeros(STATS_WIDTH, np.float64)
    m = ~np.isnan(vals)
    vv = vals[m]
    if vv.size == 0:
        stats[S_MIN:S_LAST_VAL + 1] = np.nan
        return ColumnSummary(stats, sketch_values(vv) if with_sketch
                             else None)
    tv = ts[m]
    stats[S_COUNT] = vv.size
    stats[S_SUM] = np.cumsum(vv)[-1]
    stats[S_SUMSQ] = np.cumsum(vv * vv)[-1]
    stats[S_MIN] = np.min(vv)
    stats[S_MAX] = np.max(vv)
    stats[S_FIRST_TS] = tv[0]
    stats[S_FIRST_VAL] = vv[0]
    stats[S_LAST_TS] = tv[-1]
    stats[S_LAST_VAL] = vv[-1]
    if vv.size > 1:
        prev, cur = vv[:-1], vv[1:]
        drop = cur < prev
        stats[S_RESETS] = drop.sum()
        stats[S_CORR] = np.cumsum(np.where(drop, prev, 0.0))[-1]
        stats[S_CHANGES] = (cur != prev).sum()
    return ColumnSummary(stats, sketch_values(vv) if with_sketch else None)


def _summarized(ctype) -> bool:
    return ctype in (ColumnType.DOUBLE, ColumnType.TIMESTAMP)


def summarize_columns(schema: Schema, ts: np.ndarray, columns: list) -> tuple:
    """The summary tuple of a chunk sealed from raw arrays: None for the
    timestamp column and for non-scalar columns."""
    out: list[ColumnSummary | None] = [None]
    for col, data in zip(schema.data.columns[1:], columns):
        out.append(summarize_values(ts, np.asarray(data, np.float64))
                   if _summarized(col.ctype) else None)
    return tuple(out)


def ensure_summary(chunk: "Chunk", backfill: bool = False):
    """The chunk's summary tuple, made from its decoded vectors where it
    has none (memoized on the chunk); None where its timestamps do not
    decode. ``backfill``: a compaction's rewrite, counted in
    ``filodb_sidecar_backfilled`` where a summary was made."""
    if chunk.summary is not None:
        return chunk.summary
    try:
        ts = np.asarray(chunk.decode_column(0), np.int64)
    except Exception:
        return None
    out: list[ColumnSummary | None] = [None]
    for i in range(1, len(chunk.vectors)):
        try:
            dec = chunk.decode_column(i)
        except Exception:
            out.append(None)
            continue
        if isinstance(dec, np.ndarray) and dec.ndim == 1 \
                and dec.dtype.kind in "fiu" and len(dec) == len(ts):
            out.append(summarize_values(ts, dec))
        else:
            out.append(None)
    summary = tuple(out)
    object.__setattr__(chunk, "summary", summary)
    if backfill and any(c is not None for c in summary):
        SIDECAR_BACKFILLED.inc()
    return summary


def summarize(ts: np.ndarray, vals: np.ndarray, rows: np.ndarray,
              step: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Summaries of C chunks in one call of the host codec: timestamps
    int64 [C, M], values float64 [C, M * step] (sample i of chunk c at
    ``vals[c, i * step]``), ``rows[c]`` samples each → (stats float64 [C,
    12], sketch uint16 [C, 64]), bitwise ``summarize_values`` chunk by
    chunk."""
    ts = np.ascontiguousarray(ts, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    rows = np.ascontiguousarray(rows, np.int64)
    C = len(rows)
    stats = np.zeros((C, STATS_WIDTH), np.float64)
    sketch = np.zeros((C, SKETCH_BUCKETS), np.uint16)
    flags = np.zeros(C, np.int64)
    if not C:
        return stats, sketch
    fn = _build.host_fn("fh_summarize", 10)

    def one(span):
        a, b = span
        fn(ts[a:b].ctypes.data, ts.shape[1], vals[a:b].ctypes.data,
           vals.shape[1], step, rows[a:b].ctypes.data, b - a,
           stats[a:b].ctypes.data, sketch[a:b].ctypes.data,
           flags[a:b].ctypes.data)

    _on_threads(one, _spans(C))
    for c in np.flatnonzero(flags).tolist():
        # both zeros among the values: numpy picks among equal values by
        # its own reduction order, so take min and max from it
        v = vals[c, :rows[c] * step:step]
        v = v[~np.isnan(v)]
        stats[c, S_MIN], stats[c, S_MAX] = np.min(v), np.max(v)
    return stats, sketch


def summary_sections(kinds: list, stats: list, sketches: list) -> np.ndarray:
    """``SC01`` sections of C chunks as uint8 [C, L], all of one schema:
    ``kinds`` a column each (None for no summary, else the index into
    ``stats`` [C, 12] and ``sketches`` [C, 64] of that column's)."""
    C = len(stats[0]) if stats else 0
    parts = [np.tile(np.frombuffer(SC_MAGIC + bytes([len(kinds)]), np.uint8),
                     (C, 1))]
    for k in kinds:
        if k is None:
            parts.append(np.zeros((C, 1), np.uint8))
            continue
        parts += [np.full((C, 1), 2, np.uint8),
                  np.ascontiguousarray(stats[k], "<f8").view(np.uint8),
                  np.ascontiguousarray(sketches[k], "<u2").view(np.uint8)]
    return np.concatenate(parts, axis=1)


def summary_kinds(schema: Schema) -> list:
    """Per vector of ``schema``, None or the index of its summary among
    the schema's summarized columns."""
    out, j = [None], 0
    for col in schema.data.columns[1:]:
        if _summarized(col.ctype):
            out.append(j)
            j += 1
        else:
            out.append(None)
    return out


def chunk_id(start_time: int, ingestion_seq: int = 0) -> int:
    """Time-sortable chunk id: millis in high bits, sequence in low 12 bits."""
    return (start_time << 12) | (ingestion_seq & 0xFFF)


def chunk_ids(start_times: np.ndarray, seqs: np.ndarray) -> np.ndarray:
    """``chunk_id`` of many chunks."""
    return (np.asarray(start_times, np.int64) << 12) \
        | (np.asarray(seqs, np.int64) & 0xFFF)


def chunk_header(data) -> tuple[int, int, int, int]:
    """(id, rows, start time, end time) of a serialized chunk."""
    cid, rows, start, end, _ = _HEAD.unpack_from(data)
    return cid, rows, start, end


@dataclass(frozen=True)
class Chunk:
    """One encoded chunkset for a partition."""

    id: int
    num_rows: int
    start_time: int
    end_time: int
    vectors: tuple[bytes, ...]  # one encoded vector per data column
    # one ColumnSummary or None a vector; derived data, left out of equality
    summary: tuple | None = field(default=None, compare=False)

    @property
    def nbytes(self) -> int:
        return sum(len(v) for v in self.vectors)

    def decode_column(self, i: int):
        """Decode one column (memoized: chunks are immutable)."""
        cache = self.__dict__.setdefault("_decoded", {})
        out = cache.get(i)
        if out is None:
            out = cache[i] = codecs.decode_any(self.vectors[i])
        return out

    def serialize(self) -> bytes:
        parts = [_HEAD.pack(self.id, self.num_rows, self.start_time,
                            self.end_time, len(self.vectors))]
        for v in self.vectors:
            parts.append(struct.pack("<I", len(v)))
            parts.append(v)
        if self.summary is not None:
            parts += [SC_MAGIC, struct.pack("<B", len(self.summary))]
            for cs in self.summary:
                if cs is None:
                    parts.append(b"\x00")
                elif cs.sketch is None:
                    parts += [b"\x01", cs.stats.astype("<f8").tobytes()]
                else:
                    parts += [b"\x02", cs.stats.astype("<f8").tobytes(),
                              cs.sketch.astype("<u2").tobytes()]
        return b"".join(parts)

    @staticmethod
    def deserialize(data: bytes) -> "Chunk":
        cid, rows, st, et, nvec = _HEAD.unpack_from(data, 0)
        off = _HEAD.size
        vectors = []
        for _ in range(nvec):
            (ln,) = struct.unpack_from("<I", data, off)
            off += 4
            vectors.append(bytes(data[off : off + ln]))
            off += ln
        summary = None
        if bytes(data[off:off + 4]) == SC_MAGIC:
            off += 4
            ents: list[ColumnSummary | None] = []
            for _ in range(data[off]):
                off += 1
                kind = data[off]
                if kind == 0:
                    ents.append(None)
                    continue
                stats = np.frombuffer(data, "<f8", STATS_WIDTH, off + 1).copy()
                off += STATS_WIDTH * 8
                sketch = None
                if kind == 2:
                    sketch = np.frombuffer(data, "<u2", SKETCH_BUCKETS,
                                           off + 1).copy()
                    off += SKETCH_BUCKETS * 2
                ents.append(ColumnSummary(stats, sketch))
            summary = tuple(ents)
        return Chunk(cid, rows, st, et, tuple(vectors), summary)


def encode_chunk(schema: Schema, ts: np.ndarray, columns: list, seq: int = 0,
                 with_summary: bool = False) -> Chunk:
    """Encode one chunkset: ``columns`` holds one array per non-timestamp
    data column in schema order, float64 for DOUBLE and a
    ``HistogramColumn`` (or (n, nb) int64 rows) for HISTOGRAM.
    ``with_summary`` attaches the summary (``summarize_columns``)."""
    if not len(ts):
        raise ValueError("a chunk holds at least one row")
    vectors: list[bytes] = [codecs.encode_delta_delta(ts)]
    for col, data in zip(schema.data.columns[1:], columns):
        if col.ctype == ColumnType.DOUBLE:
            vectors.append(codecs.encode_double(np.asarray(data, np.float64)))
        elif isinstance(data, codecs.HistogramColumn):
            vectors.append(codecs.encode_hist_2d_delta(data.rows, data.les))
        else:
            vectors.append(codecs.encode_hist_2d_delta(
                np.asarray(data, np.int64)))
    summary = summarize_columns(schema, ts, columns) if with_summary \
        else None
    return Chunk(chunk_id(int(ts[0]), seq), len(ts), int(ts[0]), int(ts[-1]),
                 tuple(vectors), summary)


@dataclass
class ChunkBytes:
    """Serialized chunks in one buffer: chunk i is ``buf[starts[i]:
    ends[i]]``, ``nbytes[i]`` the length of its vectors (``Chunk.nbytes``).
    ``take`` selects chunks without copying; ``copy`` packs them into a
    buffer of their own."""

    buf: np.ndarray     # uint8, contiguous
    starts: np.ndarray  # int64 [C]
    ends: np.ndarray    # int64 [C]
    nbytes: np.ndarray  # int64 [C]

    def __len__(self) -> int:
        return len(self.starts)

    def data(self, i: int) -> memoryview:
        return memoryview(self.buf)[self.starts[i]:self.ends[i]]

    def take(self, idx: np.ndarray) -> "ChunkBytes":
        return ChunkBytes(self.buf, self.starts[idx], self.ends[idx],
                          self.nbytes[idx])

    def copy(self) -> "ChunkBytes":
        lens = self.ends - self.starts
        ends = np.cumsum(lens)
        buf = np.concatenate([self.buf[a:b] for a, b in
                              zip(self.starts.tolist(), self.ends.tolist())]
                             or [np.zeros(0, np.uint8)])
        return ChunkBytes(buf, ends - lens, ends, self.nbytes.copy())

    @staticmethod
    def from_blobs(blobs: list) -> "ChunkBytes":
        """Serialized chunks as the column store hands them back."""
        lens = np.fromiter((len(b) for b in blobs), np.int64, len(blobs))
        ends = np.cumsum(lens)
        buf = np.frombuffer(b"".join(blobs), np.uint8)
        return ChunkBytes(buf, ends - lens, ends,
                          np.zeros(len(blobs), np.int64))


def _spans(n: int) -> list[tuple[int, int]]:
    return [(a, min(a + _BATCH, n)) for a in range(0, n, _BATCH)]


_pool: list = []
_pool_lock = threading.Lock()


def encode_pool() -> ThreadPoolExecutor:
    """The encoders' one pool a process, made at first use: a seal or a
    page-in encodes under the shard's lock, where starting and joining a
    pool of its own would be a thread join under a held lock (ROADMAP
    §C.23); waiting on this pool's futures joins no thread."""
    with _pool_lock:
        if not _pool:
            _pool.append(ThreadPoolExecutor(
                _WORKERS, thread_name_prefix="chunk-encode"))
        return _pool[0]


def _on_threads(fn, spans):
    if len(spans) > 1:
        return list(encode_pool().map(fn, spans))
    return [fn(s) for s in spans]


def encode_chunks(ts: np.ndarray, dcols: np.ndarray, rows: np.ndarray,
                  ids: np.ndarray, hist: np.ndarray | None = None,
                  les: np.ndarray | None = None) -> ChunkBytes:
    """Serialize C chunks (host C++): timestamps int64 [C, M], K double
    columns float64 [C, K, M], ``rows[c]`` samples and id ``ids[c]`` a
    chunk, and for a histogram schema its bucket column: int64 [C, M, S]
    with the cumulative counts in the first B slots, under bounds ``les``
    float64 [C, B]. The vectors follow the schema: timestamps, the K double
    columns, the histogram. Bytes equal ``encode_chunk(...).serialize()``
    chunk by chunk."""
    ts = np.ascontiguousarray(ts, np.int64)
    dcols = np.ascontiguousarray(dcols, np.float64)
    rows = np.ascontiguousarray(rows, np.int64)
    ids = np.ascontiguousarray(ids, np.int64)
    C, M = ts.shape
    K = dcols.shape[1]
    if hist is not None:
        hist = np.ascontiguousarray(hist, np.int64)
        les = np.ascontiguousarray(les, np.float64)
        B, hs = les.shape[1], hist.shape[2]
    else:
        B, hs = 0, 0
    if (rows < 1).any() or (rows > M).any():
        raise ValueError("every chunk holds 1..M rows")
    enc = _build.host_fn("fh_encode_chunks", 15)
    groups = -(-rows // 8)
    bound = 32 + 4 * (1 + K + (B > 0)) + 21 + 66 * groups \
        + K * (5 + 66 * groups) \
        + ((9 + 8 * B + 66 * (-(-rows * B // 8))) if B else 0)

    def one(span):
        a, b = span
        cap = int(bound[a:b].sum())
        out = np.empty(cap, np.uint8)
        offs = np.zeros(b - a + 1, np.int64)
        nbytes = np.zeros(b - a, np.int64)
        rc = enc(ts[a:b].ctypes.data, dcols[a:b].ctypes.data, K,
                 hist[a:b].ctypes.data if B else None, hs,
                 les[a:b].ctypes.data if B else None, B,
                 rows[a:b].ctypes.data, ids[a:b].ctypes.data, b - a, M,
                 out.ctypes.data, cap, offs.ctypes.data, nbytes.ctypes.data)
        if rc != 0:
            raise RuntimeError("host codec: chunk encode passed its bound")
        return out[: offs[-1]], offs, nbytes

    parts = _on_threads(one, _spans(C))
    base = np.cumsum([0] + [len(b) for b, _, _ in parts])
    offs = np.concatenate([o[:-1] + x for (_, o, _), x in zip(parts, base)]
                          + [np.zeros(0, np.int64)])
    return ChunkBytes(np.concatenate([b for b, _, _ in parts]
                                     + [np.zeros(0, np.uint8)]),
                      offs, np.concatenate([offs[1:], base[-1:]]),
                      np.concatenate([n for _, _, n in parts]
                                     + [np.zeros(0, np.int64)]))


@dataclass
class DecodedChunks:
    """Columns of C decoded chunks of one schema, rows padded to M."""

    ids: np.ndarray      # int64 [C]
    rows: np.ndarray     # int64 [C]
    start: np.ndarray    # int64 [C]
    end: np.ndarray      # int64 [C]
    ts: np.ndarray       # int64 [C, M]
    dcols: np.ndarray    # float64 [C, K, M]: the schema's DOUBLE columns
    hist: np.ndarray | None = None  # int64 [C, M, B] cumulative counts
    les: np.ndarray | None = None   # float64 [C, B]


def _layout(cb: ChunkBytes, schema: Schema):
    """(header [C, 5]: id, rows, start, end, vectors; offset and length of
    each of the schema's vectors [C, columns]) of serialized chunks."""
    C, nv = len(cb), len(schema.data.columns)
    hdr = np.zeros((C, 5), np.int64)
    voff = np.zeros((C, nv), np.int64)
    vlen = np.zeros((C, nv), np.int64)
    if C:
        starts = np.ascontiguousarray(cb.starts, np.int64)
        ends = np.ascontiguousarray(cb.ends, np.int64)
        bad = _build.host_fn("fh_chunk_layout", 8)(
            cb.buf.ctypes.data, starts.ctypes.data, ends.ctypes.data, C, nv,
            hdr.ctypes.data, voff.ctypes.data, vlen.ctypes.data)
        if bad:
            raise ValueError(f"malformed chunk {bad - 1} of {C}")
        if (hdr[:, 4] < nv).any():
            raise ValueError(f"a chunk has fewer vectors than {schema.name} "
                             f"has columns")
    return hdr, voff, vlen


def _hist_column(schema: Schema) -> int | None:
    return next((i for i, c in enumerate(schema.data.columns)
                 if c.ctype == ColumnType.HISTOGRAM), None)


def read_summaries(cb: ChunkBytes, schema: Schema,
                   decoded: DecodedChunks) -> dict:
    """The summaries of serialized chunks ``cb`` (decoded as ``decoded``):
    {``stats_<column>``: float64 [C, 12], ``sketch_<column>``: uint16 [C,
    64]} a scalar column of ``schema``, read from each chunk's ``SC01``
    section where it has the full one, else made from the decoded values
    (bitwise the same: the codecs are lossless)."""
    kinds = summary_kinds(schema)
    names = [c.name for c, k in zip(schema.data.columns, kinds)
             if k is not None]
    _, voff, vlen = _layout(cb, schema)
    at = voff[:, -1] + vlen[:, -1]
    head = np.frombuffer(SC_MAGIC + bytes([len(kinds)]), np.uint8)
    size = 5 + sum(1 if k is None else 1 + 8 * STATS_WIDTH
                   + 2 * SKETCH_BUCKETS for k in kinds)
    ok = cb.ends - at >= size
    buf = np.concatenate([cb.buf, np.zeros(size, np.uint8)])
    raw = buf[at[:, None] + np.arange(size)]
    ok &= (raw[:, :5] == head).all(1)
    pos, where = 5, {}
    for k in kinds:
        ok &= raw[:, pos] == (0 if k is None else 2)
        if k is not None:
            where[k] = pos + 1
            pos += 8 * STATS_WIDTH + 2 * SKETCH_BUCKETS
        pos += 1
    out = {}
    for j, name in enumerate(names):
        p = where[j]
        stats = np.ascontiguousarray(raw[:, p:p + 8 * STATS_WIDTH]).view(
            "<f8").astype(np.float64)
        sketch = np.ascontiguousarray(
            raw[:, p + 8 * STATS_WIDTH:p + 8 * STATS_WIDTH
                + 2 * SKETCH_BUCKETS]).view("<u2").astype(np.uint16)
        miss = np.flatnonzero(~ok)
        if len(miss):
            stats[miss], sketch[miss] = summarize(
                decoded.ts[miss], decoded.dcols[miss, j], decoded.rows[miss])
        out[f"stats_{name}"], out[f"sketch_{name}"] = stats, sketch
    return out


def bucket_counts(cb: ChunkBytes, schema: Schema) -> np.ndarray:
    """int64 [C]: the bucket count of each chunk's histogram vector."""
    _, voff, _ = _layout(cb, schema)
    at = voff[:, _hist_column(schema), None] + np.arange(5, 9)
    return cb.buf[at].copy().view("<u4")[:, 0].astype(np.int64)


def decode_chunks(cb: ChunkBytes, schema: Schema) -> DecodedChunks:
    """Decode serialized chunks of ``schema`` (host C++, on threads). A
    histogram schema's chunks must share one bucket count
    (``bucket_counts``).
    Raises ``ValueError`` on a malformed chunk or one that does not fit
    the schema."""
    cols = schema.data.columns
    dbl = [i for i, c in enumerate(cols) if c.ctype == ColumnType.DOUBLE]
    hcol = _hist_column(schema)
    C = len(cb)
    buf = cb.buf
    hdr, voff, vlen = _layout(cb, schema)
    rows = hdr[:, 1]
    M = int(rows.max(initial=1))
    dec = _build.host_fn("fh_decode_vectors", 8)

    def column(v: int, width: int, nb: int = 0) -> np.ndarray:
        out = np.zeros((C, width), np.int64)
        n = np.zeros(C, np.int64)
        vo, vl = np.ascontiguousarray(voff[:, v]), np.ascontiguousarray(
            vlen[:, v])

        def one(span):
            a, b = span
            bad = dec(buf.ctypes.data, vo[a:].ctypes.data,
                      vl[a:].ctypes.data, b - a, out[a:b].ctypes.data,
                      width, nb, n[a:].ctypes.data)
            if bad:
                raise ValueError(f"column {v} of chunk {a + bad - 1}: "
                                 f"malformed or not of this schema")

        _on_threads(one, _spans(C))
        if (n != rows).any():
            raise ValueError(f"column {v}: row counts disagree with the "
                             f"chunk headers")
        return out

    out = DecodedChunks(hdr[:, 0].copy(), rows.copy(), hdr[:, 2].copy(),
                        hdr[:, 3].copy(), column(0, M),
                        np.stack([column(v, M).view(np.float64)
                                  for v in dbl], axis=1) if dbl
                        else np.zeros((C, 0, M)))
    if hcol is not None:
        nbs = bucket_counts(cb, schema)
        B = int(nbs[0]) if C else 0
        if (nbs != B).any():
            raise ValueError("decode_chunks takes histogram chunks of one "
                             "bucket count")
        out.hist = column(hcol, M * B, B).reshape(C, M, B)
        lo = voff[:, hcol] + 9
        out.les = buf[lo[:, None] + np.arange(8 * B)[None, :]].copy().view(
            np.float64).reshape(C, B)
    return out
