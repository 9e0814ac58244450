"""Downsampling: raw samples rolled up into periods, at flush and by a job.

Port of ``filodb_tpu/core/downsample/downsampler.py``. A period is a
``resolution_ms`` bucket of time (``ts // resolution_ms``); its record's
timestamp is the last raw sample in it (``tTime``). A counter keeps that
sample (``dLast``) in ``prom-counter``; a gauge rolls up into ``ds-gauge``
(min, max, sum, count, avg). NaN samples are kept, as the reference's
``read_samples`` keeps them, so a period holding one has NaN min, max, sum
and avg. Histograms give no records (the reference's ``read_samples``
hands back a bucket column, which its rollup skips).

The port's idiom: many partitions at once. ``_flatten`` lays the samples
of decoded codec chunks (the host C++ codec, ``memory/chunk.py``) out as
one array sorted by partition, then time (ties in chunk-id order, as the
reference's stable sort over its chunks); ``_rollup`` reduces every
period of every partition with one ``reduceat`` a statistic. A period's
statistics are those ``downsample_samples`` (the reference's body) gives
for the partition alone, bit for bit.

``ShardDownsampler`` is the streaming form: a shard's flush hands it the
partitions whose chunks it wrote and each one's time span
(``Shard._flush_group``), and it publishes one container of rollups a
resolution. ``DownsamplerJob`` is the batch form: it scans the raw
dataset's chunks by ingestion time (``scan_chunk_rows_by_ingestion_time``)
and writes ds chunks and part keys under ``<dataset>_ds_<minutes>m``; a
partition's ds chunks take ids ``chunk_id(first ts, seq)`` with seq from 0,
so a window done twice writes the same chunks and the store keeps the
first. ``catch_up`` keeps each shard's ingestion-time watermark in the
meta store under ``<dataset>__dsckpt`` (group 0), the reference's layout,
so a job of either package resumes from the other's checkpoint. With
``n_splits`` it scans split by split
(``scan_chunk_rows_by_ingestion_time_split``: the object store's buckets,
or the base class's filter of the full scan).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import IngestRecord, RecordContainer
from filodb_tpu_torch.core.schemas import SCHEMAS, ColumnType
from filodb_tpu_torch.core.store.api import (
    ColumnStore,
    MetaStore,
    PartKeyRecord,
    pk_from_blob,
)
from filodb_tpu_torch.memory.chunk import (
    ChunkBytes,
    chunk_ids,
    decode_chunks,
    encode_chunks,
    summarize,
    summary_kinds,
    summary_sections,
)

DEFAULT_RESOLUTIONS_MS = (300_000, 3_600_000)


def downsample_samples(ts: np.ndarray, vals: np.ndarray, resolution_ms: int):
    """Aggregate (ts, vals) into time buckets of ``resolution_ms``.

    Returns (bucket_last_ts, min, max, sum, count, avg, last) arrays."""
    if len(ts) == 0:
        z = np.array([], np.float64)
        return np.array([], np.int64), z, z, z, z, z, z
    bucket = ts // resolution_ms
    starts = np.flatnonzero(np.concatenate([[True], bucket[1:] != bucket[:-1]]))
    ends = np.concatenate([starts[1:], [len(ts)]])
    t_last = ts[ends - 1]
    mins = np.minimum.reduceat(vals, starts)
    maxs = np.maximum.reduceat(vals, starts)
    sums = np.add.reduceat(vals, starts)
    counts = (ends - starts).astype(np.float64)
    avgs = sums / counts
    lasts = vals[ends - 1]
    return t_last, mins, maxs, sums, counts, avgs, lasts


@dataclass
class Rollups:
    """The periods of many partitions: ``row[i]`` the partition (an index
    into the caller's list) of period i, in partition order, a partition's
    periods in time order."""

    row: np.ndarray     # int64 [n]
    ts: np.ndarray      # int64 [n]: the period's last sample
    mins: np.ndarray
    maxs: np.ndarray
    sums: np.ndarray
    counts: np.ndarray
    avgs: np.ndarray
    lasts: np.ndarray

    def __len__(self) -> int:
        return len(self.row)

    def values(self, counter: bool) -> np.ndarray:
        """float64 [n, K]: a counter's (last,), a gauge's (min, max, sum,
        count, avg)."""
        if counter:
            return self.lasts[:, None]
        return np.stack([self.mins, self.maxs, self.sums, self.counts,
                         self.avgs], axis=1)


def _rollup(row: np.ndarray, ts: np.ndarray, vals: np.ndarray,
            resolution_ms: int) -> Rollups:
    """Every period of samples sorted by (row, ts)."""
    if not len(ts):
        z = np.zeros(0, np.float64)
        return Rollups(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       z, z, z, z, z, z)
    bucket = ts // resolution_ms
    new = np.ones(len(ts), bool)
    new[1:] = (row[1:] != row[:-1]) | (bucket[1:] != bucket[:-1])
    starts = np.flatnonzero(new)
    ends = np.concatenate([starts[1:], [len(ts)]])
    sums = np.add.reduceat(vals, starts)
    counts = (ends - starts).astype(np.float64)
    return Rollups(row[starts], ts[ends - 1],
                   np.minimum.reduceat(vals, starts),
                   np.maximum.reduceat(vals, starts), sums, counts,
                   sums / counts, vals[ends - 1])


def _flatten(parts: list, n_rows: int, start, end):
    """Samples in [start, end] (scalars, or arrays [n_rows] a partition)
    of decoded pieces ``parts``: (rows [N], late [N], chunk ids [N], ts
    int64 [N, M], vals float64 [N, M], live bool [N, M]) each → (row, ts,
    vals) sorted by row, then ts, ties in (late, chunk id, position)
    order."""
    rows, ts, vals, keys = [], [], [], []
    lo = np.broadcast_to(np.asarray(start, np.int64), (n_rows,))
    hi = np.broadcast_to(np.asarray(end, np.int64), (n_rows,))
    for r, late, cid, t, v, live in parts:
        if not len(r):
            continue
        r = np.asarray(r, np.int64)
        keep = live & (t >= lo[r][:, None]) & (t <= hi[r][:, None])
        i, j = np.nonzero(keep)
        rows.append(r[i])
        ts.append(t[i, j])
        vals.append(v[i, j])
        keys.append(np.stack([np.asarray(late)[i], np.asarray(cid)[i], j]))
    if not rows:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    row, t, v = (np.concatenate(x) for x in (rows, ts, vals))
    # a partition's chunks in chunk-id order hold its samples in time
    # order, as a rule: then a stable sort by partition is the order
    order = np.argsort(row, kind="stable")
    r, tt = row[order], t[order]
    same = r[1:] == r[:-1]
    if (tt[1:][same] > tt[:-1][same]).all():
        return r, tt, v[order]
    late, cid, pos = np.concatenate(keys, axis=1)
    order = np.lexsort((pos, cid, late, t, row))
    return row[order], t[order], v[order]


def _decoded_parts(rows_of_chunks: np.ndarray, cb: ChunkBytes, schema):
    """A ``_flatten`` piece of serialized chunks ``cb`` of ``schema`` (its
    value column; ``rows_of_chunks`` the partition of each)."""
    d = decode_chunks(cb, schema)
    cols = schema.data.columns
    col = [c for c in cols if c.ctype == ColumnType.DOUBLE].index(
        cols[schema.data.value_column])
    M = d.ts.shape[1]
    live = np.arange(M)[None, :] < d.rows[:, None]
    return (rows_of_chunks, np.zeros(len(d.ids), np.int64), d.ids, d.ts,
            d.dcols[:, col], live)


def ds_key(part_key: PartKey) -> PartKey:
    """The part key of a raw key's rollups: a counter's is ``prom-counter``,
    a gauge's its schema's ``ds_schema``."""
    schema = SCHEMAS[part_key.schema]
    if schema.is_counter:
        return PartKey("prom-counter", part_key.labels)
    return PartKey(schema.data.downsample_schema or "ds-gauge",
                   part_key.labels)


def _downsampled(schema) -> bool:
    """Whether a schema's partitions give rollups."""
    return schema.data.downsample_schema is not None \
        and not schema.is_histogram and not schema.is_multi


def rollup_records(keys: list[PartKey], roll: Rollups) -> list[IngestRecord]:
    """The ds records of rollups of partitions ``keys`` (``roll.row``
    indexes them), in order."""
    out = []
    rows = roll.row.tolist()
    ts = roll.ts.tolist()
    vals = {}
    for i, (r, t) in enumerate(zip(rows, ts)):
        key = keys[r]
        counter = SCHEMAS[key.schema].is_counter
        if counter not in vals:
            vals[counter] = roll.values(counter).tolist()
        out.append(IngestRecord(ds_key(key), int(t),
                                tuple(vals[counter][i])))
    return out


def downsample_partitions(shard, pids: np.ndarray, resolution_ms: int,
                          start, end) -> list[IngestRecord]:
    """The ds records of partitions ``pids`` of a port ``Shard`` over
    their samples in [start, end] (scalars or an array a partition): its
    resident chunks' codec chunks (held, or read back from the column
    store) and its write buffers. The caller holds the shard's lock."""
    pids = np.asarray(pids, np.int64)
    keys = [shard.keys[p] for p in pids.tolist()]
    ok = np.array([_downsampled(SCHEMAS[k.schema]) for k in keys], bool)
    if not ok.any():
        return []
    lo, hi = (np.broadcast_to(np.asarray(x, np.int64), (len(pids),))
              for x in (start, end))
    samples = shard._samples(pids[ok], int(lo[ok].min()), int(hi[ok].max()),
                             None, None)
    parts = [_decoded_parts(r, cb, samples.schema)
             for cb, r, _ in samples.codec] + samples.decoded
    back = np.flatnonzero(ok)
    row, ts, vals = _flatten(parts, int(ok.sum()), lo[ok], hi[ok])
    roll = _rollup(row, ts, vals, resolution_ms)
    roll.row = back[roll.row]
    return rollup_records(keys, roll)


def downsample_partition(shard, pid: int, resolution_ms: int, start: int,
                         end: int) -> list[IngestRecord]:
    """One partition's ds records (``downsample_partitions``)."""
    with shard.lock:
        return downsample_partitions(shard, np.array([pid]), resolution_ms,
                                     start, end)


@dataclass
class ShardDownsampler:
    """The streaming downsampler: a flush hands it the partitions whose
    chunks it wrote; it publishes their rollups, one container a
    resolution (``publish(resolution_ms, RecordContainer)``)."""

    resolutions_ms: tuple[int, ...] = DEFAULT_RESOLUTIONS_MS
    publish: "callable | None" = None
    records_created: int = 0

    def on_flush(self, shard, pids: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray) -> None:
        """Partitions ``pids`` flushed chunks spanning [starts, ends] each;
        the caller holds the shard's lock."""
        if self.publish is None or not len(pids):
            return
        for res in self.resolutions_ms:
            recs = downsample_partitions(shard, pids, res, starts, ends)
            if recs:
                self.records_created += len(recs)
                self.publish(res, RecordContainer(recs))


def ds_dataset_name(dataset: str, resolution_ms: int) -> str:
    return f"{dataset}_ds_{resolution_ms // 60000}m"


def ckpt_dataset(dataset: str) -> str:
    """The meta-store dataset of the job's watermarks."""
    return f"{dataset}__dsckpt"


def ds_chunk_rows(keys: list[PartKey], roll: Rollups,
                  max_chunk_size: int) -> tuple[list, list[PartKeyRecord]]:
    """The ds chunks of rollups of raw partitions ``keys`` as column-store
    rows (ds key blob, chunk id, start, end, serialized chunk with its
    summary), each partition's periods cut into chunks of
    ``max_chunk_size`` ids ``chunk_id(first ts, seq)`` (seq 0, 1, ...), and
    each ds partition's part-key record (first and last period)."""
    rows, pkrecs = [], []
    if not len(roll):
        return rows, pkrecs
    bounds = np.flatnonzero(np.concatenate(
        [[True], roll.row[1:] != roll.row[:-1], [True]]))
    for counter in (True, False):
        sel = [(a, b) for a, b in zip(bounds[:-1].tolist(),
                                      bounds[1:].tolist())
               if SCHEMAS[keys[roll.row[a]].schema].is_counter == counter]
        if not sel:
            continue
        vals = roll.values(counter)
        schema = SCHEMAS["prom-counter" if counter else "ds-gauge"]
        # one chunk a max_chunk_size run of each partition's periods
        cuts = [(r, a, min(a + max_chunk_size, b), seq)
                for r, (a, b) in enumerate(sel)
                for seq, a in enumerate(range(a, b, max_chunk_size))]
        C, M = len(cuts), max_chunk_size
        ts = np.zeros((C, M), np.int64)
        dc = np.zeros((C, vals.shape[1], M), np.float64)
        n = np.zeros(C, np.int64)
        for c, (_, a, b, _) in enumerate(cuts):
            n[c] = b - a
            ts[c, :b - a] = roll.ts[a:b]
            dc[c, :, :b - a] = vals[a:b].T
        M = int(n.max())
        ts, dc = ts[:, :M].copy(), dc[:, :, :M].copy()
        ids = chunk_ids(ts[:, 0], np.array([c[3] for c in cuts]))
        cb = encode_chunks(ts, dc, n, ids)
        kinds = summary_kinds(schema)
        stats, sketches = [], []
        for j in range(dc.shape[1]):
            st, sk = summarize(ts, np.ascontiguousarray(dc[:, j]), n)
            stats.append(st)
            sketches.append(sk)
        sec = summary_sections(kinds, stats, sketches)
        for c, (r, a, b, _) in enumerate(cuts):
            key = ds_key(keys[roll.row[sel[r][0]]])
            rows.append((key.serialized, int(ids[c]), int(ts[c, 0]),
                         int(ts[c, n[c] - 1]),
                         bytes(cb.data(c)) + sec[c].tobytes()))
        for a, b in sel:
            pkrecs.append((a, PartKeyRecord(ds_key(keys[roll.row[a]]),
                                            int(roll.ts[a]),
                                            int(roll.ts[b - 1]))))
    # part keys in the order of their raw partitions
    pkrecs = [r for _, r in sorted(pkrecs, key=lambda x: x[0])]
    return rows, pkrecs


@dataclass
class DownsamplerJob:
    """The batch downsampler: scans raw chunks by ingestion-time window
    and writes ds chunks and part keys under the ds datasets."""

    column_store: ColumnStore
    dataset: str
    num_shards: int
    resolutions_ms: tuple[int, ...] = DEFAULT_RESOLUTIONS_MS
    max_chunk_size: int = 400
    # with a meta store, catch_up keeps each shard's watermark there, so a
    # restarted job scans exactly the window not yet done
    meta_store: MetaStore | None = None
    # the ingestion-time scan fanned out over the store's token-range
    # splits (the object store's buckets; the base class filters the
    # full scan)
    n_splits: int = 1
    # seconds and rows of the last run: read, decode, rollup, write
    seconds: dict = field(default_factory=dict)

    def run(self, ingestion_start: int, ingestion_end: int,
            user_start: int = 0, user_end: int = 2**62) -> dict:
        stats = _stats()
        for shard in range(self.num_shards):
            self._downsample_shard(shard, ingestion_start, ingestion_end,
                                   user_start, user_end, stats)
        return stats

    def last_checkpoint(self, shard: int) -> int:
        """The ingestion-time watermark this shard is downsampled up to."""
        if self.meta_store is None:
            return 0
        return self.meta_store.read_checkpoints(
            ckpt_dataset(self.dataset), shard).get(0, 0)

    def catch_up(self, now_ms: int, user_start: int = 0,
                 user_end: int = 2**62) -> dict:
        """Downsample every shard from its checkpoint up to ``now_ms``
        and move the checkpoint there."""
        stats = {**_stats(), "scanned_from": {}}
        for shard in range(self.num_shards):
            start = self.last_checkpoint(shard)
            stats["scanned_from"][shard] = start
            self._downsample_shard(shard, start, now_ms, user_start,
                                   user_end, stats)
            if self.meta_store is not None:
                self.meta_store.write_checkpoint(ckpt_dataset(self.dataset),
                                                 shard, 0, now_ms)
        return stats

    def _downsample_shard(self, shard, t0, t1, us, ue, stats) -> None:
        import time

        t = time.perf_counter()
        rows = self._scan(shard, t0, t1)
        stats["raw_chunks"] += len(rows)
        stats["raw_bytes"] += sum(len(d) for _, d in rows)
        blobs, row_of = {}, []
        for b, _ in rows:
            row_of.append(blobs.setdefault(bytes(b), len(blobs)))
        keys = [pk_from_blob(b) for b in blobs]
        row_of = np.array(row_of, np.int64)
        _add(self.seconds, "read", time.perf_counter() - t)
        t = time.perf_counter()
        parts = []
        for name in sorted({k.schema for k in keys}):
            schema = SCHEMAS.get(name)
            if schema is None or not _downsampled(schema):
                continue
            mine = np.array([keys[r].schema == name for r in row_of.tolist()],
                            bool)
            at = np.flatnonzero(mine)
            if len(at):
                parts.append(_decoded_parts(
                    row_of[at], ChunkBytes.from_blobs([rows[i][1]
                                                       for i in at.tolist()]),
                    schema))
        row, ts, vals = _flatten(parts, len(keys), us, ue)
        stats["raw_rows"] += len(ts)
        _add(self.seconds, "decode", time.perf_counter() - t)
        for res in self.resolutions_ms:
            t = time.perf_counter()
            roll = _rollup(row, ts, vals, res)
            out, pkrecs = ds_chunk_rows(keys, roll, self.max_chunk_size)
            _add(self.seconds, "rollup", time.perf_counter() - t)
            t = time.perf_counter()
            ds_name = ds_dataset_name(self.dataset, res)
            if out:
                self.column_store.write_chunk_rows(ds_name, shard, out, t1)
            if pkrecs:
                self.column_store.write_part_keys(ds_name, shard, pkrecs)
            _add(self.seconds, "write", time.perf_counter() - t)
            stats["partitions"] += len(pkrecs)
            stats["ds_samples"] += len(roll)
            stats["ds_chunks"] += len(out)
            stats["ds_bytes"] += sum(len(r[4]) for r in out)


    def _scan(self, shard, t0, t1) -> list:
        if self.n_splits <= 1:
            return self.column_store.scan_chunk_rows_by_ingestion_time(
                self.dataset, shard, t0, t1)
        return [row for split in range(self.n_splits)
                for row in self.column_store
                .scan_chunk_rows_by_ingestion_time_split(
                    self.dataset, shard, t0, t1, split, self.n_splits)]


def _stats() -> dict:
    return {"partitions": 0, "ds_chunks": 0, "ds_samples": 0,
            "ds_bytes": 0, "raw_chunks": 0, "raw_bytes": 0, "raw_rows": 0}


def _add(d: dict, k: str, v: float) -> None:
    d[k] = d.get(k, 0.0) + v
