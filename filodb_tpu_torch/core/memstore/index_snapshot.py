"""Part-key index snapshots: a shard restarts from one file instead of a
scan of every part key.

Port of ``filodb_tpu/core/memstore/index_snapshot.py``, format ``FIDX4``
(little-endian), written and read section for section::

    magic "FIDX4" | u32 n_pids | i64 snapshot_ms | i64 chunk_token
    | i64 pk_token
    u32 core_len | core section, a partition an entry:
        u32 klen | key | u32 hash | i64 floor | u8 alive | u8 ncols
    i32* key_len [n_pids]
    u32 n_host | i32* host-backed pids
    i64* starts [n_pids] | i64* ends [n_pids]
    u32 n_labels | per label:
        u16 name_len | name | u32 nv
        u32 voff[nv+1] | value blob
        i64 poff[nv+1] | i32 pids[poff[nv]]
    u32 card_len | cardinality tracker state (JSON)
    [u32 bloom_len | evicted-part-key bloom state (JSON)]

The core section is the layout of the reference's C++ ingest core
(``shard_core_export``): ``key`` is the record-form part key (u16 schema id,
then the container's label section), ``hash`` the part hash (murmur3 of
``PartKey.serialized``), ``floor`` the partition's out-of-order floor from
the column store (its largest persisted timestamp, -1 if none; the port
raises it at each flush, the reference at recovery and eviction), ``alive``
1, ``ncols`` the schema's data columns. Host-backed pids are the ones whose
schema the reference's C++ lane does not take (none of the port's three).
Postings list each label's values sorted by their bytes and each value's
pids in order. The port converts between its key blobs
(``PartKey.serialized``) and the record form and builds the core section
with numpy, a few passes over all keys at once (no C++ core of its own
holds the registry), byte-equal to the reference's layout.

A restore needs an empty shard. It rebuilds the partition registry in pid
order (key blobs, flush groups from the stored hashes, floors), the index
from the postings, and the cardinality tree; each ``PartKey`` is made from
its blob when first used (``shard.KeyList``), as the reference keeps its
keys lazy. The trailing bloom section (the
reference's evicted-part-key filter) is skipped on read and not written:
partition eviction is not ported (ROADMAP §A.9). A snapshot with an
entry of key length 0 (a partition the reference purged) raises: the port
keeps no holes in its pid arrays, so the shard falls back to the full
part-key scan (ROADMAP §C).
"""

from __future__ import annotations

import json
import struct

import numpy as np

from filodb_tpu_torch.core.memstore.partition import expand
from filodb_tpu_torch.core.schemas import SCHEMAS, ColumnType

MAGIC = b"FIDX4"
_HEAD = struct.Struct("<Iqqq")
_TAIL = 14  # u32 hash | i64 floor | u8 alive | u8 ncols


def _native_eligible(schema: str) -> bool:
    """The reference's C++ lane takes doubles and at most one histogram
    column."""
    types = [c.ctype for c in SCHEMAS[schema].data.columns[1:]]
    return all(t in (ColumnType.DOUBLE, ColumnType.HISTOGRAM)
               for t in types) \
        and types.count(ColumnType.HISTOGRAM) <= 1


def _segments(sources: np.ndarray, starts, lens, order) -> np.ndarray:
    """Bytes of ``sources`` at segments (start, length), in ``order``."""
    starts, lens = starts[order], lens[order]
    return sources[expand(starts, lens)]


def _u16(data: np.ndarray, at: np.ndarray) -> np.ndarray:
    return data[at].astype(np.int64) | (data[at + 1].astype(np.int64) << 8)


def _le(values: np.ndarray, width: int) -> np.ndarray:
    """Little-endian two's-complement bytes [n, width] of ints."""
    v = values.astype(np.int64)
    return np.stack([(v >> (8 * b)) & 0xFF for b in range(width)],
                    1).astype(np.uint8)


def core_section(blobs: list[bytes], sid: np.ndarray, hashes: np.ndarray,
                 floors: np.ndarray, ncols: np.ndarray
                 ) -> tuple[bytes, np.ndarray]:
    """The core section of keys given as ``PartKey.serialized`` blobs
    (``schema\\0k\\1v\\0k\\1v...``), with their schema ids, part hashes,
    floors and data-column counts; and each record-form key's length."""
    n = len(blobs)
    end = np.cumsum(np.fromiter((len(b) for b in blobs), np.int64, n))
    buf = np.frombuffer(b"".join(blobs), np.uint8)
    zeros = np.flatnonzero(buf == 0)
    ones = np.flatnonzero(buf == 1)
    zkey = np.searchsorted(end, zeros, side="right")
    nlab = np.bincount(zkey, minlength=n)
    # each label: the bytes after its 0, to the next 0 of its key or the
    # key's end; its first 1 splits name and value
    s0 = zeros + 1
    nxt = np.append(zeros[1:], -1)
    same = np.append(zkey[1:] == zkey[:-1], False)
    e0 = np.where(same, nxt, end[zkey])
    one = ones[np.searchsorted(ones, s0)]
    kl, vl = one - s0, e0 - one - 1
    rec_len = 4 + np.bincount(zkey, weights=4 + kl + vl,
                              minlength=n).astype(np.int64)
    # synthesized bytes: a key's 22 (u32 length | u16 schema id | u16
    # labels | the 14-byte tail), a label's 4 (u16 name and value lengths)
    tail = np.concatenate([_le(hashes, 4), _le(floors, 8),
                           np.ones((n, 1), np.uint8),
                           ncols.astype(np.uint8)[:, None]], 1)
    keyblk = np.concatenate([_le(rec_len, 4), _le(sid, 2), _le(nlab, 2),
                             tail], 1).reshape(-1)
    labblk = np.concatenate([_le(kl, 2), _le(vl, 2)], 1).reshape(-1)
    src = np.concatenate([buf, keyblk, labblk])
    kb, lb = len(buf), len(buf) + len(keyblk)
    m = len(zeros)
    rank_l = 2 + 4 * (np.arange(m) - np.repeat(np.cumsum(nlab) - nlab,
                                               nlab))
    key_of = np.concatenate([np.repeat(np.arange(n), 3)]
                            + [np.repeat(zkey, 4)])
    rank = np.concatenate([np.tile([0, 1, 1 << 40], n),
                           (rank_l[:, None] + np.arange(4)).reshape(-1)])
    kbase = kb + 22 * np.arange(n)
    lbase = lb + 4 * np.arange(m)
    starts = np.concatenate([
        np.stack([kbase, kbase + 4, kbase + 8], 1).reshape(-1),
        np.stack([lbase, s0, lbase + 2, one + 1], 1).reshape(-1)])
    seglen = np.concatenate([
        np.tile([4, 4, 14], n),
        np.stack([np.full(m, 2), kl, np.full(m, 2), vl], 1).reshape(-1)])
    order = np.lexsort((rank, key_of))
    return (_segments(src, starts, seglen, order).tobytes(),
            rec_len.astype(np.int32))


def serialized_blobs(core: np.ndarray, entry: np.ndarray,
                     key_len: np.ndarray) -> tuple[list[bytes], np.ndarray]:
    """``PartKey.serialized`` of every record-form key of a core section
    (entries at ``entry``), and each key's schema id."""
    n = len(entry)
    at = entry + 4
    sid = _u16(core, at)
    nlab = _u16(core, at + 2)
    pos = at + 4
    names = {SCHEMAS[x].schema_id: x.encode() for x in SCHEMAS}
    name_blob = b"".join(names.values())
    name_off = dict(zip(names, np.cumsum([0] + [len(v) for v in
                                                names.values()])[:-1]))
    name_len = {k: len(v) for k, v in names.items()}
    sep = len(core)  # src[sep] = 0, src[sep + 1] = 1
    nb = sep + 2
    starts, lens, keys, ranks = [], [], [], []
    keys.append(np.arange(n))
    ranks.append(np.zeros(n, np.int64))
    starts.append(nb + np.array([name_off[i] for i in sid.tolist()],
                                np.int64))
    lens.append(np.array([name_len[i] for i in sid.tolist()], np.int64))
    for j in range(int(nlab.max(initial=0))):
        live = np.flatnonzero(nlab > j)
        p = pos[live]
        kl = _u16(core, p)
        vl = _u16(core, p + 2 + kl)
        for r, (st, ln) in enumerate(((np.full(len(live), sep), 1),
                                      (p + 2, kl),
                                      (np.full(len(live), sep + 1), 1),
                                      (p + 4 + kl, vl))):
            keys.append(live)
            ranks.append(np.full(len(live), 1 + 4 * j + r))
            starts.append(np.asarray(st, np.int64))
            lens.append(np.broadcast_to(np.asarray(ln, np.int64),
                                        (len(live),)))
        pos[live] = p + 4 + kl + vl
    if not np.array_equal(pos, at + key_len):
        raise ValueError("snapshot keys and their lengths disagree")
    src = np.concatenate([core, np.array([0, 1], np.uint8),
                          np.frombuffer(name_blob, np.uint8)])
    key_of, rank = np.concatenate(keys), np.concatenate(ranks)
    seglen = np.concatenate(lens)
    order = np.lexsort((rank, key_of))
    out = _segments(src, np.concatenate(starts), seglen, order).tobytes()
    per = np.bincount(key_of, weights=seglen, minlength=n).astype(np.int64)
    ends = np.cumsum(per).tolist()
    return [out[a:b] for a, b in zip([0] + ends[:-1], ends)], sid


def save_snapshot(shard, chunk_token: int = -1, pk_token: int = -1,
                  snapshot_ms: int = 0) -> bytes:
    """A shard's partition registry, index and cardinality as ``FIDX4``
    bytes. Tokens are the column store's write counters taken before the
    call: a restore replays only what was written after them."""
    from filodb_tpu_torch.core.partkey import murmur3_32_many
    from filodb_tpu_torch.core.record import SCHEMA_NAMES

    n = shard.num_partitions
    blobs = shard.key_blobs(range(n))
    schema = shard.schema_of[:n].astype(np.int64)
    ncols_of = np.array([len(SCHEMAS[x].data.columns) - 1
                         for x in SCHEMA_NAMES], np.int64)
    sid_of = np.array([SCHEMAS[x].schema_id for x in SCHEMA_NAMES], np.int64)
    core, key_len = core_section(blobs, sid_of[schema],
                                 murmur3_32_many(blobs), shard.floor[:n],
                                 ncols_of[schema])
    eligible = np.array([_native_eligible(x) for x in SCHEMA_NAMES])
    host = np.flatnonzero(~eligible[schema]).astype(np.int32)
    out = [MAGIC, _HEAD.pack(n, snapshot_ms, chunk_token, pk_token),
           struct.pack("<I", len(core)), core, key_len.tobytes(),
           struct.pack("<I", len(host)), host.tobytes(),
           np.ascontiguousarray(shard.index.start_times(np.arange(n)),
                                np.int64).tobytes(),
           np.ascontiguousarray(shard.index.end_times(np.arange(n)),
                                np.int64).tobytes()]
    labels = list(shard.index.postings())
    out.append(struct.pack("<I", len(labels)))
    for name, values, pids, counts in labels:
        nb = name.encode()
        voff = np.zeros(len(values) + 1, np.uint32)
        np.cumsum([len(v) for v in values], out=voff[1:])
        poff = np.zeros(len(values) + 1, np.int64)
        np.cumsum(counts, out=poff[1:])
        out += [struct.pack("<H", len(nb)), nb,
                struct.pack("<I", len(values)), voff.tobytes(),
                b"".join(values), poff.tobytes(),
                pids.astype(np.int32).tobytes()]
    card = json.dumps(shard.cardinality.to_state()).encode()
    out += [struct.pack("<I", len(card)), card]
    return b"".join(out)


def read_snapshot(data: bytes) -> dict:
    """The sections of ``FIDX4`` bytes: n, snapshot_ms, chunk_token,
    pk_token, blobs (``PartKey.serialized`` a pid), schema_ids, hashes,
    floors, ncols, starts, ends, postings (label, values, pids, counts) and
    cardinality (the tree state). Raises ``ValueError`` on a malformed snapshot or a purged
    entry."""
    if data[:5] != MAGIC:
        raise ValueError("not an FIDX4 index snapshot")
    n, snapshot_ms, chunk_token, pk_token = _HEAD.unpack_from(data, 5)
    off = 5 + _HEAD.size
    (core_len,) = struct.unpack_from("<I", data, off)
    off += 4
    core = np.frombuffer(data, np.uint8, core_len, off)
    off += core_len
    key_len = np.frombuffer(data, np.int32, n, off).astype(np.int64)
    off += 4 * n
    if (key_len == 0).any():
        raise ValueError("the snapshot holds purged partitions, which the "
                         "port's pid arrays cannot hold (ROADMAP §C)")
    size = key_len + 4 + _TAIL
    entry = np.concatenate([[0], np.cumsum(size)[:-1]]).astype(np.int64)
    if n and int(entry[-1] + size[-1]) != core_len:
        raise ValueError("snapshot core section and key lengths disagree")
    tail = entry + 4 + key_len

    def field(at, width, dtype):
        raw = core[at[:, None] + np.arange(width)]
        return np.ascontiguousarray(raw).view(dtype).reshape(-1)

    hashes = field(tail, 4, np.uint32)
    floors = field(tail + 4, 8, np.int64)
    ncols = core[tail + 13]
    blobs, sids = serialized_blobs(core, entry, key_len)
    (n_host,) = struct.unpack_from("<I", data, off)
    off += 4 + 4 * n_host
    starts = np.frombuffer(data, np.int64, n, off)
    off += 8 * n
    ends = np.frombuffer(data, np.int64, n, off)
    off += 8 * n
    (n_labels,) = struct.unpack_from("<I", data, off)
    off += 4
    postings = []
    for _ in range(n_labels):
        (nl,) = struct.unpack_from("<H", data, off)
        off += 2
        name = data[off:off + nl].decode()
        off += nl
        (nv,) = struct.unpack_from("<I", data, off)
        off += 4
        voff = np.frombuffer(data, np.uint32, nv + 1, off).astype(np.int64)
        off += 4 * (nv + 1)
        vblob = data[off:off + int(voff[-1])]
        off += int(voff[-1])
        poff = np.frombuffer(data, np.int64, nv + 1, off)
        off += 8 * (nv + 1)
        pids = np.frombuffer(data, np.int32, int(poff[-1]), off)
        off += 4 * int(poff[-1])
        values = [vblob[a:b].decode() for a, b in zip(voff[:-1].tolist(),
                                                      voff[1:].tolist())]
        postings.append((name, values, pids.astype(np.int64),
                         np.diff(poff)))
    (card_len,) = struct.unpack_from("<I", data, off)
    off += 4
    card = json.loads(data[off:off + card_len].decode())
    return dict(n=n, snapshot_ms=snapshot_ms, chunk_token=chunk_token,
                pk_token=pk_token, blobs=blobs, schema_ids=sids,
                hashes=hashes, floors=floors,
                ncols=ncols, starts=starts, ends=ends, postings=postings,
                cardinality=card)


def load_snapshot(shard, data: bytes) -> dict:
    """Restore an empty shard from ``FIDX4`` bytes; returns {"pids",
    "snapshot_ms", "chunk_token", "pk_token"}."""
    snap = read_snapshot(data)
    shard.restore_registry(snap)
    return {"pids": snap["n"], "snapshot_ms": snap["snapshot_ms"],
            "chunk_token": snap["chunk_token"],
            "pk_token": snap["pk_token"]}
