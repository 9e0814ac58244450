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
    u32 bloom_len | evicted-part-key bloom state (JSON)

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

A partition that is not live is written as the reference's C++ core
writes a freed slot: key length 0, its hash and floor, ``alive`` 0 and
``ncols`` 0. A purged one (a hole) also has both times at ``INGESTING``
and no postings; an evicted one keeps its times and postings. The bloom
section holds the evicted-key filter's ``state()``.

A restore needs an empty shard. It rebuilds the partition registry in pid
order (key blobs, flush groups from the stored hashes, floors), the index
from the postings, the cardinality tree and the bloom; each ``PartKey`` is
made from its blob when first used (``shard.KeyList``), as the reference
keeps its keys lazy. An entry of key length 0 restores as a hole, or, when
its times say it was evicted, as an evicted partition whose key is rebuilt
from its postings and its stored hash (the reference's restore leaves such
a partition without a key, so its chunks on disk stay out of reach:
ROADMAP §C).
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


def record_keys(blobs: list[bytes], schema: np.ndarray) -> list[bytes]:
    """The record-form keys (the reference's ``part_key_blob``) of keys
    given as ``PartKey.serialized`` blobs of schemas ``schema`` (indexes
    into ``SCHEMA_NAMES``)."""
    from filodb_tpu_torch.core.record import SCHEMA_NAMES

    if not blobs:
        return []
    sid_of = np.array([SCHEMAS[x].schema_id for x in SCHEMA_NAMES], np.int64)
    n = len(blobs)
    core, key_len = core_section(blobs, sid_of[np.asarray(schema, np.int64)],
                                 np.zeros(n, np.int64), np.zeros(n, np.int64),
                                 np.zeros(n, np.int64))
    at = (np.cumsum(key_len.astype(np.int64) + 4 + _TAIL)
          - key_len - _TAIL).tolist()
    return [core[a:a + k] for a, k in zip(at, key_len.tolist())]


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

    from filodb_tpu_torch.core.memstore.shard import LIVE

    n = shard.num_partitions
    live = np.flatnonzero(shard.status[:n] == LIVE)
    blobs = shard.key_blobs(live)
    schema = shard.schema_of[:n].astype(np.int64)
    ncols_of = np.array([len(SCHEMAS[x].data.columns) - 1
                         for x in SCHEMA_NAMES], np.int64)
    sid_of = np.array([SCHEMAS[x].schema_id for x in SCHEMA_NAMES], np.int64)
    lcore, lkey_len = core_section(blobs, sid_of[schema[live]],
                                   murmur3_32_many(blobs), shard.floor[live],
                                   ncols_of[schema[live]])
    key_len = np.zeros(n, np.int32)
    key_len[live] = lkey_len
    core = _with_holes(np.frombuffer(lcore, np.uint8), key_len, live,
                       shard.hashes[:n], shard.floor[:n])
    eligible = np.array([_native_eligible(x) for x in SCHEMA_NAMES])
    host = live[~eligible[schema[live]]].astype(np.int32)
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
    bloom = json.dumps(shard.evicted_keys.state()).encode()
    out += [struct.pack("<I", len(card)), card,
            struct.pack("<I", len(bloom)), bloom]
    return b"".join(out)


def _with_holes(lcore: np.ndarray, key_len: np.ndarray, live: np.ndarray,
                hashes: np.ndarray, floors: np.ndarray) -> bytes:
    """The core section of every pid: the live entries of ``lcore`` in
    order and, for every other pid, a freed slot (key length 0, its hash
    and floor, alive 0, ncols 0)."""
    n = len(key_len)
    size = key_len.astype(np.int64) + 4 + _TAIL
    if len(live) == n:
        return lcore.tobytes()
    dead = np.setdiff1d(np.arange(n), live)
    slots = np.concatenate([np.zeros((len(dead), 4), np.uint8),
                            _le(hashes[dead], 4), _le(floors[dead], 8),
                            np.zeros((len(dead), 2), np.uint8)], 1)
    starts = np.zeros(n, np.int64)
    lsize = size[live]
    starts[live] = np.cumsum(lsize) - lsize
    starts[dead] = len(lcore) + (4 + _TAIL) * np.arange(len(dead))
    src = np.concatenate([lcore, slots.reshape(-1)])
    return _segments(src, starts, size, np.arange(n)).tobytes()


def read_snapshot(data: bytes) -> dict:
    """The sections of ``FIDX4`` bytes: n, snapshot_ms, chunk_token,
    pk_token, blobs (``PartKey.serialized`` a pid), schema_ids, hashes,
    floors, ncols, starts, ends, postings (label, values, pids, counts) and
    cardinality (the tree state) and bloom (its state, or None). A pid of
    key length 0 has the blob b"". Raises ``ValueError`` on a malformed
    snapshot."""
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
    keyed = np.flatnonzero(key_len > 0)
    kblobs, ksids = serialized_blobs(core, entry[keyed], key_len[keyed])
    blobs = [b""] * n
    for i, b in zip(keyed.tolist(), kblobs):
        blobs[i] = b
    sids = np.zeros(n, np.int64)
    sids[keyed] = ksids
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
    off += card_len
    bloom = None
    if off + 4 <= len(data):  # absent in older snapshots
        (bl,) = struct.unpack_from("<I", data, off)
        bloom = json.loads(data[off + 4:off + 4 + bl].decode())
    return dict(n=n, snapshot_ms=snapshot_ms, chunk_token=chunk_token,
                pk_token=pk_token, blobs=blobs, schema_ids=sids,
                hashes=hashes, floors=floors,
                ncols=ncols, starts=starts, ends=ends, postings=postings,
                cardinality=card, bloom=bloom)


def rebuild_keys(pids: np.ndarray, hashes: np.ndarray,
                 postings) -> dict[int, bytes]:
    """``PartKey.serialized`` of the keyless pids ``pids``, rebuilt from
    the labels their postings give them and the schema whose key hashes to
    their stored hash; a pid no schema matches is left out."""
    from filodb_tpu_torch.core.partkey import murmur3_32
    from filodb_tpu_torch.core.record import SCHEMA_NAMES

    labels: dict[int, list] = {int(p): [] for p in pids.tolist()}
    for name, values, ppids, counts in postings:
        vid = np.repeat(np.arange(len(values)), counts)
        hit = np.isin(ppids, pids)
        for p, v in zip(ppids[hit].tolist(), vid[hit].tolist()):
            labels[p].append((name, values[v]))
    out = {}
    for p, lab in labels.items():
        body = b"".join(b"\x00" + k.encode() + b"\x01" + v.encode()
                        for k, v in sorted(lab))
        for name in SCHEMA_NAMES:
            blob = name.encode() + body
            if murmur3_32(blob) == int(hashes[p]):
                out[p] = blob
                break
    return out


def load_snapshot(shard, data: bytes) -> dict:
    """Restore an empty shard from ``FIDX4`` bytes; returns {"pids",
    "snapshot_ms", "chunk_token", "pk_token"}."""
    snap = read_snapshot(data)
    shard.restore_registry(snap)
    return {"pids": snap["n"], "snapshot_ms": snap["snapshot_ms"],
            "chunk_token": snap["chunk_token"],
            "pk_token": snap["pk_token"]}
