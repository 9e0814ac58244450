"""The shard's ingest core on the host: its part-key map, the container
pass, the write buffers' append and the sidecar lane's buffer fold, in
``csrc/ingestcore.cpp`` (built with ``g++`` at first use).

Port of ``filodb_tpu/core/memstore/native_shard.py``'s ``NativeShardCore``
(the reference's C++ shard core, ``native/filodb_native.cpp``) onto the
port's columnar write path. The reference's core keeps a partition's
samples in vectors of its own (``NativeBackedPartition``); the port's
partitions are rows of the shard's arrays (``partition.WriteBuffers``,
``ChunkTable``, the per-pid arrays), so the core here holds only the
part-key map and works on those arrays in place, through pointers the
caller takes after every reallocation:

- ``NativeShardCore``: part-key blob (``PartKey.serialized``) → pid, by
  murmur3-32 of the blob and a byte compare; batch lookup, insert, erase
  and one-call loads of a restored registry; and ``ingest``, the pass
  over a container's records (``IngestCtl``), which stops where the
  shard must act (a key the map lacks, a full buffer row, no free row)
  and resumes at the same record;
- ``append_round``: one round of ``WriteBuffers.append``, writing only
  the new samples;
- ``buf_fold``: the reference's ``shard_buf_fold`` over the scalar write
  buffers, [P, W, 12] float64 stats and flags.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from filodb_tpu_torch import _build
from filodb_tpu_torch.core.record import _NAME_OFF, _NAMES, SCHEMA_NAMES
from filodb_tpu_torch.core.schemas import SCHEMAS

_P, _I = ctypes.c_void_p, ctypes.c_int64
# entry points: (argument types, result type)
_SIGNATURES = {
    "ic_new": ([], _P),
    "ic_free": ([_P], None),
    "ic_size": ([_P], _I),
    "ic_clear": ([_P], None),
    "ic_lookup": ([_P, _P, _P, _I, _P], None),
    "ic_insert": ([_P, _P, _P, _I, _P, _P], None),
    "ic_erase": ([_P, _P, _P, _I, _P], _I),
    "ic_validate": ([_P, _I, _I], _I),
    "ic_ingest": ([_P, _P], _I),
    "ic_misses": ([_P, _P, _P, _P, _P, _P], _I),
    "ic_append_round": ([_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                         _P], _I),
    "ic_sealed_overlap": ([_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P],
                          None),
    "ic_buf_fold": ([_P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _P],
                    None),
}
_fns: dict = {}

# the pass's stop reasons (ic_ingest)
DONE, MISS, FULL, NO_ROW = 0, 1, 2, 3
# a record's schema id → its index in SCHEMA_NAMES, -1 unknown
_SCHEMA_INDEX = np.full(1 << 16, -1, np.int32)
for _i, _name in enumerate(SCHEMA_NAMES):
    _SCHEMA_INDEX[SCHEMAS[_name].schema_id] = _i
_LONGEST_NAME = int(np.diff(_NAME_OFF).max())
# pids a fold call takes; larger folds split over the card host's 8 cores
_FOLD_SPAN = 1 << 14
_FOLD_WORKERS = 8
_pool: list = []


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(_build.host_library("ingestcore"), name)
        f.argtypes, f.restype = _SIGNATURES[name]
        _fns[name] = f
    return f


def addr(a) -> int | None:
    """The address of array ``a``'s data (None for None)."""
    return None if a is None else a.__array_interface__["data"][0]


def pack_blobs(blobs) -> tuple[np.ndarray, np.ndarray]:
    """Byte strings as one uint8 buffer and int64 offsets [n + 1]."""
    lens = np.fromiter(map(len, blobs), np.int64, len(blobs))
    off = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    buf = np.frombuffer(b"".join(blobs) or b"\0", np.uint8)
    return buf, off


class IngestCtl(ctypes.Structure):
    """One container's pass (``IngestCtl`` of ``csrc/ingestcore.cpp``,
    field for field)."""

    _fields_ = [(n, _P if p else _I) for n, p in (
        ("raw", 1), ("len", 0), ("nrec", 0), ("offset", 0),
        ("schema_index", 1), ("names", 1), ("name_off", 1),
        ("watermarks", 1), ("groups", 0),
        ("latest", 1), ("hist", 1),
        ("buf_ts", 1), ("buf_vals", 1), ("buf_n", 1), ("slot", 1),
        ("n_slot", 0), ("pid_of", 1), ("M", 0), ("cap", 0), ("used", 0),
        ("free_rows", 1), ("n_free", 0), ("free_taken", 0),
        ("rec", 0), ("pos", 0), ("drop_from", 0),
        ("full_rows", 1), ("n_full", 0), ("hist_rec", 1), ("hist_pid", 1),
        ("n_hist", 0), ("drop_rec", 1), ("n_drop", 0),
        ("kept", 0), ("skipped", 0), ("scalars", 0), ("max_ts", 0))]


class NativeShardCore:
    """A shard's part-key map (``PartKey.serialized`` → pid) and its
    container pass, in C++. The caller holds the shard's lock around
    every call."""

    def __init__(self):
        self._free = _fn("ic_free")
        self._h = _fn("ic_new")()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)

    def __len__(self) -> int:
        return int(_fn("ic_size")(self._h))

    def clear(self) -> None:
        _fn("ic_clear")(self._h)

    def lookup(self, blobs) -> np.ndarray:
        """int64 pids of ``blobs``, -1 where the map lacks one."""
        buf, off = pack_blobs(blobs)
        out = np.zeros(len(blobs), np.int64)
        _fn("ic_lookup")(self._h, addr(buf), addr(off), len(blobs),
                         addr(out))
        return out

    def insert(self, blobs, pids, live=None) -> None:
        """Map ``blobs[i]`` to ``pids[i]`` (where ``live[i]``, if given):
        one call for a restored registry of a million keys."""
        buf, off = pack_blobs(blobs)
        pids = np.ascontiguousarray(pids, np.int64)
        live = None if live is None else np.ascontiguousarray(live, np.uint8)
        _fn("ic_insert")(self._h, addr(buf), addr(off), len(blobs),
                         addr(pids), addr(live))

    def erase(self, blobs, pids) -> int:
        """Forget ``blobs[i]`` where it maps to ``pids[i]``; returns the
        keys forgotten."""
        buf, off = pack_blobs(blobs)
        pids = np.ascontiguousarray(pids, np.int64)
        return int(_fn("ic_erase")(self._h, addr(buf), addr(off), len(blobs),
                                   addr(pids)))

    @staticmethod
    def validate(buf: np.ndarray, nrec: int) -> bool:
        return _fn("ic_validate")(addr(buf), len(buf), nrec) == 0

    def start(self, buf: np.ndarray, nrec: int, offset: int,
              watermarks: np.ndarray) -> IngestCtl:
        """A pass over container ``buf`` (validated) at log ``offset``,
        with its output arrays."""
        c = IngestCtl()
        c.raw, c.len, c.nrec, c.offset = addr(buf), len(buf), nrec, offset
        c.schema_index = addr(_SCHEMA_INDEX)
        c.names, c.name_off = addr(_NAMES), addr(_NAME_OFF)
        c.watermarks, c.groups = addr(watermarks), len(watermarks)
        c.pos, c.max_ts, c.drop_from = 5, -1, nrec
        out = np.empty((4, max(nrec, 1)), np.int64)
        c.full_rows, c.hist_rec, c.hist_pid, c.drop_rec = (
            addr(out[i]) for i in range(4))
        c.out = out  # the pointers' arrays live as long as the pass
        c.keep = (buf, watermarks)
        return c

    def ingest(self, c: IngestCtl, latest: np.ndarray, hist: np.ndarray,
               bufs) -> int:
        """Run the pass on from ``c.rec`` over the shard's per-pid
        ``latest`` and ``hist`` and its scalar write buffers ``bufs`` as
        they are now (a new partition or a reserve reallocates them; the
        buffers' ``slot`` covers every pid); returns why it stopped. The
        rows it handed out are ``bufs``' from then on."""
        c.latest, c.hist = addr(latest), addr(hist)
        c.buf_ts, c.buf_vals, c.buf_n = addr(bufs.ts), addr(bufs.vals), \
            addr(bufs.n)
        c.slot, c.n_slot, c.pid_of = addr(bufs.slot), len(bufs.slot), \
            addr(bufs.pid_of)
        c.M, c.cap, c.used = bufs.max_chunk_size, len(bufs.n), bufs.used
        free = bufs.free_rows
        c.free_rows, c.n_free, c.free_taken = addr(free), len(free), 0
        why = int(_fn("ic_ingest")(self._h, ctypes.byref(c)))
        bufs.handed_out(c.used, c.free_taken)
        return why

    def misses(self, c: IngestCtl) -> tuple[np.ndarray, np.ndarray, list]:
        """The keys the map lacks among the pass's records from ``c.rec``
        on, each once in the order of its first record: (that record's
        index, its timestamp, the blobs)."""
        n = c.nrec - c.rec
        rec = np.empty(max(n, 1), np.int64)
        ts = np.empty(max(n, 1), np.int64)
        blobs = np.empty(c.len + n * _LONGEST_NAME + 1, np.uint8)
        off = np.zeros(n + 1, np.int64)
        k = int(_fn("ic_misses")(self._h, ctypes.byref(c), addr(rec),
                                 addr(ts), addr(blobs), addr(off)))
        raw = blobs[:off[k]].tobytes()
        return rec[:k], ts[:k], [raw[a:b] for a, b in
                                 zip(off[:k].tolist(), off[1:k + 1].tolist())]


def append_round(buf, rows: np.ndarray, taken: np.ndarray, lens: np.ndarray,
                 ts: np.ndarray, vals: np.ndarray, full: np.ndarray) -> int:
    """One round of ``WriteBuffers.append`` over ``buf``'s arrays (taken
    now: a reserve reallocates them): row i's next samples into buffer row
    ``rows[i]`` as far as it has room; the rows that filled go to ``full``
    in input order. Returns their number."""
    width = 8 * int(np.prod(buf.vals.shape[2:], dtype=np.int64))
    return int(_fn("ic_append_round")(
        addr(buf.ts), addr(buf.vals), addr(buf.n), buf.max_chunk_size,
        width, addr(rows), addr(taken), addr(lens), len(rows), addr(ts),
        addr(vals), ts.shape[1], addr(full)))


def sealed_overlap(chunks: dict, pids: np.ndarray, t0s: np.ndarray,
                   t1s: np.ndarray, n_pids: int) -> np.ndarray:
    """bool [P]: which of ``pids`` (below ``n_pids``) have a live sealed
    chunk of ``chunks`` (a chunk table's columns) overlapping (min t0s,
    max t1s]: ``shard_buf_fold``'s flag bit 1."""
    pids = np.ascontiguousarray(pids, np.int64)
    t0s = np.ascontiguousarray(t0s, np.int64)
    t1s = np.ascontiguousarray(t1s, np.int64)
    flags = np.zeros(len(pids), np.int32)
    if len(pids) and len(t0s):
        row_of = np.full(max(n_pids, int(pids.max()) + 1), -1, np.int64)
        row_of[pids] = np.arange(len(pids))
        dead = np.ascontiguousarray(chunks["dead"], np.uint8)
        _fn("ic_sealed_overlap")(
            addr(chunks["pid"]), addr(chunks["t0"]), addr(chunks["t1"]),
            addr(dead), len(dead), addr(t0s), addr(t1s), len(t0s),
            addr(row_of), len(row_of), addr(flags))
    return flags != 0


def buf_fold(buf, pids: np.ndarray, t0s: np.ndarray, t1s: np.ndarray,
             chunks: dict | None = None, n_pids: int = 0):
    """The reference's ``shard_buf_fold`` over scalar write buffers
    ``buf``: (stats float64 [P, W, 12] of each pid's buffer samples in each
    window (t0s[w], t1s[w]], flags int32 [P]: bit 0 non-monotone buffer
    timestamps, and with ``chunks`` bit 1, ``sealed_overlap``). Large
    folds run on a thread pool."""
    pids = np.ascontiguousarray(pids, np.int64)
    t0s = np.ascontiguousarray(t0s, np.int64)
    t1s = np.ascontiguousarray(t1s, np.int64)
    P, W = len(pids), len(t0s)
    out = np.empty((P, W, 12), np.float64)
    flags = np.zeros(P, np.int32)
    if chunks is not None:
        flags |= 2 * sealed_overlap(chunks, pids, t0s, t1s, n_pids)
    fold = _fn("ic_buf_fold")

    def span(a: int) -> None:
        b = min(a + _FOLD_SPAN, P)
        fold(addr(buf.ts), addr(buf.vals), addr(buf.n), addr(buf.slot),
             len(buf.slot), buf.max_chunk_size, addr(pids[a:b]), b - a,
             addr(t0s), addr(t1s), W, addr(out[a:b]), addr(flags[a:b]))

    starts = range(0, P, _FOLD_SPAN)
    if P > _FOLD_SPAN:
        if not _pool:
            _pool.append(ThreadPoolExecutor(_FOLD_WORKERS,
                                            thread_name_prefix="buf-fold"))
        list(_pool[0].map(span, starts))
    else:
        for a in starts:
            span(a)
    return out, flags
