"""Ingestion records and containers: what the log carries into a shard.

Copy of ``filodb_tpu/core/record.py``: a container of schema-tagged records,
each holding (partition key, timestamp, data values), serialized in the
version-2 binary layout that the write-ahead log stores, byte for byte::

    u8 ver=2 | u32 n_records | records...
    record: u32 rec_len | u32 part_hash | i64 ts | u16 schema_id
            | u16 nlabels | (u16 klen|k|u16 vlen|v)*  (sorted)
            | u8 nvals | values*
    value:  u8 0 | f64                      (double column)
            u8 1 | u16 nb | f64*nb | i64*nb (histogram les+counts)

Version-1 (pickle) containers are refused: the port reads no pickle.

``parse_container`` reads a serialized container into columns (part hashes,
timestamps, schema, part-key blobs, double values, where each histogram
value lies) in a few calls of the host C++ codec and numpy, with no object
per record: replay of one scrape of a million series is a million records.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from filodb_tpu_torch import _build
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.schemas import SCHEMAS

SCHEMA_NAMES = tuple(SCHEMAS)  # a record's schema, by index
_SCHEMA_INDEX = {SCHEMAS[n].schema_id: i for i, n in enumerate(SCHEMA_NAMES)}
_NAMES = np.frombuffer(b"".join(n.encode() for n in SCHEMA_NAMES), np.uint8)
_NAME_OFF = np.cumsum([0] + [len(n.encode()) for n in SCHEMA_NAMES] + [0],
                      dtype=np.int64)  # the last name is "" (unknown id)


def encode_labels(labels: tuple[tuple[str, str], ...]) -> bytes:
    """Label-section wire codec: u16 nlabels | (u16 klen|k|u16 vlen|v)*."""
    out = [struct.pack("<H", len(labels))]
    for k, v in labels:
        kb, vb = k.encode(), v.encode()
        out.append(struct.pack("<H", len(kb)))
        out.append(kb)
        out.append(struct.pack("<H", len(vb)))
        out.append(vb)
    return b"".join(out)


def decode_labels(data: bytes, off: int) -> tuple[tuple, int]:
    (nlabels,) = struct.unpack_from("<H", data, off)
    off += 2
    labels = []
    for _ in range(nlabels):
        (kl,) = struct.unpack_from("<H", data, off)
        off += 2
        k = data[off : off + kl].decode()
        off += kl
        (vl,) = struct.unpack_from("<H", data, off)
        off += 2
        labels.append((k, data[off : off + vl].decode()))
        off += vl
    return tuple(labels), off


@dataclass(frozen=True)
class IngestRecord:
    """One sample for one series. ``values`` follows the schema's
    non-timestamp data columns in order; a histogram value is a tuple
    (les float64 [nb], cumulative counts int64 [nb])."""

    part_key: PartKey
    timestamp: int  # epoch millis
    values: tuple


@dataclass
class RecordContainer:
    """A batch of records."""

    records: list[IngestRecord] = field(default_factory=list)

    def add(self, rec: IngestRecord) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def serialize(self) -> bytes:
        """The version-2 layout of the module docstring."""
        out = [struct.pack("<BI", 2, len(self.records))]
        for r in self.records:
            body = [struct.pack("<IqH", r.part_key.part_hash, r.timestamp,
                                SCHEMAS[r.part_key.schema].schema_id),
                    encode_labels(r.part_key.labels),
                    struct.pack("<B", len(r.values))]
            for v in r.values:
                if isinstance(v, tuple) or (
                        isinstance(v, np.ndarray) and v.ndim):
                    les, counts = v
                    les = np.ascontiguousarray(les, np.float64)
                    counts = np.ascontiguousarray(counts, np.int64)
                    body.append(struct.pack("<BH", 1, len(les)))
                    body.append(les.tobytes())
                    body.append(counts.tobytes())
                else:
                    body.append(struct.pack("<Bd", 0, float(v)))
            payload = b"".join(body)
            out.append(struct.pack("<I", len(payload)))
            out.append(payload)
        return b"".join(out)

    @staticmethod
    def deserialize(data: bytes) -> "RecordContainer":
        if data[0] != 2:
            raise ValueError(f"container version {data[0]}: the port reads "
                             f"version 2 only (version 1 is pickle)")
        (n,) = struct.unpack_from("<I", data, 1)
        off = 5
        c = RecordContainer()
        key_memo: dict = {}  # the same series repeats within a batch
        by_id = {SCHEMAS[s].schema_id: s for s in SCHEMAS}
        for _ in range(n):
            (rec_len,) = struct.unpack_from("<I", data, off)
            off += 4
            end = off + rec_len
            _, ts, sid = struct.unpack_from("<IqH", data, off)
            off += 14
            labels_start = off
            labels, off = decode_labels(data, off)
            nvals = data[off]
            off += 1
            vals = []
            for _ in range(nvals):
                tag = data[off]
                off += 1
                if tag == 0:
                    (x,) = struct.unpack_from("<d", data, off)
                    off += 8
                    vals.append(x)
                else:
                    (nb,) = struct.unpack_from("<H", data, off)
                    off += 2
                    les = np.frombuffer(data, np.float64, nb, off).copy()
                    off += 8 * nb
                    counts = np.frombuffer(data, np.int64, nb, off).copy()
                    off += 8 * nb
                    vals.append((les, counts))
            if off != end:
                raise ValueError("record length mismatch")
            memo_key = (sid, data[labels_start:off])
            pk = key_memo.get(memo_key)
            if pk is None:
                pk = key_memo[memo_key] = PartKey(by_id[sid], tuple(labels))
            c.add(IngestRecord(pk, ts, tuple(vals)))
        return c


class BytesContainer:
    """A container held as its serialized bytes (what the log hands back on
    replay); ``parse_container`` reads it, ``RecordContainer.deserialize``
    makes its records."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        self.raw = raw

    def __len__(self) -> int:
        return struct.unpack_from("<I", self.raw, 1)[0]

    def serialize(self) -> bytes:
        return self.raw


@dataclass(frozen=True)
class SomeData:
    """A container together with its log offset."""

    container: RecordContainer | BytesContainer
    offset: int


@dataclass
class ContainerColumns:
    """The records of one container as columns."""

    part_hash: np.ndarray   # uint32 [n]
    ts: np.ndarray          # int64 [n]
    schema: np.ndarray      # int64 [n]: index into SCHEMA_NAMES, -1 unknown
    keys: list[bytes]       # part-key blobs (PartKey.serialized)
    dvals: np.ndarray       # float64 [n, width]: the first double values
    hist_off: np.ndarray    # int64 [n]: a histogram value's u16 nb, or -1
    raw: np.ndarray         # uint8: the container

    def __len__(self) -> int:
        return len(self.ts)

    def histograms(self, idx: np.ndarray):
        """(les float64 [k, nb], counts int64 [k, nb]) of the histogram
        values of records ``idx``, which must share one bucket count nb."""
        off = self.hist_off[idx]
        if (off < 0).any():
            raise ValueError("a record holds no histogram value")
        nbs = self.raw[off] | (self.raw[off + 1].astype(np.int64) << 8)
        nb = int(nbs[0]) if len(idx) else 0
        if (nbs != nb).any():
            raise ValueError("histograms of more than one bucket count")
        at = off[:, None] + 2 + np.arange(16 * nb)[None, :]
        body = self.raw[at]
        return (body[:, : 8 * nb].copy().view(np.float64),
                body[:, 8 * nb :].copy().view(np.int64))

    def bucket_counts(self) -> np.ndarray:
        """int64 [n]: each record's histogram bucket count (0: none)."""
        off = np.maximum(self.hist_off, 0)
        nb = self.raw[off] | (self.raw[off + 1].astype(np.int64) << 8)
        return np.where(self.hist_off >= 0, nb, 0)


def parse_container(raw: bytes, width: int = 2) -> ContainerColumns:
    """Columns of a serialized v2 container (host C++), the first
    ``width`` double values of each record in ``dvals``. Raises
    ``ValueError`` on a malformed one."""
    if not raw or raw[0] != 2:
        raise ValueError(f"container version {raw[0] if raw else None}: the "
                         f"port reads version 2 only")
    (n,) = struct.unpack_from("<I", raw, 1)
    buf = np.frombuffer(raw, np.uint8)
    h = np.zeros(n, np.uint32)
    ts = np.zeros(n, np.int64)
    sid = np.zeros(n, np.int32)
    lab_off = np.zeros(n, np.int64)
    lab_len = np.zeros(n, np.int64)
    val_off = np.zeros(n, np.int64)
    nvals = np.zeros(n, np.int32)
    if _build.host_fn("fh_container_scan", 10)(
            buf.ctypes.data, len(buf), n, h.ctypes.data, ts.ctypes.data,
            sid.ctypes.data, lab_off.ctypes.data, lab_len.ctypes.data,
            val_off.ctypes.data, nvals.ctypes.data) != 0:
        raise ValueError("malformed record container")
    dvals = np.zeros((n, width), np.float64)
    hist_off = np.zeros(n, np.int64)
    _build.host_fn("fh_container_values", 7)(
        buf.ctypes.data, val_off.ctypes.data, nvals.ctypes.data, n,
        dvals.ctypes.data, width, hist_off.ctypes.data)
    schema = np.array([_SCHEMA_INDEX.get(int(s), -1) for s in np.unique(sid)])
    schema = schema[np.searchsorted(np.unique(sid), sid)] if n \
        else np.zeros(0, np.int64)
    name_idx = np.where(schema >= 0, schema, len(SCHEMA_NAMES)).astype(
        np.int32)
    cap = int(lab_len.sum()) + n * int(_NAME_OFF[-1] + 1)
    out = np.empty(max(cap, 1), np.uint8)
    out_off = np.zeros(n + 1, np.int64)
    if _build.host_fn("fh_container_keys", 9)(
            buf.ctypes.data, lab_off.ctypes.data, name_idx.ctypes.data, n,
            _NAMES.ctypes.data, _NAME_OFF.ctypes.data, out.ctypes.data, cap,
            out_off.ctypes.data) != 0:
        raise RuntimeError("host codec: part-key blobs passed their bound")
    blob = out[: out_off[-1]].tobytes()
    keys = [blob[a:b] for a, b in zip(out_off[:-1].tolist(),
                                      out_off[1:].tolist())]
    return ContainerColumns(h, ts, schema.astype(np.int64), keys, dvals,
                            hist_off, buf)
