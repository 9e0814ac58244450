"""The typed wire codec of the plan wire, without pickle.

Port of ``filodb_tpu/coordinator/wire.py``, byte for byte in its format:
a closed registry of the classes allowed on the wire (exec plans,
transformers, filters and dispatchers by subclass walk, the query model,
``PartKey`` and the mesh runtime's ``LoweredDescriptor``), each value a
tagged binary tree. Decoding instantiates registered classes only, so a
peer cannot run code, and frames are length-capped (``MAX_FRAME``).

Format (little-endian): one tagged value.
    N/T/F  none/true/false            I i64     f f64
    S/B    u32 len + utf8/bytes       L/U u32 count + values (list/tuple)
    Z      u32 count + values (a set, sorted by repr)
    D      u32 count + (key, value)*
    A      dtype str | u8 ndim | i64 shape* | raw bytes
    O      class-name str | u16 nfields | (name str, value)*

A class's fields are its ``__wire_fields__`` where it names them, else
its dataclass fields. The port's model classes name the reference's
fields in the reference's order (``query/model.py``): both packages
decode each other's frames, and equal objects encode to the same bytes.
A ``StepMatrix`` goes materialized (deferred compaction applied, values
in host numpy float64), a torch tensor as the numpy array it holds.

``MAX_FRAME`` is 2 GiB less one byte, the most the length word holds
beside its compression bit; the reference caps frames at 256 MiB. A mesh
worker's answer at 1 M series over two workers is past that (500,000
series × 121 steps of float32 windows and their keys), so a port peer
takes frames the reference's refuses; every smaller frame passes both.

Two memos keep the mesh runtime's per-series key lists off the hot path,
neither changing a byte of the format: ``encoded(items)`` wraps a list
(the worker's batch keys, the same object while the batch lives) with its
wire bytes, made once and spliced in at every later encode; and a long
list of ``RangeVectorKey`` decoded once is handed out again, the same
list object, where a later frame holds the same bytes (callers must not
change such a list). A ``RangeVectorKey`` decodes on a fast path.
"""

from __future__ import annotations

import dataclasses
import struct
import threading

import numpy as np
import torch

MAX_FRAME = (1 << 31) - 1  # hard cap on any frame (the reference: 256 MiB)
_MEMO_MIN = 4096   # items of a list worth a memo
_MEMO_CAP = 8      # lists each memo keeps
_memo_lock = threading.Lock()


def _build_registry() -> dict[str, type]:
    """Every class allowed on the wire; the subclass walks keep it in step
    with new exec plans, transformers, filters and dispatchers. Every
    module defining wire classes is imported before the walk, so the
    registry does not depend on import order."""
    from filodb_tpu_torch.coordinator import remote  # noqa: F401
    from filodb_tpu_torch.coordinator.mesh_cluster import LoweredDescriptor
    from filodb_tpu_torch.core.filters import ColumnFilter, Filter
    from filodb_tpu_torch.core.partkey import PartKey
    from filodb_tpu_torch.query.exec import binaryjoin  # noqa: F401
    from filodb_tpu_torch.query.exec import transformers as _tr
    from filodb_tpu_torch.query.exec.plan import ExecPlan, PlanDispatcher
    from filodb_tpu_torch.query.model import (
        PlannerParams,
        QueryContext,
        QueryStats,
        RangeVectorKey,
        StepMatrix,
        TraceContext,
    )
    from filodb_tpu_torch.utils.governor import QueryBudget

    reg: dict[str, type] = {}

    def walk(base):
        for cls in base.__subclasses__():
            reg[cls.__name__] = cls
            walk(cls)

    for base in (ExecPlan, PlanDispatcher, Filter,
                 _tr.RangeVectorTransformer):
        reg[base.__name__] = base
        walk(base)
    for cls in (ColumnFilter, PartKey, LoweredDescriptor, PlannerParams,
                QueryBudget, QueryContext, QueryStats, RangeVectorKey,
                StepMatrix, TraceContext):
        reg[cls.__name__] = cls
    return reg


_REGISTRY: dict[str, type] | None = None


def registry() -> dict[str, type]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
    return _REGISTRY


# ---------------------------------------------------------------------------
# encode

class Encoded(list):
    """A list and its wire bytes (``encoded``); encoding it splices them."""

    __slots__ = ("wire",)


_encoded: dict[int, tuple[list, Encoded]] = {}


def encoded(items: list) -> list:
    """``items`` as an ``Encoded`` list, its bytes made once while the
    same list object comes back (short lists as they are)."""
    if len(items) < _MEMO_MIN:
        return items
    with _memo_lock:
        hit = _encoded.get(id(items))
        if hit is not None and hit[0] is items:
            return hit[1]
    out = Encoded(items)
    buf = bytearray()
    _enc(list(items), buf)
    out.wire = bytes(buf)
    with _memo_lock:
        if len(_encoded) >= _MEMO_CAP:
            _encoded.pop(next(iter(_encoded)))
        _encoded[id(items)] = (items, out)
    return out


def encode(obj) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _enc_str(s: str, out: bytearray) -> None:
    b = s.encode()
    out += struct.pack("<I", len(b))
    out += b


def _enc(obj, out: bytearray) -> None:  # noqa: C901
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, int):
        out += b"I"
        out += struct.pack("<q", obj)
    elif isinstance(obj, float):
        out += b"f"
        out += struct.pack("<d", obj)
    elif isinstance(obj, str):
        out += b"S"
        _enc_str(obj, out)
    elif isinstance(obj, bytes):
        out += b"B"
        out += struct.pack("<I", len(obj))
        out += obj
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        a = np.ascontiguousarray(obj)
        out += b"A"
        _enc_str(a.dtype.str, out)
        out += struct.pack("<B", a.ndim)
        out += struct.pack(f"<{a.ndim}q", *a.shape)
        out += a.tobytes()
    elif isinstance(obj, np.integer):
        out += b"I"
        out += struct.pack("<q", int(obj))
    elif isinstance(obj, np.floating):
        out += b"f"
        out += struct.pack("<d", float(obj))
    elif isinstance(obj, Encoded):
        out += obj.wire
    elif isinstance(obj, list):
        out += b"L"
        out += struct.pack("<I", len(obj))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, tuple):
        out += b"U"
        out += struct.pack("<I", len(obj))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, (set, frozenset)):
        out += b"Z"
        out += struct.pack("<I", len(obj))
        for x in sorted(obj, key=repr):
            _enc(x, out)
    elif isinstance(obj, dict):
        out += b"D"
        out += struct.pack("<I", len(obj))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    else:
        cls = type(obj)
        name = cls.__name__
        if registry().get(name) is not cls:
            raise TypeError(f"{name} is not wire-serializable (register it)")
        fields = _wire_fields(cls, obj)
        out += b"O"
        _enc_str(name, out)
        out += struct.pack("<H", len(fields))
        for fname, val in fields:
            _enc_str(fname, out)
            _enc(val, out)


def _wire_fields(cls, obj) -> list[tuple[str, object]]:
    if cls.__name__ == "StepMatrix" and (
            obj.pending_compact or isinstance(obj.values, torch.Tensor)):
        # a copy settled and on the host: the sender's matrix stays as is
        obj = dataclasses.replace(obj).materialize()
    names = cls.__dict__.get("__wire_fields__")
    if names is not None:
        return [(n, getattr(obj, n)) for n in names]
    if dataclasses.is_dataclass(cls):
        return [(f.name, getattr(obj, f.name)) for f in
                dataclasses.fields(cls) if f.init]
    names = getattr(cls, "__wire_fields__", None)
    if names is None:
        raise TypeError(f"{cls.__name__} has no wire fields")
    return [(n, getattr(obj, n)) for n in names]


# ---------------------------------------------------------------------------
# decode

def decode(data: bytes):
    """One value; a truncated or malformed frame raises ``ValueError``
    (a transport error to the framed clients), never ``struct.error``."""
    try:
        obj, off = _dec(data, 0)
    except struct.error as e:
        raise ValueError(f"wire frame truncated: {e}") from e
    if off != len(data):
        raise ValueError(f"trailing bytes after wire value: {len(data) - off}")
    return obj


def _need(data: bytes, off: int, n: int) -> None:
    if off + n > len(data):
        raise ValueError(f"wire frame truncated: need {n} at {off}, "
                         f"have {len(data) - off}")


def _dec_str(data: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    _need(data, off, n)
    return data[off : off + n].decode(), off + n


def _dec(data: bytes, off: int):  # noqa: C901
    tag = data[off : off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"I":
        (v,) = struct.unpack_from("<q", data, off)
        return v, off + 8
    if tag == b"f":
        (v,) = struct.unpack_from("<d", data, off)
        return v, off + 8
    if tag == b"S":
        return _dec_str(data, off)
    if tag == b"B":
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        _need(data, off, n)
        return data[off : off + n], off + n
    if tag == b"A":
        dt, off = _dec_str(data, off)
        ndim = data[off]
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", data, off)
        off += 8 * ndim
        dtype = np.dtype(dt)
        count = int(np.prod(shape)) if ndim else 1
        nbytes = count * dtype.itemsize
        _need(data, off, nbytes)
        arr = np.frombuffer(data, dtype, count=count,
                            offset=off).reshape(shape).copy()
        return arr, off + nbytes
    if tag == b"L":
        (n,) = struct.unpack_from("<I", data, off)
        if n >= _MEMO_MIN:
            return _dec_long_list(data, off - 1, n)
    if tag in (b"L", b"U", b"Z"):
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        items = []
        for _ in range(n):
            x, off = _dec(data, off)
            items.append(x)
        if tag == b"L":
            return items, off
        return (tuple(items) if tag == b"U" else frozenset(items)), off
    if tag == b"D":
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(data, off)
            v, off = _dec(data, off)
            d[k] = v
        return d, off
    if tag == b"O":
        if data[off : off + 4 + len(_RVK)] == _RVK_HEAD:
            return _dec_range_vector_key(data, off + 4 + len(_RVK))
        name, off = _dec_str(data, off)
        cls = registry().get(name)
        if cls is None:
            raise ValueError(f"unknown wire class {name!r}")
        return _dec_object(cls, data, off)
    raise ValueError(f"bad wire tag {tag!r} at {off - 1}")


_RVK = b"RangeVectorKey"
_RVK_HEAD = struct.pack("<I", len(_RVK)) + _RVK
_RVK_FIELD = struct.pack("<H", 1) + struct.pack("<I", 6) + b"labels" + b"U"
_u32 = struct.Struct("<I").unpack_from


def _dec_range_vector_key(data, off: int):
    """A ``RangeVectorKey`` (its class name read): the labels' pairs read
    in one loop, or the general path where the layout is another."""
    if data[off : off + len(_RVK_FIELD)] != _RVK_FIELD:
        return _dec_object(registry()["RangeVectorKey"], data, off)
    off += len(_RVK_FIELD)
    (n,) = _u32(data, off)
    off += 4
    labels = []
    for _ in range(n):
        if data[off : off + 6] != b"U\x02\x00\x00\x00S":
            raise ValueError(f"bad label pair at {off}")
        (a,) = _u32(data, off + 6)
        _need(data, off + 10, a)
        k = data[off + 10 : off + 10 + a].decode()
        off += 10 + a
        if data[off : off + 1] != b"S":
            raise ValueError(f"bad label value at {off}")
        (b,) = _u32(data, off + 1)
        _need(data, off + 5, b)
        v = data[off + 5 : off + 5 + b].decode()
        off += 5 + b
        labels.append((k, v))
    return registry()["RangeVectorKey"](tuple(labels)), off


def _dec_object(cls, data, off: int):
    (nf,) = struct.unpack_from("<H", data, off)
    off += 2
    kwargs = {}
    for _ in range(nf):
        fname, off = _dec_str(data, off)
        val, off = _dec(data, off)
        kwargs[fname] = val
    return cls(**kwargs), off


_decoded: dict[tuple, list] = {}


def _dec_long_list(data, at: int, n: int):
    """A list of ``n`` ≥ ``_MEMO_MIN`` items at ``at`` (its tag): where an
    earlier frame held the same bytes, a list of ``RangeVectorKey``
    objects then, that list object again."""
    probe = (n, bytes(data[at : at + 256]))
    with _memo_lock:
        seen = list(_decoded.get(probe, ()))
    for region, items in seen:
        if data[at : at + len(region)] == region:
            return items, at + len(region)
    off = at + 5
    items = []
    for _ in range(n):
        x, off = _dec(data, off)
        items.append(x)
    rvk = registry()["RangeVectorKey"]
    if all(type(x) is rvk for x in items):
        with _memo_lock:
            if len(_decoded) >= _MEMO_CAP:
                _decoded.pop(next(iter(_decoded)))
            _decoded.setdefault(probe, []).insert(
                0, (bytes(data[at:off]), items))
            del _decoded[probe][2:]
    return items, off
