"""Columnar vector codecs over NibblePack: the vectors of a chunk.

Copy of the parts of ``filodb_tpu/memory/codecs.py`` the port's chunks
use, byte for byte: delta-delta int64 (timestamps), XOR and const
float64, frame-of-reference packed ints, raw float64, and the 2D-delta
histogram vector, with ``decode_any`` dispatching on the leading codec id.
``HistogramColumn`` is the decoded form of a histogram vector. NibblePack
runs in the host C++ codec (``memory/nibblepack.py``); the string and map
codecs are not copied (no schema of the port has such a column).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from filodb_tpu_torch.memory.nibblepack import (
    nibble_pack,
    nibble_unpack,
    zigzag_decode,
    zigzag_encode,
)

# codec ids (first byte of every encoded vector)
CODEC_DELTA_DELTA = 1
CODEC_DELTA_DELTA_CONST = 2
CODEC_XOR_DOUBLE = 3
CODEC_HIST_2D_DELTA = 4
CODEC_RAW_DOUBLE = 6
CODEC_CONST_DOUBLE = 8         # ConstVector analog for doubles
CODEC_PACKED_INT = 9           # frame-of-reference bit-packed ints/longs


def encode_delta_delta(values: np.ndarray) -> bytes:
    """Encode int64s with a sloped-line predictor: pred[i] = base + slope*i."""
    v = np.ascontiguousarray(values, dtype=np.int64)
    n = len(v)
    if n == 0:
        return struct.pack("<BIqq", CODEC_DELTA_DELTA_CONST, 0, 0, 0)
    base = int(v[0])
    slope = int((int(v[-1]) - base) // (n - 1)) if n > 1 else 0
    pred = base + slope * np.arange(n, dtype=np.int64)
    resid = v - pred
    if not resid.any():
        return struct.pack("<BIqq", CODEC_DELTA_DELTA_CONST, n, base, slope)
    packed = nibble_pack(zigzag_encode(resid))
    return struct.pack("<BIqq", CODEC_DELTA_DELTA, n, base, slope) + packed


def decode_delta_delta(data: bytes) -> np.ndarray:
    codec, n, base, slope = struct.unpack_from("<BIqq", data, 0)
    pred = base + slope * np.arange(n, dtype=np.int64)
    if codec == CODEC_DELTA_DELTA_CONST:
        return pred
    assert codec == CODEC_DELTA_DELTA, f"bad codec {codec}"
    resid = zigzag_decode(nibble_unpack(data[struct.calcsize("<BIqq") :], n))
    return pred + resid


def encode_xor_double(values: np.ndarray) -> bytes:
    """Encode float64s: XOR against previous value's bit pattern, NibblePack."""
    v = np.ascontiguousarray(values, dtype=np.float64)
    n = len(v)
    bits = v.view(np.uint64)
    prev = np.concatenate([[np.uint64(0)], bits[:-1]])
    xored = bits ^ prev
    packed = nibble_pack(xored)
    return struct.pack("<BI", CODEC_XOR_DOUBLE, n) + packed


def decode_xor_double(data: bytes) -> np.ndarray:
    codec, n = struct.unpack_from("<BI", data, 0)
    assert codec == CODEC_XOR_DOUBLE, f"bad codec {codec}"
    xored = nibble_unpack(data[struct.calcsize("<BI") :], n)
    bits = np.bitwise_xor.accumulate(xored)
    return bits.view(np.float64)


@dataclass(frozen=True)
class HistogramColumn:
    """Decoded histogram vector: bucket upper bounds + cumulative count rows."""

    les: np.ndarray  # (nb,) float64 bucket upper bounds ("le" values)
    rows: np.ndarray  # (n, nb) int64 cumulative counts per row


def encode_hist_2d_delta(rows: np.ndarray, les: np.ndarray | None = None) -> bytes:
    """Encode histogram rows [n, num_buckets] (cumulative bucket counts, int64)
    plus the shared bucket-bound scheme.

    2D delta: within a row take deltas across buckets (cumulative -> per-bucket),
    then across time subtract the previous row's bucket deltas. Residuals can be
    negative only for counter resets; zigzag handles that.
    """
    r = np.ascontiguousarray(rows, dtype=np.int64)
    n, nb = r.shape if r.ndim == 2 else (0, 0)
    if les is None:
        les = np.zeros(nb, dtype=np.float64)
    les = np.ascontiguousarray(les, dtype=np.float64)
    head = struct.pack("<BII", CODEC_HIST_2D_DELTA, n, nb) + les.tobytes()
    if n == 0:
        return head
    bucket_deltas = np.diff(r, axis=1, prepend=0)
    time_deltas = np.diff(bucket_deltas, axis=0, prepend=np.zeros((1, nb), np.int64))
    return head + nibble_pack(zigzag_encode(time_deltas.ravel()))


def decode_hist_2d_delta(data: bytes) -> HistogramColumn:
    codec, n, nb = struct.unpack_from("<BII", data, 0)
    assert codec == CODEC_HIST_2D_DELTA, f"bad codec {codec}"
    off = struct.calcsize("<BII")
    les = np.frombuffer(data, dtype=np.float64, count=nb, offset=off).copy()
    off += nb * 8
    if n == 0:
        return HistogramColumn(les, np.zeros((0, nb), dtype=np.int64))
    flat = zigzag_decode(nibble_unpack(data[off:], n * nb))
    time_deltas = flat.reshape(n, nb)
    bucket_deltas = np.cumsum(time_deltas, axis=0)
    return HistogramColumn(les, np.cumsum(bucket_deltas, axis=1))


def encode_const_double(value: float, n: int) -> bytes:
    """All-rows-equal double vector (reference ``ConstVector.scala``: repeats
    one stored value ``numRows`` times)."""
    return struct.pack("<BId", CODEC_CONST_DOUBLE, n, value)


def decode_const_double(data: bytes) -> np.ndarray:
    codec, n, value = struct.unpack_from("<BId", data, 0)
    assert codec == CODEC_CONST_DOUBLE, f"bad codec {codec}"
    return np.full(n, value, dtype=np.float64)


def encode_double(values: np.ndarray) -> bytes:
    """Encode a double column with automatic codec selection: const when all
    rows carry one value (bitwise, so NaN==NaN), XOR+NibblePack otherwise
    (reference ``DoubleVector.optimize`` → ConstVector / DeltaDeltaDouble)."""
    v = np.ascontiguousarray(values, dtype=np.float64)
    if len(v) and (v.view(np.uint64) == v.view(np.uint64)[0]).all():
        return encode_const_double(float(v[0]), len(v))
    return encode_xor_double(v)


# frame-of-reference bit widths tried in order (reference IntBinaryVector
# supports nbits 2/4/8/16/32; we add 1 and 64 at the extremes)
_PACK_WIDTHS = (1, 2, 4, 8, 16, 32, 64)


def encode_packed_int(values: np.ndarray) -> bytes:
    """Frame-of-reference bit-packed integer vector.

    Values are rebased against their minimum, then packed at the smallest
    bit width in {1,2,4,8,16,32,64} that holds ``max - min``; an all-equal
    vector collapses to width 0 (ConstVector analog). Counterpart of the
    reference's minimal-nbits int vectors (``IntBinaryVector.scala:56-120``,
    ``IntBinaryVector.optimize``) and ``LongBinaryVector``/``ConstVector``.
    """
    v = np.ascontiguousarray(values, dtype=np.int64)
    n = len(v)
    if n == 0:
        return struct.pack("<BIqB", CODEC_PACKED_INT, 0, 0, 0)
    base = int(v.min())
    spread = int(v.max()) - base  # fits u64: int64 range spread
    if spread == 0:
        return struct.pack("<BIqB", CODEC_PACKED_INT, n, base, 0)
    rebased = (v - base).astype(np.uint64)
    nbits = next(w for w in _PACK_WIDTHS if spread < (1 << w) or w == 64)
    head = struct.pack("<BIqB", CODEC_PACKED_INT, n, base, nbits)
    if nbits >= 8:
        return head + rebased.astype(f"<u{nbits // 8}").tobytes()
    # sub-byte widths: pack per-value bits little-endian within each byte
    per_byte = 8 // nbits
    pad = (-n) % per_byte
    r = np.concatenate([rebased, np.zeros(pad, np.uint64)]) \
        .reshape(-1, per_byte).astype(np.uint8)
    shifts = (np.arange(per_byte, dtype=np.uint8) * nbits).astype(np.uint8)
    packed = (r << shifts).astype(np.uint8)
    return head + np.bitwise_or.reduce(packed, axis=1).tobytes()


def decode_packed_int(data: bytes) -> np.ndarray:
    codec, n, base, nbits = struct.unpack_from("<BIqB", data, 0)
    assert codec == CODEC_PACKED_INT, f"bad codec {codec}"
    off = struct.calcsize("<BIqB")
    if n == 0:
        return np.array([], np.int64)
    if nbits == 0:
        return np.full(n, base, dtype=np.int64)
    if nbits >= 8:
        raw = np.frombuffer(data, dtype=f"<u{nbits // 8}", count=n, offset=off)
        return base + raw.astype(np.int64)
    per_byte = 8 // nbits
    nbytes = (n + per_byte - 1) // per_byte
    b = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=off)
    shifts = (np.arange(per_byte, dtype=np.uint8) * nbits).astype(np.uint8)
    mask = np.uint8((1 << nbits) - 1)
    vals = ((b[:, None] >> shifts) & mask).reshape(-1)[:n]
    return base + vals.astype(np.int64)


def encode_int(values: np.ndarray) -> bytes:
    """Encode an int/long column picking the smaller of frame-of-reference
    bit packing and delta-delta+NibblePack (the reference's ``optimize`` step
    likewise picks the best encoding per chunk)."""
    packed = encode_packed_int(values)
    dd = encode_delta_delta(values)
    return packed if len(packed) <= len(dd) else dd


def encode_raw_double(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.float64)
    return struct.pack("<BI", CODEC_RAW_DOUBLE, len(v)) + v.tobytes()


def decode_raw_double(data: bytes) -> np.ndarray:
    codec, n = struct.unpack_from("<BI", data, 0)
    assert codec == CODEC_RAW_DOUBLE, f"bad codec {codec}"
    off = struct.calcsize("<BI")
    return np.frombuffer(data, dtype=np.float64, count=n, offset=off).copy()


def decode_any(data: bytes):
    """Dispatch on the leading codec id."""
    codec = data[0]
    if codec in (CODEC_DELTA_DELTA, CODEC_DELTA_DELTA_CONST):
        return decode_delta_delta(data)
    if codec == CODEC_XOR_DOUBLE:
        return decode_xor_double(data)
    if codec == CODEC_HIST_2D_DELTA:
        return decode_hist_2d_delta(data)
    if codec == CODEC_RAW_DOUBLE:
        return decode_raw_double(data)
    if codec == CODEC_CONST_DOUBLE:
        return decode_const_double(data)
    if codec == CODEC_PACKED_INT:
        return decode_packed_int(data)
    raise ValueError(f"unknown codec id {codec}")
