"""NibblePack: nibble-granularity bit packing of u64 streams.

Copy of ``filodb_tpu/memory/nibblepack.py``. Values pack in groups of 8;
each group stores a 1-byte nonzero bitmap and, if any value is nonzero, a
1-byte nibble descriptor (nibbles kept minus one, trailing zero nibbles)
followed by the kept nibbles of each nonzero value, little-endian.

``nibble_pack`` / ``nibble_unpack`` run the host C++ codec
(``csrc/hostcodec.cpp``, built with ``g++`` on first use; a failed build
raises). ``nibble_pack_py`` / ``nibble_unpack_py`` are the reference's
pure-Python loops, the twins the tests hold the C++ against.
"""

from __future__ import annotations

import numpy as np

from filodb_tpu_torch import _build

_U64 = np.uint64


def zigzag_encode(values: np.ndarray) -> np.ndarray:
    """Map signed int64 -> uint64 with small magnitudes near zero."""
    v = values.astype(np.int64)
    return ((v << np.int64(1)) ^ (v >> np.int64(63))).astype(np.uint64)


def zigzag_decode(values: np.ndarray) -> np.ndarray:
    u = values.astype(np.uint64)
    return ((u >> _U64(1)).astype(np.int64)) ^ (-(u & _U64(1)).astype(np.int64))


def packed_bound(n: int) -> int:
    """Most bytes ``n`` values can pack into (8 full-width values a
    group: bitmap, descriptor and 64 bytes)."""
    return -(-n // 8) * 66


def nibble_pack(values: np.ndarray) -> bytes:
    """Pack uint64 values into NibblePack bytes (host C++)."""
    vals = np.ascontiguousarray(values, dtype=np.uint64)
    out = np.empty(packed_bound(len(vals)), np.uint8)
    n = _build.host_fn("fh_nibble_pack", 3)(vals.ctypes.data, len(vals),
                                            out.ctypes.data)
    return out[:n].tobytes()


def nibble_unpack(data: bytes, count: int) -> np.ndarray:
    """Unpack ``count`` uint64 values from NibblePack bytes (host C++)."""
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(count, np.uint64)
    if count and _build.host_fn("fh_nibble_unpack", 4)(
            buf.ctypes.data, len(buf), out.ctypes.data, count) < 0:
        raise ValueError(f"NibblePack data ends before {count} values")
    return out


def _nibble_width(x: int) -> int:
    """Number of nibbles needed to represent x (>=1 even for 0)."""
    if x == 0:
        return 1
    return (x.bit_length() + 3) // 4


def _trailing_zero_nibbles(x: int) -> int:
    if x == 0:
        return 16
    tz = 0
    while x & 0xF == 0:
        tz += 1
        x >>= 4
    return tz


def nibble_pack_py(values: np.ndarray) -> bytes:
    """Pure-Python twin of ``nibble_pack`` (the reference's loop)."""
    vals = np.ascontiguousarray(values, dtype=np.uint64)
    out = bytearray()
    n = len(vals)
    for g in range(0, n, 8):
        ints = [int(x) for x in vals[g : g + 8]]
        ints += [0] * (8 - len(ints))
        bitmap = 0
        for i, x in enumerate(ints):
            if x != 0:
                bitmap |= 1 << i
        out.append(bitmap)
        if bitmap == 0:
            continue
        nz = [x for x in ints if x != 0]
        tz = min(_trailing_zero_nibbles(x) for x in nz)
        num_nibbles = max(_nibble_width(x) for x in nz) - tz
        out.append(((num_nibbles - 1) << 4) | tz)
        acc = 0
        acc_bits = 0
        for x in nz:
            x >>= 4 * tz
            acc |= (x & ((1 << (4 * num_nibbles)) - 1)) << acc_bits
            acc_bits += 4 * num_nibbles
            while acc_bits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                acc_bits -= 8
        if acc_bits > 0:
            out.append(acc & 0xFF)
    return bytes(out)


def nibble_unpack_py(data: bytes, count: int) -> np.ndarray:
    """Pure-Python twin of ``nibble_unpack`` (the reference's loop)."""
    out = np.zeros(count, dtype=np.uint64)
    pos = 0
    idx = 0
    while idx < count:
        bitmap = data[pos]
        pos += 1
        if bitmap == 0:
            idx += 8
            continue
        desc = data[pos]
        pos += 1
        num_nibbles = (desc >> 4) + 1
        tz = desc & 0xF
        nbytes = (bin(bitmap).count("1") * num_nibbles + 1) // 2
        chunk = int.from_bytes(data[pos : pos + nbytes], "little")
        pos += nbytes
        mask = (1 << (4 * num_nibbles)) - 1
        shift = 0
        for i in range(8):
            if bitmap & (1 << i):
                if idx + i < count:
                    out[idx + i] = ((chunk >> shift) & mask) << (4 * tz)
                shift += 4 * num_nibbles
        idx += 8
    return out
