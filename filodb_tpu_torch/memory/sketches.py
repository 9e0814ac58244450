"""Mergeable sketches for the approximate lane: top-k and count-distinct
over the part keys of a pyramid object.

Copy of ``filodb_tpu/memory/sketches.py``; serialized bytes equal the
reference's. Every sketch here is a commutative monoid (``merge`` of two
sketches over disjoint data is the sketch of their union), so pyramid
levels (segment, bucket, query) fold them without revisiting payloads:

- :class:`TopKSketch`: per-key running max pruned to ``capacity``. Each
  part key lives in one storage bucket, so merging per-bucket sketches of
  capacity at least k gives the exact top k of per-series maxima; the
  lane still declares the answer approximate (``FILODB_SIDECAR_APPROX``),
  since pruning makes the general merge lossy.
- :class:`HLLSketch`: HyperLogLog (p=10, 1024 byte registers, standard
  error about 3.25 %) over part-key blobs.

Both ride in the footers of pyramid objects (``core/store/pyramid.py``).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np


def _hash64(blob: bytes) -> int:
    """Stable 64-bit hash of a key blob (blake2b — stdlib, keyed runs
    reproduce across processes, unlike ``hash()``)."""
    return int.from_bytes(
        hashlib.blake2b(blob, digest_size=8).digest(), "little")


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 -> uint64 well-mixed bits
    (for benchmark-scale synthetic key populations where per-key blake2b
    would dominate the measurement)."""
    x = np.asarray(x, np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30)))
         * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27)))
         * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


class TopKSketch:
    """Top-k of per-key maxima: ``{key_blob: running max}`` pruned to
    ``capacity`` entries (keep the largest).  Merge is union-max then
    prune — exact while every key's full contribution lands in one
    sketch (the pyramid's per-bucket partitioning guarantees that)."""

    __slots__ = ("capacity", "entries")

    def __init__(self, capacity: int = 64,
                 entries: dict[bytes, float] | None = None):
        self.capacity = capacity
        self.entries: dict[bytes, float] = entries or {}

    def update(self, key: bytes, value: float) -> None:
        v = float(value)
        if v != v:  # NaN never competes
            return
        cur = self.entries.get(key)
        if cur is None or v > cur:
            self.entries[key] = v
            if len(self.entries) > 2 * self.capacity:
                self._prune()

    def _prune(self) -> None:
        if len(self.entries) > self.capacity:
            keep = sorted(self.entries.items(),
                          key=lambda kv: (-kv[1], kv[0]))[:self.capacity]
            self.entries = dict(keep)

    def merge(self, other: "TopKSketch") -> "TopKSketch":
        for k, v in other.entries.items():
            cur = self.entries.get(k)
            if cur is None or v > cur:
                self.entries[k] = v
        self._prune()
        return self

    def top(self, k: int) -> list[tuple[bytes, float]]:
        self._prune()
        return sorted(self.entries.items(),
                      key=lambda kv: (-kv[1], kv[0]))[:k]

    def serialize(self) -> bytes:
        self._prune()
        parts = [struct.pack("<II", self.capacity, len(self.entries))]
        for k, v in sorted(self.entries.items()):
            parts.append(struct.pack("<H", len(k)))
            parts.append(k)
            parts.append(struct.pack("<d", v))
        return b"".join(parts)

    @staticmethod
    def deserialize(data: bytes, off: int = 0) -> tuple["TopKSketch", int]:
        cap, n = struct.unpack_from("<II", data, off)
        off += 8
        entries: dict[bytes, float] = {}
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", data, off)
            off += 2
            k = bytes(data[off:off + klen])
            off += klen
            (v,) = struct.unpack_from("<d", data, off)
            off += 8
            entries[k] = v
        return TopKSketch(cap, entries), off


# HLL bias constant for m = 2^p registers (p >= 7: 0.7213/(1+1.079/m))
_HLL_P = 10
_HLL_M = 1 << _HLL_P


class HLLSketch:
    """HyperLogLog count-distinct, p=10 (1024 uint8 registers, standard
    error 1.04/sqrt(1024) ≈ 3.25%).  Merge = elementwise register max."""

    __slots__ = ("registers",)

    def __init__(self, registers: np.ndarray | None = None):
        self.registers = (np.zeros(_HLL_M, np.uint8) if registers is None
                          else np.asarray(registers, np.uint8))

    def add(self, blob: bytes) -> None:
        self.update_hashes(np.array([_hash64(blob)], np.uint64))

    def update_hashes(self, h: np.ndarray) -> None:
        """Fold pre-hashed uint64 values (vectorized bulk path)."""
        h = np.asarray(h, np.uint64)
        if h.size == 0:
            return
        idx = (h & np.uint64(_HLL_M - 1)).astype(np.int64)
        w = h >> np.uint64(_HLL_P)
        # rank = 1 + leading zeros of the remaining 54 bits
        nbits = 64 - _HLL_P
        rank = np.full(h.shape, nbits + 1, np.uint8)
        wk = w.copy()
        bits = np.zeros(h.shape, np.int64)
        for shift in (32, 16, 8, 4, 2, 1):
            m = wk >= (np.uint64(1) << np.uint64(shift))
            bits[m] += shift
            wk[m] >>= np.uint64(shift)
        nz = w != 0
        rank[nz] = (nbits - bits[nz]).astype(np.uint8)
        np.maximum.at(self.registers, idx, rank)

    def merge(self, other: "HLLSketch") -> "HLLSketch":
        np.maximum(self.registers, other.registers, out=self.registers)
        return self

    def estimate(self) -> float:
        regs = self.registers.astype(np.float64)
        alpha = 0.7213 / (1.0 + 1.079 / _HLL_M)
        est = alpha * _HLL_M * _HLL_M / np.sum(2.0 ** -regs)
        if est <= 2.5 * _HLL_M:
            zeros = int(np.count_nonzero(self.registers == 0))
            if zeros:
                return _HLL_M * np.log(_HLL_M / zeros)
        return float(est)

    def serialize(self) -> bytes:
        return self.registers.astype("<u1").tobytes()

    @staticmethod
    def deserialize(data: bytes, off: int = 0) -> tuple["HLLSketch", int]:
        regs = np.frombuffer(data, "<u1", _HLL_M, off).copy()
        return HLLSketch(regs), off + _HLL_M
