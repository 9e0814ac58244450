"""Evicted-part-key Bloom filter.

Copy of ``filodb_tpu/utils/bloom.py``: when a seemingly new series key
arrives at ingest, a positive answer means the key may have been evicted
before, and the shard restores the series' identity (its original start
time and its dedup floor) instead of minting a fresh one. False positives
cost an index lookup. Bits by double hashing (Kirsch-Mitzenmacher) over
the two 64-bit halves of a blake2b digest; ``state()`` is the JSON the
index snapshot carries, the reference's for the same keys.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np


class BloomFilter:
    """Fixed-capacity bloom filter over byte strings."""

    def __init__(self, capacity: int, fp_rate: float = 0.01):
        capacity = max(capacity, 1)
        m = int(-capacity * math.log(fp_rate) / (math.log(2) ** 2))
        self.nbits = max(64, 1 << (m - 1).bit_length())  # pow2 for masking
        self.k = max(1, round(m / capacity * math.log(2)))
        self._bits = np.zeros(self.nbits // 64, np.uint64)
        self.count = 0

    def _indexes(self, key: bytes) -> np.ndarray:
        d = hashlib.blake2b(key, digest_size=16).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little") | 1
        idx = (h1 + np.arange(self.k, dtype=np.uint64) * np.uint64(h2 % 2**63)) \
            & np.uint64(self.nbits - 1)
        return idx

    def add(self, key: bytes) -> None:
        idx = self._indexes(key)
        np.bitwise_or.at(self._bits, (idx >> np.uint64(6)).astype(np.int64),
                         np.uint64(1) << (idx & np.uint64(63)))
        self.count += 1

    def __contains__(self, key: bytes) -> bool:
        idx = self._indexes(key)
        word = self._bits[(idx >> np.uint64(6)).astype(np.int64)]
        bit = np.uint64(1) << (idx & np.uint64(63))
        return bool(np.all(word & bit))

    def state(self) -> dict:
        """Snapshot-serializable state."""
        return {"nbits": int(self.nbits), "k": int(self.k),
                "count": int(self.count),
                "bits": self._bits.tobytes().hex()}

    @staticmethod
    def from_state(st: dict) -> "BloomFilter":
        bf = BloomFilter.__new__(BloomFilter)
        bf.nbits = st["nbits"]
        bf.k = st["k"]
        bf.count = st["count"]
        bf._bits = np.frombuffer(bytes.fromhex(st["bits"]),
                                 np.uint64).copy()
        return bf
