"""Partition keys, hashing and shard routing.

Copy of ``filodb_tpu/core/partkey.py`` (the port imports nothing of
``filodb_tpu``). A partition key is (schema, sorted label map); the metric
name is the label ``_metric_``. The shard of a series takes its upper bits
from the hash of the shard-key labels (``_ws_``, ``_ns_``, ``_metric_``) and
its low ``spread`` bits from the hash of the whole key.

The hash is murmur3-32 over the canonical serialized key. Besides the
one-key form, ``murmur3_32_many`` hashes a list of keys at once with numpy
(bit-equal to the one-key form), which is what bulk ingest of a million
series needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

METRIC_LABEL = "_metric_"

_C1, _C2 = 0xCC9E2D51, 0x1B873593


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Stable 32-bit murmur3 (x86 variant)."""
    h = seed
    n = len(data)
    rounded = n - (n & 3)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * _C1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * _C2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * _C2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix(h: np.ndarray) -> np.ndarray:
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _murmur3_same_len(rows: np.ndarray, seed: int) -> np.ndarray:
    """murmur3_32 of each row of a uint8 [N, n] array (keys of one length)."""
    N, n = rows.shape
    rounded = n - (n & 3)
    h = np.full(N, seed, np.uint32)
    with np.errstate(over="ignore"):
        if rounded:
            blocks = np.ascontiguousarray(rows[:, :rounded]).view("<u4")
            for j in range(blocks.shape[1]):
                k = blocks[:, j].astype(np.uint32) * np.uint32(_C1)
                k = _rotl(k, 15) * np.uint32(_C2)
                h ^= k
                h = _rotl(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        tail = rows[:, rounded:].astype(np.uint32)
        if tail.shape[1]:
            k = np.zeros(N, np.uint32)
            for j in range(tail.shape[1] - 1, -1, -1):
                k ^= tail[:, j] << np.uint32(8 * j)
            k = _rotl(k * np.uint32(_C1), 15) * np.uint32(_C2)
            h ^= k
        h ^= np.uint32(n)
        return _fmix(h)


def murmur3_32_many(keys: list[bytes], seed: int = 0) -> np.ndarray:
    """``murmur3_32`` of every key, vectorised over keys of equal length."""
    out = np.empty(len(keys), np.uint32)
    lens = np.fromiter((len(k) for k in keys), np.int64, len(keys))
    for n in np.unique(lens):
        idx = np.flatnonzero(lens == n)
        rows = np.frombuffer(b"".join(keys[i] for i in idx),
                             np.uint8).reshape(len(idx), int(n))
        out[idx] = _murmur3_same_len(rows, seed)
    return out


@dataclass(frozen=True)
class PartKey:
    """An immutable partition key: schema name + label map (incl. _metric_)."""

    schema: str
    labels: tuple[tuple[str, str], ...]  # sorted (name, value) pairs

    @staticmethod
    def create(schema: str, labels: dict[str, str]) -> "PartKey":
        return PartKey(schema, tuple(sorted(labels.items())))

    @cached_property
    def label_map(self) -> dict[str, str]:
        return dict(self.labels)

    @cached_property
    def range_vector_key(self):
        from filodb_tpu_torch.query.model import RangeVectorKey
        return RangeVectorKey(self.labels)

    @property
    def metric(self) -> str:
        return self.label_map.get(METRIC_LABEL, "")

    @cached_property
    def serialized(self) -> bytes:
        parts = [self.schema.encode()]
        for k, v in self.labels:
            parts.append(k.encode() + b"\x01" + v.encode())
        return b"\x00".join(parts)

    @cached_property
    def part_hash(self) -> int:
        return murmur3_32(self.serialized)

    def shard_key_hash(self, shard_key_labels: tuple[str, ...]) -> int:
        return shard_key_hash(
            {k: self.label_map.get(k, "") for k in shard_key_labels}
        )

    def __str__(self) -> str:
        inner = ",".join(f"{k}={v}" for k, v in self.labels if k != METRIC_LABEL)
        return f"{self.metric}{{{inner}}}"


def shard_key_hash(shard_key_values: dict[str, str]) -> int:
    """Hash of the shard-key labels only."""
    data = b"\x00".join(
        k.encode() + b"\x01" + v.encode() for k, v in sorted(shard_key_values.items())
    )
    return murmur3_32(data, seed=0x5EED)


def shards_for_shard_key(shard_key_h: int, num_shards: int,
                         spread: int) -> list[int]:
    """Every shard a shard key maps to at ``spread``: the query fan-out."""
    mask = (1 << spread) - 1
    base = shard_key_h & ~mask & (num_shards - 1)
    return [(base | i) & (num_shards - 1) for i in range(1 << spread)]


def ingestion_shard(shard_key_h, part_h, num_shards: int, spread: int):
    """Owning shard: upper bits from the shard-key hash, the low ``spread``
    bits from the whole-key hash. Works on ints and on numpy arrays."""
    if num_shards & (num_shards - 1):
        raise ValueError("num_shards must be a power of 2")
    mask = (1 << spread) - 1
    return (shard_key_h & (~mask & 0xFFFFFFFF) | part_h & mask) \
        & (num_shards - 1)
