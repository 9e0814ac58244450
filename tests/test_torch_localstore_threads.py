"""Concurrent reads on a shard's sqlite connection (ROADMAP §C.14).

A node reads one shard's database from many threads at once: the ingest
and downsampler job threads, the flush scheduler, the HTTP routes and
page-ins. Eight threads here repeat ``read_checkpoints``,
``read_chunk_rows`` and ``scan_part_keys`` on one port store while a
ninth writes chunks, part keys and checkpoints. Every read must return
well-formed rows equal to what was written up to that read: at least
what was committed before the read began, at most what had begun by its
end, each chunk's bytes as written.

``truncate`` (ROADMAP §C.19) empties a dataset: after it, a scan finds
no part key and a read no chunk; beside readers of every shard, none of
them fails or reads a closed connection.
"""

from __future__ import annotations

import os
import threading

from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.store.api import PartKeyRecord
from filodb_tpu_torch.core.store.localstore import (
    LocalDiskColumnStore,
    LocalDiskMetaStore,
)

DS = "timeseries"
SHARD = 0
GROUPS = 4
WRITES = 120
READERS = 8
KEYS = [PartKey.create("prom-counter", {"_metric_": "m", "_ws_": "w",
                                        "_ns_": "n", "instance": f"i{i}"})
        for i in range(6)]
BLOBS = [k.serialized for k in KEYS]


def _data(blob: bytes, chunk: int) -> bytes:
    return blob + b"#" + str(chunk).encode() * 40


class _Progress:
    """The writer's progress: ``begun`` is the write in flight (or the last
    one), ``done`` the last one that returned (-1 before any)."""

    def __init__(self):
        self.begun = -1
        self.done = -1
        self.finished = threading.Event()


def _writer(cs, ms, prog: _Progress, errors: list) -> None:
    try:
        for i in range(WRITES):
            prog.begun = i
            cs.write_chunk_rows(DS, SHARD, [(b, i, i * 10, i * 10 + 9,
                                             _data(b, i)) for b in BLOBS],
                                ingestion_time=i)
            cs.write_part_keys(DS, SHARD, [PartKeyRecord(k, 0, i)
                                           for k in KEYS])
            ms.write_checkpoint(DS, SHARD, i % GROUPS, i)
            prog.done = i
    except Exception as e:  # noqa: BLE001 - reported by the test
        errors.append(f"writer: {e!r}")
    finally:
        prog.finished.set()


def _check_checkpoints(got, lo: int, hi: int) -> str | None:
    if not isinstance(got, dict) or not all(
            isinstance(g, int) and isinstance(o, int) for g, o in got.items()):
        return f"checkpoints not {{int: int}}: {got!r}"
    for g in range(GROUPS):
        last_done = lo - (lo - g) % GROUPS  # the last write of g before
        o = got.get(g)
        if last_done >= 0 and (o is None or o < last_done):
            return f"group {g} at {o}, written {last_done} before the read"
        if o is not None and (o % GROUPS != g or o > hi):
            return f"group {g} at {o}: never written by write {hi} or before"
    return None


def _check_chunks(rows, lo: int, hi: int) -> str | None:
    seen: dict[bytes, list[bytes]] = {}
    for r in rows:
        if len(r) != 2:
            return f"malformed chunk row {r!r}"
        seen.setdefault(bytes(r[0]), []).append(bytes(r[1]))
    for b in BLOBS:
        got = seen.get(b, [])
        if not lo + 1 <= len(got) <= hi + 1:
            return (f"{len(got)} chunks of a key, {lo + 1} written before "
                    f"the read, {hi + 1} begun by its end")
        if got != [_data(b, c) for c in range(len(got))]:
            return "chunk bytes differ from what was written"
    return None


def _check_part_keys(recs, lo: int, hi: int) -> str | None:
    if lo < 0:
        return None
    if sorted(r.part_key.serialized for r in recs) != sorted(BLOBS):
        return f"part keys {[r.part_key for r in recs]!r}"
    for r in recs:
        if not lo <= r.end_time <= hi:
            return f"end time {r.end_time} outside [{lo}, {hi}]"
    return None


def _reader(cs, ms, prog: _Progress, errors: list, counts: list,
            idx: int) -> None:
    kind = idx % 3
    n = 0
    while not prog.finished.is_set() or n < 3:
        lo = prog.done
        try:
            if kind == 0:
                got = ms.read_checkpoints(DS, SHARD)
                hi = prog.begun
                err = _check_checkpoints(got, lo, hi)
            elif kind == 1:
                got = cs.read_chunk_rows(DS, SHARD, BLOBS, 0, 1 << 40)
                hi = prog.begun
                err = _check_chunks(got, lo, hi) if lo >= 0 else None
            else:
                got = cs.scan_part_keys(DS, SHARD)
                hi = prog.begun
                err = _check_part_keys(got, lo, hi)
        except Exception as e:  # noqa: BLE001 - reported by the test
            err = repr(e)
        if err is not None:
            errors.append(f"reader {idx}: {err}")
            return
        n += 1
    counts[idx] = n


def test_reads_beside_a_writer_return_what_was_written(tmp_path):
    cs = LocalDiskColumnStore(str(tmp_path))
    ms = LocalDiskMetaStore(str(tmp_path))
    cs.initialize(DS, 1)
    ms.read_checkpoints(DS, SHARD)  # open the meta store's connection
    prog = _Progress()
    errors: list[str] = []
    counts = [0] * READERS
    threads = [threading.Thread(target=_reader,
                                args=(cs, ms, prog, errors, counts, i))
               for i in range(READERS)]
    threads.append(threading.Thread(target=_writer,
                                    args=(cs, ms, prog, errors)))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a thread hung"
        assert not errors, "\n".join(errors[:5])
        assert prog.done == WRITES - 1
        assert min(counts) >= 3, counts
        # what the last read sees is everything
        assert _check_checkpoints(ms.read_checkpoints(DS, SHARD),
                                  WRITES - 1, WRITES - 1) is None
        assert _check_chunks(cs.read_chunk_rows(DS, SHARD, BLOBS, 0, 1 << 40),
                             WRITES - 1, WRITES - 1) is None
    finally:
        cs.close()
        ms.close()


def _fill(cs, shards: int) -> None:
    for s in range(shards):
        cs.write_chunk_rows(DS, s, [(b, 1, 0, 9, _data(b, 1))
                                    for b in BLOBS], ingestion_time=1)
        cs.write_part_keys(DS, s, [PartKeyRecord(k, 0, 9) for k in KEYS])


def test_truncate_empties_the_dataset(tmp_path):
    cs = LocalDiskColumnStore(str(tmp_path))
    try:
        cs.initialize(DS, 2)
        cs.initialize("other", 1)
        _fill(cs, 2)
        cs.write_chunk_rows("other", 0, [(BLOBS[0], 1, 0, 9, b"x")], 1)
        assert len(cs.scan_part_keys(DS, 1)) == len(KEYS)
        cs.truncate(DS)
        assert not [f for f in os.listdir(tmp_path / DS)
                    if f.startswith("shard-")]
        for s in range(2):
            assert cs.scan_part_keys(DS, s) == []
            assert cs.read_chunk_rows(DS, s, BLOBS, 0, 1 << 40) == []
            assert cs.max_persisted_ts(DS, s) == {}
        # another dataset keeps its rows
        assert cs.read_chunk_rows("other", 0, BLOBS[:1], 0, 1 << 40) == [
            (BLOBS[0], b"x")]
        # the store takes writes again, its counters past the old ones
        before = cs.update_tokens(DS, 0)[0]
        _fill(cs, 1)
        assert len(cs.scan_part_keys(DS, 0)) == len(KEYS)
        assert cs.update_tokens(DS, 0)[0] > before
    finally:
        cs.close()


def test_truncate_beside_readers(tmp_path):
    cs = LocalDiskColumnStore(str(tmp_path))
    cs.initialize(DS, 2)
    _fill(cs, 2)
    stop = threading.Event()
    errors: list[str] = []
    reads = [0] * 4

    def reader(i: int) -> None:
        shard = i % 2
        while not stop.is_set():
            try:
                rows = cs.read_chunk_rows(DS, shard, BLOBS, 0, 1 << 40)
                recs = cs.scan_part_keys(DS, shard)
            except Exception as e:  # noqa: BLE001 - reported by the test
                errors.append(f"reader {i}: {e!r}")
                return
            if len(rows) not in (0, len(BLOBS)) \
                    or len(recs) not in (0, len(KEYS)):
                errors.append(f"reader {i}: {len(rows)} rows, "
                              f"{len(recs)} part keys")
                return
            reads[i] += 1

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for _ in range(20):
            cs.truncate(DS)
            _fill(cs, 2)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "a reader hung"
        assert not errors, "\n".join(errors[:5])
        assert min(reads) > 0, reads
    finally:
        stop.set()
        cs.close()
