"""Replayable ingestion logs: the write-ahead log.

Copy of ``filodb_tpu/kafka/log.py``: shards checkpoint (group → offset)
and, on restart, replay the log from ``min(checkpoints)``, skipping rows
below their group's watermark. ``FileLog`` and ``SegmentedFileLog`` write
the reference's files (``seg-<first offset>.log``: ``FLOG1``, then u32
length | container bytes per entry), so either package replays the
other's log. The reference's read-only tailer mode (a gateway process
appending on a shared filesystem) is not copied.
"""

from __future__ import annotations

import os
import struct
import threading
from collections.abc import Iterator

from filodb_tpu_torch.core.record import BytesContainer, SomeData


class ReplayLog:
    """One shard's ordered, offset-addressed container log."""

    def append(self, container) -> int:
        raise NotImplementedError

    def read_from(self, offset: int) -> Iterator[SomeData]:
        raise NotImplementedError

    @property
    def latest_offset(self) -> int:
        raise NotImplementedError

    def offset_lag(self, consumed: int) -> int:
        """Records appended past ``consumed`` (never negative)."""
        return max(0, self.latest_offset - consumed)

    def align_after(self, offset: int) -> None:
        """Make the next append's offset greater than ``offset``. Recovery
        calls this with the largest checkpoint: a torn tail may have lost
        records whose offsets were checkpointed, and reusing them would let
        the watermark skip new acknowledged rows. In-process logs die with
        the process, so the default does nothing."""


class InMemoryLog(ReplayLog):
    def __init__(self):
        self._entries: list = []
        self._lock = threading.Lock()

    def append(self, container) -> int:
        with self._lock:
            self._entries.append(container)
            return len(self._entries) - 1

    def read_from(self, offset: int) -> Iterator[SomeData]:
        start = max(offset, 0)
        with self._lock:
            entries = self._entries[start:]
        for i, container in enumerate(entries):
            yield SomeData(container, start + i)

    @property
    def latest_offset(self) -> int:
        with self._lock:
            return len(self._entries) - 1


class FileLog(ReplayLog):
    """Append-only length-prefixed record log with a sparse offset index
    ((offset, file position) every ``index_every`` entries) for seeks.

    Acknowledged appends survive a process crash (buffered write and
    flush); ``fsync=True`` fsyncs every append for power loss too. A torn
    tail found on reopen is cut back to the last whole record, so later
    appends stay readable."""

    MAGIC = b"FLOG1"

    def __init__(self, path: str, index_every: int = 64,
                 fsync: bool = False, read_only: bool = False):
        """``read_only``: a tailer's view of a segment another process
        appends to: no write handle, and a partial tail is never cut (it
        may be the owner's append in flight)."""
        self.path = path
        self.index_every = index_every
        self.fsync = fsync
        self.read_only = read_only
        self._lock = threading.Lock()
        self._count = 0
        self._index: list[tuple[int, int]] = []  # (offset, pos)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            self._recover_scan()
        elif read_only:
            raise FileNotFoundError(path)
        else:
            with open(path, "wb") as f:
                f.write(self.MAGIC)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            if fsync:
                # the directory entry of a new segment must be durable too
                dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
        self._f = None if read_only else open(path, "ab")

    def _recover_scan(self):
        # only called from __init__, but _count/_index are lock-guarded
        # everywhere else: held here too, so the invariant is uniform (and
        # checkable), as the reference's
        with self._lock:
            self._recover_scan_locked()

    def _recover_scan_locked(self):
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            if f.read(5) != self.MAGIC:
                if self.read_only:
                    return  # a segment being created: read it next poll
                raise ValueError(f"bad log file {self.path}")
            pos = 5
            while pos + 4 <= size:
                f.seek(pos)
                (ln,) = struct.unpack("<I", f.read(4))
                if pos + 4 + ln > size:
                    break  # torn tail
                if self._count % self.index_every == 0:
                    self._index.append((self._count, pos))
                pos += 4 + ln
                self._count += 1
        if pos < size and not self.read_only:
            # appends after the garbage would be unreadable: cut it off
            with open(self.path, "r+b") as f:
                f.truncate(pos)

    def append(self, container) -> int:
        if self.read_only:
            raise OSError(f"read-only tailer view of {self.path}")
        payload = container.serialize()
        with self._lock:
            pos = self._f.tell()
            if self._count % self.index_every == 0:
                self._index.append((self._count, pos))
            self._f.write(struct.pack("<I", len(payload)))
            self._f.write(payload)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            off = self._count
            self._count += 1
            return off

    def read_from(self, offset: int) -> Iterator[SomeData]:
        """Whole records from ``offset`` to the end of the file, as it is
        now: a tailer sees what another process appended since it opened
        the file; a partial record ends the scan, the next one retries."""
        offset = max(offset, 0)
        with self._lock:
            if self._f is not None:
                self._f.flush()
            seek_off, seek_pos = 0, 5
            for o, p in self._index:
                if o <= offset:
                    seek_off, seek_pos = o, p
                else:
                    break
        with open(self.path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            f.seek(seek_pos)
            cur, pos = seek_off, seek_pos
            while pos + 4 <= size:
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                (ln,) = struct.unpack("<I", hdr)
                if pos + 4 + ln > size:
                    break  # partial tail
                data = f.read(ln)
                if len(data) < ln:
                    break
                if cur >= offset:
                    yield SomeData(BytesContainer(data), cur)
                cur += 1
                pos += 4 + ln

    @property
    def latest_offset(self) -> int:
        with self._lock:
            return self._count - 1

    def close(self):
        if self._f is not None:
            self._f.close()


class SegmentedFileLog(ReplayLog):
    """A log of segments of ``segment_entries`` entries each
    (``seg-<first offset, 20 digits>.log``); ``truncate_before`` deletes
    whole segments below a checkpoint, bounding the log without rewrites
    (the Kafka segment and retention model).

    ``read_only`` is a tailer's view of a log another process appends to
    (a mesh worker tailing its node's WAL, ``parallel/multiproc.py``):
    every segment opens read-only, ``append`` raises, ``align_after`` does
    nothing, and each read picks up the segments the appender rolled since
    and drops those it truncated."""

    def __init__(self, directory: str, segment_entries: int = 4096,
                 index_every: int = 64, fsync: bool = False,
                 read_only: bool = False):
        self.dir = directory
        self.segment_entries = segment_entries
        self.index_every = index_every
        self.fsync = fsync
        self.read_only = read_only
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        self._segments: list[tuple[int, FileLog]] = []  # (first_offset, log)
        for name in sorted(os.listdir(directory)):
            if name.startswith("seg-") and name.endswith(".log"):
                self._segments.append(
                    (int(name[4:-4]), FileLog(os.path.join(directory, name),
                                              index_every, fsync=fsync,
                                              read_only=read_only)))
        if not self._segments and not read_only:
            self._roll(0)

    def _roll(self, first_offset: int) -> None:
        path = os.path.join(self.dir, f"seg-{first_offset:020d}.log")
        self._segments.append((first_offset, FileLog(path, self.index_every,
                                                     fsync=self.fsync)))

    def append(self, container) -> int:
        if self.read_only:
            raise OSError(f"read-only tailer view of {self.dir}")
        with self._lock:
            first, seg = self._segments[-1]
            if seg.latest_offset + 1 >= self.segment_entries:
                self._roll(first + seg.latest_offset + 1)
                first, seg = self._segments[-1]
            return first + seg.append(container)

    def _discover_segments(self) -> None:
        """A tailer's: open (read-only) the segments another process rolled
        since this view last looked."""
        known = {first for first, _ in self._segments}
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("seg-") and name.endswith(".log"):
                first = int(name[4:-4])
                if first not in known:
                    try:
                        self._segments.append(
                            (first, FileLog(os.path.join(self.dir, name),
                                            self.index_every,
                                            read_only=True)))
                    except FileNotFoundError:
                        pass  # truncated meanwhile
        self._segments.sort(key=lambda t: t[0])

    def read_from(self, offset: int) -> Iterator[SomeData]:
        offset = max(offset, 0)
        with self._lock:
            if self.read_only:
                self._discover_segments()
            segments = list(self._segments)
        for i, (first, seg) in enumerate(segments):
            # a segment ends where the next one starts (a tailer's record
            # counts are stale for segments another process appends to)
            if i + 1 < len(segments) and segments[i + 1][0] <= offset:
                continue
            try:
                for sd in seg.read_from(max(offset - first, 0)):
                    yield SomeData(sd.container, first + sd.offset)
            except FileNotFoundError:
                # the owner truncated this segment: its records lie below
                # every checkpoint
                with self._lock:
                    self._segments = [(f, s) for f, s in self._segments
                                      if f != first]

    @property
    def latest_offset(self) -> int:
        with self._lock:
            if not self._segments:
                return -1
            first, seg = self._segments[-1]
        return first + seg.latest_offset

    def align_after(self, offset: int) -> None:
        if self.read_only:
            return  # offsets are the appender's
        with self._lock:
            first, seg = self._segments[-1]
            if first + seg.latest_offset >= offset:
                return
            if first > offset and seg.latest_offset < 0:
                return  # an empty segment already starts past the offset
            self._roll(offset + 1)

    @property
    def earliest_offset(self) -> int:
        with self._lock:
            return self._segments[0][0] if self._segments else 0

    def truncate_before(self, offset: int) -> int:
        """Delete whole segments below ``offset`` (the newest is always
        kept); returns the segments removed."""
        removed = 0
        with self._lock:
            while len(self._segments) > 1 and self._segments[1][0] <= offset:
                _, seg = self._segments.pop(0)
                seg.close()
                os.remove(seg.path)
                removed += 1
        return removed

    def close(self):
        for _, seg in self._segments:
            seg.close()
