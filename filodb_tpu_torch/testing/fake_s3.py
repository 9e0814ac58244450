"""An in-process S3 subset for the object store's tests and dev nodes.

Copy of ``filodb_tpu/testing/fake_s3.py``: PUT, GET with a byte range,
LIST by prefix, DELETE and multipart upload, plus two things real S3
lacks:

- **disk persistence** (``root=``): objects are files under a directory,
  written to a temporary file and renamed, so a new ``FakeS3`` over the
  same root sees everything an earlier one stored (a crash test drops
  every in-memory structure and reads the bucket again);
- **faults and latency** (``inject``, ``latency_s``): the next N calls of
  an op raise, so retry paths run without a network.

It is not a network server: calls are plain method calls, the surface
``core/store/objectstore.py::HttpS3Client`` offers for real endpoints.
"""

from __future__ import annotations

import functools
import os
import threading
import time
import urllib.parse


class S3NotFound(KeyError):
    """GET/DELETE of a key that does not exist (HTTP 404 analog)."""


class S3TransientError(ConnectionError):
    """Injected/transient failure (HTTP 500/503 analog) — retryable."""


@functools.lru_cache(maxsize=1 << 16)
def _quote_key(key: str) -> str:
    # object keys contain "/" — keep them as directories on disk so LIST
    # stays cheap, but escape anything else that the filesystem dislikes
    return "/".join(urllib.parse.quote(part, safe="")
                    for part in key.split("/"))


class FakeS3:
    """Thread-safe in-memory (or dir-backed) S3 subset.

    Buckets are implicit: the store holds one flat key space; callers
    prepend ``bucket/`` themselves (the object-store tier does).
    """

    def __init__(self, root: str | None = None, latency_s: float = 0.0):
        self.root = root
        self.latency_s = latency_s
        self._objects: dict[str, bytes] = {}
        self._mpu: dict[str, dict[int, bytes]] = {}
        self._mpu_seq = 0
        self._lock = threading.Lock()
        # op -> list of [remaining_count, exc_factory]
        self._faults: dict[str, list[list]] = {}
        self.op_counts: dict[str, int] = {}
        if root:
            os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- faults
    def inject(self, op: str, times: int = 1, exc=None) -> None:
        """Arm the next ``times`` calls of ``op`` (put/get/list/delete/
        multipart) to raise ``exc`` (default ``S3TransientError``)."""
        exc = exc or (lambda: S3TransientError(f"injected {op} fault"))
        if isinstance(exc, BaseException):
            e = exc
            exc = lambda: e  # noqa: E731
        elif isinstance(exc, type):
            cls = exc
            exc = lambda: cls(f"injected {op} fault")  # noqa: E731
        with self._lock:
            self._faults.setdefault(op, []).append([times, exc])

    def clear_faults(self) -> None:
        with self._lock:
            self._faults.clear()

    def _enter(self, op: str):
        if self.latency_s:
            time.sleep(self.latency_s)
        with self._lock:
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
            for f in self._faults.get(op, ()):
                if f[0] > 0:
                    f[0] -= 1
                    raise f[1]()

    # ------------------------------------------------------------ objects
    def _path(self, key: str) -> str:
        return os.path.join(self.root, _quote_key(key))

    def put_object(self, key: str, data: bytes) -> None:
        self._enter("put")
        if self.root:
            path = self._path(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp-%d" % threading.get_ident()
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        else:
            with self._lock:
                self._objects[key] = bytes(data)

    def get_object(self, key: str, start: int | None = None,
                   length: int | None = None) -> bytes:
        """GET, optionally with a byte range (offset + length)."""
        self._enter("get")
        if self.root:
            path = self._path(key)
            try:
                with open(path, "rb") as f:
                    if start:
                        f.seek(start)
                    return f.read(length) if length is not None else f.read()
            except FileNotFoundError:
                raise S3NotFound(key) from None
        with self._lock:
            try:
                data = self._objects[key]
            except KeyError:
                raise S3NotFound(key) from None
        if start is None:
            return data
        end = len(data) if length is None else start + length
        return data[start:end]

    def list_objects(self, prefix: str = "") -> list[str]:
        """All keys with the given prefix, sorted."""
        self._enter("list")
        if self.root:
            out = []
            for dirpath, _dirs, files in os.walk(self.root):
                for fn in files:
                    if fn.endswith(".tmp") or ".tmp-" in fn:
                        continue
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          self.root)
                    key = "/".join(urllib.parse.unquote(p)
                                   for p in rel.split(os.sep))
                    if key.startswith(prefix):
                        out.append(key)
            return sorted(out)
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete_object(self, key: str) -> None:
        """DELETE — idempotent, like S3 (deleting a missing key is OK)."""
        self._enter("delete")
        if self.root:
            try:
                os.remove(self._path(key))
            except FileNotFoundError:
                pass
            return
        with self._lock:
            self._objects.pop(key, None)

    # ---------------------------------------------------------- multipart
    def create_multipart(self, key: str) -> str:
        self._enter("multipart")
        with self._lock:
            self._mpu_seq += 1
            upload_id = f"mpu-{self._mpu_seq}"
            self._mpu[upload_id] = {}
        return upload_id

    def upload_part(self, key: str, upload_id: str, part_number: int,
                    data: bytes) -> None:
        self._enter("multipart")
        with self._lock:
            if upload_id not in self._mpu:
                raise S3NotFound(upload_id)
            self._mpu[upload_id][part_number] = bytes(data)

    def complete_multipart(self, key: str, upload_id: str) -> None:
        self._enter("multipart")
        with self._lock:
            parts = self._mpu.pop(upload_id, None)
        if parts is None:
            raise S3NotFound(upload_id)
        blob = b"".join(parts[n] for n in sorted(parts))
        # the final assembly is an ordinary PUT (counted as one)
        self.put_object(key, blob)

    def abort_multipart(self, key: str, upload_id: str) -> None:
        self._enter("multipart")
        with self._lock:
            self._mpu.pop(upload_id, None)

    # ------------------------------------------------------------ helpers
    def corrupt(self, key: str, offset: int = 0, xor: int = 0xFF) -> None:
        """Flip byte(s) in a stored object — the integrity-tripwire test
        hook.  XORs the byte at ``offset`` with ``xor``."""
        data = bytearray(self.get_object(key))
        data[offset] ^= xor
        if self.root:
            path = self._path(key)
            with open(path, "wb") as f:
                f.write(bytes(data))
        else:
            with self._lock:
                self._objects[key] = bytes(data)

    def total_bytes(self) -> int:
        if self.root:
            return sum(len(self.get_object(k)) for k in self.list_objects())
        with self._lock:
            return sum(len(v) for v in self._objects.values())
