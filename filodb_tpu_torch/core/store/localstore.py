"""Durable local column store and meta store over sqlite.

Copy of ``filodb_tpu/core/store/localstore.py``'s data model, file for
file: one database a shard, ``<root>/<dataset>/shard-<n>.db``, with the
tables ``chunks`` (partition, chunkid → start, end, serialized chunk),
``ingestion_time_index``, ``partkeys`` (partition → start, end),
``checkpoints`` (group → offset; the downsampler keeps its watermarks in
the same table of the dataset ``<dataset>__dsckpt``), and the ``upd``
write counter on chunks and part keys (the port indexes ``upd``: a
snapshot restore reads what was written after its token; the reference's
queries ignore the index); a shard's index snapshot is the file
``<root>/<dataset>/index-shard-<n>.snap``, and the cost model's learned
estimates ``<root>/<dataset>/costmodel.json``, each replaced atomically. A
partition is its part-key blob (``PartKey.serialized``). A directory
either package writes, the other reads.

A flush of a shard's group writes its chunks with one ``executemany`` in
one transaction; a query's page-in reads the chunks of many part keys in
one statement (``read_chunk_rows``).

A node reads a shard's database from many threads at once (the ingest
and job threads, the flush scheduler, the HTTP routes, page-ins), and a
sqlite connection is not safe to share: every use of a connection, reads
as well as writes, holds that connection's lock until its rows are
fetched (``_Db.use``; ROADMAP §C.14).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from contextlib import contextmanager

from filodb_tpu_torch.core.store.api import (
    ColumnStore,
    MetaStore,
    PartKeyRecord,
    pk_from_blob,
)

# part keys a page-in reads one by one; more, and it scans the table in
# its stored order and keeps theirs
_FEW_KEYS = 256


class _Db:
    """One sqlite database per (dataset, shard), opened on first use, with
    one lock a connection."""

    def __init__(self, root: str):
        self.root = root
        self._conns: dict[tuple[str, int], sqlite3.Connection] = {}
        self._locks: dict[tuple[str, int], threading.RLock] = {}
        self._lock = threading.Lock()

    @contextmanager
    def use(self, dataset: str, shard: int):
        """The shard's connection, held under its lock for the block: fetch
        every row inside it."""
        c = self.conn(dataset, shard)
        with self._locks[(dataset, shard)]:
            yield c

    def conn(self, dataset: str, shard: int) -> sqlite3.Connection:
        key = (dataset, shard)
        with self._lock:
            c = self._conns.get(key)
            if c is None:
                d = os.path.join(self.root, dataset)
                os.makedirs(d, exist_ok=True)
                c = sqlite3.connect(os.path.join(d, f"shard-{shard}.db"),
                                    check_same_thread=False)
                # the meta store and the column store hold separate
                # connections to one file: lock waits block and retry
                c.execute("PRAGMA busy_timeout=10000")
                c.execute("PRAGMA journal_mode=WAL")
                c.execute("PRAGMA synchronous=NORMAL")
                c.execute("""CREATE TABLE IF NOT EXISTS chunks (
                    partition BLOB, chunkid INTEGER, start_time INTEGER,
                    end_time INTEGER, data BLOB,
                    PRIMARY KEY (partition, chunkid))""")
                c.execute("""CREATE TABLE IF NOT EXISTS ingestion_time_index (
                    partition BLOB, ingestion_time INTEGER, chunkid INTEGER,
                    PRIMARY KEY (partition, ingestion_time, chunkid))""")
                c.execute("""CREATE TABLE IF NOT EXISTS partkeys (
                    partition BLOB PRIMARY KEY, start_time INTEGER,
                    end_time INTEGER)""")
                c.execute("""CREATE TABLE IF NOT EXISTS checkpoints (
                    grp INTEGER PRIMARY KEY, offset INTEGER)""")
                for tbl in ("chunks", "partkeys"):
                    try:
                        c.execute(f"ALTER TABLE {tbl} ADD COLUMN upd "
                                  "INTEGER DEFAULT 0")
                    except sqlite3.OperationalError:
                        pass  # column already present
                    # a snapshot restore reads the rows written after its
                    # token; without an index that is a scan of the table
                    c.execute(f"CREATE INDEX IF NOT EXISTS {tbl}_upd ON "
                              f"{tbl}(upd)")
                self._conns[key] = c
                self._locks[key] = threading.RLock()
            return c

    def close(self):
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()


class LocalDiskColumnStore(ColumnStore):
    def __init__(self, root: str):
        self.root = root
        self._db = _Db(root)
        self._upd: dict[tuple[str, int], int] = {}

    def initialize(self, dataset: str, num_shards: int) -> None:
        for s in range(num_shards):
            self._db.conn(dataset, s)

    def _upd_peek(self, c, dataset, shard) -> int:
        """The last write counter (caller holds the shard's connection),
        read from the database the first time."""
        key = (dataset, shard)
        cur = self._upd.get(key)
        if cur is None:
            cur = self._upd[key] = c.execute(
                "SELECT MAX(m) FROM (SELECT COALESCE(MAX(upd),0) m FROM "
                "chunks UNION ALL SELECT COALESCE(MAX(upd),0) FROM partkeys)"
            ).fetchone()[0] or 0
        return cur

    def _next_upd(self, c, dataset, shard) -> int:
        cur = self._upd[(dataset, shard)] = \
            self._upd_peek(c, dataset, shard) + 1
        return cur

    def write_chunk_rows(self, dataset, shard, rows, ingestion_time):
        with self._db.use(dataset, shard) as c:
            upd = self._next_upd(c, dataset, shard)
            with c:  # one transaction
                c.executemany(
                    "INSERT OR IGNORE INTO chunks(partition, chunkid, "
                    "start_time, end_time, data, upd) VALUES (?,?,?,?,?,?)",
                    ((b, cid, st, et, d, upd) for b, cid, st, et, d in rows))
                c.executemany(
                    "INSERT OR IGNORE INTO ingestion_time_index VALUES "
                    "(?,?,?)", ((r[0], ingestion_time, r[1]) for r in rows))

    def read_chunk_rows(self, dataset, shard, blobs, start_time, end_time):
        with self._db.use(dataset, shard) as c:
            if len(blobs) <= _FEW_KEYS:
                out = []
                for b in sorted(set(blobs)):
                    out.extend(c.execute(
                        "SELECT partition, data FROM chunks WHERE "
                        "partition=? AND end_time>=? AND start_time<=? "
                        "ORDER BY chunkid", (b, start_time, end_time)))
                return out
            want = set(blobs)
            return [r for r in c.execute(
                "SELECT partition, data FROM chunks WHERE end_time>=? AND "
                "start_time<=?", (start_time, end_time)) if r[0] in want]

    def write_part_keys(self, dataset, shard, records):
        with self._db.use(dataset, shard) as c:
            upd = self._next_upd(c, dataset, shard)
            with c:
                c.executemany(
                    "INSERT INTO partkeys(partition, start_time, end_time, "
                    "upd) VALUES (?,?,?,?) ON CONFLICT(partition)"
                    " DO UPDATE SET start_time=MIN(start_time, excluded."
                    "start_time), end_time=excluded.end_time, "
                    "upd=excluded.upd",
                    ((r.part_key.serialized, r.start_time, r.end_time, upd)
                     for r in records))

    def scan_part_keys(self, dataset, shard):
        with self._db.use(dataset, shard) as c:
            rows = c.execute("SELECT partition, start_time, end_time FROM "
                             "partkeys ORDER BY rowid").fetchall()
        return [PartKeyRecord(pk_from_blob(b), st, et) for b, st, et in rows]

    def scan_chunk_rows_by_ingestion_time(self, dataset, shard, start, end):
        # the reference's scan: the partitions indexed in the window, then
        # each one's chunks of it by chunk id
        with self._db.use(dataset, shard) as c:
            return c.execute(
            "SELECT c.partition, c.data FROM chunks c JOIN (SELECT DISTINCT "
            "partition, chunkid FROM ingestion_time_index WHERE "
            "ingestion_time>=? AND ingestion_time<?) i ON c.partition="
            "i.partition AND c.chunkid=i.chunkid ORDER BY c.partition, "
            "c.chunkid", (start, end)).fetchall()

    def delete_part_keys(self, dataset, shard, part_keys):
        with self._db.use(dataset, shard) as c, c:
            for pk in part_keys:
                blob = pk.serialized
                c.execute("DELETE FROM partkeys WHERE partition=?", (blob,))
                c.execute("DELETE FROM chunks WHERE partition=?", (blob,))
                c.execute("DELETE FROM ingestion_time_index WHERE "
                          "partition=?", (blob,))

    def max_persisted_ts(self, dataset, shard):
        with self._db.use(dataset, shard) as c:
            return dict(c.execute("SELECT partition, MAX(end_time) FROM "
                                  "chunks GROUP BY partition").fetchall())

    def max_persisted_ts_since(self, dataset, shard, chunk_token):
        # by the upd index: sqlite would otherwise walk every chunk through
        # the primary key to group by partition
        with self._db.use(dataset, shard) as c:
            return dict(c.execute(
                "SELECT partition, MAX(end_time) FROM chunks INDEXED BY "
                "chunks_upd WHERE upd > ? GROUP BY partition",
                (chunk_token,)).fetchall())

    def scan_part_keys_since(self, dataset, shard, pk_token):
        with self._db.use(dataset, shard) as c:
            rows = c.execute("SELECT partition, start_time, end_time FROM "
                             "partkeys WHERE upd > ? ORDER BY rowid",
                             (pk_token,)).fetchall()
        return [PartKeyRecord(pk_from_blob(b), st, et) for b, st, et in rows]

    def update_tokens(self, dataset, shard):
        with self._db.use(dataset, shard) as c:
            cur = self._upd_peek(c, dataset, shard)
        return (cur, cur)

    def _snapshot_path(self, dataset, shard) -> str:
        return os.path.join(self.root, dataset, f"index-shard-{shard}.snap")

    def write_index_snapshot(self, dataset, shard, data):
        path = self._snapshot_path(dataset, shard)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        os.replace(path + ".tmp", path)  # readers never see a partial file

    def read_index_snapshot(self, dataset, shard):
        try:
            with open(self._snapshot_path(dataset, shard), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def close(self):
        self._db.close()


class LocalDiskMetaStore(MetaStore):
    def __init__(self, root: str):
        self._db = _Db(root)

    def write_checkpoint(self, dataset, shard, group, offset):
        with self._db.use(dataset, shard) as c, c:
            c.execute("INSERT INTO checkpoints VALUES (?,?) ON CONFLICT(grp) "
                      "DO UPDATE SET offset=excluded.offset", (group, offset))

    def read_checkpoints(self, dataset, shard):
        with self._db.use(dataset, shard) as c:
            return dict(c.execute("SELECT grp, offset FROM checkpoints")
                        .fetchall())

    # the cost model's snapshot, ``<root>/<dataset>/costmodel.json``,
    # replaced atomically (``query/cost_model.py``)
    def write_cost_model(self, dataset: str, data: bytes) -> None:
        d = os.path.join(self._db.root, dataset)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "costmodel.json")
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        os.replace(path + ".tmp", path)

    def read_cost_model(self, dataset: str) -> bytes | None:
        try:
            with open(os.path.join(self._db.root, dataset,
                                   "costmodel.json"), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def close(self):
        self._db.close()
