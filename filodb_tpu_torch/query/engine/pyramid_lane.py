"""The pyramid lane: cold-tier leaves folded from the object store's stored
aggregates, with chunk payloads paged only at the windows' edges.

Port of ``filodb_tpu/query/engine/pyramid_lane.py``. The sidecar lane
(``sidecar_lane.py``) folds warm partitions from their chunk summaries;
this is its cold-tier twin, entered from it for a leaf over a cold-tier
shard (``query/federation.py::ColdTierStore``) whose store publishes
pyramids (``core/store/pyramid.py``). Each partition's history is a list
of summary nodes, built from the store's index of the part key
(``pyramid_refs``) and its pyramid objects:

    bucket node    one row over a whole compacted bucket
    segment node   one row a segment; its children the chunk rows
    chunk node     a chunk's row from a segment pyramid (no payload)
    decode node    the payload paged and its summary read: where no
                   pyramid covers the chunk (a read race, a legacy
                   segment)

and every window folds top-down: the nodes wholly inside it fold from
their rows, and the (at most two) nodes at its edges descend a level,
bucket to segments to chunks, down to one paged edge chunk. A window
aligned with chunk seams pages no payload at all
(``filodb_objectstore_payload_bytes_down`` does not move).

What cannot stay exact demotes a level, down to the decode lane
(``_Bypass``): a missing pyramid, partial summaries, disordered spans.
Mode ``1`` (stored rows) and mode ``decode`` (every row made again from
the paged payload, the same tree) are bitwise equal, since both fold
with ``pyramid.merge_rows_seq`` in chunk-id order and the codecs are
lossless.

The port's idiom: the tree of each partition is built on the host, as
the reference builds it; the fold is one pass a tree level over every
(partition, window) pair of the leaf on the device (the sidecar lane's
``interior_pairs``: prefix sums over the node rows), and the edge chunks
are paged into the shard's ODP cache (one store read a chunk, as the
reference's ``_page_chunk``), decoded from their device pages by B1/B2
and folded by ``fold_rows``, as the sidecar lane folds its edges. So an
edge chunk whose values float32 does not hold bypasses to the decode
lane (its host-decode lane reads them in float64).

``quantile_over_time`` is served from the nodes' log2 sketches under
``FILODB_SIDECAR_APPROX=1`` only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from filodb_tpu_torch.core.record import SCHEMA_NAMES
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.core.store import pyramid as pyr
from filodb_tpu_torch.memory.chunk import (
    S_COUNT,
    S_FIRST_TS,
    S_LAST_TS,
    SKETCH_BUCKETS,
    STATS_WIDTH,
    ChunkBytes,
    decode_chunks,
    sketch_values,
    summarize,
)
from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.query.engine import sidecar_lane as sl
from filodb_tpu_torch.utils.tracing import span

_LEVELS = ("bucket", "segment", "chunk", "decode")


class _Node:
    """One summary node of a partition's cold history."""

    __slots__ = ("level", "pid", "row", "start", "end", "children", "ref",
                 "row_at", "sketch", "n_chunks", "seq")

    def __init__(self, level, pid, row, children=None, ref=None, row_at=-1,
                 sketch=None, n_chunks=1):
        self.level = level          # bucket | segment | chunk | decode
        self.pid = pid              # its partition
        self.row = row              # stats [12] float64, count > 0
        self.start = int(row[S_FIRST_TS])
        self.end = int(row[S_LAST_TS])
        self.children = children    # the level below (None for leaves)
        self.ref = ref              # the chunk's ref (leaves)
        self.row_at = row_at        # its row in the ODP table, once paged
        self.sketch = sketch        # int64 log2 sketch or None
        self.n_chunks = n_chunks    # chunks the node covers
        self.seq = None             # a segment node's seq


class _Pager:
    """Pages single chunks of a cold shard into its ODP cache (the scalar
    table), one ranged GET a chunk (``read_chunks_by_id``), as the
    reference's ``_page_chunk`` reads one; a chunk the cache holds
    already is not read again."""

    def __init__(self, shard, acc: dict):
        self.shard = shard
        self.cache = shard.odp_cache
        self.table = self.cache.tables[False]
        self.acc = acc
        col = self.table.columns
        live = np.flatnonzero(~col["dead"])
        self.at = dict(zip(zip(col["pid"][live].tolist(),
                               col["cid"][live].tolist()), live.tolist()))

    def rows(self, pid: int, refs) -> list[int]:
        """The table rows of chunks ``refs`` of partition ``pid``."""
        return self.rows_many([(pid, r) for r in refs])

    def rows_many(self, wanted) -> list[int]:
        """The table rows of chunks ``wanted`` ((pid, ref) pairs), the
        missing ones paged in one batch."""
        missing = [(p, r) for p, r in wanted if (p, r.chunk_id) not in self.at]
        if missing:
            self._page(missing)
        # chunk ids, as the reference counts its decode nodes
        self.acc.setdefault("_decoded_ids", set()).update(
            r.chunk_id for _, r in wanted)
        return [self.at[(p, r.chunk_id)] for p, r in wanted]

    def _page(self, wanted) -> None:
        sh = self.shard
        pids, refs, seen = [], [], set()
        for pid, ref in wanted:
            if (pid, ref.chunk_id) not in seen:
                seen.add((pid, ref.chunk_id))
                pids.append(pid)
                refs.append(ref)
        t = time.perf_counter()
        datas = sh.column_store.read_chunks_by_id(
            sh.dataset, sh.shard_num,
            [(sh.keys[p].serialized, r.chunk_id) for p, r in zip(pids, refs)])
        if any(d is None for d in datas):
            raise sl._Bypass("a chunk the store no longer holds")
        self.cache.seconds["read"] += time.perf_counter() - t
        self.cache.bytes_read += sum(len(d) for d in datas)
        n0 = len(self.table.columns["dead"])
        self.cache._add(sh, np.asarray(pids, np.int64),
                        ChunkBytes.from_blobs(datas))
        sh.version += 1
        col = self.table.columns
        for i in range(n0, len(col["dead"])):
            self.at[(int(col["pid"][i]), int(col["cid"][i]))] = i

    def summaries(self, rows: list[int], decode_mode: bool):
        """(stats [n, 12], sketch uint16 [n, 64]) of table rows ``rows``:
        their stored summaries, or in decode mode made again from their
        codec chunks (bitwise the same)."""
        idx = np.asarray(rows, np.int64)
        col = self.table.columns
        if not decode_mode:
            return col["stats_value"][idx], col["sketch_value"][idx]
        groups, lost = self.shard.codec_chunks(self.table, idx)
        if len(lost):
            raise sl._Bypass("a flushed chunk the store no longer holds")
        stats = np.zeros((len(idx), STATS_WIDTH))
        sketch = np.zeros((len(idx), SKETCH_BUCKETS), np.uint16)
        for pos, cb in groups:
            d = decode_chunks(cb, SCHEMAS["gauge"])
            stats[pos], sketch[pos] = summarize(d.ts, d.dcols[:, 0], d.rows)
        return stats, sketch


# ---------------------------------------------------------------------------
# the tree of one partition (the reference's construction)

def _decode_nodes(pid, refs, pager, decode_mode) -> list[_Node]:
    """Payload fallback leaves: each chunk paged and its summary read."""
    if not refs:
        return []
    rows = pager.rows(pid, refs)
    stats, sketch = pager.summaries(rows, decode_mode)
    return [_Node("decode", pid, stats[i], ref=ref, row_at=rows[i],
                  sketch=sketch[i].astype(np.int64))
            for i, ref in enumerate(refs) if stats[i][S_COUNT] > 0]


def _entry_chunk_nodes(entry, idxs, rr, pid, pager,
                       decode_mode) -> list[_Node]:
    """Chunk nodes from a segment pyramid's rows: no payload in mode 1;
    decode mode pages each chunk and makes its row again."""
    if decode_mode:
        at = pager.rows(pid, list(rr))
        stats, _ = pager.summaries(at, True)
        rows = list(zip(stats, at))
    else:
        rows = [(entry["rows"][i], -1) for i in idxs]
    return [_Node("chunk", pid, row, ref=ref, row_at=a)
            for (row, a), ref in zip(rows, rr) if row[S_COUNT] > 0]


def _seg_node(entry, rr, pid, pager, decode_mode) -> list[_Node]:
    """A segment node whose children are the entry's chunk rows; decode
    mode folds both levels again as the writer did."""
    children = _entry_chunk_nodes(entry, range(len(rr)), rr, pid, pager,
                                  decode_mode)
    row = pyr.merge_rows_seq([c.row for c in children]) if decode_mode \
        else entry["row"]
    if row is None or row[S_COUNT] <= 0:
        return []
    return [_Node("segment", pid, row, children=children,
                  sketch=entry.get("sketch"), n_chunks=len(children))]


def _run_nodes(blob, col, seq, rr, single_run, cache, seg_set, pid, pager,
               decode_mode) -> list[_Node]:
    """Nodes of one chunk-id-contiguous run of refs in segment ``seq``,
    demoted a level where its pyramid does not cover the run."""
    if seq in seg_set:
        sp = cache.segment(seq)
        entry = sp["entries"].get((blob, col)) if sp is not None else None
        if entry is not None:
            ecids = entry["cids"]
            rcids = np.array([r.chunk_id for r in rr], np.int64)
            if single_run and np.array_equal(ecids, rcids):
                return _seg_node(entry, rr, pid, pager, decode_mode)
            # an interleaved or partial run: the segment's row does not
            # serve, its chunk rows do
            idx = {int(c): i for i, c in enumerate(ecids)}
            out = []
            for ref in rr:
                i = idx.get(ref.chunk_id)
                out.extend(
                    _decode_nodes(pid, [ref], pager, decode_mode) if i is None
                    else _entry_chunk_nodes(entry, [i], [ref], pid, pager,
                                            decode_mode))
            return out
    pyr.PYR_FALLBACK.inc()
    return _decode_nodes(pid, rr, pager, decode_mode)


def _wrap_bucket(nodes, blob, col, bucket_info, cache,
                 decode_mode) -> list[_Node]:
    """The run of segment nodes the bucket pyramid covers, as one bucket
    node (its children those segment nodes)."""
    bp = cache.bucket(int(bucket_info["bucket"]), int(bucket_info["seq"]))
    entry = bp["entries"].get((blob, col)) if bp is not None else None
    if entry is None:
        return nodes
    covers = list(bp["covers"])
    run = [i for i, n in enumerate(nodes)
           if n.level == "segment" and n.seq in covers]
    if not run or run != list(range(run[0], run[-1] + 1)):
        return nodes
    segs = [nodes[i] for i in run]
    if sorted(s.seq for s in segs) != sorted(covers):
        return nodes
    child_cids = np.array([c.ref.chunk_id for s in segs for c in s.children],
                          np.int64)
    if len(child_cids) != len(entry["cids"]) \
            or not np.array_equal(np.sort(child_cids),
                                  np.sort(entry["cids"])):
        return nodes
    row = pyr.merge_rows_seq([s.row for s in segs]) if decode_mode \
        else entry["row"]
    if row is None or row[S_COUNT] <= 0:
        return nodes
    bnode = _Node("bucket", segs[0].pid, row, children=segs,
                  sketch=entry.get("sketch"),
                  n_chunks=sum(s.n_chunks for s in segs))
    return nodes[:run[0]] + [bnode] + nodes[run[-1] + 1:]


def _disordered(nodes) -> bool:
    if len(nodes) < 2:
        return False
    starts = np.array([n.start for n in nodes], np.int64)
    ends = np.array([n.end for n in nodes], np.int64)
    return bool(np.any(np.diff(starts) <= 0) or np.any(starts[1:] <= ends[:-1]))


def _partition_nodes(shard, pid, col, pager, decode_mode) -> list[_Node]:
    cache = shard.pyramids
    blob = shard.keys[pid].serialized
    refs, seg_set, bucket_info = cache.refs(blob)
    if not refs:
        return []
    runs: list[tuple[int, list]] = []
    for r in refs:
        if runs and runs[-1][0] == r.seq:
            runs[-1][1].append(r)
        else:
            runs.append((r.seq, [r]))
    run_count: dict[int, int] = {}
    for seq, _ in runs:
        run_count[seq] = run_count.get(seq, 0) + 1
    nodes: list[_Node] = []
    for seq, rr in runs:
        new = _run_nodes(blob, col, seq, rr, run_count[seq] == 1, cache,
                         seg_set, pid, pager, decode_mode)
        for n in new:
            if n.level == "segment":
                n.seq = seq
        nodes.extend(new)
    if bucket_info is not None:
        nodes = _wrap_bucket(nodes, blob, col, bucket_info, cache,
                             decode_mode)
    # the fold's exactness: valid spans ordered and apart across the list
    if _disordered(nodes):
        pyr.PYR_FALLBACK.inc()
        nodes = _decode_nodes(pid, refs, pager, decode_mode)
        if _disordered(nodes):
            raise sl._Bypass("chunks out of time order")
    return nodes


# ---------------------------------------------------------------------------
# the fold, a tree level at a time over every (partition, window) pair

class _Flat:
    """The nodes of the trees in groups: group ``g`` is one node list (a
    partition's top level, or a node's children), its nodes contiguous;
    their spans, rows and levels as arrays (``arrays``)."""

    def __init__(self):
        self.nodes: list[_Node] = []
        self.lo: list[int] = []
        self.hi: list[int] = []
        self.child_group: dict[int, int] = {}
        self._arrays = None

    def add_group(self, nodes) -> int:
        self.lo.append(len(self.nodes))
        self.nodes.extend(nodes)
        self.hi.append(len(self.nodes))
        self._arrays = None
        return len(self.lo) - 1

    def children_of(self, n: int) -> int:
        g = self.child_group.get(n)
        if g is None:
            g = self.child_group[n] = self.add_group(
                self.nodes[n].children)
        return g

    def arrays(self) -> dict:
        """starts, ends, rows [N, 12], level codes, chunks covered and
        whether a node has children, of every node so far."""
        a = self._arrays
        n0 = 0 if a is None else len(a["starts"])
        if n0 < len(self.nodes):
            new = self.nodes[n0:]
            add = {"starts": np.array([n.start for n in new], np.int64),
                   "ends": np.array([n.end for n in new], np.int64),
                   "rows": np.stack([n.row for n in new]).astype(
                       np.float64),
                   "level": np.array([_LEVELS.index(n.level) for n in new],
                                     np.int64),
                   "n_chunks": np.array([n.n_chunks for n in new],
                                        np.int64),
                   "inner": np.array([n.children is not None for n in new],
                                     bool)}
            a = add if a is None else {k: np.concatenate([a[k], add[k]])
                                       for k in a}
            self._arrays = a
        return self._arrays if self._arrays is not None else {
            "starts": np.zeros(0, np.int64), "ends": np.zeros(0, np.int64),
            "rows": np.zeros((0, STATS_WIDTH)),
            "level": np.zeros(0, np.int64),
            "n_chunks": np.zeros(0, np.int64), "inner": np.zeros(0, bool)}


def _fold_trees(trees, t0s, t1s, shard, pager, base, dev,
                acc) -> torch.Tensor:
    """Merged stats [P, W, 12] of every partition's tree over windows
    (t0s, t1s]: interior nodes from their rows, edge nodes descended, edge
    chunks decoded on the device."""
    P, W = len(trees), len(t0s)
    flat = _Flat()
    for t in trees:
        flat.add_group(t)
    # round 0: a call a partition over every window
    grp = np.repeat(np.arange(P, dtype=np.int64), W)
    t0 = np.tile(np.asarray(t0s, np.int64), P)
    t1 = np.tile(np.asarray(t1s, np.int64), P)
    call = grp.copy()
    rounds = []
    leaves = []  # per round: (pair, side, node, t0, t1) arrays
    while len(grp):
        inter, edges = _fold_round(flat, grp, t0, t1, call, dev, acc)
        inner = flat.arrays()["inner"]
        nxt, lv = [], []
        for side, edge in enumerate(edges):
            at = np.flatnonzero(edge >= 0)
            n = edge[at]
            deep = inner[n]
            lv.append((at[~deep], np.full(int((~deep).sum()), side),
                       n[~deep]))
            nxt.append((at[deep], np.full(int(deep.sum()), side), n[deep]))
        pair = np.concatenate([x[0] for x in lv])
        leaves.append((pair, np.concatenate([x[1] for x in lv]),
                       np.concatenate([x[2] for x in lv]), t0[pair],
                       t1[pair]))
        parent = np.concatenate([x[0] for x in nxt])
        side = np.concatenate([x[1] for x in nxt])
        node = np.concatenate([x[2] for x in nxt])
        rounds.append((inter, parent, side))
        # the next level's calls: one a (call, side, edge node), the
        # reference's ``_edge_node_stats`` recursing into that node
        if len(parent):
            n_nodes = np.int64(len(flat.nodes))
            key = (call[parent] * 2 + side) * n_nodes + node
            call = np.unique(key, return_inverse=True)[1].reshape(-1)
            uniq, at = np.unique(node, return_inverse=True)
            groups = np.array([flat.children_of(int(u))
                               for u in uniq.tolist()], np.int64)
            grp = groups[at.reshape(-1)]
        else:
            call = grp = np.zeros(0, np.int64)
        t0, t1 = t0[parent], t1[parent]
    leaf = _edge_chunks(flat, leaves, shard, pager, base, dev)
    # merge bottom-up: a pair's result is its left edge's, its interior,
    # then its right edge's
    below = None
    for r in range(len(rounds) - 1, -1, -1):
        inter, parent, side = rounds[r]
        N = inter.shape[0]
        edges = [sl._empty_stats(N, dev), sl._empty_stats(N, dev)]
        if below is not None and len(parent):
            for s in (0, 1):
                m = np.flatnonzero(side == s)
                if len(m):
                    edges[s][torch.from_numpy(parent[m]).to(dev)] = \
                        below[torch.from_numpy(m).to(dev)]
        pair, lside = leaves[r][0], leaves[r][1]
        for s in (0, 1):
            m = np.flatnonzero(lside == s)
            if len(m):
                edges[s][torch.from_numpy(pair[m]).to(dev)] = \
                    leaf[r][torch.from_numpy(m).to(dev)]
        below = sl.merge(sl.merge(edges[0], inter), edges[1])
    return below.reshape(P, W, STATS_WIDTH)


def _fold_round(flat: _Flat, grp, t0, t1, call, dev, acc):
    """One tree level: the interior fold of every pair, the level counts
    of the nodes each call folded (the union over its windows, as the
    reference counts a ``_fold_nodes`` call), and each pair's left and
    right edge nodes (flat indices, -1 for none)."""
    arr = flat.arrays()
    groups, lg = np.unique(grp, return_inverse=True)
    lg = lg.reshape(-1)
    lo = np.asarray(flat.lo, np.int64)[groups]
    sizes = np.asarray(flat.hi, np.int64)[groups] - lo
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    gnode = np.repeat(lo - offs[:-1], sizes) + np.arange(int(offs[-1]))
    part = np.repeat(np.arange(len(groups), dtype=np.int64), sizes)
    st = torch.from_numpy(np.ascontiguousarray(arr["rows"][gnode])).to(dev)
    inter, i0, i1, o0, o1 = sl.interior_pairs(
        st, part, arr["starts"][gnode], arr["ends"][gnode], offs, lg, t0,
        t1, dev)
    # the union over each call's windows of its interior nodes
    gsize = sizes[lg]
    ncall = int(call.max()) + 1 if len(call) else 0
    csize = np.zeros(ncall, np.int64)
    csize[call] = gsize
    cgrp = np.zeros(ncall, np.int64)
    cgrp[call] = lg
    cbase = np.concatenate([[0], np.cumsum(csize)]).astype(np.int64)
    diff = np.zeros(int(cbase[-1]) + 1, np.int64)
    np.add.at(diff, cbase[call] + i0, 1)
    np.add.at(diff, cbase[call] + i1, -1)
    covered = np.flatnonzero(np.cumsum(diff[:-1]) > 0)
    if len(covered):
        ccall = np.searchsorted(cbase, covered, side="right") - 1
        node = gnode[offs[cgrp[ccall]] + covered - cbase[ccall]]
        level = arr["level"][node]
        for code, name in enumerate(_LEVELS[:3]):
            k = int((level == code).sum())
            if k:
                acc["nodes_" + name] = acc.get("nodes_" + name, 0) + k
        acc["sidecar_chunks"] = acc.get("sidecar_chunks", 0) + int(
            arr["n_chunks"][node][level < 3].sum())
    first = offs[lg]
    left = np.where(o0 < i0, o0, -1)
    re = o1 - 1
    right = np.where((re >= i1) & (re >= 0) & (re < gsize) & (re != left),
                     re, -1)
    edges = [np.where(e >= 0, gnode[np.clip(first + e, 0, max(len(gnode)
                                                             - 1, 0))], -1)
             if len(gnode) else np.full(len(e), -1, np.int64)
             for e in (left, right)]
    return inter, edges


def _edge_chunks(flat: _Flat, leaves, shard, pager, base, dev) -> list:
    """A round's stats [n, 12] of each leaf request's chunk over its
    window: the chunks paged where they are not yet (in one batch), then
    decoded from their pages by B1/B2 and folded on the device."""
    nodes = np.unique(np.concatenate([lv[2] for lv in leaves]
                                     + [np.zeros(0, np.int64)]))
    if not len(nodes):
        return [sl._empty_stats(0, dev) for _ in leaves]
    objs = [flat.nodes[n] for n in nodes.tolist()]
    need = [o for o in objs if o.row_at < 0]
    if need:
        rows = pager.rows_many([(o.pid, o.ref) for o in need])
        for o, r in zip(need, rows):
            o.row_at = r
    pager.acc.setdefault("_decoded_ids", set()).update(
        o.ref.chunk_id for o in objs)
    row_of = np.array([o.row_at for o in objs], np.int64)
    uniq, inv = np.unique(row_of, return_inverse=True)
    sl._decodable(shard, uniq, pager.table)
    segs = sl._Segments(shard, uniq, base, dev, table=pager.table)
    inv = inv.reshape(-1)
    return [segs.fold(inv[np.searchsorted(nodes, node)], t0, t1)
            for _, _, node, t0, t1 in leaves]


# ---------------------------------------------------------------------------
# the approximate quantile over node sketches

def _leaves(n: _Node):
    if n.children is None:
        yield n
    else:
        for c in n.children:
            yield from _leaves(c)


def _quantile(ctx, shard, spids, trees, q, t0s, t1s, pager, base, dev,
              acc) -> torch.Tensor:
    P, W = len(spids), len(t0s)
    gate = sl._sealed_gate()
    static_serve = not (gate > 0 and P * W > gate)
    model = cm.model_for(ctx.dataset)
    d = model.decide("pyramid", f"quantile:pw{cm.bucket(P * W)}",
                     ("pyramid", "decode"),
                     static_arm="pyramid" if static_serve else "decode",
                     override="pyramid" if gate <= 0 else None)
    model.defer(ctx, d)
    if d.arm != "pyramid":
        raise sl._Bypass("static gate")
    out = np.full((P, W), np.nan)
    samples = 0
    for i, (pid, nodes) in enumerate(zip(spids.tolist(), trees)):
        if not nodes:
            continue
        starts = np.array([n.start for n in nodes], np.int64)
        ends = np.array([n.end for n in nodes], np.int64)
        i0 = np.searchsorted(starts, t0s, side="right")
        i1 = np.maximum(np.searchsorted(ends, t1s, side="right"), i0)
        # the chunks at the windows' edges, decoded from their pages
        edge = [leaf for k in range(W) for c in range(len(nodes))
                if not i0[k] <= c < i1[k] and nodes[c].end > t0s[k]
                and nodes[c].start <= t1s[k] for leaf in _leaves(nodes[c])]
        vals = {}
        if edge:
            rows = pager.rows(pid, [leaf.ref for leaf in edge])
            for leaf, r in zip(edge, rows):
                leaf.row_at = r
            uniq = np.unique(rows)
            sl._decodable(shard, uniq, pager.table)
            ts, vv, ok = sl._Segments(shard, uniq, base, dev,
                                      table=pager.table).host_rows()
            vals = {int(r): (ts[j][ok[j]], vv[j][ok[j]])
                    for j, r in enumerate(uniq.tolist())}
        for k in range(W):
            sk = np.zeros(SKETCH_BUCKETS, np.int64)
            total = 0
            for c in range(i0[k], i1[k]):
                sk += _node_sketch(nodes[c], pid, pager)
                total += int(nodes[c].row[S_COUNT])
            for c in list(range(min(i0[k], len(nodes)))) \
                    + list(range(i1[k], len(nodes))):
                n = nodes[c]
                if not (n.end > t0s[k] and n.start <= t1s[k]):
                    continue
                for leaf in _leaves(n):
                    if leaf.end <= t0s[k] or leaf.start > t1s[k]:
                        continue
                    tv, v = vals[leaf.row_at]
                    m = (tv > t0s[k]) & (tv <= t1s[k])
                    sk += sketch_values(v[m]).astype(np.int64)
                    total += int(m.sum())
            if total:
                out[i, k] = sl.sketch_quantile(q, sk)
            samples += total
    acc["samples"] = acc.get("samples", 0.0) + float(samples)
    return torch.from_numpy(out).to(dev)


def _node_sketch(n: _Node, pid, pager) -> np.ndarray:
    """The log2 sketch of all a node's samples, paging the chunk only for a
    chunk node without one."""
    if n.sketch is None:
        n.row_at = pager.rows(pid, [n.ref])[0]
        _, sk = pager.summaries([n.row_at], False)
        n.sketch = sk[0].astype(np.int64)
    return n.sketch


# ---------------------------------------------------------------------------
# the entry point (the sidecar lane's, for a cold-tier leaf)

def execute_cold(leaf, ctx, shard, pids, psm, fn, decode_mode: bool):
    """The leaf's windowing stage served from the cold shard's pyramids:
    a ``StepMatrix``. Raises ``_Bypass`` (the sidecar lane counts it and
    the decode lane serves) where the store publishes no pyramids or
    exactness cannot be kept. The caller holds the shard's lock."""
    from filodb_tpu_torch.core.store.objectstore import PAYLOAD_BYTES_DOWN
    from filodb_tpu_torch.query.exec.plan import _by_schema
    from filodb_tpu_torch.query.exec.transformers import steps_array
    from filodb_tpu_torch.query.model import StepMatrix

    cache = getattr(shard, "pyramids", None)
    if cache is None:
        raise sl._Bypass("cold partitions")
    if leaf.value_column not in (None, "value"):
        raise sl._Bypass("a column other than the value")
    # folding stored roll-ups is the static arm (it pages no payload);
    # once settled times show decoding cheaper for this class of leaf, the
    # model routes around it
    model = cm.model_for(ctx.dataset)
    d = model.decide("pyramid", f"cold:parts{cm.bucket(len(pids))}",
                     ("pyramid", "decode"), static_arm="pyramid")
    model.defer(ctx, d)
    if d.arm == "decode":
        raise sl._Bypass("cost model")
    steps = steps_array(psm.start, psm.step, psm.end)
    eval_steps = (steps - psm.offset).astype(np.int64)
    window = int(psm.span)
    t1s = np.minimum(eval_steps, int(leaf.chunk_end))
    t0s = np.maximum(eval_steps - window, int(leaf.chunk_start) - 1)
    dev = ctx.device
    acc: dict = {}
    pager = _Pager(shard, acc)
    pyr_b0 = pyr.PYR_BYTES_DOWN.value
    pay_b0 = PAYLOAD_BYTES_DOWN.value
    hits0, miss0 = cache.hits, cache.misses
    mats = []
    groups = _by_schema(shard, pids)
    for s, _ in groups:
        sch = SCHEMAS[SCHEMA_NAMES[s]]
        if sch.is_histogram:
            raise sl._Bypass("histogram columns")
        if sch.is_multi:
            raise sl._Bypass("rollup columns")
    for s, spids in groups:
        sch = SCHEMAS[SCHEMA_NAMES[s]]
        col = sch.data.value_column
        with span("decode", schema=sch.name, partitions=len(spids),
                  pyramid=True):
            trees = [_partition_nodes(shard, pid, col, pager, decode_mode)
                     for pid in spids.tolist()]
            if fn == "quantile_over_time":
                out = _quantile(ctx, shard, spids, trees,
                                float(psm.params[0]), t0s, t1s, pager,
                                leaf.chunk_start, dev, acc)
            else:
                st = _fold_trees(trees, t0s, t1s, shard, pager,
                                 leaf.chunk_start, dev, acc)
                acc["samples"] = acc.get("samples", 0.0) \
                    + float(st[..., S_COUNT].sum())
                out = sl.formula(fn, st, torch.from_numpy(
                    eval_steps.astype(np.float64)).to(dev), window,
                    sch.is_counter)
        keys = [shard.keys[p].range_vector_key for p in spids.tolist()]
        out_keys = keys if psm.function is None \
            else [k.drop_metric() for k in keys]
        mats.append(StepMatrix(out_keys, out, steps,
                               dropped_keys=[k.drop_metric() for k in keys]))
    data = StepMatrix.concat(mats) if len(mats) > 1 else mats[0]
    decoded = len(acc.get("_decoded_ids", ()))
    nb = acc.get("nodes_bucket", 0)
    ns = acc.get("nodes_segment", 0)
    nc = acc.get("nodes_chunk", 0)
    ctx.stats.samples_scanned += int(acc.get("samples", 0.0))
    ctx.stats.sidecar_chunks += acc.get("sidecar_chunks", 0)
    ctx.stats.chunks_touched += decoded + acc.get("sidecar_chunks", 0)
    # the pyramid cache is this lane's read cache
    ctx.stats.cache_hits += cache.hits - hits0
    ctx.stats.cache_misses += cache.misses - miss0
    for key, v in (("bucketNodes", nb), ("segmentNodes", ns),
                   ("chunkNodes", nc), ("decodeNodes", decoded),
                   ("pyramidBytes", max(0, pyr.PYR_BYTES_DOWN.value - pyr_b0)),
                   ("payloadBytes",
                    max(0, PAYLOAD_BYTES_DOWN.value - pay_b0))):
        ctx.stats.pyramid[key] = ctx.stats.pyramid.get(key, 0) + v
    pyr.PYR_NODES_BUCKET.inc(nb)
    pyr.PYR_NODES_SEGMENT.inc(ns)
    pyr.PYR_NODES_CHUNK.inc(nc)
    pyr.PYR_NODES_DECODE.inc(decoded)
    pyr.PYR_SERVED.inc()
    sl.SIDECAR_SERVED.inc()
    return data
