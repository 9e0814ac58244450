"""Series cardinality of one shard along its shard-key path.

Copy of ``filodb_tpu/core/memstore/cardinality.py``'s tracker: a tree over
``_ws_`` → ``_ns_`` → ``_metric_`` counting active and total series at
each node. The index snapshot carries its state (``to_state`` /
``load_state``, the reference's JSON tree), so a restored shard keeps its
counts. The port counts series in bulk (``series_created_many``: one walk
a distinct shard-key path, in order of first appearance, which gives the
tree the reference's one-at-a-time ``series_created`` builds). Quotas come
from the governor's ``tenants`` block (``governor.apply_tenant_quotas``):
once one is finite, a shard creates series one at a time through
``series_created``, which raises ``QuotaExceededError`` at a prefix that is
at its quota, as the reference's tracker does.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

UNLIMITED = 2**62


@dataclass
class Cardinality:
    name: str
    active_ts: int = 0
    total_ts: int = 0
    children: int = 0
    quota: int = UNLIMITED


class QuotaExceededError(Exception):
    def __init__(self, prefix, quota):
        super().__init__(f"cardinality quota exceeded at {prefix}: {quota}")
        self.prefix = prefix
        self.quota = quota


@dataclass
class _Node:
    card: Cardinality
    children: dict[str, "_Node"] = field(default_factory=dict)


class CardinalityTracker:
    def __init__(self, shard: int,
                 shard_key_labels=("_ws_", "_ns_", "_metric_")):
        self.shard = shard
        self.shard_key_labels = shard_key_labels
        self._root = _Node(Cardinality("__root__"))
        self.has_quotas = False  # a finite quota is set somewhere

    def _path(self, labels: dict[str, str]) -> tuple[str, ...]:
        return tuple(labels.get(k, "") for k in self.shard_key_labels)

    def _walk(self, path, create: bool = False) -> list[_Node]:
        nodes = [self._root]
        cur = self._root
        for part in path:
            nxt = cur.children.get(part)
            if nxt is None:
                if not create:
                    return nodes
                nxt = cur.children[part] = _Node(Cardinality(part))
                cur.card.children += 1
            nodes.append(nxt)
            cur = nxt
        return nodes

    def set_quota(self, prefix: list[str], quota: int) -> None:
        self._walk(prefix, create=True)[-1].card.quota = quota
        if quota < UNLIMITED:
            self.has_quotas = True

    def series_created(self, labels: dict[str, str]) -> None:
        """Count one new series; raises ``QuotaExceededError`` where a
        prefix of its path is at its quota (nothing is counted then)."""
        path = self._path(labels)
        nodes = self._walk(path, create=True)
        for i, n in enumerate(nodes):
            if n.card.active_ts + 1 > n.card.quota:
                raise QuotaExceededError(list(path[:i]), n.card.quota)
        for n in nodes:
            n.card.active_ts += 1
            n.card.total_ts += 1

    def series_created_many(self, label_maps) -> None:
        """Count new series, given their label maps."""
        for path, n in Counter(self._path(lm) for lm in label_maps).items():
            for node in self._walk(path, create=True):
                node.card.active_ts += n
                node.card.total_ts += n

    def series_stopped_many(self, label_maps) -> None:
        """Count series that stopped (purged or evicted): each one's path
        loses an active series, never below zero, as the reference's
        ``series_stopped`` one at a time."""
        for path, n in Counter(self._path(lm) for lm in label_maps).items():
            for node in self._walk(path):
                node.card.active_ts = max(node.card.active_ts - n, 0)

    def cardinality(self, prefix: list[str]) -> Cardinality:
        nodes = self._walk(prefix)
        if len(nodes) <= len(prefix):
            return Cardinality("/".join(prefix) or "__root__")
        return nodes[-1].card

    def top_k(self, prefix: list[str], k: int = 10) -> list[Cardinality]:
        """The ``k`` children under ``prefix`` with the most active
        series (``status/tsdb``'s metric counts)."""
        nodes = self._walk(prefix)
        if len(nodes) <= len(prefix):
            return []
        return sorted((c.card for c in nodes[-1].children.values()),
                      key=lambda c: -c.active_ts)[:k]

    def to_state(self) -> list:
        """The tree as nested lists ``[name, active, total, children,
        quota, [kids]]`` (the snapshot's JSON)."""
        def walk(node):
            c = node.card
            return [c.name, c.active_ts, c.total_ts, c.children, c.quota,
                    [walk(ch) for ch in node.children.values()]]
        return walk(self._root)

    def load_state(self, state: list) -> None:
        def build(entry) -> _Node:
            name, active, total, children, quota, kids = entry
            node = _Node(Cardinality(name, active, total, children, quota))
            for kid in kids:
                node.children[kid[0]] = build(kid)
            return node
        self._root = build(state)

        def finite(node) -> bool:
            return node.card.quota < UNLIMITED or any(
                finite(ch) for ch in node.children.values())
        self.has_quotas = self.has_quotas or finite(self._root)
