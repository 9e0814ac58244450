"""Column filters for partition-key lookup.

Copy of ``filodb_tpu/core/filters.py`` (the port imports nothing of ``filodb_tpu``).

Counterpart of reference ``core/src/main/scala/filodb.core/query/KeyFilter.scala``
(``ColumnFilter`` / ``Filter`` with Equals/In/EqualsRegex/NotEqualsRegex...).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class Filter:
    def matches(self, value: str) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass(frozen=True)
class Equals(Filter):
    value: str

    def matches(self, value: str) -> bool:
        return value == self.value


@dataclass(frozen=True)
class NotEquals(Filter):
    value: str

    def matches(self, value: str) -> bool:
        return value != self.value


@dataclass(frozen=True)
class In(Filter):
    values: frozenset[str]

    def matches(self, value: str) -> bool:
        return value in self.values


def _compile_anchored(pattern: str) -> re.Pattern:
    # PromQL regexes are fully anchored (RE2 ^(?:pattern)$ semantics)
    return re.compile(f"^(?:{pattern})$")


_RE_META = set(".^$*+?{}[]|()\\")


def _split_top_level_alts(pattern: str) -> list[str]:
    """Split on top-level ``|`` (escapes consumed, group nesting tracked,
    character classes scanned opaquely — ``(``/``|``/``[`` inside ``[...]``
    are literals and must not desync the depth counter). An escaped
    sequence stays in its part verbatim, so parts containing ``\\`` still
    read as non-literal downstream."""
    parts, cur, depth = [], [], 0
    in_class = False
    class_start = -1
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            cur.append(ch)
            i += 1
            if i < len(pattern):
                cur.append(pattern[i])
                i += 1
            continue
        if in_class:
            # ']' is literal as the first class char ("[]]") or right
            # after a negation ("[^]]")
            first = i == class_start + 1 or (
                i == class_start + 2 and pattern[class_start + 1] == "^")
            if ch == "]" and not first:
                in_class = False
            cur.append(ch)
            i += 1
            continue
        if ch == "[":
            in_class = True
            class_start = i
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "|" and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    parts.append("".join(cur))
    return parts


from functools import lru_cache


@lru_cache(maxsize=1024)
def regex_plan(pattern: str) -> tuple[str, object]:
    """Pre-analyze an anchored regex the way Prometheus'
    FastRegexMatcher / Lucene's automata rewriting do
    (reference ``PartKeyLuceneIndex.scala:455`` leans on Lucene's
    ``RegexpQuery`` automaton; this is the index-side equivalent):

    - ``("literal", s)``  — no metacharacters: an Equals lookup
    - ``("alts", [s..])`` — top-level alternation of literals: an In lookup
    - ``("prefix", p)``   — literal prefix: narrow the value scan to the
      sorted value table's prefix range before running the regex
    - ``("scan", None)``  — fall back to the full value-table scan
    """
    if not any(ch in _RE_META for ch in pattern):
        return ("literal", pattern)
    parts = _split_top_level_alts(pattern)
    if len(parts) > 1:
        if all(p and not any(ch in _RE_META for ch in p) for p in parts):
            return ("alts", parts)
        # top-level alternation with non-literal branches: the pattern
        # head is NOT a mandatory prefix of every match
        return ("scan", None)
    prefix = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch in _RE_META:
            break
        if i + 1 < len(pattern) and pattern[i + 1] in "*+?{":
            break  # quantifier makes this char optional/repeated
        prefix.append(ch)
        i += 1
    if prefix:
        return ("prefix", "".join(prefix))
    return ("scan", None)


class _CompiledRegexMixin:
    """Per-instance compiled-pattern memo: ``matches`` runs once per value
    in index value-table scans — recompiling (even via the re module's
    bounded cache) dominates the scan."""

    def _rx(self) -> re.Pattern:
        rx = self.__dict__.get("_rx_c")
        if rx is None:
            rx = _compile_anchored(self.pattern)
            object.__setattr__(self, "_rx_c", rx)
        return rx


@dataclass(frozen=True)
class EqualsRegex(Filter, _CompiledRegexMixin):
    pattern: str

    def matches(self, value: str) -> bool:
        return self._rx().match(value) is not None


@dataclass(frozen=True)
class NotEqualsRegex(Filter, _CompiledRegexMixin):
    pattern: str

    def matches(self, value: str) -> bool:
        return self._rx().match(value) is None


@dataclass(frozen=True)
class ColumnFilter:
    column: str
    filter: Filter

    def __str__(self) -> str:
        f = self.filter
        if isinstance(f, Equals):
            return f'{self.column}="{f.value}"'
        if isinstance(f, NotEquals):
            return f'{self.column}!="{f.value}"'
        if isinstance(f, EqualsRegex):
            return f'{self.column}=~"{f.pattern}"'
        if isinstance(f, NotEqualsRegex):
            return f'{self.column}!~"{f.pattern}"'
        if isinstance(f, In):
            return f'{self.column} in {sorted(f.values)}'
        return f"{self.column}?{f}"
