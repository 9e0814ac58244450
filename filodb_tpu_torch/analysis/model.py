"""Finding/baseline model shared by every filolint pass.

A finding's identity (``key``) is deliberately line-number-free: it
hashes the pass code, the repo-relative path, the enclosing symbol and a
pass-chosen detail string (lock name + blocked call, attribute name,
metric name, ...). Unrelated edits that shift lines therefore never
invalidate the baseline, while moving the offending code to another
function or file — a real change — does.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    code: str          # e.g. "LD101"
    path: str          # repo-relative posix path
    line: int          # 1-based; diagnostic only, not part of identity
    symbol: str        # "Class.method", "Class", or "<module>"
    detail: str        # stable pass-chosen identity fragment
    message: str       # human-readable description

    @property
    def key(self) -> str:
        return f"{self.code}:{self.path}:{self.symbol}:{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.code} [{self.symbol}] "
                f"{self.message}")


# inline suppression: a trailing  "# filolint: disable=LD101"  (or a
# comma list, or "all") on the finding's line suppresses it in place —
# for one-off intentional patterns where a baseline entry would be noise
_SUPPRESS_RE = re.compile(r"#\s*filolint:\s*disable=([A-Za-z0-9,_ ]+)")


def suppressed(source_lines: list[str], line: int, code: str) -> bool:
    if not (1 <= line <= len(source_lines)):
        return False
    m = _SUPPRESS_RE.search(source_lines[line - 1])
    if not m:
        return False
    codes = {c.strip() for c in m.group(1).split(",")}
    return "all" in codes or code in codes


@dataclass
class Baseline:
    """Checked-in set of accepted findings, each with a one-line
    justification. The gate fails only on findings NOT in here; stale
    entries (baselined finding no longer produced) are surfaced so the
    file shrinks as debts are paid."""

    entries: dict[str, dict] = field(default_factory=dict)  # key -> entry

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return cls()
        return cls({e["key"]: e for e in doc.get("entries", [])})

    def save(self, path: str) -> None:
        doc = {
            "version": 1,
            "comment": "filolint accepted-findings baseline; every entry "
                       "needs a one-line justification (see "
                       "doc/static_analysis.md)",
            "entries": sorted(self.entries.values(),
                              key=lambda e: e["key"]),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")

    def diff(self, findings: list[Finding]
             ) -> tuple[list[Finding], list[dict]]:
        """Split into (new findings, stale baseline entries)."""
        seen = {f.key for f in findings}
        new = [f for f in findings if f.key not in self.entries]
        stale = [e for k, e in sorted(self.entries.items())
                 if k not in seen]
        return new, stale

    def update(self, findings: list[Finding]) -> None:
        """Absorb current findings: add new keys with a TODO note (to be
        replaced by a human justification), drop stale ones."""
        seen = {}
        for f in findings:
            prev = self.entries.get(f.key)
            seen[f.key] = {
                "key": f.key,
                "code": f.code,
                "path": f.path,
                "symbol": f.symbol,
                "message": f.message,
                "justification": (prev or {}).get(
                    "justification", "TODO: justify or fix"),
            }
        self.entries = seen
