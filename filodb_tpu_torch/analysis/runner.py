"""Parse-once analysis context and the pass runner.

Every pass consumes :class:`AnalysisContext` — the repo's source files
parsed a single time into ``(path, ast, source_lines)`` records — so
adding a pass costs one AST walk, not a re-read of the tree.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from filodb_tpu_torch.analysis.model import Finding, suppressed

# directories under the package root whose files are analyzed; tools/
# and tests/ are consumers of the analyzer, not subjects (the parity
# pass reads the scrape test separately, as data)
_SKIP_PARTS = {"__pycache__"}


@dataclass
class ModuleInfo:
    path: str                 # repo-relative posix path
    tree: ast.Module
    lines: list[str]


@dataclass
class AnalysisContext:
    root: str                             # repo root (absolute)
    modules: list[ModuleInfo] = field(default_factory=list)
    scrape_test: str = os.path.join("tests", "test_metrics_scrape.py")
    wire_module: str = os.path.join("filodb_tpu_torch", "coordinator", "wire.py")
    errors: list[str] = field(default_factory=list)

    @classmethod
    def build(cls, root: str, package: str = "filodb_tpu_torch"
              ) -> "AnalysisContext":
        ctx = cls(root=os.path.abspath(root))
        pkg_root = os.path.join(ctx.root, package)
        for dirpath, dirnames, filenames in os.walk(pkg_root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_PARTS)
            for name in sorted(filenames):
                if name.endswith(".py"):
                    ctx.add_file(os.path.join(dirpath, name))
        return ctx

    def add_file(self, abspath: str) -> None:
        rel = os.path.relpath(abspath, self.root).replace(os.sep, "/")
        try:
            with open(abspath, encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=rel)
        except (OSError, SyntaxError) as e:
            self.errors.append(f"{rel}: {e}")
            return
        self.modules.append(ModuleInfo(rel, tree, src.splitlines()))

    def module(self, rel_path: str) -> ModuleInfo | None:
        rel = rel_path.replace(os.sep, "/")
        for m in self.modules:
            if m.path == rel:
                return m
        return None

    def read(self, rel_path: str) -> ModuleInfo | None:
        """Parse a file outside the package set (e.g. the scrape test)."""
        abspath = os.path.join(self.root, rel_path)
        if not os.path.exists(abspath):
            return None
        try:
            with open(abspath, encoding="utf-8") as f:
                src = f.read()
            return ModuleInfo(rel_path.replace(os.sep, "/"),
                              ast.parse(src, filename=rel_path),
                              src.splitlines())
        except (OSError, SyntaxError) as e:
            self.errors.append(f"{rel_path}: {e}")
            return None


def run_all(root: str, passes=None) -> list[Finding]:
    """Run every pass over the tree at ``root``; inline-suppressed
    findings are dropped here so passes never special-case comments."""
    from filodb_tpu_torch.analysis import (chokepoint, decisionparity, hotpath,
                                     lifecycle, lockdiscipline, parity)

    ctx = AnalysisContext.build(root)
    findings: list[Finding] = []
    for mod in (passes or (lockdiscipline, lifecycle, chokepoint,
                           parity, hotpath, decisionparity)):
        findings.extend(mod.run(ctx))
    by_path = {m.path: m.lines for m in ctx.modules}
    out = []
    for f in findings:
        lines = by_path.get(f.path)
        if lines is None:
            mi = ctx.module(f.path) or ctx.read(f.path)
            lines = mi.lines if mi else []
            by_path[f.path] = lines
        if not suppressed(lines, f.line, f.code):
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.code, f.detail))
    # identity is line-free, so two sites with the same key are ONE
    # finding (e.g. two recv calls in the same helper); keep the first
    seen: set[str] = set()
    deduped = []
    for f in out:
        if f.key not in seen:
            seen.add(f.key)
            deduped.append(f)
    return deduped
