"""filolint command-line driver.

Usage::

    python tools/filolint.py [--root REPO] [--baseline PATH]
                             [--update-baseline]
                             [--format text|json|sarif]
                             [--changed-only]

Exit status: 0 when every finding is baselined (stale baseline entries
are warnings), 1 when new findings exist, 2 on analyzer errors (a file
that fails to parse is an analyzer error, not a clean run).

``--changed-only`` is the pre-commit fast path: the whole tree is still
parsed and every pass still runs (the passes need whole-repo context —
call closures, wire registry, dispatcher subclasses), but reported
findings are restricted to files in ``git diff --name-only HEAD`` plus
their reverse-import dependents, and stale-baseline warnings are
suppressed (an unchanged file's entries are out of scope).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys

from filodb_tpu_torch.analysis.model import Baseline
from filodb_tpu_torch.analysis.runner import AnalysisContext, run_all

DEFAULT_BASELINE = os.path.join("conf", "filolint_torch_baseline.json")

# one-line rule descriptions for SARIF's tool.driver.rules
RULE_DESCRIPTIONS = {
    "LD101": "blocking call while holding a lock",
    "LD102": "statically-approximated lock-order cycle",
    "LD103": "attribute written both under and outside a lock",
    "RL401": "resource leaks on an exception path",
    "RL402": "resource acquired but never released",
    "RL403": "non-daemon thread started but never joined",
    "RL404": "queue task ack outside a finally block",
    "CP501": "dispatch blocks without consulting a deadline",
    "CP502": "query execution outside governor admission",
    "CP503": "breaker bookkeeping outside resilience.py",
    "CP504": "multiple breaker outcomes on one calling() path",
    "PR201": "wire registry closure violation",
    "PR202": "wire registry closure violation",
    "PR203": "metric name parity violation",
    "PR204": "metric name parity violation",
    "PR205": "Prometheus metric name charset violation",
    "HP301": "host sync inside a jitted kernel",
    "HP302": "wall-clock/randomness inside a jitted kernel",
}


def _changed_files(root: str) -> set[str] | None:
    """Repo-relative paths changed vs HEAD (staged + unstaged), or None
    when git is unavailable — the caller falls back to a full run."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return {line.strip().replace(os.sep, "/")
            for line in out.stdout.splitlines() if line.strip()}


def _module_name(path: str) -> str:
    # filodb_tpu_torch/coordinator/remote.py -> filodb_tpu_torch.coordinator.remote
    mod = path[:-3] if path.endswith(".py") else path
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _dependent_closure(ctx: AnalysisContext, changed: set[str]) -> set[str]:
    """``changed`` plus every module that transitively imports one of
    them — a changed helper invalidates its callers' summaries."""
    by_name = {_module_name(m.path): m.path for m in ctx.modules}
    importers: dict[str, set[str]] = {}   # imported path -> {importer path}
    for m in ctx.modules:
        for node in ast.walk(m.tree):
            targets = []
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                targets = [node.module] + \
                    [f"{node.module}.{a.name}" for a in node.names]
            for t in targets:
                path = by_name.get(t)
                if path is not None:
                    importers.setdefault(path, set()).add(m.path)
    scope = set(changed)
    frontier = list(changed)
    while frontier:
        cur = frontier.pop()
        for dep in importers.get(cur, ()):
            if dep not in scope:
                scope.add(dep)
                frontier.append(dep)
    return scope


def _sarif(new, stale) -> dict:
    codes = sorted({f.code for f in new})
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "filolint",
                "informationUri": "doc/static_analysis.md",
                "rules": [{
                    "id": c,
                    "shortDescription": {"text": RULE_DESCRIPTIONS.get(
                        c, "filolint finding")},
                } for c in codes],
            }},
            "results": [{
                "ruleId": f.code,
                "level": "error",
                "message": {"text": f"[{f.symbol}] {f.message}"},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {"startLine": f.line},
                    },
                }],
                # line-free identity so CI result matching survives
                # unrelated edits shifting line numbers
                "partialFingerprints": {"filolintKey": f.key},
            } for f in new],
            "invocations": [{
                "executionSuccessful": True,
                "toolExecutionNotifications": [{
                    "level": "warning",
                    "message": {"text": f"stale baseline entry "
                                        f"{e['key']}"},
                } for e in stale],
            }],
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="filolint",
        description="FiloDB concurrency-discipline and invariant "
                    "static analysis")
    ap.add_argument("--root", default=".",
                    help="repo root containing filodb_tpu_torch/ "
                         "(default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: "
                         f"<root>/{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current finding "
                         "set (existing justifications are kept; new "
                         "entries get a TODO)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--changed-only", action="store_true",
                    help="report only findings in files changed vs "
                         "HEAD plus their reverse-import dependents "
                         "(pre-commit fast mode; falls back to a full "
                         "run when git is unavailable)")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)

    # parse errors must fail loudly — an unparseable file is unanalyzed
    ctx = AnalysisContext.build(root)
    if ctx.errors:
        for e in ctx.errors:
            print(f"filolint: parse error: {e}", file=sys.stderr)
        return 2

    findings = run_all(root)

    changed_scope = None
    if args.changed_only:
        changed = _changed_files(root)
        if changed is None:
            print("filolint: warning: git diff unavailable, running on "
                  "the full tree", file=sys.stderr)
        else:
            changed_scope = _dependent_closure(ctx, changed)

    if args.update_baseline:
        bl = Baseline.load(baseline_path)
        bl.update(findings)
        bl.save(baseline_path)
        print(f"filolint: wrote {len(bl.entries)} entries to "
              f"{baseline_path}")
        return 0

    if args.no_baseline:
        new, stale = findings, []
    else:
        bl = Baseline.load(baseline_path)
        new, stale = bl.diff(findings)

    if changed_scope is not None:
        new = [f for f in new if f.path in changed_scope]
        # out-of-scope files were not (conceptually) analyzed, so their
        # stale entries are not evidence of anything
        stale = []

    if args.format == "json":
        print(json.dumps({
            "new": [vars(f) | {"key": f.key} for f in new],
            "stale_baseline": stale,
            "total_findings": len(findings),
        }, indent=2))
    elif args.format == "sarif":
        print(json.dumps(_sarif(new, stale), indent=2))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"filolint: warning: stale baseline entry "
                  f"{e['key']} (finding no longer produced; remove it)",
                  file=sys.stderr)
        if new:
            print(f"filolint: {len(new)} new finding(s) "
                  f"({len(findings)} total, "
                  f"{len(findings) - len(new)} baselined)",
                  file=sys.stderr)
        else:
            print(f"filolint: clean ({len(findings)} baselined "
                  f"finding(s))", file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
