"""Choke-point taint pass (CP5xx): whole-repo reachability proofs for
the resilience invariants that the reference's reviews restored by hand
and that nothing previously stopped a new call site from bypassing.

- **CP501 deadline-dropped dispatch** — every ``PlanDispatcher``
  subclass whose ``dispatch`` closure (nested defs and transitive
  self-calls included) performs blocking work must reference a
  ``deadline`` somewhere in that closure. A dispatcher that blocks on
  the network without consulting ``ctx.deadline`` turns one slow peer
  into an unbounded client hang. The multi-process mesh transport's
  ``exec_descriptors`` is a second network entry point on the same
  class family and is held to the same proof.
- **CP502 governor-admission bypass** — outside the plan-tree internals
  (``filodb_tpu_torch/query/``, ``filodb_tpu_torch/parallel/``, which sit *below*
  the admission gate), any ``<x>.dispatcher.dispatch(...)`` call,
  mesh-engine or mesh-cluster ``execute*`` call, or raw
  ``<x>.do_execute(...)`` call
  must be lexically inside a ``with ...admit(...)`` scope. Entry paths
  that skip governor admission starve the overload protections the
  soak tests exercise. ``query/federation.py`` is carved OUT of the
  below-gate skip: federated tier sub-queries must stay provably under
  the single admit() at ``_execute_uncached`` (i.e. route through
  ``gather``), never grow their own dispatch entry path.
- **CP503 breaker bookkeeping outside resilience.py** — direct calls to
  ``guard`` / ``record_success`` / ``record_failure`` /
  ``cancel_probe`` anywhere except ``utils/resilience.py`` bypass the
  one-outcome-per-admission accounting that ``calling()`` enforces;
  ``force_open`` is exempt (a failure-detector verdict, not a call
  outcome).
- **CP504 breaker double outcome** — inside
  ``with <x>.calling(...) as out:``, the maximum number of
  ``out.success()`` / ``out.failure()`` calls along any single path
  must be <= 1 (the ``_BreakerOutcome`` is one-shot; a second call on
  the same path is dead bookkeeping at best and a double-count race at
  worst). Alternative paths — if/else branches, distinct except
  handlers — each get their own budget.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from filodb_tpu_torch.analysis.lockdiscipline import blocking_desc
from filodb_tpu_torch.analysis.model import Finding
from filodb_tpu_torch.analysis.runner import AnalysisContext, ModuleInfo

BREAKER_BOOKKEEPING = {"guard", "record_success", "record_failure",
                       "cancel_probe"}
RESILIENCE_PATH = "filodb_tpu_torch/utils/resilience.py"
# modules below the admission gate: plan-tree / engine internals where
# dispatcher.dispatch recursion is expected to already be admitted
BELOW_GATE_PREFIXES = ("filodb_tpu_torch/query/", "filodb_tpu_torch/parallel/")
# carve-out from the below-gate skip: federation composes whole tier
# sub-queries and is the one query/ module that could plausibly grow a
# direct dispatch / do_execute entry path around the governor — scan it
# like coordinator code so federated sub-query execution stays provably
# under the admit() gate (TierExec must route through self.gather)
GATED_QUERY_MODULES = ("filodb_tpu_torch/query/federation.py",)
# coordinator modules that are nonetheless below the gate:
# ReplicaDispatcher is a PlanDispatcher routing layer — its dispatch()
# is only ever reached through an already-admitted plan tree, and its
# candidate fan-out (hedge/failover recursion into the wrapped
# per-node dispatchers) must not re-admit: one query, one admission
BELOW_GATE_MODULES = ("filodb_tpu_torch/coordinator/replication.py",)
DISPATCHER_BASE = "PlanDispatcher"


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


# --------------------------------------------------------------------------
# CP501: deadline-dropped dispatch

def _dispatcher_classes(ctx: AnalysisContext) -> list[tuple[ModuleInfo,
                                                            ast.ClassDef]]:
    """Fixpoint over base-name edges seeded at ``PlanDispatcher``."""
    classes: list[tuple[ModuleInfo, ast.ClassDef]] = []
    for mi in ctx.modules:
        for node in mi.tree.body:
            if isinstance(node, ast.ClassDef):
                classes.append((mi, node))
    dispatcher_names = {DISPATCHER_BASE}
    changed = True
    while changed:
        changed = False
        for _, cdef in classes:
            if cdef.name in dispatcher_names:
                continue
            for base in cdef.bases:
                name = base.attr if isinstance(base, ast.Attribute) else (
                    base.id if isinstance(base, ast.Name) else None)
                if name in dispatcher_names:
                    dispatcher_names.add(cdef.name)
                    changed = True
    return [(mi, cdef) for mi, cdef in classes
            if cdef.name in dispatcher_names
            and cdef.name != DISPATCHER_BASE]


def _methods(cdef: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cdef.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _closure_scan(cdef: ast.ClassDef, method: str, memo: dict,
                  active: set) -> tuple[list[tuple[int, str]], bool]:
    """(blocking sites, references-deadline) over ``method`` plus its
    transitive self-call closure, nested defs included."""
    if method in memo:
        return memo[method]
    if method in active:
        return [], False
    methods = _methods(cdef)
    fdef = methods.get(method)
    if fdef is None:
        return [], False
    active.add(method)
    blocking: list[tuple[int, str]] = []
    deadline = False
    for node in ast.walk(fdef):
        if isinstance(node, ast.Name) and node.id == "deadline":
            deadline = True
        elif isinstance(node, ast.Attribute) and node.attr == "deadline":
            deadline = True
        elif isinstance(node, ast.Call):
            desc = blocking_desc(node)
            if desc is not None:
                blocking.append((node.lineno, desc))
            fn = node.func
            if isinstance(fn, ast.Attribute) and \
                    isinstance(fn.value, ast.Name) and \
                    fn.value.id == "self" and fn.attr in methods:
                sub_b, sub_d = _closure_scan(cdef, fn.attr, memo, active)
                blocking.extend(
                    (node.lineno, f"{d} (via self.{fn.attr})")
                    for _, d in sub_b)
                deadline = deadline or sub_d
    active.discard(method)
    memo[method] = (blocking, deadline)
    return memo[method]


# dispatcher entry points that take network-bound work on behalf of a
# query: the classic plan-tree dispatch plus the multi-process mesh
# transport's descriptor fan-out
DISPATCH_ENTRY_METHODS = ("dispatch", "exec_descriptors")


def _check_cp501(ps: "_PassState", ctx: AnalysisContext) -> None:
    for mi, cdef in _dispatcher_classes(ctx):
        methods = _methods(cdef)
        for entry in DISPATCH_ENTRY_METHODS:
            if entry not in methods:
                continue
            blocking, deadline = _closure_scan(cdef, entry, {}, set())
            if blocking and not deadline:
                line, desc = blocking[0]
                ps.finding(
                    "CP501", mi.path, line, f"{cdef.name}.{entry}",
                    detail=desc,
                    message=(f"{entry} blocks on {desc} but never "
                             f"references a deadline anywhere in its "
                             f"call closure: one slow peer hangs the "
                             f"caller unboundedly (thread the "
                             f"ctx.deadline budget into the blocking "
                             f"call)"))


# --------------------------------------------------------------------------
# CP502: governor-admission bypass

def _is_admit_with(node: ast.With) -> bool:
    for item in node.items:
        ce = item.context_expr
        if isinstance(ce, ast.Call) and \
                isinstance(ce.func, ast.Attribute) and \
                ce.func.attr == "admit":
            return True
    return False


def _is_gated_call(call: ast.Call) -> str | None:
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr == "dispatch" and isinstance(fn.value, ast.Attribute) \
            and fn.value.attr == "dispatcher":
        return f"{_src(fn)}()"
    if fn.attr.startswith("execute") and "mesh_engine" in _src(fn.value):
        return f"{_src(fn)}()"
    # the multi-process mesh runtime fans a query out to worker
    # processes: same admission contract as the in-process engine
    if fn.attr.startswith("execute") and "mesh_cluster" in _src(fn.value):
        return f"{_src(fn)}()"
    # raw plan-node execution: calling do_execute bypasses BOTH the
    # admission gate and ExecPlan.execute's span/limit bookkeeping
    if fn.attr == "do_execute":
        return f"{_src(fn)}()"
    return None


def _check_cp502(ps: "_PassState", ctx: AnalysisContext) -> None:
    for mi in ctx.modules:
        if (mi.path.startswith(BELOW_GATE_PREFIXES)
                or mi.path in BELOW_GATE_MODULES) \
                and mi.path not in GATED_QUERY_MODULES:
            continue

        def scan(stmts, admitted: bool, symbol: str):
            for stmt in stmts:
                inner = admitted
                if isinstance(stmt, (ast.With, ast.AsyncWith)) and \
                        _is_admit_with(stmt):
                    inner = True
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # nested defs inherit the lexical admission scope
                    scan(stmt.body, admitted, f"{symbol}.{stmt.name}")
                    continue
                if not inner:
                    for node in ast.iter_child_nodes(stmt):
                        if not isinstance(node, (ast.stmt,)):
                            for sub in ast.walk(node):
                                if isinstance(sub, ast.Call):
                                    desc = _is_gated_call(sub)
                                    if desc is not None:
                                        ps.finding(
                                            "CP502", mi.path,
                                            sub.lineno, symbol,
                                            detail=desc,
                                            message=_CP502_MSG % desc)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if sub:
                        scan(sub, inner, symbol)
                for h in getattr(stmt, "handlers", []):
                    scan(h.body, inner, symbol)

        for node in mi.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(node.body, False, node.name)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        scan(sub.body, False, f"{node.name}.{sub.name}")


_CP502_MSG = ("%s executes query work outside any governor admit() "
              "scope: this entry path bypasses overload admission "
              "(wrap it in `with governor().admit(...)` like "
              "_execute_uncached / PlanExecutorServer._handle)")


# --------------------------------------------------------------------------
# CP503: direct breaker bookkeeping

def _check_cp503(ps: "_PassState", ctx: AnalysisContext) -> None:
    for mi in ctx.modules:
        if mi.path == RESILIENCE_PATH:
            continue
        symbol_of = _symbol_index(mi)
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in BREAKER_BOOKKEEPING:
                recv = _src(node.func.value).lower()
                # record_success/record_failure/cancel_probe are
                # breaker-specific names; the generic `guard` only
                # counts on a breaker-shaped receiver
                if node.func.attr == "guard" and "breaker" not in recv:
                    continue
                sym = symbol_of(node.lineno)
                ps.finding(
                    "CP503", mi.path, node.lineno, sym,
                    detail=f"{_src(node.func)}",
                    message=(f"direct breaker bookkeeping "
                             f"`{_src(node.func)}()` outside "
                             f"utils/resilience.py bypasses the "
                             f"one-outcome-per-admission contract of "
                             f"calling(); use `with breaker.calling()` "
                             f"or justify in the baseline"))


def _symbol_index(mi: ModuleInfo):
    spans: list[tuple[int, int, str]] = []
    for node in mi.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            spans.append((node.lineno, node.end_lineno or node.lineno,
                          node.name))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    spans.append((sub.lineno, sub.end_lineno or
                                  sub.lineno, f"{node.name}.{sub.name}"))

    def lookup(line: int) -> str:
        for lo, hi, name in spans:
            if lo <= line <= hi:
                return name
        return "<module>"

    return lookup


# --------------------------------------------------------------------------
# CP504: breaker double outcome

def _max_outcomes(stmts, out_name: str) -> int:
    """Max count of ``out.success()``/``out.failure()`` on any single
    path through ``stmts``. Sequential statements sum; branches take
    the max of their alternatives."""
    total = 0
    for stmt in stmts:
        total += _stmt_outcomes(stmt, out_name)
    return total


def _expr_outcomes(node: ast.AST, out_name: str) -> int:
    n = 0
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in ("success", "failure") and \
                isinstance(sub.func.value, ast.Name) and \
                sub.func.value.id == out_name:
            n += 1
    return n


def _stmt_outcomes(stmt: ast.stmt, out_name: str) -> int:
    if isinstance(stmt, ast.If):
        return _expr_outcomes(stmt.test, out_name) + max(
            _max_outcomes(stmt.body, out_name),
            _max_outcomes(stmt.orelse, out_name))
    if isinstance(stmt, ast.Try):
        main = _max_outcomes(stmt.body, out_name) + \
            _max_outcomes(stmt.orelse, out_name)
        handlers = max(
            (_max_outcomes(h.body, out_name) for h in stmt.handlers),
            default=0)
        # body and handler are treated as alternative paths (the common
        # body-records-or-handler-records shape must stay clean), so
        # max rather than sum
        return max(main, handlers) + _max_outcomes(stmt.finalbody,
                                                   out_name)
    if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
        return _max_outcomes(stmt.body, out_name) + \
            _max_outcomes(stmt.orelse, out_name)
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return _max_outcomes(stmt.body, out_name)
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return 0
    return _expr_outcomes(stmt, out_name)


def _check_cp504(ps: "_PassState", ctx: AnalysisContext) -> None:
    for mi in ctx.modules:
        symbol_of = _symbol_index(mi)
        for node in ast.walk(mi.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                ce = item.context_expr
                if not (isinstance(ce, ast.Call) and
                        isinstance(ce.func, ast.Attribute) and
                        ce.func.attr == "calling"):
                    continue
                if not isinstance(item.optional_vars, ast.Name):
                    continue   # no ``as out`` -> calling() does it all
                out_name = item.optional_vars.id
                worst = _max_outcomes(node.body, out_name)
                if worst > 1:
                    ps.finding(
                        "CP504", mi.path, node.lineno,
                        symbol_of(node.lineno),
                        detail=f"{_src(ce.func)} as {out_name}",
                        message=(f"some path through this calling() "
                                 f"block records {worst} outcomes on "
                                 f"'{out_name}': _BreakerOutcome is "
                                 f"one-shot, so the extras are dead "
                                 f"bookkeeping or a double-count"))


# --------------------------------------------------------------------------
# driver

@dataclass
class _PassState:
    findings: list = field(default_factory=list)

    def finding(self, code, path, line, symbol, detail, message):
        self.findings.append(Finding(code, path, line, symbol, detail,
                                     message))


def run(ctx: AnalysisContext) -> list[Finding]:
    ps = _PassState()
    _check_cp501(ps, ctx)
    _check_cp502(ps, ctx)
    _check_cp503(ps, ctx)
    _check_cp504(ps, ctx)
    return ps.findings
