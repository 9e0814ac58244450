"""Lock-discipline pass: the reference's known lock bug classes, as AST checks.

Three findings, built from one walk that tracks the lexically-held lock
set per function:

- **LD101 blocking-under-lock** — a call from the blocking registry
  (sleeps, socket/HTTP I/O, ``Future.result``, thread joins, bounded
  queue ops, ``RetryPolicy.call``, ``QueryService`` evaluation) made
  while a ``with <lock>:`` scope is open, directly or through a
  transitively-expanded ``self._method()`` chain. This is exactly the
  reference's priority inversion: rule
  evaluation ran under the state lock, so lock-free readers stalled
  behind a slow query.
- **LD102 lock-order-cycle** — ``with`` scopes that nest lock B inside
  lock A add a static edge A→B (one-level ``self._method()`` calls
  expand too); a cycle in the resulting cross-class graph is a
  potential deadlock. Edges between two instances created at the SAME
  site are ignored — static analysis cannot order instances, so a
  self-edge is reported by the runtime checker
  (``utils/lockcheck.py``) instead.
- **LD103 mixed-guard-attribute** — a ``self.X`` assigned both inside
  and outside ``with <lock>`` scopes (``__init__``/``__post_init__``
  excluded): either the lock is unnecessary or the unguarded store is a
  race (the shared-``ExecContext`` class of bug). Methods named
  ``*_locked`` assert by convention that their caller holds the
  relevant lock, and their stores count as guarded.

Known approximations, by design: lock identity is lexical (class +
attribute name), call expansion is ``self.``-only (cross-object chains
are invisible), and receiver types are guessed from names (a ``.get``
only counts as a queue op when the receiver looks like a queue). The
runtime checker covers what static approximation cannot.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from filodb_tpu_torch.analysis.model import Finding
from filodb_tpu_torch.analysis.runner import AnalysisContext, ModuleInfo

# --------------------------------------------------------------------------
# blocking-call registry (configurable: tests/tools may extend)

# attribute names that block regardless of receiver
BLOCKING_ATTRS = {
    "sleep", "recv", "recv_into", "recvfrom", "sendall", "accept",
    "getresponse", "urlopen", "create_connection", "result",
    # QueryService evaluation — the priority-inversion bug class
    "query_range", "execute_logical", "_execute_uncached",
}
# .connect blocks except for sqlite3.connect (local file open)
CONNECT_EXEMPT_RECEIVERS = {"sqlite3"}
# .join blocks only on thread-like receivers (str.join is everywhere)
JOIN_RECEIVER_HINTS = ("thread", "uploader", "worker")
# .get/.put block only on queue-like receivers (dict.get is everywhere)
QUEUE_RECEIVER_HINTS = ("queue", "_q")
# .call blocks on retry-policy receivers (it sleeps between attempts)
CALL_RECEIVER_HINTS = ("retry",)

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


def _is_lock_factory(call: ast.AST) -> str | None:
    """Return the factory name if ``call`` creates a lock primitive:
    ``threading.Lock()``, ``Lock()``, ``_threading.RLock()``,
    ``field(default_factory=threading.Lock)``."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    name = None
    if isinstance(fn, ast.Attribute):
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    if name in _LOCK_FACTORIES:
        return name
    if name == "field":
        for kw in call.keywords:
            if kw.arg == "default_factory":
                v = kw.value
                vn = v.attr if isinstance(v, ast.Attribute) else (
                    v.id if isinstance(v, ast.Name) else None)
                if vn in _LOCK_FACTORIES:
                    return vn
    return None


def blocking_desc(call: ast.Call) -> str | None:
    """Classify a call as blocking; returns a short stable description
    or None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    recv = _src(fn.value)
    if attr in BLOCKING_ATTRS:
        return f"{recv}.{attr}()"
    if attr == "connect" and recv not in CONNECT_EXEMPT_RECEIVERS:
        return f"{recv}.{attr}()"
    low = recv.lower()
    if attr == "join" and any(h in low for h in JOIN_RECEIVER_HINTS):
        return f"{recv}.join()"
    if attr in ("get", "put") and (
            any(h in low for h in QUEUE_RECEIVER_HINTS)
            or low.endswith("_q") or low == "q"):
        return f"{recv}.{attr}()"
    if attr == "call" and any(h in low for h in CALL_RECEIVER_HINTS):
        return f"{recv}.call()"
    return None


# --------------------------------------------------------------------------
# per-module model

@dataclass
class _ClassInfo:
    name: str
    lock_attrs: set[str] = field(default_factory=set)   # self.X / cls.X
    cond_attrs: set[str] = field(default_factory=set)
    cond_wraps: dict[str, str] = field(default_factory=dict)  # cond -> lock
    methods: dict[str, "_MethodSummary"] = field(default_factory=dict)


@dataclass
class _MethodSummary:
    # locks acquired anywhere in the method: (lock_id, line)
    acquires: list = field(default_factory=list)
    # blocking calls NOT under any lock in the method: (desc, line)
    top_blocking: list = field(default_factory=list)
    # self-method calls NOT under any lock: (method_name, line) — these
    # propagate the callee's blocking/acquiring behavior to the caller
    # during transitive summary resolution
    top_self_calls: list = field(default_factory=list)


@dataclass
class _Deferred:
    """A self-method call made under held locks, resolved once every
    method summary exists (one-level interprocedural expansion)."""
    path: str
    cls: str
    method: str       # callee
    caller: str       # symbol of the calling method
    held: tuple       # lock ids held at the call
    line: int


def _collect_class_prelude(mi: ModuleInfo, cdef: ast.ClassDef
                           ) -> _ClassInfo:
    """First pass over a class: find its lock/condition attributes from
    ``self.X = threading.Lock()``-style stores (any method), class-body
    assignments, and dataclass ``field(default_factory=...)`` fields."""
    info = _ClassInfo(cdef.name)
    for node in ast.walk(cdef):
        target = None
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        if target is None:
            continue
        factory = _is_lock_factory(value)
        if factory is None:
            continue
        attr = None
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id in ("self", "cls"):
            attr = target.attr
        elif isinstance(target, ast.Name):
            attr = target.id     # class-body lock (FaultInjector style)
        if attr is None:
            continue
        info.lock_attrs.add(attr)
        if factory == "Condition":
            info.cond_attrs.add(attr)
            # Condition(self._lock) aliases an existing lock
            if isinstance(value, ast.Call) and value.args:
                a0 = value.args[0]
                if isinstance(a0, ast.Attribute) and \
                        isinstance(a0.value, ast.Name) and \
                        a0.value.id == "self":
                    info.cond_wraps[attr] = a0.attr
    return info


def _module_locks(mi: ModuleInfo) -> set[str]:
    out = set()
    for node in mi.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _is_lock_factory(node.value):
            out.add(node.targets[0].id)
    return out


class _FunctionWalker(ast.NodeVisitor):
    """Walk one function/method body tracking the lexically-held lock
    stack; emits LD101 findings, lock-graph edges, deferred self-calls,
    and attribute-store records as it goes."""

    def __init__(self, pass_state: "_PassState", mi: ModuleInfo,
                 cls: _ClassInfo | None, symbol: str,
                 summary: _MethodSummary):
        self.ps = pass_state
        self.mi = mi
        self.cls = cls
        self.symbol = symbol
        self.summary = summary
        self.held: list[str] = []

    # ---- lock resolution

    def _lock_id(self, expr: ast.AST) -> str | None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base, attr = expr.value.id, expr.attr
            if self.cls is not None and base in ("self", "cls") and \
                    attr in self.cls.lock_attrs:
                return f"{self.mi.path}::{self.cls.name}.{attr}"
            # ClassName._lock (class-body lock referenced by class name)
            if self.cls is not None and base == self.cls.name and \
                    attr in self.cls.lock_attrs:
                return f"{self.mi.path}::{self.cls.name}.{attr}"
        if isinstance(expr, ast.Name) and \
                expr.id in self.ps.module_locks.get(self.mi.path, ()):
            return f"{self.mi.path}::{expr.id}"
        return None

    def _canonical(self, lock_id: str) -> str:
        """Collapse a condition onto the lock it wraps, so ``with
        self._cond:`` and ``with self._lock:`` guard the same node."""
        if self.cls is None:
            return lock_id
        prefix = f"{self.mi.path}::{self.cls.name}."
        if lock_id.startswith(prefix):
            attr = lock_id[len(prefix):]
            wrapped = self.cls.cond_wraps.get(attr)
            if wrapped is not None and wrapped in self.cls.lock_attrs:
                return prefix + wrapped
        return lock_id

    # ---- visitors

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            lid = self._lock_id(item.context_expr)
            if lid is not None:
                lid = self._canonical(lid)
                self.summary.acquires.append((lid, node.lineno))
                for held in self.held:
                    if held != lid:
                        self.ps.add_edge(held, lid, self.mi.path,
                                         node.lineno, self.symbol)
                acquired.append(lid)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - len(acquired):]
        # with-items with side effects (calls) still need visiting
        for item in node.items:
            if not self._lock_id(item.context_expr):
                self.visit(item.context_expr)

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        desc = blocking_desc(node)
        if desc is not None:
            if self.held:
                blamed = self._blamed_locks(node)
                if blamed:
                    self.ps.finding(
                        "LD101", self.mi.path, node.lineno, self.symbol,
                        detail=f"{_short(blamed[-1])}|{desc}",
                        message=(f"blocking call {desc} while holding "
                                 f"{', '.join(_short(h) for h in blamed)}"))
            else:
                self.summary.top_blocking.append((desc, node.lineno))
        # self-call expansion (resolved transitively after all summaries
        # exist): under a lock it becomes a deferred check; outside any
        # lock it propagates the callee's behavior to this summary
        fn = node.func
        if self.cls is not None and \
                isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "self":
            if self.held:
                self.ps.deferred.append(_Deferred(
                    self.mi.path, self.cls.name, fn.attr, self.symbol,
                    tuple(self.held), node.lineno))
            else:
                self.summary.top_self_calls.append((fn.attr,
                                                    node.lineno))
        self.generic_visit(node)

    def _blamed_locks(self, call: ast.Call) -> list[str]:
        """Held locks a blocking call is charged against. ``cond.wait``
        releases the condition's own lock, so only OTHER held locks are
        blamed for a wait."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in ("wait",
                                                         "wait_for"):
            lid = self._lock_id(fn.value)
            if lid is not None:
                released = self._canonical(lid)
                return [h for h in self.held if h != released]
        return list(self.held)

    def _record_store(self, target: ast.AST, line: int) -> None:
        if self.cls is None or not isinstance(target, ast.Attribute):
            return
        if not (isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            return
        attr = target.attr
        if attr in self.cls.lock_attrs or attr.startswith("__"):
            return
        # naming convention: a method named *_locked asserts its caller
        # holds the relevant lock, so its stores count as guarded
        under = bool(self.held) or any(
            part.endswith("_locked") for part in self.symbol.split("."))
        self.ps.attr_stores.setdefault(
            (self.mi.path, self.cls.name, attr), []).append(
                (under, line, self.symbol))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_store(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_store(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_store(node.target, node.lineno)
        self.generic_visit(node)

    # nested defs/lambdas run in their own frame (often another thread):
    # the held stack does not flow in, and their bodies get their own walk
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        inner = _FunctionWalker(self.ps, self.mi, self.cls,
                                f"{self.symbol}.{node.name}",
                                _MethodSummary())
        for stmt in node.body:
            inner.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        inner = _FunctionWalker(self.ps, self.mi, self.cls,
                                f"{self.symbol}.<lambda>",
                                _MethodSummary())
        inner.visit(node.body)


def _short(lock_id: str) -> str:
    return lock_id.rsplit("::", 1)[-1]


@dataclass
class _PassState:
    findings: list = field(default_factory=list)
    module_locks: dict = field(default_factory=dict)  # path -> set[str]
    classes: dict = field(default_factory=dict)       # (path, name) -> info
    # (path, cls, attr) -> [(under_lock, line, symbol)]
    attr_stores: dict = field(default_factory=dict)
    deferred: list = field(default_factory=list)
    # src -> {dst -> (path, line, symbol)} first-seen edge site
    edges: dict = field(default_factory=dict)

    def finding(self, code, path, line, symbol, detail, message):
        self.findings.append(Finding(code, path, line, symbol, detail,
                                     message))

    def add_edge(self, src, dst, path, line, symbol):
        self.edges.setdefault(src, {}).setdefault(dst,
                                                  (path, line, symbol))


def run(ctx: AnalysisContext) -> list[Finding]:
    ps = _PassState()
    for mi in ctx.modules:
        ps.module_locks[mi.path] = _module_locks(mi)
        for node in mi.tree.body:
            if isinstance(node, ast.ClassDef):
                ps.classes[(mi.path, node.name)] = \
                    _collect_class_prelude(mi, node)
    for mi in ctx.modules:
        _walk_module(ps, mi)
    _resolve_deferred(ps)
    _emit_mixed_guard(ps)
    _emit_cycles(ps)
    return ps.findings


def _walk_module(ps: _PassState, mi: ModuleInfo) -> None:
    def walk_fn(fdef, cls, symbol):
        summary = _MethodSummary()
        if cls is not None:
            cls.methods[fdef.name] = summary
        w = _FunctionWalker(ps, mi, cls, symbol, summary)
        for stmt in fdef.body:
            w.visit(stmt)

    for node in mi.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk_fn(node, None, node.name)
        elif isinstance(node, ast.ClassDef):
            cls = ps.classes[(mi.path, node.name)]
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    walk_fn(sub, cls, f"{node.name}.{sub.name}")


def _method_closure(cls: _ClassInfo, method: str,
                    memo: dict, active: set
                    ) -> tuple[list, list]:
    """Transitive summary for ``self.<method>()``: the blocking calls
    (as ``(desc, call_chain)``) and lock acquisitions it performs while
    its own held set is empty — i.e. what a caller inherits by calling
    it. Self-recursive chains are cut by the ``active`` guard."""
    if method in memo:
        return memo[method]
    if method in active:
        return [], []
    summary = cls.methods.get(method)
    if summary is None:
        memo[method] = ([], [])
        return memo[method]
    active.add(method)
    blocking = [(desc, (method,)) for desc, _ln in summary.top_blocking]
    acquires = [lid for lid, _ln in summary.acquires]
    for callee, _ln in summary.top_self_calls:
        sub_b, sub_a = _method_closure(cls, callee, memo, active)
        blocking.extend((desc, (method,) + chain)
                        for desc, chain in sub_b)
        acquires.extend(sub_a)
    active.discard(method)
    # dedupe while keeping order stable
    blocking = list(dict.fromkeys(blocking))
    acquires = list(dict.fromkeys(acquires))
    memo[method] = (blocking, acquires)
    return memo[method]


def _resolve_deferred(ps: _PassState) -> None:
    """``self._method()`` calls made under a held lock inherit the
    callee's (transitively computed) blocking calls and lock
    acquisitions. Cross-object chains (``self.other.method()``) remain
    out of static scope — runtime checker territory."""
    memos: dict[tuple, dict] = {}
    for d in ps.deferred:
        cls = ps.classes.get((d.path, d.cls))
        if cls is None:
            continue
        memo = memos.setdefault((d.path, d.cls), {})
        blocking, acquires = _method_closure(cls, d.method, memo, set())
        for desc, chain in blocking:
            via = " -> ".join(f"self.{m}()" for m in chain)
            ps.finding(
                "LD101", d.path, d.line, d.caller,
                detail=f"{_short(d.held[-1])}|{'.'.join(chain)}:{desc}",
                message=(f"{via} makes blocking call {desc} while "
                         f"{', '.join(_short(h) for h in d.held)} "
                         f"is held here"))
        for lid in acquires:
            for held in d.held:
                if held != lid:
                    ps.add_edge(held, lid, d.path, d.line, d.caller)


def _emit_mixed_guard(ps: _PassState) -> None:
    skip_methods = ("__init__", "__post_init__")
    for (path, cls, attr), stores in sorted(ps.attr_stores.items()):
        live = [(u, ln, sym) for u, ln, sym in stores
                if not any(sym.endswith(m) for m in skip_methods)]
        under = [s for s in live if s[0]]
        outside = [s for s in live if not s[0]]
        if under and outside:
            _u, _uln, usym = under[0]
            _o, oln, osym = outside[0]
            ps.finding(
                "LD103", path, oln, f"{cls}",
                detail=attr,
                message=(f"self.{attr} is written under a lock in {usym} "
                         f"but without one in {osym} (first unguarded "
                         f"store shown); guard it or document why the "
                         f"race is benign"))


def _emit_cycles(ps: _PassState) -> None:
    # iterative Tarjan SCC over the static lock graph
    graph = {src: set(dsts) for src, dsts in ps.edges.items()}
    for dsts in list(graph.values()):
        for d in dsts:
            graph.setdefault(d, set())
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(graph[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for node in sorted(graph):
        if node not in index:
            strongconnect(node)

    for scc in sccs:
        path, line, symbol = min(
            ps.edges[src][dst]
            for src in scc for dst in ps.edges.get(src, {})
            if dst in scc)
        cyc = " -> ".join(_short(n) for n in scc)
        ps.finding(
            "LD102", path, line, symbol,
            detail="|".join(scc),
            message=(f"potential lock-order cycle: {cyc} (locks "
                     f"acquired in both orders somewhere in the tree); "
                     f"impose a single acquisition order"))
