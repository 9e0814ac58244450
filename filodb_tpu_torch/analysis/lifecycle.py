"""Resource-lifecycle pass (RL4xx): acquire/release pairs through
exception paths and call closures.

The PR-review shape this mechanizes is ``coordinator/remote.py``'s
``_roundtrip``: a socket checked out of the pool, used across calls that
can raise, and checked back in only on the straight-line path — a
``KeyboardInterrupt`` or an encode ``TypeError`` between checkout and
checkin leaks the socket forever. Four codes:

- **RL401 leak-on-exception** — a tracked resource (pool checkout,
  ``socket.create_connection``, bare ``open``, a local helper whose
  summary returns a fresh resource, an armed fault site) is live across
  a statement that can raise, and no ``with`` scope, ``finally``, or
  *broad* except handler (bare / ``Exception`` / ``BaseException``)
  releases it. Narrow handler tuples — ``except self.TRANSPORT_ERRORS``
  — deliberately do NOT count: that is exactly the remote.py bug, where
  only transport errors closed the socket.
- **RL402 resource-not-released** — a tracked resource is acquired and
  neither released (``close``/``shutdown``/``checkin``/release-helper)
  nor has its ownership transferred (returned, stored, passed to an
  unknown callee) anywhere in the function.
- **RL403 thread-not-joined** — a ``Thread`` is started without
  ``daemon=True`` and is never joined (locally or, for ``self.X``
  threads, anywhere in the class) and never escapes.
- **RL404 task-ack-outside-finally** — a ``.task_done()`` queue ack
  that is not lexically inside a ``finally`` block: an exception in the
  work body skips the ack and wedges ``queue.join()`` forever (the
  objectstore write-behind drain relies on ack-in-finally).

Interprocedural layer: per-module function summaries — *releases-param*
(``_close_quietly(sock)`` closes its argument, transitively through
local helpers) and *returns-fresh-resource* (``self._dial`` returns a
socket it created) — composed through memoized recursion, the same
shape as ``lockdiscipline``'s ``_method_closure``. Passing a resource
to a summarized local callee that does not release it is a borrow;
passing it to an unresolvable callee transfers ownership (silences the
finding) — conservative in the false-negative direction, so every
report is actionable.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from filodb_tpu_torch.analysis.model import Finding
from filodb_tpu_torch.analysis.runner import AnalysisContext, ModuleInfo

# --------------------------------------------------------------------------
# registries

# attribute calls that produce an owned resource regardless of receiver
ACQUIRE_ATTRS = {
    "checkout": "socket",           # _SocketPool.checkout
    "create_connection": "socket",  # socket.create_connection
}
# receiver-release: ``sock.close()``
RELEASE_ATTRS = {"close", "shutdown", "release"}
# argument-release: ``pool.checkin(key, sock)``, ``pool.drop(sock)``
RELEASE_ARG_ATTRS = {"checkin", "drop", "put_back"}
# broad except types whose release counts as exception-path protection
BROAD_HANDLERS = {"Exception", "BaseException"}


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


def _attr_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    return any(_attr_name(n) in BROAD_HANDLERS for n in names)


# --------------------------------------------------------------------------
# per-module function summaries

@dataclass
class _FnSummary:
    params: list[str]                      # without self/cls
    has_self: bool
    releases: set[str] = field(default_factory=set)  # param names released
    returns_kind: str | None = None        # fresh resource kind, if any


def _collect_functions(mi: ModuleInfo) -> dict[str, ast.FunctionDef]:
    """``{"fn": def, "Cls.meth": def}`` for top-level defs and methods."""
    out: dict[str, ast.FunctionDef] = {}
    for node in mi.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _params_of(fdef: ast.FunctionDef) -> tuple[list[str], bool]:
    names = [a.arg for a in fdef.args.args]
    has_self = bool(names) and names[0] in ("self", "cls")
    return (names[1:] if has_self else names), has_self


def _direct_acquire_kind(call: ast.Call) -> tuple[str, str] | None:
    """Registry-only acquisition classification (no summaries)."""
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id == "open":
        return "file", "open()"
    if isinstance(fn, ast.Attribute):
        if fn.attr in ACQUIRE_ATTRS:
            return ACQUIRE_ATTRS[fn.attr], f"{_src(fn)}()"
        if fn.attr == "socket" and isinstance(fn.value, ast.Name) \
                and fn.value.id == "socket":
            return "socket", "socket.socket()"
        if fn.attr == "arm":
            return "fault-site", f"{_src(fn)}()"
    return None


def _releases_of(fns: dict[str, ast.FunctionDef], key: str,
                 memo: dict, active: set) -> set[str]:
    """Param names ``key`` releases, expanded through local call chains
    (``_close_quietly`` -> ``sock.close``), cycles cut by ``active``."""
    if key in memo:
        return memo[key]
    if key in active:
        return set()
    fdef = fns.get(key)
    if fdef is None:
        memo[key] = set()
        return memo[key]
    active.add(key)
    params, _ = _params_of(fdef)
    pset = set(params)
    cls_prefix = key.rsplit(".", 1)[0] + "." if "." in key else None
    released: set[str] = set()
    for node in ast.walk(fdef):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in RELEASE_ATTRS and \
                    isinstance(fn.value, ast.Name) and fn.value.id in pset:
                released.add(fn.value.id)
            if fn.attr in RELEASE_ARG_ATTRS:
                released |= {a.id for a in node.args
                             if isinstance(a, ast.Name) and a.id in pset}
            callee_key = None
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                    and cls_prefix is not None:
                callee_key = cls_prefix + fn.attr
        elif isinstance(fn, ast.Name) and fn.id in fns:
            callee_key = fn.id
        else:
            continue
        if callee_key is not None and callee_key in fns:
            sub = _releases_of(fns, callee_key, memo, active)
            if sub:
                callee_params, _ = _params_of(fns[callee_key])
                for i, a in enumerate(node.args):
                    if isinstance(a, ast.Name) and a.id in pset \
                            and i < len(callee_params) \
                            and callee_params[i] in sub:
                        released.add(a.id)
    active.discard(key)
    memo[key] = released
    return released


def _returns_kind_of(fdef: ast.FunctionDef) -> str | None:
    """Does the function return a resource it freshly acquired?"""
    acquired: dict[str, str] = {}
    ret: str | None = None
    for node in ast.walk(fdef):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call):
            kind = _direct_acquire_kind(node.value)
            if kind is not None:
                acquired[node.targets[0].id] = kind[0]
        elif isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Name) and \
                    node.value.id in acquired:
                ret = acquired[node.value.id]
            elif isinstance(node.value, ast.Call):
                kind = _direct_acquire_kind(node.value)
                if kind is not None:
                    ret = kind[0]
    return ret


def _build_summaries(mi: ModuleInfo) -> dict[str, _FnSummary]:
    fns = _collect_functions(mi)
    memo: dict[str, set] = {}
    out: dict[str, _FnSummary] = {}
    for key, fdef in fns.items():
        params, has_self = _params_of(fdef)
        out[key] = _FnSummary(
            params=params, has_self=has_self,
            releases=_releases_of(fns, key, memo, set()),
            returns_kind=_returns_kind_of(fdef))
    return out


# --------------------------------------------------------------------------
# leak walk (RL401/RL402)

@dataclass
class _Res:
    name: str
    kind: str
    desc: str          # acquisition expression, line-free
    line: int
    released: bool = False
    escaped: bool = False
    exposure: tuple | None = None   # (line, risky statement text)


class _LeakWalker:
    """Ordered statement walk of one function body. Tracks live owned
    resources per local name, the lexically-protected name set (``with``
    scope on the resource, ``finally`` release, broad-except release),
    and records the first unprotected may-raise exposure per resource."""

    def __init__(self, ps: "_PassState", mi: ModuleInfo, symbol: str,
                 summaries: dict[str, _FnSummary], cls_name: str | None):
        self.ps = ps
        self.mi = mi
        self.symbol = symbol
        self.summaries = summaries
        self.cls_name = cls_name
        self.live: dict[str, list[_Res]] = {}
        self.all: list[_Res] = []

    # ---- classification helpers

    def _summary_for_call(self, fn: ast.AST) -> _FnSummary | None:
        if isinstance(fn, ast.Name):
            return self.summaries.get(fn.id)
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                and self.cls_name is not None:
            return self.summaries.get(f"{self.cls_name}.{fn.attr}")
        return None

    def _acquire_from(self, value: ast.AST) -> tuple[str, str] | None:
        if not isinstance(value, ast.Call):
            return None
        direct = _direct_acquire_kind(value)
        if direct is not None:
            return direct
        summ = self._summary_for_call(value.func)
        if summ is not None and summ.returns_kind is not None:
            return summ.returns_kind, f"{_src(value.func)}()"
        return None

    def _released_names(self, stmt: ast.AST) -> set[str]:
        out: set[str] = set()
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in RELEASE_ATTRS and \
                        isinstance(fn.value, ast.Name):
                    out.add(fn.value.id)
                if fn.attr in RELEASE_ARG_ATTRS:
                    out |= {a.id for a in node.args
                            if isinstance(a, ast.Name)}
                if fn.attr == "reset":
                    # FaultInjector.reset() disarms every live fault site
                    out |= {n for n, rs in self.live.items()
                            if any(r.kind == "fault-site" for r in rs)}
            summ = self._summary_for_call(fn)
            if summ is not None and summ.releases:
                for i, a in enumerate(node.args):
                    if isinstance(a, ast.Name) and i < len(summ.params) \
                            and summ.params[i] in summ.releases:
                        out.add(a.id)
        return out

    def _escapes_in(self, stmt: ast.AST, name: str) -> bool:
        parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(stmt):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and node.id == name and \
                    isinstance(node.ctx, ast.Load):
                if self._use_escapes(node, parents):
                    return True
        return False

    def _use_escapes(self, node: ast.AST, parents: dict) -> bool:
        p = parents.get(node)
        if isinstance(p, ast.keyword):
            p = parents.get(p)
        if isinstance(p, ast.Attribute):
            return False                       # sock.settimeout(...)
        if isinstance(p, ast.Call):
            fn = p.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in RELEASE_ARG_ATTRS:
                return False                   # release, handled already
            if self._summary_for_call(fn) is not None:
                return False                   # borrow by a local callee
            return True                        # unknown callee: transfer
        if isinstance(p, (ast.Compare, ast.BoolOp, ast.UnaryOp)):
            return False                       # ``if sock is None``
        if isinstance(p, (ast.If, ast.While)):
            return False                       # bare test position
        if isinstance(p, ast.withitem):
            return False                       # ``with sock:`` = release
        if isinstance(p, ast.Expr):
            return False
        return True    # return/store/append/subscript/yield/...

    # ---- statement dispatch

    def run(self, body: list) -> None:
        self._block(body, frozenset())
        for res in self.all:
            if not res.released and not res.escaped:
                self.ps.finding(
                    "RL402", self.mi.path, res.line, self.symbol,
                    detail=f"{res.name}|{res.desc}",
                    message=(f"{res.kind} '{res.name}' from {res.desc} is "
                             f"never released (no close/checkin/shutdown "
                             f"on any path) and never escapes this "
                             f"function"))
            elif res.exposure is not None:
                eline, edesc = res.exposure
                self.ps.finding(
                    "RL401", self.mi.path, eline, self.symbol,
                    detail=f"{res.name}|{res.desc}",
                    message=(f"{res.kind} '{res.name}' from {res.desc} "
                             f"leaks if `{edesc}` raises: no with-scope, "
                             f"finally, or broad except handler releases "
                             f"it on the exception path (narrow handler "
                             f"tuples do not cover e.g. KeyboardInterrupt "
                             f"or encode errors)"))

    def _block(self, stmts: list, protected: frozenset) -> None:
        for stmt in stmts:
            self._stmt(stmt, protected)

    def _stmt(self, stmt: ast.stmt, protected: frozenset) -> None:
        if isinstance(stmt, ast.Try):
            self._try(stmt, protected)
        elif isinstance(stmt, ast.If):
            self._if(stmt, protected)
        elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            self._effects(stmt, protected, header_only=True)
            self._block(stmt.body, protected)
            self._block(stmt.orelse, protected)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._with(stmt, protected)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef, ast.Lambda)):
            # nested scope: a captured resource's lifetime leaves this
            # frame — ownership transfer
            for name, rs in list(self.live.items()):
                if any(isinstance(n, ast.Name) and n.id == name
                       for n in ast.walk(stmt)):
                    for r in rs:
                        r.escaped = True
                    self.live.pop(name, None)
        else:
            self._effects(stmt, protected)

    def _effects(self, stmt: ast.stmt, protected: frozenset,
                 header_only: bool = False) -> None:
        # 1. releases
        scan = stmt
        if header_only:
            # loop headers: only the test/iter expression, not the body
            scan = stmt.test if isinstance(stmt, ast.While) else stmt.iter
        for n in self._released_names(scan):
            for r in self.live.pop(n, ()):  # any-path release semantics
                r.released = True
        # 2. escapes
        for n, rs in list(self.live.items()):
            if self._escapes_in(scan, n):
                for r in rs:
                    r.escaped = True
                self.live.pop(n, None)
        # 3. may-raise exposure for the still-live, unprotected names
        may_raise = isinstance(stmt, ast.Raise) or any(
            isinstance(x, ast.Call) for x in ast.walk(scan))
        if may_raise:
            for n, rs in self.live.items():
                if n in protected:
                    continue
                for r in rs:
                    if r.exposure is None:
                        r.exposure = (stmt.lineno,
                                      _src(scan).split("\n")[0][:80])
        # 4. acquisitions bind last (the bound name is live AFTER the
        #    acquiring statement)
        if not header_only and isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            value = stmt.value
            if value is not None and len(targets) == 1 and \
                    isinstance(targets[0], ast.Name):
                acq = self._acquire_from(value)
                if acq is not None:
                    kind, desc = acq
                    res = _Res(targets[0].id, kind, desc, stmt.lineno)
                    self.all.append(res)
                    self.live[targets[0].id] = [res]

    @staticmethod
    def _none_tested(test: ast.AST) -> tuple[set[str], set[str]]:
        """Names known None in the body / in the orelse."""
        body_none: set[str] = set()
        orelse_none: set[str] = set()
        if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
                isinstance(test.left, ast.Name) and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value is None:
            if isinstance(test.ops[0], ast.Is):
                body_none.add(test.left.id)
            elif isinstance(test.ops[0], ast.IsNot):
                orelse_none.add(test.left.id)
        elif isinstance(test, ast.UnaryOp) and \
                isinstance(test.op, ast.Not) and \
                isinstance(test.operand, ast.Name):
            body_none.add(test.operand.id)
        return body_none, orelse_none

    def _if(self, node: ast.If, protected: frozenset) -> None:
        # the test itself may raise (attribute/call in the condition)
        if any(isinstance(x, ast.Call) for x in ast.walk(node.test)):
            for n, rs in self.live.items():
                if n in protected:
                    continue
                for r in rs:
                    if r.exposure is None:
                        r.exposure = (node.lineno,
                                      _src(node.test).split("\n")[0][:80])
        body_none, orelse_none = self._none_tested(node.test)
        base = {k: list(v) for k, v in self.live.items()}
        for n in body_none:
            self.live.pop(n, None)   # ``if sock is None:`` — not live here
        self._block(node.body, protected)
        after_body = self.live
        self.live = {k: list(v) for k, v in base.items()}
        for n in orelse_none:
            self.live.pop(n, None)
        self._block(node.orelse, protected)
        merged: dict[str, list[_Res]] = {}
        for branch in (after_body, self.live):
            for k, rs in branch.items():
                out = merged.setdefault(k, [])
                for r in rs:
                    if r not in out and not r.released and not r.escaped:
                        out.append(r)
        self.live = {k: v for k, v in merged.items() if v}

    def _try(self, node: ast.Try, protected: frozenset) -> None:
        fin_released: set[str] = set()
        for s in node.finalbody:
            fin_released |= self._released_names(s)
        broad_released: set[str] = set()
        for h in node.handlers:
            if _is_broad_handler(h):
                for s in h.body:
                    broad_released |= self._released_names(s)
        self._block(node.body, protected | fin_released | broad_released)
        self._block(node.orelse, protected | fin_released)
        # handlers run on the exception path: isolated live view, so a
        # narrow handler's close counts as "released somewhere" (no
        # RL402) without ending the main path's liveness (RL401 stays)
        saved = {k: list(v) for k, v in self.live.items()}
        for h in node.handlers:
            self.live = {k: list(v) for k, v in saved.items()}
            self._block(h.body, protected | fin_released)
        self.live = saved
        self._block(node.finalbody, protected)

    def _with(self, node: ast.With, protected: frozenset) -> None:
        prot = set(protected)
        for item in node.items:
            ce = item.context_expr
            if self._acquire_from(ce) is not None:
                # ``with open(p) as f:`` — fully managed, never tracked
                continue
            name = None
            if isinstance(ce, ast.Name):
                name = ce.id                    # ``with sock:``
            elif isinstance(ce, ast.Call) and \
                    _attr_name(ce.func) == "closing" and ce.args and \
                    isinstance(ce.args[0], ast.Name):
                name = ce.args[0].id            # contextlib.closing(sock)
            if name is not None and name in self.live:
                for r in self.live.pop(name):
                    r.released = True
                prot.add(name)
            elif isinstance(ce, ast.Call):
                # other context managers may raise on __enter__
                for n, rs in self.live.items():
                    if n in prot:
                        continue
                    for r in rs:
                        if r.exposure is None:
                            r.exposure = (node.lineno,
                                          _src(ce).split("\n")[0][:80])
        self._block(node.body, frozenset(prot))


# --------------------------------------------------------------------------
# RL403 threads / RL404 queue acks

def _thread_call(call: ast.Call) -> bool | None:
    """None if not a Thread creation; else its daemon flag."""
    name = _attr_name(call.func)
    if name != "Thread":
        return None
    for kw in call.keywords:
        if kw.arg == "daemon":
            return isinstance(kw.value, ast.Constant) and \
                bool(kw.value.value)
    return False


def _scan_threads(ps: "_PassState", mi: ModuleInfo, symbol: str,
                  fdef: ast.FunctionDef) -> None:
    local: dict[str, tuple[int, str]] = {}       # name -> (line, desc)
    self_attrs: dict[str, tuple[int, str]] = {}  # self.X -> (line, desc)
    for node in ast.walk(fdef):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.value, ast.Call):
            daemon = _thread_call(node.value)
            if daemon is None or daemon:
                continue
            t = node.targets[0]
            if isinstance(t, ast.Name):
                local[t.id] = (node.lineno, _src(node.value.func))
            elif isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                self_attrs[t.attr] = (node.lineno, _src(node.value.func))
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            # Thread(...).start() — fire-and-forget, no binding
            fn = node.value.func
            if isinstance(fn, ast.Attribute) and fn.attr == "start" and \
                    isinstance(fn.value, ast.Call) and \
                    _thread_call(fn.value) is False:
                ps.finding(
                    "RL403", mi.path, node.lineno, symbol,
                    detail=f"<anon>|{_src(fn.value.func)}",
                    message=("thread started without daemon=True and "
                             "never joined: a hung worker blocks "
                             "interpreter shutdown forever"))
    for name, (line, desc) in local.items():
        started = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "start"
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == name for n in ast.walk(fdef))
        if not started:
            continue
        joined = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "join"
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == name for n in ast.walk(fdef))
        daemon_set = any(
            isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Attribute) and t.attr == "daemon"
                    and isinstance(t.value, ast.Name)
                    and t.value.id == name for t in n.targets)
            for n in ast.walk(fdef))
        escaped = any(
            isinstance(n, ast.Return) and isinstance(n.value, ast.Name)
            and n.value.id == name for n in ast.walk(fdef)) or any(
            isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Name) and n.value.id == name
            for n in ast.walk(fdef))
        if not joined and not daemon_set and not escaped:
            ps.finding(
                "RL403", mi.path, line, symbol,
                detail=f"{name}|{desc}",
                message=(f"thread '{name}' started without daemon=True "
                         f"and never joined in this function: a hung "
                         f"worker blocks interpreter shutdown forever"))
    if self_attrs:
        ps.pending_self_threads.append((mi, symbol, self_attrs))


def _resolve_self_threads(ps: "_PassState",
                          class_bodies: dict) -> None:
    """``self.X = Thread(...)`` without daemon: the class must join it
    somewhere (any method) or set ``self.X.daemon``."""
    for mi, symbol, attrs in ps.pending_self_threads:
        cls = symbol.split(".", 1)[0]
        cdef = class_bodies.get((mi.path, cls))
        joined: set[str] = set()
        daemon_set: set[str] = set()
        if cdef is not None:
            for node in ast.walk(cdef):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "join":
                    v = node.func.value
                    if isinstance(v, ast.Attribute) and \
                            isinstance(v.value, ast.Name) and \
                            v.value.id == "self":
                        joined.add(v.attr)
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                t.attr == "daemon" and \
                                isinstance(t.value, ast.Attribute) and \
                                isinstance(t.value.value, ast.Name) and \
                                t.value.value.id == "self":
                            daemon_set.add(t.value.attr)
        for attr, (line, desc) in attrs.items():
            if attr in joined or attr in daemon_set:
                continue
            ps.finding(
                "RL403", mi.path, line, symbol,
                detail=f"self.{attr}|{desc}",
                message=(f"thread 'self.{attr}' is created without "
                         f"daemon=True and no method of {cls} joins it "
                         f"or sets .daemon: shutdown hangs on it"))


def _scan_task_done(ps: "_PassState", mi: ModuleInfo, symbol: str,
                    fdef: ast.FunctionDef) -> None:
    def emit(node: ast.Call) -> None:
        ps.finding(
            "RL404", mi.path, node.lineno, symbol,
            detail=_src(node.func),
            message=(f"{_src(node.func)}() is not inside a finally "
                     f"block: an exception in the work body skips the "
                     f"ack and wedges queue.join() forever"))

    def check_exprs(roots, in_finally: bool) -> None:
        if in_finally:
            return
        for root in roots:
            for node in ast.walk(root):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "task_done":
                    emit(node)

    def visit(stmts, in_finally: bool) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Try):
                visit(stmt.body, in_finally)
                for h in stmt.handlers:
                    visit(h.body, in_finally)
                visit(stmt.orelse, in_finally)
                visit(stmt.finalbody, True)
            elif isinstance(stmt, (ast.If, ast.While, ast.For, ast.With,
                                   ast.AsyncWith, ast.AsyncFor)):
                headers = [getattr(stmt, a) for a in
                           ("test", "iter") if hasattr(stmt, a)]
                for item in getattr(stmt, "items", []):
                    headers.append(item.context_expr)
                check_exprs(headers, in_finally)
                visit(stmt.body, in_finally)
                visit(getattr(stmt, "orelse", []), in_finally)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue  # nested scope scanned separately
            else:
                check_exprs([stmt], in_finally)

    visit(fdef.body, False)


# --------------------------------------------------------------------------
# driver

@dataclass
class _PassState:
    findings: list = field(default_factory=list)
    pending_self_threads: list = field(default_factory=list)

    def finding(self, code, path, line, symbol, detail, message):
        self.findings.append(Finding(code, path, line, symbol, detail,
                                     message))


def run(ctx: AnalysisContext) -> list[Finding]:
    ps = _PassState()
    class_bodies: dict[tuple[str, str], ast.ClassDef] = {}
    for mi in ctx.modules:
        for node in mi.tree.body:
            if isinstance(node, ast.ClassDef):
                class_bodies[(mi.path, node.name)] = node
    for mi in ctx.modules:
        summaries = _build_summaries(mi)

        def walk_fn(fdef, cls_name, symbol):
            w = _LeakWalker(ps, mi, symbol, summaries, cls_name)
            w.run(fdef.body)
            _scan_threads(ps, mi, symbol, fdef)
            _scan_task_done(ps, mi, symbol, fdef)

        for node in mi.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(node, None, node.name)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        walk_fn(sub, node.name,
                                f"{node.name}.{sub.name}")
    _resolve_self_threads(ps, class_bodies)
    return ps.findings
