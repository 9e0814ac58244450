"""Hot-path hygiene pass for the port's device programs.

Inside a device program a host sync (``.item()``, ``.cpu()``,
``torch.cuda.synchronize()``, ``np.asarray`` on a tensor) forces a
round-trip between the card and the host on every call, which is exactly
the per-step transfer cost the batched design exists to avoid; Python-side
``time``/``random`` calls inside one make its answer depend on when it
ran.

- **HP301 host-sync-in-kernel**: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``torch.cuda.synchronize()``, ``np.asarray``/``np.array``/
  ``np.frombuffer``, and ``float()``/``int()``/``bool()`` applied to an
  attribute/subscript expression (plain-``Name`` casts are skipped:
  they are usually static args, and flagging them would drown the pass
  in false positives).
- **HP302 wallclock-in-kernel**: ``time.*``, ``random.*``,
  ``np.random.*`` calls.

In the port a function counts as a kernel when it is

- the function a program factory returns: a top-level ``make_*``
  function that returns a function defined inside it (the factory idiom
  ``parallel/dist_query.py`` builds its programs with, the reference's
  call-form ``jit(fn)`` / ``shard_map(fn, ...)``);
- the ``forward`` or ``backward`` of a ``torch.autograd.Function``;
- decorated ``@triton.jit`` (or any ``@jit``);

or when it is lexically nested inside a kernel.

The pass covers ``query/engine/`` and ``parallel/``, where the device
programs live.
"""

from __future__ import annotations

import ast

from filodb_tpu_torch.analysis.model import Finding
from filodb_tpu_torch.analysis.runner import AnalysisContext

ENGINE_PREFIXES = ("filodb_tpu_torch/query/engine/", "filodb_tpu_torch/parallel/")

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array", "frombuffer"}
_CAST_FUNCS = {"float", "int", "bool"}
_CLOCK_MODULES = {"time", "random"}


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


def _is_jit_decorator(dec: ast.AST) -> bool:
    # @triton.jit / @jit
    if isinstance(dec, ast.Attribute) and dec.attr == "jit":
        return True
    if isinstance(dec, ast.Name) and dec.id == "jit":
        return True
    # @partial(triton.jit, ...) / @triton.jit(...) / @jit(...)
    if isinstance(dec, ast.Call):
        fn = dec.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if fname == "jit":
            return True
        if fname == "partial" and dec.args:
            return _is_jit_decorator(dec.args[0])
    return False


def _factory_kernel_names(fdef: ast.FunctionDef) -> set[str]:
    """The functions a ``make_*`` program factory defines and returns."""
    if not fdef.name.startswith("make_"):
        return set()
    nested = {n.name for n in fdef.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    returned = {n.value.id for n in ast.walk(fdef)
                if isinstance(n, ast.Return)
                and isinstance(n.value, ast.Name)}
    return nested & returned


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    """A subclass of ``torch.autograd.Function`` (or of a ``Function``
    imported from it)."""
    for base in cls.bases:
        if isinstance(base, ast.Attribute) and base.attr == "Function":
            return True
        if isinstance(base, ast.Name) and base.id == "Function":
            return True
    return False


class _KernelWalker(ast.NodeVisitor):
    def __init__(self, path: str, symbol: str, out: list[Finding]):
        self.path = path
        self.symbol = symbol
        self.out = out

    def _finding(self, code: str, node: ast.AST, detail: str,
                 message: str) -> None:
        self.out.append(Finding(code, self.path, node.lineno,
                                self.symbol, detail, message))

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            recv_root = recv
            while isinstance(recv_root, ast.Attribute):
                recv_root = recv_root.value
            root_name = recv_root.id if isinstance(recv_root, ast.Name) \
                else None
            if fn.attr == "synchronize" and _src(recv) == "torch.cuda":
                self._finding(
                    "HP301", node, "torch.cuda.synchronize",
                    "torch.cuda.synchronize() waits for the card inside a "
                    "device program")
            elif fn.attr in _SYNC_METHODS:
                self._finding(
                    "HP301", node, f"{fn.attr}:{_src(recv)}",
                    f"host sync .{fn.attr}() on {_src(recv)} inside a "
                    f"device program")
            elif root_name == "np" and fn.attr in _NP_SYNC_FUNCS:
                self._finding(
                    "HP301", node, f"np.{fn.attr}:{_src(node.args[0]) if node.args else ''}",
                    f"np.{fn.attr}(...) materializes on host inside a "
                    f"device program; use torch or hoist it out")
            elif root_name in _CLOCK_MODULES or (
                    root_name == "np" and isinstance(recv, ast.Attribute)
                    and recv.attr == "random"):
                self._finding(
                    "HP302", node, f"{_src(fn)}",
                    f"{_src(fn)}() inside a device program makes its "
                    f"answer depend on when it ran; pass values in as "
                    f"arguments instead")
        elif isinstance(fn, ast.Name) and fn.id in _CAST_FUNCS and \
                node.args and isinstance(node.args[0],
                                         (ast.Attribute, ast.Subscript)):
            self._finding(
                "HP301", node, f"{fn.id}:{_src(node.args[0])}",
                f"{fn.id}({_src(node.args[0])}) forces a host sync "
                f"inside a device program")
        self.generic_visit(node)

    # nested defs are scanned separately (with their own symbol) by the
    # scope walk in run(); don't double-report them here
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


def run(ctx: AnalysisContext) -> list[Finding]:
    out: list[Finding] = []
    for mi in ctx.modules:
        if not mi.path.startswith(ENGINE_PREFIXES):
            continue

        def scan(fdef: ast.FunctionDef, symbol: str) -> None:
            w = _KernelWalker(mi.path, symbol, out)
            for stmt in fdef.body:
                w.visit(stmt)

        def visit_scope(body, prefix: str, inside_kernel: bool,
                        kernels: set, autograd: bool = False) -> None:
            for node in body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    sym = f"{prefix}{node.name}"
                    is_kernel = (inside_kernel
                                 or node.name in kernels
                                 or (autograd and node.name
                                     in ("forward", "backward"))
                                 or any(_is_jit_decorator(d)
                                        for d in node.decorator_list))
                    if is_kernel:
                        scan(node, sym)
                    # nested defs inherit kernel-ness lexically; a
                    # factory's returned defs are kernels
                    visit_scope(node.body, f"{sym}.", is_kernel,
                                _factory_kernel_names(node))
                elif isinstance(node, ast.ClassDef):
                    visit_scope(node.body, f"{node.name}.",
                                inside_kernel, set(),
                                _is_autograd_function(node))

        visit_scope(mi.tree.body, "", False, set())
    return out
