"""Adaptive-decision settle-parity pass (DC601).

The trace-driven planner (``query/cost_model.py``) only stays
calibrated if every routed decision is eventually *settled* with the
observed wall time: a ``decide()``/``classify()`` call whose outcome is
never fed back leaves that arm's estimate frozen at whatever it last
learned, silently mis-routing every future query with that signature.
That failure mode is invisible at the decision site — the query still
returns the right answer — so it is exactly the kind of defect this
package exists to move from review into CI.

DC601: a function that calls ``.decide(...)`` or ``.classify(...)`` on
a cost model must, in the same function, do one of:

- call ``.record_actual(...)`` (inline settle, e.g. tier paging);
- call ``.defer(...)`` (carrier hand-off; settled later by
  ``settle_deferred`` at the timing boundary, e.g. the sidecar gate);
- ``return`` the name the decision was bound to (explicit hand-off to
  the caller, which then owns the settle — e.g. the lane router's
  ``_shared_decision``).

Static approximations: receiver types are not resolved — any
``.decide``/``.classify`` attribute call counts, which is fine in this
tree because only the cost model exposes those names; the return
hand-off matches any ``return`` whose expression mentions a name bound
from the decision call (covers ``return d.arm, d, model``). The model's
own module is exempt — it constructs ``Decision`` objects internally.
"""

from __future__ import annotations

import ast

from filodb_tpu_torch.analysis.model import Finding
from filodb_tpu_torch.analysis.runner import AnalysisContext

_DECIDE_ATTRS = ("decide", "classify")
_SETTLE_ATTRS = ("record_actual", "defer")
_EXEMPT = ("filodb_tpu_torch/query/cost_model.py",)


def _attr_name(node: ast.Call) -> str | None:
    return node.func.attr if isinstance(node.func, ast.Attribute) else None


def _own_nodes(fn: ast.AST):
    """Walk a function body without descending into nested defs, so a
    decision made in a closure is attributed to the closure."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _check_function(fn, symbol: str, path: str, out: list[Finding]) -> None:
    decides: list[tuple[int, str]] = []      # (line, detail)
    bound: set[str] = set()                  # names assigned from decide()
    settled = False
    returned: set[str] = set()               # names mentioned in returns

    for node in _own_nodes(fn):
        if isinstance(node, ast.Call):
            attr = _attr_name(node)
            if attr in _DECIDE_ATTRS:
                site = node.args[0].value if node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) else attr
                decides.append((node.lineno, f"{attr}:{site}"))
            elif attr in _SETTLE_ATTRS:
                settled = True
        elif isinstance(node, ast.Assign):
            if isinstance(node.value, ast.Call) and \
                    _attr_name(node.value) in _DECIDE_ATTRS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        bound.add(t.id)
        elif isinstance(node, ast.Return) and node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    returned.add(sub.id)

    if not decides or settled or bound & returned:
        return
    for line, detail in decides:
        out.append(Finding(
            "DC601", path, line, symbol, detail,
            f"{detail.split(':', 1)[0]}() routes by learned cost but this "
            f"function neither settles the decision (record_actual/defer) "
            f"nor returns it to a caller that could — the arm's estimate "
            f"never updates and the model drifts"))


def run(ctx: AnalysisContext) -> list[Finding]:
    out: list[Finding] = []
    for mi in ctx.modules:
        if mi.path in _EXEMPT:
            continue

        def walk(node, symbol):
            for child in ast.iter_child_nodes(node):
                sym = symbol
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    sym = f"{symbol}.{child.name}" \
                        if symbol not in ("<module>",) else child.name
                    _check_function(child, sym, mi.path, out)
                elif isinstance(child, ast.ClassDef):
                    sym = child.name
                walk(child, sym)

        walk(mi.tree, "<module>")
    return out
