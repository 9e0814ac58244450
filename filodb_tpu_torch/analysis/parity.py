"""Invariant/registry parity pass.

In the port the wire registry is the port's ``coordinator/wire.py`` and
the scrape-test lists are the reference's ``tests/test_metrics_scrape.py``
(the port has none of its own), read as source and never imported: the
port's ``filodb_*`` families are held to the reference's names.

Two registries in this tree are correctness-critical and historically
hand-maintained:

- the **wire registry** (``coordinator/wire.py``): decode instantiates
  only registered classes, so a dataclass that rides inside a
  registered class but is itself unregistered fails at runtime, on the
  first frame that carries it (PR201); a registry entry naming a class
  that no longer exists is dead weight and hides typos (PR202);
- the **scrape-test name lists** (``tests/test_metrics_scrape.py``):
  the breadth test asserts exposition families by name, so a metric
  created at import time but missing from the lists is silently
  untested (PR203), and a listed name nothing produces any more is a
  stale assertion waiting to fail (PR204).

PR205 checks every metric name literal against the Prometheus data-model
charset (``[a-zA-Z_:][a-zA-Z0-9_:]*``).

PR206 hardens the freshness-telemetry families: any metric whose name
starts with ``filodb_ingest_`` or ``filodb_selfmon_`` must appear in the
scrape-test lists REGARDLESS of the lazy/GaugeFn exemptions PR203 grants
— these series are the self-monitoring substrate (``_meta`` dataset,
default lag alerts), so an unasserted family here means the monitoring
of the monitor is untested.

PR207 extends the same no-exemption treatment to the aggregate-pyramid
families (``filodb_pyramid_``): the cold-tier zero-payload guarantee is
asserted through these counters (``core/store/pyramid.py``,
``query/engine/pyramid_lane.py``), and they all register when
objectstore imports pyramid at boot, so every family must be pinned in
the scrape test.

Static approximations: the wire walk mirrors ``_build_registry`` by
reading its two loops from the AST (explicit tuple + subclass-walked
bases) and closing over AST-declared subclasses; metric creations made
lazily inside functions are exempt from PR203 (they register on first
use, which the breadth test cannot see) but still count as producers
for PR204.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from filodb_tpu_torch.analysis.model import Finding
from filodb_tpu_torch.analysis.runner import AnalysisContext

_METRIC_FACTORIES = {
    # factory -> exposition-name suffixes rendered for base name N
    "Counter": ("_total",),
    "get_counter": ("_total",),
    "Gauge": ("",),
    "get_gauge": ("",),
    "GaugeFn": ("",),
    "Histogram": ("_bucket", "_count", "_sum"),
}

_PROM_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


@dataclass
class _MetricSite:
    name: str
    path: str
    line: int
    symbol: str
    factory: str
    module_level: bool

    @property
    def exposed(self) -> list[str]:
        return [self.name + sfx
                for sfx in _METRIC_FACTORIES[self.factory]]


def _call_factory(node: ast.Call) -> str | None:
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    return name if name in _METRIC_FACTORIES else None


def _collect_metric_sites(ctx: AnalysisContext) -> list[_MetricSite]:
    sites: list[_MetricSite] = []

    def walk(node, path, symbol, in_function):
        for child in ast.iter_child_nodes(node):
            sym, in_fn = symbol, in_function
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                sym = f"{symbol}.{child.name}" if symbol != "<module>" \
                    else child.name
                in_fn = True
            elif isinstance(child, ast.Lambda):
                in_fn = True
            elif isinstance(child, ast.ClassDef):
                sym = child.name
            elif isinstance(child, ast.Call):
                factory = _call_factory(child)
                if factory and child.args and \
                        isinstance(child.args[0], ast.Constant) and \
                        isinstance(child.args[0].value, str):
                    sites.append(_MetricSite(
                        child.args[0].value, path, child.lineno,
                        symbol, factory, not in_function))
            walk(child, path, sym, in_fn)

    for mi in ctx.modules:
        walk(mi.tree, mi.path, "<module>", False)
    return sites


# --------------------------------------------------------------------------
# wire registry

@dataclass
class _WireDecl:
    explicit: list          # [(name, line)] from the `for cls in (...)` loop
    bases: list             # [name] from the subclass-walk loop
    line: int = 0


def _parse_registry(ctx: AnalysisContext) -> _WireDecl | None:
    mi = ctx.module(ctx.wire_module)
    if mi is None:
        return None
    fn = next((n for n in mi.tree.body
               if isinstance(n, ast.FunctionDef)
               and n.name == "_build_registry"), None)
    if fn is None:
        return None
    decl = _WireDecl([], [], fn.lineno)

    def names_of(it):
        out = []
        if isinstance(it, ast.Tuple):
            for e in it.elts:
                if isinstance(e, ast.Name):
                    out.append((e.id, e.lineno))
                elif isinstance(e, ast.Attribute):
                    out.append((e.attr, e.lineno))
        return out

    for node in ast.walk(fn):
        if isinstance(node, ast.For) and \
                isinstance(node.target, ast.Name):
            if node.target.id == "cls":
                decl.explicit.extend(names_of(node.iter))
            elif node.target.id == "base":
                decl.bases.extend(n for n, _ in names_of(node.iter))
    return decl


@dataclass
class _ClassDecl:
    name: str
    path: str
    line: int
    bases: list
    is_dataclass: bool
    has_wire_fields: bool
    field_type_names: set = field(default_factory=set)


def _index_classes(ctx: AnalysisContext) -> dict[str, _ClassDecl]:
    idx: dict[str, _ClassDecl] = {}
    for mi in ctx.modules:
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            base_names = []
            for b in node.bases:
                if isinstance(b, ast.Name):
                    base_names.append(b.id)
                elif isinstance(b, ast.Attribute):
                    base_names.append(b.attr)
            is_dc = any(
                (isinstance(d, ast.Name) and d.id == "dataclass")
                or (isinstance(d, ast.Attribute) and d.attr == "dataclass")
                or (isinstance(d, ast.Call) and _decname(d.func)
                    == "dataclass")
                for d in node.decorator_list)
            has_wf = any(
                isinstance(s, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__wire_fields__"
                    for t in s.targets)
                for s in node.body)
            types: set[str] = set()
            for s in node.body:
                if isinstance(s, ast.AnnAssign):
                    for sub in ast.walk(s.annotation):
                        if isinstance(sub, ast.Name):
                            types.add(sub.id)
                        elif isinstance(sub, ast.Attribute):
                            types.add(sub.attr)
                        elif isinstance(sub, ast.Constant) and \
                                isinstance(sub.value, str):
                            # string annotation: pull identifiers
                            types.update(re.findall(r"[A-Za-z_]\w*",
                                                    sub.value))
            # first definition wins; duplicates across modules are rare
            idx.setdefault(node.name, _ClassDecl(
                node.name, mi.path, node.lineno, base_names, is_dc,
                has_wf, types))
    return idx


def _registered_closure(decl: _WireDecl,
                        classes: dict[str, _ClassDecl]) -> set[str]:
    reg = {n for n, _ in decl.explicit} | set(decl.bases)
    children: dict[str, set[str]] = {}
    for c in classes.values():
        for b in c.bases:
            children.setdefault(b, set()).add(c.name)
    frontier = list(decl.bases)
    while frontier:
        cur = frontier.pop()
        for kid in children.get(cur, ()):
            if kid not in reg:
                reg.add(kid)
                frontier.append(kid)
    return reg


def _check_wire(ctx: AnalysisContext, out: list[Finding]) -> None:
    decl = _parse_registry(ctx)
    if decl is None:
        out.append(Finding(
            "PR202", ctx.wire_module, 1, "<module>", "_build_registry",
            "could not locate _build_registry(); wire parity unchecked"))
        return
    classes = _index_classes(ctx)
    registered = _registered_closure(decl, classes)

    for name, line in decl.explicit:
        if name not in classes:
            out.append(Finding(
                "PR202", ctx.wire_module, line, "_build_registry", name,
                f"registry names {name} but no class of that name "
                f"exists in the package"))

    # closure: field annotations of registered classes must resolve to
    # registered classes whenever they name a package dataclass
    for name in sorted(registered):
        c = classes.get(name)
        if c is None:
            continue
        for t in sorted(c.field_type_names):
            ref = classes.get(t)
            if ref is None or t in registered or t == name:
                continue
            if ref.is_dataclass or ref.has_wire_fields:
                out.append(Finding(
                    "PR201", ref.path, ref.line, ref.name, ref.name,
                    f"{ref.name} is carried in wire-registered "
                    f"{name}.{'<field>'} but is not itself registered "
                    f"in coordinator/wire.py"))

    # a class declaring __wire_fields__ has exactly one purpose — ship
    # on the wire — so an unregistered one is always a bug
    for c in classes.values():
        if c.has_wire_fields and c.name not in registered:
            out.append(Finding(
                "PR201", c.path, c.line, c.name, c.name,
                f"{c.name} declares __wire_fields__ but is not "
                f"registered in coordinator/wire.py"))


# --------------------------------------------------------------------------
# metric parity

def _scrape_expected(ctx: AnalysisContext) -> tuple[set[str], int] | None:
    mi = ctx.read(ctx.scrape_test)
    if mi is None:
        return None
    names: set[str] = set()
    first_line = 1
    for node in mi.tree.body:
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.List)):
            continue
        elts = node.value.elts
        if not elts or not all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in elts):
            continue
        first_line = first_line if names else node.lineno
        names.update(e.value for e in elts)
    return names, first_line


def _check_metrics(ctx: AnalysisContext, out: list[Finding]) -> None:
    sites = _collect_metric_sites(ctx)

    for s in sites:
        if not _PROM_NAME_RE.match(s.name):
            out.append(Finding(
                "PR205", s.path, s.line, s.symbol, s.name,
                f"metric name {s.name!r} violates the Prometheus "
                f"charset [a-zA-Z_:][a-zA-Z0-9_:]*"))

    got = _scrape_expected(ctx)
    if got is None:
        out.append(Finding(
            "PR204", ctx.scrape_test, 1, "<module>", "<missing>",
            "scrape test not found; metric parity unchecked"))
        return
    expected, list_line = got
    expected_filodb = {n for n in expected if n.startswith("filodb_")}

    # PR203: import-time filodb_* metric not covered by the breadth test.
    # GaugeFn is exempt: a callback returning None drops the series from
    # the exposition, so the family is allowed to be conditional and the
    # breadth test cannot assert it unconditionally.
    for s in sites:
        if not s.module_level or not s.name.startswith("filodb_") \
                or s.factory == "GaugeFn":
            continue
        missing = [e for e in s.exposed if e not in expected]
        for e in missing:
            out.append(Finding(
                "PR203", s.path, s.line, s.symbol, e,
                f"import-time metric {s.name!r} renders family {e!r} "
                f"which no expected-name list in {ctx.scrape_test} "
                f"asserts"))

    # PR206: ingest/selfmon freshness families must be breadth-tested no
    # matter how they register. Lazy registration (shard start) and
    # GaugeFn conditionality do not exempt them: the scrape fixture boots
    # shards and drives ingest, so every family here renders, and these
    # are the series the _meta self-monitoring loop alerts on.
    seen206: set[tuple[str, str]] = set()
    for s in sites:
        if not s.name.startswith(("filodb_ingest_", "filodb_selfmon_")):
            continue
        for e in s.exposed:
            if e in expected or (s.name, e) in seen206:
                continue
            seen206.add((s.name, e))
            out.append(Finding(
                "PR206", s.path, s.line, s.symbol, e,
                f"freshness-telemetry metric {s.name!r} renders family "
                f"{e!r} which no expected-name list in "
                f"{ctx.scrape_test} asserts (the lazy/GaugeFn "
                f"exemptions do not apply to ingest/selfmon families)"))

    # PR207: aggregate-pyramid families must be breadth-tested the same
    # way — they carry the cold-tier zero-payload accounting, register at
    # import (objectstore imports pyramid), and render at zero before any
    # cold fold, so neither the lazy nor the GaugeFn exemption applies.
    seen207: set[tuple[str, str]] = set()
    for s in sites:
        if not s.name.startswith("filodb_pyramid_"):
            continue
        for e in s.exposed:
            if e in expected or (s.name, e) in seen207:
                continue
            seen207.add((s.name, e))
            out.append(Finding(
                "PR207", s.path, s.line, s.symbol, e,
                f"aggregate-pyramid metric {s.name!r} renders family "
                f"{e!r} which no expected-name list in "
                f"{ctx.scrape_test} asserts (pyramid families carry the "
                f"zero-payload accounting and register at import; no "
                f"exemptions apply)"))

    # PR204: asserted name no creation site produces (lazy sites count)
    produced: set[str] = set()
    for s in sites:
        produced.update(s.exposed)
    for name in sorted(expected_filodb - produced):
        out.append(Finding(
            "PR204", ctx.scrape_test, list_line, "<module>", name,
            f"scrape test expects family {name!r} but no metric "
            f"creation in filodb_tpu_torch/ produces it"))


def _decname(fn) -> str | None:
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def run(ctx: AnalysisContext) -> list[Finding]:
    out: list[Finding] = []
    _check_wire(ctx, out)
    _check_metrics(ctx, out)
    return out
