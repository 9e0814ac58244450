"""filolint over the port (``filodb_tpu_torch/analysis``) against the
reference's analyser (``filodb_tpu/analysis``).

- Every fixture tree of ``tests/test_filolint.py`` (read as source: each
  ``run_pass`` / ``TestParity.run`` call's file dict), written once under
  ``filodb_tpu/`` for the reference's pass and once under
  ``filodb_tpu_torch/`` for the port's, gives the same findings (code,
  path, symbol, detail) from both. The reference's three JAX kernel forms
  (``pl.pallas_call``, ``shard_map``, call-form ``jit``) are not the
  port's, which finds nothing there; the port's own forms (the function a
  ``make_*`` factory returns, a ``torch.autograd.Function``'s
  ``forward``/``backward``, ``@triton.jit``) and its sync list
  (``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``) have torch
  fixtures of their own.
- The model, the baseline and the command line, held for both packages.
- The repo gate: ``run_all`` over ``filodb_tpu_torch/`` gives no finding
  outside ``conf/filolint_torch_baseline.json``, no entry is stale, and
  every entry names its reason; ``parallel/dist_query.py`` is clean.
- ROADMAP §C.24, pinned: the port's metrics registry lacks seven
  families the reference's scrape test names.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from filodb_tpu import analysis as ref_analysis
from filodb_tpu.analysis import cli as ref_cli
from filodb_tpu_torch import analysis as port_analysis
from filodb_tpu_torch.analysis import (
    AnalysisContext,
    Baseline,
    Finding,
    chokepoint,
    cli,
    decisionparity,
    hotpath,
    lifecycle,
    lockdiscipline,
    parity,
    run_all,
)
from filodb_tpu_torch.analysis.model import suppressed

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO_ROOT, "conf", "filolint_torch_baseline.json")
REF_TEST = os.path.join(REPO_ROOT, "tests", "test_filolint.py")
PASSES = ("chokepoint", "decisionparity", "hotpath", "lifecycle",
          "lockdiscipline", "parity")
PKG = {"ref": "filodb_tpu", "port": "filodb_tpu_torch"}
# the reference's JAX kernel forms, which are not the port's
JAX_KERNEL_FORMS = ("TestHotPath.test_pallas_kernel_detected",
                    "TestHotPath.test_shard_map_wrapped_kernel_in_parallel",
                    "TestHotPath.test_jit_call_form_wrapped_kernel")


def _aim(text: str, pkg: str) -> str:
    return re.sub(r"\bfilodb_tpu(_torch)?\b", pkg, text)


def _reference_fixtures() -> list:
    """(test name, pass name, files) of every fixture tree in the
    reference's tests, the files as written under ``filodb_tpu/``."""
    tree = ast.parse(open(REF_TEST, encoding="utf-8").read())
    consts = {n.targets[0].id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and len(n.targets) == 1
              and isinstance(n.targets[0], ast.Name)
              and isinstance(n.value, ast.Constant)}
    out = []
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        for fn in (n for n in cls.body if isinstance(n, ast.FunctionDef)
                   and n.name.startswith("test_")):
            calls = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id == "run_pass" \
                        and len(node.args) == 3:
                    calls.append((node.args[1].id, node.args[2]))
                elif isinstance(f, ast.Attribute) and f.attr == "run" \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == "self" and len(node.args) == 2:
                    calls.append(("parity", node.args[1]))
            for i, (mod, arg) in enumerate(calls):
                files = dict(ast.literal_eval(arg))
                if mod == "parity":  # TestParity.run's defaults
                    files.setdefault("filodb_tpu/coordinator/wire.py",
                                     consts["WIRE_FIXTURE"])
                    files.setdefault("tests/test_metrics_scrape.py",
                                     consts["SCRAPE_FIXTURE"])
                name = f"{cls.name}.{fn.name}" + (f"#{i}" if i else "")
                out.append((name, mod, files))
    return out


FIXTURES = _reference_fixtures()


def write_tree(root, files: dict, pkg: str = "filodb_tpu_torch") -> str:
    for rel, src in files.items():
        path = os.path.join(root, _aim(rel, pkg))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(_aim(src, pkg)))
    return str(root)


def _findings(root, who: str, mod: str, files: dict) -> list:
    pkg = PKG[who]
    analysis = ref_analysis if who == "ref" else port_analysis
    write_tree(root, files, pkg)
    ctx = analysis.AnalysisContext.build(str(root))
    assert not ctx.errors, ctx.errors
    passes = __import__(f"{analysis.__name__}.{mod}", fromlist=[mod])
    return [(f.code, _aim(f.path, "PKG"), f.symbol, _aim(f.detail, "PKG"))
            for f in passes.run(ctx)]


def test_the_reference_fixtures_are_read():
    assert len(FIXTURES) >= 50
    assert {m for _, m, _ in FIXTURES} == set(PASSES)


@pytest.mark.parametrize(
    "name,mod,files",
    [f for f in FIXTURES if f[0] not in JAX_KERNEL_FORMS],
    ids=[f[0] for f in FIXTURES if f[0] not in JAX_KERNEL_FORMS])
def test_fixture_gives_the_references_findings(tmp_path, name, mod, files):
    ref = _findings(tmp_path / "ref", "ref", mod, files)
    port = _findings(tmp_path / "port", "port", mod, files)
    assert port == ref


@pytest.mark.parametrize("name", JAX_KERNEL_FORMS)
def test_jax_kernel_forms_are_not_the_ports(tmp_path, name):
    (mod, files), = [(m, f) for n, m, f in FIXTURES if n == name]
    assert _findings(tmp_path / "ref", "ref", mod, files)
    assert _findings(tmp_path / "port", "port", mod, files) == []


# --------------------------------------------------------------------------
# the port's kernel forms

TORCH_KERNELS = {
    "factory-step-item": ({"filodb_tpu_torch/parallel/d.py": """
        def make_step(mesh):
            def step(ts, vals):
                return vals.sum().item() + ts
            return step
        """}, [("HP301", "make_step.step")]),
    "factory-nested-cpu": ({"filodb_tpu_torch/parallel/d.py": """
        def make_step(mesh):
            def step(ts, vals):
                def inner(y):
                    return y.cpu()
                return inner(vals)
            return step
        """}, [("HP301", "make_step.step.inner")]),
    "autograd-function": ({"filodb_tpu_torch/query/engine/k.py": """
        import torch

        class Fused(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.cpu()

            @staticmethod
            def backward(ctx, g):
                torch.cuda.synchronize()
                return g
        """}, [("HP301", "Fused.forward"), ("HP301", "Fused.backward")]),
    "triton-jit": ({"filodb_tpu_torch/query/engine/t.py": """
        import time
        import triton

        @triton.jit
        def kernel(x_ptr, meta):
            t = time.time()
            return meta.steps.numpy() + t
        """}, [("HP302", "kernel"), ("HP301", "kernel")]),
    "not-a-kernel": ({"filodb_tpu_torch/parallel/d.py": """
        def helper(x):
            return x.item()

        def make_step(mesh):
            def other(x):
                return x.cpu()
            step = other
            return step

        def build(mesh):
            def step(x):
                return x.item()
            return step
        """, "filodb_tpu_torch/coordinator/c.py": """
        def make_step(mesh):
            def step(x):
                return x.item()
            return step
        """}, []),
}


@pytest.mark.parametrize("name", sorted(TORCH_KERNELS))
def test_torch_kernel_forms(tmp_path, name):
    files, want = TORCH_KERNELS[name]
    root = write_tree(tmp_path, files)
    out = hotpath.run(AnalysisContext.build(root))
    assert [(f.code, f.symbol) for f in out] == want


# --------------------------------------------------------------------------
# model, baseline and command line, both packages

LD101_TREE = {"filodb_tpu/m.py": """
    import threading, time

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def bad(self):
            with self._lock:
                time.sleep(1)
    """}
CLIS = {"ref": ref_cli, "port": cli}


def test_inline_suppression(tmp_path):
    root = write_tree(tmp_path, {"filodb_tpu/m.py": LD101_TREE[
        "filodb_tpu/m.py"].replace("time.sleep(1)",
                                   "time.sleep(1)  # filolint: disable=LD101")})
    assert run_all(root, passes=[lockdiscipline]) == []
    lines = ["x = 1  # filolint: disable=LD101"]
    assert suppressed(lines, 1, "LD101")
    assert not suppressed(lines, 1, "LD103")
    assert suppressed(["y  # filolint: disable=all"], 1, "HP302")


def test_baseline_diff_and_update(tmp_path):
    f1 = Finding("LD101", "p.py", 1, "C.m", "d1", "m1")
    f2 = Finding("LD101", "p.py", 2, "C.m", "d2", "m2")
    assert f1.key == Finding("LD101", "p.py", 99, "C.m", "d1", "m1").key
    bl = Baseline()
    bl.update([f1])
    bl.entries[f1.key]["justification"] = "intentional"
    new, stale = bl.diff([f1, f2])
    assert [f.key for f in new] == [f2.key] and stale == []
    new, stale = bl.diff([f2])
    assert [e["key"] for e in stale] == [f1.key]
    bl.update([f1, f2])
    assert bl.entries[f1.key]["justification"] == "intentional"
    assert "TODO" in bl.entries[f2.key]["justification"]
    path = str(tmp_path / "bl.json")
    bl.save(path)
    assert Baseline.load(path).entries == bl.entries


@pytest.mark.parametrize("who", sorted(CLIS))
def test_cli_gate_roundtrip(tmp_path, capsys, who):
    root = write_tree(tmp_path, LD101_TREE, PKG[who])
    main = CLIS[who].main
    bl = str(tmp_path / "baseline.json")
    assert main(["--root", root, "--baseline", bl]) == 1
    assert main(["--root", root, "--baseline", bl, "--update-baseline"]) == 0
    assert main(["--root", root, "--baseline", bl]) == 0
    assert "filolint: clean (" in capsys.readouterr().err
    assert json.load(open(bl))["entries"][0]["code"] == "LD101"
    assert main(["--root", root, "--baseline", bl, "--no-baseline",
                 "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["code"] for f in doc["new"] if f["code"] == "LD101"] == \
        ["LD101"]


@pytest.mark.parametrize("who", sorted(CLIS))
def test_cli_parse_error_exits_2(tmp_path, capsys, who):
    root = write_tree(tmp_path, {"filodb_tpu/bad.py": "def broken(:\n"},
                      PKG[who])
    assert CLIS[who].main(["--root", root]) == 2
    capsys.readouterr()


@pytest.mark.parametrize("who", sorted(CLIS))
def test_cli_sarif_output(tmp_path, capsys, who):
    root = write_tree(tmp_path, LD101_TREE, PKG[who])
    assert CLIS[who].main(["--root", root, "--baseline",
                           str(tmp_path / "b.json"), "--format",
                           "sarif"]) == 1
    run = json.loads(capsys.readouterr().out)["runs"][0]
    assert run["tool"]["driver"]["name"] == "filolint"
    (res,) = [r for r in run["results"] if r["ruleId"] == "LD101"]
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == f"{PKG[who]}/m.py"
    assert res["partialFingerprints"]["filolintKey"].startswith("LD101:")


@pytest.mark.parametrize("who", sorted(CLIS))
def test_cli_changed_only_filters_to_diff_scope(tmp_path, capsys, who):
    root = write_tree(tmp_path, {"filodb_tpu/clean.py": "X = 1\n",
                                 **LD101_TREE}, PKG[who])
    bl = str(tmp_path / "baseline.json")

    def git(*a):
        subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                        *a], cwd=root, check=True, capture_output=True,
                       timeout=60)

    git("init", "-q")
    git("add", "-A")
    git("commit", "-q", "-m", "base")
    main = CLIS[who].main
    assert main(["--root", root, "--baseline", bl, "--changed-only"]) == 0
    with open(os.path.join(root, PKG[who], "m.py"), "a") as f:
        f.write("\n")
    assert main(["--root", root, "--baseline", bl, "--changed-only"]) == 1
    capsys.readouterr()


def test_changed_only_dependent_closure(tmp_path):
    root = write_tree(tmp_path, {
        "filodb_tpu/__init__.py": "",
        "filodb_tpu/helper.py": "def f():\n    return 1\n",
        "filodb_tpu/caller.py": "from filodb_tpu.helper import f\n",
        "filodb_tpu/unrelated.py": "Y = 2\n"})
    scope = cli._dependent_closure(AnalysisContext.build(root),
                                   {"filodb_tpu_torch/helper.py"})
    assert "filodb_tpu_torch/caller.py" in scope
    assert "filodb_tpu_torch/unrelated.py" not in scope


def test_the_tool_prints_the_clean_line():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "tools",
                                      "filolint_torch.py")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert re.fullmatch(r"filolint: clean \(\d+ baselined finding\(s\)\)",
                        out.stderr.strip())


# --------------------------------------------------------------------------
# the repo gate

@pytest.fixture(scope="module")
def repo_findings():
    return run_all(REPO_ROOT)


def test_repo_has_no_unbaselined_findings(repo_findings):
    new, stale = Baseline.load(BASELINE).diff(repo_findings)
    assert not new, "new filolint findings (fix, or baseline with the " \
        "reason):\n" + "\n".join(f.render() for f in new)
    assert not stale, "stale baseline entries (remove them):\n" + \
        "\n".join(e["key"] for e in stale)


def test_repo_parses_clean():
    assert AnalysisContext.build(REPO_ROOT).errors == []


def test_every_baseline_entry_names_its_reason():
    bl = Baseline.load(BASELINE)
    assert bl.entries
    for key, e in bl.entries.items():
        why = e.get("justification", "")
        assert "TODO" not in why, key
        assert why.startswith("the reference's own baseline entry: ") \
            or "ROADMAP §C" in why or why.startswith("written under "), key


def test_the_dist_query_programs_are_clean(repo_findings):
    assert [f.render() for f in repo_findings
            if f.path == "filodb_tpu_torch/parallel/dist_query.py"] == []


def test_passes_cover_the_port_tree():
    ctx = AnalysisContext.build(REPO_ROOT)
    paths = {m.path for m in ctx.modules}
    assert "filodb_tpu_torch/parallel/dist_query.py" in paths
    assert not any(p.startswith("filodb_tpu/") for p in paths)
    for mod in (chokepoint, decisionparity, lifecycle, parity):
        assert isinstance(mod.run(ctx), list)


# --------------------------------------------------------------------------
# ROADMAP §C.24 (closed)

C24_FAMILIES = ("filodb_mesh_batch_cache_total", "filodb_mesh_dispatch_total",
                "filodb_mesh_hit_rate", "filodb_mesh_supported_total",
                "filodb_mesh_unsupported_total", "filodb_odp_cache_chunks",
                "filodb_sidecar_backfilled_total")
# the reference's mesh shapes (a split and a fused leaf each), then plans
# both engines decline: grids of one step that the sidecar lane takes
C24_QUERIES = (
    ("range", "sum(rate(http_requests_total[5m])) by (job)"),
    ("range", "max_over_time(http_requests_total[5m])"),
    ("range", "http_requests_total"),
    ("range", "topk(2, rate(http_requests_total[5m]))"),
    ("range", "2 * avg(sum_over_time(queue_depth[5m])) without (instance)"),
    ("range", "sum(min_over_time(queue_depth[5m])) by (job)"),
    ("instant", "sum(rate(http_requests_total[5m]))"),
    ("instant", "count_over_time(queue_depth[5m])"),
)


def _c24_counts(mod) -> tuple:
    return (mod._M_SUPPORTED.value, mod._M_UNSUPPORTED.value,
            mod._M_DISPATCH["split"].value, mod._M_DISPATCH["fused"].value)


def test_missing_metric_families_pin_c24():
    """ROADMAP §C.24, closed: the seven families the reference registers
    at import (its mesh engine's plan and cache counters, the ODP cache's
    resident chunks, the sidecar backfill counter) are in the port's
    registry too, no PR204 entry stands for them, and over the
    reference's mesh shapes and plans both engines decline the port's
    ``supported``, ``unsupported`` and ``dispatch{form}`` move by the
    reference's amounts, query by query."""
    import filodb_tpu.core.memstore.odp  # noqa: F401
    import filodb_tpu.memory.chunk  # noqa: F401
    import filodb_tpu.parallel.mesh_engine as ref_mesh
    import filodb_tpu_torch.core.memstore.odp  # noqa: F401
    import filodb_tpu_torch.memory.chunk  # noqa: F401
    import filodb_tpu_torch.parallel.mesh_engine as port_mesh
    from filodb_tpu.coordinator.query_service import \
        QueryService as RefService
    from filodb_tpu.utils import metrics as ref_metrics
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.utils import metrics as port_metrics
    from test_torch_slice import (
        CHUNK,
        DS,
        NUM_SHARDS,
        Q_END,
        Q_START,
        Q_STEP,
        _build_stores,
        _series_specs,
    )

    def families(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}

    ref = families(ref_metrics.render_prometheus())
    port = families(port_metrics.render_prometheus())
    names = set(C24_FAMILIES) | {f.replace("_total", "")
                                 for f in C24_FAMILIES}
    seven = {f for f in ref if f in names}
    assert len(seven) == 7
    assert {f for f in port if f in names} == seven
    assert not [e for e in Baseline.load(BASELINE).entries.values()
                if e["code"] == "PR204"
                and e["key"].rsplit(":", 1)[1] in C24_FAMILIES]

    ref_store, port_store = _build_stores(_series_specs(), CHUNK)
    rsvc = RefService(ref_store, DS, NUM_SHARDS, spread=1, engine="mesh")
    psvc = QueryService(port_store, device="cpu")
    got, want = [], []
    for kind, q in C24_QUERIES:
        before, rbefore = _c24_counts(port_mesh), _c24_counts(ref_mesh)
        for svc in (psvc, rsvc):
            if kind == "range":
                svc.query_range(q, Q_START, Q_STEP, Q_END).result \
                    .materialize()
            else:
                svc.query_instant(q, Q_END).result.materialize()
        got.append(tuple(a - b for a, b in zip(_c24_counts(port_mesh),
                                               before)))
        want.append(tuple(a - b for a, b in zip(_c24_counts(ref_mesh),
                                                rbefore)))
    assert got == want
    assert sum(g[1] for g in got) == 2 and sum(g[3] for g in got) == 2
