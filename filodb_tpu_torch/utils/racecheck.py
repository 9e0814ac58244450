"""Debug runtime shared-state race sanitizer (``FILODB_RACECHECK=1``).

Copy of ``filodb_tpu/utils/racecheck.py``. A static pass flags attributes
written both under and outside a lock, but only within one class's
lexical scope — it cannot see a shard map mutated from the heartbeat
thread through one lock and from a migration worker through another, or
a rules-state dict written with no lock at all from a path the class
never declared. This module covers that gap at runtime with an
Eraser-style lockset algorithm:

- :func:`register` marks an object as *shared state*; every subsequent
  attribute write to it records which checked locks (from
  :mod:`~filodb_tpu_torch.utils.lockcheck`, by creation site) the writing
  thread held.
- Per ``(label, attribute)`` cell the tracker intersects the guard sets
  across writes. Once two or more distinct threads have written the
  cell and the intersection is empty, there is no single lock that
  protects it: the write is flagged **guard-free** (the current writer
  held no checked lock at all) or **mixed-guard** (writers hold locks,
  but disjoint ones).
- :func:`tracked_dict` wraps a dict in a recording subclass so keyed
  state (the metrics registry, rules group state) gets the same
  treatment per key. Plain ``dict`` subclassing keeps wire encoding
  (``isinstance(obj, dict)``) and every read path untouched.

Tracking patches ``__setattr__`` on the *original* class — never swaps
``obj.__class__`` — because the wire registry checks exact class
identity on encode (``registry().get(name) is not cls``) and
``MigrationManifest`` is wire-registered shared state.

Known gaps, accepted by design (mirroring lockcheck): objects created
before :func:`install` are untracked; in-place mutations of list/set
attribute *values* are invisible (only the attribute rebind is seen) —
keyed container state should go through :func:`tracked_dict`; guard
identity is lockcheck's creation-site key, so locks created before
lockcheck installed are invisible as guards.

Usage in tests::

    with lockcheck.session():
        with racecheck.session():
            ... run chaos scenario ...
        assert racecheck.violations() == []

Setting ``FILODB_RACECHECK=1`` before importing ``filodb_tpu_torch``
installs the tracker process-wide (and lockcheck with it — the guard sets
come from lockcheck's held stack); ``FILODB_RACECHECK_STRICT=1`` makes a
violation raise where it happens.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import weakref
from dataclasses import dataclass, field

from filodb_tpu_torch.utils import lockcheck

__all__ = [
    "RaceViolation",
    "Violation",
    "enabled_by_env",
    "install",
    "installed",
    "register",
    "reset",
    "session",
    "tracked_dict",
    "uninstall",
    "violations",
]

_ENV_FLAG = "FILODB_RACECHECK"


@dataclass(frozen=True)
class Violation:
    kind: str        # "guard-free" | "mixed-guard"
    thread: str
    detail: str

    def render(self) -> str:
        return f"[{self.kind}] thread={self.thread}: {self.detail}"


class RaceViolation(RuntimeError):
    pass


@dataclass
class _Cell:
    """Lockset state for one (label, attr) pair."""
    candidates: frozenset | None = None   # None until the first write
    writers: set = field(default_factory=set)          # thread idents
    examples: dict = field(default_factory=dict)       # guards -> site


@dataclass
class _State:
    strict: bool = False
    cells: dict = field(default_factory=dict)   # (label, attr) -> _Cell
    violations: list = field(default_factory=list)
    reported: set = field(default_factory=set)
    lock: object = None
    installed_lockcheck: bool = False

    def __post_init__(self):
        # a REAL lock: while lockcheck is installed, threading.Lock()
        # returns a checked wrapper, and the tracker's own bookkeeping
        # must not appear in the held stack it samples
        self.lock = lockcheck._real_lock()


_state: _State | None = None
# id(obj) -> label for registered objects; populated only while
# installed, cleaned up by weakref.finalize so a recycled id cannot
# alias a dead object's label
_labels: dict[int, str] = {}
# class -> (had_own_setattr, original_setattr_descriptor, call_target)
_patched: dict[type, tuple] = {}


def _write_site() -> str:
    f = sys._getframe(2)
    this = __file__
    while f is not None:
        fn = f.f_code.co_filename
        if fn != this and "threading" not in fn:
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _current_guards() -> frozenset:
    return frozenset(site for site, _ in lockcheck._held())


def _record_write(label: str, attr: str) -> None:
    st = _state
    if st is None:
        return
    guards = _current_guards()
    site = _write_site()
    ident = threading.get_ident()
    tname = threading.current_thread().name
    raise_v = None
    with st.lock:
        cell = st.cells.setdefault((label, attr), _Cell())
        cell.writers.add(ident)
        cell.examples.setdefault(guards, site)
        if cell.candidates is None:
            cell.candidates = guards
        else:
            cell.candidates = cell.candidates & guards
        if len(cell.writers) >= 2 and not cell.candidates:
            kind = "guard-free" if not guards else "mixed-guard"
            key = (label, attr, kind)
            if key not in st.reported:
                st.reported.add(key)
                others = "; ".join(
                    f"{{{', '.join(sorted(g)) or 'no lock'}}} at {s}"
                    for g, s in cell.examples.items())
                held = ", ".join(sorted(guards)) or "no lock"
                v = Violation(
                    kind, tname,
                    f"write to {label}.{attr} at {site} under [{held}] "
                    f"has no lock in common with the other "
                    f"{len(cell.writers)} writer thread(s): {others}")
                st.violations.append(v)
                if st.strict:
                    raise_v = v
    if raise_v is not None:
        raise RaceViolation(raise_v.render())


# --------------------------------------------------------------------------
# attribute tracking

def _patch_class(cls: type) -> None:
    if cls in _patched:
        return
    had_own = "__setattr__" in cls.__dict__
    original_descriptor = cls.__dict__.get("__setattr__")
    call_target = cls.__setattr__   # resolved through the MRO

    def _tracked_setattr(self, name, value, _orig=call_target):
        _orig(self, name, value)
        label = _labels.get(id(self))
        if label is not None and not name.startswith("__"):
            _record_write(label, name)

    _patched[cls] = (had_own, original_descriptor)
    cls.__setattr__ = _tracked_setattr


def _unpatch_all() -> None:
    for cls, (had_own, original) in _patched.items():
        if had_own:
            cls.__setattr__ = original
        else:
            try:
                del cls.__setattr__
            except AttributeError:
                pass
    _patched.clear()


def register(obj, label: str):
    """Mark ``obj`` as tracked shared state; returns ``obj`` so it can
    wrap an assignment. No-op (and free) when the tracker is not
    installed — product code calls this unconditionally."""
    if _state is None:
        return obj
    _patch_class(type(obj))
    oid = id(obj)
    _labels[oid] = label
    try:
        weakref.finalize(obj, _labels.pop, oid, None)
    except TypeError:
        pass   # non-weakref-able objects just keep the label entry
    return obj


class _TrackedDict(dict):
    """Dict subclass recording per-key writes. Stays a real ``dict`` so
    wire encoding and every structural read path are untouched."""

    __slots__ = ("_racecheck_label",)

    def __init__(self, label: str, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._racecheck_label = label

    def _note(self, key) -> None:
        _record_write(self._racecheck_label, f"[{key!r}]")

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._note(key)

    def __delitem__(self, key):
        super().__delitem__(key)
        self._note(key)

    def setdefault(self, key, default=None):
        present = key in self
        out = super().setdefault(key, default)
        if not present:
            self._note(key)
        return out

    def pop(self, key, *default):
        present = key in self
        out = super().pop(key, *default)
        if present:
            self._note(key)
        return out

    def popitem(self):
        key, value = super().popitem()
        self._note(key)
        return key, value

    def update(self, *args, **kwargs):
        snapshot = dict(*args, **kwargs)
        super().update(snapshot)
        for key in snapshot:
            self._note(key)

    def clear(self):
        keys = list(self)
        super().clear()
        for key in keys:
            self._note(key)


def tracked_dict(label: str, initial=None):
    """A recording dict labeled ``label`` — or a plain dict when the
    tracker is not installed, so product code pays nothing."""
    if _state is None:
        return dict(initial or {})
    return _TrackedDict(label, initial or {})


# --------------------------------------------------------------------------
# lifecycle

def installed() -> bool:
    return _state is not None


def enabled_by_env() -> bool:
    return os.environ.get(_ENV_FLAG, "") not in ("", "0", "false")


_saved_metrics_lock = None


def _wrap_metrics_registry() -> None:
    """The metric registry dict and its module lock are created at
    import time, before any fixture can install the tracker; swap the
    dict for a recording one AND re-create the lock through the (now
    lockcheck-patched) factory — otherwise every registry write would
    look guard-free, since a pre-install real lock is invisible to the
    held-stack sampling. Both are swapped back at uninstall."""
    global _saved_metrics_lock
    from filodb_tpu_torch.utils import metrics
    if not isinstance(metrics._registry, _TrackedDict):
        metrics._registry = _TrackedDict("metrics.registry",
                                         metrics._registry)
        _saved_metrics_lock = metrics._lock
        metrics._lock = threading.Lock()


def _unwrap_metrics_registry() -> None:
    global _saved_metrics_lock
    from filodb_tpu_torch.utils import metrics
    if isinstance(metrics._registry, _TrackedDict):
        metrics._registry = dict(metrics._registry)
        if _saved_metrics_lock is not None:
            metrics._lock = _saved_metrics_lock
            _saved_metrics_lock = None


def install(strict: bool = False) -> None:
    """Start tracking registered shared objects. Installs lockcheck too
    if absent (guard sets come from its held-lock stack); that piggyback
    install is torn down again by :func:`uninstall`. Idempotent."""
    global _state
    if _state is not None:
        _state.strict = strict
        return
    st = _State(strict=strict)
    if not lockcheck.installed():
        lockcheck.install(strict=False)
        st.installed_lockcheck = True
    _state = st
    _wrap_metrics_registry()


def uninstall() -> None:
    global _state
    st = _state
    _state = None
    _unpatch_all()
    _labels.clear()
    _unwrap_metrics_registry()
    if st is not None and st.installed_lockcheck:
        lockcheck.uninstall()


def reset() -> None:
    """Clear cells and recorded violations (tracker stays installed,
    registrations stay live)."""
    st = _state
    if st is None:
        return
    with st.lock:
        st.cells.clear()
        st.violations.clear()
        st.reported.clear()


def violations() -> list[Violation]:
    st = _state
    if st is None:
        return []
    with st.lock:
        return list(st.violations)


@contextlib.contextmanager
def session(strict: bool = False):
    """Install for the duration of a block. Non-strict by default so a
    chaos scenario runs to completion and the test asserts
    ``violations() == []`` at teardown (strict raises inside worker
    threads, which surfaces as an unrelated secondary failure)."""
    fresh = _state is None
    install(strict=strict)
    if not fresh:
        reset()
    try:
        yield
    finally:
        if fresh:
            uninstall()
        # else: leave the process-wide (env-driven) install in place
