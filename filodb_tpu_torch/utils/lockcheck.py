"""Debug runtime lock-order validator (``FILODB_LOCKCHECK=1``).

Copy of ``filodb_tpu/utils/lockcheck.py``. The reference pairs it with a
static pass (filolint's lock discipline) that approximates lock identity
lexically and cannot order two locks created at the same site or see
cross-object call chains; this module covers that at runtime,
ThreadSanitizer-style but at lock granularity:

- :func:`install` replaces ``threading.Lock``/``threading.RLock`` with
  checked wrappers. Each wrapper is keyed by its CREATION SITE
  (``file:line``), so every ``with self._lock:`` across all instances
  of a class maps to one graph node — the same approximation the static
  pass uses, which is what makes an A→B vs B→A report meaningful.
- Each thread keeps its held-lock stack; acquiring lock B while holding
  A adds the edge ``site(A) → site(B)`` to a global order graph. An
  acquisition whose edge closes a cycle records a
  :class:`LockOrderViolation` (and raises, unless ``strict=False``).
- Registered blocking calls (``time.sleep``, ``queue.Queue.get``,
  ``threading.Thread.join``) made while ANY checked lock is held record
  a :class:`BlockingUnderLockViolation`.

Known gaps, accepted by design: locks created BEFORE :func:`install`
(module import order) and locks captured by value at class-definition
time (``field(default_factory=threading.Lock)``) are not wrapped.
Same-site edges (two instances of one class) are skipped for cycle
purposes — instance order is not expressible at site granularity — but
still count as "a lock is held" for blocking checks.

Usage in tests::

    with lockcheck.session():
        ... run chaos scenario ...
    assert lockcheck.violations() == []

Setting ``FILODB_LOCKCHECK=1`` before importing ``filodb_tpu_torch``
installs the checker for the whole process (see
``filodb_tpu_torch/__init__``); ``FILODB_LOCKCHECK_STRICT=1`` makes a
violation raise where it happens.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass, field

__all__ = [
    "BlockingUnderLockViolation",
    "LockOrderViolation",
    "Violation",
    "enabled_by_env",
    "install",
    "installed",
    "reset",
    "session",
    "uninstall",
    "violations",
]

_ENV_FLAG = "FILODB_LOCKCHECK"


@dataclass(frozen=True)
class Violation:
    kind: str        # "lock-order-cycle" | "blocking-under-lock"
    thread: str
    detail: str

    def render(self) -> str:
        return f"[{self.kind}] thread={self.thread}: {self.detail}"


class LockOrderViolation(RuntimeError):
    pass


class BlockingUnderLockViolation(RuntimeError):
    pass


@dataclass
class _State:
    strict: bool = True
    # creation-site graph: src site -> {dst site -> example detail}
    edges: dict = field(default_factory=dict)
    violations: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # sites already reported, so one bad shape doesn't flood the list
    reported: set = field(default_factory=set)


_state: _State | None = None
_tls = threading.local()

_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_sleep = time.sleep
_real_queue_get = queue.Queue.get
_real_thread_join = threading.Thread.join


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _creation_site() -> str:
    """First stack frame outside this module and outside ``threading`` —
    the line that called ``threading.Lock()``."""
    import sys
    f = sys._getframe(2)
    this = __file__
    while f is not None:
        fn = f.f_code.co_filename
        if fn != this and "threading" not in fn:
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _record_violation(exc_cls, kind: str, detail: str,
                      dedupe_key) -> None:
    st = _state
    if st is None:
        return
    with st.lock:
        if dedupe_key in st.reported:
            return
        st.reported.add(dedupe_key)
        v = Violation(kind, threading.current_thread().name, detail)
        st.violations.append(v)
    if st.strict:
        raise exc_cls(v.render())


def _check_cycle(new_site: str) -> None:
    """Before pushing ``new_site``, add edges held→new and verify the
    graph stays acyclic. DFS from new_site back to any held site."""
    st = _state
    held = _held()
    if st is None or not held:
        return
    srcs = {s for s, _ in held if s != new_site}
    if not srcs:
        return
    with st.lock:
        for src in srcs:
            st.edges.setdefault(src, set()).add(new_site)
        # reachability: new_site ->* src means src -> new_site closed a
        # cycle
        seen = set()
        frontier = [new_site]
        path_hit = None
        while frontier:
            cur = frontier.pop()
            if cur in seen:
                continue
            seen.add(cur)
            if cur in srcs and cur != new_site:
                path_hit = cur
                break
            frontier.extend(st.edges.get(cur, ()))
    if path_hit is not None:
        _record_violation(
            LockOrderViolation, "lock-order-cycle",
            f"acquiring lock created at {new_site} while holding "
            f"{path_hit} closes an order cycle "
            f"({path_hit} -> {new_site} and {new_site} ->* {path_hit} "
            f"both observed)",
            ("cycle", new_site, path_hit))


def _push(site: str, obj) -> None:
    _held().append((site, id(obj)))


def _pop(obj) -> None:
    stack = _held()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][1] == id(obj):
            del stack[i]
            return


class _CheckedLockBase:
    """Delegating wrapper over a real lock primitive. Implements enough
    of the lock protocol for ``threading.Condition(lock)`` to accept it
    (``_release_save``/``_acquire_restore``/``_is_owned`` on the RLock
    variant)."""

    def __init__(self, inner):
        self._inner = inner
        self._site = _creation_site()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            _check_cycle(self._site)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _push(self._site, self)
        return got

    def release(self):
        self._inner.release()
        _pop(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        # delegate the rest of the primitive's surface (e.g. the
        # _at_fork_reinit hook concurrent.futures registers on a
        # module-level lock) straight to the wrapped lock
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<checked {self._inner!r} from {self._site}>"


class _CheckedLock(_CheckedLockBase):
    pass


class _CheckedRLock(_CheckedLockBase):
    # Condition integration: these mirror RLock's private protocol
    def _release_save(self):
        # full release (all recursion levels); Condition.wait calls this
        state = self._inner._release_save() \
            if hasattr(self._inner, "_release_save") else None
        _pop(self)
        return state

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        _push(self._site, self)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return any(lid == id(self) for _, lid in _held())


def _checked_lock_factory():
    if _state is None:
        return _real_lock()
    return _CheckedLock(_real_lock())


def _checked_rlock_factory():
    if _state is None:
        return _real_rlock()
    return _CheckedRLock(_real_rlock())


def _holding_any() -> bool:
    return bool(_held())


def _blocking(desc: str) -> None:
    if _state is None or not _holding_any():
        return
    held = ", ".join(dict.fromkeys(s for s, _ in _held()))
    _record_violation(
        BlockingUnderLockViolation, "blocking-under-lock",
        f"{desc} while holding lock(s) created at {held}",
        ("blocking", desc, held))


def _checked_sleep(secs):
    _blocking(f"time.sleep({secs})")
    _real_sleep(secs)


def _checked_queue_get(self, block=True, timeout=None):
    if block:
        _blocking("queue.Queue.get(block=True)")
    return _real_queue_get(self, block, timeout)


def _checked_thread_join(self, timeout=None):
    _blocking(f"Thread.join({self.name})")
    return _real_thread_join(self, timeout)


# --------------------------------------------------------------------------
# lifecycle

def installed() -> bool:
    return _state is not None


def enabled_by_env() -> bool:
    return os.environ.get(_ENV_FLAG, "") not in ("", "0", "false")


def install(strict: bool = True) -> None:
    """Patch the lock factories and blocking calls. Idempotent; locks
    created before this call stay unchecked."""
    global _state
    if _state is not None:
        _state.strict = strict
        return
    _state = _State(strict=strict)
    threading.Lock = _checked_lock_factory
    threading.RLock = _checked_rlock_factory
    time.sleep = _checked_sleep
    queue.Queue.get = _checked_queue_get
    threading.Thread.join = _checked_thread_join


def uninstall() -> None:
    global _state
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    time.sleep = _real_sleep
    queue.Queue.get = _real_queue_get
    threading.Thread.join = _real_thread_join
    _state = None


def reset() -> None:
    """Clear the order graph and recorded violations (checker stays
    installed)."""
    st = _state
    if st is None:
        return
    with st.lock:
        st.edges.clear()
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
    """Install for the duration of a block and yield the live violation
    list via :func:`violations`. Non-strict by default so a test can run
    the whole scenario and assert ``violations() == []`` at the end
    (strict mode raises inside worker threads, which usually surfaces as
    an unrelated secondary failure)."""
    fresh = _state is None
    install(strict=strict)
    if not fresh:
        reset()
    try:
        yield
    finally:
        if fresh:
            uninstall()
        # else: leave the process-wide install (env-driven) in place
