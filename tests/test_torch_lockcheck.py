"""The port's runtime lock-order validator (``utils/lockcheck.py``).

The cases of ``tests/test_lockcheck.py`` against the port's copy: each
scenario builds fresh locks INSIDE an installed session (only locks
created after install are wrapped) and checks what the validator records
— and, just as important, what it does not. Then the switch:
``FILODB_LOCKCHECK=1`` arms the checker at ``import filodb_tpu_torch``
in a fresh interpreter, where a node on the CPU ingests through its
gateway, flushes, answers a query over HTTP and shuts down with no
violation recorded; and ROADMAP §C.23, pinned: a page encode of more
than one span of series joins its thread pool's threads where its caller
holds a lock. Every test runs under a time limit of its own.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from filodb_tpu_torch.utils import lockcheck

ROOT = Path(__file__).resolve().parent.parent
LIMIT_S = 120


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(*_):
        raise TimeoutError(f"over the test's {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean_install():
    lockcheck.uninstall()
    yield
    lockcheck.uninstall()


def make_locks(n=2):
    # one lock per source line: the checker keys nodes by creation site,
    # and same-site edges are skipped by design
    out = []
    for _ in range(n):
        out.append(threading.Lock())
    return out


class TestCycleDetection:
    def test_opposite_orders_recorded(self):
        with lockcheck.session():
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
            vs = lockcheck.violations()
        assert [v.kind for v in vs] == ["lock-order-cycle"]

    def test_consistent_order_clean(self):
        with lockcheck.session():
            a = threading.Lock()
            b = threading.Lock()
            for _ in range(3):
                with a:
                    with b:
                        pass
            vs = lockcheck.violations()
        assert vs == []

    def test_same_site_reacquisition_not_a_cycle(self):
        # two instances of one class nest in both orders; the site graph
        # cannot order instances, so this must stay silent (documented
        # gap: the static pass / a dedicated hierarchy handles it)
        with lockcheck.session():
            a, b = make_locks(2)
            with a:
                with b:
                    pass
            vs = lockcheck.violations()
        assert vs == []

    def test_cycle_across_threads(self):
        with lockcheck.session():
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass

            def other():
                with b:
                    with a:
                        pass

            t = threading.Thread(target=other)
            t.start()
            t.join()
            vs = lockcheck.violations()
        assert [v.kind for v in vs] == ["lock-order-cycle"]

    def test_strict_mode_raises(self):
        with lockcheck.session(strict=True):
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass
            with pytest.raises(lockcheck.LockOrderViolation):
                with b:
                    with a:
                        pass


class TestBlockingUnderLock:
    def test_sleep_under_lock(self):
        with lockcheck.session():
            a = threading.Lock()
            with a:
                time.sleep(0)
            vs = lockcheck.violations()
        assert [v.kind for v in vs] == ["blocking-under-lock"]
        assert "time.sleep" in vs[0].detail

    def test_queue_get_under_lock(self):
        with lockcheck.session():
            a = threading.Lock()
            q = queue.Queue()
            q.put(1)
            with a:
                q.get()
            vs = lockcheck.violations()
        assert [v.kind for v in vs] == ["blocking-under-lock"]

    def test_nonblocking_get_is_fine(self):
        with lockcheck.session():
            a = threading.Lock()
            q = queue.Queue()
            q.put(1)
            with a:
                q.get(block=False)
            vs = lockcheck.violations()
        assert vs == []

    def test_thread_join_under_lock(self):
        with lockcheck.session():
            a = threading.Lock()
            t = threading.Thread(target=lambda: None)
            t.start()
            with a:
                t.join()
            vs = lockcheck.violations()
        assert [v.kind for v in vs] == ["blocking-under-lock"]

    def test_sleep_outside_lock_is_fine(self):
        with lockcheck.session():
            a = threading.Lock()
            with a:
                pass
            time.sleep(0)
            vs = lockcheck.violations()
        assert vs == []

    def test_duplicate_shapes_reported_once(self):
        with lockcheck.session():
            a = threading.Lock()
            for _ in range(5):
                with a:
                    time.sleep(0)
            vs = lockcheck.violations()
        assert len(vs) == 1


class TestConditionCompat:
    def test_condition_over_checked_rlock(self):
        # Condition(wrapped RLock) relies on the private
        # _release_save/_acquire_restore/_is_owned protocol; wait() must
        # release the lock (else the notifier deadlocks) and not count
        # as blocking under it
        with lockcheck.session():
            lk = threading.RLock()
            cond = threading.Condition(lk)
            ready = []

            def producer():
                with cond:
                    ready.append(1)
                    cond.notify()

            t = threading.Thread(target=producer)
            with cond:
                t.start()
                deadline = time.monotonic() + 5.0
                while not ready and time.monotonic() < deadline:
                    cond.wait(0.1)
            t.join()
            assert ready
            vs = lockcheck.violations()
        assert vs == []


class TestLifecycle:
    def test_install_uninstall_restores_primitives(self):
        real_lock = threading.Lock
        real_sleep = time.sleep
        lockcheck.install(strict=False)
        assert threading.Lock is not real_lock
        assert lockcheck.installed()
        lockcheck.uninstall()
        assert threading.Lock is real_lock
        assert time.sleep is real_sleep
        assert not lockcheck.installed()

    def test_locks_survive_uninstall(self):
        # a wrapped lock created during the session keeps working after
        # uninstall (worker threads may outlive a test session)
        lockcheck.install(strict=False)
        lk = threading.Lock()
        lockcheck.uninstall()
        with lk:
            pass
        assert not lk.locked()

    def test_delegates_fork_hook(self):
        # concurrent.futures registers _at_fork_reinit on a module-level
        # lock; the wrapper must expose the full primitive surface
        lockcheck.install(strict=False)
        try:
            lk = threading.Lock()
            lk._at_fork_reinit()
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=1) as ex:
                assert ex.submit(lambda: 42).result() == 42
        finally:
            lockcheck.uninstall()

    def test_reset_clears_state(self):
        lockcheck.install(strict=False)
        a = threading.Lock()
        with a:
            time.sleep(0)
        assert lockcheck.violations()
        lockcheck.reset()
        assert lockcheck.violations() == []
        lockcheck.uninstall()

    def test_env_flag(self, monkeypatch):
        monkeypatch.delenv("FILODB_LOCKCHECK", raising=False)
        assert not lockcheck.enabled_by_env()
        monkeypatch.setenv("FILODB_LOCKCHECK", "0")
        assert not lockcheck.enabled_by_env()
        monkeypatch.setenv("FILODB_LOCKCHECK", "1")
        assert lockcheck.enabled_by_env()


# a port node on the CPU, booted, fed through its gateway, flushed by its
# scheduler, queried over HTTP and shut down in a fresh interpreter whose
# environment arms the checkers; prints what they recorded
NODE_SCRIPT = r"""
import json, socket, sys, tempfile, time, urllib.request
sys.modules["jax"] = None
sys.modules["filodb_tpu"] = None
import filodb_tpu_torch
from filodb_tpu_torch.config import ServerConfig
from filodb_tpu_torch.standalone import FiloServer, debug_report
from filodb_tpu_torch.testing import from_jax
from filodb_tpu_torch.utils import lockcheck, racecheck

armed = [lockcheck.installed(), racecheck.installed()]
srv = from_jax.boot(FiloServer, ServerConfig, {"datasets": {"timeseries": {
    "num_shards": 2, "store": {"flush_interval_ms": 2000,
                               "groups_per_shard": 2,
                               "retention_ms": 2**60}}}},
    tempfile.mkdtemp(), device="cpu")
try:
    with socket.create_connection(("127.0.0.1", srv.gateway.port)) as s:
        s.sendall("".join(
            f"up,_ws_=w,_ns_=n,i=i{i % 3} value={i} "
            f"{(1_600_000_000 + 10 * i) * 10**9}\n"
            for i in range(60)).encode())
    url = (f"http://127.0.0.1:{srv.http.port}/promql/timeseries/api/v1/"
           "query_range?query=sum(rate(up[5m]))&start=1600000000"
           "&end=1600000600&step=60")
    rows = []
    for _ in range(400):
        srv.gateway.sink.flush()
        rows = json.loads(urllib.request.urlopen(url, timeout=30).read())[
            "data"]["result"]
        if rows and len(rows[0]["values"]) == 11:
            break
        time.sleep(0.05)
    flushed = srv.node.memstores["timeseries"].shards
    for _ in range(200):
        if all(sh.group_watermarks.min() >= 0 for sh in flushed):
            break
        time.sleep(0.05)
    flushed = [int(sh.group_watermarks.min()) for sh in flushed]
finally:
    srv.shutdown()
print(json.dumps({"armed": armed, "rows": len(rows), "flushed": flushed,
                  "report": debug_report(srv)}))
"""


def run_checked_node(env: dict) -> dict:
    """The node script's JSON line, run with ``env`` over this one."""
    out = subprocess.run([sys.executable, "-c", NODE_SCRIPT], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT),
                              **env},
                         capture_output=True, text=True, timeout=100,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_switch_arms_a_node_with_no_report():
    res = run_checked_node({"FILODB_LOCKCHECK": "1",
                            "FILODB_LOCKCHECK_STRICT": "0"})
    assert res["armed"] == [True, False]
    assert res["rows"] == 1
    assert min(res["flushed"]) >= 0
    assert res["report"]["lockcheck"] == []


def test_page_encode_joins_its_pool_under_a_held_lock_pins_c23():
    """ROADMAP §C.23, closed: ``encode_pages`` over more than
    ``_ENCODE_ROWS`` series, and ``encode_chunks`` over more than one
    batch, encode on the encoders' one pool a process; under a held lock
    (the shard's, in a page-in or a seal) they wait on its futures and
    join no thread, so the checker reports nothing (it reported a
    ``Thread.join`` of a pool made for the call)."""
    import numpy as np

    from filodb_tpu_torch.core.memstore import partition
    from filodb_tpu_torch.memory import chunk

    n = partition._ENCODE_ROWS + 1
    ts = np.arange(8, dtype=np.int64)[None, :].repeat(n, 0) * 10_000
    vals = np.ones((n, 8))
    rows = np.full(n, 8, np.int64)
    with lockcheck.session():
        shard_lock = threading.Lock()
        for _ in range(2):  # the pool's first use, and a later one
            with shard_lock:
                blocks, per = partition.encode_pages(ts, vals, rows)
                chunk._on_threads(lambda s: s, chunk._spans(n))
        vs = lockcheck.violations()
    assert vs == []
    assert len(per) == n and blocks is not None
