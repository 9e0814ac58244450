"""The port's runtime shared-state race sanitizer (``utils/racecheck.py``).

The cases of ``tests/test_racecheck.py`` against the port's copy: each
scenario registers fresh objects INSIDE an installed session (only
objects registered after install are tracked) and checks what the
Eraser-style lockset tracker records — and what it does not. Guard
identity comes from lockcheck's creation-site keys, so every scenario
runs under both checkers. Then the switch: ``FILODB_RACECHECK=1`` arms
the sanitizer (and lockcheck with it) at ``import filodb_tpu_torch`` in a
fresh interpreter, where a node on the CPU ingests, flushes, answers a
query over HTTP and shuts down with no report from either; and the
shard map and its manager register as the reference's do. Every test
runs under a time limit of its own.
"""

import signal
import threading

import pytest
from test_torch_lockcheck import run_checked_node

from filodb_tpu_torch.utils import lockcheck, racecheck

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
def _clean_install(_time_limit):
    racecheck.uninstall()
    lockcheck.uninstall()
    yield
    racecheck.uninstall()
    lockcheck.uninstall()


class Shared:
    pass


def write_from_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


class TestLockset:
    def test_guard_free_write_flagged(self):
        with racecheck.session():
            obj = racecheck.register(Shared(), "t.obj")
            write_from_thread(lambda: setattr(obj, "x", 1))
            obj.x = 2
            vs = racecheck.violations()
        assert [v.kind for v in vs] == ["guard-free"]
        assert "t.obj.x" in vs[0].detail

    def test_common_guard_clean(self):
        with racecheck.session():
            lk = threading.Lock()
            obj = racecheck.register(Shared(), "t.obj")

            def w():
                with lk:
                    obj.x = 1

            write_from_thread(w)
            with lk:
                obj.x = 2
            vs = racecheck.violations()
        assert vs == []

    def test_mixed_guard_flagged(self):
        with racecheck.session():
            la = threading.Lock()
            lb = threading.Lock()
            obj = racecheck.register(Shared(), "t.obj")

            def w():
                with la:
                    obj.x = 1

            write_from_thread(w)
            with lb:
                obj.x = 2
            vs = racecheck.violations()
        assert [v.kind for v in vs] == ["mixed-guard"]

    def test_single_thread_needs_no_lock(self):
        # Eraser's point: single-threaded state is not a race, however
        # it is written
        with racecheck.session():
            obj = racecheck.register(Shared(), "t.obj")
            obj.x = 1
            with threading.Lock():
                obj.x = 2
            obj.x = 3
            vs = racecheck.violations()
        assert vs == []

    def test_one_outer_lock_among_several_clean(self):
        # writers may hold extra locks as long as ONE stays common
        with racecheck.session():
            common = threading.Lock()
            extra = threading.Lock()
            obj = racecheck.register(Shared(), "t.obj")

            def w():
                with common:
                    with extra:
                        obj.x = 1

            write_from_thread(w)
            with common:
                obj.x = 2
            vs = racecheck.violations()
        assert vs == []

    def test_duplicate_shapes_reported_once(self):
        with racecheck.session():
            obj = racecheck.register(Shared(), "t.obj")
            write_from_thread(lambda: setattr(obj, "x", 1))
            for i in range(5):
                obj.x = i
            vs = racecheck.violations()
        assert len(vs) == 1

    def test_unregistered_object_ignored(self):
        with racecheck.session():
            racecheck.register(Shared(), "t.tracked")
            loose = Shared()   # same class, never registered
            write_from_thread(lambda: setattr(loose, "x", 1))
            loose.x = 2
            vs = racecheck.violations()
        assert vs == []

    def test_strict_mode_raises(self):
        with racecheck.session(strict=True):
            obj = racecheck.register(Shared(), "t.obj")
            write_from_thread(lambda: setattr(obj, "x", 1))
            with pytest.raises(racecheck.RaceViolation):
                obj.x = 2


class TestTrackedDict:
    def test_per_key_guard_free_flagged(self):
        with racecheck.session():
            d = racecheck.tracked_dict("t.map")
            write_from_thread(lambda: d.__setitem__("k", 1))
            d["k"] = 2
            vs = racecheck.violations()
        assert [v.kind for v in vs] == ["guard-free"]
        assert "t.map" in vs[0].detail

    def test_distinct_keys_are_distinct_cells(self):
        # two threads each owning their own key is not a race
        with racecheck.session():
            d = racecheck.tracked_dict("t.map")
            write_from_thread(lambda: d.__setitem__("a", 1))
            d["b"] = 2
            vs = racecheck.violations()
        assert vs == []

    def test_stays_a_real_dict(self):
        with racecheck.session():
            d = racecheck.tracked_dict("t.map", {"a": 1})
            assert isinstance(d, dict)
            assert dict(d) == {"a": 1}
            d.update(b=2)
            assert d.pop("a") == 1
            assert d.setdefault("c", 3) == 3
            d.clear()
            assert d == {}

    def test_plain_dict_when_uninstalled(self):
        d = racecheck.tracked_dict("t.map", {"a": 1})
        assert type(d) is dict


class TestWireCompat:
    def test_registered_manifest_still_encodes(self):
        # the tracker patches __setattr__ on the ORIGINAL class — it
        # must never swap __class__, because wire encode checks exact
        # class identity. The port's wire does not carry the migration
        # manifest (its status goes as a dict), so the manifest is held
        # to its own durable bytes and a wire-registered class to the
        # wire
        from filodb_tpu_torch.coordinator import wire
        from filodb_tpu_torch.coordinator.migration import MigrationManifest
        from filodb_tpu_torch.query.model import PlannerParams

        with racecheck.session():
            m = MigrationManifest("ds", 3, "a", "b")
            assert type(m) is MigrationManifest
            m.phase = "syncing"   # tracked write keeps working
            assert MigrationManifest.from_bytes(m.to_bytes()) == m
            p = racecheck.register(PlannerParams(), "t.params")
            assert type(p) is PlannerParams
            assert wire.decode(wire.encode(p)) == p
            p.spread = 2
            assert wire.decode(wire.encode(p)).spread == 2


class TestLifecycle:
    def test_install_installs_lockcheck_and_uninstall_undoes(self):
        assert not lockcheck.installed()
        racecheck.install()
        assert racecheck.installed()
        # guard sets come from lockcheck's held stack, so install
        # piggybacks it...
        assert lockcheck.installed()
        racecheck.uninstall()
        assert not racecheck.installed()
        # ...and uninstall tears the piggyback down again
        assert not lockcheck.installed()

    def test_does_not_steal_existing_lockcheck(self):
        lockcheck.install(strict=False)
        racecheck.install()
        racecheck.uninstall()
        assert lockcheck.installed()
        lockcheck.uninstall()

    def test_class_patch_removed_on_uninstall(self):
        racecheck.install()
        obj = racecheck.register(Shared(), "t.obj")
        assert "__setattr__" in Shared.__dict__
        racecheck.uninstall()
        assert "__setattr__" not in Shared.__dict__
        obj.x = 1   # plain write, no tracking, no error

    def test_register_is_noop_when_uninstalled(self):
        obj = Shared()
        assert racecheck.register(obj, "t.obj") is obj
        assert "__setattr__" not in Shared.__dict__

    def test_reset_clears_cells_and_violations(self):
        racecheck.install()
        obj = racecheck.register(Shared(), "t.obj")
        write_from_thread(lambda: setattr(obj, "x", 1))
        obj.x = 2
        assert racecheck.violations()
        racecheck.reset()
        assert racecheck.violations() == []
        # cells cleared too: the next write pair re-evaluates fresh
        write_from_thread(lambda: setattr(obj, "x", 3))
        obj.x = 4
        assert [v.kind for v in racecheck.violations()] == ["guard-free"]
        racecheck.uninstall()

    def test_metrics_registry_swapped_and_restored(self):
        from filodb_tpu_torch.utils import metrics
        racecheck.install()
        assert isinstance(metrics._registry, racecheck._TrackedDict)
        racecheck.uninstall()
        assert type(metrics._registry) is dict

    def test_env_flag(self, monkeypatch):
        monkeypatch.delenv("FILODB_RACECHECK", raising=False)
        assert not racecheck.enabled_by_env()
        monkeypatch.setenv("FILODB_RACECHECK", "0")
        assert not racecheck.enabled_by_env()
        monkeypatch.setenv("FILODB_RACECHECK", "1")
        assert racecheck.enabled_by_env()


class TestRegistrations:
    def test_shard_map_writes_are_tracked(self):
        # the map's owner writes it under the manager's lock; a write from
        # another thread without it is a report
        from filodb_tpu_torch.coordinator.shardmapper import ShardManager

        with racecheck.session():
            sm = ShardManager("ds", 4)
            sm.add_member("a")
            write_from_thread(lambda: setattr(sm.mapper, "num_shards", 4))
            sm.mapper.num_shards = 4
            vs = racecheck.violations()
        assert [v.kind for v in vs] == ["guard-free"]
        assert "ShardMapper.num_shards" in vs[0].detail


def test_env_switch_arms_a_node_with_no_report():
    res = run_checked_node({"FILODB_RACECHECK": "1"})
    assert res["armed"] == [True, True]
    assert res["rows"] == 1
    assert min(res["flushed"]) >= 0
    assert res["report"]["racecheck"] == []
    assert res["report"]["lockcheck"] == []
