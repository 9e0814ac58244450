"""Port parity for the cost model and the adaptive planner.

- One observation sequence, made with numpy from a seed (observations,
  decisions, classifications, deferred settles), goes through both
  packages' ``CostModel``: the same decisions, sources, estimates,
  percentiles and calibration.
- Snapshots are byte-equal both ways (``to_bytes``, and through each
  package's local meta store), so either package reads the other's.
- The ``sidecar`` site (exec leaves on the slice store) and the ``cache``
  site (the extent cache's admission) leave their static arm once the
  model is warm on both arms, and ``FILODB_ADAPTIVE=0`` pins the static
  arm; a cold model answers bit for bit as the static arm does.
- The lifecycle (``install``/``persist``) and the Retry-After provider.
"""

import numpy as np
import pytest

from filodb_tpu.coordinator import adaptive_planner as rap
from filodb_tpu.coordinator.query_service import QueryService as RefService
from filodb_tpu.core.store.localstore import LocalDiskMetaStore as RefMeta
from filodb_tpu.promql.parser import TimeStepParams as RefParams
from filodb_tpu.promql.parser import parse_query as ref_parse
from filodb_tpu.query import cost_model as rcm
from filodb_tpu.utils import governor as rgov
from filodb_tpu_torch.coordinator import adaptive_planner as ap
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.store.localstore import LocalDiskMetaStore
from filodb_tpu_torch.promql.parser import TimeStepParams
from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.utils import governor as gov
from test_torch_slice import (
    CHUNK,
    DS,
    NUM_SHARDS,
    Q_END,
    Q_START,
    Q_STEP,
    _build_stores,
    _series_specs,
    _sorted,
)

SITES = ("sidecar", "cache", "admit", "lane")


@pytest.fixture(autouse=True)
def fresh_models():
    cm.reset_models()
    rcm.reset_models()
    gov.reset()
    rgov.reset()
    yield
    cm.reset_models()
    rcm.reset_models()
    gov.reset()
    rgov.reset()


@pytest.fixture(scope="module")
def stores():
    return _build_stores(_series_specs(), CHUNK)


class _Carrier:
    pass


def _sequence(mod) -> list:
    """The same script of calls on ``mod``'s CostModel; what came out."""
    rng = np.random.default_rng(42)
    m = mod.CostModel("ds", min_samples=3, reservoir=8)
    out = []
    for step in range(400):
        site = SITES[int(rng.integers(0, len(SITES)))]
        sig = f"sig{int(rng.integers(0, 5))}"
        kind = int(rng.integers(0, 4))
        if kind == 0:
            arm = ("a", "b")[int(rng.integers(0, 2))]
            m.observe(site, sig, arm, float(rng.random()))
        elif kind == 1:
            d = m.decide(site, sig, ("a", "b"), static_arm="a",
                         require_all=bool(rng.integers(0, 2)))
            out.append((d.arm, d.source, d.predicted,
                        tuple(sorted(d.alternatives.items()))))
            m.record_actual(d, float(rng.random()))
        elif kind == 2:
            d = m.classify(site, sig, 0.5, "cheap", "keep", "keep")
            out.append((d.arm, d.source, d.predicted))
            c = _Carrier()
            m.defer(c, d)
            if rng.integers(0, 2):
                mod.CostModel.relabel_deferred(c, site, "keep")
            mod.CostModel.settle_deferred(c, float(rng.random()))
        else:
            out.append((m.estimate(site, sig, "a"),
                        m.percentile(site, sig, "b", 0.9),
                        m.samples(site, sig, "wall")))
    snap = m.snapshot()
    snap.pop("recent")
    return out + [snap, sorted(m.calibration().items()), m.to_bytes()]


def test_one_sequence_decides_alike_in_both_packages():
    got, want = _sequence(cm), _sequence(rcm)
    assert got == want
    assert any(o[1] == "model" for o in got[:-3]
               if isinstance(o, tuple) and len(o) > 1
               and isinstance(o[1], str))


def _warm(m):
    rng = np.random.default_rng(3)
    for _ in range(10):
        m.observe("sidecar", "fold:pw1024", "sidecar", float(rng.random()))
        m.observe("sidecar", "fold:pw1024", "decode", float(rng.random()))
        m.observe("admit", "class:expensive", "wall", float(rng.random()))
    d = m.decide("sidecar", "fold:pw1024", ("sidecar", "decode"),
                 static_arm="decode")
    m.record_actual(d, 0.25)


def test_snapshots_are_byte_equal_both_ways(tmp_path):
    port, ref = cm.CostModel("ds", min_samples=2), rcm.CostModel(
        "ds", min_samples=2)
    _warm(port)
    _warm(ref)
    assert port.to_bytes() == ref.to_bytes()
    a, b = cm.CostModel("ds", min_samples=2), rcm.CostModel(
        "ds", min_samples=2)
    assert a.from_bytes(ref.to_bytes()) and b.from_bytes(port.to_bytes())
    assert a.to_bytes() == b.to_bytes() == port.to_bytes()
    # through each package's local meta store, read by the other's
    port.save(LocalDiskMetaStore(str(tmp_path / "p")))
    ref.save(RefMeta(str(tmp_path / "r")))
    assert (tmp_path / "p" / "ds" / "costmodel.json").read_bytes() == \
        (tmp_path / "r" / "ds" / "costmodel.json").read_bytes()
    c, d = cm.CostModel("ds", min_samples=2), rcm.CostModel(
        "ds", min_samples=2)
    assert c.load(RefMeta(str(tmp_path / "p")))
    assert d.load(LocalDiskMetaStore(str(tmp_path / "r")))
    assert c.to_bytes() == d.to_bytes() == port.to_bytes()
    assert c.estimate("sidecar", "fold:pw1024", "decode") == \
        port.estimate("sidecar", "fold:pw1024", "decode")


def test_install_and_persist_lifecycle(tmp_path):
    meta = LocalDiskMetaStore(str(tmp_path))
    m = ap.install(DS, meta, {"min_samples": 2})
    assert gov._retry_after_provider is ap.retry_after_provider
    _warm(m)
    ap.persist(DS, meta)
    cm.reset_models()
    m2 = ap.install(DS, meta, {"min_samples": 2})
    d = m2.decide("sidecar", "fold:pw1024", ("sidecar", "decode"),
                  static_arm="decode")
    assert d.source == "model"
    # the Retry-After of a shed: the EXPENSIVE class's live p90
    assert ap.retry_after_provider("capacity") == pytest.approx(
        m2.percentile("admit", "class:expensive", "wall", 0.9))


# ---------------------------------------------------------------------------
# the sidecar site

# a 25 m window at T holds two sealed chunks of most counters (chunks of
# 64 samples at 10 s), so the lane folds interior summaries there
SIDECAR_Q = "sum(sum_over_time(http_requests_total[25m])) by (job)"
T = Q_START + 1500


def _sidecar_sig(model) -> str:
    return next(r["signature"] for r in model.recent()
                if r["site"] == "sidecar")


def test_the_sidecar_site_decides_as_the_reference(stores, monkeypatch):
    """One instant through exec leaves in both packages: the same
    signature classes, static arm first; warm on both arms with decode
    cheaper, both leave the fold for decode and answer alike."""
    monkeypatch.setenv("FILODB_SIDECARS", "1")
    ref, port = stores
    rsvc = RefService(ref, DS, NUM_SHARDS, spread=1, engine="exec")
    psvc = QueryService(port, device="cpu", engine="exec")
    sigs = []
    for mod, svc in ((rcm, rsvc), (cm, psvc)):
        svc.query_range(SIDECAR_Q, T, 0, T)
        model = mod.model_for(DS)
        rows = [r for r in model.recent() if r["site"] == "sidecar"]
        assert rows and all(r["source"] == "static" and
                            r["arm"] == "sidecar" for r in rows)
        sigs.append(sorted({r["signature"] for r in rows}))
    assert sigs[0] == sigs[1]
    answers = []
    for mod, svc in ((rcm, rsvc), (cm, psvc)):
        model = mod.model_for(DS)
        for sig in sigs[0]:
            for _ in range(model.min_samples):
                model.observe("sidecar", sig, "sidecar", 10.0)
                model.observe("sidecar", sig, "decode", 1e-4)
        before = mod._decided[("sidecar", "model")].value
        r = svc.query_range(SIDECAR_Q, T, 0, T)
        assert mod._decided[("sidecar", "model")].value > before
        r.result.materialize()
        answers.append(_sorted(r))
    assert answers[0][0] == answers[1][0]
    np.testing.assert_allclose(answers[1][1], answers[0][1], rtol=2e-5,
                               atol=1e-6, equal_nan=True)


def test_the_sidecar_site_leaves_the_static_arm_when_warm(stores,
                                                          monkeypatch):
    monkeypatch.setenv("FILODB_SIDECARS", "1")
    _, port = stores
    svc = QueryService(port, device="cpu", engine="exec")
    cold = svc.query_range(SIDECAR_Q, T, 0, T)
    assert not cold.stats.sidecar_bypassed and cold.stats.sidecar_chunks > 0
    model = cm.model_for(DS)
    sig = _sidecar_sig(model)
    # natural traffic under the two static arms: the geometry gate at 1
    # (decode), then at its default (fold), past min_samples each
    model.configure(min_samples=2)
    monkeypatch.setenv("FILODB_SIDECAR_SEALED_GATE", "1")
    for _ in range(2):
        r = svc.query_range(SIDECAR_Q, T, 0, T)
        assert r.stats.sidecar_bypassed.get("static gate")
    monkeypatch.delenv("FILODB_SIDECAR_SEALED_GATE")
    svc.query_range(SIDECAR_Q, T, 0, T)
    assert model.samples("sidecar", sig, "decode") >= 2
    assert model.samples("sidecar", sig, "sidecar") >= 2
    # the aggregation's pushdown decision (static: its leaves are local)
    # settles with each query too, last: the rows before it are read
    rows = [r for r in model.recent(8) if r["site"] != "pushdown"]
    assert rows[0]["source"] == "model"
    # pin decode cheaper, then the kill switch
    for _ in range(20):
        model.observe("sidecar", sig, "decode", 1e-6)
    r = svc.query_range(SIDECAR_Q, T, 0, T)
    assert r.stats.sidecar_bypassed.get("static gate")
    monkeypatch.setenv("FILODB_ADAPTIVE", "0")
    r0 = svc.query_range(SIDECAR_Q, T, 0, T)
    assert not r0.stats.sidecar_bypassed and r0.stats.sidecar_chunks > 0
    assert [r for r in model.recent()
            if r["site"] != "pushdown"][0]["source"] == "static"
    np.testing.assert_allclose(_sorted(r)[1], _sorted(r0)[1], rtol=2e-5,
                               atol=1e-6, equal_nan=True)


def test_a_cold_model_answers_bit_for_bit_as_the_static_arm(stores,
                                                           monkeypatch):
    monkeypatch.setenv("FILODB_SIDECARS", "1")
    _, port = stores
    out = []
    for valve in ("0", "1"):
        cm.reset_models()
        monkeypatch.setenv("FILODB_ADAPTIVE", valve)
        svc = QueryService(port, device="cpu", engine="exec",
                           result_cache=True)
        for q, step in ((SIDECAR_Q, 0), ("sum(rate(http_requests_total[5m]))"
                                         " by (job)", Q_STEP)):
            start, end = (T, T) if step == 0 else (Q_START, Q_END)
            r = svc.query_range(q, start, step, end)
            out.append((valve, r.result.num_series,
                        np.asarray(r.result.values).tobytes()))
        assert all(row["source"] != "model"
                   for row in cm.model_for(DS).recent())
    assert [o[1:] for o in out[:2]] == [o[1:] for o in out[2:]]


# ---------------------------------------------------------------------------
# the cache site


RANGE_Q = "sum(rate(http_requests_total[5m])) by (job)"


def _cheap_keys(svc) -> int:
    return len(svc.result_cache._cheap)


@pytest.mark.parametrize("adaptive", ["1", "0"])
def test_the_cache_site_admits_cheap_extents_when_warm(stores, monkeypatch,
                                                       adaptive):
    _, port = stores
    monkeypatch.setenv("FILODB_ADAPTIVE", adaptive)
    svc = QueryService(port, device="cpu", result_cache={"extent_steps": 8})
    svc.query_range(RANGE_Q, Q_START, Q_STEP, Q_END)
    model = cm.model_for(DS)
    # a classification settles under the recompute time ("wall")
    rows = [r for r in model.recent() if r["site"] == "cache"]
    assert rows and all(r["source"] == "static" for r in rows)
    assert _cheap_keys(svc) == 0
    sig = rows[0]["signature"]
    for _ in range(40):
        model.observe("cache", sig, "wall", 1e-5)  # cheap to recompute
    svc.result_cache.clear()
    svc.query_range(RANGE_Q, Q_START, Q_STEP, Q_END)
    rows = [r for r in model.recent(len(rows)) if r["site"] == "cache"]
    if adaptive == "1":
        # the first extent settled after the warm-up goes in cheap; its
        # own recompute time then moves the estimate back up
        assert rows[-1]["source"] == "model"
        assert _cheap_keys(svc) >= 1
    else:
        assert all(r["source"] == "static" for r in rows)
        assert _cheap_keys(svc) == 0


def test_admission_classing_follows_the_model(stores):
    """The ``admit`` site: a warm prediction under the threshold admits a
    range query as CHEAP, so it survives CRITICAL as an instant does."""
    _, port = stores
    svc = QueryService(port, device="cpu")
    gov.governor().set_state(gov.CRITICAL)
    with pytest.raises(gov.QueryRejected):
        svc.query_range(RANGE_Q, Q_START, Q_STEP, Q_END)
    plan = svc._parse_cached(RANGE_Q, TimeStepParams(Q_START, Q_STEP,
                                                     Q_END))
    # the signature class is the reference's, so a persisted model carries
    assert ap.plan_signature_class(plan) == rap.plan_signature_class(
        ref_parse(RANGE_Q, RefParams(Q_START, Q_STEP, Q_END)))
    model = cm.model_for(DS)
    for _ in range(model.min_samples):
        model.observe("admit", ap.plan_signature_class(plan), "wall", 1e-4)
    r = svc.query_range(RANGE_Q, Q_START, Q_STEP, Q_END)
    assert r.result.num_series > 0
    assert model.recent(1)[0]["site"] == "admit"
