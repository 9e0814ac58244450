"""Online per-(dataset, plan-signature-class) cost model.

Copy of ``filodb_tpu/query/cost_model.py``. An either/or decision of the
query path asks :meth:`CostModel.decide` for the predicted-cheaper arm and
settles the observed wall time back with :meth:`CostModel.record_actual`
(or through :meth:`CostModel.defer` where the settle point is downstream).
The port's sites: ``sidecar`` (the sidecar lane's fold against the decode
lane), ``cache`` (the extent cache's admission priority), ``admit`` (the
governor's CHEAP/EXPENSIVE class) and ``lane`` (the adaptive engine's
lanes); ``pyramid``, ``pushdown`` and ``paging`` belong to modules not
ported (ROADMAP A6, A7) and keep their metric series.

Each (site, signature class, arm) keeps an EWMA (the first two samples
replace, then ``est += 0.3 (v - est)``) and a reservoir of recent samples
for percentiles; the table is LRU-bounded. A cold model is the static
behaviour, bit for bit: a site departs from its static arm only when
``FILODB_ADAPTIVE`` is not ``"0"`` and every competing arm has
``min_samples`` observations.

Models persist through the meta store (``write_cost_model`` /
``read_cost_model``) as the reference's bytes, so either package reads a
snapshot the other wrote.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from filodb_tpu_torch.utils.metrics import get_counter, get_gauge
from filodb_tpu_torch.utils.tracing import FlightRecorder

__all__ = [
    "SITES",
    "Decision",
    "CostModel",
    "bucket",
    "enabled",
    "model_for",
    "models",
    "reset_models",
    "signature_key",
]

# The known decision sites. Metrics are pre-created per site at import so
# scrapes expose every series from process start.
SITES = ("sidecar", "pyramid", "pushdown", "lane", "paging", "admit", "cache")

_SOURCES = ("static", "model", "override")

_decided = {
    (s, src): get_counter("filodb_costmodel_decisions", {"site": s, "source": src})
    for s in SITES
    for src in _SOURCES
}
_settled = {s: get_counter("filodb_costmodel_settled", {"site": s}) for s in SITES}
_calib_gauge = {
    s: get_gauge("filodb_costmodel_calibration_error", {"site": s}) for s in SITES
}
_signatures_gauge = get_gauge("filodb_costmodel_signatures")
_evicted = get_counter("filodb_costmodel_evictions")

# EWMA weight for calibration error and arm estimates (the adaptive
# engine's lane router's, so the "lane" site reproduces its routing).
_ALPHA = 0.3


def enabled() -> bool:
    """Adaptive routing valve. Default on; ``FILODB_ADAPTIVE=0`` pins
    every decision site to its static arm regardless of model warmth."""
    return os.environ.get("FILODB_ADAPTIVE", "1") != "0"


def bucket(n: int) -> int:
    """Power-of-two bucket for signature features, so nearby workload
    sizes share one signature class instead of fragmenting the table."""
    n = int(n)
    b = 1
    while b < n and b < (1 << 20):
        b <<= 1
    return b


def signature_key(signature: object) -> str:
    """Stable signature-class key. Short strings pass through (readable in
    ``coststats``); everything else hashes its canonical ``repr`` —
    ``hash()`` is seed-randomized across processes and would break
    persistence."""
    if isinstance(signature, str) and len(signature) <= 64:
        return signature
    import hashlib

    return hashlib.blake2b(repr(signature).encode(), digest_size=8).hexdigest()


@dataclass
class Decision:
    """One routed decision: which arm a site took and why. Carried to the
    settle point (possibly via :meth:`CostModel.defer`) so the observed
    actual lands on the arm that actually ran."""

    site: str
    signature: str
    arm: str
    static_arm: str
    source: str  # "static" | "model" | "override"
    predicted: float | None = None
    alternatives: dict[str, float | None] = field(default_factory=dict)
    # Arm key the actual settles under when it differs from the routing
    # arm (admission classing settles the query's wall time, not the
    # class label's "cost").
    settle_arm: str | None = None


class _ArmStat:
    __slots__ = ("n", "est", "samples")

    def __init__(self, reservoir: int):
        self.n = 0
        self.est = 0.0
        self.samples: deque = deque(maxlen=reservoir)

    def record(self, v: float) -> None:
        self.n += 1
        if self.n <= 2:
            self.est = v
        else:
            self.est += _ALPHA * (v - self.est)
        self.samples.append(v)


class CostModel:
    """Per-dataset online cost model: EWMA + percentile reservoir per
    (site, signature-class, arm), LRU-bounded over signature classes."""

    def __init__(
        self,
        dataset: str = "",
        min_samples: int = 8,
        max_signatures: int = 4096,
        reservoir: int = 64,
    ):
        self.dataset = dataset
        self.min_samples = max(1, int(min_samples))
        self.max_signatures = max(16, int(max_signatures))
        self.reservoir = max(8, int(reservoir))
        self._lock = threading.RLock()
        # (site, sig) -> {arm: _ArmStat}, LRU over keys
        self._stats: OrderedDict[tuple[str, str], dict[str, _ArmStat]] = OrderedDict()
        self._calib: dict[str, float] = {}  # site -> EWMA |pred-actual|/actual
        self._ring = FlightRecorder(capacity=128)
        self._dirty = False

    def configure(
        self,
        min_samples: int | None = None,
        max_signatures: int | None = None,
        reservoir: int | None = None,
        ring_capacity: int | None = None,
    ) -> None:
        with self._lock:
            if min_samples is not None:
                self.min_samples = max(1, int(min_samples))
            if max_signatures is not None:
                self.max_signatures = max(16, int(max_signatures))
            if reservoir is not None:
                self.reservoir = max(8, int(reservoir))
            if ring_capacity is not None:
                self._ring.resize(int(ring_capacity))

    # -- estimate bookkeeping ----------------------------------------------

    def _entry(self, site: str, sig: str, create: bool) -> dict[str, _ArmStat] | None:
        key = (site, sig)
        arms = self._stats.get(key)
        if arms is None:
            if not create:
                return None
            arms = self._stats[key] = {}
            while len(self._stats) > self.max_signatures:
                self._stats.popitem(last=False)
                _evicted.inc()
            _signatures_gauge.set(float(len(self._stats)))
        else:
            self._stats.move_to_end(key)
        return arms

    def observe(self, site: str, signature: object, arm: str, actual_s: float) -> None:
        """Settle an observed cost directly (no prior Decision)."""
        sig = signature_key(signature)
        with self._lock:
            arms = self._entry(site, sig, create=True)
            stat = arms.get(arm)
            if stat is None:
                stat = arms[arm] = _ArmStat(self.reservoir)
            stat.record(float(actual_s))
            self._dirty = True

    def estimate(self, site: str, signature: object, arm: str) -> float | None:
        """Warm EWMA estimate, or None below ``min_samples``."""
        sig = signature_key(signature)
        with self._lock:
            arms = self._entry(site, sig, create=False)
            if not arms:
                return None
            stat = arms.get(arm)
            if stat is None or stat.n < self.min_samples:
                return None
            return stat.est

    def samples(self, site: str, signature: object, arm: str) -> int:
        sig = signature_key(signature)
        with self._lock:
            arms = self._stats.get((site, sig))
            stat = arms.get(arm) if arms else None
            return stat.n if stat is not None else 0

    def percentile(
        self, site: str, signature: object, arm: str, q: float
    ) -> float | None:
        """Reservoir percentile, or None below ``min_samples``."""
        sig = signature_key(signature)
        with self._lock:
            arms = self._stats.get((site, sig))
            stat = arms.get(arm) if arms else None
            if stat is None or stat.n < self.min_samples or not stat.samples:
                return None
            xs = sorted(stat.samples)
            i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
            return xs[i]

    # -- decisions ----------------------------------------------------------

    def decide(
        self,
        site: str,
        signature: object,
        arms: tuple[str, ...],
        static_arm: str,
        override: str | None = None,
        require_all: bool = True,
        min_samples: int | None = None,
    ) -> Decision:
        """Route one decision. Returns the ``static_arm`` unless adaptive
        routing is enabled AND the competing arms are warm (all of them
        when ``require_all``, any subset otherwise — the lane router keeps
        the lane router's min-over-known semantics via ``require_all=False``)."""
        sig = signature_key(signature)
        if override is not None:
            ctr = _decided.get((site, "override"))
            if ctr is not None:
                ctr.inc()
            return Decision(site, sig, override, static_arm, "override")
        need = self.min_samples if min_samples is None else max(1, int(min_samples))
        ests: dict[str, float | None] = {}
        with self._lock:
            table = self._entry(site, sig, create=False) or {}
            for arm in arms:
                stat = table.get(arm)
                ests[arm] = stat.est if stat is not None and stat.n >= need else None
        known = {a: e for a, e in ests.items() if e is not None}
        use_model = (
            enabled()
            and known
            and (len(known) == len(arms) or not require_all)
        )
        if use_model:
            arm = min(known, key=known.get)
            src = "model"
        else:
            arm, src = static_arm, "static"
        ctr = _decided.get((site, src))
        if ctr is not None:
            ctr.inc()
        return Decision(site, sig, arm, static_arm, src, ests.get(arm), ests)

    def classify(
        self,
        site: str,
        signature: object,
        threshold_s: float,
        below_arm: str,
        above_arm: str,
        static_arm: str,
        settle_arm: str = "wall",
    ) -> Decision:
        """Threshold classing (governor CHEAP/EXPENSIVE): the arm is
        picked by comparing the predicted wall time for this signature
        class against ``threshold_s``, not by comparing arm costs. The
        settle lands under ``settle_arm`` so the prediction keeps
        learning from whichever class the query was given."""
        sig = signature_key(signature)
        est = self.estimate(site, sig, settle_arm)
        if enabled() and est is not None:
            arm = below_arm if est < threshold_s else above_arm
            src = "model"
        else:
            arm, src = static_arm, "static"
        ctr = _decided.get((site, src))
        if ctr is not None:
            ctr.inc()
        return Decision(
            site, sig, arm, static_arm, src, est, {settle_arm: est}, settle_arm
        )

    def record_actual(self, decision: Decision, actual_s: float,
                      observe: bool = True) -> None:
        """Settle a decision with its observed cost; feeds the estimator,
        per-site calibration error, and the prediction-vs-actual ring.
        ``observe=False`` skips the estimator update for call sites that
        already fed the sample through :meth:`observe` (the lane router
        mirrors every serve)."""
        arm = decision.settle_arm or decision.arm
        if observe:
            self.observe(decision.site, decision.signature, arm, actual_s)
        ctr = _settled.get(decision.site)
        if ctr is not None:
            ctr.inc()
        pred = decision.predicted
        if pred is not None and actual_s > 0:
            err = abs(pred - actual_s) / max(actual_s, 1e-9)
            with self._lock:
                prev = self._calib.get(decision.site)
                cur = err if prev is None else prev + _ALPHA * (err - prev)
                self._calib[decision.site] = cur
            g = _calib_gauge.get(decision.site)
            if g is not None:
                g.set(cur)
        self._ring.record(
            {
                "site": decision.site,
                "signature": decision.signature,
                "arm": arm,
                "source": decision.source,
                "predicted_s": pred,
                "actual_s": float(actual_s),
            }
        )

    # -- deferred settle ----------------------------------------------------

    def defer(self, carrier: object, decision: Decision) -> None:
        """Attach a decision to a context object whose settle point is
        downstream (e.g. the sidecar gate decides inside the lane but the
        wall time is only known back in the exec leaf)."""
        pend = getattr(carrier, "_cost_decisions", None)
        if pend is None:
            pend = []
            try:
                setattr(carrier, "_cost_decisions", pend)
            except (AttributeError, TypeError):  # frozen carrier: drop
                return
        pend.append((self, decision))

    @staticmethod
    def relabel_deferred(carrier: object, site: str, arm: str) -> None:
        """Re-label pending decisions for ``site`` whose chosen arm did
        NOT run (e.g. the sidecar fold bypassed mid-flight and the decode
        lane served instead): the settle moves to the arm that actually
        ran and the prediction is dropped so calibration error only
        measures honest predictions."""
        pend = getattr(carrier, "_cost_decisions", None)
        if not pend:
            return
        for _, d in pend:
            if d.site == site and d.arm != arm:
                d.settle_arm = arm
                d.predicted = None

    @staticmethod
    def settle_deferred(carrier: object, actual_s: float) -> None:
        """Settle every decision deferred onto ``carrier``; no-op when
        none are pending."""
        pend = getattr(carrier, "_cost_decisions", None)
        if not pend:
            return
        try:
            delattr(carrier, "_cost_decisions")
        except (AttributeError, TypeError):
            pass
        for model, decision in pend:
            model.record_actual(decision, actual_s)

    # -- debug / persistence ------------------------------------------------

    def calibration(self) -> dict[str, float]:
        with self._lock:
            return dict(self._calib)

    def recent(self, limit: int = 0) -> list[dict]:
        entries = list(reversed(self._ring.snapshot()))
        return entries[:limit] if limit and limit > 0 else entries

    def snapshot(self) -> dict:
        """Structured dump for ``filo-cli coststats`` and
        ``/api/v1/debug/costmodel``."""
        with self._lock:
            rows = []
            for (site, sig), arms in self._stats.items():
                for arm, stat in arms.items():
                    xs = sorted(stat.samples)
                    rows.append(
                        {
                            "site": site,
                            "signature": sig,
                            "arm": arm,
                            "n": stat.n,
                            "estimate_s": stat.est,
                            "p50_s": xs[len(xs) // 2] if xs else None,
                            "p90_s": xs[min(len(xs) - 1, int(0.9 * len(xs)))]
                            if xs
                            else None,
                            "warm": stat.n >= self.min_samples,
                        }
                    )
            return {
                "dataset": self.dataset,
                "enabled": enabled(),
                "min_samples": self.min_samples,
                "signatures": len(self._stats),
                "max_signatures": self.max_signatures,
                "calibration_error": dict(self._calib),
                "estimates": rows,
                "recent": self.recent(32),
            }

    def to_bytes(self) -> bytes:
        with self._lock:
            entries = [
                {
                    "site": site,
                    "sig": sig,
                    "arm": arm,
                    "n": stat.n,
                    "est": stat.est,
                    "samples": list(stat.samples),
                }
                for (site, sig), arms in self._stats.items()
                for arm, stat in arms.items()
            ]
            doc = {
                "version": 1,
                "dataset": self.dataset,
                "min_samples": self.min_samples,
                "calibration": dict(self._calib),
                "entries": entries,
            }
        return json.dumps(doc, sort_keys=True).encode()

    def from_bytes(self, raw: bytes) -> bool:
        try:
            doc = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            return False
        if not isinstance(doc, dict) or doc.get("version") != 1:
            return False
        with self._lock:
            self._stats.clear()
            for e in doc.get("entries", ()):
                try:
                    arms = self._entry(str(e["site"]), str(e["sig"]), create=True)
                    stat = _ArmStat(self.reservoir)
                    stat.n = int(e["n"])
                    stat.est = float(e["est"])
                    stat.samples.extend(float(x) for x in e.get("samples", ()))
                    arms[str(e["arm"])] = stat
                except (KeyError, TypeError, ValueError):
                    continue
            self._calib = {
                str(k): float(v)
                for k, v in (doc.get("calibration") or {}).items()
                if isinstance(v, (int, float))
            }
            _signatures_gauge.set(float(len(self._stats)))
            self._dirty = False
        return True

    def save(self, meta_store) -> None:
        """Persist learned estimates through the metastore (no-op when the
        store lacks blob support)."""
        write = getattr(meta_store, "write_cost_model", None)
        if write is None:
            return
        write(self.dataset, self.to_bytes())
        with self._lock:
            self._dirty = False

    def load(self, meta_store) -> bool:
        read = getattr(meta_store, "read_cost_model", None)
        if read is None:
            return False
        raw = read(self.dataset)
        if not raw:
            return False
        return self.from_bytes(raw)

    @property
    def dirty(self) -> bool:
        return self._dirty


# ---------------------------------------------------------------------------
# per-dataset registry

_models: dict[str, CostModel] = {}
_models_lock = threading.Lock()


def model_for(dataset: str) -> CostModel:
    """Process-global per-dataset model (decision sites deep in the query
    path reach it by dataset name rather than by plumbing a handle)."""
    with _models_lock:
        m = _models.get(dataset)
        if m is None:
            m = _models[dataset] = CostModel(dataset)
        return m


def models() -> dict[str, CostModel]:
    with _models_lock:
        return dict(_models)


def reset_models() -> None:
    """Test hook: drop all learned state."""
    with _models_lock:
        _models.clear()
