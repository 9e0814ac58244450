"""The cost model bound to the node's admission and lifecycle.

Copy of ``filodb_tpu/coordinator/adaptive_planner.py``:
``admission_class`` replaces the static ``start == end`` class with the
learned wall-time prediction of the plan's signature class (CHEAP below
``cheap_threshold_s``; a cold model gives the static class);
``retry_after_provider`` advises a shed's ``Retry-After`` from the live p90
of the saturating class; ``install`` loads persisted estimates at boot and
``persist`` saves them at shutdown.
"""

from __future__ import annotations

from filodb_tpu_torch.query import cost_model as cm
from filodb_tpu_torch.utils import governor as gov

# Predicted wall time below which a query classes CHEAP (overridable via
# the "cost_model" config block). Matches the intent of the static
# heuristic: instant-style evaluations are the ones that stay admissible
# under a CRITICAL governor.
_DEFAULTS = {"cheap_threshold_s": 0.05}
_cheap_threshold_s = _DEFAULTS["cheap_threshold_s"]


def configure(dataset: str, cfg: dict | None) -> cm.CostModel:
    """Apply the ``cost_model`` config block to the dataset's model."""
    global _cheap_threshold_s
    model = cm.model_for(dataset)
    cfg = cfg or {}
    model.configure(
        min_samples=cfg.get("min_samples"),
        max_signatures=cfg.get("max_signatures"),
        reservoir=cfg.get("reservoir"),
        ring_capacity=cfg.get("ring_capacity"),
    )
    thr = cfg.get("cheap_threshold_s")
    if thr is not None:
        _cheap_threshold_s = float(thr)
    return model


def plan_signature_class(plan) -> str:
    """Signature class for a logical plan: the result cache's canonical
    retimed signature (extent-independent), hashed to a stable key."""
    from filodb_tpu_torch.query.result_cache import plan_signature

    return cm.signature_key(plan_signature(plan))


def admission_class(dataset: str, plan, qcontext, static_cost: str) -> str:
    """CHEAP/EXPENSIVE from predicted wall time; the decision defers onto
    ``qcontext`` and settles with the query's actual wall time so the
    prediction keeps calibrating. Only the shape-heuristic class is ever
    replaced — RULES and planner-forced classes pass through untouched."""
    if static_cost not in (gov.CHEAP, gov.EXPENSIVE):
        return static_cost
    model = cm.model_for(dataset)
    d = model.classify(
        "admit",
        plan_signature_class(plan),
        _cheap_threshold_s,
        below_arm=gov.CHEAP,
        above_arm=gov.EXPENSIVE,
        static_arm=static_cost,
    )
    model.defer(qcontext, d)
    return d.arm


def settle_query(dataset: str, qcontext, wall_s: float,
                 cost_class: str | None = None) -> None:
    """Settle everything deferred onto the query context (admission
    classing, pushdown decisions) and feed the per-class latency
    reservoir that Retry-After reads."""
    cm.CostModel.settle_deferred(qcontext, wall_s)
    if cost_class:
        cm.model_for(dataset).observe(
            "admit", f"class:{cost_class}", "wall", wall_s)


def retry_after_provider(reason: str):
    """Advisory Retry-After for a shed: the live p90 wall time of the
    class saturating the admission gate — how long until a slot
    plausibly frees. None (cold model everywhere) keeps the static
    constant."""
    cls = gov.RULES if reason == "rules" else gov.EXPENSIVE
    best = None
    for model in cm.models().values():
        p = model.percentile("admit", f"class:{cls}", "wall", 0.9)
        if p is None and cls != gov.CHEAP:
            p = model.percentile("admit", f"class:{gov.CHEAP}", "wall", 0.9)
        if p is not None and (best is None or p > best):
            best = p
    return best


def install(dataset: str, meta_store=None, cfg: dict | None = None) -> cm.CostModel:
    """Server-start hook: configure + load persisted estimates + register
    the live Retry-After source."""
    model = configure(dataset, cfg)
    if meta_store is not None:
        model.load(meta_store)
    gov.set_retry_after_provider(retry_after_provider)
    return model


def persist(dataset: str, meta_store) -> None:
    """Checkpoint learned estimates through the metastore."""
    if meta_store is None:
        return
    cm.model_for(dataset).save(meta_store)
