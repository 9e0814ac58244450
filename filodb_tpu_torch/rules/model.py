"""Rule definitions: recording and alerting rules parsed from the
``rules:`` config block.

Mirrors the Prometheus rule-file shape (groups of rules with a shared
evaluation ``interval``), restricted to what the standing-query engine
supports: intervals must be whole seconds (the range-query grid is epoch
seconds) and each rule is exactly one of ``record:`` or ``alert:``.
Durations accept either Prometheus duration strings (via
``parse_duration_ms``) or bare numbers meaning seconds.

Copy of ``filodb_tpu/rules/model.py``: the same dataclasses, the same
validations and the same messages.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from filodb_tpu_torch.promql.parser import parse_duration_ms

# record-rule output metric names must round-trip through the selector
# lexer; single colons are the conventional level:metric:operation form
# (``job:http_requests:rate5m``).  ``::`` is reserved by the parser's
# metric::column extension and is rejected up front.
_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_:]*$")

# group names are interpolated into recovery selectors as label values
# (and so are alert names, which additionally must be valid metric names
# per _NAME_RE, matching Prometheus); restrict both to a charset that
# can never break the selector lexer — no quotes, backslashes, or braces
_GROUP_NAME_RE = re.compile(r"^[A-Za-z0-9_.:/\- ]+$")

# synthetic series owned by the manager; a recording rule shadowing one
# would corrupt alert-state recovery
_RESERVED_NAMES = {"ALERTS", "ALERTS_FOR_STATE", "FILODB_RULES_WATERMARK"}

# labels a rule may not override: output identity, alert state, and the
# recovery scope stamp are assigned by the evaluator itself
_RESERVED_LABELS = {"__name__", "_metric_", "alertstate", "_group_"}


@dataclass(frozen=True)
class RecordingRule:
    """``record: <name>`` — expr output written back as series ``name``."""

    record: str
    expr: str
    labels: tuple[tuple[str, str], ...] = ()

    @property
    def name(self) -> str:
        return self.record


@dataclass(frozen=True)
class AlertingRule:
    """``alert: <name>`` — expr output drives inactive→pending→firing."""

    alert: str
    expr: str
    for_ms: int = 0
    labels: tuple[tuple[str, str], ...] = ()
    annotations: tuple[tuple[str, str], ...] = ()

    @property
    def name(self) -> str:
        return self.alert


@dataclass(frozen=True)
class RuleGroup:
    """A set of rules sharing one evaluation interval and watermark."""

    name: str
    interval_ms: int
    dataset: str
    rules: tuple = field(default_factory=tuple)

    @property
    def interval_s(self) -> int:
        return self.interval_ms // 1000


def _duration_ms(value, what: str) -> int:
    if isinstance(value, bool):
        raise ValueError(f"rules: {what} must be a duration, got {value!r}")
    if isinstance(value, (int, float)):
        return int(value * 1000)
    if isinstance(value, str):
        ms = parse_duration_ms(value)
        if ms == 0 and value not in ("0", "0s", "0ms"):
            raise ValueError(f"rules: unparseable duration {value!r} "
                             f"for {what}")
        return ms
    raise ValueError(f"rules: {what} must be a duration, got {value!r}")


def _label_pairs(raw, what: str) -> tuple[tuple[str, str], ...]:
    if not raw:
        return ()
    if not isinstance(raw, dict):
        raise ValueError(f"rules: {what} must be a mapping")
    for k in raw:
        if k in _RESERVED_LABELS:
            raise ValueError(f"rules: {what} may not set reserved "
                             f"label {k!r}")
    return tuple(sorted((str(k), str(v)) for k, v in raw.items()))


def _load_rule(raw: dict, group: str):
    if not isinstance(raw, dict):
        raise ValueError(f"rules: group {group!r}: rule must be a mapping")
    has_record = "record" in raw
    has_alert = "alert" in raw
    if has_record == has_alert:
        raise ValueError(f"rules: group {group!r}: rule must have exactly "
                         f"one of record:/alert:")
    expr = raw.get("expr")
    if not expr or not isinstance(expr, str):
        raise ValueError(f"rules: group {group!r}: rule needs a non-empty "
                         f"expr:")
    labels = _label_pairs(raw.get("labels"), f"group {group!r} labels")
    if has_record:
        name = str(raw["record"])
        if not _NAME_RE.match(name) or "::" in name:
            raise ValueError(f"rules: invalid record name {name!r}")
        if name in _RESERVED_NAMES:
            raise ValueError(f"rules: record name {name!r} is reserved")
        if "for" in raw or "annotations" in raw:
            raise ValueError(f"rules: record rule {name!r} may not set "
                             f"for:/annotations:")
        return RecordingRule(record=name, expr=expr, labels=labels)
    name = str(raw["alert"])
    if not _NAME_RE.match(name):
        # alert names become the alertname label value AND the recovery
        # selector; Prometheus applies the same metric-name restriction
        raise ValueError(f"rules: invalid alert name {name!r}")
    for_ms = _duration_ms(raw.get("for", 0), f"alert {name!r} for:")
    if for_ms < 0:
        raise ValueError(f"rules: alert {name!r} for: must be >= 0")
    ann = raw.get("annotations") or {}
    if not isinstance(ann, dict):
        raise ValueError(f"rules: alert {name!r} annotations must be a "
                         f"mapping")
    return AlertingRule(
        alert=name, expr=expr, for_ms=for_ms, labels=labels,
        annotations=tuple(sorted((str(k), str(v)) for k, v in ann.items())))


def load_groups(block, default_dataset: str) -> list[RuleGroup]:
    """Parse the ``rules.groups`` config list into validated RuleGroups."""
    groups_raw = (block or {}).get("groups", [])
    if not isinstance(groups_raw, list):
        raise ValueError("rules: groups must be a list")
    out: list[RuleGroup] = []
    seen: set[str] = set()
    for g in groups_raw:
        if not isinstance(g, dict) or not g.get("name"):
            raise ValueError("rules: each group needs a name:")
        name = str(g["name"])
        if not _GROUP_NAME_RE.match(name):
            raise ValueError(f"rules: invalid group name {name!r} (group "
                             f"names appear in recovery selectors)")
        if name in seen:
            raise ValueError(f"rules: duplicate group name {name!r}")
        seen.add(name)
        interval_ms = _duration_ms(g.get("interval", "60s"),
                                   f"group {name!r} interval:")
        if interval_ms < 1000 or interval_ms % 1000:
            raise ValueError(f"rules: group {name!r} interval must be a "
                             f"whole number of seconds >= 1s")
        rules = tuple(_load_rule(r, name) for r in g.get("rules", []))
        rule_names = [r.name for r in rules]
        if len(rule_names) != len(set(rule_names)):
            raise ValueError(f"rules: duplicate rule name in group {name!r}")
        out.append(RuleGroup(name=name, interval_ms=interval_ms,
                             dataset=str(g.get("dataset", default_dataset)),
                             rules=rules))
    return out
