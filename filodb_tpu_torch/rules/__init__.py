"""Standing queries: recording rules and alert evaluation on ingest."""

from filodb_tpu_torch.rules.model import (
    AlertingRule,
    RecordingRule,
    RuleGroup,
    load_groups,
)
from filodb_tpu_torch.rules.manager import LogSink, MemstoreSink, RuleManager
from filodb_tpu_torch.rules.notify import AlertEvent, WebhookNotifier

__all__ = [
    "AlertEvent",
    "AlertingRule",
    "RecordingRule",
    "RuleGroup",
    "RuleManager",
    "LogSink",
    "MemstoreSink",
    "WebhookNotifier",
    "load_groups",
]
