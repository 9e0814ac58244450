"""Query result model.

Port of ``filodb_tpu/query/model.py`` (``RangeVectorKey``, ``StepMatrix``,
``QueryStats``, ``QueryResult``): a batch of series keys plus a dense
[P, K] value matrix over shared step timestamps, NaN marking "no sample".
The engine hands values over as a torch tensor on its device;
``materialize`` brings them to host numpy (float64) and applies any
compaction deferred while they lived on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from filodb_tpu_torch.core.partkey import METRIC_LABEL


@dataclass(frozen=True)
class RangeVectorKey:
    """Series identity: a frozen, sorted label set."""

    labels: tuple[tuple[str, str], ...]

    @staticmethod
    def of(labels: dict[str, str]) -> "RangeVectorKey":
        return RangeVectorKey(tuple(sorted(labels.items())))

    @property
    def label_map(self) -> dict[str, str]:
        return dict(self.labels)

    def without(self, names) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple((k, v) for k, v in self.labels
                                    if k not in ns))

    def only(self, names) -> "RangeVectorKey":
        ns = set(names)
        return RangeVectorKey(tuple((k, v) for k, v in self.labels if k in ns))

    def drop_metric(self) -> "RangeVectorKey":
        return self.without((METRIC_LABEL,))

    def __str__(self) -> str:
        return "{" + ",".join(f"{k}={v}" for k, v in self.labels) + "}"


@dataclass
class StepMatrix:
    """Series sharing step timestamps: values [P, K] (numpy after
    ``materialize``, possibly a device tensor before)."""

    keys: list[RangeVectorKey]
    values: "np.ndarray | torch.Tensor"
    steps_ms: np.ndarray  # int64 [K] epoch millis
    pending_compact: bool = False

    @property
    def num_series(self) -> int:
        return len(self.keys)

    @property
    def num_steps(self) -> int:
        return len(self.steps_ms)

    @staticmethod
    def empty(steps_ms: np.ndarray) -> "StepMatrix":
        return StepMatrix([], np.zeros((0, len(steps_ms))), steps_ms)

    def materialize(self) -> "StepMatrix":
        """Host float64 values; drop all-NaN series if compaction was
        asked for (an aggregate's empty groups)."""
        if isinstance(self.values, torch.Tensor):
            self.values = self.values.detach().to("cpu", torch.float64) \
                .numpy()
        if self.pending_compact:
            self.pending_compact = False
            keep = ~np.all(np.isnan(self.values), axis=1)
            if not keep.all():
                self.keys = [k for k, m in zip(self.keys, keep) if m]
                self.values = self.values[keep]
        return self


@dataclass
class QueryStats:
    series_scanned: int = 0
    samples_scanned: int = 0
    result_series: int = 0
    wall_time_s: float = 0.0
    # leaves whose magnitudes failed the float32 gate and ran in float64
    precise_lane: int = 0


@dataclass
class QueryResult:
    result: StepMatrix
    stats: QueryStats = field(default_factory=QueryStats)
