"""Histogram values as the store hands them over.

Trimmed copy of ``filodb_tpu/memory/codecs.py``: only ``HistogramColumn``,
the decoded form of a histogram vector. The port's chunks keep device pages
only (one timestamp page plus one int page per bucket, see
``query/engine/device_batch.py``), so NibblePack and the 2D-delta codec are
not copied.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HistogramColumn:
    """Decoded histogram vector: bucket upper bounds + cumulative count rows."""

    les: np.ndarray  # (nb,) float64 bucket upper bounds ("le" values)
    rows: np.ndarray  # (n, nb) int64 cumulative counts per row
