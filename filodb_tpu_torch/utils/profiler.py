"""Built-in sampling profiler.

Copy of ``filodb_tpu/utils/profiler.py``. Counterpart of reference
``standalone/src/main/java/filodb/standalone/SimpleProfiler.java:36``
(558-line stack-sampling profiler started by FiloServer): samples all
thread stacks at a fixed interval, aggregates hot frames, and
periodically logs a top-N report. Pure stdlib (``sys._current_frames``).
"""

from __future__ import annotations

import logging
import sys
import threading
import time
import traceback
from collections import Counter

log = logging.getLogger(__name__)


class SimpleProfiler:
    def __init__(self, sample_interval_s: float = 0.01,
                 report_interval_s: float = 60.0, top_n: int = 20):
        self.sample_interval_s = sample_interval_s
        self.report_interval_s = report_interval_s
        self.top_n = top_n
        self._counts: Counter = Counter()
        self._samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "SimpleProfiler":
        if self._thread:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="simple-profiler")
        self._thread.start()
        return self

    def _loop(self):
        last_report = time.monotonic()
        me = threading.get_ident()
        while not self._stop.wait(self.sample_interval_s):
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack = traceback.extract_stack(frame, limit=1)
                if stack:
                    f = stack[-1]
                    self._counts[f"{f.filename}:{f.lineno} {f.name}"] += 1
            self._samples += 1
            if time.monotonic() - last_report >= self.report_interval_s:
                log.info("profiler report:\n%s", self.report())
                last_report = time.monotonic()

    def report(self, top_n: int | None = None) -> str:
        total = sum(self._counts.values()) or 1
        lines = [f"{n:6d} ({100.0 * n / total:5.1f}%)  {frame}"
                 for frame, n in self._counts.most_common(top_n or self.top_n)]
        return "\n".join(lines)

    def stop(self) -> str:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        return self.report()
