"""Step-time heartbeat + straggler detection (a stdlib copy of
``repro.runtime.heartbeat``).

At 1000-node scale, the dominant cheap signal for sick hosts is per-step wall
time skew: a straggling worker stretches every synchronous step.  The
StepMonitor keeps a rolling median and flags steps slower than
``threshold x median`` — the supervisor can then trigger checkpoint + evict.
(Single-process here; on a real cluster each host reports its own step time
through the coordination service and the lead aggregates.)
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import deque


@dataclasses.dataclass
class StragglerEvent:
    step: int
    wall_s: float
    median_s: float

    @property
    def slowdown(self) -> float:
        return self.wall_s / max(self.median_s, 1e-9)


class StepMonitor:
    def __init__(self, window: int = 32, threshold: float = 3.0, warmup: int = 3):
        self.window = window
        self.threshold = threshold
        self.warmup = warmup
        self._times: deque[float] = deque(maxlen=window)
        self.straggler_events: list[StragglerEvent] = []
        self._count = 0

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0

    def record(self, step: int, wall_s: float) -> StragglerEvent | None:
        self._count += 1
        event = None
        # compile-warmup steps are excluded from the baseline
        if self._count > self.warmup and self._times:
            med = self.median
            if wall_s > self.threshold * med:
                event = StragglerEvent(step=step, wall_s=wall_s, median_s=med)
                self.straggler_events.append(event)
        if self._count > self.warmup or self._count == self.warmup:
            self._times.append(wall_s)
        return event
