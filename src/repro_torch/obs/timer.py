"""The one wall-clock code path for the port's serving stack.

A copy of ``repro.obs.timer`` (the port imports nothing of ``repro``).

Every wall-time measurement in the repo flows through this module: the
``timer-discipline`` lint rule (``repro.analysis.rules``) forbids raw
``time.perf_counter()`` / ``time.time()`` calls in serving-path code, so
span timestamps, request latencies and launch profiles all read the same
clock and can be compared without unit or epoch surprises.

Host-side clock only: a caller timing CUDA work synchronizes the device
first (``torch.cuda.synchronize()``), since kernel launches return before
the card finishes.  The clock is ``time.perf_counter`` — monotonic, highest available
resolution, *not* wall-epoch time: values are only meaningful as
differences or against other ``now_*`` readings in the same process.
"""
from __future__ import annotations

import time

__all__ = ["Stopwatch", "now_s", "now_us"]


def now_s() -> float:
    """Monotonic process clock in seconds (the repo's one timing source)."""
    return time.perf_counter()


def now_us() -> float:
    """Monotonic process clock in microseconds (span-timestamp unit)."""
    return time.perf_counter() * 1e6


class Stopwatch:
    """Context-manager stopwatch over the shared clock.

    ::

        with Stopwatch() as sw:
            work()
        wall = sw.elapsed_us

    ``elapsed_*`` reads the live clock while the watch is running and the
    frozen stop time after ``stop()``/``__exit__`` — so one watch can both
    report mid-flight laps and a final total.
    """

    __slots__ = ("t0", "t1")

    def __init__(self):
        self.t0: float | None = None
        self.t1: float | None = None

    def start(self) -> "Stopwatch":
        self.t0 = now_s()
        self.t1 = None
        return self

    def stop(self) -> "Stopwatch":
        self.t1 = now_s()
        return self

    def __enter__(self) -> "Stopwatch":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def elapsed_s(self) -> float:
        if self.t0 is None:
            return 0.0
        return (self.t1 if self.t1 is not None else now_s()) - self.t0

    @property
    def elapsed_us(self) -> float:
        return self.elapsed_s * 1e6
