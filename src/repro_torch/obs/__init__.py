"""Observability for the port's kernel serving path: tracing, metrics,
profiling — a copy of ``repro.obs`` with the same import surface.

* :mod:`repro_torch.obs.timer` — the single host wall-clock code path;
* :mod:`repro_torch.obs.trace` — per-request :class:`Span` trees;
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` and the
  :class:`CounterDict` view ``KernelService.stats`` is served from;
* :mod:`repro_torch.obs.profile` — :class:`LaunchProfiler` pairing each
  launch's static plan with its measured wall time.
"""
from repro_torch.obs.metrics import (
    Counter,
    CounterDict,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.profile import (
    LaunchProfiler,
    LaunchRecord,
    active,
    install,
    profiled,
)
from repro_torch.obs.timer import Stopwatch, now_s, now_us
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "Counter",
    "CounterDict",
    "Gauge",
    "Histogram",
    "LaunchProfiler",
    "LaunchRecord",
    "MetricsRegistry",
    "Span",
    "Stopwatch",
    "Tracer",
    "active",
    "install",
    "now_s",
    "now_us",
    "profiled",
]
