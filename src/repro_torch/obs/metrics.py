"""Metrics registry: counters, gauges and streaming histograms.

A copy of ``repro.obs.metrics``.

The serving stack's numeric observability surface.  A
:class:`MetricsRegistry` owns named instruments; callers get-or-create by
name (``registry.counter("submitted")``) so instrumentation sites never
coordinate construction.  Three instrument kinds:

* :class:`Counter` — monotonically growing event tally (requests served,
  launches, rejections);
* :class:`Gauge` — last-write-wins level (queue depth, in-flight slots,
  planned shared-memory bytes of the most recent admitted launch plan);
* :class:`Histogram` — streaming log-bucketed distribution with O(1)
  memory and ~±9% quantile error (per-op-class request latency, coalesced
  group size, launch wall time).

:class:`CounterDict` is the migration shim for frozen dict-of-ints stats
contracts (``KernelService.stats``): a ``MutableMapping`` view whose
entries are live registry counters — the registry is the source of truth,
the dict spelling keeps every existing dashboard and test working.
"""
from __future__ import annotations

import json
import math
from collections.abc import MutableMapping
from typing import Iterator

__all__ = [
    "Counter",
    "CounterDict",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]


class Counter:
    """Monotonic event tally.  ``set()`` exists for dict-view migration
    (``stats[k] += 1`` reads then writes) — going backwards is refused so
    a counter can never silently un-count events."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: int | float = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {n})")
        self.value += n

    def set(self, value: int | float) -> None:
        if value < self.value:
            raise ValueError(
                f"counter {self.name!r} cannot decrease ({self.value} -> {value})")
        self.value = value

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins level (queue depth, in-flight, planned bytes)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: int | float = 0

    def set(self, value: int | float) -> None:
        self.value = value

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def dec(self, n: int | float = 1) -> None:
        self.value -= n

    def snapshot(self):
        return self.value


#: geometric bucket base: 2**(1/4) => worst-case quantile error ~±9%
_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(_BASE)


class Histogram:
    """Streaming log-bucketed histogram: O(buckets) memory, any value range.

    Buckets are geometric with base ``2**(1/4)``; ``observe`` is a log and
    a dict increment, ``percentile`` walks the cumulative counts and
    reports the geometric midpoint of the landing bucket — a ~±9%
    relative-error estimate that never retains the observations
    themselves (a long-running server must not grow per-request state).
    Non-positive values land in a dedicated zero bucket.
    """

    __slots__ = ("name", "help", "count", "total", "min", "max", "_buckets")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: dict[int | None, int] = {}

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        idx = None if value <= 0.0 else math.floor(math.log(value) / _LOG_BASE)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile (0..100), within ~±9% relative error."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        # zero bucket sorts first; geometric buckets in index order
        keys = sorted(self._buckets, key=lambda k: -math.inf if k is None else k)
        for key in keys:
            seen += self._buckets[key]
            if seen >= rank:
                if key is None:
                    return min(self.min, 0.0)
                # geometric midpoint of [base^k, base^(k+1)), clamped to the
                # observed range so estimates never leave the data
                mid = _BASE ** (key + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": round(self.mean, 3),
            "min": 0.0 if self.count == 0 else round(self.min, 3),
            "max": 0.0 if self.count == 0 else round(self.max, 3),
            "p50": round(self.percentile(50), 3),
            "p95": round(self.percentile(95), 3),
            "p99": round(self.percentile(99), 3),
        }


class MetricsRegistry:
    """Named instruments, get-or-create by (name, kind).

    Re-requesting a name returns the existing instrument; requesting it as
    a different kind is a hard error (two sites silently updating
    different objects under one name is the bug this refuses to allow).
    """

    def __init__(self):
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, help: str):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, help)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested as {cls.__name__}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, help)

    def get(self, name: str):
        return self._instruments[name]

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def snapshot(self) -> dict:
        """JSON-able {name: value-or-distribution} of every instrument."""
        return {name: self._instruments[name].snapshot()
                for name in self.names()}

    def dump_json(self, path_or_file) -> None:
        """Write :meth:`snapshot` as JSON (the obs_report input format)."""
        if hasattr(path_or_file, "write"):
            json.dump(self.snapshot(), path_or_file, indent=2, sort_keys=True)
        else:
            with open(path_or_file, "w", encoding="utf-8") as fh:
                json.dump(self.snapshot(), fh, indent=2, sort_keys=True)


class CounterDict(MutableMapping):
    """Frozen-key dict view over registry counters.

    Every read/write goes straight to the backing :class:`Counter`, so
    ``stats["served"] += 1`` updates the registry and dashboards reading
    either surface agree by construction.  The key set is fixed at
    construction (the published contract): writing an unknown key raises
    ``KeyError`` and deletion is refused — a stats schema cannot drift by
    accident.
    """

    def __init__(self, registry: MetricsRegistry, keys, help_by_key=None):
        help_by_key = help_by_key or {}
        self._order = tuple(keys)
        self._counters = {
            k: registry.counter(k, help=help_by_key.get(k, "")) for k in keys}

    def __getitem__(self, key: str):
        return self._counters[key].value

    def __setitem__(self, key: str, value) -> None:
        counter = self._counters.get(key)
        if counter is None:
            raise KeyError(
                f"{key!r} is not in the frozen stats key set {self._order}")
        counter.set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("stats keys are a frozen contract; cannot delete")

    def __iter__(self) -> Iterator[str]:
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def __repr__(self) -> str:
        return repr(dict(self))
