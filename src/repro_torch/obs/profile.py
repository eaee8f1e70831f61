"""Launch profiling: pair static preflight plans with measured wall time.

A copy of ``repro.obs.profile``.

The preflight layer (:mod:`repro_torch.analysis.launchplan`) predicts each
launch's shape — grid cells, launch count, peak shared memory — before anything
runs.  This module closes the loop: every executed launch records a
:class:`LaunchRecord` carrying both the plan's static fields and the
measured wall time, so planned-vs-measured residuals (``us_per_grid_cell``
per operand, plan-accuracy drift across dtypes) are queryable from one
place instead of re-derived from benchmark JSON.

The kernel layer (:mod:`repro_torch.kernels.ops`) must not depend on the
service layer, so it reaches the profiler through the module-level
:func:`install`/:func:`active` hook: when no profiler is installed the
hook is a single global read and kernels pay nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque

__all__ = [
    "LaunchProfiler",
    "LaunchRecord",
    "active",
    "install",
    "profiled",
]


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One executed launch: the plan's static story plus the measured one.

    ``k`` counts logical launches covered by this record (a streamed
    operand issues one core call per slab; callers that time the whole
    sweep pass ``k=n_slabs``).  Plan fields are ``None`` when the launch
    had no preflight plan (e.g. dense FFT fallback).
    """

    op: str
    operand: str
    wall_us: float
    k: int = 1
    kernel: str | None = None
    n_launches: int | None = None
    grid_cells: int | None = None
    planned_ok: bool | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class LaunchProfiler:
    """Bounded buffer of :class:`LaunchRecord` + residual aggregates."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._records: deque[LaunchRecord] = deque(maxlen=capacity)
        self.dropped = 0

    def record(self, *, op: str, operand: str, wall_us: float, k: int = 1,
               plan=None, kernel: str | None = None) -> LaunchRecord:
        """Append one record; ``plan`` is a ``LaunchPlan`` (or None)."""
        if plan is not None:
            rec = LaunchRecord(
                op=op, operand=operand, wall_us=float(wall_us), k=k,
                kernel=kernel if kernel is not None else plan.kernel,
                n_launches=plan.n_launches,
                grid_cells=plan.grid_cells,
                planned_ok=plan.ok,
            )
        else:
            rec = LaunchRecord(op=op, operand=operand,
                               wall_us=float(wall_us), k=k, kernel=kernel)
        if len(self._records) == self._records.maxlen:
            self.dropped += 1
        self._records.append(rec)
        return rec

    def records(self, operand: str | None = None) -> list[LaunchRecord]:
        if operand is None:
            return list(self._records)
        return [r for r in self._records if r.operand == operand]

    def by_operand(self) -> dict:
        """Aggregate per (op, operand): measured wall stats joined with the
        plan's static predictions — the planned-vs-measured residual table."""
        groups: dict[tuple[str, str], list[LaunchRecord]] = {}
        for rec in self._records:
            groups.setdefault((rec.op, rec.operand), []).append(rec)
        out = {}
        for (op, operand), recs in sorted(groups.items()):
            walls = [r.wall_us for r in recs]
            calls = sum(r.k for r in recs)
            row = {
                "op": op,
                "operand": operand,
                "count": len(recs),
                "calls": calls,
                "wall_us_mean": sum(walls) / len(walls),
                "wall_us_min": min(walls),
                "wall_us_max": max(walls),
            }
            planned = [r for r in recs if r.grid_cells is not None]
            if planned:
                last = planned[-1]
                row["kernel"] = last.kernel
                row["n_launches"] = last.n_launches
                row["grid_cells"] = last.grid_cells
                row["planned_ok"] = last.planned_ok
                if last.grid_cells:
                    # measured cost per planned grid cell: the residual the
                    # static model cannot see (cache misses, gather cost)
                    per_call = row["wall_us_mean"] / max(recs[-1].k, 1)
                    row["us_per_grid_cell"] = per_call / last.grid_cells
            out[f"{op}/{operand}"] = row
        return out

    def residuals(self) -> dict:
        """Alias for :meth:`by_operand` under its analysis-facing name."""
        return self.by_operand()

    def reset(self) -> None:
        self._records.clear()
        self.dropped = 0


#: process-wide hook the kernel layer reads; service installs its profiler
_ACTIVE: LaunchProfiler | None = None


def install(profiler: LaunchProfiler | None) -> LaunchProfiler | None:
    """Install the process-wide profiler; returns the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = profiler
    return prev


def active() -> LaunchProfiler | None:
    return _ACTIVE


@contextlib.contextmanager
def profiled(profiler: LaunchProfiler):
    """Scoped :func:`install` that restores the previous hook on exit."""
    prev = install(profiler)
    try:
        yield profiler
    finally:
        install(prev)
