"""Restart supervisor: run a (resumable) job, restoring from checkpoints on
failure, with bounded retries and backoff (a stdlib copy of
``repro.runtime.supervisor``).

The train loop is written to resume exactly from its last checkpoint, so the
supervisor's contract is simply "call it again"; on a cluster this process
sits outside the job (borg/k8s/slurm restart policy) — here it is in-process
so the fault-tolerance path is testable on CPU.
"""
from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")


class RestartBudgetExceeded(RuntimeError):
    pass


def run_with_restarts(
    job: Callable[[], T],
    *,
    max_restarts: int = 3,
    backoff_s: float = 0.0,
    on_restart: Callable[[int, Exception], None] | None = None,
    retryable: tuple[type[Exception], ...] = (RuntimeError,),
) -> tuple[T, int]:
    """Run ``job`` to completion, restarting on retryable failures.

    Returns (result, n_restarts).  Non-retryable exceptions propagate.
    """
    restarts = 0
    while True:
        try:
            return job(), restarts
        except retryable as e:  # noqa: PERF203
            restarts += 1
            if restarts > max_restarts:
                raise RestartBudgetExceeded(
                    f"gave up after {max_restarts} restarts: {e}"
                ) from e
            if on_restart:
                on_restart(restarts, e)
            if backoff_s:
                time.sleep(backoff_s * restarts)
