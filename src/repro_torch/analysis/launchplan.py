"""Static launch plans: what a CUDA launch will ask of the card.

The port's own counterpart of ``repro.analysis.launchplan``.  A
:class:`LaunchPlan` is what a kernel launch will need — grid and block
dims, per-operand shapes, dtype flow — derived from operand *metadata*
alone, before anything is uploaded or launched.
The plan carries its contract verdict: builders in
:mod:`repro_torch.analysis.preflight` record every violated contract in
:attr:`LaunchPlan.violations`, and :meth:`LaunchPlan.raise_if_invalid`
turns a non-empty verdict into a structured :class:`LaunchPlanError`.

On a TPU a bad plan fails to compile or clamps an out-of-bounds gather;
on a GPU the same mistake is a refused launch or a read of unrelated
memory, so the preflight is the only place it is caught cleanly.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "BlockPlan",
    "LaunchPlan",
    "LaunchPlanError",
    "is_pow2",
]


def is_pow2(x: int) -> bool:
    """True for positive powers of two (the padding invariant of the SELL
    bucket widths and the tuned k_block tile)."""
    return x >= 1 and (x & (x - 1)) == 0


class LaunchPlanError(ValueError):
    """A launch contract would be violated; the launch must not happen.

    ``kernel`` names the entry point, ``violations`` lists every broken
    contract, ``plan`` (when available) is the full offending plan.
    """

    def __init__(self, kernel: str, violations, plan: "LaunchPlan | None" = None):
        self.kernel = kernel
        self.violations = tuple(violations)
        self.plan = plan
        super().__init__(
            f"launch preflight failed for {kernel}: "
            + "; ".join(self.violations)
        )


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """One kernel launch of the launch set (one SELL bucket, one FFT
    stage): its grid and block dims, the shape and dtype of every operand
    it touches, and the dynamic shared memory a block claims."""

    label: str                                  # e.g. "bucket0[W=8]"
    grid: tuple[int, ...]
    block: tuple[int, ...]
    operands: tuple[tuple[str, tuple[int, ...], str], ...]  # (name, shape, dtype)
    smem_bytes: int = 0

    @property
    def grid_cells(self) -> int:
        return math.prod(self.grid) if self.grid else 0


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Static description of one kernel launch set, with contract verdict."""

    kernel: str                 # spmm_sell
    operand: str                # short human description of the operand
    dtype: str                  # value/compute dtype flowing through the kernel
    blocks: tuple[BlockPlan, ...]
    violations: tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def n_launches(self) -> int:
        return len(self.blocks)

    @property
    def grid_cells(self) -> int:
        return sum(b.grid_cells for b in self.blocks)

    def raise_if_invalid(self) -> "LaunchPlan":
        """Return self when every contract holds; raise otherwise."""
        if self.violations:
            raise LaunchPlanError(self.kernel, self.violations, plan=self)
        return self

    def summary(self) -> dict:
        """JSON-able observability record (what the service exposes)."""
        return {
            "kernel": self.kernel,
            "operand": self.operand,
            "dtype": self.dtype,
            "ok": self.ok,
            "n_launches": self.n_launches,
            "grid_cells": self.grid_cells,
            "violations": list(self.violations),
        }
