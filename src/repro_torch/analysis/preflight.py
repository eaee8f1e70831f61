"""Hopper launch-plan builder for the SELL SpMM kernel.

:func:`plan_spmm_sell` mirrors the launch arithmetic of
:func:`repro_torch.kernels.sell_core.spmm_sell` without importing or
running it: per width bucket one launch of ``SPMM_BLOCK_THREADS``-thread
blocks, one thread per (slice, lane) row, ``grid = (ceil(S_b * C /
threads), k_pad / k_tile)``.  Checked contracts:

* grid and block dims inside CUDA's limits (the kernel claims no shared
  memory: its sums live in registers);
* pow2 padding invariants: ``k_block`` and every packed bucket width are
  powers of two;
* the RHS tile fits the kernel: ``k_tile <= MAX_K_TILE`` accumulators
  within the per-thread register budget;
* column indices in ``[PAD, n_cols)`` (``SlabMeta.from_slabs(check_bounds=
  True)`` scans once) — the kernel gathers ``X[col]`` unchecked;
* dtype flow: int32 indices, slab values and X of one dtype, float32 or
  float64 only (the kernel's instantiations).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.analysis.launchplan import BlockPlan, LaunchPlan, is_pow2
from repro_torch.core.autotune import (
    ACC_BYTES_PER_THREAD,
    KERNEL_DTYPES,
    MAX_K_TILE,
    SPMM_BLOCK_THREADS,
)
from repro_torch.sparse.formats import PAD, pow2_ceil

__all__ = ["SlabMeta", "plan_spmm_sell"]

#: CUDA launch limits (compute capability 9.0)
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65_535
MAX_BLOCK_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class SlabMeta:
    """The launch-relevant metadata of a packed SELL matrix operand.

    Cheap to extract (O(n_buckets) shape reads); the optional index-bounds
    scan is one vectorized min/max over the stored indices.
    """

    c: int
    widths: tuple[int, ...]         # padded W per bucket
    n_slices: tuple[int, ...]       # slices per bucket
    n_rows: int
    n_cols: int
    val_dtype: str
    idx_dtype: str
    idx_min: int | None = None      # None = bounds not scanned
    idx_max: int | None = None

    @classmethod
    def from_slabs(cls, slabs, check_bounds: bool = False) -> "SlabMeta":
        """Extract metadata from host :class:`~repro_torch.sparse.formats.SellSlabs`."""
        if not hasattr(slabs, "bucket_cols"):
            raise TypeError(f"expected SellSlabs, got {type(slabs).__name__}")
        cols = slabs.bucket_cols
        idx_min = idx_max = None
        if check_bounds:
            idx_min = min(int(np.min(a)) for a in cols if a.size)
            idx_max = max(int(np.max(a)) for a in cols if a.size)
        return cls(
            c=int(cols[0].shape[2]),
            widths=tuple(int(a.shape[1]) for a in cols),
            n_slices=tuple(int(a.shape[0]) for a in cols),
            n_rows=int(slabs.n_rows), n_cols=int(slabs.n_cols),
            val_dtype=str(slabs.bucket_vals[0].dtype),
            idx_dtype=str(cols[0].dtype),
            idx_min=idx_min, idx_max=idx_max,
        )

    def describe(self) -> str:
        return (f"matrix {self.n_rows}x{self.n_cols} "
                f"C={self.c} buckets={list(self.widths)}")


def plan_spmm_sell(
    meta: SlabMeta,
    k: int = 1,
    x_dtype: str | None = None,
    *,
    k_block: int = 8,
) -> LaunchPlan:
    """Plan ``spmm_sell`` for a (n_cols, k) RHS stack against these slabs."""
    violations: list[str] = []
    if not is_pow2(k_block):
        violations.append(f"k_block {k_block} is not a power of two")
    if k < 1:
        violations.append(f"RHS stack must have k >= 1 columns, got {k}")
    for i, w in enumerate(meta.widths):
        if not is_pow2(w):
            violations.append(
                f"bucket {i} width {w} is not a power of two (packer "
                "invariant broken)")
    if meta.idx_dtype != "int32":
        violations.append(
            f"index dtype {meta.idx_dtype} != int32 (kernel gather contract)")
    if meta.idx_max is not None and meta.idx_max >= meta.n_cols:
        violations.append(
            f"stored index {meta.idx_max} out of bounds for n_cols="
            f"{meta.n_cols} (the kernel would read outside X)")
    if meta.idx_min is not None and meta.idx_min < PAD:
        violations.append(
            f"stored index {meta.idx_min} below the PAD sentinel ({PAD})")
    if meta.val_dtype not in KERNEL_DTYPES:
        violations.append(
            f"slab value dtype {meta.val_dtype} is not float32 or float64")
    if x_dtype is not None and x_dtype != meta.val_dtype:
        violations.append(
            f"RHS dtype {x_dtype} != slab value dtype {meta.val_dtype}")
    vb = int(np.dtype(meta.val_dtype).itemsize) \
        if meta.val_dtype in KERNEL_DTYPES else 8
    k_tile = min(max(int(k_block), 1), pow2_ceil(max(k, 1)))
    k_pad = k_tile * math.ceil(max(k, 1) / k_tile)
    if k_tile > MAX_K_TILE or k_tile * vb > ACC_BYTES_PER_THREAD:
        violations.append(
            f"k_tile {k_tile} x {vb} B accumulators exceed the per-thread "
            f"register budget ({ACC_BYTES_PER_THREAD} B, k_tile <= "
            f"{MAX_K_TILE})")
    threads = SPMM_BLOCK_THREADS
    if threads > MAX_BLOCK_THREADS:
        violations.append(f"block of {threads} threads > {MAX_BLOCK_THREADS}")
    grid_y = k_pad // k_tile
    if grid_y > MAX_GRID_Y:
        violations.append(
            f"{grid_y} k tiles exceed grid.y limit {MAX_GRID_Y} "
            f"(k={k}, k_block={k_block})")
    dtype = x_dtype or meta.val_dtype
    blocks = []
    for i, (s, w) in enumerate(zip(meta.n_slices, meta.widths)):
        grid_x = math.ceil(s * meta.c / threads)
        if grid_x > MAX_GRID_X:
            violations.append(
                f"bucket {i} (W={w}): grid.x {grid_x} > {MAX_GRID_X}")
        blocks.append(BlockPlan(
            label=f"bucket{i}[W={w}]",
            grid=(grid_x, grid_y),
            block=(threads,),
            operands=(
                ("cols", (s, w, meta.c), meta.idx_dtype),
                ("vals", (s, w, meta.c), meta.val_dtype),
                ("rows", (s, meta.c), meta.idx_dtype),
                ("x", (meta.n_cols, k_pad), dtype),
                ("y", (meta.n_rows + 1, k_pad), meta.val_dtype),
            ),
        ))
    return LaunchPlan(
        kernel="spmm_sell", operand=meta.describe(), dtype=meta.val_dtype,
        blocks=tuple(blocks),
        violations=tuple(violations),
    )
