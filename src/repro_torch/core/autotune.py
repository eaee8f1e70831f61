"""SELL layout selection on a Hopper budget.

The port's counterpart of ``repro.core.autotune``: the paper's co-design
loop picks the SELL-C-sigma layout (C, sigma) from the *measured* pad
factor of the operand's row lengths.  The reference scores each candidate
with the SDV cycle model; on an H100 a SIMT instruction is one 32-thread
warp whatever C is, so that model saw every warp-multiple C at the same
vector length and ranked layouts by pad factor alone.  The port therefore
ranks by pad factor directly, and brings the cycle model back once the
card's memory latencies are measured (ROADMAP A14).  What else changes on
an H100 is the budget the RHS tile is priced against.

The TPU tuner sizes ``k_block`` so that the whole ``(n_cols, k_block)`` X
block fits VMEM (64 MiB, double-buffered); a 2M-column operand fails that
filter at any k > 1 and is tuned to ``k_block = 1``.  On Hopper X is not
staged in fast memory at all: it stays in device memory, its gathers go
through the 50 MB L2, and each CUDA thread keeps its ``k_tile`` partial
sums in registers.  So :func:`pick_k_block` prices the per-thread
accumulators against the register file, never X residency, and coalesced
request groups keep their full RHS width on million-column operands.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.sparse.formats import next_pow2, sigma_sort_order, slice_widths

#: Threads per warp: the SIMT group one SELL slice column is walked by.
WARP = 32
#: Threads per block of the SELL SpMM kernel (8 warps).
SPMM_BLOCK_THREADS = 256
#: Largest RHS tile the SpMM kernel is instantiated for (its k_tile
#: template values are the powers of two 1 .. 32).
MAX_K_TILE = 32
#: Register bytes a thread may spend on its k_tile accumulators: 64 of
#: the 255 32-bit registers a thread can hold, i.e. 32 fp64 partial sums,
#: leaving the rest for addresses, the loaded (col, val) pair and the
#: gathered X values.
ACC_BYTES_PER_THREAD = 256
#: Value dtypes the SpMM kernel is instantiated for.
KERNEL_DTYPES = ("float32", "float64")
#: Smallest SELL slice height the packer is asked for.
MIN_C = 8
#: Width tile kept in the tune schema for the reference's cache format;
#: the Hopper kernel walks a slice's whole bucket width in one thread, so
#: w_block does not shape its launch.
W_BLOCK = 8


@dataclasses.dataclass(frozen=True)
class SellTuneResult:
    """A tuned SELL layout; the same fields as the reference's, so the
    TuneCache JSON schema is shared between the packages.  The port ranks
    by pad factor, so its ``cycles`` (the score) is the pad factor."""

    c: int
    sigma: int
    w_block: int
    cycles: float
    pad_factor: float
    #: (c, sigma, measured pad_factor, score) per candidate
    table: tuple[tuple[int, int, float, float], ...]
    #: RHS tile of the batched SpMM core (RHS columns one thread carries)
    k_block: int = 8
    #: streaming-schedule tiles of the reference (kernel B2, not ported);
    #: carried so cache entries round-trip unchanged
    col_tile: int = 1 << 16
    row_tile: int = 8


def candidate_vls(max_vl: int = 1024, min_vl: int = MIN_C) -> list[int]:
    """Power-of-two slice heights from ``min_vl`` up to ``max_vl``."""
    out = []
    v = min_vl
    while v <= max_vl:
        out.append(v)
        v *= 2
    return out


def measured_pad_factor(
    row_lengths: np.ndarray, c: int, sigma: int, pow2_buckets: bool = True
) -> float:
    """padded_nnz / nnz of the SELL-C-sigma layout on *these* row lengths.

    Computed with the packer's own helpers (sigma-window sort, per-C-slice
    max width, power-of-two bucket rounding) without building the layout,
    so the tuner can sweep (C, sigma) cheaply and can never disagree with
    what :func:`repro_torch.sparse.formats.csr_to_sell_slabs` builds.
    """
    n = len(row_lengths)
    if n == 0:
        return 1.0
    lengths = np.asarray(row_lengths, np.int64)
    order = sigma_sort_order(lengths, sigma)
    widths = slice_widths(lengths, order, c)
    if pow2_buckets:
        widths = next_pow2(widths)
    return float(widths.sum() * c) / max(int(lengths.sum()), 1)


def pick_k_block(elem_bytes: int = 8, k_max: int = MAX_K_TILE) -> int:
    """Largest power-of-two RHS tile whose accumulators fit a thread.

    One thread of the SpMM kernel owns one (slice, lane) row and carries
    ``k_tile`` running sums in registers across the whole bucket width, so
    the tile is bounded by :data:`ACC_BYTES_PER_THREAD` — 32 at fp64 — and
    by the kernel's instantiations (:data:`MAX_K_TILE`).  X is gathered
    from device memory whatever its size, so ``n_cols`` does not enter.
    Wider is better up to the cap: each slab entry loaded is reused across
    every RHS column of the tile.
    """
    k = 1
    while k * 2 <= k_max and (k * 2) * elem_bytes <= ACC_BYTES_PER_THREAD:
        k *= 2
    return k


def tune_sell_layout(
    row_lengths: np.ndarray,
    candidates_c: Sequence[int] | None = None,
    sigma_factors: Sequence[int] = (1, 4, 8, 32),
    cache=None,
    cache_key: str | None = None,
) -> SellTuneResult:
    """Co-select (C, sigma) and the RHS tile for the SELL SpMM kernel.

    For every candidate the tuner *measures* the pad factor the packer
    would produce on the given row lengths and keeps the least (the first
    candidate on a tie).  B1 reads every padded slab entry, so the pad
    factor is what the layout adds to its bytes.  Without explicit
    ``candidates_c`` the sweep prefers slice heights that are whole warps
    (32 .. 1024): a C below 32 leaves a warp straddling slices of different
    widths.  Smaller C are swept only when the operand has fewer than 32
    rows.  X's size does not enter the Hopper tune.

    ``cache``/``cache_key`` plug in a persistent tune store (duck-typed
    ``get_sell``/``put_sell``, e.g.
    :class:`repro_torch.service.tunecache.TuneCache`): the cache is
    consulted before any pad factor is measured, and a miss records its
    result.
    """
    if cache is not None and cache_key is not None:
        hit = cache.get_sell(cache_key)
        if hit is not None:
            return hit
    lengths = np.asarray(row_lengths, np.int64)
    n_rows = len(lengths)
    if candidates_c is not None:
        cands = list(candidates_c)
    else:
        cands = [v for v in candidate_vls() if v <= max(n_rows, MIN_C)]
        cands = [v for v in cands if v % WARP == 0] or cands
    if not cands:
        raise ValueError("no candidate slice height C to tune over")
    rows: list[tuple[int, int, float, float]] = []
    for c in cands:
        seen: set[int] = set()
        for f in sigma_factors:
            sigma = min(max(f * c, c), max(n_rows, 1))
            if sigma in seen:
                continue
            seen.add(sigma)
            pf = measured_pad_factor(lengths, c, sigma)
            rows.append((c, sigma, pf, pf))
    best = min(rows, key=lambda r: r[3])
    result = SellTuneResult(
        c=best[0],
        sigma=best[1],
        w_block=W_BLOCK,
        cycles=best[3],
        pad_factor=best[2],
        table=tuple(rows),
        k_block=pick_k_block(),
    )
    if cache is not None and cache_key is not None:
        cache.put_sell(cache_key, result)
    return result
