"""Sparse formats for long-vector SpMV (paper §3.1, Gómez et al. [2]).

The port's copy of what its main path needs from ``repro.sparse.formats``:
CSR, the ragged :class:`SellCSigmaMatrix`, the device layout
:class:`SellSlabs`, the vectorized packers and the operand generators.
Every array this module builds is byte-identical to the reference's for
the same inputs (tests hold the two packers against each other), so a
layout packed by either package serves in both.

Packing stays on the host, in numpy, as in the reference.  What is new
here is the boundary to the card: :meth:`SellSlabs.to_device` uploads the
bucket slabs as torch tensors, and :func:`slabs_from_arrays` adopts slabs
packed by the JAX reference.

:class:`SellSlabs` slices are grouped into power-of-two width buckets,
each a dense (n_slices_b, W_b, C) slab plus the row scatter map that
restores the original row order (padding lanes map to ``n_rows``, a dump
slot the kernel wrapper trims).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAD = -1  # column padding sentinel


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed Sparse Row."""

    indptr: np.ndarray    # (n_rows + 1,) int64
    indices: np.ndarray   # (nnz,) int32
    data: np.ndarray      # (nnz,) float
    n_cols: int

    @property
    def n_rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference host SpMV."""
        y = np.zeros(self.n_rows, dtype=np.result_type(self.data, x))
        np.add.at(y, np.repeat(np.arange(self.n_rows), self.row_lengths),
                  self.data * x[self.indices])
        return y


@dataclasses.dataclass(frozen=True)
class SellCSigmaMatrix:
    """SELL-C-sigma: per-slice width, rows sigma-window sorted by length.

    ``slice_cols[s]`` has shape (width_s, C).  ``perm`` maps sorted position
    -> original row id (y must be scattered back through it).
    """

    slice_cols: tuple[np.ndarray, ...]
    slice_vals: tuple[np.ndarray, ...]
    perm: np.ndarray
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def c(self) -> int:
        return self.slice_cols[0].shape[1]

    @property
    def padded_nnz(self) -> int:
        return sum(c.size for c in self.slice_cols)

    @property
    def pad_factor(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)


@dataclasses.dataclass(frozen=True)
class SellSlabs:
    """Device-executable SELL-C-sigma: width-bucketed uniform slabs.

    Slices of the sigma-sorted matrix are grouped by padded width rounded up
    to a power of two; every bucket ``b`` is a dense slice-transposed slab
    ``bucket_cols[b]``/``bucket_vals[b]`` of shape (n_slices_b, W_b, C) that
    a single kernel launch can stream, with ``bucket_rows[b]`` of shape
    (n_slices_b, C) mapping each lane back to its original row id (padding
    lanes map to ``n_rows``, a dump slot the kernel wrapper trims).

    The number of kernel launches is bounded by log2(max_width) while the
    padded-FLOP count tracks the per-slice widths instead of the global max.
    """

    bucket_cols: tuple[np.ndarray, ...]   # each (n_slices_b, W_b, C) int32
    bucket_vals: tuple[np.ndarray, ...]   # each (n_slices_b, W_b, C) float
    bucket_rows: tuple[np.ndarray, ...]   # each (n_slices_b, C) int32
    n_rows: int
    n_cols: int
    nnz: int
    sigma: int

    @property
    def c(self) -> int:
        return self.bucket_cols[0].shape[2]

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_cols)

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(c.shape[1] for c in self.bucket_cols)

    @property
    def n_slices(self) -> int:
        return sum(c.shape[0] for c in self.bucket_cols)

    @property
    def padded_nnz(self) -> int:
        return sum(c.size for c in self.bucket_cols)

    @property
    def pad_factor(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    def to_device(self, device) -> tuple[tuple[torch.Tensor, ...], ...]:
        """The bucket tensors on ``device``: ``(cols, vals, rows)``, each a
        tuple over buckets — int32 cols and rows, vals in their own dtype.
        Packing stays on the host; this is the one upload."""
        def up(arrays):
            return tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays)

        return up(self.bucket_cols), up(self.bucket_vals), up(self.bucket_rows)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference host SpMV: per-bucket gather-MAC + row scatter."""
        xg = np.concatenate([x, np.zeros(1, x.dtype)])
        y = np.zeros(self.n_rows + 1, dtype=np.result_type(self.bucket_vals[0], x))
        for cols, vals, rows in zip(self.bucket_cols, self.bucket_vals, self.bucket_rows):
            safe = np.where(cols == PAD, len(x), cols)
            yb = np.einsum("swc,swc->sc", vals, xg[safe])
            y[rows.reshape(-1)] = yb.reshape(-1)
        return y[: self.n_rows]


# ---------------------------------------------------------------------------
# Conversions (vectorized: numpy argsort/scatter, no per-row Python loops)
# ---------------------------------------------------------------------------


def _nnz_coords(m: CSRMatrix) -> tuple[np.ndarray, np.ndarray]:
    """(row, within-row offset) of every stored entry, in CSR order."""
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int64), m.row_lengths)
    offs = np.arange(m.nnz, dtype=np.int64) - m.indptr[rows]
    return rows, offs


def sigma_sort_order(lengths: np.ndarray, sigma: int) -> np.ndarray:
    """Row order: descending length within each sigma window, stable.

    The single definition of the SELL-C-sigma sort — the packers, the graph
    slab builder, and the tuner's pad model all share it so they can never
    disagree about the layout.
    """
    n = len(lengths)
    win = np.arange(n, dtype=np.int64) // max(int(sigma), 1)
    return np.lexsort((np.arange(n), -np.asarray(lengths), win))


def _sell_flat_pack(
    m: CSRMatrix, c: int, order: np.ndarray, slice_base: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Scatter every nnz into a flat buffer of concatenated (W_s, C) slices.

    ``slice_base[s]`` is the flat offset of slice ``s``'s buffer; within a
    slice, entry (w, lane) lives at ``w * c + lane``.
    """
    total = int(slice_base[-1])
    cols_flat = np.full(total, PAD, np.int32)
    vals_flat = np.zeros(total, m.data.dtype)
    if m.nnz:
        pos_of_row = np.empty(m.n_rows, np.int64)
        pos_of_row[order] = np.arange(m.n_rows)
        rows, offs = _nnz_coords(m)
        pos = pos_of_row[rows]
        flat = slice_base[pos // c] + offs * c + pos % c
        cols_flat[flat] = m.indices
        vals_flat[flat] = m.data
    return cols_flat, vals_flat


def slice_widths(lengths: np.ndarray, order: np.ndarray, c: int) -> np.ndarray:
    """Max row length per C-slice of the sorted order (>= 1), vectorized."""
    n = len(order)
    n_slices = max(-(-n // c), 1)
    padded = np.zeros(n_slices * c, np.int64)
    if n:
        padded[:n] = lengths[order]
    return np.maximum(padded.reshape(n_slices, c).max(axis=1), 1)


def csr_to_sell(m: CSRMatrix, c: int, sigma: int | None = None) -> SellCSigmaMatrix:
    """SELL-C-sigma conversion (sigma defaults to 8*c as in Gómez et al.)."""
    sigma = sigma or 8 * c
    order = sigma_sort_order(m.row_lengths, sigma)
    widths = slice_widths(m.row_lengths, order, c)
    slice_base = np.zeros(len(widths) + 1, np.int64)
    np.cumsum(widths * c, out=slice_base[1:])
    cols_flat, vals_flat = _sell_flat_pack(m, c, order, slice_base)
    slice_cols = tuple(
        cols_flat[slice_base[s] : slice_base[s + 1]].reshape(int(widths[s]), c)
        for s in range(len(widths))
    )
    slice_vals = tuple(
        vals_flat[slice_base[s] : slice_base[s + 1]].reshape(int(widths[s]), c)
        for s in range(len(widths))
    )
    return SellCSigmaMatrix(
        slice_cols=slice_cols,
        slice_vals=slice_vals,
        perm=order,
        n_rows=m.n_rows,
        n_cols=m.n_cols,
        nnz=m.nnz,
    )


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (>= 1) — the scalar form of
    :func:`next_pow2`, shared by the batched-kernel RHS tiling and the
    tuner's width cap so the rounding rule exists once."""
    return 1 << max(int(x) - 1, 0).bit_length()


def next_pow2(x: np.ndarray) -> np.ndarray:
    """Element-wise next power of two (>= 1): the bucket width rounding
    (array form of :func:`pow2_ceil`)."""
    return (2 ** np.ceil(np.log2(np.maximum(x, 1)))).astype(np.int64)


def csr_to_sell_slabs(m: CSRMatrix, c: int, sigma: int | None = None) -> SellSlabs:
    """Pack CSR into width-bucketed device slabs (see :class:`SellSlabs`).

    Slices are sigma-sorted as in :func:`csr_to_sell`, then padded up to the
    next power-of-two width and grouped by that width, keeping slice order
    stable within a bucket.
    """
    sigma = int(sigma or 8 * c)
    lengths = m.row_lengths
    order = sigma_sort_order(lengths, sigma)
    bwidths = next_pow2(slice_widths(lengths, order, c))
    n_slices = len(bwidths)

    # Destination of each slice: buckets ordered by ascending width, slices
    # in original (sorted-position) order within a bucket.
    uniq = np.unique(bwidths)
    dest = np.lexsort((np.arange(n_slices), bwidths))   # bucket-major slice order
    rank_of = np.empty(n_slices, np.int64)
    rank_of[dest] = np.arange(n_slices)
    sizes_in_dest = bwidths[dest] * c
    slice_base_dest = np.zeros(n_slices + 1, np.int64)
    np.cumsum(sizes_in_dest, out=slice_base_dest[1:])
    slice_base = slice_base_dest[rank_of]               # flat offset per slice
    base_full = np.concatenate([slice_base, [slice_base_dest[-1]]])
    cols_flat, vals_flat = _sell_flat_pack(m, c, order, base_full)

    # Row scatter map: sorted position -> original row, pads -> n_rows.
    order_padded = np.full(n_slices * c, m.n_rows, np.int64)
    order_padded[: m.n_rows] = order
    rows_by_slice = order_padded.reshape(n_slices, c).astype(np.int32)

    bucket_cols, bucket_vals, bucket_rows = [], [], []
    for w in uniq:
        ids = np.nonzero(bwidths == w)[0]               # ascending = dest order
        lo = slice_base_dest[rank_of[ids[0]]]
        hi = lo + len(ids) * w * c
        bucket_cols.append(cols_flat[lo:hi].reshape(len(ids), int(w), c))
        bucket_vals.append(vals_flat[lo:hi].reshape(len(ids), int(w), c))
        bucket_rows.append(rows_by_slice[ids])
    return SellSlabs(
        bucket_cols=tuple(bucket_cols),
        bucket_vals=tuple(bucket_vals),
        bucket_rows=tuple(bucket_rows),
        n_rows=m.n_rows,
        n_cols=m.n_cols,
        nnz=m.nnz,
        sigma=sigma,
    )


def sell_to_slabs(sell: SellCSigmaMatrix) -> SellSlabs:
    """Bucket a ragged :class:`SellCSigmaMatrix` into device slabs."""
    c = sell.c
    n_slices = len(sell.slice_cols)
    bwidths = next_pow2(np.array([sc.shape[0] for sc in sell.slice_cols]))
    order_padded = np.full(n_slices * c, sell.n_rows, np.int64)
    order_padded[: sell.n_rows] = sell.perm
    rows_by_slice = order_padded.reshape(n_slices, c).astype(np.int32)
    bucket_cols, bucket_vals, bucket_rows = [], [], []
    for w in np.unique(bwidths):
        ids = np.nonzero(bwidths == w)[0]
        cols = np.full((len(ids), int(w), c), PAD, np.int32)
        vals = np.zeros((len(ids), int(w), c), sell.slice_vals[0].dtype)
        for j, s in enumerate(ids):
            ws = sell.slice_cols[s].shape[0]
            cols[j, :ws] = sell.slice_cols[s]
            vals[j, :ws] = sell.slice_vals[s]
        bucket_cols.append(cols)
        bucket_vals.append(vals)
        bucket_rows.append(rows_by_slice[ids])
    return SellSlabs(
        bucket_cols=tuple(bucket_cols),
        bucket_vals=tuple(bucket_vals),
        bucket_rows=tuple(bucket_rows),
        n_rows=sell.n_rows,
        n_cols=sell.n_cols,
        nnz=sell.nnz,
        sigma=0,
    )


def _coo_to_csr(
    rows: np.ndarray, offs: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    n_rows: int, n_cols: int,
) -> CSRMatrix:
    """Rebuild CSR from (row, within-row offset, col, val) tuples."""
    key = np.lexsort((offs, rows))
    rows, cols, vals = rows[key], cols[key], vals[key]
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return CSRMatrix(indptr=indptr, indices=cols.astype(np.int32),
                     data=vals, n_cols=n_cols)


def sell_slabs_to_csr(slabs: SellSlabs) -> CSRMatrix:
    """Invert :func:`csr_to_sell_slabs`: un-sort and re-pack as CSR."""
    all_rows, all_offs, all_cols, all_vals = [], [], [], []
    for cols, vals, rowmap in zip(slabs.bucket_cols, slabs.bucket_vals, slabs.bucket_rows):
        s, w, lane = np.nonzero(cols != PAD)
        all_rows.append(rowmap[s, lane].astype(np.int64))
        all_offs.append(w)
        all_cols.append(cols[s, w, lane])
        all_vals.append(vals[s, w, lane])
    if not all_rows:
        return CSRMatrix(np.zeros(slabs.n_rows + 1, np.int64),
                         np.empty(0, np.int32),
                         np.empty(0), slabs.n_cols)
    return _coo_to_csr(
        np.concatenate(all_rows), np.concatenate(all_offs),
        np.concatenate(all_cols), np.concatenate(all_vals),
        slabs.n_rows, slabs.n_cols,
    )


def to_csr(matrix) -> CSRMatrix:
    """Normalize any supported format back to CSR (for repacking)."""
    if isinstance(matrix, CSRMatrix):
        return matrix
    if isinstance(matrix, SellSlabs):
        return sell_slabs_to_csr(matrix)
    if isinstance(matrix, SellCSigmaMatrix):
        return sell_slabs_to_csr(sell_to_slabs(matrix))
    raise TypeError(f"unsupported sparse format: {type(matrix).__name__}")


def slabs_from_arrays(src) -> SellSlabs:
    """Adopt the numpy fields of a SELL slab container packed elsewhere.

    ``src`` is duck-typed: any object with ``bucket_cols`` /
    ``bucket_vals`` / ``bucket_rows`` / ``n_rows`` / ``n_cols`` / ``nnz`` /
    ``sigma`` attributes — in particular a ``repro.sparse.formats.SellSlabs``
    packed by the JAX reference — becomes this package's
    :class:`SellSlabs` with the same bytes.  The layout contract is checked
    here, because the CUDA kernel trusts it: int32 indices, every bucket
    ``(S_b, W_b, C)`` with one C, ``bucket_rows[b]`` of shape ``(S_b, C)``
    with ids in ``[0, n_rows]``, one value dtype.
    """
    cols = tuple(np.ascontiguousarray(a) for a in src.bucket_cols)
    vals = tuple(np.ascontiguousarray(a) for a in src.bucket_vals)
    rows = tuple(np.ascontiguousarray(a) for a in src.bucket_rows)
    n_rows, n_cols = int(src.n_rows), int(src.n_cols)
    if not (len(cols) == len(vals) == len(rows)) or not cols:
        raise ValueError("need one cols/vals/rows array per bucket, >= 1 bucket")
    c = cols[0].shape[2] if cols[0].ndim == 3 else -1
    for b, (cb, vb, rb) in enumerate(zip(cols, vals, rows)):
        if cb.ndim != 3 or cb.shape != vb.shape or cb.shape[2] != c:
            raise ValueError(
                f"bucket {b}: cols {cb.shape} / vals {vb.shape} are not one "
                f"(S_b, W_b, C={c}) slab")
        if rb.shape != (cb.shape[0], c):
            raise ValueError(
                f"bucket {b}: rows {rb.shape} != (S_b, C) = "
                f"{(cb.shape[0], c)}")
        if cb.dtype != np.int32 or rb.dtype != np.int32:
            raise ValueError(f"bucket {b}: cols/rows must be int32")
        if vb.dtype != vals[0].dtype:
            raise ValueError(
                f"bucket {b}: value dtype {vb.dtype} != {vals[0].dtype}")
        if rb.size and (rb.min() < 0 or rb.max() > n_rows):
            raise ValueError(f"bucket {b}: row ids outside [0, {n_rows}]")
    return SellSlabs(
        bucket_cols=cols, bucket_vals=vals, bucket_rows=rows,
        n_rows=n_rows, n_cols=n_cols, nnz=int(src.nnz), sigma=int(src.sigma))


# ---------------------------------------------------------------------------
# Generators (vectorized: distinct sorted column draws via order statistics)
# ---------------------------------------------------------------------------


def _segment_sort(values: np.ndarray, seg: np.ndarray, n_vals: int) -> np.ndarray:
    """Sort ``values`` within each segment (``seg`` nondecreasing)."""
    key = seg * np.int64(n_vals + 1) + values
    return np.sort(key) - seg * np.int64(n_vals + 1)


def _distinct_sorted_draws(
    rng: np.random.Generator, lengths: np.ndarray, domain: np.ndarray
) -> np.ndarray:
    """For each row r, ``lengths[r]`` distinct sorted ints in [0, domain[r]).

    Classic order-statistics trick, fully vectorized: draw k iid samples
    from [0, domain - k], sort within the row, add 0..k-1 — the result is
    strictly increasing, hence distinct.
    """
    rows = np.repeat(np.arange(len(lengths), dtype=np.int64), lengths)
    if not len(rows):
        return np.empty(0, np.int64)
    high = (domain - lengths + 1)[rows]           # exclusive upper bound
    draws = rng.integers(0, high)
    draws = _segment_sort(draws, rows, int(domain.max()) + 1)
    starts = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=starts[1:])
    pos = np.arange(len(rows), dtype=np.int64) - starts[rows]
    return draws + pos


def random_csr(
    n_rows: int,
    n_cols: int,
    avg_nnz_row: float,
    seed: int = 0,
    dtype=np.float64,
    skew: float = 0.0,
) -> CSRMatrix:
    """Random sparse matrix with Poisson-ish row lengths.

    ``skew > 0`` switches the row-length law to a lognormal with that sigma
    (heavy-tailed, mean ~``avg_nnz_row``), the shape SELL-C-sigma exists for.
    Fully vectorized: packing a 10^6-row matrix is a few array ops, not a
    Python loop.
    """
    rng = np.random.default_rng(seed)
    if skew > 0:
        raw = rng.lognormal(np.log(max(avg_nnz_row, 1.0)) - skew**2 / 2, skew, n_rows)
        lengths = np.clip(np.round(raw).astype(np.int64), 1, n_cols)
    else:
        lengths = np.clip(rng.poisson(avg_nnz_row, n_rows), 1, n_cols).astype(np.int64)
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    indices = _distinct_sorted_draws(
        rng, lengths, np.full(n_rows, n_cols, np.int64)
    ).astype(np.int32)
    data = rng.standard_normal(indptr[-1]).astype(dtype)
    return CSRMatrix(indptr=indptr, indices=indices, data=data, n_cols=n_cols)


def cage10_like(seed: int = 0, dtype=np.float64) -> CSRMatrix:
    """CAGE10-shaped matrix (11,397 x 11,397, ~150,645 nnz, avg 13.2/row).

    The SuiteSparse file is not bundled offline; this generator reproduces its
    *structural statistics* (dimension, nnz, near-banded locality), which is
    what the memory-behavior study depends on.  Each row holds its diagonal
    plus distinct entries from a +-200 band, drawn vectorized.
    """
    n = 11_397
    target_nnz = 150_645
    avg = target_nnz / n            # ~13.2
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(avg - 1, n) + 1, 1, 33)  # cage10 max ~33
    # Scale to hit the target nnz closely.
    scale = (target_nnz - n) / max((lengths - 1).sum(), 1)
    lengths = 1 + np.round((lengths - 1) * scale).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])

    r = np.arange(n, dtype=np.int64)
    lo = np.maximum(0, r - 200)
    band = np.minimum(n, r + 201) - lo            # band size per row (>= 201)
    k_off = lengths - 1                           # off-diagonal entries
    # Distinct draws from the band minus the diagonal slot, then shift the
    # values at/after the diagonal's in-band offset up by one to skip it.
    draws = _distinct_sorted_draws(rng, k_off, band - 1)
    rows_off = np.repeat(r, k_off)
    diag_off = (r - lo)[rows_off]
    draws = np.where(draws >= diag_off, draws + 1, draws) + lo[rows_off]

    # Interleave: k-1 band entries then the diagonal, re-sorted per row.
    indices = np.empty(indptr[-1], np.int64)
    rows_all = np.repeat(r, lengths)
    off_slots = np.arange(indptr[-1]) - indptr[rows_all]
    indices[off_slots < (lengths - 1)[rows_all]] = draws
    indices[indptr[1:] - 1] = r                   # diagonal in the last slot
    indices = _segment_sort(indices, rows_all, n)
    data = rng.standard_normal(indptr[-1]).astype(dtype)
    return CSRMatrix(indptr=indptr, indices=indices.astype(np.int32),
                     data=data, n_cols=n)
