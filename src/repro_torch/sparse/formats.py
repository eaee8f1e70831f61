"""Sparse formats for long-vector SpMV (paper §3.1, Gómez et al. [2]).

The port's copy of what its main path needs from ``repro.sparse.formats``:
CSR, uniform-width :class:`EllpackMatrix` (the paper's baseline format),
the ragged :class:`SellCSigmaMatrix`, the device layout :class:`SellSlabs`,
the vectorized packers and the operand generators.
Every array this module builds is byte-identical to the reference's for
the same inputs (tests hold the two packers against each other), so a
layout packed by either package serves in both.

Packing stays on the host, in numpy, as in the reference.  What is new
here is the boundary to the card: :meth:`SellSlabs.to_device` and
:meth:`EllpackMatrix.to_device` upload the slabs as torch tensors, and :func:`slabs_from_arrays` adopts slabs
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
class EllpackMatrix:
    """Uniform-width ELLPACK in slice-transposed (kernel) layout.

    ``cols``/``vals`` have shape (n_slices, width, C): element (s, w, c) is
    the w-th nonzero of row ``s*C + c``; padding has ``cols == PAD`` and
    ``vals == 0``.  One CUDA thread of kernel B6 walks one row; the lanes c
    of a slice sit on consecutive addresses for every w.
    """

    cols: np.ndarray      # (n_slices, width, C) int32
    vals: np.ndarray      # (n_slices, width, C) float
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def c(self) -> int:
        return self.cols.shape[2]

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @property
    def n_slices(self) -> int:
        return self.cols.shape[0]

    @property
    def padded_nnz(self) -> int:
        return self.cols.size

    @property
    def pad_factor(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference host SpMV over the padded layout."""
        xg = np.concatenate([x, np.zeros(1, x.dtype)])  # PAD -> 0 via index -1
        safe = np.where(self.cols == PAD, len(x), self.cols)
        y = np.einsum("swc,swc->sc", self.vals, xg[safe])
        return y.reshape(-1)[: self.n_rows]

    def to_device(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(cols, vals)`` as tensors on ``device``, in the same (S, W, C)
        layout: int32 cols, vals in their own dtype.  The one upload."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (self.cols, self.vals))


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


def csr_to_ellpack(m: CSRMatrix, c: int, width: int | None = None) -> EllpackMatrix:
    """Pad CSR to uniform-width slice-transposed ELLPACK with slice size c.

    As in the reference, an explicit ``width`` below the longest row drops
    the entries past it (``nnz`` still counts them)."""
    lengths = m.row_lengths
    w = int(width if width is not None else (lengths.max() if m.n_rows else 0))
    w = max(w, 1)
    n_slices = -(-m.n_rows // c)
    cols = np.full((n_slices, w, c), PAD, np.int32)
    vals = np.zeros((n_slices, w, c), m.data.dtype)
    rows, offs = _nnz_coords(m)
    keep = offs < w
    r, k = rows[keep], offs[keep]
    cols[r // c, k, r % c] = m.indices[keep]
    vals[r // c, k, r % c] = m.data[keep]
    return EllpackMatrix(cols=cols, vals=vals, n_rows=m.n_rows, n_cols=m.n_cols, nnz=m.nnz)


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


@dataclasses.dataclass(frozen=True)
class StreamColumnMap:
    """Per-block column lists of width-bucketed SELL slabs: the operands of
    the streaming SpMM schedule (kernel B2), which stages through shared
    memory only the rows of X that a block of its rows touches.

    A block of bucket ``b`` is ``block_rows[b]`` consecutive lanes (lane
    ``s * C + c`` of its (S, W, C) slab).  For each bucket:

    * ``block_ptr`` (n_blocks + 1,) int64 and ``block_cols`` (total,)
      int32: block ``i``'s distinct stored columns, ascending, are
      ``block_cols[block_ptr[i]:block_ptr[i + 1]]``;
    * ``lcols`` (S, W, C) int32, shaped like the bucket's ``cols``: each
      entry's index into its block's list, ``PAD`` kept as ``-1``, so
      ``block_cols[block_ptr[block] + lcols] == cols`` on every real entry
      and local order is column order;
    * ``lane_end`` (S, C) int32: one past the last real slot of each lane's
      w axis (0 for an empty lane), where the walk of that row ends.

    ``longest`` is each bucket's longest list.  Built on the host
    (:func:`stream_column_map`); :meth:`to_device` uploads the arrays and
    keeps the host-side sizes, so a launch needs no device read.
    """

    block_rows: tuple[int, ...]
    longest: tuple[int, ...]
    block_ptr: tuple
    block_cols: tuple
    lcols: tuple
    lane_end: tuple

    def __post_init__(self):
        """The arrays agree with each other (numpy on the host, tensors on
        one device): one (lcols, lane_end, block_ptr, block_cols) per
        bucket, int32 but ``block_ptr`` int64, contiguous, ``lane_end``
        (S, C) and ``block_ptr`` one past the bucket's block count.  Checked
        once here, so a launch only matches the map to its slabs."""
        n = len(self.block_rows)
        fields = (self.block_ptr, self.block_cols, self.lcols, self.lane_end)
        if len(self.longest) != n or any(len(f) != n for f in fields):
            raise ValueError("a column map needs one entry per bucket in "
                             "every field")
        devices = set()
        for b, (ptr, lst, lcols, end) in enumerate(zip(*fields)):
            for name, a, dtype in (("block_ptr", ptr, "int64"),
                                   ("block_cols", lst, "int32"),
                                   ("lcols", lcols, "int32"),
                                   ("lane_end", end, "int32")):
                tensor = isinstance(a, torch.Tensor)
                if not str(a.dtype).endswith(dtype) or not (
                        a.is_contiguous() if tensor
                        else a.flags["C_CONTIGUOUS"]):
                    raise ValueError(f"bucket {b} column map {name} is not "
                                     f"a contiguous {dtype} array")
                devices.add(a.device if tensor else "host")
            s, _, c = lcols.shape
            if tuple(end.shape) != (s, c) or tuple(ptr.shape) != (
                    -(-s * c // self.block_rows[b]) + 1,):
                raise ValueError(
                    f"bucket {b} column map: lane_end {tuple(end.shape)} / "
                    f"block_ptr {tuple(ptr.shape)} do not fit lcols "
                    f"{tuple(lcols.shape)} at {self.block_rows[b]} rows a block")
        if len(devices) > 1:
            raise ValueError(f"column map arrays on {sorted(map(str, devices))}")

    @property
    def device(self):
        """The device the arrays lie on (``None`` on the host or empty)."""
        a = self.lcols[0] if self.lcols else None
        return a.device if isinstance(a, torch.Tensor) else None

    @property
    def x_rows(self) -> int:
        """(block, column) pairs over all buckets: the rows of X the
        schedule stages per RHS tile, each once."""
        return sum(int(p[-1]) for p in self.block_ptr)

    def to_device(self, device) -> "StreamColumnMap":
        def up(arrays):
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in arrays)

        return dataclasses.replace(
            self, block_ptr=up(self.block_ptr), block_cols=up(self.block_cols),
            lcols=up(self.lcols), lane_end=up(self.lane_end))


def stream_column_map(bucket_cols, block_rows) -> StreamColumnMap:
    """The :class:`StreamColumnMap` of (S, W, C) int32 column slabs, with
    ``block_rows[b]`` lanes a block in bucket ``b``.  Vectorised: one sort
    of (block, column) keys per bucket."""
    ptrs, lists, locals_, ends, longest = [], [], [], [], []
    for cols, rb in zip(bucket_cols, block_rows):
        cols = np.asarray(cols)
        s, w, c = cols.shape
        n_blocks = -(-s * c // int(rb))
        block = (np.arange(s * c, dtype=np.int64) // int(rb)).reshape(s, 1, c)
        real = cols != PAD
        key = (np.broadcast_to(block, cols.shape)[real] << 32) \
            | cols[real].astype(np.int64)
        uniq, inverse = np.unique(key, return_inverse=True)
        ptr = np.zeros(n_blocks + 1, np.int64)
        np.cumsum(np.bincount(uniq >> 32, minlength=n_blocks), out=ptr[1:])
        lcols = np.full(cols.shape, PAD, np.int32)
        lcols[real] = inverse.reshape(-1) - ptr[key >> 32]
        last = np.where(real.any(axis=1),
                        w - np.argmax(real[:, ::-1, :], axis=1), 0)
        ptrs.append(ptr)
        lists.append((uniq & 0xFFFFFFFF).astype(np.int32))
        locals_.append(lcols)
        ends.append(last.astype(np.int32))
        longest.append(int(np.diff(ptr).max()) if n_blocks else 0)
    return StreamColumnMap(
        block_rows=tuple(int(r) for r in block_rows), longest=tuple(longest),
        block_ptr=tuple(ptrs), block_cols=tuple(lists),
        lcols=tuple(locals_), lane_end=tuple(ends))


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


def ellpack_to_csr(ell: EllpackMatrix) -> CSRMatrix:
    """Invert :func:`csr_to_ellpack` (drops nothing: pads are masked out)."""
    s, w, cc = np.nonzero(ell.cols != PAD)
    rows = s * ell.c + cc
    return _coo_to_csr(rows, w, ell.cols[s, w, cc], ell.vals[s, w, cc],
                       ell.n_rows, ell.n_cols)


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
    if isinstance(matrix, EllpackMatrix):
        return ellpack_to_csr(matrix)
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
# Multi-device row partitioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedSlabs:
    """Row-partitioned :class:`SellSlabs`, stacked along a device axis.

    Every shard owns a contiguous, nnz-balanced range of rows and is packed
    independently at the parent's (C, sigma); the per-shard slabs are then
    padded to one COMMON bucket structure (union of power-of-two widths,
    per-bucket slice counts padded with PAD-only slabs) so a single
    program runs every device.  ``bucket_cols[b]``
    is (n_shards, S_b, W_b, C), ``bucket_rows[b]`` is (n_shards, S_b, C)
    holding *shard-local* row ids (padding lanes map to ``rows_max``, the
    shared local dump slot).

    The boundary-column gather metadata: shard ``d`` only references
    columns in the window ``[col_starts[d], col_starts[d] + window_cols)``,
    so each shard gathers from one uniform ``window_cols``-wide slice of
    the replicated X instead of the whole operand; stored column indices
    are already rebased into that window.  ``boundary_cols`` is the worst
    per-shard count of referenced columns outside the shard's even
    ``n_cols / n_shards`` share — the volume a column-exchange collective
    would move, priced by :func:`repro_torch.analysis.preflight.plan_spmm_sell_sharded`.
    """

    bucket_cols: tuple[np.ndarray, ...]   # each (n_shards, S_b, W_b, C) int32
    bucket_vals: tuple[np.ndarray, ...]   # each (n_shards, S_b, W_b, C) float
    bucket_rows: tuple[np.ndarray, ...]   # each (n_shards, S_b, C) int32, local
    row_starts: np.ndarray                # (n_shards,) int64: first global row
    row_counts: np.ndarray                # (n_shards,) int64: rows owned
    col_starts: np.ndarray                # (n_shards,) int32: X window start
    window_cols: int                      # uniform X window width
    boundary_cols: int                    # worst out-of-share column count
    n_rows: int
    n_cols: int
    nnz: int
    sigma: int

    @property
    def c(self) -> int:
        return self.bucket_cols[0].shape[3]

    @property
    def n_shards(self) -> int:
        return self.bucket_cols[0].shape[0]

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(c.shape[2] for c in self.bucket_cols)

    @property
    def slices_per_shard(self) -> tuple[int, ...]:
        return tuple(c.shape[1] for c in self.bucket_cols)

    @property
    def rows_max(self) -> int:
        """Rows of the widest shard — the local dump-slot index."""
        return int(self.row_counts.max()) if len(self.row_counts) else 0

    @property
    def padded_nnz(self) -> int:
        return sum(c.size for c in self.bucket_cols)

    @property
    def pad_factor(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    def shard_to_device(self, d: int, device) -> tuple[tuple[torch.Tensor, ...], ...]:
        """Shard ``d``'s bucket tensors on ``device``: ``(cols, vals,
        rows)``, each a tuple over the union buckets, as
        :meth:`SellSlabs.to_device` uploads one operand (rows local, the
        dump slot ``rows_max``).  The one upload of that shard."""
        def up(arrays):
            return tuple(
                torch.from_numpy(np.ascontiguousarray(a[d])).to(device)
                for a in arrays)

        return up(self.bucket_cols), up(self.bucket_vals), up(self.bucket_rows)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference host SpMV mirroring the sharded schedule exactly:
        per-shard window gather + local scatter, shards concatenated."""
        out = np.zeros(self.n_rows, dtype=np.result_type(self.bucket_vals[0], x))
        for d in range(self.n_shards):
            lo = int(self.col_starts[d])
            xw = x[lo : lo + self.window_cols]
            xg = np.concatenate([xw, np.zeros(1, x.dtype)])
            y = np.zeros(self.rows_max + 1, out.dtype)
            for cols, vals, rows in zip(self.bucket_cols, self.bucket_vals,
                                        self.bucket_rows):
                safe = np.where(cols[d] == PAD, len(xw), cols[d])
                yb = np.einsum("swc,swc->sc", vals[d], xg[safe])
                y[rows[d].reshape(-1)] = yb.reshape(-1)
            r0, cnt = int(self.row_starts[d]), int(self.row_counts[d])
            out[r0 : r0 + cnt] = y[:cnt]
        return out


def shard_row_ranges(lengths: np.ndarray, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous row ranges [lo, hi) balancing nnz across ``n_shards``.

    The weight is ``nnz + 1`` per row so all-empty stretches still spread
    instead of collapsing into one shard.  Ranges partition [0, n_rows)
    exactly; a shard may be empty (lo == hi) when rows run out.
    """
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    n_shards = max(int(n_shards), 1)
    cum = np.zeros(n + 1, np.int64)
    np.cumsum(lengths + 1, out=cum[1:])
    targets = cum[-1] * np.arange(1, n_shards) / n_shards
    cuts = np.searchsorted(cum, targets)
    bounds = np.maximum.accumulate(np.concatenate([[0], cuts, [n]]))
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_shards)]


def _csr_row_slice(m: CSRMatrix, lo: int, hi: int) -> CSRMatrix:
    """Rows [lo, hi) of ``m`` as a standalone CSR (column ids unchanged)."""
    s, e = int(m.indptr[lo]), int(m.indptr[hi])
    return CSRMatrix(
        indptr=(m.indptr[lo : hi + 1] - m.indptr[lo]),
        indices=m.indices[s:e],
        data=m.data[s:e],
        n_cols=m.n_cols,
    )


def shard_slabs(slabs: SellSlabs, n_shards: int) -> ShardedSlabs:
    """Row-partition slabs into ``n_shards`` device slabs (see
    :class:`ShardedSlabs` for the layout contract).

    Each shard re-packs its contiguous nnz-balanced row range at the
    parent's (C, sigma) — the sigma-sort is *local*, so a shard's slices
    never mix rows across the partition — and the shard structures are
    unified so one kernel program serves every device.
    """
    csr = sell_slabs_to_csr(slabs)
    c = slabs.c
    sigma = int(slabs.sigma or 8 * c)
    ranges = shard_row_ranges(csr.row_lengths, n_shards)
    n_shards = len(ranges)
    shards = [
        csr_to_sell_slabs(_csr_row_slice(csr, lo, hi), c=c, sigma=sigma)
        for lo, hi in ranges
    ]
    rows_max = max(s.n_rows for s in shards)

    # Per-shard referenced-column window + out-of-share boundary count.
    col_starts = np.zeros(n_shards, np.int32)
    window = 1
    boundary = 0
    n_cols = max(csr.n_cols, 1)
    for d, ((lo, hi), s) in enumerate(zip(ranges, shards)):
        ref = csr.indices[int(csr.indptr[lo]) : int(csr.indptr[hi])]
        if len(ref):
            c_lo, c_hi = int(ref.min()), int(ref.max()) + 1
        else:
            c_lo, c_hi = 0, 1
        col_starts[d] = c_lo
        window = max(window, c_hi - c_lo)
        fair_lo = d * csr.n_cols // n_shards
        fair_hi = (d + 1) * csr.n_cols // n_shards
        outside = np.unique(ref[(ref < fair_lo) | (ref >= fair_hi)])
        boundary = max(boundary, len(outside))
    window = min(window, n_cols)
    col_starts = np.minimum(col_starts, n_cols - window).astype(np.int32)

    # Union bucket structure: every width any shard produced, slice counts
    # padded to the per-width max with PAD-only slabs.
    per_shard = [dict(zip(s.widths, range(s.n_buckets))) for s in shards]
    union_w = sorted({w for s in shards for w in s.widths})
    smax = {
        w: max(
            (s.bucket_cols[per_shard[d][w]].shape[0]
             if w in per_shard[d] else 0)
            for d, s in enumerate(shards))
        for w in union_w
    }
    val_dtype = slabs.bucket_vals[0].dtype if slabs.bucket_vals else np.float64
    bucket_cols, bucket_vals, bucket_rows = [], [], []
    for w in union_w:
        s_b = smax[w]
        cols = np.full((n_shards, s_b, w, c), PAD, np.int32)
        vals = np.zeros((n_shards, s_b, w, c), val_dtype)
        rows = np.full((n_shards, s_b, c), rows_max, np.int32)
        for d, s in enumerate(shards):
            if w not in per_shard[d]:
                continue  # empty per-device bucket: stays all-PAD
            b = per_shard[d][w]
            sc, sv, sr = s.bucket_cols[b], s.bucket_vals[b], s.bucket_rows[b]
            nb = sc.shape[0]
            # rebase columns into the shard's X window; PAD stays PAD
            cols[d, :nb] = np.where(sc == PAD, PAD, sc - col_starts[d])
            vals[d, :nb] = sv
            # local ids; the shard's own dump slot remaps to the shared one
            rows[d, :nb] = np.where(sr == s.n_rows, rows_max, sr)
        bucket_cols.append(cols)
        bucket_vals.append(vals)
        bucket_rows.append(rows)

    return ShardedSlabs(
        bucket_cols=tuple(bucket_cols),
        bucket_vals=tuple(bucket_vals),
        bucket_rows=tuple(bucket_rows),
        row_starts=np.array([lo for lo, _ in ranges], np.int64),
        row_counts=np.array([hi - lo for lo, hi in ranges], np.int64),
        col_starts=col_starts,
        window_cols=int(window),
        boundary_cols=int(boundary),
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        nnz=csr.nnz,
        sigma=sigma,
    )


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
