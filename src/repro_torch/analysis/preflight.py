"""Hopper launch-plan builders for the port's CUDA kernels.

Each builder mirrors the launch arithmetic of its wrapper without importing
or running it, from operand metadata alone (:class:`SlabMeta`).

:func:`plan_spmm_sell` (kernel B1, :func:`repro_torch.kernels.sell_core
.spmm_sell`): per width bucket one launch of ``SPMM_BLOCK_THREADS``-thread
blocks, one thread per (slice, lane) row, ``grid = (ceil(S_b * C /
threads), k_pad / k_tile)``; a bucket that :func:`repro_torch.core.autotune
.spmm_split` splits runs blocks of ``lanes`` rows x ``parts`` threads,
``grid = (ceil(S_b * C / lanes), k_pad / k_tile)``, each claiming the
shared memory of its partial sums.

:func:`plan_spmm_sell_stream` (kernel B2, :func:`repro_torch.kernels
.sell_core.spmm_sell_stream`): B1's function and contracts; per width
bucket one launch of blocks of :func:`stream_block_rows` rows (one thread
each, rounded up to whole warps), ``grid = (ceil(S_b * C / rows), k_pad /
k_tile)``, each block claiming two X chunks of shared memory (the rows of
X its column list names, :func:`stream_chunk_rows` at a time).  :func:`plan_moe_dispatch` adds the routing
contract to B1's plan.

:func:`plan_bfs_sell` / :func:`plan_pagerank_sell` (kernel B3 with the BFS
or PageRank combine) and :func:`plan_bfs_ell` / :func:`plan_pagerank_ell`
(kernels B4 and B5): per bucket one launch of the lane groups and parts
:func:`repro_torch.core.autotune.node_split` chooses, ``grid =
(ceil(S_b * C / nodes), k / k_tile)``, ``nodes`` a block (ELLPACK: one
thread per node, ``ELL_NODE_BLOCK_THREADS`` a block, one state column,
one launch over n nodes walking each warp up to its live width, which
are checked for length and range, and for BFS a frontier pass before
it).  Unlike the
reference's ``_plan_node_step`` there is no fast-memory footprint to
price: the state stays in device memory and is gathered through L2.

:func:`plan_spmv_ell` (kernel B6, :func:`repro_torch.kernels.spmv
.spmv_ell` / ``.spmm_ell``): at k = 1 one launch, one thread per ELLPACK
row, ``grid = ceil(S * C / threads)``; for k columns one launch a k tile,
a group of lanes a row; the slab's live widths checked for length and
range.

:func:`plan_fft_stockham` (kernel B7, :func:`repro_torch.kernels.fft
.fft_stockham`): the in-block form (one launch, whole signals a block, at
most ``b_block``, radix-16 register passes exchanging through shared
memory) up to 4096 in fp64 and 8192 in fp32, else the two-pass form (two
launches, each block a tile of sub-signals in shared memory).

:func:`plan_embedding_gather` (kernel B9, :func:`repro_torch.kernels
.gather.embedding_gather`): one launch, a block per (row, chunk of the
row); the ids that lie on the host are scanned for range.
:func:`plan_embedding_gather_bwd` (B9's backward) and
:func:`plan_embedding_gather_shard_bwd` (its vocab-shard form, a mesh's
row shard of the table): one launch, a block per stripe of table rows and
column chunk.
:func:`plan_ssd_fused` (kernel B8, :func:`repro_torch.kernels.ssd.ssd_fused`): three
launches of the chunk-parallel scan (chunk states, the state pass, chunk
outputs), their grids and fixed shared memory.

Checked contracts:

* grid and block dims inside CUDA's limits; shared memory per block
  within :data:`SMEM_PER_BLOCK` (the FFT, the streamed SpMM, B1's split
  buckets and the SSD scan claim some: the other kernels keep their sums
  and masks in registers);
* pow2 padding invariants: ``k_block`` and every packed bucket width are
  powers of two;
* the column tile fits a thread: ``k_tile <= MAX_K_TILE`` state columns
  within the per-thread register budget;
* index bounds, when scanned (``SlabMeta.from_slabs(check_bounds=True)``):
  column or neighbour ids in ``[PAD, n_cols)`` and row or node maps in
  ``[0, n_rows]`` — the kernels gather and scatter unchecked, and CUDA
  does not clamp an out-of-range index the way JAX does;
* dtype flow: int32 indices; SpMM / SpMV values and X of one dtype,
  float32 or float64; BFS state int32; PageRank state float64 or float32;
  FFT planes float32 or float64 (the kernels' instantiations).

:func:`plan_spmm_sell_sharded` (the row-sharded drive of
:mod:`repro_torch.kernels.sell_shard`): the parent operand's contracts,
then one device's B1 plan over its shard's slices against its X window
(``window_cols`` rows, gathered from device memory as B1 always does), and
a zero-shared-memory pseudo-block that prices what crosses devices.  The
graph plans take a sharded layout's :meth:`SlabMeta.from_sharded`: each
device runs its slices of every union bucket against the whole state.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.analysis.launchplan import BlockPlan, LaunchPlan, is_pow2
from repro_torch.core.autotune import (
    ACC_BYTES_PER_THREAD,
    DTYPE_BYTES,
    ELL_BLOCK_THREADS,
    ELL_LIVE_ROWS,
    ELL_NODE_BLOCK_THREADS,
    GATHER_BWD_SLICE,
    KERNEL_DTYPES,
    LM_KERNEL_DTYPES,
    MAX_K_TILE,
    SMEM_PER_BLOCK,
    SPMM_BLOCK_THREADS,
    SSD_BLOCK_THREADS,
    SSD_BWD_LAUNCHES,
    SSD_LAUNCHES,
    SSD_TILE,
    STREAM_FILL_BLOCKS,
    WARP,
    ell_k_tiles,
    ell_vec,
    fft_block_limit,
    fft_block_radix,
    fft_block_signals,
    fft_block_smem_bytes,
    fft_block_threads,
    fft_pass_smem_bytes,
    fft_pass_threads,
    fft_two_pass,
    gather_bwd_grid,
    gather_bwd_smem_bytes,
    gather_grid,
    node_split,
    spmm_split,
    ssd_bwd_grids,
    ssd_bwd_pairs,
    ssd_bwd_smem_bytes,
    ssd_grids,
    ssd_smem_bytes,
    stream_smem_bytes,
)
from repro_torch.sparse.formats import PAD, pow2_ceil

__all__ = [
    "LiveWidthMeta",
    "SlabMeta",
    "StreamMapMeta",
    "gather_ids_violation",
    "ids_on_host",
    "plan_bfs_ell",
    "plan_bfs_sell",
    "plan_embedding_gather",
    "plan_embedding_gather_shard",
    "plan_fft_stockham",
    "plan_moe_dispatch",
    "plan_pagerank_ell",
    "plan_pagerank_sell",
    "plan_spmm_sell",
    "plan_spmm_sell_sharded",
    "plan_spmm_sell_stream",
    "plan_spmv_ell",
    "plan_ssd_fused",
]

#: CUDA launch limits (compute capability 9.0)
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65_535
MAX_BLOCK_THREADS = 1024


def _bounds(idx, maps) -> dict:
    """The index and lane-map bounds of a packed operand's buckets (one
    vectorized min / max a bucket)."""
    def lo(arrays):
        return min((int(np.min(a)) for a in arrays if a.size), default=None)

    def hi(arrays):
        return max((int(np.max(a)) for a in arrays if a.size), default=None)

    return dict(idx_min=lo(idx), idx_max=hi(idx), map_min=lo(maps),
                map_max=hi(maps))


@dataclasses.dataclass(frozen=True)
class SlabMeta:
    """The launch-relevant metadata of a packed operand.

    Cheap to extract (O(n_buckets) shape reads); the optional bounds scan
    is one vectorized min/max over the stored indices and the lane maps.
    Four kinds: ``"matrix"`` (:class:`~repro_torch.sparse.formats.SellSlabs`,
    buckets (S, W, C)), ``"graph"`` (:class:`~repro_torch.graphs
    .SellGraphSlabs`, buckets (S, C, W)), ``"ell"`` (an ELLPACK
    adjacency, :meth:`from_ell`: one slice of height n, no lane map) and
    ``"ellpack"`` (an :class:`~repro_torch.sparse.formats.EllpackMatrix`,
    :meth:`from_ellpack`: one (S, W, C) slab, no row map).
    """

    kind: str                       # "matrix" | "graph" | "ell" | "ellpack"
    c: int
    widths: tuple[int, ...]         # padded W per bucket
    n_slices: tuple[int, ...]       # slices per bucket
    n_rows: int                     # rows / nodes
    n_cols: int                     # X length / n_nodes
    val_dtype: str | None           # None for graphs (index-only slabs)
    idx_dtype: str
    idx_min: int | None = None      # None = bounds not scanned
    idx_max: int | None = None
    map_min: int | None = None      # row / node map bounds (when scanned)
    map_max: int | None = None

    @classmethod
    def from_slabs(cls, slabs, check_bounds: bool = False) -> "SlabMeta":
        """Extract metadata from host ``SellSlabs`` or ``SellGraphSlabs``
        (duck-typed)."""
        if hasattr(slabs, "bucket_cols"):       # matrix slabs: (S, W, C)
            idx, maps = slabs.bucket_cols, slabs.bucket_rows
            widths = tuple(int(a.shape[1]) for a in idx)
            c = int(idx[0].shape[2]) if idx else 0
            kind, n_rows, n_cols = "matrix", slabs.n_rows, slabs.n_cols
            val_dtype = str(slabs.bucket_vals[0].dtype) if idx else None
        elif hasattr(slabs, "bucket_adj"):      # graph slabs: (S, C, W)
            idx, maps = slabs.bucket_adj, slabs.bucket_nodes
            widths = tuple(int(a.shape[2]) for a in idx)
            c = int(idx[0].shape[1]) if idx else 0
            kind, n_rows, n_cols = "graph", slabs.n_nodes, slabs.n_nodes
            val_dtype = None
        else:
            raise TypeError(
                f"expected SellSlabs or SellGraphSlabs, got "
                f"{type(slabs).__name__}")
        bounds = _bounds(idx, maps) if check_bounds else {}
        return cls(
            kind=kind, c=c, widths=widths,
            n_slices=tuple(int(a.shape[0]) for a in idx),
            n_rows=int(n_rows), n_cols=int(n_cols), val_dtype=val_dtype,
            idx_dtype=str(idx[0].dtype) if idx else "int32", **bounds,
        )

    @classmethod
    def from_ell(cls, adj: np.ndarray, n_nodes: int,
                 check_bounds: bool = False) -> "SlabMeta":
        """Metadata of an ELLPACK adjacency (n, width): one slice of height
        n whose lanes are the nodes themselves."""
        bounds = {}
        if check_bounds and adj.size:
            bounds = dict(idx_min=int(adj.min()), idx_max=int(adj.max()))
        return cls(kind="ell", c=int(adj.shape[0]),
                   widths=(int(adj.shape[1]),), n_slices=(1,),
                   n_rows=int(n_nodes), n_cols=int(n_nodes), val_dtype=None,
                   idx_dtype=str(adj.dtype), **bounds)

    @classmethod
    def from_ellpack(cls, ell, check_bounds: bool = False) -> "SlabMeta":
        """Metadata of an :class:`~repro_torch.sparse.formats.EllpackMatrix`:
        one bucket of width W over its S slices of height C; rows past
        ``n_rows`` in the last slice hold only PAD."""
        bounds = {}
        if check_bounds and ell.cols.size:
            bounds = dict(idx_min=int(ell.cols.min()),
                          idx_max=int(ell.cols.max()))
        return cls(kind="ellpack", c=int(ell.c), widths=(int(ell.width),),
                   n_slices=(int(ell.n_slices),), n_rows=int(ell.n_rows),
                   n_cols=int(ell.n_cols), val_dtype=str(ell.vals.dtype),
                   idx_dtype=str(ell.cols.dtype), **bounds)

    @classmethod
    def from_sharded(cls, sharded, check_bounds: bool = False) -> "SlabMeta":
        """One device's metadata of a sharded layout (duck-typed):
        :class:`~repro_torch.sparse.formats.ShardedSlabs` is a matrix of
        ``rows_max`` local rows against its ``window_cols``-row X window,
        :class:`~repro_torch.graphs.ShardedGraphSlabs` a graph over all
        ``n_nodes``; the slices are a shard's of each union bucket.  The
        bounds scan covers every shard."""
        if hasattr(sharded, "bucket_cols"):
            idx, maps = sharded.bucket_cols, sharded.bucket_rows
            widths = tuple(int(a.shape[2]) for a in idx)
            c = int(idx[0].shape[3]) if idx else 0
            kind, n_rows, n_cols = ("matrix", sharded.rows_max,
                                    sharded.window_cols)
            val_dtype = str(sharded.bucket_vals[0].dtype) if idx else None
        elif hasattr(sharded, "bucket_adj"):
            idx, maps = sharded.bucket_adj, sharded.bucket_nodes
            widths = tuple(int(a.shape[3]) for a in idx)
            c = int(idx[0].shape[2]) if idx else 0
            kind, n_rows, n_cols = "graph", sharded.n_nodes, sharded.n_nodes
            val_dtype = None
        else:
            raise TypeError(f"expected ShardedSlabs or ShardedGraphSlabs, "
                            f"got {type(sharded).__name__}")
        bounds = _bounds(idx, maps) if check_bounds else {}
        return cls(kind=kind, c=c, widths=widths,
                   n_slices=tuple(int(a.shape[1]) for a in idx),
                   n_rows=int(n_rows), n_cols=int(n_cols),
                   val_dtype=val_dtype,
                   idx_dtype=str(idx[0].dtype) if idx else "int32", **bounds)

    def describe(self) -> str:
        return (f"{self.kind} {self.n_rows}x{self.n_cols} "
                f"C={self.c} buckets={list(self.widths)}")


def _index_contracts(meta: SlabMeta, violations: list[str], what: str,
                     state: str) -> None:
    """Contracts every launch over packed indices shares: pow2 bucket
    widths (SELL slabs only), int32 indices, and — when scanned — index
    and lane-map bounds."""
    if meta.kind in ("matrix", "graph"):
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
            f"stored {what} {meta.idx_max} out of bounds for "
            f"{'n_cols' if meta.kind in ('matrix', 'ellpack') else 'n_nodes'}="
            f"{meta.n_cols} (the kernel would read outside {state})")
    if meta.idx_min is not None and meta.idx_min < PAD:
        violations.append(
            f"stored {what} {meta.idx_min} below the PAD sentinel ({PAD})")
    if meta.map_max is not None and meta.map_max > meta.n_rows:
        violations.append(
            f"lane map entry {meta.map_max} beyond the dump slot "
            f"{meta.n_rows} (the kernel would write outside its output)")
    if meta.map_min is not None and meta.map_min < 0:
        violations.append(f"lane map entry {meta.map_min} is negative")


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
    if meta.kind != "matrix":
        violations.append(f"spmm_sell needs matrix slabs, got {meta.kind}")
    _index_contracts(meta, violations, "index", "X")
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
    grid_y = k_pad // k_tile
    if grid_y > MAX_GRID_Y:
        violations.append(
            f"{grid_y} k tiles exceed grid.y limit {MAX_GRID_Y} "
            f"(k={k}, k_block={k_block})")
    dtype = x_dtype or meta.val_dtype
    blocks = []
    for i, (s, w) in enumerate(zip(meta.n_slices, meta.widths)):
        split = spmm_split(w, meta.c, s, k_tile, vb)
        threads = split.threads
        rows = split.lanes if split.parts > 1 else threads
        if threads > MAX_BLOCK_THREADS:
            violations.append(f"bucket {i} (W={w}): block of {threads} "
                              f"threads > {MAX_BLOCK_THREADS}")
        if split.smem_bytes > SMEM_PER_BLOCK:
            violations.append(f"bucket {i} (W={w}): {split.smem_bytes} B of "
                              f"shared memory a block > {SMEM_PER_BLOCK}")
        grid_x = math.ceil(s * meta.c / rows)
        if grid_x > MAX_GRID_X:
            violations.append(
                f"bucket {i} (W={w}): grid.x {grid_x} > {MAX_GRID_X}")
        blocks.append(BlockPlan(
            label=(f"bucket{i}[W={w}, split={split.parts}x{split.lanes}]"
                   if split.parts > 1 else f"bucket{i}[W={w}]"),
            grid=(grid_x, grid_y),
            block=(threads,),
            smem_bytes=split.smem_bytes,
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


def stream_col_tile(col_tile: int, n_cols: int) -> int:
    """The column tile kernel B2 runs: ``col_tile`` coerced to a power of
    two and clamped at ``pow2_ceil(n_cols)``, as the reference's wrapper
    does."""
    return min(pow2_ceil(max(int(col_tile), 1)), pow2_ceil(max(int(n_cols), 1)))


def stream_block_rows(row_tile: int, c: int, n_lanes: int) -> int:
    """Rows (threads with a row) of one block of kernel B2 over a bucket of
    ``n_lanes`` rows: ``row_tile`` slices of height ``c``, at most
    :data:`SPMM_BLOCK_THREADS`; halved in whole warps, down to one warp,
    while the bucket would give the card fewer than
    :data:`STREAM_FILL_BLOCKS` blocks."""
    rows = min(max(int(row_tile), 1) * int(c), SPMM_BLOCK_THREADS)
    while rows > WARP and -(-int(n_lanes) // rows) < STREAM_FILL_BLOCKS:
        rows = max(WARP, rows // 2 // WARP * WARP)
    return rows


def stream_bucket_rows(row_tile: int, shapes) -> tuple[int, ...]:
    """:func:`stream_block_rows` of each (S, W, C) bucket shape, with
    ``row_tile`` clamped at the bucket's slice count."""
    return _bucket_rows(int(row_tile), tuple(tuple(s) for s in shapes))


@functools.lru_cache(maxsize=1024)
def _bucket_rows(row_tile: int, shapes: tuple) -> tuple[int, ...]:
    return tuple(stream_block_rows(min(max(row_tile, 1), max(s, 1)), c,
                                   s * c) for s, _, c in shapes)


def stream_chunk_rows(col_tile: int, longest: int) -> int:
    """X rows one staged chunk of kernel B2 holds in a bucket whose longest
    block column list is ``longest``: ``col_tile``, or that list when
    shorter (a block then claims only the shared memory it fills)."""
    return max(1, min(int(col_tile), int(longest)))


@dataclasses.dataclass(frozen=True)
class StreamMapMeta:
    """What the preflight needs of a :class:`~repro_torch.sparse.formats
    .StreamColumnMap`: its block sizes and the bounds of its indices,
    scanned on the host (:meth:`from_map`).  ``local_excess`` is the largest
    ``lcols - count`` over the real entries, ``count`` the entry's own
    block's list length: below 0 when every local index lies in its list."""

    block_rows: tuple[int, ...]
    n_blocks: tuple[int, ...]
    longest: tuple[int, ...]
    listed: tuple[int, ...]
    col_min: int
    col_max: int
    local_min: int
    local_excess: int

    @classmethod
    def from_map(cls, smap) -> "StreamMapMeta":
        col_min, col_max, local_min, excess = 0, -1, PAD, -1
        for ptr, lst, lcols, rb in zip(smap.block_ptr, smap.block_cols,
                                       smap.lcols, smap.block_rows):
            ptr, lst, lcols = (np.asarray(a) for a in (ptr, lst, lcols))
            s, _, c = lcols.shape
            if lst.size:
                col_min = min(col_min, int(lst.min()))
                col_max = max(col_max, int(lst.max()))
            if lcols.size:
                local_min = min(local_min, int(lcols.min()))
                count = np.diff(ptr)[np.arange(s * c) // int(rb)].reshape(
                    s, 1, c)
                real = lcols != PAD
                if real.any():
                    excess = max(excess, int(
                        (lcols - count)[real].max()))
        return cls(block_rows=tuple(smap.block_rows),
                   n_blocks=tuple(len(p) - 1 for p in smap.block_ptr),
                   longest=tuple(smap.longest),
                   listed=tuple(int(p[-1]) for p in smap.block_ptr),
                   col_min=col_min, col_max=col_max, local_min=local_min,
                   local_excess=excess)


def plan_spmm_sell_stream(
    meta: SlabMeta,
    k: int = 1,
    x_dtype: str | None = None,
    *,
    k_block: int = 8,
    col_tile: int,
    row_tile: int,
    base=None,
    column_map: StreamMapMeta | None = None,
) -> LaunchPlan:
    """Plan ``spmm_sell_stream`` (kernel B2) for a (n_cols, k) RHS stack.

    Every contract of ``base`` (default :func:`plan_spmm_sell`: the same
    function over the same slabs; :func:`plan_moe_dispatch` adds the
    routing contract), plus the schedule's own: ``col_tile`` and
    ``row_tile`` at least 1; ``col_tile`` coerced to a power of two and
    clamped at ``pow2_ceil(n_cols)``; each bucket's block rows from
    :func:`stream_block_rows`, as the wrapper takes them; the two X chunks
    a block stages within :data:`SMEM_PER_BLOCK`.  With ``column_map``
    (the block column lists the launch reads) the plan also holds its
    operands to the slabs: the same block rows and block counts, every
    listed column in ``[0, n_cols)``, every local index ``PAD`` or below
    its block's count; a chunk then holds :func:`stream_chunk_rows` rows.
    Without it the chunk is priced at ``col_tile`` rows, the most a launch
    claims.  The footprint is independent of ``n_cols`` and ``n_rows``, so
    any operand B1 serves has a valid streaming plan at the tiles
    :func:`repro_torch.core.autotune.pick_stream_tiles` picks.
    """
    base = (base or plan_spmm_sell)(meta, k=k, x_dtype=x_dtype,
                                    k_block=k_block)
    violations = list(base.violations)
    if col_tile < 1:
        violations.append(f"col_tile must be >= 1, got {col_tile}")
    if row_tile < 1:
        violations.append(f"row_tile must be >= 1, got {row_tile}")
    vb = int(np.dtype(meta.val_dtype).itemsize) \
        if meta.val_dtype in KERNEL_DTYPES else 8
    k_tile = min(max(int(k_block), 1), pow2_ceil(max(k, 1)))
    k_pad = k_tile * math.ceil(max(k, 1) / k_tile)
    ct = stream_col_tile(col_tile, meta.n_cols)
    dtype = x_dtype or meta.val_dtype
    shapes = tuple((s, w, meta.c) for s, w in zip(meta.n_slices, meta.widths))
    block_rows = stream_bucket_rows(row_tile, shapes)
    if column_map is not None:
        if column_map.block_rows != block_rows:
            violations.append(
                f"column map built for block rows {column_map.block_rows}, "
                f"the launch takes {block_rows}")
        if column_map.col_min < 0 or column_map.col_max >= meta.n_cols:
            violations.append(
                f"column map lists columns in [{column_map.col_min}, "
                f"{column_map.col_max}], out of bounds for n_cols="
                f"{meta.n_cols}")
        if column_map.local_min < PAD or column_map.local_excess >= 0:
            violations.append(
                "column map local index out of its block's list (min "
                f"{column_map.local_min}, largest index - count "
                f"{column_map.local_excess})")
    blocks = []
    for i, ((s, w, c), rows) in enumerate(zip(shapes, block_rows)):
        grid_x = math.ceil(s * c / rows)
        if grid_x > MAX_GRID_X:
            violations.append(
                f"bucket {i} (W={w}): grid.x {grid_x} > {MAX_GRID_X}")
        operands = [
            ("lcols", (s, w, c), meta.idx_dtype),
            ("vals", (s, w, c), meta.val_dtype),
            ("rows", (s, c), meta.idx_dtype),
            ("lane_end", (s, c), "int32"),
            ("block_ptr", (grid_x + 1,), "int64"),
        ]
        chunk = ct
        if column_map is not None and i < len(column_map.n_blocks):
            if column_map.n_blocks[i] != grid_x:
                violations.append(
                    f"bucket {i} (W={w}): column map has "
                    f"{column_map.n_blocks[i]} blocks, the launch {grid_x}")
            chunk = stream_chunk_rows(ct, column_map.longest[i])
            operands.append(("block_cols", (column_map.listed[i],), "int32"))
        smem = stream_smem_bytes(chunk, k_tile, vb)
        if smem > SMEM_PER_BLOCK:
            violations.append(
                f"two ({chunk}, {k_tile}) X chunks take {smem} B of shared "
                f"memory a block > {SMEM_PER_BLOCK} (col_tile={col_tile}, "
                f"k_block={k_block})")
        operands += [("x", (meta.n_cols, k_pad), dtype),
                     ("y", (meta.n_rows + 1, k_pad), meta.val_dtype),
                     ("x_chunks", (2, chunk, k_tile), dtype)]
        blocks.append(BlockPlan(
            label=f"bucket{i}[W={w}, rows={rows}]",
            grid=(grid_x, k_pad // k_tile),
            block=(WARP * math.ceil(rows / WARP),),
            operands=tuple(operands),
            smem_bytes=smem,
        ))
    return LaunchPlan(
        kernel="spmm_sell_stream", operand=meta.describe(),
        dtype=meta.val_dtype, blocks=tuple(blocks),
        violations=tuple(violations),
    )


def plan_spmm_sell_sharded(
    meta: SlabMeta,
    k: int = 1,
    x_dtype: str | None = None,
    *,
    n_devices: int,
    k_block: int = 8,
    window_cols: int,
    shard: SlabMeta,
) -> LaunchPlan:
    """Plan the row-sharded ``spmm_sell_sharded`` drive over ``n_devices``.

    ``meta`` is the whole operand's (its contracts, the index bounds among
    them, hold first).  Each device then runs B1 over its shard's slices
    against its ``window_cols``-row X window: ``shard`` is one device's
    :meth:`SlabMeta.from_sharded` (the union buckets, ``rows_max`` rows,
    stored columns rebased into the window).  X stays in device memory
    and is gathered through the L2 (no window has to fit on chip), so the
    window bounds the gather's indices, not a budget.  A last pseudo-block
    with no shared memory prices what crosses devices: the X window each
    device reads (``window_cols x k_pad``) and the output rows it hands to
    the first device (``~n_rows / n_devices x k_pad``).
    """
    violations: list[str] = []
    nd = int(n_devices)
    if nd < 1:
        violations.append(f"n_devices must be >= 1, got {n_devices}")
        nd = 1
    win = int(window_cols)
    if win < 1 or win > max(meta.n_cols, 1):
        violations.append(
            f"window_cols {win} outside [1, n_cols={meta.n_cols}]")
    whole = plan_spmm_sell(meta, k=k, x_dtype=x_dtype, k_block=k_block)
    violations += whole.violations
    shard = dataclasses.replace(shard, n_cols=max(win, 1))
    per_device = plan_spmm_sell(shard, k=k, x_dtype=x_dtype, k_block=k_block)
    violations += [f"per device: {v}" for v in per_device.violations
                   if v not in whole.violations]
    dtype = x_dtype or meta.val_dtype or "float64"
    k_tile = min(max(int(k_block), 1), pow2_ceil(max(k, 1)))
    k_pad = k_tile * math.ceil(max(k, 1) / k_tile)
    blocks = tuple(dataclasses.replace(b, label=f"{b.label}/dev")
                   for b in per_device.blocks)
    blocks += (BlockPlan(
        label="collectives", grid=(nd,), block=(0,),
        operands=(("x_window", (win, k_pad), dtype),
                  ("y_rows", (math.ceil(max(meta.n_rows, 1) / nd), k_pad),
                   dtype)),
        smem_bytes=0),)
    return LaunchPlan(kernel="spmm_sell_sharded", operand=meta.describe(),
                      dtype=dtype, blocks=blocks,
                      violations=tuple(violations))


def plan_moe_dispatch(meta: SlabMeta, k: int = 1, x_dtype: str | None = None,
                      *, top_k: int, k_block: int = 8) -> LaunchPlan:
    """Plan the MoE expert-dispatch SpMM (:func:`repro_torch.kernels.ops
    .moe_dispatch`): the routing matrix R (one row per token, at most
    ``top_k`` stored router weights, columns = expert capacity slots)
    against the ``(n_slots, d_model)`` expert-output stack.

    The launch arithmetic is :func:`plan_spmm_sell` verbatim: this is the
    plan ``ops`` runs B1 on (the streaming schedule adds its own contracts
    to it, :func:`plan_spmm_sell_stream` with ``base``).  On top of its
    contracts the routing shape is enforced: no packed bucket wider than
    ``pow2_ceil(top_k)`` (a wider row claims more assignments than the
    router's top-k can produce), and a matrix, not a graph, operand.
    """
    base = plan_spmm_sell(meta, k=k, x_dtype=x_dtype, k_block=k_block)
    violations = list(base.violations)
    if meta.kind != "matrix":
        violations.append(
            f"routing operand kind {meta.kind!r} != 'matrix' (the dispatch "
            "SpMM needs value-carrying slabs, not an adjacency pack)")
    if top_k < 1:
        violations.append(f"top_k must be >= 1, got {top_k}")
    w_max = pow2_ceil(max(int(top_k), 1))
    for i, w in enumerate(meta.widths):
        if w > w_max:
            violations.append(
                f"bucket {i} width {w} exceeds pow2_ceil(top_k={top_k})="
                f"{w_max}: a routing row carries at most top_k entries")
    return dataclasses.replace(
        base, kernel="moe_dispatch", violations=tuple(violations))


# ---------------------------------------------------------------------------
# Graph node steps (kernels B3, B4, B5)
# ---------------------------------------------------------------------------

#: state dtypes each graph kernel is instantiated for
_STATE_DTYPES = {"bfs": ("int32",), "pagerank": ("float32", "float64")}


def _plan_node_step(kernel: str, combine: str, meta: SlabMeta, k: int,
                    state_dtype: str,
                    live: "LiveWidthMeta | None" = None) -> LaunchPlan:
    """Shared plan of the graph node steps.  SELL (B3): per bucket one
    launch of the lane groups, parts, threads and shared memory
    :func:`repro_torch.core.autotune.node_split` gives the bucket at this
    ``k_tile``.  ELLPACK (B4 / B5): :func:`_ell_node_blocks`."""
    violations: list[str] = []
    ell = meta.kind == "ell"
    if meta.kind not in ("graph", "ell"):
        violations.append(f"{kernel} needs graph adjacency, got {meta.kind}")
    if k < 1:
        violations.append(f"state stack must have k >= 1 columns, got {k}")
    if ell and k != 1:
        violations.append(f"{kernel} advances one state column, got k={k}")
    _index_contracts(meta, violations, "neighbour id", "the state")
    want = _STATE_DTYPES[combine]
    if state_dtype not in want:
        violations.append(
            f"{combine} state dtype {state_dtype} is not one of {want} (the "
            "kernel's instantiations)")
    if ell:
        blocks = _ell_node_blocks(combine, meta, state_dtype, live, violations)
        return LaunchPlan(kernel=kernel, operand=meta.describe(),
                          dtype=state_dtype, blocks=blocks,
                          violations=tuple(violations))
    sb = int(np.dtype(state_dtype).itemsize) if state_dtype in (
        "int32", "float32", "float64") else 8
    k_tile = min(max(k, 1) & -max(k, 1), MAX_K_TILE)
    if k_tile * sb > ACC_BYTES_PER_THREAD:
        violations.append(
            f"k_tile {k_tile} x {sb} B state columns exceed the per-thread "
            f"register budget ({ACC_BYTES_PER_THREAD} B)")
    grid_y = max(k, 1) // k_tile
    if grid_y > MAX_GRID_Y:
        violations.append(
            f"{grid_y} column tiles exceed grid.y limit {MAX_GRID_Y} (k={k})")
    state = (meta.n_rows + 1, max(k, 1))
    blocks = []
    for i, (s, w) in enumerate(zip(meta.n_slices, meta.widths)):
        split = node_split(w, meta.c, s, k_tile, sb, combine)
        if split.threads > MAX_BLOCK_THREADS:
            violations.append(f"bucket {i} (W={w}): block of {split.threads} "
                              f"threads > {MAX_BLOCK_THREADS}")
        grid_x = math.ceil(s * meta.c / split.nodes)
        if grid_x > MAX_GRID_X:
            violations.append(f"bucket {i} (W={w}): grid.x {grid_x} > "
                              f"{MAX_GRID_X}")
        operands = [("adj", (s, w, meta.c), meta.idx_dtype),
                    ("nodes", (s, meta.c), meta.idx_dtype),
                    ("state", state, state_dtype), ("out", state, state_dtype)]
        if combine == "pagerank":
            operands.append(("consts", (3, max(k, 1)), state_dtype))
        blocks.append(BlockPlan(
            label=(f"bucket{i}[W={w}, group={split.group}, "
                   f"parts={split.parts}]"),
            grid=(grid_x, grid_y), block=(split.threads,),
            operands=tuple(operands), smem_bytes=split.smem_bytes))
    return LaunchPlan(kernel=kernel, operand=meta.describe(),
                      dtype=state_dtype, blocks=tuple(blocks),
                      violations=tuple(violations))


def _ell_node_blocks(combine: str, meta: SlabMeta, state_dtype: str,
                     live: "LiveWidthMeta | None",
                     violations: list[str]) -> tuple[BlockPlan, ...]:
    """B4 / B5 over an ELLPACK adjacency of n nodes: for BFS first the
    frontier pass (one thread a node, a ``(ceil(n / 32),)`` bitmap), then
    the walk, one thread a node up to its warp's live width, both in
    blocks of ``ELL_NODE_BLOCK_THREADS``.  ``live`` (the adjacency's live
    widths) must hold one entry per 32 nodes, each in ``[0, W]``."""
    (w,), n = meta.widths, meta.n_rows
    threads = ELL_NODE_BLOCK_THREADS
    words = -(-n // ELL_LIVE_ROWS)
    _live_contracts(live, words, w, violations)
    grid_x = math.ceil(n / threads)
    if grid_x > MAX_GRID_X:
        violations.append(f"grid.x {grid_x} > {MAX_GRID_X}")
    state = ("state", (n,), state_dtype)
    walk = [("adj", (w, n), meta.idx_dtype), ("live", (words,), "int32")]
    blocks = []
    if combine == "bfs":
        frontier = ("frontier", (words,), "int32")
        blocks.append(BlockPlan(label="frontier", grid=(grid_x,),
                                block=(threads,),
                                operands=(state, frontier)))
        walk.append(frontier)
    walk += [state, ("out", (n,), state_dtype)]
    if combine == "pagerank":
        walk.append(("consts", (3,), state_dtype))
    blocks.append(BlockPlan(label=f"ell[W={w}]", grid=(grid_x, 1),
                            block=(threads,), operands=tuple(walk)))
    return tuple(blocks)


def plan_bfs_sell(meta: SlabMeta, k: int = 1) -> LaunchPlan:
    """Plan one ``bfs_step_sell`` level for k stacked sources: int32
    distance columns (n + 1, k), one B3 launch per bucket."""
    return _plan_node_step("bfs_sell", "bfs", meta, k, "int32")


def plan_pagerank_sell(meta: SlabMeta, k: int = 1,
                       dtype: str = "float64") -> LaunchPlan:
    """Plan one ``pagerank_step_sell`` power step for k stacked
    configurations: (n + 1, k) contribution columns and (3, k) constants
    in the rank dtype, float64 (the reference's x64 path) or float32 (its
    x64-off path), one B3 launch per bucket."""
    return _plan_node_step("pagerank_sell", "pagerank", meta, k, dtype)


def plan_bfs_ell(meta: SlabMeta,
                 live: "LiveWidthMeta | None" = None) -> LaunchPlan:
    """Plan one ``bfs_step`` level (kernel B4: the frontier pass and the
    walk, two launches) over an ELLPACK in-adjacency
    (:meth:`SlabMeta.from_ell`), its live widths checked from ``live``."""
    return _plan_node_step("bfs_step", "bfs", meta, 1, "int32", live)


def plan_pagerank_ell(meta: SlabMeta, dtype: str = "float64",
                      live: "LiveWidthMeta | None" = None) -> LaunchPlan:
    """Plan one ``pagerank_step`` power step (kernel B5, one launch) over
    an ELLPACK reverse adjacency (:meth:`SlabMeta.from_ell`), its live
    widths checked from ``live``."""
    return _plan_node_step("pagerank_step", "pagerank", meta, 1, dtype,
                           live)


# ---------------------------------------------------------------------------
# ELLPACK SpMV (kernel B6)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LiveWidthMeta:
    """What the B6 plan needs of a slab's live-width array
    (:func:`repro_torch.kernels.spmv.live_widths`): its length and range,
    read once per operand (``ops`` caches it beside the tensors)."""

    n: int
    lo: int
    hi: int

    @classmethod
    def from_array(cls, live) -> "LiveWidthMeta":
        """From a numpy array or a tensor (a card tensor is read back
        once)."""
        arr = np.asarray(live.cpu() if hasattr(live, "cpu") else live)
        if arr.size == 0:
            return cls(0, 0, 0)
        return cls(int(arr.size), int(arr.min()), int(arr.max()))


def _live_contracts(live: LiveWidthMeta | None, want: int, width: int,
                    violations: list[str]) -> None:
    """A live-width array (B4, B5, B6) holds ``want`` entries (one per
    :data:`ELL_LIVE_ROWS` rows), each in ``[0, width]``: the kernels walk
    each warp's rows up to it and read no slot past it."""
    if live is None:
        return
    if live.n != want:
        violations.append(f"live widths hold {live.n} entries, want "
                          f"{want} (one per {ELL_LIVE_ROWS} rows)")
    if live.n and (live.lo < 0 or live.hi > width):
        violations.append(f"live widths in [{live.lo}, {live.hi}] "
                          f"outside [0, W={width}]")


def plan_spmv_ell(meta: SlabMeta, *, dtype: str | None = None, k: int = 1,
                  live: LiveWidthMeta | None = None) -> LaunchPlan:
    """Plan ``spmv_ell`` (k = 1) or ``spmm_ell`` (k columns) for an x of
    ``dtype`` against this ELLPACK matrix (:meth:`SlabMeta.from_ellpack`).

    k = 1: one launch, one thread a row, ``grid = ceil(S * C / threads)``.
    k > 1: one launch of the k-column form per k tile
    (:func:`~repro_torch.core.autotune.ell_k_tiles`, at 16 B of columns a
    lane), groups of lanes a row, ``grid = ceil(S * C / (threads /
    group))``, each tile as wide as one warp's lanes hold.  With a
    bounds-scanned meta every
    stored column must be PAD or lie in ``[0, n_cols)``: the kernel gathers
    ``x[col]`` unchecked.  ``live`` (the slab's live widths) must hold one
    entry per 32 rows, each in ``[0, W]``: the kernel walks each warp's
    rows up to it (bounded to ``[0, W]`` inside the kernel as well, so a
    width handed past the plan reads no slot outside the slab)."""
    violations: list[str] = []
    if meta.kind != "ellpack":
        violations.append(f"spmv_ell needs an ELLPACK matrix, got {meta.kind}")
    _index_contracts(meta, violations, "column index", "x")
    if meta.val_dtype not in KERNEL_DTYPES:
        violations.append(
            f"ELLPACK value dtype {meta.val_dtype} is not float32 or float64")
    if dtype is not None and dtype != meta.val_dtype:
        violations.append(
            f"x dtype {dtype} != ELLPACK value dtype {meta.val_dtype}")
    threads = ELL_BLOCK_THREADS
    (s,), (w,) = meta.n_slices, meta.widths
    lanes = s * meta.c
    _live_contracts(live, -(-lanes // ELL_LIVE_ROWS), w, violations)
    vdt = dtype or meta.val_dtype
    itemsize = int(np.dtype(vdt).itemsize) if vdt in KERNEL_DTYPES else 8
    live_op = ("live", (-(-lanes // ELL_LIVE_ROWS),), "int32")
    slab = (("cols", (s, w, meta.c), meta.idx_dtype),
            ("vals", (s, w, meta.c), meta.val_dtype))
    blocks = []
    if k < 1:
        violations.append(f"k must be >= 1, got {k}")
    elif k == 1:
        grid_x = math.ceil(lanes / threads)
        if grid_x > MAX_GRID_X:
            violations.append(f"grid.x {grid_x} > {MAX_GRID_X}")
        blocks.append(BlockPlan(
            label=f"ell[W={w}]", grid=(grid_x,), block=(threads,),
            operands=slab + (live_op, ("x", (meta.n_cols,), vdt),
                             ("y", (lanes,), meta.val_dtype))))
    else:
        for k0, kt, group in ell_k_tiles(k, ell_vec(k, itemsize)):
            grid_x = math.ceil(lanes / (threads // group))
            if grid_x > MAX_GRID_X:
                violations.append(f"grid.x {grid_x} > {MAX_GRID_X}")
            blocks.append(BlockPlan(
                label=f"ell[W={w}, cols {k0}:{k0 + kt}, group={group}]",
                grid=(grid_x,), block=(threads,),
                operands=slab + (live_op, ("X", (meta.n_cols, k), vdt),
                                 ("Y", (lanes, k), meta.val_dtype))))
    return LaunchPlan(kernel="spmv_ell" if k == 1 else "spmm_ell",
                      operand=meta.describe(), dtype=meta.val_dtype,
                      blocks=tuple(blocks), violations=tuple(violations))


# ---------------------------------------------------------------------------
# FFT (kernel B7)
# ---------------------------------------------------------------------------


def plan_fft_stockham(n: int, batch: int = 1, *, b_block: int = 8,
                      dtype: str = "float64") -> LaunchPlan:
    """Plan ``fft_stockham`` for a (batch, n) split-plane signal block.

    Up to :func:`~repro_torch.core.autotune.fft_block_limit` (4096 in fp64,
    8192 in fp32) the in-block form runs: one launch, ``grid = ceil(batch /
    signals)`` (:func:`~repro_torch.core.autotune.fft_block_signals`, at
    most ``b_block``), ``signals * n / radix`` threads, each block's padded
    exchange planes and twiddle bases priced in ``smem_bytes``
    (:func:`~repro_torch.core.autotune.fft_block_smem_bytes`).
    Longer signals run the two-pass form (:func:`repro_torch.core.autotune
    .fft_two_pass`): pass A, ``batch * n2 / tile_a`` blocks of ``tile_a``
    length-n1 columns, then pass B, ``batch * n1 / tile_b`` blocks of
    ``tile_b`` length-n2 rows, each block's ping-pong buffers priced in
    ``smem_bytes``; both sub-lengths at most what a block holds, so n up to
    2^24 in fp64 and 2^26 in fp32 (the reference refuses far shorter
    lengths: its VMEM).  Longer signals are a violation.
    """
    violations: list[str] = []
    pow2 = n >= 2 and is_pow2(n)
    if not pow2:
        violations.append(f"fft length {n} is not a power of two >= 2")
    if b_block < 1:
        violations.append(f"b_block must be >= 1, got {b_block}")
    if batch < 1:
        violations.append(f"batch must be >= 1, got {batch}")
    if dtype not in KERNEL_DTYPES:
        violations.append(f"fft dtype {dtype} is not float32 or float64")
    b = int(np.dtype(dtype).itemsize) if dtype in KERNEL_DTYPES else 8
    stages = int(math.log2(n)) if pow2 else 0
    half = n // 2 if pow2 else 0
    rows = max(int(batch), 1)
    twiddles = (("wre", (stages, half), dtype), ("wim", (stages, half), dtype))
    planes = (("re", (rows, n), dtype), ("im", (rows, n), dtype))
    blocks = []
    signals = fft_block_signals(n, b_block, b) if pow2 else 0
    two_pass = fft_two_pass(n, b) if pow2 and signals < 1 else None
    if signals >= 1:
        smem = fft_block_smem_bytes(n, signals, b)
        if smem > SMEM_PER_BLOCK:
            violations.append(f"{smem} B of shared memory a block > "
                              f"{SMEM_PER_BLOCK}")
        blocks.append(BlockPlan(
            label=f"in_block[signals={signals}, radix={fft_block_radix(n)}]",
            grid=(math.ceil(rows / signals),),
            block=(fft_block_threads(n, signals),),
            operands=planes + twiddles + (("out_re", (rows, n), dtype),
                                          ("out_im", (rows, n), dtype)),
            smem_bytes=smem))
    elif two_pass is not None:
        n1, n2, tile_a, tile_b = two_pass
        scratch = (("scratch_re", (rows, n), dtype),
                   ("scratch_im", (rows, n), dtype))
        out = (("out_re", (rows, n), dtype), ("out_im", (rows, n), dtype))
        for label, m, count, tile, pad, ins, outs in (
                ("pass_a", n1, n2, tile_a, 0, planes, scratch),
                ("pass_b", n2, n1, tile_b, tile_b, scratch, out)):
            smem = fft_pass_smem_bytes(m, tile, b, pad)
            if smem > SMEM_PER_BLOCK:
                violations.append(f"{label}: {smem} B of shared memory a "
                                  f"block > {SMEM_PER_BLOCK}")
            grid_x = rows * (count // tile)
            if grid_x > MAX_GRID_X:
                violations.append(f"{label}: grid.x {grid_x} > {MAX_GRID_X}")
            blocks.append(BlockPlan(
                label=f"{label}[n1={n1}, n2={n2}, tile={tile}]",
                grid=(grid_x,), block=(fft_pass_threads(m, tile),),
                operands=ins + twiddles + outs, smem_bytes=smem))
    elif pow2:
        limit = fft_block_limit(b)
        violations.append(
            f"fft length {n} exceeds the two-pass form's reach: n1 and n2 "
            f"each at most {limit} in {dtype}, so n <= {limit * limit}")
    return LaunchPlan(kernel="fft_stockham", operand=f"fft n={n} batch={batch}",
                      dtype=dtype, blocks=tuple(blocks),
                      violations=tuple(violations))


# ---------------------------------------------------------------------------
# Embedding gather (kernel B9) and the fused SSD scan (kernel B8)
# ---------------------------------------------------------------------------


def ids_on_host(ids) -> bool:
    """True for ids whose values the host can read without a copy from the
    card: a numpy array or a CPU tensor (numpy 2 arrays say "cpu")."""
    dev = getattr(ids, "device", "cpu")
    return str(getattr(dev, "type", dev)) == "cpu"


def gather_ids_violation(ids, vocab: int) -> str | None:
    """The range scan of host ids: a violation naming their range when one
    leaves ``[0, vocab)``, else None."""
    arr = np.asarray(ids)
    if arr.size:
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= vocab:
            return f"ids out of bounds: range [{lo}, {hi}] outside [0, {vocab})"
    return None


def plan_embedding_gather(vocab: int, d: int, ids, *, dtype: str = "float32",
                          vl: int = 256) -> LaunchPlan:
    """Plan ``embedding_gather`` of ``ids`` from a (vocab, d) table.

    One launch, ``grid = (T, chunks)`` blocks of ``threads``, each block
    copying one chunk of one gathered row
    (:func:`~repro_torch.core.autotune.gather_grid`).  ``ids`` is anything
    with a ``shape`` and a ``dtype`` (a numpy array or a torch tensor): it
    must be one axis of integers; the kernel reads int32 and int64 ids as
    they are (other integer types are widened to int64 first).  Where the
    ids lie on the host (numpy, or a CPU tensor) their values are scanned
    too, and an id outside ``[0, vocab)`` is a violation, refused before
    upload.  Ids already on the card (a decode step's argmax) are not read
    back, so their plan depends on the shapes and dtypes alone: the kernel
    bounds each of them to a row by the reference's rule
    (:func:`repro_torch.kernels.gather.clamp_ids`).  ``vl`` is the reference's rows a grid step; the CUDA
    grid does not depend on it.  The table is float32, float64 or
    bfloat16 (the copy moves bytes; a bf16 row of odd d goes in 2 B
    vectors).
    """
    violations: list[str] = []
    shape = tuple(int(s) for s in ids.shape)
    id_dtype = str(ids.dtype).removeprefix("torch.")
    if len(shape) != 1:
        violations.append(f"ids must be one axis (T,), got shape {shape}")
    if not np.issubdtype(np.dtype(id_dtype), np.integer):
        violations.append(f"ids dtype {id_dtype} is not an integer type")
    if dtype not in LM_KERNEL_DTYPES:
        violations.append(f"table dtype {dtype} is not bfloat16, float32 or "
                          "float64")
    if vocab < 1 or d < 1:
        violations.append(f"table ({vocab}, {d}) is empty")
    if vl < 1:
        violations.append(f"vl must be >= 1, got {vl}")
    if not violations and ids_on_host(ids):
        bad = gather_ids_violation(ids, vocab)
        if bad:
            violations.append(bad)
    t = shape[0] if len(shape) == 1 else 0
    itemsize = DTYPE_BYTES.get(dtype, 4)
    chunks, threads = gather_grid(t, d * itemsize)
    if t > MAX_GRID_X:
        violations.append(f"grid.x {t} > {MAX_GRID_X}")
    if chunks > MAX_GRID_Y:
        violations.append(f"grid.y {chunks} > {MAX_GRID_Y}")
    kernel_ids = id_dtype if id_dtype in ("int32", "int64") else "int64"
    block = BlockPlan(
        label=f"rows[{chunks} chunk(s) of {threads} threads a row]",
        grid=(max(t, 1), chunks), block=(threads,),
        operands=(("ids", (t,), kernel_ids), ("table", (vocab, d), dtype),
                  ("out", (t, d), dtype)))
    return LaunchPlan(kernel="embedding_gather",
                      operand=f"gather T={t} from ({vocab}, {d})", dtype=dtype,
                      blocks=(block,), violations=tuple(violations))


def plan_embedding_gather_shard(vocab: int, lo: int, rows: int, d: int, ids, *,
                                dtype: str = "float32",
                                vl: int = 256) -> LaunchPlan:
    """Plan the vocab-shard form of ``embedding_gather``: rows ``[lo, lo +
    rows)`` of a (vocab, d) table, held on one device of a mesh's model
    axis.  The launch is the whole-table gather's
    (:func:`plan_embedding_gather`, its grid (T, chunks)); host ids are
    scanned against the *whole* vocabulary and refused before upload outside
    ``[0, vocab)``, ids on the card are bounded by the whole vocabulary inside
    the kernel, then masked to the shard.  The window must lie inside the
    vocabulary."""
    plan = plan_embedding_gather(vocab, d, ids, dtype=dtype, vl=vl)
    violations = list(plan.violations)
    if lo < 0 or rows < 1 or lo + rows > vocab:
        violations.append(f"shard rows [{lo}, {lo + rows}) outside the "
                          f"vocabulary [0, {vocab})")
    (blk,) = plan.blocks
    t = blk.operands[0][1][0]
    block = dataclasses.replace(blk, operands=(
        blk.operands[0], ("table", (rows, d), dtype), ("out", (t, d), dtype)))
    return LaunchPlan(kernel="embedding_gather_shard",
                      operand=f"gather T={t} from rows [{lo}, {lo + rows}) of "
                              f"({vocab}, {d})",
                      dtype=dtype, blocks=(block,),
                      violations=tuple(violations))


def plan_embedding_gather_bwd(vocab: int, d: int, t: int, *,
                              dtype: str = "float32",
                              id_dtype: str = "int64",
                              table_dtype: str | None = None) -> LaunchPlan:
    """Plan ``embedding_gather_bwd`` of (t, d) output gradients of
    ``dtype`` into a (vocab, d) table gradient of ``table_dtype`` (None:
    ``dtype``): one launch of ``ceil(vocab / stripe) x chunks`` blocks of
    ``threads`` (:func:`~repro_torch.core.autotune.gather_bwd_grid`, its
    vectors cut from the output gradient's rows), block s chunks + c
    owning a stripe of table rows and one vector of each a thread; the ids
    are read as they come (int32 or int64) and walked in slices of
    :data:`~repro_torch.core.autotune.GATHER_BWD_SLICE`, so no T is refused
    for shared memory (fixed: :func:`~repro_torch.core.autotune.
    gather_bwd_smem_bytes`, static).  The types: one of float32, float64
    and bfloat16 for both, or float32 output gradients into a bfloat16
    table; sums in float32 (float64), a bf16 row rounded once, through a
    float32 ``carry`` (t, d) where t passes one slice."""
    violations: list[str] = []
    table_dtype = dtype if table_dtype is None else table_dtype
    if dtype not in LM_KERNEL_DTYPES:
        violations.append(f"gradient dtype {dtype} is not bfloat16, float32 "
                          "or float64")
    elif table_dtype != dtype and (dtype, table_dtype) != ("float32",
                                                           "bfloat16"):
        violations.append(f"a {table_dtype} table's gradient from {dtype} "
                          "output gradients (the pairs: one type, or float32 "
                          "into bfloat16)")
    if vocab < 1 or d < 1:
        violations.append(f"table ({vocab}, {d}) is empty")
    if t < 1:
        violations.append(f"no ids ({t})")
    if t > MAX_GRID_X:
        violations.append(f"{t} ids > {MAX_GRID_X}")
    itemsize = DTYPE_BYTES.get(dtype, 4)
    stripe, chunks, threads, vec = gather_bwd_grid(max(vocab, 1), max(d, 1),
                                                   t, itemsize)
    blocks = -(-max(vocab, 1) // stripe) * chunks
    if blocks > MAX_GRID_X:
        violations.append(f"grid.x {blocks} > {MAX_GRID_X}")
    kernel_ids = id_dtype if id_dtype in ("int32", "int64") else "int64"
    operands = (("ids", (t,), kernel_ids), ("dout", (t, d), dtype),
                ("dtable", (vocab, d), table_dtype))
    if DTYPE_BYTES.get(table_dtype, 4) < 4 and t > GATHER_BWD_SLICE:
        operands += (("carry", (t, d), "float32"),)
    block = BlockPlan(
        label=f"stripes[{stripe} rows x {chunks} chunk(s) of {threads} "
              f"threads, {vec} B vectors]",
        grid=(blocks,), block=(threads,), operands=operands,
        smem_bytes=gather_bwd_smem_bytes())
    return LaunchPlan(kernel="embedding_gather_bwd",
                      operand=f"scatter T={t} into ({vocab}, {d})",
                      dtype=dtype, blocks=(block,),
                      violations=tuple(violations))


def plan_embedding_gather_shard_bwd(vocab: int, lo: int, rows: int, d: int,
                                    t: int, *, dtype: str = "float32",
                                    id_dtype: str = "int64",
                                    table_dtype: str | None = None) -> LaunchPlan:
    """Plan the vocab-shard backward: the (rows, d) gradient of rows ``[lo,
    lo + rows)`` of a (vocab, d) table from (t, d) output gradients.  The
    launch is the whole-table backward's (:func:`plan_embedding_gather_bwd`)
    over the shard's rows: ``ceil(rows / stripe) x chunks`` blocks, the ids
    bounded by the *whole* vocabulary inside the kernel, then those outside
    the window dropped.  The window must lie inside the vocabulary."""
    plan = plan_embedding_gather_bwd(rows, d, t, dtype=dtype, id_dtype=id_dtype,
                                     table_dtype=table_dtype)
    violations = list(plan.violations)
    if lo < 0 or rows < 1 or lo + rows > vocab:
        violations.append(f"shard rows [{lo}, {lo + rows}) outside the "
                          f"vocabulary [0, {vocab})")
    return LaunchPlan(kernel="embedding_gather_shard_bwd",
                      operand=f"scatter T={t} into rows [{lo}, {lo + rows}) of "
                              f"({vocab}, {d})",
                      dtype=dtype, blocks=plan.blocks,
                      violations=tuple(violations))


def plan_ssd_fused(b: int, l: int, h: int, p: int, g: int, n: int, *,
                   chunk: int, dtype: str = "float32") -> LaunchPlan:
    """Plan ``ssd_fused`` for xd (b, l, h, p), ad (b, l, h) and B, C
    (b, l, g, n).

    Three launches (:func:`~repro_torch.core.autotune.ssd_grids`,
    ``SSD_BLOCK_THREADS`` threads each): ``chunk_state``, a block per
    (b, h, chunk) and 64 x 64 tile of the state; ``state_pass``, a thread
    per state entry; ``chunk_output``, a block per (b, h, chunk) and 64-row
    query tile.  Their shared memory is fixed
    (:func:`~repro_torch.core.autotune.ssd_smem_bytes`: 55 KB at most in
    fp32, 105 KB in fp64), so no shape is refused for it.  Refused: a
    sequence that is not a whole number of chunks (``ssd.py:69``), heads
    that groups do not divide, and grids past CUDA's limits.

    ``dtype`` "bfloat16" is the reference model's SSD_BF16 mix: xd, B, C
    and y bf16, ad and everything else float32, the fp32 form's launches
    and shared memory (operands widened as they are loaded, element by
    element: no alignment beyond a bf16 element's 2 B); where p takes more
    than one 64-column slice, y's partial sums go through a float32
    scratch ``yacc`` (b, l, h, p), so that y is rounded once.
    """
    violations: list[str] = []
    if min(b, l, h, p, g, n) < 1:
        violations.append(f"empty extent in (b, l, h, p, g, n) = "
                          f"{(b, l, h, p, g, n)}")
    if chunk < 1:
        violations.append(f"chunk must be >= 1, got {chunk}")
    elif l % chunk or l < chunk:
        violations.append(f"sequence length {l} is not a positive multiple of "
                          f"the chunk {chunk}")
    if g >= 1 and h % g:
        violations.append(f"{h} heads are not a multiple of {g} groups")
    if dtype not in LM_KERNEL_DTYPES:
        violations.append(f"ssd dtype {dtype} is not bfloat16, float32 or "
                          "float64")
    acc = "float64" if dtype == "float64" else "float32"
    itemsize = DTYPE_BYTES[acc]
    ext = [max(int(v), 1) for v in (b, l, h, p, n, chunk)]
    grids = ssd_grids(*ext)
    nc = ext[1] // ext[5]
    scratch = (("cum", (b, h, l), acc), ("states", (b, h, nc, p, n), acc))
    entering = ("entering", (b, h, nc, p, n), acc)
    io = {"xd": ("xd", (b, l, h, p), dtype), "ad": ("ad", (b, l, h), acc),
          "B": ("B", (b, l, g, n), dtype), "C": ("C", (b, l, g, n), dtype),
          "y": ("y", (b, l, h, p), dtype),
          "state": ("state", (b, h, p, n), acc)}
    out = (io["y"],)
    if dtype == "bfloat16" and p > SSD_TILE:
        out += (("yacc", (b, l, h, p), acc),)
    operands = {
        "chunk_state": (io["xd"], io["ad"], io["B"]) + scratch,
        "state_pass": scratch + (entering, io["state"]),
        "chunk_output": (io["xd"], io["B"], io["C"], scratch[0], entering)
        + out,
    }
    blocks = []
    for launch in SSD_LAUNCHES:
        grid = grids[launch]
        if grid[0] > MAX_GRID_X:
            violations.append(f"{launch}: grid.x {grid[0]} > {MAX_GRID_X}")
        if any(d > MAX_GRID_Y for d in grid[1:]):
            violations.append(f"{launch}: grid {grid} past {MAX_GRID_Y} in "
                              "y or z")
        blocks.append(BlockPlan(
            label=launch, grid=grid, block=(SSD_BLOCK_THREADS,),
            operands=operands[launch],
            smem_bytes=ssd_smem_bytes(launch, itemsize)))
    return LaunchPlan(kernel="ssd_fused",
                      operand=f"ssd b={b} l={l} h={h} p={p} g={g} n={n} "
                              f"chunk={chunk}",
                      dtype=dtype, blocks=tuple(blocks),
                      violations=tuple(violations))


def plan_ssd_fused_bwd(b: int, l: int, h: int, p: int, g: int, n: int, *,
                       chunk: int, dtype: str = "float32") -> LaunchPlan:
    """Plan ``ssd_fused_bwd``, the backward of :func:`plan_ssd_fused`'s
    scan: five launches (:func:`~repro_torch.core.autotune.ssd_bwd_grids`,
    ``SSD_BLOCK_THREADS`` threads each) of fixed shared memory
    (:func:`~repro_torch.core.autotune.ssd_bwd_smem_bytes`: 107 KB at most
    in fp32, 214 KB in fp64; refused past a block's share), the forward's
    contracts (whole chunks, groups dividing heads, grid limits) and its
    operands: the forward's inputs, its cum and entering states, the
    output gradients, the per-head scratch of dB and dC (b, l, h, n)
    before their group sums, the key launch's M and (G ∘ L) tiles (``mh``,
    ``gh`` (b h nc, pairs, 64, 64)) and the pairs' row sums (``rh`` (b h
    nc, pairs, 64)), of which it hands the query launch ``mh`` and
    ``rh``.  In the bf16 form xd, dy, B, C, dx, dB and dC are bf16, the
    rest float32, the shared memory the fp32 form's."""
    fwd = plan_ssd_fused(b, l, h, p, g, n, chunk=chunk, dtype=dtype)
    violations = list(fwd.violations)
    acc = "float64" if dtype == "float64" else "float32"
    itemsize = DTYPE_BYTES[acc]
    ext = [max(int(v), 1) for v in (b, l, h, p, g, n, chunk)]
    grids = ssd_bwd_grids(*ext)
    nc = ext[1] // ext[6]
    pairs = b * h * nc * ssd_bwd_pairs(ext[1], ext[6])
    stored = {"xd", "dy", "dx", "B", "C", "dB", "dC"}
    ops = {name: (name, shape, dtype if name in stored else acc)
           for name, shape in (
        ("xd", (b, l, h, p)), ("dy", (b, l, h, p)), ("dx", (b, l, h, p)),
        ("B", (b, l, g, n)), ("C", (b, l, g, n)), ("dB", (b, l, g, n)),
        ("dC", (b, l, g, n)), ("dad", (b, l, h)), ("cum", (b, h, l)),
        ("dcq", (b, h, l)), ("dck", (b, h, l)),
        ("entering", (b, h, nc, p, n)), ("local", (b, h, nc, p, n)),
        ("dso", (b, h, nc, p, n)), ("state", (b, h, p, n)),
        ("dbh", (b, l, h, n)), ("dch", (b, l, h, n)),
        ("mh", (pairs, SSD_TILE, SSD_TILE)), ("gh", (pairs, SSD_TILE, SSD_TILE)),
        ("rh", (pairs, SSD_TILE)))}
    operands = {
        "bwd_local": ("dy", "C", "cum", "local"),
        "bwd_state_pass": ("local", "dso", "cum", "state"),
        "bwd_key": ("xd", "dy", "B", "C", "cum", "entering", "state", "dso",
                    "dbh", "dx", "dck", "mh", "gh", "rh"),
        "bwd_query": ("dy", "B", "C", "cum", "entering", "mh", "rh", "dch",
                      "dcq"),
        "bwd_finish": ("dcq", "dck", "dad", "dbh", "dch", "dB", "dC"),
    }
    blocks = []
    for launch in SSD_BWD_LAUNCHES:
        grid = grids[launch]
        if grid[0] > MAX_GRID_X:
            violations.append(f"{launch}: grid.x {grid[0]} > {MAX_GRID_X}")
        if any(d > MAX_GRID_Y for d in grid[1:]):
            violations.append(f"{launch}: grid {grid} past {MAX_GRID_Y} in "
                              "y or z")
        smem = ssd_bwd_smem_bytes(launch, itemsize)
        if smem > SMEM_PER_BLOCK:
            violations.append(f"{launch}: {smem} B of shared memory > "
                              f"{SMEM_PER_BLOCK}")
        blocks.append(BlockPlan(
            label=launch, grid=grid, block=(SSD_BLOCK_THREADS,),
            operands=tuple(ops[o] for o in operands[launch]),
            smem_bytes=smem))
    return LaunchPlan(kernel="ssd_fused_bwd",
                      operand=f"ssd backward b={b} l={l} h={h} p={p} g={g} "
                              f"n={n} chunk={chunk}",
                      dtype=dtype, blocks=tuple(blocks),
                      violations=tuple(dict.fromkeys(violations)))
